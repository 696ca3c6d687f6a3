"""The preprocess's payload entry (``preprocess_cuda.preprocess_payload``:
K1 forward, K4 backward, one ``autograd.Function``) and the layout it
writes (``ops/rasterize/payload.py``).

On the CPU: the column map against the kernels' copy in ``common.cuh``;
the entry's plain version bit for bit against the facade's chain as it was
before the entry existed (``pack_rows`` of the concatenated SH ->
``_row_math`` -> ``split_rows`` -> the screen offset -> ``make_payload``),
the payload, the binning record and every field's gradient, at SH degrees
0-3, an active degree below the cloud's, a cloud of degree 1, a caller's
colour, no offset and slot counts that are not a multiple of the kernels'
128-slot blocks; the ``autograd.Function`` wired to stand-in launchers, so
its argument order and gradients are checked without a card; the
launchers' refusals.

On the card (``card``; run there with ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_payload.py -m card``): K1's payload and
binning record and K4's per-field gradients against the plain version on
the card at 131,072 and 2^22 slots and at the CPU cases' shapes, with
chip_smoke.py's tolerances (valid, radius and K4's mask words exact; the
other floats of K1 within 1e-5 relative and absolute; each K4 gradient
within 1e-4 of its field's largest; Gaussians at a step's edge aside, see
EDGE), one launch of each kernel a call.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sdpgs_torch import _kernels
from sdpgs_torch.core.camera import Camera
from sdpgs_torch.ops.rasterize import payload as pay_lib
from sdpgs_torch.ops.rasterize import preprocess_cuda as pp
from sdpgs_torch.ops.rasterize.preprocess import Preprocessed

CAM = dict(R=np.eye(3), T=np.array([0.05, -0.02, 0.0]), fovx=0.9, fovy=0.7, width=96,
           height=64)
K1_TOL = 1e-5   # K1's float outputs against the plain version on the card (rtol and atol)
K4_TOL = 1e-4   # K4 against autograd on the card: |diff| <= 1e-4 x the field's max
# The plain version normalizes the SH view direction with torch.rsqrt, the
# kernels with 1 / sqrtf: a pre-clamp colour within EDGE of 0, or a centre
# within EDGE (relative) of a clip limit, can fall on the other side of that
# step on the two. Such Gaussians (a few in a million) are counted, held to
# at most EDGE_SHARE of the slots, and left out of K4's mask and gradient
# comparison; K1's floats are compared everywhere.
EDGE = 1e-5
EDGE_SHARE = 1e-4
FIELDS = ("xyz", "scale", "quat", "features_dc", "features_rest", "opacity", "feature")
# name: (slots, cloud's SH degree, active degree, caller's colour, screen offset)
CASES = {
    "deg3": (301, 3, 3, False, True),
    "deg2_of_3": (301, 3, 2, False, True),
    "deg1_of_3": (301, 3, 1, False, True),
    "deg0_of_3": (301, 3, 0, False, True),
    "cloud_deg1": (301, 1, 1, False, True),
    "override_color": (301, 3, 3, True, True),
    "no_offset": (301, 3, 3, False, False),
    "whole_blocks": (256, 3, 3, False, True),
}


def make_inputs(rng, P: int, max_deg: int, color: bool, offset: bool, device="cpu") -> dict:
    """A cloud in front of the camera with Gaussians behind it, inside the
    near plane, at and past the clip limits, dead, and with negative
    pre-clamp colour; the per-Gaussian opacity, feature, colour, offset."""
    xyz = rng.normal(size=(P, 3)) * 0.5 + [0.0, 0.0, 3.0]
    xyz[:5, 2] = -1.0
    xyz[5:8] = [0.0, 0.0, 0.1]
    xyz[8:40, 0] = rng.uniform(-8.0, 8.0, 32)
    quat = rng.normal(size=(P, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    K = (max_deg + 1) ** 2
    sh = rng.normal(size=(P, K, 3)) * 0.3
    sh[48:64, 0] = -3.0
    arrays = dict(xyz=xyz, scale=rng.uniform(0.01, 0.1, size=(P, 3)), quat=quat,
                  features_dc=sh[:, :1], features_rest=sh[:, 1:],
                  alive=(rng.random(P) > 0.1), opacity=rng.uniform(0.1, 0.9, size=P),
                  feature=rng.normal(size=(P, 3)))
    if color:
        arrays["color"] = rng.uniform(size=(P, 3))
    if offset:
        arrays["means2d_offset"] = rng.normal(size=(P, 2)) * 0.1
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32, device=device)
            for k, v in arrays.items()}


def camera(device="cpu"):
    return Camera.create(**CAM, device=device)


# -- the facade's chain before the payload entry, as it was ----------------

def _pack_rows_then(xyz, scale, quat, features, alive, deg):
    P, K = xyz.shape[0], (deg + 1) ** 2
    geoT = torch.cat([xyz.T, scale.T, quat.T, alive.reshape(1, P)], dim=0)
    shT = features[:, :K, :].reshape(P, K * 3).T
    return geoT.to(torch.float32).contiguous(), shT.to(torch.float32).contiguous()


def _split_rows_then(out):
    prep = Preprocessed(valid=out[0] > 0.0, mean2d=torch.stack([out[1], out[2]], dim=-1),
                        depth=out[3], conic=torch.stack([out[4], out[5], out[6]], dim=-1),
                        radius=out[7])
    return prep, torch.stack([out[8], out[9], out[10]], dim=-1)


def _pad_row_then(a):
    return torch.cat([a, torch.zeros_like(a[:1])], dim=0)


def chain_then(x: dict, cam, deg: int):
    """(payload rows, binning record) of the parent chain: preprocess_color
    over get_features' concatenation, then rasterize_tiles' offset and
    make_payload."""
    features = torch.cat([x["features_dc"], x["features_rest"]], dim=1)
    geoT, shT = _pack_rows_then(x["xyz"], x["scale"], x["quat"], features, x["alive"], deg)
    rows = torch.stack(pp._row_math(geoT, shT, pp._cam_vec(cam), deg=deg, width=cam.width,
                                    height=cam.height, near=0.2, low_pass=0.3))
    prep, color = _split_rows_then(rows)
    mean2d = prep.mean2d
    if "means2d_offset" in x:
        mean2d = mean2d + x["means2d_offset"]
    color = x.get("color", color)
    payload = _pad_row_then(torch.cat([
        mean2d, prep.conic, (x["opacity"] * prep.valid)[:, None], color, prep.depth[:, None],
        x["feature"]], dim=-1).to(torch.float32)).contiguous()
    return payload, (prep.valid, mean2d, prep.depth, prep.radius)


def entry(x: dict, cam, deg: int) -> pay_lib.Payload:
    return pp.preprocess_payload(
        *(x[k] for k in ("xyz", "scale", "quat", "features_dc", "features_rest", "alive",
                         "opacity", "feature")),
        cam, deg, color=x.get("color"), means2d_offset=x.get("means2d_offset"))


def grads_of(fn, x: dict, d_rows: torch.Tensor) -> dict:
    """Each differentiable input's gradient of <fn's payload rows, d_rows>."""
    leaves = {k: v.clone().requires_grad_(k != "alive") for k, v in x.items()}
    rows = fn(leaves)
    names = [k for k in leaves if k != "alive"]
    got = torch.autograd.grad(rows, [leaves[k] for k in names], d_rows, allow_unused=True)
    return dict(zip(names, got))


# -- CPU -------------------------------------------------------------------

def test_column_map_is_the_kernels():
    """payload.py's columns are common.cuh's SDPGS_PAY_* and SDPGS_NPAY,
    and make_payload writes them in that order."""
    src = (Path(pp.__file__).resolve().parents[2] / "csrc" / "common.cuh").read_text()
    consts = {m[0]: int(m[1]) for m in re.findall(r"constexpr int SDPGS_(\w+) = (\d+);", src)}
    assert consts["NPAY"] == pay_lib.NPAY
    starts = dict(PAY_MEAN2D=pay_lib.MEAN2D.start, PAY_CONIC=pay_lib.CONIC.start,
                  PAY_OPACITY=pay_lib.OPACITY, PAY_RGB=pay_lib.RGB.start,
                  PAY_DEPTH=pay_lib.DEPTH, PAY_FEATURE=pay_lib.FEATURE.start)
    assert {k: consts[k] for k in starts} == starts
    P = 5
    prep = Preprocessed(valid=torch.ones(P, dtype=torch.bool), mean2d=torch.full((P, 2), 1.0),
                        depth=torch.full((P,), 5.0), conic=torch.full((P, 3), 2.0),
                        radius=torch.ones(P))
    rows = pay_lib.make_payload(prep, torch.full((P,), 3.0), torch.full((P, 3), 4.0),
                                torch.full((P, 3), 6.0))
    for cols, v in ((pay_lib.MEAN2D, 1.0), (pay_lib.CONIC, 2.0), (pay_lib.OPACITY, 3.0),
                    (pay_lib.RGB, 4.0), (pay_lib.DEPTH, 5.0), (pay_lib.FEATURE, 6.0)):
        assert bool((rows[:P, cols] == v).all())
    assert rows.shape == (P + 1, pay_lib.NPAY) and not rows[P].any()
    assert pay_lib.VALUES == slice(6, 13)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_entry_is_the_chain_it_replaced(case):
    """The payload, the binning record and every field's gradient, bit for
    bit, against the facade's chain before the entry."""
    P, max_deg, deg, color, offset = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    x = make_inputs(rng, P, max_deg, color, offset)
    cam = camera()
    _kernels.reset_counts()
    got = entry(x, cam, deg)
    assert _kernels.PLAIN_CALLS["preprocess"] == 1 and _kernels.LAUNCHES["preprocess"] == 0
    ref_rows, ref_screen = chain_then(x, cam, deg)
    assert torch.equal(got.rows, ref_rows)
    for a, b, name in zip(got.screen, ref_screen, pay_lib.Screen._fields):
        assert a.dtype == b.dtype and torch.equal(a, b), name
        assert not a.requires_grad and a.is_contiguous(), name
    assert 0 < int(got.screen.valid.sum()) < P
    d_rows = torch.tensor(rng.normal(size=(P + 1, pay_lib.NPAY)), dtype=torch.float32)
    g = grads_of(lambda v: entry(v, cam, deg).rows, x, d_rows)
    r = grads_of(lambda v: chain_then(v, cam, deg)[0], x, d_rows)
    assert g.keys() == r.keys()
    for k in g:
        assert (g[k] is None) == (r[k] is None), k
        if g[k] is not None:
            assert torch.equal(g[k], r[k]), k
    assert not g["features_rest"][:, (deg + 1) ** 2 - 1:].any()
    if color:
        assert not g["features_dc"].any() and not g["features_rest"].any()
        assert torch.equal(g["color"], d_rows[:P, pay_lib.RGB])
    if offset:
        assert torch.equal(g["means2d_offset"], d_rows[:P, pay_lib.MEAN2D])
    assert torch.equal(g["opacity"], d_rows[:P, pay_lib.OPACITY] * got.screen.valid)
    assert torch.equal(g["feature"], d_rows[:P, pay_lib.FEATURE])


def _stand_in_launchers(monkeypatch):
    """K1 and K4 replaced by the plain version on CPU tensors: K1 its
    forward, K4 its gradients as the kernel returns them (FieldGrads)."""

    def fwd(xyz, scale, quat, features_dc, features_rest, alive, opacity, feature, cam_vec,
            deg, width, height, near=0.2, low_pass=0.3, color=None, means2d_offset=None):
        for t in (xyz, scale, quat, features_dc, features_rest, alive, opacity, feature):
            assert not t.requires_grad
        cam = _VecCamera(cam_vec, width, height)
        return pp.preprocess_payload_plain(xyz, scale, quat, features_dc, features_rest, alive,
                                           opacity, feature, cam, deg, color=color,
                                           means2d_offset=means2d_offset, near=near,
                                           low_pass=low_pass)

    def bwd(xyz, scale, quat, features_dc, features_rest, alive, d_rows, cam_vec, deg, width,
            height, near=0.2, low_pass=0.3, color=False, means2d_offset=False, masks=None):
        return pp.preprocess_payload_vjp_plain(
            xyz, scale, quat, features_dc, features_rest, alive, d_rows,
            _VecCamera(cam_vec, width, height), deg, color=color, means2d_offset=means2d_offset,
            near=near, low_pass=low_pass)

    monkeypatch.setattr(pp, "preprocess_payload_fwd", fwd)
    monkeypatch.setattr(pp, "preprocess_payload_bwd", bwd)


class _VecCamera:
    """The camera as the launchers see it: its [CAMN] vector and size."""

    def __init__(self, vec, width, height):
        self.vec, self.width, self.height = vec, width, height


@pytest.mark.parametrize("case", ["deg3", "deg1_of_3", "override_color", "no_offset"])
def test_function_routes_each_gradient_to_its_field(case, monkeypatch):
    """The autograd.Function around K1 and K4, with the launchers replaced
    by the plain version: its payload and record, and each input's
    gradient, equal the plain entry's bit for bit."""
    P, max_deg, deg, color, offset = CASES[case]
    rng = np.random.default_rng(7)
    x = make_inputs(rng, P, max_deg, color, offset)
    cam = camera()
    d_rows = torch.tensor(rng.normal(size=(P + 1, pay_lib.NPAY)), dtype=torch.float32)
    ref = entry(x, cam, deg)
    r = grads_of(lambda v: entry(v, cam, deg).rows, x, d_rows)
    _stand_in_launchers(monkeypatch)
    monkeypatch.setattr(pp, "_cam_vec", lambda c: c.vec if isinstance(c, _VecCamera)
                        else _CAM_VEC(c))

    def through_function(v):
        out = pp._PreprocessPayload.apply(
            *(v[k] for k in ("xyz", "scale", "quat", "features_dc", "features_rest", "alive",
                             "opacity", "feature")),
            v.get("color"), v.get("means2d_offset"), _CAM_VEC(cam), deg, cam.width, cam.height,
            0.2, 0.3)
        return out

    out = through_function(x)
    assert torch.equal(out[0], ref.rows)
    for a, b in zip(out[1:], ref.screen):
        assert torch.equal(a, b)
    g = grads_of(lambda v: through_function(v)[0], x, d_rows)
    assert g.keys() == r.keys()
    for k in g:
        assert torch.equal(g[k], r[k]), k


_CAM_VEC = pp._cam_vec


@pytest.mark.parametrize("case", ["deg3", "deg0_of_3", "override_color", "no_offset"])
def test_plain_k4_is_autograd_through_the_plain_entry(case):
    """preprocess_payload_vjp_plain, the plain version of K4, returns each
    field's gradient as autograd through the plain entry gives it (the
    opacity, feature, colour and offset at any value), counted."""
    P, max_deg, deg, color, offset = CASES[case]
    rng = np.random.default_rng(3)
    x = make_inputs(rng, P, max_deg, color, offset)
    cam = camera()
    d_rows = torch.tensor(rng.normal(size=(P + 1, pay_lib.NPAY)), dtype=torch.float32)
    _kernels.reset_counts()
    got = pp.preprocess_payload_vjp_plain(
        *(x[k] for k in ("xyz", "scale", "quat", "features_dc", "features_rest", "alive")),
        d_rows, cam, deg, color=color, means2d_offset=offset)
    assert _kernels.PLAIN_CALLS["preprocess_bwd"] == 1
    assert got.quat.stride() == (1, P)     # K4's layout: the transpose of [4, P] rows
    ref = grads_of(lambda v: entry(v, cam, deg).rows, x, d_rows)
    for name in pp.FieldGrads._fields:
        if getattr(got, name) is None:
            assert name not in ref, name
        else:
            assert torch.equal(getattr(got, name), ref[name]), name


REFUSALS = {"dtype": "xyz: expected torch.float32", "strided": "scale: expected a contiguous",
            "rest_short": "features_rest: expected", "degree": "SH degree 4",
            "offset_shape": "means2d_offset: expected shape"}


@pytest.mark.parametrize("fault", list(REFUSALS))
def test_launchers_refuse_what_the_kernels_cannot_take(fault, monkeypatch):
    """The wrappers check type, shape, contiguity and degree before any
    launch (here on CPU tensors, with the check's device clause waived)."""
    real = _kernels.check

    def check_but_the_device(t, name, dtype, shape):
        try:
            real(t, name, dtype, shape)
        except ValueError as e:
            if "expected a CUDA tensor" not in str(e):
                raise

    monkeypatch.setattr(_kernels, "check", check_but_the_device)
    x = make_inputs(np.random.default_rng(1), 64, 3, False, True)
    deg = 3
    if fault == "dtype":
        x["xyz"] = x["xyz"].double()
    elif fault == "strided":
        x["scale"] = x["scale"].T.contiguous().T
    elif fault == "rest_short":
        x["features_rest"] = x["features_rest"][:, :3].contiguous()
    elif fault == "degree":
        deg = 4
    else:
        x["means2d_offset"] = x["means2d_offset"][:, :1].contiguous()
    _kernels.reset_counts()
    with pytest.raises(ValueError, match=REFUSALS[fault]):
        pp.preprocess_payload_fwd(
            *(x[k] for k in ("xyz", "scale", "quat", "features_dc", "features_rest", "alive",
                             "opacity", "feature")),
            pp._cam_vec(camera()), deg, 96, 64, means2d_offset=x["means2d_offset"])
    assert _kernels.LAUNCHES["preprocess"] == 0


# -- the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def card_versus_plain(dev, x: dict, deg: int) -> dict:
    """K1 and K4 against the plain version on the card, on the same inputs
    and a seeded payload gradient; returns the disagreements and errors."""
    cam = camera()
    P = x["xyz"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(2)
    d_rows = torch.randn((P + 1, pay_lib.NPAY), generator=gen, device=dev)
    before = dict(_kernels.LAUNCHES)
    with torch.no_grad():
        k1 = entry(x, cam, deg)
    ref = pp.preprocess_payload_plain(
        *(x[k] for k in ("xyz", "scale", "quat", "features_dc", "features_rest", "alive",
                         "opacity", "feature")),
        cam, deg, color=x.get("color"), means2d_offset=x.get("means2d_offset"))
    masks = torch.empty(P, dtype=torch.int32, device=dev)
    k4 = pp.preprocess_payload_bwd(
        *(x[k] for k in ("xyz", "scale", "quat", "features_dc", "features_rest", "alive")),
        d_rows, pp._cam_vec(cam), deg, cam.width, cam.height, color="color" in x,
        means2d_offset="means2d_offset" in x, masks=masks)
    r4 = pp.preprocess_payload_vjp_plain(
        *(x[k] for k in ("xyz", "scale", "quat", "features_dc", "features_rest", "alive")),
        d_rows, cam, deg, color="color" in x, means2d_offset="means2d_offset" in x)._asdict()
    features = torch.cat([x["features_dc"], x["features_rest"]], dim=1)
    geoT, shT = pp.pack_rows(x["xyz"], x["scale"], x["quat"], features, x["alive"], deg)
    masks_p = pp.row_masks_plain(geoT, shT, pp._cam_vec(cam), deg, cam.width, cam.height)
    aux = {}
    with torch.no_grad():
        pp._row_math(geoT, shT, pp._cam_vec(cam).to(dev), deg=deg, width=cam.width,
                     height=cam.height, near=0.2, low_pass=0.3, aux=aux)
    edge = torch.zeros(P, dtype=torch.bool, device=dev)
    for ch in range(3):
        edge |= aux[f"res{ch}"].abs() < EDGE
    for u, lim in (("ux", "lim_x"), ("uy", "lim_y")):
        edge |= (aux[u].abs() - aux[lim]).abs() < EDGE * aux[lim]
    inner = ~edge
    torch.cuda.synchronize()
    launched = {k: _kernels.LAUNCHES[k] - before[k] for k in ("preprocess", "preprocess_bwd")}
    res = dict(launched=launched, edge=int(edge.sum()), P=P,
               quat_layout=k4.quat.stride() == r4["quat"].stride() == (1, P),
               mask_bad=int(((masks != masks_p) & inner).sum()),
               valid_bad=int((k1.screen.valid != ref.screen.valid).sum()),
               radius_bad=int((k1.screen.radius != ref.screen.radius).sum()),
               sentinel=bool(k1.rows[P].any()))
    floats = [(k1.rows[:P], ref.rows[:P].detach()), (k1.screen.mean2d, ref.screen.mean2d),
              (k1.screen.depth, ref.screen.depth)]
    res["k1_bad"] = sum(int((~torch.isclose(a, b, rtol=K1_TOL, atol=K1_TOL,
                                            equal_nan=True)).sum()) for a, b in floats)
    res["record_is_payload"] = (torch.equal(k1.screen.mean2d, k1.rows[:P, pay_lib.MEAN2D])
                                and torch.equal(k1.screen.depth, k1.rows[:P, pay_lib.DEPTH]))
    worst = {}
    for name in pp.FieldGrads._fields:
        got, want = getattr(k4, name), r4[name]
        if got is None:
            assert want is None, name
            continue
        scale = float(want.abs().max().clamp_min(1e-30))
        worst[name] = float((got[inner] - want[inner]).abs().max()) / scale
        assert bool(torch.isfinite(got).all()), name
    res["k4_worst"] = worst
    return res


def assert_card_agrees(res: dict) -> None:
    assert res["launched"] == {"preprocess": 1, "preprocess_bwd": 1}, res
    assert res["edge"] <= EDGE_SHARE * res["P"] and res["quat_layout"], res
    assert res["valid_bad"] == 0 and res["radius_bad"] == 0 and res["mask_bad"] == 0, res
    assert res["k1_bad"] == 0 and not res["sentinel"] and res["record_is_payload"], res
    assert max(res["k4_worst"].values()) <= K4_TOL, res


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_the_plain_version_on_the_card(cuda_device, case):
    P, max_deg, deg, color, offset = CASES[case]
    x = make_inputs(np.random.default_rng(11), P, max_deg, color, offset, device=cuda_device)
    assert_card_agrees(card_versus_plain(cuda_device, x, deg))


@pytest.mark.card
@pytest.mark.parametrize("P", [131072, 1 << 22])
def test_kernels_match_the_plain_version_at_the_cells_slots(cuda_device, P):
    """At the LLFF cell's and the 3 M-Gaussian cell's capacities."""
    x = make_inputs(np.random.default_rng(P), P, 3, False, True, device=cuda_device)
    res = card_versus_plain(cuda_device, x, 3)
    print(f"P {P}: {res}")
    assert_card_agrees(res)
