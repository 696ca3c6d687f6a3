"""Tiles that list more than 8,192 entries (the JAX package's fixed cap on
the per-tile table K), on the CPU and on the card.

On the CPU: a two-tile view whose crowded tile lists 9,000 entries, its
front half drawn on the left of the tile and its back half on the right,
so that the entries past 8,192 colour pixels of their own. The port's
plain train step at K 16,384 (its loss and every leaf's gradient) equals
the benchmark's plain reference at that K, and the reference cut to K
8,192 does not; a Trainer started at K 1,024 grows K past 8,192 without
dropping an entry; the derived ceilings refuse a K whose slot indices
would wrap int32 and a K or D whose buffers pass the memory budget; and
the raster counters read at a log point equal the binning's own totals,
with nothing recorded while spans are off and zeros from a state saved
without them.

On the card (``card``; run there with ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_deep_tiles.py -m card``): K2's table,
K3's image and K5's payload gradient against their plain versions on a
tile of about 20,000 entries at K 32,768, at the tolerances of
``chip_smoke.py``'s K2, K3 and K5 checks. This file does not import JAX.
"""

import dataclasses
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sdpgs_torch.config import RasterizeConfig, TrainConfig
from sdpgs_torch.core.camera import Camera
from sdpgs_torch.core.gaussians import Gaussians
from sdpgs_torch.data.camera_utils import LoadedCamera
from sdpgs_torch.ops.rasterize import binning
from sdpgs_torch.train import loop as tloop
from sdpgs_torch.train.state import TrainState
from sdpgs_torch.train.step import ViewBatch, loss_and_grads
from sdpgs_torch.utils import profiling
from torch_threads import few_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference.camera import Cam, View  # noqa: E402
from benchmark.reference.raster import FIELDS, Raster, render as ref_render  # noqa: E402
from benchmark.reference.step import options, view_loss  # noqa: E402

W, H, TILE = 32, 16, 16              # two 16-pixel tiles side by side
FOVX, FOVY = 2 * math.atan(0.5), 2 * math.atan(0.25)   # fx = fy = 32 px
CROWD, LIGHT = 9_000, 200            # entries of the crowded tile and of the other
CAPACITY = 12_288
SH = 3
K_DEEP = 16_384                      # the ladder's rung past 8,192
STEP = 1_000
LOSS_RTOL = 1e-6                     # the same float32 sums on both sides, in the
GRAD_RTOL = 1e-5                     # same chunked order; the leaves' norms of the gap
CUT_GAP = 1e-3                       # the reference cut to K 8,192 is this far off at least


def crowded_fields(seed: int, crowd: int = CROWD, light: int = LIGHT) -> dict:
    """Fields of a cloud at depth 2 to 3 in front of the camera at the
    origin: ``crowd`` faint Gaussians whose rects lie in tile 0 (centres
    3 to 13 px from its corner, the nearer half left of x = 8 px), and
    ``light`` in tile 1; the slots past them dead."""
    rng = np.random.default_rng(seed)
    half = crowd // 2
    u = np.concatenate([rng.uniform(3, 8, half), rng.uniform(8, 13, crowd - half),
                        rng.uniform(19, 29, light)])
    v = rng.uniform(3, 13, crowd + light)
    z = np.concatenate([np.sort(rng.uniform(2.0, 2.5, half)),
                        np.sort(rng.uniform(2.5, 3.0, crowd - half)),
                        rng.uniform(2.0, 3.0, light)])
    n = crowd + light
    opa = np.concatenate([rng.uniform(0.005, 0.02, crowd), rng.uniform(0.3, 0.8, light)])
    quat = rng.normal(size=(n, 4))
    feat = rng.normal(size=(n, 3))
    live = dict(
        xyz=np.stack([(u - 15.5) * z / 32.0, (v - 7.5) * z / 32.0, z], -1),
        features_dc=rng.uniform(-1.5, 1.5, (n, 1, 3)),
        features_rest=rng.normal(size=(n, (SH + 1) ** 2 - 1, 3)) * 0.05,
        scaling=np.full((n, 3), math.log(1e-4)),
        rotation=quat / np.linalg.norm(quat, axis=-1, keepdims=True),
        opacity=np.log(opa / (1.0 - opa))[:, None],
        language_feature=feat / np.linalg.norm(feat, axis=-1, keepdims=True))
    out = {}
    for k, a in live.items():
        full = np.full((CAPACITY,) + a.shape[1:], -10.0 if k in ("scaling", "opacity") else 0.0)
        full[:n] = a
        out[k] = full.astype(np.float32)
    out["rotation"][n:, 0] = 1.0
    out["alive"] = (np.arange(CAPACITY) < n).astype(np.float32)
    out["confidence"] = np.ones((CAPACITY, 1), np.float32)
    return out


def targets(seed: int) -> dict:
    rng = np.random.default_rng(seed + 1)
    protos = rng.normal(size=(4, 3)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=-1, keepdims=True)
    return dict(image=rng.uniform(size=(3, H, W)).astype(np.float32),
                depth=rng.uniform(1.0, 3.0, (H, W)).astype(np.float32),
                feature=rng.normal(size=(3, H, W)).astype(np.float32),
                seg=rng.integers(0, 4, (H, W)).astype(np.int32), protos=protos)


def raster_cfg(K: int) -> RasterizeConfig:
    return RasterizeConfig(tile=TILE, max_per_tile=K, max_tiles_per_gaussian=8, chunk=32)


def camera() -> Camera:
    return Camera.create(R=np.eye(3), T=np.zeros(3), fovx=FOVX, fovy=FOVY, width=W, height=H,
                         device="cpu")


def port_step(fields: dict, tg: dict, K: int):
    """The port's plain step at K: (loss, {field: gradient})."""
    cfg = TrainConfig(raster=raster_cfg(K))
    state = TrainState.create(Gaussians.from_numpy(fields, max_sh_degree=SH, device="cpu"),
                              device="cpu")
    state.step = STEP
    batch = ViewBatch(cameras=[camera()], image=torch.from_numpy(tg["image"])[None],
                      depth_mono=torch.from_numpy(tg["depth"])[None],
                      feature=torch.from_numpy(tg["feature"])[None],
                      seg_map=torch.from_numpy(tg["seg"])[None])
    g = loss_and_grads(state, batch, torch.from_numpy(tg["protos"]), torch.zeros(3), cfg, SH,
                       torch.device("cpu"))
    return float(g.loss), g.params


def reference_step(fields: dict, tg: dict, K: int):
    """The benchmark's plain reference at K: (loss, {field: gradient},
    its binning)."""
    cfg = TrainConfig(raster=raster_cfg(K))
    raster = Raster(**{f.name: getattr(cfg.raster, f.name) for f in dataclasses.fields(Raster)})
    leaves = {k: torch.from_numpy(fields[k]).requires_grad_(True) for k in FIELDS}
    cam = Cam.of(View(R=np.eye(3), T=np.zeros(3), fovx=FOVX, fovy=FOVY, width=W, height=H),
                 "cpu")
    out = ref_render(leaves, torch.from_numpy(fields["alive"]), cam, raster, torch.zeros(3), SH)
    loss, _ = view_loss(out, torch.from_numpy(tg["image"]), torch.from_numpy(tg["depth"]),
                        torch.from_numpy(tg["feature"]), torch.from_numpy(tg["seg"]),
                        torch.from_numpy(tg["protos"]),
                        options(dataclasses.asdict(cfg.optim)), STEP)
    grads = torch.autograd.grad(loss, [leaves[k] for k in FIELDS])
    return float(loss.detach()), dict(zip(FIELDS, grads)), out.bins


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()).clamp_min(1e-30))


def test_plain_step_matches_reference_past_8192():
    fields, tg = crowded_fields(0), targets(0)
    loss, grads = port_step(fields, tg, K_DEEP)
    ref_loss, ref_grads, bins = reference_step(fields, tg, K_DEEP)
    assert int(bins.counts[0]) == CROWD and bins.overflow == 0
    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    for k in FIELDS:
        assert float(torch.linalg.vector_norm(ref_grads[k])) > 0.0, k
        assert rel(grads[k], ref_grads[k]) <= GRAD_RTOL, k
    # the entries past 8,192 count: cut there, the reference moves
    cut_loss, cut_grads, cut = reference_step(fields, tg, 8192)
    assert cut.overflow == CROWD - 8192
    assert max(rel(cut_grads[k], ref_grads[k]) for k in FIELDS) > CUT_GAP


def crowded_scene(seed: int) -> SimpleNamespace:
    """The Trainer's scene surface over the crowded cloud and one view."""
    tg = targets(seed)
    view = LoadedCamera(camera=camera(), R=np.eye(3), T=np.zeros(3), fovx=FOVX, fovy=FOVY,
                        image=tg["image"], depth_mono=tg["depth"], point_feature=tg["feature"],
                        seg_map=tg["seg"], feature_dict=tg["protos"],
                        bounds=np.array([1.0, 10.0]), image_name="train0")
    return SimpleNamespace(
        model_path="", train_cameras=[view], test_cameras=[], prototypes=tg["protos"],
        gaussians=Gaussians.from_numpy(crowded_fields(seed), max_sh_degree=SH, device="cpu"),
        cameras_extent=1.0, pseudo_poses=np.zeros((0, 4, 4)))


def quiet_config(K: int) -> TrainConfig:
    """No densify, reset or pseudo window in the first iterations."""
    cfg = TrainConfig(raster=raster_cfg(K))
    cfg.optim.densify_from_iter, cfg.optim.densify_until_iter = 10_000, 0
    cfg.optim.start_sample_pseudo = 10_000
    cfg.optim.test_iterations = cfg.optim.save_iterations = ()
    cfg.optim.checkpoint_iterations = ()
    return cfg


def test_ladder_grows_past_8192_without_dropping(capsys):
    t = tloop.Trainer(quiet_config(1024), scene=crowded_scene(1), device="cpu")
    ceiling = t.max_per_tile_ceiling()
    assert ceiling == binning.max_per_tile_ceiling(2, TILE, CAPACITY, binning.CPU_BUDGET)
    assert ceiling >= K_DEEP
    with profiling.recording():
        t.train(iterations=5, log_every=1)
        tops = [s.n for s in profiling.spans() if s.name == "raster.tile_max"]
    out = capsys.readouterr().out
    assert "dropping" not in out
    for K in (1024, 2048, 4096, 8192):
        assert f"per-tile cap K={K} -> {2 * K}" in out
    assert t.cfg.raster.max_per_tile == K_DEEP
    assert "overflow=0 clipped=0" in out.splitlines()[-1]
    # the crowded tile's total at every log point (steps may move a few
    # Gaussians of the other tile into it)
    assert len(tops) == 5 and tops[0] == CROWD and min(tops) >= CROWD


@pytest.mark.parametrize("num_tiles, tile, ceiling", [
    (1 << 16, 16, 1 << 14),     # 2^16 tiles: K 2^15 would index 2^31 slots
    (70_000, 8, 1 << 14),       # 70,000 x 2^15 > 2^31 - 1
    ((1 << 21) + 1, 8, 512),    # 2,097,153 x 1,024 > 2^31 - 1
])
def test_ceiling_refuses_k_whose_indices_wrap(num_tiles, tile, ceiling):
    """With memory to spare, the int32 slot index tile * K + rank bounds K."""
    budget = 1 << 62
    got = binning.max_per_tile_ceiling(num_tiles, tile, 1 << 30, budget)
    assert got == ceiling
    assert num_tiles * got <= binning.INDEX_MAX < num_tiles * 2 * got


def test_ceilings_by_memory():
    """The buffers' bytes bound K and D at mip-NeRF 360 1/4 resolution
    (1,107 tiles, 2^22 slots) on a quarter of an 80-GB card: K 65,536
    fits, 131,072 does not; K5's entry map holds D 1,024, not 2,048."""
    T, P = 41 * 27, 1 << 22
    budget = 20 * 10 ** 9
    assert binning.k_buffer_bytes(T, 1 << 16, 32, P) <= budget
    assert binning.k_buffer_bytes(T, 1 << 17, 32, P) > budget
    assert binning.max_per_tile_ceiling(T, 32, P, budget) == 1 << 16
    assert binning.max_tiles_per_gaussian_ceiling(P, budget) == 1024


def test_scratch_words_mirror_the_kernel():
    """K2's words per tile (binning.cu: words_per_tile), which the rule
    counts, are ceil(P / 32) rounded up to whole 4-word loads."""
    src = (ROOT / "sdpgs_torch" / "csrc" / "binning.cu").read_text()
    assert "constexpr int kWordsPerThread = 4;" in src
    for P, words in ((1, 4), (128, 4), (129, 8), (3_000, 96), (1 << 22, 1 << 17)):
        assert binning.scratch_words(P) == words


def pseudo_scene(seed: int):
    from sdpgs_torch.data.synthetic import SyntheticScene

    return SyntheticScene(seed=seed, n_points=64, capacity=128, n_pseudo=4, device="cpu")


def counted_binning(monkeypatch) -> list:
    """Wrap the binning every render calls: each render's listed entries
    and largest uncapped tile total, from K2's plain version run again."""
    seen = []
    real = binning.bin_gaussians

    def wrapped(prep, width, height, cfg, tile_range=None):
        packed_s, order, n_valid = binning.sort_rects(prep, width, height, cfg)
        tx, ty = binning.tile_grid(width, height, cfg.tile)
        _, totals = binning.build_table_plain(packed_s, order, n_valid, tx * ty, tx,
                                              cfg.max_per_tile, cfg.max_tiles_per_gaussian)
        seen.append((int(torch.clamp_max(totals, cfg.max_per_tile).sum()), int(totals.max())))
        return real(prep, width, height, cfg, tile_range=tile_range)

    monkeypatch.setattr(binning, "bin_gaussians", wrapped)
    return seen


def counter_config() -> TrainConfig:
    cfg = quiet_config(16)        # K 16: some tiles overflow, tile_max is uncapped
    cfg.raster = dataclasses.replace(cfg.raster, chunk=16)
    cfg.optim.start_sample_pseudo, cfg.optim.end_sample_pseudo = 2, 5   # 3, 4 pseudo
    return cfg


def test_counters_at_log_points_equal_binning_totals(monkeypatch):
    t = tloop.Trainer(counter_config(), scene=pseudo_scene(2), device="cpu")
    t._maybe_grow_max_per_tile = lambda overflow: None     # hold K at 16
    seen = counted_binning(monkeypatch)
    with profiling.recording():
        t.train(iterations=4, log_every=2)
        recs = profiling.spans()
    entries = [s for s in recs if s.name == "raster.entries"]
    tops = [s for s in recs if s.name == "raster.tile_max"]
    # iterations 1, 2 render once each; 3, 4 twice (the pseudo view)
    assert [s.unit for s in entries] == ["2 renders", "4 renders"]
    assert [s.unit for s in tops] == ["2 renders", "4 renders"]
    assert [s.n for s in entries] == [sum(e for e, _ in seen[:2]), sum(e for e, _ in seen[2:])]
    assert [s.n for s in tops] == [max(m for _, m in seen[:2]), max(m for _, m in seen[2:])]
    assert max(m for _, m in seen) > 16                     # the uncapped total
    assert all(s.end_ns - s.start_ns < 10 ** 8 for s in entries + tops)   # empty markers
    assert int(t.state.raster_entries) == 0 and int(t.state.raster_tile_max) == 0


def test_counters_record_nothing_when_off(capsys):
    t = tloop.Trainer(counter_config(), scene=pseudo_scene(3), device="cpu")
    with profiling.recording():
        pass                                                # a new, empty stretch
    t.train(iterations=2, log_every=2)
    assert profiling.spans() == []
    assert int(t.state.raster_entries) == 0 and int(t.state.raster_tile_max) == 0
    assert "tile_max=" in capsys.readouterr().out


def test_state_without_counters_loads():
    """The counters travel with a state's arrays, and a state saved without
    them (an older checkpoint, or the JAX package's) loads with zeros."""
    state = TrainState.create(pseudo_scene(4).gaussians, device="cpu")
    state.raster_entries.fill_(7)
    state.raster_tile_max.fill_(3)
    arrays = state.to_numpy()
    back = TrainState.from_numpy(arrays, device="cpu")
    assert (int(back.raster_entries), int(back.raster_tile_max)) == (7, 3)
    for k in ("raster_entries", "raster_tile_max"):
        del arrays[k]
    old = TrainState.from_numpy(arrays, device="cpu")
    assert (int(old.raster_entries), int(old.raster_tile_max)) == (0, 0)
    assert old.raster_entries.dtype == torch.int64


# ---- on the card: K2, K3 and K5 on a tile of ~20,000 entries at K 32,768 ----

CARD_K, CARD_CROWD, CARD_TILE = 32_768, 20_000, 32
K3_TOL, K3_REL_TOL, K5_TOL = 1e-4, 1e-3, 1e-3   # chip_smoke.py's K3 and K5 gates


@pytest.fixture(scope="module")
def deep_tile():
    """A 64x64 view (four 32-pixel tiles) whose tile 0 lists CARD_CROWD
    faint Gaussians spread over it, the others a few hundred each, binned
    at K 32,768 and D 8: the payload, the sorted rects and the plain table."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(16)
    f32 = dict(generator=gen, device=dev, dtype=torch.float32)
    n_light = 300
    P = CARD_CROWD + 3 * n_light
    lo = torch.tensor([[3.0, 3.0], [35.0, 3.0], [3.0, 35.0], [35.0, 35.0]], device=dev)
    corner = torch.cat([lo[:1].expand(CARD_CROWD, 2), lo[1:].repeat_interleave(n_light, 0)])
    mean2d = corner + torch.rand((P, 2), **f32) * 26.0           # rects inside one tile
    sigma2 = 0.3 + torch.rand((P,), **f32) * 0.4
    conic = torch.stack([1.0 / sigma2, torch.zeros_like(sigma2), 1.0 / sigma2], -1)
    radius = torch.full((P,), 3.0, device=dev)
    opacity = torch.cat([0.01 + 0.03 * torch.rand((CARD_CROWD,), **f32),
                         0.2 + 0.6 * torch.rand((3 * n_light,), **f32)])
    depth = 1.0 + torch.rand((P,), **f32) * 4.0
    payload = torch.cat([mean2d, conic, opacity[:, None], torch.rand((P, 3), **f32),
                         depth[:, None], torch.randn((P, 3), **f32),
                         ], -1)
    payload = torch.cat([payload, torch.zeros_like(payload[:1])]).contiguous()
    cfg = RasterizeConfig(tile=CARD_TILE, max_per_tile=CARD_K, max_tiles_per_gaussian=8,
                          chunk=64)
    tx, ty = binning.tile_grid(64, 64, CARD_TILE)
    xmin, xmax, ymin, ymax = binning.tile_rect(mean2d, radius, tx, ty, CARD_TILE)
    packed = binning.pack_rect(xmin, xmax, ymin, ymax)
    order = torch.sort(depth, stable=True).indices
    k2_args = (packed[order].contiguous(), order.to(torch.int32),
               torch.tensor(P, dtype=torch.int32, device=dev), tx * ty, tx, CARD_K, 8)
    table, totals = binning.build_table_plain(*k2_args)
    return SimpleNamespace(dev=dev, gen=gen, payload=payload, rects=packed, cfg=cfg, tx=tx,
                           ty=ty, P=P, k2_args=k2_args, table=table.reshape(tx * ty, CARD_K),
                           totals=totals)


@pytest.mark.card
def test_k2_table_on_a_deep_tile(deep_tile):
    d = deep_tile
    assert int(d.totals[0]) == CARD_CROWD
    table, totals = binning.build_table(*d.k2_args)
    assert torch.equal(totals, d.totals)
    assert torch.equal(table.reshape(d.table.shape), d.table)


@pytest.mark.card
def test_k3_image_on_a_deep_tile(deep_tile):
    from sdpgs_torch.ops.rasterize import composite_cuda

    d = deep_tile
    counts = torch.clamp_max(d.totals, CARD_K)
    args = (d.payload, d.table, counts, d.tx, d.ty, d.cfg, d.P)
    o_k = composite_cuda.composite_gather(*args, rects=d.rects)
    o_p = composite_cuda.composite_gather_plain(*args)
    d_rgb = (o_k.values[..., :3] - o_p.values[..., :3]).abs().amax(-1)
    d_alpha = (o_k.final_t - o_p.final_t).abs()
    d_rel = ((o_k.values[..., 3:] - o_p.values[..., 3:]).abs()
             / o_p.values[..., 3:].abs().clamp_min(1.0)).amax(-1)
    bad = (d_rgb > K3_TOL) | (d_alpha > K3_TOL) | (d_rel > K3_REL_TOL)
    assert int(bad.sum()) <= bad.numel() // 1000
    # the crowded tile's pixels walk past entry 8,192
    assert int(o_k.n_visit[0].max()) > 8192


@pytest.mark.card
def test_k5_payload_gradient_on_a_deep_tile(deep_tile):
    from sdpgs_torch.ops.rasterize import composite_cuda

    d = deep_tile
    counts = torch.clamp_max(d.totals, CARD_K)
    args = (d.payload, d.table, counts, d.tx, d.ty, d.cfg, d.P)
    out, last = composite_cuda.composite_gather_fwd(*args)
    assert int(last[0].max()) > 8192          # contributors past entry 8,192
    g_values = torch.randn(tuple(out.values.shape), generator=d.gen, device=d.dev)
    g_final_t = torch.randn(tuple(out.final_t.shape), generator=d.gen, device=d.dev)
    d_k = composite_cuda.composite_gather_bwd(d.payload, d.table, d.rects, out.final_t, last,
                                              g_values, g_final_t, d.tx, d.ty, d.cfg, d.P)
    d_p = composite_cuda.composite_vjp_plain(*args, g_values, g_final_t, tiles_per_pass=1)
    diff = (d_k - d_p).abs()
    scale = d_p.abs().amax(dim=0, keepdim=True).clamp_min(1e-30)
    assert int((diff > K5_TOL * scale).any(dim=1).sum()) == 0
    assert int((d_p[:CARD_CROWD] != 0).any(dim=1).sum()) > CARD_CROWD // 2
