"""Fused preprocess + SH colour into the compositor's payload: kernels K1
(``csrc/preprocess.cu``, forward) and K4 (``csrc/preprocess_bwd.cu``, its
vjp) and their plain PyTorch versions.

Counterpart of ``sdpgs_tpu/ops/rasterize/preprocess_pallas.py``. The whole
per-Gaussian chain (world->view, projection, quaternion+scale -> EWA
cov2D -> conic -> radius, culling, SH degree 0..3 with the +0.5 clamp)
turns the Gaussians' own tensors into the [P+1, 13] payload rows of
``payload.py`` and the binning record beside them. :func:`preprocess_payload`
is the entry: on CUDA tensors an ``autograd.Function`` whose forward
launches K1 (it reads each field in place and writes the payload) and whose
backward launches K4 (from the payload's gradient to each field's, in the
field's own shape); on CPU tensors :func:`preprocess_payload_plain`, the
row chain ``pack_rows`` -> :func:`_row_math` on [rows, P] arrays ->
``split_rows`` -> ``payload.make_payload``, which autograd differentiates
(:func:`preprocess_payload_vjp_plain`, the plain version of K4).
K1 repeats :func:`_row_math` operation by operation, and K4
back-propagates through it by hand.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from sdpgs_torch import _kernels
from sdpgs_torch.core import sh as sh_lib
from sdpgs_torch.ops.rasterize.payload import NPAY, Payload, Screen, make_payload, screen_of
from sdpgs_torch.ops.rasterize.preprocess import Preprocessed, ndc_to_pixel

NGEO = 11    # x y z sx sy sz qw qx qy qz alive
NOUT = 11    # validf mx my depth conic_a conic_b conic_c radius r g b
CAMN = 39    # view(16) full_proj(16) focal_x focal_y tan_fovx tan_fovy pos(3)


def _row_math(geo, sh, cam, *, deg: int, width: int, height: int,
              near: float, low_pass: float, aux: dict | None = None):
    """The preprocess+SH chain on [NGEO, N] geometry and [3*(deg+1)^2, N]
    SH rows with the [CAMN] camera vector; returns NOUT [N] rows. ``aux``,
    when given, receives the values the backward's masks are decided on."""
    x, y, z = geo[0], geo[1], geo[2]
    s0, s1, s2 = geo[3], geo[4], geo[5]
    r, qx, qy, qz = geo[6], geo[7], geo[8], geo[9]
    alive = geo[10]
    V = [cam[i] for i in range(16)]           # row-major view
    FP = [cam[16 + i] for i in range(16)]
    fx, fy = cam[32], cam[33]
    tan_fovx, tan_fovy = cam[34], cam[35]
    cpx, cpy, cpz = cam[36], cam[37], cam[38]

    tx = V[0] * x + V[1] * y + V[2] * z + V[3]
    ty = V[4] * x + V[5] * y + V[6] * z + V[7]
    tz = V[8] * x + V[9] * y + V[10] * z + V[11]
    depth = tz

    hx = FP[0] * x + FP[1] * y + FP[2] * z + FP[3]
    hy = FP[4] * x + FP[5] * y + FP[6] * z + FP[7]
    hw = FP[12] * x + FP[13] * y + FP[14] * z + FP[15]
    inv_w = 1.0 / (hw + 1e-7)
    mx = ndc_to_pixel(hx * inv_w, width)
    my = ndc_to_pixel(hy * inv_w, height)

    R00 = 1 - 2 * (qy * qy + qz * qz)
    R01 = 2 * (qx * qy - r * qz)
    R02 = 2 * (qx * qz + r * qy)
    R10 = 2 * (qx * qy + r * qz)
    R11 = 1 - 2 * (qx * qx + qz * qz)
    R12 = 2 * (qy * qz - r * qx)
    R20 = 2 * (qx * qz - r * qy)
    R21 = 2 * (qy * qz + r * qx)
    R22 = 1 - 2 * (qx * qx + qy * qy)

    def wrow(i):
        return (
            V[4 * i + 0] * R00 + V[4 * i + 1] * R10 + V[4 * i + 2] * R20,
            V[4 * i + 0] * R01 + V[4 * i + 1] * R11 + V[4 * i + 2] * R21,
            V[4 * i + 0] * R02 + V[4 * i + 1] * R12 + V[4 * i + 2] * R22,
        )

    A00, A01, A02 = wrow(0)
    A10, A11, A12 = wrow(1)
    A20, A21, A22 = wrow(2)
    A00, A01, A02 = A00 * s0, A01 * s1, A02 * s2
    A10, A11, A12 = A10 * s0, A11 * s1, A12 * s2
    A20, A21, A22 = A20 * s0, A21 * s1, A22 * s2

    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tz_safe = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    ux, uy = tx / tz_safe, ty / tz_safe
    cx = torch.clamp(ux, -lim_x, lim_x) * tz_safe
    cy = torch.clamp(uy, -lim_y, lim_y) * tz_safe
    j00 = fx / tz_safe
    j02 = -(fx * cx) / (tz_safe * tz_safe)
    j11 = fy / tz_safe
    j12 = -(fy * cy) / (tz_safe * tz_safe)
    m00 = j00 * A00 + j02 * A20
    m01 = j00 * A01 + j02 * A21
    m02 = j00 * A02 + j02 * A22
    m10 = j11 * A10 + j12 * A20
    m11 = j11 * A11 + j12 * A21
    m12 = j11 * A12 + j12 * A22

    a = m00 * m00 + m01 * m01 + m02 * m02 + low_pass
    b = m00 * m10 + m01 * m11 + m02 * m12
    c = m10 * m10 + m11 * m11 + m12 * m12 + low_pass

    det = a * c - b * b
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    ca, cb, cc = c * inv_det, -b * inv_det, a * inv_det

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(mid + disc, 0.0)))

    validf = (
        (depth > near) & (det != 0.0) & (radius > 0.0) & (alive > 0.0)
        & torch.isfinite(depth)
    ).to(geo.dtype)
    radius = radius * validf

    # SH colour at the normalized view direction (colors_from_sh,
    # reference gaussian_renderer/__init__.py:269-274)
    dx, dy_, dz = x - cpx, y - cpy, z - cpz
    inv_n = torch.rsqrt(dx * dx + dy_ * dy_ + dz * dz + 1e-24)
    dx, dy_, dz = dx * inv_n, dy_ * inv_n, dz * inv_n

    def coef(k, ch):
        return sh[3 * k + ch]

    rgb = []
    for ch in range(3):
        res = sh_lib.C0 * coef(0, ch)
        if deg > 0:
            res = (
                res - sh_lib.C1 * dy_ * coef(1, ch)
                + sh_lib.C1 * dz * coef(2, ch)
                - sh_lib.C1 * dx * coef(3, ch)
            )
            if deg > 1:
                xx, yy, zz = dx * dx, dy_ * dy_, dz * dz
                xy, yz2, xz = dx * dy_, dy_ * dz, dx * dz
                C2 = sh_lib.C2
                res = (
                    res
                    + C2[0] * xy * coef(4, ch)
                    + C2[1] * yz2 * coef(5, ch)
                    + C2[2] * (2.0 * zz - xx - yy) * coef(6, ch)
                    + C2[3] * xz * coef(7, ch)
                    + C2[4] * (xx - yy) * coef(8, ch)
                )
                if deg > 2:
                    C3 = sh_lib.C3
                    res = (
                        res
                        + C3[0] * dy_ * (3.0 * xx - yy) * coef(9, ch)
                        + C3[1] * xy * dz * coef(10, ch)
                        + C3[2] * dy_ * (4.0 * zz - xx - yy) * coef(11, ch)
                        + C3[3] * dz * (2.0 * zz - 3.0 * xx - 3.0 * yy) * coef(12, ch)
                        + C3[4] * dx * (4.0 * zz - xx - yy) * coef(13, ch)
                        + C3[5] * dz * (xx - yy) * coef(14, ch)
                        + C3[6] * dx * (xx - 3.0 * yy) * coef(15, ch)
                    )
        rgb.append(torch.clamp_min(res + 0.5, 0.0))
        if aux is not None:
            aux[f"res{ch}"] = res + 0.5

    if aux is not None:
        aux.update(ux=ux, uy=uy, lim_x=lim_x, lim_y=lim_y, tz=tz, det=det)
    return (validf, mx, my, depth, ca, cb, cc, radius, rgb[0], rgb[1], rgb[2])


def _cam_vec(cam) -> torch.Tensor:
    """The [CAMN] f32 camera vector, on the camera's device."""
    f32 = torch.float32
    return torch.cat([
        cam.view.to(f32).reshape(-1),
        cam.full_proj.to(f32).reshape(-1),
        torch.stack([cam.focal_x, cam.focal_y, cam.tan_fovx, cam.tan_fovy]).to(f32),
        cam.cam_pos.to(f32).reshape(3),
    ])


def preprocess_rows_plain(geoT, shT, cam_vec, deg: int, width: int, height: int,
                          near: float = 0.2, low_pass: float = 0.3) -> torch.Tensor:
    """Plain PyTorch version of K1: [NGEO, P], [3K, P] -> [NOUT, P]; autograd
    differentiates it (the plain version of K4)."""
    _kernels.plain_call("preprocess")
    cam = cam_vec.to(device=geoT.device, dtype=torch.float32)
    rows = _row_math(geoT, shT, cam, deg=deg, width=width, height=height,
                     near=near, low_pass=low_pass)
    return torch.stack(rows)


# Bits of K4's mask word (csrc/preprocess_math.cuh, kMask*).
MASK_CLIP_X, MASK_CLIP_Y, MASK_TZ_SMALL, MASK_DET_ZERO, MASK_RGB0 = 1, 2, 4, 8, 16


def row_masks_plain(geoT, shT, cam_vec, deg: int, width: int, height: int,
                    near: float = 0.2, low_pass: float = 0.3) -> torch.Tensor:
    """The mask word K4 reports, from the plain version's own floats: which
    side of each step function (clip, tz_safe, det_safe, rgb clamp) the
    gradient of each Gaussian took. [P] int32."""
    aux: dict = {}
    cam = cam_vec.to(device=geoT.device, dtype=torch.float32)
    with torch.no_grad():
        _row_math(geoT, shT, cam, deg=deg, width=width, height=height, near=near,
                  low_pass=low_pass, aux=aux)
    ux, uy, lx, ly = aux["ux"], aux["uy"], aux["lim_x"], aux["lim_y"]
    bits = [((ux >= -lx) & (ux <= lx), MASK_CLIP_X), ((uy >= -ly) & (uy <= ly), MASK_CLIP_Y),
            (torch.abs(aux["tz"]) < 1e-6, MASK_TZ_SMALL), (aux["det"] == 0.0, MASK_DET_ZERO)]
    bits += [(aux[f"res{ch}"] >= 0.0, MASK_RGB0 << ch) for ch in range(3)]
    word = torch.zeros(geoT.shape[1], dtype=torch.int32, device=geoT.device)
    for cond, bit in bits:
        word |= cond.to(torch.int32) * bit
    return word


def _host_cam(cam_vec) -> torch.Tensor:
    cam_host = cam_vec.detach().to("cpu", torch.float32).contiguous()
    if tuple(cam_host.shape) != (CAMN,):
        raise ValueError(f"cam_vec: expected shape ({CAMN},), got {tuple(cam_host.shape)}")
    return cam_host


def pack_rows(xyz, scale, quat, features, alive, sh_degree: int):
    """[P,3] xyz, [P,3] activated scale, [P,4] normalized quat, [P,K,3] SH,
    [P] alive -> the plain version's [NGEO, P] and [3*(deg+1)^2, P] rows."""
    P = xyz.shape[0]
    K = (sh_degree + 1) ** 2
    f32 = torch.float32
    geoT = torch.cat([xyz.T, scale.T, quat.T, alive.reshape(1, P)], dim=0)
    shT = features[:, :K, :].reshape(P, K * 3).T
    return geoT.to(f32).contiguous(), shT.to(f32).contiguous()


def split_rows(out) -> tuple[Preprocessed, torch.Tensor]:
    """The plain version's [NOUT, P] rows as (Preprocessed, color [P, 3])."""
    prep = Preprocessed(
        valid=out[0] > 0.0,
        mean2d=torch.stack([out[1], out[2]], dim=-1),
        depth=out[3],
        conic=torch.stack([out[4], out[5], out[6]], dim=-1),
        radius=out[7],
    )
    color = torch.stack([out[8], out[9], out[10]], dim=-1)
    return prep, color


class FieldGrads(NamedTuple):
    """K4's gradients, each in its field's shape (the order of its
    outputs); ``means2d_offset`` and ``color`` None where the forward had
    none. ``quat`` is the transpose of [4, P] rows: ``normalize_quat``'s
    backward sums over the four components, PyTorch rounds that sum
    differently over a packed last dimension, and in this layout the
    rotation's gradient has the bits the plain version's ``pack_rows``
    chain gives it."""

    xyz: torch.Tensor
    scale: torch.Tensor
    quat: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    opacity: torch.Tensor
    feature: torch.Tensor
    means2d_offset: Optional[torch.Tensor]
    color: Optional[torch.Tensor]


def preprocess_payload_plain(xyz, scale, quat, features_dc, features_rest, alive, opacity,
                             feature, cam, sh_degree: int, *, color=None, means2d_offset=None,
                             near: float = 0.2, low_pass: float = 0.3) -> Payload:
    """Plain PyTorch version of K1, and through autograd of K4: the row
    chain ``pack_rows`` -> :func:`_row_math` -> ``split_rows`` ->
    ``make_payload``, on the tensors' own device. Arguments as
    :func:`preprocess_payload`."""
    features = torch.cat([features_dc, features_rest], dim=1)
    geoT, shT = pack_rows(xyz, scale, quat, features, alive, sh_degree)
    prep, rgb = split_rows(preprocess_rows_plain(geoT, shT, _cam_vec(cam), sh_degree,
                                                 int(cam.width), int(cam.height), near, low_pass))
    if means2d_offset is not None:
        prep = prep._replace(mean2d=prep.mean2d + means2d_offset)
    rows = make_payload(prep, opacity, rgb if color is None else color, feature)
    return Payload(rows, screen_of(prep))


def preprocess_payload_vjp_plain(xyz, scale, quat, features_dc, features_rest, alive, d_rows,
                                 cam, sh_degree: int, *, color: bool = False,
                                 means2d_offset: bool = False, near: float = 0.2,
                                 low_pass: float = 0.3) -> FieldGrads:
    """Plain PyTorch version of K4: autograd's gradient of every field at
    the payload gradient ``d_rows`` [P+1, NPAY], through
    :func:`preprocess_payload_plain` (the opacity's, feature's, colour's and
    offset's gradients read no value of theirs). Arguments as
    :func:`preprocess_payload_bwd`, the camera as a ``Camera``."""
    _kernels.plain_call("preprocess_bwd")
    P, dev = xyz.shape[0], xyz.device
    with torch.enable_grad():
        fields = [t.detach().requires_grad_() for t in (xyz, scale, quat, features_dc,
                                                       features_rest)]
        extra = {"opacity": torch.ones(P, device=dev), "feature": torch.zeros((P, 3), device=dev)}
        if means2d_offset:
            extra["means2d_offset"] = torch.zeros((P, 2), device=dev)
        if color:
            extra["color"] = torch.zeros((P, 3), device=dev)
        extra = {k: v.requires_grad_() for k, v in extra.items()}
        rows = preprocess_payload_plain(*fields, alive, extra["opacity"], extra["feature"], cam,
                                        sh_degree, color=extra.get("color"),
                                        means2d_offset=extra.get("means2d_offset"), near=near,
                                        low_pass=low_pass).rows
        got = torch.autograd.grad(rows, fields + list(extra.values()), d_rows)
    names = ("xyz", "scale", "quat", "features_dc", "features_rest") + tuple(extra)
    return FieldGrads(**{**dict.fromkeys(FieldGrads._fields), **dict(zip(names, got))})


def _check_fields(xyz, scale, quat, features_dc, features_rest, alive, deg: int) -> int:
    """What K1 and K4 read of every Gaussian; returns P."""
    if not 0 <= deg <= 3:
        raise ValueError(f"SH degree {deg} outside 0..3")
    P = xyz.shape[0]
    f32 = torch.float32
    for t, name, shape in ((xyz, "xyz", (P, 3)), (scale, "scale", (P, 3)),
                           (quat, "quat", (P, 4)), (features_dc, "features_dc", (P, 1, 3)),
                           (alive, "alive", (P,))):
        _kernels.check(t, name, f32, shape)
    rest = tuple(features_rest.shape)
    if len(rest) != 3 or rest[0] != P or rest[2] != 3 or rest[1] < (deg + 1) ** 2 - 1:
        raise ValueError(f"features_rest: expected [{P}, >= {(deg + 1) ** 2 - 1}, 3], "
                         f"got {list(rest)}")
    _kernels.check(features_rest, "features_rest", f32, rest)
    return P


def preprocess_payload_fwd(xyz, scale, quat, features_dc, features_rest, alive, opacity,
                           feature, cam_vec, deg: int, width: int, height: int,
                           near: float = 0.2, low_pass: float = 0.3, color=None,
                           means2d_offset=None) -> Payload:
    """Launch K1 on CUDA tensors autograd does not track (arguments as
    :func:`preprocess_payload`, the camera as its [CAMN] vector)."""
    P = _check_fields(xyz, scale, quat, features_dc, features_rest, alive, deg)
    f32 = torch.float32
    _kernels.check(opacity, "opacity", f32, (P,))
    _kernels.check(feature, "feature", f32, (P, 3))
    if color is not None:
        _kernels.check(color, "color", f32, (P, 3))
    if means2d_offset is not None:
        _kernels.check(means2d_offset, "means2d_offset", f32, (P, 2))
    cam_host = _host_cam(cam_vec)
    dev = xyz.device
    rows = torch.empty((P + 1, NPAY), dtype=f32, device=dev)
    screen = Screen(valid=torch.empty((P,), dtype=torch.bool, device=dev),
                    mean2d=torch.empty((P, 2), dtype=f32, device=dev),
                    depth=torch.empty((P,), dtype=f32, device=dev),
                    radius=torch.empty((P,), dtype=f32, device=dev))
    ptr = _kernels.ptr
    _kernels.launch(
        "preprocess", "sdpgs_preprocess_fwd",
        ptr(xyz), ptr(scale), ptr(quat), ptr(features_dc), ptr(features_rest),
        3 * features_rest.shape[1], ptr(alive), ptr(opacity), ptr(feature), ptr(color),
        ptr(means2d_offset), ptr(cam_host), ptr(rows), ptr(screen.mean2d), ptr(screen.depth),
        ptr(screen.radius), ptr(screen.valid), P, deg, int(width), int(height), float(near),
        float(low_pass), _kernels.stream(dev),
    )
    return Payload(rows, screen)


def preprocess_payload_bwd(xyz, scale, quat, features_dc, features_rest, alive, d_rows,
                           cam_vec, deg: int, width: int, height: int, near: float = 0.2,
                           low_pass: float = 0.3, color: bool = False,
                           means2d_offset: bool = False, masks=None) -> FieldGrads:
    """Launch K4: every field's gradient from the payload's ``d_rows``
    [P+1, NPAY], on CUDA tensors autograd does not track. ``color`` and
    ``means2d_offset`` say whether the forward had them (their gradients
    are then returned, and a given colour leaves the SH none). ``masks``,
    an int32 [P] tensor, receives each Gaussian's mask word when given."""
    P = _check_fields(xyz, scale, quat, features_dc, features_rest, alive, deg)
    _kernels.check(d_rows, "d_rows", torch.float32, (P + 1, NPAY))
    if masks is not None:
        _kernels.check(masks, "masks", torch.int32, (P,))
    cam_host = _host_cam(cam_vec)
    empty = torch.empty_like
    grads = FieldGrads(
        xyz=empty(xyz), scale=empty(scale), quat=quat.new_empty((4, P)).T,
        features_dc=empty(features_dc),
        features_rest=empty(features_rest), opacity=empty(alive),
        feature=empty(xyz),
        means2d_offset=torch.empty((P, 2), dtype=torch.float32, device=xyz.device)
        if means2d_offset else None,
        color=empty(xyz) if color else None)
    ptr = _kernels.ptr
    _kernels.launch(
        "preprocess_bwd", "sdpgs_preprocess_bwd",
        ptr(xyz), ptr(scale), ptr(quat), ptr(features_dc), ptr(features_rest),
        3 * features_rest.shape[1], ptr(alive), ptr(d_rows), int(bool(color)), ptr(cam_host),
        *(ptr(t) for t in grads), ptr(masks), P, deg, int(width), int(height), float(near),
        float(low_pass), _kernels.stream(xyz.device),
    )
    return grads


class _PreprocessPayload(torch.autograd.Function):
    """K1 forward, K4 backward. The launchers get detached tensors (no
    copy): autograd tracks them here, not inside a kernel. Only the payload
    rows carry a gradient."""

    @staticmethod
    def forward(ctx, xyz, scale, quat, features_dc, features_rest, alive, opacity, feature,
                color, means2d_offset, cam_host, deg, width, height, near, low_pass):
        fields = tuple(t.detach() for t in (xyz, scale, quat, features_dc, features_rest,
                                            alive))
        extra = tuple(None if t is None else t.detach() for t in (color, means2d_offset))
        args = (cam_host, deg, width, height, near, low_pass)
        out = preprocess_payload_fwd(*fields, opacity.detach(), feature.detach(), *args,
                                     color=extra[0], means2d_offset=extra[1])
        ctx.save_for_backward(*fields)
        ctx.args = args
        ctx.has = tuple(t is not None for t in extra)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*out.screen)
        return (out.rows, *out.screen)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_rows, *_):
        if d_rows is None:
            return (None,) * 16
        g = preprocess_payload_bwd(*ctx.saved_tensors, d_rows.contiguous(), *ctx.args,
                                   color=ctx.has[0], means2d_offset=ctx.has[1])
        return (g.xyz, g.scale, g.quat, g.features_dc, g.features_rest, None, g.opacity,
                g.feature, g.color, g.means2d_offset) + (None,) * 6


def preprocess_payload(xyz, scale, quat, features_dc, features_rest, alive, opacity, feature,
                       cam, sh_degree: int, *, color=None, means2d_offset=None,
                       near: float = 0.2, low_pass: float = 0.3) -> Payload:
    """One view's payload rows and binning record from the Gaussians' own
    tensors: K1 (backward K4) on CUDA tensors, the plain version on CPU
    tensors.

    xyz [P, 3], scale [P, 3] (activated), quat [P, 4] (normalized),
    features_dc [P, 1, 3], features_rest [P, >= (deg+1)^2 - 1, 3] (only the
    first (deg+1)^2 - 1 coefficients are read), alive [P], opacity [P]
    (activated), feature [P, 3]: f32, contiguous. ``color`` [P, 3] takes the
    place of the SH colour; ``means2d_offset`` [P, 2] is added to the screen
    centres (its gradient is the payload's mean2d gradient). ``cam`` may
    live on the host: the kernels take it by value. The payload rows are
    differentiable with respect to every field but alive."""
    if not xyz.is_cuda:
        return preprocess_payload_plain(xyz, scale, quat, features_dc, features_rest, alive,
                                        opacity, feature, cam, sh_degree, color=color,
                                        means2d_offset=means2d_offset, near=near,
                                        low_pass=low_pass)
    rows, *screen = _PreprocessPayload.apply(
        xyz, scale, quat, features_dc, features_rest, alive, opacity, feature, color,
        means2d_offset, _host_cam(_cam_vec(cam)), sh_degree, int(cam.width), int(cam.height),
        float(near), float(low_pass))
    return Payload(rows, Screen(*screen))
