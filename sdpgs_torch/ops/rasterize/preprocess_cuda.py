"""Fused preprocess + SH colour: kernels K1 (``csrc/preprocess.cu``,
forward) and K4 (``csrc/preprocess_bwd.cu``, its vjp) and their plain
PyTorch versions.

Counterpart of ``sdpgs_tpu/ops/rasterize/preprocess_pallas.py``. The whole
per-Gaussian chain (world->view, projection, quaternion+scale -> EWA
cov2D -> conic -> radius, culling, SH degree 0..3 with the +0.5 clamp)
runs on row-major [rows, P] arrays: 11 geometry rows in, 11 rows out.
:func:`_row_math` is the plain version, a copy of the JAX row math; K1
repeats it operation by operation, and K4 back-propagates through it by
hand. On CUDA tensors :func:`preprocess_rows` is an ``autograd.Function``
whose forward launches K1 and whose backward launches K4; on CPU tensors
autograd runs through :func:`_row_math`.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from sdpgs_torch import _kernels
from sdpgs_torch.core import sh as sh_lib
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


def preprocess_vjp_plain(geoT, shT, cam_vec, ct, deg: int, width: int, height: int,
                         near: float = 0.2, low_pass: float = 0.3):
    """Plain PyTorch version of K4: autograd's vjp of :func:`_row_math` at
    cotangent ``ct`` [NOUT, P]; returns (d geoT, d shT)."""
    _kernels.plain_call("preprocess_bwd")
    with torch.enable_grad():
        g = geoT.detach().requires_grad_()
        s = shT.detach().requires_grad_()
        cam = cam_vec.to(device=geoT.device, dtype=torch.float32)
        rows = torch.stack(_row_math(g, s, cam, deg=deg, width=width, height=height,
                                     near=near, low_pass=low_pass))
        return torch.autograd.grad(rows, (g, s), ct)


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


def _check_rows(geoT, shT, deg: int) -> None:
    if not 0 <= deg <= 3:
        raise ValueError(f"SH degree {deg} outside 0..3")
    P = geoT.shape[1]
    _kernels.check(geoT, "geoT", torch.float32, (NGEO, P))
    _kernels.check(shT, "shT", torch.float32, (3 * (deg + 1) ** 2, P))


def preprocess_rows_fwd(geoT, shT, cam_vec, deg: int, width: int, height: int,
                        near: float = 0.2, low_pass: float = 0.3) -> torch.Tensor:
    """Launch K1 on CUDA tensors autograd does not track: [NOUT, P]."""
    _check_rows(geoT, shT, deg)
    cam_host = _host_cam(cam_vec)
    P = geoT.shape[1]
    out = torch.empty((NOUT, P), dtype=torch.float32, device=geoT.device)
    _kernels.launch(
        "preprocess", "sdpgs_preprocess_fwd",
        _kernels.ptr(geoT), _kernels.ptr(shT), _kernels.ptr(cam_host), _kernels.ptr(out),
        P, deg, int(width), int(height), float(near), float(low_pass),
        _kernels.stream(geoT.device),
    )
    return out


def preprocess_rows_bwd(geoT, shT, cam_vec, ct, deg: int, width: int, height: int,
                        near: float = 0.2, low_pass: float = 0.3, masks=None):
    """Launch K4: the vjp of K1 at cotangent ``ct`` [NOUT, P] on CUDA
    tensors autograd does not track; returns (d geoT, d shT). ``masks``, an
    int32 [P] tensor, receives each Gaussian's mask word when given."""
    _check_rows(geoT, shT, deg)
    P = geoT.shape[1]
    _kernels.check(ct, "ct", torch.float32, (NOUT, P))
    if masks is not None:
        _kernels.check(masks, "masks", torch.int32, (P,))
    cam_host = _host_cam(cam_vec)
    dgeo = torch.empty_like(geoT)
    dsh = torch.empty_like(shT)
    _kernels.launch(
        "preprocess_bwd", "sdpgs_preprocess_bwd",
        _kernels.ptr(geoT), _kernels.ptr(shT), _kernels.ptr(ct), _kernels.ptr(cam_host),
        _kernels.ptr(dgeo), _kernels.ptr(dsh), _kernels.ptr(masks), P, deg, int(width),
        int(height), float(near), float(low_pass), _kernels.stream(geoT.device),
    )
    return dgeo, dsh


class _PreprocessRows(torch.autograd.Function):
    """K1 forward, K4 backward. The launchers get detached tensors (no
    copy): autograd tracks them here, not inside a kernel."""

    @staticmethod
    def forward(ctx, geoT, shT, cam_vec, deg, width, height, near, low_pass):
        geoT, shT = geoT.detach(), shT.detach()
        ctx.save_for_backward(geoT, shT)
        ctx.args = (_host_cam(cam_vec), deg, width, height, near, low_pass)
        return preprocess_rows_fwd(geoT, shT, *ctx.args)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        geoT, shT = ctx.saved_tensors
        cam_host, deg, width, height, near, low_pass = ctx.args
        dgeo, dsh = preprocess_rows_bwd(geoT, shT, cam_host, ct.contiguous(), deg, width,
                                        height, near, low_pass)
        return dgeo, dsh, None, None, None, None, None, None


def preprocess_rows(geoT, shT, cam_vec, deg: int, width: int, height: int,
                    near: float = 0.2, low_pass: float = 0.3) -> torch.Tensor:
    """K1 (backward K4) on CUDA tensors, the plain version on CPU tensors.

    geoT [NGEO, P] and shT [3*(deg+1)^2, P] f32; cam_vec [CAMN] (read on
    the host: it is passed to the kernels by value). Returns [NOUT, P],
    differentiable with respect to geoT and shT."""
    if not geoT.is_cuda:
        return preprocess_rows_plain(geoT, shT, cam_vec, deg, width, height,
                                     near, low_pass)
    return _PreprocessRows.apply(geoT, shT, cam_vec, deg, int(width), int(height),
                                 float(near), float(low_pass))


def pack_rows(xyz, scale, quat, features, alive, sh_degree: int):
    """[P,3] xyz, [P,3] activated scale, [P,4] normalized quat, [P,K,3] SH,
    [P] alive -> the kernel's [NGEO, P] and [3*(deg+1)^2, P] row inputs."""
    P = xyz.shape[0]
    K = (sh_degree + 1) ** 2
    f32 = torch.float32
    geoT = torch.cat([xyz.T, scale.T, quat.T, alive.reshape(1, P)], dim=0)
    shT = features[:, :K, :].reshape(P, K * 3).T
    return geoT.to(f32).contiguous(), shT.to(f32).contiguous()


def preprocess_color(xyz, scale, quat, features, alive, cam, sh_degree: int,
                     near: float = 0.2, low_pass: float = 0.3
                     ) -> tuple[Preprocessed, torch.Tensor]:
    """Fused preprocess + SH colour; returns (Preprocessed, color [P, 3]),
    differentiable with respect to xyz, scale, quat and features."""
    geoT, shT = pack_rows(xyz, scale, quat, features, alive, sh_degree)
    out = preprocess_rows(geoT, shT, _cam_vec(cam), sh_degree, int(cam.width),
                          int(cam.height), near, low_pass)
    prep = Preprocessed(
        valid=out[0] > 0.0,
        mean2d=torch.stack([out[1], out[2]], dim=-1),
        depth=out[3],
        conic=torch.stack([out[4], out[5], out[6]], dim=-1),
        radius=out[7],
    )
    color = torch.stack([out[8], out[9], out[10]], dim=-1)
    return prep, color
