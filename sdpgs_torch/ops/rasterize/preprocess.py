"""Per-Gaussian screen-space preprocessing in plain PyTorch.

Counterpart of ``sdpgs_tpu/ops/rasterize/preprocess.py`` (reference
forward.cu:74-256): EWA 2D covariance with the J*W Jacobian, 0.3 low-pass
dilation, conic inversion, 3-sigma pixel radius, near-plane culling at
z <= 0.2. These are the JAX package's XLA paths, not kernels: ``render``
takes the fused kernel path of ``preprocess_cuda.py`` instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdpgs_torch.core.camera import Camera


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities, all [P, ...]."""

    valid: torch.Tensor    # [P] bool: survives culling, det != 0, radius > 0
    mean2d: torch.Tensor   # [P, 2] pixel-space center
    depth: torch.Tensor    # [P] view-space z
    conic: torch.Tensor    # [P, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor   # [P] 3-sigma screen radius (pixels, ceil)


def ndc_to_pixel(v: torch.Tensor, size: int) -> torch.Tensor:
    """reference auxiliary.h:41-44."""
    return ((v + 1.0) * size - 1.0) * 0.5


def _finish(depth, mean2d, a, b, c, alive, near) -> Preprocessed:
    det = a * c - b * b
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(mid + disc, 0.0)))
    valid = ((depth > near) & (det != 0.0) & (radius > 0.0) & (alive > 0.0)
             & torch.isfinite(depth))
    return Preprocessed(valid=valid, mean2d=mean2d, depth=depth, conic=conic,
                        radius=torch.where(valid, radius, torch.zeros_like(radius)))


def project_points(xyz: torch.Tensor, cam: Camera) -> tuple[torch.Tensor, torch.Tensor]:
    """World points [P,3] -> (pixel xy [P,2], view-space z [P])."""
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=-1)
    p_view = hom @ cam.view.T
    p_hom = hom @ cam.full_proj.T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    ndc = p_hom[:, :3] * p_w[:, None]
    xy = torch.stack([ndc_to_pixel(ndc[:, 0], cam.width),
                      ndc_to_pixel(ndc[:, 1], cam.height)], dim=-1)
    return xy, p_view[:, 2]


def ewa_cov2d(xyz: torch.Tensor, cov3d: torch.Tensor, cam: Camera,
              low_pass: float = 0.3) -> torch.Tensor:
    """EWA projection of world covariance [P,3,3] to the packed 2D screen
    covariance [P,3] (xx, xy, yy) with low-pass dilation (forward.cu:74-113)."""
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=-1)
    t = (hom @ cam.view.T)[:, :3]
    lim_x = 1.3 * cam.tan_fovx
    lim_y = 1.3 * cam.tan_fovy
    tz = t[:, 2]
    tz = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    tx = torch.clamp(t[:, 0] / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(t[:, 1] / tz, -lim_y, lim_y) * tz
    fx, fy = cam.focal_x, cam.focal_y
    zero = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([fx / tz, zero, -(fx * tx) / (tz * tz)], dim=-1),
        torch.stack([zero, fy / tz, -(fy * ty) / (tz * tz)], dim=-1),
    ], dim=-2)                                              # [P, 2, 3]
    W = cam.view[:3, :3]
    JW = torch.einsum("pij,jk->pik", J, W)
    cov2d = torch.einsum("pik,pkl,pjl->pij", JW, cov3d, JW)
    return torch.stack([cov2d[:, 0, 0] + low_pass, cov2d[:, 0, 1],
                        cov2d[:, 1, 1] + low_pass], dim=-1)


def preprocess(xyz, cov3d, cam: Camera, alive, near: float = 0.2,
               low_pass: float = 0.3) -> Preprocessed:
    """Cull + project + invert covariance + screen radius from a world
    covariance (forward.cu:155-256)."""
    mean2d, depth = project_points(xyz, cam)
    cov = ewa_cov2d(xyz, cov3d, cam, low_pass)
    return _finish(depth, mean2d, cov[:, 0], cov[:, 1], cov[:, 2], alive, near)


def preprocess_fused(xyz, scale, quat, cam: Camera, alive, near: float = 0.2,
                     low_pass: float = 0.3, scale_modifier: float = 1.0) -> Preprocessed:
    """Scalar-expanded preprocess from activated scale [P,3] and normalized
    quaternion [P,4] (w, x, y, z): cov3D -> EWA cov2D -> conic -> radius
    without per-Gaussian 3x3 matrices. Same math as :func:`preprocess`."""
    V = cam.view
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    tx = V[0, 0] * x + V[0, 1] * y + V[0, 2] * z + V[0, 3]
    ty = V[1, 0] * x + V[1, 1] * y + V[1, 2] * z + V[1, 3]
    tz = V[2, 0] * x + V[2, 1] * y + V[2, 2] * z + V[2, 3]

    FP = cam.full_proj
    hx = FP[0, 0] * x + FP[0, 1] * y + FP[0, 2] * z + FP[0, 3]
    hy = FP[1, 0] * x + FP[1, 1] * y + FP[1, 2] * z + FP[1, 3]
    hw = FP[3, 0] * x + FP[3, 1] * y + FP[3, 2] * z + FP[3, 3]
    inv_w = 1.0 / (hw + 1e-7)
    mean2d = torch.stack([ndc_to_pixel(hx * inv_w, cam.width),
                          ndc_to_pixel(hy * inv_w, cam.height)], dim=-1)

    r, qx, qy, qz = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    R = ((1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - r * qz), 2 * (qx * qz + r * qy)),
         (2 * (qx * qy + r * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - r * qx)),
         (2 * (qx * qz - r * qy), 2 * (qy * qz + r * qx), 1 - 2 * (qx * qx + qy * qy)))
    s = [scale[:, j] * scale_modifier for j in range(3)]
    # A = W @ (R diag(s)), W the view rotation
    A = [[(V[i, 0] * R[0][j] + V[i, 1] * R[1][j] + V[i, 2] * R[2][j]) * s[j]
          for j in range(3)] for i in range(3)]

    lim_x = 1.3 * cam.tan_fovx
    lim_y = 1.3 * cam.tan_fovy
    tz_safe = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    cx = torch.clamp(tx / tz_safe, -lim_x, lim_x) * tz_safe
    cy = torch.clamp(ty / tz_safe, -lim_y, lim_y) * tz_safe
    fx, fy = cam.focal_x, cam.focal_y
    j00 = fx / tz_safe
    j02 = -(fx * cx) / (tz_safe * tz_safe)
    j11 = fy / tz_safe
    j12 = -(fy * cy) / (tz_safe * tz_safe)
    m0 = [j00 * A[0][j] + j02 * A[2][j] for j in range(3)]
    m1 = [j11 * A[1][j] + j12 * A[2][j] for j in range(3)]
    a = m0[0] * m0[0] + m0[1] * m0[1] + m0[2] * m0[2] + low_pass
    b = m0[0] * m1[0] + m0[1] * m1[1] + m0[2] * m1[2]
    c = m1[0] * m1[0] + m1[1] * m1[1] + m1[2] * m1[2] + low_pass
    return _finish(tz, mean2d, a, b, c, alive, near)
