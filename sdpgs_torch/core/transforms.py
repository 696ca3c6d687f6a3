"""Rotation / scaling / covariance math, batched over leading dimensions.

Counterpart of ``sdpgs_tpu/core/transforms.py``; the formulas follow the
reference (general_utils.py:88-109, forward.cu:118-152).
"""

from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) [..., 4] stored as (w, x, y, z).

    Smooth norm so the gradient is 0 (not NaN) at q == 0: dead padding
    slots can carry zero quaternions."""
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps * eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3].
    The caller normalizes."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y)],
        dim=-1,
    )
    row1 = torch.stack(
        [2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x)],
        dim=-1,
    )
    row2 = torch.stack(
        [2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y)],
        dim=-1,
    )
    return torch.stack([row0, row1, row2], dim=-2)


def build_covariance_3d(
    scale: torch.Tensor, quat: torch.Tensor, scale_modifier: float = 1.0
) -> torch.Tensor:
    """World covariance [..., 3, 3] = R diag(s^2) R^T from activated scale
    [..., 3] and normalized quaternion [..., 4] (forward.cu:118-152)."""
    rot = quat_to_rotmat(quat)
    s2 = torch.square(scale * scale_modifier)
    return torch.einsum("...ij,...j,...kj->...ik", rot, s2, rot)


def covariance_to_symm6(cov: torch.Tensor) -> torch.Tensor:
    """Pack symmetric [..., 3, 3] covariance into [..., 6] upper triangle
    (xx, xy, xz, yy, yz, zz), the reference's storage order."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )


def symm6_to_covariance(sym: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`covariance_to_symm6`."""
    xx, xy, xz, yy, yz, zz = (sym[..., i] for i in range(6))
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Logit; reference/utils/general_utils.py:18."""
    return torch.log(x / (1.0 - x))
