"""Pinhole cameras of the reference (copied from ``sdpgs_torch/core/camera.py``).

A view is described by ``View``: the COLMAP-style C2W rotation ``R``, the
W2C translation ``T``, the fields of view and the image size. The
matrices are built in float64 numpy and cast, as the program builds
them, so both sides see the same bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class View:
    R: np.ndarray      # [3, 3] camera-to-world rotation
    T: np.ndarray      # [3] world-to-camera translation
    fovx: float
    fovy: float
    width: int
    height: int


def world_to_view(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = T
    Rt[3, 3] = 1.0
    return Rt.astype(np.float32)


def projection(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / math.tan(fovx * 0.5)
    P[1, 1] = 1.0 / math.tan(fovy * 0.5)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


@dataclass
class Cam:
    """A view's f32 tensors on one device."""

    view: torch.Tensor        # [4, 4] world -> camera
    full_proj: torch.Tensor   # [4, 4]
    cam_pos: torch.Tensor     # [3]
    tan_fovx: torch.Tensor    # 0-d
    tan_fovy: torch.Tensor    # 0-d
    width: int
    height: int

    @classmethod
    def of(cls, v: View, device) -> "Cam":
        view = world_to_view(np.asarray(v.R), np.asarray(v.T))
        full = (projection(0.01, 100.0, v.fovx, v.fovy) @ view).astype(np.float32)
        pos = np.linalg.inv(view)[:3, 3].astype(np.float32)

        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        return cls(t(view), t(full), t(pos), t(np.float32(math.tan(v.fovx * 0.5))),
                   t(np.float32(math.tan(v.fovy * 0.5))), int(v.width), int(v.height))

    def vec(self) -> torch.Tensor:
        """view(16) full_proj(16) focal_x focal_y tan_fovx tan_fovy pos(3);
        the focal lengths by a true f32 division, as the program's."""
        fx = torch.full_like(self.tan_fovx, self.width) / (2.0 * self.tan_fovx)
        fy = torch.full_like(self.tan_fovy, self.height) / (2.0 * self.tan_fovy)
        return torch.cat([self.view.reshape(-1), self.full_proj.reshape(-1),
                          torch.stack([fx, fy, self.tan_fovx, self.tan_fovy]),
                          self.cam_pos.reshape(3)])


def intrinsics(v: View) -> np.ndarray:
    fx, fy = fov2focal(v.fovx, v.width), fov2focal(v.fovy, v.height)
    return np.array([[fx, 0, v.width / 2.0], [0, fy, v.height / 2.0], [0, 0, 1]], np.float32)
