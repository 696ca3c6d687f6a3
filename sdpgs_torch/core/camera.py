"""Pinhole camera as a dataclass of tensors.

Counterpart of ``sdpgs_tpu/core/camera.py``. The matrices are built in
numpy exactly as the JAX package builds them (float64, then cast), so both
packages see bit-identical cameras. Conventions (reference
graphics_utils.py:31-84): ``R`` is the camera-to-world rotation, ``T`` the
world-to-camera translation, world-to-view = [[R^T, T], [0, 1]], +z
forward, znear 0.01, zfar 100.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch


def world_to_view_matrix(R: np.ndarray, T: np.ndarray,
                         translate: Optional[np.ndarray] = None,
                         scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera matrix from COLMAP-style (R=C2W rotation, T=W2C
    translation); optional recentering of the camera center
    (reference getWorld2View2, graphics_utils.py:38-49)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = T
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else translate
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection, +z forward (reference graphics_utils.py:64-84)."""
    tan_x = math.tan(fovx * 0.5)
    tan_y = math.tan(fovy * 0.5)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


@dataclass
class Camera:
    """One view: f32 tensors on one device, plus the image size."""

    view: torch.Tensor        # [4,4] world -> camera
    full_proj: torch.Tensor   # [4,4] projection @ view
    cam_pos: torch.Tensor     # [3] camera center in world space
    tan_fovx: torch.Tensor    # 0-d
    tan_fovy: torch.Tensor    # 0-d
    height: int
    width: int

    @property
    def device(self) -> torch.device:
        return self.view.device

    # A true f32 division, as in JAX: ``number / tensor`` would take the
    # reciprocal first and round twice.
    @property
    def focal_x(self) -> torch.Tensor:
        return torch.full_like(self.tan_fovx, self.width) / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return torch.full_like(self.tan_fovy, self.height) / (2.0 * self.tan_fovy)

    @classmethod
    def create(
        cls,
        R: np.ndarray,
        T: np.ndarray,
        fovx: float,
        fovy: float,
        width: int,
        height: int,
        znear: float = 0.01,
        zfar: float = 100.0,
        translate: Optional[np.ndarray] = None,
        scale: float = 1.0,
        device=None,
    ) -> "Camera":
        from sdpgs_torch import default_device

        dev = default_device(device)
        view = world_to_view_matrix(np.asarray(R), np.asarray(T), translate, scale)
        proj = projection_matrix(znear, zfar, fovx, fovy)
        full = (proj @ view).astype(np.float32)
        cam_pos = np.linalg.inv(view)[:3, 3].astype(np.float32)
        return cls.from_numpy(
            dict(view=view, full_proj=full, cam_pos=cam_pos,
                 tan_fovx=np.float32(math.tan(fovx * 0.5)),
                 tan_fovy=np.float32(math.tan(fovy * 0.5)),
                 height=height, width=width),
            device=dev,
        )

    @classmethod
    def from_numpy(cls, arrays: Mapping, device=None) -> "Camera":
        """Carry a camera across from numpy arrays keyed by the JAX
        ``Camera`` field names (``view``, ``full_proj``, ``cam_pos``,
        ``tan_fovx``, ``tan_fovy``, ``height``, ``width``)."""
        from sdpgs_torch import default_device

        dev = default_device(device)

        def t(name):
            return torch.tensor(np.asarray(arrays[name], np.float32), device=dev)

        return cls(view=t("view"), full_proj=t("full_proj"), cam_pos=t("cam_pos"),
                   tan_fovx=t("tan_fovx"), tan_fovy=t("tan_fovy"),
                   height=int(arrays["height"]), width=int(arrays["width"]))

    def to(self, device) -> "Camera":
        return Camera(self.view.to(device), self.full_proj.to(device),
                      self.cam_pos.to(device), self.tan_fovx.to(device),
                      self.tan_fovy.to(device), self.height, self.width)

    def intrinsics_matrix(self) -> torch.Tensor:
        """3x3 pinhole intrinsics K (pixel units, principal point at center)."""
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        one = torch.ones((), dtype=torch.float32, device=self.device)
        return torch.stack([
            torch.stack([self.focal_x, zero, zero + self.width / 2.0]),
            torch.stack([zero, self.focal_y, zero + self.height / 2.0]),
            torch.stack([zero, zero, one]),
        ])
