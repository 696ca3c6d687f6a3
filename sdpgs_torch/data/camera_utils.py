"""Host-side view record, the counterpart of
``sdpgs_tpu/data/camera_utils.py:LoadedCamera``: what ``render_set``
iterates over. Loading views from a dataset comes with the data layer."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from sdpgs_torch.core.camera import Camera, fov2focal


@dataclass
class LoadedCamera:
    """Host-side fully-loaded training/eval view."""

    camera: Camera            # device camera
    R: np.ndarray             # C2W rotation (reference convention)
    T: np.ndarray             # W2C translation
    fovx: float
    fovy: float
    image: Optional[np.ndarray] = None       # [3, H, W] in [0,1]
    depth_mono: Optional[np.ndarray] = None  # [H, W]
    point_feature: Optional[np.ndarray] = None  # [3, H, W]
    seg_map: Optional[np.ndarray] = None     # [H, W] int32
    feature_dict: Optional[np.ndarray] = None  # [S, 3]
    bounds: Optional[np.ndarray] = None
    image_name: str = ""

    @property
    def width(self) -> int:
        return self.camera.width

    @property
    def height(self) -> int:
        return self.camera.height

    def intrinsics(self) -> np.ndarray:
        fx = fov2focal(self.fovx, self.width)
        fy = fov2focal(self.fovy, self.height)
        return np.array(
            [[fx, 0, self.width / 2.0], [0, fy, self.height / 2.0], [0, 0, 1]],
            np.float32,
        )
