"""Host-side camera and image loading.

Counterpart of ``sdpgs_tpu/data/camera_utils.py`` (reference
utils/camera_utils.py): the global resolution divider (/8 in the LLFF
protocol), the image, depth, feature and segment resizes, the loaded view
record the Trainer and ``render_set`` read, and ``camera_to_json``. A
loaded view's camera lives on the host: K1 and K4 take the camera by value,
so a camera on the card would cost a copy back per call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from sdpgs_torch.core.camera import Camera, fov2focal


def resize_image(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of an [H, W, C] float image through PIL (8-bit, as
    the JAX package does it)."""
    from PIL import Image

    if img.shape[0] == height and img.shape[1] == width:
        return img
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    out = pil.resize((width, height), Image.BILINEAR)
    return np.asarray(out, np.float32) / 255.0


def resize_nearest(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest-neighbour resize of [H, W] or [H, W, C] arrays (depth and
    segment maps: interpolation would corrupt ids and depth edges; the
    reference uses cv2.INTER_NEAREST, dataset_readers.py:448)."""
    h, w = arr.shape[:2]
    if h == height and w == width:
        return arr
    ys = np.minimum((np.arange(height) * h / height).astype(np.int64), h - 1)
    xs = np.minimum((np.arange(width) * w / width).astype(np.int64), w - 1)
    return arr[ys[:, None], xs[None, :]]


@dataclass
class LoadedCamera:
    """Host-side fully-loaded training/eval view."""

    camera: Camera            # host camera
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


def load_camera(cam_info, resolution: int = 8) -> LoadedCamera:
    """Downscale a ``readers.CameraInfo`` by the global resolution divider
    and build its camera on the host (reference loadCam,
    camera_utils.py:22-91). Images and maps stay numpy arrays."""
    w = int(round(cam_info.width / resolution))
    h = int(round(cam_info.height / resolution))

    image = cam_info.image
    if image is not None:
        image = resize_image(image, h, w).transpose(2, 0, 1)
    depth = cam_info.depth_mono
    if depth is not None:
        depth = resize_nearest(depth, h, w).astype(np.float32)
    feature = cam_info.point_feature
    if feature is not None:
        feature = resize_nearest(feature, h, w).transpose(2, 0, 1).astype(np.float32)
    seg = cam_info.seg_map
    if seg is not None:
        seg = resize_nearest(seg, h, w).astype(np.int32)

    camera = Camera.create(
        R=cam_info.R, T=cam_info.T, fovx=cam_info.FovX, fovy=cam_info.FovY,
        width=w, height=h, device="cpu",
    )
    return LoadedCamera(
        camera=camera,
        R=cam_info.R,
        T=cam_info.T,
        fovx=cam_info.FovX,
        fovy=cam_info.FovY,
        image=image,
        depth_mono=depth,
        point_feature=feature,
        seg_map=seg,
        feature_dict=cam_info.feature_dict,
        bounds=cam_info.bounds,
        image_name=cam_info.image_name,
    )


def camera_to_json(uid: int, cam) -> dict:
    """reference camera_utils.py:147-167."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam.R.transpose()
    Rt[:3, 3] = cam.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    pos = W2C[:3, 3]
    rot = W2C[:3, :3]
    return {
        "id": uid,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": pos.tolist(),
        "rotation": [r.tolist() for r in rot],
        "fy": fov2focal(cam.fovy, cam.height),
        "fx": fov2focal(cam.fovx, cam.width),
    }
