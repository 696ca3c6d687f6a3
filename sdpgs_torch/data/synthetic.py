"""In-memory synthetic scenes (no disk, no COLMAP).

Counterpart of ``sdpgs_tpu/data/synthetic.py``: a scene-shaped object for a
full ``Trainer`` run without a dataset. Ground-truth images are rendered
(through the port's ``render``) from a hidden Gaussian set, so training has
a real signal. The same constructor and seed give the same points,
cameras, pseudo poses and initial cloud as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from sdpgs_torch import default_device
from sdpgs_torch.config import RasterizeConfig
from sdpgs_torch.core.camera import Camera
from sdpgs_torch.core.gaussians import create_from_points
from sdpgs_torch.data.camera_utils import LoadedCamera


class SyntheticScene:
    """The attribute surface the Trainer reads (train/test cameras,
    gaussians, prototypes, cameras_extent, pseudo poses, model_path). The
    Gaussians live on ``device`` (``cuda`` unless the caller asks for
    another); cameras stay on the host, images and maps are numpy."""

    def __init__(
        self,
        seed: int = 0,
        n_points: int = 64,
        capacity: int = 256,
        width: int = 48,
        height: int = 32,
        n_train: int = 3,
        n_pseudo: int = 4,
        init_scale: float = 0.01,
        initial_opacity: float = 0.9,
        raster: RasterizeConfig | None = None,
        n_segments: int = 0,       # > 0: prototypes, seg maps and feature images
                                   # from the ground truth's feature render
        n_test: int = 1,           # held-out views (0 reuses train view 0)
        point_spread: float = 0.4,
        depth_center: float = 3.0,
        init_points: int = 0,      # > 0: a random cloud of this size as the init
                                   # instead of the jittered ground truth
        pseudo_jitter: float = 0.05,
        device=None,
    ):
        from sdpgs_torch.render import render

        dev = default_device(device)
        rng = np.random.default_rng(seed)
        self.model_path = ""
        pts = rng.normal(size=(n_points, 3)).astype(np.float32) * point_spread \
            + np.array([0, 0, depth_center], np.float32)
        cols = rng.uniform(size=(n_points, 3)).astype(np.float32)
        if n_segments > 0:
            protos = rng.normal(size=(n_segments, 3)).astype(np.float32)
            protos /= np.linalg.norm(protos, axis=-1, keepdims=True) + 1e-8
            # angular bins around the view axis: segments are contiguous regions
            ang = np.arctan2(pts[:, 1], pts[:, 0])
            seg_of_pt = ((ang + np.pi) / (2 * np.pi) * n_segments).astype(int)
            seg_of_pt = np.clip(seg_of_pt, 0, n_segments - 1)
            feats = protos[seg_of_pt]
            self.prototypes = protos
        else:
            feats = None
            self.prototypes = np.ones((2, 3), np.float32)
        gt = create_from_points(
            pts, cols, n_points, init_scale=np.full(n_points, init_scale),
            initial_opacity=initial_opacity, features=feats, device=dev,
        )
        cfg = raster or RasterizeConfig(tile=16, max_per_tile=128, max_tiles_per_gaussian=8,
                                        chunk=32)
        # the hidden ground truth and its raster config, for oracle-depth rigs
        self.gt_gaussians = gt
        self.gt_raster = cfg

        def make_view(dx, dy, name):
            R = np.eye(3)
            T = np.array([float(dx), float(dy), 0.0])
            cam = Camera.create(R=R, T=T, fovx=0.9, fovy=0.7, width=width, height=height,
                                device="cpu")
            with torch.no_grad():
                out = render(cam, gt, cfg, torch.zeros(3, device=dev), 0, device=dev)
            feat_img = out.feature.cpu().numpy()                  # [H, W, 3]
            if n_segments > 0:
                seg_map = np.argmax(feat_img @ self.prototypes.T, axis=-1).astype(np.int32)
                point_feature = feat_img.transpose(2, 0, 1).astype(np.float32)
            else:
                seg_map = np.zeros((height, width), np.int32)
                point_feature = np.zeros((3, height, width), np.float32)
            return LoadedCamera(
                camera=cam, R=R, T=T, fovx=0.9, fovy=0.7,
                image=out.color.cpu().numpy().transpose(2, 0, 1),
                depth_mono=out.depth.cpu().numpy(),
                point_feature=point_feature,
                seg_map=seg_map,
                feature_dict=self.prototypes,
                bounds=np.array([1.0, 10.0]),
                image_name=name,
            )

        offsets = np.linspace(-0.2, 0.2, n_train)
        self.train_cameras = [make_view(dx, 0.0, f"train{i}") for i, dx in enumerate(offsets)]
        if n_test > 0:
            toff = np.linspace(-0.1, 0.1, n_test)
            self.test_cameras = [make_view(dx, 0.1, f"test{i}") for i, dx in enumerate(toff)]
        else:
            self.test_cameras = [self.train_cameras[0]]
        self.cameras_extent = 1.0
        if init_points > 0:
            init = rng.normal(size=(init_points, 3)).astype(np.float32) \
                * point_spread + np.array([0, 0, depth_center], np.float32)
            init_cols = np.full((init_points, 3), 0.5, np.float32)
        else:
            init = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05
            init_cols = np.full((n_points, 3), 0.5, np.float32)
        self.gaussians = create_from_points(init, init_cols, capacity,
                                            init_scale=np.full(init.shape[0], init_scale),
                                            device=dev)
        poses = []
        for i in range(n_pseudo):
            p = np.eye(4)
            p[:3, 3] = np.array([
                pseudo_jitter * float(rng.uniform(-1, 1)),
                pseudo_jitter * float(rng.uniform(-1, 1)),
                0.2 * pseudo_jitter * float(rng.uniform(-1, 1)),
            ]) if i > 0 else np.array([0.05, 0.02, 0.0])
            poses.append(p)
        self.pseudo_poses = np.stack(poses)
        self.pseudo_fovx, self.pseudo_fovy = 0.9, 0.7
        self.pseudo_width, self.pseudo_height = width, height

    def pseudo_camera(self, idx):
        """(host camera, C2W rotation, W2C translation) of pseudo pose ``idx``."""
        pose = self.pseudo_poses[idx]
        R = pose[:3, :3].T
        T = pose[:3, 3]
        cam = Camera.create(R=R, T=T, fovx=self.pseudo_fovx, fovy=self.pseudo_fovy,
                            width=self.pseudo_width, height=self.pseudo_height, device="cpu")
        return cam, R, T

    def save(self, iteration, gaussians):
        pass
