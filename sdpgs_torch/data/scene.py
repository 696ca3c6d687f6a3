"""Scene orchestration: load a dataset, unify segment ids across the
train views, make the pseudo poses and the initial Gaussians.

Counterpart of ``sdpgs_tpu/data/scene.py`` (reference scene/__init__.py):
- the dataset type from the directory layout (:52-60);
- cross-view segment-id unification: one global id space, each segment's
  feature averaged over the views that see it, each camera's seg_map,
  point_feature and feature_dict rewritten (:83-156);
- pseudo poses by dataset flavour (:163-179);
- the Gaussians from the fused or random point cloud (:185-192) or a saved
  PLY, on ``device`` (``cuda`` unless the caller asks for another);
- the model directory's provenance copies, ``input.ply`` and
  ``cameras.json`` (:62-74).

Cameras, images and maps stay on the host, as ``data/synthetic.py`` keeps
them.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import List, Optional

import numpy as np

from sdpgs_torch import default_device
from sdpgs_torch.config import TrainConfig
from sdpgs_torch.core.camera import Camera
from sdpgs_torch.core.gaussians import Gaussians, create_from_points
from sdpgs_torch.data import pose_sampling
from sdpgs_torch.data.camera_utils import LoadedCamera, camera_to_json, load_camera
from sdpgs_torch.data.ply import load_gaussians_ply, save_gaussians_ply
from sdpgs_torch.data.readers import (
    read_blender_scene,
    read_colmap_scene,
    read_mipnerf360_scene,
    read_spiral_scene,
)


def unify_segments(cams: List[LoadedCamera]) -> np.ndarray:
    """Merge per-view segment ids into one global contiguous id space and
    average prototype features over observing views
    (reference scene/__init__.py:83-156). Mutates the cameras in place and
    returns the global prototype matrix [S, 3]."""
    with_seg = [c for c in cams if c.seg_map is not None]
    if not with_seg:
        return np.zeros((1, 3), np.float32)

    # per-view: sorted unique ids; feature_dict rows follow that order after
    # the loader's contiguous remap.
    all_ids = sorted(set(int(i) for c in with_seg for i in np.unique(c.seg_map) if i >= 0))
    mapping = {gid: i for i, gid in enumerate(all_ids)}
    S = len(all_ids)

    proto_sum = np.zeros((S, 3), np.float64)
    proto_cnt = np.zeros((S,), np.float64)
    for c in with_seg:
        ids = np.unique(c.seg_map)
        ids = ids[ids >= 0]
        for pos, gid in enumerate(sorted(int(i) for i in ids)):
            if c.feature_dict is not None and pos < len(c.feature_dict):
                proto_sum[mapping[gid]] += c.feature_dict[pos]
                proto_cnt[mapping[gid]] += 1
    protos = (proto_sum / np.maximum(proto_cnt[:, None], 1)).astype(np.float32)

    for c in with_seg:
        lut = np.zeros(int(c.seg_map.max()) + 2, np.int32)
        for gid in np.unique(c.seg_map):
            if gid >= 0:
                lut[gid] = mapping[int(gid)]
        new_seg = np.where(c.seg_map >= 0, lut[np.clip(c.seg_map, 0, None)], 0)
        c.seg_map = new_seg.astype(np.int32)
        c.point_feature = protos[new_seg].transpose(2, 0, 1).astype(np.float32)
        c.feature_dict = protos
    return protos


def detect_scene_type(source_path: str) -> str:
    """reference scene/__init__.py:52-60 (+ the mipnerf360 branch the
    reference ships commented out at :48-50, enabled here)."""
    sp = Path(source_path)
    if (sp / "sparse").exists():
        return "colmap"
    if (sp / "transforms_train.json").exists():
        return "blender"
    if (sp / "transforms.json").exists():
        return "mipnerf360"
    raise ValueError(f"could not recognize scene type at {source_path}")


class Scene:
    """Loaded cameras, prototypes and pseudo poses on the host; the initial
    Gaussians on ``device`` (``cuda`` unless the caller asks for another)."""

    def __init__(self, cfg: TrainConfig, load_iteration: Optional[int] = None, device=None):
        dev = default_device(device)
        m = cfg.model
        self.cfg = cfg
        self.model_path = m.model_path
        stype = detect_scene_type(m.source_path)
        dataset_flavor = self._flavor(m.source_path)
        # Prefer pre-downsampled image folders (mip-NeRF-360 convention:
        # images_2/images_4/images_8) when one matches the resolution divider
        # (reference dataset_readers mipnerf360 path). load_camera's resize
        # then becomes a no-op while intrinsics still rescale.
        images_dir = m.images
        if (
            stype == "colmap"
            and m.resolution > 1
            and (Path(m.source_path) / f"{m.images}_{m.resolution}").exists()
        ):
            images_dir = f"{m.images}_{m.resolution}"
        if stype == "colmap":
            info = read_colmap_scene(
                m.source_path, images=images_dir, features=m.language_features_name,
                eval=m.eval, n_views=m.nviews,
                dataset="DTU" if dataset_flavor == "dtu" else "LLFF",
                seed=cfg.seed,
            )
        elif stype == "mipnerf360":
            info = read_mipnerf360_scene(
                m.source_path, white_background=m.white_background, eval=m.eval,
                n_views=m.nviews, features=m.language_features_name, seed=cfg.seed,
            )
        else:
            info = read_blender_scene(
                m.source_path, white_background=m.white_background, eval=m.eval,
                n_views=m.nviews, features=m.language_features_name, seed=cfg.seed,
            )
        self.info = info
        self.cameras_extent = float(info.nerf_normalization["radius"])

        self.train_cameras = [load_camera(c, m.resolution) for c in info.train_cameras]
        self.test_cameras = [load_camera(c, m.resolution) for c in info.test_cameras]
        self.prototypes = unify_segments(self.train_cameras)

        # pseudo poses (reference scene/__init__.py:163-179)
        Rs = [c.R for c in self.train_cameras]
        Ts = [c.T for c in self.train_cameras]
        rng = np.random.default_rng(cfg.seed)
        if dataset_flavor == "llff":
            bounds = np.stack([c.bounds for c in self.train_cameras])
            poses = pose_sampling.generate_random_poses_llff(Rs, Ts, bounds, rng=rng)
        elif dataset_flavor == "dtu":
            poses = pose_sampling.generate_random_poses_interp(Rs, Ts, rng=rng)
        else:  # 360 / nerf_synthetic
            poses = pose_sampling.generate_random_poses_360(Rs, Ts, rng=rng)
        ref = self.train_cameras[0]
        self.pseudo_poses = poses                       # [N, 4, 4] W2C
        self.pseudo_fovx, self.pseudo_fovy = ref.fovx, ref.fovy
        self.pseudo_width, self.pseudo_height = ref.width, ref.height

        if load_iteration is not None:
            ply = (
                Path(self.model_path) / "point_cloud"
                / f"iteration_{load_iteration}" / "point_cloud.ply"
            )
            self.gaussians = load_gaussians_ply(ply, m.capacity, m.sh_degree, device=dev)
        else:
            n = min(len(info.points), m.capacity)
            self.gaussians = create_from_points(
                info.points[:n], info.colors[:n], m.capacity, m.sh_degree, device=dev
            )
            self._write_provenance()

    @staticmethod
    def _flavor(source_path: str) -> str:
        """Path-substring dispatch, reference scene/__init__.py:164-171."""
        sp = source_path.lower()
        if "dtu" in sp:
            return "dtu"
        if "360" in sp:
            return "360"
        if "nerf_synthetic" in sp or "blender" in sp:
            return "synthetic"
        return "llff"

    def _write_provenance(self):
        if not self.model_path:
            return
        os.makedirs(self.model_path, exist_ok=True)
        try:
            if Path(self.info.ply_path).exists():
                shutil.copy(self.info.ply_path, Path(self.model_path) / "input.ply")
        except OSError:
            pass
        cams = [
            camera_to_json(i, c)
            for i, c in enumerate(self.test_cameras + self.train_cameras)
        ]
        (Path(self.model_path) / "cameras.json").write_text(json.dumps(cams))

    def pseudo_camera(self, idx: int) -> tuple[Camera, np.ndarray, np.ndarray]:
        """(host camera, C2W rotation, W2C translation) of pseudo pose
        ``idx`` (reference PseudoCamera, scene/__init__.py:174-178:
        R = pose[:3,:3].T, T = pose[:3,3])."""
        pose = self.pseudo_poses[idx]
        R = pose[:3, :3].T
        T = pose[:3, 3]
        cam = Camera.create(
            R=R, T=T, fovx=self.pseudo_fovx, fovy=self.pseudo_fovy,
            width=self.pseudo_width, height=self.pseudo_height, device="cpu",
        )
        return cam, R, T

    def save(self, iteration: int, gaussians: Gaussians):
        """PLY snapshot (reference scene/__init__.py:194-196)."""
        out = Path(self.model_path) / "point_cloud" / f"iteration_{iteration}"
        out.mkdir(parents=True, exist_ok=True)
        save_gaussians_ply(out / "point_cloud.ply", gaussians)


class RenderScene:
    """Spiral-video render scene (reference RenderScene,
    scene/__init__.py:212-255): cameras come from the Spiral reader
    (``poses_bounds.npy`` of *all* source views, not just the few-shot train
    subset); Gaussians load from a trained PLY snapshot onto ``device``
    (``cuda`` unless the caller asks for another)."""

    def __init__(self, cfg: TrainConfig, load_iteration: Optional[int] = None,
                 n_frames: int = 180, device=None):
        dev = default_device(device)
        m = cfg.model
        self.cfg = cfg
        self.model_path = m.model_path
        info = read_spiral_scene(m.source_path, n_frames=n_frames)
        self.info = info
        self.cameras_extent = float(info.nerf_normalization["radius"])
        self.render_cameras = [
            load_camera(c, m.resolution) for c in info.test_cameras
        ]

        if load_iteration is None:
            iters = sorted(
                int(p.name.split("_")[1])
                for p in (Path(self.model_path) / "point_cloud").iterdir()
            )
            load_iteration = iters[-1]
        self.loaded_iter = load_iteration
        ply = (
            Path(self.model_path) / "point_cloud"
            / f"iteration_{load_iteration}" / "point_cloud.ply"
        )
        self.gaussians = load_gaussians_ply(ply, m.capacity, m.sh_degree, device=dev)
