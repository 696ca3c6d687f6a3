"""Dataset readers: COLMAP (LLFF and DTU), Blender (NeRF-synthetic),
mip-NeRF-360 and the LLFF spiral render path.

Counterpart of ``sdpgs_tpu/data/readers.py`` (reference
scene/dataset_readers.py), host-side numpy and PIL:
- ``read_colmap_scene`` (:513-639): the MVS ``<n>_views/dense/fused.ply``
  init, else a random cloud sized from the sparse cloud's bounding box; the
  LLFF hold-out (every 8th view a test view) with a linspace subsample of
  n_views train views; DTU's fixed train and exclude indices;
- ``read_colmap_cameras`` (:393-467): each view's image,
  ``poses_bounds.npy`` bounds, language features (``<name>_s.npy`` segment
  map and ``<name>_fdim3.npy`` feature dictionary, ids remapped to be
  contiguous), and depth: ``depth_adjust_maps_stereo/depth_*.npy`` for a
  train view, the mono PNG for a test view;
- ``read_blender_scene`` (:663-748, 821-901): fixed train indices, every
  8th test view, the inverted PFM mono depth for train views;
- ``read_mipnerf360_scene`` (:751-820, 904-963): ``transforms.json`` and
  ``train_test_split_<n>.json``;
- ``read_spiral_scene`` (CreateLLFFSpiral, :995-1038).

Each random draw happens in the JAX package's order, so one seed gives the
same cloud in both packages.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from sdpgs_torch.core.camera import focal2fov, fov2focal
from sdpgs_torch.core.sh import sh_to_rgb
from sdpgs_torch.data import colmap, pose_sampling
from sdpgs_torch.data.camera_utils import resize_nearest
from sdpgs_torch.data.ply import read_pointcloud_ply, write_pointcloud_ply

# DTU split (reference dataset_readers.py:580-583)
DTU_TRAIN_IDX = [25, 22, 28, 40, 44, 48, 0, 8, 13]
DTU_EXCLUDE_IDX = [3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39]


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovX: float
    FovY: float
    image: Optional[np.ndarray]         # [H, W, 3] float in [0,1]
    image_path: str
    image_name: str
    width: int
    height: int
    bounds: Optional[np.ndarray] = None
    depth_mono: Optional[np.ndarray] = None
    point_feature: Optional[np.ndarray] = None  # [H, W, 3]
    seg_map: Optional[np.ndarray] = None        # [H, W] int32
    feature_dict: Optional[np.ndarray] = None   # [S, 3]


@dataclass
class SceneInfo:
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    """Camera-extent normalization (reference dataset_readers.py:293-314)."""
    centers = []
    for cam in cam_infos:
        Rt = np.zeros((4, 4))
        Rt[:3, :3] = cam.R.T
        Rt[:3, 3] = cam.T
        Rt[3, 3] = 1.0
        centers.append(np.linalg.inv(Rt)[:3, 3:4])
    centers = np.hstack(centers)
    center = centers.mean(axis=1, keepdims=True)
    diagonal = np.max(np.linalg.norm(centers - center, axis=0))
    return {"translate": -center.flatten(), "radius": diagonal * 1.1}


def _load_image(path) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return img


def read_pfm(path) -> np.ndarray:
    """Minimal PFM reader (reference dataset_readers.py:33-79)."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        color = header == "PF"
        dims = f.readline().decode("latin-1")
        while dims.startswith("#"):
            dims = f.readline().decode("latin-1")
        w, h = map(int, dims.split())
        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path, data: np.ndarray) -> None:
    """Minimal PFM writer (inverse of :func:`read_pfm`; little-endian)."""
    data = np.asarray(data, np.float32)
    color = data.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        np.flipud(data).astype("<f4").tofile(f)


def load_language_features(
    features_dir, image_name: str, height: int, width: int
):
    """Seg map + per-pixel features (reference
    get_language_feature_threemasks_torch, dataset_readers.py:316-391):
    nearest-resize the seg map, remap ids to contiguous 0..S-1, index the
    feature dict per pixel."""
    base = os.path.join(str(features_dir), image_name)
    seg = np.load(base + "_s.npy")
    fdict = np.load(base + "_fdim3.npy").astype(np.float32)
    if seg.ndim == 3:
        seg = seg[0]
    seg = resize_nearest(seg.astype(np.int64), height, width)

    ids = np.unique(seg)
    ids = ids[ids >= 0]
    remap = np.full(int(seg.max()) + 2, -1, np.int64)
    remap[ids] = np.arange(len(ids))
    seg_new = np.where(seg >= 0, remap[np.clip(seg, 0, None)], -1)
    point_feature = fdict[np.clip(seg_new, 0, len(ids) - 1)]  # [H, W, 3]
    return point_feature.astype(np.float32), seg.astype(np.int32), fdict


def read_colmap_cameras(
    path,
    cam_extrinsics,
    cam_intrinsics,
    images_folder,
    features_folder,
    train_cam_names,
    depth_dir_name: str = "depth_adjust_maps_stereo",
) -> List[CameraInfo]:
    """reference readColmapCameras (dataset_readers.py:393-467)."""
    path = Path(path)
    cam_infos = []
    poses_bounds = None
    pb_path = path / "poses_bounds.npy"
    if pb_path.exists():
        poses_bounds = np.load(pb_path)

    for idx, (name, extr) in enumerate(cam_extrinsics.items()):
        intr = cam_intrinsics[extr.camera_id]
        height, width = intr.height, intr.width
        R = colmap.qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)
        bounds = poses_bounds[idx, -2:] if poses_bounds is not None else np.array([0.1, 100.0])

        if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            focal_x = focal_y = intr.params[0]
        elif intr.model == "PINHOLE":
            focal_x, focal_y = intr.params[0], intr.params[1]
        else:
            raise ValueError(f"unsupported camera model {intr.model}")
        FovY = focal2fov(focal_y, height)
        FovX = focal2fov(focal_x, width)

        image_path = os.path.join(str(images_folder), os.path.basename(extr.name))
        image_name = os.path.basename(image_path).split(".")[0]
        image = _load_image(image_path)

        point_feature = seg_map = feature_dict = None
        is_train = image_name in train_cam_names
        if is_train and features_folder and Path(features_folder).exists():
            try:
                point_feature, seg_map, feature_dict = load_language_features(
                    features_folder, image_name, image.shape[0], image.shape[1]
                )
            except FileNotFoundError:
                pass

        depth_mono = None
        stem = os.path.basename(extr.name).split(".")[0]
        if is_train:
            dp = path / depth_dir_name / f"depth_{stem}.npy"
            if dp.exists():
                depth_mono = resize_nearest(np.load(dp), height, width).astype(np.float32)
        else:
            dp = path / "depth_maps" / f"depth_{stem}.png"
            if dp.exists():
                from PIL import Image as PILImage

                depth_mono = np.asarray(
                    PILImage.open(dp).convert("L"), np.float32
                )
                depth_mono = resize_nearest(depth_mono, height, width)

        cam_infos.append(
            CameraInfo(
                uid=intr.id, R=R, T=T, FovX=FovX, FovY=FovY, image=image,
                image_path=image_path, image_name=image_name, width=width,
                height=height, bounds=bounds, depth_mono=depth_mono,
                point_feature=point_feature, seg_map=seg_map,
                feature_dict=feature_dict,
            )
        )
    return cam_infos


def _random_pointcloud(xyz_sparse: np.ndarray, dataset: str, rng) -> np.ndarray:
    """Random init sized from the sparse cloud (dataset_readers.py:535-561)."""

    def topk(m, k, axis=0):
        return np.sort(m, axis=axis)[-k:][0] if k <= m.shape[0] else m.min(0)

    if dataset == "DTU":
        hi = np.sort(xyz_sparse, axis=0)[-min(100, len(xyz_sparse))]
        lo = np.sort(-xyz_sparse, axis=0)[-min(100, len(xyz_sparse))]
        shape = hi + lo
        num = 1000
        return rng.random((num, 3)) * shape * 1.3 - lo
    hi = xyz_sparse.max(0)
    lo = (-xyz_sparse).max(0)
    k20 = np.sort(-xyz_sparse, axis=0)[-min(20, len(xyz_sparse))]
    shape = hi + lo
    num = int(shape.max() * 50)
    return rng.random((num, 3)) * shape * 1.3 - k20


def read_colmap_scene(
    path,
    images: str = "images",
    features: str = "DINO_features_GGrouping_dim3",
    eval: bool = True,
    n_views: int = 3,
    llffhold: int = 8,
    dataset: str = "LLFF",
    seed: int = 0,
) -> SceneInfo:
    """reference readColmapSceneInfo (dataset_readers.py:513-652)."""
    path = Path(path)
    sparse = path / "sparse" / "0"
    cam_intrinsics, cam_extrinsics_raw, points = colmap.detect_model_dir(sparse)

    # order views by name (LLFF: numeric suffix; DTU: plain name sort)
    if dataset == "DTU":
        cam_extrinsics = {
            img.name: img
            for img in sorted(cam_extrinsics_raw.values(), key=lambda im: im.name)
        }
    else:
        def numkey(im):
            m = re.search(r"(\d+)", im.name.split(".")[0])
            return int(m.group(1)) if m else 0

        cam_extrinsics = {
            img.name: img for img in sorted(cam_extrinsics_raw.values(), key=numkey)
        }

    names = [im.name.split(".")[0] for im in cam_extrinsics.values()]
    if dataset == "DTU":
        sort_names = sorted(names)
        train_idx = DTU_TRAIN_IDX[:n_views]
        train_cam_names = [c for i, c in enumerate(sort_names) if i in train_idx]
    else:
        if eval:
            pool = [c for i, c in enumerate(names) if i % llffhold != 0]
        else:
            pool = names
        idx_sub = [round(i) for i in np.linspace(0, len(pool) - 1, n_views)]
        train_cam_names = [c for i, c in enumerate(pool) if i in idx_sub]
        assert len(train_cam_names) == n_views

    cam_infos = read_colmap_cameras(
        path, cam_extrinsics, cam_intrinsics,
        path / images, path / features, train_cam_names,
    )
    cam_infos = sorted(cam_infos, key=lambda c: c.image_name)

    if eval:
        if dataset == "DTU":
            train_idx = DTU_TRAIN_IDX[:n_views]
            test_idx = [
                i for i in range(49) if i not in DTU_TRAIN_IDX + DTU_EXCLUDE_IDX
            ]
            train_cams = [c for i, c in enumerate(cam_infos) if i in train_idx]
            test_cams = [c for i, c in enumerate(cam_infos) if i in test_idx]
        else:
            train_cams = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
            test_cams = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
            idx_sub = [round(i) for i in np.linspace(0, len(train_cams) - 1, n_views)]
            train_cams = [c for i, c in enumerate(train_cams) if i in idx_sub]
    else:
        train_cams, test_cams = cam_infos, []

    # point cloud: MVS fusion if present, else random fallback
    ply_path = path / f"{n_views}_views" / "dense" / "fused.ply"
    if ply_path.exists():
        pts, cols, normals = read_pointcloud_ply(ply_path)
    else:
        rng = np.random.default_rng(seed)
        xyz_sparse = points[0]
        pts = _random_pointcloud(xyz_sparse, dataset, rng).astype(np.float32)
        cols = np.asarray(sh_to_rgb(rng.random((len(pts), 3)) / 255.0), np.float32)
        normals = np.zeros_like(pts)
        ply_path = path / "sparse" / "0" / "points3D_random.ply"
        try:
            write_pointcloud_ply(ply_path, pts, cols)
        except OSError:
            pass

    return SceneInfo(
        points=pts, colors=cols, normals=normals,
        train_cameras=train_cams, test_cameras=test_cams,
        nerf_normalization=get_nerfpp_norm(train_cams),
        ply_path=str(ply_path),
    )


# Blender train split (reference dataset_readers.py:835,852: hardcoded
# indices into transforms_train.json, not a linspace subsample)
BLENDER_TRAIN_IDX = [2, 16, 26, 55, 73, 76, 86, 93]


def read_blender_scene(
    path, white_background: bool = False, eval: bool = True, n_views: int = 8,
    llffhold: int = 8, features: Optional[str] = None, seed: int = 0,
) -> SceneInfo:
    """NeRF-synthetic reader (reference dataset_readers.py:663-748,821-963)."""
    path = Path(path)
    features_dir = path / (features or "language_features_GGrouping_dim3")

    def read_split(transforms_file, train_names):
        meta = json.loads((path / transforms_file).read_text())
        fovx = meta["camera_angle_x"]
        infos = []
        for idx, frame in enumerate(meta["frames"]):
            img_path = path / (frame["file_path"] + ".png")
            name = Path(frame["file_path"]).name
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1                      # blender -> colmap axes
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            from PIL import Image

            im = np.asarray(Image.open(img_path), np.float32) / 255.0
            bgcol = np.array([1.0, 1.0, 1.0]) if white_background else np.zeros(3)
            if im.shape[-1] == 4:
                rgb = im[..., :3] * im[..., 3:4] + bgcol * (1 - im[..., 3:4])
            else:
                rgb = im
            H, W = rgb.shape[:2]
            fovy = focal2fov(fov2focal(fovx, W), H)

            # train views: inverted PFM mono prior (dataset_readers.py:734-736
            # reads the pfm and flips it: depth.max() - depth); test: png
            depth = None
            is_train = name in train_names and "train" in str(img_path)
            if is_train:
                dp = path / "depth_maps" / f"depth_{name}.pfm"
                if dp.exists():
                    depth = read_pfm(dp).astype(np.float32)
                    depth = depth.max() - depth
                    depth = resize_nearest(depth, H, W)
            else:
                dp = path / "depth_maps" / f"depth_{name}.png"
                if dp.exists():
                    from PIL import Image as PILImage

                    depth = np.asarray(PILImage.open(dp).convert("L"), np.float32)
                    depth = resize_nearest(depth, H, W)

            point_feature = seg_map = feature_dict = None
            if (features_dir / f"{name}_s.npy").exists():
                point_feature, seg_map, feature_dict = load_language_features(
                    features_dir, name, H, W
                )

            infos.append(
                CameraInfo(
                    uid=idx, R=R, T=T, FovX=fovx, FovY=fovy, image=rgb,
                    image_path=str(img_path), image_name=name,
                    width=W, height=H, depth_mono=depth,
                    bounds=np.array([2.0, 6.0]),
                    point_feature=point_feature, seg_map=seg_map,
                    feature_dict=feature_dict,
                )
            )
        return infos

    train_meta = json.loads((path / "transforms_train.json").read_text())
    all_train_names = [Path(f["file_path"]).name for f in train_meta["frames"]]
    if eval and n_views > 0:
        train_idx = BLENDER_TRAIN_IDX[:n_views] if n_views <= 8 else BLENDER_TRAIN_IDX
        train_names = [c for i, c in enumerate(all_train_names) if i in train_idx]
    else:
        train_names = all_train_names

    train_cams = read_split("transforms_train.json", train_names)
    if eval and n_views > 0:
        train_cams = [c for c in train_cams if c.image_name in train_names]
    test_cams = []
    if eval:
        test_all = read_split("transforms_test.json", train_names)
        # reference keeps every llffhold-th test view (dataset_readers.py:854)
        test_cams = [c for i, c in enumerate(test_all) if i % llffhold == 0]

    rng = np.random.default_rng(seed)
    num_pts = 100_000
    pts = (rng.random((num_pts, 3)) * 2.6 - 1.3).astype(np.float32)
    cols = np.asarray(sh_to_rgb(rng.random((num_pts, 3)) / 255.0), np.float32)
    return SceneInfo(
        points=pts, colors=cols, normals=np.zeros_like(pts),
        train_cameras=train_cams, test_cameras=test_cams,
        nerf_normalization=get_nerfpp_norm(train_cams),
        ply_path=str(path / "points3d.ply"),
    )


def read_mipnerf360_scene(
    path, white_background: bool = False, eval: bool = True, n_views: int = 3,
    features: Optional[str] = None, seed: int = 0,
) -> SceneInfo:
    """mip-NeRF-360 reader (reference readmipnerf360Info,
    dataset_readers.py:904-963 + readCamerasFromTransforms_mipnerf :751-820):
    a single ``transforms.json`` with explicit fl_x/fl_y/cx/cy intrinsics and
    a ``train_test_split_<n>.json`` index split; train views get language
    features, test views none; alpha-composited onto the background."""
    path = Path(path)
    split = json.loads((path / f"train_test_split_{n_views}.json").read_text())
    meta = json.loads((path / "transforms.json").read_text())
    features_dir = path / (features or "language_features_GGrouping_dim3")

    fx, fy = meta["fl_x"], meta["fl_y"]
    w, h = meta["w"], meta["h"]
    fovx = focal2fov(fx, w)

    def read_views(idx_set, with_features):
        infos = []
        for idx, frame in enumerate(meta["frames"]):
            if idx not in idx_set:
                continue
            img_path = path / frame["file_path"]
            name = Path(frame["file_path"]).stem
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1                      # opengl -> colmap axes
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            from PIL import Image

            im = np.asarray(Image.open(img_path).convert("RGBA"), np.float32) / 255.0
            bgcol = np.array([1.0, 1.0, 1.0]) if white_background else np.zeros(3)
            rgb = im[..., :3] * im[..., 3:4] + bgcol * (1 - im[..., 3:4])
            H, W = rgb.shape[:2]
            fovy = focal2fov(fov2focal(fovx, W), H)

            point_feature = seg_map = feature_dict = None
            if with_features and (features_dir / f"{name}_s.npy").exists():
                point_feature, seg_map, feature_dict = load_language_features(
                    features_dir, name, H, W
                )
            infos.append(
                CameraInfo(
                    uid=idx, R=R, T=T, FovX=fovx, FovY=fovy, image=rgb,
                    image_path=str(img_path), image_name=name, width=W, height=H,
                    point_feature=point_feature, seg_map=seg_map,
                    feature_dict=feature_dict,
                )
            )
        return infos

    train_cams = read_views(set(split["train_ids"]), with_features=True)
    test_cams = read_views(set(split["test_ids"]), with_features=False) if eval else []

    # random init cloud inside the synthetic bounds (dataset_readers.py:940-951)
    rng = np.random.default_rng(seed)
    num_pts = 10_000
    pts = (rng.random((num_pts, 3)) * 2.6 - 1.3).astype(np.float32)
    cols = np.asarray(sh_to_rgb(rng.random((num_pts, 3)) / 255.0), np.float32)
    ply_path = path / "points3d.ply"
    if not ply_path.exists():
        try:
            write_pointcloud_ply(ply_path, pts, cols)
        except OSError:
            pass
    if ply_path.exists():
        pts, cols, _ = read_pointcloud_ply(ply_path)

    return SceneInfo(
        points=pts, colors=cols, normals=np.zeros_like(pts),
        train_cameras=train_cams, test_cameras=test_cams,
        nerf_normalization=get_nerfpp_norm(train_cams),
        ply_path=str(ply_path),
    )


def read_spiral_scene(path, n_frames: int = 180) -> SceneInfo:
    """Spiral render-path "scene" (reference CreateLLFFSpiral,
    dataset_readers.py:995-1038): build ``n_frames`` camera poses on a
    forward-facing spiral fitted to ``poses_bounds.npy``; no images, no point
    cloud — consumed by the spiral-video renderer (``RenderScene``)."""
    path = Path(path)
    poses_arr = np.load(path / "poses_bounds.npy")
    poses_o = poses_arr[:, :-2].reshape([-1, 3, 5])
    bounds = poses_arr[:, -2:]

    fix_rotation = np.array(
        [[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32
    )
    poses = poses_o[:, :3, :4] @ fix_rotation
    recentered, _ = pose_sampling.recenter_poses(poses)
    render_poses = pose_sampling.render_spiral_path(
        recentered, bounds, n_frames=n_frames
    )
    render_poses = pose_sampling.backcenter_poses(render_poses, poses)
    render_poses = render_poses @ np.linalg.inv(fix_rotation)
    # re-attach the (H, W, focal) column from the first source pose
    render_poses = np.concatenate(
        [render_poses, np.tile(poses_o[:1, :3, 4:], (render_poses.shape[0], 1, 1))],
        axis=-1,
    )

    Rs, tvecs, H, W, focal = pose_sampling.convert_poses(
        render_poses.transpose([1, 2, 0])
    )
    H, W = int(H), int(W)
    FovY = focal2fov(focal, H)
    FovX = focal2fov(focal, W)
    cams = [
        CameraInfo(
            uid=i, R=np.transpose(Rs[i]), T=tvecs[i], FovX=FovX, FovY=FovY,
            image=None, image_path="", image_name=f"spiral_{i:05d}",
            width=W, height=H,
        )
        for i in range(len(Rs))
    ]
    return SceneInfo(
        points=np.zeros((0, 3), np.float32), colors=np.zeros((0, 3), np.float32),
        normals=np.zeros((0, 3), np.float32),
        train_cameras=[], test_cameras=cams,
        nerf_normalization=get_nerfpp_norm(cams), ply_path="",
    )
