"""COLMAP model parsers (text and binary) and sparse-depth extraction.

Counterpart of ``sdpgs_tpu/data/colmap.py`` (reference
scene/colmap_loader.py): cameras, images and points3D in both formats, and
the train views' sparse-depth observations that the segment-wise depth
alignment reads (``read_points3D_binary_sparse``, colmap_loader.py:156-248).
Host-side numpy; no tensor is made here.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

# model_id -> (name, num_params); COLMAP camera model table.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray       # [4] (w, x, y, z)
    tvec: np.ndarray       # [3]
    camera_id: int
    name: str
    xys: np.ndarray        # [N, 2] keypoints
    point3D_ids: np.ndarray  # [N]


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """reference colmap_loader.py:43-54."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """reference colmap_loader.py:56-66 (eigenvector of the K matrix)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(fid, n, fmt):
    return struct.unpack("<" + fmt, fid.read(n))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cams = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        el = line.split()
        cams[int(el[0])] = ColmapCamera(
            int(el[0]), el[1], int(el[2]), int(el[3]), np.array(el[4:], dtype=np.float64)
        )
    return cams


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            (cam_id,) = _read(f, 4, "i")
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (npts,) = _read(f, 8, "Q")
            # each 2D point record: x (f8), y (f8), point3D id (i8)
            raw = np.frombuffer(
                f.read(24 * npts), dtype=[("x", "<f8"), ("y", "<f8"), ("id", "<i8")]
            )
            xys = np.stack([raw["x"], raw["y"]], axis=-1)
            ids = raw["id"].copy()
            images[iid] = ColmapImage(
                iid, qvec, tvec, int(cam_id), name.decode("utf-8"), xys, ids
            )
    return images


def read_images_text(path) -> Dict[int, ColmapImage]:
    images = {}
    lines = [
        l.strip()
        for l in Path(path).read_text().splitlines()
        if l.strip() and not l.startswith("#")
    ]
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        iid = int(el[0])
        qvec = np.array(el[1:5], dtype=np.float64)
        tvec = np.array(el[5:8], dtype=np.float64)
        cam_id = int(el[8])
        name = el[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        arr = np.array(pts, dtype=np.float64).reshape(-1, 3) if pts else np.zeros((0, 3))
        images[iid] = ColmapImage(
            iid, qvec, tvec, cam_id, name, arr[:, :2], arr[:, 2].astype(np.int64)
        )
    return images


def read_points3D_binary(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (xyz [N,3], rgb [N,3] uint8-scale float, errors [N])."""
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3))
        err = np.empty((num,))
        for i in range(num):
            _pid = _read(f, 8, "Q")[0]
            xyz[i] = _read(f, 24, "ddd")
            rgb[i] = _read(f, 3, "BBB")
            err[i] = _read(f, 8, "d")[0]
            (track_len,) = _read(f, 8, "Q")
            f.read(8 * track_len)
    return xyz, rgb, err


def read_points3D_text(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyz, rgb, err = [], [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        el = line.split()
        xyz.append([float(v) for v in el[1:4]])
        rgb.append([float(v) for v in el[4:7]])
        err.append(float(el[7]))
    return np.array(xyz), np.array(rgb), np.array(err)


def read_points3D_binary_sparse(
    path, train_image_ids: List[int]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    """Points + per-train-view sparse depth support
    (reference colmap_loader.py:156-248): for each 3D point, record which
    train images observe it and at which keypoint; the caller projects to
    per-view sparse depth maps.

    Returns (xyz, rgb, err, view_xy, view_pid):
      view_xy[img_id]  -> [M, 2] keypoint pixel coords observing a point
      view_pid[img_id] -> [M] index into xyz for each observation
    """
    train_set = set(int(i) for i in train_image_ids)
    obs: Dict[int, list] = {i: [] for i in train_set}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3))
        err = np.empty((num,))
        for i in range(num):
            _pid = _read(f, 8, "Q")[0]
            xyz[i] = _read(f, 24, "ddd")
            rgb[i] = _read(f, 3, "BBB")
            err[i] = _read(f, 8, "d")[0]
            (track_len,) = _read(f, 8, "Q")
            track = np.frombuffer(f.read(8 * track_len), dtype=np.int32).reshape(-1, 2)
            for img_id, kp_idx in track:
                if int(img_id) in train_set:
                    obs[int(img_id)].append((i, int(kp_idx)))
    view_xy: Dict[int, np.ndarray] = {}
    view_pid: Dict[int, np.ndarray] = {}
    for img_id, entries in obs.items():
        view_pid[img_id] = np.array([e[0] for e in entries], dtype=np.int64)
        view_xy[img_id] = np.array([e[1] for e in entries], dtype=np.int64)
    return xyz, rgb, err, view_xy, view_pid


def sparse_depth_for_view(
    xyz: np.ndarray,
    pids: np.ndarray,
    kp_idx: np.ndarray,
    image: ColmapImage,
    K: np.ndarray,
    width: int,
    height: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Project the observed 3D points into the view -> (depth [H, W] sparse
    map with 0 holes, xy [M, 2]). The reference builds the same per-view
    sparse depth for RANSAC alignment (colmap_loader.py:203-240)."""
    R = qvec2rotmat(image.qvec)
    t = image.tvec
    pc = (R @ xyz[pids].T).T + t
    depth = pc[:, 2]
    uv = (K @ pc.T).T
    u = np.round(uv[:, 0] / uv[:, 2]).astype(np.int64)
    v = np.round(uv[:, 1] / uv[:, 2]).astype(np.int64)
    ok = (depth > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    dm = np.zeros((height, width), np.float32)
    dm[v[ok], u[ok]] = depth[ok]
    return dm, np.stack([u[ok], v[ok]], axis=-1)


def detect_model_dir(sparse_dir) -> Tuple[Dict[int, ColmapCamera], Dict[int, ColmapImage], Tuple]:
    """Load a COLMAP model dir, preferring binary."""
    sparse_dir = Path(sparse_dir)
    if (sparse_dir / "images.bin").exists():
        cams = read_cameras_binary(sparse_dir / "cameras.bin")
        images = read_images_binary(sparse_dir / "images.bin")
        points = read_points3D_binary(sparse_dir / "points3D.bin")
    else:
        cams = read_cameras_text(sparse_dir / "cameras.txt")
        images = read_images_text(sparse_dir / "images.txt")
        points = read_points3D_text(sparse_dir / "points3D.txt")
    return cams, images, points
