"""MVS interchange helpers.

- ``write_mvs_cams``: per-view ``cams/NAME_cam.txt`` with 4x4 extrinsic, 3x3
  intrinsic, and a depth range from track-depth percentiles
  (reference colmap2mvs.py:281-440).
- ``read_colmap_array`` / ``write_colmap_array``: COLMAP dense-stereo
  ``.bin`` depth/normal maps (reference read_dense.py:39-117).
- ``extract_dense_depths``: stereo .bin -> .npy with percentile clamping
  (reference read_dense.py:119-181).

Host numpy over the port's ``data/colmap``, a copy of
``sdpgs_tpu/pipelines/mvs.py``.
"""

from __future__ import annotations

from pathlib import Path
import numpy as np

from sdpgs_torch.data import colmap


def read_colmap_array(path) -> np.ndarray:
    """COLMAP dense .bin array: 'W&H&C&' ascii header + column-major f32."""
    with open(path, "rb") as f:
        header = b""
        amp = 0
        while amp < 3:
            c = f.read(1)
            header += c
            if c == b"&":
                amp += 1
        w, h, c = map(int, header[:-1].split(b"&"))
        data = np.fromfile(f, np.float32, w * h * c)
    return data.reshape(h, w, c, order="F").squeeze()


def write_colmap_array(path, arr: np.ndarray) -> None:
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode())
        arr.astype(np.float32).reshape(h, w, c).flatten(order="F").tofile(f)


def extract_dense_depths(
    dense_dir, out_dir, kind: str = "geometric", pmin: float = 5, pmax: float = 95
) -> None:
    """reference read_dense.py:119-181: clamp to [p5, p95] percentiles of the
    positive values and save .npy."""
    dense_dir, out_dir = Path(dense_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for binf in sorted(dense_dir.glob(f"*.{kind}.bin")):
        depth = read_colmap_array(binf)
        pos = depth[depth > 0]
        if pos.size:
            lo, hi = np.percentile(pos, [pmin, pmax])
            depth = np.clip(depth, 0, hi)
            depth[depth < lo] = 0
        name = binf.name.split(".")[0]
        np.save(out_dir / f"depth_{Path(name).stem}.npy", depth)


def write_mvs_cams(
    sparse_dir, out_dir, num_depths: int = 192, interval_scale: float = 1.06
) -> None:
    """reference colmap2mvs.py:281-440: per-view cam files with depth range
    derived from the 1%/99% percentiles of the view's track depths and an
    inverse-depth step count."""
    sparse_dir, out_dir = Path(sparse_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cams, images, (xyz, rgb, err) = colmap.detect_model_dir(sparse_dir)

    for img in images.values():
        intr = cams[img.camera_id]
        if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fx = fy = intr.params[0]
            cx, cy = intr.params[1], intr.params[2]
        else:
            fx, fy, cx, cy = intr.params[:4]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        R = colmap.qvec2rotmat(img.qvec)
        t = img.tvec

        # depths of this view's observed 3D points
        pids = img.point3D_ids[img.point3D_ids >= 0]
        if len(pids):
            pc = (R @ xyz[np.clip(pids, 0, len(xyz) - 1)].T).T + t
            depths = pc[:, 2]
            depths = depths[depths > 0]
        else:
            depths = np.array([1.0, 10.0])
        if depths.size == 0:
            depths = np.array([1.0, 10.0])
        d_min = float(np.percentile(depths, 1))
        d_max = float(np.percentile(depths, 99))
        interval = (1.0 / d_min - 1.0 / d_max) / max(num_depths - 1, 1)
        interval *= interval_scale

        ext = np.eye(4)
        ext[:3, :3] = R
        ext[:3, 3] = t
        name = Path(img.name).stem
        lines = ["extrinsic"]
        lines += [" ".join(f"{v:.6f}" for v in row) for row in ext]
        lines += ["", "intrinsic"]
        lines += [" ".join(f"{v:.6f}" for v in row) for row in K]
        lines += ["", f"{d_min:.6f} {interval:.6f} {num_depths} {d_max:.6f}"]
        (out_dir / f"{name}_cam.txt").write_text("\n".join(lines) + "\n")
