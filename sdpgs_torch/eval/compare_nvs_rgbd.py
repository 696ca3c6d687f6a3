"""NVS-RGBD sensor-depth vs mono-depth comparator
(reference compare/compare_nvs-RGBD.py:42-158): scale-and-shift the mono
depth to the sensor depth over the valid range and produce a 2D density
histogram of the correspondence (saved as .npz; plotting left to the
caller — the reference used matplotlib contour plots). Host numpy, a copy
of ``sdpgs_tpu/eval/compare_nvs_rgbd.py``."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from sdpgs_torch.data.camera_utils import resize_nearest
from sdpgs_torch.pipelines.depth_align import compute_scale_and_shift


def compare_depth(
    depth_sensor: np.ndarray, depth_mono: np.ndarray, bins: int = 50
) -> Dict[str, np.ndarray]:
    """-> {'density' [bins, bins], 'x_edges', 'y_edges', 'a', 'b'}."""
    depth_mono = resize_nearest(
        depth_mono.astype(np.float32), depth_sensor.shape[0], depth_sensor.shape[1]
    )
    sensor = depth_sensor.astype(np.float64) / max(depth_sensor.max(), 1e-9) * 255.0
    mono = depth_mono.astype(np.float64)
    valid = (sensor > 0) & (sensor < 0.99 * sensor.max())
    s = sensor[valid] / 255.0
    m = mono[valid] / 255.0
    a, b = compute_scale_and_shift(m, s)
    m_aligned = a * m + b
    density, xe, ye = np.histogram2d(s, m_aligned, bins=bins)
    return {
        "density": density, "x_edges": xe, "y_edges": ye,
        "a": np.float64(a), "b": np.float64(b),
    }


def compare_scene(
    scene_path, splits=("iphone", "kinect"), out_dir="depth_compare"
) -> List[str]:
    """Batch over a NVS-RGBD-layout scene: per view, sensor depth at
    ``depth/<name>.png`` vs mono at ``depth_maps/depth_<name>.png``."""
    from PIL import Image

    scene_path = Path(scene_path)
    out = scene_path / out_dir
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for split in splits:
        for sensor_file in sorted((scene_path / split / "depth").glob("*.png")):
            name = sensor_file.stem
            mono_file = scene_path / split / "depth_maps" / f"depth_{name}.png"
            if not mono_file.exists():
                continue
            sensor = np.asarray(Image.open(sensor_file), np.float32)
            mono = np.asarray(Image.open(mono_file).convert("L"), np.float32)
            res = compare_depth(sensor, mono)
            path = out / f"{split}_{name}.npz"
            np.savez(path, **res)
            written.append(str(path))
    return written
