"""Render a set of views to PNG with depth and feature dumps: the
counterpart of ``sdpgs_tpu/cli/render_cli.py`` (reference render.py:27-118).

``render_set`` is ported; the command-line ``main`` over
``data/scene.RenderScene`` is still to port (ROADMAP.md A3).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_png(path, arr):
    from PIL import Image

    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)


def turbo_depth(depth: np.ndarray) -> np.ndarray:
    """Simple normalized colormap for depth dumps (a dependency-free ramp
    close to the reference's turbo map, utils/general_utils.py:145-173)."""
    d = depth.astype(np.float64)
    lo, hi = np.percentile(d[d > 0], 1) if (d > 0).any() else 0, d.max() or 1
    t = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1)
    r = np.clip(1.5 - np.abs(2.0 * t - 1.5), 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * t - 1.0), 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * t - 0.5), 0, 1)
    return np.stack([r, g, b], axis=-1)


def render_set(out_root: Path, name: str, iteration: int, cameras, gaussians,
               raster_cfg, bg, sh_degree, save_depth=True, save_feature=True,
               device=None):
    """reference render.py:27-80 output layout: ``renders/``, ``gt/``,
    ``depth/`` (.npy + .png) and ``feature/`` under
    ``<out_root>/<name>/ours_<iteration>``. Renders on ``device`` (``cuda``
    unless the caller asks for another), under ``torch.no_grad``."""
    import torch

    from sdpgs_torch import default_device
    from sdpgs_torch.render import render

    dev = default_device(device)
    base = Path(out_root) / name / f"ours_{iteration}"
    rdir = base / "renders"
    gdir = base / "gt"
    ddir = base / "depth"
    fdir = base / "feature"
    for d in (rdir, gdir, ddir, fdir):
        d.mkdir(parents=True, exist_ok=True)

    for idx, cam in enumerate(cameras):
        with torch.no_grad():
            out = render(cam.camera, gaussians, raster_cfg, bg, sh_degree, device=dev)
        fname = f"{idx:05d}.png"
        save_png(rdir / fname, out.color.cpu().numpy())
        if cam.image is not None:
            save_png(gdir / fname, cam.image.transpose(1, 2, 0))
        if save_depth:
            depth = out.depth.cpu().numpy()
            np.save(ddir / f"depth_{idx:05d}.npy", depth)
            save_png(ddir / fname, turbo_depth(depth))
        if save_feature:
            save_png(fdir / fname, (out.feature.cpu().numpy() + 1.0) / 2.0)
