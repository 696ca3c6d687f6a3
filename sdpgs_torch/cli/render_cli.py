"""Render CLI: ``python -m sdpgs_torch.cli.render_cli -m <model> [...]``
renders a trained model's train and test views (and, on request, a spiral
video's frames) to PNG with depth and feature dumps.

Counterpart of ``sdpgs_tpu/cli/render_cli.py`` (reference render.py:27-118),
with the same flags and output layout. Renders on ``device`` (``cuda``
unless the caller asks for another); cameras stay on the host.
"""

from __future__ import annotations

import argparse
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


def _render_frames(vdir: Path, cameras, gaussians, raster_cfg, bg, sh_degree, dev) -> float:
    """Render each host camera to ``<vdir>/<i>.png``; the brightest frame's
    mean colour."""
    import torch

    from sdpgs_torch.render import render

    vdir.mkdir(parents=True, exist_ok=True)
    brightness = 0.0
    for i, cam in enumerate(cameras):
        with torch.no_grad():
            img = render(cam, gaussians, raster_cfg, bg, sh_degree, device=dev).color
        img = img.cpu().numpy()
        brightness = max(brightness, float(img.mean()))
        save_png(vdir / f"{i:05d}.png", img)
    return brightness


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description="SDP-GS rendering (PyTorch)")
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--video", action="store_true", help="spiral path frames")
    p.add_argument(
        "--spiral", action="store_true",
        help="render the RenderScene spiral path built from poses_bounds.npy "
             "of all source views (reference RenderScene/CreateLLFFSpiral)",
    )
    args = p.parse_args(argv)

    import torch

    from sdpgs_torch import default_device
    from sdpgs_torch.config import load_config
    from sdpgs_torch.data.scene import Scene

    dev = default_device(device)
    cfg = load_config(Path(args.model_path) / "cfg.json")
    iteration = args.iteration
    if iteration < 0:
        pc = Path(args.model_path) / "point_cloud"
        iteration = sorted(int(p.name.split("_")[1]) for p in pc.iterdir())[-1]
    scene = Scene(cfg, load_iteration=iteration, device=dev)
    bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0, device=dev)
    out_root = Path(args.model_path)

    if not args.skip_train:
        render_set(out_root, "train", iteration, scene.train_cameras, scene.gaussians,
                   cfg.raster, bg, cfg.model.sh_degree, device=dev)
    if not args.skip_test:
        render_set(out_root, "test", iteration, scene.test_cameras, scene.gaussians,
                   cfg.raster, bg, cfg.model.sh_degree, device=dev)
    if args.video:
        from sdpgs_torch.core.camera import Camera
        from sdpgs_torch.data import pose_sampling

        Rs = [c.R for c in scene.train_cameras]
        Ts = [c.T for c in scene.train_cameras]
        bounds = np.stack([c.bounds for c in scene.train_cameras])
        poses = pose_sampling.generate_spiral_path(Rs, Ts, bounds, n_frames=180)
        ref = scene.train_cameras[0]
        cams = [Camera.create(R=pose[:3, :3].T, T=pose[:3, 3], fovx=ref.fovx, fovy=ref.fovy,
                              width=ref.width, height=ref.height, device="cpu")
                for pose in poses]
        _render_frames(out_root / "video" / f"ours_{iteration}", cams, scene.gaussians,
                       cfg.raster, bg, cfg.model.sh_degree, dev)
    if args.spiral:
        from sdpgs_torch.data.scene import RenderScene

        rscene = RenderScene(cfg, load_iteration=iteration, device=dev)
        brightness = _render_frames(
            out_root / "video_spiral" / f"ours_{iteration}",
            [c.camera for c in rscene.render_cameras], rscene.gaussians, cfg.raster, bg,
            cfg.model.sh_degree, dev)
        if brightness < 1e-3:
            print(
                "WARNING: every spiral frame is black — poses_bounds.npy is "
                "likely in the wrong convention (LLFF stores c2w columns as "
                "[down, right, back])."
            )
    print("rendering done")


if __name__ == "__main__":
    main()
