"""Long-horizon synthetic convergence run.

Counterpart of ``scripts/convergence_run.py``: the port's train CLI for
1,500 iterations on a miniature LLFF-style scene whose images are renders
of a ground-truth splat cloud (the acceptance rig's scene,
``tests/test_acceptance.py:make_full_scene``, copied here), through the
densification window, the pseudo window (a random-weight tiny DPT in the
loss) and the scheduled opacity reset, with three checks on the PSNR
trajectory:

  - train PSNR >= 25 dB at the end (the scene is a consistent render of a
    real splat cloud, so a correct optimizer must fit it well);
  - test PSNR (held-out views) gains at least 5 dB over the first eval;
  - the train-test gap at the end is at most 6 dB.

Run (``device="cpu"`` from Python for the plain path):

    python -m sdpgs_torch.cli.convergence_run [workdir]

Results land in ``<workdir>/out/eval_results.json``; the return code is 1
when a check fails.
"""

from __future__ import annotations

import json
import struct
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from sdpgs_torch import default_device

ITERATIONS = 1500
W, H = 64, 48
FOCAL = 60.0
N_VIEWS = 9
TEST_ITERATIONS = (1, 100, 300, 600, 900, 1200, 1500)
MIN_TRAIN_PSNR = 25.0
MIN_TEST_GAIN = 5.0
MAX_GAP = 6.0


def _gt_cloud(rng, n=96, device=None):
    from sdpgs_torch.core.gaussians import create_from_points

    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5 + np.array([0, 0, 3.0], np.float32)
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    return pts, cols, create_from_points(pts, cols, n, init_scale=np.full(n, 0.02),
                                         initial_opacity=0.9, device=device)


def make_full_scene(root, rng, device=None):
    """Miniature LLFF scene whose images are renders of a GT cloud, with
    every auxiliary input the reference pipeline consumes (COLMAP binaries,
    poses_bounds.npy, PNG images, *_s.npy/*_fdim3.npy language features,
    PFM mono depth, sparse stereo depth); the same files and draws as
    tests/test_acceptance.py:make_full_scene, rendered by the port."""
    from PIL import Image

    from sdpgs_torch.config import RasterizeConfig
    from sdpgs_torch.core.camera import Camera
    from sdpgs_torch.data.readers import write_pfm
    from sdpgs_torch.render import render

    dev = default_device(device)
    root = Path(root)
    fovx = 2 * np.arctan(W / (2 * FOCAL))
    fovy = 2 * np.arctan(H / (2 * FOCAL))
    pts, cols, gt = _gt_cloud(rng, device=dev)
    cfg = RasterizeConfig(tile=16, max_per_tile=128, max_tiles_per_gaussian=8, chunk=32,
                          use_pallas=False)

    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    for d in ("images", "features_dim3", "depth_maps_anything", "stereo_depth"):
        (root / d).mkdir()

    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, W, H))
        f.write(struct.pack("<dddd", FOCAL, FOCAL, W / 2, H / 2))

    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", N_VIEWS))
        for i in range(N_VIEWS):
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", 1.0, 0.0, 0.0, 0.0))  # identity quat
            f.write(struct.pack("<ddd", 0.08 * i - 0.32, 0.0, 0.0))
            f.write(struct.pack("<i", 1))
            f.write(f"image{i:03d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))

    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for pid, (p, c) in enumerate(zip(pts, cols)):
            f.write(struct.pack("<Q", pid))
            f.write(struct.pack("<ddd", *p.astype(np.float64)))
            f.write(struct.pack("<BBB", *(c * 255).astype(np.uint8)))
            f.write(struct.pack("<d", 0.3))
            f.write(struct.pack("<Q", 0))

    bounds = np.zeros((N_VIEWS, 17))
    bounds[:, -2] = 1.0
    bounds[:, -1] = 10.0
    np.save(root / "poses_bounds.npy", bounds)

    for i in range(N_VIEWS):
        T = np.array([0.08 * i - 0.32, 0.0, 0.0])
        cam = Camera.create(R=np.eye(3), T=T, fovx=fovx, fovy=fovy, width=W, height=H,
                            device="cpu")
        with torch.no_grad():
            out = render(cam, gt, cfg, torch.zeros(3, device=dev), 0, device=dev)
        img = np.clip(out.color.cpu().numpy(), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(root / "images" / f"image{i:03d}.png")
        depth = out.depth.cpu().numpy()
        # mono depth: inverted (disparity-like), as a DPT would produce;
        # conclude re-inverts and RANSAC-aligns it to the sparse stereo
        write_pfm(root / "depth_maps_anything" / f"depth_image{i:03d}.pfm",
                  depth.max() + 0.5 - depth)
        stereo = np.where(rng.random(depth.shape) < 0.3, depth, 0.0)
        np.save(root / "stereo_depth" / f"depth_image{i:03d}.npy", stereo.astype(np.float32))
        # 2-segment map (left/right) + per-segment feature dictionary
        seg = np.zeros((H, W), np.int64)
        seg[:, W // 2:] = 1
        np.save(root / "features_dim3" / f"image{i:03d}_s.npy", seg)
        np.save(root / "features_dim3" / f"image{i:03d}_fdim3.npy",
                np.asarray([[0.8, 0.1, 0.1], [0.1, 0.1, 0.8]], np.float32))
    return root


def train_argv(root: Path, out: Path, dpt_path: Path, iterations: int) -> list:
    """scripts/convergence_run.py:69-82's flags, the test iterations past
    ``iterations`` dropped."""
    tests = [str(i) for i in TEST_ITERATIONS if i < iterations] + [str(iterations)]
    return [
        "-s", str(root), "-m", str(out), "-r", "2", "-l", "features_dim3",
        "--capacity", "1024", "--iterations", str(iterations), "--seed", "0",
        "--test_iterations", *tests,
        "--save_iterations", str(iterations),
        "--checkpoint_iterations", str(iterations),
        "--dpt_weights", str(dpt_path),
        "--densify_from_iter", "100", "--densification_interval", "100",
        "--densify_until_iter", "900", "--proximity_until_iter", "300",
        "--prune_from_iter", "100",
        "--start_sample_pseudo", "300", "--end_sample_pseudo", "1200",
        "--sample_pseudo_interval", "1", "--opacity_reset_interval", "3000",
        "--position_lr_max_steps", str(iterations),
    ]


def check(evals: list) -> list:
    """The three checks on the eval trajectory; returns the failures."""
    first, last = evals[0], evals[-1]
    fails = []
    if last["train"]["psnr"] < MIN_TRAIN_PSNR:
        fails.append(f"final train PSNR {last['train']['psnr']:.2f} < {MIN_TRAIN_PSNR:g}")
    if last["test"]["psnr"] < first["test"]["psnr"] + MIN_TEST_GAIN:
        fails.append(f"test PSNR gained {last['test']['psnr'] - first['test']['psnr']:.2f} dB "
                     f"(< {MIN_TEST_GAIN:g})")
    if last["train"]["psnr"] - last["test"]["psnr"] > MAX_GAP:
        fails.append(f"train-test gap {last['train']['psnr'] - last['test']['psnr']:.2f} dB "
                     f"(> {MAX_GAP:g})")
    return fails


def main(workdir=None, iterations: int = ITERATIONS, device=None) -> int:
    """Write the scene, the tiny DPT (seed 3) and the aligned depths under
    ``workdir`` (each once), train with the train CLI on ``device`` and
    check the trajectory. Returns 0, or 1 when a check fails."""
    from sdpgs_torch.cli.train_cli import main as train_main
    from sdpgs_torch.models.dpt import DPTArch, random_params, save_params
    from sdpgs_torch.pipelines.depth_align import conclude_depth_for_scene

    dev = default_device(device)
    workdir = Path(workdir if workdir is not None
                   else Path(tempfile.gettempdir()) / "sdpgs_convergence")
    root, out = workdir / "scene", workdir / "out"
    if not (root / "poses_bounds.npy").exists():
        root.mkdir(parents=True, exist_ok=True)
        make_full_scene(root, np.random.default_rng(7), device=dev)
    dpt_path = workdir / "dpt_tiny_hybrid.npz"
    if not dpt_path.exists():
        save_params(dpt_path, random_params(DPTArch.tiny_hybrid(), seed=3), DPTArch.tiny_hybrid())
    if not (root / "depth_adjust_maps_stereo").exists():
        conclude_depth_for_scene(root, mono_depth_dir="depth_maps_anything",
                                 seg_dir="features_dim3", out_dir="depth_adjust_maps_stereo")

    train_main(train_argv(root, out, dpt_path, iterations), device=dev)

    evals = json.loads((out / "eval_results.json").read_text())
    print(f"{'iter':>6} {'train_psnr':>10} {'test_psnr':>10}")
    for e in evals:
        print(f"{e['iteration']:>6} {e['train']['psnr']:>10.2f} {e['test']['psnr']:>10.2f}")
    fails = check(evals)
    for f in fails:
        print("FAIL: " + f)
    print("CONVERGENCE", "FAILED" if fails else "OK")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
