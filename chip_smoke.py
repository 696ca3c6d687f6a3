#!/usr/bin/env python3
"""Drive the sdpgs_torch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's kernels from ``sdpgs_torch/csrc/`` with nvcc, makes a
trained-like Gaussian cloud at the LLFF protocol's size from a seed
(504x378, capacity 131,072, 60,000 alive, SH degree 3), writes it as a PLY
and loads it back on the card, holds each kernel against its plain PyTorch
version on the same inputs, renders 8 views through ``render_set`` and
checks that every kernel ran on that path, then times each kernel, its
plain version and the render. Every phase raises on failure, so the script
exits non-zero and prints no ``ok`` line; it refuses to run without a CUDA
device. The last two lines are the ``kernels`` JSON record and the ``ok``
JSON line; the card's name and power limit are printed first.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

WIDTH, HEIGHT = 504, 378      # LLFF at resolution /8
CAPACITY = 1 << 17            # Gaussian slots
ALIVE = 60_000                # typical mid-training population
SH_DEGREE = 3
VIEWS = 8
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores
COMPOSITE_OPS_PER_PAIR = 21   # ~20 flops + one exp per (entry, pixel) visited
REPS = 20
SLEEP_CYCLES = 2_000_000      # ~1 ms of device time at H100 clocks
RENDER_PASSES = 5             # render timing: median over passes x views


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def make_cloud(rng) -> dict:
    """Trained-like parameters at capacity: ALIVE live slots, the rest dead."""
    from sdpgs_torch.core.sh import rgb_to_sh

    n, P, K = ALIVE, CAPACITY, (SH_DEGREE + 1) ** 2
    pts = rng.normal(size=(n, 3)) * np.array([1.2, 0.9, 0.6]) + np.array([0.0, 0.0, 4.0])
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    live = dict(
        xyz=pts,
        features_dc=rgb_to_sh(rng.uniform(size=(n, 1, 3))),
        features_rest=rng.normal(size=(n, K - 1, 3)) * 0.05,
        scaling=np.log(0.01) + rng.normal(size=(n, 3)) * 0.3,
        rotation=quat,
        opacity=rng.uniform(-2.0, 3.0, size=(n, 1)),
        language_feature=rng.normal(size=(n, 3)),
    )
    fill = dict(scaling=-10.0, opacity=-10.0)
    arrays = {}
    for k, v in live.items():
        out = np.full((P,) + v.shape[1:], fill.get(k, 0.0), np.float32)
        out[:n] = v
        arrays[k] = out
    arrays["rotation"][n:, 0] = 1.0
    arrays["alive"] = (np.arange(P) < n).astype(np.float32)
    arrays["confidence"] = np.ones((P, 1), np.float32)
    return arrays


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn`` over ``reps`` calls, after a warm-up.
    A device sleep queued before the start event lets the host enqueue the
    whole call first, so the events time the device work, not the host's
    Python between launches (calls that synchronise inside are still
    timed with their host gaps)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_render(render_view, cams, top: int = 12) -> None:
    """Device time by kernel over one render of each view, and the
    device's busy share of the wall time (torch.profiler / CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    render_view(cams[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for cam in cams:
            render_view(cam)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            us, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_kernel.values())
    if busy_us == 0:
        print("profile: no device time recorded")
        return
    v = len(cams)
    print(f"profile: wall {wall_us / v:.1f} us per view, device busy {busy_us / v:.1f} us "
          f"per view ({100.0 * busy_us / wall_us:.1f}% of wall), "
          f"{sum(n for _, n in by_kernel.values()) / v:g} device ops per view")
    for name, (us, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {name[:70]:70s} {us / v:9.1f} us/view x{n / v:g}")


def check_kernels(g, cam, cfg, label: str) -> dict:
    """Phases 4-6: each kernel against its plain version on the card, on
    the same inputs (K1 -> K2 on K1's output -> K3 on K2's table). Returns
    the inputs and errors the timing phase needs."""
    from sdpgs_torch.ops.rasterize import binning, composite_cuda, preprocess_cuda
    from sdpgs_torch.ops.rasterize.rasterizer import make_payload

    tiles_x, tiles_y = binning.tile_grid(WIDTH, HEIGHT, cfg.tile)
    T = tiles_x * tiles_y
    K, D = cfg.max_per_tile, cfg.max_tiles_per_gaussian
    print(f"[{label}] tile {cfg.tile} ({T} tiles), K {K}, D {D}")
    with torch.no_grad():
        # -- 4. K1 vs plain ------------------------------------------------
        geoT, shT = preprocess_cuda.pack_rows(
            g.xyz, g.get_scaling(), g.get_rotation(), g.get_features(), g.alive, SH_DEGREE)
        cam_vec = preprocess_cuda._cam_vec(cam)
        k1_args = (geoT, shT, cam_vec, SH_DEGREE, WIDTH, HEIGHT, cfg.near, cfg.low_pass)
        out_k = preprocess_cuda.preprocess_rows(*k1_args)
        out_p = preprocess_cuda.preprocess_rows_plain(*k1_args)
        torch.cuda.synchronize()
        valid_bad = int((out_k[0] != out_p[0]).sum())
        radius_bad = int((out_k[7] != out_p[7]).sum())
        float_rows = [1, 2, 3, 4, 5, 6, 8, 9, 10]
        close = torch.isclose(out_k[float_rows], out_p[float_rows], rtol=1e-5, atol=1e-5,
                              equal_nan=True)
        float_bad = int((~close).sum())
        live = out_p[0] > 0
        k1_err = float((out_k[float_rows][:, live] - out_p[float_rows][:, live]).abs().max())
        n_visible = int(live.sum())
        print(f"  K1 preprocess: valid mismatches {valid_bad}, radius mismatches "
              f"{radius_bad}, float rows outside rtol/atol 1e-5: {float_bad}, "
              f"max |diff| over {n_visible} visible {k1_err:.3e}")
        require(valid_bad == 0 and radius_bad == 0 and float_bad == 0, f"[{label}] K1 disagrees")

        # -- 5. K2 vs plain on the same Preprocessed ----------------------
        prep = preprocess_cuda.Preprocessed(
            valid=out_k[0] > 0.0, mean2d=torch.stack([out_k[1], out_k[2]], -1),
            depth=out_k[3], conic=torch.stack([out_k[4], out_k[5], out_k[6]], -1),
            radius=out_k[7])
        color = torch.stack([out_k[8], out_k[9], out_k[10]], -1)
        packed_s, order, n_valid = binning.sort_rects(prep, WIDTH, HEIGHT, cfg)
        k2_args = (packed_s, order, n_valid, T, tiles_x, K, D)
        table_k, totals_k = binning.build_table(*k2_args)
        table_p, totals_p = binning.build_table_plain(*k2_args)
        torch.cuda.synchronize()
        table_same = bool(torch.equal(table_k, table_p))
        totals_same = bool(torch.equal(totals_k, totals_p))
        k2_err = max(int((table_k - table_p).abs().max()),
                     int((totals_k - totals_p).abs().max()))
        bins = binning.bin_gaussians(prep, WIDTH, HEIGHT, cfg)
        overflow_p = int(torch.clamp_min(totals_p - K, 0).sum())
        print(f"  K2 binning: table identical {table_same}, totals identical {totals_same}, "
              f"n_valid {int(n_valid)}, entries {int(bins.num_entries)}, overflow "
              f"{int(bins.overflow)} (plain {overflow_p}), clipped {int(bins.clipped)}, "
              f"max tile count {int(totals_p.max())}")
        require(table_same and totals_same and int(bins.overflow) == overflow_p
                and torch.equal(bins.tile_index.reshape(-1), table_p)
                and torch.equal(bins.tile_counts, torch.clamp_max(totals_p, K)),
                f"[{label}] K2 disagrees")

        # -- 6. K3 vs plain on the same table and payload -----------------
        payload = make_payload(prep, g.get_opacity()[:, 0], color,
                               g.language_feature_normalized())
        counts = bins.tile_counts
        k3_args = (payload, bins.tile_index, counts, tiles_x, tiles_y, cfg, g.capacity)
        o_k = composite_cuda.composite_gather(*k3_args)
        o_p = composite_cuda.composite_gather_plain(*k3_args)
        torch.cuda.synchronize()
        d_rgb = (o_k.values[..., :3] - o_p.values[..., :3]).abs().amax(-1)
        d_alpha = (o_k.final_t - o_p.final_t).abs()
        # depth/feature: relative to max(|plain|, 1), as features cross zero
        rel = ((o_k.values[..., 3:] - o_p.values[..., 3:]).abs()
               / o_p.values[..., 3:].abs().clamp_min(1.0)).amax(-1)
        bad = (d_rgb > 1e-4) | (d_alpha > 1e-4) | (rel > 1e-3)
        n_bad, npix_all = int(bad.sum()), bad.numel()
        k3_err = float(torch.maximum(d_rgb, d_alpha).max())
        pairs = int(o_k.n_visit.sum())
        print(f"  K3 composite: pixels outside tolerance {n_bad} of {npix_all} "
              f"(limit 0.1%), max |diff| color/alpha {k3_err:.3e}, depth/feature "
              f"rel {float(rel.max()):.3e}, (entry, pixel) pairs visited {pairs}")
        require(n_bad <= npix_all // 1000, f"[{label}] K3 disagrees")

    return dict(k1_args=k1_args, k2_args=k2_args, k3_args=k3_args, k1_err=k1_err,
                k2_err=k2_err, k3_err=k3_err, pairs=pairs, payload_numel=payload.numel(), T=T, K=K,
                overflow=int(bins.overflow), clipped=int(bins.clipped))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main(device: str = "cuda") -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return drive(torch.device(device), Path(tmp))


def drive(dev: torch.device, work: Path) -> int:
    """Phases 2-9 on ``dev``, writing the PLY and the renders under ``work``."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.cli.render_cli import render_set
    from sdpgs_torch.config import RasterizeConfig
    from sdpgs_torch.core.camera import Camera
    from sdpgs_torch.core.gaussians import Gaussians
    from sdpgs_torch.data.camera_utils import LoadedCamera
    from sdpgs_torch.data.ply import load_gaussians_ply, save_gaussians_ply
    from sdpgs_torch.ops.rasterize import binning, composite_cuda, preprocess_cuda
    from sdpgs_torch.render import render

    # -- 1-2. card and kernel build ---------------------------------------
    secs = _kernels.build_seconds()
    print(f"build: {secs:.1f} s ({_kernels.build().name})", flush=True)
    for line in _kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    # -- 3. the full-width scene, through a PLY ---------------------------
    cfg = RasterizeConfig()
    rng = np.random.default_rng(0)
    ply = work / "point_cloud.ply"
    save_gaussians_ply(ply, Gaussians.from_numpy(make_cloud(rng), device="cpu"))
    g = load_gaussians_ply(ply, CAPACITY, SH_DEGREE, device=dev)
    require(g.num_alive() == ALIVE, "PLY round trip lost Gaussians")
    cams = [
        Camera.create(R=np.eye(3), T=np.array([0.1 * i - 0.35, 0.0, 0.0]), fovx=0.9,
                      fovy=0.7, width=WIDTH, height=HEIGHT, device="cpu")
        for i in range(VIEWS)
    ]
    bg = torch.zeros(3, device=dev)
    print(f"scene: {ALIVE} alive of {CAPACITY}, SH {SH_DEGREE}, {WIDTH}x{HEIGHT}, "
          f"tile {cfg.tile}, K {cfg.max_per_tile}, D {cfg.max_tiles_per_gaussian}")

    main_check = check_kernels(g, cams[0], cfg, "main config")
    # capacity edges the main scene never reaches: K overflow, D clipping
    # (sentinel holes in the table) and 16-pixel tiles (256-thread blocks)
    tight = check_kernels(g, cams[0], RasterizeConfig(tile=16, max_per_tile=128,
                                                       max_tiles_per_gaussian=2),
                          "tight config")
    require(tight["overflow"] > 0 and tight["clipped"] > 0,
            "the tight config did not reach the K and D caps")

    # -- 7. the slice end to end: render_set over 8 views -----------------
    views = [
        LoadedCamera(camera=c, R=np.eye(3), T=np.array([0.1 * i - 0.35, 0.0, 0.0]),
                     fovx=0.9, fovy=0.7, image=rng.uniform(size=(3, HEIGHT, WIDTH)),
                     image_name=f"view{i}")
        for i, c in enumerate(cams)
    ]
    out_root = work / "out"
    _kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_set(out_root, "test", 0, views, g, cfg, bg, SH_DEGREE, device=dev)
    torch.cuda.synchronize()
    set_s = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    plain = dict(_kernels.PLAIN_CALLS)
    print(f"render_set: {VIEWS} views in {set_s:.3f} s; launches {launches}; "
          f"plain calls {plain}")
    require(all(launches[k] == VIEWS for k in _kernels.KERNELS),
            "a kernel was not launched once per view")
    require(not any(plain.values()), "a plain version ran on the render path")
    base = out_root / "test" / "ours_0"
    for i in range(VIEWS):
        for f in (f"renders/{i:05d}.png", f"gt/{i:05d}.png", f"depth/{i:05d}.png",
                  f"depth/depth_{i:05d}.npy", f"feature/{i:05d}.png"):
            require((base / f).exists(), f"render_set did not write {f}")
        depth = np.load(base / "depth" / f"depth_{i:05d}.npy")
        require(depth.shape == (HEIGHT, WIDTH) and np.isfinite(depth).all(),
                f"view {i}: depth not finite or misshapen")

    out = render(cams[0], g, cfg, bg, SH_DEGREE, device=dev)
    for name in ("color", "depth", "alpha", "feature"):
        require(bool(torch.isfinite(getattr(out, name)).all()), f"{name} not finite")
    mean_alpha = float(out.alpha.mean())
    require(mean_alpha > 0.05, f"mean alpha {mean_alpha} too low")
    g_cpu = load_gaussians_ply(ply, CAPACITY, SH_DEGREE, device="cpu")
    ref = render(cams[0], g_cpu, cfg, torch.zeros(3), SH_DEGREE, device="cpu")
    mse = float(((out.color.cpu() - ref.color) ** 2).mean())
    psnr = 10.0 * math.log10(1.0 / max(mse, 1e-20))
    print(f"view 0: mean alpha {mean_alpha:.4f}, overflow {int(out.overflow)}, "
          f"clipped {int(out.clipped)}, card vs plain CPU path PSNR {psnr:.1f} dB")
    require(psnr >= 50.0, f"card render differs from the plain path: {psnr:.1f} dB")

    # -- 8. timings and bounds ---------------------------------------------
    k1_args, k2_args, k3_args = (main_check[k] for k in ("k1_args", "k2_args", "k3_args"))
    T, K, pairs = main_check["T"], main_check["K"], main_check["pairs"]
    with torch.no_grad():
        k1_ms = cuda_ms(lambda: preprocess_cuda.preprocess_rows(*k1_args))
        k1_plain = cuda_ms(lambda: preprocess_cuda.preprocess_rows_plain(*k1_args))
        k2_ms = cuda_ms(lambda: binning.build_table(*k2_args))
        k2_plain = cuda_ms(lambda: binning.build_table_plain(*k2_args))
        k3_ms = cuda_ms(lambda: composite_cuda.composite_gather(*k3_args))
        k3_plain = cuda_ms(lambda: composite_cuda.composite_gather_plain(*k3_args))
    nsh = 3 * (SH_DEGREE + 1) ** 2
    k1_bytes = (preprocess_cuda.NGEO + nsh + preprocess_cuda.NOUT) * 4 * CAPACITY
    k2_bytes = (2 * CAPACITY + 1 + T * K + T) * 4
    k3_bytes = (main_check["payload_numel"] + T * K + T + T * cfg.tile ** 2 * (composite_cuda.NCH + 1)) * 4
    k3_ops = pairs * COMPOSITE_OPS_PER_PAIR
    bounds = {
        "k1": (k1_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
        "k2": (k2_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
        "k3": max((k3_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                  (k3_ops / F32_FLOPS * 1e3, "operations")),
    }
    records = [
        dict(name="preprocess_sh_fwd", route="cuda", source="sdpgs_torch/csrc/preprocess.cu",
             replaces="sdpgs_tpu/ops/rasterize/preprocess_pallas.py:227",
             launches=launches["preprocess"], max_abs_err=main_check["k1_err"], ms=k1_ms,
             plain_ms=k1_plain, bound_ms=bounds["k1"][0], bound_by=bounds["k1"][1],
             library_ms=None),
        dict(name="bin_table", route="cuda", source="sdpgs_torch/csrc/binning.cu",
             replaces="sdpgs_tpu/ops/rasterize/rank_pallas.py:851",
             launches=launches["binning"], max_abs_err=main_check["k2_err"],
             ms=k2_ms, plain_ms=k2_plain, bound_ms=bounds["k2"][0],
             bound_by=bounds["k2"][1], library_ms=None),
        dict(name="composite_fwd", route="cuda", source="sdpgs_torch/csrc/composite.cu",
             replaces="sdpgs_tpu/ops/rasterize/composite_pallas.py:283",
             launches=launches["composite"], max_abs_err=main_check["k3_err"], ms=k3_ms,
             plain_ms=k3_plain, bound_ms=bounds["k3"][0], bound_by=bounds["k3"][1],
             library_ms=None),
    ]
    for r in records:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms), bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, "
              f"{r['launches'] // VIEWS} launch per view")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_view = []
    for _ in range(RENDER_PASSES):
        for cam in cams:
            t0 = time.perf_counter()
            render(cam, g, cfg, bg, SH_DEGREE, device=dev)
            torch.cuda.synchronize()
            per_view.append((time.perf_counter() - t0) * 1e3)
    view_ms = statistics.median(per_view)
    print(f"render: {view_ms:.3f} ms per view (median of {len(per_view)}; min "
          f"{min(per_view):.3f}, max {max(per_view):.3f}), "
          f"{1e3 / view_ms:.1f} views/s; render_set with PNG/NPY writes "
          f"{set_s / VIEWS * 1e3:.1f} ms per view")

    print(f"render peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    profile_render(lambda cam: render(cam, g, cfg, bg, SH_DEGREE, device=dev), cams)

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
