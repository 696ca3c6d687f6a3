#!/usr/bin/env python3
"""Drive the sdpgs_torch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's five kernels from ``sdpgs_torch/csrc/`` with nvcc and
drives its two paths at the LLFF protocol's size (504x378, capacity
131,072, 60,000 alive, SH degree 3), clouds made from a seed:

- serving: a trained-like cloud is written as a PLY and loaded back on the
  card; each kernel (K1-K3 forward, K4-K5 backward) is held against its
  plain PyTorch version on the same inputs at the main and a tight config,
  K5 also on poisoned conics and where alpha clamps at 0.99;
  8 views render through ``render_set``, which must launch K1-K3 once per
  view and nothing else;
- training: one train step on the card against the same step on the CPU
  at a reduced size, then 30 plain train steps (``make_train_step``) on a
  perturbed copy of a ground-truth cloud, which must lower L1 and launch
  each of K1-K5 once per step and no plain version.

It then times each kernel, its plain version, a render and a train step,
and profiles both. Every phase raises on failure, so the script exits
non-zero and prints no ``ok`` line; it refuses to run without a CUDA
device. The card's name and power limit are printed first; the last two
lines are the ``kernels`` JSON record and the ``ok`` JSON line.
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
ALPHA_OPS = 16                # alpha test per (entry, pixel) pair: ~15 flops + one exp
BLEND_OPS = 18                # K3 per contributing pair: T (1 - alpha), its test, 7 FMAs
GRAD_OPS = 61                 # K5 per contributing pair: 13 gradients (~48 flops) and
                              # their 13 adds into the entry's row
REPS = 20
SLEEP_CYCLES = 2_000_000      # ~1 ms of device time at H100 clocks
RENDER_PASSES = 5             # render timing: median over passes x views
K4_TOL = 1e-4                 # K4 vs autograd: |diff| <= 1e-4 x the field's max
K5_TOL = 1e-3                 # K5 vs autograd: atomics' order and T recovered by
                              # division; no payload row beyond it
PLAIN_TILES_PER_PASS = 16     # K5's plain version: tiles per autograd pass
K4_BYTES_ROWS = 11 + 11 + 11  # K4 reads geometry and cotangent rows, writes d geometry
TRAIN_STEPS = 30              # full-width train steps, cycling the train cameras
TRAIN_WARMUP = 5              # steps left out of the step-time median
TRAIN_CAMS = 3
PROTOTYPES = 16               # segment prototypes (S)
L1_MARGIN = 0.9               # mean L1 of the last cycle < 0.9 x the first's
SMALL = dict(width=WIDTH // 4, height=HEIGHT // 4, capacity=1 << 14, alive=ALIVE // 8)
STEP_GRAD_TOL = 1e-3          # card vs CPU step: gradients within 1e-3 of the field max
STEP_METRIC_RTOL = 1e-4       # card vs CPU step: loss, L1, PSNR


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def make_cloud(rng, n: int = ALIVE, P: int = CAPACITY) -> dict:
    """Trained-like parameters at capacity P: n live slots, the rest dead."""
    from sdpgs_torch.core.sh import rgb_to_sh

    K = (SH_DEGREE + 1) ** 2
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


def profile_calls(fn, items, unit: str, top: int = 12) -> dict:
    """Device time by kernel over one call of ``fn`` per item, and the
    device's busy share of the wall time (torch.profiler / CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    fn(items[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for item in items:
            fn(item)
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
        return {}
    v = len(items)
    print(f"profile: wall {wall_us / v:.1f} us per {unit}, device busy {busy_us / v:.1f} us "
          f"per {unit} ({100.0 * busy_us / wall_us:.1f}% of wall), "
          f"{sum(n for _, n in by_kernel.values()) / v:g} device ops per {unit}")
    for name, (us, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {name[:70]:70s} {us / v:9.1f} us/{unit} x{n / v:g}")
    return dict(wall_us=wall_us / v, busy_us=busy_us / v)


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

    bwd = check_backward_kernels(g, label, k1_args, k3_args)
    return dict(k1_args=k1_args, k2_args=k2_args, k3_args=k3_args, k1_err=k1_err,
                k2_err=k2_err, k3_err=k3_err, pairs=pairs, payload_numel=payload.numel(), T=T, K=K,
                overflow=int(bins.overflow), clipped=int(bins.clipped), **bwd)


def field_errors(got: torch.Tensor, ref: torch.Tensor, tol: float):
    """Per field (row of ``ref``): max |got - ref| over max |ref|, and the
    count of elements with |got - ref| > tol * max |ref|."""
    diff = (got - ref).abs()
    scale = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    rel = (diff / scale).amax(dim=1)
    bad = int((diff > tol * scale).sum())
    return rel, bad


def k5_versus_plain(args, gen, stats=None):
    """K3 forward, then K5 and its plain version at seeded random
    cotangents on the compositing inputs ``args``. Returns (K5's and the
    plain payload gradient, K5's launch arguments)."""
    from sdpgs_torch.ops.rasterize import composite_cuda

    payload, table, counts, tiles_x, tiles_y, cfg, P = args
    dev = payload.device
    out, last = composite_cuda.composite_gather_fwd(*args)
    g_values = torch.randn(tuple(out.values.shape), generator=gen, device=dev)
    g_final_t = torch.randn(tuple(out.final_t.shape), generator=gen, device=dev)
    k5_args = (payload, table, out.final_t, last, g_values, g_final_t, tiles_x, tiles_y,
               cfg, P)
    d_k = composite_cuda.composite_gather_bwd(*k5_args, stats=stats)
    d_p = composite_cuda.composite_vjp_plain(*args, g_values, g_final_t,
                                             tiles_per_pass=PLAIN_TILES_PER_PASS)
    torch.cuda.synchronize()
    return d_k, d_p, k5_args


def k5_errors(d_k: torch.Tensor, d_p: torch.Tensor):
    """K5's payload gradient against its plain version: max |diff| over the
    column max per column, the rows with any element beyond K5_TOL x its
    column max, the rows the plain version gives a gradient, max |diff|."""
    diff = (d_k - d_p).abs()
    scale = d_p.abs().amax(dim=0, keepdim=True).clamp_min(1e-30)
    rows_bad = int((diff > K5_TOL * scale).any(dim=1).sum())
    rows_live = int((d_p != 0).any(dim=1).sum())
    return (diff / scale).amax(dim=0), rows_bad, rows_live, float(diff.max())


def check_poisoned_conic(k3_args, cfg) -> None:
    """K5 where garbage conics put power >> 0, so exp(power) would overflow
    (tests/test_pallas_composite.py:106-122): the masked entries' zero
    gradient must not become 0 * inf = NaN."""
    payload, table, counts, tiles_x, tiles_y, _, P = k3_args
    gen = torch.Generator(device=payload.device).manual_seed(2)
    pay = payload.clone()
    hit = torch.unique(table[table < P])[::50]
    pay[hit, 2] = -500.0
    pay[hit, 3] = 0.0
    pay[hit, 4] = -500.0
    with torch.no_grad():
        d_k, d_p, _ = k5_versus_plain((pay, table, counts, tiles_x, tiles_y, cfg, P), gen)
    _, rows_bad, rows_live, err = k5_errors(d_k, d_p)
    finite = bool(torch.isfinite(d_k).all())
    hit_zero = not bool(d_k[hit].any())
    print(f"  K5 poisoned conics ({hit.numel()} rows at a = c = -500): finite {finite}, "
          f"poisoned rows all zero {hit_zero}, rows beyond {K5_TOL:g} x column max "
          f"{rows_bad} of {rows_live}, max |diff| {err:.3e}")
    require(finite and hit_zero and rows_bad == 0,
            "K5 on poisoned conics is not finite or disagrees")


def check_clamped_alpha(k3_args, cfg) -> None:
    """K5 where alpha reaches the alpha_max clamp: every tenth binned
    Gaussian made near-opaque (0.999) and ten times wider, so op e^power
    passes 0.99 at the pixels around its centre. JAX gives those pairs no
    alpha-gradient (not_clamped, composite_pallas.py:68,215-216); K5 must
    agree with autograd through min(alpha_max, .), and K5's own count of
    clamped contributing pairs shows the case was reached."""
    payload, table, counts, tiles_x, tiles_y, _, P = k3_args
    dev = payload.device
    gen = torch.Generator(device=dev).manual_seed(3)
    pay = payload.clone()
    hit = torch.unique(table[table < P])[::10]
    pay[hit, 2:5] *= 0.01
    pay[hit, 5] = 0.999
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    with torch.no_grad():
        d_k, d_p, _ = k5_versus_plain((pay, table, counts, tiles_x, tiles_y, cfg, P), gen,
                                      stats)
    rel, rows_bad, rows_live, err = k5_errors(d_k, d_p)
    contrib, clamped = (int(v) for v in stats.tolist())
    print(f"  K5 clamped alpha ({hit.numel()} rows at opacity 0.999): contributing pairs "
          f"{contrib}, clamped at {cfg.alpha_max:g} {clamped}; rows beyond {K5_TOL:g} x "
          f"column max {rows_bad} of {rows_live}, max |diff| / column max "
          f"{float(rel.max()):.1e}, max |diff| {err:.3e}")
    require(clamped > 0, "the clamp phase reached no clamped pair")
    require(bool(torch.isfinite(d_k).all()) and rows_bad == 0,
            "K5 disagrees where alpha is clamped")


def check_backward_kernels(g, label: str, k1_args, k3_args) -> dict:
    """K4 and K5 against their plain versions (autograd) on the card, on
    K1's and K3's inputs with seeded random cotangents."""
    from sdpgs_torch.ops.rasterize import preprocess_cuda

    dev = g.xyz.device
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        # -- K4 vs plain: cotangents on the alive slots ---------------------
        geoT = k1_args[0]
        P = geoT.shape[1]
        ct = torch.randn((preprocess_cuda.NOUT, P), generator=gen, device=dev) * g.alive
        masks = torch.empty(P, dtype=torch.int32, device=dev)
        dgeo_k, dsh_k = preprocess_cuda.preprocess_rows_bwd(*k1_args[:3], ct, *k1_args[3:],
                                                            masks=masks)
        dgeo_p, dsh_p = preprocess_cuda.preprocess_vjp_plain(*k1_args[:3], ct, *k1_args[3:])
        masks_p = preprocess_cuda.row_masks_plain(*k1_args)
        torch.cuda.synchronize()
        mask_bad = int((masks != masks_p).sum())
        # fields: x y z, sx sy sz, qw qx qy qz, and the SH block as one
        rel_g, bad_g = field_errors(dgeo_k[:10], dgeo_p[:10], K4_TOL)
        rel_s, bad_s = field_errors(dsh_k.reshape(1, -1), dsh_p.reshape(1, -1), K4_TOL)
        k4_err = float(torch.maximum((dgeo_k - dgeo_p).abs().max(), (dsh_k - dsh_p).abs().max()))
        print(f"  K4 preprocess bwd: mask disagreements {mask_bad} of {P}, elements beyond "
              f"{K4_TOL:g} x field max {bad_g + bad_s}, max |diff| / field max per field "
              f"{[f'{v:.1e}' for v in rel_g.tolist()]} sh {float(rel_s.max()):.1e}, "
              f"max |diff| {k4_err:.3e}")
        require(mask_bad == 0 and bad_g + bad_s == 0 and bool(torch.isfinite(dgeo_k).all()),
                f"[{label}] K4 disagrees")

        # -- K5 vs plain: the payload gradient at random cotangents --------
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        d_k, d_p, k5_args = k5_versus_plain(k3_args, gen, stats)
        rel5, rows_bad, rows_live, k5_err = k5_errors(d_k, d_p)
        walked = int(k5_args[3].sum())   # up to each pixel's last contributor
        contrib, clamped = (int(v) for v in stats.tolist())
        print(f"  K5 composite bwd: payload rows beyond {K5_TOL:g} x column max {rows_bad} of "
              f"{rows_live} with a gradient (limit 0), max |diff| / column max "
              f"{[f'{v:.1e}' for v in rel5.tolist()]}, max |diff| {k5_err:.3e}; "
              f"(entry, pixel) pairs walked {walked}, contributing {contrib} (clamped "
              f"{clamped})")
        require(bool(torch.isfinite(d_k).all()) and rows_bad == 0, f"[{label}] K5 disagrees")
    return dict(k4_args=(*k1_args[:3], ct, *k1_args[3:]), k4_err=k4_err,
                k5_args=k5_args, k5_plain_args=(*k3_args, *k5_args[4:6]),
                k5_err=k5_err, walked=walked, contrib=contrib)


def perturb(arrays: dict, rng) -> dict:
    """The trainee: the ground-truth cloud moved, dimmed and recoloured."""
    n = int(arrays["alive"].sum())
    out = {k: v.copy() for k, v in arrays.items()}
    out["xyz"][:n] += rng.normal(size=(n, 3)) * 0.01
    out["opacity"][:n] -= 2.0
    out["features_dc"][:n] += rng.normal(size=(n, 1, 3)) * 0.2
    return out


def train_scene(rng, dev, width: int, height: int, capacity: int, alive: int):
    """A ground-truth cloud rendered on ``dev`` from TRAIN_CAMS cameras (the
    targets: images, mono depth, features), random segment maps and
    prototypes, and the trainee's arrays."""
    from sdpgs_torch.config import RasterizeConfig
    from sdpgs_torch.core.camera import Camera
    from sdpgs_torch.core.gaussians import Gaussians
    from sdpgs_torch.render import render

    gt = make_cloud(rng, alive, capacity)
    g = Gaussians.from_numpy(gt, device=dev)
    cams = [Camera.create(R=np.eye(3), T=np.array([0.1 * i - 0.1, 0.0, 0.0]), fovx=0.9,
                          fovy=0.7, width=width, height=height, device="cpu")
            for i in range(TRAIN_CAMS)]
    with torch.no_grad():
        outs = [render(c, g, RasterizeConfig(), torch.zeros(3, device=dev), SH_DEGREE,
                       device=dev) for c in cams]
    data = dict(
        cams=cams,
        image=torch.stack([o.color.permute(2, 0, 1) for o in outs]),
        depth_mono=torch.stack([o.depth for o in outs]),
        feature=torch.stack([o.feature.permute(2, 0, 1) for o in outs]),
        seg_map=torch.from_numpy(rng.integers(0, PROTOTYPES, (TRAIN_CAMS, height, width))
                                 .astype(np.int32)).to(dev),
        protos=torch.from_numpy(rng.normal(size=(PROTOTYPES, 3)).astype(np.float32)).to(dev),
    )
    return perturb(gt, rng), data


def view_batch(data: dict, v: int, dev):
    from sdpgs_torch.train.step import ViewBatch

    return ViewBatch(cameras=[data["cams"][v]], image=data["image"][v:v + 1].to(dev),
                     depth_mono=data["depth_mono"][v:v + 1].to(dev),
                     feature=data["feature"][v:v + 1].to(dev),
                     seg_map=data["seg_map"][v:v + 1].to(dev))


def check_step_card_vs_cpu(rng, dev) -> None:
    """One train step from the same state on the card (kernels) and on the
    CPU (plain versions) at a reduced size: gradients and StepMetrics."""
    from sdpgs_torch.config import TrainConfig
    from sdpgs_torch.core.gaussians import Gaussians
    from sdpgs_torch.opt.adam import TRAINABLE
    from sdpgs_torch.train.state import TrainState
    from sdpgs_torch.train.step import loss_and_grads, make_train_step

    trainee, data = train_scene(rng, dev, **SMALL)
    tcfg = TrainConfig()
    res = {}
    for d in (dev, torch.device("cpu")):
        state = TrainState.create(Gaussians.from_numpy(trainee, device=d), device=d)
        batch, protos, bg = view_batch(data, 0, d), data["protos"].to(d), torch.zeros(3, device=d)
        grads = loss_and_grads(state, batch, protos, bg, tcfg, SH_DEGREE, d)
        _, m = make_train_step(tcfg, SH_DEGREE)(state, batch, protos, bg, 1.0, device=d)
        res[d.type] = (grads, m)
    (g_c, m_c), (g_p, m_p) = res[dev.type], res["cpu"]
    rel = {}
    for k in TRAINABLE:
        ref = g_p.params[k]
        rel[k] = float((g_c.params[k].cpu() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    ref = g_p.offsets
    rel["means2d"] = float((g_c.offsets.cpu() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    metric_rel = {k: abs(float(getattr(m_c, k)) - float(getattr(m_p, k)))
                  / max(abs(float(getattr(m_p, k))), 1e-30) for k in ("loss", "l1", "psnr")}
    exact = {k: (int(getattr(m_c, k)), int(getattr(m_p, k)))
             for k in ("overflow", "clipped", "num_alive", "slab")}
    print(f"train step, card vs CPU at {SMALL['width']}x{SMALL['height']}, capacity "
          f"{SMALL['capacity']}: gradient max |diff| / field max "
          f"{ {k: f'{v:.1e}' for k, v in rel.items()} } (limit {STEP_GRAD_TOL:g}); "
          f"metrics rel {({k: f'{v:.1e}' for k, v in metric_rel.items()})} (limit "
          f"{STEP_METRIC_RTOL:g}); telemetry card/CPU {exact}")
    require(all(v <= STEP_GRAD_TOL for v in rel.values()), "card and CPU gradients differ")
    require(all(v <= STEP_METRIC_RTOL for v in metric_rel.values()), "card and CPU losses differ")
    require(all(a == b for a, b in exact.values()), "card and CPU telemetry differ")


def train_phase(rng, dev) -> dict:
    """The training slice at full width: TRAIN_STEPS plain steps on the
    perturbed cloud, cycling the train cameras; then its profile."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.config import TrainConfig
    from sdpgs_torch.core.gaussians import Gaussians
    from sdpgs_torch.train.state import TrainState
    from sdpgs_torch.train.step import make_train_step

    trainee, data = train_scene(rng, dev, WIDTH, HEIGHT, CAPACITY, ALIVE)
    state = TrainState.create(Gaussians.from_numpy(trainee, device=dev), device=dev)
    step = make_train_step(TrainConfig(), SH_DEGREE)
    batches = [view_batch(data, v, dev) for v in range(TRAIN_CAMS)]
    protos, bg = data["protos"], torch.zeros(3, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    l1s, times, telemetry = [], [], set()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batches[i % TRAIN_CAMS], protos, bg, 1.0, device=dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        l1s.append(float(m.l1))
        telemetry.add((int(m.overflow), int(m.clipped), int(m.num_alive)))
    launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    first = statistics.mean(l1s[:TRAIN_CAMS])
    last = statistics.mean(l1s[-TRAIN_CAMS:])
    step_ms = statistics.median(times[TRAIN_WARMUP:])
    print(f"train: {TRAIN_STEPS} steps at {WIDTH}x{HEIGHT}, {ALIVE} alive of {CAPACITY}, "
          f"SH {SH_DEGREE}, V 1; launches {launches}; plain calls {plain}")
    print(f"  L1 first cycle {first:.5f} -> last cycle {last:.5f} (ratio {last / first:.3f}, "
          f"limit {L1_MARGIN}); final loss {float(m.loss):.5f}, PSNR {float(m.psnr):.2f} dB; "
          f"(overflow, clipped, alive) seen {sorted(telemetry)}")
    print(f"  train step: {step_ms:.3f} ms (median of {len(times) - TRAIN_WARMUP} after "
          f"{TRAIN_WARMUP} warm-up; min {min(times[TRAIN_WARMUP:]):.3f}, max "
          f"{max(times[TRAIN_WARMUP:]):.3f}), {1e3 / step_ms:.1f} steps/s; peak device "
          f"memory {peak / 2**20:.1f} MiB")
    require(all(launches[k] == TRAIN_STEPS for k in _kernels.KERNELS),
            "a kernel was not launched once per train step")
    require(not any(plain.values()), "a plain version ran on the train path")
    require(all(bool(torch.isfinite(p).all()) for p in state.gaussians.parameters()),
            "non-finite parameters after training")
    require(last < L1_MARGIN * first, f"L1 did not fall below {L1_MARGIN} x its start")
    prof = profile_calls(lambda b: step(state, b, protos, bg, 1.0, device=dev), batches, "step")
    return dict(launches=launches, step_ms=step_ms, peak=peak, **prof)


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
    check_poisoned_conic(main_check["k3_args"], cfg)
    check_clamped_alpha(main_check["k3_args"], cfg)
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
    require(all(launches[k] == VIEWS for k in _kernels.FORWARD_KERNELS),
            "a forward kernel was not launched once per view")
    require(not any(launches[k] for k in _kernels.BACKWARD_KERNELS),
            "a backward kernel ran on the render path")
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
    profile_calls(lambda cam: render(cam, g, cfg, bg, SH_DEGREE, device=dev), cams, "view")

    # -- 8. training: card vs CPU, then the full-width train steps --------
    check_step_card_vs_cpu(rng, dev)
    train = train_phase(rng, dev)

    # -- 9. kernel timings and bounds ---------------------------------------
    k1_args, k2_args, k3_args = (main_check[k] for k in ("k1_args", "k2_args", "k3_args"))
    k4_args, k5_args = main_check["k4_args"], main_check["k5_args"]
    T, K, pairs, contrib = (main_check[k] for k in ("T", "K", "pairs", "contrib"))
    with torch.no_grad():
        k1_ms = cuda_ms(lambda: preprocess_cuda.preprocess_rows(*k1_args))
        k1_plain = cuda_ms(lambda: preprocess_cuda.preprocess_rows_plain(*k1_args))
        k2_ms = cuda_ms(lambda: binning.build_table(*k2_args))
        k2_plain = cuda_ms(lambda: binning.build_table_plain(*k2_args))
        k3_ms = cuda_ms(lambda: composite_cuda.composite_gather(*k3_args))
        k3_plain = cuda_ms(lambda: composite_cuda.composite_gather_plain(*k3_args))
        k4_ms = cuda_ms(lambda: preprocess_cuda.preprocess_rows_bwd(*k4_args))
        k4_plain = cuda_ms(lambda: preprocess_cuda.preprocess_vjp_plain(*k4_args))
        k5_ms = cuda_ms(lambda: composite_cuda.composite_gather_bwd(*k5_args))
        k5_plain = cuda_ms(lambda: composite_cuda.composite_vjp_plain(
            *main_check["k5_plain_args"], tiles_per_pass=PLAIN_TILES_PER_PASS), reps=3)
    nsh = 3 * (SH_DEGREE + 1) ** 2
    npix = cfg.tile ** 2
    payload_bytes = main_check["payload_numel"] * 4
    k1_bytes = (preprocess_cuda.NGEO + nsh + preprocess_cuda.NOUT) * 4 * CAPACITY
    k2_bytes = (2 * CAPACITY + 1 + T * K + T) * 4
    k3_bytes = payload_bytes + (T * K + T + T * npix * (composite_cuda.NCH + 1)) * 4
    k4_bytes = (K4_BYTES_ROWS + 2 * nsh) * 4 * CAPACITY
    k5_bytes = 2 * payload_bytes + (T * K + T * npix * (composite_cuda.NCH + 3)) * 4

    def bound(nbytes, ops=0):
        return max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), (ops / F32_FLOPS * 1e3, "operations"))

    bounds = {
        "k1": bound(k1_bytes), "k2": bound(k2_bytes),
        "k3": bound(k3_bytes, pairs * ALPHA_OPS + contrib * BLEND_OPS),
        "k4": bound(k4_bytes),
        "k5": bound(k5_bytes, main_check["walked"] * ALPHA_OPS + contrib * GRAD_OPS),
    }
    rows = [
        ("preprocess_sh_fwd", "preprocess.cu", "preprocess_pallas.py:227", "preprocess",
         launches, "k1", main_check["k1_err"], k1_ms, k1_plain),
        ("bin_table", "binning.cu", "rank_pallas.py:851", "binning", launches, "k2",
         main_check["k2_err"], k2_ms, k2_plain),
        ("composite_fwd", "composite.cu", "composite_pallas.py:283", "composite", launches,
         "k3", main_check["k3_err"], k3_ms, k3_plain),
        ("preprocess_sh_bwd", "preprocess_bwd.cu", "preprocess_pallas.py:236", "preprocess_bwd",
         train["launches"], "k4", main_check["k4_err"], k4_ms, k4_plain),
        ("composite_bwd", "composite_bwd.cu", "composite_pallas.py:318", "composite_bwd",
         train["launches"], "k5", main_check["k5_err"], k5_ms, k5_plain),
    ]
    records = [
        dict(name=name, route="cuda", source=f"sdpgs_torch/csrc/{src}",
             replaces=f"sdpgs_tpu/ops/rasterize/{rep}",
             launches=counts[kern], max_abs_err=err, ms=ms, plain_ms=plain_ms,
             bound_ms=bounds[b][0], bound_by=bounds[b][1], library_ms=None)
        for name, src, rep, kern, counts, b, err, ms, plain_ms in rows
    ]
    for r, (_, _, _, _, counts, _, _, _, _) in zip(records, rows):
        per = "view" if counts is launches else "train step"
        n_runs = VIEWS if counts is launches else TRAIN_STEPS
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms), bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, "
              f"{r['launches'] / n_runs:g} launch per {per}")

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
