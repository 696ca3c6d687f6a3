#!/usr/bin/env python3
"""Drive the sdpgs_torch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's eight kernels from ``sdpgs_torch/csrc/`` with nvcc and
drives its five paths at the LLFF protocol's size (504x378, capacity
131,072, 60,000 alive, SH degree 3), and the two kernels' own entry
points, clouds, images and weights made from a seed:

- the depth sort's own path (K7, ``ops/sort.sort_by_key``, the
  counterpart of scripts/perf_sort.py): N = 2^17 and 2^16 with 40% +inf
  keys, then N = 2^14 and 2^19 across the f32 line (negatives, +-inf,
  +-FLT_MAX, the smallest normals, subnormals, signed zeros and ties among
  each), each bit-identical to torch.sort(stable=True) with its gathers
  and to the plain version;
- the launch-floor probe's own path (K8, ``ops/launch_floor``, row C of
  scripts/perf_rank_variants.py) on K2's sorted rects at P = 131,072,
  D = 8, equal to its plain version;

- serving: a trained-like cloud is written as a PLY and loaded back on the
  card; each kernel (K1-K3 forward, K4-K5 backward) is held against its
  plain PyTorch version on the same inputs at the main and a tight config,
  K5 also on poisoned conics and where alpha clamps at 0.99 (and K5
  launched 5 times with and 5 without its counts on each of the main,
  tight and clamp inputs and at a tile offset of 48, every result bit-equal
  to the first: its sums run in a fixed order); in each of
  those K3's n_visit and last_contrib equal a plain sequential walk over
  every entry and K3's and K5's counts of contributing pairs a plain
  count, so their shared entry cull skipped nothing; K2 and K3 again at
  tiles 8, 20 and 24, and K2 at n_valid 0, 1 and 3,999, every rect covering
  every tile, D 1 and the Trainer ladder's K 2048, D 32; 8 views render
  through ``render_set``, which must launch K1-K3 once per view and
  nothing else;
- training: one train step on the card against the same step on the CPU
  at a reduced size, then 30 plain train steps (``make_train_step``) on a
  perturbed copy of a ground-truth cloud, which must lower L1 and launch
  each of K1-K5 once per step and no plain version;
- pseudo-view training: K6 (the reprojection z-buffer) bit-identical to its
  plain version on 64 pseudo cameras x 3 train views (the cluster path),
  the in-step 3 pairs, edge pairs, pairs at 377x503, 1008x756 and
  4032x3024 (the general path), a pair whose rows all land in one block's
  band and one whose rows collapse onto 15 pixels; K6's other designs
  (cluster sizes, the general path over all pairs and by chunks) timed as
  probes at the prefetch's pair count at 504x378 and at 1008x756, each
  bit-identical too;
  the DPT-Hybrid depth net (random weights, seed 0) on the card against
  the CPU, and in bf16 against f32; one pseudo step on the card against
  the CPU at a reduced size; a plain and a pseudo step each taken twice
  from one state at iteration 4500, every tensor of the two resulting
  states and the metrics bit-equal; then, from iteration 4500, 30 pseudo steps
  (``make_train_step(with_pseudo=True)``) with the depth net in the loss,
  whose pseudo cameras come from one K6 prefetch of 64: K1-K5 must launch
  twice per step, K6 once, and no plain version; the loss must fall below
  0.96x its start, and L1 below 0.9x in the same steps without the depth
  net;
- the Trainer: one densify event with proximity on the card against the
  CPU at a reduced size (and the k-NN), then ``train/loop.Trainer`` for
  600 iterations on a ``SyntheticScene`` at full width (3 train views, 1
  test view, 16 segments, 128 pseudo poses, 60,000 ground-truth points)
  with the DPT-Hybrid in bf16: densify at 100-400 (proximity at 100), 99
  pseudo iterations from two K6 prefetches, the opacity reset at 301,
  SH degree 1 from 500, eval and a checkpoint at 600. K1-K5 must launch
  once per plain iteration and twice per pseudo one (K1-K3 also once per
  eval view), K6 twice, nothing else; an event must spawn and the prune
  after the reset remove some; PSNR must rise from 100 to 300; the report
  files must exist and the checkpoint restore to equal arrays. A Trainer
  with tight K and D must double both at its next log point;
- the train CLI from disk: an LLFF tree in fern's layout is written (a
  COLMAP model of 20 views of a 4032x3024 PINHOLE camera, images_8/ at
  504x378 rendered from a hidden cloud, poses_bounds.npy, 16-segment
  language features, aligned depths, and 3_views/dense/fused.ply of 60,000
  points); its ``Scene`` on the card must equal the CPU's (host arrays
  identical, Gaussians within 1e-6 of each field's max: the k-NN init on
  each) with 3 train and 3 test views and 60,000 of 131,072 slots alive;
  then ``python -m sdpgs_torch.cli.train_cli``'s ``main`` trains it for
  300 iterations (the DPT-Hybrid from an .npz; densify at 100 with the
  k-NN and 200 without; a pseudo window of 60 iterations from one K6
  prefetch; eval at 100 and 300, a save and a checkpoint at 300): K1-K5
  must launch once per plain iteration and twice per pseudo one (K1-K3
  also once per eval view), K6 once, nothing else; the train L1 must fall
  from 100 to 300 and the model directory hold its files; a second ``main``
  resumes from the checkpoint for iterations 301-310;
- evaluate and prepare, on that tree and model directory:
  ``python -m sdpgs_torch.cli.render_cli -m <model> --spiral``'s ``main``
  renders the 3 train, 3 test and 180 spiral views (K1-K3 once per view and
  nothing else; two test views at least 50 dB against ``render_set`` on the
  CPU; no spiral frame black); ``metrics_cli.main`` scores them with a
  random full-width LPIPS-VGG16 .npz (LPIPS on two 504x378 pairs within
  1e-4 of the CPU's, PSNR 1e-5 relative, SSIM 1e-5 absolute); the depth
  prior's ``conclude_depth_for_scene`` fits the known per-segment lines of
  the train views to 1e-3 through the native I/O library (built with g++
  from native/sdpgs_io.cc, equal to its Python versions); ``fuse_depths``
  on the card equals the CPU's (masks but at threshold pixels, points to
  1e-4) and round-trips a fused PLY; the SIBR viewer serves 10 frames over
  loopback, each equal to ``render``'s bytes; a ``utils/profiling.trace``
  names K1-K3's kernels;
- multi-card training (``parallel/``): K2, K3 and K5 with a tile offset on
  the main scene for 1, 2, 3, 4 and 7 tile shards (K2's rows, counts and
  overflow bit-identical to the whole table's and to its plain version at
  the same offset, rows past the grid empty; K3's rows bit-identical to the
  whole render's, its walk gate on every shard; K5's shard sum within
  1e-3 of the column max of the whole K5), with K2's, K3's and K5's times
  at an offset above 0; then 4 spawned ranks over gloo, all on this one
  card (time-sliced: no scaling number), take 3 sharded plain steps at
  504x378, V = 2, on a (2, 1, 2) and a (1, 2, 2) mesh and one sharded
  pseudo step (K6 and a tiny DPT replicated) from the single-card run's
  state: metrics per step, parameters, moments and statistics at the CPU
  tests' tolerances, every rank's state identical and K1-K5 launched on
  every rank; then ``certify_sharded_training(4)`` with JAX's checks
  (every event, the restore exact, the resumed run bit for bit, every
  ladder rung equal, the trajectory within 5e-2 and the alive count within
  JAX's tolerance of the single card, every rank's single-card leg the
  same), and the same on 4 gloo ranks on the machine's CPU; then
  ``parallel/certify_bench_shape`` on 4 gloo ranks sharing the card at the
  bench shape (131,072 slots, 60,000 alive, 504x378, K 1,024, two views) on
  a (2, 2, 1) and a (1, 2, 2) mesh: 3 sharded steps against one card's
  (loss and PSNR 1e-3, telemetry exact, the gauss split after every step)
  and a densify event with the k-NN (the split after the surgery, alive
  within JAX's tolerance); NCCL with a card per rank runs the first
  part where the machine has two cards or more;
- the protocol harnesses, after the evaluate phase: ``cli/full_eval`` on
  the train CLI phase's tree as its one LLFF scene (30 iterations, then
  the render and metrics CLIs); ``cli/ablation_run``'s ``full`` and
  ``nomono`` arms at the protocol shape (504x378, capacity 131,072,
  61,440 ground-truth points, 4,096 pseudo poses, 4 test views) to
  iteration 2,050: bit-identical logs and evals through 2,000, the pseudo
  branch live after it in both, no NaN, every kind of densify event;
  ``cli/convergence_run`` (1,500 iterations of the train CLI on the
  acceptance rig's scene) passing its three checks.

It then times each kernel, its plain version, a render, a train step, a
pseudo step (and the prefetch's K6, fusion and rest) and the Trainer's
iterations and events, and profiles them; K1 and K4 are timed with the
camera vector on the host.
Each phase prints its wall time. Every phase raises on failure, so the
script exits non-zero and prints no ``ok`` line; it refuses to run without
a CUDA device. The card's name and power limit are printed first; the
last two lines are the ``kernels`` JSON record and the ``ok`` JSON line.
"""

from __future__ import annotations

import contextlib
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

from sdpgs_torch.models.dpt import DPTArch

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
K5_REPEATS = 5                # K5's determinism gate: launches of each instance
SLEEP_CYCLES = 2_000_000      # ~1 ms of device time at H100 clocks
RENDER_PASSES = 5             # render timing: median over passes x views
K4_TOL = 1e-4                 # K4 vs autograd: |diff| <= 1e-4 x the field's max
K5_TOL = 1e-3                 # K5 vs autograd: the sum order and T recovered by
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
WARP_OPS = 28                 # K6 per source row: 3 rows of 3 mul + 3 add, 2 div, 2 rint,
                              # 6 compares
PSEUDO_START = 4500           # the pseudo phases start here: every pseudo term live
PSEUDO_STEPS = 30             # full-width pseudo steps, cycling the train cameras
BASELINE_FAR = 1.5            # edge pair: |du| ~ fx b / z > 128, outside the TPU window
# K6 at other widths x heights, and the path zbuf_plan must give each
K6_SIZES = (((377, 503), "cluster"), ((1008, 756), "cluster"), ((4032, 3024), "general"))
K6_CHUNK = 33                 # K6 probe: pairs a chunk (25 MB of z-buffers, inside L2)
K6_PROBE_CLUSTERS = (4, 7, 8, 16)   # K6 probe: blocks a cluster (1, 2, 2 and 4 an SM at LLFF)
K6_CHUNK_2X = 9               # K6 probe at 1008x756: pairs a chunk (27 MB, inside L2)
K6_PROBE_CLUSTERS_2X = (8, 16)  # K6 probe at 1008x756 (8 does not fit a block: printed)
DPT_FWD_TOL = 1e-3            # depth net, card vs CPU in f32: of the output's range
# Its input gradient at a random cotangent is ill-conditioned in f32: the
# card's, the CPU's (with or without oneDNN) each differ from a float64 run
# by 1.0-1.2% in the norm, while their outputs agree to 6e-6 of the range.
# So the card's gradient is held to the float64 run on the CPU, no further
# from it than the CPU's own f32 gradient, with this margin.
DPT_GRAD_MARGIN = 1.5
DPT_BF16_CORR = 0.98          # bf16 against f32 on the card: the Pearson of the two maps
                              # (the loss reads the net through a Pearson; 0.9917 in the
                              # first run, 10% of the range apart in the norm)
PSEUDO_GRAD_TOL = 2e-2        # pseudo step card vs CPU, |g_card - g_cpu| / |g_cpu| per
                              # field: the steps inherit the depth net's f32 input
                              # gradient, 1.0-1.2% off float64 in the norm on each
                              # device and 1.36% apart (above); read 1.3-1.6%
# bf16's input gradient through the full DPT-Hybrid on random weights is
# noise (the f32 one is ~1% off float64; bf16's unit roundoff is 2^16
# times f32's), so bf16's backward is held on DPTArch.tiny_hybrid, where
# bf16 is ~21% off f32 on the CPU: the card's bf16 input gradient no
# further from its f32 one than this margin times the CPU's.
DPT_BF16_GRAD_MARGIN = 1.25
PSEUDO_LOSS_MARGIN = 0.96     # 30 pseudo steps: mean loss of the last cycle < 0.96 x the
                              # first's (read 1.06301 -> 0.99164, 0.933)
DPT_ARCH = DPTArch.hybrid()   # the reference's depth net
SORT_SIZES = (1 << 17, 1 << 16)        # K7's path: scripts/perf_sort.py's shapes
SORT_EDGE_SIZES = (1 << 14, 1 << 19)   # the domain's ends, keys across the f32 line
_F32 = np.finfo(np.float32)
SORT_SPECIALS = (0.0, -0.0, np.inf, -np.inf, 2.5, -2.5, _F32.max, -_F32.max, _F32.tiny,
                 -_F32.tiny, 1e-40, -1e-40)  # as tests/test_torch_sort.py, with subnormals
SORT_DEAD = 0.4                        # share of +inf keys (dead slots)
SORT_BYTES = 24                        # K7 per element: key, payload, gid read and written
# the redesigned kernels' names in the profiler's kernel list (K2 is two launches)
PROFILED = {"K2": ("cover_words_kernel", "bin_table_kernel"), "K3": ("composite_fwd_kernel",),
            "K5": ("composite_bwd_kernel",)}
PROBE_D = 8                            # K8: tile slots per rect
EDGE_TILES = (8, 24, 20)               # K2/K3 at tiles the main and tight configs miss
                                       # (20: 8 does not divide it, K3's row-major blocks)
LADDER_K, LADDER_D = 2048, 32          # the Trainer cell's K and D after its ladder
PROBE_BYTES = 4 + 4 + 32 + 4           # K8 per slot: packed, gid, tid's row sector, out
KNN_TOL = 1e-5                # k-NN card vs CPU: |diff| over |q|^2 + |p|^2, the terms
                              # the formula cancels
DENSIFY_TOL = 1e-6            # densify card vs CPU: every field within this of its max
# The Trainer phase: TrainConfig() with a compressed schedule, on a
# SyntheticScene at LLFF width. Points spread as the render cell's cloud,
# scales 0.014 (init_scale 2e-4): above percent_dense x extent, so the
# first events split.
TRAINER_OPTIM = dict(iterations=600, densify_from_iter=50, densification_interval=100,
                     densify_until_iter=500, proximity_until_iter=150, start_sample_pseudo=300,
                     end_sample_pseudo=400, test_iterations=(600,), checkpoint_iterations=(600,))
TRAINER_SCENE = dict(n_points=ALIVE, capacity=CAPACITY, width=WIDTH, height=HEIGHT, n_train=3,
                     n_test=1, n_segments=PROTOTYPES, n_pseudo=128, point_spread=1.0,
                     depth_center=4.0, init_scale=2e-4)
TRAINER_LOG_EVERY = 100
BARE_STEPS = 20               # bare step timing: median after TRAIN_WARMUP
# The train CLI phase: an LLFF tree on disk in fern's layout (20 views of a
# 4032x3024 camera, read at /8 through images_8), its MVS cloud the 60,000
# points of the other cells, and TrainConfig() with the schedule compressed
# on the per-field flags: densify at 100 (with the k-NN) and 200 (without),
# a pseudo window of 60 iterations (one K6 prefetch) whose opacity reset
# comes before the first log point, eval at 100 and 300.
LLFF_FULL = (4032, 3024)
LLFF_DIVIDER = 8
LLFF_VIEWS = 20
LLFF_SPARSE = 2_000           # COLMAP's sparse points (the fused cloud is the init)
LLFF_BOUNDS = (1.0, 10.0)     # poses_bounds.npy near and far
LLFF_SEED = 8
CLI_ITERATIONS = 300
CLI_LOG_EVERY = 100           # the Trainer's default log cadence; the first eval
CLI_RESUME = 10
CLI_OPTIM = dict(densify_from_iter=50, densification_interval=100, densify_until_iter=250,
                 proximity_until_iter=150, start_sample_pseudo=30, end_sample_pseudo=91)
SCENE_TOL = 1e-6              # Scene card vs CPU: Gaussians within this of each field's max
# The evaluate-and-prepare phase, on the train CLI's tree and model directory.
LPIPS_RTOL = 1e-4             # LPIPS-VGG16 card vs CPU, relative, per 504x378 pair
METRIC_TOL = 1e-5             # PSNR card vs CPU relative, SSIM absolute
LINE_TOL = 1e-3               # conclude's per-segment lines against the known (a, b)
POINT_TOL = 1e-4              # fused points card vs CPU, over the largest coordinate
VIEWER_FRAMES = 10            # SIBR requests served over loopback
SHARDS = (1, 2, 3, 4, 7)      # tile shards of the one-process tile-range gates
PAR_RANKS = 4                 # ranks of the sharded-training phase
PAR_AXES = ((2, 1, 2), (1, 2, 2))   # (data, gauss, tile) meshes it steps on
PAR_V = 2                     # views per sharded step
PAR_STEPS = 3                 # sharded steps held against the single-card steps
PAR_TIMED = 5                 # further steps timed (not compared)
PAR_WARMUP = 3                # single-card steps before: non-zero Adam moments
PAR_DPT = DPTArch.tiny_hybrid()     # the depth net of the sharded pseudo step
PAR_LOSS_RTOL = 1e-5          # sharded vs single-card step: loss and L1 relative
PAR_PSNR_RTOL = 1e-4          # ... PSNR relative
PAR_PARAM_RTOL, PAR_PARAM_ATOL = 1e-4, 1e-6   # ... xyz and opacity
PAR_FIELD_TOL = 1e-4          # ... moments and statistics, of each field's max
PAR_GROUP_TIMEOUT = 300       # seconds a collective may wait before it raises
BENCH_SHAPE_MESHES = ((2, 2, 1), (1, 2, 2))   # the bench-shape certification's meshes
PROTOCOL_ARMS = ("full", "nomono")  # ablation_run's arms the protocol phase runs
PROTOCOL_ITERATIONS = 2050    # past the pseudo window's start at 2,000
PROTOCOL_LOG_EVERY = 50
FULL_EVAL_ITERATIONS = 30
BENCH_SHAPE_STEPS = 3         # its sharded steps per mesh (scripts/certify_bench_shape.py)


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
    for kern, names in PROFILED.items():
        us = sum(us for name, (us, _) in by_kernel.items() if any(n in name for n in names))
        if us:
            print(f"  {kern} ({', '.join(names)}) {us / v:.1f} us per {unit}, "
                  f"{100.0 * us / busy_us:.1f}% of device busy")
    return dict(wall_us=wall_us / v, busy_us=busy_us / v)


def check_kernels(g, cam, cfg, label: str) -> dict:
    """Phases 4-6: each kernel against its plain version on the card, on
    the same inputs (K1 -> K2 on K1's output -> K3 on K2's table). Returns
    the inputs and errors the timing phase needs."""
    from sdpgs_torch.ops.rasterize import binning, preprocess_cuda
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
        prep, color = preprocess_cuda.split_rows(out_k)
        k2_args = (*binning.sort_rects(prep, WIDTH, HEIGHT, cfg), T, tiles_x, K, D)
        k2 = k2_versus_plain(k2_args, label)
        bins = binning.bin_gaussians(prep, WIDTH, HEIGHT, cfg)
        print(f"  K2 through bin_gaussians: entries {int(bins.num_entries)}, overflow "
              f"{int(bins.overflow)}, clipped {int(bins.clipped)}")
        require(int(bins.overflow) == k2["overflow"] and int(bins.clipped) == k2["clipped"]
                and torch.equal(bins.tile_index.reshape(-1), k2["table"])
                and torch.equal(bins.tile_counts, torch.clamp_max(k2["totals"], K)),
                f"[{label}] K2 disagrees through bin_gaussians")

        # -- 6. K3 vs plain on the same table and payload -----------------
        payload = make_payload(prep, g.get_opacity()[:, 0], color,
                               g.language_feature_normalized())
        k3_args = (payload, bins.tile_index, bins.tile_counts, tiles_x, tiles_y, cfg,
                   g.capacity)
        k3_err, pairs = k3_versus_plain(k3_args, bins.rects, label)
        # what K3 and K5 must read: the table's entries below each tile's
        # count and the payload rows those reference
        listed = bins.tile_index[torch.arange(K, device=payload.device)[None, :]
                                 < bins.tile_counts[:, None]]
        entries, rows_read = listed.numel(), torch.unique(listed).numel()

    bwd = check_backward_kernels(g, label, k1_args, k3_args, bins.rects)
    return dict(k1_args=k1_args, k2_args=k2_args, k3_args=k3_args, k1_err=k1_err,
                k2_err=k2["err"], k3_err=k3_err, pairs=pairs, payload_numel=payload.numel(),
                row_bytes=payload.shape[1] * 4, entries=entries, rows_read=rows_read,
                n_valid=int(k2_args[2]), T=T, K=K, overflow=k2["overflow"], rects=bins.rects,
                clipped=k2["clipped"], **bwd)


def main_prep(main_check: dict):
    """The main scene's Preprocessed, from K1 on the main check's inputs."""
    from sdpgs_torch.ops.rasterize import preprocess_cuda

    return preprocess_cuda.split_rows(preprocess_cuda.preprocess_rows(*main_check["k1_args"]))[0]


def k2_versus_plain(k2_args, label: str) -> dict:
    """K2 and its plain version on the same sorted rects: table and uncapped
    totals bit-identical, and so the K overflow; the D clipping from the
    same rects."""
    from sdpgs_torch.ops.rasterize import binning

    packed_s, order, n_valid, T, tiles_x, K, D = k2_args
    table_k, totals_k = binning.build_table(*k2_args)
    table_p, totals_p = binning.build_table_plain(*k2_args)
    torch.cuda.synchronize()
    table_same = bool(torch.equal(table_k, table_p))
    totals_same = bool(torch.equal(totals_k, totals_p))
    err = max(int((table_k - table_p).abs().max()), int((totals_k - totals_p).abs().max()))
    overflow_k, overflow_p = (int(torch.clamp_min(t - K, 0).sum()) for t in (totals_k, totals_p))
    xmin, xmax, ymin, ymax = binning.unpack_rect(packed_s)
    clipped = int(torch.clamp_min((xmax - xmin) * (ymax - ymin) - D, 0).sum())
    P = packed_s.shape[0]
    holes = int(((table_p == P).reshape(T, K)
                 & (torch.arange(K, device=table_p.device)[None, :]
                    < torch.clamp_max(totals_p, K)[:, None])).sum())
    print(f"  K2 binning [{label}]: P {P}, n_valid {int(n_valid)}, {T} tiles, K {K}, D {D}: "
          f"table identical {table_same}, totals identical {totals_same}, overflow "
          f"{overflow_k} (plain {overflow_p}), clipped {clipped}, sentinel holes {holes}, "
          f"max tile count {int(totals_p.max()) if T else 0}")
    require(table_same and totals_same and overflow_k == overflow_p, f"[{label}] K2 disagrees")
    return dict(table=table_p, totals=totals_p, err=err, overflow=overflow_p, clipped=clipped,
                holes=holes)


def k3_versus_plain(k3_args, rects, label: str) -> tuple:
    """K3 against its plain version on the same table and payload (binned
    from ``rects``): colour and alpha within 1e-4, depth and feature within
    1e-3 relative, all but 0.1% of pixels. Returns (max |diff|
    colour/alpha, pairs visited)."""
    from sdpgs_torch.ops.rasterize import composite_cuda

    o_k = composite_cuda.composite_gather(*k3_args, rects=rects)
    o_p = composite_cuda.composite_gather_plain(*k3_args)
    torch.cuda.synchronize()
    d_rgb = (o_k.values[..., :3] - o_p.values[..., :3]).abs().amax(-1)
    d_alpha = (o_k.final_t - o_p.final_t).abs()
    # depth/feature: relative to max(|plain|, 1), as features cross zero
    rel = ((o_k.values[..., 3:] - o_p.values[..., 3:]).abs()
           / o_p.values[..., 3:].abs().clamp_min(1.0)).amax(-1)
    bad = (d_rgb > 1e-4) | (d_alpha > 1e-4) | (rel > 1e-3)
    n_bad, npix_all = int(bad.sum()), bad.numel()
    err = float(torch.maximum(d_rgb, d_alpha).max())
    pairs = int(o_k.n_visit.sum())
    print(f"  K3 composite [{label}]: pixels outside tolerance {n_bad} of {npix_all} "
          f"(limit 0.1%), max |diff| color/alpha {err:.3e}, depth/feature "
          f"rel {float(rel.max()):.3e}, (entry, pixel) pairs visited {pairs}")
    require(n_bad <= npix_all // 1000, f"[{label}] K3 disagrees")
    return err, pairs


def entry_power_plain(mx, my, a, b, c, px, py):
    """composite.py:76-83's power with composite_math.cuh:entry_alpha's
    rounding (each fma's product exact in float64, one rounding to f32)."""
    f32, f64 = torch.float32, torch.float64
    dx, dy = mx - px, my - py
    q = ((a * dx).to(f64) * dx.to(f64) + ((c * dy) * dy).to(f64)).to(f32)
    return -0.5 * q - (b * dx) * dy          # -0.5 q is exact: one rounding, as the fma


def composite_walk_plain(k3_args, t0: int = 0):
    """K3's walk in plain PyTorch, one entry at a time over the [T, tile^2]
    pixels in f32: the power rounded as entry_alpha rounds it, alpha =
    min(alpha_max, op e^power), an entry skipped where power > 0 or alpha <
    alpha_min, T = T (1 - alpha) entry by entry, and the stop at the entry
    that would take T below t_min (not added). Returns (n_visit,
    last_contrib) [T, tile^2] int32, the entries up to the stop (or the
    tile's count) and one past the last entry added, and the number of
    (entry, pixel) pairs added: the contributing pairs, since every pair
    that passes before the stop is added. The table's rows are the tiles
    from flat tile ``t0``."""
    from sdpgs_torch.ops.rasterize.composite import tile_pixel_coords_range

    payload, table, counts, tiles_x, tiles_y, cfg, P = k3_args
    dev = payload.device
    alpha_min, alpha_max, t_min = (torch.tensor(v, dtype=torch.float32, device=dev) for v in
                                   (cfg.alpha_min, cfg.alpha_max, cfg.transmittance_min))
    px, py = tile_pixel_coords_range(t0, table.shape[0], tiles_x, cfg.tile, device=dev)
    gid = torch.where((table >= 0) & (table <= P), table, P).long()
    trans = torch.ones_like(px)
    done = torch.zeros(px.shape, dtype=torch.bool, device=dev)
    visited = counts[:, None].expand(px.shape).clone()
    last = torch.zeros_like(visited)
    added = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(int(counts.max()) if counts.numel() else 0):
        live = (k < counts)[:, None] & ~done
        if k % 64 == 0 and not bool(live.any()):
            break
        mx, my, a, b, c, op = (v[:, None] for v in payload[gid[:, k], :6].unbind(-1))
        power = entry_power_plain(mx, my, a, b, c, px, py)
        alpha = torch.clamp_max(op * torch.exp(power), alpha_max)
        passes = live & ~(power > 0.0) & ~(alpha < alpha_min)
        test = trans * (1.0 - alpha)
        stop = passes & (test < t_min)
        add = passes & ~stop
        visited = torch.where(stop, k + 1, visited)
        done |= stop
        trans = torch.where(add, test, trans)
        last = torch.where(add, k + 1, last)
        added += add.sum()
    return visited, last, int(added)


def check_k3_walk(k3_args, out, last, label: str, t0: int = 0) -> tuple:
    """K3's n_visit and last_contrib (``out``, ``last``: the timed instance's)
    against composite_walk_plain, which walks every entry: equal at every
    pixel, so K3's entry cull skipped no entry the walk stops at or adds.
    The instance with ``stats`` must give the same two outputs, and count
    as many contributing pairs as the walk adds. Returns (K3's tested,
    contributing pairs)."""
    from sdpgs_torch.ops.rasterize import composite_cuda

    stats = torch.zeros(2, dtype=torch.int64, device=out.n_visit.device)
    out_s, last_s = composite_cuda.composite_gather_fwd(*k3_args, stats=stats, t0=t0)
    visit_p, last_p, added = composite_walk_plain(k3_args, t0=t0)
    npix_all = last.numel()
    bad = int(((out.n_visit != visit_p) | (last != last_p)).sum())
    same_s = bool(torch.equal(out_s.n_visit, out.n_visit) and torch.equal(last_s, last))
    tested, contrib = (int(v) for v in stats.tolist())
    visited = int(out.n_visit.sum())
    print(f"  K3 walk [{label}]: pixels whose n_visit or last_contrib differ from the plain "
          f"sequential walk {bad} of {npix_all} (limit 0); stats instance equal {same_s}; "
          f"(entry, pixel) pairs visited {visited}, tested {tested} "
          f"({100.0 * tested / max(visited, 1):.1f}%), contributing {contrib} (the walk "
          f"adds {added})")
    require(bad == 0 and same_s, f"[{label}] K3's walk differs from the plain walk")
    require(contrib == added, f"[{label}] K3 counts {contrib} contributing pairs, the plain "
                              f"walk adds {added}")
    require(0 < contrib <= tested <= visited, f"[{label}] K3's pair counts are inconsistent")
    return tested, contrib


def check_tile_sizes(main_check: dict) -> None:
    """K2 and K3 at the tiles the main and tight configs do not reach (8
    and 24: one block per tile, 8x4 patches, T = 3,024 at tile 8; 20:
    row-major blocks), on the main scene's K1 output: K2 bit-identical to
    its plain version, K3 within the colour gate and its walk, and its
    count of contributing pairs, equal to the plain walk's."""
    from sdpgs_torch.config import RasterizeConfig
    from sdpgs_torch.ops.rasterize import binning, composite_cuda

    prep, payload = main_prep(main_check), main_check["k3_args"][0]
    with torch.no_grad():
        for tile in EDGE_TILES:
            cfg = RasterizeConfig(tile=tile)
            tiles_x, tiles_y = binning.tile_grid(WIDTH, HEIGHT, tile)
            T, K = tiles_x * tiles_y, cfg.max_per_tile
            label = f"tile {tile}"
            k2 = k2_versus_plain((*binning.sort_rects(prep, WIDTH, HEIGHT, cfg), T, tiles_x, K,
                                  cfg.max_tiles_per_gaussian), label)
            k3_args = (payload, k2["table"].reshape(T, K), torch.clamp_max(k2["totals"], K),
                       tiles_x, tiles_y, cfg, payload.shape[0] - 1)
            k3_versus_plain(k3_args, binning.packed_rects(prep, WIDTH, HEIGHT, cfg)[0], label)
            out, last = composite_cuda.composite_gather_fwd(*k3_args)
            check_k3_walk(k3_args, out, last, label)


def synthetic_rects(rng, P: int, n_valid: int, tiles_x: int, tiles_y: int, whole: bool, dev):
    """K2's inputs without a scene: P packed rects of 1-6 tiles a side (or
    the whole grid), empty past n_valid as sort_rects leaves the culled
    ones, a random order and the device scalar n_valid."""
    from sdpgs_torch.ops.rasterize.binning import pack_rect

    xmin = rng.integers(0, tiles_x, P)
    ymin = rng.integers(0, tiles_y, P)
    xmax = np.minimum(xmin + rng.integers(1, 7, P), tiles_x)
    ymax = np.minimum(ymin + rng.integers(1, 7, P), tiles_y)
    if whole:
        xmin, xmax, ymin, ymax = (np.full(P, v) for v in (0, tiles_x, 0, tiles_y))
    xmax[n_valid:], ymax[n_valid:] = xmin[n_valid:], ymin[n_valid:]
    rect = (torch.from_numpy(v.astype(np.int32)).to(dev) for v in (xmin, xmax, ymin, ymax))
    order = torch.from_numpy(rng.permutation(P).astype(np.int32)).to(dev)
    return pack_rect(*rect).contiguous(), order, torch.tensor(n_valid, dtype=torch.int32,
                                                              device=dev)


def check_binning_edges(dev, main_check: dict) -> None:
    """K2 bit-identical to its plain version where the main scene does not
    go: n_valid 0, 1 and not a multiple of 32 (P not one either), every
    rect covering every tile (every tile overflows K), D = 1, and on the
    main scene at the Trainer's ladder sizes, K 2,048 and D 32."""
    from sdpgs_torch.config import RasterizeConfig
    from sdpgs_torch.ops.rasterize import binning

    rng = np.random.default_rng(6)
    tiles_x, tiles_y = binning.tile_grid(WIDTH, HEIGHT, 16)
    T = tiles_x * tiles_y
    with torch.no_grad():
        # label: (P, n_valid, every tile, K, D)
        for label, (P, n, whole, K, D) in {
                "n_valid 0": (4096, 0, False, 256, 8),
                "n_valid 1": (4096, 1, False, 256, 8),
                "n_valid 3999, P 4000": (4000, 3999, False, 256, 8),
                "every rect covers every tile": (4096, 3000, True, 256, 8),
                "D 1": (4096, 4096, False, 256, 1)}.items():
            k2 = k2_versus_plain((*synthetic_rects(rng, P, n, tiles_x, tiles_y, whole, dev), T,
                                  tiles_x, K, D), label)
            if whole:
                require(bool((k2["totals"] == n).all()) and k2["overflow"] == T * (n - K),
                        "not every tile overflowed K")
            if D == 1:
                require(k2["clipped"] > 0 and k2["holes"] > 0, "D 1 clipped nothing")
        cfg = RasterizeConfig(max_per_tile=LADDER_K, max_tiles_per_gaussian=LADDER_D)
        tiles_x, tiles_y = binning.tile_grid(WIDTH, HEIGHT, cfg.tile)
        k2_versus_plain((*binning.sort_rects(main_prep(main_check), WIDTH, HEIGHT, cfg),
                         tiles_x * tiles_y, tiles_x, LADDER_K, LADDER_D),
                        f"ladder K {LADDER_K}, D {LADDER_D}")


def field_errors(got: torch.Tensor, ref: torch.Tensor, tol: float):
    """Per field (row of ``ref``): max |got - ref| over max |ref|, and the
    count of elements with |got - ref| > tol * max |ref|."""
    diff = (got - ref).abs()
    scale = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    rel = (diff / scale).amax(dim=1)
    bad = int((diff > tol * scale).sum())
    return rel, bad


def k5_versus_plain(args, rects, gen, label: str):
    """K3 forward, its walk against the plain walk, then K5 and its plain
    version at seeded random cotangents on the compositing inputs ``args``,
    and K5's pair counts (the instance with ``stats``), whose contributing
    pairs must equal those the plain walk adds (K3's). Returns (K5's
    and the plain payload gradient, K5's launch arguments, K5's
    contributing, clamped and tested pairs, K3's tested pairs)."""
    from sdpgs_torch.ops.rasterize import composite_cuda

    payload, table, counts, tiles_x, tiles_y, cfg, P = args
    dev = payload.device
    out, last = composite_cuda.composite_gather_fwd(*args)
    k3_tested, k3_contrib = check_k3_walk(args, out, last, label)
    g_values = torch.randn(tuple(out.values.shape), generator=gen, device=dev)
    g_final_t = torch.randn(tuple(out.final_t.shape), generator=gen, device=dev)
    k5_args = (payload, table, rects, out.final_t, last, g_values, g_final_t, tiles_x,
               tiles_y, cfg, P)
    d_k = composite_cuda.composite_gather_bwd(*k5_args)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    composite_cuda.composite_gather_bwd(*k5_args, stats=stats)
    d_p = composite_cuda.composite_vjp_plain(*args, g_values, g_final_t,
                                             tiles_per_pass=PLAIN_TILES_PER_PASS)
    pairs = [int(v) for v in stats.tolist()]
    require(pairs[0] == k3_contrib, f"K5 counts {pairs[0]} contributing pairs, the plain walk "
                                    f"{k3_contrib}: its cull skipped contributing pairs")
    return d_k, d_p, k5_args, pairs, k3_tested


def k5_errors(d_k: torch.Tensor, d_p: torch.Tensor):
    """K5's payload gradient against its plain version: max |diff| over the
    column max per column, the rows with any element beyond K5_TOL x its
    column max, the rows the plain version gives a gradient, max |diff|."""
    diff = (d_k - d_p).abs()
    scale = d_p.abs().amax(dim=0, keepdim=True).clamp_min(1e-30)
    rows_bad = int((diff > K5_TOL * scale).any(dim=1).sum())
    rows_live = int((d_p != 0).any(dim=1).sum())
    return (diff / scale).amax(dim=0), rows_bad, rows_live, float(diff.max())


def k5_repeats(k5_args, label: str, t0: int = 0) -> None:
    """K5's determinism gate: K5_REPEATS launches of each instance (with and
    without ``stats``) on the same inputs must all give the payload
    gradient of the first bit for bit."""
    from sdpgs_torch.ops.rasterize import composite_cuda

    dev = k5_args[0].device
    first = composite_cuda.composite_gather_bwd(*k5_args, t0=t0)
    same = {"without stats": 1, "with stats": 0}
    for i in range(2 * K5_REPEATS - 1):
        stats = torch.zeros(3, dtype=torch.int64, device=dev) if i % 2 == 0 else None
        d = composite_cuda.composite_gather_bwd(*k5_args, stats=stats, t0=t0)
        same["with stats" if stats is not None else "without stats"] += int(same_bits(d, first))
    print(f"  K5 determinism [{label}]: launches bit-equal to the first {same} of "
          f"{K5_REPEATS} each")
    require(all(v == K5_REPEATS for v in same.values()),
            f"[{label}] K5 is not bitwise deterministic")


def check_poisoned_conic(k3_args, rects, cfg) -> None:
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
        d_k, d_p, _, (contrib, _, _), _ = k5_versus_plain(
            (pay, table, counts, tiles_x, tiles_y, cfg, P), rects, gen, "poisoned conics")
    _, rows_bad, rows_live, err = k5_errors(d_k, d_p)
    finite = bool(torch.isfinite(d_k).all())
    hit_zero = not bool(d_k[hit].any())
    print(f"  K5 poisoned conics ({hit.numel()} rows at a = c = -500): finite {finite}, "
          f"poisoned rows all zero {hit_zero}, rows beyond {K5_TOL:g} x column max "
          f"{rows_bad} of {rows_live}, max |diff| {err:.3e}; contributing pairs {contrib} "
          f"(= the plain walk's)")
    require(finite and hit_zero and rows_bad == 0,
            "K5 on poisoned conics is not finite or disagrees")


def check_clamped_alpha(k3_args, rects, cfg) -> None:
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
    with torch.no_grad():
        d_k, d_p, k5_args, (contrib, clamped, _), _ = k5_versus_plain(
            (pay, table, counts, tiles_x, tiles_y, cfg, P), rects, gen, "clamped alpha")
    rel, rows_bad, rows_live, err = k5_errors(d_k, d_p)
    print(f"  K5 clamped alpha ({hit.numel()} rows at opacity 0.999): contributing pairs "
          f"{contrib}, clamped at {cfg.alpha_max:g} {clamped}; rows beyond {K5_TOL:g} x "
          f"column max {rows_bad} of {rows_live}, max |diff| / column max "
          f"{float(rel.max()):.1e}, max |diff| {err:.3e}; contributing pairs = the plain walk's")
    require(clamped > 0, "the clamp phase reached no clamped pair")
    k5_repeats(k5_args, "clamped alpha")
    require(bool(torch.isfinite(d_k).all()) and rows_bad == 0,
            "K5 disagrees where alpha is clamped")


def check_backward_kernels(g, label: str, k1_args, k3_args, rects) -> dict:
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
        d_k, d_p, k5_args, (contrib, clamped, tested), k3_tested = k5_versus_plain(
            k3_args, rects, gen, label)
        rel5, rows_bad, rows_live, k5_err = k5_errors(d_k, d_p)
        walked = int(k5_args[4].sum())   # up to each pixel's last contributor
        print(f"  K5 composite bwd: payload rows beyond {K5_TOL:g} x column max {rows_bad} of "
              f"{rows_live} with a gradient (limit 0), max |diff| / column max "
              f"{[f'{v:.1e}' for v in rel5.tolist()]}, max |diff| {k5_err:.3e}; "
              f"(entry, pixel) pairs up to each pixel's last contributor {walked}, tested "
              f"{tested}, contributing {contrib} (= the plain walk's; clamped {clamped})")
        require(bool(torch.isfinite(d_k).all()) and rows_bad == 0, f"[{label}] K5 disagrees")
        require(0 < contrib <= tested <= walked, f"[{label}] K5's pair counts are inconsistent")
        k5_repeats(k5_args, label)
    return dict(k4_args=(*k1_args[:3], ct, *k1_args[3:]), k4_err=k4_err,
                k5_args=k5_args, k5_plain_args=(*k3_args, *k5_args[5:7]),
                k5_err=k5_err, contrib=contrib, k3_tested=k3_tested)


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
    Ts = [np.array([0.1 * i - 0.1, 0.0, 0.0]) for i in range(TRAIN_CAMS)]
    cams = [Camera.create(R=np.eye(3), T=T, fovx=0.9, fovy=0.7, width=width, height=height,
                          device="cpu") for T in Ts]
    with torch.no_grad():
        outs = [render(c, g, RasterizeConfig(), torch.zeros(3, device=dev), SH_DEGREE,
                       device=dev) for c in cams]
    data = dict(
        cams=cams, Rs=[np.eye(3)] * TRAIN_CAMS, Ts=Ts,
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


def state_bits(state) -> dict:
    """Every tensor of a TrainState as numpy, flattened by name."""
    out = {}
    for part, v in state.to_numpy().items():
        for k, a in (v.items() if isinstance(v, dict) else [("", v)]):
            out[f"{part}.{k}" if k else part] = np.asarray(a)
    return out


def check_step_determinism(label: str, step, snap: dict, args: tuple, dev, **kw) -> None:
    """Two steps from one state (``snap``, a TrainState as numpy) must give
    bit-equal states and metrics."""
    from sdpgs_torch.train.state import TrainState

    runs = []
    for _ in range(2):
        s = TrainState.from_numpy(snap, device=dev)
        s, m = step(s, *args, device=dev, **kw)
        torch.cuda.synchronize()
        runs.append((state_bits(s), [float(getattr(m, k)) for k in ("loss", "l1", "psnr")]))
        del s
    (a, ma), (b, mb) = runs
    differ = [k for k in a if not np.array_equal(a[k], b[k], equal_nan=True)]
    print(f"  {label} step determinism: two steps from one state, {len(a)} state tensors, "
          f"differing {differ}; metrics {ma} and {mb}")
    require(not differ and ma == mb, f"two {label} steps from one state differ: {differ}")


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
    require(all(launches[k] == TRAIN_STEPS
                for k in _kernels.FORWARD_KERNELS + _kernels.BACKWARD_KERNELS),
            "a kernel was not launched once per train step")
    require(not any(launches[k] for k in _kernels.WARP_KERNELS + _kernels.SORT_KERNELS
                    + _kernels.PROBE_KERNELS),
            "K6, K7 or K8 ran on the plain train path")
    require(not any(plain.values()), "a plain version ran on the train path")
    require(all(bool(torch.isfinite(p).all()) for p in state.gaussians.parameters()),
            "non-finite parameters after training")
    require(last < L1_MARGIN * first, f"L1 did not fall below {L1_MARGIN} x its start")
    prof = profile_calls(lambda b: step(state, b, protos, bg, 1.0, device=dev), batches, "step")
    return dict(launches=launches, step_ms=step_ms, peak=peak, **prof)


def range_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over the range of ``ref``."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / (ref.max() - ref.min()).clamp_min(1e-30))


def spread_errs(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max |got - ref| over the range of ``ref``, |got - ref| / |ref| in
    the L2 norm)."""
    got, ref = got.double().cpu(), ref.double().cpu()
    diff = (got - ref).abs()
    span = (ref.max() - ref.min()).clamp_min(1e-30)
    return float(diff.max() / span), float(diff.norm() / ref.norm().clamp_min(1e-30))


def pseudo_geometry(data: dict, n: int, seed: int):
    """The train views' K, world -> camera R and t, and ``n`` pseudo cameras
    from ``generate_random_poses_llff`` around them, the scene's depth range
    as bounds (scene.py:133-147,191-200). Cameras stay on the host."""
    from sdpgs_torch.core.camera import Camera
    from sdpgs_torch.data.pose_sampling import generate_random_poses_llff

    cams = data["cams"]
    depth = data["depth_mono"].cpu().numpy()
    bounds = np.stack([np.percentile(d[d > 0], [1.0, 99.0]) for d in depth])
    poses = generate_random_poses_llff(data["Rs"], data["Ts"], bounds, n_poses=n,
                                       rng=np.random.default_rng(seed))
    pcams = [Camera.create(R=p[:3, :3].T, T=p[:3, 3], fovx=0.9, fovy=0.7, width=cams[0].width,
                           height=cams[0].height, device="cpu") for p in poses]
    K = cams[0].intrinsics_matrix()
    R_train = torch.stack([c.view[:3, :3] for c in cams])
    t_train = torch.stack([c.view[:3, 3] for c in cams])
    return K, R_train, t_train, pcams


def k6_versus_plain(depths, pc, label: str) -> dict:
    """K6 and its plain version on the same [proj | c] rows: bit-identical
    z-buffers, through the path zbuf_plan gives the shape; prints the path,
    the cluster, the share of valid rows whose atomic stays in the block
    that projects them, the filled pixels, the rows that lost the min and
    the largest displacement."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.ops import warp

    V, H, W = depths.shape
    plan = warp.zbuf_plan(H, W)
    paths = dict(_kernels.WARP_PATH_LAUNCHES)
    out_k = warp.warp_zbuffer_rows(depths, pc)
    took = {k: n - paths[k] for k, n in _kernels.WARP_PATH_LAUNCHES.items()}
    out_p = warp.warp_zbuffer_rows_plain(depths, pc)
    torch.cuda.synchronize()
    same = torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))
    err = float((out_k - out_p).abs().max())
    u, v, z, valid = warp.project_rows(depths, pc)
    n = pc.shape[0]
    pix = torch.arange(H * W, device=depths.device)
    xs, ys = pix % W, pix // W
    n_valid = int(valid.sum())
    filled = int((out_p > 0).sum())
    max_du = int(torch.where(valid, (u - xs).abs(), 0).max()) if n_valid else 0
    if plan.path == "cluster":   # destination row in the band of the source row
        home = torch.div(torch.where(valid, v, 0).long(), plan.rows, rounding_mode="floor")
        local = int((valid & (home == torch.div(ys, plan.rows, rounding_mode="floor"))).sum())
        where = (f"cluster path, {plan.cluster} blocks of {plan.rows} rows "
                 f"({plan.smem_bytes} B shared), atomics local to their block "
                 f"{local / max(n_valid, 1):.4f}")
    else:
        where = "general path (three kernels over device memory)"
    print(f"  K6 [{label}]: {n} pairs at {W}x{H}, {where}; rows {n * H * W}, valid {n_valid}, "
          f"filled pixels {filled}, rows that lost the min {n_valid - filled}, holes in the "
          f"source {int((depths == 0).sum())}, max |du| {max_du} px; bit-identical {same}")
    require(took == {k: int(k == plan.path) for k in took},
            f"K6 [{label}] did not take the {plan.path} path once: {took}")
    require(same, f"K6 disagrees with its plain version [{label}]")
    require(n_valid > 0 and filled > 0, f"K6 [{label}] scattered nothing")
    return dict(err=err, max_du=max_du, filled=filled, path=plan.path, out=out_p)


def rescaled(depths, K, width: int, height: int):
    """The depths resized (nearest) to width x height, and K scaled with them."""
    V, H, W = depths.shape
    d = torch.nn.functional.interpolate(depths[None], size=(height, width), mode="nearest")[0]
    scale = torch.tensor([[width / W, 0.0, 0.0], [0.0, height / H, 0.0], [0.0, 0.0, 1.0]],
                         device=K.device)
    return d.contiguous(), scale @ K


def single_pair(dev, proj, c=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """One pair's [proj | c] rows, written out."""
    rows = torch.cat([torch.tensor(proj, dtype=torch.float32),
                      torch.tensor(c, dtype=torch.float32)[:, None]], dim=1)
    return rows.reshape(1, 12).to(dev)


def check_warp(data: dict, dev) -> dict:
    """K6 against its plain version on the card, bit for bit: the prefetch
    (REPROJ_PREFETCH pseudo cameras x 3 train views) and the in-step shape
    (3 pairs) on the cluster path; a pair whose baseline puts
    displacements past the TPU kernel's 128-pixel window; one with source
    holes and rows out of frame; pairs at 377x503 (4-byte write-out),
    1008x756 (a non-portable cluster of 16) and 4032x3024 (past every cluster:
    the general path); a pair whose rows all land in one block's band, and
    one whose rows collapse onto 15 pixels on a band edge."""
    from sdpgs_torch.ops import warp
    from sdpgs_torch.train.loop import REPROJ_PREFETCH

    with torch.no_grad():
        depths = data["depth_mono"].contiguous()
        H, W = depths.shape[-2:]
        K, R_train, t_train, pcams = pseudo_geometry(data, REPROJ_PREFETCH, seed=1)
        R_p = torch.stack([c.view[:3, :3] for c in pcams]).to(dev)
        t_p = torch.stack([c.view[:3, 3] for c in pcams]).to(dev)
        geo = (K.to(dev), R_train.to(dev), t_train.to(dev))
        pc = warp.pair_rows(*geo, R_p, t_p)
        main = k6_versus_plain(depths, pc, f"{REPROJ_PREFETCH} pseudo cameras")
        require(main["path"] == "cluster", "the prefetch's shape did not take the cluster path")
        errs = [main["err"]]
        errs.append(k6_versus_plain(depths, pc[:depths.shape[0]], "in step, 3 pairs")["err"])
        eye = torch.eye(3, device=dev)[None]
        far = warp.pair_rows(geo[0], geo[1][:1], geo[2][:1], eye,
                             geo[2][:1] + torch.tensor([[BASELINE_FAR, 0.0, 0.0]], device=dev))
        wide = k6_versus_plain(depths[:1].contiguous(), far, "wide baseline")
        errs.append(wide["err"])
        require(wide["max_du"] > 128, "the wide-baseline pair stayed inside 128 px")
        holes = depths[:1].clone()
        holes[:, H // 4:H // 2, W // 4:W // 2] = 0.0
        tilt = torch.tensor([[0.8, 0.0, 0.6], [0.0, 1.0, 0.0], [-0.6, 0.0, 0.8]], device=dev)
        edge = warp.pair_rows(geo[0], geo[1][:1], geo[2][:1], tilt[None],
                              torch.tensor([[0.4, 0.3, -0.5]], device=dev))
        errs.append(k6_versus_plain(holes, edge, "holes, out of frame")["err"])
        for (w, h), want in K6_SIZES:
            d, Ks = rescaled(depths[:1], geo[0], w, h)
            pair = warp.pair_rows(Ks, geo[1][:1], geo[2][:1], R_p[:1], t_p[:1])
            res = k6_versus_plain(d, pair, f"{w}x{h}")
            require(res["path"] == want, f"K6 at {w}x{h} took the {res['path']} path")
            errs.append(res["err"])
            del d
        # every row into block 0's band: v = rint(y (rows - 1) / (H - 1))
        rows = warp.zbuf_plan(H, W).rows
        squash = single_pair(dev, [[1, 0, 0], [0, (rows - 1) / (H - 1), 0], [0, 0, 1]])
        one = k6_versus_plain(depths[:1].contiguous(), squash, "one band")
        require(not bool((one["out"][:, rows:] > 0).any()),
                "the one-band pair filled a pixel outside block 0's band")
        # every row onto 5 x 3 pixels across the edge of bands 1 and 2
        mid = rows * 2 - 1.0
        crowd = k6_versus_plain(depths[:1].contiguous(), single_pair(
            dev, [[4.0 / W, 0, W / 2 - 2], [0, 2.0 / H, mid - 1], [0, 0, 1]]), "collapsed")
        require(crowd["filled"] <= 15, "the collapsed pair filled more than 15 pixels")
        errs += [one["err"], crowd["err"]]
    n_rows = pc.shape[0] * depths[0].numel()
    return dict(depths=depths, pc=pc, rows=n_rows, err=max(errs), plain=main["out"],
                geo=(*geo, R_p, t_p))


def zbuf_launch(depths, pc, cluster: int, rows: int, out=None) -> torch.Tensor:
    """K6's C entry with a design the plan may not pick (the probes), into
    ``out`` when given: clusters of ``cluster`` blocks of ``rows`` rows, or
    the general path at cluster 0."""
    from sdpgs_torch import _kernels

    V, H, W = depths.shape
    if out is None:
        out = torch.empty((pc.shape[0], H, W), device=depths.device)
    err = _kernels.lib().sdpgs_warp_zbuf(
        _kernels.ptr(depths), _kernels.ptr(pc), _kernels.ptr(out), pc.shape[0], V, H, W,
        cluster, rows, _kernels.stream(depths.device))
    require(err == 0, f"K6 probe (cluster {cluster}, rows {rows}) failed to launch: {err}")
    return out


def k6_designs_timed(depths, pc, ref, clusters, chunk: int) -> dict:
    """K6's designs on these pairs, each held bit for bit to ``ref`` (the
    plain version's z-buffers) and timed: the general path's three kernels
    over all pairs and over chunks of ``chunk`` pairs (chunk % V == 0, so a
    chunk's pairs read the same views), and clusters of each of
    ``clusters`` blocks whose band fits one block's shared memory, each
    block projecting its own band of source rows."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.ops import warp

    V, H, W = depths.shape
    plan = warp.zbuf_plan(H, W)
    where = f"{pc.shape[0]} pairs at {W}x{H}"

    def chunked():
        out = torch.empty_like(ref)
        for a in range(0, pc.shape[0], chunk):
            zbuf_launch(depths, pc[a:a + chunk], 0, H, out=out[a:a + chunk])
        return out

    designs = {"general, all pairs": lambda: zbuf_launch(depths, pc, 0, H),
               f"general, chunks of {chunk} pairs": chunked}
    for c in clusters:
        rows = -(-H // c)
        if rows * W * 4 > warp.MAX_SMEM_BYTES:
            print(f"  K6 probe, {where}: no cluster of {c} (a block's {rows} rows take "
                  f"{rows * W * 4} B, above {warp.MAX_SMEM_BYTES})")
            continue
        tag = ", the plan's" if (c, rows) == (plan.cluster, plan.rows) else ""
        designs[f"cluster {c} x {rows} rows{tag}"] = (
            lambda c=c, rows=rows: zbuf_launch(depths, pc, c, rows))
        print(f"  K6 probe, {where}: clusters of {c} x {rows} rows resident at once "
              f"{_kernels.lib().sdpgs_warp_zbuf_clusters(c, rows, W)}")
    ref_bits = ref.view(torch.int32)
    times = {}
    for name, fn in designs.items():
        same = torch.equal(fn().view(torch.int32), ref_bits)
        require(same, f"K6 probe [{name}, {where}] disagrees with the plain version")
        times[name] = cuda_ms(fn)
        print(f"  K6 probe, {where} [{name}]: {times[name]:.4f} ms, bit-identical {same}")
    best = min(times, key=times.get)
    print(f"  K6 probe, {where}: fastest [{best}]; the plan takes the {plan.path} path"
          + (f", {plan.cluster} x {plan.rows} rows" if plan.path == "cluster" else ""))
    return times


def k6_probes(warp_check: dict) -> dict:
    """K6's designs at the prefetch's pair count, each bit-identical to the
    plain version and timed: at 504x378 clusters of K6_PROBE_CLUSTERS
    blocks and the general path over all pairs and chunks of K6_CHUNK
    pairs; at 1008x756 (the depths resized, the intrinsics scaled) the
    plan's cluster of 16 against the general path over all pairs and
    chunks of K6_CHUNK_2X."""
    from sdpgs_torch.ops import warp

    depths, pc, ref = warp_check["depths"], warp_check["pc"], warp_check.pop("plain")
    K, R_train, t_train, R_p, t_p = warp_check["geo"]
    V, H, W = depths.shape
    times = k6_designs_timed(depths, pc, ref, K6_PROBE_CLUSTERS, K6_CHUNK)
    del ref
    d2, K2 = rescaled(depths, K, 2 * W, 2 * H)
    pc2 = warp.pair_rows(K2, R_train, t_train, R_p, t_p)
    ref2 = warp.warp_zbuffer_rows_plain(d2, pc2)
    times_2x = k6_designs_timed(d2, pc2, ref2, K6_PROBE_CLUSTERS_2X, K6_CHUNK_2X)
    return dict(llff=times, double=times_2x)


def kernel_resources(source: str) -> dict:
    """Registers and spill bytes of each kernel of ``source`` in this
    build's ptxas log ({} when the library came from the cache)."""
    import re

    from sdpgs_torch import _kernels

    found, name, in_src = {}, None, False
    for line in _kernels.BUILD_LOG.splitlines():
        if line.startswith("== "):
            in_src = line[3:].strip() == source
            continue
        if not in_src:
            continue
        m = re.search(r"Compiling entry function '\S*?\d+([a-z_]+_kernel)(?:ILb([01])EE)?E",
                      line)
        if m:
            name = m.group(1) + ("" if m.group(2) is None
                                 else "<stats>" if m.group(2) == "1" else "<no stats>")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            found.setdefault(name, {})["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found.setdefault(name, {})["registers"] = int(m.group(1))
    return found


def check_depth_net(data: dict, dev) -> dict:
    """The depth net (random weights, seed 0) on the card against the CPU in
    f32: the output, and the input gradient at a seeded cotangent held to a
    float64 run, on one full-width image; then bf16 against f32 on the
    card: the output, and the input gradient on tiny_hybrid against the
    CPU's."""
    from sdpgs_torch.models.depth_estimator import MonoDepth, mono_depth_from_params
    from sdpgs_torch.models.dpt import random_params

    arch = DPT_ARCH
    raw = random_params(arch, seed=0)
    img = data["image"][0].detach()
    cot = torch.randn(img.shape[1:], generator=torch.Generator().manual_seed(4))
    res = []
    for d, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float32),
                     (torch.device("cpu"), torch.float64)):
        mono = mono_depth_from_params(raw, arch=arch, device=d)
        if dtype == torch.float64:
            mono = MonoDepth(mono.net.double())
        x = img.to(d, dtype).clone().requires_grad_(True)
        t0 = time.perf_counter()
        y = mono(x)
        (g,) = torch.autograd.grad(y, x, cot.to(d, dtype))
        if d.type == "cuda":
            torch.cuda.synchronize()
        res.append((y.detach().cpu(), g.cpu(), time.perf_counter() - t0))
        del mono
    (y_c, g_c, t_c), (y_p, g_p, t_p), (_, g_64, _) = res
    fwd = range_err(y_c, y_p)
    l2_c = float((g_c.double() - g_64).norm() / g_64.norm())
    l2_p = float((g_p.double() - g_64).norm() / g_64.norm())
    l2_cp = float((g_c - g_p).norm() / g_p.norm())
    mono_bf = mono_depth_from_params(raw, arch=arch, dtype=torch.bfloat16, device=dev)
    x = img.to(dev).clone().requires_grad_(True)
    if dev.type == "cuda":      # the first graphed call captures: its time, the pool's memory
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    t0 = time.perf_counter()
    y_bf = mono_bf(x)
    (g_bf,) = torch.autograd.grad(y_bf, x, cot.to(dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.empty_cache()
        print(f"  depth net's CUDA graphs (bf16, {len(mono_bf._graphs)} captured): first call "
              f"(three eager warm-ups, the capture, one replay) {capture_ms:.1f} ms; with the "
              f"graphs held, reserved {torch.cuda.memory_reserved() - mem0[1]:+,} bytes, "
              f"allocated {torch.cuda.memory_allocated() - mem0[0]:+,}")
        require(len(mono_bf._graphs) == 1, "the card's depth-net call did not capture a graph")
    y_bf = y_bf.detach().cpu()
    bf_grad_full = float((g_bf.double().cpu() - g_c).norm() / g_c.norm())
    del mono_bf
    bf_max, bf_l2 = spread_errs(y_bf, y_c)
    bf_corr = float(torch.corrcoef(torch.stack([y_bf.reshape(-1), y_c.reshape(-1)]))[0, 1])
    tiny = random_params(DPTArch.tiny_hybrid(), seed=0)
    bf_grad = {d.type: bf16_grad_err(tiny, img, cot, d) for d in (dev, torch.device("cpu"))}
    print(f"depth net ({'DPT-Hybrid' if arch == DPTArch.hybrid() else arch}, seed 0) at "
          f"{img.shape[2]}x{img.shape[1]}: card vs CPU in f32, output {fwd:.2e} of its range "
          f"(limit {DPT_FWD_TOL:g}); input gradient against a float64 run on the CPU, in the "
          f"norm: card {l2_c:.3e}, CPU f32 {l2_p:.3e} (card limit {DPT_GRAD_MARGIN}x the CPU's), "
          f"card vs CPU {l2_cp:.3e}; output range {float(y_p.max() - y_p.min()):.3e}; bf16 vs "
          f"f32 on the card: max {bf_max:.2e} of the range, {bf_l2:.2e} in the norm, Pearson "
          f"{bf_corr:.5f} (limit {DPT_BF16_CORR}), input gradient {bf_grad_full:.3f} in the norm "
          f"(noise: held on tiny_hybrid); tiny_hybrid's bf16 input gradient vs its f32 one: card "
          f"{bf_grad[dev.type]:.4f}, CPU {bf_grad['cpu']:.4f} (card limit "
          f"{DPT_BF16_GRAD_MARGIN}x the CPU's); forward + input gradient {t_c:.3f} s on the "
          f"card (first call), {t_p:.1f} s on the CPU")
    require(bool(torch.isfinite(y_c).all() and torch.isfinite(g_c).all()),
            "depth net output or gradient not finite")
    require(float(g_c.abs().max()) > 0, "no gradient reached the image")
    require(fwd <= DPT_FWD_TOL and l2_c <= DPT_GRAD_MARGIN * l2_p,
            "depth net: the card strays from the CPU")
    require(bf_corr >= DPT_BF16_CORR, "depth net: bf16 strays from f32")
    require(0 < bf_grad[dev.type] <= DPT_BF16_GRAD_MARGIN * bf_grad["cpu"],
            "depth net: the card's bf16 backward strays further from f32 than the CPU's")
    return dict(raw=raw, cpu_s=t_p)


def bf16_grad_err(raw: dict, img: torch.Tensor, cot: torch.Tensor, dev) -> float:
    """|g_bf16 - g_f32| / |g_f32| of tiny_hybrid's input gradient at ``cot``
    on ``dev``."""
    from sdpgs_torch.models.depth_estimator import mono_depth_from_params

    grads = []
    for dtype in (None, torch.bfloat16):
        mono = mono_depth_from_params(raw, arch=DPTArch.tiny_hybrid(), dtype=dtype, device=dev)
        x = img.to(dev).clone().requires_grad_(True)
        (g,) = torch.autograd.grad(mono(x), x, cot.to(dev))
        grads.append(g.double().cpu())
    return float((grads[1] - grads[0]).norm() / grads[0].norm())


def cycle_means(values: list) -> tuple:
    """The mean of the first and of the last cycle of the train cameras."""
    return statistics.mean(values[:TRAIN_CAMS]), statistics.mean(values[-TRAIN_CAMS:])


def pseudo_inputs(data, dev, cam, fused, weight, K, R_train, t_train):
    from sdpgs_torch.train.step import PseudoInputs

    return PseudoInputs(camera=cam, train_depths=data["depth_mono"].to(dev), K=K.to(dev),
                        R_train=R_train.to(dev), t_train=t_train.to(dev),
                        R_pseudo=cam.view[:3, :3].to(dev), t_pseudo=cam.view[:3, 3].to(dev),
                        reproj_fused=fused, reproj_weight=weight)


def pseudo_terms(state, pseudo, protos, bg, tcfg, mono, dev) -> dict:
    """The three pseudo terms, weighted, at this state: the reprojection,
    the depth net's Pearson and the segment Pearson."""
    from sdpgs_torch.render import render
    from sdpgs_torch.train.step import _pseudo_losses

    with torch.no_grad():
        out = render(pseudo.camera, state.gaussians, tcfg.raster, bg, SH_DEGREE, device=dev)
        full = _pseudo_losses(out, pseudo, protos, tcfg, state.step, mono)
        reproj = _pseudo_losses(out, pseudo, protos, tcfg, state.step, None)
        below = _pseudo_losses(out, pseudo, protos, tcfg, 4000, mono)
    return dict(reproj=float(reproj), mono=float(below - reproj), seg=float(full - below))


def check_pseudo_step_card_vs_cpu(rng, dev, raw) -> None:
    """One pseudo step from the same state at iteration PSEUDO_START on the
    card (kernels) and on the CPU (plain versions) at a reduced size, the
    depth net in f32: gradients, metrics and the fused z-buffer."""
    from sdpgs_torch.config import TrainConfig
    from sdpgs_torch.core.gaussians import Gaussians
    from sdpgs_torch.losses import reproject_fused_depth
    from sdpgs_torch.models.depth_estimator import mono_depth_from_params
    from sdpgs_torch.opt.adam import TRAINABLE
    from sdpgs_torch.train.state import TrainState
    from sdpgs_torch.train.step import loss_and_grads, make_train_step

    trainee, data = train_scene(rng, dev, **SMALL)
    K, R_train, t_train, pcams = pseudo_geometry(data, 1, seed=3)
    tcfg = TrainConfig()
    res = {}
    for d in (dev, torch.device("cpu")):
        state = TrainState.create(Gaussians.from_numpy(trainee, device=d), device=d)
        state.step = PSEUDO_START
        mono = mono_depth_from_params(raw, arch=DPT_ARCH, device=d)
        depths = data["depth_mono"].to(d)
        f, w = reproject_fused_depth(depths, K.to(d), R_train.to(d), t_train.to(d),
                                     pcams[0].view[:3, :3].to(d), pcams[0].view[:3, 3].to(d))
        pseudo = pseudo_inputs(data, d, pcams[0], f, w, K, R_train, t_train)
        batch, protos, bg = view_batch(data, 0, d), data["protos"].to(d), torch.zeros(3, device=d)
        terms = pseudo_terms(state, pseudo, protos, bg, tcfg, mono, d)
        grads = loss_and_grads(state, batch, protos, bg, tcfg, SH_DEGREE, d, pseudo=pseudo,
                               mono_depth_fn=mono)
        _, m = make_train_step(tcfg, SH_DEGREE, with_pseudo=True, mono_depth_fn=mono)(
            state, batch, protos, bg, 1.0, pseudo=pseudo, device=d)
        res[d.type] = (grads, m, f.cpu(), w.cpu(), terms)
        del mono
    (g_c, m_c, f_c, w_c, terms_c), (g_p, m_p, f_p, w_p, terms_p) = res[dev.type], res["cpu"]
    rel, l2 = {}, {}
    for k in TRAINABLE:
        ref, got = g_p.params[k], g_c.params[k].cpu()
        rel[k] = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
        l2[k] = float((got - ref).norm() / ref.norm().clamp_min(1e-30))
    metric_rel = {k: abs(float(getattr(m_c, k)) - float(getattr(m_p, k)))
                  / max(abs(float(getattr(m_p, k))), 1e-30) for k in ("loss", "l1", "psnr")}
    w_share = float((w_c != w_p).float().mean())
    print(f"pseudo step, card vs CPU at {SMALL['width']}x{SMALL['height']}, iteration "
          f"{PSEUDO_START}: terms card {terms_c}, CPU {terms_p}; gradient max |diff| / field "
          f"max { {k: f'{v:.1e}' for k, v in rel.items()} }, in the norm "
          f"{ {k: f'{v:.1e}' for k, v in l2.items()} } (limit {PSEUDO_GRAD_TOL:g}); "
          f"metrics rel {({k: f'{v:.1e}' for k, v in metric_rel.items()})} (limit "
          f"{STEP_METRIC_RTOL:g}); fused weight pixels that differ {w_share:.2e}, fused "
          f"pixels {int(w_p.sum())}")
    require(all(v != 0.0 and math.isfinite(v) for v in terms_c.values()),
            "a pseudo term is zero or not finite")
    require(all(v <= PSEUDO_GRAD_TOL for v in l2.values()), "card and CPU gradients differ")
    require(all(v <= STEP_METRIC_RTOL for v in metric_rel.values()), "card and CPU losses differ")
    require(w_share <= 1e-3, "card and CPU fused z-buffers differ")


def pseudo_train_phase(rng, dev, raw) -> dict:
    """The pseudo-view slice at full width from iteration PSEUDO_START: one
    K6 prefetch of REPROJ_PREFETCH pseudo cameras, then PSEUDO_STEPS pseudo
    steps cycling the train cameras with the depth net (config defaults:
    bf16) in the loss, which must lower the loss; the same steps without
    the depth net must lower L1. Then its timings and profile."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.config import TrainConfig
    from sdpgs_torch.core.gaussians import Gaussians
    from sdpgs_torch.losses import reproject_fused_depth
    from sdpgs_torch.losses.depth import _fuse_warped
    from sdpgs_torch.models.depth_estimator import mono_depth_from_params
    from sdpgs_torch.ops import warp
    from sdpgs_torch.opt.adam import TRAINABLE
    from sdpgs_torch.train.loop import REPROJ_PREFETCH, prefetch_pseudo_reproj
    from sdpgs_torch.train.state import TrainState
    from sdpgs_torch.train.step import make_train_step

    tcfg = TrainConfig()
    trainee, data = train_scene(rng, dev, WIDTH, HEIGHT, CAPACITY, ALIVE)
    mono = mono_depth_from_params(
        raw, arch=DPT_ARCH, dtype=torch.bfloat16 if tcfg.model.dpt_bf16 else None,
        matmul_precision=tcfg.model.dpt_matmul_precision, resize_method=tcfg.model.dpt_resize,
        device=dev)
    K, R_train, t_train, pcams = pseudo_geometry(data, REPROJ_PREFETCH, seed=2)
    depths, Kd, Rd, td = (data["depth_mono"], K.to(dev), R_train.to(dev), t_train.to(dev))
    state = TrainState.create(Gaussians.from_numpy(trainee, device=dev), device=dev)
    state.step = PSEUDO_START
    step = make_train_step(tcfg, SH_DEGREE, with_pseudo=True, mono_depth_fn=mono)
    plain_step = make_train_step(tcfg, SH_DEGREE)
    batches = [view_batch(data, v, dev) for v in range(TRAIN_CAMS)]
    protos, bg = data["protos"], torch.zeros(3, device=dev)

    # the terms at the start, and the first update against a plain step's
    f0, w0 = reproject_fused_depth(depths, Kd, Rd, td, pcams[0].view[:3, :3].to(dev),
                                   pcams[0].view[:3, 3].to(dev))
    pseudo0 = pseudo_inputs(data, dev, pcams[0], f0, w0, K, R_train, t_train)
    terms = pseudo_terms(state, pseudo0, protos, bg, tcfg, mono, dev)
    snap = state.to_numpy()
    moved = {}
    for name, fn, kw in (("plain", plain_step, {}), ("pseudo", step, dict(pseudo=pseudo0))):
        s = TrainState.from_numpy(snap, device=dev)
        fn(s, batches[0], protos, bg, 1.0, device=dev, **kw)
        moved[name] = {k: getattr(s.gaussians, k).detach() - torch.from_numpy(
            snap["gaussians"][k]).to(dev) for k in TRAINABLE}
        del s
    update_diff = max(float((moved["pseudo"][k] - moved["plain"][k]).abs().max())
                      for k in TRAINABLE)
    print(f"pseudo train: {PSEUDO_STEPS} steps at {WIDTH}x{HEIGHT}, {ALIVE} alive of "
          f"{CAPACITY}, SH {SH_DEGREE}, from iteration {PSEUDO_START}; pseudo terms at the "
          f"start {terms}; first update, pseudo vs plain step, max |diff| {update_diff:.3e}")
    require(all(v != 0.0 and math.isfinite(v) for v in terms.values()),
            "a pseudo term is zero or not finite")
    require(update_diff > 0.0, "the pseudo step updated the parameters as a plain step does")
    check_step_determinism("plain", plain_step, snap, (batches[0], protos, bg, 1.0), dev)
    check_step_determinism("pseudo", step, snap, (batches[0], protos, bg, 1.0), dev,
                           pseudo=pseudo0)

    # the main path: one prefetch, then the pseudo steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    t0 = time.perf_counter()
    queue = prefetch_pseudo_reproj(depths, Kd, Rd, td, pcams)
    torch.cuda.synchronize()
    prefetch_s = time.perf_counter() - t0
    pseudos = [pseudo_inputs(data, dev, cam, f, w, K, R_train, t_train)
               for cam, f, w in queue[:PSEUDO_STEPS]]
    l1s, losses, times = [], [], []
    for i in range(PSEUDO_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batches[i % TRAIN_CAMS], protos, bg, 1.0, pseudo=pseudos[i],
                        device=dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        l1s.append(float(m.l1))
        losses.append(float(m.loss))
    launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
    k6_paths = dict(_kernels.WARP_PATH_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    first, last = cycle_means(l1s)
    loss_first, loss_last = cycle_means(losses)
    step_ms = statistics.median(times[TRAIN_WARMUP:])
    print(f"  launches {launches} (K6 by path {k6_paths}); plain calls {plain}; prefetch of "
          f"{len(queue)} cameras {prefetch_s * 1e3:.1f} ms (first call)")
    print(f"  loss first cycle {loss_first:.5f} -> last cycle {loss_last:.5f} (ratio "
          f"{loss_last / loss_first:.3f}, limit {PSEUDO_LOSS_MARGIN}); L1 {first:.5f} -> {last:.5f} (ratio "
          f"{last / first:.3f}); final PSNR {float(m.psnr):.2f} dB")
    print(f"  pseudo step: {step_ms:.3f} ms (median of {len(times) - TRAIN_WARMUP} after "
          f"{TRAIN_WARMUP} warm-up; min {min(times[TRAIN_WARMUP:]):.3f}, max "
          f"{max(times[TRAIN_WARMUP:]):.3f}), {1e3 / step_ms:.1f} steps/s; peak device memory "
          f"{peak / 2**20:.1f} MiB")
    require(all(launches[k] == 2 * PSEUDO_STEPS
                for k in _kernels.FORWARD_KERNELS + _kernels.BACKWARD_KERNELS),
            "a render kernel was not launched twice per pseudo step")
    require(launches["warp_zbuf"] == 1, "the prefetch did not launch K6 once")
    require(k6_paths == {"cluster": 1, "general": 0}, "the prefetch's K6 took the general path")
    require(not any(plain.values()), "a plain version ran on the pseudo path")
    require(all(bool(torch.isfinite(p).all()) for p in state.gaussians.parameters()),
            "non-finite parameters after pseudo training")
    require(loss_last < PSEUDO_LOSS_MARGIN * loss_first,
            f"the loss did not fall below {PSEUDO_LOSS_MARGIN} x its start over the pseudo steps")
    # The random-weight depth net's term outweighs L1 (L1 stays flat): the
    # same steps without it, from the same state, must lower L1.
    s = TrainState.from_numpy(snap, device=dev)
    no_net = make_train_step(tcfg, SH_DEGREE, with_pseudo=True)
    l1s_no_net = []
    for i in range(PSEUDO_STEPS):
        s, m = no_net(s, batches[i % TRAIN_CAMS], protos, bg, 1.0, pseudo=pseudos[i], device=dev)
        l1s_no_net.append(float(m.l1))
    nn_first, nn_last = cycle_means(l1s_no_net)
    print(f"  the same steps without the depth net: L1 {nn_first:.5f} -> {nn_last:.5f} (ratio "
          f"{nn_last / nn_first:.3f}, limit {L1_MARGIN})")
    require(nn_last < L1_MARGIN * nn_first, "L1 did not fall over the pseudo steps without "
            "the depth net")
    del s

    # the depth net alone, the prefetch alone, then the step's profile
    x = data["image"][0].detach().clone().requires_grad_(True)
    cot = torch.randn(x.shape[1:], generator=torch.Generator(device=dev).manual_seed(5),
                      device=dev)
    dpt_ms = cuda_ms(lambda: torch.autograd.grad(mono(x), x, cot), reps=10)
    prefetch_ms = cuda_ms(lambda: prefetch_pseudo_reproj(depths, Kd, Rd, td, pcams), reps=5)
    # the prefetch's parts: K6, the fusion of its z-buffers, the rest (the
    # cameras' copy to the card, which synchronises, and pair_rows)
    with torch.no_grad():
        pc = warp.pair_rows(Kd, Rd, td, torch.stack([c.view[:3, :3] for c in pcams]).to(dev),
                            torch.stack([c.view[:3, 3] for c in pcams]).to(dev))
        warped = warp.warp_zbuffer_rows(depths, pc).reshape(len(pcams), *depths.shape)
        k6_ms = cuda_ms(lambda: warp.warp_zbuffer_rows(depths, pc), reps=5)
        fuse_ms = cuda_ms(lambda: _fuse_warped(warped, 2, 0.05), reps=5)
    del warped
    print(f"  depth net forward + input gradient: {dpt_ms:.3f} ms; prefetch per "
          f"{len(pcams)} pseudo cameras: {prefetch_ms:.3f} ms: K6 {k6_ms:.4f} ms, _fuse_warped "
          f"{fuse_ms:.4f} ms, the rest {prefetch_ms - k6_ms - fuse_ms:.4f} ms")
    prof = profile_calls(lambda i: step(state, batches[i % TRAIN_CAMS], protos, bg, 1.0,
                                        pseudo=pseudos[i], device=dev),
                         list(range(TRAIN_CAMS)), "pseudo step", top=16)
    return dict(launches=launches, step_ms=step_ms, peak=peak, dpt_ms=dpt_ms,
                prefetch_ms=prefetch_ms, prefetch_k6_ms=k6_ms, prefetch_fuse_ms=fuse_ms, **prof)


def sort_inputs(rng, n: int, dead: float, edge: bool, dev):
    """perf_sort.py's inputs: depths in [1, 9) with a share of +inf (dead
    slots), random payloads, gid = arange(n); ``edge`` negates a fifth of
    the keys (-inf among them) and sets 30% to SORT_SPECIALS, so each
    special value ties many times (tests/test_torch_sort.py:edge_inputs)."""
    depth = rng.uniform(1, 9, n).astype(np.float32)
    depth[rng.random(n) < dead] = np.inf
    if edge:
        depth[rng.random(n) < 0.2] *= -1
        pick = rng.random(n) < 0.3
        depth[pick] = rng.choice(np.array(SORT_SPECIALS, np.float32), int(pick.sum()))
    packed = rng.integers(0, 1 << 30, n).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (depth, packed, np.arange(n, dtype=np.int32)))


def same_bits(a, b) -> bool:
    """Bit-identical tensors (floats by their int32 bits: -0.0 != +0.0)."""
    view = (lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t)  # noqa: E731
    return bool(torch.equal(view(a), view(b)))


def library_sort(key, val1, gid):
    """The library call K7 stands beside: torch.sort(stable=True) and the
    two gathers."""
    ks, order = torch.sort(key, stable=True)
    return ks, val1[order], gid[order]


def sort_phase(rng, dev) -> dict:
    """K7's own path, the counterpart of scripts/perf_sort.py: the stable
    sort at N = 2^17 and 2^16 with 40% +inf keys; each result bit-identical
    to torch.sort(stable=True) with its gathers and to the plain version,
    also at N = 2^14 and 2^19 with keys across the f32 line."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.ops.sort import sort_by_key, sort_by_key_plain

    main = {n: sort_inputs(rng, n, SORT_DEAD, False, dev) for n in SORT_SIZES}
    torch.cuda.synchronize()
    _kernels.reset_counts()
    outs = {n: sort_by_key(*args, device=dev) for n, args in main.items()}
    torch.cuda.synchronize()
    launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
    require(launches["sort"] == len(SORT_SIZES) and not any(plain.values())
            and sum(launches.values()) == launches["sort"],
            "the sort path did not launch K7 once per sort, and nothing else")
    cases = {**{(n, "40% inf"): (main[n], outs[n]) for n in SORT_SIZES}}
    for n in SORT_EDGE_SIZES:
        args = sort_inputs(rng, n, SORT_DEAD, True, dev)
        cases[(n, "negatives, +-inf, +-max, subnormals, signed zeros, ties")] = (
            args, sort_by_key(*args, device=dev))
    err = 0.0
    for (n, label), (args, got) in cases.items():
        lib = library_sort(*args)
        ref = sort_by_key_plain(*args)
        torch.cuda.synchronize()
        same = [same_bits(a, b) and same_bits(a, c) for a, b, c in zip(got, lib, ref)]
        finite = torch.isfinite(ref[0])
        err = max(err, float((got[0] - ref[0])[finite].abs().max()),
                  *(float((a - b).abs().max()) for a, b in zip(got[1:], ref[1:])))
        zeros = int((got[0] == 0).sum())
        print(f"  K7 sort N=2^{n.bit_length() - 1} ({label}): keys, payload, gids bit-identical "
              f"to torch.sort(stable) + gathers and to the plain version {same}; keys < 0 "
              f"{int((got[0] < 0).sum())}, inf keys {int(torch.isinf(got[0]).sum())} (-inf "
              f"{int((got[0] == -math.inf).sum())}), zeros {zeros} (negative "
              f"{int(torch.signbit(got[0][got[0] == 0]).sum())})")
        require(all(same), f"K7 disagrees at N={n} ({label})")
    print(f"sort path: launches {launches}")
    args_by_n = {n: args for (n, _), (args, _) in sorted(cases.items())}
    return dict(launches=launches, args=main[SORT_SIZES[0]], args_by_n=args_by_n, err=err)


def rect_tids(packed_s: torch.Tensor, tiles_x: int, D: int) -> torch.Tensor:
    """[P, D] tile ids of each sorted rect's first D tiles, -1 past its
    count (scripts/perf_rank_variants.py:100-112)."""
    from sdpgs_torch.ops.rasterize.binning import unpack_rect

    xmin, xmax, ymin, ymax = unpack_rect(packed_s)
    rect_w = xmax - xmin
    count = rect_w * (ymax - ymin)
    d = torch.arange(D, dtype=torch.int32, device=packed_s.device)[None, :]
    rw = torch.clamp_min(rect_w, 1)[:, None]
    tid = (ymin[:, None] + d // rw) * tiles_x + xmin[:, None] + d % rw
    valid = (count > 0)[:, None] & (d < count[:, None])
    return torch.where(valid, tid, -1).to(torch.int32).contiguous()


def probe_phase(main_check: dict) -> dict:
    """K8's own path, the counterpart of row C of
    scripts/perf_rank_variants.py: the launch-floor probe once on K2's
    sorted rects, gids and tile ids (P = 131,072, D = 8), then equal to
    its plain version."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.config import RasterizeConfig
    from sdpgs_torch.ops.launch_floor import launch_floor, launch_floor_plain
    from sdpgs_torch.ops.rasterize import binning

    packed_s, order = main_check["k2_args"][:2]
    tiles_x, _ = binning.tile_grid(WIDTH, HEIGHT, RasterizeConfig().tile)
    args = (packed_s, order, rect_tids(packed_s, tiles_x, PROBE_D))
    torch.cuda.synchronize()
    _kernels.reset_counts()
    out = launch_floor(*args, device=packed_s.device)
    torch.cuda.synchronize()
    launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
    ref = launch_floor_plain(*args)
    same = bool(torch.equal(out, ref))
    err = float((out.double() - ref.double()).abs().max())
    print(f"probe path: launches {launches}; K8 at P={packed_s.shape[0]}, D={PROBE_D}: equal to "
          f"its plain version {same}, tile ids set {int((args[2] >= 0).sum())}")
    require(launches["launch_floor"] == 1 and sum(launches.values()) == 1
            and not any(plain.values()), "the probe path did not launch K8 once, and nothing else")
    require(same, "K8 disagrees with its plain version")
    return dict(launches=launches, args=args, err=err)


def check_densify_card_vs_cpu(rng, dev) -> None:
    """One densify event with proximity on, card against CPU at SMALL size:
    the k-NN on both (distances, and indices wherever the distances are not
    tied), then densify_and_prune from one state, one noise tensor and the
    CPU's k-NN inputs on both: alive masks identical, counts equal, every
    field within DENSIFY_TOL of its largest value."""
    from sdpgs_torch.core.gaussians import PARAM_FIELDS, Gaussians
    from sdpgs_torch.ops.knn import knn
    from sdpgs_torch.opt.densify import densify_and_prune
    from sdpgs_torch.train.state import TrainState

    P, n = SMALL["capacity"], SMALL["alive"]
    arrays = make_cloud(rng, n, P)
    denom = rng.integers(0, 5, P).astype(np.float32)
    accum = rng.uniform(0, 0.003, P).astype(np.float32) * denom
    noise = rng.normal(size=(P, 3)).astype(np.float32)
    cpu = torch.device("cpu")
    knns = {}
    for d in (dev, cpu):
        xyz = torch.from_numpy(arrays["xyz"]).to(d)
        alive = torch.from_numpy(arrays["alive"]).to(d)
        d2, idx = knn(xyz, k=3, mask=alive, device=d)
        knns[d.type] = (d2.cpu(), idx.cpu())
    (d2_c, i_c), (d2_p, i_p) = knns[dev.type], knns["cpu"]
    alive_rows = torch.from_numpy(arrays["alive"]) > 0
    scale = torch.from_numpy((arrays["xyz"].astype(np.float64) ** 2).sum(-1)).float()[:, None]
    diff = (d2_c - d2_p).abs()[alive_rows]
    rel = float((diff / d2_p[alive_rows].clamp_min(1e-30)).max())
    cancel = float((diff / (2 * scale[alive_rows])).max())
    moved = (i_c != i_p)[alive_rows]
    tied = diff[moved] <= KNN_TOL * 2 * scale[alive_rows].expand_as(moved)[moved]
    print(f"k-NN card vs CPU on {n} points: distances max |diff| / distance {rel:.2e}, / (|q|^2 "
          f"+ |p|^2) {cancel:.2e} (limit {KNN_TOL:g}); indices that differ {int(moved.sum())} of "
          f"{moved.numel()}, all at tied distances {bool(tied.all())}")
    require(cancel <= KNN_TOL and bool(tied.all()), "the k-NN differs between card and CPU")

    finite = torch.isfinite(d2_p)
    knn_dist = torch.where(finite, d2_p, 0.0).sum(-1) / finite.sum(-1).clamp_min(1)
    max_scale = np.exp(arrays["scaling"]).max(-1)
    extent = 0.2 * float(knn_dist[alive_rows].median())
    pd = float(np.median(max_scale[:n])) / extent
    kw = dict(grad_threshold=0.0013, min_opacity=0.01, extent=extent, percent_dense=pd,
              run_proximity=True)
    res = {}
    for d in (dev, cpu):
        state = TrainState.create(Gaussians.from_numpy(arrays, device=d), device=d)
        state.stats.xyz_gradient_accum.copy_(torch.from_numpy(accum))
        state.stats.denom.copy_(torch.from_numpy(denom))
        g, _, _, info = densify_and_prune(state.gaussians, state.opt_state, state.stats,
                                          torch.from_numpy(noise).to(d),
                                          knn_dist=knn_dist.to(d), knn_idx=i_p.to(d), **kw)
        res[d.type] = (g.to_numpy(), {k: int(v) for k, v in info._asdict().items()})
    (g_c, info_c), (g_p, info_p) = res[dev.type], res["cpu"]
    errs = {k: float(np.abs(g_c[k] - g_p[k]).max() / max(np.abs(g_p[k]).max(), 1e-30))
            for k in PARAM_FIELDS + ("confidence",)}
    alive_same = bool(np.array_equal(g_c["alive"], g_p["alive"]))
    print(f"densify card vs CPU at capacity {P} ({n} alive), proximity on, extent {extent:.3e}: "
          f"counts card {info_c}, CPU {info_p}; alive masks identical {alive_same}; max |diff| "
          f"/ field max { {k: f'{v:.1e}' for k, v in errs.items()} } (limit {DENSIFY_TOL:g})")
    require(info_c == info_p and alive_same, "densify: card and CPU counts or masks differ")
    require(info_p["spawned"] > 0 and info_p["dropped"] > 0 and info_p["pruned"] > 0,
            "the densify check spawned, dropped or pruned nothing")
    require(all(v <= DENSIFY_TOL for v in errs.values()), "densify: card and CPU fields differ")


def trainer_config():
    from sdpgs_torch.config import TrainConfig

    cfg = TrainConfig()
    for k, v in TRAINER_OPTIM.items():
        setattr(cfg.optim, k, v)
    return cfg


def make_timed_trainer():
    """``cli/ablation_run.instrumented``'s Trainer (a synchronize at each
    step and event, so the time between consecutive steps is one whole
    iteration by kind; the densify events, resets and ladder recorded),
    which also counts the low-opacity Gaussians each densify event removes."""
    from sdpgs_torch.cli.ablation_run import instrumented
    from sdpgs_torch.train.loop import Trainer

    class TimedTrainer(instrumented(Trainer)):
        def _maybe_densify(self, iteration):
            g = self.state.gaussians
            low = (g.alive > 0) & (torch.sigmoid(g.opacity[:, 0].detach())
                                   < self.cfg.optim.prune_threshold)
            info = super()._maybe_densify(iteration)
            if info is not None:
                self.events["densify"][-1]["low_opacity_removed"] = int((low & (g.alive == 0)).sum())
            return info

    return TimedTrainer


def trainer_phase(dev, raw, work: Path) -> dict:
    """The Trainer at LLFF width: SyntheticScene (504x378, 3 train views, 1
    test view, 16 segments, 128 pseudo poses, 60,000 ground-truth points,
    capacity 131,072), TrainConfig() with a compressed schedule (600
    iterations; densify at 100-400, proximity at 100; pseudo window
    301-399; opacity reset at 301; SH degree 1 from 500; eval and a
    checkpoint at 600) and the DPT-Hybrid (random weights, seed 0, bf16) as
    the depth net."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.data.synthetic import SyntheticScene
    from sdpgs_torch.models.depth_estimator import mono_depth_from_params
    from sdpgs_torch.ops.knn import knn
    from sdpgs_torch.train.loop import REPROJ_PREFETCH
    from sdpgs_torch.train.state import restore_checkpoint

    t_phase = time.perf_counter()
    scene = SyntheticScene(**TRAINER_SCENE, device=dev)
    scene.model_path = str(work / "trainer")
    cfg = trainer_config()
    mono = mono_depth_from_params(
        raw, arch=DPT_ARCH, dtype=torch.bfloat16 if cfg.model.dpt_bf16 else None,
        matmul_precision=cfg.model.dpt_matmul_precision, resize_method=cfg.model.dpt_resize,
        device=dev)
    trainer = make_timed_trainer()(cfg, scene, mono_depth_fn=mono, device=dev)
    opt = cfg.optim
    n_pseudo = sum(opt.start_sample_pseudo < i < opt.end_sample_pseudo
                   for i in range(1, opt.iterations + 1))
    n_plain = opt.iterations - n_pseudo
    n_eval = len(scene.test_cameras) + len(scene.train_cameras)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    t0 = time.perf_counter()
    hist = trainer.train(log_every=TRAINER_LOG_EVERY)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    it_ms = {k: (statistics.median(v), len(v)) for k, v in trainer.iter_ms.items()}

    by_iter = {h["iter"]: h for h in hist}
    print(f"trainer: {opt.iterations} iterations ({n_plain} plain, {n_pseudo} pseudo) at "
          f"{WIDTH}x{HEIGHT}, {TRAINER_SCENE['n_points']} ground-truth points, capacity "
          f"{TRAINER_SCENE['capacity']}, in {train_s:.1f} s; launches {launches} (K6 by path "
          f"{_kernels.WARP_PATH_LAUNCHES}); plain calls {plain}")
    for e in trainer.events["densify"]:
        print(f"  densify at {e['iteration']}: {e['ms']:.1f} ms ({'with' if e['knn'] else 'without'}"
              f" the k-NN), spawned {e['spawned']}, dropped {e['dropped']}, pruned {e['pruned']} "
              f"(low opacity {e['low_opacity_removed']}), alive after {e['num_alive']}")
    print(f"  ladder reactions: {trainer.events['ladder'] or 'none'}; raster K "
          f"{trainer.cfg.raster.max_per_tile}, D {trainer.cfg.raster.max_tiles_per_gaussian}")
    print(f"  history: {[(h['iter'], round(h['loss'], 5), round(h['psnr'], 2), h['alive']) for h in hist]}")
    require(launches["preprocess"] == launches["binning"] == launches["composite"]
            == n_plain + 2 * n_pseudo + n_eval,
            "K1-K3 did not launch once per plain iteration, twice per pseudo one and once "
            "per eval view")
    require(launches["preprocess_bwd"] == launches["composite_bwd"] == n_plain + 2 * n_pseudo,
            "K4-K5 did not launch once per plain iteration and twice per pseudo one")
    require(launches["warp_zbuf"] == -(-n_pseudo // REPROJ_PREFETCH),
            "K6 did not launch once per prefetch")
    require(_kernels.WARP_PATH_LAUNCHES == {"cluster": launches["warp_zbuf"], "general": 0},
            f"K6's prefetches did not take the cluster path: {_kernels.WARP_PATH_LAUNCHES}")
    require(launches["sort"] == launches["launch_floor"] == 0 and not any(plain.values()),
            "K7/K8 or a plain version ran on the Trainer path")
    events = [i for i in range(opt.densify_from_iter + 1, opt.densify_until_iter)
              if i % opt.densification_interval == 0]
    require([e["iteration"] for e in trainer.events["densify"]] == events,
            f"the densify events are not at {events}")
    require(any(e["spawned"] > 0 for e in trainer.events["densify"]), "no densify event spawned")
    require(any(e["low_opacity_removed"] > 0 for e in trainer.events["densify"]
                if e["iteration"] > opt.start_sample_pseudo + 1),
            "the prune after the opacity reset removed nothing")
    # before the opacity reset (tests/test_trainer.py:99-103)
    first, before_reset = TRAINER_LOG_EVERY, opt.start_sample_pseudo
    require(by_iter[before_reset]["psnr"] > by_iter[first]["psnr"],
            f"train PSNR did not rise from {first} to {before_reset}")
    require(math.isfinite(hist[-1]["loss"]), "the final loss is not finite")
    mp = Path(scene.model_path)
    report = json.loads((mp / "eval_results.json").read_text())
    history = json.loads((mp / "training_history.json").read_text())
    require(report and report[-1]["iteration"] == opt.iterations and history == hist,
            "eval_results.json / training_history.json not written")
    print(f"  eval at {opt.iterations}: test {report[-1]['test']}, train {report[-1]['train']}")
    back = restore_checkpoint(mp / "checkpoints", opt.iterations, trainer.state)
    a, b = back.to_numpy(), trainer.state.to_numpy()
    same = all(np.array_equal(a[k][f], b[k][f]) for k in ("gaussians", "mu", "nu", "stats")
               for f in a[k]) and all(a[k] == b[k] for k in ("step", "adam_step"))
    require(same, "the checkpoint does not restore to equal arrays")
    del back

    # bare steps, the k-NN alone
    batch = trainer._next_batch()
    bg, protos, lr = trainer.bg, trainer.prototypes, trainer.spatial_lr_scale
    bare = {}
    for kind in (False, True):
        step = trainer._step_fn(0 if kind else 1, kind)
        times = []
        for _ in range(BARE_STEPS):
            pseudo = None
            if kind:
                pseudo = pseudo_inputs_from(trainer, *trainer._next_pseudo_reproj())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(trainer.state, batch, protos, bg, lr, pseudo, device=dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        bare[kind] = statistics.median(times[TRAIN_WARMUP:])
    g = trainer.state.gaussians
    knn_ms = cuda_ms(lambda: knn(g.xyz.detach(), k=3, mask=g.alive, device=dev), reps=3)
    ev = {k: [e["ms"] for e in trainer.events["densify"] if e["knn"] == k] for k in (True, False)}
    wall = time.perf_counter() - t_phase
    print(f"  ms per iteration inside train() (median, one synchronize per iteration): plain "
          f"{it_ms['plain'][0]:.3f} (of {it_ms['plain'][1]}), pseudo {it_ms['pseudo'][0]:.3f} (of "
          f"{it_ms['pseudo'][1]}); the same steps called bare: plain {bare[False]:.3f}, "
          f"pseudo {bare[True]:.3f}; densify event with the k-NN {ev[True]} ms, without "
          f"{ev[False]} ms; k-NN alone at {g.capacity} slots {knn_ms:.1f} ms; peak device memory "
          f"{peak / 2**20:.1f} MiB; phase wall time {wall:.1f} s")
    return dict(launches=launches, scene=scene, it_ms=it_ms, bare=bare, knn_ms=knn_ms,
                peak=peak)


def pseudo_inputs_from(trainer, cam, fused, weight, R, t):
    """PseudoInputs from one entry of the Trainer's prefetch queue."""
    from sdpgs_torch.train.step import PseudoInputs

    return PseudoInputs(camera=cam, train_depths=trainer._train_depths, K=trainer._K,
                        R_train=trainer._R_train, t_train=trainer._t_train, R_pseudo=R,
                        t_pseudo=t, reproj_fused=fused, reproj_weight=weight)


def forced_ladder(dev, scene) -> None:
    """A Trainer on the same scene with tight K and D (tile 16, K 128, D
    2): at the next log point it doubles both and resets the running
    maxima."""
    from sdpgs_torch.config import RasterizeConfig, TrainConfig
    from sdpgs_torch.train.loop import Trainer

    cfg = TrainConfig(raster=RasterizeConfig(tile=16, max_per_tile=128, max_tiles_per_gaussian=2))
    cfg.optim.densify_until_iter = 0
    cfg.optim.start_sample_pseudo = 10_000
    cfg.optim.test_iterations = cfg.optim.checkpoint_iterations = ()
    scene.model_path = ""
    trainer = Trainer(cfg, scene, device=dev)
    trainer.train(iterations=2, log_every=2)
    r = trainer.cfg.raster
    maxima = [int(getattr(trainer.state, k)) for k in ("max_overflow", "max_clipped")]
    print(f"forced ladder: K 128 -> {r.max_per_tile}, D 2 -> {r.max_tiles_per_gaussian}, running "
          f"maxima after the reaction {maxima}")
    require(r.max_per_tile == 256 and r.max_tiles_per_gaussian == 4 and maxima == [0, 0],
            "the ladder did not double K and D and reset the running maxima")


def write_colmap_model(sparse: Path, width: int, height: int, fx: float, fy: float,
                       names: list, tvecs: list, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """cameras.bin (one PINHOLE camera), images.bin (identity rotations,
    no keypoints) and points3D.bin (no tracks) in COLMAP's binary layout."""
    import struct

    sparse.mkdir(parents=True)
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<QiiQQ", 1, 1, 1, width, height))
        f.write(struct.pack("<dddd", fx, fy, width / 2, height / 2))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for i, (name, t) in enumerate(zip(names, tvecs)):
            f.write(struct.pack("<i4d3di", i + 1, 1.0, 0.0, 0.0, 0.0, *t, 1))
            f.write(name.encode() + b"\x00" + struct.pack("<Q", 0))
    rec = np.zeros(len(xyz), np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                                       ("err", "<f8"), ("track", "<u8")]))
    rec["id"], rec["xyz"], rec["rgb"], rec["err"] = np.arange(len(xyz)), xyz, rgb, 0.5
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(rec)) + rec.tobytes())


def write_llff_tree(root: Path, dev) -> dict:
    """An LLFF scene on disk, in the layout of LLFF's fern: a COLMAP model of
    LLFF_VIEWS views of one 4032x3024 PINHOLE camera on a forward-facing
    5 x 4 grid, images_8/ (504x378 PNGs) with poses_bounds.npy, language
    features with PROTOTYPES segments, aligned depths and the MVS cloud
    3_views/dense/fused.ply of ALIVE points. Images, depths and segments are
    rendered on ``dev`` from a hidden cloud (as data/synthetic.py does),
    the fused cloud is that cloud jittered and grey."""
    from PIL import Image

    from sdpgs_torch.config import RasterizeConfig
    from sdpgs_torch.core.camera import Camera, focal2fov
    from sdpgs_torch.core.gaussians import create_from_points
    from sdpgs_torch.data.ply import write_pointcloud_ply
    from sdpgs_torch.render import render

    rng = np.random.default_rng(LLFF_SEED)
    W, H = LLFF_FULL
    w, h = W // LLFF_DIVIDER, H // LLFF_DIVIDER
    fx, fy = W / (2 * math.tan(0.45)), H / (2 * math.tan(0.35))
    fovx, fovy = focal2fov(fx, W), focal2fov(fy, H)
    pts = (rng.normal(size=(ALIVE, 3)) + np.array([0.0, 0.0, 4.0])).astype(np.float32)
    cols = rng.uniform(size=(ALIVE, 3)).astype(np.float32)
    protos = rng.normal(size=(PROTOTYPES, 3)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=-1, keepdims=True)
    ang = np.arctan2(pts[:, 1], pts[:, 0])
    seg_of_pt = np.clip(((ang + np.pi) / (2 * np.pi) * PROTOTYPES).astype(int), 0,
                        PROTOTYPES - 1)
    gt = create_from_points(pts, cols, ALIVE, init_scale=np.full(ALIVE, 2e-4),
                            initial_opacity=0.9, features=protos[seg_of_pt], device=dev)
    names = [f"image{i:03d}.png" for i in range(LLFF_VIEWS)]
    tvecs = [np.array([dx, dy, 0.0]) for dy in np.linspace(-0.15, 0.15, 4)
             for dx in np.linspace(-0.3, 0.3, 5)]
    dirs = {k: root / k for k in (f"images_{LLFF_DIVIDER}", "language_features_GGrouping_dim3",
                                  "depth_adjust_maps_stereo")}
    for d in dirs.values():
        d.mkdir(parents=True)
    poses_bounds = np.zeros((LLFF_VIEWS, 17))
    for name, t, pb in zip(names, tvecs, poses_bounds):
        cam = Camera.create(R=np.eye(3), T=t, fovx=fovx, fovy=fovy, width=w, height=h,
                            device="cpu")
        with torch.no_grad():
            out = render(cam, gt, RasterizeConfig(), torch.zeros(3, device=dev), 0, device=dev)
        stem = name.split(".")[0]
        rgb = (np.clip(out.color.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        Image.fromarray(rgb).save(dirs[f"images_{LLFF_DIVIDER}"] / name)
        np.save(dirs["depth_adjust_maps_stereo"] / f"depth_{stem}.npy", out.depth.cpu().numpy())
        seg = np.argmax(out.feature.cpu().numpy() @ protos.T, axis=-1)
        features = dirs["language_features_GGrouping_dim3"]
        np.save(features / f"{stem}_s.npy", seg.astype(np.int64))
        np.save(features / f"{stem}_fdim3.npy", protos[np.unique(seg)])
        # LLFF's pose layout: the c2w columns (y, x, -z, centre) and (H, W, focal)
        c2w = np.concatenate([np.eye(3), -t[:, None]], 1)
        pb[:15] = np.concatenate([c2w[:, [1, 0]], -c2w[:, 2:3], c2w[:, 3:],
                                  np.array([[H], [W], [fx]])], 1).reshape(-1)
        pb[15:] = LLFF_BOUNDS
    np.save(root / "poses_bounds.npy", poses_bounds)
    sparse = rng.choice(ALIVE, LLFF_SPARSE, replace=False)
    write_colmap_model(root / "sparse" / "0", W, H, fx, fy, names, tvecs, pts[sparse],
                       (cols[sparse] * 255).astype(np.uint8))
    (root / "3_views" / "dense").mkdir(parents=True)
    write_pointcloud_ply(root / "3_views" / "dense" / "fused.ply",
                         pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05,
                         np.full((ALIVE, 3), 0.5, np.float32))
    return dict(width=w, height=h, fovx=fovx, fovy=fovy)


def cli_argv(tree: Path, out: Path, dpt: Path) -> list:
    """The train CLI's command line: TrainConfig()'s defaults but for the
    schedule, compressed to CLI_ITERATIONS on the per-field flags."""
    argv = ["-s", str(tree), "-m", str(out), "-r", str(LLFF_DIVIDER), "--nviews", "3",
            "--dpt_weights", str(dpt), "--iterations", str(CLI_ITERATIONS),
            "--test_iterations", str(CLI_LOG_EVERY), str(CLI_ITERATIONS),
            "--checkpoint_iterations", str(CLI_ITERATIONS)]
    for k, v in CLI_OPTIM.items():
        argv += [f"--{k}", str(v)]
    return argv


def check_scene_card_vs_cpu(tree: Path, dev) -> dict:
    """Scene(cfg) from the tree on the card and on the CPU: the same host
    arrays, cameras on the host, and Gaussians within SCENE_TOL of each
    field's largest value (the init scales come from the k-NN on each)."""
    from sdpgs_torch.cli.train_cli import build_parser, config_from_args
    from sdpgs_torch.core.gaussians import BUFFER_FIELDS, PARAM_FIELDS
    from sdpgs_torch.data.scene import Scene

    cfg = config_from_args(build_parser().parse_args(
        ["-s", str(tree), "-r", str(LLFF_DIVIDER), "--nviews", "3"]))
    scenes, secs = {}, {}
    for d in (dev, torch.device("cpu")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scenes[d.type] = Scene(cfg, device=d)
        torch.cuda.synchronize()
        secs[d.type] = time.perf_counter() - t0
    card, cpu = scenes[dev.type], scenes["cpu"]
    same = np.array_equal(card.prototypes, cpu.prototypes) and np.array_equal(
        card.pseudo_poses, cpu.pseudo_poses) and card.cameras_extent == cpu.cameras_extent
    for a, b in zip(card.train_cameras + card.test_cameras, cpu.train_cameras + cpu.test_cameras):
        for k in ("image", "seg_map", "point_feature", "feature_dict", "depth_mono", "bounds"):
            x, y = getattr(a, k), getattr(b, k)
            same = same and (x is None and y is None or np.array_equal(x, y))
        same = same and a.camera.view.device.type == "cpu" and bool(
            torch.equal(a.camera.full_proj, b.camera.full_proj))
    g_card, g_cpu = card.gaussians.to_numpy(), cpu.gaussians.to_numpy()
    errs = {k: float(np.abs(g_card[k] - g_cpu[k]).max() / max(np.abs(g_cpu[k]).max(), 1e-30))
            for k in PARAM_FIELDS + BUFFER_FIELDS}
    n_train, n_test = len(card.train_cameras), len(card.test_cameras)
    alive, slots = card.gaussians.num_alive(), card.gaussians.capacity
    c0 = card.train_cameras[0]
    print(f"scene from disk ({LLFF_VIEWS} views, COLMAP {LLFF_FULL[0]}x{LLFF_FULL[1]}, "
          f"images_{LLFF_DIVIDER} at {c0.width}x{c0.height}): {n_train} train views "
          f"{[c.image_name for c in card.train_cameras]}, {n_test} test, {alive} alive of "
          f"{slots}, {card.prototypes.shape[0]} prototypes, {len(card.pseudo_poses)} pseudo "
          f"poses; load {secs[dev.type]:.2f} s on the card, {secs['cpu']:.2f} s on the CPU "
          f"({card_line()}); host arrays identical {same}; Gaussians card vs CPU max |diff| / "
          f"field max { {k: f'{v:.1e}' for k, v in errs.items() if v} or 0} "
          f"(limit {SCENE_TOL:g})")
    require(same, "the Scene's host arrays differ between card and CPU loads")
    require(all(v <= SCENE_TOL for v in errs.values()), "the Scene's Gaussians differ")
    require((n_train, n_test, alive, slots) == (3, 3, ALIVE, CAPACITY),
            "the LLFF tree did not load as 3 train and 3 test views with 60,000 of 131,072")
    del scenes, card, cpu
    return dict(load_s=secs[dev.type], cpu_load_s=secs["cpu"])


def cli_phase(dev, raw, work: Path) -> dict:
    """The train CLI on an LLFF tree from disk: write the tree, hold its
    Scene on the card to the CPU's, then ``train_cli.main`` for
    CLI_ITERATIONS (DPT-Hybrid, random weights, seed 0, bf16; densify at
    100 with the k-NN and 200 without; pseudo window 31-90, one K6
    prefetch, the opacity reset at 31; eval at 100 and 300, a save and a
    checkpoint at 300) and a resume for CLI_RESUME more."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.cli import train_cli
    from sdpgs_torch.models.dpt import save_params
    from sdpgs_torch.train import loop
    from sdpgs_torch.train.loop import REPROJ_PREFETCH

    t_phase = time.perf_counter()
    tree, out = work / "llff_fern", work / "llff_fern_out"
    write_llff_tree(tree, dev)
    dpt = work / "dpt_hybrid_seed0.npz"
    save_params(dpt, raw, DPT_ARCH)
    t_written = time.perf_counter() - t_phase
    scene = check_scene_card_vs_cpu(tree, dev)

    argv = cli_argv(tree, out, dpt)
    opt = CLI_OPTIM
    n_pseudo = sum(opt["start_sample_pseudo"] < i < opt["end_sample_pseudo"]
                   for i in range(1, CLI_ITERATIONS + 1))
    n_plain = CLI_ITERATIONS - n_pseudo
    timed = make_timed_trainer()
    plain_trainer, loop.Trainer = loop.Trainer, timed
    try:
        torch.cuda.synchronize()
        _kernels.reset_counts()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv, device=dev)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
        warp_paths = dict(_kernels.WARP_PATH_LAUNCHES)
        # the resumed run rewrites the report with its own (empty) history
        report = json.loads((out / "eval_results.json").read_text())
        _kernels.reset_counts()
        t0 = time.perf_counter()
        resumed = train_cli.main(argv + [
            "--iterations", str(CLI_ITERATIONS + CLI_RESUME),
            "--start_checkpoint", f"{out / 'checkpoints'}:{CLI_ITERATIONS}"], device=dev)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resume_launches = dict(_kernels.LAUNCHES)
    finally:
        loop.Trainer = plain_trainer
    n_eval = len(report) * (len(trainer.scene.train_cameras) + len(trainer.scene.test_cameras))
    it_ms = {k: (statistics.median(v), len(v)) for k, v in trainer.iter_ms.items()}
    l1 = {r["iteration"]: r["train"]["l1"] for r in report}
    files = ["cfg.json", "input.ply", "cameras.json", "eval_results.json",
             f"point_cloud/iteration_{CLI_ITERATIONS}/point_cloud.ply",
             f"checkpoints/ckpt_{CLI_ITERATIONS}.pt",
             f"point_cloud/iteration_{CLI_ITERATIONS + CLI_RESUME}/point_cloud.ply"]
    missing = [f for f in files if not (out / f).exists()]
    wall = time.perf_counter() - t_phase
    card = card_line()
    print(f"train CLI (python -m sdpgs_torch.cli.train_cli {' '.join(argv[4:])}): "
          f"{CLI_ITERATIONS} iterations ({n_plain} plain, {n_pseudo} pseudo) in {main_s:.1f} s "
          f"with the scene and depth-net loads; launches {launches} (K6 by path "
          f"{warp_paths}); plain calls {plain}")
    for e in trainer.events["densify"]:
        print(f"  densify at {e['iteration']}: {e['ms']:.1f} ms ({'with' if e['knn'] else 'without'}"
              f" the k-NN), spawned {e['spawned']}, pruned {e['pruned']}, alive after "
              f"{e['num_alive']}")
    print(f"  eval train L1 by iteration {l1}; test {[r['test']['l1'] for r in report]}; "
          f"resume from {CLI_ITERATIONS}: {CLI_RESUME} iterations in {resume_s:.1f} s, launches "
          f"{resume_launches}; missing files {missing}")
    print(f"  ms per iteration inside train() (median, one synchronize per iteration): plain "
          f"{it_ms['plain'][0]:.3f} (of {it_ms['plain'][1]}), pseudo {it_ms['pseudo'][0]:.3f} (of "
          f"{it_ms['pseudo'][1]}) ({card})")
    print(f"  scene load {scene['load_s']:.2f} s on the card ({card}); phase wall time "
          f"{wall:.1f} s ({card}): tree and weights written in {t_written:.1f} s, the CPU "
          f"scene {scene['cpu_load_s']:.1f} s, CLI {main_s:.1f} s, resume {resume_s:.1f} s")
    require(launches["preprocess"] == launches["binning"] == launches["composite"]
            == n_plain + 2 * n_pseudo + n_eval,
            "CLI: K1-K3 did not launch once per plain iteration, twice per pseudo one and once "
            "per eval view")
    require(launches["preprocess_bwd"] == launches["composite_bwd"] == n_plain + 2 * n_pseudo,
            "CLI: K4-K5 did not launch once per plain iteration and twice per pseudo one")
    require(launches["warp_zbuf"] == -(-n_pseudo // REPROJ_PREFETCH) >= 1,
            "CLI: K6 did not launch once per prefetch")
    require(warp_paths == {"cluster": launches["warp_zbuf"], "general": 0},
            f"CLI: K6's prefetch did not take the cluster path: {warp_paths}")
    require(launches["sort"] == launches["launch_floor"] == 0 and not any(plain.values()),
            "CLI: K7/K8 or a plain version ran")
    require([e["knn"] for e in trainer.events["densify"]] == [True, False],
            "CLI: not one densify event with the k-NN and one without")
    require(sorted(l1) == [CLI_LOG_EVERY, CLI_ITERATIONS]
            and l1[CLI_ITERATIONS] < l1[CLI_LOG_EVERY],
            f"CLI: the train L1 did not fall from {CLI_LOG_EVERY} to {CLI_ITERATIONS}")
    require(not missing, f"CLI: the model directory lacks {missing}")
    require(resumed.state.step == CLI_ITERATIONS + CLI_RESUME
            and resume_launches["preprocess_bwd"] == CLI_RESUME,
            f"CLI: the resume did not run iterations {CLI_ITERATIONS + 1}-"
            f"{CLI_ITERATIONS + CLI_RESUME}")
    return dict(launches=launches, it_ms=it_ms, wall=wall, load_s=scene["load_s"])


def random_lpips_npz(path: Path, seed: int = 0) -> None:
    """Random VGG16 + LPIPS heads in tools/convert_lpips.py's .npz layout
    (the layout tests/test_lpips.py writes; about 59 MB)."""
    from sdpgs_torch.models.lpips import VGG16_STAGES

    rng = np.random.default_rng(seed)
    params, in_ch = {}, 3
    for s, (ch, n_convs) in enumerate(VGG16_STAGES):
        for i in range(n_convs):
            params[f"conv{s}_{i}_w"] = rng.normal(0, 0.05, (ch, in_ch, 3, 3)).astype(np.float32)
            params[f"conv{s}_{i}_b"] = rng.normal(0, 0.01, (ch,)).astype(np.float32)
            in_ch = ch
        params[f"lin{s}_w"] = rng.uniform(0, 0.1, (1, ch, 1, 1)).astype(np.float32)
    np.savez(path, **params)


def png_psnr(a: Path, b: Path) -> float:
    from PIL import Image

    x, y = (np.asarray(Image.open(f), np.float64) / 255.0 for f in (a, b))
    return 10.0 * math.log10(1.0 / max(float(((x - y) ** 2).mean()), 1e-20))


def render_cli_check(dev, model: Path, scene, rscene, bg, load_s: float, timer) -> dict:
    """``render_cli.main -m <model> --spiral`` on the card: K1-K3 once per
    train, test and spiral view and nothing else; two test views against
    ``render_set`` on the CPU from the same PLY; no spiral frame black.
    ``load_s``: what the CLI's Scene and RenderScene loads took when built
    the same way beforehand."""
    from PIL import Image

    from sdpgs_torch import _kernels
    from sdpgs_torch.cli import render_cli
    from sdpgs_torch.data.ply import load_gaussians_ply
    from sdpgs_torch.render import render

    cfg, it = scene.cfg, rscene.loaded_iter
    torch.cuda.synchronize()
    _kernels.reset_counts()
    with timer.section("render CLI", bg):
        t0 = time.perf_counter()
        render_cli.main(["-m", str(model), "--spiral"], device=dev)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
    spiral = sorted((model / "video_spiral" / f"ours_{it}").glob("*.png"))
    n_views = len(scene.train_cameras) + len(scene.test_cameras) + len(spiral)
    means = [float(np.asarray(Image.open(f)).mean()) / 255.0 for f in spiral]
    # the same views rendered bare: no PNG or NPY writes
    cams = [c.camera for c in scene.train_cameras + scene.test_cameras]
    cams += [c.camera for c in rscene.render_cameras]
    with torch.no_grad():
        render(cams[0], scene.gaussians, cfg.raster, bg, cfg.model.sh_degree, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for cam in cams:
            render(cam, scene.gaussians, cfg.raster, bg, cfg.model.sh_degree, device=dev)
        torch.cuda.synchronize()
        bare_s = time.perf_counter() - t0
    # two test views through render_set on the CPU, from the same PLY
    ply = model / "point_cloud" / f"iteration_{it}" / "point_cloud.ply"
    g_cpu = load_gaussians_ply(ply, cfg.model.capacity, cfg.model.sh_degree, device="cpu")
    render_cli.render_set(model / "cpu_check", "test", it, scene.test_cameras[:2], g_cpu,
                          cfg.raster, bg.cpu(), cfg.model.sh_degree, device="cpu")
    psnrs = [png_psnr(model / "test" / f"ours_{it}" / "renders" / f"{i:05d}.png",
                      model / "cpu_check" / "test" / f"ours_{it}" / "renders" / f"{i:05d}.png")
             for i in range(2)]
    card = card_line()
    print(f"render CLI (python -m sdpgs_torch.cli.render_cli -m <model> --spiral, iteration "
          f"{it}): {len(scene.train_cameras)} train + {len(scene.test_cameras)} test + "
          f"{len(spiral)} spiral views in {cli_s:.2f} s with its Scene loads and PNG/NPY writes "
          f"({cli_s / n_views * 1e3:.1f} ms per view; the loads take {load_s:.2f} s, so "
          f"{(cli_s - load_s) / n_views * 1e3:.1f} ms per view render and write); the same views "
          f"bare "
          f"{bare_s / len(cams) * 1e3:.2f} ms per view ({card}); launches {launches}; plain "
          f"calls {plain}; two test views card vs render_set on the CPU "
          f"{[f'{p:.1f}' for p in psnrs]} dB; spiral frame means {min(means):.4f}-"
          f"{max(means):.4f}")
    require(all(launches[k] == n_views for k in _kernels.FORWARD_KERNELS),
            f"render CLI: K1-K3 did not launch once per view ({n_views})")
    require(not any(launches[k] for k in _kernels.KERNELS if k not in _kernels.FORWARD_KERNELS)
            and not any(plain.values()), "render CLI: another kernel or a plain version ran")
    require(len(spiral) == 180 and len(rscene.render_cameras) == 180,
            "render CLI: not 180 spiral frames")
    require(min(psnrs) >= 50.0, f"render CLI: a test view differs from the CPU's: {psnrs} dB")
    require(min(means) > 1e-3, "render CLI: a spiral frame is black")
    return dict(cli_s=cli_s, n_views=n_views, bare_ms=bare_s / len(cams) * 1e3,
                write_ms=(cli_s - load_s) / n_views * 1e3, launches=launches)


def metrics_cli_check(dev, model: Path, work: Path, it: int, timer) -> dict:
    """``metrics_cli.main -m <model> --lpips_weights <npz>`` on the card
    (a random full-width VGG16), then LPIPS on two 504x378 test pairs and
    PSNR and SSIM on every test view, on the card against the CPU."""
    from sdpgs_torch.cli import metrics_cli
    from sdpgs_torch.eval.metrics import evaluate_dirs, load_image
    from sdpgs_torch.models.lpips import LPIPS

    npz = work / "lpips_vgg16_random.npz"
    random_lpips_npz(npz)
    with timer.section("metrics CLI", torch.zeros(1, device=dev)):
        t0 = time.perf_counter()
        metrics_cli.main(["-m", str(model), "--lpips_weights", str(npz)], device=dev)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    results = json.loads((model / "results.json").read_text())[f"ours_{it}"]
    base = model / "test" / f"ours_{it}"
    names = sorted(p.name for p in (base / "renders").iterdir())[:2]
    nets = {d: LPIPS.load(npz, device=d) for d in (dev, torch.device("cpu"))}
    lp_err, pairs = 0.0, []
    for name in names:
        img, gt = (torch.from_numpy(load_image(base / d / name)) for d in ("renders", "gt"))
        card = float(nets[dev](img.to(dev), gt.to(dev)))
        cpu = float(nets[torch.device("cpu")](img, gt))
        lp_err = max(lp_err, abs(card - cpu) / max(abs(cpu), 1e-30))
        pairs.append((img.to(dev), gt.to(dev), card, cpu))
    img, gt = pairs[0][:2]
    lpips_ms = cuda_ms(lambda: nets[dev](img, gt))
    shape = tuple(img.shape)
    on_card = evaluate_dirs(base / "renders", base / "gt", device=dev)["per_view"]
    on_cpu = evaluate_dirs(base / "renders", base / "gt", device="cpu")["per_view"]
    # PSNR relative; SSIM, a score in [-1, 1] that is a mean of terms of
    # both signs, absolute
    psnr_err = max(abs(on_card["PSNR"][n] - v) / v for n, v in on_cpu["PSNR"].items())
    ssim_err = max(abs(on_card["SSIM"][n] - v) for n, v in on_cpu["SSIM"].items())
    print(f"metrics CLI (python -m sdpgs_torch.cli.metrics_cli -m <model> --lpips_weights "
          f"<random VGG16 .npz>): {cli_s:.2f} s for {len(list((base / 'renders').iterdir()))} "
          f"test views with the .npz load; {results}; LPIPS per {shape[2]}x{shape[1]} pair "
          f"{lpips_ms:.3f} ms (CUDA events, median of {REPS}; {card_line()}); card vs CPU: "
          f"LPIPS {[f'{c:.6f} / {p:.6f}' for _, _, c, p in pairs]} max rel {lp_err:.2e} (limit "
          f"{LPIPS_RTOL:g}), PSNR max rel {psnr_err:.2e}, SSIM max abs {ssim_err:.2e} (limit "
          f"{METRIC_TOL:g} each); "
          f"cudnn.deterministic {torch.backends.cudnn.deterministic}")
    require(results["LPIPS"] is not None and results["AVGE"] is not None,
            "metrics CLI: results.json has no LPIPS")
    require(lp_err <= LPIPS_RTOL, f"LPIPS card vs CPU {lp_err:.2e}")
    require(psnr_err <= METRIC_TOL and ssim_err <= METRIC_TOL,
            f"PSNR/SSIM card vs CPU {psnr_err:.2e}, {ssim_err:.2e}")
    return dict(cli_s=cli_s, lpips_ms=lpips_ms)


def depth_prior_inputs(tree: Path, scene, rng) -> dict:
    """Mono PFMs and sparse stereo depths whose alignment is known, for the
    train views: in segment s the stereo depth is a_s * mono + b_s, where
    mono is the tree's rendered depth D through (D - b_s) / a_s, written
    inverted (C - mono) as a mono net's disparity-like output; the stereo
    samples are D at the pixels nearest the COLMAP points' projections, a
    tenth of them pushed 3-6 further as outliers. conclude re-inverts with
    max - mono, which shifts mono by its minimum m: the expected line is
    (a_s, b_s + a_s * m)."""
    from sdpgs_torch import native
    from sdpgs_torch.data.readers import write_pfm

    xyz = native.read_points3d(tree / "sparse" / "0" / "points3D.bin")[0]
    ab = np.stack([rng.uniform(0.5, 2.0, PROTOTYPES), rng.uniform(-1.0, 1.0, PROTOTYPES)], 1)
    for d in ("depth_maps_anything", "stereo_depth"):
        (tree / d).mkdir(exist_ok=True)
    views = {}
    for cam in scene.train_cameras:
        stem = cam.image_name.split(".")[0]
        D = np.load(tree / "depth_adjust_maps_stereo" / f"depth_{stem}.npy").astype(np.float64)
        seg = np.load(tree / "language_features_GGrouping_dim3" / f"{stem}_s.npy")
        seg = (seg[0] if seg.ndim == 3 else seg).astype(np.int32)
        mono = ((D - ab[seg, 1]) / ab[seg, 0]).astype(np.float32)
        write_pfm(tree / "depth_maps_anything" / f"depth_{stem}.pfm", 10.0 - mono)
        K = cam.intrinsics().astype(np.float64)
        pc = xyz + cam.T                             # identity rotations: world + T
        front = pc[:, 2] > 0
        u = np.rint(K[0, 0] * pc[front, 0] / pc[front, 2] + (cam.width - 1) / 2).astype(int)
        v = np.rint(K[1, 1] * pc[front, 1] / pc[front, 2] + (cam.height - 1) / 2).astype(int)
        inside = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        u, v = u[inside], v[inside]
        stereo = np.zeros(D.shape, np.float32)
        stereo[v, u] = D[v, u]
        hit = np.flatnonzero(stereo.reshape(-1) > 0)
        bad = rng.choice(hit, len(hit) // 10, replace=False)
        stereo.reshape(-1)[bad] += rng.uniform(3.0, 6.0, len(bad)).astype(np.float32)
        np.save(tree / "stereo_depth" / f"depth_{stem}.npy", stereo)
        m = float(np.float32(10.0) - (10.0 - mono).max())   # conclude's shift, in f32
        views[stem] = dict(mono=mono, stereo=stereo, seg=seg, shift=m, K=K, R=cam.R, T=cam.T,
                           image=cam.image.transpose(1, 2, 0).astype(np.float32))
    return dict(views=views, ab=ab)


def depth_prior_check(tree: Path, scene, timer) -> dict:
    """conclude_depth_for_scene over the train views: every segment fitted
    from >= 20 samples must come back to its known line; the native library
    must have run, equal to the Python versions."""
    from sdpgs_torch import native
    from sdpgs_torch.data.ply import read_pointcloud_ply
    from sdpgs_torch.pipelines import depth_align, fusion

    inputs = depth_prior_inputs(tree, scene, np.random.default_rng(9))
    views, ab = inputs["views"], inputs["ab"]
    with timer.section("conclude"):
        t0 = time.perf_counter()
        depth_align.conclude_depth_for_scene(tree, seg_dir="language_features_GGrouping_dim3",
                                             out_dir="depth_adjust_anything", diagnostics=True)
        conclude_s = time.perf_counter() - t0
    worst, fitted, inherited = 0.0, 0, 0
    for stem, v in views.items():
        adjusted = np.load(tree / "depth_adjust_anything" / f"depth_{stem}.npy")
        require(adjusted.shape == v["mono"].shape and np.isfinite(adjusted).all(),
                f"conclude: {stem}'s adjusted depth misshapen or not finite")
        with np.load(tree / "depth_adjust_anything" / f"depth_{stem}_diag.npz") as diag:
            line_of = {int(sid): diag[f"line{i}_ab"] for i in range(int(diag["n_lines"]))
                       for sid in diag[f"line{i}_segments"]}
        counts = np.bincount(v["seg"][v["stereo"] > 0], minlength=PROTOTYPES)
        for sid, (a, b) in line_of.items():
            if counts[sid] < 20:
                inherited += 1
                continue
            fitted += 1
            a_s, b_s = ab[sid, 0], ab[sid, 1] + ab[sid, 0] * v["shift"]
            worst = max(worst, abs(a - a_s) / a_s, abs(b - b_s) / max(abs(b_s), 1.0))
    labels_n, n_n = native.connected_components(views[next(iter(views))]["seg"] == 0)
    labels_p, n_p = depth_align._connected_components(views[next(iter(views))]["seg"] == 0)
    pts, cols, _ = read_pointcloud_ply(tree / "3_views" / "dense" / "fused.ply")
    vn = native.voxel_downsample(pts, cols, 0.05)
    vp = fusion.voxel_downsample(pts, cols, 0.05)
    voxel_err = max(float(np.abs(np.sort(a, 0) - np.sort(b, 0)).max()) for a, b in zip(vn, vp))
    print(f"depth prior (conclude_depth_for_scene, {len(views)} train views at "
          f"{views[next(iter(views))]['mono'].shape[::-1]}): {conclude_s / len(views):.3f} s per "
          f"view on the host; {fitted} segment lines fitted (max rel error {worst:.2e}, limit "
          f"{LINE_TOL:g}), {inherited} inherited; native library {native.available()} "
          f"({native.BUILD_LOG.strip()}): connected components {n_n} = Python {n_p}, labels "
          f"equal {np.array_equal(labels_n, labels_p)}; voxel downsample of {len(pts)} points "
          f"to {len(vn[0])} (Python {len(vp[0])}), max |diff| {voxel_err:.1e}")
    require(native.available(), f"the native library did not build: {native.BUILD_LOG}")
    require(fitted >= 8 and worst <= LINE_TOL, f"conclude: lines off by {worst:.2e}")
    require(n_n == n_p and np.array_equal(labels_n, labels_p),
            "native connected components differ from the Python version")
    require(len(vn[0]) == len(vp[0]) and voxel_err <= 1e-5,
            "native voxel downsample differs from the Python version")
    return dict(views=views, conclude_s=conclude_s / len(views))


def fusion_check(dev, views: dict, tree: Path, timer) -> dict:
    """fuse_depths on the card and on the CPU: each pair's masks equal but
    at pixels within 1e-5 relative of a threshold, the points to 1e-4; the
    cloud through fused.ply and back."""
    from sdpgs_torch.data.ply import read_pointcloud_ply, write_pointcloud_ply
    from sdpgs_torch.pipelines import fusion
    from sdpgs_torch.pipelines.depth_align import compute_scale_and_shift

    vs = list(views.values())
    args = ([v["mono"] for v in vs], [v["stereo"] for v in vs], [v["K"] for v in vs],
            [v["R"].T for v in vs], [np.asarray(v["T"], np.float64) for v in vs])
    aligned = []
    for mono, sparse in zip(args[0], args[1]):
        a, b = compute_scale_and_shift(mono[sparse > 0], sparse[sparse > 0])
        aligned.append(np.asarray(a * mono + b, np.float32))
    flips, away, pair_ms = 0, 0, []
    for r in range(len(vs)):
        for s in range(len(vs)):
            if r == s:
                continue
            cams = [(args[2][i], args[3][i], args[4][i]) for i in (r, s)]
            out = {}
            for d in (dev, torch.device("cpu")):
                dr, ds = (torch.as_tensor(aligned[i], device=d) for i in (r, s))
                out[d.type] = [t.cpu().numpy() for t in fusion.check_geometric_consistency(
                    dr, *cams[0], ds, *cams[1])]
                rep = fusion.reproject_with_depth(dr, *cams[0], ds, *cams[1])
                out[d.type + "_rep"] = [t.cpu().numpy() for t in rep]
            dr, ds = (torch.as_tensor(aligned[i], device=dev) for i in (r, s))
            pair_ms.append(cuda_ms(lambda: fusion.check_geometric_consistency(
                dr, *cams[0], ds, *cams[1])))
            H, W = aligned[r].shape
            ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
            rep = out["cpu_rep"]
            dist = np.sqrt((rep[1] - xs) ** 2 + (rep[2] - ys) ** 2)
            rel = np.abs(rep[0] - aligned[r]) / np.maximum(aligned[r], 1e-8)
            differ = out[dev.type][0] != out["cpu"][0]
            at_thresh = (np.abs(dist - 5.0) <= 5e-5) | (np.abs(rel - 0.2) <= 2e-6)
            flips += int(differ.sum())
            away += int((differ & ~at_thresh).sum())
    with timer.section("fusion", torch.zeros(1, device=dev)):
        t0 = time.perf_counter()
        pts, cols = fusion.fuse_depths(*args, colors=[v["image"] for v in vs], device=dev)
        fuse_s = time.perf_counter() - t0
    cpu_pts, cpu_cols = fusion.fuse_depths(*args, colors=[v["image"] for v in vs], device="cpu")
    same_n = pts.shape == cpu_pts.shape
    pt_err = float(np.abs(pts - cpu_pts).max() / np.abs(cpu_pts).max()) if same_n else math.inf
    ply = tree / "3_views" / "dense" / "fused_prior.ply"
    write_pointcloud_ply(ply, pts, cols)
    back, back_cols, _ = read_pointcloud_ply(ply)
    print(f"fusion (fuse_depths, {len(vs)} views, {len(pair_ms)} (ref, src) pairs at "
          f"{W}x{H}): the consistency check {statistics.median(pair_ms):.3f} ms per pair on the "
          f"card (CUDA events, median of {REPS}, {card_line()}); fuse_depths {fuse_s:.3f} s "
          f"with the host back-projection; {len(pts)} points (CPU {len(cpu_pts)}), max |diff| / "
          f"max |p| {pt_err:.1e} (limit {POINT_TOL:g}); masks card vs CPU differ at {flips} "
          f"pixels, {away} of them away from a threshold; fused.ply round trip "
          f"{np.array_equal(back, pts)}")
    require(away == 0, f"fusion: {away} mask pixels differ away from a threshold")
    require(len(pts) > len(vs) * H * W // 10 and (pt_err <= POINT_TOL if flips == 0
                                   else abs(len(pts) - len(cpu_pts)) <= flips),
            f"fusion: the card's points differ from the CPU's ({pt_err:.2e})")
    require(np.array_equal(back, pts) and np.abs(back_cols - cols).max() <= 1 / 255 + 1e-6,
            "fusion: fused.ply did not read back")
    return dict(pair_ms=statistics.median(pair_ms), fuse_s=fuse_s)


def viewer_check(dev, scene, bg, timer) -> dict:
    """GuiServer on a loopback port: a client sends SIBR messages for a
    train camera (transposed view matrix, y and z columns negated); the
    server renders each on the card and replies; the bytes must equal the
    uint8 frame of ``render`` for the camera built directly."""
    import socket
    import threading

    from sdpgs_torch.core.camera import Camera
    from sdpgs_torch.render import render
    from sdpgs_torch.viewer import GuiServer

    cfg, cam = scene.cfg, scene.train_cameras[0]
    W, H = cam.width, cam.height
    vm = cam.camera.view.numpy().T.copy()
    vm[:, 1] *= -1
    vm[:, 2] *= -1
    msg = json.dumps({"resolution_x": W, "resolution_y": H, "train": False, "keep_alive": True,
                      "scaling_modifier": 1.0, "fov_x": float(cam.fovx),
                      "fov_y": float(cam.fovy),
                      "z_near": 0.01, "z_far": 100.0, "view_matrix": vm.flatten().tolist(),
                      "view_projection_matrix": np.eye(4).flatten().tolist()}).encode()
    frames = VIEWER_FRAMES
    got: list = []

    def client(port):
        with socket.create_connection(("127.0.0.1", port), timeout=60) as c:
            for _ in range(frames):
                c.sendall(len(msg).to_bytes(4, "little") + msg)
                buf = b""
                while len(buf) < W * H * 3 + 4:
                    chunk = c.recv(W * H * 3 + 4 - len(buf))
                    if not chunk:
                        return
                    buf += chunk
                n = int.from_bytes(buf[-4:], "little")
                verify = b""
                while len(verify) < n:
                    verify += c.recv(n - len(verify))
                got.append((buf[:-4], verify.decode()))

    server = GuiServer(port=0)
    t = threading.Thread(target=client, args=(server.listener.getsockname()[1],), daemon=True)
    t.start()
    times = []
    try:
        deadline = time.monotonic() + 60
        while not server.try_connect():
            require(time.monotonic() < deadline, "viewer: no client connected")
            time.sleep(0.01)
        with timer.section("viewer", bg):
            for _ in range(frames):
                t0 = time.perf_counter()
                rcam, _ = server.receive()
                with torch.no_grad():
                    img = render(rcam, scene.gaussians, cfg.raster, bg, cfg.model.sh_degree,
                                 device=dev).color
                server.send(img.cpu().numpy(), "llff_fern")
                times.append((time.perf_counter() - t0) * 1e3)
    finally:
        t.join(timeout=60)
        server.drop()
        server.listener.close()
    direct = Camera.create(R=cam.R, T=cam.T, fovx=cam.fovx, fovy=cam.fovy, width=W, height=H,
                           device="cpu")
    with torch.no_grad():
        ref = render(direct, scene.gaussians, cfg.raster, bg, cfg.model.sh_degree,
                     device=dev).color.cpu().numpy()
    ref_bytes = (np.clip(ref, 0, 1) * 255).astype(np.uint8).tobytes()
    print(f"viewer (GuiServer, SIBR protocol over loopback, {W}x{H}): {len(got)} frames, "
          f"{statistics.median(times):.2f} ms per frame (receive, render on the card, reply; "
          f"median; {card_line()}); bytes equal to render of the camera built directly "
          f"{all(b == ref_bytes for b, _ in got)}; camera on {rcam.view.device}")
    require(not t.is_alive() and len(got) == frames, "viewer: the client did not get every frame")
    require(all(b == ref_bytes and v == "llff_fern" for b, v in got),
            "viewer: the frame differs from render of the camera built directly")
    return dict(frame_ms=statistics.median(times))


def profiling_check(dev, scene, bg, work: Path) -> None:
    """``utils/profiling.trace`` around the renders of the train views: a
    Chrome trace that names K1-K3's kernels. The counts are printed
    beside the launches (the profiler may miss launches just after it
    starts: one chip run's trace of a single render lacked K1)."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.render import render
    from sdpgs_torch.utils.profiling import trace

    cfg = scene.cfg
    torch.cuda.synchronize()
    _kernels.reset_counts()
    with trace(work / "profile") as path:
        with torch.no_grad():
            for cam in scene.train_cameras:
                render(cam.camera, scene.gaussians, cfg.raster, bg, cfg.model.sh_degree,
                       device=dev)
        torch.cuda.synchronize()
    launched = {k: _kernels.LAUNCHES[k] for k in _kernels.FORWARD_KERNELS}
    text = path.read_text() if path.exists() else ""
    names = ("preprocess_fwd_kernel", "cover_words_kernel", "bin_table_kernel",
             "composite_fwd_kernel")
    events = {}
    if text:
        for e in json.loads(text)["traceEvents"]:
            for n in names:
                events[n] = events.get(n, 0) + (n in str(e.get("name", "")))
    print(f"profiling: trace {path.name} ({len(text)} bytes) over {len(scene.train_cameras)} "
          f"renders (launches {launched}): kernel events by name {events}")
    require(all(events.get(n, 0) > 0 for n in names),
            f"profiling: the trace lacks a kernel: {events}")


class Sections:
    """Wall milliseconds of each check of the evaluate phase, waiting for
    the card where the section is handed a tensor on it."""

    def __init__(self):
        self.ms: dict = {}

    @contextlib.contextmanager
    def section(self, name: str, on=None):
        t0 = time.perf_counter()
        yield
        if on is not None and on.is_cuda:
            torch.cuda.synchronize(on.device)
        self.ms[name] = (time.perf_counter() - t0) * 1e3

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.1f}ms" for k, v in sorted(self.ms.items()))


def evaluate_phase(dev, tree: Path, model: Path, work: Path) -> dict:
    """Evaluate and prepare, on the train CLI's tree and model directory:
    the render CLI, the metrics CLI (LPIPS-VGG16), the depth prior's
    conclude, fusion, the viewer and a profiler trace."""
    from sdpgs_torch.config import load_config
    from sdpgs_torch.data.scene import RenderScene, Scene

    t_phase = time.perf_counter()
    cfg = load_config(model / "cfg.json")
    t0 = time.perf_counter()
    rscene = RenderScene(cfg, device=dev)
    scene = Scene(cfg, load_iteration=rscene.loaded_iter, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0, device=dev)
    timer = Sections()
    rendered = render_cli_check(dev, model, scene, rscene, bg, load_s, timer)
    metrics = metrics_cli_check(dev, model, work, rscene.loaded_iter, timer)
    prior = depth_prior_check(tree, scene, timer)
    fused = fusion_check(dev, prior["views"], tree, timer)
    viewer = viewer_check(dev, scene, bg, timer)
    profiling_check(dev, scene, bg, work)
    wall = time.perf_counter() - t_phase
    print(f"evaluate and prepare: {wall:.1f} s ({card_line()}); sections: {timer.report()}")
    return dict(rendered=rendered, metrics=metrics, prior=prior, fused=fused, viewer=viewer,
                wall=wall)


def protocol_phase(dev, work: Path) -> dict:
    """ablation_run's ``full`` and ``nomono`` arms at the protocol shape
    (504x378, capacity 131,072, 61,440 ground-truth points, 10,000 initial,
    4,096 pseudo poses, 4 test views) to iteration PROTOCOL_ITERATIONS: the
    densify events to 2,000 (with the k-NN before 1,000... as the schedule
    gives), evals at 1,000 and 2,000, and the first pseudo iterations. The
    arms must be bit-identical through 2,000 (every logged loss, PSNR and
    alive count, and both evals), the pseudo branch live after it in both
    (pseudo iterations timed, K6 launched, the arms' logs apart at
    PROTOCOL_ITERATIONS), nothing NaN, and each arm's kernels the kernels."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.cli import ablation_run

    opt = ablation_run.build_cfg(ablation_run.build_raster()).optim
    start = opt.start_sample_pseudo      # 2,000: the arms part after it
    arms = {}
    for arm in PROTOCOL_ARMS:
        _kernels.reset_counts()
        t0 = time.perf_counter()
        res = ablation_run.run_arm(arm, out_root=work / "protocol",
                                   iterations=PROTOCOL_ITERATIONS,
                                   log_every=PROTOCOL_LOG_EVERY, device=dev)
        res["wall"] = time.perf_counter() - t0
        res["launches"], res["plain"] = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
        tm, ev = res["timing"], res["events"]
        print(f"protocol arm {arm}: {PROTOCOL_ITERATIONS} iterations in {res['wall_s']} s of "
              f"training ({res['wall']:.1f} s with the scene); ms per iteration plain "
              f"{tm['plain_iter_ms']:.3f} (of {tm['plain_iters']}), pseudo "
              f"{tm['pseudo_iter_ms']:.3f} (of {tm['pseudo_iters']}); densify events "
              f"{[(e['iteration'], e['knn'], e['num_alive']) for e in ev['densify']]}, the k-NN "
              f"ones {[round(v) for v in tm['knn_event_ms']]} ms; resets {ev['reset']}; "
              f"ladder {ev['ladder']}; evals {[(e['iteration'], e['test']['psnr']) for e in res['eval']]}"
              f"; launches {res['launches']}")
        require(all(math.isfinite(h["loss"]) and math.isfinite(h["psnr"])
                    for h in res["history"]), f"protocol arm {arm}: a NaN in the log")
        require(tm["pseudo_iters"] > 0 and res["launches"]["warp_zbuf"] >= 1,
                f"protocol arm {arm}: the pseudo branch did not run after {start}")
        require(all(res["launches"][k] > 0 for k in _kernels.FORWARD_KERNELS
                    + _kernels.BACKWARD_KERNELS) and not any(res["plain"].values()),
                f"protocol arm {arm}: a kernel did not launch or a plain version ran")
        require(any(e["knn"] for e in ev["densify"]) and any(not e["knn"] for e in ev["densify"]),
                f"protocol arm {arm}: not every kind of densify event fired")
        arms[arm] = res
    a, b = (arms[k] for k in PROTOCOL_ARMS)
    before = lambda r: [h for h in r["history"] if h["iter"] <= start]  # noqa: E731
    evals = lambda r: [e for e in r["eval"] if e["iteration"] <= start]  # noqa: E731
    tests = [i for i in opt.test_iterations if i <= start]
    require(before(a) == before(b) and len(before(a)) == start // PROTOCOL_LOG_EVERY,
            f"protocol: the arms' logs differ through {start}")
    require(evals(a) == evals(b) and [e["iteration"] for e in evals(a)] == tests,
            f"protocol: the arms' evals at {tests} differ")
    require(a["history"][-1] != b["history"][-1],
            "protocol: the arms did not part after the pseudo window opened")
    print(f"  protocol: {PROTOCOL_ARMS} bit-identical through {start} ({len(before(a))} log "
          f"points, evals at {tests}), apart at {PROTOCOL_ITERATIONS}: "
          f"{a['history'][-1]} vs {b['history'][-1]}")
    return {k: dict(wall=v["wall"], timing=v["timing"]) for k, v in arms.items()}


def convergence_phase(dev, work: Path) -> dict:
    """convergence_run on the card: the acceptance rig's scene, the tiny DPT
    (seed 3), conclude, 1,500 iterations of the train CLI; its three checks
    (train PSNR >= 25, a test gain >= 5 dB, a gap <= 6 dB) must pass."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.cli import convergence_run

    _kernels.reset_counts()
    t0 = time.perf_counter()
    rc = convergence_run.main(work / "convergence", device=dev)
    wall = time.perf_counter() - t0
    launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
    evals = json.loads((work / "convergence" / "out" / "eval_results.json").read_text())
    print(f"convergence_run: {convergence_run.ITERATIONS} iterations, {wall:.1f} s; train/test "
          f"PSNR {[(e['iteration'], round(e['train']['psnr'], 2), round(e['test']['psnr'], 2)) for e in evals]}"
          f"; launches {launches}")
    require(rc == 0, f"convergence_run failed its checks: {convergence_run.check(evals)}")
    require(all(launches[k] > 0 for k in _kernels.FORWARD_KERNELS + _kernels.BACKWARD_KERNELS
                + _kernels.WARP_KERNELS) and not any(plain.values()),
            "convergence_run: a kernel did not launch or a plain version ran")
    return dict(wall=wall, final=evals[-1])


def full_eval_phase(dev, work: Path) -> dict:
    """full_eval on the train CLI phase's tree as its one LLFF scene (the
    module's LLFF list holds that scene for the call), for
    FULL_EVAL_ITERATIONS: train_cli, render_cli --skip_train and
    metrics_cli in turn; the test renders and the scores must be on disk."""
    from sdpgs_torch.cli import full_eval

    t0 = time.perf_counter()
    out = work / "full_eval"
    suite, full_eval.LLFF = full_eval.LLFF, ["llff_fern"]
    try:
        full_eval.main(["--llff", str(work), "-o", str(out), "--iterations",
                        str(FULL_EVAL_ITERATIONS)], device=dev)
    finally:
        full_eval.LLFF = suite
    wall = time.perf_counter() - t0
    model = out / "llff" / "llff_fern"
    renders = list((model / "test" / f"ours_{FULL_EVAL_ITERATIONS}" / "renders").glob("*.png"))
    scores = json.loads((model / "results.json").read_text())[f"ours_{FULL_EVAL_ITERATIONS}"]
    print(f"full_eval: 1 LLFF scene, {FULL_EVAL_ITERATIONS} iterations, {len(renders)} test "
          f"renders, scores {scores}; {wall:.1f} s")
    require(renders and math.isfinite(scores["PSNR"]), "full_eval wrote no renders or scores")
    return dict(wall=wall, scores=scores)


def tile_range_phase(main_check: dict) -> dict:
    """K2, K3 and K5 with a tile offset, in one process, on the main
    scene: for each shard count n, the shards of ceil(T / n) tiles from
    t0 = i ceil(T / n). K2's rows, counts and overflow must equal the whole
    table's rows and K2's plain version at the same t0 bit for bit (rows
    past the grid empty); K3's values and final_t must equal the whole
    render's rows bit for bit (rows past the grid 0 and 1), with K3's walk
    gate on every shard; K5's payload gradients, summed over the shards at
    the whole cotangents' rows, must equal the whole K5's within K5_TOL of
    the column max. Then K2, K3 and K5 are timed on the shard from t0 > 0
    of 4 shards."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.ops.rasterize import binning, composite_cuda

    packed_s, order, n_valid, T, tiles_x, K, D = main_check["k2_args"]
    payload, _, _, _, tiles_y, cfg, P = main_check["k3_args"]
    rects = main_check["rects"]
    dev = payload.device
    gen = torch.Generator(device=dev).manual_seed(7)
    npix = cfg.tile ** 2
    with torch.no_grad():
        w_table, w_totals = binning.build_table(packed_s, order, n_valid, T, tiles_x, K, D)
        w_table = w_table.reshape(T, K)
        w_counts = torch.clamp_max(w_totals, K)
        w_out, w_last = composite_cuda.composite_gather_fwd(payload, w_table, w_counts, tiles_x,
                                                            tiles_y, cfg, P)
        g_values = torch.randn((T, npix, 7), generator=gen, device=dev)
        g_final_t = torch.randn((T, npix), generator=gen, device=dev)
        d_whole = composite_cuda.composite_gather_bwd(payload, w_table, rects, w_out.final_t,
                                                      w_last, g_values, g_final_t, tiles_x,
                                                      tiles_y, cfg, P)
        _kernels.reset_counts()
        timed = None
        for n in SHARDS:
            n_local = -(-T // n)
            d_sum = torch.zeros_like(d_whole)
            overflow = 0
            for i in range(n):
                t0 = i * n_local
                inside = max(0, min(n_local, T - t0))
                args2 = (packed_s, order, n_valid, n_local, tiles_x, K, D)
                tab_k, tot_k = binning.build_table(*args2, t0=t0)
                tab_p, tot_p = binning.build_table_plain(*args2, t0=t0)
                tab_k = tab_k.reshape(n_local, K)
                require(torch.equal(tab_k.reshape(-1), tab_p) and torch.equal(tot_k, tot_p),
                        f"K2 at t0 {t0} differs from its plain version")
                require(torch.equal(tab_k[:inside], w_table[t0:t0 + inside])
                        and torch.equal(tot_k[:inside], w_totals[t0:t0 + inside]),
                        f"K2's rows from t0 {t0} differ from the whole table's")
                require(not bool(tot_k[inside:].any()) and bool((tab_k[inside:] == P).all()),
                        f"K2's rows past the grid from t0 {t0} are not empty")
                overflow += int(torch.clamp_min(tot_k - K, 0).sum())
                counts = torch.clamp_max(tot_k, K)
                k3_args = (payload, tab_k, counts, tiles_x, tiles_y, cfg, P)
                out, last = composite_cuda.composite_gather_fwd(*k3_args, t0=t0)
                require(torch.equal(out.values[:inside], w_out.values[t0:t0 + inside])
                        and torch.equal(out.final_t[:inside], w_out.final_t[t0:t0 + inside]),
                        f"K3's rows from t0 {t0} differ from the whole render's")
                require(not bool(out.values[inside:].any())
                        and bool((out.final_t[inside:] == 1.0).all()),
                        f"K3's rows past the grid from t0 {t0} are not 0 and 1")
                if n > 1:
                    check_k3_walk(k3_args, out, last, f"{n} shards, t0 {t0}", t0=t0)
                pad = n_local - inside
                gv = torch.cat([g_values[t0:t0 + inside],
                                torch.zeros((pad, npix, 7), device=dev)])
                gt = torch.cat([g_final_t[t0:t0 + inside], torch.zeros((pad, npix), device=dev)])
                k5_args = (payload, tab_k, rects, out.final_t, last, gv, gt, tiles_x, tiles_y,
                           cfg, P)
                d_sum += composite_cuda.composite_gather_bwd(*k5_args, t0=t0)
                if n == 4 and i == 1:
                    timed = (args2, t0, k3_args, k5_args)
            require(overflow == int(torch.clamp_min(w_totals - K, 0).sum()),
                    f"{n} shards: the shards' overflow does not sum to the whole's")
            rel5, rows_bad, rows_live, err = k5_errors(d_sum, d_whole)
            print(f"  tile range, {n} shard(s) of {n_local} tiles: K2 rows, counts and "
                  f"overflow ({overflow}) equal the whole table's and K2's plain version; K3 "
                  f"values and final_t equal the whole render's; K5 summed over the shards: "
                  f"rows beyond {K5_TOL:g} x column max {rows_bad} of {rows_live} (limit 0), "
                  f"max |diff| {err:.3e}")
            require(rows_bad == 0, f"{n} shards: K5's shard sum differs from the whole K5")
        launches = dict(_kernels.LAUNCHES)
        args2, t0, k3_args, k5_args = timed
        k5_repeats(k5_args, f"t0 {t0}", t0=t0)
        k2_ms = cuda_ms(lambda: binning.build_table(*args2, t0=t0))
        k3_ms = cuda_ms(lambda: composite_cuda.composite_gather_fwd(*k3_args, t0=t0))
        k5_ms = cuda_ms(lambda: composite_cuda.composite_gather_bwd(*k5_args, t0=t0))
    per = {k: launches[k] for k in ("binning", "composite", "composite_bwd")}
    print(f"  tile range gates: launches {per} over {sum(SHARDS)} shards; at t0 {t0} (4 "
          f"shards of {args2[3]} tiles): K2 {k2_ms:.4f} ms, K3 {k3_ms:.4f} ms, K5 "
          f"{k5_ms:.4f} ms")
    return dict(t0=t0, n_local=args2[3], k2_ms=k2_ms, k3_ms=k3_ms, k5_ms=k5_ms, launches=per)


def par_batch(data: dict, views, dev):
    """The ViewBatch of train views ``views`` from the sharded phase's
    inputs (numpy on the host)."""
    from sdpgs_torch.core.camera import Camera
    from sdpgs_torch.train.step import ViewBatch

    t = lambda a: torch.from_numpy(a[list(views)]).to(dev)  # noqa: E731
    return ViewBatch(cameras=[Camera.create(R=np.eye(3), T=data["Ts"][v], fovx=0.9, fovy=0.7,
                                            width=WIDTH, height=HEIGHT, device="cpu")
                              for v in views],
                     image=t(data["image"]), depth_mono=t(data["depth_mono"]),
                     feature=t(data["feature"]), seg_map=t(data["seg_map"]))


def par_view_pairs(n: int) -> list:
    return [((i % TRAIN_CAMS), ((i + 1) % TRAIN_CAMS)) for i in range(n)]


def par_pseudo(data: dict, dev):
    """The sharded phase's pseudo inputs: one pseudo camera, its z-buffer
    from K6 (``prefetch_pseudo_reproj``) on ``dev``."""
    from sdpgs_torch.core.camera import Camera
    from sdpgs_torch.train.loop import prefetch_pseudo_reproj
    from sdpgs_torch.train.step import PseudoInputs

    cams = [Camera.create(R=np.eye(3), T=T, fovx=0.9, fovy=0.7, width=WIDTH, height=HEIGHT,
                          device="cpu") for T in data["Ts"]]
    pcam = Camera.create(R=np.eye(3), T=np.array([0.03, 0.02, 0.0]), fovx=0.9, fovy=0.7,
                         width=WIDTH, height=HEIGHT, device="cpu")
    depths = torch.from_numpy(data["depth_mono"]).to(dev)
    K = cams[0].intrinsics_matrix().to(dev)
    R = torch.stack([c.view[:3, :3] for c in cams]).to(dev)
    t = torch.stack([c.view[:3, 3] for c in cams]).to(dev)
    [(cam, fused, weight)] = prefetch_pseudo_reproj(depths, K, R, t, [pcam])
    return PseudoInputs(camera=cam, train_depths=depths, K=K, R_train=R, t_train=t,
                        R_pseudo=cam.view[:3, :3].to(dev), t_pseudo=cam.view[:3, 3].to(dev),
                        reproj_fused=fused, reproj_weight=weight, train_view_idx=1)


def par_metrics(m) -> dict:
    return {k: float(getattr(m, k)) for k in ("loss", "l1", "psnr")} | {
        k: int(getattr(m, k)) for k in ("overflow", "clipped", "num_alive", "slab")}


def snapshot(state) -> dict:
    """``state.to_numpy()`` copied: on the CPU its arrays would share memory
    with tensors that later steps update in place."""
    import copy

    return copy.deepcopy(state.to_numpy())


def state_digest(arrays: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for part in ("gaussians", "mu", "nu", "stats"):
        for k in sorted(arrays[part]):
            h.update(np.ascontiguousarray(arrays[part][k]).tobytes())
    return h.hexdigest()


def par_steps(state, step, batches, protos, bg, dev, pseudo=None) -> tuple:
    """Run ``step`` on each batch; returns (state, metrics per step, ms
    per step: host clock to a synchronised device)."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    metrics, times = [], []
    for b in batches:
        sync()
        t0 = time.perf_counter()
        args = (state, b, protos, bg, 1.0) + (() if pseudo is None else (pseudo,))
        state, m = step(*args, device=dev)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(par_metrics(m))
    return state, metrics, times


def par_reference(dev, work: Path, rng) -> dict:
    """The single-card side of the sharded phase, on ``dev``: the LLFF-width
    scene, PAR_WARMUP steps at V = PAR_V to the shared start state, then
    PAR_STEPS + PAR_TIMED plain steps and one pseudo step (iteration
    PSEUDO_START, the tiny DPT in f32) from it. The ranks' inputs go to
    ``work``."""
    from sdpgs_torch.config import TrainConfig
    from sdpgs_torch.core.gaussians import Gaussians
    from sdpgs_torch.models.depth_estimator import mono_depth_from_params
    from sdpgs_torch.models.dpt import random_params
    from sdpgs_torch.train.state import TrainState
    from sdpgs_torch.train.step import make_train_step

    trainee, data = train_scene(rng, dev, WIDTH, HEIGHT, CAPACITY, ALIVE)
    host = dict(Ts=data["Ts"], protos=data["protos"].cpu().numpy(),
                **{k: data[k].cpu().numpy() for k in ("image", "depth_mono", "feature",
                                                       "seg_map")})
    protos, bg = data["protos"], torch.zeros(3, device=dev)
    step = make_train_step(TrainConfig(), SH_DEGREE)
    state = TrainState.create(Gaussians.from_numpy(trainee, device=dev), device=dev)
    pairs = par_view_pairs(PAR_WARMUP + PAR_STEPS + PAR_TIMED)
    state, _, _ = par_steps(state, step, [par_batch(host, p, dev) for p in pairs[:PAR_WARMUP]],
                            protos, bg, dev)
    s0 = snapshot(state)
    batches = [par_batch(host, p, dev) for p in pairs[PAR_WARMUP:]]
    ref = {}
    state = TrainState.from_numpy(s0, device=dev)
    state, metrics, times = par_steps(state, step, batches[:PAR_STEPS], protos, bg, dev)
    ref["plain"] = dict(metrics=metrics, state=snapshot(state))
    state, _, times = par_steps(state, step, batches[PAR_STEPS:], protos, bg, dev)
    ref["plain_ms"] = statistics.median(times)
    raw = random_params(PAR_DPT, seed=0)
    mono = mono_depth_from_params(raw, arch=PAR_DPT, device=dev)
    state = TrainState.from_numpy(s0, device=dev)
    state.step = PSEUDO_START
    pstep = make_train_step(TrainConfig(), SH_DEGREE, with_pseudo=True, mono_depth_fn=mono)
    state, metrics, times = par_steps(state, pstep, batches[:1], protos, bg, dev,
                                      pseudo=par_pseudo(host, dev))
    ref["pseudo"] = dict(metrics=metrics, state=snapshot(state))
    ref["pseudo_ms"] = times[0]
    torch.save(dict(s0=s0, host=host, raw=raw), work / "par_inputs.pt")
    return ref


def par_rank_entry(rank: int, world: int, backend: str, work: str, device_type: str,
                   sizes: dict, task: str) -> None:
    """One rank of the sharded phase (a spawned process): takes the parent's
    image size, joins the group, runs ``task`` (``work``: par_rank_work;
    ``certify``: the certification alone; ``bench_shape``: the bench-shape
    certification) and saves its results for the parent, which checks
    them."""
    import datetime
    import os

    import torch.distributed as dist

    globals().update(sizes)
    # the ranks share the machine's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = torch.device(device_type)
    if device_type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    tag = f"{backend}_{device_type}" + ("" if task == "work" else f"_{task}")
    dist.init_process_group(backend, init_method=f"file://{Path(work) / f'{tag}.rdv'}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=PAR_GROUP_TIMEOUT))
    if task == "bench_shape":
        res = par_bench_shape(dev)
    elif task == "certify":
        res = par_certify(world, dev, Path(work))
    else:
        res = par_rank_work(rank, world, dev, Path(work))
    torch.save(res, Path(work) / f"{tag}_rank{rank}.pt")
    dist.destroy_process_group()


def par_rank_work(rank: int, world: int, dev, work: Path) -> dict:
    """On every rank: PAR_STEPS + PAR_TIMED sharded plain steps per mesh of
    ``par_axes(world)`` from the shared start state, counting the kernels'
    launches; one sharded pseudo step (K6 and the DPT replicated); then
    certify_sharded_training(world)."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.config import TrainConfig
    from sdpgs_torch.models.depth_estimator import mono_depth_from_params
    from sdpgs_torch.parallel import (
        gather_train_state,
        make_mesh,
        shard_batch,
        shard_train_state,
        state_shardings,
    )
    from sdpgs_torch.train.state import TrainState
    from sdpgs_torch.train.step import make_train_step

    inp = torch.load(work / "par_inputs.pt", weights_only=False)
    host = inp["host"]
    protos, bg = torch.from_numpy(host["protos"]).to(dev), torch.zeros(3, device=dev)
    pairs = par_view_pairs(PAR_WARMUP + PAR_STEPS + PAR_TIMED)[PAR_WARMUP:]
    out = dict(meshes={})

    def sharded(axes, with_pseudo=False):
        mesh = make_mesh(*axes)
        state = TrainState.from_numpy(inp["s0"], device=dev)
        kw = {}
        if with_pseudo:
            state.step = PSEUDO_START
            kw = dict(with_pseudo=True, mono_depth_fn=mono_depth_from_params(
                inp["raw"], arch=PAR_DPT, device=dev))
        shardings = state_shardings(mesh, state)
        state = shard_train_state(state, mesh)
        step = make_train_step(TrainConfig(), SH_DEGREE, tile_mesh=mesh if axes[2] > 1 else None,
                               out_shardings=shardings, **kw)
        return mesh, state, step

    for axes in par_axes(world):
        mesh, state, step = sharded(axes)
        batches = [shard_batch(par_batch(host, p, dev), mesh) for p in pairs]
        _kernels.reset_counts()
        state, metrics, _ = par_steps(state, step, batches[:PAR_STEPS], protos, bg, dev)
        launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
        whole = snapshot(gather_train_state(state, mesh))
        state, _, times = par_steps(state, step, batches[PAR_STEPS:], protos, bg, dev)
        if rank == 0:
            print(f"  rank 0: {PAR_STEPS + PAR_TIMED} sharded steps on {axes}", flush=True)
        out["meshes"][axes] = dict(metrics=metrics, launches=launches, plain=plain,
                                   digest=state_digest(whole), ms=statistics.median(times),
                                   views=len(batches[0].cameras),
                                   state=whole if rank == 0 else None)
    mesh, state, step = sharded(par_axes(world)[0], with_pseudo=True)
    _kernels.reset_counts()
    pseudo = par_pseudo(host, dev)
    state, metrics, times = par_steps(state, step, [shard_batch(par_batch(host, pairs[0], dev),
                                                                mesh)],
                                      protos, bg, dev, pseudo=pseudo)
    whole = snapshot(gather_train_state(state, mesh))
    out["pseudo"] = dict(metrics=metrics, launches=dict(_kernels.LAUNCHES),
                         plain=dict(_kernels.PLAIN_CALLS), digest=state_digest(whole),
                         ms=times[0], axes=par_axes(world)[0],
                         state=whole if rank == 0 else None)
    out.update(par_certify(world, dev, work))
    return out


def par_certify(world: int, dev, work: Path) -> dict:
    """certify_sharded_training(world) on this rank, timed."""
    import torch.distributed as dist

    from sdpgs_torch.parallel.certify import certify_sharded_training

    t0 = time.perf_counter()
    res = certify_sharded_training(
        world, workdir=str(work / f"certify_{dist.get_backend()}_{dev.type}"), device=dev)
    return dict(certify=res, certify_s=time.perf_counter() - t0)


def par_bench_shape(dev) -> dict:
    """certify_bench_shape on this rank at the bench shape, timed."""
    from sdpgs_torch.parallel.certify_bench_shape import certify_bench_shape

    t0 = time.perf_counter()
    res = certify_bench_shape(meshes=BENCH_SHAPE_MESHES, steps=BENCH_SHAPE_STEPS, device=dev)
    return dict(summary=res, seconds=time.perf_counter() - t0)


def bench_shape_phase(dev, work: Path, world: int) -> dict:
    """The bench-shape certification (131,072 slots, 60,000 alive, 504x378,
    K 1,024, two views) on ``world`` gloo ranks sharing this card: each
    rank asserts, per mesh of BENCH_SHAPE_MESHES, BENCH_SHAPE_STEPS sharded
    steps against its own single-card steps (loss and PSNR 1e-3, telemetry
    exact, the gauss split after every step) and one densify event with the
    k-NN (the split after the surgery, alive within JAX's tolerance); the
    parent checks that every rank saw the same."""
    import torch.multiprocessing as tmp_mp

    t0 = time.perf_counter()
    tmp_mp.spawn(par_rank_entry, args=(world, "gloo", str(work), dev.type, {}, "bench_shape"),
                 nprocs=world, join=True)
    ranks = [torch.load(work / f"gloo_{dev.type}_bench_shape_rank{r}.pt", weights_only=False)
             for r in range(world)]
    wall = time.perf_counter() - t0
    s = ranks[0]["summary"]
    same = lambda r: {k: v for k, v in r["summary"].items() if k != "seconds"}  # noqa: E731
    require(all(same(r) == same(ranks[0]) for r in ranks),
            "the ranks' bench-shape summaries differ")
    require(set(s["meshes"]) == set(BENCH_SHAPE_MESHES), "a bench-shape mesh did not run")
    for axes, m in s["meshes"].items():
        print(f"  bench shape {axes}: losses {m['loss']} (single card {s['loss_single']}), "
              f"telemetry {m['telemetry']}, alive after the densify event "
              f"{m['alive_after_densify']} (single card {s['alive_single']}), "
              f"{s['seconds'][axes]:.1f} s on rank 0")
    print(f"bench-shape certification on {world} gloo ranks sharing the card: shape "
          f"{s['shape']}, K {s['K']}, {s['steps']} steps per mesh; the ranks took {wall:.1f} s")
    return dict(wall=wall, summary=s)


def par_axes(world: int) -> tuple:
    return PAR_AXES if world == 4 else ((2, 1, 1), (1, 1, 2))


def field_rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1e-30))


def check_par_result(got: dict, ref: dict, label: str) -> None:
    """A sharded run's metrics per step and gathered state against the
    single-card run's, at the CPU tests' tolerances."""
    from sdpgs_torch.opt.adam import TRAINABLE
    from sdpgs_torch.train.state import STAT_FIELDS

    worst = dict(loss=0.0, psnr=0.0)
    for m, r in zip(got["metrics"], ref["metrics"]):
        for k, tol in (("loss", PAR_LOSS_RTOL), ("l1", PAR_LOSS_RTOL), ("psnr", PAR_PSNR_RTOL)):
            rel = abs(m[k] - r[k]) / max(abs(r[k]), 1e-30)
            worst[k] = max(worst.get(k, 0.0), rel)
            require(rel <= tol, f"[{label}] {k} {m[k]} vs single-card {r[k]} (rel {rel:.2e})")
        for k in ("overflow", "clipped", "num_alive", "slab"):
            require(m[k] == r[k], f"[{label}] {k} {m[k]} vs single-card {r[k]}")
    s, a = got["state"], ref["state"]
    for k in ("xyz", "opacity"):
        ok = np.allclose(s["gaussians"][k], a["gaussians"][k], rtol=PAR_PARAM_RTOL,
                         atol=PAR_PARAM_ATOL)
        require(ok, f"[{label}] {k} differs from the single-card step's")
    fields = {f"mu[{k}]": (s["mu"][k], a["mu"][k]) for k in TRAINABLE}
    fields |= {f"nu[{k}]": (s["nu"][k], a["nu"][k]) for k in TRAINABLE}
    fields |= {k: (s["stats"][k], a["stats"][k]) for k in STAT_FIELDS}
    rels = {k: field_rel(*v) for k, v in fields.items()}
    print(f"  [{label}] vs single card: metrics rel {({k: f'{v:.1e}' for k, v in worst.items()})}"
          f", moments and statistics max |diff| / field max "
          f"{max(rels.values()):.1e} (limit {PAR_FIELD_TOL:g})")
    require(max(rels.values()) <= PAR_FIELD_TOL,
            f"[{label}] moments or statistics differ: {rels}")


def sharded_phase(dev, work: Path, backend: str, world: int, ref: dict) -> dict:
    """``world`` spawned ranks over ``backend`` (gloo: all on ``dev``'s card,
    time-sliced; nccl: a card each) against the single-card reference."""
    import torch.multiprocessing as tmp_mp

    from sdpgs_torch import _kernels

    t0 = time.perf_counter()
    tmp_mp.spawn(par_rank_entry, args=(world, backend, str(work), dev.type,
                                       dict(WIDTH=WIDTH, HEIGHT=HEIGHT), "work"),
                 nprocs=world, join=True)
    wall = time.perf_counter() - t0
    ranks = [torch.load(work / f"{backend}_{dev.type}_rank{r}.pt", weights_only=False)
             for r in range(world)]
    print(f"sharded training: backend {backend}, world size {world}"
          + (", every rank time-sliced on one card (not a scaling measurement)"
             if backend == "gloo" else ", one card per rank") + f"; the ranks took {wall:.1f} s")
    steps = _kernels.FORWARD_KERNELS + _kernels.BACKWARD_KERNELS
    for axes in par_axes(world):
        res = [r["meshes"][axes] for r in ranks]
        label = f"{backend} {axes[0]}x{axes[1]}x{axes[2]}"
        check_par_result(res[0], ref["plain"], label)
        require(len({r["digest"] for r in res}) == 1, f"[{label}] the ranks' states differ")
        for r, x in enumerate(res):
            want = PAR_STEPS * x["views"]
            require(all(x["launches"][k] == want for k in steps),
                    f"[{label}] rank {r} launched {x['launches']}, not K1-K5 {want} times each")
            require(not any(x["plain"].values()), f"[{label}] rank {r} ran a plain version")
        print(f"  [{label}] launches per rank (K1-K5 over {PAR_STEPS} steps of {res[0]['views']}"
              f" view(s)): {[{k: x['launches'][k] for k in steps} for x in res]}; "
              f"ms per sharded step (median of {PAR_TIMED}, per rank) "
              f"{[round(x['ms'], 3) for x in res]} beside the single-card step's "
              f"{ref['plain_ms']:.3f} ms")
    res = [r["pseudo"] for r in ranks]
    label = f"{backend} pseudo {res[0]['axes']}"
    check_par_result(res[0], ref["pseudo"], label)
    require(len({r["digest"] for r in res}) == 1, f"[{label}] the ranks' states differ")
    for r, x in enumerate(res):
        require(all(x["launches"][k] > 0 for k in steps + _kernels.WARP_KERNELS)
                and not any(x["plain"].values()),
                f"[{label}] rank {r}: launches {x['launches']}, plain {x['plain']}")
    print(f"  [{label}] launches per rank {[x['launches'] for x in res]}; digest "
          f"{res[0]['digest']}; ms (first step, per rank) {[round(x['ms'], 1) for x in res]} "
          f"beside the single-card pseudo step's {ref['pseudo_ms']:.1f} ms")
    check_certify(ranks, world, dev.type)
    return dict(wall=wall, ms={axes: [r["meshes"][axes]["ms"] for r in ranks]
                               for axes in par_axes(world)})


def check_certify(ranks: list, world: int, device_type: str) -> None:
    """The ranks' certification summaries (each rank asserted JAX's checks:
    the resumed run bit-exact, every ladder rung, alive within JAX's
    tolerance of its single-card leg): one sharded run, so its fields agree
    on every rank, and the ranks' single-card legs agree with each other."""
    cert = [r["certify"] for r in ranks]
    shared = ("mesh", "densify_iters", "reset_iters", "ladder_events", "ladder_events_single",
              "final_loss_sharded", "final_loss_single", "final_alive", "final_alive_single",
              "restore_exact", "resume_bitexact")
    require(all(c[k] == cert[0][k] for c in cert for k in shared),
            "the ranks' certification summaries differ")
    c = cert[0]
    print(f"  certify_sharded_training({world}) on {device_type}: mesh {c['mesh']}, densify at "
          f"{c['densify_iters']}, resets at {c['reset_iters']}, ladder {c['ladder_events']} "
          f"(single card {c['ladder_events_single']}), restore exact {c['restore_exact']}, "
          f"resumed run bit-exact {c['resume_bitexact']}, final loss sharded "
          f"{c['final_loss_sharded']:.5f} vs single {c['final_loss_single']:.5f}, alive "
          f"sharded {c['final_alive']}, single-card legs (min, max over the ranks) "
          f"{c['final_alive_single']}; {ranks[0]['certify_s']:.1f} s")
    lo, hi = c["final_alive_single"]
    require(c["restore_exact"] and c["resume_bitexact"] and lo == hi,
            "the certification's restore or resume was not exact, or the ranks' single-card "
            "legs differ")


def cpu_certify_phase(work: Path, world: int) -> None:
    """certify_sharded_training(world) on gloo ranks on this machine's
    CPU, where the plain path is deterministic: every equality of the JAX
    certification, the resumed run bit-exact."""
    import torch.multiprocessing as tmp_mp

    t0 = time.perf_counter()
    tmp_mp.spawn(par_rank_entry, args=(world, "gloo", str(work), "cpu", {}, "certify"),
                 nprocs=world, join=True)
    ranks = [torch.load(work / f"gloo_cpu_certify_rank{r}.pt", weights_only=False)
             for r in range(world)]
    print(f"sharded training on the CPU: backend gloo, world size {world}; the ranks took "
          f"{time.perf_counter() - t0:.1f} s")
    check_certify(ranks, world, "cpu")


def parallel_phase(dev, main_check: dict, work: Path) -> dict:
    """Phase 13: the tile range in one process, then the sharded Trainer's
    path on PAR_RANKS gloo ranks sharing this card, the certification again
    on PAR_RANKS gloo ranks on the CPU, then NCCL with a card per rank
    where the machine has them."""
    res = dict(tile_range=tile_range_phase(main_check))
    ref = par_reference(dev, work, np.random.default_rng(11))
    res["gloo"] = sharded_phase(dev, work, "gloo", PAR_RANKS, ref)
    res["bench_shape"] = bench_shape_phase(dev, work, PAR_RANKS)
    cpu_certify_phase(work, PAR_RANKS)
    cards = torch.cuda.device_count()
    if cards >= 2:
        res["nccl"] = sharded_phase(dev, work, "nccl", 4 if cards >= 4 else 2, ref)
    else:
        print(f"nccl: not run ({cards} card)")
    return res


def k5_shape_times(g, cam) -> dict:
    """K5 alone at the main config (K 1,024, D 8) and at the Trainer's
    ladder (K 2,048, D 32) on the main scene (K1 -> bin_gaussians -> K3,
    seeded cotangents): the median of REPS launches each, in ms. It needs
    of the package only what every K5 since the first port takes, and
    passes the rects where the launcher asks for them, so one card call
    can time two trees' K5 (``--k5-times``)."""
    import inspect

    from sdpgs_torch.config import RasterizeConfig
    from sdpgs_torch.ops.rasterize import binning, composite_cuda, preprocess_cuda
    from sdpgs_torch.ops.rasterize.rasterizer import make_payload

    takes_rects = "rects" in inspect.signature(composite_cuda.composite_gather_bwd).parameters
    gen = torch.Generator(device=g.xyz.device).manual_seed(5)
    out = {}
    with torch.no_grad():
        geoT, shT = preprocess_cuda.pack_rows(
            g.xyz, g.get_scaling(), g.get_rotation(), g.get_features(), g.alive, SH_DEGREE)
        base = RasterizeConfig()
        rows = preprocess_cuda.preprocess_rows(geoT, shT, preprocess_cuda._cam_vec(cam),
                                               SH_DEGREE, WIDTH, HEIGHT, base.near,
                                               base.low_pass)
        prep, color = preprocess_cuda.split_rows(rows)
        payload = make_payload(prep, g.get_opacity()[:, 0], color,
                               g.language_feature_normalized())
        for K, D in ((1024, 8), (LADDER_K, LADDER_D)):
            cfg = RasterizeConfig(max_per_tile=K, max_tiles_per_gaussian=D)
            tiles_x, tiles_y = binning.tile_grid(WIDTH, HEIGHT, cfg.tile)
            bins = binning.bin_gaussians(prep, WIDTH, HEIGHT, cfg)
            res, last = composite_cuda.composite_gather_fwd(
                payload, bins.tile_index, bins.tile_counts, tiles_x, tiles_y, cfg, g.capacity)
            g_values = torch.randn(tuple(res.values.shape), generator=gen, device=payload.device)
            g_final_t = torch.randn(tuple(res.final_t.shape), generator=gen,
                                    device=payload.device)
            args = ((payload, bins.tile_index) + ((bins.rects,) if takes_rects else ())
                    + (res.final_t, last, g_values, g_final_t, tiles_x, tiles_y, cfg,
                       g.capacity))
            out[f"K {K}, D {D}"] = dict(
                ms=cuda_ms(lambda: composite_cuda.composite_gather_bwd(*args)),
                entries=int(bins.tile_counts.sum()), clipped=int(bins.clipped))
    return out


def k5_times_main() -> int:
    """``--k5-times``: build the kernels, then K5 at the main and ladder
    shapes (k5_shape_times) on the main scene, as one JSON line."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.core.camera import Camera
    from sdpgs_torch.core.gaussians import Gaussians

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    _kernels.build()
    dev = torch.device("cuda")
    g = Gaussians.from_numpy(make_cloud(np.random.default_rng(0)), device=dev)
    cam = Camera.create(R=np.eye(3), T=np.array([-0.35, 0.0, 0.0]), fovx=0.9, fovy=0.7,
                        width=WIDTH, height=HEIGHT, device="cpu")
    print(json.dumps({"k5_ms": k5_shape_times(g, cam)}))
    return 0


def k1_k4_times(k1_args, k4_args) -> tuple:
    """K1's and K4's own times: the bare launchers with the camera vector
    on the host (they pass it to the kernel by value, so no copy to the
    host waits out the device sleep inside the timed window)."""
    from sdpgs_torch.ops.rasterize import preprocess_cuda as pp

    cam = k1_args[2].cpu()
    return (cuda_ms(lambda: pp.preprocess_rows_fwd(*k1_args[:2], cam, *k1_args[3:])),
            cuda_ms(lambda: pp.preprocess_rows_bwd(*k4_args[:2], cam, *k4_args[3:])))


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
    """Phases 2-13 on ``dev``, writing the PLY, the renders, the Trainer's files
    and the LLFF tree with the CLI's model directory under ``work``."""
    from sdpgs_torch import _kernels
    from sdpgs_torch.cli.render_cli import render_set
    from sdpgs_torch.config import RasterizeConfig
    from sdpgs_torch.core.camera import Camera
    from sdpgs_torch.core.gaussians import Gaussians
    from sdpgs_torch.data.camera_utils import LoadedCamera
    from sdpgs_torch.data.ply import load_gaussians_ply, save_gaussians_ply
    from sdpgs_torch.ops import warp
    from sdpgs_torch.ops.launch_floor import launch_floor, launch_floor_plain
    from sdpgs_torch.ops.rasterize import binning, composite_cuda, preprocess_cuda
    from sdpgs_torch.ops.sort import sort_by_key, sort_by_key_plain
    from sdpgs_torch.render import render

    clock = dict(last=time.perf_counter(), start=time.perf_counter(), phases={})

    def mark(name: str) -> None:
        now = time.perf_counter()
        clock["phases"][name] = round(now - clock["last"], 1)
        clock["last"] = now
        print(f"[phase] {name}: {clock['phases'][name]} s (smoke at {now - clock['start']:.1f} s)",
              flush=True)

    # -- 1-2. card and kernel build ---------------------------------------
    secs = _kernels.build_seconds()
    print(f"build: {secs:.1f} s ({_kernels.build().name})", flush=True)
    for line in _kernels.BUILD_LOG.splitlines():
        if ("registers" in line or "spill" in line or line.startswith("==")
                or "Compiling entry function" in line):
            print("  " + line.strip())

    mark("build")

    # -- K7's own path: the stable depth sort ------------------------------
    sort = sort_phase(np.random.default_rng(4), dev)
    mark("sort")

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
    probe = probe_phase(main_check)
    check_poisoned_conic(main_check["k3_args"], main_check["rects"], cfg)
    check_clamped_alpha(main_check["k3_args"], main_check["rects"], cfg)
    # capacity edges the main scene never reaches: K overflow, D clipping
    # (sentinel holes in the table) and 16-pixel tiles (256-thread blocks)
    tight = check_kernels(g, cams[0], RasterizeConfig(tile=16, max_per_tile=128,
                                                       max_tiles_per_gaussian=2),
                          "tight config")
    require(tight["overflow"] > 0 and tight["clipped"] > 0,
            "the tight config did not reach the K and D caps")
    check_tile_sizes(main_check)
    check_binning_edges(dev, main_check)
    for src, label in (("composite.cu", "K3"), ("composite_bwd.cu", "K5")):
        for fn, res in kernel_resources(src).items():
            print(f"  {label} {fn}: {res.get('registers')} registers, {res.get('spill')} bytes "
                  f"spilled")
    mark("kernel checks")

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
    require(not any(launches[k] for k in _kernels.KERNELS if k not in _kernels.FORWARD_KERNELS),
            "a kernel other than K1-K3 ran on the render path")
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
    mark("render")

    # -- 8. training: card vs CPU, then the full-width train steps --------
    check_step_card_vs_cpu(rng, dev)
    train_phase(rng, dev)
    mark("train steps")

    # -- 9. pseudo-view training: K6, the depth net, the pseudo steps ------
    _, pdata = train_scene(rng, dev, WIDTH, HEIGHT, CAPACITY, ALIVE)
    warp_check = check_warp(pdata, dev)
    k6_probes(warp_check)
    for fn, res in kernel_resources("warp_zbuf.cu").items():
        path = "cluster path" if "cluster" in fn else "general path"
        print(f"  K6 {path} {fn}: {res.get('registers')} registers, {res.get('spill')} bytes "
              f"spilled")
    dnet = check_depth_net(pdata, dev)
    check_pseudo_step_card_vs_cpu(rng, dev, dnet["raw"])
    pseudo = pseudo_train_phase(rng, dev, dnet["raw"])
    mark("pseudo steps")

    # -- 10. the Trainer: densify on the card, the loop, the ladder ---------
    check_densify_card_vs_cpu(np.random.default_rng(5), dev)
    trainer = trainer_phase(dev, dnet["raw"], work)
    forced_ladder(dev, trainer["scene"])
    mark("trainer")

    # -- 11. the train CLI on an LLFF tree from disk -------------------------
    cli = cli_phase(dev, dnet["raw"], work)
    mark("train CLI")

    # -- 12. evaluate and prepare: the render and metrics CLIs on the CLI's
    # model, the depth prior and fusion on its tree, the viewer, a trace ----
    evaluation = evaluate_phase(dev, work / "llff_fern", work / "llff_fern_out", work)
    mark("evaluate")
    full_eval_phase(dev, work)
    mark("full_eval")

    # -- 13. the protocol harnesses: two ablation arms through the pseudo
    # window's start, and the convergence run ----------------------------
    protocol_phase(dev, work)
    mark("protocol")
    convergence_phase(dev, work)
    mark("convergence")

    # -- 14. multi-card training: the tile range of K2, K3 and K5, then the
    # sharded steps, a sharded pseudo step, the certification and the
    # bench-shape certification on ranks ------------------------------------
    parallel_phase(dev, main_check, work)
    mark("parallel")

    # -- 15. kernel timings and bounds --------------------------------------
    k1_args, k2_args, k3_args = (main_check[k] for k in ("k1_args", "k2_args", "k3_args"))
    k4_args, k5_args = main_check["k4_args"], main_check["k5_args"]
    T, K, pairs, contrib = (main_check[k] for k in ("T", "K", "pairs", "contrib"))
    with torch.no_grad():
        k1_ms, k4_ms = k1_k4_times(k1_args, k4_args)
        k1_plain = cuda_ms(lambda: preprocess_cuda.preprocess_rows_plain(*k1_args))
        k2_ms = cuda_ms(lambda: binning.build_table(*k2_args))
        k2_plain = cuda_ms(lambda: binning.build_table_plain(*k2_args))
        k3_ms = cuda_ms(lambda: composite_cuda.composite_gather(*k3_args,
                                                                rects=main_check["rects"]))
        k3_plain = cuda_ms(lambda: composite_cuda.composite_gather_plain(*k3_args))
        k4_plain = cuda_ms(lambda: preprocess_cuda.preprocess_vjp_plain(*k4_args))
        k5_ms = cuda_ms(lambda: composite_cuda.composite_gather_bwd(*k5_args))
        k5_shapes = k5_shape_times(g, cams[0])
        k5_plain = cuda_ms(lambda: composite_cuda.composite_vjp_plain(
            *main_check["k5_plain_args"], tiles_per_pass=PLAIN_TILES_PER_PASS), reps=3)
        depths, pc = warp_check["depths"], warp_check["pc"]
        k6_ms = cuda_ms(lambda: warp.warp_zbuffer_rows(depths, pc))
        k6_plain = cuda_ms(lambda: warp.warp_zbuffer_rows_plain(depths, pc), reps=3)
        # the library call: the plain version's scatter-min alone, on its rows
        idx, zv = warp.scatter_rows(*warp.project_rows(depths, pc), HEIGHT, WIDTH)
        zbuf = torch.full((pc.shape[0] * HEIGHT * WIDTH + 1,), float("inf"), device=dev)
        k6_lib = cuda_ms(lambda: zbuf.scatter_reduce_(0, idx, zv, reduce="amin"))
        del idx, zv, zbuf
        sort_args, probe_args = sort["args"], probe["args"]
        k7_ms = cuda_ms(lambda: sort_by_key(*sort_args, device=dev))
        k7_plain = cuda_ms(lambda: sort_by_key_plain(*sort_args))
        k7_lib = cuda_ms(lambda: library_sort(*sort_args))
        for n, args in sort["args_by_n"].items():
            if args is not sort_args:
                print(f"  sort_by_key at N=2^{n.bit_length() - 1}: "
                      f"{cuda_ms(lambda: sort_by_key(*args, device=dev)):.4f} ms, library "
                      f"{cuda_ms(lambda: library_sort(*args)):.4f} ms")
        k8_ms = cuda_ms(lambda: launch_floor(*probe_args, device=dev))
        k8_plain = cuda_ms(lambda: launch_floor_plain(*probe_args))
        k8_lib = cuda_ms(lambda: probe_args[0] + probe_args[1] + probe_args[2][:, 0])
    nsh = 3 * (SH_DEGREE + 1) ** 2
    npix = cfg.tile ** 2
    # K2 reads n_valid rects and ids; K3 and K5 the listed entries and the
    # payload rows they reference; K5 writes the whole payload gradient
    payload_bytes = main_check["payload_numel"] * 4
    read_bytes = main_check["rows_read"] * main_check["row_bytes"] + main_check["entries"] * 4
    k1_bytes = (preprocess_cuda.NGEO + nsh + preprocess_cuda.NOUT) * 4 * CAPACITY
    k2_bytes = (2 * main_check["n_valid"] + 1 + T * K + T) * 4
    k3_bytes = read_bytes + (T + T * npix * (composite_cuda.NCH + 1)) * 4
    k4_bytes = (K4_BYTES_ROWS + 2 * nsh) * 4 * CAPACITY
    k5_bytes = read_bytes + payload_bytes + T * npix * (composite_cuda.NCH + 3) * 4
    # what K5's fixed order moves beyond the function's own bytes: each
    # block's partials below its start written and read once, the entry map
    # cleared, its listed entries written and read, the rects read by the
    # map and reduction launches, the table read by the map launch
    last = k5_args[4]
    side = composite_cuda.SQUARE if cfg.tile % composite_cuda.SQUARE == 0 else cfg.tile
    sq = cfg.tile // side
    tops = int(last.reshape(T, sq, side, sq, side).amax(dim=(2, 4)).sum())
    k5_scratch = (2 * tops * composite_cuda.NPAY * 4 + CAPACITY * cfg.max_tiles_per_gaussian * 4
                  + 2 * main_check["entries"] * 4 + 2 * CAPACITY * 4 + T * K * 4)
    k6_bytes = (pc.shape[0] + depths.shape[0]) * HEIGHT * WIDTH * 4 + pc.numel() * 4
    k7_bytes = SORT_BYTES * sort_args[0].numel()
    k8_bytes = PROBE_BYTES * probe_args[0].numel()

    def bound(nbytes, ops=0):
        return max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), (ops / F32_FLOPS * 1e3, "operations"))

    # K3's and K5's operations: the function's own work, the contributing pairs
    k3_unculled = bound(k3_bytes, pairs * ALPHA_OPS + contrib * BLEND_OPS)
    bounds = {
        "k1": bound(k1_bytes), "k2": bound(k2_bytes),
        "k3": bound(k3_bytes, contrib * (ALPHA_OPS + BLEND_OPS)),
        "k4": bound(k4_bytes),
        "k5": bound(k5_bytes, contrib * (ALPHA_OPS + GRAD_OPS)),
        "k6": bound(k6_bytes, warp_check["rows"] * WARP_OPS),
        "k7": bound(k7_bytes), "k8": bound(k8_bytes),
    }
    rast = "sdpgs_tpu/ops/rasterize/"
    # launches: K1-K6 on the train CLI's run (this slice's main path; the
    # render, train, pseudo and Trainer paths printed theirs above), K7 and
    # K8 on their own paths
    tr, per_tr = cli["launches"], "on the train CLI run"
    rows = [
        ("preprocess_sh_fwd", "preprocess.cu", rast + "preprocess_pallas.py:227", "preprocess",
         tr, per_tr, "k1", main_check["k1_err"], k1_ms, k1_plain, None),
        ("bin_table", "binning.cu", rast + "rank_pallas.py:851", "binning", tr, per_tr, "k2",
         main_check["k2_err"], k2_ms, k2_plain, None),
        ("composite_fwd", "composite.cu", rast + "composite_pallas.py:283", "composite",
         tr, per_tr, "k3", main_check["k3_err"], k3_ms, k3_plain, None),
        ("preprocess_sh_bwd", "preprocess_bwd.cu", rast + "preprocess_pallas.py:236",
         "preprocess_bwd", tr, per_tr, "k4", main_check["k4_err"], k4_ms, k4_plain, None),
        ("composite_bwd", "composite_bwd.cu", rast + "composite_pallas.py:318", "composite_bwd",
         tr, per_tr, "k5", main_check["k5_err"], k5_ms, k5_plain, None),
        ("warp_zbuffer", "warp_zbuf.cu", "sdpgs_tpu/ops/warp_pallas.py:115", "warp_zbuf",
         tr, per_tr, "k6", warp_check["err"], k6_ms, k6_plain, k6_lib),
        ("sort_by_key", "sort.cu", "sdpgs_tpu/ops/sort_pallas.py:178", "sort", sort["launches"],
         "on the sort path (N = 2^17, 2^16)", "k7", sort["err"], k7_ms, k7_plain, k7_lib),
        ("launch_floor", "launch_floor.cu", "scripts/perf_rank_variants.py:58", "launch_floor",
         probe["launches"], "on the probe path", "k8", probe["err"], k8_ms, k8_plain, k8_lib),
    ]
    records = [
        dict(name=name, route="cuda", source=f"sdpgs_torch/csrc/{src}", replaces=rep,
             launches=counts[kern], max_abs_err=err, ms=ms, plain_ms=plain_ms,
             bound_ms=bounds[b][0], bound_by=bounds[b][1], library_ms=lib_ms)
        for name, src, rep, kern, counts, _, b, err, ms, plain_ms, lib_ms in rows
    ]
    for r, row in zip(records, rows):
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms{lib}), bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, {r['launches']} launches "
              f"{row[5]}")
    print(f"  composite_fwd: the unculled walk's operations, {pairs} pairs visited x "
          f"{ALPHA_OPS} + {contrib} contributing x {BLEND_OPS}, would take "
          f"{k3_unculled[0] * 1e3:.2f} us; K3 tested {main_check['k3_tested']} of the {pairs}")
    print(f"  bytes counted: K2 {k2_bytes} (n_valid {main_check['n_valid']}), K3 {k3_bytes}, "
          f"K5 {k5_bytes} ({main_check['entries']} table entries listed, "
          f"{main_check['rows_read']} payload rows they reference)")
    print(f"  composite_bwd's scratch: {k5_scratch} bytes ({tops} partial rows below the "
          f"blocks' starts, the [{CAPACITY}, {cfg.max_tiles_per_gaussian}] entry map, the "
          f"rects, the table); with them the bytes bound is "
          f"{(k5_bytes + k5_scratch) / HBM_BYTES_PER_S * 1e6:.2f} us")
    print(f"  composite_bwd at the main and the ladder shapes: {k5_shapes}")
    ev = evaluation["rendered"]
    print(f"  K1-K3 on the evaluation path (render CLI, {ev['n_views']} views): launches "
          f"{ {k: ev['launches'][k] for k in _kernels.FORWARD_KERNELS} }; the viewer launches "
          f"each once per frame ({VIEWER_FRAMES} frames, and once for its check)")

    mark("kernel timings")
    print(f"phases (s): {clock['phases']}; total {time.perf_counter() - clock['start']:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(k5_times_main() if sys.argv[1:] == ["--k5-times"] else main())
