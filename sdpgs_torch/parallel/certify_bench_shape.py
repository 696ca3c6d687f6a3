"""Bench-shape sharded-training certification.

Counterpart of ``scripts/certify_bench_shape.py``. ``certify.py`` proves
the sharded Trainer at a toy shape (48x32); this runs the bench
configuration (``bench.py:47-80``'s inputs, copied: capacity 131,072, 60,000
alive, 504x378, K 1,024, two views) through
``make_train_step(tile_mesh=...)`` on every rank of a process group:

  * ``steps`` sharded train steps on each mesh against the same steps on
    one card: loss and PSNR within 1e-3 relative (the tile sum and the data
    mean reorder the float accumulations), telemetry (overflow, clipped,
    slab, alive) exactly, and the ``gauss`` split of the moments and
    statistics asserted after every step;
  * one densify and prune event (with proximity: the k-NN of the gathered
    state) at bench capacity, the split asserted again after the slot
    surgery, and the alive count within JAX's tolerance of the single-card
    event's.

JAX runs one (2, 2, 2) mesh on 8 virtual CPU devices; here every mesh of
``meshes`` must hold the group's world size of ranks, e.g. (2, 2, 1) and
(1, 2, 2) on 4 gloo ranks sharing one card. Every rank calls
:func:`certify_bench_shape`; the single-card leg runs on each rank without
collectives.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch
import torch.distributed as dist

from sdpgs_torch import default_device
from sdpgs_torch.parallel.certify import assert_state_sharded

# bench.py:38-42 (the bench shape) with two views, as the JAX script sets
BENCH_SHAPE = dict(width=504, height=378, capacity=1 << 17, alive=60_000)
VIEWS = 2
SH_DEGREE = 3
PROTOTYPES = 8
LOSS_RTOL = 1e-3
SEED = 3            # scripts/certify_bench_shape.py's inputs


def make_inputs(rng, width: int, height: int, capacity: int, alive: int, device=None):
    """bench.py:47-80's inputs at two views, from ``rng`` (the same draws):
    the Gaussians, the cameras and the view batch."""
    from sdpgs_torch.core.camera import Camera
    from sdpgs_torch.core.gaussians import create_from_points
    from sdpgs_torch.train.step import ViewBatch

    dev = default_device(device)
    pts = rng.normal(size=(alive, 3)).astype(np.float32) * np.array(
        [1.2, 0.9, 0.6], np.float32) + np.array([0, 0, 4.0], np.float32)
    cols = rng.uniform(size=(alive, 3)).astype(np.float32)
    g = create_from_points(pts, cols, capacity, init_scale=np.full(alive, 1e-4), device=dev)
    cams = [Camera.create(R=np.eye(3), T=np.array([0.1 * i, 0.0, 0.0]), fovx=0.9, fovy=0.7,
                          width=width, height=height, device="cpu") for i in range(VIEWS)]

    def t(a):
        return torch.from_numpy(a).to(dev)

    batch = ViewBatch(
        cameras=cams,
        image=t(rng.uniform(size=(VIEWS, 3, height, width)).astype(np.float32)),
        depth_mono=t(rng.uniform(1, 8, size=(VIEWS, height, width)).astype(np.float32)),
        feature=t(rng.uniform(size=(VIEWS, 3, height, width)).astype(np.float32)),
        seg_map=t(np.zeros((VIEWS, height, width), np.int32)))
    return g, cams, batch


def _densify(state, cfg, dev):
    """One densify and prune event with proximity on the whole ``state``
    (scripts/certify_bench_shape.py:113-151): the k-NN, the split noise
    from the state's generator, the slot surgery in place."""
    from sdpgs_torch.opt.densify import densify_and_prune
    from sdpgs_torch.ops.knn import knn

    opt = cfg.optim
    g = state.gaussians
    d2, idx = knn(g.xyz.detach(), k=3, mask=g.alive, device=dev)
    finite = torch.isfinite(d2)
    knn_dist = torch.where(finite, d2, 0.0).sum(-1) / torch.clamp_min(finite.sum(-1), 1)
    noise = torch.randn((g.capacity, 3), generator=state.generator, device=dev)
    _, _, state.stats, _ = densify_and_prune(
        g, state.opt_state, state.stats, noise, grad_threshold=opt.densify_grad_threshold,
        min_opacity=opt.prune_threshold, extent=1.0, percent_dense=opt.percent_dense,
        run_proximity=True, knn_dist=knn_dist, knn_idx=idx)
    return state


def _leg(g, batch, protos, cfg, steps: int, dev, mesh_axes=None) -> tuple:
    """``steps`` train steps and one densify event from a copy of ``g``, on
    one card (``mesh_axes`` None) or sharded over the mesh. Returns (the
    per-step metrics, the alive count after the event, seconds)."""
    from sdpgs_torch.parallel import (
        gather_train_state,
        make_mesh,
        shard_batch,
        shard_train_state,
        state_shardings,
    )
    from sdpgs_torch.train.state import TrainState
    from sdpgs_torch.train.step import make_train_step

    t0 = time.perf_counter()
    state = TrainState.create(copy.deepcopy(g), seed=0, device=dev)
    bg = torch.zeros(3, device=dev)
    mesh = shardings = None
    b = batch
    if mesh_axes is not None:
        mesh = make_mesh(*mesh_axes)
        shardings = state_shardings(mesh, state)
        state = shard_train_state(state, mesh)
        b = shard_batch(batch, mesh)
    step = make_train_step(cfg, SH_DEGREE, tile_mesh=mesh if mesh_axes and mesh_axes[2] > 1
                           else None, out_shardings=shardings)
    hist = []
    for i in range(steps):
        state, m = step(state, b, protos, bg, 1.0, device=dev)
        if mesh is not None:
            assert_state_sharded(state, shardings, f"sharded step {i}")
        hist.append({"loss": float(m.loss), "psnr": float(m.psnr), "overflow": int(m.overflow),
                     "clipped": int(m.clipped), "slab": int(m.slab),
                     "alive": int(m.num_alive)})
    if mesh is not None:
        state = _densify(gather_train_state(state, mesh), cfg, dev)
        state = shard_train_state(state, mesh)
        assert_state_sharded(state, shardings, "post-densify")
    else:
        state = _densify(state, cfg, dev)
    alive = state.gaussians.num_alive()
    return hist, alive, time.perf_counter() - t0


def certify_bench_shape(meshes=((2, 2, 1), (1, 2, 2)), steps: int = 3,
                        shape: dict | None = None, device=None) -> dict:
    """Run the certification on this rank of an initialized process group
    whose world size is the size of every mesh of ``meshes``; raises
    AssertionError on any failure. ``shape`` (width, height, capacity,
    alive) replaces the bench shape, for a reduced run; ``device`` is this
    rank's (``cuda`` unless the caller asks for another). Returns a summary
    dict (the legs' seconds under ``seconds``)."""
    from sdpgs_torch.config import RasterizeConfig, TrainConfig

    dev = default_device(device)
    assert dist.is_initialized(), "certify_bench_shape runs on every rank of a process group"
    world = dist.get_world_size()
    for axes in meshes:
        if int(np.prod(axes)) != world:
            raise ValueError(f"mesh {axes} does not hold the group's {world} ranks")
    sh = dict(BENCH_SHAPE, **(shape or {}))
    cfg = TrainConfig()
    cfg.raster = RasterizeConfig(chunk=64)
    cfg.views_per_batch = VIEWS
    rng = np.random.default_rng(SEED)
    g, _, batch = make_inputs(rng, device=dev, **sh)
    protos = torch.from_numpy(rng.normal(size=(PROTOTYPES, 3)).astype(np.float32)).to(dev)

    hist_s, alive_s, secs_s = _leg(g, batch, protos, cfg, steps, dev)
    summary = {"shape": sh, "steps": steps, "K": cfg.raster.max_per_tile,
               "loss_single": [h["loss"] for h in hist_s], "alive_single": alive_s,
               "meshes": {}, "seconds": {"single": secs_s}}
    for axes in meshes:
        hist_m, alive_m, secs_m = _leg(g, batch, protos, cfg, steps, dev, mesh_axes=axes)
        # telemetry must agree exactly; trajectories loosely (tile sum and
        # data mean reorder the accumulations)
        for a, b in zip(hist_m, hist_s):
            assert (a["overflow"], a["clipped"], a["slab"], a["alive"]) == (
                b["overflow"], b["clipped"], b["slab"], b["alive"]), (axes, a, b)
        np.testing.assert_allclose(
            [h["loss"] for h in hist_m], [h["loss"] for h in hist_s], rtol=LOSS_RTOL,
            err_msg=f"{axes}: bench-shape sharded trajectory diverged from one card")
        np.testing.assert_allclose([h["psnr"] for h in hist_m], [h["psnr"] for h in hist_s],
                                   rtol=LOSS_RTOL)
        # densify decisions at bench scale: float-threshold flips under the
        # reordered sums can move a few marginal slots (certify.py's bound)
        tol = max(3, min(16, int(0.05 * max(alive_m, alive_s))))
        assert abs(alive_m - alive_s) <= tol, (axes, alive_m, alive_s)
        summary["meshes"][tuple(axes)] = {
            "loss": [h["loss"] for h in hist_m], "telemetry": hist_m[-1],
            "alive_after_densify": alive_m}
        summary["seconds"][tuple(axes)] = secs_m
    return summary
