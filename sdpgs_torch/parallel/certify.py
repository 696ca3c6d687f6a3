"""Multi-step sharded-training certification.

Counterpart of ``sdpgs_tpu/parallel/certify.py``. One sharded step proves
the step; this harness proves the Trainer survives real training on a
(data, gauss, tile) mesh: a mini-training on every rank of an initialized
process group that passes through every slow-path event (densify and prune
with the k-NN on the gathered state, the opacity reset, a capacity-ladder
rung, a checkpoint and its restore) and asserts that

  (a) the ``gauss`` split of the Adam moments and densification statistics
      survives every event, and the parameters stay replicated (equal on
      every rank);
  (b) the restored state equals the checkpointed one bit for bit, and a run
      restored from the mid-run checkpoint finishes bit-identically to the
      uninterrupted run: the same parameters and the same losses, on the
      CPU and on a card alike (every kernel of the step, K5's payload
      gradient included, sums in a fixed order);
  (c) the sharded trajectory tracks the single-card one (loosely: the tile
      sum and the data mean reorder the float accumulations), with the same
      events at the same iterations, every capacity-ladder rung equal, and
      the final alive count within JAX's tolerance of the single-card
      leg's.

Every rank calls :func:`certify_sharded_training` with the world size; the
single-card leg runs on every rank, without collectives.
"""

from __future__ import annotations

import copy
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from sdpgs_torch.parallel import comm


def assert_state_sharded(state, shardings, where: str) -> None:
    """Moments and statistics hold this rank's slots only (``shardings``,
    ``parallel.state_shardings``); the parameters are whole and equal on
    every rank."""
    lo, hi = shardings.slots
    assert state.slots == (lo, hi), f"{where}: the state holds slots {state.slots}"
    for name, leaf in (("opt_state.mu[xyz]", state.opt_state.mu["xyz"]),
                       ("opt_state.nu[xyz]", state.opt_state.nu["xyz"]),
                       ("stats.xyz_gradient_accum", state.stats.xyz_gradient_accum)):
        assert leaf.shape[0] == hi - lo, f"{where}: {name} lost its 'gauss' split: {leaf.shape}"
    xyz = state.gaussians.xyz.detach()
    assert xyz.shape[0] == shardings.capacity, f"{where}: params must stay whole"
    hi_v = comm.all_max(xyz.clone(), dist.group.WORLD)
    lo_v = -comm.all_max(-xyz, dist.group.WORLD)
    assert torch.equal(hi_v, lo_v), f"{where}: the ranks' parameters differ"


def _make_trainer(mesh_axes, scene_seed: int, device, raster=None, trainer_cls=None):
    from sdpgs_torch.config import RasterizeConfig, TrainConfig
    from sdpgs_torch.data.synthetic import SyntheticScene
    from sdpgs_torch.train.loop import Trainer

    cfg = TrainConfig()
    # D=2 on a dense synthetic scene: rects are clipped, so the telemetry
    # ladder fires (D doubles at a log point)
    cfg.raster = raster if raster is not None else RasterizeConfig(
        tile=16, max_per_tile=128, max_tiles_per_gaussian=2, chunk=32)
    cfg.views_per_batch = 2
    cfg.mesh_data, cfg.mesh_gauss, cfg.mesh_tile = mesh_axes
    o = cfg.optim
    o.densify_from_iter = 10
    o.densification_interval = 20
    o.densify_until_iter = 100
    o.proximity_until_iter = 30          # densify@20 runs proximity, @40/60 not
    o.start_sample_pseudo = 34           # empty pseudo window (34 < it < 35)
    o.end_sample_pseudo = 35             # -> opacity resets at 35, 55 ...
    o.opacity_reset_interval = 20
    o.test_iterations = ()
    o.save_iterations = ()
    o.checkpoint_iterations = ()
    scene = SyntheticScene(seed=scene_seed, device=device)
    return (trainer_cls or Trainer)(cfg, scene=scene, device=device)


class _EventLog:
    def __init__(self):
        self.densify = []
        self.reset = []
        self.ladder = []


def _certifying_trainer_cls(log: _EventLog, sharded: bool):
    from sdpgs_torch.train.loop import Trainer

    class CertifyingTrainer(Trainer):
        def _maybe_densify(self, iteration):
            info = super()._maybe_densify(iteration)
            if info is not None:
                log.densify.append(iteration)
                if sharded:
                    assert_state_sharded(self.state, self._shardings, f"densify@{iteration}")
            return info

        def _maybe_reset_opacity(self, iteration):
            fired = super()._maybe_reset_opacity(iteration)
            if fired:
                log.reset.append(iteration)
                if sharded:
                    assert_state_sharded(self.state, self._shardings, f"reset@{iteration}")
            return fired

        def _maybe_grow_tiles_per_gaussian(self, clipped):
            d_before = self.cfg.raster.max_tiles_per_gaussian
            super()._maybe_grow_tiles_per_gaussian(clipped)
            if self.cfg.raster.max_tiles_per_gaussian != d_before:
                log.ladder.append(("D", d_before, self.cfg.raster.max_tiles_per_gaussian))

        def _maybe_grow_max_per_tile(self, overflow):
            k_before = self.cfg.raster.max_per_tile
            super()._maybe_grow_max_per_tile(overflow)
            if self.cfg.raster.max_per_tile != k_before:
                log.ladder.append(("K", k_before, self.cfg.raster.max_per_tile))

    return CertifyingTrainer


def _reseed(trainer, seed: int) -> None:
    """Pin the host-side sampling RNG so two trainers continue with the
    same view sequence from a common point (resume determinism)."""
    trainer._rng = np.random.default_rng(seed)
    trainer._view_stack = []
    trainer._pseudo_stack = []


def _shared_workdir(workdir) -> Path:
    """One directory for every rank: rank 0's temporary one unless given."""
    if workdir is not None:
        return Path(workdir)
    name = [tempfile.mkdtemp(prefix="certify_") if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(name, src=0)
    return Path(name[0])


def certify_sharded_training(n_ranks: int, iterations: int = 60, ckpt_at: int = 30,
                             workdir: str | None = None, scene_seed: int = 7,
                             device=None) -> dict:
    """Run the certification on this rank of a process group of ``n_ranks``
    processes (every rank calls it); raises AssertionError on any failure.
    The mesh is (2, 2, 2) for 8 ranks, (2, 2, 1) for 4 and (2, 1, 1) for 2.
    ``device`` is this rank's (``cuda`` unless the caller asks for
    another). Returns a summary dict (events, trajectories)."""
    assert n_ranks >= 2, "certification needs a real mesh"
    assert dist.is_initialized() and dist.get_world_size() == n_ranks, (
        "certify_sharded_training runs on every rank of a group of n_ranks processes")
    if n_ranks >= 8:
        mesh_axes = (2, 2, 2)
    elif n_ranks >= 4:
        mesh_axes = (2, 2, 1)
    else:
        mesh_axes = (2, 1, 1)
    if int(np.prod(mesh_axes)) != n_ranks:
        raise ValueError(f"{n_ranks} ranks: the certification meshes take 2, 4 or 8")

    tmp = _shared_workdir(workdir)
    log_a = _EventLog()
    A = _make_trainer(mesh_axes, scene_seed, device,
                      trainer_cls=_certifying_trainer_cls(log_a, sharded=True))
    assert A.mesh is not None and A.mesh.shape == dict(
        data=mesh_axes[0], gauss=mesh_axes[1], tile=mesh_axes[2]), A.mesh
    assert_state_sharded(A.state, A._shardings, "init")

    hist_a1 = A.train(iterations=ckpt_at, log_every=10)
    assert_state_sharded(A.state, A._shardings, f"pre-checkpoint@{ckpt_at}")
    A.save_checkpoint(tmp / "checkpoints", ckpt_at)
    at_ckpt = copy.deepcopy(A._whole_state().to_numpy())
    gen_at_ckpt = A.state.generator.get_state()
    raster_at_ckpt = A.cfg.raster  # the ladder may have grown it by now

    _reseed(A, 999)
    hist_a2 = A.train(iterations=iterations, log_every=10)

    # --- resume leg: restore into a fresh sharded trainer, finish, compare ---
    log_b = _EventLog()
    B = _make_trainer(mesh_axes, scene_seed, device, raster=raster_at_ckpt,
                      trainer_cls=_certifying_trainer_cls(log_b, sharded=True))
    B.restore(tmp / "checkpoints", ckpt_at)
    assert_state_sharded(B.state, B._shardings, "post-restore")
    assert B.state.step == ckpt_at
    restored = B._whole_state().to_numpy()
    for part in ("gaussians", "mu", "nu", "stats"):
        for k, v in at_ckpt[part].items():
            np.testing.assert_array_equal(restored[part][k], v,
                                          err_msg=f"restore differs from the checkpoint: {k}")
    assert torch.equal(B.state.generator.get_state(), gen_at_ckpt), "generator not restored"
    _reseed(B, 999)
    hist_b = B.train(iterations=iterations, log_every=10)

    for name in ("xyz", "opacity", "scaling", "rotation", "features_dc"):
        np.testing.assert_array_equal(
            getattr(A.state.gaussians, name).detach().cpu().numpy(),
            getattr(B.state.gaussians, name).detach().cpu().numpy(),
            err_msg=f"resumed run diverged from uninterrupted run: {name}")
    assert [h["loss"] for h in hist_b] == [h["loss"] for h in hist_a2], (
        "resumed loss trajectory differs", hist_b, hist_a2)
    assert log_b.densify == [i for i in log_a.densify if i > ckpt_at], (log_b.densify,
                                                                        log_a.densify)

    # --- single-card leg: same schedule, no mesh -------------------------------
    log_c = _EventLog()
    C = _make_trainer((1, 1, 1), scene_seed, device,
                      trainer_cls=_certifying_trainer_cls(log_c, sharded=False))
    hist_c1 = C.train(iterations=ckpt_at, log_every=10)
    _reseed(C, 999)
    hist_c2 = C.train(iterations=iterations, log_every=10)

    assert log_a.densify and log_a.reset and log_a.ladder, (
        "certification run must exercise every event type",
        log_a.densify, log_a.reset, log_a.ladder)
    assert log_a.densify == log_c.densify, (log_a.densify, log_c.densify)
    assert log_a.reset == log_c.reset
    assert log_a.ladder == log_c.ladder, (log_a.ladder, log_c.ladder)

    # sharded vs single-card trajectories agree loosely: the tile sum and the
    # data mean reorder float accumulations
    losses_a = [h["loss"] for h in hist_a1 + hist_a2]
    losses_c = [h["loss"] for h in hist_c1 + hist_c2]
    np.testing.assert_allclose(losses_a, losses_c, rtol=5e-2,
                               err_msg="sharded trajectory diverged from single-card")
    alive_a = hist_a2[-1]["alive"]
    alive_c = hist_c2[-1]["alive"]
    # densify decisions are float-threshold flips, so accumulation-order
    # drift can move a few marginal slots: 5% with an absolute floor of 3
    # and cap of 16, so the check stays a divergence detector at large counts
    tol = max(3, min(16, int(0.05 * max(alive_a, alive_c))))
    assert abs(alive_a - alive_c) <= tol, (alive_a, alive_c)
    # every rank ran its own single-card leg: the span of their alive counts
    # (one value where the legs agree, as they do run to run)
    span = torch.tensor([-alive_c, alive_c], device=A.device)
    comm.all_max(span, dist.group.WORLD)
    assert np.isfinite(losses_a).all()

    return {
        "mesh": mesh_axes,
        "iterations": iterations,
        "ckpt_at": ckpt_at,
        "densify_iters": log_a.densify,
        "reset_iters": log_a.reset,
        "ladder_events": log_a.ladder,
        "ladder_events_single": log_c.ladder,
        "final_loss_sharded": losses_a[-1],
        "final_loss_single": losses_c[-1],
        "final_alive": alive_a,
        "final_alive_single": (-int(span[0]), int(span[1])),
        "restore_exact": True,
        "resume_bitexact": True,
    }
