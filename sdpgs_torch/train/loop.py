"""The training loop.

Counterpart of ``sdpgs_tpu/train/loop.py`` (the reference's ``training()``,
train.py:38-236): the view pop, the SH warm-up, the pseudo-view window with
its prefetched reprojection z-buffers, densify and prune every
``densification_interval`` iterations (with proximity bridging before
``proximity_until_iter``), the opacity reset, the capacity ladder that
reacts to the binning telemetry, evaluation, checkpoints and the persisted
report. The host reads the device only at log points, events and
evaluations: the steps are host-bound already.

With ``cfg.mesh_data * mesh_gauss * mesh_tile > 1`` every rank of an
initialized ``torch.distributed`` group of that many processes runs one
Trainer (JAX loop.py:91-119, 150-210, 260-310, 470-480): the state is
sharded (``parallel/sharding.py``), every rank draws the same views and
pseudo cameras from the same seed and takes its share of each batch, the
step is the mesh's, densify and prune (and the k-NN) run on the gathered
state with the same generator on every rank before it is split again, the
capacity ladder acts on telemetry maxed over the ranks so that all grow
together, and rank 0 alone writes checkpoints and the model directory.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sdpgs_torch import default_device
from sdpgs_torch.config import TrainConfig
from sdpgs_torch.core.camera import Camera
from sdpgs_torch.data.scene import Scene
from sdpgs_torch.losses import psnr as psnr_fn
from sdpgs_torch.losses import reproject_fused_depth_batch
from sdpgs_torch.losses import ssim as ssim_fn
from sdpgs_torch.opt.densify import densify_and_prune, reset_opacity
from sdpgs_torch.ops.knn import knn
from sdpgs_torch.render import render
from sdpgs_torch.train.state import TrainState, save_checkpoint
from sdpgs_torch.train.step import PseudoInputs, ViewBatch, make_train_step

# Pseudo cameras are drawn without replacement from ~10k poses, so no
# z-buffer is ever reused: the next REPROJ_PREFETCH cameras' z-buffers are
# built in one call (one K6 launch on the card) and held in a bounded queue.
REPROJ_PREFETCH = 64


def prefetch_pseudo_reproj(train_depths: torch.Tensor, K: torch.Tensor, R_train: torch.Tensor,
                           t_train: torch.Tensor, cameras: Sequence[Camera]
                           ) -> List[Tuple[Camera, torch.Tensor, torch.Tensor]]:
    """The fused reprojection depth and weight ([H, W] each) of every
    pseudo camera in ``cameras``, from the train views' depths
    ([V, H, W]), intrinsics and world -> camera poses, on the depths'
    device. Returns [(camera, fused, weight)] in order.

    JAX's Trainer recomputes a camera whose rows fell outside its TPU
    z-buffer's displacement window one by one. The port's z-buffer has no
    window and scatters every row, so its outlier count is always 0 and is
    not read (reading it would synchronise the device with the host)."""
    dev = train_depths.device
    R = torch.stack([c.view[:3, :3] for c in cameras]).to(dev)
    t = torch.stack([c.view[:3, 3] for c in cameras]).to(dev)
    fused, weight, _ = reproject_fused_depth_batch(train_depths, K, R_train, t_train, R, t)
    return [(c, fused[j], weight[j]) for j, c in enumerate(cameras)]


def build_view_batch(cams, indices, device=None) -> ViewBatch:
    """Stack the selected train views into a batch on ``device`` (``cuda``
    unless the caller asks for another); missing maps are zeros."""
    dev = default_device(device)
    sel = [cams[i] for i in indices]
    H, W = sel[0].height, sel[0].width
    zeros_img = np.zeros((3, H, W), np.float32)
    zeros_map = np.zeros((H, W), np.float32)

    def stack(name, zeros, dtype=np.float32):
        arr = np.stack([getattr(c, name) if getattr(c, name) is not None else zeros
                        for c in sel]).astype(dtype)
        return torch.from_numpy(arr).to(dev)

    return ViewBatch(cameras=[c.camera for c in sel], image=stack("image", zeros_img),
                     depth_mono=stack("depth_mono", zeros_map),
                     feature=stack("point_feature", zeros_img),
                     seg_map=stack("seg_map", zeros_map, np.int32))


class Trainer:
    """Trains ``scene.gaussians`` (a copy: the scene keeps its cloud) on
    ``device`` (``cuda`` unless the caller asks for another). Without a
    scene it loads ``data.scene.Scene(cfg)`` from ``cfg.model.source_path``;
    any object with the attributes of ``data.synthetic.SyntheticScene``
    serves as well.
    ``mono_depth_fn`` is a ``models.depth_estimator.MonoDepth`` or any
    callable ([3, H, W] image -> [H, W] inverse depth); without one,
    ``cfg.model.dpt_weights`` names a converted DPT checkpoint, and without
    that the pseudo steps keep the reprojection term alone."""

    # one card unless __init__ forms a mesh; rank 0 prints and writes
    mesh = None
    is_main = True
    MAX_PER_TILE_CEILING = 8192
    MAX_GRAD_WINDOW_SLACK = 2.0
    MAX_TILES_PER_GAUSSIAN_CEILING = 32

    def __init__(self, cfg: TrainConfig, scene=None, mono_depth_fn=None, device=None):
        n_mesh = cfg.mesh_data * cfg.mesh_gauss * cfg.mesh_tile
        if n_mesh > 1:
            ranks = dist.get_world_size() if dist.is_initialized() else 1
            if ranks != n_mesh:
                raise ValueError(f"mesh {cfg.mesh_data}x{cfg.mesh_gauss}x{cfg.mesh_tile} needs "
                                 f"{n_mesh} torch.distributed ranks, have {ranks}")
            if cfg.views_per_batch % cfg.mesh_data != 0:
                raise ValueError(f"views_per_batch={cfg.views_per_batch} must be a multiple "
                                 f"of mesh_data={cfg.mesh_data}")
        self.device = dev = default_device(device)
        self.cfg = cfg
        self.scene = scene = Scene(cfg, device=dev) if scene is None else scene
        if mono_depth_fn is None and cfg.model.dpt_weights:
            from sdpgs_torch.models.depth_estimator import make_mono_depth_fn

            mono_depth_fn = make_mono_depth_fn(
                cfg.model.dpt_weights, dtype=torch.bfloat16 if cfg.model.dpt_bf16 else None,
                matmul_precision=cfg.model.dpt_matmul_precision,
                resize_method=cfg.model.dpt_resize, device=dev)
        self.mono_depth_fn = mono_depth_fn if callable(mono_depth_fn) else None
        self.state = TrainState.create(copy.deepcopy(scene.gaussians), seed=cfg.seed, device=dev)
        # the device mesh: DP (views over data) x ZeRO (moments and statistics
        # over gauss) x tile-sharded rendering
        self._shardings = None
        if n_mesh > 1:
            from sdpgs_torch.parallel import make_mesh, shard_train_state, state_shardings

            self.mesh = make_mesh(data=cfg.mesh_data, gauss=cfg.mesh_gauss, tile=cfg.mesh_tile)
            self._shardings = state_shardings(self.mesh, self.state)
            self.state = shard_train_state(self.state, self.mesh)
            self.is_main = dist.get_rank() == 0

        from sdpgs_torch.eval.metrics import make_lpips_fn

        self.lpips_fn = make_lpips_fn(cfg.model.lpips_weights or None, device=dev)
        self.eval_history: list = []
        self.bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0, device=dev)
        self.prototypes = torch.as_tensor(np.asarray(scene.prototypes, np.float32), device=dev)
        self.spatial_lr_scale = float(np.float32(scene.cameras_extent))
        self._steps: Dict = {}
        self._rng = np.random.default_rng(cfg.seed)
        self._view_stack: list = []
        self._pseudo_stack: list = []
        # batches by view-index tuple: staging the images every iteration
        # would cost more host time than the step's own launches
        self._batch_cache: Dict[tuple, ViewBatch] = {}
        self._reproj_queue: list = []
        tc = scene.train_cameras
        self._train_depths = torch.from_numpy(np.stack(
            [c.depth_mono if c.depth_mono is not None
             else np.zeros((c.height, c.width), np.float32) for c in tc]
        ).astype(np.float32)).to(dev)
        self._K = torch.from_numpy(tc[0].intrinsics()).to(dev)
        self._R_train = torch.stack([c.camera.view[:3, :3] for c in tc]).to(dev)
        self._t_train = torch.stack([c.camera.view[:3, 3] for c in tc]).to(dev)

    # ---- step cache ------------------------------------------------------
    def _step_fn(self, sh_degree: int, with_pseudo: bool):
        """The train step by (SH degree, pseudo), cleared when the ladder
        changes ``cfg.raster``."""
        key = (sh_degree, with_pseudo)
        if key not in self._steps:
            self._steps[key] = make_train_step(self.cfg, sh_degree, with_pseudo=with_pseudo,
                                               mono_depth_fn=self.mono_depth_fn,
                                               tile_mesh=self.mesh, out_shardings=self._shardings)
        return self._steps[key]

    def _next_view(self) -> int:
        """Random camera pop without replacement (train.py:89-92)."""
        if not self._view_stack:
            self._view_stack = list(range(len(self.scene.train_cameras)))
        i = self._rng.integers(0, len(self._view_stack))
        return self._view_stack.pop(int(i))

    def _next_batch(self) -> ViewBatch:
        V = max(1, int(self.cfg.views_per_batch))
        if self.mesh is None:
            V = min(V, len(self.scene.train_cameras))
        # under a mesh V stays a multiple of mesh_data even when the scene
        # has fewer train views (few-shot: 3); a batch may repeat a view
        idx = tuple(sorted(self._next_view() for _ in range(V)))
        if idx not in self._batch_cache:
            batch = build_view_batch(self.scene.train_cameras, list(idx), device=self.device)
            if self.mesh is not None:
                from sdpgs_torch.parallel import shard_batch

                batch = shard_batch(batch, self.mesh)
            self._batch_cache[idx] = batch
        return self._batch_cache[idx]

    def _next_pseudo(self) -> int:
        if not self._pseudo_stack:
            self._pseudo_stack = list(range(len(self.scene.pseudo_poses)))
        i = self._rng.integers(0, len(self._pseudo_stack))
        return self._pseudo_stack.pop(int(i))

    def _next_pseudo_reproj(self):
        """The next pseudo camera with its reprojection z-buffer and its
        world -> camera R, t on the device: (camera, fused, weight, R, t).
        The next REPROJ_PREFETCH cameras are drawn, warped and copied to the
        device together when the queue runs dry (a copy from the host waits
        for the device, so not one per iteration)."""
        if not self._reproj_queue:
            idxs = [self._next_pseudo() for _ in range(REPROJ_PREFETCH)]
            cams = [self.scene.pseudo_camera(i)[0] for i in idxs]
            views = torch.stack([c.view for c in cams]).to(self.device)
            self._reproj_queue = [
                (cam, fused, weight, views[j, :3, :3], views[j, :3, 3])
                for j, (cam, fused, weight) in enumerate(prefetch_pseudo_reproj(
                    self._train_depths, self._K, self._R_train, self._t_train, cams))]
        return self._reproj_queue.pop(0)

    # ---- events ----------------------------------------------------------
    def _maybe_densify(self, iteration: int):
        """Densify and prune on the cadence of train.py:205-230; returns
        the DensifyInfo of an event (device tensors), else None."""
        opt = self.cfg.optim
        if iteration >= opt.densify_until_iter:
            return None
        if iteration <= opt.densify_from_iter or iteration % opt.densification_interval != 0:
            return None
        state = self._whole_state()
        g = state.gaussians
        run_prox = iteration < opt.proximity_until_iter
        knn_dist = knn_idx = None
        if run_prox:
            d2, knn_idx = knn(g.xyz.detach(), k=3, mask=g.alive, device=self.device)
            finite = torch.isfinite(d2)
            knn_dist = (torch.where(finite, d2, 0.0).sum(-1)
                        / torch.clamp_min(finite.sum(-1), 1))
        # the split children's offsets: the event's one random draw
        noise = torch.randn((g.capacity, 3), generator=state.generator, device=self.device)
        _, _, state.stats, info = densify_and_prune(
            g, state.opt_state, state.stats, noise,
            grad_threshold=opt.densify_grad_threshold, min_opacity=opt.prune_threshold,
            extent=float(self.scene.cameras_extent), percent_dense=opt.percent_dense,
            run_proximity=run_prox, knn_dist=knn_dist, knn_idx=knn_idx)
        if self.mesh is not None:
            from sdpgs_torch.parallel import shard_train_state

            self.state = shard_train_state(state, self.mesh)
        return info

    def _whole_state(self) -> TrainState:
        """The state with its moments and statistics whole (gathered over the
        mesh's ``gauss`` axis on every rank)."""
        if self.mesh is None:
            return self.state
        from sdpgs_torch.parallel import gather_train_state

        return gather_train_state(self.state, self.mesh)

    def save_checkpoint(self, checkpoint_dir, step: int) -> None:
        """``<checkpoint_dir>/ckpt_<step>.pt`` of the whole state, written by
        rank 0 once every rank has gathered it."""
        state = self._whole_state()
        if self.is_main:
            save_checkpoint(checkpoint_dir, state, step)
        if self.mesh is not None:
            dist.barrier()

    def _maybe_reset_opacity(self, iteration: int) -> bool:
        """Reset the opacities where the schedule says; returns whether it did."""
        opt = self.cfg.optim
        fires = (iteration > opt.start_sample_pseudo
                 and (iteration - opt.start_sample_pseudo - 1) % opt.opacity_reset_interval == 0)
        if fires:
            reset_opacity(self.state.gaussians, self.state.opt_state)
        return fires

    def _set_raster(self, new, msg: str) -> None:
        if self.is_main:
            print(f"{msg} (new step)", flush=True)
        self.cfg.raster = new
        self._steps.clear()

    def _maybe_grow_max_per_tile(self, overflow: int) -> None:
        """Table overflow: double the per-tile cap K up to a ceiling (JAX's
        ``_maybe_grow_block_slots``). JAX's rungs before it resize the TPU
        rank kernel's block slots (S, the pooled tail, the grouped layout)
        and run only with that kernel on; K2 has no such capacity, so here
        K is the only rung and ``rank_block_*`` keep their values."""
        r = self.cfg.raster
        if r.max_per_tile >= self.MAX_PER_TILE_CEILING:
            print(f"binning overflow={overflow}: K at ceiling {r.max_per_tile}; dropping "
                  "excess entries", flush=True)
            return
        new = dataclasses.replace(r, max_per_tile=r.max_per_tile * 2)
        self._set_raster(new, f"binning overflow={overflow}: per-tile cap K={r.max_per_tile} "
                              f"-> {new.max_per_tile}")

    def _maybe_grow_slab(self, slab: int) -> None:
        """Gradient-window slab drops grow ``grad_window_slack`` alone,
        geometrically up to a ceiling. The port's backward has no slab (its
        count is always 0), so this runs only for a state carried across
        from the JAX package."""
        r = self.cfg.raster
        if r.grad_window_slack >= self.MAX_GRAD_WINDOW_SLACK:
            print(f"grad-window slab drops={slab}: slack at ceiling "
                  f"{r.grad_window_slack:.2f}; gradients of excess rows dropped", flush=True)
            return
        new = dataclasses.replace(r, grad_window_slack=min(self.MAX_GRAD_WINDOW_SLACK,
                                                           r.grad_window_slack * 1.3))
        self._set_raster(new, f"grad-window slab drops={slab}: slack "
                              f"{r.grad_window_slack:.2f} -> {new.grad_window_slack:.2f}")

    def _maybe_grow_tiles_per_gaussian(self, clipped: int) -> None:
        """Clipped rects (a splat over more than D tiles lost its tail
        tiles): double D up to a ceiling."""
        r = self.cfg.raster
        if r.max_tiles_per_gaussian >= self.MAX_TILES_PER_GAUSSIAN_CEILING:
            print(f"binning clipped={clipped}: D at ceiling {r.max_tiles_per_gaussian}; "
                  "dropping rect tails", flush=True)
            return
        new = dataclasses.replace(r, max_tiles_per_gaussian=r.max_tiles_per_gaussian * 2)
        self._set_raster(new, f"binning clipped={clipped}: per-Gaussian rect cap "
                              f"D={r.max_tiles_per_gaussian} -> {new.max_tiles_per_gaussian}")

    def _react_to_telemetry(self) -> Tuple[int, int]:
        """Read the running maxima of the drops since the last look (maxed
        over the ranks of a mesh, so that every rank grows alike), grow the
        capacities they call for, and reset them. Returns (overflow,
        clipped)."""
        s = self.state
        seen = torch.stack([s.max_overflow, s.max_clipped, s.max_slab])
        if self.mesh is not None:
            from sdpgs_torch.parallel import comm

            comm.all_max(seen, dist.group.WORLD)
        mo, mc, ms = (int(v) for v in seen.tolist())
        if mo > 0:
            self._maybe_grow_max_per_tile(mo)
        if mc > 0:
            self._maybe_grow_tiles_per_gaussian(mc)
        if ms > 0:
            self._maybe_grow_slab(ms)
        if mo > 0 or mc > 0 or ms > 0:
            for k in ("max_overflow", "max_clipped", "max_slab"):
                getattr(s, k).zero_()
        return mo, mc

    def restore(self, checkpoint_dir, step: int) -> None:
        """Resume from ``<checkpoint_dir>/ckpt_<step>.pt`` (reference
        --start_checkpoint, train.py:46-48)."""
        from sdpgs_torch.train.state import restore_checkpoint

        state = restore_checkpoint(checkpoint_dir, step, self._whole_state())
        if self.mesh is not None:     # every rank reads it, then takes its share
            from sdpgs_torch.parallel import shard_train_state

            state = shard_train_state(state, self.mesh)
        self.state = state

    # ---- main loop -------------------------------------------------------
    def train(self, iterations: Optional[int] = None, log_every: int = 100, on_eval=None):
        opt = self.cfg.optim
        iterations = iterations or opt.iterations
        history = []
        t_start = time.time()
        first_iter = self.state.step + 1
        # the SH warm-up follows the global iteration on resume
        sh_degree = min((first_iter - 1) // 500, self.cfg.model.sh_degree)
        dev = self.device
        for iteration in range(first_iter, iterations + 1):
            if iteration % 500 == 0:
                sh_degree = min(sh_degree + 1, self.cfg.model.sh_degree)
            in_pseudo = (opt.start_sample_pseudo < iteration < opt.end_sample_pseudo
                         and iteration % opt.sample_pseudo_interval == 0)
            batch = self._next_batch()
            step = self._step_fn(sh_degree, in_pseudo)
            pseudo = None
            if in_pseudo:
                cam, fused, weight, R, t = self._next_pseudo_reproj()
                V = len(batch.cameras)
                pseudo = PseudoInputs(
                    camera=cam, train_depths=self._train_depths, K=self._K,
                    R_train=self._R_train, t_train=self._t_train, R_pseudo=R, t_pseudo=t,
                    reproj_fused=fused, reproj_weight=weight,
                    # the reference's sampled train view (train.py:156)
                    train_view_idx=0 if V == 1 else int(self._rng.integers(0, V)))
            self.state, metrics = step(self.state, batch, self.prototypes, self.bg,
                                       self.spatial_lr_scale, pseudo, device=dev)

            self._maybe_densify(iteration)
            self._maybe_reset_opacity(iteration)

            if iteration % log_every == 0 or iteration == iterations:
                # the running maxima folded every step's drops since the
                # last look, so none slips between log points
                mo, mc = self._react_to_telemetry()
                m = {k: float(getattr(metrics, k)) for k in ("loss", "l1", "psnr")}
                alive = int(metrics.num_alive)
                rate = (iteration - first_iter + 1) / (time.time() - t_start)
                if self.is_main:
                    print(f"[{iteration}/{iterations}] loss={m['loss']:.5f} l1={m['l1']:.5f} "
                          f"psnr={m['psnr']:.2f} alive={alive} overflow={mo} clipped={mc} "
                          f"({rate:.2f} it/s)", flush=True)
                history.append({"iter": iteration, "loss": m["loss"], "psnr": m["psnr"],
                                "alive": alive})

            if iteration in opt.test_iterations:
                if on_eval is not None:
                    on_eval(self, iteration)
                else:
                    self._training_report(iteration, sh_degree)
            if self.scene.model_path and iteration in opt.save_iterations and self.is_main:
                self.scene.save(iteration, self.state.gaussians)
            if self.scene.model_path and iteration in opt.checkpoint_iterations:
                self.save_checkpoint(Path(self.scene.model_path) / "checkpoints", iteration)
        if self.scene.model_path and self.is_main:
            mp = Path(self.scene.model_path)
            mp.mkdir(parents=True, exist_ok=True)
            (mp / "training_history.json").write_text(json.dumps(history, indent=2))
            self._persist_results()
        return history

    # ---- evaluation ------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, cameras=None, sh_degree: Optional[int] = None) -> dict:
        """L1 / PSNR / SSIM (and LPIPS with weights) over held-out views
        (training_report, reference train.py:275-300)."""
        cams = cameras if cameras is not None else self.scene.test_cameras
        if not cams:
            return {}
        deg = self.cfg.model.sh_degree if sh_degree is None else sh_degree
        l1s, psnrs, ssims, lpipss = [], [], [], []
        for c in cams:
            out = render(c.camera, self.state.gaussians, self.cfg.raster, self.bg, deg,
                         device=self.device)
            img = torch.clamp(out.color.permute(2, 0, 1), 0.0, 1.0)
            gt = torch.clamp(torch.tensor(np.asarray(c.image, np.float32), device=self.device),
                             0.0, 1.0)
            l1s.append(float(torch.mean(torch.abs(img - gt))))
            psnrs.append(float(psnr_fn(img, gt)))
            ssims.append(float(ssim_fn(img, gt)))
            lv = self.lpips_fn(img, gt)  # None without converted weights
            if lv is not None:
                lpipss.append(float(lv))
        res = {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs)),
               "ssim": float(np.mean(ssims)), "n_views": len(cams)}
        if lpipss:
            res["lpips"] = float(np.mean(lpipss))
        return res

    def _training_report(self, iteration: int, sh_degree: int) -> dict:
        """The per-``test_iterations`` report (reference train.py:263-307):
        test and train views evaluated, printed and persisted."""
        report = {"iteration": iteration}
        for name, cams in (("test", self.scene.test_cameras), ("train", self.scene.train_cameras)):
            if not cams:
                continue
            res = self.evaluate(cameras=cams, sh_degree=sh_degree)
            report[name] = res
            extra = f" LPIPS {res['lpips']:.4f}" if "lpips" in res else ""
            if self.is_main:
                print(f"\n[ITER {iteration}] Evaluating {name}: L1 {res['l1']:.5f} PSNR "
                      f"{res['psnr']:.3f} SSIM {res['ssim']:.4f}{extra}", flush=True)
        report["total_points"] = self.state.gaussians.num_alive()
        self.eval_history.append(report)
        self._persist_results()
        return report

    def _persist_results(self) -> None:
        """Write the eval history to the model dir (the reference's
        tensorboard role); rank 0 alone on a mesh."""
        if not self.scene.model_path or not self.is_main:
            return
        mp = Path(self.scene.model_path)
        mp.mkdir(parents=True, exist_ok=True)
        (mp / "eval_results.json").write_text(json.dumps(self.eval_history, indent=2))
