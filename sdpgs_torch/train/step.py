"""The train step.

Counterpart of ``sdpgs_tpu/train/step.py`` (reference train.py:93-194):
one combined loss, one backward, one Adam step per iteration:
- photometric (1 - lambda) L1 + lambda (1 - SSIM)       (train.py:99-100)
- language-feature CE + L1 + smoothness                 (train.py:102-109)
- mono-depth Pearson with the disparity fallback        (train.py:126-131),
  its weight dropping to ``depth_weight_late`` after end_sample_pseudo;
- with ``with_pseudo``, the pseudo-view branch (train.py:138-188): a render
  from a pseudo camera, the Pearson of its depth against the depth net's
  estimate (differentiable through the net into the image), the
  per-segment Pearson after iteration 4000, and the multi-view
  reprojection consistency.
The JAX package vmaps the render over the view batch; the port loops over
the views, as the JAX ``unroll_views`` branch does, renders the pseudo
view through the same ``render``, and takes one backward of the total.
On CUDA every render runs K1-K3 and the backward K5 and K4. Screen-space
densification gradients come from differentiating with respect to an
all-zeros per-view ``means2d_offset`` of the train views only.

On a (data, gauss, tile) mesh (``parallel/``; JAX's ``tile_mesh`` and
``out_shardings``) each rank takes its share of the views, renders its
share of each view's tiles (``parallel/tile_shard.py``: the payload
gradient summed over ``tile`` inside the backward), averages the
parameter gradients over ``data`` and updates its slots of the moments,
whose parameter rows are then gathered over ``gauss`` (ZeRO-1). The
densification increments are summed (the radius maxed) over ``data`` from
offset gradients already whole over ``tile``, since their norm is not
linear. Every metric equals the single-card step's: the loss, L1 and PSNR
averaged over all views, the telemetry maxed over them.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from sdpgs_torch import default_device
from sdpgs_torch.config import TrainConfig
from sdpgs_torch.core.camera import Camera
from sdpgs_torch.losses import (
    depth_pearson_loss,
    l1_loss_mask,
    loss_feature_metric,
    loss_reproject_depth,
    loss_reproject_from_fused,
    pearson_corrcoef,
    psnr,
    segment_cluster_assign,
    segment_pearson_loss,
    ssim,
)
from sdpgs_torch.ops.rasterize.rasterizer import RenderOutput
from sdpgs_torch.opt.adam import TRAINABLE, adam_update, learning_rates
from sdpgs_torch.opt.densify import (
    DensifyStats,
    add_densification_stats_batched,
    apply_increments,
    densification_increments,
)
from sdpgs_torch.render import render
from sdpgs_torch.train.state import TrainState
from sdpgs_torch.utils.profiling import span


class StepMetrics(NamedTuple):
    """0-d tensors on the train device (read them on the host when needed)."""

    loss: torch.Tensor
    l1: torch.Tensor
    psnr: torch.Tensor
    overflow: torch.Tensor   # entries dropped by the per-tile K cap
    clipped: torch.Tensor    # tile slots dropped by the per-Gaussian D cap
    num_alive: torch.Tensor


class ViewBatch(NamedTuple):
    """One batch of training views (leading axis = view)."""

    cameras: List[Camera]          # same H, W across views
    image: torch.Tensor            # [V, 3, H, W] ground truth
    depth_mono: torch.Tensor       # [V, H, W] aligned mono depth prior
    feature: torch.Tensor          # [V, 3, H, W] per-pixel language feature
    seg_map: torch.Tensor          # [V, H, W] int segment ids


class PseudoInputs(NamedTuple):
    """Inputs of the pseudo-view branch (the JAX fields)."""

    camera: Camera                 # the pseudo camera
    train_depths: torch.Tensor     # [V, H, W] aligned mono depths of the train views
    K: torch.Tensor                # [3, 3]
    R_train: torch.Tensor          # [V, 3, 3] world -> camera
    t_train: torch.Tensor          # [V, 3]
    R_pseudo: torch.Tensor         # [3, 3]
    t_pseudo: torch.Tensor         # [3]
    # (JAX's mono_params has no counterpart: the port's depth net is a
    # module that holds its weights.)
    # The fused reprojection z-buffer (losses.reproject_fused_depth):
    # independent of the Gaussians, so prefetched once per pseudo camera
    # (train/loop.prefetch_pseudo_reproj). None: the warp runs in the step.
    reproj_fused: Optional[torch.Tensor] = None    # [H, W]
    reproj_weight: Optional[torch.Tensor] = None   # [H, W] 0/1
    # Which view of the batch plays the reference's sampled train view for
    # pseudo_seg_from_train_view (train.py:156).
    train_view_idx: int = 0


class Gradients(NamedTuple):
    """What one backward of the combined loss gives."""

    loss: torch.Tensor                 # 0-d, detached
    params: dict                       # field -> gradient
    offsets: torch.Tensor              # [V, P, 2] screen-space gradients
    l1: torch.Tensor                   # [V]
    images: torch.Tensor               # [V, 3, H, W] rendered, detached
    outs: list                         # the per-view RenderOutputs
    pseudo_out: Optional[RenderOutput] = None   # the pseudo view's render


def _view_losses_from_out(out, gt_img, mono, gt_feat, seg, protos, cfg: TrainConfig,
                          step: int):
    """One view's combined loss (JAX step.py:114-133); returns
    (loss, (l1, image [3, H, W]))."""
    opt = cfg.optim
    image = out.color.permute(2, 0, 1)
    ll1 = l1_loss_mask(image, gt_img)
    loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - ssim(image, gt_img))
    if opt.include_feature:
        lf, lsm = loss_feature_metric(out.feature.permute(2, 0, 1), gt_feat, protos, seg,
                                      known_fce=opt.known_fce, known_fl1=opt.known_fl1,
                                      known_fsm=opt.known_fsm)
        loss = loss + lf + lsm
    depth_w = opt.depth_weight_late if step > opt.end_sample_pseudo else opt.depth_weight
    loss = loss + depth_w * depth_pearson_loss(out.depth, mono, disparity_const=200.0)
    return loss, (ll1, image)


def _pseudo_losses(out, pseudo: PseudoInputs, protos, cfg: TrainConfig, step: int,
                   mono_depth_fn: Optional[Callable], train_feature=None) -> torch.Tensor:
    """The pseudo-view terms (JAX step.py:136-190, train.py:138-188) from
    the rendered pseudo view ``out``; 0-d.

    Segment labels come from the pseudo view's own rendered features, or
    from the train view's ([3, H, W] ``train_feature``) when
    ``cfg.optim.pseudo_seg_from_train_view`` is set, as the reference
    indexes them (train.py:156)."""
    opt = cfg.optim
    it = float(step)
    loss_scale = min(max((it - opt.start_sample_pseudo) / 500.0, 0.0), 1.0)
    depth = out.depth
    total = torch.zeros((), dtype=torch.float32, device=depth.device)

    if mono_depth_fn is not None:
        mono = mono_depth_fn(out.color.permute(2, 0, 1))                  # [H, W]
        pl = 1.0 - pearson_corrcoef(depth, -mono)
        total = total + loss_scale * opt.depth_pseudo_weight * torch.nan_to_num(pl)
        if it > 4000.0:     # the segment term is live after iteration 4000
            if opt.pseudo_seg_from_train_view and train_feature is not None:
                label_feat = train_feature
            else:
                label_feat = out.feature.permute(2, 0, 1)
            labels = segment_cluster_assign(label_feat.detach(), protos)
            seg_loss = segment_pearson_loss(depth, mono, labels, protos.shape[0])
            seg_scale = min(max((it - opt.start_sample_pseudo) / 8000.0, 0.0), 1.0)
            total = total + (0.25 * seg_scale * opt.depth_pseudo_weight
                             * torch.nan_to_num(seg_loss))

    if pseudo.reproj_fused is not None:
        reproj = loss_reproject_from_fused(depth, pseudo.reproj_fused, pseudo.reproj_weight)
    else:
        reproj = loss_reproject_depth(depth, pseudo.train_depths, pseudo.K, pseudo.R_train,
                                      pseudo.t_train, pseudo.R_pseudo, pseudo.t_pseudo)
    return total + 0.5 * loss_scale * opt.depth_pseudo_weight * torch.nan_to_num(reproj)


def loss_and_grads(state: TrainState, batch: ViewBatch, prototypes, bg, cfg: TrainConfig,
                   sh_degree: int, device: torch.device, pseudo: Optional[PseudoInputs] = None,
                   mono_depth_fn: Optional[Callable] = None, tile_mesh=None,
                   data_mesh=None) -> Gradients:
    """Render every view, form the mean combined loss (plus the pseudo-view
    terms when ``pseudo`` is given) and take its one backward with respect
    to the trainable fields and the train views' offsets. ``tile_mesh``
    shards each render's tiles; ``data_mesh``, a mesh whose ``data`` axis
    split the batch, gives the pseudo branch its train view from the rank
    that holds it."""
    with span("step.forward"):
        g = state.gaussians
        conf = g.confidence if cfg.pipeline.use_confidence else None
        params = [getattr(g, k) for k in TRAINABLE]
        offsets = [torch.zeros((g.capacity, 2), dtype=torch.float32, device=device,
                               requires_grad=True) for _ in batch.cameras]
        losses, l1s, images, outs = [], [], [], []
        for v, cam in enumerate(batch.cameras):
            out = render(cam, g, cfg.raster, bg, sh_degree, means2d_offset=offsets[v],
                         confidence=conf, device=device, tile_mesh=tile_mesh)
            loss_v, (ll1, image) = _view_losses_from_out(
                out, batch.image[v], batch.depth_mono[v], batch.feature[v], batch.seg_map[v],
                prototypes, cfg, state.step)
            losses.append(loss_v)
            l1s.append(ll1.detach())
            images.append(image.detach())
            outs.append(out)
        loss = torch.stack(losses).mean()
        out_ps = None
        if pseudo is not None:
            # no offset: the densification statistics come from the train
            # views only (train.py:218-221)
            out_ps = render(pseudo.camera, g, cfg.raster, bg, sh_degree, confidence=conf,
                            device=device, tile_mesh=tile_mesh)
            train_feat = _train_feature(outs, pseudo.train_view_idx, cfg, data_mesh)
            loss = loss + _pseudo_losses(out_ps, pseudo, prototypes, cfg, state.step,
                                         mono_depth_fn, train_feature=train_feat)
    with span("step.backward"):
        grads = torch.autograd.grad(loss, params + offsets, allow_unused=True)
    param_grads = {k: torch.zeros_like(p) if d is None else d
                   for k, p, d in zip(TRAINABLE, params, grads[:len(params)])}
    return Gradients(loss=loss.detach(), params=param_grads,
                     offsets=torch.stack(grads[len(params):]), l1=torch.stack(l1s),
                     images=torch.stack(images), outs=outs,
                     pseudo_out=out_ps)


def _close_step(state: TrainState, metrics: StepMetrics, grads: Gradients) -> tuple:
    """The bookkeeping that ends every step, on one card or a mesh: advance
    the iteration counter, fold the step's drops into the running maxima,
    and every render of the step (the pseudo view's too) into the running
    sum of listed entries and running max of the per-tile totals: four
    device operations a render and no synchronisation. Returns
    ``(state, metrics)``."""
    state.step += 1
    state.max_overflow = torch.maximum(state.max_overflow, metrics.overflow)
    state.max_clipped = torch.maximum(state.max_clipped, metrics.clipped)
    rendered = grads.outs if grads.pseudo_out is None else grads.outs + [grads.pseudo_out]
    for o in rendered:
        state.raster_entries.add_(o.tile_counts.sum())
        torch.maximum(state.raster_tile_max, o.tile_totals.amax(), out=state.raster_tile_max)
    return state, metrics


def _train_feature(outs, idx: int, cfg: TrainConfig, data_mesh) -> torch.Tensor:
    """The [3, H, W] feature render of the batch's view ``idx`` (only its
    labels are read: pseudo_seg_from_train_view). With the views split over
    ``data`` the rank that rendered it hands it to the others."""
    if data_mesh is None or data_mesh.shape["data"] == 1:
        return outs[idx].feature.permute(2, 0, 1)
    if not cfg.optim.pseudo_seg_from_train_view:
        return None
    from sdpgs_torch.parallel import comm

    owner, local = divmod(idx, len(outs))
    feat = outs[local].feature.detach().permute(2, 0, 1).contiguous()
    if data_mesh.coords["data"] != owner:
        feat = torch.zeros_like(feat)
    return comm.all_sum(feat, data_mesh.group("data"))


def make_train_step(cfg: TrainConfig, sh_degree: int, with_pseudo: bool = False,
                    mono_depth_fn: Optional[Callable] = None, tile_mesh=None,
                    out_shardings=None) -> Callable:
    """The train step for an active SH degree (the reference raises the
    degree every 500 iterations, train.py:85-86). With ``with_pseudo`` the
    pseudo-view terms join the same loss and backward; ``mono_depth_fn``
    ([3, H, W] image -> [H, W] inverse depth, differentiable in the image,
    e.g. a ``models.depth_estimator.MonoDepth``) enables the depth-net
    terms, and without it only the reprojection term runs (as a run
    without ``dpt_weights``).

    ``step(state, batch, prototypes, bg, spatial_lr_scale, pseudo=None,
    device=None)`` runs on ``device`` (``cuda`` unless the caller asks for
    another), where ``state`` must live; it updates the state's parameters,
    moments and statistics in place under ``torch.no_grad`` and returns
    ``(state, StepMetrics)``.

    ``tile_mesh`` (a ``parallel.Mesh`` with a ``tile`` axis) renders each
    view tile-sharded. ``out_shardings`` (``parallel.state_shardings``)
    makes the step the mesh's: ``state`` is this rank's share
    (``parallel.shard_train_state``) and ``batch`` its views
    (``parallel.shard_batch``). A mesh whose ``data`` or ``gauss`` axis
    exceeds 1 needs ``out_shardings``."""
    mesh = out_shardings.mesh if out_shardings is not None else tile_mesh
    if tile_mesh is not None and out_shardings is not None and tile_mesh is not mesh:
        raise ValueError("tile_mesh and out_shardings name different meshes")
    if (out_shardings is None and mesh is not None
            and (mesh.shape["data"] > 1 or mesh.shape["gauss"] > 1)):
        raise ValueError("a mesh with data or gauss above 1 needs out_shardings "
                         "(parallel.state_shardings)")

    def step(state: TrainState, batch: ViewBatch, prototypes, bg, spatial_lr_scale,
             pseudo: Optional[PseudoInputs] = None, device=None):
        dev = default_device(device)
        if state.device.type != dev.type:
            raise ValueError(f"state lives on {state.device}, train device is {dev}")
        if with_pseudo != (pseudo is not None):
            raise ValueError("a step made with with_pseudo=True takes PseudoInputs, "
                             "and only such a step does")
        want = None if out_shardings is None else out_shardings.slots
        if state.slots != want:
            raise ValueError(f"the state holds slots {state.slots}, the step's sharding "
                             f"{want}")
        bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
        prototypes = torch.as_tensor(prototypes, dtype=torch.float32, device=dev)
        grads = loss_and_grads(state, batch, prototypes, bg, cfg, sh_degree, dev,
                               pseudo=pseudo, mono_depth_fn=mono_depth_fn,
                               tile_mesh=tile_mesh, data_mesh=mesh)
        if out_shardings is not None:
            with span("step.update"):
                return _mesh_update(state, batch, grads, cfg, spatial_lr_scale, mesh)

        with torch.no_grad(), span("step.update"):
            g = state.gaussians
            lrs = learning_rates(cfg.optim, state.step, float(spatial_lr_scale))
            state.opt_state = adam_update(g, grads.params, state.opt_state, lrs)
            H, W = batch.image.shape[-2:]
            state.stats = add_densification_stats_batched(
                state.stats, grads.offsets, torch.stack([o.visibility for o in grads.outs]),
                torch.stack([o.radii for o in grads.outs]), W, H)
            metrics = StepMetrics(
                loss=grads.loss,
                l1=grads.l1.mean(),
                psnr=torch.stack([psnr(torch.clamp(a, 0, 1), torch.clamp(b, 0, 1))
                                  for a, b in zip(grads.images, batch.image)]).mean(),
                overflow=torch.stack([o.overflow for o in grads.outs]).amax(),
                clipped=torch.stack([o.clipped for o in grads.outs]).amax(),
                num_alive=g.alive.sum().to(torch.int32),
            )
            return _close_step(state, metrics, grads)

    return step


@torch.no_grad()
def _mesh_update(state: TrainState, batch: ViewBatch, grads: Gradients, cfg: TrainConfig,
                 spatial_lr_scale, mesh) -> tuple:
    """The update of a sharded step: one sum over ``data`` of the gradients,
    the densification sums and the metrics' sums, one max over ``data`` of
    the radii and the telemetry, Adam on this rank's slots, and the gather
    of the parameters' rows over ``gauss``."""
    from sdpgs_torch.parallel import comm

    g = state.gaussians
    data, n_data = mesh.group("data"), mesh.shape["data"]
    V = len(batch.cameras) * n_data
    H, W = batch.image.shape[-2:]
    # the rank's loss is the mean over its V / n_data views: its offset
    # gradients are n_data times those of the mean over all V
    inc = densification_increments(grads.offsets / n_data,
                                   torch.stack([o.visibility for o in grads.outs]),
                                   torch.stack([o.radii for o in grads.outs]), W, H)
    psnrs = torch.stack([psnr(torch.clamp(a, 0, 1), torch.clamp(b, 0, 1))
                         for a, b in zip(grads.images, batch.image)])
    sums = [grads.params[k].reshape(-1) for k in TRAINABLE]
    n_grad = sum(t.numel() for t in sums)
    flat = comm.all_sum(torch.cat(sums + [
        inc.xyz_gradient_accum, inc.denom,
        torch.stack([grads.loss, grads.l1.sum(), psnrs.sum()])]), data)
    flat[:n_grad].div_(n_data)
    telemetry = torch.stack([torch.stack([getattr(o, k) for o in grads.outs]).amax()
                             for k in ("overflow", "clipped")])
    maxed = comm.all_max(torch.cat([inc.max_radii2d.double(), telemetry.double()]), data)
    P = g.capacity
    full, o = {}, 0
    for k in TRAINABLE:
        p = getattr(g, k)
        full[k] = flat[o:o + p.numel()].view_as(p)
        o += p.numel()
    inc = DensifyStats(xyz_gradient_accum=flat[n_grad:n_grad + P],
                       denom=flat[n_grad + P:n_grad + 2 * P],
                       max_radii2d=maxed[:P].float())
    loss, l1_sum, psnr_sum = flat[n_grad + 2 * P:]

    lrs = learning_rates(cfg.optim, state.step, float(spatial_lr_scale))
    lo, hi = state.slots
    state.opt_state = adam_update(g, full, state.opt_state, lrs, slots=(lo, hi))
    _gather_param_rows(g, lo, hi, mesh.group("gauss"))
    state.stats = apply_increments(state.stats, DensifyStats(
        *(getattr(inc, f)[lo:hi] for f in ("xyz_gradient_accum", "denom", "max_radii2d"))))
    overflow, clipped = (maxed[P + i].to(torch.int32) for i in range(2))
    metrics = StepMetrics(loss=loss / n_data, l1=l1_sum / V, psnr=psnr_sum / V,
                          overflow=overflow, clipped=clipped,
                          num_alive=g.alive.sum().to(torch.int32))
    return _close_step(state, metrics, grads)


@torch.no_grad()
def _gather_param_rows(g, lo: int, hi: int, group) -> None:
    """Every rank of the ``gauss`` axis updated its rows [lo, hi) of each
    trainable field: one gather makes the fields whole on all of them."""
    from sdpgs_torch.parallel import comm

    if group is None:
        return
    fields = [getattr(g, k) for k in TRAINABLE]
    buf = torch.zeros(sum(p.numel() for p in fields), dtype=torch.float32, device=g.device)
    o = 0
    for p in fields:
        w = p.numel() // p.shape[0]
        buf[o + lo * w:o + hi * w] = p[lo:hi].reshape(-1)
        o += p.numel()
    comm.all_sum(buf, group)
    o = 0
    for p in fields:
        p.copy_(buf[o:o + p.numel()].view_as(p))
        o += p.numel()
