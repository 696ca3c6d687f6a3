"""The plain train step.

Counterpart of ``sdpgs_tpu/train/step.py`` with ``with_pseudo=False``
(reference train.py:93-134): one combined loss, one backward, one Adam
step per iteration:
- photometric (1 - lambda) L1 + lambda (1 - SSIM)       (train.py:99-100)
- language-feature CE + L1 + smoothness                 (train.py:102-109)
- mono-depth Pearson with the disparity fallback        (train.py:126-131),
  its weight dropping to ``depth_weight_late`` after end_sample_pseudo.
The JAX package vmaps the render over the view batch; the port loops over
the views, as the JAX ``unroll_views`` branch does, and takes one backward
of the mean loss. On CUDA the renders run K1-K3 and the backward K5 and
K4. Screen-space densification gradients come from differentiating with
respect to an all-zeros per-view ``means2d_offset``.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch

from sdpgs_torch import default_device
from sdpgs_torch.config import TrainConfig
from sdpgs_torch.core.camera import Camera
from sdpgs_torch.losses import (
    depth_pearson_loss,
    l1_loss_mask,
    loss_feature_metric,
    psnr,
    ssim,
)
from sdpgs_torch.opt.adam import TRAINABLE, adam_update, learning_rates
from sdpgs_torch.opt.densify import add_densification_stats_batched
from sdpgs_torch.render import render
from sdpgs_torch.train.state import TrainState


class StepMetrics(NamedTuple):
    """0-d tensors on the train device (read them on the host when needed)."""

    loss: torch.Tensor
    l1: torch.Tensor
    psnr: torch.Tensor
    overflow: torch.Tensor   # entries dropped by the per-tile K cap
    clipped: torch.Tensor    # tile slots dropped by the per-Gaussian D cap
    num_alive: torch.Tensor
    slab: torch.Tensor       # always 0 in the port (JAX's windowed backward)


class ViewBatch(NamedTuple):
    """One batch of training views (leading axis = view)."""

    cameras: List[Camera]          # same H, W across views
    image: torch.Tensor            # [V, 3, H, W] ground truth
    depth_mono: torch.Tensor       # [V, H, W] aligned mono depth prior
    feature: torch.Tensor          # [V, 3, H, W] per-pixel language feature
    seg_map: torch.Tensor          # [V, H, W] int segment ids


class Gradients(NamedTuple):
    """What one backward of the combined loss gives."""

    loss: torch.Tensor                 # 0-d, detached
    params: dict                       # field -> gradient
    offsets: torch.Tensor              # [V, P, 2] screen-space gradients
    l1: torch.Tensor                   # [V]
    images: torch.Tensor               # [V, 3, H, W] rendered, detached
    outs: list                         # the per-view RenderOutputs


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


def loss_and_grads(state: TrainState, batch: ViewBatch, prototypes, bg, cfg: TrainConfig,
                   sh_degree: int, device: torch.device) -> Gradients:
    """Render every view, form the mean combined loss and take its one
    backward with respect to the trainable fields and the offsets."""
    g = state.gaussians
    params = [getattr(g, k) for k in TRAINABLE]
    conf = g.confidence if cfg.pipeline.use_confidence else None
    offsets = [torch.zeros((g.capacity, 2), dtype=torch.float32, device=device,
                           requires_grad=True) for _ in batch.cameras]
    losses, l1s, images, outs = [], [], [], []
    for v, cam in enumerate(batch.cameras):
        out = render(cam, g, cfg.raster, bg, sh_degree, means2d_offset=offsets[v],
                     confidence=conf, device=device)
        loss_v, (ll1, image) = _view_losses_from_out(
            out, batch.image[v], batch.depth_mono[v], batch.feature[v], batch.seg_map[v],
            prototypes, cfg, state.step)
        losses.append(loss_v)
        l1s.append(ll1.detach())
        images.append(image.detach())
        outs.append(out)
    loss = torch.stack(losses).mean()
    grads = torch.autograd.grad(loss, params + offsets, allow_unused=True)
    param_grads = {k: torch.zeros_like(p) if d is None else d
                   for k, p, d in zip(TRAINABLE, params, grads[:len(params)])}
    return Gradients(loss=loss.detach(), params=param_grads,
                     offsets=torch.stack(grads[len(params):]), l1=torch.stack(l1s),
                     images=torch.stack(images), outs=outs)


def make_train_step(cfg: TrainConfig, sh_degree: int, with_pseudo: bool = False,
                    tile_mesh=None, out_shardings=None) -> Callable:
    """The train step for an active SH degree (the reference raises the
    degree every 500 iterations, train.py:85-86).

    ``step(state, batch, prototypes, bg, spatial_lr_scale, device=None)``
    runs on ``device`` (``cuda`` unless the caller asks for another), where
    ``state`` must live; it updates the state's parameters, moments and
    statistics in place under ``torch.no_grad`` and returns
    ``(state, StepMetrics)``."""
    if with_pseudo:
        raise NotImplementedError(
            "with_pseudo=True: the pseudo-view branch comes with the pseudo-view slice "
            "(ROADMAP.md queue A, item 10)")
    if tile_mesh is not None or out_shardings is not None:
        raise NotImplementedError(
            "tile_mesh / out_shardings: multi-card training comes with the parallelism "
            "slice (ROADMAP.md queue A, item 13)")

    def step(state: TrainState, batch: ViewBatch, prototypes, bg, spatial_lr_scale,
             device=None):
        dev = default_device(device)
        if state.device.type != dev.type:
            raise ValueError(f"state lives on {state.device}, train device is {dev}")
        bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
        prototypes = torch.as_tensor(prototypes, dtype=torch.float32, device=dev)
        grads = loss_and_grads(state, batch, prototypes, bg, cfg, sh_degree, dev)

        with torch.no_grad():
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
                slab=torch.stack([o.slab for o in grads.outs]).amax(),
            )
            state.step += 1
            state.max_overflow = torch.maximum(state.max_overflow, metrics.overflow)
            state.max_clipped = torch.maximum(state.max_clipped, metrics.clipped)
            state.max_slab = torch.maximum(state.max_slab, metrics.slab)
        return state, metrics

    return step
