"""The reference train step: render, the combined loss (and the pseudo-view
terms with the depth net), one backward, one Adam update.

Copied from ``sdpgs_torch/train/step.py`` (``_view_losses_from_out``,
``_pseudo_losses`` and the single-card update of ``make_train_step``) and
``sdpgs_torch/opt/adam.py`` (the learning-rate schedule and the update),
for a batch of one view, as the configurations train.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from benchmark.reference import losses as L
from benchmark.reference.camera import Cam
from benchmark.reference.raster import FIELDS, Raster, Rendered, render

B1, B2, EPS = 0.9, 0.999, 1e-15


def expon_lr(step: int, lr_init: float, lr_final: float, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> float:
    """Log-linear decay in f32 (no delay steps, as the program schedules xyz)."""
    f32 = np.float32
    lr_init, lr_final = f32(lr_init), f32(lr_final)
    if step < 0:
        return 0.0
    t = np.clip(f32(step) / f32(max_steps), f32(0.0), f32(1.0))
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    log_lerp = np.exp(np.log(max(lr_init, f32(1e-30))) * (f32(1.0) - t)
                      + np.log(max(lr_final, f32(1e-30))) * t)
    return float(f32(f32(1.0) * log_lerp))


def learning_rates(opt, step: int, spatial_lr_scale: float) -> Dict[str, float]:
    scale = float(np.float32(spatial_lr_scale))
    f = lambda v: float(np.float32(v))  # noqa: E731
    return {
        "xyz": expon_lr(step, opt.position_lr_init * scale, opt.position_lr_final * scale,
                        lr_delay_mult=opt.position_lr_delay_mult,
                        max_steps=opt.position_lr_max_steps),
        "features_dc": f(opt.feature_lr),
        "features_rest": f(opt.feature_lr / 20.0),
        "scaling": f(opt.scaling_lr),
        "rotation": f(opt.rotation_lr),
        "opacity": f(opt.opacity_lr),
        "language_feature": f(opt.language_feature_lr),
    }


@torch.no_grad()
def adam_update(params: dict, grads: dict, mu: dict, nu: dict, step: int, lrs: dict) -> None:
    """One Adam step at Adam step ``step`` (counted from 1), in place."""
    bc1 = float(1.0 - np.float32(B1) ** np.float32(step))
    bc2 = float(1.0 - np.float32(B2) ** np.float32(step))
    for k in FIELDS:
        mu[k].mul_(B1).add_((1 - B1) * grads[k])
        nu[k].mul_(B2).add_((1 - B2) * grads[k] * grads[k])
        params[k].sub_(lrs[k] * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)))


def view_loss(out: Rendered, gt_img, mono, gt_feat, seg, protos, opt, step: int):
    """The train view's combined loss and its L1."""
    image = out.color.permute(2, 0, 1)
    ll1 = L.l1_loss_mask(image, gt_img)
    loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - L.ssim(image, gt_img))
    if opt.include_feature:
        lf, lsm = L.loss_feature_metric(out.feature.permute(2, 0, 1), gt_feat, protos, seg,
                                        known_fce=opt.known_fce, known_fl1=opt.known_fl1,
                                        known_fsm=opt.known_fsm)
        loss = loss + lf + lsm
    depth_w = opt.depth_weight_late if step > opt.end_sample_pseudo else opt.depth_weight
    return loss + depth_w * L.depth_pearson_loss(out.depth, mono, disparity_const=200.0), ll1


def pseudo_loss(out: Rendered, fused, weight, protos, opt, step: int,
                mono_depth: Optional[Callable], train_feature) -> torch.Tensor:
    it = float(step)
    loss_scale = min(max((it - opt.start_sample_pseudo) / 500.0, 0.0), 1.0)
    depth = out.depth
    total = torch.zeros((), dtype=torch.float32, device=depth.device)
    if mono_depth is not None:
        mono = mono_depth(out.color.permute(2, 0, 1))
        pl = 1.0 - L.pearson_corrcoef(depth, -mono)
        total = total + loss_scale * opt.depth_pseudo_weight * torch.nan_to_num(pl)
        if it > 4000.0:
            label_feat = (train_feature if opt.pseudo_seg_from_train_view
                          else out.feature.permute(2, 0, 1))
            labels = L.segment_cluster_assign(label_feat.detach(), protos)
            seg_loss = L.segment_pearson_loss(depth, mono, labels, protos.shape[0])
            seg_scale = min(max((it - opt.start_sample_pseudo) / 8000.0, 0.0), 1.0)
            total = total + (0.25 * seg_scale * opt.depth_pseudo_weight
                             * torch.nan_to_num(seg_loss))
    reproj = L.loss_reproject_from_fused(depth, fused, weight)
    return total + 0.5 * loss_scale * opt.depth_pseudo_weight * torch.nan_to_num(reproj)


@dataclass
class StepInputs:
    """What one iteration feeds the step: the train view's camera and
    targets, and for a pseudo iteration the pseudo camera and its fused
    reprojection depth and weight."""

    cam: Cam
    image: torch.Tensor        # [3, H, W]
    depth_mono: torch.Tensor   # [H, W]
    feature: torch.Tensor      # [3, H, W]
    seg_map: torch.Tensor      # [H, W] int32
    pseudo_cam: Optional[Cam] = None
    fused: Optional[torch.Tensor] = None
    weight: Optional[torch.Tensor] = None


class Trainee:
    """The trained state: raw parameters by field, the alive mask, Adam's
    moments and step, the iteration counter."""

    def __init__(self, params: dict, alive, step: int, adam_step: int, mu=None, nu=None):
        self.params = {k: params[k].detach().clone() for k in FIELDS}
        self.alive = alive.detach().clone()
        self.mu = mu or {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = nu or {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.step = step
        self.adam_step = adam_step

    def train_step(self, inp: StepInputs, opt, raster: Raster, protos, bg, sh_degree: int,
                   spatial_lr_scale: float, mono_depth: Optional[Callable] = None) -> tuple:
        """One iteration: returns its loss and the train view's L1."""
        leaves = {k: v.requires_grad_(True) for k, v in self.params.items()}
        out = render(leaves, self.alive, inp.cam, raster, bg, sh_degree)
        loss, ll1 = view_loss(out, inp.image, inp.depth_mono, inp.feature, inp.seg_map, protos,
                              opt, self.step)
        if inp.pseudo_cam is not None:
            out_ps = render(leaves, self.alive, inp.pseudo_cam, raster, bg, sh_degree)
            loss = loss + pseudo_loss(out_ps, inp.fused, inp.weight, protos, opt, self.step,
                                      mono_depth, out.feature.permute(2, 0, 1))
        grads = torch.autograd.grad(loss, [leaves[k] for k in FIELDS], allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(FIELDS, grads)}
        for v in leaves.values():
            v.requires_grad_(False)
        self.adam_step += 1
        adam_update(self.params, grads, self.mu, self.nu, self.adam_step,
                    learning_rates(opt, self.step, spatial_lr_scale))
        self.step += 1
        return float(loss.detach()), float(ll1.detach())


def options(d: dict) -> SimpleNamespace:
    """A configuration's ``optim`` object as attributes."""
    return SimpleNamespace(**d)

