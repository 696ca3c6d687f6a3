"""Renderer facade over the tile rasterizer.

Counterpart of ``sdpgs_tpu/render/__init__.py`` (reference
gaussian_renderer/__init__.py): ``render`` (:209-338), ``render_for_depth``
(:18-95, opacity frozen at 0.95, colors = 1) and ``render_for_opa``
(:96-181, geometry detached). All three run the fused preprocess + SH
kernel (K1), binning (K2) and compositing (K3) on CUDA, and are
differentiable: the backward runs K5 and K4. Gradients stop where the
JAX package stops them.
"""

from __future__ import annotations

from typing import Optional

import torch

from sdpgs_torch import default_device
from sdpgs_torch.config import RasterizeConfig
from sdpgs_torch.core.camera import Camera
from sdpgs_torch.core.gaussians import Gaussians
from sdpgs_torch.ops.rasterize.preprocess_cuda import preprocess_color
from sdpgs_torch.ops.rasterize.rasterizer import RenderOutput, rasterize


def _prep_color(cam, g: Gaussians, cfg, sh_degree, scaling_modifier=1.0,
                detach: bool = False):
    # K1 takes the camera by value: a camera kept on the host (the cheap
    # place for a 39-float record) reaches it without a device sync.
    args = (g.xyz, g.get_scaling() * scaling_modifier, g.get_rotation(), g.get_features())
    if detach:
        args = tuple(a.detach() for a in args)
    return preprocess_color(*args, g.alive, cam, sh_degree, near=cfg.near,
                            low_pass=cfg.low_pass)


def _resolve(device, g: Gaussians) -> torch.device:
    dev = default_device(device)
    if g.device.type != dev.type:
        raise ValueError(f"Gaussians live on {g.device}, render device is {dev}")
    return dev


def render(
    cam: Camera,
    g: Gaussians,
    cfg: RasterizeConfig,
    bg,
    active_sh_degree: int,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    override_language: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    confidence: Optional[torch.Tensor] = None,
    device=None,
) -> RenderOutput:
    """Render one view: fused preprocess + SH colour, the degree-0
    normalized language feature, the extended rasterize. Runs on ``device``
    (``cuda`` unless the caller asks for another), where ``g`` must live;
    ``cam`` may live on the host."""
    dev = _resolve(device, g)
    prep, color = _prep_color(cam, g, cfg, active_sh_degree, scaling_modifier)
    if override_color is not None:
        color = override_color
    feature = (override_language if override_language is not None
               else g.language_feature_normalized())
    return rasterize(
        g.xyz, None, g.get_opacity()[:, 0], color, feature, g.alive, cam, bg, cfg,
        means2d_offset=means2d_offset,
        feature_weight=confidence[:, 0] if confidence is not None else None,
        prep=prep, device=dev,
    )


def render_for_depth(cam: Camera, g: Gaussians, cfg: RasterizeConfig, bg,
                     active_sh_degree: int, device=None) -> RenderOutput:
    """Depth rendering with opacity frozen at 0.95 and white colors
    (reference gaussian_renderer/__init__.py:18-95): geometry gradients
    only, the feature detached (JAX render/__init__.py:93)."""
    dev = _resolve(device, g)
    prep, _ = _prep_color(cam, g, cfg, active_sh_degree)
    opacity = torch.full((g.capacity,), 0.95, dtype=torch.float32, device=dev) * g.alive
    color = torch.ones((g.capacity, 3), dtype=torch.float32, device=dev)
    return rasterize(g.xyz, None, opacity, color,
                     g.language_feature_normalized().detach(), g.alive, cam, bg, cfg,
                     prep=prep, device=dev)


def render_for_opa(cam: Camera, g: Gaussians, cfg: RasterizeConfig, bg,
                   active_sh_degree: int, device=None) -> RenderOutput:
    """Opacity rendering (reference gaussian_renderer/__init__.py:96-181):
    xyz, colour, feature, scale and quaternion detached, so only the
    opacity receives a gradient (JAX render/__init__.py:109-115)."""
    dev = _resolve(device, g)
    prep, color = _prep_color(cam, g, cfg, active_sh_degree, detach=True)
    return rasterize(g.xyz.detach(), None, g.get_opacity()[:, 0], color,
                     g.language_feature_normalized().detach(), g.alive, cam, bg, cfg,
                     prep=prep, device=dev)
