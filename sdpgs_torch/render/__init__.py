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
from sdpgs_torch.ops.rasterize.payload import Payload
from sdpgs_torch.ops.rasterize.preprocess_cuda import preprocess_payload
from sdpgs_torch.ops.rasterize.rasterizer import RenderOutput, rasterize
from sdpgs_torch.utils.profiling import span


def _payload(cam, g: Gaussians, cfg, sh_degree, opacity, feature, scaling_modifier=1.0,
             color=None, means2d_offset=None, detach: bool = False) -> Payload:
    # K1 reads the Gaussians' tensors in place and takes the camera by value:
    # a camera kept on the host (the cheap place for a 39-float record)
    # reaches it without a device sync.
    fields = (g.xyz, g.get_scaling() * scaling_modifier, g.get_rotation(), g.features_dc,
              g.features_rest)
    if detach:
        fields = tuple(a.detach() for a in fields)
    return preprocess_payload(*fields, g.alive, opacity, feature, cam, sh_degree, color=color,
                              means2d_offset=means2d_offset, near=cfg.near,
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
    tile_mesh=None,
) -> RenderOutput:
    """Render one view: the fused preprocess + SH colour into the
    compositor's payload (K1, with the degree-0 normalized language feature
    or ``override_language``, scaled by ``confidence``), then the extended
    rasterize. Runs on ``device`` (``cuda`` unless the caller asks for
    another), where ``g`` must live; ``cam`` may live on the host. On a
    ``tile_mesh`` (a ``parallel.Mesh``) whose ``tile`` axis exceeds 1 every
    rank of the axis composites its share of the tiles
    (``parallel.tile_shard.rasterize_tile_sharded``)."""
    with span("render", unit="view"):
        dev = _resolve(device, g)
        opacity = g.get_opacity()[:, 0]
        feature = (override_language if override_language is not None
                   else g.language_feature_normalized())
        if confidence is not None:
            feature = feature * confidence[:, 0][:, None]
        pay = _payload(cam, g, cfg, active_sh_degree, opacity, feature, scaling_modifier,
                       color=override_color, means2d_offset=means2d_offset)
        if tile_mesh is not None and tile_mesh.shape["tile"] > 1:
            from sdpgs_torch.parallel.tile_shard import rasterize_tile_sharded

            return rasterize_tile_sharded(pay, cam, bg, cfg, tile_mesh)
        return rasterize(g.xyz, None, opacity, override_color, feature, g.alive, cam, bg, cfg,
                         device=dev, payload=pay)


def render_for_depth(cam: Camera, g: Gaussians, cfg: RasterizeConfig, bg,
                     active_sh_degree: int, device=None) -> RenderOutput:
    """Depth rendering with opacity frozen at 0.95 and white colors
    (reference gaussian_renderer/__init__.py:18-95): geometry gradients
    only, the feature detached (JAX render/__init__.py:93)."""
    dev = _resolve(device, g)
    opacity = torch.full((g.capacity,), 0.95, dtype=torch.float32, device=dev) * g.alive
    color = torch.ones((g.capacity, 3), dtype=torch.float32, device=dev)
    feature = g.language_feature_normalized().detach()
    pay = _payload(cam, g, cfg, active_sh_degree, opacity, feature, color=color)
    return rasterize(g.xyz, None, opacity, color, feature, g.alive, cam, bg, cfg, device=dev,
                     payload=pay)


def render_for_opa(cam: Camera, g: Gaussians, cfg: RasterizeConfig, bg,
                   active_sh_degree: int, device=None) -> RenderOutput:
    """Opacity rendering (reference gaussian_renderer/__init__.py:96-181):
    xyz, colour, feature, scale and quaternion detached, so only the
    opacity receives a gradient (JAX render/__init__.py:109-115)."""
    dev = _resolve(device, g)
    opacity = g.get_opacity()[:, 0]
    feature = g.language_feature_normalized().detach()
    pay = _payload(cam, g, cfg, active_sh_degree, opacity, feature, detach=True)
    return rasterize(g.xyz.detach(), None, opacity, None, feature, g.alive, cam, bg, cfg,
                     device=dev, payload=pay)
