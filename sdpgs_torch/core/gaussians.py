"""Gaussian cloud state: a static-capacity ``nn.Module`` with an alive mask.

Counterpart of ``sdpgs_tpu/core/gaussians.py``. Raw (pre-activation)
parameters exactly like the reference (gaussian_model.py:26-65): log-scale,
logit-opacity, unnormalized quaternion (w, x, y, z). The trainable fields
are ``nn.Parameter``s; ``alive`` (float {0,1}) and ``confidence`` are
buffers. Dead slots are neutralized by multiplying the activated opacity
with ``alive``. A cloud starts frozen (``requires_grad`` off), as a loaded
cloud is served and a render then builds no graph; ``TrainState.create``
turns gradients on.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from sdpgs_torch.core import sh as sh_lib
from sdpgs_torch.core.transforms import (
    build_covariance_3d,
    covariance_to_symm6,
    inverse_sigmoid,
    normalize_quat,
)

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "language_feature")
BUFFER_FIELDS = ("alive", "confidence")


class Gaussians(nn.Module):
    """Gaussian parameters at fixed capacity P.

    xyz [P,3], features_dc [P,1,3], features_rest [P,K-1,3], scaling [P,3],
    rotation [P,4], opacity [P,1], language_feature [P,3]; buffers alive [P]
    and confidence [P,1]."""

    def __init__(self, *, max_sh_degree: int = 3, **fields: torch.Tensor):
        super().__init__()
        self.max_sh_degree = max_sh_degree
        for name in PARAM_FIELDS:
            setattr(self, name, nn.Parameter(fields[name].float(), requires_grad=False))
        for name in BUFFER_FIELDS:
            self.register_buffer(name, fields[name].float())

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], max_sh_degree: int = 3,
                   device=None) -> "Gaussians":
        """Carry the JAX package's parameters across: ``arrays`` holds numpy
        arrays keyed by the JAX ``Gaussians`` field names (copied, so a train
        step's in-place updates never write into them)."""
        from sdpgs_torch import default_device

        dev = default_device(device)
        return cls(max_sh_degree=max_sh_degree, **{
            k: torch.tensor(np.asarray(arrays[k], np.float32), device=dev)
            for k in PARAM_FIELDS + BUFFER_FIELDS
        })

    def to_numpy(self) -> dict:
        """Field name -> numpy array (the inverse of :meth:`from_numpy`)."""
        return {k: getattr(self, k).detach().cpu().numpy()
                for k in PARAM_FIELDS + BUFFER_FIELDS}

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    # ---- activations (reference gaussian_model.py:26-41,146-187) ----
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_rotation(self) -> torch.Tensor:
        return normalize_quat(self.rotation)

    def get_opacity(self) -> torch.Tensor:
        """Activated opacity with dead slots forced to zero."""
        return torch.sigmoid(self.opacity) * self.alive[:, None]

    def get_features(self) -> torch.Tensor:
        """[P, K, 3] full SH coefficient stack."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_covariance(self, scale_modifier: float = 1.0) -> torch.Tensor:
        """[P, 6] packed symmetric world covariance."""
        cov = build_covariance_3d(self.get_scaling(), self.get_rotation(), scale_modifier)
        return covariance_to_symm6(cov)

    def num_alive(self) -> int:
        return int(self.alive.sum().item())

    def colors_from_sh(self, cam_pos: torch.Tensor, active_degree: int) -> torch.Tensor:
        """Per-Gaussian RGB from SH at the given camera position
        (reference gaussian_renderer/__init__.py:269-274)."""
        dirs = self.xyz - cam_pos[None, :]
        dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-24)
        rgb = sh_lib.eval_sh(active_degree, self.get_features(), dirs)
        return torch.clamp_min(rgb + 0.5, 0.0)

    def language_feature_normalized(self) -> torch.Tensor:
        """Degree-0 'SH' language feature, L2-normalized
        (reference gaussian_renderer/__init__.py:282-287), with the smooth
        norm sqrt(|f|^2 + eps^2) of the JAX package: features start at
        exactly zero, where a plain norm has no gradient."""
        f = self.language_feature * sh_lib.C0
        norm = torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True) + 1e-18)
        return f / (norm + 1e-9)


def create_from_points(
    points: np.ndarray,
    colors: np.ndarray,
    capacity: int,
    max_sh_degree: int = 3,
    features: Optional[np.ndarray] = None,
    init_scale: Optional[np.ndarray] = None,
    initial_opacity: float = 0.1,
    device=None,
) -> Gaussians:
    """Initialize from a point cloud (reference gaussian_model.py:189-214).

    ``init_scale`` ([N], mean squared distance to the 3 nearest neighbours)
    is required: the k-NN that computes it is not ported yet."""
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    if init_scale is None:
        raise NotImplementedError("create_from_points needs init_scale: the k-NN "
                                  "initialisation is not ported yet")
    dist2 = np.clip(init_scale, 1e-7, None)
    log_scale = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)
    K = sh_lib.num_sh_coeffs(max_sh_degree)

    def pad(a, fill=0.0):
        out = np.full((capacity,) + a.shape[1:], fill, dtype=np.float32)
        out[:n] = a
        return out

    fdc = sh_lib.rgb_to_sh(np.asarray(colors, dtype=np.float32))[:, None, :]
    logit = float(inverse_sigmoid(torch.tensor(initial_opacity, dtype=torch.float32)))
    opa = np.full((n, 1), logit, np.float32)
    if features is None:
        features = np.zeros((n, 3), dtype=np.float32)
    alive = np.zeros((capacity,), dtype=np.float32)
    alive[:n] = 1.0
    rot = np.zeros((capacity, 4), dtype=np.float32)
    rot[:, 0] = 1.0  # identity quat, also in dead slots (zero quat has no grad)

    return Gaussians.from_numpy(dict(
        xyz=pad(np.asarray(points, np.float32)),
        features_dc=pad(np.asarray(fdc, np.float32)),
        features_rest=pad(np.zeros((n, K - 1, 3), np.float32)),
        scaling=pad(log_scale, fill=-10.0),
        rotation=rot,
        opacity=pad(opa, fill=-10.0),
        language_feature=pad(np.asarray(features, np.float32)),
        alive=alive,
        confidence=pad(np.ones((n, 1), np.float32), fill=1.0),
    ), max_sh_degree=max_sh_degree, device=device)
