"""Typed configuration (dataclasses + JSON), the counterpart of
``sdpgs_tpu/config.py``: the same dataclasses, field names and defaults, so
``save_config``/``load_config`` round-trip one ``cfg.json`` for both
packages.

Default values mirror the reference's OptimizationParams / ModelParams /
PipelineParams (reference/arguments/__init__.py:47-124).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Tuple


@dataclass(frozen=True)
class RasterizeConfig:
    """Static geometry of the tile rasterizer.

    Same fields and defaults as ``sdpgs_tpu.config.RasterizeConfig`` so one
    ``cfg.json`` drives both packages. The port reads ``tile``,
    ``max_per_tile``, ``max_tiles_per_gaussian``, ``chunk`` and the
    compositing/culling thresholds. The remaining fields size the TPU
    package's Pallas kernels (rank-kernel slots and layouts, windowed and
    gather-based payload backward, Pallas chunk and tiles per grid step,
    bf16 backward, kernel routing) and are kept only for file
    compatibility: the port ignores them. ``grad_window_slack`` is as inert
    as the rest: the port's backward has no gradient window, and its
    capacity ladder grows K and D only. Overflows are counted and
    reported, never silent.
    """

    tile: int = 32                  # tile edge in pixels
    max_per_tile: int = 1024        # K: max composited Gaussians per tile
    rank_block_grouped: bool = True  # TPU-only (ignored by the port)
    rank_block_tail: int = 0        # TPU-only (ignored by the port)
    rank_block_slots: int = 512     # TPU-only (ignored by the port)
    max_tiles_per_gaussian: int = 8   # D: per-Gaussian tile-rect capacity
    grad_gather_min_rows: int = 1 << 62  # TPU-only (ignored by the port)
    grad_window_min_rows: int = 1 << 20  # TPU-only (ignored by the port)
    grad_window_bits: int = 14      # TPU-only (ignored by the port)
    grad_window_slack: float = 0.85  # TPU-only (ignored by the port)
    rank_kernel_lanes: bool = True  # TPU-only (ignored by the port)
    rank_block_gaussians: int = 1024  # TPU-only (ignored by the port)
    chunk: int = 32                 # plain compositor chunk (K % chunk == 0)
    chunk_pallas: int = 128         # TPU-only (ignored by the port)
    tiles_per_kernel_step: int = 4  # TPU-only (ignored by the port)
    alpha_min: float = 1.0 / 255.0  # skip threshold (forward.cu:344)
    alpha_max: float = 0.99         # clamp (forward.cu:343)
    transmittance_min: float = 1e-4  # early-stop threshold (forward.cu:347)
    near: float = 0.2               # frustum near cull (auxiliary.h:154)
    low_pass: float = 0.3           # 2D cov dilation (forward.cu:110-111)
    bwd_bf16: bool = True           # TPU-only (ignored by the port)
    use_pallas: bool = True         # TPU-only (ignored by the port)
    use_rank_kernel: bool = True    # TPU-only (ignored by the port)
    interpret_kernels: bool = False  # TPU-only (ignored by the port)


@dataclass
class ModelConfig:
    """reference/arguments/__init__.py:47-64."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    language_features_name: str = "language_features_GGrouping_dim3"
    resolution: int = 8
    white_background: bool = False
    eval: bool = True
    nviews: int = 3
    capacity: int = 1 << 17        # static Gaussian slot count
    init_points: int = 10_000      # random init size when no MVS cloud exists
    dpt_weights: str = ""          # .npz from tools/convert_dpt.py (MiDaS role)
    lpips_weights: str = ""        # .npz from tools/convert_lpips.py; when set,
                                   # training_report + evaluate include
                                   # LPIPS-VGG (reference train.py:292)
    dpt_bf16: bool = True          # depth net in bf16 params (f32 in/out)
    dpt_resize: str = "bicubic"    # depth-net in/out resize: "bicubic" or
                                   # "bilinear"
    dpt_matmul_precision: str = "default"
                                   # matmul precision for the depth net only


@dataclass
class PipelineConfig:
    """reference/arguments/__init__.py:66-72."""

    convert_SHs_python: bool = True
    compute_cov3D_python: bool = False
    debug: bool = False
    use_confidence: bool = False


@dataclass
class OptimizationConfig:
    """reference/arguments/__init__.py:74-124 (same names and defaults)."""

    iterations: int = 6_000
    position_lr_init: float = 0.016
    position_lr_final: float = 0.00016
    position_lr_delay_mult: float = 0.01
    position_lr_start: int = 500
    position_lr_max_steps: int = 5500
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.003
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    prune_from_iter: int = 500
    densify_until_iter: int = 6000
    densify_grad_threshold: float = 0.0013
    random_background: bool = False
    include_feature: bool = True
    language_feature_lr: float = 0.013
    soft_depth_start: int = 1000
    hard_depth_start: int = 0
    error_tolerance: float = 0.2
    depth_weight: float = 0.05
    depth_weight_late: float = 0.001   # depth_weight after end_sample_pseudo (train.py:134)
    depth_pseudo_weight: float = 0.5
    shape_pena: float = 0.001
    scale_pena: float = 0.001
    opa_pena: float = 0.01
    pseudo_seg_from_train_view: bool = False
                                   # True = reference-exact segment labels for
                                   # the pseudo seg-pearson: index the pseudo
                                   # depth with the TRAIN view's feature
                                   # render (reference train.py:156), which is
                                   # geometrically misaligned with the pseudo
                                   # depth map. False (default) = the aligned
                                   # reading (pseudo view's own features).
                                   # See docs/PARITY.md "deliberate deviations".
    start_sample_pseudo: int = 2000
    end_sample_pseudo: int = 5500
    sample_pseudo_interval: int = 1
    known_fl1: float = 1.0
    known_fce: float = 0.01
    known_fsm: float = 0.000001
    novel_rgb_l1: float = 0.1
    reproj_rgb: float = 0.01
    prune_threshold: float = 0.01
    dist_thres: float = 10.0
    proximity_until_iter: int = 2000   # gaussian_model.py:598-599
    test_iterations: Tuple[int, ...] = (1000, 2000, 3000, 5000, 10000)
    save_iterations: Tuple[int, ...] = (5000, 10000)
    checkpoint_iterations: Tuple[int, ...] = (5000, 10000)


@dataclass
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    optim: OptimizationConfig = field(default_factory=OptimizationConfig)
    raster: RasterizeConfig = field(default_factory=RasterizeConfig)
    seed: int = 0                   # reference seeds all RNGs to 0 (general_utils.py:140-142)
    views_per_batch: int = 1        # data-parallel view batch (reference: 1)
    # Device mesh (data x gauss x tile): the Trainer trains on a mesh of
    # that many torch.distributed ranks when their product exceeds 1.
    mesh_data: int = 1              # device-mesh data (view) axis size
    mesh_gauss: int = 1             # device-mesh Gaussian-shard axis size
    mesh_tile: int = 1              # device-mesh rasterizer tile axis size


def _to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    return obj


def _from_dict(cls, data):
    import typing

    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        ftype = hints.get(f.name, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            kwargs[f.name] = _from_dict(ftype, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def save_config(cfg: TrainConfig, path: str | Path) -> None:
    Path(path).write_text(json.dumps(_to_dict(cfg), indent=2))


def load_config(path: str | Path) -> TrainConfig:
    return _from_dict(TrainConfig, json.loads(Path(path).read_text()))
