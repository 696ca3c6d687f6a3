"""Training CLI: ``python -m sdpgs_torch.cli.train_cli -s <scene> -m <out>``.

Counterpart of ``sdpgs_tpu/cli/train_cli.py`` (the reference's
``python train.py -s <scene> -m <out>``, train.py:309-342): the same flags,
names and defaults, one per ``OptimizationConfig`` field among them, so a
JAX command line runs unchanged; the config is saved as ``cfg.json``.

Multi-card training: one process per rank, formed by the ``--dist_*`` flags
(or their ``SDPGS_*`` environment variables, ``parallel/distributed.py``)
before the card is touched, with ``--mesh data=..,gauss=..,tile=..`` whose
product is the number of ranks, e.g.::

    torchrun --nproc_per_node 4 -m sdpgs_torch.cli.train_cli -s <scene> -m <out> \
        --views_per_batch 2 --mesh data=2,gauss=1,tile=2 --dist_coordinator auto

Rank 0 alone writes the model directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    from sdpgs_torch.config import ModelConfig, OptimizationConfig

    p = argparse.ArgumentParser(description="SDP-GS training (PyTorch, CUDA)")
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--model_path", "-m", default="")
    p.add_argument("--images", "-i", default="images")
    p.add_argument("--language_features_name", "-l",
                   default=ModelConfig.language_features_name)
    p.add_argument("--resolution", "-r", type=int, default=8)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--nviews", type=int, default=3)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--capacity", type=int, default=ModelConfig.capacity)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test_iterations", nargs="+", type=int,
                   default=[1000, 2000, 3000, 5000, 10000])
    p.add_argument("--save_iterations", nargs="+", type=int, default=[5000, 10000])
    p.add_argument("--checkpoint_iterations", nargs="+", type=int,
                   default=[5000, 10000])
    p.add_argument("--start_checkpoint", type=str, default=None,
                   help="resume from <checkpoint dir>:<step>")
    p.add_argument("--dpt_weights", type=str, default="",
                   help=".npz depth net (models/dpt.save_params) for the pseudo "
                        "window's MiDaS role")
    p.add_argument("--lpips_weights", type=str, default="",
                   help=".npz LPIPS-VGG weights for eval reports")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--views_per_batch", type=int, default=1,
                   help="views per training step")
    p.add_argument("--mesh", type=str, default="",
                   help="device mesh, e.g. 'data=2,gauss=1,tile=2' (axes default to 1); "
                        "its product is the number of ranks")
    from sdpgs_torch.parallel.distributed import add_distributed_args

    add_distributed_args(p)
    # optimization overrides (reference per-scene flags, run_llff_mvs.sh)
    for f in dataclasses.fields(OptimizationConfig):
        # flags already declared explicitly above
        if f.name in ("iterations", "test_iterations", "save_iterations",
                      "checkpoint_iterations"):
            continue
        if isinstance(f.default, bool):
            p.add_argument(f"--{f.name}", type=lambda s: s.lower() == "true",
                           default=None)
        elif isinstance(f.default, (int, float)):
            p.add_argument(f"--{f.name}", type=type(f.default), default=None)
    return p


def config_from_args(args):
    from sdpgs_torch.config import OptimizationConfig, TrainConfig

    cfg = TrainConfig()
    cfg.seed = args.seed
    m = cfg.model
    m.source_path = os.path.abspath(args.source_path)
    m.model_path = args.model_path
    m.images = args.images
    m.language_features_name = args.language_features_name
    m.resolution = args.resolution
    m.white_background = args.white_background
    m.nviews = args.nviews
    m.sh_degree = args.sh_degree
    m.capacity = args.capacity
    m.dpt_weights = args.dpt_weights
    m.lpips_weights = args.lpips_weights

    cfg.views_per_batch = args.views_per_batch
    if args.mesh:
        axes = {"data": 1, "gauss": 1, "tile": 1}
        for part in args.mesh.split(","):
            name, _, val = part.partition("=")
            name = name.strip()
            if name not in axes:
                raise SystemExit(
                    f"--mesh: unknown axis {name!r} (data/gauss/tile)")
            axes[name] = int(val)
        cfg.mesh_data = axes["data"]
        cfg.mesh_gauss = axes["gauss"]
        cfg.mesh_tile = axes["tile"]

    for f in dataclasses.fields(OptimizationConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            setattr(cfg.optim, f.name, v)
    if args.iterations is not None:
        cfg.optim.iterations = args.iterations
    cfg.optim.test_iterations = tuple(args.test_iterations)
    cfg.optim.save_iterations = tuple(args.save_iterations) + (cfg.optim.iterations,)
    cfg.optim.checkpoint_iterations = tuple(args.checkpoint_iterations)
    return cfg


def main(argv=None, device=None, backend=None):
    """Parse ``argv``, form the process group when the ``--dist_*`` flags
    ask for one (with ``backend``: NCCL where a card exists unless the
    caller asks for gloo), save ``cfg.json``, build the Trainer (which loads the
    scene) on ``device`` (``cuda`` unless the caller asks for another; a
    rank's own card under NCCL), resume from ``--start_checkpoint dir:step``
    and train. Returns the Trainer."""
    args = build_parser().parse_args(argv)
    from sdpgs_torch.parallel.distributed import maybe_initialize_distributed

    multi = maybe_initialize_distributed(args, backend=backend)
    cfg = config_from_args(args)

    from sdpgs_torch.config import save_config
    from sdpgs_torch.train.loop import Trainer

    import torch.distributed as dist

    if cfg.model.model_path and (not multi or dist.get_rank() == 0):
        Path(cfg.model.model_path).mkdir(parents=True, exist_ok=True)
        save_config(cfg, Path(cfg.model.model_path) / "cfg.json")

    trainer = Trainer(cfg, device=device)
    if args.start_checkpoint:
        ckpt_dir, step = args.start_checkpoint.rsplit(":", 1)
        trainer.restore(ckpt_dir, int(step))
        print(f"resumed from {ckpt_dir} at step {step}")

    # train() reports L1/PSNR/SSIM (and LPIPS) on the train and test views at
    # each test iteration and persists eval_results.json to the model dir
    trainer.train()
    print("\nTraining complete.")
    return trainer


if __name__ == "__main__":
    main()
