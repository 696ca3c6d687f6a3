"""Batch train, render and metrics over the standard suites.

Counterpart of the root ``full_eval.py`` (reference full_eval.py:33-75,
which drives mip-NeRF-360, T&T and Deep Blending): the same scene lists and
flags, over the port's CLIs in the same order: ``train_cli`` for each
scene, then ``render_cli --skip_train`` for each, then one ``metrics_cli
--model_paths`` over all. Each CLI's ``main(argv, device=...)`` runs in
this process; a failing CLI raises.

    python -m sdpgs_torch.cli.full_eval --llff <root> [--mipnerf360 <root>] -o <out>
"""

from __future__ import annotations

import argparse
from pathlib import Path

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]
LLFF = ["flower", "fern", "horns", "leaves", "orchids", "room", "trex", "fortress"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SDP-GS full evaluation (PyTorch)")
    p.add_argument("--output_path", "-o", default="./eval")
    p.add_argument("--llff", default=None, help="LLFF dataset root")
    p.add_argument("--mipnerf360", "-m360", default=None)
    p.add_argument("--skip_training", action="store_true")
    p.add_argument("--skip_rendering", action="store_true")
    p.add_argument("--skip_metrics", action="store_true")
    p.add_argument("--iterations", type=int, default=10000)
    return p


def jobs(args) -> list:
    """(source, model directory, resolution) of every scene the flags name."""
    out = []
    if args.llff:
        out += [(Path(args.llff) / s, Path(args.output_path) / "llff" / s, 8) for s in LLFF]
    if args.mipnerf360:
        out += [(Path(args.mipnerf360) / s, Path(args.output_path) / "m360" / s, 4)
                for s in MIPNERF360_OUTDOOR + MIPNERF360_INDOOR]
    return out


def _run(name: str, fn, argv: list, device) -> None:
    print("+", name, " ".join(argv), flush=True)
    fn(argv, device=device)


def main(argv=None, device=None) -> list:
    """Run the suite on ``device`` (``cuda`` unless the caller asks for
    another). Returns the jobs."""
    from sdpgs_torch.cli import metrics_cli, render_cli, train_cli

    args = build_parser().parse_args(argv)
    todo = jobs(args)
    if not args.skip_training:
        for src, out, r in todo:
            _run("train_cli", train_cli.main, ["-s", str(src), "-m", str(out), "-r", str(r),
                                               "--iterations", str(args.iterations)], device)
    if not args.skip_rendering:
        for _, out, _ in todo:
            _run("render_cli", render_cli.main, ["-m", str(out), "--iteration",
                                                 str(args.iterations), "--skip_train"], device)
    if not args.skip_metrics:
        _run("metrics_cli", metrics_cli.main, ["--model_paths"] + [str(o) for _, o, _ in todo],
             device)
    return todo


if __name__ == "__main__":
    main()
