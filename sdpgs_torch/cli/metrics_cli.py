"""Metrics CLI: ``python -m sdpgs_torch.cli.metrics_cli -m <model> [...]``.

Counterpart of ``sdpgs_tpu/cli/metrics_cli.py`` (reference
metrics.py:95-103 / metrics_dtu.py), with the same flags. Scores on
``device`` (``cuda`` unless the caller asks for another).
"""

from __future__ import annotations

import argparse


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description="SDP-GS metrics (PyTorch)")
    p.add_argument("--model_paths", "-m", required=True, nargs="+")
    p.add_argument("--lpips_weights", default=None,
                   help=".npz from tools/convert_lpips.py")
    p.add_argument("--masks", default=None, help="DTU object-mask dir")
    p.add_argument("--aggregate", default=None,
                   help="aggregate per-scene results.json under this root")
    args = p.parse_args(argv)

    from sdpgs_torch.eval.metrics import aggregate_results, evaluate_model_paths

    evaluate_model_paths(args.model_paths, lpips_weights=args.lpips_weights,
                         masks_root=args.masks, device=device)
    if args.aggregate:
        aggregate_results(args.aggregate)


if __name__ == "__main__":
    main()
