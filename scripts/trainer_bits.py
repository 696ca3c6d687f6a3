"""Hold two trees of the port to the same training bits.

``run`` builds a benchmark training cell's scene and Trainer from a seed
(as ``benchmark/train_cell.py`` sets them up, the Trainer's counters at
the traffic's start), trains for a number of iterations with the
``sdpgs_torch`` of ``--tree``, and saves every step's loss and L1 and the
final parameters, alive mask and Adam moments. ``compare`` reads two such
files and reports, per tensor, the elements whose bits differ, counting a
zero against a zero of the other sign as equal. On a card, one process a
tree:

    python scripts/trainer_bits.py run --tree <root> --workload m360r4-train-late-densify \\
        --seed 7 --iterations 100 --out a.pt
    python scripts/trainer_bits.py compare a.pt b.pt

The benchmark package is imported from this script's checkout; the two
trees must share it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def run(args) -> None:
    sys.path.insert(0, str(Path(args.tree).resolve()))
    sys.path.insert(1, str(REPO))
    import sdpgs_torch

    from benchmark import program, scene as scene_lib
    from benchmark.reference.raster import FIELDS
    from benchmark.spec import load_cell

    cell = load_cell(args.workload)
    cfg = cell.config
    start = int(cell.traffic["start"])
    dev = torch.device(args.device)
    sc = scene_lib.build(cfg, args.seed, dev, with_pseudo=False)
    trainer = program.bench_trainer(False)(program.train_config(cfg),
                                           scene=program.ProgramScene(sc, cfg["cloud"]["sh_degree"]),
                                           mono_depth_fn=None, device=dev)
    trainer.state.step = start - 1
    trainer.state.opt_state.step = start - 1
    trainer.record = []
    trainer.train(iterations=start - 1 + args.iterations, log_every=args.iterations)
    state = trainer.state
    out = {"package": str(Path(sdpgs_torch.__file__).resolve().parent),
           "loss": torch.stack([r.loss for r in trainer.record]).cpu(),
           "l1": torch.stack([r.l1 for r in trainer.record]).cpu(),
           "alive": state.gaussians.alive.detach().cpu()}
    for k in FIELDS:
        out[f"param.{k}"] = getattr(state.gaussians, k).detach().cpu()
        out[f"mu.{k}"] = state.opt_state.mu[k].detach().cpu()
        out[f"nu.{k}"] = state.opt_state.nu[k].detach().cpu()
    torch.save(out, args.out)
    print(json.dumps({"tree": args.tree, "steps": len(trainer.record),
                      "last_loss": float(out["loss"][-1]), "alive": int(out["alive"].sum())}))


def compare(args) -> int:
    a, b = torch.load(args.a), torch.load(args.b)
    report, differing = {}, 0
    for k in sorted(set(a) | set(b)):
        if k == "package":
            continue
        x, y = a[k], b[k]
        if x.shape != y.shape:
            report[k] = f"shapes {tuple(x.shape)} and {tuple(y.shape)}"
            differing += 1
            continue
        bits = x.view(torch.int32) != y.view(torch.int32)
        zeros = (x == 0) & (y == 0)
        n = int((bits & ~zeros).sum())
        signed = int((bits & zeros).sum())
        report[k] = {"differ": n, "zero_signs": signed}
        differing += n > 0
    print(json.dumps({"equal_but_zero_signs": differing == 0, "tensors": report}))
    return 0 if differing == 0 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--tree", required=True)
    r.add_argument("--workload", required=True)
    r.add_argument("--seed", type=int, required=True)
    r.add_argument("--iterations", type=int, default=100)
    r.add_argument("--out", required=True)
    r.add_argument("--device", default="cuda")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        run(args)
        return 0
    return compare(args)


if __name__ == "__main__":
    sys.exit(main())
