"""The cost of the port's spans (``sdpgs_torch.utils.profiling``) on the card.

    python scripts/span_cost.py [--seed N] [--pairs 3] [--cells llff-train-pseudo ...]

from the root of a checkout, on a machine with a CUDA device.

1. One span, two deep as the loop's are, with recording off, inside
   ``recording()`` and under ``torch.profiler`` (CPU and CUDA
   activities): microseconds a span, a loop of empty spans less the same
   loop without them.
2. For each training cell of ``BENCHMARK.json`` named: the program's
   ``Trainer`` built from the seed as the benchmark builds it, run to a
   chunk's end and one chunk more, then chunks of 100 iterations timed by
   the host's clock (each ending in a synchronise) in turns without and
   inside ``recording()``: off, on, on, off, ``--pairs`` times; it/s of
   every chunk, their medians and the spans an iteration recorded.

The last line of standard output is one JSON object with every number,
the card's name and its power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CHUNK = 100


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def span_us(n: int, ctx) -> float:
    """Microseconds a span: n pairs of nested empty spans under ``ctx``,
    less n empty iterations."""
    from sdpgs_torch.utils.profiling import span

    with ctx:
        t0 = time.perf_counter()
        for _ in range(n):
            with span("outer"):
                with span("inner"):
                    pass
        t1 = time.perf_counter()
        for _ in range(n):
            pass
        t2 = time.perf_counter()
    return ((t1 - t0) - (t2 - t1)) / (2 * n) * 1e6


def span_costs() -> dict:
    from torch.profiler import ProfilerActivity, profile

    from sdpgs_torch.utils.profiling import recording

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    for rep in range(3):
        for name, n, ctx in (("off", 1_000_000, contextlib.nullcontext()),
                             ("recording", 100_000, recording()),
                             ("profiler", 20_000, profile(activities=acts))):
            out.setdefault(name, []).append(span_us(n, ctx))
    return out


def sync(dev) -> float:
    torch.cuda.synchronize(dev)
    return time.perf_counter()


def trainer_of(cell, seed: int, dev):
    """The program's Trainer on the cell's scene, depth net and schedule,
    made from the seed as benchmark/train_cell.py makes them."""
    from benchmark import program, scene as scene_lib
    from benchmark.train_cell import in_pseudo
    from sdpgs_torch.train.loop import Trainer

    cfg = cell.config
    start = int(cell.traffic["start"])
    pseudo = in_pseudo(cfg["optim"], start)
    sc = scene_lib.build(cfg, seed, dev, with_pseudo=pseudo)
    mono = None
    if pseudo:
        weights = scene_lib.dpt_weights(program.dpt_names_shapes(cfg), seed, dev,
                                        getattr(torch, cfg["depth_net"]["dtype"]))
        mono = program.depth_net(cfg, weights, dev)
    trainer = Trainer(program.train_config(cfg),
                      scene=program.ProgramScene(sc, cfg["cloud"]["sh_degree"]),
                      mono_depth_fn=mono, device=dev)
    trainer.state.step = start - 1
    trainer.state.opt_state.step = start - 1
    return trainer


def recording_cost(name: str, seed: int, pairs: int, dev) -> dict:
    from benchmark import spec
    from sdpgs_torch.utils.profiling import recording, spans

    cell = spec.load_cell(name)
    trainer = trainer_of(cell, seed, dev)
    first = trainer.state.step + 1
    opened = -(-first // CHUNK) * CHUNK + CHUNK
    opt = cell.config["optim"]
    if first < opt["end_sample_pseudo"] <= opened + 4 * pairs * CHUNK:
        raise ValueError(f"{name}: {pairs} pairs of chunks would leave the pseudo window at "
                         f"{opt['end_sample_pseudo']}")
    trainer.train(iterations=opened, log_every=CHUNK)
    rates = {"off": [], "on": []}
    per_iter = []
    for side in ["off", "on", "on", "off"] * pairs:
        t0 = sync(dev)
        with recording() if side == "on" else contextlib.nullcontext():
            trainer.train(iterations=trainer.state.step + CHUNK, log_every=CHUNK)
        rates[side].append(CHUNK / (sync(dev) - t0))
        if side == "on":
            per_iter.append(len(spans()) / CHUNK)
    med = {k: statistics.median(v) for k, v in rates.items()}
    return {"it_per_s": rates, "median": med, "change": med["on"] / med["off"] - 1.0,
            "spans_per_iter": per_iter}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=5100000001)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--cells", nargs="*", default=["llff-train-pseudo", "m360-train-plain"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_cost: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    dev = torch.device("cuda", 0)
    result = {"card": card(), "torch": torch.__version__, "span_us": span_costs()}
    print(f"span_us: {result['span_us']}", flush=True)
    for name in args.cells:
        result[name] = recording_cost(name, args.seed, args.pairs, dev)
        print(f"{name}: {result[name]['median']} change {result[name]['change']:+.4f}",
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
