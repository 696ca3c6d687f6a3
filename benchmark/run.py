"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``sdpgs_torch`` and ``BENCHMARK.json``.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit
(also the last lines of standard error). Without as many CUDA devices as
the cell asks for, it prints no result and exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
# every build and kernel cache at a fixed place inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "sdpgs_tpu")


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, dev, t_start: float) -> dict:
    """Drive ``cell`` once on ``dev`` and return its result object."""
    import torch

    from benchmark import check, spec
    from benchmark.render_cell import run as run_render
    from benchmark.train_cell import run as run_train

    drive = {"train": run_train, "render": run_render}[cell.traffic["kind"]]
    measured, readings, peak, attempted, failed = drive(cell, seed, seconds, trace, dev,
                                                        t_start)
    measured.power_limit = card_power_limit() if dev.type == "cuda" else "none"
    correct, checks = check.judge(readings, cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(measured)
        if value is None:
            # on the CPU the readers of the device trace find nothing
            if not trace and dev.type == "cuda":
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak),
              "power_limit": measured.power_limit}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device}
    if trace:
        tr = measured.trace
        device["busy_s"], device["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = tr.breakdown()
    result["readings"] = readings
    result["phases"] = measured.phases
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      T_START)
    print("phases (s): " + ", ".join(f"{k} {v:.2f}" for k, v in result.pop("phases").items()),
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
