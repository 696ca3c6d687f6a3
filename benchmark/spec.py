"""Find a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout lists the cells (a
configuration and a traffic mix each) and the metrics. Everything else is
a file named after its entry:

- ``benchmark/configs/<configuration>.json``: the sizes, schedule and
  depth net as run, with ``source``, ``reduced`` and ``assumed``;
- ``benchmark/traffic/<traffic>.json``: the parameters that one of the
  generators (``kind``: ``train`` or ``render``) reads;
- ``benchmark/limits/<cell>.json``: the limits of the numbers the check
  compares, with the readings they were set from;
- ``benchmark/metrics/<metric>.py``: a reader, ``read(run)``, for every
  metric (end-to-end and per layer); it returns ``None`` where the run
  holds nothing for it to read.

A cell, configuration, traffic mix or metric is added as new files and a
``BENCHMARK.json`` entry; no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list        # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list         # ... and with --trace 1


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed, or the metric
    lists no cells and the cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = HERE) -> Cell:
    """The cell ``name`` of ``<root>/../BENCHMARK.json`` and its files under
    ``root``."""
    bench = read_json(root.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=read_json(root / "configs" / f"{entry['config']}.json"),
                traffic=read_json(root / "traffic" / f"{entry['traffic']}.json"),
                limits=read_json(root / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per)


def reader(metric: str, root: Path = HERE):
    """The ``read`` function of ``<root>/metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
