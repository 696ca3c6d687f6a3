"""Cells, configurations, traffic mixes, limits and metrics are found by
name, and a new one is added as files only."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

from benchmark import spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_and_metric_resolves():
    b = bench()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.traffic["kind"] in ("train", "render")
        assert cell.config["name"] == w["config"]
        assert set(cell.limits["limits"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1] == "benchmark/run.py"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert (ROOT / c["file"]).exists() and c["reduced"] == json.loads(
            (ROOT / c["file"]).read_text())["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "layer" in m:
            assert m["moves"] in {e["name"] for e in b["end_to_end"]}
            if "roofline" in m["name"] or "mfu" in m["name"]:
                assert m["unit"] == "%"
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_a_new_cell_and_metric_are_files_only(tmp_path):
    """On a copy of the benchmark's folder: a new traffic mix, cell limits,
    metric reader and BENCHMARK.json entries (the cell also joins the list
    of cells of the end-to-end metric it reports); every file under the
    folder that was there is unchanged, and the harness finds the new
    ones."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*") if p.is_file()}

    b = json.loads((copy / "BENCHMARK.json").read_text())
    (copy / "benchmark/traffic/sample_window.json").write_text(json.dumps(
        {"kind": "train", "start": 2501, "stop": 2900, "why": "densify without the k-NN"}))
    (copy / "benchmark/limits/llff-train-sample.json").write_text(json.dumps(
        {"limits": {"loss_rel": 1e-3}}))
    (copy / "benchmark/metrics/sample_ms_per_event.py").write_text(
        "def read(run):\n    return run.brackets.get('sample') and 1.0\n")
    b["workloads"].append({"name": "llff-train-sample", "config": "llff-fern-3view",
                           "traffic": "sample_window", "chips": 1, "why": "densify"})
    next(m for m in b["end_to_end"] if m["name"] == "train_it_per_s")["workloads"].append(
        "llff-train-sample")
    b["per_layer"].append({"name": "sample_ms_per_event", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "densify", "moves": "train_it_per_s",
                           "workloads": ["llff-train-sample"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell("llff-train-sample", root=copy / "benchmark")
    assert cell.traffic["start"] == 2501 and cell.traffic["stop"] == 2900
    assert [m["name"] for m in cell.per_layer] == ["sample_ms_per_event"]
    assert {m["name"] for m in cell.end_to_end} == {"train_it_per_s", "setup_s"}
    assert spec.reader("sample_ms_per_event", root=copy / "benchmark")(
        type("R", (), {"brackets": {"sample": [1]}})()) == 1.0
    assert all(p.read_bytes() == data for p, data in before.items())


def test_the_early_cell_is_found():
    """``llff-train-early``: fern with isolated Gaussians, a window that
    cycles before the proximity rule ends, the train cells' metrics and
    the k-NN's."""
    cell = spec.load_cell("llff-train-early")
    assert cell.config["cloud"]["isolated"]["count"] == 256
    stop = cell.traffic["stop"]
    assert stop % 100 == 0 and cell.traffic["start"] < stop < cell.config["optim"][
        "proximity_until_iter"]
    assert {m["name"] for m in cell.end_to_end} == {"train_it_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "knn_ms_per_event", "densify_ms_per_event", "launches_per_iter", "k5_roofline_pct",
        "device_idle_pct.train", "train_mfu", "idle_ms_per_iter.facade",
        "idle_ms_per_iter.losses", "idle_ms_per_iter.backward", "idle_ms_per_iter.update",
        "idle_ms_per_iter.loop", "adam_ms_per_iter"}
    assert set(cell.limits["limits"]) == {"loss_first", "l1_first", "change_first",
                                          "densify_slots", "densify_gap"}
    assert spec.reader("knn_ms_per_event")(type("R", (), {"brackets": {"knn": [2.0, 4.0]}})()
                                           ) == 3.0
