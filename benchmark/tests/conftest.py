"""Settings of the benchmark's own tests (``python -m pytest benchmark/tests``).

Tests that need the card carry the ``card`` marker and take the
``cuda_device`` fixture, which skips them where no CUDA device exists.
The CPU tests drive the harness on a small copy of the benchmark's data
(``small_bench``): the same files with the sizes cut, in a temporary
folder.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_DPT = {"hidden_size": 32, "num_layers": 4, "num_heads": 2, "intermediate_size": 64,
            "patch_size": 16, "backbone_out_indices": [0, 1, 2, 3],
            "neck_hidden_sizes": [16, 32, 32, 32], "reassemble_factors": [1, 1, 1, 0.5],
            "fusion_hidden_size": 16, "layer_norm_eps": 1e-12, "is_hybrid": True,
            "bit": {"embedding_size": 16, "hidden_sizes": [16, 32, 32], "depths": [1, 1, 1],
                    "num_groups": 8, "width_factor": 1}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def make_small(dest: Path) -> Path:
    """A copy of BENCHMARK.json and the benchmark's data files under
    ``dest`` with every configuration cut to 64x48, 2,048 slots, 512
    alive (32 of them isolated where a configuration has such), tile 16
    and a tiny depth net; returns ``dest/benchmark``."""
    bench = dest / "benchmark"
    bench.mkdir(parents=True)
    for d in ("configs", "traffic", "limits"):
        shutil.copytree(ROOT / "benchmark" / d, bench / d)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for p in (bench / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["image"].update(width=64, height=48)
        c["cloud"].update(capacity=2048, alive=512)
        if "isolated" in c["cloud"]:
            c["cloud"]["isolated"]["count"] = 32
        c["raster"].update(tile=16, max_per_tile=128, max_tiles_per_gaussian=8, chunk=32)
        if "n_pseudo" in c["layout"]:
            c["layout"]["n_pseudo"] = 128
        c["layout"]["n_train"] = min(c["layout"]["n_train"], 6)
        c["depth_net"]["arch"] = TINY_DPT
        p.write_text(json.dumps(c))
    for p in (bench / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        if t["kind"] == "render":
            t.update(frames=12, checked_views=4)
        p.write_text(json.dumps(t))
    return bench


@pytest.fixture(scope="session")
def small_bench(tmp_path_factory) -> Path:
    return make_small(tmp_path_factory.mktemp("small"))
