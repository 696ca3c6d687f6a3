"""The port's full_eval (cli/full_eval.py) against the root full_eval.py.

The same scene lists; the same commands in the same order for the same
flags (the root script's ``train.py``/``render.py``/``metrics.py``
subprocesses, recorded, against the argv the port hands its CLIs'
``main``); a CLI that fails stops the run. Then the whole suite on one
LLFF-layout scene written under pytest's tmp dir (tests/test_scene.py's
writer, as tests/test_torch_train_cli.py uses it): 3 iterations at
``-r 8`` on the CPU, the test renders and the metrics files on disk.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from sdpgs_torch.cli import full_eval as port
from test_scene import make_colmap_scene

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import full_eval as ref  # noqa: E402  (the root script: argparse and subprocess only)
from torch_threads import few_threads  # noqa: F401  (autouse)

SCRIPTS = {"train.py": "train_cli", "render.py": "render_cli", "metrics.py": "metrics_cli"}


def test_scene_lists_match():
    for k in ("MIPNERF360_OUTDOOR", "MIPNERF360_INDOOR", "TANKS_AND_TEMPLES", "DEEP_BLENDING",
              "LLFF"):
        assert getattr(port, k) == getattr(ref, k), k


@pytest.mark.parametrize("flags", [
    ["--llff", "L", "--mipnerf360", "M", "-o", "O", "--iterations", "7"],
    ["--llff", "L", "--skip_training"],
    ["-m360", "M", "--skip_rendering", "--skip_metrics"],
])
def test_commands_follow_jax(flags, monkeypatch):
    want = []

    class Done:
        returncode = 0

    def record(cmd):
        want.append((SCRIPTS[cmd[1]], cmd[2:]))
        return Done()

    monkeypatch.setattr(ref.subprocess, "run", record)
    monkeypatch.setattr(sys, "argv", ["full_eval.py"] + flags)
    ref.main()

    got = []
    from sdpgs_torch.cli import metrics_cli, render_cli, train_cli

    for mod in (train_cli, render_cli, metrics_cli):
        monkeypatch.setattr(mod, "main", lambda argv, device=None, _n=mod.__name__:
                            got.append((_n.rsplit(".", 1)[1], argv)))
    port.main(flags, device="cpu")
    assert got == want


def test_failing_cli_raises(monkeypatch):
    from sdpgs_torch.cli import train_cli

    def fail(argv, device=None):
        raise RuntimeError("scene not found")

    monkeypatch.setattr(train_cli, "main", fail)
    with pytest.raises(RuntimeError, match="scene not found"):
        port.main(["--llff", "L"], device="cpu")


def test_one_scene_on_cpu(tmp_path, monkeypatch):
    torch.manual_seed(0)
    monkeypatch.setattr(port, "LLFF", ["fern"])
    root = tmp_path / "llff"
    (root / "fern").mkdir(parents=True)
    make_colmap_scene(root / "fern")
    out = tmp_path / "eval"
    jobs = port.main(["--llff", str(root), "-o", str(out), "--iterations", "3"], device="cpu")
    model = out / "llff" / "fern"
    assert jobs == [(root / "fern", model, 8)]
    assert (model / "point_cloud" / "iteration_3" / "point_cloud.ply").exists()
    renders = sorted((model / "test" / "ours_3" / "renders").glob("*.png"))
    assert renders and len(renders) == len(list((model / "test" / "ours_3" / "gt").glob("*.png")))
    results = json.loads((model / "results.json").read_text())
    scores = results["ours_3"]
    assert scores["PSNR"] > 5.0 and 0.0 < scores["SSIM"] <= 1.0
