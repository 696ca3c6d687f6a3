"""The port's convergence harness (cli/convergence_run.py) against
scripts/convergence_run.py, on the CPU.

- The scene writer: the port's copy of tests/test_acceptance.py's
  make_full_scene from one seed writes the same COLMAP binaries and
  poses_bounds.npy byte for byte, the same segment files, PNGs within one
  8-bit level (the two renders round apart), and mono and stereo depths
  within DEPTH_RTOL of the depth range.
- The train argv is the script's flags.
- The three checks, on made-up trajectories.
- The harness end to end at 20 iterations (the plumbing: the scene, the
  tiny DPT, conclude's aligned depths, the CLI's files and evals, the
  return code that the checks give). The script's own 1,500-iteration run
  takes minutes on this CPU and is marked slow.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from sdpgs_torch.cli import convergence_run as port
from sdpgs_torch.data.readers import read_pfm
from torch_threads import few_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
DEPTH_RTOL = 1e-4


def test_scene_matches_jax(tmp_path, monkeypatch):
    import jax
    import test_acceptance

    # JAX's render under jax.jit (eager it takes ~2 s a view here; the
    # jitted function is the same)
    monkeypatch.setattr(test_acceptance, "render",
                        jax.jit(test_acceptance.render, static_argnums=(2, 4)))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    test_acceptance.make_full_scene(tmp_path / "jax", np.random.default_rng(7))
    port.make_full_scene(tmp_path / "port", np.random.default_rng(7), device="cpu")
    j, p = tmp_path / "jax", tmp_path / "port"
    files = sorted(f.relative_to(j) for f in j.rglob("*") if f.is_file())
    assert files == sorted(f.relative_to(p) for f in p.rglob("*") if f.is_file())
    for f in files:
        if f.suffix in (".bin", ".npy") and f.parts[0] != "stereo_depth":
            assert (j / f).read_bytes() == (p / f).read_bytes(), f
        elif f.suffix == ".png":
            a = np.asarray(Image.open(j / f), np.int16)
            b = np.asarray(Image.open(p / f), np.int16)
            assert np.abs(a - b).max() <= 1, f
        else:
            a = read_pfm(j / f) if f.suffix == ".pfm" else np.load(j / f)
            b = read_pfm(p / f) if f.suffix == ".pfm" else np.load(p / f)
            np.testing.assert_array_equal(a != 0, b != 0, err_msg=str(f))
            np.testing.assert_allclose(b, a, atol=DEPTH_RTOL * float(np.ptp(a)), err_msg=str(f))


def test_train_argv_is_the_scripts():
    src = (REPO / "scripts" / "convergence_run.py").read_text()
    argv = port.train_argv(Path("S"), Path("O"), Path("D"), port.ITERATIONS)
    flags = [a for a in argv if a.startswith("-")]
    for f in flags:
        assert f'"{f}"' in src, f
    assert argv[argv.index("--test_iterations") + 1:argv.index("--save_iterations")] == [
        str(i) for i in (1, 100, 300, 600, 900, 1200, 1500)]


@pytest.mark.parametrize("final,first,fails", [
    ((30.0, 26.0), 10.0, 0),
    ((24.0, 20.0), 10.0, 1),     # train below 25
    ((30.0, 14.0), 10.0, 2),     # gain 4 dB < 5, gap 16 dB > 6
])
def test_checks(final, first, fails):
    evals = [{"iteration": 1, "train": {"psnr": first}, "test": {"psnr": first}},
             {"iteration": 2, "train": {"psnr": final[0]}, "test": {"psnr": final[1]}}]
    assert len(port.check(evals)) == fails


def _run(tmp_path, iterations):
    torch.manual_seed(0)
    rc = port.main(tmp_path, iterations=iterations, device="cpu")
    evals = json.loads((tmp_path / "out" / "eval_results.json").read_text())
    return rc, evals


def test_harness_plumbing(tmp_path):
    rc, evals = _run(tmp_path, 20)
    assert [e["iteration"] for e in evals] == [1, 20]
    assert rc == (1 if port.check(evals) else 0)
    assert (tmp_path / "dpt_tiny_hybrid.npz").exists()
    assert len(list((tmp_path / "scene" / "depth_adjust_maps_stereo").glob("*.npy"))) == 9
    out = tmp_path / "out"
    assert (out / "point_cloud" / "iteration_20" / "point_cloud.ply").exists()
    assert (out / "checkpoints" / "ckpt_20.pt").exists()
    assert all(np.isfinite(e[s]["psnr"]) for e in evals for s in ("train", "test"))


@pytest.mark.slow
def test_convergence_run(tmp_path):
    rc, evals = _run(tmp_path, port.ITERATIONS)
    assert rc == 0, port.check(evals)
