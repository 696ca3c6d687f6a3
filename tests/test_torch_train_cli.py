"""The port's train CLI (cli/train_cli.py) against sdpgs_tpu's, on the CPU.

``config_from_args`` must give JAX's config on every field both
``TrainConfig``s share, for the same argv (per-field optimization flags
included), and the parser must have JAX's flags and defaults. Multi-card
flags end in SystemExit. The whole slice: JAX's ``train_cli.main`` and the
port's ``main(argv, device="cpu")`` train the same 64x48 COLMAP tree from
disk with one argv (``Trainer(cfg)`` loads the scene, 8 iterations, tile
16, an eval and a save at the last; the port's run adds a checkpoint).
Required: the evaluated train and test L1 within 1e-4 relative, and each
field of the saved PLYs within 1e-4 relative in the norm (float32 formulas
summed in other orders, carried through 8 Adam steps), except rot_* and
scale_*: the init is isotropic, so a Gaussian's covariance does not
depend on its rotation and the exact rotation gradient is 0; the computed
one is round-off, which Adam's normalised step turns into a move of about
the learning rate in either package's own direction, and scales then
follow the rotated axes. So those two are held through the covariances
they make, within 1e-3 relative in the norm (1.4e-4 measured on the CPU).
Then the port resumes from its checkpoint for 2 more iterations.
"""

import dataclasses
import json
import runpy
import sys

import numpy as np
import pytest
import torch

from sdpgs_torch import config as tconfig
from sdpgs_torch.cli import train_cli as tcli
from sdpgs_torch.data.ply import read_ply
from sdpgs_tpu import config as jconfig
from sdpgs_tpu.cli import train_cli as jcli
from test_scene import make_colmap_scene
from torch_threads import few_threads  # noqa: F401  (autouse)

# 64x48 at tile 16 is 12 tiles: K and D that no cloud here outgrows, so the
# capacity ladder never asks JAX for a second compile
RASTER = dict(tile=16, max_per_tile=512, max_tiles_per_gaussian=16, chunk=32)
ITERATIONS = 8
TOL = 1e-4       # evaluated L1 relative, and each PLY field relative in the norm
COV_TOL = 1e-3   # the covariances that rot_* and scale_* make, relative in the norm


def rel_err(got, ref) -> float:
    """|got - ref| / |ref| in the norm (0 where both are 0)."""
    diff = np.linalg.norm(np.asarray(got, np.float64) - ref)
    return float(diff / np.linalg.norm(ref)) if diff else 0.0


def covariances(p) -> np.ndarray:
    """[N, 3, 3] R S S^T R^T from a Gaussian PLY's rot_* and scale_*."""
    q = np.stack([p[f"rot_{i}"] for i in range(4)], -1).astype(np.float64)
    w, x, y, z = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                 -1).reshape(-1, 3, 3)
    M = R * np.exp(np.stack([p[f"scale_{i}"] for i in range(3)], -1).astype(np.float64))[:, None]
    return M @ M.transpose(0, 2, 1)


def shared(a, b, path="cfg"):
    """Assert equality on every field the two config dataclasses share."""
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    keys = fa.keys() & fb.keys()
    assert keys, path
    for k in keys:
        assert fa[k] == fb[k], (f"{path}.{k}", fa[k], fb[k])
    return keys


ARGVS = {
    "defaults": [],
    "model_flags": ["-m", "out", "-i", "images_4", "-l", "feats", "-r", "4", "-w",
                    "--nviews", "5", "--sh_degree", "2", "--capacity", "4096", "--seed", "3",
                    "--dpt_weights", "d.npz", "--lpips_weights", "l.npz", "--quiet"],
    "schedule": ["--iterations", "3000", "--test_iterations", "100", "200",
                 "--save_iterations", "1000", "--checkpoint_iterations", "500", "1500"],
    "optim_overrides": ["--densify_grad_threshold", "0.001", "--include_feature", "false",
                        "--pseudo_seg_from_train_view", "True", "--start_sample_pseudo", "100",
                        "--position_lr_init", "0.0002", "--densification_interval", "50",
                        "--views_per_batch", "2", "--mesh", "data=1,gauss=1"],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_config_from_args_matches_jax(name):
    argv = ["-s", "scene_dir"] + ARGVS[name]
    t = tcli.config_from_args(tcli.build_parser().parse_args(argv))
    j = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert "optim" in shared(t, j) and "mesh_data" in shared(t, j)
    for part in ("model", "optim", "pipeline", "raster"):
        shared(getattr(t, part), getattr(j, part), part)
    assert t.views_per_batch == (2 if name == "optim_overrides" else 1)


def test_parser_has_jax_flags_and_defaults():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs)
                for a in parser._actions if a.dest != "help"}

    assert flags(tcli.build_parser()) == flags(jcli.build_parser())


@pytest.mark.parametrize("argv", [["--mesh", "data=2"], ["--mesh", "gauss=2,tile=2"],
                                  ["--dist_coordinator", "localhost:1234"],
                                  ["--dist_num_processes", "2", "--dist_process_id", "0"]],
                         ids=["mesh_data", "mesh_gauss_tile", "coordinator", "processes"])
def test_multi_card_flags_refused(argv, tmp_path):
    """A mesh is accepted but needs a process group of as many ranks; the
    multi-process flags need all three (or ``auto``): without them, no run
    falls back to one card."""
    args = tcli.build_parser().parse_args(["-s", "x"] + argv)
    cfg = tcli.config_from_args(args)
    if argv[0] == "--mesh":
        assert cfg.mesh_data * cfg.mesh_gauss * cfg.mesh_tile > 1
        with pytest.raises(ValueError, match="torch.distributed ranks, have 1"):
            tcli.main(["-s", str(tmp_path)] + argv, device="cpu")
    else:
        with pytest.raises(SystemExit, match="must all be given"):
            tcli.main(["-s", str(tmp_path)] + argv, device="cpu")


def test_multi_process_environment_refused(monkeypatch, tmp_path):
    monkeypatch.setenv("SDPGS_NUM_PROCESSES", "2")
    with pytest.raises(SystemExit, match="must all be given"):
        tcli.main(["-s", str(tmp_path)], device="cpu")
    monkeypatch.delenv("SDPGS_NUM_PROCESSES")
    with pytest.raises(SystemExit, match="unknown axis"):
        tcli.config_from_args(tcli.build_parser().parse_args(["-s", "x", "--mesh", "rows=2"]))


def test_module_runs_main_on_cuda_by_default(tmp_path, monkeypatch):
    """``python -m sdpgs_torch.cli.train_cli`` saves cfg.json, then the
    Trainer asks for the card: without one it raises, and nothing falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", ["train_cli", "-s", str(tmp_path), "-m", str(out)])
    monkeypatch.delitem(sys.modules, "sdpgs_torch.cli.train_cli")  # as ``python -m`` finds it
    with pytest.raises(RuntimeError, match="CUDA device"):
        runpy.run_module("sdpgs_torch.cli.train_cli", run_name="__main__")
    cfg = tconfig.load_config(out / "cfg.json")
    assert cfg.model.source_path == str(tmp_path)
    assert cfg.optim.save_iterations[-1] == cfg.optim.iterations


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One argv through both packages' train_cli.main on one tree."""
    base = tmp_path_factory.mktemp("cli")
    root = base / "llff_scene"
    root.mkdir()
    make_colmap_scene(root)

    def argv(out):
        return ["-s", str(root), "-m", str(out), "-r", "1", "--nviews", "3",
                "-l", "features_dim3", "--capacity", "512", "--iterations", str(ITERATIONS),
                "--test_iterations", str(ITERATIONS)]

    # the port alone writes a checkpoint: JAX's (orbax) would add seconds and
    # is not compared
    port_argv = argv(base / "port") + ["--checkpoint_iterations", str(ITERATIONS)]

    def with_raster(mod, **extra):
        parse = mod.config_from_args

        def config_from_args(args):
            cfg = parse(args)
            cfg.raster = dataclasses.replace(cfg.raster, **RASTER, **extra)
            return cfg
        return config_from_args

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDPGS_COMPILE_CACHE", "off")
        mp.setattr(jcli, "config_from_args", with_raster(
            jcli, use_pallas=False, use_rank_kernel=False))
        jcli.main(argv(base / "jax"))
        mp.setattr(tcli, "config_from_args", with_raster(tcli))
        trainer = tcli.main(port_argv, device="cpu")
        # the resumed run rewrites the report with its own (empty) history
        report = json.loads((base / "port" / "eval_results.json").read_text())
        resumed = tcli.main(port_argv + [
            "--iterations", str(ITERATIONS + 2),
            "--start_checkpoint", f"{base / 'port' / 'checkpoints'}:{ITERATIONS}"],
            device="cpu")
    return base, trainer, resumed, report


def test_train_cli_matches_jax(trained):
    base, trainer, _, t_eval = trained
    jdir, tdir = base / "jax", base / "port"
    assert trainer.device.type == "cpu" and trainer.state.step == ITERATIONS
    for f in ("cfg.json", "input.ply", "cameras.json", "eval_results.json",
              "training_history.json", f"point_cloud/iteration_{ITERATIONS}/point_cloud.ply",
              f"checkpoints/ckpt_{ITERATIONS}.pt"):
        assert (tdir / f).exists(), f
    assert (tdir / "cameras.json").read_text() == (jdir / "cameras.json").read_text()
    assert (tdir / "input.ply").read_bytes() == (jdir / "input.ply").read_bytes()

    ply = f"point_cloud/iteration_{ITERATIONS}/point_cloud.ply"
    got, ref = read_ply(tdir / ply), read_ply(jdir / ply)
    assert got.keys() == ref.keys() and len(got["x"]) == len(ref["x"]) > 0
    for k in got:
        if k.startswith(("scale_", "rot_")):
            continue
        assert rel_err(got[k], ref[k]) <= TOL, k
    assert rel_err(covariances(got), covariances(ref)) <= COV_TOL

    j_eval = json.loads((jdir / "eval_results.json").read_text())
    assert [r["iteration"] for r in t_eval] == [r["iteration"] for r in j_eval] == [ITERATIONS]
    for kind in ("train", "test"):
        assert t_eval[0][kind]["n_views"] == j_eval[0][kind]["n_views"] == 3 - (kind == "test")
        assert t_eval[0][kind]["l1"] == pytest.approx(j_eval[0][kind]["l1"], rel=TOL, abs=TOL)
    assert t_eval[0]["total_points"] == j_eval[0]["total_points"]


def test_train_cli_resumes(trained):
    base, _, resumed, _ = trained
    tdir = base / "port"
    assert resumed.state.step == ITERATIONS + 2
    assert (tdir / f"point_cloud/iteration_{ITERATIONS + 2}/point_cloud.ply").exists()
    history = json.loads((tdir / "training_history.json").read_text())
    assert [h["iter"] for h in history] == [ITERATIONS + 2]
