"""The port's protocol harness (cli/ablation_run.py) against
scripts/ablation_run.py, on the CPU at the script's SMOKE size (64x48,
capacity 1,024, 40 iterations, the pseudo window 6-34, tests at 20 and 40).

- The ``nomono`` arm through both packages' build functions (the scene, the config,
  the arm's Trainer) from one seed: the same ground truth and initial
  cloud, then the logged loss and PSNR every 10 iterations and the test
  PSNR at 20 and 40 within LOSS_RTOL (float32 formulas summed in other
  orders, carried through 40 steps, 34 of them pseudo steps).
- The four arms, port only, bit-identical before the pseudo window: every
  tensor of the state after iteration 5 and every logged loss.
- The oracle arm's depth net returns -(GT depth) at the pseudo camera the
  Trainer handed out last: equal to the port's own render of the hidden
  ground truth there, and within DEPTH_TOL of JAX's oracle depth at the same
  camera (the same draw of the same pseudo pose).
"""

import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import few_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4     # logged loss and PSNR, test PSNR: port against JAX
DEPTH_TOL = 1e-4     # oracle depth, port against JAX, of the depth range
PRE_PSEUDO = 5       # the pseudo window opens after iteration 5 at SMOKE size


@pytest.fixture(scope="module")
def smoke():
    """Both harness modules with SDPGS_ABLATION_SMOKE=1 read at import: the
    JAX script loaded from its path, the port's module reloaded."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDPGS_ABLATION_SMOKE", "1")
        mp.setenv("SDPGS_COMPILE_CACHE", "off")
        spec = importlib.util.spec_from_file_location(
            "jax_ablation_run", REPO / "scripts" / "ablation_run.py")
        jax_mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jax_mod)
        from sdpgs_torch.cli import ablation_run

        port = importlib.reload(ablation_run)
        yield jax_mod, port
    importlib.reload(ablation_run)


def test_smoke_constants(smoke):
    jax_mod, port = smoke
    for k in ("WIDTH", "HEIGHT", "CAPACITY", "GT_POINTS", "INIT_POINTS", "ITERATIONS", "ARMS"):
        assert getattr(port, k) == getattr(jax_mod, k), k
    assert port.SMOKE and jax_mod.SMOKE


def test_nomono_arm_matches_jax(smoke, tmp_path):
    jax_mod, port = smoke
    hist, evals = {}, {}
    for name, mod, kw in (("jax", jax_mod, {}), ("port", port, dict(device="cpu"))):
        scene, raster = mod.build_scene(**kw) if name == "port" else mod.build_scene()
        scene.model_path = str(tmp_path / name)
        if name == "jax":   # before the Trainer: JAX's train step donates the cloud
            gt_j = np.asarray(scene.gt_gaussians.xyz)
            init_j = np.asarray(scene.gaussians.xyz)
        else:
            np.testing.assert_array_equal(scene.gt_gaussians.xyz.detach().numpy(), gt_j)
            np.testing.assert_array_equal(scene.gaussians.xyz.detach().numpy(), init_j)
        cfg = mod.build_cfg(raster)
        trainer = mod.make_trainer("nomono", cfg, scene, **kw)
        hist[name] = trainer.train(iterations=mod.ITERATIONS, log_every=10)
        evals[name] = trainer.eval_history
    assert [h["iter"] for h in hist["port"]] == [h["iter"] for h in hist["jax"]]
    assert [h["alive"] for h in hist["port"]] == [h["alive"] for h in hist["jax"]]
    for k in ("loss", "psnr"):
        np.testing.assert_allclose([h[k] for h in hist["port"]], [h[k] for h in hist["jax"]],
                                   rtol=LOSS_RTOL, err_msg=k)
    assert [e["iteration"] for e in evals["port"]] == [20, 40]
    for split in ("test", "train"):
        np.testing.assert_allclose([e[split]["psnr"] for e in evals["port"]],
                                   [e[split]["psnr"] for e in evals["jax"]], rtol=LOSS_RTOL)
    summary = json.loads((tmp_path / "port" / "eval_results.json").read_text())
    assert [e["iteration"] for e in summary] == [20, 40]


def test_arms_equal_before_the_pseudo_window(smoke, tmp_path):
    _, port = smoke
    states, hists = {}, {}
    for arm in port.ARMS:
        scene, raster = port.build_scene(device="cpu")
        cfg = port.build_cfg(raster)
        trainer = port.make_trainer(arm, cfg, scene, device="cpu")
        hists[arm] = trainer.train(iterations=PRE_PSEUDO, log_every=1)
        states[arm] = trainer.state.to_numpy()
    ref = states["full"]
    for arm in port.ARMS[1:]:
        assert hists[arm] == hists["full"], arm
        for part in ("gaussians", "mu", "nu", "stats"):
            for k, v in ref[part].items():
                np.testing.assert_array_equal(states[arm][part][k], v, err_msg=f"{arm} {k}")


def test_run_arm_writes_summary(smoke, tmp_path):
    _, port = smoke
    res = port.run_arm("nopseudo", out_root=tmp_path, iterations=8, log_every=4, device="cpu")
    summary = json.loads((tmp_path / "nopseudo" / "summary.json").read_text())
    assert summary["arm"] == "nopseudo" and summary["iterations"] == 8
    assert summary["final"] == res["history"][-1] and summary["device"] == "cpu"
    timing = summary["timing"]
    # iterations 1-5 plain, 6-8 pseudo; the last iteration closes no interval
    assert timing["plain_iters"] == 5 and timing["pseudo_iters"] == 2
    assert summary["events"]["reset"] == [6]
    assert (tmp_path / "nopseudo" / "training_history.json").exists()
    rows = port.report(tmp_path)
    assert list(rows) == ["nopseudo"]


def test_oracle_depth_is_the_ground_truth(smoke):
    jax_mod, port = smoke
    import jax.numpy as jnp

    from sdpgs_torch.render import render

    scene, raster = port.build_scene(device="cpu")
    trainer = port.make_trainer("oracle", port.build_cfg(raster), scene, device="cpu")
    cam = trainer._next_pseudo_reproj()[0]
    got = trainer.mono_depth_fn(torch.zeros((3, scene.pseudo_height, scene.pseudo_width)))
    assert not got.requires_grad
    with torch.no_grad():
        want = -render(cam, scene.gt_gaussians, scene.gt_raster, torch.zeros(3), 0,
                       device="cpu").depth
    assert torch.equal(got, want)
    assert float(got.min()) < 0.0

    from sdpgs_tpu.render import render as jrender

    jscene, _ = jax_mod.build_scene()
    # the trainer drew its first prefetch from its seeded generator: the same
    # index through the JAX Trainer's numpy draw
    idx = np.random.default_rng(trainer.cfg.seed).integers(0, len(jscene.pseudo_poses))
    jcam = jscene.pseudo_camera(int(idx))[0]
    jdepth = -np.asarray(jrender(jcam, jscene.gt_gaussians, jscene.gt_raster, jnp.zeros(3),
                                 0).depth)
    np.testing.assert_allclose(got.numpy(), jdepth,
                               atol=DEPTH_TOL * float(np.ptp(jdepth)))


def test_protocol_run_writes_its_files(smoke, tmp_path, monkeypatch):
    """protocol_run at the SMOKE size on the CPU, with a test and a
    checkpoint inside the run: its summary, the Trainer's files and the
    checkpoint on disk."""
    from sdpgs_torch.cli import protocol_run

    monkeypatch.setattr(protocol_run, "TEST_ITERATIONS", (4, 8, 1000))
    monkeypatch.setattr(protocol_run, "CHECKPOINT_ITERATIONS", (6,))
    res = protocol_run.main(out=tmp_path, iterations=8, device="cpu")
    summary = json.loads((tmp_path / "protocol_summary.json").read_text())
    assert summary["iterations"] == 8 and summary["final"] == res["final"]
    assert [e["iteration"] for e in summary["eval"]] == [4, 8]
    assert all(np.isfinite(e[s]["psnr"]) for e in summary["eval"] for s in ("test", "train"))
    assert (tmp_path / "checkpoints" / "ckpt_6.pt").exists()
    for name in ("training_history.json", "eval_results.json"):
        assert (tmp_path / name).exists(), name
