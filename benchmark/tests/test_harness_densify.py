"""The early window's parts on the CPU: the reference's proximity rule
against the program's densify event, the isolated Gaussians' margins, the
scenes of the configurations without them, and a window that cycles."""

from __future__ import annotations

import hashlib
import json
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import control, program, scene as scene_lib, spec, train_cell
from benchmark.reference import densify as ref_densify

CPU = torch.device("cpu")
# the draws of each configuration's scene at the small size, seed 11, as
# the scene was made before isolated Gaussians existed: the hidden cloud,
# the trainee, the prototypes, the views, the extent and the pseudo poses
DRAWS = {"llff-fern-3view": "2f88bc306a41d177a3e2a4f6f52475a3",
         "m360-garden-24view": "6d55920d5c59eee2bdf51e4f985eb084",
         "m360-garden-24view-r4": "5647222bf53a6decf8031af03bac644a"}
# a configuration that has gained pseudo poses (``layout.n_pseudo``) still
# draws everything else as before: its scene built without them
WITHOUT_PSEUDO = {"m360-garden-24view": "5647222bf53a6decf8031af03bac644a"}


def draws(sc) -> str:
    h = hashlib.sha256()
    for part in (sc.hidden, sc.trainee):
        for k in sorted(part):
            h.update(part[k].contiguous().numpy().tobytes())
    h.update(sc.protos.numpy().tobytes())
    for v in sc.views:
        h.update(np.asarray(v.R, np.float64).tobytes())
        h.update(np.asarray(v.T, np.float64).tobytes())
    h.update(np.float64(sc.extent).tobytes())
    h.update(np.asarray(sc.pseudo_poses if sc.pseudo_poses is not None else 0,
                        np.float64).tobytes())
    return h.hexdigest()[:32]


def program_event(before: dict, cfg: dict, extent: float) -> dict:
    """The program's densify event with the proximity rule from ``before``,
    its k-NN as ``Trainer._maybe_densify`` takes it."""
    from sdpgs_torch.ops.knn import knn
    from sdpgs_torch.opt.adam import GaussianAdamState
    from sdpgs_torch.opt.densify import DensifyStats, densify_and_prune

    opt = cfg["optim"]
    g = program.gaussians({k: v.clone() for k, v in before.items() if torch.is_tensor(v)},
                          cfg["cloud"]["sh_degree"])
    state = SimpleNamespace(
        gaussians=g,
        opt_state=GaussianAdamState(mu={k: v.clone() for k, v in before["mu"].items()},
                                    nu={k: v.clone() for k, v in before["nu"].items()}, step=0),
        stats=DensifyStats(before["accum"].clone(), before["denom"].clone(),
                           torch.zeros_like(before["denom"])))
    gen = torch.Generator(device=CPU)
    gen.set_state(before["generator"])
    d2, idx = knn(g.xyz.detach(), k=3, mask=g.alive, device=CPU)
    finite = torch.isfinite(d2)
    dist = torch.where(finite, d2, 0.0).sum(-1) / torch.clamp_min(finite.sum(-1), 1)
    noise = torch.randn((g.capacity, 3), generator=gen, device=CPU)
    _, _, state.stats, _ = densify_and_prune(
        g, state.opt_state, state.stats, noise, grad_threshold=opt["densify_grad_threshold"],
        min_opacity=opt["prune_threshold"], extent=extent, percent_dense=opt["percent_dense"],
        run_proximity=True, knn_dist=dist, knn_idx=idx)
    return program.densify_state(state)


def test_reference_proximity_rule_matches_the_program(small_bench):
    """From a state with isolated Gaussians and some clones and splits:
    every slot as the program leaves it, the fields within the limit,
    three children for each isolated Gaussian."""
    cell = spec.load_cell("llff-train-early", root=small_bench)
    cfg = cell.config
    sc = scene_lib.build(cfg, 4, CPU, with_pseudo=False)
    before = control.densify_before(sc, cfg, 4, CPU)
    after = program_event(before, cfg, sc.extent)
    r = train_cell.densify_readings({"before": before, "after": after, "iteration": 1600},
                                    cfg, sc.extent, CPU)
    assert r["densify_slots"] == 0, r
    assert r["densify_gap"] <= cell.limits["limits"]["densify_gap"], r
    assert r["proximity_children"] == 3 * cfg["cloud"]["isolated"]["count"]
    # the rule's children are there: without it the event differs
    skipped = train_cell.reference_event(before, cfg, sc.extent, CPU, 1600, proximity=False)
    assert ref_densify.readings(after, skipped)["densify_slots"] == r["proximity_children"]


def test_isolated_gaussians_meet_the_rule_with_margins():
    """At the cell's size, on seeds small and large: each corner's three
    nearest are its own group's, their squared distances and the next one
    0.1 or more apart, their mean over five extents with room, every
    corner behind every train camera."""
    cfg = json.loads((spec.HERE / "configs" / "llff-fern-3view-early.json").read_text())
    iso = cfg["cloud"]["isolated"]
    for seed in (1, 2 ** 31 + 12345):
        rng = np.random.default_rng(seed)
        extent = scene_lib.extent_of(scene_lib.train_views(cfg["layout"], cfg["image"], rng))
        pos = scene_lib.isolated_positions(iso, rng)
        assert pos.shape == (iso["count"], 3) and (pos[:, 2] < -1.0).all()
        d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        order = np.argsort(d2, axis=1)[:, :3]
        assert (order // 4 == np.arange(len(pos))[:, None] // 4).all()
        near = np.sort(d2, axis=1)[:, :4]
        assert np.diff(near, axis=1).min() >= 0.1
        assert near[:, :3].mean(1).min() > 2.0 * 5.0 * extent
        assert iso["scale"] * np.exp(-4 * iso["scale_sd"]) > 1.3 * extent


def test_scenes_without_isolated_gaussians_are_unchanged(small_bench):
    """The configurations without ``cloud.isolated`` draw what they drew
    before it existed; the early one differs from fern's only in the
    isolated slots, which hold fern's last 32 alive Gaussians there."""
    for name, digest in DRAWS.items():
        cfg = json.loads((small_bench / "configs" / f"{name}.json").read_text())
        sc = scene_lib.build(cfg, 11, CPU, with_pseudo="n_pseudo" in cfg["layout"])
        assert draws(sc) == digest, name
    for name, digest in WITHOUT_PSEUDO.items():
        cfg = json.loads((small_bench / "configs" / f"{name}.json").read_text())
        assert draws(scene_lib.build(cfg, 11, CPU, with_pseudo=False)) == digest, name
    fern, early = (scene_lib.build(
        json.loads((small_bench / "configs" / f"{n}.json").read_text()), 11, CPU, False)
        for n in ("llff-fern-3view", "llff-fern-3view-early"))
    n, m = 512, 32
    rows = torch.ones(2048, dtype=torch.bool)
    rows[n - m:n] = False
    for part in ("hidden", "trainee"):
        for k, v in getattr(fern, part).items():
            assert torch.equal(v[rows], getattr(early, part)[k][rows]), (part, k)
            assert k == "alive" or not torch.equal(v[~rows], getattr(early, part)[k][~rows])


def test_a_cycled_window_repeats_bit_for_bit(small_bench, monkeypatch):
    """Chunks of 20 from 1,561 with ``stop`` 1,600 (a densify event with the
    k-NN and the proximity rule at its end): the second cycle's log points
    equal the first's in every bit. One thread: the CPU's threaded sums
    take no fixed order."""
    monkeypatch.setattr(train_cell, "CHUNK", 20)
    cfg = spec.load_cell("llff-train-early", root=small_bench).config
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sc = scene_lib.build(cfg, 5, CPU, with_pseudo=False)
        trainer = program.bench_trainer(False)(
            program.train_config(cfg), scene=program.ProgramScene(sc, cfg["cloud"]["sh_degree"]),
            device=CPU)
        trainer.state.step = trainer.state.opt_state.step = 1540
        trainer.train(iterations=1560, log_every=20)
        window = train_cell.Window(trainer, 1600)
        for _ in range(4):
            window.chunk()
    finally:
        torch.set_num_threads(threads)
    assert window.chunks == [1561, 1581, 1561, 1581]
    assert window.repeats() == {"cycles": 1, "cycle_log_points": 2, "cycle_differing": 0}
    assert int(trainer.state.gaussians.alive.sum()) > 512    # the events spawned
