"""The control and the planted faults, read by the same comparison as a
run, at the cell's own size. Each is the reference put in the program's
place:

- ``control``: computed one precision below the configuration's
  (``reference/precision.Lower``: float32 products in TF32, the bfloat16
  depth net's in float8);
- ``altered``: every render altered where it is produced (its middle
  tile left out: black, depth and feature zero);
- ``no_pseudo`` (cells with pseudo iterations): the pseudo view's half of
  each step's batch left out;
- ``densify_frozen``, ``densify_unmoved``, ``proximity_skipped`` (cells
  with a densify event in set-up; the last where the event comes before
  ``proximity_until_iter``): the event's state left as it was before it,
  the event with its split children left on their sources (no offset),
  and the event without the proximity rule, each against the reference
  event from a state made from the seed (the trainee, moments and
  statistics drawn so that some 2% of the alive Gaussians densify, a
  quarter of the Gaussians at least twice the split size); the control
  reads that event one precision below;
- ``jitter`` (cells with pseudo iterations, a witness and no fault): the
  reference itself with every render's colour moved by one part in a
  million, the size of the compositor's rounding, to read how far the
  bfloat16 depth net carries such a difference.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

prints one JSON line per seed with each one's readings and the cell's
limits. The benchmark's runs do not run it; a limit is set between the
program's readings and these (``benchmark/limits/<cell>.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def patched_renders(change):
    """The reference's renders, each passed through ``change``."""
    from benchmark.reference import step
    from benchmark.reference.raster import render

    step.render = lambda *a, **kw: change(render(*a, **kw))
    try:
        yield
    finally:
        step.render = render


def skip_middle_tile(tile: int):
    """A render altered where it is produced: its middle tile left out
    (black, depth and feature zero), as a compositor that skipped it."""
    def change(out):
        H, W = out.depth.shape
        y, x = (H // tile // 2) * tile, (W // tile // 2) * tile
        for name in ("color", "depth", "feature"):
            v = getattr(out, name).clone()
            v[y:y + tile, x:x + tile] = 0.0
            setattr(out, name, v)
        return out
    return change


def jitter(seed: int):
    """A render's colour moved by one part in a million, from ``seed``."""
    import torch

    def change(out):
        gen = torch.Generator(device=out.color.device).manual_seed(seed)
        noise = torch.randn(out.color.shape, generator=gen, device=out.color.device)
        out.color = out.color * (1.0 + 1e-6 * noise)
        return out
    return change


def densify_before(sc, cfg: dict, seed: int, dev) -> dict:
    """A state to densify from, made from the seed: the trainee, moments,
    and statistics whose mean gradient reaches the threshold on about 2%
    of the alive Gaussians, a quarter of which are above the split size."""
    import math

    import torch

    from benchmark.reference.raster import FIELDS
    from benchmark.scene import generator

    gen = generator(seed + 1, dev)
    alive = sc.trainee["alive"]
    state = {k: sc.trainee[k].clone() for k in FIELDS}
    state["alive"] = alive.clone()
    state["confidence"] = torch.ones_like(alive)[:, None]
    state["mu"] = {k: 1e-3 * torch.randn(v.shape, generator=gen, device=dev)
                   for k, v in state.items() if k in FIELDS}
    state["nu"] = {k: 1e-6 * torch.rand(v.shape, generator=gen, device=dev)
                   for k, v in state.items() if k in FIELDS}
    z = torch.randn(alive.shape, generator=gen, device=dev)
    state["denom"] = 100.0 * alive
    state["accum"] = (cfg["optim"]["densify_grad_threshold"] * torch.exp(0.5 * z - 1.0)
                      * state["denom"])
    # a quarter of them at least twice the split size on every axis, so
    # that the event splits some wherever the trainee's scales lie below it
    floor = math.log(2.0 * cfg["optim"]["percent_dense"] * sc.extent)
    grown = torch.rand(alive.shape, generator=gen, device=dev) < 0.25
    state["scaling"] = torch.where(grown[:, None], state["scaling"].clamp_min(floor),
                                   state["scaling"])
    state["generator"] = generator(seed + 2, dev).get_state()
    return state


def densify_modes(sc, cfg: dict, seed: int, dev, iteration: int) -> dict:
    import torch

    from benchmark.reference import densify as ref_densify
    from benchmark.train_cell import densify_readings, reference_event

    before = densify_before(sc, cfg, seed, dev)

    def judged(after):
        return densify_readings({"before": before, "after": after, "iteration": iteration},
                                cfg, sc.extent, dev)

    def event(**kw):
        return reference_event(before, cfg, sc.extent, dev, iteration, **kw)

    out = {"control": judged(event(control=True)),
           "densify_frozen": judged({k: v for k, v in before.items() if k != "generator"})}
    real = ref_densify.rotation
    ref_densify.rotation = lambda q: torch.zeros(q.shape[:-1] + (3, 3), device=q.device)
    try:
        unmoved = event()
    finally:
        ref_densify.rotation = real
    out["densify_unmoved"] = judged(unmoved)
    if iteration < cfg["optim"]["proximity_until_iter"]:
        out["proximity_skipped"] = judged(event(proximity=False))
    return out


def train_readings(cell, seed: int, dev) -> dict:
    import torch

    from benchmark import check, program, scene as scene_lib
    from benchmark.program import Recorded
    from benchmark.train_cell import CHECKED, CHUNK, events_in, follow, in_pseudo, net_readings

    cfg = cell.config
    start = int(cell.traffic["start"])
    pseudo = in_pseudo(cfg["optim"], start)
    sc = scene_lib.build(cfg, seed, dev, with_pseudo=pseudo)
    weights = (scene_lib.dpt_weights(program.dpt_names_shapes(cfg), seed, dev,
                                     getattr(torch, cfg["depth_net"]["dtype"]))
               if pseudo else None)
    records = [Recorded(view=i % len(sc.views), pseudo=i if pseudo else None, loss=None)
               for i in range(CHECKED)]
    params = {k: v for k, v in sc.trainee.items() if k != "alive"}
    alive = sc.trainee["alive"]
    ref = follow(sc, cfg, params, alive, records, start, weights, dev)
    out = {"control": check.train_readings(
        follow(sc, cfg, params, alive, records, start, weights, dev, control=True), ref)}
    with patched_renders(skip_middle_tile(cfg["raster"]["tile"])):
        out["altered"] = check.train_readings(
            follow(sc, cfg, params, alive, records, start, weights, dev), ref)
    if pseudo:
        out["control"].update(net_readings(ref["net_seen"], cfg, weights, dev, control=True))
    warm_end = -(-(start + CHECKED - 1) // CHUNK) * CHUNK
    events = events_in(cfg["optim"], start + CHECKED, warm_end)
    if events:
        modes = densify_modes(sc, cfg, seed, dev, events[0])
        out["control"].update(modes.pop("control"))
        out.update(modes)
    if pseudo:
        plain = [Recorded(view=r.view, pseudo=None, loss=None) for r in records]
        out["no_pseudo"] = check.train_readings(
            follow(sc, cfg, params, alive, plain, start, weights, dev), ref)
        with patched_renders(jitter(seed)):
            out["jitter"] = check.train_readings(
                follow(sc, cfg, params, alive, records, start, weights, dev), ref)
    return out


def render_readings(cell, seed: int, dev) -> dict:
    import numpy as np
    import torch

    from benchmark import check, scene as scene_lib
    from benchmark.reference.camera import Cam
    from benchmark.reference.precision import context
    from benchmark.reference.raster import FIELDS, render, to_rgb8

    cfg, tr = cell.config, cell.traffic
    sc = scene_lib.build(cfg, seed, dev, with_pseudo=False)
    views = scene_lib.spiral_views(sc, int(tr["frames"]))
    rng = np.random.default_rng(seed)
    picks = sorted(rng.choice(len(views), int(tr["checked_views"]), replace=False))
    raster, bg = scene_lib.raster_of(cfg), torch.zeros(3, device=dev)
    hidden = {k: sc.hidden[k] for k in FIELDS}

    def images(control: bool, skip: bool = False):
        out = []
        with torch.no_grad(), context(control):
            for i in picks:
                color = render(hidden, sc.hidden["alive"], Cam.of(views[int(i)], dev), raster,
                               bg, cfg["cloud"]["sh_degree"]).color
                if skip:
                    t = raster.tile
                    y, x = (color.shape[0] // t // 2) * t, (color.shape[1] // t // 2) * t
                    color[y:y + t, x:x + t] = 0.0
                out.append(to_rgb8(color).cpu())
        return out

    ref = images(False)
    return {"control": check.render_readings(images(True), ref),
            "altered": check.render_readings(images(False, skip=True), ref)}


def readings(cell, seed: int, dev) -> dict:
    drive = {"train": train_readings, "render": render_readings}[cell.traffic["kind"]]
    return drive(cell, seed, dev)


def main(argv=None) -> int:
    import torch

    from benchmark import spec

    p = argparse.ArgumentParser(description="the control's readings of a cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = readings(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": cell.name, "seed": seed, **r,
                          "limits": cell.limits["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
