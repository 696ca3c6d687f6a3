"""SDP loss-stack A/B at protocol scale.

Counterpart of ``scripts/ablation_run.py``: the same scene, seed and
schedule through the port's ``Trainer``, one knob per arm, so that the
arms' held-out quality says what the pseudo-view regularization stack
(reference train.py:138-188) adds.

Arms (one per invocation; each writes ``<OUT>/<arm>/summary.json``,
``training_history.json`` and ``eval_results.json``):
  full      random-weight DPT-Hybrid mono-Pearson + segment Pearson +
            reprojection consistency in the pseudo window.
  nopseudo  depth_pseudo_weight=0.0: the pseudo branch adds zero gradient
            while the schedule (opacity resets keyed to start_sample_pseudo,
            densify cadence) stays the same.
  nomono    no depth net: the pseudo branch keeps only the reprojection term.
  oracle    the mono term fed -(GT depth) rendered from the hidden GT
            Gaussians at each pseudo camera (a perfect depth prior).

The arms are bit-identical until the pseudo window opens at iteration
2,000: every kernel of the step sums in a fixed order, so the card repeats
a run bit for bit.

Run (``SDPGS_ABLATION_SMOKE=1`` for 64x48 and 40 iterations,
``SDPGS_ABLATION_OUT`` for the output root, a temporary directory by
default):

    python -m sdpgs_torch.cli.ablation_run <full|nopseudo|nomono|oracle>
    python -m sdpgs_torch.cli.ablation_run report

:func:`run_arm` takes ``device="cpu"`` for the plain path.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

from sdpgs_torch import default_device

OUT = Path(os.environ.get("SDPGS_ABLATION_OUT", Path(tempfile.gettempdir()) / "ablation"))
SMOKE = os.environ.get("SDPGS_ABLATION_SMOKE", "") not in ("", "0")
WIDTH, HEIGHT = (64, 48) if SMOKE else (504, 378)
CAPACITY = (1 << 10) if SMOKE else (1 << 17)
GT_POINTS = 256 if SMOKE else 61_440
INIT_POINTS = 128 if SMOKE else 10_000
ITERATIONS = 40 if SMOKE else 10_000
ARMS = ("full", "nopseudo", "nomono", "oracle")


def build_raster():
    from sdpgs_torch.config import RasterizeConfig

    return RasterizeConfig(chunk=64) if not SMOKE else RasterizeConfig(
        tile=16, max_per_tile=128, max_tiles_per_gaussian=8, chunk=32, use_pallas=False)


def build_scene(n_test: int = 4, device=None):
    """The protocol scene (scripts/ablation_run.py:50-69): the same hidden
    ground truth, cameras, pseudo poses and initial cloud as the JAX
    package's from the same seed. Returns (scene, raster)."""
    from sdpgs_torch.data.synthetic import SyntheticScene

    raster = build_raster()
    scene = SyntheticScene(
        seed=0, n_points=GT_POINTS, capacity=CAPACITY, width=WIDTH, height=HEIGHT,
        n_train=3, n_pseudo=64 if SMOKE else 4096, init_scale=1e-2 if SMOKE else 1e-4,
        initial_opacity=0.9, raster=raster, n_segments=8, n_test=n_test,
        point_spread=1.0, depth_center=4.0, init_points=INIT_POINTS, device=device)
    return scene, raster


def build_cfg(raster, iterations: int = ITERATIONS):
    """The protocol schedule (scripts/ablation_run.py:72-93): tests every
    1,000 iterations, densify to 6,000, the pseudo window 2,000-5,500."""
    from sdpgs_torch.config import TrainConfig

    cfg = TrainConfig()
    cfg.raster = raster
    cfg.optim.iterations = iterations
    cfg.optim.save_iterations = ()
    cfg.optim.checkpoint_iterations = ()
    if SMOKE:
        cfg.optim.test_iterations = (20, 40)
        cfg.optim.densify_until_iter = 25
        cfg.optim.start_sample_pseudo = 5
        cfg.optim.end_sample_pseudo = 35
        cfg.optim.sample_pseudo_interval = 1
        return cfg
    cfg.optim.test_iterations = tuple(range(1000, iterations + 1, 1000))
    cfg.optim.densify_until_iter = 6000
    cfg.optim.start_sample_pseudo = 2000
    cfg.optim.end_sample_pseudo = 5500
    cfg.optim.sample_pseudo_interval = 1
    return cfg


def random_dpt(device=None):
    """The random-weight DPT (seed 0) in bf16: DPT-Hybrid, tiny_hybrid at
    the SMOKE size."""
    from sdpgs_torch.models.depth_estimator import mono_depth_from_params
    from sdpgs_torch.models.dpt import DPTArch, random_params

    arch = DPTArch.tiny_hybrid() if SMOKE else DPTArch.hybrid()
    return mono_depth_from_params(random_params(arch, seed=0), arch=arch,
                                  dtype=torch.bfloat16, device=device)


def instrumented(base):
    """``base`` with its iterations and events recorded for the summary:
    host ms between consecutive steps by kind (one whole iteration: step,
    events, logging; the device is synchronised at each step on a card),
    each densify event's ms, k-NN flag and counts, the opacity resets and
    the capacity ladder's messages."""
    import statistics

    class Instrumented(base):
        def __init__(self, *a, **kw):
            self.iter_ms = {"plain": [], "pseudo": []}
            self.events = {"densify": [], "reset": [], "ladder": []}
            self._last = None
            super().__init__(*a, **kw)

        def _sync(self):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return time.perf_counter()

        def _step_fn(self, sh_degree, with_pseudo):
            fn = super()._step_fn(sh_degree, with_pseudo)

            def timed(*a, **kw):
                now = self._sync()
                if self._last is not None:
                    self.iter_ms[self._last[1]].append((now - self._last[0]) * 1e3)
                self._last = (now, "pseudo" if with_pseudo else "plain")
                return fn(*a, **kw)
            return timed

        def _maybe_densify(self, iteration):
            t0 = self._sync()
            info = super()._maybe_densify(iteration)
            if info is not None:
                ms = (self._sync() - t0) * 1e3
                self.events["densify"].append(dict(
                    iteration=iteration, ms=ms,
                    knn=iteration < self.cfg.optim.proximity_until_iter,
                    **{k: int(v) for k, v in info._asdict().items()}))
            return info

        def _maybe_reset_opacity(self, iteration):
            fired = super()._maybe_reset_opacity(iteration)
            if fired:
                self.events["reset"].append(iteration)
            return fired

        def _set_raster(self, new, msg):
            self.events["ladder"].append(msg)
            super()._set_raster(new, msg)

        def timing(self) -> dict:
            med = {k: statistics.median(v) if v else None for k, v in self.iter_ms.items()}
            dens = self.events["densify"]
            return {"plain_iter_ms": med["plain"], "pseudo_iter_ms": med["pseudo"],
                    "plain_iters": len(self.iter_ms["plain"]),
                    "pseudo_iters": len(self.iter_ms["pseudo"]),
                    "knn_event_ms": [e["ms"] for e in dens if e["knn"]],
                    "other_event_ms": [e["ms"] for e in dens if not e["knn"]]}

    return Instrumented


def oracle_trainer_cls(base):
    """A Trainer (subclass of ``base``) whose depth net returns -(GT depth)
    at the pseudo camera handed out last: JAX swaps ``Trainer.mono_params``
    there (scripts/ablation_run.py:126-144); the port's depth net is a
    callable, so the oracle is one, refreshed where the reprojection
    z-buffer is popped. Both consumers negate mono, so -gt_depth scores
    rho = 1 on a perfect reconstruction. The depth carries no graph: its
    gradient is zero, as JAX's oracle output ignores the image."""
    from sdpgs_torch.render import render

    class OracleTrainer(base):
        def __init__(self, cfg, scene, device=None):
            self.oracle_depth = None
            super().__init__(cfg, scene=scene, mono_depth_fn=self.oracle_mono, device=device)

        def oracle_mono(self, image):
            return self.oracle_depth

        def _next_pseudo_reproj(self):
            item = super()._next_pseudo_reproj()
            with torch.no_grad():
                depth = render(item[0], self.scene.gt_gaussians, self.scene.gt_raster,
                               torch.zeros(3, device=self.device), 0,
                               device=self.device).depth
            self.oracle_depth = -depth
            return item

    return OracleTrainer


def make_trainer(arm: str, cfg, scene, device=None, trainer_cls=None):
    """The arm's Trainer (scripts/ablation_run.py:96-144), of
    ``trainer_cls`` (``Trainer`` by default) or a subclass of it."""
    from sdpgs_torch.train.loop import Trainer

    base = trainer_cls or Trainer
    if arm not in ARMS:
        raise ValueError(f"unknown arm {arm!r}: one of {ARMS}")
    if arm == "nopseudo":
        cfg.optim.depth_pseudo_weight = 0.0
    if arm in ("full", "nopseudo"):
        return base(cfg, scene=scene, mono_depth_fn=random_dpt(device), device=device)
    if arm == "nomono":
        return base(cfg, scene=scene, mono_depth_fn=None, device=device)
    return oracle_trainer_cls(base)(cfg, scene, device=device)


def run_arm(arm: str, out_root=None, iterations: int = ITERATIONS, log_every: int = 100,
            device=None) -> dict:
    """Train one arm for ``iterations`` and write its ``summary.json``
    under ``<out_root>/<arm>/`` (``OUT`` by default): JAX's fields, and the
    port's events, iteration times by kind and the device. Returns the
    summary with the Trainer's history under ``history``."""
    from sdpgs_torch.train.loop import Trainer

    dev = default_device(device)
    t0 = time.time()
    scene, raster = build_scene(device=dev)
    out = Path(out_root if out_root is not None else OUT) / arm
    out.mkdir(parents=True, exist_ok=True)
    scene.model_path = str(out)
    print(f"[{arm}] scene built in {time.time() - t0:.1f}s", flush=True)

    cfg = build_cfg(raster, iterations)
    trainer = make_trainer(arm, cfg, scene, device=dev, trainer_cls=instrumented(Trainer))
    t1 = time.time()
    hist = trainer.train(iterations=iterations, log_every=log_every)
    wall = time.time() - t1
    res = {
        "arm": arm,
        "iterations": iterations,
        "wall_s": round(wall, 1),
        "iters_per_s": round(iterations / wall, 2),
        "final": hist[-1] if hist else None,
        "eval": trainer.eval_history,
        "events": trainer.events,
        "timing": trainer.timing(),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
    }
    (out / "summary.json").write_text(json.dumps(res, indent=2))
    print(f"[{arm}] DONE: {iterations} iters in {wall:.1f}s "
          f"({iterations / wall:.2f} it/s wall)", flush=True)
    return dict(res, history=hist)


def report(out_root=None) -> dict:
    """Print the arms' test PSNR trajectories and final train PSNR from
    their summaries; returns {arm: summary}."""
    root = Path(out_root if out_root is not None else OUT)
    rows = {}
    for arm in ARMS:
        p = root / arm / "summary.json"
        if p.exists():
            rows[arm] = json.loads(p.read_text())
    if not rows:
        print("no arm summaries found under", root)
        return rows
    iters = sorted({e["iteration"] for r in rows.values() for e in r["eval"]})
    print("test PSNR trajectories:")
    print("iter  " + "".join(f"{a:>10}" for a in rows))
    for it in iters:
        line = f"{it:>5} "
        for r in rows.values():
            e = next((x for x in r["eval"] if x["iteration"] == it), None)
            line += f"{e['test']['psnr']:>10.2f}" if e and "test" in e else " " * 10
        print(line)
    print("\nfinal train PSNR / wall:")
    for a, r in rows.items():
        tr = next((x for x in reversed(r["eval"]) if "train" in x), None)
        tpsnr = f"{tr['train']['psnr']:.2f}" if tr else "-"
        print(f"  {a:>9}: train {tpsnr}  wall {r['wall_s']}s ({r['iters_per_s']} it/s)")
    return rows


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0] if argv else ""
    if cmd == "report":
        report()
    elif cmd in ARMS:
        run_arm(cmd, device=device)
    else:
        print(f"usage: ablation_run.py {{{'|'.join(ARMS)}|report}}")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
