"""The training generator: a closed loop of ``Trainer.train`` in whole
chunks of a hundred iterations, from the traffic's ``start`` iteration.

Set-up builds the scene, the depth net and one Trainer from the seed,
puts its counters where the protocol has them at ``start - 1`` (the Adam
moments at zero), drives its first three steps through ``train`` (the
check's steps, recording the depth net's first call), then on to the
next hundred (every shape the window uses, a densify event where the
schedule has one, the first recorded for the check). The window runs whole
chunks until ``seconds`` have passed. With a ``stop`` in the traffic (a
chunk boundary), a chunk that would pass it starts from the Trainer as the
window found it (``program.Rewind``), so the window cycles inside the
schedule's range and each cycle repeats the last bit for bit. A traced run
adds synchronised brackets over the window, then times one chunk without
them and profiles one more, cycling alike; an untraced run of a cell whose
end-to-end metric is read from the device trace profiles one chunk after
the window.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import check, program, scene as scene_lib, spans, work
from benchmark.measure import Run
from benchmark.reference import densify as ref_densify, dpt as ref_dpt
from benchmark.reference.camera import Cam, intrinsics
from benchmark.reference.losses import reproject_fused_depth_batch
from benchmark.reference.precision import context
from benchmark.reference.raster import FIELDS
from benchmark.reference.step import StepInputs, Trainee, options
from benchmark.tracing import profiled

CHUNK = 100          # the Trainer's log cadence: a chunk ends on a log point
CHECKED = 3          # steps the reference follows
SAMPLED_VIEWS = 4    # views per state binned for the work counts


def events_in(opt: dict, lo: int, hi: int) -> list:
    """Iterations in [lo, hi] at which the schedule densifies or resets."""
    out = []
    for it in range(lo, hi + 1):
        dens = (opt["densify_from_iter"] < it < opt["densify_until_iter"]
                and it % opt["densification_interval"] == 0)
        reset = (it > opt["start_sample_pseudo"]
                 and (it - opt["start_sample_pseudo"] - 1) % opt["opacity_reset_interval"] == 0)
        if dens or reset:
            out.append(it)
    return out


def in_pseudo(opt: dict, it: int) -> bool:
    return (opt["start_sample_pseudo"] < it < opt["end_sample_pseudo"]
            and it % opt["sample_pseudo_interval"] == 0)


def params_of(g) -> dict:
    return {k: getattr(g, k).detach().clone() for k in FIELDS}


def reference_depth(cfg: dict, weights: dict, dev):
    d = cfg["depth_net"]
    with torch.device("meta"):
        net = ref_dpt.DPT(program.ref_dpt_arch(cfg), image_size=d["image_size"])
    net = net.to_empty(device=dev)
    net.load_state_dict(weights)
    return ref_dpt.MonoDepth(net, dtype=getattr(torch, d["dtype"]), resize_method=d["resize"])


def step_inputs(sc, rec, dev) -> StepInputs:
    v = rec.view
    inp = StepInputs(cam=Cam.of(sc.views[v], dev), image=sc.image[v], depth_mono=sc.depth[v],
                     feature=sc.feature[v], seg_map=sc.seg_map[v])
    if rec.pseudo is not None:
        cams = [Cam.of(w, dev) for w in sc.views]
        pc = Cam.of(sc.pseudo_view(rec.pseudo), dev)
        K = torch.from_numpy(intrinsics(sc.views[0])).to(dev)
        fused, weight = reproject_fused_depth_batch(
            sc.depth, K, torch.stack([c.view[:3, :3] for c in cams]),
            torch.stack([c.view[:3, 3] for c in cams]), pc.view[None, :3, :3],
            pc.view[None, :3, 3])
        inp.pseudo_cam, inp.fused, inp.weight = pc, fused[0], weight[0]
    return inp


def follow(sc, cfg: dict, start_params: dict, alive, records: list, start: int, weights,
           dev, control: bool = False) -> dict:
    """The reference (or, with ``control``, the reference one precision
    below) through the recorded steps from the same state: its losses and
    the train views' L1, first moments and change after one step, change
    over all of them, and its depth net's first call (``net_seen``)."""
    mono = None
    if weights is not None:
        mono = program.DepthNet(reference_depth(cfg, weights, dev))
        mono.tap = True
    t = Trainee(start_params, alive, step=start - 1, adam_step=start - 1)
    opt, raster = options(cfg["optim"]), scene_lib.raster_of(cfg)
    bg = torch.zeros(3, device=dev)
    losses, l1s, mu1, change1 = [], [], None, None
    with context(control):
        for rec in records:
            loss, l1 = t.train_step(step_inputs(sc, rec, dev), opt, raster, sc.protos, bg,
                                    cfg["cloud"]["sh_degree"], sc.extent, mono)
            losses.append(loss)
            l1s.append(l1)
            if mu1 is None:
                mu1 = {k: v.clone() for k, v in t.mu.items()}
                change1 = {k: t.params[k] - start_params[k] for k in FIELDS}
    return {"losses": losses, "l1": l1s, "mu1": mu1, "change1": change1,
            "change": {k: t.params[k] - start_params[k] for k in FIELDS},
            "net_seen": mono.seen if mono is not None else None}


def rel_gap(got, ref) -> float:
    """||got - ref|| / ||ref||, in float64."""
    got, ref = got.double(), ref.double()
    norm = torch.linalg.vector_norm
    return float(norm(got - ref) / norm(ref).clamp_min(1e-30))


def net_readings(seen: dict, cfg: dict, weights, dev, control: bool = False) -> dict:
    """The reference depth net (with ``control``, one precision below) on
    the input of a recorded call and with the gradient that reached its
    output there: ``net_out``, the relative gap of the recorded output,
    and ``net_grad``, of the recorded input gradient."""
    mono = reference_depth(cfg, weights, dev)
    with context(control), torch.enable_grad():
        x = seen["image"].clone().requires_grad_(True)
        y = mono(x)
        (gx,) = torch.autograd.grad(y, x, seen["grad_out"])
    return {"net_out": rel_gap(seen["out"], y.detach()),
            "net_grad": rel_gap(seen["grad_in"], gx)}


def reference_event(before: dict, cfg: dict, extent: float, dev, iteration: int,
                    control: bool = False, proximity: bool = True) -> dict:
    """The reference densify event at ``iteration`` (with ``control``, one
    precision below) from the recorded state ``before``, its split noise
    drawn from the recorded generator state as the program draws it, the
    proximity rule where the schedule runs it (and ``proximity``)."""
    opt = cfg["optim"]
    gen = torch.Generator(device=dev)
    gen.set_state(before["generator"])
    noise = torch.randn(tuple(before["xyz"].shape), generator=gen, device=dev)
    state = {k: on_device(v, dev) for k, v in before.items() if k != "generator"}
    with context(control):
        return ref_densify.densify_and_prune(
            state, noise, grad_threshold=opt["densify_grad_threshold"],
            min_opacity=opt["prune_threshold"], extent=extent,
            percent_dense=opt["percent_dense"],
            run_proximity=proximity and iteration < opt["proximity_until_iter"])


def on_device(v, dev):
    return {k: t.to(dev) for k, t in v.items()} if isinstance(v, dict) else v.to(dev)


def densify_readings(seen: dict, cfg: dict, extent: float, dev) -> dict:
    """The program's state after the recorded event against the reference
    event's from the state before it."""
    after = {k: on_device(v, dev) for k, v in seen["after"].items() if k != "generator"}
    return ref_densify.readings(after, reference_event(seen["before"], cfg, extent, dev,
                                                       seen["iteration"]))


def geometry(g) -> dict:
    return {k: getattr(g, k).detach().clone() for k in ("xyz", "scaling", "rotation", "alive")}


def step_work(states: list, sc, cfg: dict, pseudo: bool, seed: int, dev) -> dict:
    """Bytes and operations of one iteration, averaged over the sampled
    states and views."""
    rng = np.random.default_rng(seed)
    raster, sh = scene_lib.raster_of(cfg), cfg["cloud"]["sh_degree"]
    nv = len(sc.views)
    train = [sc.views[i] for i in sorted(rng.choice(nv, min(nv, SAMPLED_VIEWS), replace=False))]
    kinds = {"train": train}
    if pseudo:
        kinds["pseudo"] = [sc.pseudo_view(int(i)) for i in
                           rng.choice(len(sc.pseudo_poses), SAMPLED_VIEWS, replace=False)]
    per = {}
    for kind, views in kinds.items():
        ws = [work.view_work(s, Cam.of(v, dev), raster, sh) for s in states for v in views]
        per[kind] = dict(fwd=np.mean([w.forward(sh) for w in ws]),
                         bwd=np.mean([w.backward(sh) for w in ws]),
                         k5=np.mean([w.k5() for w in ws]), pixels=ws[0].pixels)
    live = np.mean([float(s["alive"].sum()) for s in states])
    nbytes = work.adam_bytes(int(live))
    for kind, p in per.items():
        nbytes += p["fwd"] + p["bwd"] + work.loss_bytes(p["pixels"], kind == "pseudo")
    return {"bytes_per_unit": float(nbytes),
            "flops_per_unit": work.depth_net_flops(cfg) if pseudo else 0.0,
            "k5_bytes_per_unit": float(sum(p["k5"] for p in per.values()))}


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float):
    """One run of a training cell; returns (Run, readings, peak bytes,
    iterations attempted, log points whose loss was not finite)."""
    cfg, tr = cell.config, cell.traffic
    opt = cfg["optim"]
    start = int(tr["start"])
    if events_in(opt, start, start + CHECKED - 1):
        raise ValueError(f"an event falls in the checked steps {start}..{start + CHECKED - 1}")
    pseudo = in_pseudo(opt, start)
    sh = cfg["cloud"]["sh_degree"]
    out = Run(kind="train")
    t = out.lap("start", t_start)
    sc = scene_lib.build(cfg, seed, dev, with_pseudo=pseudo)
    t = out.lap("scene", t)
    weights = mono = None
    if pseudo:
        weights = scene_lib.dpt_weights(program.dpt_names_shapes(cfg), seed, dev,
                                        getattr(torch, cfg["depth_net"]["dtype"]))
        mono = program.DepthNet(program.depth_net(cfg, weights, dev), on=trace)
        mono.tap = True
    trainer = program.bench_trainer(trace)(program.train_config(cfg),
                                           scene=program.ProgramScene(sc, sh),
                                           mono_depth_fn=mono, device=dev)
    trainer.state.step = start - 1
    trainer.state.opt_state.step = start - 1
    t = out.lap("program", t)
    p0, alive0 = params_of(trainer.state.gaussians), trainer.state.gaussians.alive.clone()
    trainer.record = []
    trainer.densify_tap = True
    trainer.train(iterations=start + CHECKED - 1, log_every=CHUNK)
    records, trainer.record = trainer.record, None
    p3 = params_of(trainer.state.gaussians)
    prog = {"losses": [float(r.loss) for r in records], "l1": [float(r.l1) for r in records],
            "mu1": trainer.mu1,
            "change1": {k: trainer.params1[k] - p0[k] for k in FIELDS},
            "change": {k: p3[k] - p0[k] for k in FIELDS}}
    del p3
    trainer.params1 = None
    t = out.lap("checked_steps", t)
    trainer.train(iterations=-(-(start + CHECKED - 1) // CHUNK) * CHUNK, log_every=CHUNK)
    # only set-up's event is checked: a window past the schedule's last
    # event would otherwise copy the whole state to the host at every
    # interval, waiting for one that never comes
    trainer.densify_tap = False

    program.sync(dev)
    window = Window(trainer, tr.get("stop"))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = out.lap("warm_up", t)
    for v in trainer.brackets.values():
        v.clear()
    if mono is not None:
        mono.times.clear()
    out.setup_s = time.perf_counter() - t_start
    t_open = time.perf_counter()
    while True:
        window.chunk()
        if time.perf_counter() - t_open >= seconds:
            break
    out.window_s = program.sync(dev) - t_open
    out.units = CHUNK * len(window.chunks)
    out.pseudo_units = sum(in_pseudo(opt, it) for first in window.chunks
                           for it in range(first, first + CHUNK))
    failed = sum(1 for h in window.hist if not np.isfinite(h["loss"]))
    t = out.lap("window", t_open)
    out.unit_s = out.window_s / out.units
    if not trace and any(m["source"] == "device_trace" for m in cell.end_to_end):
        # an end-to-end metric of the card's time: one chunk profiled
        out.trace = profiled(window.chunk)
        out.traced_units = CHUNK
        t = out.lap("profiled", t)
    if trace:
        # the brackets synchronise: one chunk without them times the
        # iteration for the mfu, and one more is profiled
        out.brackets = dict(trainer.brackets,
                            depth_net=list(mono.times) if pseudo else [])
        trainer.bracketing = False
        if pseudo:
            mono.on = False
        t0 = program.sync(dev)
        window.chunk()
        out.unit_s = (program.sync(dev) - t0) / CHUNK
        states = [geometry(trainer.state.gaussians)]
        out.trace = profiled(window.chunk)
        out.traced_units = CHUNK
        # the idle-by-span line on standard error, whichever metrics read it
        spans.stretch(out)
        states.append(geometry(trainer.state.gaussians))
        t = out.lap("profiled", t)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    net_seen = mono.seen if mono is not None else None
    densify_seen = trainer.densify_seen
    del trainer, mono
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        out.work = step_work(states, sc, cfg, pseudo, seed, dev)
        del states
        t = out.lap("work", t)
    ref = follow(sc, cfg, p0, alive0, records, start, weights, dev)
    readings = check.train_readings(prog, ref)
    del ref
    if net_seen is not None:
        readings.update(net_readings(net_seen, cfg, weights, dev))
    if densify_seen is not None:
        readings.update(densify_readings(densify_seen, cfg, sc.extent, dev))
        readings["densify_iteration"] = densify_seen["iteration"]
    readings.update(window.repeats())
    out.lap("reference", t)
    return out, readings, peak, out.units, failed


class Window:
    """The window's chunks of ``CHUNK`` iterations from where ``trainer``
    stands; with ``stop``, a chunk that would pass it first rewinds the
    Trainer to where the window found it. Keeps each chunk's first
    iteration and the log points."""

    def __init__(self, trainer, stop=None):
        self.trainer, self.stop = trainer, stop
        self.chunks, self.hist = [], []
        self.rewind = None
        if stop is not None:
            opened = trainer.state.step
            if stop % CHUNK or stop < opened + CHUNK:
                raise ValueError(f"stop {stop} is no chunk boundary past {opened}")
            self.rewind = program.Rewind(trainer)

    def chunk(self) -> None:
        t = self.trainer
        if self.rewind is not None and t.state.step + CHUNK > self.stop:
            self.rewind.apply(t)
        self.chunks.append(t.state.step + 1)
        self.hist += t.train(iterations=t.state.step + CHUNK, log_every=CHUNK)

    def repeats(self) -> dict:
        """``cycles``: rewinds; ``cycle_log_points``: log points a later
        cycle repeated; ``cycle_differing``: those whose loss, PSNR or
        alive count differ from the first cycle's in any bit."""
        first, seen, differ = {}, 0, 0
        for h in self.hist:
            key = (h["loss"], h["psnr"], h["alive"])
            if h["iter"] in first:
                seen += 1
                differ += key != first[h["iter"]]
            else:
                first[h["iter"]] = key
        cycles = sum(1 for a, b in zip(self.chunks, self.chunks[1:]) if b <= a)
        return {"cycles": cycles, "cycle_log_points": seen, "cycle_differing": differ}
