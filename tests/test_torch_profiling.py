"""The port's spans (utils/profiling.py) and the benchmark's reader of them
(benchmark/spans.py), on the CPU: a span with recording off enters no
``record_function`` and keeps nothing; under ``torch.profiler`` spans nest
with their parents, units and requests and lie on the profiler's clock
beside its host events of the same name; a new stretch clears the last;
``recording()`` records without a profiler; sixteen threads at once keep
every span; a CPU Trainer's iterations,
one of them pseudo with a depth net, give the phases in order; and the
reader puts a synthetic stretch's idle down to its phases exactly. The
``card`` test checks on the H100 that every K1 launch starts inside its
render's span (run there: ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_profiling.py -m card``)."""

import gc
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdpgs_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import spans as bspans  # noqa: E402

CLOCK_US = 50            # a span's ends against its kineto event's, on the same clock
PAGEABLE = "Memcpy DtoH (Device -> Pageable)"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def no_record_function(monkeypatch):
    """Fail any ``record_function`` that a span enters."""
    def refuse(name, *a, **kw):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling._prof, "record_function", refuse)


def host_events(prof) -> dict:
    """name -> [(start_ns, end_ns)] of the profiler's host events, in order."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA":
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def test_off_records_nothing(no_record_function):
    with profiling.recording():
        pass                                    # a stretch with no span
    assert not profiling.is_recording()
    assert profiling.span("a") is profiling.span("b", unit="view", n=3)   # one shared object
    with profiling.span("train.iteration", unit="iteration", request=7):
        with profiling.span("train.step"):
            torch.ones(3) + 1
    assert profiling.spans() == []


def profiled_spans():
    """Two views' spans under the profiler: (spans, the profiler)."""
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert profiling.is_recording()
            # a session's first record_function sets itself up inside its
            # event (0.03-1 ms here): not a clock's offset
            with profiling.span("warm-up"):
                pass
            for _ in range(2):
                with profiling.span("outer", unit="view"):
                    with profiling.span("inner", n=3):
                        torch.ones(64) + 1
                with profiling.span("after"):
                    pass
    finally:
        gc.enable()
    return profiling.spans(), prof


def clock_offsets_us(got, prof) -> list:
    """Each span's start and end less its kineto event's, in µs."""
    events, out = host_events(prof), []
    for name in ("outer", "inner", "after"):
        mine = [s for s in got if s.name == name]
        assert len(events[name]) == len(mine)
        for s, (a, b) in zip(mine, events[name]):
            out += [(s.start_ns - a) * 1e-3, (s.end_ns - b) * 1e-3]
    return out


def test_profiler_spans_nest_on_its_clock():
    got, prof = profiled_spans()
    assert not profiling.is_recording()
    assert got[0].name == "warm-up"
    got = got[1:]
    assert [s.name for s in got] == ["outer", "inner", "after"] * 2
    by_id = {s.id: s for s in got}
    for s in got:
        assert s.end_ns >= s.start_ns and s.thread == got[0].thread
        if s.name == "inner":
            parent = by_id[s.parent]
            assert parent.name == "outer" and s.n == 3 and s.unit is None
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            assert s.request == parent.request
        else:
            assert s.parent is None and s.n == 1
    assert [s.request for s in got if s.name == "outer"] == [0, 1]       # view ordinals
    assert [s.request for s in got if s.name == "after"] == [0, 1]
    assert {s.unit for s in got if s.name == "outer"} == {"view"}
    # the test workers share the machine's cores: a thread put off the core
    # between two clock reads gets two more tries
    for _ in range(2):
        if max(abs(d) for d in clock_offsets_us(got, prof)) <= CLOCK_US:
            break
        got, prof = profiled_spans()
        got = got[1:]
    offsets = clock_offsets_us(got, prof)
    assert max(abs(d) for d in offsets) <= CLOCK_US, offsets


def test_new_stretch_clears_the_last():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("first"):
            pass
    assert [s.name for s in profiling.spans()] == ["first"]
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("second"):
            pass
    assert [s.name for s in profiling.spans()] == ["second"]
    with profiling.recording():
        with profiling.span("third"):
            pass
    assert [(s.name, s.request) for s in profiling.spans()] == [("third", 0)]


def test_recording_without_profiler(no_record_function):
    with profiling.recording():
        assert profiling.is_recording()
        with profiling.span("train.iteration", unit="iteration", request=41):
            with profiling.span("train.prefetch", n=64):
                pass
            with profiling.recording():             # nested: the same stretch
                with profiling.span("train.step"):
                    pass
    assert not profiling.is_recording()
    it, pre, step = profiling.spans()
    assert (it.name, it.unit, it.request, it.parent) == ("train.iteration", "iteration", 41, None)
    assert (pre.name, pre.n, pre.parent, pre.request) == ("train.prefetch", 64, it.id, 41)
    assert (step.name, step.parent, step.request) == ("train.step", it.id, 41)
    assert it.start_ns <= pre.start_ns <= pre.end_ns <= step.start_ns <= step.end_ns <= it.end_ns


def test_threads_record_every_span():
    """Sixteen threads open nested spans at once, switching every
    microsecond: every span is kept once, with its own id, and each inner
    span's parent is its own thread's outer span."""
    threads, rounds = 16, 200
    errors = []

    def work():
        try:
            for _ in range(rounds):
                with profiling.span("outer"):
                    with profiling.span("inner"):
                        pass
        except Exception as e:      # noqa: BLE001  (raised in the test below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    got = profiling.spans()
    assert len(got) == 2 * threads * rounds
    assert [s.id for s in got] == list(range(len(got)))
    by_id = {s.id: s for s in got}
    for s in got:
        if s.name == "inner":
            parent = by_id[s.parent]
            assert parent.name == "outer" and parent.thread == s.thread
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_trainer_phases_under_profiler():
    """Three CPU iterations, the second a pseudo one with a tiny DPT as the
    depth net: each iteration holds its step, the step its forward,
    backward and update in that order; the renders and the depth net's
    forward sit in the forward, the net's backward in the backward."""
    from sdpgs_torch import config as tconfig
    from sdpgs_torch.data.synthetic import SyntheticScene
    from sdpgs_torch.models.depth_estimator import MonoDepth
    from sdpgs_torch.models.dpt import DPT, DPTArch
    from sdpgs_torch.train.loop import REPROJ_PREFETCH, Trainer

    torch.manual_seed(0)
    raster = tconfig.RasterizeConfig(tile=16, max_per_tile=128, max_tiles_per_gaussian=8,
                                     chunk=32)
    cfg = tconfig.TrainConfig(raster=raster)
    for k, v in dict(start_sample_pseudo=1, end_sample_pseudo=3, sample_pseudo_interval=1,
                     test_iterations=(), save_iterations=(), checkpoint_iterations=()).items():
        setattr(cfg.optim, k, v)
    scene = SyntheticScene(n_points=32, capacity=64, raster=raster, device="cpu")
    mono = MonoDepth(DPT(DPTArch.tiny_hybrid()))
    trainer = Trainer(cfg, scene=scene, mono_depth_fn=mono, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train(iterations=3, log_every=3)
    got = profiling.spans()
    by_id = {s.id: s for s in got}
    named = lambda n: [s for s in got if s.name == n]  # noqa: E731

    def inside(child, parent):
        return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns

    iters = named("train.iteration")
    assert [s.request for s in iters] == [1, 2, 3] and {s.unit for s in iters} == {"iteration"}
    steps = named("train.step")
    assert len(steps) == 3
    for it, st in zip(iters, steps):
        assert by_id[st.parent] is it and inside(st, it) and st.request == it.request
        fwd, bwd, upd = (s for s in got if s.parent == st.id)
        assert [fwd.name, bwd.name, upd.name] == ["step.forward", "step.backward", "step.update"]
        for phase in (fwd, bwd, upd):
            assert inside(phase, st) and phase.request == it.request
        assert fwd.end_ns <= bwd.start_ns and bwd.end_ns <= upd.start_ns
    renders = named("render")
    assert len(renders) == 4 and {s.unit for s in renders} == {"view"}     # 3 train + 1 pseudo
    assert all(by_id[r.parent].name == "step.forward" for r in renders)
    (dfwd,), (dbwd,) = named("depth_net.forward"), named("depth_net.backward")
    assert by_id[dfwd.parent].name == "step.forward" and dfwd.request == 2
    assert by_id[dbwd.parent].name == "step.backward" and dbwd.request == 2
    assert inside(dbwd, by_id[dbwd.parent])
    (pre,) = named("train.prefetch")
    assert pre.n == REPROJ_PREFETCH and pre.request == 2 and by_id[pre.parent] is iters[1]
    (log,) = named("train.log")
    assert log.request == 3 and by_id[log.parent] is iters[2]
    assert named("train.densify") == []


def test_reader_puts_idle_down_exactly():
    """A synthetic stretch: each phase's idle, the idle outside every span
    and the copy's span, against the sums worked by hand."""
    base_us = 1_790_000_000_000_000            # the epoch clock's magnitude, in µs
    S = lambda i, name, a, b: SimpleNamespace(  # noqa: E731
        id=i, name=name, start_ns=(base_us + a) * 1000, end_ns=(base_us + b) * 1000)
    records = [S(0, "train.iteration", 0, 100), S(1, "train.step", 10, 90),
               S(2, "step.forward", 10, 40), S(3, "render", 15, 25),
               S(4, "step.backward", 40, 80), S(5, "depth_net.backward", 48, 60),
               S(6, "train.log", 92, 98), S(7, "train.iteration", 110, 120)]
    ops = [(n, float(base_us + a), float(base_us + b)) for n, a, b in
           [("k", 0, 5), ("k", 20, 22), ("k", 30, 35), (PAGEABLE, 45, 55), ("k", 70, 95),
            ("k", 130, 140)]]
    att = bspans.attribute(ops, records)
    assert att.idle_us == {"train.iteration": 17.0, "step.forward": 15.0, "render": 8.0,
                           "step.backward": 15.0, "depth_net.backward": 5.0, "train.log": 3.0}
    assert att.outside_us == 10.0 and att.total_us == 73.0 and att.stretch_us == 120.0
    assert sum(att.idle_us.values()) + att.outside_us == pytest.approx(att.total_us, rel=1e-9)
    assert att.copies == {("depth_net.backward", PAGEABLE): [10.0, 1]}
    run = SimpleNamespace(kind="train", trace=SimpleNamespace(ops=ops), traced_units=2)
    bspans._last[:] = [run.trace, att]
    assert bspans.idle_ms(run, "train", ("render",)) == pytest.approx(0.004)
    assert bspans.idle_ms(run, "train", ("train.iteration", "train.step", "train.log")) \
        == pytest.approx(0.010)
    assert bspans.idle_ms(run, "train", ("viewer.send",)) is None       # no such span
    assert bspans.idle_ms(run, "render", ("render",)) is None           # another cell
    line = bspans.line(att, 2, "iteration")
    assert "total idle 0.036500000" in line and "outside 0.036500000" in line


@pytest.mark.card
def test_k1_starts_inside_its_render_span(cuda_device):
    """On the H100, under the profiler: every K1 launch of a render starts
    after its ``render`` span opened, so the spans' clock and CUPTI's agree."""
    from sdpgs_torch.data.synthetic import SyntheticScene
    from sdpgs_torch.render import render

    scene = SyntheticScene(n_points=256, capacity=512, width=128, height=96,
                           device=cuda_device)
    bg = torch.zeros(3, device=cuda_device)
    cams = [c.camera for c in scene.train_cameras] * 3
    with torch.no_grad():
        render(cams[0], scene.gaussians, scene.gt_raster, bg, 0, device=cuda_device)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for cam in cams:
                render(cam, scene.gaussians, scene.gt_raster, bg, 0, device=cuda_device)
            torch.cuda.synchronize()
    k1 = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                if e.device_type().name == "CUDA" and "preprocess_fwd_kernel" in e.name())
    renders = [s for s in profiling.spans() if s.name == "render"]
    assert len(k1) == len(renders) == len(cams)
    lag_us = np.array([a - s.start_ns for a, s in zip(k1, renders)]) * 1e-3
    print(f"K1 starts {lag_us.min():.1f}-{lag_us.max():.1f} us after its render span opens")
    assert (lag_us > 0).all()
