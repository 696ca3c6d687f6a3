"""What the benchmark hands the program (``sdpgs_torch``) and what it reads
back.

It builds the program's objects from the benchmark's inputs (the scene as
the ``Trainer`` reads a scene, the trainee as ``Gaussians``, the depth net
as ``MonoDepth`` with the benchmark's weights, the ``TrainConfig`` from
the configuration file), and it observes the Trainer from a subclass, the
pattern of ``sdpgs_torch/cli/ablation_run.instrumented``: the first
steps' inputs, losses and moments for the check, and, in a traced run,
synchronised brackets around densify events, pseudo-camera prefetches and
the depth net (and the k-NN inside an event, through the module global
``sdpgs_torch.train.loop.knn``), and the state around one densify event
and one call of the depth net for the check. ``Rewind`` puts a Trainer
back where it was, for a window that cycles inside a schedule range. The
program surface this reads: ``Trainer._step_fn``, ``_maybe_densify``,
``_next_pseudo_reproj``, ``_reproj_queue``, ``_rng``, ``_view_stack``,
``_pseudo_stack``, ``_renders``, ``_steps``, ``cfg.raster``, ``state``
and ``loop.knn``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from benchmark.reference.raster import FIELDS


def sync(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def raster_config(cfg: dict):
    from sdpgs_torch.config import RasterizeConfig

    return RasterizeConfig(**cfg["raster"])


def train_config(cfg: dict):
    """The configuration's schedule as the program's ``TrainConfig``: every
    field the step and the loop read is set from the file."""
    from sdpgs_torch.config import TrainConfig

    tc = TrainConfig()
    tc.raster = raster_config(cfg)
    tc.model.sh_degree = cfg["cloud"]["sh_degree"]
    tc.model.capacity = cfg["cloud"]["capacity"]
    tc.model.white_background = False
    for k, v in cfg["optim"].items():
        if not hasattr(tc.optim, k):
            raise KeyError(f"optim.{k} is no field of the program's OptimizationConfig")
        setattr(tc.optim, k, tuple(v) if isinstance(v, list) else v)
    return tc


def gaussians(fields: dict, sh_degree: int):
    from sdpgs_torch.core.gaussians import Gaussians

    dev = fields["xyz"].device
    return Gaussians(max_sh_degree=sh_degree, **{k: fields[k] for k in FIELDS},
                     alive=fields["alive"],
                     confidence=torch.ones_like(fields["alive"])[:, None].to(dev))


def camera(v):
    from sdpgs_torch.core.camera import Camera

    return Camera.create(R=v.R, T=v.T, fovx=v.fovx, fovy=v.fovy, width=v.width,
                         height=v.height, device="cpu")


class ProgramScene:
    """The attribute surface the Trainer reads of a scene (that of
    ``sdpgs_torch.data.synthetic.SyntheticScene``), over the benchmark's
    scene: host cameras, numpy targets, the trainee on the device."""

    def __init__(self, scene, sh_degree: int):
        from sdpgs_torch.data.camera_utils import LoadedCamera

        self.model_path = ""
        protos = scene.protos.cpu().numpy()
        img, dep = scene.image.cpu().numpy(), scene.depth.cpu().numpy()
        feat, seg = scene.feature.cpu().numpy(), scene.seg_map.cpu().numpy()
        self.train_cameras = [
            LoadedCamera(camera=camera(v), R=v.R, T=v.T, fovx=v.fovx, fovy=v.fovy,
                         image=img[i], depth_mono=dep[i], point_feature=feat[i],
                         seg_map=seg[i], feature_dict=protos, bounds=scene.bounds[i],
                         image_name=f"train{i}")
            for i, v in enumerate(scene.views)]
        self.test_cameras = []
        self.gaussians = gaussians(scene.trainee, sh_degree)
        self.prototypes = protos
        self.cameras_extent = scene.extent
        self._scene = scene
        self.pseudo_poses = (scene.pseudo_poses if scene.pseudo_poses is not None
                             else np.zeros((0, 4, 4)))
        self.made: list = []    # (program camera, pseudo pose index), in the order made

    def pseudo_camera(self, idx):
        v = self._scene.pseudo_view(idx)
        cam = camera(v)
        self.made.append((cam, int(idx)))
        return cam, v.R, v.T

    def view_index(self, cam) -> int:
        return next(i for i, c in enumerate(self.train_cameras) if c.camera is cam)

    def pseudo_index(self, cam) -> int:
        return next(i for c, i in self.made if c is cam)

    def save(self, iteration, g):
        pass


def arch_of(arch: dict, dpt_arch, bit_arch):
    """``dpt_arch`` from a configuration's ``depth_net.arch``, lists as
    tuples, with a ``bit_arch`` stem where the arch has ``bit`` (a hybrid
    net) and none where it has not."""
    def fields(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    arch = dict(arch)
    bit = arch.pop("bit", None)
    return dpt_arch(**fields(arch), bit=None if bit is None else bit_arch(**fields(bit)))


def depth_net(cfg: dict, weights: dict, device):
    """The program's ``MonoDepth`` with the configuration's net and the
    benchmark's weights, in the configuration's type."""
    from sdpgs_torch.models.bit import BitArch
    from sdpgs_torch.models.depth_estimator import MonoDepth
    from sdpgs_torch.models.dpt import DPT, DPTArch

    d = cfg["depth_net"]
    arch = arch_of(d["arch"], DPTArch, BitArch)
    with torch.device("meta"):
        net = DPT(arch, image_size=d["image_size"])
    net = net.to_empty(device=device)
    net.load_state_dict(weights)
    return MonoDepth(net, dtype=getattr(torch, d["dtype"]), resize_method=d["resize"])


def dpt_names_shapes(cfg: dict) -> list:
    """(name, shape) of every parameter of the configuration's depth net,
    from the reference's module on the meta device (the same names)."""
    from benchmark.reference import dpt as ref_dpt

    with torch.device("meta"):
        net = ref_dpt.DPT(ref_dpt_arch(cfg), image_size=cfg["depth_net"]["image_size"])
    return sorted((k, tuple(v.shape)) for k, v in net.state_dict().items())


def ref_dpt_arch(cfg: dict):
    from benchmark.reference import dpt as ref_dpt

    return arch_of(cfg["depth_net"]["arch"], ref_dpt.DPTArch, ref_dpt.BitArch)


class Tapped(torch.autograd.Function):
    """The depth net's forward and input gradient through autograd; with
    ``times``, each bracketed by a synchronise and the milliseconds added
    to it; with ``seen``, one call recorded: its input, output, the
    gradient that reached the output and the input's gradient."""

    @staticmethod
    def forward(ctx, image, net, times, seen):
        dev = image.device
        t0 = sync(dev) if times is not None else 0.0
        with torch.enable_grad():
            x = image.detach().requires_grad_(True)
            out = net(x)
        if times is not None:
            times.append((sync(dev) - t0) * 1e3)
        if seen is not None:
            seen.update(image=x.detach().clone(), out=out.detach().clone())
        ctx.saved = (x, out, times, seen)
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        x, out, times, seen = ctx.saved
        t0 = sync(x.device) if times is not None else 0.0
        (g,) = torch.autograd.grad(out, x, grad)
        if times is not None:
            times[-1] += (sync(x.device) - t0) * 1e3
        if seen is not None:
            seen.update(grad_out=grad.detach().clone(), grad_in=g.detach().clone())
        return g, None, None, None


class DepthNet:
    """A depth net as the step calls it: behind synchronised brackets while
    ``on``, and with its next call recorded in ``seen`` once ``tap`` is
    set; otherwise the net itself."""

    def __init__(self, net, on: bool = False):
        self.net, self.on, self.times = net, on, []
        self.tap, self.seen = False, None

    def __call__(self, image):
        seen = None
        if self.tap:
            self.tap, seen = False, {}
            self.seen = seen
        if self.on or seen is not None:
            return Tapped.apply(image, self.net, self.times if self.on else None, seen)
        return self.net(image)


def densify_state(state, generator: bool = False) -> dict:
    """A copy on the host of what a densify event reads and writes: the
    Gaussians' fields, Adam's moments, the statistics and, with
    ``generator``, the state of the generator that draws the split noise."""
    g = state.gaussians
    host = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
    out = {k: host(getattr(g, k)) for k in FIELDS + ("confidence", "alive")}
    out["mu"] = {k: host(v) for k, v in state.opt_state.mu.items()}
    out["nu"] = {k: host(v) for k, v in state.opt_state.nu.items()}
    out["accum"], out["denom"] = host(state.stats.xyz_gradient_accum), host(state.stats.denom)
    if generator:
        out["generator"] = state.generator.get_state()
    return out


def device_tensors(state) -> dict:
    """Every device tensor of a ``TrainState`` by name: the Gaussians'
    fields, Adam's moments, the densify statistics, the telemetry's running
    maxima and the raster counters."""
    g, opt = state.gaussians, state.opt_state
    out = {f"g.{k}": getattr(g, k) for k in FIELDS + ("confidence", "alive")}
    out.update({f"mu.{k}": v for k, v in opt.mu.items()})
    out.update({f"nu.{k}": v for k, v in opt.nu.items()})
    out.update({f"stats.{k}": getattr(state.stats, k) for k in
                ("xyz_gradient_accum", "denom", "max_radii2d")})
    out.update({k: getattr(state, k) for k in ("max_overflow", "max_clipped",
                                               "raster_entries", "raster_tile_max")})
    return out


class Rewind:
    """A Trainer as it stands, to put it back there: a copy on the device
    of every tensor of its state, the state's step counters and
    generator, and the host state that picks views and pseudo cameras
    (``_rng``, ``_view_stack``, ``_pseudo_stack``, ``_reproj_queue``, whose
    tensors no step writes), the render count and the ladder's rung."""

    def __init__(self, trainer):
        s = trainer.state
        self.tensors = {k: v.detach().clone() for k, v in device_tensors(s).items()}
        self.steps = (s.step, s.opt_state.step)
        self.generator = s.generator.get_state()
        self.rng = trainer._rng.bit_generator.state
        self.stacks = (list(trainer._view_stack), list(trainer._pseudo_stack),
                       list(trainer._reproj_queue))
        self.renders = trainer._renders
        self.raster = trainer.cfg.raster

    @torch.no_grad()
    def apply(self, trainer) -> None:
        s = trainer.state
        for k, v in device_tensors(s).items():
            v.copy_(self.tensors[k])
        s.step, s.opt_state.step = self.steps
        s.generator.set_state(self.generator)
        trainer._rng.bit_generator.state = self.rng
        trainer._view_stack, trainer._pseudo_stack, trainer._reproj_queue = (
            list(x) for x in self.stacks)
        trainer._renders = self.renders
        if trainer.cfg.raster != self.raster:
            trainer.cfg.raster = self.raster
            trainer._steps.clear()


@dataclasses.dataclass
class Recorded:
    view: int
    pseudo: object            # pseudo pose index or None
    loss: torch.Tensor
    l1: torch.Tensor = None   # the train view's L1


def bench_trainer(traced: bool):
    """A Trainer subclass that records its first steps and, when ``traced``,
    brackets its events."""
    from torch.profiler import record_function

    from sdpgs_torch.train import loop
    from sdpgs_torch.train.loop import Trainer

    class BenchTrainer(Trainer):
        def __init__(self, *a, **kw):
            self.record = None          # a list while the checked steps run
            self.mu1 = None             # Adam's first moments after the first step
            self.params1 = None         # the parameters after the first step
            self.bracketing = traced    # synchronised brackets around events
            self.densify_tap = False    # record the next densify event in densify_seen
            self.densify_seen = None    # {"before", "after"}: densify_state around it
            self.brackets = {"densify": [], "knn": [], "prefetch": [], "prefetch_cams": []}
            super().__init__(*a, **kw)

        def _step_fn(self, sh_degree, with_pseudo):
            fn = super()._step_fn(sh_degree, with_pseudo)
            if self.record is None and not traced:
                return fn

            def step(state, batch, prototypes, bg, scale, pseudo=None, device=None):
                with record_function("bench.train_step"):
                    state, m = fn(state, batch, prototypes, bg, scale, pseudo, device=device)
                if self.record is not None:
                    if self.mu1 is None:
                        self.mu1 = {k: v.clone() for k, v in state.opt_state.mu.items()}
                        self.params1 = {k: getattr(state.gaussians, k).detach().clone()
                                        for k in FIELDS}
                    self.record.append(Recorded(
                        view=self.scene.view_index(batch.cameras[0]),
                        pseudo=None if pseudo is None else self.scene.pseudo_index(pseudo.camera),
                        loss=m.loss.detach().clone(), l1=m.l1.detach().clone()))
                return state, m
            return step

        def _maybe_densify(self, iteration):
            # events fall on the schedule's interval: only those iterations
            # are bracketed or recorded, so that the others run unsynchronised
            if iteration % self.cfg.optim.densification_interval:
                return super()._maybe_densify(iteration)
            before = densify_state(self.state, generator=True) if self.densify_tap else None
            if not self.bracketing:
                info = super()._maybe_densify(iteration)
            else:
                with record_function("bench.densify"), self.timed_knn():
                    t0 = sync(self.device)
                    info = super()._maybe_densify(iteration)
                    if info is not None:
                        self.brackets["densify"].append((sync(self.device) - t0) * 1e3)
            if before is not None and info is not None:
                self.densify_tap = False
                self.densify_seen = {"iteration": iteration, "before": before,
                                     "after": densify_state(self.state)}
            return info

        @contextlib.contextmanager
        def timed_knn(self):
            """The event's k-NN behind a synchronised bracket."""
            real = loop.knn

            def knn(*a, **kw):
                with record_function("bench.knn"):
                    t0 = sync(self.device)
                    out = real(*a, **kw)
                    self.brackets["knn"].append((sync(self.device) - t0) * 1e3)
                return out

            loop.knn = knn
            try:
                yield
            finally:
                loop.knn = real

        def _next_pseudo_reproj(self):
            if not self.bracketing or self._reproj_queue:
                return super()._next_pseudo_reproj()
            with record_function("bench.prefetch"):
                t0 = sync(self.device)
                item = super()._next_pseudo_reproj()
                self.brackets["prefetch"].append((sync(self.device) - t0) * 1e3)
                self.brackets["prefetch_cams"].append(len(self._reproj_queue) + 1)
            return item

    return BenchTrainer
