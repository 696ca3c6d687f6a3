"""Ranks of a gloo process group on the CPU, for the port's parallel tests.

``RankPool(n, tmp_dir)`` spawns n processes that form one gloo group
(rendezvous through a file in ``tmp_dir``, so parallel test workers never
collide, 60 s timeout) and then run the tasks they are sent, by name, from
this module. Each rank imports torch and the port only (never JAX), runs on
one thread, and returns numpy results; ``run`` collects every rank's result
within a deadline and raises, with the rank's traceback, if any failed or
did not answer. One pool serves every case of a test file.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import traceback

import numpy as np

DEADLINE = 120.0     # seconds a task may take on every rank


def _worker(rank: int, n: int, init_file: str, tasks, results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=n,
                                rank=rank, timeout=datetime.timedelta(seconds=60))
    except Exception:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        name, args = task
        try:
            results.put((rank, True, globals()[name](*args)))
        except Exception:  # noqa: BLE001 - reported to the parent, which raises
            results.put((rank, False, traceback.format_exc()))
            break
    dist.destroy_process_group()


class RankPool:
    def __init__(self, n: int, tmp_dir):
        ctx = mp.get_context("spawn")
        self.n = n
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(n)]
        init_file = str(tmp_dir / "rendezvous")
        self.procs = [ctx.Process(target=_worker, args=(r, n, init_file, self.tasks[r],
                                                        self.results), daemon=True)
                      for r in range(n)]
        for p in self.procs:
            p.start()
        self.broken = False

    def run(self, name: str, *args, deadline: float = DEADLINE) -> list:
        """Every rank's result of task ``name``, in rank order."""
        if self.broken:
            raise RuntimeError("an earlier task failed on this pool")
        for q in self.tasks:
            q.put((name, args))
        got = {}
        while len(got) < self.n:
            try:
                rank, ok, value = self.results.get(timeout=deadline)
            except queue.Empty:
                self.broken = True
                raise TimeoutError(f"{name}: ranks {sorted(set(range(self.n)) - set(got))} "
                                   f"did not answer within {deadline} s") from None
            if not ok:
                self.broken = True
                raise RuntimeError(f"{name} failed on rank {rank}:\n{value}")
            got[rank] = value
        return [got[r] for r in range(self.n)]

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()


# ---- tasks (run on every rank) ----------------------------------------------

def _cfg(raster_kw, pseudo=None):
    from sdpgs_torch.config import RasterizeConfig, TrainConfig

    cfg = TrainConfig(raster=RasterizeConfig(**raster_kw))
    for k, v in ({} if pseudo is None else pseudo.get("optim", {})).items():
        setattr(cfg.optim, k, v)
    return cfg


def mesh_shapes(specs):
    import torch.distributed as dist

    from sdpgs_torch.parallel import make_mesh

    out = []
    for spec in specs:
        m = make_mesh(*spec)
        out.append((m.shape, m.coords, {a: (None if g is None else dist.get_world_size(g))
                                        for a, g in m.groups.items()}))
    refused = []
    for spec in ((3, 1, 1), (-1, 3, 1)):
        try:
            make_mesh(*spec)
        except ValueError:
            refused.append(spec)
    return out, refused


def tile_render(arrays, cam_kw, raster_kw, bg, target, axes):
    """The tile-sharded and the whole render of one view, each with the
    gradients of sum((color - target)^2) + 1e-3 sum(depth) with respect to
    every trainable field, and the names of the spans each recorded."""
    import torch

    from sdpgs_torch.core.camera import Camera
    from sdpgs_torch.core.gaussians import Gaussians
    from sdpgs_torch.opt.adam import TRAINABLE
    from sdpgs_torch.parallel import make_mesh
    from sdpgs_torch.render import render
    from sdpgs_torch.utils.profiling import recording, spans

    mesh = make_mesh(*axes)
    g = Gaussians.from_numpy(arrays, device="cpu")
    g.requires_grad_(True)
    cam = Camera.create(**cam_kw, device="cpu")
    cfg = _cfg(raster_kw).raster
    bg = torch.from_numpy(bg)
    n = lambda t: t.detach().numpy()  # noqa: E731
    res = {}
    for name, tile_mesh in (("sharded", mesh), ("whole", None)):
        with recording():
            out = render(cam, g, cfg, bg, 1, device="cpu", tile_mesh=tile_mesh)
        span_names = [s.name for s in spans()]
        loss = ((out.color - torch.from_numpy(target)) ** 2).sum() + out.depth.sum() * 1e-3
        grads = torch.autograd.grad(loss, [getattr(g, k) for k in TRAINABLE])
        res[name] = dict(color=n(out.color), depth=n(out.depth), alpha=n(out.alpha),
                         feature=n(out.feature), radii=n(out.radii),
                         overflow=int(out.overflow), clipped=int(out.clipped),
                         grads={k: n(d) for k, d in zip(TRAINABLE, grads)}, spans=span_names)
    return res


def _batch(data, V):
    import torch

    from sdpgs_torch.core.camera import Camera
    from sdpgs_torch.train.step import ViewBatch

    return ViewBatch(cameras=[Camera.create(T=data["translations"][i], **data["cam"],
                                            device="cpu") for i in range(V)],
                     image=torch.from_numpy(data["image"][:V]),
                     depth_mono=torch.from_numpy(data["mono"][:V]),
                     feature=torch.from_numpy(data["feature"][:V]),
                     seg_map=torch.from_numpy(data["seg"][:V]))


def _metrics(m):
    return {k: float(getattr(m, k)) for k in ("loss", "l1", "psnr")} | {
        k: int(getattr(m, k)) for k in ("overflow", "clipped", "num_alive")}


def sharded_step(state_arrays, data, raster_kw, axes, deg, pseudo=None):
    """One sharded step from ``state_arrays`` on mesh ``axes`` (its train
    views split over data); returns the metrics and the gathered state."""
    from sdpgs_torch.parallel import (
        gather_train_state,
        make_mesh,
        shard_batch,
        shard_train_state,
        state_shardings,
    )
    from sdpgs_torch.train.state import TrainState
    from sdpgs_torch.train.step import make_train_step

    mesh = make_mesh(*axes)
    cfg = _cfg(raster_kw, pseudo)
    state = TrainState.from_numpy(state_arrays, device="cpu")
    shardings = state_shardings(mesh, state)
    state = shard_train_state(state, mesh)
    batch = shard_batch(_batch(data, len(data["translations"])), mesh)
    kw = {}
    if pseudo is not None:
        kw = dict(with_pseudo=True, mono_depth_fn=_stand_in_depth)
    step = make_train_step(cfg, deg, tile_mesh=mesh if axes[2] > 1 else None,
                           out_shardings=shardings, **kw)
    args = (state, batch, data["protos"], data["bg"], 1.0)
    if pseudo is not None:
        args += (_pseudo_inputs(data, pseudo),)
    state, m = step(*args, device="cpu")
    lo, hi = state.slots
    assert state.opt_state.mu["xyz"].shape[0] == hi - lo
    return dict(metrics=_metrics(m), state=gather_train_state(state, mesh).to_numpy(),
                slots=(lo, hi))


def _stand_in_depth(img):
    """A smooth, differentiable stand-in for the depth net."""
    return 1.0 + img.mean(0) * 2.0 + 0.1 * img[0] * img[1]


def _pseudo_inputs(data, pseudo):
    import torch

    from sdpgs_torch.core.camera import Camera
    from sdpgs_torch.train.step import PseudoInputs

    V = len(data["translations"])
    cams = [Camera.create(T=data["translations"][i], **data["cam"], device="cpu")
            for i in range(V)]
    pcam = Camera.create(T=pseudo["T"], **data["cam"], device="cpu")
    return PseudoInputs(camera=pcam, train_depths=torch.from_numpy(data["mono"][:V]),
                        K=torch.from_numpy(pseudo["K"]),
                        R_train=torch.stack([c.view[:3, :3] for c in cams]),
                        t_train=torch.stack([c.view[:3, 3] for c in cams]),
                        R_pseudo=pcam.view[:3, :3], t_pseudo=pcam.view[:3, 3],
                        train_view_idx=pseudo["train_view_idx"])


def single_step(state_arrays, data, raster_kw, deg, pseudo=None):
    """The same step on one card (no mesh), on this rank alone."""
    from sdpgs_torch.train.state import TrainState
    from sdpgs_torch.train.step import make_train_step

    kw = {} if pseudo is None else dict(with_pseudo=True, mono_depth_fn=_stand_in_depth)
    state = TrainState.from_numpy(state_arrays, device="cpu")
    args = (state, _batch(data, len(data["translations"])), data["protos"], data["bg"], 1.0)
    if pseudo is not None:
        args += (_pseudo_inputs(data, pseudo),)
    state, m = make_train_step(_cfg(raster_kw, pseudo), deg, **kw)(*args, device="cpu")
    return dict(metrics=_metrics(m), state=state.to_numpy())


def sharding_rules(state_arrays, data, axes):
    """shard / gather round trips, the slot ranges, the batch split, and
    Adam on slots then the gather against the whole update, bit for bit."""
    import torch

    from sdpgs_torch.opt.adam import TRAINABLE, adam_update
    from sdpgs_torch.parallel import (
        batch_sharding,
        gather_train_state,
        make_mesh,
        shard_batch,
        shard_train_state,
        state_shardings,
    )
    from sdpgs_torch.parallel import comm
    from sdpgs_torch.train.state import TrainState
    from sdpgs_torch.train.step import _gather_param_rows

    mesh = make_mesh(*axes)
    state = TrainState.from_numpy(state_arrays, device="cpu")
    sh = state_shardings(mesh, state)
    assert sh.capacity == state.gaussians.capacity and sh.mesh is mesh
    sharded = shard_train_state(state, mesh)
    whole = gather_train_state(sharded, mesh).to_numpy()
    same = all(np.array_equal(a, b) for part in ("mu", "nu", "stats")
               for a, b in zip(whole[part].values(), state.to_numpy()[part].values()))
    try:
        sharded.to_numpy()
        refused = False
    except ValueError:
        refused = True
    # the ZeRO update: Adam on this rank's slots, then the gather
    rng = np.random.default_rng(5)
    grads = {k: torch.from_numpy(rng.normal(size=tuple(getattr(state.gaussians, k).shape))
                                 .astype(np.float32)) for k in TRAINABLE}
    lrs = dict.fromkeys(TRAINABLE, 1e-3)
    ref = TrainState.from_numpy(state_arrays, device="cpu")
    adam_update(ref.gaussians, grads, ref.opt_state, lrs)
    adam_update(sharded.gaussians, grads, sharded.opt_state, lrs, slots=sharded.slots)
    _gather_param_rows(sharded.gaussians, *sharded.slots, mesh.group("gauss"))
    params_equal = all(torch.equal(getattr(ref.gaussians, k), getattr(sharded.gaussians, k))
                       for k in TRAINABLE)
    lo, hi = sharded.slots
    moments_equal = all(torch.equal(ref.opt_state.mu[k][lo:hi], sharded.opt_state.mu[k])
                        and torch.equal(ref.opt_state.nu[k][lo:hi], sharded.opt_state.nu[k])
                        for k in TRAINABLE)
    try:
        comm.slot_range(state.gaussians.capacity - 1, mesh.group("gauss"))
        odd_refused = mesh.shape["gauss"] == 1
    except ValueError:
        odd_refused = True
    batch = _batch(data, len(data["translations"]))
    sl = batch_sharding(mesh, batch)
    mine = shard_batch(batch, mesh)
    return dict(slots=(lo, hi), round_trip=same, refused=refused, odd_refused=odd_refused,
                params_equal=params_equal,
                moments_equal=moments_equal, views=(sl.start, sl.stop),
                images_equal=bool(torch.equal(mine.image, batch.image[sl])))


def certify(n, workdir):
    from sdpgs_torch.parallel.certify import certify_sharded_training

    return certify_sharded_training(n, workdir=workdir, device="cpu")


def certify_bench_shape(meshes, shape, steps):
    from sdpgs_torch.parallel.certify_bench_shape import certify_bench_shape as run

    return run(meshes=meshes, steps=steps, shape=shape, device="cpu")
