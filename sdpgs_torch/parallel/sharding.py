"""Sharding rules for the train state and the view batches.

Counterpart of ``sdpgs_tpu/parallel/sharding.py``:

- the Gaussian parameters are replicated (every rank rasterizes every
  Gaussian), as are the scalars (step, telemetry maxima, the generator);
- the Adam moments and the densification statistics are split along the
  ``gauss`` axis (ZeRO-1): each rank keeps the contiguous slots
  ``[lo, hi)`` of its index on the axis, ``capacity / gauss`` of them;
- a view batch is split along ``data``: each rank takes its contiguous
  ``V / data`` views.

JAX places the leaves with ``NamedSharding``s and GSPMD moves them; here
each rank holds its own rows (``TrainState.slots`` records which), and
:func:`gather_train_state` rebuilds the whole state, for checkpoints and
densification.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

from sdpgs_torch.opt.adam import GaussianAdamState
from sdpgs_torch.opt.densify import DensifyStats
from sdpgs_torch.parallel import comm
from sdpgs_torch.parallel.mesh import Mesh
from sdpgs_torch.train.state import STAT_FIELDS, TrainState
from sdpgs_torch.train.step import ViewBatch

@dataclass(frozen=True)
class StateSharding:
    """Where a sharded state's leaves live on this rank: the mesh and this
    rank's slot range of the split leaves (the moments and statistics)."""

    mesh: Mesh
    capacity: int
    slots: Tuple[int, int]


def state_shardings(mesh: Mesh, state: TrainState) -> StateSharding:
    """The sharding of ``state`` on ``mesh``; raises when the capacity does
    not divide by the ``gauss`` axis."""
    capacity = state.gaussians.capacity
    return StateSharding(mesh=mesh, capacity=capacity,
                         slots=comm.slot_range(capacity, mesh.group("gauss")))


def _rows(t, lo: int, hi: int):
    return t[lo:hi].clone()


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's share of a whole ``state`` (the same on every rank):
    the parameters and scalars as they are, the moments' and statistics'
    slot rows copied out."""
    if state.slots is not None:
        raise ValueError("the state is already sharded")
    lo, hi = state_shardings(mesh, state).slots
    opt = state.opt_state
    return replace(
        state,
        opt_state=GaussianAdamState(mu={k: _rows(v, lo, hi) for k, v in opt.mu.items()},
                                    nu={k: _rows(v, lo, hi) for k, v in opt.nu.items()},
                                    step=opt.step),
        stats=DensifyStats(*(_rows(getattr(state.stats, k), lo, hi) for k in STAT_FIELDS)),
        slots=(lo, hi))


def gather_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The whole state from the ranks' shares (on every rank of the mesh):
    the moments and statistics gathered over ``gauss``."""
    if state.slots is None:
        return state
    group = mesh.group("gauss")
    opt = state.opt_state
    g = lambda t: comm.gather_rows(t, group)  # noqa: E731
    return replace(
        state,
        opt_state=GaussianAdamState(mu={k: g(v) for k, v in opt.mu.items()},
                                    nu={k: g(v) for k, v in opt.nu.items()}, step=opt.step),
        stats=DensifyStats(*(g(getattr(state.stats, k)) for k in STAT_FIELDS)),
        slots=None)


def batch_sharding(mesh: Mesh, batch: ViewBatch) -> slice:
    """The views of ``batch`` this rank takes: its contiguous share along
    ``data``; raises when the view count does not divide by the axis."""
    V, n = len(batch.cameras), mesh.shape["data"]
    if V % n:
        raise ValueError(f"{V} views do not split over data={n}")
    per = V // n
    i = mesh.coords["data"]
    return slice(i * per, (i + 1) * per)


def shard_batch(batch: ViewBatch, mesh: Mesh) -> ViewBatch:
    sl = batch_sharding(mesh, batch)
    return ViewBatch(cameras=batch.cameras[sl], image=batch.image[sl],
                     depth_mono=batch.depth_mono[sl], feature=batch.feature[sl],
                     seg_map=batch.seg_map[sl])
