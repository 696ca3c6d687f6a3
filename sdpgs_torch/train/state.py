"""Train state and checkpoints.

Counterpart of ``sdpgs_tpu/train/state.py``: the Gaussians, the Adam
moments, the densification statistics, the iteration counter, a random
generator, and the running maxima of the capacity telemetry. The JAX
package saves it with orbax; here ``save_checkpoint`` / ``restore_checkpoint``
store the same fields with ``torch.save``. ``from_numpy`` / ``to_numpy``
carry a state across from the JAX package as numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from sdpgs_torch import default_device
from sdpgs_torch.core.gaussians import Gaussians
from sdpgs_torch.opt.adam import TRAINABLE, GaussianAdamState, adam_init
from sdpgs_torch.opt.densify import DensifyStats, init_stats

STAT_FIELDS = ("xyz_gradient_accum", "denom", "max_radii2d")
TELEMETRY = ("max_overflow", "max_clipped")
# The raster work since the host last looked; a checkpoint without them
# loads with zeros.
RASTER_COUNTERS = ("raster_entries", "raster_tile_max")


@dataclass
class TrainState:
    gaussians: Gaussians
    opt_state: GaussianAdamState
    stats: DensifyStats
    step: int                    # iteration counter, on the host
    generator: torch.Generator   # draws densify's split noise
    # Running maxima of the capacity drops since the host last looked
    # (0-d int32 on the device, folded in every step without a sync), so
    # no step's overflow or clipping slips between log points.
    max_overflow: torch.Tensor
    max_clipped: torch.Tensor
    # The (tile, Gaussian) entries the renders listed since the host last
    # looked, summed (0-d int64), and the largest uncapped per-tile total
    # among them (0-d int32): the raster work K3 and K5 did, and what K needs.
    raster_entries: torch.Tensor
    raster_tile_max: torch.Tensor
    # On a mesh, the Gaussian slots [lo, hi) whose moments and statistics
    # this rank holds (parallel/sharding.py); None: all of them.
    slots: Optional[Tuple[int, int]] = None

    @property
    def device(self) -> torch.device:
        return self.gaussians.device

    @classmethod
    def create(cls, gaussians: Gaussians, seed: int = 0, device=None) -> "TrainState":
        """A fresh state on ``device`` (``cuda`` unless the caller asks for
        another), where ``gaussians`` must live; turns its gradients on."""
        dev = default_device(device)
        if gaussians.device.type != dev.type:
            raise ValueError(f"Gaussians live on {gaussians.device}, train device is {dev}")
        gaussians.requires_grad_(True)
        zero = lambda dtype=torch.int32: torch.zeros((), dtype=dtype, device=dev)  # noqa: E731
        return cls(gaussians=gaussians, opt_state=adam_init(gaussians),
                   stats=init_stats(gaussians.capacity, device=dev), step=0,
                   generator=torch.Generator(device=dev).manual_seed(seed),
                   max_overflow=zero(), max_clipped=zero(),
                   raster_entries=zero(torch.int64), raster_tile_max=zero())

    @classmethod
    def from_numpy(cls, arrays: Mapping, max_sh_degree: int = 3, seed: int = 0,
                   device=None) -> "TrainState":
        """Carry a JAX ``TrainState`` across: ``arrays`` holds numpy arrays
        under ``gaussians`` (field -> array), ``mu`` and ``nu`` (field ->
        array), ``stats`` (``xyz_gradient_accum``, ``denom``,
        ``max_radii2d``), and the scalars ``adam_step``, ``step``,
        ``max_overflow``, ``max_clipped``, and optionally
        ``raster_entries``, ``raster_tile_max`` (0 where absent, as in the
        JAX package's state and older checkpoints). A ``max_slab`` (the
        JAX package's state, or a checkpoint that still wrote it) is
        ignored. The JAX random key is not carried: the generator is seeded
        with ``seed``."""
        dev = default_device(device)
        g = Gaussians.from_numpy(arrays["gaussians"], max_sh_degree=max_sh_degree, device=dev)
        state = cls.create(g, seed=seed, device=dev)

        def t(a, dtype=torch.float32):
            return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

        for k in TRAINABLE:
            state.opt_state.mu[k].copy_(t(arrays["mu"][k]))
            state.opt_state.nu[k].copy_(t(arrays["nu"][k]))
        state.opt_state.step = int(arrays["adam_step"])
        state.stats = DensifyStats(*(t(arrays["stats"][k]) for k in STAT_FIELDS))
        state.step = int(arrays["step"])
        for k in TELEMETRY:
            setattr(state, k, t(arrays[k], torch.int32))
        for k in RASTER_COUNTERS:
            getattr(state, k).fill_(int(arrays.get(k, 0)))
        return state

    def to_numpy(self) -> dict:
        """The inverse of :meth:`from_numpy`; a sharded state is gathered
        first (``parallel.sharding.gather_train_state``)."""
        if self.slots is not None:
            raise ValueError("a sharded state: gather it before converting")
        n = lambda v: v.detach().cpu().numpy()  # noqa: E731
        return dict(
            gaussians=self.gaussians.to_numpy(),
            mu={k: n(v) for k, v in self.opt_state.mu.items()},
            nu={k: n(v) for k, v in self.opt_state.nu.items()},
            adam_step=self.opt_state.step,
            stats={k: n(getattr(self.stats, k)) for k in STAT_FIELDS},
            step=self.step,
            **{k: int(getattr(self, k)) for k in TELEMETRY + RASTER_COUNTERS},
        )


def save_checkpoint(path: str | Path, state: TrainState, step: int) -> Path:
    """Write ``state`` to ``<path>/ckpt_<step>.pt``; returns the file."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    out = path / f"ckpt_{step}.pt"
    torch.save(dict(state=state.to_numpy(), max_sh_degree=state.gaussians.max_sh_degree,
                    generator=state.generator.get_state()), out)
    return out


def restore_checkpoint(path: str | Path, step: int, template: TrainState) -> TrainState:
    """Read ``<path>/ckpt_<step>.pt`` onto ``template``'s device."""
    blob = torch.load(Path(path) / f"ckpt_{step}.pt", weights_only=False)
    state = TrainState.from_numpy(blob["state"], max_sh_degree=blob["max_sh_degree"],
                                  device=template.device)
    state.generator.set_state(blob["generator"])
    return state
