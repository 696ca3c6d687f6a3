"""The (data, gauss, tile) mesh over ``torch.distributed`` ranks.

Counterpart of ``sdpgs_tpu/parallel/mesh.py``. JAX lays the devices out as
``reshape(data, gauss, tile)``; here each rank is one process, and rank
``(d * gauss + g) * tile + t`` sits at mesh coordinates ``(d, g, t)``, so
``tile`` is innermost as there. Each axis of size above 1 gets one process
group per line of the mesh along it, built with ``dist.new_group`` (every
rank creates every group, in the same order, as ``new_group`` requires),
so the same groups serve gloo on the CPU, gloo ranks sharing one card and
NCCL with one card per rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch.distributed as dist

AXES = ("data", "gauss", "tile")


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the axis sizes, its coordinate on each
    axis, and the process group of its line along each axis (None where
    the axis has size 1 and needs no collective)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]] = field(repr=False)

    def group(self, axis: str):
        return self.groups[axis]


def _coords(rank: int, data: int, gauss: int, tile: int) -> tuple[int, int, int]:
    return rank // (gauss * tile), (rank // tile) % gauss, rank % tile


def make_mesh(data: int = -1, gauss: int = 1, tile: int = 1) -> Mesh:
    """Build a (data, gauss, tile) mesh over the initialized process group.
    ``data=-1`` takes every remaining rank; the product must be the world
    size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group")
    n = dist.get_world_size()
    if data == -1:
        if n % (gauss * tile):
            raise ValueError(f"{n} ranks do not split into gauss={gauss} x tile={tile}")
        data = n // (gauss * tile)
    if data * gauss * tile != n:
        raise ValueError(f"mesh {data}x{gauss}x{tile} != {n} ranks")
    sizes = dict(data=data, gauss=gauss, tile=tile)
    rank = dist.get_rank()
    mine = dict(zip(AXES, _coords(rank, data, gauss, tile)))
    groups: Dict[str, Optional[object]] = {}
    for axis in AXES:
        groups[axis] = None
        if sizes[axis] == 1:
            continue
        lines: Dict[tuple, list] = {}
        for r in range(n):
            c = dict(zip(AXES, _coords(r, data, gauss, tile)))
            key = tuple(c[a] for a in AXES if a != axis)
            lines.setdefault(key, []).append(r)
        for key, ranks in sorted(lines.items()):
            pg = dist.new_group(ranks=ranks)
            if rank in ranks:
                groups[axis] = pg
    return Mesh(shape=sizes, coords=mine, groups=groups)
