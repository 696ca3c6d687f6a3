"""Multi-card training: a (data, gauss, tile) mesh over torch.distributed.

Counterpart of ``sdpgs_tpu/parallel/`` (the reference trains on one GPU):

- **data**: each rank renders its share of the view batch against the
  replicated Gaussians; the parameter gradients are averaged over the axis.
- **gauss**: ZeRO-1: the Adam moments and the densification statistics are
  split by Gaussian slot; each rank updates its slots, and the parameters'
  rows are gathered over the axis after the update.
- **tile**: tile-partitioned rasterization (``tile_shard.py``): each rank
  bins and composites only its tiles of each view (K2, K3 and K5 take the
  shard's first tile); the image is gathered for the loss, and the payload
  gradient summed over the axis.

JAX leaves the collectives to GSPMD and ``shard_map``; here ``comm.py``
calls them, one process per rank: NCCL with a card per rank, gloo on the
CPU and for several ranks sharing one card (``distributed.py``).
"""

from sdpgs_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from sdpgs_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    gather_train_state,
    shard_batch,
    shard_train_state,
    state_shardings,
)
from sdpgs_torch.parallel.tile_shard import (  # noqa: F401
    rasterize_tile_sharded,
    render_tile_sharded,
)
