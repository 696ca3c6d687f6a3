"""Multi-process entry wiring: the flags that form the process group.

Counterpart of ``sdpgs_tpu/parallel/distributed.py``: the same flags and
the same ``SDPGS_*`` environment fallbacks, each process one rank. JAX's
``jax.distributed.initialize(coordinator, num_processes, process_id)``
becomes ``torch.distributed.init_process_group(init_method="tcp://host:port",
world_size, rank)``, and ``--dist_coordinator auto`` becomes
``init_method="env://"``, what ``torchrun`` sets (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK). A rank trains on ``cuda:{LOCAL_RANK}``.
"""

from __future__ import annotations

import argparse
import datetime
import os

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=600)


def add_distributed_args(parser: argparse.ArgumentParser) -> None:
    """Attach the multi-process flags to an argparse parser."""
    parser.add_argument(
        "--dist_coordinator", type=str, default="",
        help="rank 0's reachable host:port for multi-process training. Empty = "
             "one process; 'auto' = the torchrun environment (env://)")
    parser.add_argument("--dist_num_processes", type=int, default=None,
                        help="total number of processes (ranks)")
    parser.add_argument("--dist_process_id", type=int, default=None,
                        help="this process's rank in [0, num_processes)")


def default_backend() -> str:
    """NCCL where a card exists (one card per rank), gloo on the CPU. Ranks
    that share one card must ask for gloo: NCCL refuses two ranks on one."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def maybe_initialize_distributed(args=None, backend: str | None = None) -> bool:
    """Call ``torch.distributed.init_process_group`` when the flags (or the
    SDPGS_COORDINATOR / SDPGS_NUM_PROCESSES / SDPGS_PROCESS_ID environment)
    ask for it, with ``backend`` (``default_backend()`` when None); returns
    True when a process group was formed. Run it before the first touch of
    the card. Partial flags raise SystemExit."""
    coord = (getattr(args, "dist_coordinator", "") or
             os.environ.get("SDPGS_COORDINATOR", ""))
    nproc = getattr(args, "dist_num_processes", None)
    if nproc is None and os.environ.get("SDPGS_NUM_PROCESSES"):
        nproc = int(os.environ["SDPGS_NUM_PROCESSES"])
    pid = getattr(args, "dist_process_id", None)
    if pid is None and os.environ.get("SDPGS_PROCESS_ID"):
        pid = int(os.environ["SDPGS_PROCESS_ID"])

    if not coord and nproc is None:
        return False
    backend = backend or default_backend()
    if coord == "auto":
        dist.init_process_group(backend=backend, init_method="env://", timeout=TIMEOUT)
    else:
        if not coord or nproc is None or pid is None:
            raise SystemExit(
                "multi-process: --dist_coordinator, --dist_num_processes and "
                "--dist_process_id must all be given (or --dist_coordinator auto "
                "under torchrun)")
        dist.init_process_group(backend=backend, init_method=f"tcp://{coord}",
                                world_size=int(nproc), rank=int(pid), timeout=TIMEOUT)
    if backend == "nccl":     # a card per rank
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return True
