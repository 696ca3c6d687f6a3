"""The port's launch-floor probe (ops/launch_floor.py: K8's plain version,
and launch_floor on CPU tensors) against scripts/perf_rank_variants.py's
make_overhead_call in interpret mode, on the CPU, at P = 2048, D = 8:
out = packed + gid + tid[:, 0], held exactly (int32 adds that wrap).
The script is imported by path and not changed."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_torch.ops import launch_floor as tprobe

P, D = 2048, 8
SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "perf_rank_variants.py"


def load_script():
    spec = importlib.util.spec_from_file_location("perf_rank_variants", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,full_range", [(0, False), (1, True)])
def test_matches_overhead_kernel(seed, full_range):
    rng = np.random.default_rng(seed)
    lo, hi = (-(1 << 31), (1 << 31) - 1) if full_range else (0, 1 << 28)
    packed = rng.integers(lo, hi, P, dtype=np.int64).astype(np.int32)
    gid = rng.permutation(P).astype(np.int32)
    tid = rng.integers(-1, 192, (P, D)).astype(np.int32)
    call = load_script().make_overhead_call(P, D, P // 256, 256)
    (ref,) = call(jnp.asarray(packed)[None], jnp.asarray(tid)[None], jnp.asarray(gid)[None])
    args = [torch.from_numpy(a) for a in (packed, gid, tid)]
    for got in (tprobe.launch_floor_plain(*args), tprobe.launch_floor(*args, device="cpu")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref)[0])


def test_launch_floor_refuses_a_device_mismatch():
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="live on"):
        tprobe.launch_floor(t, t, t[:, None], device="meta")
