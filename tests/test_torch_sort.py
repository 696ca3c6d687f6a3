"""The port's stable depth sort (ops/sort.py: K7's plain version, and
sort_by_key on CPU tensors) against sdpgs_tpu's, on the CPU.

Held bit for bit (keys compared as their int32 bits, so -0.0 and +0.0 are
told apart): against the interpret-mode Pallas bitonic kernel
(sort_by_key_pallas) in one case, and against the stable lax.sort in the
cases of tests/test_sort_pallas.py plus one with signed zeros, inf keys
and ties. sort_supported gates as JAX's. K7's order-preserving key bits
(sort_bits): a stable sort by them, and four stable 8-bit passes over them
as K7 makes, equal lax.sort bit for bit on those cases and on one with
negatives, both zeros, both infinities and ties. On denormal keys they give
torch.sort's order (the plain version's), while XLA on the CPU compares
with denormals flushed to zero: there they equal lax.sort once the keys
are flushed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.ops import sort_pallas
from sdpgs_torch.ops import sort as tsort

N = 1 << 14


def inputs(seed, dead_frac, zeros=False):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1, 9, N).astype(np.float32)
    depth[rng.random(N) < dead_frac] = np.inf      # dead-slot sentinels
    depth[rng.random(N) < 0.05] = 2.5              # ties
    if zeros:
        depth[rng.random(N) < 0.05] = 0.0
        depth[rng.random(N) < 0.05] = -0.0
    packed = rng.integers(0, 1 << 30, N).astype(np.int32)
    return depth, packed, np.arange(N, dtype=np.int32)


SPECIALS = [0.0, -0.0, np.inf, -np.inf, 2.5, -2.5, np.finfo(np.float32).max,
            -np.finfo(np.float32).max, np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny]
DENORMALS = [1e-40, -1e-40, 1e-45, -1e-45, 5e-39]


def edge_inputs(seed, denormals=False):
    """Keys across the f32 line: negatives, -0.0 and +0.0, +-inf, the
    extremes, the smallest normals, ties among each, and with ``denormals``
    subnormal keys of both signs."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(-9, 9, N).astype(np.float32)
    specials = np.array(SPECIALS + (DENORMALS if denormals else []), np.float32)
    pick = rng.random(N) < 0.3
    depth[pick] = rng.choice(specials, int(pick.sum()))
    packed = rng.integers(0, 1 << 30, N).astype(np.int32)
    return depth, packed, np.arange(N, dtype=np.int32)


def radix_order(bits):
    """The order K7's four stable passes leave: least significant byte first."""
    order = np.arange(bits.shape[0])
    for shift in (0, 8, 16, 24):
        order = order[np.argsort((bits[order] >> shift) & 0xFF, kind="stable")]
    return order


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same(got, ref):
    for g, r, name in zip(got, ref, ("keys", "val1", "gid")):
        np.testing.assert_array_equal(bits(g), bits(r), err_msg=name)


def port_sorts(depth, packed, gid):
    args = [torch.from_numpy(a) for a in (depth, packed, gid)]
    plain = [t.numpy() for t in tsort.sort_by_key_plain(*args)]
    wrapped = [t.numpy() for t in tsort.sort_by_key(*args, device="cpu")]
    return plain, wrapped


def test_matches_interpret_mode_pallas_kernel():
    depth, packed, gid = inputs(0, 0.3, zeros=True)
    ref = sort_pallas.sort_by_key_pallas(*(jnp.asarray(a) for a in (depth, packed, gid)))
    for got in port_sorts(depth, packed, gid):
        assert_same(got, ref)


@pytest.mark.parametrize("seed,dead_frac,zeros",
                         [(0, 0.3, False), (1, 0.0, False), (2, 0.95, False), (3, 0.4, True)])
def test_matches_stable_lax_sort(seed, dead_frac, zeros):
    depth, packed, gid = inputs(seed, dead_frac, zeros)
    ref = jax.lax.sort(tuple(jnp.asarray(a) for a in (depth, packed, gid)), num_keys=1,
                       is_stable=True)
    for got in port_sorts(depth, packed, gid):
        assert_same(got, ref)
    if zeros:   # both signs of zero kept, in gid order
        keys = got[0]
        zero = keys == 0.0
        assert np.signbit(keys[zero]).any() and not np.signbit(keys[zero]).all()
        assert (np.diff(got[2][zero]) > 0).all()


@pytest.mark.parametrize("n", [1000, 1 << 13, 1 << 14, 3 << 14, 1 << 17, 1 << 19, 1 << 20])
def test_sort_supported_gates_as_jax(n):
    assert tsort.sort_supported(n) == sort_pallas.sort_supported(n)


def test_sort_by_key_refuses_what_the_kernel_does_not_take():
    t = torch.zeros(1 << 13)
    with pytest.raises(ValueError, match="power of two"):
        tsort.sort_by_key(t, t.int(), t.int(), device="cpu")
    t = torch.zeros(N)
    with pytest.raises(ValueError, match="live on"):
        tsort.sort_by_key(t, t.int(), t.int(), device="meta")


@pytest.mark.parametrize("case", ["dead 0.3", "dead 0.0", "dead 0.95", "zeros", "edge"])
def test_sort_bits_order_matches_stable_lax_sort(case):
    depth, packed, gid = {
        "dead 0.3": lambda: inputs(0, 0.3), "dead 0.0": lambda: inputs(1, 0.0),
        "dead 0.95": lambda: inputs(2, 0.95), "zeros": lambda: inputs(3, 0.4, zeros=True),
        "edge": lambda: edge_inputs(5)}[case]()
    ref = jax.lax.sort(tuple(jnp.asarray(a) for a in (depth, packed, gid)), num_keys=1,
                       is_stable=True)
    key_bits = tsort.sort_bits(torch.from_numpy(depth)).numpy()
    assert key_bits.dtype == np.int64 and key_bits.min() >= 0 and key_bits.max() < 1 << 32
    for order in (np.argsort(key_bits, kind="stable"), radix_order(key_bits)):
        assert_same((depth[order], packed[order], gid[order]), ref)
    if case == "edge":   # the case reaches what it is for
        assert np.signbit(depth[depth == 0]).any() and (depth < 0).any()
        assert np.isinf(depth).any() and (depth == -np.inf).any()


def test_sort_bits_order_on_denormal_keys():
    depth, packed, gid = edge_inputs(6, denormals=True)
    sub = (depth != 0) & (np.abs(depth) < np.finfo(np.float32).tiny)
    assert sub.any()
    key_bits = tsort.sort_bits(torch.from_numpy(depth)).numpy()
    plain = [t.numpy() for t in tsort.sort_by_key_plain(
        *(torch.from_numpy(a) for a in (depth, packed, gid)))]
    for order in (np.argsort(key_bits, kind="stable"), radix_order(key_bits)):
        assert_same((depth[order], packed[order], gid[order]), plain)
    ref = jax.lax.sort(tuple(jnp.asarray(a) for a in (depth, packed, gid)), num_keys=1,
                       is_stable=True)
    flushed = np.where(sub, np.copysign(np.float32(0), depth), depth).astype(np.float32)
    order = radix_order(tsort.sort_bits(torch.from_numpy(flushed)).numpy())
    assert_same((depth[order], packed[order], gid[order]), ref)
    assert not np.array_equal(np.asarray(ref[2]), plain[2])   # the two orders do differ
