"""Gradients of the port's compositing (autograd through the plain version
of K3, which is the plain version of K5) against sdpgs_tpu: jax.grad of
composite_tiles_xla and of composite_tiles_pallas in interpret mode (its
hand-written reverse sweep, composite_pallas.py:157-243). The JAX
gradients of the gathered [T, K, ...] arrays are scatter-added over the
table into payload rows, as the port's gradient is one [P+1, 13] payload
gradient. The cases include alpha clamped at 0.99, where JAX masks the
alpha-gradient (composite_pallas.py:68,215-216). Tolerance: 1e-4 of each column's largest gradient (transmittance
is formed by another product order in each)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.config import RasterizeConfig as JConfig
from sdpgs_tpu.ops.rasterize import composite_xla as jcomp
from sdpgs_tpu.ops.rasterize.composite_pallas import composite_tiles_pallas
from sdpgs_torch import _kernels
from sdpgs_torch.config import RasterizeConfig as TConfig
from sdpgs_torch.ops.rasterize import composite_cuda
from test_torch_composite import KW, TILE, TX, TY, gathered, make_payload, table_rects
from torch_threads import few_threads  # noqa: F401  (autouse)

TOL = 1e-4
T, NPIX = TX * TY, TILE * TILE


def cotangents(seed=5):
    r = np.random.default_rng(seed)
    return (r.normal(size=(T, NPIX, 7)).astype(np.float32),
            r.normal(size=(T, NPIX)).astype(np.float32))


def jax_payload_grad(fn, cfg, pay, table, counts, gv, gT):
    """jax.grad of sum(values * gv) + sum(final_t * gT) through ``fn`` on the
    gathered arrays, scatter-added into [P+1, 13] payload rows."""
    px, py = jcomp.tile_pixel_coords(TX, TY, TILE)
    kw = {} if fn is jcomp.composite_tiles_xla else dict(counts=jnp.asarray(counts))

    def loss(xy, conic, opa, vals):
        out = fn(xy, conic, opa, vals, px, py, cfg, **kw)
        return jnp.sum(out.values * gv) + jnp.sum(out.final_t * gT)

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in gathered(pay, table)))
    per_slot = np.concatenate([np.asarray(g[0]), np.asarray(g[1]), np.asarray(g[2])[..., None],
                               np.asarray(g[3])], axis=-1)            # [T, K, 13]
    out = np.zeros_like(pay)
    np.add.at(out, table.reshape(-1), per_slot.reshape(-1, 13))
    return out


def port_payload_grad(pay, table, counts, gv, gT):
    p = torch.from_numpy(pay).requires_grad_()
    out = composite_cuda.composite_gather(p, torch.from_numpy(table), torch.from_numpy(counts),
                                          TX, TY, TConfig(**KW), pay.shape[0] - 1,
                                          rects=table_rects(table, pay.shape[0] - 1))
    ((out.values * torch.from_numpy(gv)).sum()
     + (out.final_t * torch.from_numpy(gT)).sum()).backward()
    return p.grad.numpy()


def assert_payload_grads_match(got, ref):
    """Rows 0..P-1 (the sentinel's gradient is dropped by both)."""
    got, ref = got[:-1], ref[:-1]
    scale = np.maximum(np.abs(ref).max(axis=0), 1e-30)
    err = (np.abs(got - ref) / scale).max(axis=0)
    assert np.all(err <= TOL), err


def wall_payload(rng):
    """An opaque near-field wall: every pixel stops early (T < 1e-4)."""
    pay, table, counts = make_payload(rng)
    pay[:-1, 0:2] = [TILE * TX / 2, TILE * TY / 2] + rng.normal(size=(pay.shape[0] - 1, 2)) * 8
    pay[:-1, 2:5] = [0.02, 0.0, 0.02]
    pay[:-1, 5] = 0.98
    return pay, table, counts


def clamped_payload(rng):
    """Near-opaque (opacity in [0.991, 1)), wide Gaussians centred on a pixel
    of a tile that lists them among its first three entries: there alpha is
    op e^0 > 0.99 and clamps at alpha_max, where JAX gives no alpha-gradient
    (composite_pallas.py:68,215-216)."""
    pay, table, counts = make_payload(rng)
    P = pay.shape[0] - 1
    placed = set()
    for t in range(T):
        for r in table[t, :3]:
            if r == P or r in placed:
                continue
            placed.add(r)
            pay[r, 0] = (t % TX) * TILE + rng.integers(TILE)
            pay[r, 1] = (t // TX) * TILE + rng.integers(TILE)
            pay[r, 2:5] = [0.002, 0.0, 0.002]
            pay[r, 5] = rng.uniform(0.991, 0.9999)
    assert np.all(pay[table[:, 0], 5] > JConfig().alpha_max)   # each tile's front entry
    return pay, table, counts


PAYLOADS = {"random": make_payload, "wall": wall_payload, "clamped": clamped_payload}


@pytest.mark.parametrize("case", list(PAYLOADS))
@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_payload_grad_matches_jax(rng, case, ref):
    pay, table, counts = PAYLOADS[case](rng)
    gv, gT = cotangents()
    if ref == "xla":
        want = jax_payload_grad(jcomp.composite_tiles_xla, JConfig(**KW), pay, table, counts,
                                gv, gT)
    else:
        want = jax_payload_grad(composite_tiles_pallas, JConfig(**KW, chunk_pallas=128), pay,
                                table, counts, gv, gT)
    _kernels.reset_counts()
    got = port_payload_grad(pay, table, counts, gv, gT)
    assert _kernels.PLAIN_CALLS["composite"] == 1 and _kernels.LAUNCHES["composite_bwd"] == 0
    assert np.abs(want[:-1]).max() > 0
    assert_payload_grads_match(got, want)


def test_poisoned_conic_gives_finite_grads(rng):
    """Entries whose garbage conic puts power >> 0 (exp overflows) are
    masked; their zero gradient must not become 0 * inf = NaN
    (tests/test_pallas_composite.py:106-122)."""
    pay, table, counts = make_payload(rng)
    poisoned = table[:, -8:].reshape(-1)
    poisoned = poisoned[poisoned < pay.shape[0] - 1]
    pay[poisoned, 2] = -500.0
    pay[poisoned, 4] = -500.0
    pay[poisoned, 3] = 0.0
    gv, gT = cotangents()
    got = port_payload_grad(pay, table, counts, gv, gT)
    assert np.all(np.isfinite(got))
    assert not np.any(got[poisoned])
    want = jax_payload_grad(composite_tiles_pallas, JConfig(**KW, chunk_pallas=128), pay,
                            table, counts, gv, gT)
    assert_payload_grads_match(got, want)


def test_vjp_plain_in_tile_passes(rng):
    """composite_vjp_plain (the plain version of K5) equals autograd of the
    whole grid, also when it differentiates a few tiles at a time."""
    pay, table, counts = make_payload(rng)
    gv, gT = cotangents()
    full = port_payload_grad(pay, table, counts, gv, gT)
    args = (torch.from_numpy(pay), torch.from_numpy(table), torch.from_numpy(counts), TX, TY,
            TConfig(**KW), pay.shape[0] - 1, torch.from_numpy(gv), torch.from_numpy(gT))
    for per_pass in (None, 4):
        _kernels.reset_counts()
        got = composite_cuda.composite_vjp_plain(*args, tiles_per_pass=per_pass).numpy()
        assert _kernels.PLAIN_CALLS["composite_bwd"] == 1
        np.testing.assert_allclose(got, full, rtol=0, atol=1e-6 * np.abs(full).max())
