"""The port's densify and prune, opacity reset, prune_mask and random_init
(opt/densify.py, core/gaussians.py) against sdpgs_tpu, on the CPU.

One JAX state (random Gaussians with non-zero Adam moments and
densification statistics) is carried across with TrainState.from_numpy;
JAX's densify_and_prune draws its split noise from a key, and the same
jax.random.normal(key, (P, 3)) is handed to the port. Cases: clones only,
splits, proximity bridging (JAX's k-NN as the inputs), capacity exhausted
(dropped > 0) and a prune of low opacities. The alive mask and the
counts (spawned, dropped, pruned, alive) are held exactly, the moments
exactly (rows are zeroed by the same product), every parameter within
1e-6 of its field's largest value (the split offsets go through another
matrix product)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.core import gaussians as jgaussians
from sdpgs_tpu.ops.knn import knn as jknn
from sdpgs_tpu.opt import adam as jadam
from sdpgs_tpu.opt import densify as jdensify
from sdpgs_torch.core import gaussians as tgaussians
from sdpgs_torch.opt import adam as tadam
from sdpgs_torch.opt import densify as tdensify
from sdpgs_torch.train.state import STAT_FIELDS, TrainState
from test_torch_adam import _moments, jax_state_arrays
from test_torch_core import jax_gaussians, random_arrays

P, N_ALIVE = 256, 200
FIELD_TOL = 1e-6
CASES = {
    "clone": dict(threshold=0.009, percent_dense=100.0, extent=1.0),
    "split": dict(threshold=0.009, percent_dense=0.01, extent=1.0),
    "proximity": dict(threshold=0.0095, percent_dense=100.0, extent=0.004, prox=True),
    "capacity": dict(threshold=0.002, percent_dense=0.01, extent=1.0),
    "prune": dict(threshold=0.009, percent_dense=100.0, extent=1.0, low_opacity=30),
}


def jax_state(rng, low_opacity=0):
    arrays = random_arrays(rng, P=P, n=N_ALIVE)
    if low_opacity:
        arrays["opacity"][:low_opacity] = np.log(0.004 / 0.996)
    denom = rng.integers(0, 5, P).astype(np.float32)
    stats = jdensify.DensifyStats(
        xyz_gradient_accum=jnp.asarray(rng.uniform(0, 0.01, P).astype(np.float32) * denom),
        denom=jnp.asarray(denom),
        max_radii2d=jnp.asarray(rng.uniform(0, 20, P).astype(np.float32)))
    mu, nu = _moments(rng, arrays), _moments(rng, arrays)
    opt = jadam.GaussianAdamState(mu={k: jnp.asarray(v) for k, v in mu.items()},
                                  nu={k: jnp.asarray(np.abs(v)) for k, v in nu.items()},
                                  step=jnp.int32(7))
    from sdpgs_tpu.train.state import TrainState as JState

    return JState.create(jax_gaussians(arrays)).replace(opt_state=opt, stats=stats,
                                                       step=jnp.int32(7))


def knn_inputs(xyz, alive):
    """The Trainer's proximity inputs (JAX loop.py:278-285)."""
    d2, idx = jknn(xyz, k=3, mask=alive)
    finite = jnp.isfinite(d2)
    return (jnp.sum(jnp.where(finite, d2, 0), -1) / jnp.maximum(finite.sum(-1), 1)), idx


def rel_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("name", list(CASES))
def test_densify_and_prune_matches_jax(name):
    case = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    js = jax_state(rng, case.get("low_opacity", 0))
    before = jax_state_arrays(js)
    key = jax.random.PRNGKey(3)
    prox = case.get("prox", False)
    kd = ki = None
    if prox:
        kd, ki = knn_inputs(js.gaussians.xyz, js.gaussians.alive)
    kw = dict(grad_threshold=case["threshold"], min_opacity=0.005, extent=case["extent"],
              percent_dense=case["percent_dense"], run_proximity=prox)
    jg, jopt, jstats, jinfo = jdensify.densify_and_prune(
        js.gaussians, js.opt_state, js.stats, key, knn_dist=kd, knn_idx=ki, **kw)
    after = jax_state_arrays(js.replace(gaussians=jg, opt_state=jopt, stats=jstats))

    state = TrainState.from_numpy(before, device="cpu")
    g = state.gaussians
    params = [getattr(g, k) for k in tgaussians.PARAM_FIELDS]
    noise = torch.from_numpy(np.array(jax.random.normal(key, (P, 3))))
    t = (lambda a: None if a is None else torch.from_numpy(np.array(a)))
    g2, opt2, stats2, info = tdensify.densify_and_prune(
        g, state.opt_state, state.stats, noise, knn_dist=t(kd), knn_idx=t(ki), **kw)
    assert g2 is g and opt2 is state.opt_state          # in place
    assert all(a is b for a, b in zip(params, (getattr(g, k) for k in tgaussians.PARAM_FIELDS)))
    got = dict(gaussians=g.to_numpy(), mu=opt2.mu, nu=opt2.nu)

    counts = {k: (int(getattr(info, k)), int(getattr(jinfo, k))) for k in jinfo._fields}
    print(name, counts)
    assert all(a == b for a, b in counts.values()), counts
    assert counts["spawned"][0] > 0
    if name == "capacity":
        assert counts["dropped"][0] > 0
    if name == "prune":
        assert counts["pruned"][0] >= case["low_opacity"]
    np.testing.assert_array_equal(got["gaussians"]["alive"], after["gaussians"]["alive"])
    for k in tgaussians.PARAM_FIELDS + ("confidence",):
        assert rel_err(got["gaussians"][k], after["gaussians"][k]) <= FIELD_TOL, k
    for k in tadam.TRAINABLE:
        np.testing.assert_array_equal(got["mu"][k].numpy(), after["mu"][k], err_msg=k)
        np.testing.assert_array_equal(got["nu"][k].numpy(), after["nu"][k], err_msg=k)
    for k in STAT_FIELDS:
        assert not getattr(stats2, k).any() and not after["stats"][k].any()


def test_proximity_children_take_the_neighbour():
    """The proximity case reaches proximity children (identity rotation,
    zero SH), not only clones."""
    rng = np.random.default_rng(list(CASES).index("proximity"))
    js = jax_state(rng)
    kd, ki = knn_inputs(js.gaussians.xyz, js.gaussians.alive)
    state = TrainState.from_numpy(jax_state_arrays(js), device="cpu")
    alive0 = state.gaussians.alive.clone()
    case = CASES["proximity"]
    tdensify.densify_and_prune(
        state.gaussians, state.opt_state, state.stats, torch.zeros((P, 3)),
        grad_threshold=case["threshold"], min_opacity=0.005, extent=case["extent"],
        percent_dense=case["percent_dense"], run_proximity=True,
        knn_dist=torch.from_numpy(np.array(kd)), knn_idx=torch.from_numpy(np.array(ki)))
    g = state.gaussians
    new = (g.alive > 0) & (alive0 == 0)
    prox_rows = new & (g.features_dc.abs().sum((1, 2)) == 0) & (g.rotation[:, 1:] == 0).all(1)
    assert int(prox_rows.sum()) > 0


def test_reset_opacity_matches_jax():
    rng = np.random.default_rng(5)
    js = jax_state(rng)
    jg, jopt = jdensify.reset_opacity(js.gaussians, js.opt_state)
    ref = jax_state_arrays(js.replace(gaussians=jg, opt_state=jopt))
    state = TrainState.from_numpy(jax_state_arrays(js), device="cpu")
    tdensify.reset_opacity(state.gaussians, state.opt_state)
    got = state.to_numpy()
    np.testing.assert_array_equal(got["gaussians"]["opacity"], ref["gaussians"]["opacity"])
    for k in tadam.TRAINABLE:
        np.testing.assert_array_equal(got["mu"][k], ref["mu"][k], err_msg=k)
        np.testing.assert_array_equal(got["nu"][k], ref["nu"][k], err_msg=k)


def test_prune_mask_matches_jax():
    rng = np.random.default_rng(6)
    arrays = random_arrays(rng, P=64, n=50)
    mask = rng.random(64) < 0.3
    ref = jgaussians.prune_mask(jax_gaussians(arrays), jnp.asarray(mask))
    g = tgaussians.Gaussians.from_numpy(arrays, device="cpu")
    assert tgaussians.prune_mask(g, torch.from_numpy(mask)) is g
    np.testing.assert_array_equal(g.alive.numpy(), np.asarray(ref.alive))


def test_random_init_draws_from_the_generator():
    """random_init: uniform points in the box and colours from one
    torch.Generator (JAX draws from a key, so the draws differ), then
    create_from_points with the k-NN scales."""
    gen = torch.Generator().manual_seed(0)
    g = tgaussians.random_init(gen, 50, 64, extent=1.3, device="cpu")
    assert g.num_alive() == 50
    xyz = g.xyz[:50].detach()
    assert float(xyz.abs().max()) <= 1.3 and float(xyz.std()) > 0.3
    pts = g.xyz[:50].detach().numpy()
    again = tgaussians.random_init(torch.Generator().manual_seed(0), 50, 64, device="cpu")
    np.testing.assert_array_equal(again.xyz.detach().numpy()[:50], pts)
    ref = jgaussians.create_from_points(pts, np.zeros((50, 3), np.float32), 64)
    np.testing.assert_allclose(g.scaling.detach().numpy(), np.asarray(ref.scaling), atol=1e-6)
