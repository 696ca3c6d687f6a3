"""The port's optimizer, densification statistics and train state against
sdpgs_tpu: the learning-rate schedule, one Adam step from non-zero moments,
moment-row zeroing, the batched densification statistics, the carry-over
of a JAX TrainState through from_numpy / to_numpy, and the torch.save
checkpoint. Tolerances: 1e-6 relative where float32 formulas are evaluated
in another order (Adam's update, the schedule's log/exp), exact elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.config import OptimizationConfig as JOpt
from sdpgs_tpu.opt import adam as jadam
from sdpgs_tpu.opt import densify as jdensify
from sdpgs_tpu.train.state import TrainState as JState
from sdpgs_torch.config import OptimizationConfig as TOpt
from sdpgs_torch.core.gaussians import BUFFER_FIELDS, PARAM_FIELDS, Gaussians
from sdpgs_torch.opt import adam as tadam
from sdpgs_torch.opt import densify as tdensify
from sdpgs_torch.train.state import (
    STAT_FIELDS,
    TrainState,
    restore_checkpoint,
    save_checkpoint,
)
from test_torch_core import jax_gaussians, random_arrays


@pytest.mark.parametrize("step", [0, 1, 250, 500, 5500, 10000])
def test_learning_rates_match(step):
    ref = jadam.learning_rates(JOpt(), jnp.int32(step), 2.5)
    got = tadam.learning_rates(TOpt(), step, 2.5)
    assert set(got) == set(ref) == set(tadam.TRAINABLE)
    for k in ref:
        assert got[k] == pytest.approx(float(ref[k]), rel=1e-6, abs=0), k
    assert tadam.expon_lr(-1, 0.1, 0.01) == 0.0
    assert tadam.expon_lr(step, 0.0, 0.0) == float(jadam.expon_lr(jnp.int32(step), 0.0, 0.0))
    delayed = jadam.expon_lr(jnp.int32(step), 0.01, 0.001, lr_delay_steps=300,
                             lr_delay_mult=0.1, max_steps=6000)
    assert tadam.expon_lr(step, 0.01, 0.001, lr_delay_steps=300, lr_delay_mult=0.1,
                          max_steps=6000) == pytest.approx(float(delayed), rel=1e-6)


def _moments(rng, arrays):
    return {k: (rng.normal(size=arrays[k].shape) * 1e-3).astype(np.float32)
            for k in tadam.TRAINABLE}


def test_adam_update_matches_from_nonzero_moments(rng):
    arrays = random_arrays(rng, P=64, n=50)
    mu = _moments(rng, arrays)
    nu = {k: np.abs(v) * 1e-3 for k, v in _moments(rng, arrays).items()}
    grads = _moments(rng, arrays)
    lrs_j = jadam.learning_rates(JOpt(), jnp.int32(700), 1.0)
    js = jadam.GaussianAdamState(mu={k: jnp.asarray(v) for k, v in mu.items()},
                                 nu={k: jnp.asarray(v) for k, v in nu.items()},
                                 step=jnp.int32(6))
    gj, sj = jadam.adam_update(jax_gaussians(arrays), {k: jnp.asarray(v) for k, v in
                                                      grads.items()}, js, lrs_j)
    gt = Gaussians.from_numpy(arrays, device="cpu")
    st = tadam.GaussianAdamState(mu={k: torch.tensor(v) for k, v in mu.items()},
                                 nu={k: torch.tensor(v) for k, v in nu.items()}, step=6)
    st = tadam.adam_update(gt, {k: torch.tensor(v) for k, v in grads.items()}, st,
                           tadam.learning_rates(TOpt(), 700, 1.0))
    assert st.step == int(sj.step) == 7
    for k in tadam.TRAINABLE:
        np.testing.assert_allclose(st.mu[k].numpy(), np.asarray(sj.mu[k]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(st.nu[k].numpy(), np.asarray(sj.nu[k]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(getattr(gt, k).detach().numpy(), np.asarray(getattr(gj, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_zero_state_rows_matches(rng):
    arrays = random_arrays(rng, P=64, n=50)
    mu, nu = _moments(rng, arrays), _moments(rng, arrays)
    rows = (rng.random(64) > 0.7)
    js = jadam.zero_state_rows(jadam.GaussianAdamState(
        mu={k: jnp.asarray(v) for k, v in mu.items()},
        nu={k: jnp.asarray(v) for k, v in nu.items()}, step=jnp.int32(3)), jnp.asarray(rows))
    st = tadam.zero_state_rows(tadam.GaussianAdamState(
        mu={k: torch.tensor(v) for k, v in mu.items()},
        nu={k: torch.tensor(v) for k, v in nu.items()}, step=3), torch.from_numpy(rows))
    for k in tadam.TRAINABLE:
        np.testing.assert_array_equal(st.mu[k].numpy(), np.asarray(js.mu[k]))
        np.testing.assert_array_equal(st.nu[k].numpy(), np.asarray(js.nu[k]))
        assert not np.any(st.mu[k].numpy()[rows])


def test_densification_stats_batched_match(rng):
    V, P = 3, 80
    base = [rng.uniform(0, 2, P).astype(np.float32) for _ in range(3)]
    grads = rng.normal(size=(V, P, 2)).astype(np.float32) * 1e-3
    vis = rng.random((V, P)) > 0.3
    radii = rng.integers(0, 20, (V, P)).astype(np.float32)
    ref = jdensify.add_densification_stats_batched(
        jdensify.DensifyStats(*(jnp.asarray(b) for b in base)), jnp.asarray(grads),
        jnp.asarray(vis), jnp.asarray(radii), 72, 56)
    got = tdensify.add_densification_stats_batched(
        tdensify.DensifyStats(*(torch.tensor(b) for b in base)), torch.from_numpy(grads),
        torch.from_numpy(vis), torch.from_numpy(radii), 72, 56)
    one = tdensify.add_densification_stats(
        tdensify.DensifyStats(*(torch.tensor(b) for b in base)), torch.from_numpy(grads[0]),
        torch.from_numpy(vis[0]), torch.from_numpy(radii[0]), 72, 56)
    ref_one = jdensify.add_densification_stats(
        jdensify.DensifyStats(*(jnp.asarray(b) for b in base)), jnp.asarray(grads[0]),
        jnp.asarray(vis[0]), jnp.asarray(radii[0]), 72, 56)
    for k in STAT_FIELDS:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_allclose(getattr(one, k).numpy(), np.asarray(getattr(ref_one, k)),
                                   rtol=1e-6, atol=0, err_msg=k)
    assert tdensify.init_stats(7).denom.shape == (7,)


def jax_state_arrays(js) -> dict:
    """A JAX TrainState's leaves as the numpy dict TrainState.from_numpy takes."""
    g = js.gaussians
    n = np.array
    return dict(
        gaussians={k: n(getattr(g, k)) for k in PARAM_FIELDS + BUFFER_FIELDS},
        mu={k: n(v) for k, v in js.opt_state.mu.items()},
        nu={k: n(v) for k, v in js.opt_state.nu.items()},
        adam_step=int(js.opt_state.step),
        stats={k: n(getattr(js.stats, k)) for k in STAT_FIELDS},
        step=int(js.step), max_overflow=int(js.max_overflow),
        max_clipped=int(js.max_clipped), max_slab=int(js.max_slab))


def _filled_jax_state(rng):
    arrays = random_arrays(rng, P=64, n=50)
    js = JState.create(jax_gaussians(arrays))
    mu, nu = _moments(rng, arrays), _moments(rng, arrays)
    return js.replace(
        opt_state=jadam.GaussianAdamState(mu={k: jnp.asarray(v) for k, v in mu.items()},
                                          nu={k: jnp.asarray(v) for k, v in nu.items()},
                                          step=jnp.int32(9)),
        stats=jdensify.DensifyStats(*(jnp.asarray(rng.uniform(size=64).astype(np.float32))
                                      for _ in STAT_FIELDS)),
        step=jnp.int32(9), max_overflow=jnp.int32(4), max_clipped=jnp.int32(2),
        max_slab=jnp.int32(0))


def _assert_same_arrays(a, b):
    for k in ("gaussians", "mu", "nu", "stats"):
        assert a[k].keys() == b[k].keys(), k
        for f in a[k]:
            np.testing.assert_array_equal(a[k][f], b[k][f], err_msg=f"{k}.{f}")
    for k in ("adam_step", "step", "max_overflow", "max_clipped", "max_slab"):
        assert a[k] == b[k], k


def test_state_from_numpy_round_trip(rng):
    arrays = jax_state_arrays(_filled_jax_state(rng))
    state = TrainState.from_numpy(arrays, device="cpu")
    assert all(p.requires_grad for p in state.gaussians.parameters())
    back = state.to_numpy()
    _assert_same_arrays(back, arrays)
    state.gaussians.xyz.data.add_(1.0)                 # no memory shared with the input
    assert not np.array_equal(state.to_numpy()["gaussians"]["xyz"], arrays["gaussians"]["xyz"])


def test_checkpoint_round_trip(rng, tmp_path):
    state = TrainState.from_numpy(jax_state_arrays(_filled_jax_state(rng)), seed=3,
                                  device="cpu")
    torch.rand(4, generator=state.generator)          # advance it before the save
    path = save_checkpoint(tmp_path, state, 9)
    assert path == tmp_path / "ckpt_9.pt"
    back = restore_checkpoint(tmp_path, 9, state)
    _assert_same_arrays(back.to_numpy(), state.to_numpy())
    assert torch.equal(torch.rand(4, generator=back.generator),
                       torch.rand(4, generator=state.generator))
