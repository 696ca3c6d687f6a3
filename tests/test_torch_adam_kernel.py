"""The fused Adam kernel (``csrc/adam.cu``) and what surrounds it.

On the CPU: the launcher's descriptors of the gradients as the train step
hands them over (the features' as narrow views of one [P, 16, 3]
gradient, xyz's as the transpose of a [3, P] one) and of ZeRO slot
ranges, read back through their strides; the step's float32 constants;
the plain version taken for CPU tensors, counted and held to sdpgs_tpu.

On the card (``card``; run there with ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_adam_kernel.py -m card``, the machine
has no JAX): the kernel bit-equal to the op chain run on the card, whole
and on a slot range, in one device operation with no gradient copy.
"""

import numpy as np
import pytest
import torch

try:    # absent beside the card: only the card tests run there
    import jax.numpy as jnp

    from sdpgs_tpu.config import OptimizationConfig as JOpt
    from sdpgs_tpu.opt import adam as jadam
except ImportError:
    jnp = None
from sdpgs_torch import _kernels
from sdpgs_torch.config import OptimizationConfig as TOpt
from sdpgs_torch.core.gaussians import Gaussians
from sdpgs_torch.opt import adam as tadam

SHAPES = dict(xyz=(3,), features_dc=(1, 3), features_rest=(15, 3), scaling=(3,),
              rotation=(4,), opacity=(1,), language_feature=(3,))


def fields(rng, P: int) -> dict:
    """Parameters of every trainable field, keyed as the Gaussians', plus
    the buffers ``Gaussians`` takes."""
    out = {k: rng.normal(size=(P,) + s).astype(np.float32) for k, s in SHAPES.items()}
    out["alive"] = np.ones(P, np.float32)
    out["confidence"] = np.ones((P, 1), np.float32)
    return out


def step_grads(rng, P: int, device) -> dict:
    """Gradients laid out as autograd hands them to the update: the
    features' narrow views of one [P, 16, 3] gradient, xyz's and
    scaling's transposes of [3, P] rows, the rest dense; a few zeros and
    values far from 1."""
    t = lambda a: torch.tensor(a.astype(np.float32), device=device)  # noqa: E731
    feats = t(rng.normal(size=(P, 16, 3)) * 1e-3)
    grads = dict(xyz=t(rng.normal(size=(3, P)) * 1e-4).T,
                 features_dc=feats[:, :1], features_rest=feats[:, 1:],
                 scaling=t(rng.normal(size=(3, P)) * 1e-2).T,
                 rotation=t(rng.normal(size=(P, 4)) * 1e-3),
                 opacity=t(rng.normal(size=(P, 1)) * 10.0),
                 language_feature=t(rng.normal(size=(P, 3)) * 1e-6))
    grads["opacity"][::7] = 0.0
    return grads


def moments(rng, P: int, device) -> tuple:
    mu = {k: torch.tensor((rng.normal(size=(P,) + s) * 1e-3).astype(np.float32), device=device)
          for k, s in SHAPES.items()}
    nu = {k: torch.tensor((np.abs(rng.normal(size=(P,) + s)) * 1e-6).astype(np.float32),
                          device=device) for k, s in SHAPES.items()}
    return mu, nu


def through_descriptor(grad: torch.Tensor, d: tadam.AdamGroupC) -> torch.Tensor:
    """The [rows, width] floats the kernel reads for group ``d`` of
    ``grad``'s storage."""
    view = grad.as_strided((d.rows, d.width // d.inner, d.inner), (d.g_row, d.g_mid, d.g_col),
                           grad.storage_offset() + (d.g - grad.data_ptr()) // 4)
    return view.reshape(d.rows, d.width)


# ---- on the CPU ----------------------------------------------------------


@pytest.mark.parametrize("slots", [None, (37, 181)])
def test_descriptors_of_the_step_gradients(slots):
    rng = np.random.default_rng(1)
    P = 256
    params = {k: torch.tensor(v) for k, v in fields(rng, P).items() if k in SHAPES}
    grads = step_grads(rng, P, "cpu")
    lo, hi = (0, P) if slots is None else slots
    mu, nu = moments(rng, hi - lo, "cpu")
    lrs = tadam.learning_rates(TOpt(), 5600, 4.7)
    table = tadam.adam_groups(params, grads, mu, nu, lrs, slots)
    assert len(table) == len(tadam.TRAINABLE)
    want = dict(xyz=(3, 3, 1, 0, P), features_dc=(3, 3, 48, 0, 1),
                features_rest=(45, 45, 48, 0, 1), scaling=(3, 3, 1, 0, P),
                rotation=(4, 4, 4, 0, 1), opacity=(1, 1, 1, 0, 1),
                language_feature=(3, 3, 3, 0, 1))
    for k, d in zip(tadam.TRAINABLE, table):
        width, inner, g_row, g_mid, g_col = want[k]
        assert (d.rows, d.width, d.inner, d.g_row, d.g_mid, d.g_col) == (
            hi - lo, width, inner, g_row, g_mid, g_col), k
        # the parameter and gradient start at row lo, the moments at their own row 0
        assert d.p - params[k].data_ptr() == 4 * lo * width, k
        assert d.g - grads[k].data_ptr() == 4 * lo * g_row, k
        assert (d.m, d.v) == (mu[k].data_ptr(), nu[k].data_ptr()), k
        assert d.lr == np.float32(lrs[k])
        np.testing.assert_array_equal(through_descriptor(grads[k], d).numpy(),
                                      grads[k][lo:hi].reshape(hi - lo, -1).numpy(), err_msg=k)
    # the features' two views share one gradient: the rest's starts 3 floats in
    assert grads["features_rest"].data_ptr() - grads["features_dc"].data_ptr() == 12


def test_descriptor_of_a_gradient_whose_row_does_not_collapse():
    rng = np.random.default_rng(2)
    P, lo, hi = 64, 5, 50
    params = {k: torch.tensor(v) for k, v in fields(rng, P).items() if k in SHAPES}
    grads = step_grads(rng, P, "cpu")
    grads["features_rest"] = torch.tensor(rng.normal(size=(P, 3, 15)).astype(np.float32)
                                          ).transpose(1, 2)
    mu, nu = moments(rng, hi - lo, "cpu")
    d = tadam.adam_groups(params, grads, mu, nu, tadam.learning_rates(TOpt(), 1, 1.0),
                          (lo, hi))[tadam.TRAINABLE.index("features_rest")]
    assert (d.width, d.inner, d.g_row, d.g_mid, d.g_col) == (45, 3, 45, 1, 15)
    assert d.g - grads["features_rest"].data_ptr() == 4 * lo * 45
    np.testing.assert_array_equal(through_descriptor(grads["features_rest"], d).numpy(),
                                  grads["features_rest"][lo:hi].reshape(hi - lo, 45).numpy())


@pytest.mark.parametrize("fault", ["moment_rows", "strided_param", "f64_grad", "slots"])
def test_descriptors_refuse_what_the_kernel_cannot_take(fault):
    rng = np.random.default_rng(3)
    P = 32
    params = {k: torch.tensor(v) for k, v in fields(rng, P).items() if k in SHAPES}
    grads = step_grads(rng, P, "cpu")
    mu, nu = moments(rng, P, "cpu")
    slots = None
    if fault == "moment_rows":
        mu["rotation"] = mu["rotation"][1:]
    elif fault == "strided_param":
        params["scaling"] = torch.zeros(3, P).T
    elif fault == "f64_grad":
        grads["opacity"] = grads["opacity"].double()
    else:
        slots = (4, P + 1)
    with pytest.raises(ValueError):
        tadam.adam_groups(params, grads, mu, nu, tadam.learning_rates(TOpt(), 1, 1.0), slots)


@pytest.mark.parametrize("step", [1, 2, 7, 700, 5600, 10000])
def test_scalars_are_the_chains_float32_constants(step):
    f32 = np.float32
    b1, omb1, b2, omb2, ibc1, ibc2, eps = tadam.adam_scalars(step)
    assert all(type(x) is np.float32 for x in (b1, omb1, b2, omb2, ibc1, ibc2, eps))
    # a Python scalar reaches the card's kernels as its double cast to float
    cast = lambda x: f32(torch.tensor(x, dtype=torch.float64).float().item())  # noqa: E731
    assert (b1, omb1, b2, omb2, eps) == (cast(0.9), cast(1 - 0.9), cast(0.999), cast(1 - 0.999),
                                         cast(1e-15))
    assert omb1 == f32(0.1) and omb2 == f32(0.001)
    bc1 = f32(1) - f32(0.9) ** f32(step)
    bc2 = f32(1) - f32(0.999) ** f32(step)
    assert (ibc1, ibc2) == (f32(1) / bc1, f32(1) / bc2)
    assert tadam.bias_corrections(step, 0.9, 0.999) == (float(bc1), float(bc2))


def _cpu_update(rng, P, slots):
    arrays = fields(rng, P)
    grads = step_grads(rng, P, "cpu")
    lo, hi = (0, P) if slots is None else slots
    mu, nu = moments(rng, hi - lo, "cpu")
    return arrays, grads, mu, nu


@pytest.mark.parametrize("slots", [None, (10, 70)])
def test_cpu_update_is_the_plain_version_and_matches_jax(slots):
    if jnp is None:
        pytest.fail("the CPU tests need the JAX package")
    rng = np.random.default_rng(4)
    P = 96
    arrays, grads, mu, nu = _cpu_update(rng, P, slots)
    lo, hi = (0, P) if slots is None else slots
    lrs_j = jadam.learning_rates(JOpt(), jnp.int32(700), 1.0)
    whole = {k: np.zeros((P,) + s, np.float32) for k, s in SHAPES.items()}
    js = jadam.GaussianAdamState(
        mu={k: jnp.asarray(whole[k]).at[lo:hi].set(mu[k].numpy()) for k in SHAPES},
        nu={k: jnp.asarray(whole[k]).at[lo:hi].set(nu[k].numpy()) for k in SHAPES},
        step=jnp.int32(6))
    jparams = {k: jnp.asarray(arrays[k]) for k in SHAPES}
    # the JAX package updates every row: its rows lo:hi are the slot range's
    jnew, jstate = _jax_update(jparams, {k: jnp.asarray(grads[k].numpy()) for k in SHAPES},
                               js, lrs_j)
    gt = Gaussians.from_numpy(arrays, device="cpu")
    _kernels.reset_counts()
    st = tadam.adam_update(gt, grads, tadam.GaussianAdamState(mu=mu, nu=nu, step=6),
                           tadam.learning_rates(TOpt(), 700, 1.0), slots=slots)
    assert _kernels.PLAIN_CALLS["adam"] == 1 and _kernels.LAUNCHES["adam"] == 0
    assert st.step == int(jstate.step) == 7
    for k in tadam.TRAINABLE:
        np.testing.assert_allclose(st.mu[k].numpy(), np.asarray(jstate.mu[k])[lo:hi],
                                   rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_allclose(st.nu[k].numpy(), np.asarray(jstate.nu[k])[lo:hi],
                                   rtol=1e-6, atol=0, err_msg=k)
        got = getattr(gt, k).detach().numpy()
        np.testing.assert_allclose(got[lo:hi], np.asarray(jnew[k])[lo:hi], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(np.delete(got, np.s_[lo:hi], 0),
                                      np.delete(arrays[k], np.s_[lo:hi], 0), err_msg=k)


def _jax_update(params, grads, state, lrs):
    """sdpgs_tpu's adam_update on a Gaussians built from ``params``."""
    from sdpgs_tpu.core import gaussians as jgaussians

    P = params["xyz"].shape[0]
    g = jgaussians.Gaussians(**params, alive=jnp.ones(P), confidence=jnp.ones((P, 1)),
                             max_sh_degree=3)
    gj, sj = jadam.adam_update(g, grads, state, lrs)
    return {k: getattr(gj, k) for k in SHAPES}, sj


# ---- on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def _card_case(dev, P: int, slots, seed: int):
    rng = np.random.default_rng(seed)
    arrays = fields(rng, P)
    grads = step_grads(rng, P, dev)
    lo, hi = (0, P) if slots is None else slots
    mu, nu = moments(rng, hi - lo, dev)
    return arrays, grads, mu, nu


@pytest.mark.card
@pytest.mark.parametrize("slots", [None, (12_345, 40_001)])
def test_kernel_is_bit_equal_to_the_op_chain_on_the_card(cuda_device, slots):
    P = 1 << 16
    arrays, grads, mu, nu = _card_case(cuda_device, P, slots, seed=5)
    lo, hi = (0, P) if slots is None else slots
    lrs = tadam.learning_rates(TOpt(), 5600, 4.7)
    g = Gaussians.from_numpy(arrays, device=cuda_device)
    ref = {k: getattr(g, k).detach().clone() for k in tadam.TRAINABLE}
    mu_ref = {k: v.clone() for k, v in mu.items()}
    nu_ref = {k: v.clone() for k, v in nu.items()}
    kept = {k: v.clone() for k, v in grads.items()}
    _kernels.reset_counts()
    st = tadam.adam_update(g, grads, tadam.GaussianAdamState(mu=mu, nu=nu, step=5599), lrs,
                           slots=slots)
    tadam.adam_update_plain({k: v[lo:hi] for k, v in ref.items()},
                            {k: v[lo:hi] for k, v in kept.items()}, mu_ref, nu_ref, lrs, 5600)
    torch.cuda.synchronize()
    assert st.step == 5600 and _kernels.LAUNCHES["adam"] == 1
    for k in tadam.TRAINABLE:
        assert torch.equal(getattr(g, k).detach(), ref[k]), k
        assert torch.equal(st.mu[k], mu_ref[k]) and torch.equal(st.nu[k], nu_ref[k]), k
        assert torch.equal(grads[k], kept[k]), k
        if slots is not None:
            assert torch.equal(getattr(g, k).detach()[:lo].cpu(),
                               torch.from_numpy(arrays[k][:lo])), k
    assert any(not torch.equal(getattr(g, k).detach().cpu(), torch.from_numpy(arrays[k]))
               for k in tadam.TRAINABLE)


@pytest.mark.card
def test_one_update_is_one_device_operation(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    P = 1 << 16
    arrays, grads, mu, nu = _card_case(cuda_device, P, None, seed=6)
    g = Gaussians.from_numpy(arrays, device=cuda_device)
    state = tadam.GaussianAdamState(mu=mu, nu=nu, step=3)
    lrs = tadam.learning_rates(TOpt(), 3, 1.0)
    tadam.adam_update(g, grads, state, lrs)        # the library's build and load
    torch.cuda.synchronize()
    before = _kernels.LAUNCHES["adam"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tadam.adam_update(g, grads, state, lrs)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = {e.name() for e in events if e.device_type().name != "CUDA"}
    device_ops = [e.name() for e in events
                  if e.device_type().name == "CUDA" and e.name() not in host]
    assert _kernels.LAUNCHES["adam"] == before + 1
    assert len(device_ops) == 1 and "fused_adam_kernel" in device_ops[0], device_ops
