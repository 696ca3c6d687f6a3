"""The port's depth net (ops/resize.py, models/{bit,dpt,depth_estimator}.py)
against sdpgs_tpu's, on the CPU, with numpy-seeded weights and images.

Tolerances, float32 on both sides (the same formulas, convolutions and
sums in another order): resize to 1e-6 of the output's range; BiT stage
features and the DPT output to 1e-4 of each output's range; MonoDepth's
depth to 1e-4 of its range (JAX takes its stem-phase path there, the port
resizes and then convolves), its input gradient to 1e-3: the CPU's
float32 convolution backends are less exact in the backward than in the
forward (against a float64 run of the port, JAX's gradient is 3.9e-4 of
the range off on the bilinear case, and the port's 5.6e-5 on the bicubic
one, 1.4e-7 with oneDNN off). bf16 against f32 within 2%
of the output range (tests/test_dpt.py:109-127), or JAX's own bf16 error
where larger; bf16's input gradient no further from f32 than 1.25x JAX's
own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.models import bit as jbit
from sdpgs_tpu.models import depth_estimator as jde
from sdpgs_tpu.models import dpt as jdpt
from sdpgs_tpu.ops import resize as jresize
from sdpgs_torch.models import bit as tbit
from sdpgs_torch.models import depth_estimator as tde
from sdpgs_torch.models import dpt as tdpt
from sdpgs_torch.ops import resize as tresize

TOL = 1e-4
GRAD_TOL = 1e-3
BF16_TOL = 0.02


def range_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(ref.max() - ref.min(), 1e-30)


def norm_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def arches(name):
    return getattr(tdpt.DPTArch, name)(), getattr(jdpt.DPTArch, name)()


def loaded(module, p: dict):
    """``module`` with the numpy state dict ``p`` loaded (strict)."""
    module.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    return module


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("align", [False, True])
def test_resize2d_matches_jax_and_interpolate(rng, method, align):
    x = rng.normal(size=(2, 3, 21, 30)).astype(np.float32)
    got = tresize.resize2d(torch.from_numpy(x), 34, 17, method, align).numpy()
    ref = np.asarray(jresize.resize2d(jnp.asarray(x), 34, 17, method, align))
    np.testing.assert_array_equal(tresize.resize_matrix(30, 17, method, align),
                                  jresize.resize_matrix(30, 17, method, align))
    assert range_err(got, ref) <= 1e-6
    lib = torch.nn.functional.interpolate(torch.from_numpy(x), size=(34, 17), mode=method,
                                          align_corners=align).numpy()
    assert range_err(got, lib) <= 1e-5


def test_bit_backbone_matches_jax(rng):
    tarch, jarch = arches("tiny_hybrid")
    p = tdpt.random_params(tarch, seed=3, image_size=96)
    pre = "dpt.embeddings.backbone.bit"
    p = {k: v for k, v in p.items() if k.startswith(pre + ".")}
    x = rng.normal(size=(1, 3, 45, 62)).astype(np.float32)   # odd sizes: asymmetric SAME
    net = loaded(tbit.BitBackbone(tarch.bit), {k[len(pre) + 1:]: v for k, v in p.items()})
    got = net(torch.from_numpy(x))
    ref = jbit.bit_backbone({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jarch.bit,
                            prefix=pre)
    assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in ref]
    for g, r in zip(got, ref):
        assert range_err(g.detach().numpy(), r) <= TOL


@pytest.mark.parametrize("size", [(96, 96), (96, 128)], ids=["square", "pos_interp"])
@pytest.mark.parametrize("name", ["tiny", "tiny_hybrid"])
def test_dpt_forward_matches_jax(rng, name, size):
    tarch, jarch = arches(name)
    p = tdpt.random_params(tarch, seed=1, image_size=96)
    x = rng.normal(size=(1, 3) + size).astype(np.float32)
    got = loaded(tdpt.DPT(tarch, image_size=96), p)(torch.from_numpy(x)).detach().numpy()
    ref = np.asarray(jdpt.dpt_forward({k: jnp.asarray(v) for k, v in p.items()},
                                      jnp.asarray(x), jarch))
    assert got.shape == ref.shape == (1,) + size
    assert np.ptp(ref) > 0
    assert range_err(got, ref) <= TOL


@pytest.mark.parametrize("name", ["tiny", "tiny_hybrid", "hybrid"])
def test_random_params_and_state_dict_keys_match_jax(name):
    """The same seed gives equal arrays, and the module's state dict has
    exactly those names and shapes (built on the meta device: no memory)."""
    tarch, jarch = arches(name)
    got = tdpt.random_params(tarch, seed=7)
    ref = jdpt.random_params(jarch, seed=7)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    with torch.device("meta"):
        sd = tdpt.DPT(tarch).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: v.shape for k, v in ref.items()}


def _mono_pair(name, resize_method, seed=2):
    tarch, jarch = arches(name)
    raw = tdpt.random_params(tarch, seed=seed)
    mono = tde.mono_depth_from_params(raw, arch=tarch, resize_method=resize_method, device="cpu")
    jmono = jde.mono_depth_from_params({k: jnp.asarray(v) for k, v in raw.items()}, arch=jarch,
                                       resize_method=resize_method)
    return raw, tarch, mono, jmono


def _value_and_vjp(jmono, img, cot):
    out, vjp = jax.vjp(lambda im: jmono.apply(jmono.params, im), img)
    return out, vjp(cot)[0]


@pytest.mark.parametrize("name,resize_method", [("tiny_hybrid", "bicubic"), ("tiny", "bicubic"),
                                                ("tiny_hybrid", "bilinear")])
def test_mono_depth_and_input_gradient_match_jax(rng, name, resize_method):
    _, _, mono, jmono = _mono_pair(name, resize_method)
    img = rng.uniform(size=(3, 40, 54)).astype(np.float32)
    cot = rng.normal(size=(40, 54)).astype(np.float32)
    ref, ref_g = jax.jit(lambda im, c: _value_and_vjp(jmono, im, c))(jnp.asarray(img),
                                                                     jnp.asarray(cot))
    x = torch.from_numpy(img).requires_grad_(True)
    got = mono(x)
    (got_g,) = torch.autograd.grad(got, x, torch.from_numpy(cot))
    assert got.shape == (40, 54) and got.dtype == torch.float32
    assert np.ptp(np.asarray(ref)) > 0 and np.abs(np.asarray(ref_g)).max() > 0
    assert range_err(got.detach().numpy(), ref) <= TOL
    assert range_err(got_g.numpy(), ref_g) <= GRAD_TOL
    assert all(not p.requires_grad for p in mono.parameters())


@pytest.mark.parametrize("name", ["tiny", "tiny_hybrid"])
def test_mono_depth_bf16_close_to_f32(rng, name):
    """bf16 weights and compute against f32, within 2% of the output range,
    or within 1.25x of the JAX package's own bf16 error on the same net and
    image where that is larger (4.1% on tiny_hybrid's random weights).

    The input gradient at a random cotangent, which the pseudo-view loss
    backpropagates: bf16's distance from f32 in the norm is no more than
    1.25x the JAX package's own (port 7.3% and 20.9%, JAX 7.2% and 23.6%
    on tiny and tiny_hybrid), so the port's bf16 backward is as faithful
    as JAX's."""
    raw, tarch, mono, jmono = _mono_pair(name, "bicubic", seed=3)
    mono_bf = tde.mono_depth_from_params(raw, arch=tarch, dtype=torch.bfloat16, device="cpu")
    jmono_bf = jde.mono_depth_from_params({k: jnp.asarray(v) for k, v in raw.items()},
                                          arch=arches(name)[1], dtype=jnp.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in mono_bf.parameters())
    img = rng.uniform(size=(3, 40, 54)).astype(np.float32)
    cot = rng.normal(size=(40, 54)).astype(np.float32)
    outs = {}
    for key, m in (("f32", mono), ("bf16", mono_bf)):
        x = torch.from_numpy(img).requires_grad_(True)
        y = m(x)
        assert y.dtype == torch.float32
        (g,) = torch.autograd.grad(y, x, torch.from_numpy(cot))
        outs[key] = (y.detach().numpy(), g.numpy())
    (f32, g32), (bf, gbf) = outs["f32"], outs["bf16"]
    (j32, jg32), (jbf, jgbf) = (
        jax.jit(lambda im, c, jm=jm: _value_and_vjp(jm, im, c))(jnp.asarray(img), jnp.asarray(cot))
        for jm in (jmono, jmono_bf))
    j_err = range_err(jbf, j32)
    err = range_err(bf, f32)
    g_err, j_g_err = norm_err(gbf, g32), norm_err(jgbf, jg32)
    print(f"{name}: bf16 vs f32 {err:.4f} of the range (JAX's own {j_err:.4f}); input "
          f"gradient {g_err:.4f} in the norm (JAX's own {j_g_err:.4f})")
    assert err <= max(BF16_TOL, 1.25 * j_err)
    assert g_err <= 1.25 * j_g_err


def test_dpt_depth_model_matches_jax(rng):
    """The reference's estimate_depth interface (bilinear in and out): JAX's
    DPTDepthModel against the port's MonoDepth with bilinear resizes."""
    tarch, jarch = arches("tiny")
    p = tdpt.random_params(tarch, seed=5)
    img = rng.uniform(size=(3, 40, 54)).astype(np.float32)
    mono = tde.mono_depth_from_params(p, arch=tarch, resize_method="bilinear", device="cpu")
    got = mono(torch.from_numpy(img)).detach().numpy()
    jmodel = jdpt.DPTDepthModel(p, jarch)
    ref = np.asarray(jax.jit(lambda im: jmodel(im))(jnp.asarray(img)))
    assert got.shape == (40, 54) and np.ptp(ref) > 0
    assert range_err(got, ref) <= TOL


def test_make_mono_depth_fn_reads_the_jax_file(tmp_path):
    """A file written by the JAX package's ``save_params`` loads into the
    port (architecture from ``__arch__``); no file gives None."""
    assert tde.make_mono_depth_fn(str(tmp_path / "missing.npz"), device="cpu") is None
    assert tde.make_mono_depth_fn("", device="cpu") is None
    jarch = jdpt.DPTArch.tiny_hybrid()
    raw = jdpt.random_params(jarch, seed=4)
    jdpt.save_params(tmp_path / "dpt.npz", raw, jarch)
    mono = tde.make_mono_depth_fn(str(tmp_path / "dpt.npz"), device="cpu")
    assert mono.arch == tdpt.DPTArch.tiny_hybrid()
    sd = mono.net.state_dict()
    assert set(sd) == set(raw)
    for k in raw:
        np.testing.assert_array_equal(sd[k].numpy(), raw[k])


def test_dpt_hybrid_matches_transformers(rng):
    """Optional second golden: the torch reference implementation's state
    dict loads into the port's module, which then meets tests/test_dpt.py's
    own tolerance against it (atol 5e-4, rtol 5e-3: looser than the output,
    which spans 6.3e-5 here; the JAX package differs from it by 5.5% of
    that range, and the port follows the JAX package)."""
    transformers = pytest.importorskip("transformers")
    bit_cfg = transformers.BitConfig(
        embedding_size=16, hidden_sizes=[16, 32, 32], depths=[1, 1, 1], layer_type="bottleneck",
        stem_type="same", out_features=["stage1", "stage2", "stage3"], num_groups=8,
        embedding_dynamic_padding=True, global_padding="SAME")
    cfg = transformers.DPTConfig(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=2, intermediate_size=64,
        image_size=96, patch_size=16, fusion_hidden_size=16, neck_hidden_sizes=[16, 32, 32, 32],
        backbone_out_indices=[0, 1, 2, 3], is_hybrid=True, reassemble_factors=[1, 1, 1, 0.5],
        backbone_config=bit_cfg, backbone_featmap_shape=[1, 32, 6, 6], neck_ignore_stages=[0, 1])
    torch.manual_seed(0)
    ref_model = transformers.DPTForDepthEstimation(cfg).eval()
    net = tdpt.DPT(tdpt.DPTArch.tiny_hybrid(), image_size=96)
    names = set(net.state_dict())
    net.load_state_dict({k: v for k, v in ref_model.state_dict().items() if k in names})
    x = torch.from_numpy(rng.normal(size=(1, 3, 96, 96)).astype(np.float32))
    with torch.no_grad():
        ref = ref_model(x).predicted_depth.numpy()
        got = net(x).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=5e-3)
