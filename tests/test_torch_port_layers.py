"""pcgan_tpu_torch layers == the JAX package's flax modules (CPU).

Each flax module is initialized from a PRNGKey, its kernel converted by
``pcgan_tpu_torch.convert`` and loaded into the port's module; both run on
the same numpy input (NHWC for JAX, NCHW for the port). f32 tolerance 1e-5:
JAX runs its f32 convs at Precision.HIGHEST and the port in full f32, so
only the summation order differs. bf16 instance norm: one bf16 ulp of the
JAX value (magnitudes below 2^-7 count as 2^-7).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.models import layers as jl
from pcgan_tpu_torch import convert
from pcgan_tpu_torch.models import layers as tl


def bf16_ulp(v):
    a = np.maximum(np.abs(np.asarray(v, np.float32)), 2.0 ** -7)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nchw(x_nhwc):
    return torch.from_numpy(np.array(x_nhwc)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


@pytest.mark.parametrize("pad_mode", ["zero", "reflect", "replicate"])
@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (3, 2, 1), (7, 1, 3)])
def test_torch_conv_matches_flax(pad_mode, k, s, p):
    cin, cout = 5, 6
    x = _x((2, 12, 12, cin))
    mod = jl.TorchConv(cout, k, s, p, pad_mode=pad_mode, use_bias=True)
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": jax.random.normal(jax.random.PRNGKey(2), (cout,))}
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    conv = tl.TorchConv(cin, cout, k, s, p, pad_mode, use_bias=True)
    conv.load_state_dict({
        "weight": torch.from_numpy(
            convert.conv_weight_from_flax(params["kernel"])),
        "bias": torch.tensor(np.asarray(params["bias"]))})
    got = _nhwc(conv(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k,s,p,op", [(3, 2, 1, 1), (4, 2, 1, 0)])
def test_torch_conv_transpose_matches_flax(k, s, p, op):
    cin, cout = 6, 4
    x = _x((2, 8, 8, cin), seed=3)
    mod = jl.TorchConvTranspose(cout, k, s, p, op, use_bias=False)
    params = mod.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    deconv = tl.TorchConvTranspose(cin, cout, k, s, p, op, use_bias=False)
    deconv.load_state_dict({"weight": torch.from_numpy(
        convert.deconv_weight_from_flax(params["kernel"]))})
    got = _nhwc(deconv(_nchw(x)))
    assert got.shape == want.shape == (2, (8 - 1) * s - 2 * p + k + op,
                                       (8 - 1) * s - 2 * p + k + op, cout)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_instance_norm_f32_matches_jax():
    x = _x((2, 9, 9, 5), seed=5) * 3 + 1
    want = np.asarray(jl.instance_norm(jnp.asarray(x)))
    got = _nhwc(tl.instance_norm(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_instance_norm_bf16_within_rounding():
    x = _x((2, 16, 16, 8), seed=6) * 3 + 1
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jl.instance_norm(xb)).astype(np.float32)
    xt = _nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    out = tl.instance_norm(xt)
    assert out.dtype == torch.bfloat16
    got = _nhwc(out)
    assert np.all(np.abs(got - want) <= bf16_ulp(want))


def test_norm_kinds():
    x = torch.from_numpy(_x((1, 3, 4, 4), seed=7))
    assert torch.equal(tl.Norm("none")(x), x)
    assert torch.allclose(tl.Norm("instance")(x), tl.instance_norm(x))
    for kind, cls in (("batch", tl.BatchNorm), ("group", tl.GroupNorm)):
        norm = tl.Norm(kind, 3)
        assert isinstance(norm, cls) and norm(x).shape == x.shape
    with pytest.raises(NotImplementedError, match="layer"):
        tl.Norm("layer", 3)


@pytest.mark.parametrize("kind", ["instance", "batch", "group", "none"])
def test_bias_rules_match_jax(kind):
    assert tl.conv_bias_before_norm(kind) == jl.conv_bias_before_norm(kind)
    assert tl.norm_uses_bias(kind) == jl.norm_uses_bias(kind)


SHAPE = (7, 7, 64, 32)   # HWIO


@pytest.mark.parametrize("init_type,gain", [
    ("normal", 0.02), ("xavier", 0.02), ("kaiming", 0.02),
    ("orthogonal", 0.5)])
def test_initializer_matches_jax_distribution(init_type, gain):
    """Same distribution as the JAX initializer (the two RNGs never agree
    bit for bit): std within 3% on 100k draws, orthonormal columns scaled
    by the gain for orthogonal, the +-2 std cut for kaiming."""
    got = tl.make_initializer(init_type, gain)(
        SHAPE, torch.Generator().manual_seed(0)).numpy()
    want = np.asarray(jl.make_initializer(init_type, gain)(
        jax.random.PRNGKey(0), SHAPE, jnp.float32))
    assert got.shape == want.shape == SHAPE and got.dtype == np.float32
    np.testing.assert_allclose(got.std(), want.std(), rtol=3e-2)
    if init_type == "orthogonal":
        m = got.reshape(-1, SHAPE[-1])
        np.testing.assert_allclose(m.T @ m, gain ** 2 * np.eye(SHAPE[-1]),
                                   atol=1e-5)
    if init_type == "kaiming":
        std = math.sqrt(2.0 / (7 * 7 * 64)) / 0.87962566103423978
        assert np.abs(got).max() <= 2 * std + 1e-6


def test_unknown_init_type_raises():
    with pytest.raises(NotImplementedError):
        tl.make_initializer("uniform", 0.02)
