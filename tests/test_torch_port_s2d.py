"""The port's space-to-depth family, ``reflect_conv``, ``TorchConv``'s
bf16 routes and ``ResizeConv`` against the JAX package (CPU).

- ``_s2d_embed`` (bit-equal), ``s2d_conv``, ``s2d_reflect_conv`` with its
  gradients and ``reflect_conv`` against ``pcgan_tpu/ops/lowch_conv.py``
  and ``models/layers.py`` in f32, within 1e-5 of max(1, max|x|) (sums of
  up to 7*7*C products in another order).
- ``TorchConv``'s separated-condition stem and s2d tail in bf16 against the
  JAX ``TorchConv`` with ``lowch_matmul`` on the same weights, within the
  bf16 limits of ``test_torch_port_generator.py`` (max 5e-2, mean 5e-3).
- ``ResizeConv`` in f32 (1e-5) and bf16 (the bf16 limits).
- The bf16 resnet G with ``--lowch_matmul`` (the JAX default) takes the
  separated-condition stem and the s2d tail (a counter shows it) and stays
  within the bf16 limits of the JAX G's output.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.config import parse_config as jax_parse
from pcgan_tpu.models import layers as jlayers
from pcgan_tpu.models.registry import define_G as jax_define_G
from pcgan_tpu.models.registry import init_params
from pcgan_tpu.ops import lowch_conv as jlc
from pcgan_tpu_torch import convert
from pcgan_tpu_torch.config import parse_config as port_parse
from pcgan_tpu_torch.models import define_G as port_define_G
from pcgan_tpu_torch.models import layers as tlayers
from pcgan_tpu_torch.ops import lowch_conv as tlc

from torch_port_levers import one_torch_thread  # noqa: F401

HI = jax.lax.Precision.HIGHEST


def _close(got, want, tol):
    """Every entry within ``tol * max(1, max|want|)``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# --------------------------------------------------------------------------- #
# the s2d family and reflect_conv, f32
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("k,r,cin,cout", [(7, 4, 3, 3), (7, 2, 5, 2),
                                          (3, 4, 4, 8)])
def test_s2d_embed_matches_jax(k, r, cin, cout):
    w = _rand(k, k, cin, cout, seed=k + r)
    want = np.asarray(jlc._s2d_embed(jnp.asarray(w), r, jnp.float32))
    got = tlc._s2d_embed(torch.from_numpy(w), r, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,k,cout", [((2, 22, 26, 6), 7, 3),
                                          ((1, 18, 14, 4), 3, 8)])
def test_s2d_conv_matches_jax(shape, k, cout):
    x = _rand(*shape, seed=1)
    w = _rand(k, k, shape[-1], cout, seed=2, scale=0.1)
    want = np.asarray(jlc.s2d_conv(jnp.asarray(x), jnp.asarray(w), 4, HI))
    got = tlc.s2d_conv(torch.from_numpy(x), torch.from_numpy(w), 4)
    _close(got.numpy(), want, 1e-5)
    # the same conv, directly
    _close(got.numpy(), tlc.conv_valid_ref(torch.from_numpy(x),
                                           torch.from_numpy(w)).numpy(), 1e-5)


def test_s2d_conv_rejects_indivisible_outputs():
    x = torch.zeros(1, 21, 20, 3)              # output 15 x 14
    with pytest.raises(ValueError, match="divisible by 4"):
        tlc.s2d_conv(x, torch.zeros(7, 7, 3, 3), 4)


@pytest.mark.parametrize("shape,p,cout", [((2, 16, 20, 5), 3, 3),
                                          ((1, 12, 8, 4), 1, 2)])
def test_s2d_reflect_conv_and_grads_match_jax(shape, p, cout):
    k = 2 * p + 1
    x = _rand(*shape, seed=3)
    w = _rand(k, k, shape[-1], cout, seed=4, scale=0.1)
    dy = _rand(*shape[:3], cout, seed=5)
    y, vjp = jax.vjp(lambda a, b: jlc.s2d_reflect_conv(a, b, p, 4, HI),
                     jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    yt = tlc.s2d_reflect_conv(xt, wt, p, 4)
    dx_t, dw_t = torch.autograd.grad(yt, (xt, wt), torch.from_numpy(dy))
    _close(yt.detach().numpy(), y, 1e-5)
    _close(dx_t.numpy(), dx_j, 1e-5)
    _close(dw_t.numpy(), dw_j, 1e-5)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_reflect_conv_matches_jax(p):
    k = 2 * p + 1
    x = _rand(2, 9, 11, 4, seed=6)
    w = _rand(k, k, 4, 5, seed=7, scale=0.1)
    want = np.asarray(jlayers.reflect_conv(jnp.asarray(x), jnp.asarray(w), p,
                                           precision=HI))
    got = tlc.reflect_conv(torch.from_numpy(x), torch.from_numpy(w), p)
    _close(got.numpy(), want, 1e-5)


def test_torch_conv_fused_reflect_equals_padded_conv():
    """``fused_reflect`` (a module field, no CLI flag) gives the padded
    conv's output and gradients."""
    g = torch.Generator().manual_seed(0)
    plain = tlayers.TorchConv(6, 4, 3, 1, 1, "reflect", True)
    fused = tlayers.TorchConv(6, 4, 3, 1, 1, "reflect", True,
                              fused_reflect=True)
    tlayers.init_weights(plain, tlayers.make_initializer("normal", 0.02), g)
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(2, 6, 10, 12, generator=g, requires_grad=True)
    ys = [m(x) for m in (plain, fused)]
    gs = [torch.autograd.grad((y ** 2).sum(), (x, m.weight))
          for y, m in zip(ys, (plain, fused))]
    torch.testing.assert_close(ys[1], ys[0], rtol=0, atol=1e-6)
    for a, b in zip(gs[1], gs[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- #
# TorchConv's bf16 routes and ResizeConv, on converted weights
# --------------------------------------------------------------------------- #


def _jax_conv(module, x, *args):
    v = module.init(jax.random.PRNGKey(0), jnp.asarray(x), *args)
    return v, np.asarray(module.apply(v, jnp.asarray(x), *args), np.float32)


@pytest.mark.parametrize("route", ["stem_cond", "tail_s2d"])
def test_torch_conv_bf16_routes_close_to_jax(route, monkeypatch):
    """The JAX bf16 ``TorchConv`` with ``lowch_matmul`` (stem: the
    condition as a per-sample bias; tail: the r=4 s2d conv) against the
    port's, on the same f32 weights."""
    rng = np.random.default_rng(8)
    calls = []
    real = tlc.s2d_conv_nchw
    monkeypatch.setattr(tlc, "s2d_conv_nchw",
                        lambda *a: calls.append(1) or real(*a))
    if route == "stem_cond":
        x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
        cond = np.eye(4, dtype=np.float32)[[1, 3]]
        # 16 features: a stem (more than 8) is never s2d-routed
        jm = jlayers.TorchConv(16, 7, 1, 3, pad_mode="reflect",
                               use_bias=True, lowch_matmul=True,
                               dtype=jnp.bfloat16)
        v, want = _jax_conv(jm, x, jnp.asarray(cond))
        tm = tlayers.TorchConv(7, 16, 7, 1, 3, "reflect", True,
                               torch.bfloat16, lowch_matmul=True)
        args = (torch.from_numpy(cond),)
    else:
        x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
        jm = jlayers.TorchConv(3, 7, 1, 3, pad_mode="reflect", use_bias=True,
                               lowch_matmul=True, dtype=jnp.bfloat16)
        v, want = _jax_conv(jm, x)
        tm = tlayers.TorchConv(8, 3, 7, 1, 3, "reflect", True,
                               torch.bfloat16, lowch_matmul=True)
        args = ()
    p = v["params"]
    tm.load_state_dict({
        "weight": torch.from_numpy(convert.conv_weight_from_flax(
            p["kernel"])),
        "bias": torch.from_numpy(np.array(p["bias"]))})
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), *args)
    assert got.dtype == torch.bfloat16
    assert len(calls) == (route == "tail_s2d")
    err = np.abs(got.float().permute(0, 2, 3, 1).numpy() - want)
    assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())
    if route == "stem_cond":
        # the separated channels need a full stride-1 reflect conv
        zero = tlayers.TorchConv(7, 8, 3, 1, 1, "zero", True, torch.bfloat16)
        with pytest.raises(ValueError, match="full stride-1 reflect"):
            zero(torch.zeros(1, 3, 8, 8), torch.zeros(1, 4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_conv_matches_jax(dtype):
    x = np.random.default_rng(9).standard_normal((2, 5, 7, 6)).astype(
        np.float32)
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    v, want = _jax_conv(jlayers.ResizeConv(4, 2, dtype=jd), x)
    p = v["params"]["TorchConv_0"]
    tm = tlayers.ResizeConv(6, 4, dtype=td)
    tm.load_state_dict({
        "conv.weight": torch.from_numpy(convert.conv_weight_from_flax(
            p["kernel"])),
        "conv.bias": torch.from_numpy(np.array(p["bias"]))})
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).float().permute(
            0, 2, 3, 1).numpy()
    assert got.shape == (2, 10, 14, 4)
    if dtype == "float32":
        _close(got, want, 1e-5)
    else:
        err = np.abs(got - want)
        assert err.max() <= 5e-2 and err.mean() <= 5e-3


@pytest.mark.parametrize("lowch", [True, False])
def test_bf16_resnet_takes_the_jax_default_routes(lowch, monkeypatch):
    """With ``--lowch_matmul`` (the default) the bf16 resnet G's stem gets
    the condition as a bias (the constant map is never built) and its tail
    runs as one s2d conv; without it, neither. Either way the output
    stays within the bf16 limits of the JAX G's."""
    # ngf 16: the stem has more than 8 features, as at full width, so only
    # the tail is s2d-routed
    argv = ["--crop_size", "32", "--load_size", "36", "--n_age_bins", "4",
            "--netG", "resnet_6blocks", "--dtype", "bfloat16",
                    "--ngf", "16",
                    "--lowch_matmul" if lowch else "--no-lowch_matmul"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jG = jax_define_G(jax_parse(argv, is_train=False))
        pG = port_define_G(port_parse(argv, is_train=False))
    jv = init_params(jG, jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)),
                     jnp.zeros((1, 4)), train=False)
    pG.load_state_dict(convert.convert_generator_params(jv["params"]))
    pG.eval()
    calls, conds = [], []
    real = tlc.s2d_conv_nchw
    monkeypatch.setattr(tlc, "s2d_conv_nchw",
                        lambda *a: calls.append(1) or real(*a))
    pG.stem.register_forward_hook(
        lambda m, args, out: conds.append(len(args)))
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[[0, 2]]
    with torch.no_grad():
        got = pG(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    want = np.asarray(jG.apply(jv, jnp.asarray(x), jnp.asarray(c),
                               train=False), np.float32)
    assert calls == ([1] if lowch else [])
    assert conds == [2 if lowch else 1]      # (x, cond) or the concat alone
    assert pG.stem.weight.shape[1] == 3 + 4  # the concat shape either way
    err = np.abs(got - want)
    assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())
