"""The port's low-channel conv route and kernel B2's plain version against
``pcgan_tpu/ops/lowch_conv.py`` and ``pcgan_tpu/ops/pallas_wgrad.py``.

Inputs are made with numpy from a seed and given to both packages in f32
(JAX at ``Precision.HIGHEST``; the Pallas kernel runs in interpret mode on
the CPU, as the JAX package's own tests run it). Tolerances are those of
``tests/test_lowch_conv.py``: the reformulations change only the float
association.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.ops import lowch_conv as J
from pcgan_tpu.ops.pallas_wgrad import conv_wgrad_lowcout as j_wgrad

from pcgan_tpu_torch.ops import cuda_wgrad
from pcgan_tpu_torch.ops import lowch_conv as T

P = jax.lax.Precision.HIGHEST


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("cin,cout,k", [(16, 3, 7), (3, 16, 7), (8, 2, 3)])
def test_formulations_match_jax(cin, cout, k):
    x_pad, w = _rand(0, (2, 20, 22, cin)), _rand(1, (k, k, cin, cout), 0.2)
    want = np.asarray(J.conv_valid_ref(jnp.asarray(x_pad), jnp.asarray(w),
                                       precision=P))
    xt, wt = torch.from_numpy(x_pad), torch.from_numpy(w)
    for fn in (T.conv_valid_ref, T.tap_matmul_conv, T.col_matmul_conv):
        np.testing.assert_allclose(fn(xt, wt).numpy(), want,
                                   rtol=2e-5, atol=2e-5)


def test_reflect_pad_and_fold_match_jax():
    x, g_pad = _rand(2, (2, 10, 12, 4)), _rand(3, (2, 16, 18, 4))
    np.testing.assert_array_equal(
        T.reflect_pad(torch.from_numpy(x), 3).numpy(),
        np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)), mode="reflect"))
    np.testing.assert_allclose(
        T.reflect_fold(torch.from_numpy(g_pad), 3).numpy(),
        np.asarray(J.reflect_fold(jnp.asarray(g_pad), 3)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cin,cout", [(12, 3), (3, 12)])
def test_lowch_reflect_conv_matches_jax(cin, cout):
    """Forward, dx and dw of the custom VJP against JAX's, at the shapes of
    tests/test_lowch_conv.py. (12, 3) takes B2's plain version for dw,
    (3, 12) the native weight-gradient conv."""
    x, w = _rand(4, (2, 16, 16, cin)), _rand(5, (7, 7, cin, cout), 0.1)
    dy = _rand(6, (2, 16, 16, cout))
    y_j, vjp = jax.vjp(lambda a, b: J.lowch_reflect_conv(a, b, 3, P),
                       jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y_t = T.lowch_reflect_conv(xt, wt, 3)
    dx_t, dw_t = torch.autograd.grad(y_t, (xt, wt), torch.from_numpy(dy))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dw_t.numpy(), np.asarray(dw_j),
                               rtol=2e-5, atol=3e-5)
    assert y_t.dtype == dx_t.dtype == dw_t.dtype == torch.float32


def test_lowch_reflect_conv_bf16_grads_finite():
    x = torch.from_numpy(_rand(7, (2, 16, 16, 8))).bfloat16()
    w = torch.from_numpy(_rand(8, (7, 7, 8, 3), 0.1)).requires_grad_()
    (g,) = torch.autograd.grad((T.lowch_reflect_conv(x, w, 3).float() ** 2)
                               .sum(), w)
    assert g.shape == w.shape and g.dtype == torch.float32
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("shape,cout,k", [((2, 22, 20, 16), 3, 7),
                                          ((1, 11, 9, 8), 1, 3)])
def test_wgrad_plain_matches_pallas_kernel(shape, cout, k):
    """B2's plain version against the Pallas kernel in interpret mode."""
    x_pad = _rand(9, shape)
    dy = _rand(10, (shape[0], shape[1] - k + 1, shape[2] - k + 1, cout))
    want = np.asarray(j_wgrad(jnp.asarray(x_pad), jnp.asarray(dy), k, P))
    got = cuda_wgrad.wgrad_plain(torch.from_numpy(x_pad),
                                 torch.from_numpy(dy), k)
    assert got.shape == (k, k, shape[3], cout) and got.dtype == torch.float32
    # the dW entries reach ~40: f32 sums of ~450 products in two orders
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=3e-5)


def test_wgrad_dispatch_by_device():
    """A CPU tensor takes the plain version without touching the kernel's
    launch count; the kernel wrapper refuses a CPU tensor."""
    x_pad, dy = torch.zeros(1, 9, 9, 4), torch.zeros(1, 7, 7, 2)
    before = cuda_wgrad.launches
    assert cuda_wgrad.conv_wgrad_lowcout(x_pad, dy, 3).shape == (3, 3, 4, 2)
    assert cuda_wgrad.launches == before
    with pytest.raises(ValueError, match="cuda"):
        cuda_wgrad.wgrad_cuda(x_pad, dy, 3)
    with pytest.raises(ValueError, match="does not match"):
        cuda_wgrad.wgrad_plain(x_pad, torch.zeros(1, 6, 7, 2), 3)
