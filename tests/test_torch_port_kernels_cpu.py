"""The algebra of the port's hand-written kernels, on the CPU.

Kernel B1 (``pcgan_tpu_torch/csrc/preprocess.cu``) reads the resize
matrices as bands (``ops/resize.py resize_band``). Kernel B2's bf16 route
(``pcgan_tpu_torch/csrc/wgrad.cu``) computes the weight gradient as one
GEMM over the pixels of x_pad against an im2col of the zero-extended
cotangent. A CUDA kernel cannot run here, so both schemes are written out
below in numpy and held against the plain versions and the JAX package
(its Pallas wgrad kernel in interpret mode at ``Precision.HIGHEST``, as its
own tests run it). The kernels themselves are held against the plain
versions on the card (``tests/test_torch_port_cuda.py``).

Tolerances: the band scattered back is the resize matrix bit for bit. The
banded preprocessing is f32 sums in another order than the plain version's
products: 2e-5, as in ``tests/test_torch_port_preprocess.py``. The GEMM,
summed in f64, meets JAX's f32 kernel and the plain version at the
tolerances of ``tests/test_torch_port_lowch.py``.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.ops import preprocess as jax_pre
from pcgan_tpu.ops.pallas_wgrad import conv_wgrad_lowcout as j_wgrad
from pcgan_tpu_torch.ops import cuda_wgrad
from pcgan_tpu_torch.ops import preprocess as port_pre
from pcgan_tpu_torch.ops.resize import resize_band, resize_matrix

P = jax.lax.Precision.HIGHEST


# --------------------------------------------------------------------------- #
# B1: resize bands
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("in_size,out_size,method,want_k", [
    (200, 143, "bicubic", None), (50, 43, "bicubic", None),
    (30, 64, "bicubic", None), (50, 43, "bilinear", None),
    (32, 32, "bicubic", 1), (32, 32, "nearest", 1), (200, 143, "nearest", 1)])
def test_resize_band_scatters_back_exactly(in_size, out_size, method, want_k):
    lo, taps = resize_band(in_size, out_size, method)
    m = resize_matrix(in_size, out_size, method)
    k = taps.shape[1]
    assert lo.dtype == np.int32 and taps.dtype == np.float32
    assert lo.shape == (out_size,) and taps.shape == (out_size, k)
    assert want_k is None or k == want_k
    assert np.all(lo >= 0) and np.all(lo + k <= in_size)
    # the kernel reads the input columns lo[x0] .. lo[x0+crop-1]+K
    assert np.all(np.diff(lo) >= 0)
    back = np.zeros_like(m)
    np.put_along_axis(back, lo[:, None] + np.arange(k), taps, 1)
    assert np.array_equal(back, m)


def band_preprocess(imgs, cy, cx, flip, load, crop):
    """Kernel B1's banded sums in f32: per output row the vertical pass
    over the crop's input columns, then the horizontal pass per column,
    each over ascending input index."""
    b, h, w, c = imgs.shape
    lo_h, th = resize_band(h, load)
    lo_w, tw = resize_band(w, load)
    kh, kw = th.shape[1], tw.shape[1]
    span = load - crop
    out = np.empty((b, crop, crop, c), np.float32)
    for i in range(b):
        y0, x0 = min(max(cy[i], 0), span), min(max(cx[i], 0), span)
        wlo = lo_w[x0]
        whi = lo_w[x0 + crop - 1] + kw
        q = np.arange(crop)
        sel = x0 + (crop - 1 - q if flip[i] else q)
        cols = lo_w[sel][:, None] - wlo + np.arange(kw)       # (crop, kw)
        for r in range(crop):
            y = y0 + r
            v = np.zeros((whi - wlo, c), np.float32)
            for u in range(kh):
                v += th[y, u] * imgs[i, lo_h[y] + u, wlo:whi].astype(np.float32)
            acc = np.zeros((crop, c), np.float32)
            for u in range(kw):
                acc += tw[sel, u][:, None] * v[cols[:, u]]
            out[i, r] = np.clip(acc * np.float32(2 / 255) - 1, -1, 1)
    return out


@pytest.mark.parametrize("b,native,load,crop,cy,cx,flip", [
    (2, 200, 143, 16, [0, 127], [127, 40], [1, 0]),    # sampling sizes, cut
    (4, 50, 43, 32, [0, 3, 7, 11], [11, 7, 3, 0], [0, 1, 0, 1]),
    (2, 30, 64, 48, [16, 3], [0, 16], [1, 1]),          # upscale, flipped
    (2, 32, 32, 32, [0, 0], [0, 0], [0, 1])])           # identity
def test_band_preprocess_matches_plain_and_jax(b, native, load, crop, cy, cx,
                                               flip):
    imgs = np.random.default_rng(native).integers(
        0, 256, (b, native, native, 3), dtype=np.uint8)
    cy, cx, flip = np.int32(cy), np.int32(cx), np.int32(flip)
    got = band_preprocess(imgs, cy, cx, flip, load, crop)
    plain = port_pre.preprocess_batch(
        torch.from_numpy(imgs), torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(flip).bool(), load, crop).numpy()
    want = np.asarray(jax_pre.preprocess_batch(
        jnp.asarray(imgs), jnp.asarray(cy), jnp.asarray(cx),
        jnp.asarray(flip).astype(bool), load, crop, out_dtype=jnp.float32))
    np.testing.assert_allclose(got, plain, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


# --------------------------------------------------------------------------- #
# B2: the weight gradient as one GEMM over the pixels of x_pad
# --------------------------------------------------------------------------- #


def gemm_wgrad(x_pad, dy, k):
    """dW^T (Cin, k*k*Cout) = X^T D in f64: X (P, Cin) the pixels of x_pad,
    D[(b,hh,ww), (i,j,co)] = dy[b, hh-i, ww-j, co], zero outside dy."""
    b, hp, wp, cin = x_pad.shape
    _, h, w, cout = dy.shape
    dyz = np.zeros((b, hp + k - 1, wp + k - 1, cout))     # dy at (k-1, k-1)
    dyz[:, k - 1:k - 1 + h, k - 1:k - 1 + w] = dy
    d = np.concatenate([dyz[:, k - 1 - i:k - 1 - i + hp, k - 1 - j:k - 1 - j + wp]
                        for i in range(k) for j in range(k)], axis=-1)
    dwt = x_pad.reshape(-1, cin).astype(np.float64).T @ d.reshape(-1, k * k * cout)
    return dwt.reshape(cin, k, k, cout).transpose(1, 2, 0, 3)


def _wgrad_inputs(b, hp, wp, cin, cout, k, seed=0):
    rng = np.random.default_rng(seed)
    x_pad = rng.standard_normal((b, hp, wp, cin)).astype(np.float32)
    dy = rng.standard_normal((b, hp - k + 1, wp - k + 1, cout)).astype(np.float32)
    return x_pad, dy


# (B, Hp, Wp, Cin, Cout, k): ragged Cin, C_out 1/2/3/8, k 1/3/7, Wp not a
# multiple of 16 (and one that is)
WGRAD_SHAPES = [(2, 9, 13, 5, 1, 1), (2, 11, 21, 24, 3, 3),
                (1, 12, 19, 5, 8, 7), (1, 10, 13, 24, 8, 3),
                (2, 13, 22, 5, 3, 7), (2, 13, 37, 5, 3, 7),
                (3, 10, 29, 24, 1, 3), (1, 8, 17, 5, 2, 1),
                (2, 12, 16, 24, 8, 7)]


@pytest.mark.parametrize("shape", WGRAD_SHAPES)
def test_wgrad_gemm_identity_matches_jax(shape):
    *_, k = shape
    x_pad, dy = _wgrad_inputs(*shape)
    got = gemm_wgrad(x_pad, dy, k)
    want = np.asarray(j_wgrad(jnp.asarray(x_pad), jnp.asarray(dy), k, P))
    assert got.shape == want.shape == (k, k, shape[3], shape[4])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=3e-5)
    plain = cuda_wgrad.wgrad_plain(torch.from_numpy(x_pad),
                                   torch.from_numpy(dy), k).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-5, atol=3e-5)
