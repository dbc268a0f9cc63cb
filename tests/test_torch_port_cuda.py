"""Kernels B1 (pcgan_tpu_torch/csrc/preprocess.cu) and B2
(pcgan_tpu_torch/csrc/wgrad.cu) against their plain PyTorch versions on a
CUDA card. A CUDA kernel has no CPU mode, so these tests skip
where no card is present. On the card (this file imports no jax, and
``--noconftest`` skips the JAX-side test config)::

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q -p no:cacheprovider

Tolerances: B1 f32 output 2e-5 (summation order only); bf16 output one
bf16 ulp of the plain value (magnitudes below 2^-7 count as 2^-7). B2:
1e-4 of the largest entry (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from pcgan_tpu_torch.ops import cuda_preprocess as cp
from pcgan_tpu_torch.ops.preprocess import preprocess_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no "
                    "CPU mode")
    from pcgan_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def bf16_ulp(v):
    a = np.maximum(np.abs(np.asarray(v, np.float32)), 2.0 ** -7)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("b,native,load,crop", [
    (8, 200, 143, 128), (4, 50, 43, 32), (2, 32, 32, 32), (3, 30, 64, 48)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, b, native, load, crop, out_dtype):
    rng = np.random.default_rng(native)
    imgs = torch.from_numpy(rng.integers(0, 256, (b, native, native, 3),
                                         dtype=np.uint8)).to(cuda_device)
    cy, cx = (torch.from_numpy(rng.integers(0, load - crop + 1, b))
              .to(cuda_device) for _ in range(2))
    fl = torch.from_numpy(rng.integers(0, 2, b)).to(cuda_device)
    before = cp.launches
    got = cp.preprocess_batch_cuda(imgs, cy, cx, fl, load, crop,
                                   out_dtype=out_dtype)
    assert cp.launches == before + 1
    want = preprocess_batch(imgs, cy, cx, fl.bool(), load, crop,
                            out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.shape == (b, crop, crop, 3) and got.dtype == out_dtype
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    if out_dtype == torch.float32:
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)
    else:
        assert np.all(np.abs(g - w) <= bf16_ulp(w))


def test_make_preprocess_runs_the_kernel_on_a_cuda_batch(cuda_device):
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    cfg = parse_config(["--load_size", "43", "--crop_size", "32",
                        "--dtype", "bfloat16"], is_train=False)
    imgs = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (4, 50, 50, 3), dtype=np.uint8))
    before = cp.launches
    got = make_preprocess(cfg, train=False)(
        None, {"image": imgs.to(cuda_device)})["image"]
    assert cp.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.bfloat16
    want = make_preprocess(cfg, train=False)(None, {"image": imgs})["image"]
    g, w = got.float().cpu().numpy(), want.float().numpy()
    assert np.all(np.abs(g - w) <= bf16_ulp(w))


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    z = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    f32 = torch.zeros((2, 8, 8, 3), device=cuda_device)
    with pytest.raises(ValueError, match="uint8"):
        cp.preprocess_batch_cuda(f32, z, z, z, 8, 8)
    u8 = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cp.preprocess_batch_cuda(u8.transpose(1, 2), z, z, z, 8, 8)
    with pytest.raises(ValueError, match="crop"):
        cp.preprocess_batch_cuda(u8, z, z, z, 8, 9)


# --------------------------------------------------------------------------- #
# kernel B2 (pcgan_tpu_torch/csrc/wgrad.cu)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("b,hp,wp,cin,cout,k", [
    (16, 134, 134, 64, 3, 7), (3, 37, 29, 24, 1, 3), (2, 40, 40, 16, 8, 7),
    (2, 9, 9, 300, 2, 7), (1, 12, 12, 5, 4, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_kernel_matches_plain(cuda_device, b, hp, wp, cin, cout, k,
                                    dtype):
    """Both sum the same f32 products in another order: within 1e-4 of the
    largest entry; two launches give the same bits (no atomics)."""
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.standard_normal((b, hp, wp, cin)).astype(
        np.float32)).to(cuda_device, dtype)
    dy = torch.from_numpy(rng.standard_normal(
        (b, hp - k + 1, wp - k + 1, cout)).astype(np.float32)).to(
            cuda_device, dtype)
    before = cw.launches
    got = cw.wgrad_cuda(x, dy, k)
    assert cw.launches == before + 1
    want = cw.wgrad_plain(x, dy, k)
    again = cw.wgrad_cuda(x, dy, k)
    torch.cuda.synchronize()
    assert got.shape == (k, k, cin, cout) and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert torch.equal(got, again)


def test_lowch_reflect_conv_dw_on_card_matches_cpu(cuda_device):
    """The routed tail conv's weight gradient: kernel B2 on the card, its
    plain version on the CPU, f32 (TF32 off)."""
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    from pcgan_tpu_torch.ops.lowch_conv import lowch_reflect_conv
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 16)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((7, 7, 16, 3)) * 0.1).astype(
        np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    grads = []
    for dev in (torch.device("cpu"), cuda_device):
        xd = x.to(dev).requires_grad_()
        wd = w.to(dev).requires_grad_()
        before = cw.launches
        y = lowch_reflect_conv(xd, wd, 3)
        grads.append([g.cpu() for g in torch.autograd.grad(y, (xd, wd),
                                                           dy.to(dev))])
        assert cw.launches == before + (dev.type == "cuda")
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4)
