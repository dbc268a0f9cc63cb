"""pcgan_tpu_torch preprocessing == the JAX package's (CPU).

The plain PyTorch ``preprocess_batch`` (the twin of the CUDA kernel) is held
against JAX ``preprocess_batch`` and the Pallas kernel in interpret mode on
the same numpy inputs. f32 tolerance 2e-5: both sides are full-f32 products
of u8 data and differ only in summation order. bf16 tolerance: one bf16 ulp
of the reference value (magnitudes below 2^-7 count as 2^-7, so values that
cancel to ~0 are held to 6e-5, above the f32 noise).
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcgan_tpu.ops import preprocess as jax_pre
from pcgan_tpu.ops.pallas_preprocess import pallas_preprocess_batch
from pcgan_tpu_torch.ops import _build, cuda_preprocess
from pcgan_tpu_torch.ops import preprocess as port_pre


def bf16_ulp(v):
    a = np.maximum(np.abs(np.asarray(v, np.float32)), 2.0 ** -7)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("method", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("in_out", [(50, 43), (200, 143), (36, 64), (32, 32)])
def test_resize_matrix_bit_identical(method, in_out):
    got = port_pre.resize_matrix(*in_out, method)
    want = jax_pre.resize_matrix(*in_out, method)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


# (B, native, load, crop, cy, cx, flip)
CASES = {
    "offsets_flips": (4, 50, 43, 32, [0, 3, 7, 11], [11, 7, 3, 0],
                      [0, 1, 0, 1]),
    "upsample": (2, 30, 36, 32, [4, 1], [2, 0], [1, 0]),
    "identity": (2, 32, 32, 32, [0, 0], [0, 0], [0, 0]),
}


def _inputs(case, seed=0):
    b, n, load, crop, cy, cx, fl = CASES[case]
    imgs = np.random.default_rng(seed).integers(0, 256, (b, n, n, 3),
                                                dtype=np.uint8)
    return imgs, np.int32(cy), np.int32(cx), np.int32(fl), load, crop


def _port(imgs, cy, cx, fl, load, crop, out_dtype):
    out = port_pre.preprocess_batch(
        torch.from_numpy(imgs), torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(fl).bool(), load, crop, out_dtype=out_dtype)
    return out.float().numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_f32(case):
    imgs, cy, cx, fl, load, crop = _inputs(case)
    got = _port(imgs, cy, cx, fl, load, crop, torch.float32)
    want = jax_pre.preprocess_batch(
        jnp.asarray(imgs), jnp.asarray(cy), jnp.asarray(cx),
        jnp.asarray(fl).astype(bool), load, crop, out_dtype=jnp.float32)
    pallas = pallas_preprocess_batch(
        jnp.asarray(imgs), jnp.asarray(cy), jnp.asarray(cx), jnp.asarray(fl),
        load_size=load, crop_size=crop, out_dtype=jnp.float32,
        interpret=True)
    assert got.shape == (len(cy), crop, crop, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", ["offsets_flips", "upsample"])
def test_plain_matches_jax_bf16(case):
    imgs, cy, cx, fl, load, crop = _inputs(case, seed=1)
    got = _port(imgs, cy, cx, fl, load, crop, torch.bfloat16)
    want = np.asarray(jax_pre.preprocess_batch(
        jnp.asarray(imgs), jnp.asarray(cy), jnp.asarray(cx),
        jnp.asarray(fl).astype(bool), load, crop,
        out_dtype=jnp.bfloat16)).astype(np.float32)
    assert np.all(np.abs(got - want) <= bf16_ulp(want))


def test_identity_is_normalization():
    imgs, cy, cx, fl, load, crop = _inputs("identity")
    got = _port(imgs, cy, cx, fl, load, crop, torch.float32)
    np.testing.assert_allclose(got, imgs / 127.5 - 1.0, atol=1e-5, rtol=0)


def _cfg(dtype="float32"):
    from pcgan_tpu_torch.config import parse_config
    return parse_config(["--load_size", "36", "--crop_size", "32",
                         "--dtype", dtype, "--device", "cpu"], is_train=False)


def test_make_preprocess_eval_center_crops():
    """train=False: center crop (offset (load-crop)//2 = 2), no flip, the
    same batch as the JAX make_preprocess on the CPU."""
    from pcgan_tpu.config import parse_config as jax_parse
    from pcgan_tpu.ops.preprocess import make_preprocess as jax_make
    imgs = np.random.default_rng(2).integers(0, 256, (3, 40, 40, 3),
                                             dtype=np.uint8)
    out = port_pre.make_preprocess(_cfg(), train=False)(
        None, {"image": torch.from_numpy(imgs), "bin": np.arange(3)})
    assert np.array_equal(out["bin"], np.arange(3))
    two = np.full(3, 2, np.int32)
    want = _port(imgs, two, two, np.zeros(3, np.int32), 36, 32, torch.float32)
    np.testing.assert_array_equal(out["image"].numpy(), want)
    import jax
    jcfg = jax_parse(["--load_size", "36", "--crop_size", "32",
                      "--dtype", "float32"], is_train=False)
    jout = jax_make(jcfg, train=False)(jax.random.PRNGKey(0),
                                       {"image": jnp.asarray(imgs)})
    np.testing.assert_allclose(out["image"].numpy(), np.asarray(jout["image"]),
                               atol=2e-5, rtol=0)


def test_make_preprocess_train_is_seeded():
    imgs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, 40, 40, 3), dtype=np.uint8))
    fn = port_pre.make_preprocess(_cfg("bfloat16"), train=True)
    a = fn(torch.Generator().manual_seed(5), {"image": imgs})["image"]
    b = fn(torch.Generator().manual_seed(5), {"image": imgs})["image"]
    assert a.dtype == torch.bfloat16 and a.shape == (4, 32, 32, 3)
    assert torch.equal(a, b)
    assert float(a.float().abs().max()) <= 1.0


def test_cpu_never_launches_the_kernel():
    before = cuda_preprocess.launches
    imgs = np.random.default_rng(4).integers(0, 256, (4, 40, 40, 3),
                                             dtype=np.uint8)
    out = port_pre.make_preprocess(_cfg(), train=False)(
        None, {"image": torch.from_numpy(imgs)})["image"]
    two = np.full(4, 2, np.int32)
    want = _port(imgs, two, two, np.zeros(4, np.int32), 36, 32, torch.float32)
    np.testing.assert_array_equal(out.numpy(), want)
    assert cuda_preprocess.launches == before == 0


def test_kernel_wrapper_never_falls_back():
    """No plain-version fallback: a CPU tensor handed to the kernel wrapper,
    or a batch on another device type handed to make_preprocess, raises."""
    imgs = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="want cuda"):
        cuda_preprocess.preprocess_batch_cuda(imgs, z, z, z, 8, 8)
    fn = port_pre.make_preprocess(_cfg(), train=False)
    with pytest.raises(ValueError, match="unsupported device"):
        fn(None, {"image": imgs.to("meta")})


class _CudaBatch:
    """Stands for a u8 batch on the card: make_preprocess reads only its
    shape and device before handing it on."""
    shape = (2, 40, 40, 3)
    device = torch.device("cuda")


@pytest.mark.parametrize("flag,want", [("--pallas_pipeline", "kernel"),
                                       ("--no-pallas_pipeline", "plain")])
def test_pallas_pipeline_flag_picks_the_route(monkeypatch, flag, want):
    """--no-pallas_pipeline runs the plain version on the batch's device,
    as the JAX package runs its plain XLA route; with the flag on a CUDA
    batch goes to the kernel and never to the plain version. A CPU batch
    takes the plain version either way, with the same result."""
    from pcgan_tpu_torch.config import parse_config
    cfg = parse_config(["--load_size", "36", "--crop_size", "32", flag,
                        "--dtype", "float32",
                        "--device", "cpu"], is_train=False)
    took = []
    monkeypatch.setattr(port_pre, "preprocess_batch_cuda",
                        lambda *a, **k: took.append("kernel"))
    plain = port_pre.preprocess_batch

    def spy(imgs, *a, **k):
        took.append("plain")
        return plain(imgs, *a, **k) if isinstance(imgs, torch.Tensor) else None
    monkeypatch.setattr(port_pre, "preprocess_batch", spy)
    fn = port_pre.make_preprocess(cfg, train=False)
    fn(None, {"image": _CudaBatch()})
    assert took == [want]
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 40, 40, 3), dtype=np.uint8))
    got = fn(None, {"image": imgs})["image"]
    assert took[1:] == ["plain"]
    assert torch.equal(got, plain(imgs, torch.full((2,), 2),
                                  torch.full((2,), 2),
                                  torch.zeros(2, dtype=torch.bool), 36, 32))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
