"""The port's adversarial criteria and condition encoding against
``pcgan_tpu/ops/gan_loss.py`` and ``pcgan_tpu/data/binning.py`` on the same
numpy inputs (f32 reductions both sides: 1e-6 relative)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcgan_tpu.data import binning as jbin
from pcgan_tpu.ops import gan_loss as J

from pcgan_tpu_torch.data import binning as tbin
from pcgan_tpu_torch.ops import gan_loss as T


@pytest.mark.parametrize("mode", T.PORTED_MODES)
@pytest.mark.parametrize("target_is_real", [True, False])
@pytest.mark.parametrize("for_discriminator", [True, False])
def test_gan_loss_matches_jax(mode, target_is_real, for_discriminator):
    logits = (np.random.default_rng(0).standard_normal((4, 6, 6, 1))
              * 3).astype(np.float32)
    want = float(J.gan_loss(jnp.asarray(logits), target_is_real, mode,
                            for_discriminator))
    got = T.gan_loss(torch.from_numpy(logits), target_is_real, mode,
                     for_discriminator)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want))


def test_gan_loss_reduces_bf16_logits_in_f32():
    logits = torch.linspace(-2, 2, 64).reshape(1, 8, 8, 1)
    got = T.gan_loss(logits.bfloat16(), True, "lsgan")
    assert got.dtype == torch.float32
    want = float(J.gan_loss(jnp.asarray(logits.bfloat16().float().numpy()),
                            True, "lsgan"))
    assert abs(float(got) - want) <= 1e-6


def test_unported_modes_raise():
    # wgangp is ported: the critic's mean, against JAX
    x = torch.linspace(-1.5, 2.0, 12).reshape(1, 3, 4, 1)
    for real in (True, False):
        want = float(J.gan_loss(jnp.asarray(x.numpy()), real, "wgangp"))
        assert abs(float(T.gan_loss(x, real, "wgangp")) - want) <= 1e-7
    with pytest.raises(NotImplementedError, match="nope"):
        T.gan_loss(torch.zeros(1), True, "nope")


def test_split_pred():
    x = np.arange(12.0).reshape(6, 2)
    a, b = T.split_pred(torch.from_numpy(x), 2)
    ja, jb = J.split_pred(jnp.asarray(x), 2)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("n_bins", [4, 10])
def test_onehot_encodings_match_jax(n_bins):
    ages = np.array([0, 5, 17, 33, 59, 89, 90, 116])
    bins = np.array(jbin.age_to_bin(ages, n_bins))
    np.testing.assert_array_equal(tbin.age_to_bin(ages, n_bins), bins)
    np.testing.assert_array_equal(
        tbin.bin_to_onehot(bins, n_bins).numpy(),
        np.asarray(jbin.bin_to_onehot(bins, n_bins)))
    np.testing.assert_array_equal(
        tbin.age_to_onehot(ages, n_bins).numpy(),
        np.asarray(jbin.age_to_onehot(ages, n_bins)))
    oh = tbin.bin_to_onehot(torch.from_numpy(bins), n_bins, torch.bfloat16)
    assert oh.dtype == torch.bfloat16 and oh.shape == (len(ages), n_bins)
