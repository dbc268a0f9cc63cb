"""The port's PatchGAN discriminator against ``pcgan_tpu``'s on converted
weights: the flax params are drawn by the JAX package, carried over with
``convert.convert_discriminator_params`` and both forwards run on the same
numpy input in f32 (JAX at ``Precision.HIGHEST``), within 1e-5.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu import config as jcfg
from pcgan_tpu.models.registry import define_D as j_define_D
from pcgan_tpu.models.registry import init_params

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch.convert import convert_discriminator_params
from pcgan_tpu_torch.models import define_D

NB = 4


def _cfg(mod, netD, n_layers, norm, dtype="float32"):
    return mod.Config(
        data=mod.DataConfig(n_age_bins=NB, crop_size=32, load_size=32),
        model=mod.ModelConfig(netD=netD, n_layers_D=n_layers, ndf=8,
                              norm=norm, dtype=dtype))


@pytest.mark.parametrize("netD,n_layers,norm,size", [
    ("basic", 3, "instance", 32), ("n_layers", 2, "instance", 32),
    ("n_layers", 4, "none", 64)])
def test_forward_matches_jax(netD, n_layers, norm, size):
    jD = j_define_D(_cfg(jcfg, netD, n_layers, norm))
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    cond = np.eye(NB, dtype=np.float32)[[1, 3]]
    variables = init_params(jD, jax.random.PRNGKey(1), jnp.asarray(x),
                            jnp.asarray(cond))
    # non-zero biases, so their mapping is checked too
    params = jax.tree.map(lambda a: a + 0.01 if a.ndim == 1 else a,
                          variables["params"])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jD.apply({"params": params}, jnp.asarray(x),
                                   jnp.asarray(cond), train=True))
    D = define_D(_cfg(tcfg, netD, n_layers, norm))
    D.load_state_dict(convert_discriminator_params(params), strict=True)
    got = D(torch.from_numpy(x), torch.from_numpy(cond))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


def test_mid_convs_have_no_bias_under_instance_norm():
    D = define_D(_cfg(tcfg, "basic", 3, "instance"))
    assert [c.bias is not None for c in D.convs] == [True, False, False,
                                                     False, True]
    with pytest.raises(ValueError, match="no place"):
        convert_discriminator_params(
            {**{f"TorchConv_{i}": {"kernel": np.zeros((4, 4, 1, 1))}
                for i in range(5)}, "Extra_0": {"kernel": np.zeros(1)}})


def test_bf16_logits_are_f32():
    D = define_D(_cfg(tcfg, "basic", 3, "instance", dtype="bfloat16"),
                 torch.Generator().manual_seed(0))
    out = D(torch.zeros(1, 32, 32, 3), torch.eye(NB)[:1])
    assert out.dtype == torch.float32 and out.shape == (1, 2, 2, 1)
