"""pcgan_tpu_torch generator == the JAX package's (CPU).

Flax generators are initialized from a PRNGKey, converted with
``pcgan_tpu_torch.convert`` and run on the same numpy inputs. Tolerances:
f32 atol 1e-4 (the golden grid's own tolerance: summation-order noise
through 6-9 residual blocks and the tanh head). bf16: max 5e-2 and mean
5e-3, because the two frameworks round bf16 at different places (the JAX
bf16 path also reformulates the stem/tail convs under --lowch_matmul,
exact only in real arithmetic).
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.config import parse_config as jax_parse
from pcgan_tpu.models.registry import define_G as jax_define_G
from pcgan_tpu.models.registry import init_params
from pcgan_tpu_torch import convert
from pcgan_tpu_torch.config import parse_config as port_parse
from pcgan_tpu_torch.models import define_G as port_define_G
from pcgan_tpu_torch.sample import make_sampler

SMALL = ["--crop_size", "32", "--load_size", "36", "--ngf", "8",
         "--n_age_bins", "4"]


def _pair(argv, seed=0):
    """(JAX G, its variables, the port's G with the converted weights)."""
    jcfg = jax_parse(argv, is_train=False)
    pcfg = port_parse(argv, is_train=False)
    jG = jax_define_G(jcfg)
    jvars = init_params(jG, jax.random.PRNGKey(seed),
                        jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 4)),
                        train=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pG = port_define_G(pcfg)
    pG.load_state_dict(convert.convert_generator_params(jvars["params"]))
    return jG, jvars, pG.eval()


def _inputs(n=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, c


def _run_both(argv, seed=0):
    jG, jvars, pG = _pair(argv, seed)
    x, c = _inputs(seed=seed)
    want = np.asarray(jG.apply(jvars, jnp.asarray(x), jnp.asarray(c),
                               train=False), np.float32)
    with torch.no_grad():
        got = pG(torch.from_numpy(x), torch.from_numpy(c))
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("netG,inject", [
    ("resnet_6blocks", "input"), ("resnet_6blocks", "bottleneck"),
    ("resnet_9blocks", "bottleneck")])
def test_generator_f32_matches_jax(netG, inject):
    got, want = _run_both(SMALL + ["--netG", netG, "--cond_inject", inject,
                                   "--dtype", "float32"])
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("inject", ["input", "bottleneck"])
@pytest.mark.parametrize("lowch", ["--lowch_matmul", "--no-lowch_matmul"])
def test_generator_bf16_close_to_jax(inject, lowch):
    got, want = _run_both(SMALL + ["--netG", "resnet_6blocks",
                                   "--cond_inject", inject,
                                   "--dtype", "bfloat16", lowch], seed=1)
    err = np.abs(got - want)
    assert err.max() <= 5e-2, err.max()
    assert err.mean() <= 5e-3, err.mean()


def test_sampler_matches_stored_golden():
    """The port's aging grid on the converted PRNGKey(7) weights of the
    golden smoke config equals tests/golden_sampler.npz
    (tests/test_golden.py:71-97) at its own atol 1e-4."""
    argv = SMALL + ["--netG", "resnet_6blocks", "--dtype", "float32",
                    "--batch_size", "4", "--no_flip"]
    _, _, pG = _pair(argv, seed=7)
    x = np.linspace(-1.0, 1.0, 2 * 32 * 32 * 3,
                    dtype=np.float32).reshape(2, 32, 32, 3)
    fakes = make_sampler(port_parse(argv, is_train=False), pG)(
        torch.from_numpy(x)).numpy()
    golden = np.load(os.path.join(os.path.dirname(__file__),
                                  "golden_sampler.npz"))["fakes"]
    assert fakes.shape == golden.shape == (2, 4, 32, 32, 3)
    np.testing.assert_allclose(fakes, golden, atol=1e-4, rtol=0)


def test_convert_round_trips_through_npz(tmp_path):
    """The npz dump of convert.py's docstring (flax paths joined with '/')
    converts to the same state_dict as the live tree."""
    from flax.traverse_util import flatten_dict
    argv = SMALL + ["--netG", "resnet_6blocks", "--cond_inject", "bottleneck"]
    jG = jax_define_G(jax_parse(argv, is_train=False))
    params = init_params(jG, jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)),
                         jnp.zeros((1, 4)), train=False)["params"]
    flat = flatten_dict(params, sep="/")
    path = tmp_path / "G_flax.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})
    a = convert.convert_generator_params(convert.load_flax_npz(str(path)))
    b = convert.convert_generator_params(params)
    assert list(a) == list(b)
    assert "cond_proj.bias" in a and "stem.bias" not in a
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="no place"):
        convert.convert_generator_params({**flat, "extra/kernel": np.zeros(1)})


def test_define_G_warnings_fire():
    with pytest.warns(RuntimeWarning, match="UNCONDITIONAL"):
        port_define_G(port_parse(SMALL + ["--netG", "resnet_6blocks"]))
    with pytest.warns(RuntimeWarning, match="INERT"):
        port_define_G(port_parse(SMALL + ["--netG", "resnet_6blocks",
                                          "--cond_inject", "bottleneck",
                                          "--remat_blocks", "2"]))


@pytest.mark.parametrize("dtype,want", [("float16", torch.float16),
                                        ("bfloat16", torch.bfloat16),
                                        ("float32", torch.float32)])
def test_dtype_flag_sets_the_module_dtype(dtype, want):
    """--dtype (float16 ported too) sets every layer's compute dtype; the
    params stay f32."""
    G = port_define_G(port_parse(SMALL + ["--cond_inject", "bottleneck",
                                          "--dtype", dtype]))
    assert G.compute_dtype == G.stem.compute_dtype == want
    assert all(p.dtype == torch.float32 for p in G.parameters())


def test_seeded_init_is_reproducible():
    cfg = port_parse(SMALL + ["--netG", "resnet_6blocks",
                              "--cond_inject", "bottleneck"])
    a = port_define_G(cfg, torch.Generator().manual_seed(11)).state_dict()
    b = port_define_G(cfg, torch.Generator().manual_seed(11)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
