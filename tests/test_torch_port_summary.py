"""``print_networks`` in the port (``pcgan_tpu_torch/utils/summary.py``)
against the JAX package's (``pcgan_tpu/utils/summary.py``): each net's
parameter total equals the JAX param tree's, for the generator variants,
the discriminators and the comparator (a cross-check of the converters'
layouts: the flax trees come from ``jax.eval_shape``, so no weights are
drawn), and the banner and table read as the JAX package prints them."""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import warnings

import pytest

import jax
import jax.numpy as jnp

from pcgan_tpu.config import parse_config as jax_parse
from pcgan_tpu.models import registry as jreg
from pcgan_tpu.utils.summary import count_params as jax_count
from pcgan_tpu.utils.summary import format_network as jax_format
from pcgan_tpu_torch.config import parse_config as port_parse
from pcgan_tpu_torch.models import registry as treg
from pcgan_tpu_torch.utils.summary import (count_params, format_network,
                                           print_networks)

SMALL = ["--ngf", "8", "--ndf", "8", "--n_age_bins", "4", "--cmp_nf", "8",
         "--cmp_n_down", "3", "--load_size", "36"]


def _jax_params(module, size, *args):
    shapes = jax.eval_shape(lambda k: jreg.init_params(
        module, k, jnp.zeros((1, size, size, 3)), *args, train=False),
        jax.random.PRNGKey(0))
    return shapes["params"]


@pytest.mark.parametrize("netG,size,flags", [
    ("resnet_6blocks", 32, []),
    ("resnet_9blocks@resize_conv", 32, ["--cond_inject", "bottleneck"]),
    ("resnet_6blocks", 32, ["--g_attn", "--norm", "batch"]),
    ("unet_32", 32, []),
    ("unet_256", 256, ["--cond_inject", "bottleneck"])])
def test_generator_totals_equal_jax(netG, size, flags):
    argv = SMALL + ["--netG", netG, "--crop_size", str(size)] + flags
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jG = jreg.define_G(jax_parse(argv, is_train=False))
        pG = treg.define_G(port_parse(argv, is_train=False))
    want = jax_count(_jax_params(jG, size, jnp.zeros((1, 4))))
    assert count_params(pG) == want > 0
    assert format_network("G", pG).splitlines()[-1] == jax_format(
        "G", _jax_params(jG, size, jnp.zeros((1, 4)))).splitlines()[-1]


@pytest.mark.parametrize("netD,flags", [
    ("basic", []), ("multiscale", ["--num_D", "2", "--n_layers_D", "2",
                                   "--d_attn"]),
    ("pixel", ["--norm", "batch"])])
def test_discriminator_totals_equal_jax(netD, flags):
    argv = SMALL + ["--netD", netD, "--crop_size", "32"] + flags
    jD = jreg.define_D(jax_parse(argv))
    pD = treg.define_D(port_parse(argv))
    assert count_params(pD) == jax_count(_jax_params(jD, 32, jnp.zeros(
        (1, 4)))) > 0


def test_comparator_total_equals_jax():
    argv = SMALL + ["--crop_size", "32"]
    jC = jreg.define_C(jax_parse(argv))
    pC = treg.define_C(port_parse(argv))
    assert count_params(pC) == jax_count(_jax_params(jC, 32)) > 0


def test_print_networks_banner_and_verbose_table(capsys):
    G = treg.define_G(port_parse(SMALL + ["--netG", "unet_32",
                                          "--crop_size", "32"]))
    print_networks({"G": G, "C (frozen)": None}, verbose=True)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "---------- Networks initialized -------------"
    assert out[1] == "[Network G] parameters:"
    rows = out[2:-2]
    assert len(rows) == len(list(G.parameters()))
    assert rows[0].split()[0] == "levels.0.down.weight"
    assert out[-2] == (f"[Network G] Total number of parameters : "
                       f"{count_params(G) / 1e6:.3f} M")
    assert "C (frozen)" not in "\n".join(out)


def test_training_prints_the_networks(tmp_path, capsys):
    from pcgan_tpu_torch import train_main
    train_main.main(["--dataset_mode", "synthetic", "--max_dataset_size",
                     "4", "--batch_size", "2", "--crop_size", "32",
                     "--netG", "unet_32", "--niter", "1", "--niter_decay",
                     "0", "--name", "s", "--checkpoints_dir", str(tmp_path),
                     "--device", "cpu"] + SMALL)
    out = capsys.readouterr().out
    assert "[Network G] Total number of parameters" in out
    assert "[Network D] Total number of parameters" in out
