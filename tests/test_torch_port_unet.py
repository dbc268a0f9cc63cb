"""The port's U-Net generator (``--netG unet_<size>``) against the JAX
package's ``UnetGenerator`` (CPU).

Flax U-Nets are initialized from a PRNGKey, converted with
``pcgan_tpu_torch.convert`` and run on the same numpy inputs. Tolerances:
f32 forwards within 1e-4 (the golden grid's own tolerance); bf16 within max
5e-2 / mean 5e-3 (``test_torch_port_generator.py``'s bf16 limits: the two
frameworks round bf16 at different places); the 3-step train-step
lockstep as ``tests/torch_port_levers.py`` states it (metrics and Adam
first moments within 1e-4 of max(1, max|x|), norm state within 1e-5); int8
absmaxes within 2e-2 relative and int8 outputs within max 0.05 / mean 0.01
(``test_torch_port_quant.py``'s measured spread: rounding flips at f32
noise). Sizes: ngf 8, 4 bins, ``unet_32`` at 32 px, ``unet_64`` at 64 px
for the dropout and remat levels. The train step's lockstep is
``test_torch_port_unet_step.py``.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import functools
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.config import parse_config as jax_parse
from pcgan_tpu.models.registry import define_G as jax_define_G
from pcgan_tpu_torch import convert
from pcgan_tpu_torch.config import parse_config as port_parse
from pcgan_tpu_torch.models import define_G as port_define_G
from pcgan_tpu_torch.models.generator import UnetGenerator
from pcgan_tpu_torch.ops import quant as tq

from torch_port_levers import one_torch_thread  # noqa: F401

SMALL = ["--load_size", "36", "--ngf", "8", "--n_age_bins", "4"]


@functools.lru_cache(maxsize=None)
def _jax_g(argv, size):
    """(JAX G, jitted init(key), apply(v, x, c), calibrate(v, x, c))."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jG = jax_define_G(jax_parse(list(argv), is_train=False))
    init = jax.jit(lambda k: jG.init({"params": k, "dropout": k},
                                     jnp.zeros((1, size, size, 3)),
                                     jnp.zeros((1, 4)), train=False))
    apply = jax.jit(lambda v, x, c: jG.apply(v, x, c, train=False))
    calib = jax.jit(lambda v, x, c: jG.apply(
        v, x, c, train=False, mutable=["quant"])[1]["quant"])
    return jG, init, apply, calib


def _pair(netG, extra=(), seed=0):
    """(apply, calibrate, JAX variables, the port's G with the converted
    weights and batch stats, size)."""
    size = 64 if netG == "unet_64" else 32
    argv = tuple(SMALL + ["--netG", netG, "--crop_size", str(size)]
                 + list(extra))
    _, init, apply, calib = _jax_g(argv, size)
    jvars = init(jax.random.PRNGKey(seed))
    pG = port_define_G(port_parse(list(argv), is_train=False))
    pG.load_state_dict(convert.convert_generator_params(
        jvars["params"], jvars.get("batch_stats")))
    return apply, calib, jvars, pG.eval(), size


def _inputs(size, n=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, c


def _port(pG, x, c):
    with torch.no_grad():
        return pG(torch.from_numpy(x), torch.from_numpy(c)).float().numpy()


@pytest.mark.parametrize("netG,inject,norm", [
    ("unet_32", "input", "instance"), ("unet_32", "bottleneck", "instance"),
    ("unet_32", "input", "batch"), ("unet_32", "bottleneck", "group"),
    ("unet_64", "input", "instance"), ("unet_64", "bottleneck", "batch")])
def test_unet_f32_matches_jax(netG, inject, norm):
    apply, _, jvars, pG, size = _pair(
        netG, ("--cond_inject", inject, "--norm", norm, "--dtype",
               "float32"), seed=1)
    assert isinstance(pG, UnetGenerator)
    x, c = _inputs(size, seed=2)
    want = np.asarray(apply(jvars, jnp.asarray(x), jnp.asarray(c)))
    got = _port(pG, x, c)
    assert got.shape == want.shape == (2, size, size, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_unet_bf16_close_to_jax():
    apply, _, jvars, pG, size = _pair("unet_32", ("--dtype", "bfloat16"),
                                      seed=3)
    x, c = _inputs(size, seed=3)
    want = np.asarray(apply(jvars, jnp.asarray(x), jnp.asarray(c)),
                      np.float32)
    err = np.abs(_port(pG, x, c) - want)
    assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())


def test_convert_consumes_every_unet_leaf(tmp_path):
    """Every flax tensor of a batch-norm U-Net (params and batch_stats)
    finds its place, through the npz dump too; a foreign one raises."""
    from flax.traverse_util import flatten_dict
    _, _, jvars, pG, _ = _pair("unet_64", ("--norm", "batch"))
    flat = flatten_dict(jvars["params"], sep="/")
    stats = flatten_dict(jvars["batch_stats"], sep="/")
    sd = convert.convert_generator_params(jvars["params"],
                                          jvars["batch_stats"])
    assert len(sd) == len(flat) + len(stats) == len(pG.state_dict())
    assert set(sd) == set(pG.state_dict())
    assert "levels.0.up_norm.running_mean" in sd
    assert "levels.1.down_norm.weight" in sd and "levels.5.up.bias" in sd
    path = tmp_path / "G_flax.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})
    again = convert.convert_generator_params(convert.load_flax_npz(str(path)))
    for k in again:
        assert torch.equal(again[k], sd[k]), k
    with pytest.raises(ValueError, match="no place"):
        convert.convert_generator_params(
            {**flat, "UnetSkipBlock_0/Bogus_0/kernel": np.zeros(1)})


def test_define_g_unet_sizes_and_errors():
    """unet_<size>: log2(size) levels; a size that is not a power of 2 and
    --g_attn raise as in the JAX registry; --remat counts the levels below
    the outermost."""
    for size, n in ((32, 5), (128, 7), (256, 8)):
        G = port_define_G(port_parse(SMALL + ["--netG", f"unet_{size}"]))
        assert len(G.levels) == n and G.n_remat == 0
    G = port_define_G(port_parse(SMALL + ["--netG", "unet_128", "--remat"]))
    assert G.n_remat == 6
    G = port_define_G(port_parse(SMALL + ["--netG", "unet_128", "--remat",
                                          "--remat_blocks", "2"]))
    assert G.n_remat == 2
    with pytest.raises(NotImplementedError, match="power of 2"):
        port_define_G(port_parse(SMALL + ["--netG", "unet_48"]))
    with pytest.raises(NotImplementedError, match="resnet-generator lever"):
        port_define_G(port_parse(SMALL + ["--netG", "unet_128", "--g_attn"]))


# --------------------------------------------------------------------------- #
# remat, int8, serving and the CLIs
# --------------------------------------------------------------------------- #


def test_unet_remat_changes_no_number():
    """Remat of every level below the outermost (nested checkpoints, the
    recompute under frozen stats) gives the plain G's output, gradients
    and batch-norm state with the same masks."""
    argv = SMALL + ["--netG", "unet_64", "--crop_size", "64", "--norm",
                    "batch", "--no-no_dropout", "--dtype", "float32"]
    Gp = port_define_G(port_parse(argv), torch.Generator().manual_seed(1))
    Gr = port_define_G(port_parse(argv + ["--remat"]),
                       torch.Generator().manual_seed(1))
    x, c = (torch.from_numpy(a) for a in _inputs(64, seed=4))
    outs, grads = [], []
    for G in (Gp, Gr):
        out = G(x, c, generator=torch.Generator().manual_seed(9))
        outs.append(out)
        grads.append(torch.autograd.grad((out ** 2).sum(),
                                         list(G.parameters())))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-6)
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for k, v in Gp.state_dict().items():
        torch.testing.assert_close(Gr.state_dict()[k], v, rtol=0, atol=1e-7)


def test_unet_int8_absmaxes_and_outputs_match_jax():
    """Calibrated absmaxes of every level but the outermost, and the int8
    U-Net with dynamic and with JAX's calibrated static scales, over seeds
    0-2 (the tolerances are the module docstring's)."""
    for seed in range(3):
        apply, calib, jvars, pG, size = _pair(
            "unet_32", ("--quant_int8", "--dtype", "float32"), seed)
        x, c = _inputs(size, n=4, seed=20 + seed)
        jq = calib(jvars, jnp.asarray(x), jnp.asarray(c))
        want = convert.convert_generator_quant(jq)
        assert len(want) == 2 * 4 and "levels.4.down" not in want
        tq.calibrate_quant(pG, [(torch.from_numpy(x), torch.from_numpy(c))])
        got = tq.act_absmaxes(pG)
        assert set(got) == set(want)
        for k in want:
            assert abs(float(got[k]) / float(want[k]) - 1) <= 2e-2, k
        back = convert.convert_generator_quant(
            convert.generator_quant_to_flax(got))
        assert all(float(back[k]) == float(got[k]) for k in got)
        xs, cs = _inputs(size, seed=seed)
        for quant in (None, jq):
            v = jvars if quant is None else {**jvars, "quant": quant}
            if quant is not None:
                tq.set_act_absmaxes(pG, convert.convert_generator_quant(jq))
            ref = np.asarray(apply(v, jnp.asarray(xs), jnp.asarray(cs)))
            d = np.abs(_port(pG, xs, cs) - ref)
            assert d.max() <= 0.05 and d.mean() <= 0.01, (seed, d.max())


@pytest.mark.parametrize("flags", [[], ["--quant_int8"]],
                         ids=["bf16", "int8"])
def test_unet_export_verify(tmp_path, capsys, flags):
    """The export CLI builds a U-Net artifact from the run's structural
    flags, and ``--verify`` holds it against the live model."""
    from pcgan_tpu_torch.tools import export_serving
    from pcgan_tpu_torch.utils.checkpoint import save_generator
    argv = SMALL + ["--netG", "unet_32", "--crop_size", "32", "--dtype",
                    "bfloat16"]
    save_generator(port_define_G(port_parse(argv)), str(tmp_path / "ck"),
                   "run")
    out_dir = str(tmp_path / "srv")
    export_serving.main(["--name", "run", "--checkpoints_dir",
                         str(tmp_path / "ck"), "--netG", "unet_32", "--ngf",
                         "8", "--crop_size", "32", "--n_age_bins", "4",
                         "--calib_batches", "1", "--verify", "--out_dir",
                         out_dir, "--device", "cpu", *flags])
    log = capsys.readouterr().out
    err = float(log.split("verify: max|exported - live| = ")[1].split()[0])
    assert err <= (0.3 if flags else 5e-2)
    if flags:
        ep = torch.export.load(os.path.join(out_dir, "generator.pt2"))
        assert sum(k.endswith("act_absmax") for k in ep.constants) == 8


def test_unet_cli_trains_samples_and_animates(tmp_path):
    """One epoch of unet_32 through ``train_main`` (dropout on), then the
    sampler's grid and a 3-frame ``--anim`` from its checkpoint."""
    from pcgan_tpu_torch import test as port_test
    from pcgan_tpu_torch import train_main
    common = ["--dataset_mode", "synthetic", "--netG", "unet_32", "--ngf",
              "8", "--ndf", "8", "--n_age_bins", "4", "--load_size", "36",
              "--crop_size", "32", "--checkpoints_dir", str(tmp_path),
              "--name", "u", "--device", "cpu"]
    out = train_main.main(common + ["--max_dataset_size", "8",
                                    "--batch_size", "4", "--niter", "1",
                                    "--niter_decay", "0", "--print_freq",
                                    "1", "--no-no_dropout"])
    assert out["step"] == 2 and np.isfinite(out["metrics"]["loss_G"])
    res = port_test.main(common + ["--results_dir", str(tmp_path / "r"),
                                   "--num_test", "2", "--anim", "3"])
    assert res["done"] == 2
    files = os.listdir(os.path.join(res["web_dir"], "images"))
    assert any(f.endswith("_aging.gif") for f in files)
