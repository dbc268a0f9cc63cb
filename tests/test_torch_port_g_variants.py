"""The resnet generator's variants and the JAX package's bf16 routes in the
port's G, against the JAX package (CPU).

- ``@resize_conv`` and ``--g_attn`` (non-zero gamma) forwards in f32 within
  1e-4, a 3-step train-step lockstep as ``tests/torch_port_levers.py``
  states it, the converter, and an exported ``--g_attn`` artifact.
The layers themselves, and the bf16 resnet G's routes, are held in
``test_torch_port_s2d.py``. Sizes: ngf 8, 4 bins, 32 px.
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
from pcgan_tpu_torch.ops import lowch_conv as tlc
import torch_port_levers as lv
from torch_port_levers import one_torch_thread  # noqa: F401

SMALL = ["--crop_size", "32", "--load_size", "36", "--ngf", "8",
         "--n_age_bins", "4"]


def _pair(argv, seed=0, gamma=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jG = jax_define_G(jax_parse(argv, is_train=False))
        pG = port_define_G(port_parse(argv, is_train=False))
    jv = init_params(jG, jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)),
                     jnp.zeros((1, 4)), train=False)
    if gamma is not None:
        params = jax.tree_util.tree_map(lambda a: a, jv["params"])
        params["attn"]["gamma"] = jnp.float32(gamma)
        jv = {**jv, "params": params}
    pG.load_state_dict(convert.convert_generator_params(jv["params"]))
    return jG, jv, pG.eval()


@pytest.mark.parametrize("netG,flags", [
    ("resnet_6blocks@resize_conv", []),
    ("resnet_6blocks", ["--g_attn"]),
    ("resnet_9blocks@resize_conv", ["--g_attn", "--norm", "group"]),
    ("resnet_6blocks@anything", ["--cond_inject", "input"])])
def test_generator_variants_f32_match_jax(netG, flags):
    """Any ``@variant`` but ``deconv`` selects the resize conv, as the JAX
    registry does; the attention runs with a non-zero gamma."""
    argv = SMALL + ["--netG", netG, "--dtype", "float32",
                    "--cond_inject", "bottleneck"] + flags
    jG, jv, pG = _pair(argv, seed=4,
                       gamma=0.75 if "--g_attn" in flags else None)
    assert all(type(m).__name__ == "ResizeConv" for m in pG.up) == (
        "@" in netG)
    assert (pG.attn is not None) == ("--g_attn" in flags)
    if pG.attn is not None:
        assert pG.attn.gamma.item() == 0.75
        assert pG.attn_after == len(pG.blocks) // 2 - 1
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[[1, 2]]
    want = np.asarray(jG.apply(jv, jnp.asarray(x), jnp.asarray(c),
                               train=False))
    with torch.no_grad():
        got = pG(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_convert_consumes_every_variant_leaf():
    """``ResizeConv_k/TorchConv_0``, ``attn/{theta,phi,g,o}`` and
    ``attn/gamma`` each find their place; a foreign attention leaf
    raises."""
    from flax.traverse_util import flatten_dict
    argv = SMALL + ["--netG", "resnet_6blocks@resize_conv", "--g_attn",
                    "--dtype", "float32"]
    _, jv, pG = _pair(argv)
    flat = flatten_dict(jv["params"], sep="/")
    sd = convert.convert_generator_params(jv["params"])
    assert len(sd) == len(flat) and set(sd) == set(pG.state_dict())
    for k in ("attn.gamma", "attn.o.weight", "up.1.conv.weight", "tail.bias"):
        assert k in sd
    with pytest.raises(ValueError, match="no place"):
        convert.convert_generator_params({**flat, "attn/q/kernel":
                                          np.zeros((1, 1, 2, 2))})


def test_resize_conv_g_attn_three_step_lockstep(monkeypatch):
    """``resnet_6blocks@resize_conv --g_attn``: the port's step against
    ``make_train_step`` (tolerances of ``torch_port_levers.compare_step``)."""
    from pcgan_tpu.train import make_train_step as j_make_train_step
    from pcgan_tpu_torch.train import make_train_step
    jc, tc = lv.cfgs(model=dict(netG="resnet_6blocks@resize_conv",
                                g_attn=True))
    Gj, Dj = lv.jax_models(jc)
    jstate = lv.jax_state(jc, Gj, Dj)
    jstep = jax.jit(j_make_train_step(jc, Gj, Dj, steps_per_epoch=1000))
    bs = lv.batches(4, seed=1)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in bs[0].items()})
    for b in bs[1:]:
        state = lv.port_state(tc, jstate)
        tm = make_train_step(tc, state.G, state.D)(state, lv.torch_batch(b))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        lv.compare_step(jstate, jm, state, tm)
    # gamma moved off zero: the attention's gradient flowed
    assert float(jstate.g_params["attn"]["gamma"]) != 0.0


def test_g_attn_export_verify_and_bf16_routes_in_the_artifact(
        tmp_path, capsys, monkeypatch):
    """A ``--g_attn`` run exports (bf16, the default) and verifies against
    the live G; the export traces the stem's separated condition and the
    s2d tail into the program, as the JAX artifact carries them."""
    from pcgan_tpu_torch.tools import export_serving
    from pcgan_tpu_torch.utils.checkpoint import save_generator
    argv = SMALL + ["--netG", "resnet_6blocks", "--g_attn", "--cond_inject",
                    "bottleneck", "--dtype", "bfloat16"]
    G = port_define_G(port_parse(argv))
    with torch.no_grad():
        G.attn.gamma.fill_(0.5)
    save_generator(G, str(tmp_path / "ck"), "run")
    calls = []
    real = tlc.s2d_conv_nchw
    monkeypatch.setattr(tlc, "s2d_conv_nchw",
                        lambda *a: calls.append(1) or real(*a))
    out_dir = str(tmp_path / "srv")
    export_serving.main(["--name", "run", "--checkpoints_dir",
                         str(tmp_path / "ck"), "--netG", "resnet_6blocks",
                         "--g_attn", "--ngf", "8", "--cond_inject",
                         "bottleneck", "--crop_size", "32", "--n_age_bins",
                         "4", "--verify", "--out_dir", out_dir, "--device",
                         "cpu"])
    assert calls                        # traced into the program
    log = capsys.readouterr().out
    err = float(log.split("verify: max|exported - live| = ")[1].split()[0])
    assert err <= 5e-2
    assert os.path.isfile(os.path.join(out_dir, "generator.pt2"))


def test_define_g_builds_every_jax_netg():
    """Every ``--netG`` string the JAX registry accepts builds here: the
    family and the upsampling follow the same parse."""
    for name, cls, up in (("resnet_9blocks", "ResnetGenerator",
                           "TorchConvTranspose"),
                          ("resnet_6blocks@deconv", "ResnetGenerator",
                           "TorchConvTranspose"),
                          ("resnet_9blocks@resize_conv", "ResnetGenerator",
                           "ResizeConv"),
                          ("unet_128", "UnetGenerator", None),
                          ("unet_256@resize_conv", "UnetGenerator", None)):
        G = port_define_G(port_parse(SMALL + ["--netG", name,
                                              "--cond_inject", "bottleneck"]))
        assert type(G).__name__ == cls, name
        if up:
            assert type(G.up[0]).__name__ == up, name
    for bad in ("resnet_7blocks", "vgg"):
        with pytest.raises(NotImplementedError, match="not implemented"):
            port_define_G(port_parse(SMALL + ["--netG", bad]))
