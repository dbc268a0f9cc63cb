"""The port's discriminator variants, and G and C under ``--norm
batch|group``, against the JAX modules on the same numpy inputs, the JAX
variables carried across by ``convert``: logits and feature taps of a
train forward, the state it writes (spectral norm's u/sigma, batch norm's
running stats), then an eval forward. f32; 1e-5 abs (2e-5 through the
attention's softmax and the generator's depth) + 1e-5 rel on outputs
(batch norm's E[x^2]-E[x]^2 in f32 on both sides), 1e-6 on stored
state. Plus ``define_D``'s errors."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.config import parse_config as jax_parse
from pcgan_tpu.models.registry import define_C as j_define_C
from pcgan_tpu.models.registry import define_D as j_define_D
from pcgan_tpu.models.registry import define_G as j_define_G

from pcgan_tpu_torch.config import parse_config as port_parse
from pcgan_tpu_torch.convert import (convert_comparator_params,
                                     convert_discriminator_params,
                                     convert_generator_params)
from pcgan_tpu_torch.models import define_C, define_D, define_G

from torch_port_levers import one_torch_thread  # noqa: F401

SMALL = ["--crop_size", "32", "--ndf", "8", "--ngf", "8", "--n_age_bins",
         "4", "--netG", "resnet_6blocks", "--dtype", "float32",
         "--cmp_nf", "8", "--cmp_n_down", "3"]


def _inputs(seed=0, b=3):
    rng = np.random.default_rng(seed)
    x = (rng.random((b, 32, 32, 3), np.float32) * 2 - 1)
    c = np.eye(4, dtype=np.float32)[rng.integers(0, 4, b)]
    return x, c


def _split(v):
    return v["params"], {k: x for k, x in v.items() if k != "params"}


def _close(got, want, atol, name=""):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, atol, f"{name}[{i}]")
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=atol, err_msg=name)


def _state_close(net, want_sd, atol=1e-6):
    params = {n for n, _ in net.named_parameters()}
    got = net.state_dict()
    assert set(got) == set(want_sd)
    for k, v in want_sd.items():
        if k not in params:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol,
                                       err_msg=k)


D_CASES = {
    "basic_sn_attn_batch": ["--netD", "basic", "--spectral_norm",
                            "--d_attn", "--norm", "batch"],
    "basic_group": ["--netD", "basic", "--norm", "group"],
    "n_layers2_none": ["--netD", "n_layers", "--n_layers_D", "2",
                       "--norm", "none"],
    "multiscale_sn": ["--netD", "multiscale", "--num_D", "2",
                      "--n_layers_D", "2", "--spectral_norm"],
    "multiscale_attn_group": ["--netD", "multiscale", "--num_D", "2",
                              "--n_layers_D", "2", "--d_attn", "--norm",
                              "group"],
    "pixel_sn_batch": ["--netD", "pixel", "--spectral_norm", "--norm",
                       "batch"],
}


@pytest.mark.parametrize("case", sorted(D_CASES))
def test_discriminator_variant_matches_jax(case):
    argv = SMALL + D_CASES[case]
    Dj = j_define_D(jax_parse(argv))
    x, c = _inputs()
    v = Dj.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x),
                jnp.asarray(c), train=True)
    params, state = _split(v)
    D = define_D(port_parse(argv))
    D.load_state_dict(convert_discriminator_params(params, state))
    atol = 2e-5 if "attn" in case else 1e-5
    x2, c2 = _inputs(1)
    kw = dict(train=True, return_features=True)
    if state:
        (want, wfeats), upd = Dj.apply(v, jnp.asarray(x2), jnp.asarray(c2),
                                       mutable=list(state), **kw)
    else:
        want, wfeats = Dj.apply(v, jnp.asarray(x2), jnp.asarray(c2), **kw)
        upd = state
    got, feats = D(torch.from_numpy(x2), torch.from_numpy(c2),
                   return_features=True)
    _close(got, want, atol, "logits")
    _close(feats, wfeats, atol, "features")
    n_taps = {"pixel": 2}.get(case.split("_")[0],
                              3 if "n_layers" in case or "multi" in case
                              else 4)
    taps = feats[0] if "multi" in case else feats
    assert len(taps) == n_taps
    _state_close(D, convert_discriminator_params(params, upd))
    # eval: batch norm reads its running stats, spectral norm iterates
    # without storing
    want = Dj.apply({"params": params, **upd}, jnp.asarray(x),
                    jnp.asarray(c), train=False)
    before = {k: t.clone() for k, t in D.state_dict().items()}
    _close(D.eval()(torch.from_numpy(x), torch.from_numpy(c)), want, atol,
           "eval")
    for k, t in D.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_define_d_errors():
    with pytest.raises(NotImplementedError, match="PatchGAN lever"):
        define_D(port_parse(SMALL + ["--netD", "pixel", "--d_attn"]))
    with pytest.raises(NotImplementedError, match="--num_D 0"):
        define_D(port_parse(SMALL + ["--netD", "multiscale", "--num_D",
                                     "0"]))
    with pytest.raises(NotImplementedError, match="netD"):
        define_D(port_parse(SMALL + ["--netD", "nope"]))
    # 32 px over two scales of a 3-layer PatchGAN: D_1's map is empty
    D = define_D(port_parse(SMALL + ["--netD", "multiscale"]))
    x, c = _inputs()
    with pytest.raises(ValueError, match="D_1 .* empty 0x0 patch map"):
        D(torch.from_numpy(x), torch.from_numpy(c))


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_generator_norm_matches_jax(norm):
    argv = SMALL + ["--norm", norm, "--cond_inject", "bottleneck"]
    Gj = j_define_G(jax_parse(argv))
    x, c = _inputs(2)
    v = Gj.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x),
                jnp.asarray(c), train=True)
    params, state = _split(v)
    G = define_G(port_parse(argv))
    G.load_state_dict(convert_generator_params(params, state))
    if state:
        want, upd = Gj.apply(v, jnp.asarray(x), jnp.asarray(c), train=True,
                             mutable=list(state))
    else:
        want, upd = Gj.apply(v, jnp.asarray(x), jnp.asarray(c),
                             train=True), state
    _close(G(torch.from_numpy(x), torch.from_numpy(c)), want, 2e-5)
    _state_close(G, convert_generator_params(params, upd))
    want = Gj.apply({"params": params, **upd}, jnp.asarray(x),
                    jnp.asarray(c), train=False)
    _close(G.eval()(torch.from_numpy(x), torch.from_numpy(c)), want, 2e-5)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_comparator_norm_matches_jax(norm):
    argv = SMALL + ["--norm", norm]
    Cj = j_define_C(jax_parse(argv))
    x, _ = _inputs(3, b=4)
    v = Cj.init({"params": jax.random.PRNGKey(3)}, jnp.asarray(x),
                train=True)
    params, state = _split(v)
    C = define_C(port_parse(argv))
    C.load_state_dict(convert_comparator_params(params, state))
    if state:
        (mu, lv), upd = Cj.apply(v, jnp.asarray(x), train=True,
                                 mutable=list(state))
    else:
        (mu, lv), upd = Cj.apply(v, jnp.asarray(x), train=True), state
    got = C(torch.from_numpy(x))
    _close(got[0], mu, 1e-5)
    _close(got[1], lv, 1e-5)
    _state_close(C, convert_comparator_params(params, upd))
    mu, _ = Cj.apply({"params": params, **upd}, jnp.asarray(x), train=False)
    _close(C.eval()(torch.from_numpy(x))[0], mu, 1e-5)


def test_input_injection_warning_still_fires_for_instance_only():
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        define_G(port_parse(SMALL + ["--norm", "batch"]))
