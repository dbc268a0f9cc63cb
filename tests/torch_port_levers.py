"""Shared plumbing of the lever tests (``test_torch_port_lever_*.py``):
config pairs, a JAX state carried into the port, the JAX step's random
draws (augmentation, GP's interpolation) replayed in the port's step, and
the one-step comparison of the two steps."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu import config as jcfg
from pcgan_tpu.models.registry import define_D as j_define_D
from pcgan_tpu.models.registry import define_G as j_define_G
from pcgan_tpu.train import create_train_state as j_create_train_state

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch import train as ttrain
from pcgan_tpu_torch.convert import (convert_discriminator_params,
                                     convert_generator_params,
                                     convert_train_state)
from pcgan_tpu_torch.models import define_D, define_G
from pcgan_tpu_torch.ops import diffaug
from pcgan_tpu_torch.train import create_train_state
from pcgan_tpu_torch.utils.checkpoint import adam_state, load_state

B, S, NB, NF, LR = 2, 32, 4, 8, 2e-4
# golden sizes: 32 px, ngf/ndf 8, resnet_6blocks, 4 bins, f32
BASE = dict(
    data=dict(batch_size=B, crop_size=S, load_size=S, n_age_bins=NB),
    model=dict(netG="resnet_6blocks", netD="basic", ngf=NF, ndf=NF,
               dtype="float32", cond_inject="bottleneck"),
    train=dict(gan_mode="lsgan", lambda_L1=100.0, pool_size=0, lr=LR,
               lr_policy="constant"))


def cfgs(model=None, train=None, data=None):
    """(JAX Config, port Config) at the golden sizes with overrides."""
    kw = {k: {**v, **(o or {})} for (k, v), o in
          zip(BASE.items(), (data, model, train))}

    def build(mod):
        return mod.Config(data=mod.DataConfig(**kw["data"]),
                          model=mod.ModelConfig(**kw["model"]),
                          train=mod.TrainConfig(**kw["train"]))
    return build(jcfg), build(tcfg)


def batches(n, seed=0, b=B):
    rng = np.random.default_rng(seed)
    return [{"image": rng.random((b, S, S, 3), np.float32) * 2 - 1,
             "bin": rng.integers(0, NB, b).astype(np.int32),
             "target_bin": rng.integers(0, NB, b).astype(np.int32)}
            for _ in range(n)]


def jax_models(jc):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return j_define_G(jc), j_define_D(jc)


def jax_state(jc, Gj, Dj, seed=3, vgg_vars=None):
    return j_create_train_state(jc, Gj, Dj, jax.random.PRNGKey(seed), 1000,
                                vgg_vars=vgg_vars)


def port_state(tc, jstate, vgg=None):
    """A port TrainState holding ``jstate`` (G, D and their state, Adam,
    the skip counters, ADA's p, pool, step)."""
    G, D = define_G(tc), define_D(tc)
    state = create_train_state(tc, G, D, torch.Generator().manual_seed(0),
                               vgg=vgg)
    load_state(state, convert_train_state(jax.device_get(jstate)))
    return state


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# --------------------------------------------------------------------------- #
# the JAX step's draws, replayed in the port's step
# --------------------------------------------------------------------------- #


def jax_aug_draws(key, names, shape, ada):
    """``make_diff_augment`` / ``make_ada_augment``'s per-op draws under
    ``key`` (one fold of r_aug) in the port's ``Augment.draw`` layout."""
    b, h, w, _ = shape
    out = []
    for i, n in enumerate(names):
        r = jax.random.fold_in(key, i)
        if n == "color":
            kb, ks, kc = jax.random.split(r, 3)
            d = {"bright": jax.random.uniform(kb, (b,)) - 0.5,
                 "sat": jax.random.uniform(ks, (b,)) * 2.0,
                 "cont": jax.random.uniform(kc, (b,)) + 0.5}
        elif n == "translation":
            s = max(1, int(h * 0.125)), max(1, int(w * 0.125))
            ky, kx = jax.random.split(r)
            d = {"dy": jax.random.randint(ky, (b,), -s[0], s[0] + 1),
                 "dx": jax.random.randint(kx, (b,), -s[1], s[1] + 1)}
        else:
            ch, cw = max(1, int(h * 0.5)), max(1, int(w * 0.5))
            ky, kx = jax.random.split(r)
            d = {"oy": jax.random.randint(ky, (b, 1, 1), -(ch // 2),
                                          h - ch // 2).reshape(b),
                 "ox": jax.random.randint(kx, (b, 1, 1), -(cw // 2),
                                          w - cw // 2).reshape(b)}
        if ada:
            d["u"] = jax.random.uniform(jax.random.fold_in(key, 1000 + i),
                                        (b, 1, 1, 1)).reshape(b)
        out.append({k: torch.from_numpy(np.array(v)) for k, v in d.items()})
    return out


def step_keys(jstate, use_aug):
    """(r_target, r_drop, r_pool, r_gp, r_aug) of the JAX step at
    ``jstate.step``."""
    rng = jax.random.fold_in(jstate.rng, jstate.step)
    if use_aug:
        return jax.random.split(rng, 5)
    return (*jax.random.split(rng, 4), None)


def replay_jax_draws(monkeypatch, jc, jstate, fuse_d=True):
    """Route the port step's augmentation draws and GP weights to the ones
    the JAX step takes at ``jstate``: the D-loss fold(s), GP's two folds,
    then fold 4 (the G pass), in the port's call order."""
    t = jc.train
    names = diffaug.parse_policy(t.diff_augment)
    _, _, _, r_gp, r_aug = step_keys(jstate, bool(names))
    folds = [0] if fuse_d else [0, 1]
    if t.gan_mode == "wgangp":
        folds += [2, 3]
    folds.append(4)
    queue = list(folds)

    def draw(self, generator, x):
        k = queue.pop(0)
        return jax_aug_draws(jax.random.fold_in(r_aug, k), names, x.shape,
                             t.ada_target > 0)

    monkeypatch.setattr(diffaug.Augment, "draw", draw)
    monkeypatch.setattr(ttrain, "gp_eps", lambda g, b: torch.from_numpy(
        np.array(jax.random.uniform(r_gp, (b, 1, 1, 1)))))
    return queue


# --------------------------------------------------------------------------- #
# comparison
# --------------------------------------------------------------------------- #


def assert_close(name, got, want, tol):
    """Every entry within ``tol * max(1, max|want|)`` (NaN == NaN)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), name
    if nan.all():
        return
    scale = max(1.0, float(np.abs(want[~nan]).max()))
    err = float(np.abs(got[~nan] - want[~nan]).max())
    assert err <= tol * scale, (name, err, scale)


def compare_step(jstate, jm, state, tm, mu_tol=1e-4, state_tol=1e-5):
    """The port's step against JAX's from the same state: metrics (same
    keys), Adam's first moments and counts of G and D (the gradients),
    the skip counters, and G's and D's norm and spectral-norm state."""
    assert set(tm) == set(jm), (sorted(tm), sorted(jm))
    for k in jm:
        assert_close(k, float(tm[k]), float(jm[k]), mu_tol)
    for which, opt_j, net, conv in (
            ("G", jstate.g_opt, state.G, convert_generator_params),
            ("D", jstate.d_opt, state.D, convert_discriminator_params)):
        from pcgan_tpu_torch.convert import _adam_moments, _skip_counters
        adam = _adam_moments(opt_j)
        want = conv(adam.mu)
        got = adam_state(state.opt_g if which == "G" else state.opt_d,
                         net)
        assert got["count"] == int(adam.count), which
        for k in want:
            assert_close(f"{which}.mu.{k}", got["mu"][k], want[k], mu_tol)
        skip = _skip_counters(opt_j)
        mine = state.skip_g if which == "G" else state.skip_d
        assert (skip is None) == (mine is None)
        if skip is not None:
            for k in skip:
                assert int(mine[k]) == int(skip[k]), (which, k)
    for which, params, st, net, conv in (
            ("G", jstate.g_params, jstate.g_state, state.G,
             convert_generator_params),
            ("D", jstate.d_params, jstate.d_state, state.D,
             convert_discriminator_params)):
        want = conv(params, st)
        got = net.state_dict()
        names = {n for n, _ in net.named_parameters()}
        assert set(got) == set(want), which
        for k in want:
            if k not in names:
                assert_close(f"{which}.state.{k}", got[k], want[k],
                             state_tol)


# --------------------------------------------------------------------------- #
# the parametrised lockstep
# --------------------------------------------------------------------------- #

LEVERS = {
    "wgangp": dict(train=dict(gan_mode="wgangp")),
    "r1_feat": dict(train=dict(lambda_r1=10.0, lambda_feat=10.0)),
    "multiscale_sn_attn": dict(model=dict(netD="multiscale", num_D=2,
                                          n_layers_D=2, spectral_norm=True,
                                          d_attn=True)),
    "batch_norm": dict(model=dict(norm="batch")),
    "diffaug": dict(train=dict(diff_augment="color,translation,cutout")),
    "ada": dict(train=dict(diff_augment="color,translation,cutout",
                           ada_target=0.6, ada_kimg=0.01)),
    "vgg_random": dict(train=dict(lambda_vgg=10.0, vgg_path="random")),
    "skip_inf": dict(train=dict(skip_nonfinite=3, ema_decay=0.999)),
    "log_grad_norm": dict(train=dict(log_grad_norm=True)),
}


def run_lockstep(case, monkeypatch, n_steps=3):
    """One JAX warm-up step, then ``n_steps`` steps each started from JAX's
    state in both frameworks and compared (``compare_step``). The
    ``skip_inf`` case puts an inf into the second compared step's batch."""
    from pcgan_tpu.train import make_train_step as j_make_train_step
    from pcgan_tpu_torch.train import make_train_step
    jc, tc = cfgs(**LEVERS[case])
    Gj, Dj = jax_models(jc)
    vgg_vars = vgg = None
    if case == "vgg_random":
        from pcgan_tpu.models.vgg import init_vgg_vars
        from pcgan_tpu_torch.convert import convert_vgg16_params
        from pcgan_tpu_torch.models.vgg import VGG19Taps
        vgg_vars = init_vgg_vars(jax.random.PRNGKey(0))
        vgg = VGG19Taps()
        vgg.load_state_dict(convert_vgg16_params(vgg_vars["params"]))
    jstate = jax_state(jc, Gj, Dj, vgg_vars=vgg_vars)
    jstep = jax.jit(j_make_train_step(jc, Gj, Dj, steps_per_epoch=1000))
    bs = batches(n_steps + 1)
    if case == "skip_inf":
        bs[2]["image"][0, 3, 5, 1] = np.inf
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in bs[0].items()})
    for b in bs[1:]:
        state = port_state(tc, jstate, vgg)
        step = make_train_step(tc, state.G, state.D)
        replay_jax_draws(monkeypatch, jc, jstate,
                         fuse_d=jc.model.norm != "batch")
        tm = step(state, torch_batch(b))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        compare_step(jstate, jm, state, tm)
        if jstate.ema_params is not None:
            want = convert_generator_params(jstate.ema_params)
            for k in want:
                assert_close(f"ema.{k}", state.ema[k], want[k], 1e-5)
        if jstate.aug_p is not None:
            assert_close("aug_p", float(state.aug_p), float(jstate.aug_p),
                         1e-6)
    return jstate


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run tiny tensors: one intra-op thread is as fast alone
    and spares the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
