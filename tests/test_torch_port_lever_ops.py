"""The step's new operations against the JAX package on pinned inputs:
the penalties (WGAN-GP, R1: values and their double-backward gradients
for D's parameters), feature matching, ADA's overfitting heuristic, the
multiscale loss averaging, DiffAugment's ops and ADA's gating on the JAX
draws, and the VGG19 perceptual loss (the JAX package's random trunk
carried across; ``--vgg_path`` as ``.pth`` and ``.npz``). f32: 1e-6 on
augmentations, 1e-5 relative on losses and gradients."""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.config import parse_config as jax_parse
from pcgan_tpu.models import vgg as jvgg
from pcgan_tpu.models.registry import define_D as j_define_D
from pcgan_tpu.ops import diffaug as jaug
from pcgan_tpu.ops import gan_loss as J

from pcgan_tpu_torch.config import parse_config as port_parse
from pcgan_tpu_torch.convert import (convert_discriminator_params,
                                     convert_vgg16_params)
from pcgan_tpu_torch.models import define_D, define_G
from pcgan_tpu_torch.models import vgg as tvgg
from pcgan_tpu_torch.ops import diffaug as taug
from pcgan_tpu_torch.ops import gan_loss as T

from torch_port_levers import one_torch_thread, jax_aug_draws  # noqa: F401

SMALL = ["--crop_size", "32", "--ndf", "8", "--n_age_bins", "4",
         "--dtype", "float32"]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _rel(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _d_pair(extra):
    argv = SMALL + extra
    Dj = j_define_D(jax_parse(argv))
    x = _rand((2, 32, 32, 3), 0)
    c = np.eye(4, dtype=np.float32)[[1, 3]]
    v = Dj.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                jnp.asarray(c), train=True)
    D = define_D(port_parse(argv))
    D.load_state_dict(convert_discriminator_params(v["params"]))
    return Dj, v["params"], D, c


@pytest.mark.parametrize("netd", [["--netD", "basic"],
                                  ["--netD", "multiscale", "--n_layers_D",
                                   "2"]])
def test_penalties_and_their_gradients_match_jax(netd):
    Dj, params, D, c = _d_pair(netd)
    real, fake = _rand((2, 32, 32, 3), 1), _rand((2, 32, 32, 3), 2)
    key = jax.random.PRNGKey(7)

    def d_apply(v, x, cond):
        return Dj.apply(v, x, cond, train=True)

    def gp_j(p):
        return J.gradient_penalty(d_apply, {"params": p}, jnp.asarray(real),
                                  jnp.asarray(fake), jnp.asarray(c), key)

    def r1_j(p):
        return J.r1_penalty(d_apply, {"params": p}, jnp.asarray(real),
                            jnp.asarray(c))

    eps = torch.from_numpy(np.array(jax.random.uniform(key, (2, 1, 1, 1))))
    params_t = list(D.parameters())
    names = [n for n, _ in D.named_parameters()]
    for fj, ft in ((gp_j, lambda: T.gradient_penalty(
            D, torch.from_numpy(real), torch.from_numpy(fake),
            torch.from_numpy(c), eps)),
                   (r1_j, lambda: T.r1_penalty(D, torch.from_numpy(real),
                                               torch.from_numpy(c)))):
        val, grads = jax.value_and_grad(fj)(params)
        got = ft()
        _rel(float(got.detach()), float(val))
        want = convert_discriminator_params(grads)
        # the last conv's bias never reaches an input gradient: unused
        for n, g, p in zip(names, torch.autograd.grad(
                got, params_t, allow_unused=True), params_t):
            g = torch.zeros_like(p) if g is None else g
            _rel(g.numpy(), want[n].numpy(), 1e-4)


def test_gan_loss_multiscale_and_heuristic_match_jax():
    maps = (_rand((2, 6, 6, 1), 3, 2), _rand((2, 2, 2, 1), 4, 2))
    tm = tuple(torch.from_numpy(m) for m in maps)
    jm = tuple(jnp.asarray(m) for m in maps)
    for mode in T.PORTED_MODES:
        for real in (True, False):
            _rel(float(T.gan_loss(tm, real, mode)),
                 float(J.gan_loss(jm, real, mode)))
    for mode in ("lsgan", "vanilla"):
        _rel(float(T.overfit_heuristic(tm, mode)),
             float(J.overfit_heuristic(jm, mode)))
        _rel(float(T.overfit_heuristic(tm[0], mode)),
             float(J.overfit_heuristic(jm[0], mode)))
    a, b = T.split_pred(tuple(torch.cat([m, m + 1]) for m in tm), 2)
    assert all(torch.equal(x, m) for x, m in zip(a, tm))
    assert all(torch.equal(x, m + 1) for x, m in zip(b, tm))


def test_feature_matching_matches_jax():
    one = [_rand((2, 8, 8, 4), i) for i in range(3)]
    two = [_rand((2, 8, 8, 4), 10 + i) for i in range(3)]
    for f, r in ((one, two),
                 ((one, one[:2]), (two, two[:2]))):      # multiscale nesting
        def conv(xs, fn):
            return tuple(conv(x, fn) if isinstance(x, (list, tuple))
                         else fn(x) for x in xs)
        want = J.feature_matching_loss(conv(f, jnp.asarray),
                                       conv(r, jnp.asarray))
        got = T.feature_matching_loss(conv(f, torch.from_numpy),
                                      conv(r, torch.from_numpy))
        _rel(float(got), float(want))


@pytest.mark.parametrize("name", taug.POLICIES)
def test_each_augmentation_on_pinned_draws(name):
    x = _rand((3, 32, 32, 3), 5)
    key = jax.random.PRNGKey(11)
    want = jaug._FNS[name](jax.random.fold_in(key, 0), jnp.asarray(x))
    (draw,) = jax_aug_draws(key, [name], x.shape, ada=False)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = taug._APPLY[name](xt, draw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    # differentiable in x: the pullback of a fixed cotangent
    w = _rand(x.shape, 6)
    gj = jax.grad(lambda a: jnp.sum(jaug._FNS[name](
        jax.random.fold_in(key, 0), a) * w))(jnp.asarray(x))
    (gt,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5)


def test_policy_chain_and_ada_gating_match_jax():
    policy = "color,translation,cutout"
    names = taug.parse_policy(policy)
    x = _rand((4, 32, 32, 3), 8)
    key = jax.random.PRNGKey(12)
    xt = torch.from_numpy(x)
    always = taug.Augment(policy)
    want = jaug.make_diff_augment(policy)(key, jnp.asarray(x))
    got = always.apply(xt, jax_aug_draws(key, names, x.shape, False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    ada = taug.Augment(policy, ada=True)
    draws = jax_aug_draws(key, names, x.shape, True)
    for p in (0.0, 0.5, 1.0):
        want = jaug.make_ada_augment(policy)(key, jnp.asarray(x),
                                             jnp.float32(p))
        got = ada.apply(xt, draws, torch.tensor(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert torch.equal(ada.apply(xt, draws, 0.0), xt)
    assert torch.equal(ada.apply(xt, draws, 1.0), always.apply(xt, draws))
    # drawn from a torch generator: reproducible, and shaped per op
    a, b = (always.apply(xt, always.draw(torch.Generator().manual_seed(3),
                                         xt)) for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, xt)
    assert not taug.Augment(" , ")
    with pytest.raises(ValueError, match="unknown policy"):
        taug.parse_policy("color,zoom")
    with pytest.raises(ValueError, match="non-empty"):
        taug.Augment("", ada=True)


@pytest.fixture(scope="module")
def vgg_pair():
    v = jvgg.init_vgg_vars(jax.random.PRNGKey(0))
    net = tvgg.VGG19Taps()
    net.load_state_dict(convert_vgg16_params(v["params"]))
    return v, net.eval().requires_grad_(False)


def test_vgg19_taps_and_perceptual_loss_match_jax(vgg_pair):
    v, net = vgg_pair
    x, y = _rand((2, 32, 32, 3), 20, 0.5), _rand((2, 32, 32, 3), 21, 0.5)
    for a, b in zip(net(torch.from_numpy(x)), jvgg.vgg_taps(v, jnp.asarray(x))):
        _rel(a.numpy(), np.asarray(b))
    want, gj = jax.value_and_grad(
        lambda a: jvgg.vgg_perceptual_loss(v, a, jnp.asarray(y)))(
            jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tvgg.vgg_perceptual_loss(net, xt, torch.from_numpy(y))
    _rel(float(got.detach()), float(want))
    (gt,) = torch.autograd.grad(got, xt)
    gj, gt = np.asarray(gj), gt.numpy()
    # one pre-activation of conv4_4 (the last conv before relu5_1's pool)
    # sits 1.5e-8 from the relu's kink, so f32 noise takes its other
    # branch in one framework: the whole loss's input gradient agrees
    # within 1e-2 in norm, and each tap above that conv entrywise within
    # 1e-4 of its max
    assert np.linalg.norm(gt - gj) <= 1e-2 * np.linalg.norm(gj)
    for i in range(4):
        def tap_loss_j(a):
            t = jvgg.vgg_taps(v, jnp.concatenate([a, jnp.asarray(y)]))[i]
            return jnp.mean(jnp.abs(t[:2] - jax.lax.stop_gradient(t[2:])))
        gj = np.asarray(jax.grad(tap_loss_j)(jnp.asarray(x)))
        t = net(torch.cat([xt, torch.from_numpy(y)]))[i]
        (gt,) = torch.autograd.grad((t[:2] - t[2:].detach()).abs().mean(),
                                    xt)
        assert np.abs(gt.numpy() - gj).max() <= 1e-4 * np.abs(gj).max(), i


def test_vgg_path_pth_and_npz(tmp_path, vgg_pair):
    from flax.traverse_util import flatten_dict
    v, net = vgg_pair
    sd = net.state_dict()
    pth = tmp_path / "vgg19.pth"
    # a torchvision vgg19 state dict carries the classifier too
    torch.save({**sd, "classifier.0.weight": torch.zeros(2, 2)}, pth)
    npz_t, npz_f = tmp_path / "t.npz", tmp_path / "f.npz"
    np.savez(npz_t, **{k: t.numpy() for k, t in sd.items()})
    np.savez(npz_f, **{k: np.asarray(a) for k, a in
                       flatten_dict(v["params"], sep="/").items()})
    for path in (pth, npz_t, npz_f):
        got = tvgg.load_vgg19(str(path)).state_dict()
        assert all(torch.equal(got[k], sd[k]) for k in sd), path
    bad = tmp_path / "vgg16.pth"
    torch.save(tvgg.VGG16Taps().state_dict(), bad)
    with pytest.raises((KeyError, ValueError)):
        tvgg.load_vgg19(str(bad))
    r = tvgg.random_vgg19(0)
    assert torch.equal(r.features["28"].weight,
                       tvgg.random_vgg19(0).features["28"].weight)


@pytest.mark.parametrize("train", [
    {"ada_target": 0.6},
    {"ada_target": 0.6, "diff_augment": "color", "gan_mode": "wgangp"}])
def test_ada_errors_match_jax(train):
    from pcgan_tpu.train import make_train_step as j_make_train_step
    from pcgan_tpu_torch.train import make_train_step
    from torch_port_levers import cfgs, jax_models
    jc, tc = cfgs(train=train)
    Gj, Dj = jax_models(jc)
    with pytest.raises(ValueError) as want:
        j_make_train_step(jc, Gj, Dj)
    with pytest.raises(ValueError) as got:
        make_train_step(tc, define_G(tc), define_D(tc))
    assert str(got.value) == str(want.value)
