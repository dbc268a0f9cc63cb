"""The port's comparator pretraining step, and its GAN step with the frozen
comparator, against ``pcgan_tpu.train`` in lockstep.

JAX draws the weights (and the Adam states); they are carried into the
port with ``convert.convert_comparator_state`` / ``convert_train_state``
and ``convert_comparator_params``; the same numpy batches go through both
steps for three steps in f32 (JAX at ``Precision.HIGHEST``, torch on the
CPU). The frameworks' RNG streams never match, so the GAN steps pin
``target_bin`` (onehot) or ``target_score`` (score mode) and run with
``pool_size 0``. Tolerances are those of
``tests/test_torch_port_train_step.py``: every loss within 1e-4 abs +
1e-4 rel at every step; updated parameters within the Adam first-step
envelope (an entry whose true gradient is ~0 turns f32 noise into an update
of up to +-lr, so the bulk must match tightly and the worst entry is bounded
by the sign-flip envelope). The frozen comparator must come out bit for bit
as it went in.

Two things make a GAN trajectory in f32 depend on the seed, and the GAN
test takes both out, so that it holds on any seed:
- Adam's first step moves every entry by +-lr on its gradient's sign, so a
  D entry whose gradient cancels to f32 noise moves by opposite +-lr in
  the two frameworks, and carried on, one such flip moves a later G loss
  by up to ~2e-3. JAX therefore takes one warm-up step before the lockstep
  (its moments then scale every update continuously), and each lockstep
  step starts from JAX's state, loaded into the port.
- A ReLU input of G within f32 noise of zero takes its slope from that
  noise, and the one element moves every G gradient upstream of it by up
  to ~1e-1 of the tensor's largest entry. Over seeds 0-11 (72 steps) the
  three gradients that missed 1e-4 were all at a G ReLU input below 1e-6
  (six steps had one); the rest stayed within 7.5e-5. The gradient check
  skips such a step; its losses and parameters are still checked.
Each step's losses must then agree within 1e-4 abs + 1e-4 rel; its G and D
gradients, read through the first moments (``mu' = b1 mu + (1 - b1) g``
import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
from the same ``mu``, so before Adam takes their sign), within 1e-4 of
each tensor's largest entry; its parameters within the one-step envelope.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pcgan_tpu import config as jcfg
from pcgan_tpu.models.registry import define_C as j_define_C
from pcgan_tpu.models.registry import define_D as j_define_D
from pcgan_tpu.models.registry import define_G as j_define_G
from pcgan_tpu.models.registry import init_params
from pcgan_tpu.train import compute_bin_anchors as j_bin_anchors
from pcgan_tpu.train import create_comparator_state as j_create_cmp_state
from pcgan_tpu.train import create_train_state as j_create_train_state
from pcgan_tpu.train import make_comparator_step as j_make_cmp_step
from pcgan_tpu.train import make_train_step as j_make_train_step

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch.convert import (convert_comparator_params,
                                     convert_comparator_state,
                                     convert_train_state)
from pcgan_tpu_torch.models import define_C, define_D, define_G
from pcgan_tpu_torch.train import (create_comparator_state, create_train_state,
                                   make_comparator_step, make_train_step)
from pcgan_tpu_torch.utils.checkpoint import (adam_state,
                                              load_comparator_state,
                                              load_state)

B, S, NB, NF, LR, STEPS = 2, 32, 4, 8, 2e-4, 3
GAN_SEEDS = (0, 1, 2)
KINK = 1e-6      # |ReLU input| below which f32 noise may pick the slope


def _cfgs(cond_mode="onehot", **train):
    kw = dict(
        data=dict(batch_size=B, crop_size=S, load_size=S, n_age_bins=NB),
        model=dict(netG="resnet_6blocks", netD="basic", ngf=NF, ndf=NF,
                   dtype="float32", cond_inject="bottleneck",
                   cond_mode=cond_mode, cmp_nf=NF, cmp_n_down=3),
        train=dict(gan_mode="lsgan", lambda_L1=100.0, pool_size=0, lr=LR,
                   lr_policy="constant", **train))

    def build(mod):
        return mod.Config(data=mod.DataConfig(**kw["data"]),
                          model=mod.ModelConfig(**kw["model"]),
                          train=mod.TrainConfig(**kw["train"]))
    return build(jcfg), build(tcfg)


def _assert_adam_envelope(name, dj, dt, n_steps):
    diff = np.abs(dj - dt)
    assert np.median(diff) < 2e-6, (name, np.median(diff))
    assert diff.max() <= 2.1 * n_steps * LR, (name, diff.max())
    assert float((diff > 0.25 * LR).mean()) < 2e-3, name


def _assert_losses(i, jm, tm):
    assert set(tm) == set(jm)
    for k in jm:
        jv, tv = float(jm[k]), float(tm[k])
        assert abs(jv - tv) <= 1e-4 + 1e-4 * abs(jv), (i, k, jv, tv)


def _images(rng, n=B):
    return rng.random((n, S, S, 3), np.float32) * 2 - 1


def test_comparator_three_step_lockstep():
    jc, tc = _cfgs()
    jC = j_define_C(jc)
    jstate = j_create_cmp_state(jc, jC, jax.random.PRNGKey(3), 1000)
    C = define_C(tc)
    state = create_comparator_state(tc, C, torch.Generator().manual_seed(0))
    load_comparator_state(state, convert_comparator_state(jstate))
    c0 = convert_comparator_params(jstate.params)
    jstep = jax.jit(j_make_cmp_step(jc, jC, 1000))
    step = make_comparator_step(tc, C)
    rng = np.random.default_rng(0)
    for i in range(STEPS):
        b = {"image_a": _images(rng, 4), "image_b": _images(rng, 4),
             "label": rng.integers(0, 3, 4).astype(np.int32)}
        with jax.default_matmul_precision("highest"):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        tm = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        _assert_losses(i, jm, tm)
    assert state.step == int(jstate.step) == STEPS
    c1 = convert_comparator_params(jstate.params)
    t1 = C.state_dict()
    assert set(t1) == set(c1)
    for k in c1:
        dj, dt = (c1[k] - c0[k]).numpy(), (t1[k] - c0[k]).numpy()
        if k == "head.bias":
            # mu's bias: the likelihood sees only score differences, so its
            # gradient is zero analytically and each step moves it by +-lr
            # on the sign of f32 noise; only the sign-flip bound applies
            assert abs(dj[0] - dt[0]) <= 2.1 * STEPS * LR
            dj, dt = dj[1:], dt[1:]
        _assert_adam_envelope(f"C.{k}", dj, dt, STEPS)
    assert adam_state(state.opt, C)["count"] == STEPS


def _frozen_comparator(jc, images):
    """JAX C variables (Dense kernels 20x their init, so the scores are
    O(1) and the anchors spread) and anchors fitted on ``images``."""
    jC = j_define_C(jc)
    variables = init_params(jC, jax.random.PRNGKey(11),
                            jnp.zeros((1, S, S, 3)))
    params = {k: {n: a * 20.0 if k.startswith("Dense") and a.ndim == 2
                  else a for n, a in v.items()}
              for k, v in variables["params"].items()}
    c_vars = {"params": params}
    with jax.default_matmul_precision("highest"):
        anchors = j_bin_anchors(jC, c_vars, jnp.asarray(images),
                                jnp.arange(len(images)) % NB, NB)
    return jC, c_vars, anchors


def _assert_grads(name, mu0, mu_j, mu_t, b1):
    """The step's gradients from the first moments each Adam left, both from
    the same ``mu0``: within 1e-4 of the largest entry of JAX's."""
    for k in mu_j:
        gj = (mu_j[k] - b1 * mu0[k]).numpy() / (1 - b1)
        diff = (mu_j[k] - mu_t[k]).abs().numpy() / (1 - b1)
        assert diff.max() <= 1e-4 * np.abs(gj).max(), (
            f"{name}.{k}", diff.max(), np.abs(gj).max())


@pytest.fixture
def relu_margins(monkeypatch):
    """The smallest |input| of every ReLU the port runs (G's), in call
    order; the test clears the list."""
    seen = []
    relu = F.relu

    def wrapped(x, *args, **kwargs):
        seen.append(float(x.detach().abs().min()))
        return relu(x, *args, **kwargs)
    monkeypatch.setattr(F, "relu", wrapped)
    return seen


@pytest.mark.parametrize("cond_mode", ["onehot", "score"])
def test_gan_step_with_comparator_three_step_lockstep(cond_mode,
                                                      relu_margins):
    jc, tc = _cfgs(cond_mode, lambda_cond=5.0)
    jC, c_vars, anchors = _frozen_comparator(
        jc, _images(np.random.default_rng(1), 8))
    Gj, Dj = j_define_G(jc), j_define_D(jc)
    jstep = jax.jit(j_make_train_step(jc, Gj, Dj, C=jC, steps_per_epoch=1000))
    C = define_C(tc)
    C.load_state_dict(convert_comparator_params(c_vars))
    C0 = {k: v.clone() for k, v in C.state_dict().items()}
    b1 = tc.train.beta1

    checked = 0
    for seed in GAN_SEEDS:
        jstate = j_create_train_state(jc, Gj, Dj, jax.random.PRNGKey(seed),
                                      1000, c_vars=c_vars,
                                      bin_anchors=anchors)
        state = create_train_state(
            tc, define_G(tc), define_D(tc), torch.Generator().manual_seed(0),
            C=C, bin_anchors=[np.array(a) for a in anchors])
        step = make_train_step(tc, state.G, state.D, state.C)
        rng = np.random.default_rng(seed)
        for i in range(-1, STEPS):
            b = {"image": _images(rng), "bin": rng.integers(0, NB, B)}
            if cond_mode == "score":
                b["target_score"] = rng.uniform(-1, 1, B).astype(np.float32)
            else:
                b["target_bin"] = rng.integers(0, NB, B)
            if i < 0:                          # JAX's warm-up step
                with jax.default_matmul_precision("highest"):
                    jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                               for k, v in b.items()})
                continue
            s0 = convert_train_state(jstate)
            load_state(state, s0)              # both start from JAX's state
            with jax.default_matmul_precision("highest"):
                jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()})
            relu_margins.clear()
            tm = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            _assert_losses((seed, i), jm, tm)
            assert float(tm["loss_G_cond"]) != 0.0
            smooth = min(relu_margins) > KINK
            checked += smooth
            s1 = convert_train_state(jstate)
            for name, net, opt in (("G", state.G, state.opt_g),
                                   ("D", state.D, state.opt_d)):
                key = f"opt_{name.lower()}"
                if smooth:
                    _assert_grads(f"{seed}.{i}.{name}", s0[key]["mu"],
                                  s1[key]["mu"], adam_state(opt, net)["mu"],
                                  b1)
                t1 = net.state_dict()
                for k in s1[name]:
                    _assert_adam_envelope(f"{seed}.{i}.{name}.{k}",
                                          (s1[name][k] - s0[name][k]).numpy(),
                                          (t1[k] - s0[name][k]).numpy(), 1)
        assert state.step == int(jstate.step) == STEPS + 1
    assert checked > len(GAN_SEEDS) * STEPS // 2     # most steps
    # the comparator stayed frozen: same bits, outside autograd
    assert state.C is C
    for k, v in C.state_dict().items():
        assert torch.equal(v, C0[k]), k
    assert all(not p.requires_grad and p.grad is None
               for p in C.parameters())


def test_cond_loss_reaches_g_through_the_comparator():
    """With lambda_cond the G update differs from the one without it, while
    D's update (which never sees the cond loss) is the same."""
    _, tc = _cfgs(lambda_cond=5.0)
    _, tc0 = _cfgs(lambda_cond=0.0)
    rng = np.random.default_rng(2)
    jc, _ = _cfgs()
    _, c_vars, anchors = _frozen_comparator(jc, _images(rng, 8))
    b = {"image": torch.from_numpy(_images(rng)),
         "bin": torch.from_numpy(rng.integers(0, NB, B)),
         "target_bin": torch.from_numpy(rng.integers(0, NB, B))}
    nets = {}
    for name, cfg in (("cond", tc), ("plain", tc0)):
        C = define_C(cfg)
        C.load_state_dict(convert_comparator_params(c_vars))
        state = create_train_state(
            cfg, define_G(cfg, torch.Generator().manual_seed(1)),
            define_D(cfg, torch.Generator().manual_seed(2)),
            torch.Generator().manual_seed(0), C=C,
            bin_anchors=[np.array(a) for a in anchors])
        m = make_train_step(cfg, state.G, state.D, state.C)(state, b)
        nets[name] = (m, state.G.state_dict(), state.D.state_dict())
    (mc, gc, dc), (mp, gp, dp) = nets["cond"], nets["plain"]
    assert float(mc["loss_G_cond"]) != 0.0 and float(mp["loss_G_cond"]) == 0.0
    assert all(torch.equal(dc[k], dp[k]) for k in dc)
    assert any(not torch.equal(gc[k], gp[k]) for k in gc)
