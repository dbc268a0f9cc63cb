"""The port's fused G/D step against ``pcgan_tpu.train.make_train_step``.

The JAX state (G, D, both Adam states) is carried into the port with
``convert.convert_train_state``; the same numpy batches (target bins
pinned, pool off) go through both steps in lockstep for three steps in f32
(JAX at ``Precision.HIGHEST``, torch on the CPU). Losses must agree within
1e-4 abs + 1e-4 rel at every step. Updated parameters are compared tensor
by tensor within the Adam first-step envelope of
``tests/test_torch_step_parity.py``: an entry whose true gradient is ~0
turns f32 noise into an update of up to +-lr, so the bulk must match
tightly and the worst entry is bounded by the sign-flip envelope.
"""

import dataclasses
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
from pcgan_tpu.train import make_train_step as j_make_train_step

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch.convert import (convert_discriminator_params,
                                     convert_generator_params,
                                     convert_train_state)
from pcgan_tpu_torch.models import define_D, define_G
from pcgan_tpu_torch.train import (adam_step, create_train_state, make_adam,
                                   make_lr_schedule, make_train_step)
from pcgan_tpu_torch.utils.checkpoint import adam_state, load_state

from torch_port_levers import one_torch_thread  # noqa: F401

B, S, NB, NF, LR, STEPS = 2, 32, 4, 8, 2e-4, 3


def _cfgs(cond_inject, **train):
    kw = dict(
        data=dict(batch_size=B, crop_size=S, load_size=S, n_age_bins=NB),
        model=dict(netG="resnet_6blocks", netD="basic", ngf=NF, ndf=NF,
                   dtype="float32", cond_inject=cond_inject),
        train=dict(gan_mode="lsgan", lambda_L1=100.0, pool_size=0, lr=LR,
                   lr_policy="constant", **train))

    def build(mod):
        return mod.Config(data=mod.DataConfig(**kw["data"]),
                          model=mod.ModelConfig(**kw["model"]),
                          train=mod.TrainConfig(**kw["train"]))
    return build(jcfg), build(tcfg)


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.random((B, S, S, 3), np.float32) * 2 - 1,
             "bin": rng.integers(0, NB, B).astype(np.int32),
             "target_bin": rng.integers(0, NB, B).astype(np.int32)}
            for _ in range(STEPS)]


def _port_state(tc, jstate):
    G, D = define_G(tc), define_D(tc)
    state = create_train_state(tc, G, D, torch.Generator().manual_seed(0))
    load_state(state, convert_train_state(jstate))
    return state


def _assert_adam_envelope(name, dj, dt, n_steps):
    diff = np.abs(dj - dt)
    assert np.median(diff) < 2e-6, (name, np.median(diff))
    assert diff.max() <= 2.1 * n_steps * LR, (name, diff.max())
    assert float((diff > 0.25 * LR).mean()) < 2e-3, name


@pytest.mark.parametrize("cond_inject", ["input", "bottleneck"])
def test_three_step_lockstep(cond_inject):
    jc, tc = _cfgs(cond_inject)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # input injection
        Gj, Dj = j_define_G(jc), j_define_D(jc)
        state = _port_state(tc, jstate := j_create_train_state(
            jc, Gj, Dj, jax.random.PRNGKey(3), 1000))
    jstep = jax.jit(j_make_train_step(jc, Gj, Dj, steps_per_epoch=1000))
    step = make_train_step(tc, state.G, state.D)
    g0 = convert_generator_params(jstate.g_params)
    d0 = convert_discriminator_params(jstate.d_params)

    for i, b in enumerate(_batches()):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tm = step(state, {"image": torch.from_numpy(b["image"]),
                          "bin": torch.from_numpy(b["bin"]),
                          "target_bin": torch.from_numpy(b["target_bin"])})
        assert set(tm) == set(jm)
        for k in jm:
            jv, tv = float(jm[k]), float(tm[k])
            assert abs(jv - tv) <= 1e-4 + 1e-4 * abs(jv), (i, k, jv, tv)
    assert state.step == int(jstate.step) == STEPS

    for name, j0, j1, net in (
            ("G", g0, convert_generator_params(jstate.g_params), state.G),
            ("D", d0, convert_discriminator_params(jstate.d_params),
             state.D)):
        t1 = net.state_dict()
        assert set(t1) == set(j1)
        for k in j1:
            dj, dt = (j1[k] - j0[k]).numpy(), (t1[k] - j0[k]).numpy()
            if cond_inject == "input" and f"{name}.{k}" == "G.stem.weight":
                # the stem's condition channels: their gradient is zero
                # analytically (the stem's instance norm cancels a constant
                # map), so each step moves them by +-lr on the sign of f32
                # noise; only the sign-flip bound applies to them
                assert np.abs(dj[:, 3:] - dt[:, 3:]).max() <= 2.1 * STEPS * LR
                dj, dt = dj[:, :3], dt[:, :3]
            _assert_adam_envelope(f"{name}.{k}", dj, dt, STEPS)
    # the optimizers' step counts and first moments followed too
    jmu = convert_discriminator_params(jstate.d_opt[0].mu)
    tmu = adam_state(state.opt_d, state.D)["mu"]
    for k in jmu:
        np.testing.assert_allclose(tmu[k].numpy(), jmu[k].numpy(),
                                   rtol=1e-3, atol=1e-6)
    assert adam_state(state.opt_g, state.G)["count"] == STEPS
    assert adam_state(state.opt_d, state.D)["count"] == STEPS


def test_no_g_loss_gradient_reaches_d():
    """D's parameters change only through its own update: after one step,
    every D tensor equals what Adam makes of the D loss's gradient alone,
    and no .grad is left on any parameter."""
    _, tc = _cfgs("bottleneck")
    G = define_G(tc, torch.Generator().manual_seed(1))
    D = define_D(tc, torch.Generator().manual_seed(2))
    state = create_train_state(tc, G, D, torch.Generator().manual_seed(0))
    d0 = {k: v.clone() for k, v in D.state_dict().items()}
    b = _batches(5)[0]
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    # the D update alone, replayed on a copy
    Dc = define_D(tc, torch.Generator().manual_seed(2))
    from pcgan_tpu_torch.data.binning import bin_to_onehot
    with torch.no_grad():
        out = G(torch.cat([batch["image"]] * 2),
                torch.cat([bin_to_onehot(batch["target_bin"], NB),
                           bin_to_onehot(batch["bin"], NB)]))
    pred = Dc(torch.cat([batch["image"], out[:B]]),
              torch.cat([bin_to_onehot(batch["bin"], NB),
                         bin_to_onehot(batch["target_bin"], NB)]))
    loss = 0.5 * (((pred[:B] - 1) ** 2).mean() + (pred[B:] ** 2).mean())
    grads = torch.autograd.grad(loss, list(Dc.parameters()))
    adam_step(make_adam(Dc, 0.5, 0.999), grads, make_lr_schedule(tc, 1)(0))
    make_train_step(tc, G, D)(state, batch)
    for k, v in D.state_dict().items():
        assert not torch.equal(v, d0[k]), k
        np.testing.assert_allclose(v.numpy(), Dc.state_dict()[k].numpy(),
                                   rtol=0, atol=1e-7)
    assert all(p.grad is None for p in [*G.parameters(), *D.parameters()])


def test_lr_schedule_matches_jax():
    from pcgan_tpu.train import make_lr_schedule as j_sched
    for policy in ("linear", "step", "cosine", "constant", "plateau"):
        jc, tc = _cfgs("input")
        over = dict(lr_policy=policy, niter=3, niter_decay=4,
                    lr_decay_iters=2, epoch_count=2)
        jc = dataclasses.replace(jc, train=dataclasses.replace(jc.train,
                                                               **over))
        tc = dataclasses.replace(tc, train=dataclasses.replace(tc.train,
                                                               **over))
        js, ts = j_sched(jc, 5, 3e-4), make_lr_schedule(tc, 5, 3e-4)
        for s in range(0, 45, 3):
            assert abs(float(js(jnp.int32(s))) - ts(s)) <= 1e-9 + 1e-6 * ts(s), \
                (policy, s)


def test_plateau_scheduler_matches_jax():
    from pcgan_tpu.train import PlateauScheduler as JP
    from pcgan_tpu_torch.train import PlateauScheduler as TP
    j, t = JP(patience=2), TP(patience=2)
    for m in (1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.5, 0.6, 0.6, 0.6):
        assert j.update(m) == t.update(m)
        assert (j.best, j.bad_epochs) == (t.best, t.bad_epochs)


def test_adam_matches_optax():
    import optax
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(4)]
    tx = optax.adam(lambda c: 1e-2 / (1.0 + c), b1=0.5, b2=0.999)
    wj, sj = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    lin = torch.nn.Linear(4, 3, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w0))
    opt = make_adam(lin, 0.5, 0.999)
    for c, g in enumerate(grads):
        u, sj = tx.update(jnp.asarray(g), sj, wj)
        wj = optax.apply_updates(wj, jax.tree.map(lambda x: x * 0.5, u))
        adam_step(opt, [torch.from_numpy(g)], 1e-2 / (1.0 + c) * 0.5)
    np.testing.assert_allclose(lin.weight.detach().numpy(), np.asarray(wj),
                               rtol=1e-6, atol=1e-7)


def _one_step(argv):
    """Build the port's step for ``argv`` at a tiny size and take one step
    on a seeded batch; returns the metrics as floats."""
    tc = tcfg.parse_config(
        ["--crop_size", "32", "--load_size", "32", "--ngf", "8", "--ndf",
         "8", "--n_age_bins", str(NB), "--netG", "resnet_6blocks",
         "--cond_inject", "bottleneck", "--batch_size", "2", "--dtype",
         "float32", "--pool_size", "0"] + argv)
    G = define_G(tc, torch.Generator().manual_seed(1))
    D = define_D(tc, torch.Generator().manual_seed(2))
    state = create_train_state(tc, G, D, torch.Generator().manual_seed(0))
    b = _batches(7)[0]
    m = make_train_step(tc, G, D)(state, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
    return {k: float(v) for k, v in m.items()}


def test_unported_training_flags_raise(tmp_path):
    from pcgan_tpu_torch import train_main
    from pcgan_tpu_torch.train import reject_unported_train
    reject_unported_train(tcfg.parse_config([]))
    reject_unported_train(tcfg.parse_config(["--model", "comparator"]))
    reject_unported_train(tcfg.parse_config(["--comparator_path", "x"]))
    # the levers of this slice are ported: each one trains
    for argv, key in ((["--gan_mode", "wgangp"], "loss_D"),
                      (["--lambda_r1", "1"], "loss_D_r1"),
                      (["--diff_augment", "color"], "loss_D"),
                      (["--grad_accum", "2"], "loss_G"),
                      (["--lambda_feat", "10"], "loss_G_feat"),
                      (["--skip_nonfinite", "3"], "notfinite_D")):
        reject_unported_train(tcfg.parse_config(argv))
        m = _one_step(argv)
        assert key in m and all(np.isfinite(list(m.values()))), (argv, m)
    # the human-annotation CSV source of comparator pretraining needs its
    # CSV
    with pytest.raises(FileNotFoundError, match="comparisons_csv"):
        train_main.main(["--model", "comparator", "--dataset_mode",
                         "comparisons", "--device", "cpu",
                         "--checkpoints_dir", str(tmp_path)])
    for argv, cls in ((["--netD", "multiscale"], "MultiScale"),
                      (["--netD", "pixel"], "Pixel"),
                      (["--spectral_norm"], "NLayer")):
        assert type(define_D(tcfg.parse_config(argv))).__name__.startswith(
            cls)
    # what still raises: the device cache, the multi-device flags, and the
    # XLA-only flags for good
    for argv, flag in ((["--device_cache"], "--device_cache"),
                       (["--zero1"], "--zero1"),
                       (["--xla_opt", "x"], "XLA-only"),
                       (["--compile_cache", "d"], "XLA-only"),
                       (["--profile_server", "9000"], "XLA-only")):
        with pytest.raises(NotImplementedError, match=flag):
            reject_unported_train(tcfg.parse_config(argv))
