"""Gradient accumulation, remat and dropout in the port.

- ``--grad_accum N`` equals the full-batch step in the port (f32, pool off,
  targets pinned): every metric and every entry of both nets' Adam first
  moments (the gradients) within 1e-5 of the tensor's scale;
- the port's accumulated step against ``pcgan_tpu.accum.
  make_accum_train_step`` from the same JAX state, with spectral norm
  (whose u threads through the microbatches) and R1: the lockstep
  tolerances of ``tests/test_torch_port_lever_step.py``;
- ``--remat`` changes no number: the same dropout masks (drawn before the
  checkpointed block, so the recompute replays them), the same outputs and
  gradients, the same batch-norm running stats (the recompute writes
  none), and the same names;
- dropout masks come from the state's generator only.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu_torch.models import define_D, define_G
from pcgan_tpu_torch.train import create_train_state, make_train_step
from pcgan_tpu_torch.utils.checkpoint import adam_state

from torch_port_levers import (one_torch_thread,  # noqa: F401
                               assert_close, batches, cfgs, compare_step,
                               jax_models, jax_state, port_state,
                               torch_batch)


def _port_run(tc, batch, seed=0):
    G = define_G(tc, torch.Generator().manual_seed(seed + 1))
    D = define_D(tc, torch.Generator().manual_seed(seed + 2))
    state = create_train_state(tc, G, D, torch.Generator().manual_seed(seed))
    m = make_train_step(tc, G, D)(state, torch_batch(batch))
    return state, m


@pytest.mark.parametrize("accum,extra", [
    (2, {}), (4, {"lambda_r1": 10.0, "lambda_feat": 10.0,
                  "log_grad_norm": True})])
def test_accum_matches_full_batch(accum, extra):
    _, t1 = cfgs(data=dict(batch_size=8), train=extra)
    _, tn = cfgs(data=dict(batch_size=8), train=dict(grad_accum=accum,
                                                     **extra))
    (b,) = batches(1, seed=4, b=8)
    s1, m1 = _port_run(t1, b)
    sn, mn = _port_run(tn, b)
    assert set(m1) == set(mn)
    for k in m1:
        assert_close(k, float(mn[k]), float(m1[k]), 1e-5)
    for which in ("G", "D"):
        net1, netn = (s1.G, sn.G) if which == "G" else (s1.D, sn.D)
        o1 = adam_state(s1.opt_g if which == "G" else s1.opt_d, net1)
        on = adam_state(sn.opt_g if which == "G" else sn.opt_d, netn)
        assert o1["count"] == on["count"] == 1
        for k in o1["mu"]:
            assert_close(f"{which}.{k}", on["mu"][k], o1["mu"][k], 1e-5)


def test_accum_matches_jax_accum_step():
    from pcgan_tpu.accum import make_accum_train_step as j_make_accum
    over = dict(model=dict(spectral_norm=True),
                train=dict(grad_accum=2, lambda_r1=10.0),
                data=dict(batch_size=4))
    jc, tc = cfgs(**over)
    Gj, Dj = jax_models(jc)
    jstate = jax_state(jc, Gj, Dj)
    jstep = jax.jit(j_make_accum(jc, Gj, Dj, steps_per_epoch=1000))
    bs = batches(3, seed=5, b=4)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in bs[0].items()})
    for b in bs[1:]:
        state = port_state(tc, jstate)
        tm = make_train_step(tc, state.G, state.D)(state, torch_batch(b))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        compare_step(jstate, jm, state, tm)


def _g(tc, seed=1):
    return define_G(tc, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_remat_changes_no_number(norm):
    model = dict(no_dropout=False, norm=norm)
    _, plain = cfgs(model=model)
    _, remat = cfgs(model=dict(model, remat=True, remat_blocks=4))
    Gp, Gr = _g(plain), _g(remat)
    assert Gr.n_remat == 4 and Gp.n_remat == 0
    assert list(Gp.state_dict()) == list(Gr.state_dict())
    Gr.load_state_dict(Gp.state_dict())
    (b,) = batches(1, seed=6)
    x, c = torch.from_numpy(b["image"]), torch.eye(4)[b["bin"]]
    outs, grads = [], []
    for G in (Gp, Gr):
        gen = torch.Generator().manual_seed(9)
        out = G(x, c, generator=gen)
        outs.append(out)
        grads.append(torch.autograd.grad((out ** 2).sum(),
                                         list(G.parameters())))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-6)
    for a, b_ in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-6)
    for k, v in Gp.state_dict().items():
        torch.testing.assert_close(Gr.state_dict()[k], v, rtol=0, atol=1e-7)


def test_dropout_masks_come_from_the_generator():
    _, tc = cfgs(model=dict(no_dropout=False))
    G = _g(tc)
    (b,) = batches(1, seed=7)
    x, c = torch.from_numpy(b["image"]), torch.eye(4)[b["bin"]]

    def run(seed):
        return G(x, c, generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="generator"):
        G(x, c)
    G.eval()
    assert torch.equal(G(x, c), G(x, c))     # no dropout at eval
    # the train state holds the dropout generator; two runs from one seed
    # take the same steps
    ms = []
    for _ in range(2):
        G = _g(tc)
        D = define_D(tc, torch.Generator().manual_seed(2))
        state = create_train_state(tc, G, D, torch.Generator().manual_seed(0))
        assert state.dropout_generator is not None
        ms.append(make_train_step(tc, G, D)(state, torch_batch(b)))
    assert all(torch.equal(ms[0][k], ms[1][k]) for k in ms[0])


def test_accum_rejects_an_indivisible_batch():
    _, tc = cfgs(train=dict(grad_accum=4))
    (b,) = batches(1, seed=8, b=2)
    G, D = _g(tc), define_D(tc)
    state = create_train_state(tc, G, D, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="divisible by --grad_accum 4"):
        make_train_step(tc, G, D)(state, torch_batch(b))
    with pytest.raises(ValueError, match="grad_accum >= 2"):
        from pcgan_tpu_torch.accum import make_accum_train_step
        make_accum_train_step(dataclasses.replace(
            tc, train=dataclasses.replace(tc.train, grad_accum=1)), G, D)


def test_comparator_step_skips_a_nonfinite_update():
    """``--skip_nonfinite`` wraps comparator pretraining's Adam too
    (``make_optimizer`` in the JAX package): a NaN pair holds C, Adam's
    count and the lr schedule's count; the next finite pair updates."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_C
    from pcgan_tpu_torch.train import (adam_count, create_comparator_state,
                                       make_comparator_step)
    cfg = parse_config(["--model", "comparator", "--crop_size", "32",
                        "--cmp_nf", "8", "--cmp_n_down", "3",
                        "--dtype", "float32", "--skip_nonfinite", "2"])
    C = define_C(cfg, torch.Generator().manual_seed(1))
    state = create_comparator_state(cfg, C, torch.Generator().manual_seed(0))
    step = make_comparator_step(cfg, C)
    rng = np.random.default_rng(3)
    pair = {"image_a": torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3))
                                        .astype(np.float32)),
            "image_b": torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3))
                                        .astype(np.float32)),
            "label": torch.tensor([0, 1, 2, 0])}
    step(state, pair)
    before = {k: v.clone() for k, v in C.state_dict().items()}
    bad = {**pair, "image_a": pair["image_a"].clone()}
    bad["image_a"][0, 0, 0, 0] = float("nan")
    m = step(state, bad)
    assert not np.isfinite(float(m["loss_cmp"]))
    assert all(torch.equal(v, before[k]) for k, v in C.state_dict().items())
    assert int(adam_count(state.opt)) == 1 and state.step == 2
    assert int(state.skip["total_notfinite"]) == 1
    step(state, pair)
    assert int(adam_count(state.opt)) == 2
    assert not torch.equal(C.state_dict()["fc.weight"], before["fc.weight"])
