"""The port's train step with a U-Net G against
``pcgan_tpu.train.make_train_step`` (CPU), as
``tests/torch_port_levers.py`` runs it: one JAX warm-up step, then steps
each started from JAX's state, metrics and Adam first moments within 1e-4
of max(1, max|x|), norm state within 1e-5. JAX's dropout draws cannot be
made in torch, so the ``unet_64`` case replays JAX's masks in the port's
step.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from pcgan_tpu_torch.models import define_G as port_define_G
from pcgan_tpu_torch.models.generator import UnetGenerator

import torch_port_levers as lv
from torch_port_levers import one_torch_thread  # noqa: F401


def _lockstep(monkeypatch, model, data=None, masks=None, n_steps=3):
    """The port's step against JAX's ``make_train_step``: one JAX warm-up
    step, then ``n_steps`` steps each started from JAX's state
    (``torch_port_levers.compare_step``). ``masks(jc, Gj, jstate, batch)``
    returns JAX's dropout masks for the step, replayed in the port."""
    from pcgan_tpu.train import make_train_step as j_make_train_step
    from pcgan_tpu_torch.train import make_train_step
    jc, tc = lv.cfgs(model=model, data=data)
    Gj, Dj = lv.jax_models(jc)
    jstate = lv.jax_state(jc, Gj, Dj)
    jstep = jax.jit(j_make_train_step(jc, Gj, Dj, steps_per_epoch=1000))
    size = jc.data.crop_size
    rng = np.random.default_rng(0)
    bs = [{"image": rng.random((lv.B, size, size, 3), np.float32) * 2 - 1,
           "bin": rng.integers(0, lv.NB, lv.B).astype(np.int32),
           "target_bin": rng.integers(0, lv.NB, lv.B).astype(np.int32)}
          for _ in range(n_steps + 1)]
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in bs[0].items()})
    for b in bs[1:]:
        state = lv.port_state(tc, jstate)
        if masks is not None:
            keeps = masks(jc, Gj, jstate, b)
            monkeypatch.setattr(UnetGenerator, "draw_keeps",
                                lambda self, x, g: keeps)
        tm = make_train_step(tc, state.G, state.D)(state, lv.torch_batch(b))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        lv.compare_step(jstate, jm, state, tm)


@pytest.mark.parametrize("model", [
    dict(netG="unet_32"),
    dict(netG="unet_32", cond_inject="input", norm="batch")],
    ids=["bottleneck_instance", "input_batch"])
def test_unet_three_step_lockstep(model, monkeypatch):
    _lockstep(monkeypatch, model)


def _jax_dropout_masks(jc, Gj, jstate, b):
    """JAX's dropout keep-masks of the step at ``jstate`` as the port's
    {level: NCHW bool mask}: the G forward of the step (x2 = [real, real],
    the dropout key r_drop) with every ``nn.Dropout`` intercepted to draw
    its own key and hand it to the layer, so the mask is the layer's."""
    r_drop = lv.step_keys(jstate, False)[1]
    # the same G without remat (remat would trace the layer), whose
    # dropout layers draw the same keys
    Gj = lv.jax_models(dataclasses.replace(
        jc, model=dataclasses.replace(jc.model, remat=False)))[0]
    got = []

    def grab(next_fun, args, kwargs, context):
        if (isinstance(context.module, nn.Dropout)
                and context.method_name == "__call__"):
            key = context.module.make_rng("dropout")
            x = args[0]
            got.append((context.module.scope.path,
                        jax.random.bernoulli(key, 0.5, x.shape)))
            return next_fun(*args, rng=key, **kwargs)
        return next_fun(*args, **kwargs)

    x2 = jnp.concatenate([b["image"], b["image"]])
    c2 = jnp.zeros((x2.shape[0], lv.NB))
    with nn.intercept_methods(grab):
        Gj.apply({"params": jstate.g_params, **jstate.g_state}, x2, c2,
                 train=True, rngs={"dropout": r_drop},
                 mutable=list(jstate.g_state))
    out = {}
    for path, m in got:
        level = int(path[0].split("_")[-1])
        out[level] = torch.from_numpy(np.array(m)).permute(0, 3, 1, 2)
    return out


def test_unet64_dropout_and_remat_step_replays_jax_masks(monkeypatch):
    """unet_64 has one dropout level (num_downs - 5 = 1, ``UnetSkipBlock_1``)
    and, under --remat, five recomputed levels with the mask inside: the
    step equals JAX's remat step with JAX's masks replayed."""
    model = dict(netG="unet_64", no_dropout=False, remat=True)
    data = dict(crop_size=64, load_size=64)
    jc, tc = lv.cfgs(model=model, data=data)
    G = port_define_G(tc)
    assert G.n_remat == 5 and [lvl.use_dropout for lvl in G.levels] == [
        False, True, False, False, False, False]
    seen = []

    def masks(jc, Gj, jstate, b):
        m = _jax_dropout_masks(jc, Gj, jstate, b)
        assert list(m) == [1] and m[1].shape == (2 * lv.B, 64, 4, 4)
        seen.append(float(m[1].float().mean()))
        return m
    _lockstep(monkeypatch, model, data, masks=masks, n_steps=2)
    assert len(seen) == 2 and all(0.3 < s < 0.7 for s in seen)
