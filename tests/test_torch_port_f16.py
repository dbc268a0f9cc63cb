"""``--dtype float16`` in the port against the JAX package's (CPU).

In JAX, f16 reaches only the modules' ``dtype`` (convs cast their input and
kernel per layer, norms take their moments in f32); the step's compute
dtype, the preprocessed images and the conditions stay f32, the bf16 routes
(the cond-bias stem, the s2d tail) stay off, and there is no loss scaling
(``pcgan_tpu/train.py:265``, ``models/layers.py:200``). Held here on
converted weights and the same numpy inputs:

- G, D and C forwards in f16 against the JAX modules in f16. Limits: the
  bf16 ones (max 5e-2, mean 5e-3 for G; ``test_torch_port_generator.py``)
  scaled by 2^-3 for f16's three more mantissa bits: max 6.25e-3, mean
  6.25e-4 (measured: G 1.8e-3 / 3.3e-4, D and C below that).
- A 3-step lockstep of ``make_train_step`` in f16, in the manner of the
  GAN-with-C lockstep (``test_torch_port_comparator_step.py``): JAX takes
  one warm-up step, each step starts from JAX's state. Without loss
  scaling the f16 cotangents lose bits (and the two CPU backends round and
  flush small values differently), so the limits are f16's, measured over
  both injections: losses within 5e-3 of 1e-4 + |JAX's| (measured
  1.4e-3); each net's gradient, read through Adam's first moments, within
  0.25 of JAX's in relative L2 (measured 0.083); parameters within the
  one-step Adam envelope of 2.5 lr (measured 2.14 lr).
- The serving wrapper casts to f32 around the f16 G, and the exported
  meta records ``float16``.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.serving import make_infer_fn as j_make_infer_fn
from pcgan_tpu_torch import serving
from pcgan_tpu_torch.config import parse_config
from pcgan_tpu_torch.convert import convert_train_state
from pcgan_tpu_torch.models.registry import DTYPES, compute_dtype
from pcgan_tpu_torch.ops.preprocess import make_preprocess
from pcgan_tpu_torch.utils.checkpoint import adam_state, load_state

import test_torch_port_comparator as tcmp_t
import test_torch_port_discriminator as td_t
import test_torch_port_generator as tg_t
import test_torch_port_train_step as ts_t
from torch_port_levers import one_torch_thread  # noqa: F401

G_MAX, G_MEAN = 6.25e-3, 6.25e-4
LOSS_REL, GRAD_L2, ENVELOPE = 5e-3, 0.25, 2.5


def _err(got, want):
    e = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    return e.max(), e.mean()


def test_compute_dtype_rule():
    assert DTYPES["float16"] == torch.float16
    assert compute_dtype("float16") == compute_dtype("float32") == \
        torch.float32
    assert compute_dtype("bfloat16") == torch.bfloat16
    cfg = parse_config(["--dtype", "float16", "--device", "cpu"],
                       is_train=False)
    out = make_preprocess(cfg, train=False)(None, {
        "image": torch.zeros((1, 36, 36, 3), dtype=torch.uint8)})
    assert out["image"].dtype == torch.float32


@pytest.mark.parametrize("inject", ["input", "bottleneck"])
def test_generator_f16_close_to_jax(inject):
    argv = tg_t.SMALL + ["--netG", "resnet_6blocks", "--cond_inject",
                         inject, "--dtype", "float16", "--lowch_matmul"]
    got, want = tg_t._run_both(argv, seed=1)
    e_max, e_mean = _err(got, want)
    assert e_max <= G_MAX and e_mean <= G_MEAN, (e_max, e_mean)
    _, _, pG = tg_t._pair(argv, seed=1)
    # the bf16 routes stay off; every conv computes in f16, params in f32
    assert not pG.stem_cond and pG.tail.s2d_r == 0
    assert all(m.compute_dtype == torch.float16 for m in pG.modules()
               if hasattr(m, "compute_dtype") and m is not pG)
    assert all(p.dtype == torch.float32 for p in pG.parameters())


@pytest.mark.parametrize("netD,n_layers", [("basic", 3), ("n_layers", 2)])
def test_discriminator_f16_close_to_jax(netD, n_layers):
    from pcgan_tpu import config as jcfg
    from pcgan_tpu.models.registry import define_D as j_define_D
    from pcgan_tpu.models.registry import init_params
    from pcgan_tpu_torch import config as tcfg
    from pcgan_tpu_torch.convert import convert_discriminator_params
    from pcgan_tpu_torch.models import define_D
    jD = j_define_D(td_t._cfg(jcfg, netD, n_layers, "instance", "float16"))
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    cond = np.eye(td_t.NB, dtype=np.float32)[[1, 3]]
    variables = init_params(jD, jax.random.PRNGKey(1), jnp.asarray(x),
                            jnp.asarray(cond))
    params = jax.tree.map(lambda a: a + 0.01 if a.ndim == 1 else a,
                          variables["params"])
    want = jD.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond),
                    train=True)
    D = define_D(td_t._cfg(tcfg, netD, n_layers, "instance", "float16"))
    D.load_state_dict(convert_discriminator_params(params), strict=True)
    got = D(torch.from_numpy(x), torch.from_numpy(cond))
    assert got.dtype == torch.float32
    e_max, e_mean = _err(got.detach().numpy(), want)
    assert e_max <= G_MAX and e_mean <= G_MEAN, (e_max, e_mean)


def test_comparator_f16_close_to_jax():
    jC, jv, C = tcmp_t._pair(dtype="float16")
    x = tcmp_t._images(8, seed=3)
    mu_j, lv_j = jC.apply(jv, jnp.asarray(x), train=False)
    with torch.no_grad():
        mu, lv = C(torch.from_numpy(x))
    assert mu.dtype == lv.dtype == torch.float32
    assert C.convs[1].compute_dtype == torch.float16
    for got, want in ((mu, mu_j), (lv, lv_j)):
        e_max, e_mean = _err(got.numpy(), want)
        assert e_max <= G_MAX and e_mean <= G_MEAN, (e_max, e_mean)


def _f16(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float16"))


@pytest.mark.parametrize("cond_inject", ["input", "bottleneck"])
def test_f16_three_step_lockstep(cond_inject):
    jc, tc = (_f16(c) for c in ts_t._cfgs(cond_inject))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # input injection
        Gj, Dj = ts_t.j_define_G(jc), ts_t.j_define_D(jc)
        state = ts_t._port_state(tc, jstate := ts_t.j_create_train_state(
            jc, Gj, Dj, jax.random.PRNGKey(3), 1000))
    jstep = jax.jit(ts_t.j_make_train_step(jc, Gj, Dj, steps_per_epoch=1000))
    step = ts_t.make_train_step(tc, state.G, state.D)
    b1 = tc.train.beta1
    seen = []
    real_g = state.G.forward

    def spy(x, cond, *a, **k):
        seen.append((x.dtype, cond.dtype))
        return real_g(x, cond, *a, **k)
    state.G.forward = spy
    batches = ts_t._batches(1) + ts_t._batches(2)[:1]
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if i == 0:                                 # JAX's warm-up step
            jstate, _ = jstep(jstate, jb)
            continue
        s0 = convert_train_state(jstate)
        load_state(state, s0)                      # both from JAX's state
        jstate, jm = jstep(jstate, jb)
        tm = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(tm) == set(jm)
        for k in jm:
            jv, tv = float(jm[k]), float(tm[k])
            assert np.isfinite(tv) and abs(jv - tv) <= LOSS_REL * (
                1e-4 + abs(jv)), (i, k, jv, tv)
        s1 = convert_train_state(jstate)
        for name, net, opt in (("G", state.G, state.opt_g),
                               ("D", state.D, state.opt_d)):
            key = f"opt_{name.lower()}"
            mu0, mu_j = s0[key]["mu"], s1[key]["mu"]
            mu_t = adam_state(opt, net)["mu"]
            num = den = 0.0
            for k in mu_j:
                gj = (mu_j[k] - b1 * mu0[k]).numpy() / (1 - b1)
                num += float((((mu_j[k] - mu_t[k]).numpy() / (1 - b1)) ** 2
                              ).sum())
                den += float((gj ** 2).sum())
            assert (num / den) ** 0.5 <= GRAD_L2, (i, name, (num / den) ** 0.5)
            t1 = net.state_dict()
            for k in s1[name]:
                d = np.abs((s1[name][k] - t1[k]).numpy())
                assert d.max() <= ENVELOPE * ts_t.LR, (i, name, k, d.max())
    # the step hands G f32 images and conditions: f16 lives in its layers
    assert seen and set(seen) == {(torch.float32, torch.float32)}
    assert state.step == int(jstate.step) == len(batches)


def test_serving_wrapper_casts_to_f32(tmp_path):
    argv = tg_t.SMALL + ["--netG", "resnet_6blocks", "--cond_inject",
                         "bottleneck", "--dtype", "float16"]
    jG, jv, pG = tg_t._pair(argv, seed=2)
    cfg = parse_config(argv + ["--device", "cpu"], is_train=False)
    fn = serving.make_infer_fn(cfg, pG)
    assert fn.compute_dtype == torch.float32
    x, c = tg_t._inputs(seed=2)
    with torch.no_grad():
        got = fn(torch.from_numpy(x), torch.from_numpy(c))
        direct = pG(torch.from_numpy(x), torch.from_numpy(c))
    assert got.dtype == torch.float32 and torch.equal(got, direct)
    from pcgan_tpu.config import parse_config as jax_parse
    want = j_make_infer_fn(jax_parse(argv, is_train=False), jG)(
        jv, jnp.asarray(x), jnp.asarray(c))
    assert want.dtype == jnp.float32
    e_max, e_mean = _err(got.numpy(), want)
    assert e_max <= G_MAX and e_mean <= G_MEAN, (e_max, e_mean)
    out = str(tmp_path / "srv")
    serving.export_generator(cfg, pG, out, platforms=["cpu"])
    with open(os.path.join(out, "meta.json")) as f:
        assert json.load(f)["compute_dtype"] == "float16"
    served = serving.load_exported(out, device="cpu")
    np.testing.assert_allclose(served(x, c), got.numpy(), atol=1e-6, rtol=0)
