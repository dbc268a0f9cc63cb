"""Shared plumbing of the sharded-state tests
(``test_torch_port_auto_*.py``); a helper, not a test file.

- ``spec_codes``: a leaf's sharding as an array of the leaf's shape whose
  entry names the shard that holds it (``1 + 16 * model block + data
  block``). Carried through ``convert.convert_train_state`` it gives JAX's
  ``state_shardings`` in the port's layout, by the converter's own
  transposes (``jax_codes``); ``port_codes`` gives the same from the
  port's plan (``parallel.auto.plan_module``).
- ``jax_auto_run``: JAX's GSPMD step (``make_auto_train_step``) on a CPU
  mesh after one warm-up step, each state before and after a step carried
  into the port's payload format; on request also JAX's one-device step
  (``make_train_step``) from each of the same states.
"""

import dataclasses
import warnings

import numpy as np

import jax
import jax.numpy as jnp

from pcgan_tpu import config as jcfg
from pcgan_tpu.parallel.auto import (make_auto_train_step, place_auto_state,
                                     state_shardings)
from pcgan_tpu.parallel.mesh import make_mesh
from pcgan_tpu.train import create_train_state as j_create_train_state
from pcgan_tpu.train import make_train_step as j_make_train_step

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch.convert import convert_train_state
from pcgan_tpu_torch.parallel.auto import plan_module

from torch_port_levers import batches, cfgs, jax_models

BLOCK = 16          # code = 1 + BLOCK * model block + data block
FIELDS = {"g_params": ("G", None), "d_params": ("D", None),
          "g_opt": ("opt_g", "mu"), "d_opt": ("opt_d", "mu"),
          "ema_params": ("ema", None)}


def spec_codes(shape, spec, sizes) -> np.ndarray:
    """The shard of every entry of a leaf of ``shape`` under ``spec`` (an
    axis name or None per dim) on a mesh of axis ``sizes``."""
    code = np.ones(shape, np.float32)
    idx = np.indices(shape) if len(shape) else None
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        blk = idx[d] // (shape[d] // sizes[ax])
        code = code + blk * (BLOCK if ax == "model" else 1)
    return code


def decode(code):
    """(model block, data block) of each entry."""
    c = np.asarray(code).astype(np.int64) - 1
    return c // BLOCK, c % BLOCK


def _payload_codes(payload) -> dict:
    """{field: {port name: code array}} of a converted payload."""
    out = {}
    for field, (key, sub) in FIELDS.items():
        tree = payload[key]
        if tree is None:
            continue
        tree = tree[sub] if sub else tree
        out[field] = {k: np.asarray(v, np.float32) for k, v in tree.items()}
    return out


def jax_codes(jstate, mesh, zero1: bool) -> dict:
    """JAX's ``state_shardings`` of ``jstate`` as port-layout codes."""
    specs = state_shardings(jstate, mesh, zero1=zero1)
    sizes = dict(mesh.shape)

    def coded(tree, sh):
        return jax.tree.map(
            lambda x, s: spec_codes(np.shape(x), tuple(s.spec) + (None,) * (
                np.ndim(x) - len(tuple(s.spec))), sizes), tree, sh)
    repl = {f: coded(getattr(jstate, f), getattr(specs, f))
            for f in FIELDS if getattr(jstate, f) is not None}
    host = jax.device_get(jstate)
    return _payload_codes(convert_train_state(host.replace(**repl)))


def port_codes(G, D, sizes, zero1: bool) -> dict:
    """The port plan as codes under JAX's field names: the parameters and
    the EMA twin shard over ``model`` only, the Adam moments over both."""
    out = {}
    for net, mod in (("g", G), ("d", D)):
        plan = plan_module(mod, sizes.get("model", 1), sizes.get("data", 1),
                           zero1)
        for field, opt in ((f"{net}_params", False), (f"{net}_opt", True)):
            out[field] = {}
            for name, p in mod.named_parameters():
                spec = [None] * p.dim()
                if plan[name].model_dim is not None:
                    spec[plan[name].model_dim] = "model"
                if opt and plan[name].data_dim is not None:
                    spec[plan[name].data_dim] = "data"
                out[field][name] = spec_codes(tuple(p.shape), spec, sizes)
    out["ema_params"] = out["g_params"]
    return out


def with_parallel(jc, tc, shape, axes, zero1):
    """The config pair with a mesh and ``--zero1``."""
    kw = dict(mesh_shape=tuple(shape), mesh_axes=tuple(axes), zero1=zero1)
    return (dataclasses.replace(jc, parallel=jcfg.ParallelConfig(**kw)),
            dataclasses.replace(tc, parallel=tcfg.ParallelConfig(**kw)))


_ONE_DEVICE = {}   # the jitted one-device step of each config


def jax_auto_run(over, shape, axes, zero1, b, n_steps, seed=11,
                 warm=True, one_device=None):
    """(port cfg, JAX codes, [payload before step i], [global batch i],
    [(JAX metrics, payload after step i)]) of JAX's GSPMD step on a CPU
    mesh of ``shape`` after one warm-up step (none with ``warm=False``:
    step 0 starts from the fresh state, as ``tests/test_auto_parallel.py``
    does) (f32, pool off, target bins pinned). A list ``one_device``
    receives, for each step, (metrics, payload after) of JAX's
    one-device ``make_train_step`` from the same state on the same
    batch."""
    jc, tc = cfgs(data={"batch_size": b}, **over)
    jc, tc = with_parallel(jc, tc, shape, axes, zero1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        Gj, Dj = jax_models(jc)
    n = int(np.prod(shape))
    mesh = make_mesh(shape, axes, devices=jax.devices()[:n])
    # the init jitted: eager flax init takes ~3x as long on this CPU
    jstate = jax.jit(lambda r: j_create_train_state(jc, Gj, Dj, r, 1000))(
        jax.random.PRNGKey(3))
    jstate = place_auto_state(jstate, mesh, zero1=zero1)
    step = make_auto_train_step(jc, Gj, Dj, steps_per_epoch=1000, mesh=mesh,
                                with_preprocess=False)
    bs = batches(n_steps + 1, seed=seed, b=b)

    def run(st, batch):
        return step(st, {k: jnp.asarray(v) for k, v in batch.items()})
    codes = jax_codes(jstate, mesh, zero1)
    if warm:
        jstate, _ = run(jstate, bs[0])
    if one_device is not None:
        key = (repr(over), b)
        if key not in _ONE_DEVICE:
            jc1 = dataclasses.replace(jc, parallel=jcfg.ParallelConfig())
            _ONE_DEVICE[key] = jax.jit(j_make_train_step(
                jc1, Gj, Dj, steps_per_epoch=1000))
        one = _ONE_DEVICE[key]
    payloads, want = [], []
    for batch in bs[1:]:
        host = jax.device_get(jstate)
        payloads.append(convert_train_state(host))
        if one_device is not None:
            st, jm = one(host, {k: jnp.asarray(v) for k, v in batch.items()})
            one_device.append(({k: float(v) for k, v in jm.items()},
                               convert_train_state(jax.device_get(st))))
        jstate, jm = run(jstate, batch)
        want.append(({k: float(v) for k, v in jm.items()},
                     convert_train_state(jax.device_get(jstate))))
    return tc, codes, payloads, bs[1:], want


def check_shards(result, codes, has_ema=False):
    """A rank's own shards after a step (``torch_port_parallel_worker.
    sharded_steps``) are exactly the blocks JAX's shardings give its mesh
    coordinates, of the whole tensors the cohort gathered."""
    mc, dc = result["coords"].get("model", 0), result["coords"].get("data",
                                                                    0)
    checked = 0
    for key, sh in result["shards"].items():
        net, name = key.split(".", 1)
        g = net == "G"
        for what, field, full in (
                ("param", "g_params" if g else "d_params",
                 result[net][name]),
                ("mu", "g_opt" if g else "d_opt",
                 result["opt_g" if g else "opt_d"]["mu"][name]),
                ("ema", "ema_params", result["ema"][name]
                 if g and has_ema else None)):
            if full is None:
                continue
            m, d = decode(codes[field][name])
            # the entries of this rank's block on each axis the leaf shards
            mask = ((m == mc) | (m.max() == 0)) & ((d == dc) | (d.max() == 0))
            want = full.numpy()[mask]
            got = sh[what].numpy().reshape(-1)
            assert got.shape == want.shape, (key, what, got.shape,
                                             want.shape)
            np.testing.assert_array_equal(got, want, err_msg=f"{key} {what}")
            checked += 1
    assert checked > 0
