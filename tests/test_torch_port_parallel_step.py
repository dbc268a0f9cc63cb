"""The port's data-parallel GAN step over two gloo ranks against
``pcgan_tpu.parallel.make_parallel_train_step`` on a 2-device mesh
(instance norm; batch norm, ``--grad_accum`` and the comparator are
``test_torch_port_parallel_variants.py``'s).

JAX draws the weights, takes one warm-up step (so Adam's moments scale
every update continuously, as in ``tests/torch_port_levers.py``), then
three steps; before each, its state is carried into the port with
``convert.convert_train_state``. One cohort of two ranks
(``torch_port_parallel_worker.py``) takes each step from that state on
its rows of the same global batch (f32, pool off, target bins pinned,
``with_preprocess=False``). Per step: every loss within 1e-4 abs + 1e-4
rel (``tests/test_torch_port_train_step.py``'s limit); the gradients, read
through Adam's first moments, within 1e-4 of each tensor's largest entry,
unless an input of a G ReLU or a D leaky ReLU on either rank lay within
f32 noise of zero (below 1e-6; its slope then comes from that noise, and
every gradient upstream of it may move by ~1e-2: the rule of
``tests/test_torch_port_comparator_step.py``, with D's kinks added; each
case checks at least one step's gradients: batch norm over two rows a rank
puts such an input near zero in most steps); the parameters within the one-step Adam
envelope (its bulk bound only where the gradients are checked); the norm state within
1e-5 (batch norm's running stats are the ranks' mean, as JAX's ``pmean``);
both ranks alike bit for bit. The two ranks also match the port's
one-device step on the whole global batch (``tests/test_parallel.py``'s
invariant, held like ``--grad_accum``'s: 1e-5 of each tensor's scale).
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.parallel import make_mesh
from pcgan_tpu.parallel import make_parallel_train_step as j_make_dp_step
from pcgan_tpu.parallel import shard_train_state as j_shard_train_state
from pcgan_tpu.train import create_train_state as j_create_train_state

from pcgan_tpu_torch.convert import convert_train_state
from pcgan_tpu_torch.models import define_D, define_G
from pcgan_tpu_torch.train import create_train_state, make_train_step
from pcgan_tpu_torch.utils.checkpoint import adam_state, load_state

from torch_port_levers import (LR, assert_close, batches, cfgs, jax_models,
                               torch_batch)
from torch_port_parallel_worker import run_cohort

GLOBAL_B, STEPS = 4, 3
KINK = 1e-6      # |(leaky) ReLU input| below which f32 noise picks the slope
CASES = {"instance": {}}


def jax_mesh2():
    return make_mesh((2,), ("data",), devices=jax.devices()[:2])


def jax_dp_run(over, n_steps=STEPS, b=GLOBAL_B):
    """(port cfg, [payload before step i], [global batch i], [(JAX metrics,
    payload after step i)]) of JAX's 2-device step after one warm-up."""
    jc, tc = cfgs(data={"batch_size": b}, **over)
    Gj, Dj = jax_models(jc)
    mesh = jax_mesh2()
    # the init jitted: eager flax init takes ~3x as long on this CPU
    jstate = jax.jit(lambda r: j_create_train_state(jc, Gj, Dj, r, 1000))(
        jax.random.PRNGKey(3))
    jstate = j_shard_train_state(jstate, mesh)
    step = j_make_dp_step(jc, Gj, Dj, steps_per_epoch=1000, mesh=mesh,
                          with_preprocess=False)
    bs = batches(n_steps + 1, seed=11, b=b)

    def run(st, batch):
        return step(st, {k: jnp.asarray(v) for k, v in batch.items()})
    jstate, _ = run(jstate, bs[0])
    payloads, want = [], []
    for batch in bs[1:]:
        payloads.append(convert_train_state(jax.device_get(jstate)))
        jstate, jm = run(jstate, batch)
        want.append(({k: float(v) for k, v in jm.items()},
                     convert_train_state(jax.device_get(jstate))))
    return tc, payloads, [torch_batch(x) for x in bs[1:]], want


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    runs = {name: jax_dp_run(over) for name, over in CASES.items()}
    ranks = run_cohort({name: {"kind": "gan_steps", "cfg": tc,
                               "payloads": payloads, "batches": bs}
                        for name, (tc, payloads, bs, _) in runs.items()},
                       tmp_path_factory.mktemp("dp_step"))
    return runs, ranks


def _adam_envelope(name, d_want, d_got, tight=True):
    """One Adam step's parameter change within the sign-flip envelope;
    ``tight``: the bulk within 2e-6 too (not at a kink, whose gradient
    error moves the bulk of the update by about that much)."""
    diff = np.abs(d_want - d_got)
    assert not tight or np.median(diff) < 2e-6, (name, np.median(diff))
    assert diff.max() <= 2.1 * LR, (name, diff.max())
    assert float((diff > 0.25 * LR).mean()) < 2e-3, name


def compare_gan_step(start, want_metrics, want, got, tol=1e-4,
                     grads=True):
    """One step of the port (``got``: a worker's step result) against the
    reference (``want_metrics`` and the ``convert_train_state`` payload
    after the step) from the payload ``start``; ``grads=False`` leaves out
    the first moments (a step at a ReLU kink)."""
    assert set(got["metrics"]) == set(want_metrics)
    for k, v in want_metrics.items():
        assert abs(got["metrics"][k] - v) <= tol + tol * abs(v), \
            (k, got["metrics"][k], v)
    for net, opt in (("G", "opt_g"), ("D", "opt_d")):
        assert got[opt]["count"] == want[opt]["count"], net
        for k, mu in want[opt]["mu"].items() if grads else ():
            assert_close(f"{net}.mu.{k}", got[opt]["mu"][k], mu, tol)
        params = set(want[opt]["mu"])
        assert set(got[net]) == set(want[net]), net
        for k, v in want[net].items():
            if k in params:
                _adam_envelope(f"{net}.{k}",
                               (v - start[net][k]).numpy(),
                               (got[net][k] - start[net][k]).numpy(), grads)
            else:
                assert_close(f"{net}.state.{k}", got[net][k], v, 1e-5)


def check_against_jax(runs, ranks, case):
    """Every step of ``case`` against JAX's (the module docstring's
    limits)."""
    _, payloads, _, want = runs[case]
    checked = 0
    for i, (jm, after) in enumerate(want):
        smooth = min(r[case][i]["relu_margin"] for r in ranks) > KINK
        checked += smooth
        compare_gan_step(payloads[i], jm, after, ranks[0][case][i],
                         grads=smooth)
    assert checked >= 1


def check_ranks_alike(ranks, case, nets=("G", "D")):
    for a, b in zip(ranks[0][case], ranks[1][case]):
        assert a["metrics"] == b["metrics"]
        for net in nets:
            for k, v in a[net].items():
                assert torch.equal(v, b[net][k]), (net, k)


def test_dp_step_matches_jax_parallel_step(cohort):
    check_against_jax(*cohort, "instance")


def test_ranks_stay_alike(cohort):
    check_ranks_alike(cohort[1], "instance")


def test_two_ranks_match_one_rank(cohort):
    """The two ranks' step equals the port's one-device step on the whole
    global batch."""
    runs, ranks = cohort
    tc, payloads, bs, _ = runs["instance"]
    for payload, batch, got in zip(payloads, bs, ranks[0]["instance"]):
        G, D = define_G(tc), define_D(tc)
        state = create_train_state(tc, G, D, torch.Generator().manual_seed(0))
        load_state(state, payload)
        m = make_train_step(tc, G, D)(state, batch)
        for k, v in m.items():
            assert_close(k, got["metrics"][k], float(v), 1e-5)
        for net, opt, mod in (("G", "opt_g", G), ("D", "opt_d", D)):
            one = adam_state(getattr(state, opt), mod)
            for k, mu in one["mu"].items():
                assert_close(f"{net}.mu.{k}", got[opt]["mu"][k], mu, 1e-5)
            for k in one["mu"]:
                v = mod.state_dict()[k]
                _adam_envelope(f"{net}.{k}",
                               (v - payload[net][k]).numpy(),
                               (got[net][k] - payload[net][k]).numpy())
