"""The port's data-parallel steps beyond the default GAN, over two gloo
ranks against the JAX package's on a 2-device mesh, in one cohort:

- ``--norm batch``: G's and D's running stats averaged over the ranks at
  the end of the step (JAX's ``pmean`` of the state);
- ``--grad_accum 2`` (global batch 8, 2 microbatches a rank): the
  accumulated step's reduction points;
- the comparator's pretraining step
  (``pcgan_tpu.parallel.make_parallel_comparator_step``).

The GAN cases take the limits and the ReLU-kink rule of
``test_torch_port_parallel_step.py`` (each step started from JAX's
state). The comparator's steps, each started from JAX's state too: both
metrics within 1e-4 abs + 1e-4 rel, Adam's count, and the parameters within
the one-step envelope of ``tests/test_torch_port_comparator_step.py`` (the
score head's bias only within the sign-flip bound: its gradient is zero
analytically).
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pcgan_tpu.models.registry import define_C as j_define_C
from pcgan_tpu.parallel import make_parallel_comparator_step as j_cmp_step
from pcgan_tpu.train import create_comparator_state as j_create_cmp_state

from pcgan_tpu_torch.convert import convert_comparator_state

from test_torch_port_parallel_step import (_adam_envelope, check_against_jax,
                                           check_ranks_alike, jax_dp_run,
                                           jax_mesh2)
from torch_port_levers import LR, S, cfgs
from torch_port_parallel_worker import run_cohort

GAN_CASES = {"batch_norm": ({"model": {"norm": "batch"}}, 4),
             "grad_accum": ({"train": {"grad_accum": 2}}, 8)}
CMP_STEPS, CMP_B = 3, 8


def jax_cmp_run():
    """(port cfg, [payload before step i], [global pair batch i], [(JAX
    metrics, payload after step i)]) of JAX's 2-device comparator step."""
    jc, tc = cfgs(model={"cmp_nf": 8, "cmp_n_down": 3},
                  data={"batch_size": CMP_B})
    jC = j_define_C(jc)
    mesh = jax_mesh2()
    jstate = jax.device_put(j_create_cmp_state(jc, jC, jax.random.PRNGKey(3),
                                               1000),
                            NamedSharding(mesh, P()))
    step = j_cmp_step(jc, jC, 1000, mesh=mesh, with_preprocess=False)
    rng = np.random.default_rng(5)
    payloads, bs, want = [], [], []
    for _ in range(CMP_STEPS):
        b = {"image_a": rng.random((CMP_B, S, S, 3), np.float32) * 2 - 1,
             "image_b": rng.random((CMP_B, S, S, 3), np.float32) * 2 - 1,
             "label": rng.integers(0, 3, CMP_B).astype(np.int32)}
        payloads.append(convert_comparator_state(jax.device_get(jstate)))
        with jax.default_matmul_precision("highest"):
            jstate, jm = step(jstate, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        want.append(({k: float(v) for k, v in jm.items()},
                     convert_comparator_state(jax.device_get(jstate))))
        bs.append({k: torch.from_numpy(v) for k, v in b.items()})
    return tc, payloads, bs, want


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    runs = {name: jax_dp_run(over, b=b)
            for name, (over, b) in GAN_CASES.items()}
    cases = {name: {"kind": "gan_steps", "cfg": tc, "payloads": payloads,
                    "batches": bs}
             for name, (tc, payloads, bs, _) in runs.items()}
    runs["comparator"] = jax_cmp_run()
    tc, payloads, bs, _ = runs["comparator"]
    cases["comparator"] = {"kind": "comparator_steps", "cfg": tc,
                           "payloads": payloads, "batches": bs}
    return runs, run_cohort(cases, tmp_path_factory.mktemp("dp_variants"))


@pytest.mark.parametrize("case", sorted(GAN_CASES))
def test_dp_variant_matches_jax(cohort, case):
    check_against_jax(*cohort, case)
    check_ranks_alike(cohort[1], case)


def test_dp_comparator_step_matches_jax(cohort):
    runs, ranks = cohort
    _, payloads, _, want = runs["comparator"]
    for start, (jm, after), got, other in zip(
            payloads, want, ranks[0]["comparator"], ranks[1]["comparator"]):
        assert set(got["metrics"]) == set(jm)
        for k, v in jm.items():
            assert abs(got["metrics"][k] - v) <= 1e-4 + 1e-4 * abs(v), \
                (k, got["metrics"][k], v)
        assert got["opt"]["count"] == after["opt"]["count"]
        assert set(got["C"]) == set(after["C"])
        for k, v in after["C"].items():
            dj = (v - start["C"][k]).numpy()
            dt = (got["C"][k] - start["C"][k]).numpy()
            if k == "head.bias":
                assert abs(dj[0] - dt[0]) <= 2.1 * LR
                dj, dt = dj[1:], dt[1:]
            _adam_envelope(f"C.{k}", dj, dt)
            assert torch.equal(got["C"][k], other["C"][k]), k
        assert got["metrics"] == other["metrics"]
