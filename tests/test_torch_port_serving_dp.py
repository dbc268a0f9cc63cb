"""``ServedGenerator.data_parallel`` of the port (``serving.py``): one
process, the artifact on each given device, the batch split evenly, the
shards gathered in order (the counterpart of
``pcgan_tpu/serving.py:331-365``), on four CPU devices.

- Equal to the single call within 1e-5 for an even batch, a ragged one
  (padded with its last row, sliced back) and an empty one, and through
  ``progression``'s ``call``; each device's shard bit for bit the single
  call on that shard alone.
- A ``--fixed_batch`` artifact raises ``ValueError`` matching
  "symbolic-batch", as JAX's does.
- Against JAX's ``data_parallel`` over four CPU devices on the same
  (converted) weights within 1e-4, ``test_torch_port_serving.py``'s
  limit for the two servers.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from pcgan_tpu_torch.serving import export_generator, load_exported

from test_torch_port_serving import _inputs, _jax_artifact, _port_cfg, \
    _port_g

DEVICES = ["cpu"] * 4


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving_dp")
    pcfg, pG = _jax_artifact(tmp)
    export_generator(pcfg, pG, str(tmp / "port"))
    return tmp, load_exported(str(tmp / "port"), device="cpu")


@pytest.mark.parametrize("b", [8, 6, 1, 0])
def test_data_parallel_equals_the_single_call(served, b):
    _, p = served
    call = p.data_parallel(DEVICES)
    x, c = _inputs(b, seed=3)
    got, want = call(x, c), p(x, c)
    assert got.shape == want.shape == (b, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if b:
        np.testing.assert_allclose(p.progression(x[:2], call=call),
                                   p.progression(x[:2]), atol=1e-5)


@pytest.mark.parametrize("b", [8, 6])
def test_each_shard_equals_the_single_call_on_that_shard(served, b):
    """Like batch sizes: each device's rows of the split are bit for bit
    the single call on those rows alone (the single call on the whole
    batch may sum in another order: a backend picks its algorithms by the
    batch size), a ragged batch's shards too."""
    _, p = served
    x, c = _inputs(b, seed=7)
    got = p.data_parallel(DEVICES)(x, c)
    k = -(-b // len(DEVICES))
    for i in range(0, b, k):
        np.testing.assert_array_equal(got[i:i + k], p(x[i:i + k],
                                                      c[i:i + k]))


def test_fixed_batch_artifact_raises(tmp_path):
    cfg = _port_cfg()
    export_generator(cfg, _port_g(cfg), str(tmp_path / "fb"), fixed_batch=4)
    with pytest.raises(ValueError, match="symbolic-batch"):
        load_exported(str(tmp_path / "fb"), device="cpu").data_parallel(
            DEVICES)


def test_matches_jax_data_parallel(served):
    from pcgan_tpu.serving import load_exported as jax_load
    tmp, p = served
    j = jax_load(str(tmp / "jax"))
    jcall = j.data_parallel(Mesh(np.asarray(jax.devices()[:4]), ("data",)))
    x, c = _inputs(6, seed=5)
    np.testing.assert_allclose(p.data_parallel(DEVICES)(x, c), jcall(x, c),
                               atol=1e-4)
