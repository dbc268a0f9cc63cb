"""The port's shard plan (``pcgan_tpu_torch/parallel/auto.py``) against
JAX's ``pcgan_tpu.parallel.auto.state_shardings`` at the golden sizes
(32 px, ngf/ndf 8, resnet_6blocks, 4 bins, f32, an EMA twin).

Each leaf's sharding is written as an array naming the shard of every
entry; JAX's go through ``convert.convert_train_state``, so the
converter's own transposes put them in the port's layout, and the port's
come from its plan. Both must agree entry for entry, for the parameters,
both Adam trees and the EMA twin of G and D, on a ``model`` axis of 2,
under ``--zero1`` on a data axis of 8, and with both on a 2 x 2 mesh,
where an Adam leaf carries both axes.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import warnings

import jax
import numpy as np
import pytest

from pcgan_tpu.parallel.mesh import make_mesh
from pcgan_tpu.train import create_train_state as j_create_train_state

from pcgan_tpu_torch.models import define_D, define_G
from pcgan_tpu_torch.parallel.auto import jax_dims, leaf_spec, plan_module

from torch_port_auto import decode, jax_codes, port_codes
from torch_port_levers import cfgs, jax_models

CASES = {"model2": ((1, 2), ("data", "model"), False),
         "zero1_data8": ((8,), ("data",), True),
         "both_2x2": ((2, 2), ("data", "model"), True)}


@pytest.fixture(scope="module")
def models():
    jc, tc = cfgs(train={"ema_decay": 0.999})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        Gj, Dj = jax_models(jc)
    jstate = jax.jit(lambda r: j_create_train_state(jc, Gj, Dj, r, 10))(
        jax.random.PRNGKey(0))
    return jstate, define_G(tc), define_D(tc)


@pytest.mark.parametrize("case", list(CASES))
def test_plan_equals_jax_state_shardings(models, case):
    jstate, G, D = models
    shape, axes, zero1 = CASES[case]
    mesh = make_mesh(shape, axes, devices=jax.devices()[:int(np.prod(
        shape))])
    want = jax_codes(jstate, mesh, zero1)
    got = port_codes(G, D, dict(zip(axes, shape)), zero1)
    assert set(want) == set(got) == {"g_params", "d_params", "g_opt",
                                     "d_opt", "ema_params"}
    sharded = 0
    for field, leaves in want.items():
        assert set(leaves) == set(got[field]), field
        for name, code in leaves.items():
            np.testing.assert_array_equal(got[field][name], code,
                                          err_msg=f"{field} {name}")
            sharded += int(code.max() > 1)
    assert sharded > 0
    if case == "both_2x2":
        # an Adam leaf carries both axes; the image-space edges replicate
        m, d = decode(want["g_opt"]["blocks.0.conv0.weight"])
        assert m.max() == 1 and d.max() == 1
        assert want["g_params"]["tail.bias"].max() == 1   # 3 channels


def test_leaf_rule_and_layout_map():
    """JAX's rule on hand-picked shapes, and the port's dim map: a conv's
    output channels are dim 0 of its weight, a transposed conv's dim 1."""
    assert leaf_spec((3, 3, 8, 8), 2, 2, True, True) == [None, None, "data",
                                                         "model"]
    assert leaf_spec((8,), 2, 2, True, True) == ["model"]
    assert leaf_spec((7, 7, 3, 13), 2, 1, False, True) == [None] * 4
    assert leaf_spec((3, 3, 8, 8), 1, 4, True, False) == [None] * 4
    _, tc = cfgs()
    G = define_G(tc)
    dims = jax_dims(G)
    assert dims["blocks.0.conv0.weight"] == (2, 3, 1, 0)
    assert dims["up.0.weight"] == (2, 3, 0, 1)
    plan = plan_module(G, 2, 1, False)
    assert plan["blocks.0.conv0.weight"].model_dim == 0
    assert plan["up.0.weight"].model_dim == 1
    assert plan["tail.weight"].model_dim is None
