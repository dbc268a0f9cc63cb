"""The port's training step against ``pcgan_tpu.train.make_train_step``,
one lever at a time: WGAN-GP, R1 with feature matching, the multiscale D
under spectral norm with attention, batch norm, and a forced non-finite
step under ``--skip_nonfinite`` (with the EMA hold).

Built like ``tests/test_torch_port_train_step.py``: the JAX state at the
golden sizes (32 px, ngf/ndf 8, resnet_6blocks, 4 bins, f32) takes one
warm-up step; then three steps each start from JAX's state, carried into
the port by ``convert.convert_train_state``, on the same numpy batch (the
JAX step's augmentation and GP draws replayed in the port). Every metric
and every entry of G's and D's Adam first moments (the gradients) agree
within 1e-4 of the tensor's scale (max(1, max|x|)); Adam's counts and the
skip counters are equal; spectral norm's u/sigma and batch norm's running
stats within 1e-5.
"""

import pytest

from torch_port_levers import one_torch_thread, run_lockstep  # noqa: F401


@pytest.mark.parametrize("case", ["wgangp", "r1_feat", "multiscale_sn_attn",
                                  "batch_norm", "skip_inf"])
def test_lever_lockstep(case, monkeypatch):
    run_lockstep(case, monkeypatch)
