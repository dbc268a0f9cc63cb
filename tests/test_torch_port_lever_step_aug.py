"""The port's training step against ``pcgan_tpu.train.make_train_step`` for
the augmentation levers (DiffAugment, ADA), the VGG perceptual loss over a
random trunk (the JAX package's PRNGKey(0) VGG19 carried across) and
``--log_grad_norm``. Same construction and tolerances as
``tests/test_torch_port_lever_step.py``: the JAX step's per-fold
augmentation draws (and ADA's gates) are replayed in the port's step, so
both apply the same transforms."""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import pytest

from torch_port_levers import one_torch_thread, run_lockstep  # noqa: F401


@pytest.mark.parametrize("case", ["diffaug", "ada", "vgg_random",
                                  "log_grad_norm"])
def test_lever_lockstep(case, monkeypatch):
    run_lockstep(case, monkeypatch)
