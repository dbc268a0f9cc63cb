"""Device ms a training step of the operations launched in the backward
spans (``step/d_backward``, ``step/g_backward``), in the traced stretch,
averaged over the ranks (``harness/spans.py``)."""

from portbench.harness import spans

spans.install()


def read(ctx):
    return spans.per_step(ctx, "backward_ms")
