"""Device ms a training step of the operations launched in the optimizer
spans (``step/d_adam``, ``step/g_adam``, ``step/ema``), in the traced
stretch, averaged over the ranks (``harness/spans.py``)."""

from portbench.harness import spans

spans.install()


def read(ctx):
    return spans.per_step(ctx, "optimizer_ms")
