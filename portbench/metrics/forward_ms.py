"""Device ms a training step of the operations launched in the forward
spans (``step/g_forward``, ``step/d_loss``, ``step/g_loss``), in the
traced stretch, averaged over the ranks (``harness/spans.py``)."""

from portbench.harness import spans

spans.install()


def read(ctx):
    return spans.per_step(ctx, "forward_ms")
