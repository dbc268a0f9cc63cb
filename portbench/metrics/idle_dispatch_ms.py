"""Device idle ms a training step while the program's main thread was in
``step`` or one of its children (B1's draws, the model's forward and
backward passes, the optimizers, the metrics), in the traced stretch,
averaged over the ranks (``harness/spans.py``)."""

from portbench.harness import spans

spans.install()


def read(ctx):
    return spans.per_step(ctx, "idle_dispatch_ms")
