"""Device idle ms a training step while the program's main thread was in
a host-data span (``data/wait``: the loader's queue; ``data/upload``: the
batch's copies to the card), in the traced stretch, averaged over the
ranks (``harness/spans.py``)."""

from portbench.harness import spans

spans.install()


def read(ctx):
    return spans.per_step(ctx, "idle_data_ms")
