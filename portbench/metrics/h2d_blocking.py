"""Blocking host-to-device copies a training step (the program's
``h2d/blocking`` counter: from pageable memory, or not ``non_blocking``),
in the traced stretch, averaged over the ranks (``harness/spans.py``)."""

from portbench.harness import spans

spans.install()


def read(ctx):
    return spans.per_step(ctx, "h2d_blocking")
