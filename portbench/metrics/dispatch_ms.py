"""Host ms a training step takes to enqueue: the harness's span around
the step call, with no synchronisation, averaged over the window's steps
and the ranks."""


def read(ctx):
    return ctx["dispatch_ms"] if ctx["kind"] == "train" else None
