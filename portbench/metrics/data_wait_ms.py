"""Host ms a training step spends getting its next batch from the
loader's prefetch queue and uploading it (``_to_device``), averaged over
the window's steps and the ranks. A blocking upload also waits here for
the card to finish the previous step's work."""


def read(ctx):
    return ctx["data_wait_ms"] if ctx["kind"] == "train" else None
