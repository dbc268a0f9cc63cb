"""The training step's model FLOPs (``harness/flops.py``) times the
window's steps, over the window and the card's published bf16 peak, in %
of one card."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return (100.0 * ctx["flops_per_step"] * ctx["steps"]
            / ctx["window_s"] / ctx["peak_flops"])
