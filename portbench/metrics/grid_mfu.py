"""G's forward FLOPs at every bin for each face of the window's calls,
over the window and the card's published bf16 peak, in %."""


def read(ctx):
    if ctx["kind"] != "grid":
        return None
    return (100.0 * ctx["flops_per_step"] * ctx["steps"]
            / ctx["window_s"] / ctx["peak_flops"])
