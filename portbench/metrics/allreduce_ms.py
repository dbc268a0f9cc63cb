"""Device milliseconds of NCCL kernels a training step in the traced
stretch, averaged over the ranks. Nothing on one card."""


def read(ctx):
    if ctx["kind"] != "train" or ctx["world"] < 2 or not ctx["traces"]:
        return None
    per = []
    for t, n in ctx["traces"]:
        _, sec = t.kernel_seconds(lambda name: "nccl" in name.lower())
        if n:
            per.append(1e3 * sec / n)
    return sum(per) / len(per) if per else None
