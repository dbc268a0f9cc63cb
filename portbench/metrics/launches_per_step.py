"""Device kernel launches a training step in the traced stretch,
averaged over the ranks."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["traces"]:
        return None
    per = [t.launches() / n for t, n in ctx["traces"] if n]
    return sum(per) / len(per) if per else None
