"""The share of the traced window, in %, in which no operation ran on
the card: 1 - the union of the device operations' intervals over the
window, averaged over the ranks."""


def read(ctx):
    if not ctx["traces"]:
        return None
    per = [100.0 * (1.0 - t.busy_s / t.window_s) for t, _ in ctx["traces"]]
    return sum(per) / len(per)
