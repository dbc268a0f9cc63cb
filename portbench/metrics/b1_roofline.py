"""Kernel B1's share of its roofline on the training path, in %: the
bytes its interface fixes (the u8 canvases read once, the crops written
once) over the HBM's published bandwidth, against B1's device time in
the trace."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    shares = []
    for t, _ in ctx["traces"]:
        n, sec = t.kernel_seconds(lambda name: "preprocess_kernel" in name)
        if n and sec > 0:
            shares.append(100.0 * n * ctx["b1_bytes"]
                          / ctx["hbm_bytes_per_s"] / sec)
    return sum(shares) / len(shares) if shares else None
