"""Microbenchmark: the low-channel conv route against the direct conv, at the
G stem and tail shapes (counterpart of ``tools/bench_lowch.py``).

    python -m pcgan_tpu_torch.tools.bench_lowch [--size 128] [--batch 16]
        [--cond 10] [--device cuda|cpu]

For the tail (64 -> 3) and the stem (3 + cond -> 64), both 7x7 with
reflect padding 3, in bf16: "direct" (reflect pad + conv) and "routed"
(``ops/lowch_conv.py lowch_reflect_conv``), forward and forward + VJP. The
routed tail's VJP computes its weight gradient with kernel B2 on a card;
the stem's (C_out 64) uses the native weight-gradient conv. Times are CUDA
events on a card and the host clock on the CPU.
"""

from __future__ import annotations

import argparse
import time

WARMUP = 3
ITERS = 20


def _time_ms(torch, fn, device) -> float:
    for _ in range(WARMUP):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / ITERS
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    return (time.perf_counter() - t0) / ITERS * 1e3


def main(argv=None) -> dict:
    """Runs the benchmark; returns {shape name: {'ms': {fn: ms}, 'calls':
    {fn: calls}, 'wgrad_launches': B2 launches during the routed f+vjp
    timing}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--cond", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch
    from pcgan_tpu_torch.device import resolve_device
    from pcgan_tpu_torch.ops import cuda_wgrad
    from pcgan_tpu_torch.ops import lowch_conv as lc

    device = resolve_device(args.device)
    b, s, k, p = args.batch, args.size, 7, 3
    gen = torch.Generator().manual_seed(0)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}, batch {b}, {s}px, bf16", flush=True)

    def rand(shape):
        return torch.randn(shape, generator=gen).to(device, torch.bfloat16)

    def direct(x, w):
        return lc.conv_valid_ref(lc.reflect_pad(x, p), w)

    def routed(x, w):
        return lc.lowch_reflect_conv(x, w, p)

    out = {}
    for shape, (cin, cout) in {"tail (64->3)": (64, 3),
                               f"stem ({3 + args.cond}->64)": (3 + args.cond,
                                                               64)}.items():
        x = rand((b, s, s, cin)).requires_grad_()
        w = rand((k, k, cin, cout)).requires_grad_()
        dy = rand((b, s, s, cout))

        def fwd(f):
            def run():
                with torch.no_grad():
                    return f(x, w)
            return run

        def vjp(f):
            return lambda: torch.autograd.grad(f(x, w), (x, w), dy)

        fns = {"direct fwd": fwd(direct), "routed fwd": fwd(routed),
               "direct f+vjp": vjp(direct), "routed f+vjp": vjp(routed)}
        res = {"ms": {}, "calls": {}}
        print(f"-- {shape} --", flush=True)
        for fname, fn in fns.items():
            before = cuda_wgrad.launches
            res["ms"][fname] = _time_ms(torch, fn, device)
            res["calls"][fname] = ITERS + WARMUP
            if fname == "routed f+vjp":
                res["wgrad_launches"] = cuda_wgrad.launches - before
            print(f"  {fname:14s} {res['ms'][fname]:8.3f} ms", flush=True)
        ms = res["ms"]
        print(f"  fwd speedup {ms['direct fwd'] / ms['routed fwd']:.2f}x, "
              f"f+vjp speedup "
              f"{ms['direct f+vjp'] / ms['routed f+vjp']:.2f}x", flush=True)
        out[shape] = res
    return out


if __name__ == "__main__":
    main()
