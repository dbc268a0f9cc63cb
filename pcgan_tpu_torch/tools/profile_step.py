"""Profile the fused train step on the card and mine the trace (counterpart
of ``tools/profile_step.py``).

    python -m pcgan_tpu_torch.tools.profile_step [--steps 10] [--batch 64]
        [--size 128] [--trace_dir DIR] [--out report.json] [--mine_only]
        [--smoke] [--device cpu]

Runs the bench's headline step (``bench.train_step_fn``: kernel B1 on a
resident native-size u8 batch, then the fused G/D step) for 5 unprofiled
steps, then ``--steps`` steps under ``utils.profiling.trace`` (each inside
a ``train_step`` range, shapes and FLOPs recorded), and mines the chrome trace
(``mine_trace``): device time by kernel class and by kernel, and a floor
per step from each op call's FLOPs and bytes (``utils.profiling.op_cost``).
Prints the report as JSON and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import tempfile

from pcgan_tpu_torch.utils.profiling import COSTS_FILE

# H100 SXM published peaks (dense): bf16 on the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20            # the H100's L2 cache
STEP_RANGE = "train_step"

# chrome-trace categories of device work: kernels, copies, fills
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}

CLASSES = (
    ("B1 preprocess (hand kernel)", ("preprocess_kernel",)),
    ("B2 wgrad (hand kernel)", ("wgrad_tc_kernel", "wgrad_fma_kernel",
                                "wgrad_reduce_kernel")),
    ("layout copy", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("tensor-core GEMM/conv", ("cudnn", "cublas", "cutlass", "nvjet",
                               "sm90_xmma", "xmma", "gemm", "implicit_convolve",
                               "convolve")),
    ("elementwise/reduce", ("elementwise", "reduce", "norm", "multi_tensor",
                            "adam", "softmax", "vectorized", "scan",
                            "distribution", "pad", "fill", "cat", "index",
                            "where", "copy")),
)


def classify(name: str, kind: str) -> str:
    """The class of one device event by its kind and CUDA kernel name."""
    if kind in ("memcpy", "memset"):
        return "memcpy/memset"
    n = name.lower()
    for cls, keys in CLASSES:
        if any(k in n for k in keys):
            return cls
    return "other"


def _trace_file(trace_dir: str) -> str:
    if os.path.isfile(trace_dir):
        return trace_dir
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                             recursive=True))
    files = [f for f in files if not f.endswith(COSTS_FILE)]
    if not files:
        raise FileNotFoundError(f"no chrome trace under {trace_dir}")
    return files[-1]


def mine_trace(trace_dir: str, top_k: int = 25,
               peak_flops: float = PEAK_BF16_FLOPS,
               peak_bytes_per_s: float = PEAK_BYTES_PER_S) -> dict:
    """Mine a chrome trace of ``utils.profiling.trace`` (a file, or the
    newest under ``trace_dir``) into the JAX report's keys.

    Device time is the sum of the GPU kernel, memcpy and memset events
    (ranges annotated on the device lanes are left out: they overlap the
    kernels in them). ``steps`` counts the ``train_step`` ranges and
    ``mean_step_ms`` is their mean wall span; ``device_ms_per_step`` is the
    device time a step. Each device event is floored with the ATen op call
    that launched it (its ``External id``): the call's max(FLOPs /
    ``peak_flops``, bytes / ``peak_bytes_per_s``) from ``op_costs.json``
    beside the trace, counted once for all the call's kernels. The bytes
    are those that must cross HBM: an input the size of what the op call
    just before it on the device wrote, when that fits in the 50 MiB L2,
    is read from the L2 and left out (``l2_reads_ms_per_step``); a copy or
    fill under no costed op is floored at its own bytes. Only an event
    under no ATen op stays without a floor (``uncounted_ms_per_step``).
    ``ratio_to_floor`` is the total device time over the summed floor, as
    in the JAX tool; ``ops`` gives every op's device time beside its floor
    (``min_op_ratio`` the lowest ratio).
    A trace without a device lane (a CPU run) gives 0 device us."""
    path = _trace_file(trace_dir)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    costs_path = os.path.join(os.path.dirname(path), COSTS_FILE)
    costs = {}
    if os.path.exists(costs_path):
        with open(costs_path) as f:
            costs = json.load(f)

    pid_names = {e["pid"]: e["args"].get("name", "") for e in events
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
    spans = [float(e["dur"]) for e in events
             if e.get("ph") == "X" and "dur" in e
             and e.get("cat") == "user_annotation"
             and e.get("name") == STEP_RANGE]

    per_kernel = collections.Counter()
    launches = collections.Counter()
    kernel_class = {}
    per_class = collections.Counter()
    per_op_us = collections.Counter()      # device us under each op name
    floors = collections.Counter()         # floor us per op name / copy
    tracks = set()
    total = counted = 0.0
    calls = set()                          # op calls with a device event
    device = []
    for e in events:
        kind = DEVICE_CATS.get(e.get("cat"))
        if e.get("ph") != "X" or "dur" not in e or kind is None:
            continue
        device.append(e)
        dur = float(e["dur"])                                   # us
        name = e.get("name", "?")
        args = e.get("args", {})
        cls = classify(name, kind)
        total += dur
        per_kernel[name] += dur
        launches[name] += 1
        kernel_class[name] = cls
        per_class[cls] += dur
        tracks.add(pid_names.get(e.get("pid"), str(e.get("pid"))))
        ext = str(args.get("External id"))
        if ext in costs:
            per_op_us[costs[ext]["op"]] += dur
            calls.add(ext)
            counted += dur
        elif kind != "kernel" and float(args.get("bytes", 0) or 0):
            key = f"{kind} ({name})"
            floors[key] += float(args["bytes"]) / peak_bytes_per_s * 1e6
            per_op_us[key] += dur
            counted += dur
    # the op call that ran just before each call on the device (None after
    # a kernel of no costed call): a tensor it wrote that fits in the L2 is
    # still there, so an input of that size is not read from HBM
    order, prev = {}, None
    for e in sorted(device, key=lambda e: float(e["ts"])):
        ext = str(e.get("args", {}).get("External id"))
        ext = ext if ext in costs else None
        if ext != prev and ext is not None and ext not in order:
            order[ext] = prev
        prev = ext
    l2_us = 0.0
    for ext in calls:
        c = costs[ext]
        reads = list(c["reads"])
        before = costs.get(order.get(ext))
        if before and 0 < before["writes"] <= L2_BYTES \
                and before["writes"] in reads:
            reads.remove(before["writes"])
            l2_us += before["writes"] / peak_bytes_per_s * 1e6
        floors[c["op"]] += max(c["flops"] / peak_flops,
                               (sum(reads) + c["writes"]) / peak_bytes_per_s
                               ) * 1e6
    floor_total = sum(floors.values())
    n = max(len(spans), 1)
    pct = (lambda v: round(100 * v / total, 2)) if total else (lambda v: 0.0)
    gaps = collections.Counter({k: per_op_us[k] - floors[k]
                                for k in per_op_us})
    ops = [{"op": k, "us": round(v, 1), "floor_us": round(floors[k], 1),
            "ratio": round(v / floors[k], 3) if floors[k] else None}
           for k, v in per_op_us.most_common()]
    ratios = [o["ratio"] for o in ops if o["ratio"] is not None]
    return {
        "trace_file": path,
        "total_device_us": total,
        "steps": len(spans),
        "mean_step_ms": round(sum(spans) / n / 1e3, 3),
        "device_tracks": sorted(tracks),
        "roofline": {
            "peak_flops": peak_flops, "peak_bytes_per_s": peak_bytes_per_s,
            "floor_ms_per_step": round(floor_total / n / 1e3, 4),
            "device_ms_per_step": round(total / n / 1e3, 3),
            "counted_ms_per_step": round(counted / n / 1e3, 3),
            "l2_reads_ms_per_step": round(l2_us / n / 1e3, 4),
            "uncounted_ms_per_step": round((total - counted) / n / 1e3, 3),
            "covered_share": round(counted / total, 4) if total else None,
            "ratio_to_floor": (round(total / floor_total, 3)
                               if floor_total else None),
            "min_op_ratio": min(ratios) if ratios else None,
            "top_gaps_us_per_step": [
                {"op": k, "us": round(v / n, 1)}
                for k, v in gaps.most_common(10)],
            "ops": ops,
        },
        "by_class": {k: {"us": round(v, 1), "pct": pct(v)}
                     for k, v in per_class.most_common()},
        "top_ops": [{"kernel": k, "us": round(v, 1), "pct": pct(v),
                     "launches": launches[k], "category": kernel_class[k]}
                    for k, v in per_kernel.most_common(top_k)],
    }


def profile_config(size: int, batch: int, smoke: bool = False,
                   device: str = "cuda"):
    """The bench's config with the JAX tool's remat rule: on at >= 512 px,
    or at >= 256 px with batch > 64."""
    import dataclasses
    from pcgan_tpu_torch.bench import bench_config
    cfg = bench_config(size, batch, smoke=smoke, device=device)
    if smoke:
        return cfg
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, remat=size >= 512 or (size >= 256 and batch > 64)))


def run_and_trace(cfg, steps: int, trace_dir: str, warmup: int = 5) -> None:
    """``warmup`` steps, then ``steps`` steps under the trace, each in a
    ``train_step`` range; the trace stops after the device is synced."""
    from pcgan_tpu_torch.bench import _device, raw_batch, train_step_fn
    from pcgan_tpu_torch.utils import tracing
    from pcgan_tpu_torch.utils.profiling import trace
    device = _device(cfg)
    _, run = train_step_fn(cfg, device)
    raw = raw_batch(cfg, device)
    for _ in range(warmup):
        m = run(raw)
    float(m["loss_G"])
    with trace(trace_dir, device, with_flops=True):
        for _ in range(steps):
            with tracing.span(STEP_RANGE):
                m = run(raw)
        float(m["loss_G"])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=None,
                   help="default 64 (--smoke: the bench's smoke batch)")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--trace_dir",
                   default=os.path.join(tempfile.gettempdir(), "pcgan_trace"))
    p.add_argument("--out", default="")
    p.add_argument("--mine_only", action="store_true",
                   help="skip running; just mine an existing trace_dir")
    p.add_argument("--smoke", action="store_true", help="tiny config")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    if not args.mine_only:
        batch = args.batch or (0 if args.smoke else 64)
        cfg = profile_config(args.size, batch, args.smoke, args.device)
        run_and_trace(cfg, args.steps, args.trace_dir)
    rep = mine_trace(args.trace_dir)
    print(json.dumps(rep, indent=2), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2)
        print(f"wrote {args.out}", flush=True)
    return rep


if __name__ == "__main__":
    main()
