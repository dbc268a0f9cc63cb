"""The device trace of a traced stretch of steps, reduced to what the
per-layer metrics and the breakdown read.

``torch.profiler`` records, with CUDA activity alone (CUPTI: no CPU
operator events, whose recording would double the host's time a step in
a launch-bound cell), the CUDA runtime calls and every device operation
(kernels, copies, fills) on one clock; the harness reads them from the
profiler's Chrome trace. From that:

- the traced window: from the first event's start to the last one's end
  (the stretch's first upload to its closing synchronise);
- busy seconds: the union of the device operations' intervals inside
  the window (overlapping streams count once); idle = window - busy;
- each kernel's total time by name, and the launches;
- each idle gap named by what the host was doing at its middle: the CUDA
  runtime call in flight (a blocking copy, a synchronise, a launch), or
  ``host`` when none was (Python and framework work between calls).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 120


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    device_ops: Dict[str, float] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def launches(self) -> int:
        return sum(n for n, _ in self.kernels.values())

    def kernel_seconds(self, match) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name ``match`` accepts."""
        n = s = 0
        for name, (k, sec) in self.kernels.items():
            if match(name):
                n, s = n + k, s + sec
        return n, s


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _host_at(spans: List[Tuple[int, int, str]], starts: List[int],
             t: int) -> str:
    """The latest-starting span covering t (spans sorted by start)."""
    best = None
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(spans[max(0, i - 64):i]):
        if a <= t < b and (best is None or a > best[0]):
            best = (a, name)
    return best[1] if best else ""


def reduce(prof) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` through its Chrome
    trace (the format every PyTorch release writes)."""
    import json
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return reduce_events(events)


def reduce_events(events: List[dict]) -> Trace:
    """Reduce Chrome-trace events (``ts`` and ``dur`` in microseconds)."""
    dev: List[Tuple[int, int]] = []
    kernels: Dict[str, List] = defaultdict(lambda: [0, 0])
    ops: Dict[str, int] = defaultdict(int)
    runtime: List[Tuple[int, int, str]] = []
    lo = hi = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        kind = e.get("cat", "")
        a = int(round(float(e["ts"]) * 1000))
        b = a + int(round(float(e["dur"]) * 1000))
        lo = a if lo is None else min(lo, a)
        hi = b if hi is None else max(hi, b)
        name = str(e.get("name", ""))
        if kind in DEVICE_KINDS:
            dev.append((a, b))
            short = name[:NAME_CHARS]
            ops[short] += b - a
            if kind == "kernel":
                kernels[short][0] += 1
                kernels[short][1] += b - a
        elif kind == "cuda_runtime":
            runtime.append((a, b, name))
    if lo is None:
        raise RuntimeError("trace: no events")
    t = Trace(window_s=(hi - lo) / 1e9)
    merged = _union(dev)
    t.busy_s = sum(b - a for a, b in merged) / 1e9
    t.kernels = {k: (v[0], v[1] / 1e9) for k, v in kernels.items()}
    t.device_ops = {k: v / 1e9 for k, v in ops.items()}
    runtime.sort()
    starts = [a for a, _, _ in runtime]
    idle: Dict[str, int] = defaultdict(int)
    prev = lo
    for a, b in merged + [(hi, hi)]:
        if a > prev:
            idle[_host_at(runtime, starts, (prev + a) // 2) or "host"] += (
                a - prev)
        prev = max(prev, b)
    t.idle_by_host = {k: v / 1e9 for k, v in idle.items()}
    return t


def breakdown(t: Trace, top: int = 10) -> Dict[str, list]:
    ops = sorted(t.device_ops.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(t.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
