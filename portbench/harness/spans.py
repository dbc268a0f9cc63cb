"""The program's own spans and counters in the traced stretch, on the
device trace's clock.

The port records spans and counters (``pcgan_tpu_torch/utils/tracing.py``:
``data/wait``, ``data/upload``, ``step`` and its children
``step/preprocess``, ``step/g_forward``, ..., ``step/g_adam``; the
``h2d/*`` counters of host-to-device copies). ``install()`` runs the
recorder for the traced stretch alone: it wraps ``train_cell._traced``
(the recorder on around the traced steps, off after) and ``trace.reduce``
(the same trace's events reduced as before, then with the recorder's
spans; the result rides on the ``Trace`` as ``.program``). The window and
the untraced run are left as they are. A program without the recorder
gets the wrapped functions unchanged. The readers of the span metrics
(``metrics/idle_data_ms.py`` and the others) call ``install()`` when they
are loaded.

``reduce_spans`` maps the recorder's clock onto the trace's: a span's
``perf_counter_ns`` t sits at ``t - perf0 + time0 - baseTimeNanoseconds``
ns of the trace (``(time0, perf0)``, the recorder's anchor; the trace's
``ts`` x 1000 + ``baseTimeNanoseconds`` is ``time.time_ns``). Then, over
the main thread's spans (the innermost one at a time names it; ``loop``
outside every span):

- each idle gap, as ``trace.reduce_events`` finds it (the window from the
  first event to the last, less the union of the device operations), is
  named by the span at its middle;
- each device operation's share of the busy union (operations that
  overlap count once) goes to the span holding its launching runtime call
  (the events' ``correlation`` id); kernels count as launches there;
- each span's host time is the sum of its durations (children included).

So the idle times of all names add to the trace's idle time, and the
device times to its busy time. ``b1_outside`` counts B1's launches
(``preprocess_kernel``) whose runtime call lies outside
``step/preprocess``; ``offset_window_us`` is the range of shifts of the
spans that would keep the runtime call of every B1 launch and of every
host-to-device copy whole inside the span it lies in (0 inside it: the
clocks agree to within it).
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
import traceback
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench.harness import trace

MAIN = "MainThread"
LOOP = "loop"
B1 = "preprocess_kernel"
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
# the per-layer readings: (span names or prefixes, what is summed)
GROUPS = {
    "idle_data_ms": (("data/",), "idle"),
    "idle_dispatch_ms": (("step", "step/"), "idle"),
    "forward_ms": (("step/g_forward", "step/d_loss", "step/g_loss"),
                   "device"),
    "backward_ms": (("step/d_backward", "step/g_backward"), "device"),
    "optimizer_ms": (("step/d_adam", "step/g_adam", "step/ema"), "device"),
}


def _recorder():
    try:
        from pcgan_tpu_torch.utils import tracing
    except ImportError:         # a program without the recorder
        return None
    return tracing


def install() -> None:
    """Wrap ``train_cell._traced`` and ``trace.reduce`` (once)."""
    from portbench.harness import train_cell
    if getattr(train_cell._traced, "with_spans", False):
        return
    rec = _recorder()
    if rec is None:
        return
    traced, reduce = train_cell._traced, trace.reduce

    def traced_with_spans(one_step, n, device):
        rec.drain()
        rec.enable()
        try:
            t, n = traced(one_step, n, device)
        finally:
            rec.disable()
            rec.drain()
        report = getattr(t, "program", None)
        if report is not None:
            _print(report, n)
        return t, n

    def reduce_with_spans(prof):
        if not rec.enabled():
            return reduce(prof)
        drained = rec.drain()
        events, base = _export(prof)
        t = trace.reduce_events(events)
        try:
            t.program = reduce_spans(events, base, drained)
        except Exception:       # the trace's own readings stand without it
            traceback.print_exc(file=sys.stderr)
        return t

    traced_with_spans.with_spans = True
    train_cell._traced = traced_with_spans
    trace.reduce = reduce_with_spans


def _export(prof) -> Tuple[List[dict], int]:
    """(events, baseTimeNanoseconds) of a finished profile, as
    ``trace.reduce`` reads it."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(doc, dict):
        return doc.get("traceEvents", []), int(doc.get(
            "baseTimeNanoseconds", 0))
    return doc, 0


def _innermost(spans: List[Tuple[int, int, str]]
               ) -> Tuple[List[int], List[Tuple[int, int, str]]]:
    """Nested intervals flattened into disjoint segments, each named by
    the innermost interval over it: (starts, segments)."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, int, str]] = []
    cur = 0

    def close():
        nonlocal cur
        top = stack.pop()
        if cur < top[1]:
            out.append((cur, top[1], top[2]))
        cur = max(cur, top[1])

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= a:
            close()
        if stack and cur < a:
            out.append((cur, a, stack[-1][2]))
        stack.append((a, b, name))
        cur = a
    while stack:
        close()
    return [a for a, _, _ in out], out


def _at(starts, segs, t: int) -> Optional[Tuple[int, int, str]]:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segs[i][0] <= t < segs[i][1]:
        return segs[i]
    return None


def reduce_spans(events: List[dict], base_ns: int, drained: Dict) -> Dict:
    """The stretch's totals by span name (module docstring): ``spans``
    {name: {"host_ns", "device_ns", "launches", "idle_ns"}}, the
    ``counters``, ``busy_ns``, ``idle_ns``, ``offset_ns``, ``b1_launches``,
    ``b1_outside``, ``offset_window_us``, ``unmatched`` (device operations
    whose launching call the trace does not hold, counted under ``loop``)
    and ``h2d_in_trace`` (host-to-device copies on the device)."""
    time0, perf0 = drained["anchor"]
    offset = time0 - perf0 - base_ns
    main = [(a + offset, b + offset, name)
            for name, _, thread, a, b in drained["spans"] if thread == MAIN]
    starts, segs = _innermost(main)

    def name_at(t):
        s = _at(starts, segs, t)
        return s[2] if s else LOOP

    lo = hi = None
    dev: List[Tuple[int, int, str, str, object]] = []
    launch_at: Dict[object, Tuple[int, int]] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = int(round(float(e["ts"]) * 1000))
        b = a + int(round(float(e["dur"]) * 1000))
        lo = a if lo is None else min(lo, a)
        hi = b if hi is None else max(hi, b)
        kind = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if kind in trace.DEVICE_KINDS:
            dev.append((a, b, kind, str(e.get("name", "")), corr))
        elif kind in LAUNCH_KINDS and corr is not None:
            launch_at[corr] = (a, b)
    if lo is None:
        raise RuntimeError("spans: the trace has no events")
    rows: Dict[str, Dict[str, int]] = defaultdict(
        lambda: {"host_ns": 0, "device_ns": 0, "launches": 0, "idle_ns": 0})
    for a, b, name in main:
        rows[name]["host_ns"] += b - a
    # device time: each operation's share of the busy union
    covered = lo
    unmatched = h2d = b1 = b1_out = 0
    window = [-float("inf"), float("inf")]
    for a, b, kind, opname, corr in sorted(dev, key=lambda d: d[:2]):
        share = max(0, b - max(a, covered))
        covered = max(covered, b)
        call = launch_at.get(corr)
        seg = None if call is None else _at(starts, segs, call[0])
        name = LOOP if seg is None else seg[2]
        unmatched += call is None
        rows[name]["device_ns"] += share
        if kind == "kernel":
            rows[name]["launches"] += 1
        is_b1 = kind == "kernel" and B1 in opname
        is_h2d = kind == "gpu_memcpy" and "HtoD" in opname
        h2d += is_h2d
        b1 += is_b1
        if is_b1 and name != "step/preprocess":
            b1_out += 1
        elif (is_b1 or is_h2d) and seg is not None:
            window[0] = max(window[0], (call[1] - seg[1]) / 1e3)
            window[1] = min(window[1], (call[0] - seg[0]) / 1e3)
    # idle gaps, as trace.reduce_events finds them
    prev = lo
    for a, b in trace._union([(a, b) for a, b, *_ in dev]) + [(hi, hi)]:
        if a > prev:
            rows[name_at((prev + a) // 2)]["idle_ns"] += a - prev
        prev = max(prev, b)
    idle = sum(r["idle_ns"] for r in rows.values())
    return {"spans": {k: dict(v) for k, v in rows.items()},
            "counters": dict(drained["counters"]),
            "busy_ns": (hi - lo) - idle, "idle_ns": idle,
            "offset_ns": offset, "b1_launches": b1, "b1_outside": b1_out,
            "offset_window_us": window if window[0] > -float("inf")
            else None,
            "unmatched": unmatched, "h2d_in_trace": h2d}


def readings(report: Dict) -> Dict[str, float]:
    """The per-layer quantities' totals over the stretch, in ms (copies
    for ``h2d_blocking``), and ``idle_loop_ms``."""
    out = {}
    for key, (names, what) in GROUPS.items():
        out[key] = sum(
            row[what + "_ns"] for name, row in report["spans"].items()
            if name in names or any(p.endswith("/") and name.startswith(p)
                                    for p in names)) / 1e6
    out["idle_loop_ms"] = (report["idle_ns"] / 1e6 - out["idle_data_ms"]
                           - out["idle_dispatch_ms"])
    out["h2d_blocking"] = float(report["counters"].get("h2d/blocking", 0))
    return out


def per_step(ctx, key: str) -> Optional[float]:
    """``key``'s reading a traced step, averaged over the ranks; None
    where no trace holds the program's spans."""
    if ctx.get("kind") != "train":
        return None
    per = [readings(t.program)[key] / n for t, n in ctx["traces"]
           if n and getattr(t, "program", None) is not None]
    return sum(per) / len(per) if per else None


def _print(report: Dict, n: int) -> None:
    """Per span and a step: host, device and idle ms and launches, then
    the clock's numbers, to standard error."""
    for name, row in sorted(report["spans"].items()):
        print(f"span {name}: host {row['host_ns'] / 1e6 / n:.3f} ms, "
              f"device {row['device_ns'] / 1e6 / n:.3f} ms, launches "
              f"{row['launches'] / n:.1f}, idle "
              f"{row['idle_ns'] / 1e6 / n:.3f} ms (a step, {n} steps)",
              file=sys.stderr)
    r = readings(report)
    print("spans " + json.dumps({
        "steps": n, "offset_ns": report["offset_ns"],
        "offset_window_us": report["offset_window_us"],
        "b1_launches": report["b1_launches"],
        "b1_outside": report["b1_outside"],
        "unmatched": report["unmatched"],
        "busy_ms": report["busy_ns"] / 1e6 / n,
        "idle_ms": report["idle_ns"] / 1e6 / n,
        "h2d_in_trace": report["h2d_in_trace"] / n,
        "counters": {k: v / n for k, v in report["counters"].items()},
        **{k: v / n for k, v in r.items()}}), file=sys.stderr, flush=True)
