"""Spans and counters of the port's own phases: the one span API of
``pcgan_tpu_torch``.

- ``span(name)``: a context manager around a phase (``data/wait``,
  ``step``, ``step/g_forward``, ...). A span's parent is the innermost
  span open on the same thread.
- ``count(name, n=1)``: adds ``n`` to a counter (``h2d/copies``, ...).
- ``enable(annotate=False)`` / ``disable()`` / ``drain()``.

Off (the default), ``span`` returns one shared null context (``NULL``)
and ``count``
returns, each after a single bool check: nothing allocates, synchronises
or touches the device. On, spans are kept in memory on
``time.perf_counter_ns`` and ``enable`` takes the one ``(time.time_ns(),
perf_counter_ns())`` pair that maps them onto a profiler trace's clock
(its ``ts`` x 1000 + ``baseTimeNanoseconds`` is ``time.time_ns``). There
is no file, thread or exporter: ``drain()`` hands back

    {"spans": [(name, parent, thread, t0_ns, t1_ns)],
     "counters": {name: n}, "anchor": (time_ns, perf_counter_ns)}

and empties the recorder (``thread`` is the thread's name, ``parent`` the
parent span's name or None). With ``annotate`` (a ``torch.profiler``
recording CPU activity is running: ``utils.profiling.trace``), every
span also opens a ``record_function`` range of its name, so the
operator's trace shows the phases.

``upload(x, device)`` is the step's host-to-device copy: it counts
``h2d/copies``, ``h2d/bytes`` and ``h2d/blocking`` (the source is
pageable, or the copy is not ``non_blocking``) when the source is in host
memory, then makes the copy ``x.to(device, ...)`` makes.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

NULL = contextlib.nullcontext()

_on = False
_annotate = False
_spans: List[Tuple[str, Optional[str], str, int, int]] = []
_counters: Dict[str, int] = {}
_anchor: Optional[Tuple[int, int]] = None
_lock = threading.Lock()
_local = threading.local()


class _Span:
    __slots__ = ("name", "parent", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.rf = None
        if _annotate:
            import torch
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        _spans.append((self.name, self.parent,
                       threading.current_thread().name, self.t0, t1))
        return False


def span(name: str):
    """A span around the ``with`` body (the shared null context when
    off)."""
    if not _on:
        return NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enabled() -> bool:
    return _on


def enable(annotate: bool = False) -> None:
    """Start recording; takes the clock anchor."""
    global _on, _annotate, _anchor
    _anchor = (time.time_ns(), time.perf_counter_ns())
    _annotate = bool(annotate)
    _on = True


def disable() -> None:
    """Stop recording (what was recorded stays until ``drain``)."""
    global _on, _annotate
    _on = False
    _annotate = False


def drain() -> Dict:
    """The spans, counters and anchor recorded since the last drain; the
    recorder is emptied (empty lists and no anchor when nothing was)."""
    global _anchor
    with _lock:
        out = {"spans": list(_spans), "counters": dict(_counters),
               "anchor": _anchor}
        _spans.clear()
        _counters.clear()
        if not _on:
            _anchor = None
    return out


def upload(x: "torch.Tensor", device, dtype=None,
           non_blocking: bool = False) -> "torch.Tensor":
    """``x.to(device, dtype, non_blocking=non_blocking)``, counted as a
    host-to-device copy when ``x`` is in host memory."""
    if _on and x.device.type == "cpu":
        count("h2d/copies")
        count("h2d/bytes", x.numel() * x.element_size())
        count("h2d/blocking", int(not (non_blocking and x.is_pinned())))
    return x.to(device=device, dtype=dtype, non_blocking=non_blocking)
