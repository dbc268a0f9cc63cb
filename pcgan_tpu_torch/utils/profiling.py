"""Profiling hooks of the port (counterpart of ``pcgan_tpu/utils/profiling.py``).

- ``trace(logdir, device)``: a ``torch.profiler`` trace of the region (CPU
  activity, plus CUDA activity on the card), written as a chrome trace to
  ``{logdir}/trace.json``; with ``with_flops`` the profiler's FLOP counts
  per op name go beside it to ``{logdir}/op_flops.json``
  (``tools/profile_step.py mine_trace`` reads both).
- ``annotate(name)``: a named range on the trace's timeline
  (``torch.profiler.record_function``).
- ``timed(fn)``: the wall time of a call, synchronized on the card when its
  result holds a CUDA tensor.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable

import torch

TRACE_FILE = "trace.json"
FLOPS_FILE = "op_flops.json"


@contextlib.contextmanager
def trace(logdir: str, device="cpu", with_flops: bool = False):
    """Profile the body; yields the ``torch.profiler.profile``. On the card
    the device is synchronized before the trace stops, so the body's
    kernels are in it. The files are written only when the body
    completes."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, with_flops=with_flops) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
    if with_flops:
        flops = {}
        for e in prof.key_averages():
            if e.flops:
                flops[e.key] = flops.get(e.key, 0) + int(e.flops)
        with open(os.path.join(logdir, FLOPS_FILE), "w") as f:
            json.dump(flops, f, indent=1, sort_keys=True)


def annotate(name: str):
    return torch.profiler.record_function(name)


def _sync_outputs(out) -> None:
    leaves = torch.utils._pytree.tree_leaves(out)
    for dev in {t.device for t in leaves
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def timed(fn: Callable) -> Callable:
    """Returns wrapped(*a, **k) -> (result, seconds) with device sync."""

    def wrapped(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        _sync_outputs(out)
        return out, time.perf_counter() - t0

    return wrapped
