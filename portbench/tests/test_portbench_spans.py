"""The program's spans on the device trace's clock (``harness/spans.py``):
on a hand-made Chrome trace with known spans, launches and gaps, the
reduction gives the known idle and device time a span, the partitions
close, and B1 launched outside its span is counted; a traced run of a
tiny cell prints the span metrics, and a trace without the program's
spans (a program without the recorder) gives none."""

import time

import pytest

from portbench.harness import spans, trace
from portbench.harness.report import run_cell
from portbench.tests.tiny_cells import SEED, tiny

US = 1000        # ns


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# launches at 100 (in step), 150 and 152 (in step/g_forward), 260 (in
# data/wait); a kernel on a second stream overlaps the B1 kernel by 10 us
EVENTS = [
    _x("cuda_runtime", "cudaLaunchKernel", 100, 2, 1),
    _x("kernel", "k1", 110, 20, 1),
    _x("cuda_runtime", "cudaLaunchKernel", 150, 1, 2),
    _x("kernel", "preprocess_kernel", 150, 30, 2),
    _x("cuda_runtime", "cudaLaunchKernel", 152, 1, 4),
    _x("kernel", "k3", 170, 20, 4),
    _x("cuda_runtime", "cudaMemcpyAsync", 260, 5, 3),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 270, 10, 3),
    _x("cuda_runtime", "cudaDeviceSynchronize", 310, 2),
]
# the recorder's clock runs 7 us behind the trace's; the anchor says so
DRAINED = {
    "spans": [("step/g_forward", "step", "MainThread", 97 * US, 193 * US),
              ("step", None, "MainThread", 93 * US, 233 * US),
              ("data/wait", None, "MainThread", 243 * US, 293 * US),
              ("data/make", None, "prefetch", 93 * US, 293 * US)],
    "counters": {"h2d/blocking": 2, "h2d/copies": 2},
    "anchor": (5_000 + 7 * US, 5_000)}


def test_reduction_on_a_hand_made_trace():
    r = spans.reduce_spans(EVENTS, 0, DRAINED)
    assert r["offset_ns"] == 7 * US
    rows = r["spans"]
    # gaps [100,110] and [130,150] in g_forward, [190,270] in step,
    # [280,312] in data/wait
    assert rows["step/g_forward"]["idle_ns"] == 30 * US
    assert rows["step"]["idle_ns"] == 80 * US
    assert rows["data/wait"]["idle_ns"] == 32 * US
    # k1 from step; B1 and k3's 10 us beyond it from g_forward
    assert rows["step"]["device_ns"] == 20 * US
    assert rows["step/g_forward"]["device_ns"] == 40 * US
    assert rows["step/g_forward"]["launches"] == 2
    assert rows["data/wait"]["device_ns"] == 10 * US
    assert "data/make" not in rows
    assert rows["step"]["host_ns"] == 140 * US
    # the partitions close on the trace's own busy and idle time
    t = trace.reduce_events(EVENTS)
    assert sum(v["idle_ns"] for v in rows.values()) == r["idle_ns"]
    assert r["idle_ns"] == round((t.window_s - t.busy_s) * 1e9)
    assert sum(v["device_ns"] for v in rows.values()) == r["busy_ns"] \
        == round(t.busy_s * 1e9)
    assert r["b1_launches"] == r["b1_outside"] == 1
    assert r["h2d_in_trace"] == 1 and r["unmatched"] == 0
    got = spans.readings(r)
    assert got == pytest.approx({
        "idle_data_ms": 0.032, "idle_dispatch_ms": 0.110,
        "idle_loop_ms": 0.0, "forward_ms": 0.040, "backward_ms": 0.0,
        "optimizer_ms": 0.0, "h2d_blocking": 2.0})


def test_b1_inside_its_span_and_the_offset_window():
    drained = dict(DRAINED, spans=[
        ("step/preprocess", "step", "MainThread", 140 * US, 146 * US)]
        + DRAINED["spans"][1:])
    r = spans.reduce_spans(EVENTS, 0, drained)
    assert r["b1_outside"] == 0
    # the launch [150, 151] stays inside [147, 153] for shifts in [-2, 3]
    # us, the upload's call [260, 265] inside [250, 300] in [-35, 10]
    assert r["offset_window_us"] == pytest.approx([-2.0, 3.0])


class _Trace:
    def __init__(self, program=None):
        if program is not None:
            self.program = program


def test_per_step_reads_the_programs_spans_only():
    r = spans.reduce_spans(EVENTS, 0, DRAINED)
    ctx = {"kind": "train", "traces": [(_Trace(r), 2), (_Trace(r), 2)]}
    assert spans.per_step(ctx, "forward_ms") == pytest.approx(0.020)
    assert spans.per_step(ctx, "h2d_blocking") == 1.0
    # the parent's trace: no spans, no reading
    assert spans.per_step({"kind": "train", "traces": [(_Trace(), 2)]},
                          "forward_ms") is None


def test_traced_tiny_cell_prints_the_span_metrics(capsys):
    cell, extra = tiny("train_utk128", "float32")
    line, _ = run_cell(cell, SEED, 1.0, True, time.time(), "cpu", extra)
    m = {k: v["value"] for k, v in line["metrics"].items()}
    for q in ("idle_data_ms", "idle_dispatch_ms", "forward_ms",
              "backward_ms", "optimizer_ms", "h2d_blocking"):
        assert q + ".train" in m
    # B1's plain twin on the CPU: ten copies a step (eight on the card)
    assert m["h2d_blocking.train"] == 10.0
    err = capsys.readouterr().err
    assert "span step/g_forward:" in err and "\nspans {" in err
