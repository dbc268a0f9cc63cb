"""The port's span and counter recorder (``utils/tracing.py``) on the CPU:
off it records nothing and hands out one shared null context; on, one
training step of a tiny configuration (B1's draws, the fake pool, the
drawn target bins, the batch's uploads) records the step's spans as a
tree, counts every host-to-device copy site, and leaves the losses and
parameters bit-identical; under a CPU ``torch.profiler`` trace the
spans, mapped with the recorder's anchor and the trace's
``baseTimeNanoseconds``, hold the backward and Adam operators.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import json
import sys
from collections import Counter

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch.data.loader import prefetch
from pcgan_tpu_torch.models import define_D, define_G
from pcgan_tpu_torch.parallel.train_parallel import make_parallel_train_step
from pcgan_tpu_torch.train import create_train_state
from pcgan_tpu_torch.train_main import _to_device
from pcgan_tpu_torch.utils import tracing

from torch_port_levers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
STEP_CHILDREN = {"step/preprocess", "step/g_forward", "step/pool",
                 "step/d_loss", "step/d_backward", "step/d_adam",
                 "step/g_loss", "step/g_backward", "step/g_adam",
                 "step/metrics"}


@pytest.fixture
def recorder():
    tracing.disable()
    tracing.drain()
    yield tracing
    tracing.disable()
    tracing.drain()


def _step(accum=1):
    """(step, state, G, D) of a tiny configuration: B1's route from 40 px
    canvases (resize to 36, crop 32), a pool of 4, drawn target bins."""
    tc = tcfg.parse_config(
        ["--crop_size", "32", "--load_size", "36", "--ngf", "8", "--ndf",
         "8", "--n_age_bins", "4", "--netG", "resnet_6blocks",
         "--cond_inject", "bottleneck", "--batch_size", "4", "--dtype",
         "float32", "--pool_size", "4", "--grad_accum", str(accum)],
        is_train=True)
    G = define_G(tc, torch.Generator().manual_seed(1))
    D = define_D(tc, torch.Generator().manual_seed(2))
    state = create_train_state(tc, G, D, torch.Generator().manual_seed(0))
    return make_parallel_train_step(tc, G, D), state, G, D


def _raw(seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (4, 40, 40, 3), dtype=np.uint8),
            "bin": rng.integers(0, 4, 4)}


def _run(step, state, raw):
    return step(state, {k: _to_device(v, CPU) for k, v in raw.items()})


def test_off_records_nothing(recorder):
    assert recorder.span("step") is recorder.span("data/wait") \
        is recorder.NULL
    with recorder.span("step"):
        recorder.count("h2d/copies")
    x = recorder.upload(torch.ones(3), CPU)
    assert torch.equal(x, torch.ones(3))
    assert recorder.drain() == {"spans": [], "counters": {},
                                "anchor": None}


@pytest.mark.parametrize("accum", [1, 2])
def test_step_spans_form_a_tree(recorder, accum):
    step, state, _, _ = _step(accum)
    recorder.enable()
    _run(step, state, _raw())
    recorder.disable()
    out = recorder.drain()
    spans = out["spans"]
    names = Counter(s[0] for s in spans)
    assert set(names) == STEP_CHILDREN | {"step", "data/upload"}
    assert names["step"] == 1 and names["data/upload"] == 2
    # accumulation runs G forward in both phases of every microbatch;
    # one update a net a step
    assert names["step/g_forward"] == (1 if accum == 1 else 2 * accum)
    assert names["step/d_adam"] == names["step/g_adam"] == 1
    for name, parent, thread, t0, t1 in spans:
        assert thread == "MainThread" and t0 <= t1
        if name.startswith("step/"):
            assert parent == "step"
        else:
            assert parent is None
        if parent is not None:
            assert any(p[0] == parent and p[2] == thread
                       and p[3] <= t0 and t1 <= p[4] for p in spans)
    a0, p0 = out["anchor"]
    assert p0 <= min(s[3] for s in spans)


@pytest.mark.parametrize("accum", [1, 2])
def test_recorder_leaves_the_step_unchanged(recorder, accum):
    runs = []
    for on in (False, True):
        step, state, G, D = _step(accum)
        if on:
            recorder.enable()
        m = [_run(step, state, _raw(s)) for s in range(2)]
        recorder.disable()
        runs.append((m, [p.detach().clone() for p in
                         list(G.parameters()) + list(D.parameters())]))
    (m_off, p_off), (m_on, p_on) = runs
    assert recorder.drain()["spans"]
    for a, b in zip(m_off, m_on):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(p_off, p_on))


class _DeviceMoves(TorchFunctionMode):
    """Records each ``Tensor.to`` that names a device, by whether it came
    through ``tracing.upload``."""

    def __init__(self):
        super().__init__()
        self.seen = Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.to and (
                "device" in kwargs
                or any(isinstance(a, (str, torch.device)) for a in args[1:])):
            f = sys._getframe(1)
            while f is not None and f.f_code.co_filename.endswith(
                    ("overrides.py", "_tensor.py")):
                f = f.f_back
            counted = f is not None and f.f_code.co_name == "upload"
            self.seen["upload" if counted else f.f_code.co_name] += 1
        return func(*args, **kwargs)


def test_upload_sites_are_counted(recorder, monkeypatch):
    """The plain route's ten copies a step: the batch's image and bins
    (``_to_device``), the two resize matrices and three draws of B1's
    plain twin, the pool's two draws and the drawn target bins. B1's
    kernel route makes the three draws' copies alone (its band tables are
    cached on the card): eight a step on the card."""
    step, state, _, _ = _step()
    sites = Counter()
    upload = tracing.upload

    def spy(x, device, *a, **k):
        sites[sys._getframe(1).f_code.co_name] += 1
        return upload(x, device, *a, **k)

    monkeypatch.setattr(tracing, "upload", spy)
    raw = _raw()
    recorder.enable()
    with _DeviceMoves() as moves:
        _run(step, state, raw)
    recorder.disable()
    counters = recorder.drain()["counters"]
    assert sites == {"_to_device": 2, "preprocess_batch": 5,
                     "query_with_draws": 2, "conditions": 1}
    # every copy the step names a device for goes through the counter
    assert set(moves.seen) == {"upload"}
    assert moves.seen["upload"] == 10
    b = 4                # int64 offsets and slots, bool flips and swaps
    nbytes = (raw["image"].nbytes + raw["bin"].nbytes
              + 2 * 36 * 40 * 4                # the f32 resize matrices
              + 2 * b * 8 + b                  # B1's crop offsets, flips
              + b * 8 + b + b * 8)             # pool slots, swaps; bins
    # beside the uploads, the instance norm's route: every site of the tiny
    # G (17) and of D's two calls (3 each) takes the composite on the CPU
    assert counters == {"h2d/copies": 10, "h2d/bytes": nbytes,
                        "h2d/blocking": 10, "norm/plain": 23}


def test_prefetch_spans_on_both_threads(recorder):
    recorder.enable()
    got = list(prefetch(iter(range(3)), size=2))
    got_inline = list(prefetch(iter(range(2)), size=0))
    recorder.disable()
    spans = recorder.drain()["spans"]
    assert got == [0, 1, 2] and got_inline == [0, 1]
    by = Counter((s[0], s[2]) for s in spans)
    # one wait a batch and one for the end, on the consumer's thread
    assert by[("data/wait", "MainThread")] == 4 + 3
    assert by[("data/make", "prefetch")] == 4


def _trace_events(path):
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"], int(doc["baseTimeNanoseconds"])


def test_profiler_ops_lie_inside_their_spans(recorder, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    step, state, _, _ = _step()
    _run(step, state, _raw(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recorder.enable()
        _run(step, state, _raw(1))
        recorder.disable()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events, base = _trace_events(tmp_path / "t.json")
    out = recorder.drain()
    t_ns, p_ns = out["anchor"]
    spans = [(name, a - p_ns + t_ns, b - p_ns + t_ns)
             for name, _, _, a, b in out["spans"]]

    def inside(e, suffix):
        a = e["ts"] * 1000 + base
        b = a + e["dur"] * 1000
        return any(n.endswith(suffix) and s0 <= a and b <= s1
                   for n, s0, s1 in spans)

    ops = [e for e in events if e.get("ph") == "X" and "dur" in e]
    backward = [e for e in ops if e["name"] == "aten::convolution_backward"]
    adam = [e for e in ops if e["name"].startswith("Optimizer.step#Adam")]
    assert backward and len(adam) == 2
    assert all(inside(e, "_backward") for e in backward)
    assert all(inside(e, "_adam") for e in adam)


def test_profiling_trace_shows_the_spans(recorder, tmp_path):
    from pcgan_tpu_torch.utils import profiling
    step, state, _, _ = _step()
    with profiling.trace(str(tmp_path), "cpu"):
        assert recorder.enabled()
        _run(step, state, _raw())
    assert not recorder.enabled() and recorder.drain()["spans"] == []
    events, _ = _trace_events(tmp_path / profiling.TRACE_FILE)
    ranges = {e["name"] for e in events
              if e.get("cat") == "user_annotation"}
    assert STEP_CHILDREN | {"step", "data/upload"} <= ranges
