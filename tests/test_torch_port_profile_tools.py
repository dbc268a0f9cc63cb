"""The port's profiling tools (CPU): ``utils/profiling.py``, the trace
miner of ``tools/profile_step.py`` on a committed synthetic chrome trace
(exact totals, classes, top kernels and floors) and on a real CPU trace (0
device us: no device lane), ``tune_batch``'s rows (an out-of-memory step
"does not fit" and climbs the JAX tool's dial ladder; any other error
propagates), ``memory_plan``'s state bytes against the JAX ``_tree_bytes``
of the same subtrees, and ``doctor --device cpu``.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import json
import os
import sys

import pytest
import torch

import jax
import optax

from pcgan_tpu_torch import bench
from pcgan_tpu_torch.tools import doctor, memory_plan, profile_step
from pcgan_tpu_torch.tools import tune_batch
from pcgan_tpu_torch.utils import profiling, tracing

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_port_data",
                       "trace_fixture")


def test_mine_trace_on_the_fixture():
    rep = profile_step.mine_trace(FIXTURE)
    # two steps of 100 + 20 + 10 + 5 us of kernels, a 30 us copy, a 2 us set
    assert rep["total_device_us"] == 302.0
    # mean_step_ms is the train_step ranges' mean wall span (500 us), as the
    # JAX tool's Steps lane; the device time a step is 151 us
    assert rep["steps"] == 2 and rep["mean_step_ms"] == 0.5
    assert rep["device_tracks"] == ["GPU 0"]
    assert rep["by_class"] == {
        "tensor-core GEMM/conv": {"us": 200.0, "pct": 66.23},
        "layout copy": {"us": 40.0, "pct": 13.25},
        "memcpy/memset": {"us": 32.0, "pct": 10.6},
        "elementwise/reduce": {"us": 20.0, "pct": 6.62},
        "B1 preprocess (hand kernel)": {"us": 10.0, "pct": 3.31}}
    assert abs(sum(c["pct"] for c in rep["by_class"].values()) - 100) < 0.05
    top = rep["top_ops"]
    assert [t["launches"] for t in top] == [2, 2, 1, 2, 2, 1]
    assert top[0]["kernel"].startswith("sm90_xmma_fprop")
    assert top[4] == {"kernel": "preprocess_kernel", "us": 10.0,
                      "pct": 3.31, "launches": 2,
                      "category": "B1 preprocess (hand kernel)"}
    roof = rep["roofline"]
    assert roof["device_ms_per_step"] == 0.151
    # counted: the conv's two kernels under aten::cudnn_convolution, the
    # add's under aten::add_ (each floored once a call from its shapes),
    # the copy at its own 3.35 MB; B1 (no op) and the empty memset are not
    assert roof["counted_ms_per_step"] == 0.145
    assert roof["uncounted_ms_per_step"] == 0.006
    assert roof["covered_share"] == round(290 / 302, 4)
    peak_f, peak_b = profile_step.PEAK_BF16_FLOPS, profile_step.PEAK_BYTES_PER_S
    # conv: 2*N*K*C*R*S*P*Q FLOPs; x, w and y in bf16
    conv_flops = 2 * 8 * 64 * 64 * 3 * 3 * 32 * 32
    conv_bytes = (2 * 8 * 64 * 32 * 32 + 64 * 64 * 9) * 2
    conv_us = max(conv_flops / peak_f, conv_bytes / peak_b) * 1e6
    # in-place f32 add of a broadcast (64,) bias: self read and written
    add_us = (2 * 8 * 64 * 32 * 32 + 64) * 4 / peak_b * 1e6
    floor_us = 2 * (conv_us + add_us) + 1.0
    assert roof["floor_ms_per_step"] == round(floor_us / 2 / 1e3, 4)
    assert roof["ratio_to_floor"] == round(302.0 / floor_us, 3)
    ops = {o["op"]: o for o in roof["ops"]}
    assert ops["aten::cudnn_convolution"]["us"] == 240.0
    assert ops["aten::cudnn_convolution"]["floor_us"] == round(2 * conv_us, 1)
    assert roof["min_op_ratio"] == min(o["ratio"] for o in roof["ops"])
    assert roof["top_gaps_us_per_step"][0]["op"] == "aten::cudnn_convolution"


def test_fixture_costs_follow_from_its_shapes():
    """The committed ``op_costs.json`` is what ``op_costs`` gives the
    fixture's events (with the profiler's count on aten::conv2d)."""
    with open(os.path.join(FIXTURE, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    with open(os.path.join(FIXTURE, profiling.COSTS_FILE)) as f:
        want = json.load(f)
    flops = 2 * 8 * 64 * 64 * 3 * 3 * 32 * 32
    assert profiling.op_costs(events, {1: flops, 101: flops}) == want


def _args(dims, types, concrete=(), strides=None):
    return {"Input Dims": dims, "Input type": types,
            "Concrete Inputs": list(concrete),
            **({"Input Strides": strides} if strides else {})}


F32, BF16 = "float", "c10::BFloat16"


@pytest.mark.parametrize("name,args,want", [
    # out-of-place elementwise: inputs plus the broadcast output
    ("aten::mul", _args([[4, 8], [8], []], [BF16, F32, ""]),
     (0, (32 * 2 + 8 * 4) + 32 * 4)),
    # an expanded (stride 0) input is read once
    ("aten::add", _args([[4, 8], [4, 8], []], [F32, F32, "Scalar"],
                        strides=[[8, 1], [0, 1], []]),
     (0, (32 + 8) * 4 + 32 * 4)),
    # in place: self read and written; copy_: src read, dst written
    ("aten::add_", _args([[4, 8], [4, 8], []], [F32, F32, "Scalar"]),
     (0, 3 * 32 * 4)),
    ("aten::copy_", _args([[4, 8], [4, 8], []], [BF16, F32, "Scalar"]),
     (0, 32 * 2 + 32 * 4)),
    ("aten::fill_", _args([[4, 8], []], [F32, "Scalar"]), (0, 32 * 4)),
    ("aten::eq", _args([[6], [6]], ["long int", "long int"]),
     (0, 2 * 6 * 8 + 6)),
    ("aten::sum", _args([[4, 8], []], [F32, ""]), (0, 32 * 4)),
    ("aten::cat", _args([[[2, 3], [2, 3]], []], ["TensorList", "Scalar"]),
     (0, 2 * 12 * 2)),
    # the fused Adam reads params, grads and both moments, writes three
    ("aten::_fused_adam_", _args(
        [[[5]], [[5]], [[5]], [[5]], [], [[]]],
        ["TensorList"] * 6), (0, (4 * 5 + 1) * 4 + 3 * 5 * 4)),
    # a gather reads its index, a scatter its index and values
    ("aten::index_select", _args([[100, 8], [], [3]],
                                 [F32, "Scalar", "long int"]), (0, 3 * 8)),
    ("aten::index_put_", _args([[100, 8], [[3]], [3, 8], []],
                               [F32, "GenericList", F32, "Scalar"]),
     (0, 2 * 24 * 4)),
    ("aten::reflection_pad2d", _args([[1, 2, 5, 6], []], [F32, "ScalarList"],
                                     ["", "[1, 1, 2, 2]"]),
     (0, (60 + 2 * 9 * 8) * 4)),
    # matmuls: 2mnk FLOPs unless the profiler counted the call
    ("aten::addmm", _args([[3], [4, 6], [6, 3], [], []],
                          [F32, F32, F32, "Scalar", "Scalar"]),
     (2 * 4 * 3 * 6, (3 + 24 + 18 + 12) * 4)),
    # a stride-2 conv: 8 -> 4
    ("aten::cudnn_convolution", _args(
        [[2, 3, 8, 8], [5, 3, 3, 3], [], [], [], []],
        [BF16, BF16, "ScalarList", "ScalarList", "ScalarList", "Scalar"],
        ["", "", "[1, 1]", "[2, 2]", "[1, 1]", "1"]),
     (2 * 2 * 5 * 16 * 27, (2 * 3 * 64 + 5 * 27 + 2 * 5 * 16) * 2)),
    # a transposed conv, stride 2 with output padding 1: 5 -> 10
    ("aten::cudnn_convolution_transpose", _args(
        [[1, 4, 5, 5], [4, 2, 3, 3], [], [], [], [], []],
        [F32, F32, "ScalarList", "ScalarList", "ScalarList", "ScalarList",
         "Scalar"],
        ["", "", "[1, 1]", "[1, 1]", "[2, 2]", "[1, 1]", "1"]),
     (2 * 100 * 18, (100 + 72 + 2 * 100) * 4)),
])
def test_op_cost_rules(name, args, want):
    flops, reads, writes = profiling.op_cost(name, args)
    assert (flops, sum(reads) + writes) == tuple(map(float, want))


@pytest.mark.parametrize("mask,grads", [("[True, True, False]", 2),
                                        ("[False, True, True]", 1)])
def test_conv_backward_cost(mask, grads):
    """2*N*K*C*R*S*P*Q FLOPs per gradient it returns: the data gradient
    reads grad_output and the weight and writes the input's size, the
    weight gradient reads grad_output and the input."""
    g, x, w = [2, 5, 4, 4], [2, 3, 8, 8], [5, 3, 3, 3]
    args = _args([g, x, w, [], [], [], [], [], [], [], []],
                 [F32] * 3 + ["ScalarList"] * 4 + ["Scalar", "ScalarList",
                                                   "Scalar", "ScalarList"],
                 ["", "", "", "[5]", "[2, 2]", "[1, 1]", "[1, 1]", "False",
                  "[0, 0]", "1", mask])
    flops, reads, writes = profiling.op_cost("aten::convolution_backward",
                                             args)
    assert flops == grads * 2 * 2 * 5 * 3 * 3 * 3 * 4 * 4
    m = [v == "True" for v in mask[1:-1].split(", ")]
    assert reads == [160 * 4] + [384 * 4] * m[1] + [135 * 4] * m[0]
    assert writes == (m[0] * 384 + m[1] * 135 + m[2] * 5) * 4


def _l2_trace(tmp_path, size):
    """Two op calls in a row: a copy writing ``size`` f32 elements, then a
    tanh reading them, 10 us each, in one train_step range."""
    dims = [[size], [size], []]
    ev = [{"ph": "X", "cat": "user_annotation", "name": "train_step",
           "pid": 1, "tid": 1, "ts": 0, "dur": 100, "args": {}}]
    for i, (op, args) in enumerate((
            ("aten::copy_", _args(dims, [F32, BF16, "Scalar"])),
            ("aten::tanh", _args([[size]], [F32])))):
        ev.append({"ph": "X", "cat": "cpu_op", "name": op, "pid": 1,
                   "tid": 1, "ts": 10 * i, "dur": 5,
                   "args": {"External id": i, **args}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{i}", "pid": 0,
                   "tid": 7, "ts": 50 + 10 * i, "dur": 10,
                   "args": {"External id": i}})
    with open(tmp_path / "trace.json", "w") as f:
        json.dump({"traceEvents": ev}, f)
    with open(tmp_path / profiling.COSTS_FILE, "w") as f:
        json.dump(profiling.op_costs(ev), f)
    return profile_step.mine_trace(str(tmp_path))


@pytest.mark.parametrize("mib,cached", [(24, True), (60, False)])
def test_an_input_just_written_is_read_from_the_l2(tmp_path, mib, cached):
    """The tanh's input is what the copy before it wrote: when that fits
    in the 50 MiB L2 it is not read from HBM again."""
    size = mib * 2 ** 20 // 4
    roof = _l2_trace(tmp_path, size)["roofline"]
    peak_b = profile_step.PEAK_BYTES_PER_S
    ops = {o["op"]: o for o in roof["ops"]}
    want_tanh = (1 if cached else 2) * size * 4 / peak_b * 1e6
    assert ops["aten::tanh"]["floor_us"] == round(want_tanh, 1)
    assert ops["aten::copy_"]["floor_us"] == round(size * 6 / peak_b * 1e6, 1)
    assert roof["l2_reads_ms_per_step"] == round(
        cached * size * 4 / peak_b * 1e3, 4)


def test_classes():
    c = profile_step.classify
    assert c("void cudnn::engines_precompiled::nchwToNhwcKernel", "kernel") \
        == "layout copy"
    assert c("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "kernel") == \
        "tensor-core GEMM/conv"
    assert c("cutlass3x_sm90_tensorop_gemm", "kernel") == \
        "tensor-core GEMM/conv"
    assert c("void wgrad_tc_kernel<3>", "kernel") == "B2 wgrad (hand kernel)"
    assert c("void at::native::reduce_kernel<512, 1>", "kernel") == \
        "elementwise/reduce"
    assert c("Memcpy DtoD (Device -> Device)", "memcpy") == "memcpy/memset"
    assert c("mystery", "kernel") == "other"


def test_profile_step_on_a_cpu_trace(tmp_path):
    rep = profile_step.main(["--smoke", "--device", "cpu", "--steps", "2",
                             "--trace_dir", str(tmp_path),
                             "--out", str(tmp_path / "rep.json")])
    assert rep["total_device_us"] == 0 and rep["steps"] == 2
    assert rep["by_class"] == {} and rep["top_ops"] == []
    # the steps' wall spans, which a CPU trace has too
    assert rep["mean_step_ms"] > 0
    with open(tmp_path / profiling.COSTS_FILE) as f:
        costs = json.load(f).values()
    convs = [c for c in costs if c["op"] == "aten::convolution_backward"]
    assert convs and all(c["flops"] > 0 and c["bytes"] > 0 for c in convs)
    with open(tmp_path / "rep.json") as f:
        assert json.load(f) == rep


def test_trace_annotate_timed(tmp_path):
    # inside the trace a span is a named range on its timeline
    with profiling.trace(str(tmp_path), "cpu", with_flops=True):
        with tracing.span("region"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "region" in names
    with open(tmp_path / profiling.COSTS_FILE) as f:
        costs = json.load(f).values()
    assert [(c["flops"], c["bytes"]) for c in costs
            if c["op"] == "aten::mm"] == [(2 * 4 * 4 * 4, 3 * 16 * 4)]
    out, secs = profiling.timed(lambda a: a * 2)(torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0)) and secs >= 0
    # a body that raises writes nothing
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path / "x"), "cpu"):
            raise ValueError
    assert not os.path.exists(tmp_path / "x")


def _oom_unless(fits):
    calls = []

    def measure(cfg, steps, warmup=3):
        calls.append((cfg.model.remat, cfg.train.grad_accum,
                      cfg.data.batch_size))
        if fits(cfg):
            return 10.0 * cfg.data.batch_size
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 2.00 GiB")
    return measure, calls


def test_tune_batch_ladder_matches_jax(monkeypatch):
    """Every candidate fails: the port tries the JAX tool's rungs in its
    order, and reports each candidate as not fitting."""
    import tools.tune_batch as jax_tune
    jax_calls = []
    monkeypatch.setattr(jax_tune, "try_measure", lambda cfg, steps: (
        jax_calls.append((cfg.model.remat, cfg.train.grad_accum,
                          cfg.data.batch_size)) or (None, "oom")))
    monkeypatch.setattr(sys, "argv", ["tune_batch.py", "--candidates",
                                      "6,64", "--grad_accum", "2"])
    jax_tune.main()
    measure, calls = _oom_unless(lambda cfg: False)
    monkeypatch.setattr(bench, "measure", measure)
    out = tune_batch.main(["--candidates", "6,64", "--grad_accum", "2",
                           "--device", "cpu"])
    assert calls == jax_calls == [(False, 2, 6), (True, 2, 6),
                                  (False, 2, 64), (True, 2, 64),
                                  (True, 4, 64)]
    assert out["best"] is None
    assert all("out of memory" in r["error"] for r in out["rows"])


def test_tune_batch_rows(monkeypatch):
    measure, calls = _oom_unless(
        lambda cfg: cfg.model.remat and cfg.train.grad_accum == 4
        or cfg.data.batch_size == 8)
    monkeypatch.setattr(bench, "measure", measure)
    out = tune_batch.main(["--smoke", "--candidates", "8,16", "--device",
                           "cpu", "--steps", "1"])
    assert out["metric"] == "tune_batch_32px"
    assert out["rows"] == [
        {"batch": 8, "remat": False, "grad_accum": 1,
         "imgs_per_sec_per_chip": 80.0},
        {"batch": 16, "remat": True, "grad_accum": 4,
         "imgs_per_sec_per_chip": 160.0}]
    assert out["best"]["batch"] == 16 and out["best"]["confirmed"]
    assert calls[1:4] == [(False, 1, 16), (True, 1, 16), (True, 2, 16)]
    # no ladder: the first rung's failure is the row
    out = tune_batch.main(["--smoke", "--candidates", "16", "--device",
                           "cpu", "--no-auto_dials"])
    assert "error" in out["rows"][0] and out["best"] is None

    def broken(cfg, steps, warmup=3):
        raise RuntimeError("not a memory error")
    monkeypatch.setattr(bench, "measure", broken)
    with pytest.raises(RuntimeError, match="not a memory error"):
        tune_batch.main(["--smoke", "--candidates", "8", "--device", "cpu"])


def test_tune_batch_measures_on_the_cpu():
    out = tune_batch.main(["--smoke", "--candidates", "4", "--device", "cpu",
                           "--steps", "1"])
    assert out["rows"][0]["imgs_per_sec_per_chip"] > 0


def test_memory_plan_state_bytes_equal_jax(monkeypatch):
    from pcgan_tpu.models.registry import define_D, define_G
    from pcgan_tpu.train import create_train_state
    import tools.memory_plan as jax_plan

    class A:
        smoke, batch = True, 0
    cfg = jax_plan.build_cfg(A, False, 1)
    G, D = define_G(cfg), define_D(cfg)
    st = jax.eval_shape(lambda r: create_train_state(cfg, G, D, r, 100),
                        jax.random.PRNGKey(0))
    adam = [s for s in jax.tree_util.tree_leaves(
        (st.g_opt, st.d_opt),
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    want_params = jax_plan._tree_bytes((st.g_params, st.d_params))
    want_moments = jax_plan._tree_bytes([(s.mu, s.nu) for s in adam])
    out = memory_plan.main(["--smoke", "--device", "cpu"])
    assert out["backend"] == "cpu" and out["hbm_limit_gib"] is None
    row = out["rows"][0]
    assert row["state_bytes"]["params"] == want_params
    assert row["state_bytes"]["adam_moments"] == want_moments
    assert row["peak_gib"] is None and row["temp_gib"] is None
    assert out["batch"] == cfg.data.batch_size


def test_memory_plan_oom_row(monkeypatch):
    def oom(cfg, device):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
    monkeypatch.setattr(bench, "train_step_fn", oom)
    out = memory_plan.main(["--smoke", "--sweep", "--device", "cpu"])
    assert [(r["remat"], r["grad_accum"]) for r in out["rows"]] == \
        memory_plan.SWEEP
    assert all(r["error"].startswith("CUDA out of memory")
               for r in out["rows"])


def test_doctor_on_the_cpu(capsys):
    rep = doctor.main(["--device", "cpu"])
    assert rep["device_check"] == "ok"
    assert rep["mesh"] == {"data": 1}
    assert set(rep["xla_only_flags"]) == set(doctor.XLA_ONLY)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["doctor"]["device_check"] == "ok"
    assert rep["world_size"] == 1
    rep = doctor.main(["--device", "cpu", "--mesh_shape", "2"])
    assert rep["mesh"].startswith("FAILED: --mesh_shape 2")
    # --zero1 leaves the mesh as it is (root tools/doctor.py builds the
    # mesh alone); a spatial axis of two needs two processes (its band
    # plan: test_torch_port_spatial_cli.py)
    rep = doctor.main(["--device", "cpu", "--zero1"])
    assert rep["mesh"] == {"data": 1}
    rep = doctor.main(["--device", "cpu", "--mesh_shape", "1,1",
                       "--mesh_axes", "data,model"])
    assert rep["mesh"] == {"data": 1, "model": 1}
    rep = doctor.main(["--device", "cpu", "--mesh_shape", "1,2",
                       "--mesh_axes", "data,spatial"])
    assert rep["mesh"].startswith("FAILED: --mesh_shape 1,2")
