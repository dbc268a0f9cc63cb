"""The port's profiling tools (CPU): ``utils/profiling.py``, the trace
miner of ``tools/profile_step.py`` on a committed synthetic chrome trace
(exact totals, classes, top kernels and floors) and on a real CPU trace (0
device us: no device lane), ``tune_batch``'s rows (an out-of-memory step
"does not fit" and climbs the JAX tool's dial ladder; any other error
propagates), ``memory_plan``'s state bytes against the JAX ``_tree_bytes``
of the same subtrees, and ``doctor --device cpu``.
"""

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
from pcgan_tpu_torch.utils import profiling

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_port_data",
                       "trace_fixture")


def test_mine_trace_on_the_fixture():
    rep = profile_step.mine_trace(FIXTURE)
    # two steps of 100 + 20 + 10 + 5 us of kernels, a 30 us copy, a 2 us set
    assert rep["total_device_us"] == 302.0
    assert rep["steps"] == 2 and rep["mean_step_ms"] == 0.151
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
    # counted: the conv's kernels under aten::conv2d (2 GFLOP) and the
    # copy's 3.35 MB; the add, B1 and the empty memset have no count
    assert roof["counted_ms_per_step"] == 0.135
    assert roof["uncounted_ms_per_step"] == 0.016
    floor_us = 2e9 / profile_step.PEAK_BF16_FLOPS * 1e6 + 1.0
    assert roof["floor_ms_per_step"] == round(floor_us / 2 / 1e3, 4)
    assert roof["ratio_to_floor"] == round(270.0 / floor_us, 3)
    assert roof["top_gaps_us_per_step"][0]["op"] == "aten::conv2d"


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
    assert rep["mean_step_ms"] == 0.0
    with open(tmp_path / "op_flops.json") as f:
        flops = json.load(f)
    assert flops.get("aten::conv2d", 0) > 0
    with open(tmp_path / "rep.json") as f:
        assert json.load(f) == rep


def test_trace_annotate_timed(tmp_path):
    with profiling.trace(str(tmp_path), "cpu", with_flops=True):
        with profiling.annotate("region"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "region" in names
    with open(tmp_path / profiling.FLOPS_FILE) as f:
        assert json.load(f)["aten::mm"] == 2 * 4 * 4 * 4
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
    rep = doctor.main(["--device", "cpu", "--mesh_shape", "2"])
    assert "A10" in rep["mesh"]
