"""Each cell's run on the CPU at a tiny size (``tiny_cells.py``): the port
against the plain reference, the result line, and the faults a cell can
have planted under the timed path, each of which must make ``correct``
false. The harness's look for a card is skipped (``run_cell`` on the
CPU); everything after it runs."""

import contextlib
import time

import pytest

from portbench.harness.report import run_cell
from portbench.tests.tiny_cells import SEED, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(name, traced=False, patch=None, dtype="float32"):
    cell, extra = tiny(name, dtype)
    return run_cell(cell, SEED, 1.0, traced, time.time(), "cpu", extra,
                    patch)


@pytest.mark.parametrize("name", ["train_utk128", "train_cacd256",
                                  "grid_utk128"])
def test_port_matches_the_reference_in_f32(name):
    line, checks = _run(name)
    assert line["correct"], checks
    gaps = {k: v["value"] for k, v in checks.items() if k != "data_rows"}
    # f32 on both sides: round-off only
    assert max(gaps.values()) < 1e-3, gaps
    assert checks.get("data_rows", {"value": 0})["value"] == 0


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(traced):
    line, _ = _run("train_utk128", traced)
    keys = KEYS[:4] + (["breakdown"] if traced else []) + KEYS[4:]
    assert sorted(line) == sorted(keys)
    assert list(line)[-1] == "checks"
    for row in line["checks"].values():
        assert set(row) == {"value", "limit"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "train_mfu" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"train_imgs_per_s", "peak_mem_gib",
                                        "setup_s"}


def test_fault_state_left_unchanged(monkeypatch):
    import pcgan_tpu_torch.train as train
    monkeypatch.setattr(train, "adam_step", lambda *a, **k: None)
    line, checks = _run("train_utk128")
    assert not line["correct"]
    # no leaf moved: each weight's median leaf reads its own norm over
    # itself
    assert checks["change_gap_tensor"]["value"] >= 0.99


def test_fault_one_layer_left_unchanged(monkeypatch):
    import torch

    import pcgan_tpu_torch.train as train
    step = train.adam_step

    def first_frozen(opt, grads, lr, found_inf=None):
        p = opt.param_groups[0]["params"][0]
        keep = p.detach().clone()
        step(opt, grads, lr, found_inf)
        with torch.no_grad():
            p.copy_(keep)
    monkeypatch.setattr(train, "adam_step", first_frozen)
    line, checks = _run("train_utk128")
    assert not line["correct"], checks
    # one tensor of each net unmoved: its leaves' median reads about 1
    assert checks["change_gap_tensor"]["value"] >= 0.99


@contextlib.contextmanager
def _fp8_layers():
    """Every conv's and linear layer's input and weight rounded to fp8
    (``reference/lowp.py``), the gradients through them too."""
    import torch.nn.functional as F

    from portbench.reference.lowp import fp8
    names = ("conv2d", "conv_transpose2d", "linear")
    saved = {n: getattr(F, n) for n in names}

    def lowered(f):
        def call(x, w, *a, **k):
            return f(fp8(x), fp8(w), *a, **k)
        return call
    try:
        for n, f in saved.items():
            setattr(F, n, lowered(f))
        yield
    finally:
        for n, f in saved.items():
            setattr(F, n, f)


@pytest.mark.parametrize("name", ["train_utk128", "train_cacd256"])
def test_control_fp8_in_the_program_is_not_correct(name):
    """The control in the program's place: the timed step computed one
    precision step below the configuration's."""
    def patch(ns):
        make = ns["make_parallel_train_step"]

        def fp8_maker(*a, **k):
            step = make(*a, **k)

            def step_fp8(state, raw):
                with _fp8_layers():
                    return step(state, raw)
            return step_fp8
        ns["make_parallel_train_step"] = fp8_maker
    line, checks = _run(name, patch=patch)
    assert not line["correct"], checks


def test_fault_half_the_batch():
    def patch(ns):
        make = ns["make_parallel_train_step"]

        def half_maker(*a, **k):
            step = make(*a, **k)

            def step_half(state, raw):
                n = raw["image"].shape[0] // 2
                return step(state, {k: v[:n] for k, v in raw.items()})
            return step_half
        ns["make_parallel_train_step"] = half_maker
    line, checks = _run("train_utk128", patch=patch)
    assert not line["correct"], checks


def test_fault_grid_answer_altered():
    def patch(ns):
        sampler = ns["sampler"]

        def altered(images):
            out = sampler(images).clone()
            out[[0, 1]] = out[[1, 0]]
            return out
        ns["sampler"] = altered
    line, checks = _run("grid_utk128", patch=patch)
    assert not line["correct"], checks


def no_exchange():
    """Planted in each worker: the data-parallel step's all-reduces
    return each rank's own tensors."""
    import pcgan_tpu_torch.train as train
    train.all_reduce_flat = lambda tensors, group, mean=False: list(tensors)


def test_data_parallel_cell_and_its_missing_exchange():
    line, checks = _run("train_utk128_dp4")
    assert line["correct"], checks
    assert line["device"]["count"] == 4
    line, checks = _run("train_utk128_dp4",
                        patch="portbench.tests.test_portbench_cells:"
                              "no_exchange")
    assert not line["correct"], checks
