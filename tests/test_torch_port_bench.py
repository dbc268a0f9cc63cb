"""The port's bench (``pcgan_tpu_torch/bench.py``) against the root
``bench.py`` (CPU).

Its configs carry the JAX bench's fields at 128, 256 and 512 px and under
``--smoke``; every mode prints the JAX metric name and keys (plus the
device it ran on), with ``vs_baseline`` as JAX's where the baseline file
measured the same kind of device and null where not. The measures
themselves run at the smoke size on the CPU and give finite positive
rates; the traced latency is null there, because a CPU trace has no device
lane. The config and name checks stub the measures on both sides, so they
compare the drivers and not two timings.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest

import bench as jax_bench
from pcgan_tpu_torch import bench
from pcgan_tpu_torch.tools import profile_e2e

FIELDS = {"data": ("batch_size", "crop_size", "load_size", "n_age_bins",
                   "host_decode_m", "host_resize"),
          "model": ("netG", "ngf", "ndf", "dtype", "remat", "quant_int8"),
          "train": ("pool_size",)}


def _fields(cfg):
    return {f"{sec}.{k}": getattr(getattr(cfg, sec), k)
            for sec, keys in FIELDS.items() for k in keys}


def _run_jax(monkeypatch, argv, value=5.0):
    """The JAX bench's line and the configs its measures got, measures
    stubbed."""
    seen = []

    def rate(cfg, *a, **k):
        seen.append(cfg)
        return value

    monkeypatch.setattr(jax_bench, "measure", rate)
    monkeypatch.setattr(jax_bench, "measure_e2e", rate)
    monkeypatch.setattr(jax_bench, "measure_infer", rate)
    monkeypatch.setattr(jax_bench, "measure_latency",
                        lambda cfg, *a, **k: seen.append(cfg) or (1.0, 2.0,
                                                                  None))
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    out = []
    monkeypatch.setattr("builtins.print", lambda s, **k: out.append(s))
    jax_bench.main()
    monkeypatch.undo()
    return json.loads(out[-1]), seen


def _run_port(monkeypatch, argv, value=5.0, device_ms=None):
    seen = []

    def rate(cfg, *a, **k):
        seen.append(cfg)
        return value

    monkeypatch.setattr(bench, "measure", rate)
    monkeypatch.setattr(bench, "measure_e2e", rate)
    monkeypatch.setattr(bench, "measure_infer", rate)
    monkeypatch.setattr(bench, "measure_latency",
                        lambda cfg, *a, **k: seen.append(cfg) or (
                            1.0, 2.0, device_ms))
    line = bench.main([*argv, "--device", "cpu"])
    monkeypatch.undo()
    return line, seen


@pytest.mark.parametrize("argv", [
    ["--size", "128"], ["--size", "256"], ["--size", "512"],
    ["--size", "256", "--batch", "128"], ["--size", "128", "--batch", "96"],
    ["--smoke", "--batch", "8"], ["--infer", "--quant_int8"],
    ["--e2e", "--host_decode_m", "4", "--host_resize"]],
    ids=lambda a: "_".join(x.lstrip("-") for x in a))
def test_configs_match_jax(monkeypatch, argv):
    _, jseen = _run_jax(monkeypatch, argv)
    _, pseen = _run_port(monkeypatch, argv)
    assert len(jseen) == len(pseen) >= 1
    for j, p in zip(jseen, pseen):
        assert _fields(p) == _fields(j)
        assert p.run.device == "cpu"


def test_smoke_default_batch_is_one_devices():
    # JAX's smoke batch is max(4, local devices); the port has one device
    assert bench.bench_config(smoke=True).data.batch_size == 4
    assert dataclasses.replace(bench.bench_config(smoke=True, batch=8)
                               ).data.batch_size == 8


MODES = [[], ["--skip_e2e"], ["--e2e"], ["--e2e", "--packed"],
         ["--e2e", "--device_cache"], ["--e2e", "--device_cache_sharded"],
         ["--infer"], ["--infer", "--serving"], ["--infer", "--quant_int8"],
         ["--infer", "--serving", "--quant_int8"], ["--latency"],
         ["--size", "256", "--skip_e2e"], ["--smoke"]]


@pytest.mark.parametrize("argv", MODES,
                         ids=lambda a: "_".join(x.lstrip("-") for x in a)
                         or "headline")
def test_metric_names_and_keys_match_jax(monkeypatch, argv):
    jline, _ = _run_jax(monkeypatch, argv)
    pline, _ = _run_port(monkeypatch, argv)
    assert pline["metric"] == jline["metric"]
    assert set(pline) == set(jline) | {"device"}
    assert pline["device"] == "cpu"
    assert pline["unit"] == jline["unit"]
    # the committed baseline measured a CPU, as this run did
    assert pline["vs_baseline"] == jline["vs_baseline"]
    for k in ("value", "e2e_imgs_s", "e2e_cached_imgs_s", "batch"):
        assert pline.get(k) == jline.get(k)


def test_vs_baseline_needs_the_same_kind_of_device(tmp_path, monkeypatch):
    base = tmp_path / "baseline_torch.json"
    base.write_text(json.dumps({"imgs_per_sec_per_chip_128px": 2.0,
                                "device": "cuda"}))
    monkeypatch.setattr(bench, "BASELINE", str(base))
    line, _ = _run_port(monkeypatch, ["--skip_e2e"])
    assert line["vs_baseline"] is None
    monkeypatch.setattr(bench, "BASELINE", str(base))
    base.write_text(json.dumps({"imgs_per_sec_per_chip_128px": 2.0,
                                "device": "cpu"}))
    line, _ = _run_port(monkeypatch, ["--skip_e2e"])
    assert line["vs_baseline"] == 2.5


def test_bad_flag_combinations_exit():
    for argv in (["--serving"], ["--quant_int8"], ["--packed"],
                 ["--device_cache"], ["--e2e", "--device_cache", "--packed"]):
        with pytest.raises(SystemExit):
            bench.main([*argv, "--device", "cpu"])


def _finite_positive(v):
    return bool(np.isfinite(v)) and v > 0


def test_measures_run_on_the_cpu():
    cfg = bench.bench_config(smoke=True, device="cpu")
    assert _finite_positive(bench.measure(cfg, steps=2, warmup=1))
    for kw in ({}, {"packed": True}, {"device_cache": True}):
        assert _finite_positive(bench.measure_e2e(cfg, steps=2, warmup=1,
                                                  n_images=16, **kw)), kw
    with pytest.raises(NotImplementedError, match="A10"):
        bench.measure_e2e(cfg, steps=1, n_images=8, device_cache=True,
                          cache_sharded=True)
    for serving in (False, True):
        assert _finite_positive(bench.measure_infer(cfg, steps=2, warmup=1,
                                                    serving=serving))
    q = bench.bench_config(smoke=True, quant_int8=True, device="cpu")
    assert _finite_positive(bench.measure_infer(q, steps=2, warmup=1))
    p50, p99, device_ms = bench.measure_latency(cfg, n=3, traced=2)
    assert 0 < p50 <= p99 and device_ms is None


def test_smoke_main_prints_the_line(capsys):
    line = bench.main(["--smoke", "--steps", "2", "--device", "cpu"])
    assert line["metric"] == "train_imgs_per_sec_per_chip_32px"
    assert _finite_positive(line["value"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == line


def test_profile_e2e_stages_on_the_cpu():
    rep = profile_e2e.main(["--smoke", "--device", "cpu", "--steps", "2",
                            "--n_images", "16"])
    for k in ("decode_ms_per_batch", "with_bins_ms", "upload_ms",
              "dispatch_ms", "step_ms", "e2e_ms", "step_imgs_s",
              "e2e_imgs_s"):
        assert _finite_positive(rep[k]), k
    assert rep["bound"] in ("host", "device") and rep["device"] == "cpu"
