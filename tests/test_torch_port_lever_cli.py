"""The run-level levers of the port's training CLI on the CPU at a tiny
size: exact resume with spectral norm, batch norm, ADA, dropout and the
skip counters; ``convert_train_state`` of a JAX state that carries
``d_state``, ADA's p and skip counters; ``--metrics_lag`` (the same rows);
``--tb_logdir`` (byte-identical to the JAX package's writer);
``--init_g_from``; ``--profile_steps``; ``--log_memory``;
``--debug_nans``; the XLA-only flags; and sampling and export of a
batch-norm G."""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu_torch import train_main
from torch_port_levers import (one_torch_thread,  # noqa: F401
                               batches, cfgs, jax_models, jax_state,
                               port_state)

BASE = ["--dataset_mode", "synthetic", "--max_dataset_size", "8",
        "--batch_size", "2", "--load_size", "36", "--crop_size", "32",
        "--netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8",
        "--n_age_bins", "4", "--niter_decay", "0", "--print_freq", "1",
        "--cond_inject", "bottleneck", "--pool_size", "3",
        "--device", "cpu", "--num_threads", "1"]
# ADA's p moves by 2/4 a step here, so the resumed epoch augments
LEVERS = ["--spectral_norm", "--norm", "batch", "--diff_augment",
          "color,translation,cutout", "--gan_mode", "vanilla",
          "--ada_target", "0.1", "--ada_kimg", "0.004", "--skip_nonfinite",
          "3", "--no-no_dropout", "--ema_decay", "0.9"]


def _run(tmp_path, name, *extra):
    return train_main.main(BASE + ["--name", name, "--checkpoints_dir",
                                   str(tmp_path), *extra])


def _rows(tmp_path, name):
    with open(tmp_path / name / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _losses(rows):
    return [{k: v for k, v in r.items() if k.startswith(("loss", "ada",
                                                         "notfinite"))}
            for r in rows]


def test_exact_resume_with_state_levers(tmp_path):
    _run(tmp_path, "straight", "--niter", "2", *LEVERS)
    _run(tmp_path, "cut", "--niter", "1", *LEVERS)
    sd = torch.load(tmp_path / "cut" / "latest.pt", weights_only=True)
    assert sd["aug_p"] > 0 and sd["dropout_rng"] is not None
    assert set(sd["opt_d"]["skip"]) == {"notfinite_count", "last_finite",
                                        "total_notfinite"}
    assert any(k.endswith(".sn.u") for k in sd["D"])
    assert any(k.endswith("running_var") for k in sd["D"])
    assert any(k.endswith("running_var") for k in sd["G"])
    _run(tmp_path, "cut", "--niter", "2", "--continue_train", *LEVERS)
    a, b = _rows(tmp_path, "straight"), _rows(tmp_path, "cut")
    assert [r["step"] for r in b] == list(range(1, 9))
    assert _losses(a) == _losses(b)
    assert any(r["ada_p"] > 0 for r in a)
    for tag in ("latest_G", "latest_G_ema"):
        x = torch.load(tmp_path / "straight" / f"{tag}.pt", weights_only=True)
        y = torch.load(tmp_path / "cut" / f"{tag}.pt", weights_only=True)
        assert set(x) == set(y) and all(torch.equal(x[k], y[k]) for k in x)


def test_convert_train_state_carries_d_state_ada_and_skip(monkeypatch):
    from pcgan_tpu.train import make_train_step as j_make_train_step
    jc, tc = cfgs(model=dict(spectral_norm=True, norm="batch"),
                  train=dict(diff_augment="color", ada_target=0.6,
                             ada_kimg=0.01, skip_nonfinite=2))
    Gj, Dj = jax_models(jc)
    jstate = jax_state(jc, Gj, Dj).replace(aug_p=jnp.float32(0.37))
    step = jax.jit(j_make_train_step(jc, Gj, Dj))
    bs = batches(2)
    jstate, _ = step(jstate, {k: jnp.asarray(v) for k, v in bs[0].items()})
    assert float(jstate.aug_p) > 0
    assert float(port_state(tc, jstate).aug_p) == float(jstate.aug_p)
    # a non-finite step: both updates skipped (and r_t, hence p, is NaN)
    bs[1]["image"][0, 0, 0, 0] = np.nan
    jstate, _ = step(jstate, {k: jnp.asarray(v) for k, v in bs[1].items()})
    state = port_state(tc, jstate)
    for skip, opt in ((state.skip_g, jstate.g_opt),
                      (state.skip_d, jstate.d_opt)):
        assert int(skip["total_notfinite"]) == int(opt.total_notfinite) == 1
        assert int(skip["notfinite_count"]) == 1
        assert not bool(skip["last_finite"])
    from flax.traverse_util import flatten_dict
    flat = flatten_dict(jax.device_get(jstate.d_state)["batch_stats"],
                        sep="/")
    sd = state.D.state_dict()
    np.testing.assert_array_equal(
        sd["convs.2.sn.u"].numpy(),
        flat["SpectralNorm_2/TorchConv_2/kernel/u"])
    np.testing.assert_array_equal(sd["norms.1.running_var"].numpy(),
                                  flat["Norm_1/BatchNorm_0/var"])


def test_metrics_lag_writes_the_same_rows(tmp_path):
    # a save at step 3 and the epoch's end both flush the pending row
    _run(tmp_path, "eager", "--niter", "1", "--save_latest_freq", "3")
    _run(tmp_path, "lag", "--niter", "1", "--save_latest_freq", "3",
         "--metrics_lag")
    a, b = _rows(tmp_path, "eager"), _rows(tmp_path, "lag")
    assert [r["step"] for r in a] == [r["step"] for r in b]
    assert _losses(a) == _losses(b)
    assert [r["lr"] for r in a] == [r["lr"] for r in b]


def test_tb_writer_is_byte_identical_to_jax(tmp_path, monkeypatch):
    from pcgan_tpu.utils import tb_writer as jtb
    from pcgan_tpu_torch.utils import tb_writer as ttb
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    paths = []
    for mod, d in ((jtb, "j"), (ttb, "t")):
        w = mod.TBWriter(str(tmp_path / d))
        w.add_scalars(3, {"loss_G": 0.5, "loss_D": -0.25})
        w.add_scalars(7, {"loss_G": 0.125, "ada_p": 1e-3}, wall_time=12.5)
        w.add_scalars(9, {})
        w.close()
        paths.append(w.path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()
    assert ttb.crc32c(b"123456789") == 0xE3069283


def test_init_g_from_profile_and_memory(tmp_path):
    _run(tmp_path, "src", "--niter", "1")
    res = _run(tmp_path, "dst", "--niter", "1", "--init_g_from", "src/latest",
               "--lr", "0", "--profile_steps", "2", "--log_memory")
    x = torch.load(tmp_path / "src" / "latest_G.pt", weights_only=True)
    y = torch.load(tmp_path / "dst" / "latest_G.pt", weights_only=True)
    assert all(torch.equal(x[k], y[k]) for k in x)     # lr 0: G unchanged
    assert os.path.getsize(tmp_path / "dst" / "trace" / "trace.json") > 0
    # off the card the allocator has nothing to report
    assert not any(k.startswith("mem_") for k in _rows(tmp_path, "dst")[0])
    assert res["step"] == 4


def test_debug_nans_raises(tmp_path, monkeypatch):
    from pcgan_tpu_torch import train as ttrain
    real = ttrain.make_train_step

    def nan_step(*a, **k):
        step = real(*a, **k)

        def f(state, batch):
            m = step(state, batch)
            m["loss_D"] = m["loss_D"] * float("nan")
            return m
        return f
    monkeypatch.setattr(ttrain, "make_train_step", nan_step)
    with pytest.raises(FloatingPointError, match="loss_D"):
        _run(tmp_path, "nan", "--niter", "1", "--debug_nans")
    torch.autograd.set_detect_anomaly(False)


@pytest.mark.parametrize("flags", [["--xla_opt", "x"],
                                   ["--compile_cache", "c"],
                                   ["--profile_server", "9001"]])
def test_xla_only_flags_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="XLA-only"):
        _run(tmp_path, "x", "--niter", "1", *flags)


def test_batch_norm_g_samples_and_exports(tmp_path):
    from pcgan_tpu_torch import test as port_test
    from pcgan_tpu_torch.tools import export_serving
    _run(tmp_path, "bn", "--niter", "1", "--norm", "batch", "--ema_decay",
         "0.9")
    common = ["--dataset_mode", "synthetic", "--max_dataset_size", "4",
              "--load_size", "36", "--crop_size", "32", "--netG",
              "resnet_6blocks", "--ngf", "8", "--n_age_bins", "4",
              "--name", "bn", "--checkpoints_dir", str(tmp_path),
              "--device", "cpu", "--num_test", "2"]
    for ema in ([], ["--use_ema"]):
        out = port_test.main(common + ["--results_dir", str(tmp_path / "r"),
                                       *ema])
        assert out["done"] == 2
    export_serving.main(["--name", "bn", "--checkpoints_dir", str(tmp_path),
                         "--out_dir", str(tmp_path / "srv"), "--verify",
                         "--dtype", "float32", "--device", "cpu"])
    assert os.path.isfile(tmp_path / "srv" / "meta.json")
