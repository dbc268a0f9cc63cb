"""The port's training CLI (``python -m pcgan_tpu_torch.train_main``) on
the CPU at a tiny size: what a run writes, exact resume, checkpoint
retention, and the flags it refuses."""

import json
import os

import numpy as np
import pytest
import torch

from pcgan_tpu_torch import train_main
from pcgan_tpu_torch.config import parse_config
from pcgan_tpu_torch.utils import checkpoint as ckpt

from torch_port_levers import one_torch_thread  # noqa: F401

BASE = ["--dataset_mode", "synthetic", "--max_dataset_size", "8",
        "--batch_size", "2", "--load_size", "36", "--crop_size", "32",
        "--netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8",
        "--n_age_bins", "4", "--niter_decay", "0", "--print_freq", "1",
        "--cond_inject", "bottleneck", "--pool_size", "3",
        "--device", "cpu", "--num_threads", "1"]


def _run(tmp_path, name, *extra):
    return train_main.main(BASE + ["--name", name, "--checkpoints_dir",
                                   str(tmp_path), *extra])


def _metrics(tmp_path, name):
    with open(tmp_path / name / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_smoke_run_writes_its_outputs(tmp_path):
    res = _run(tmp_path, "smoke", "--niter", "2", "--save_epoch_freq", "1",
               "--display_freq", "3", "--ema_decay", "0.9",
               "--max_ckpt_keep", "1", "--lr_policy", "linear")
    run = tmp_path / "smoke"
    assert res["step"] == 8 and [e["steps"] for e in res["epochs"]] == [4, 4]
    rows = _metrics(tmp_path, "smoke")
    assert [r["step"] for r in rows] == list(range(1, 9))
    for r in rows:
        for k in ("loss_G", "loss_G_GAN", "loss_G_L1", "loss_G_cond",
                  "loss_D", "loss_D_real", "loss_D_fake", "lr"):
            assert np.isfinite(r[k]), (k, r)
        # the schedule at the next step: flat for 2 epochs, then 0
        assert r["lr"] == pytest.approx(2e-4 if r["step"] < 8 else 0.0)
    assert all("imgs_per_sec" in r for r in rows)
    files = set(os.listdir(run))
    # epoch_1 pruned by --max_ckpt_keep 1; the EMA twin beside each G
    assert {"latest.pt", "latest_G.pt", "latest_G_ema.pt", "epoch_2.pt",
            "epoch_2_G.pt", "epoch_2_G_ema.pt", "opt.json",
            "loss_curves.svg", "metrics.jsonl"} <= files
    assert not any(f.startswith("epoch_1") for f in files)
    with open(run / "loss_curves.svg") as f:
        assert "loss_G" in f.read()
    assert len(os.listdir(run / "web" / "images")) == 2     # steps 3 and 6
    with open(run / "opt.json") as f:
        assert json.load(f)["run"]["device"] == "cpu"
    sd = torch.load(run / "latest.pt", weights_only=True)
    assert sd["step"] == 8 and sd["opt_g"]["count"] == 8
    assert int(sd["pool"]["count"]) == 3


def test_two_epochs_equal_one_plus_resumed_one(tmp_path):
    _run(tmp_path, "straight", "--niter", "2")
    _run(tmp_path, "resumed", "--niter", "1")
    res = _run(tmp_path, "resumed", "--niter", "2", "--continue_train")
    assert res["step"] == 8 and [e["epoch"] for e in res["epochs"]] == [2]
    a, b = _metrics(tmp_path, "straight"), _metrics(tmp_path, "resumed")
    assert [r["step"] for r in a] == [r["step"] for r in b]
    for ra, rb in zip(a, b):
        for k in ra:
            if k.startswith("loss"):
                assert ra[k] == rb[k], (ra["step"], k, ra[k], rb[k])


def test_mid_epoch_resume_skips_consumed_batches(tmp_path, monkeypatch,
                                                capsys):
    """A run cut right after its mid-epoch 'latest' save at step 6 (of 4
    steps an epoch) resumes inside epoch 2, skips the 2 batches already
    consumed and logs what the uninterrupted run logs."""
    _run(tmp_path, "straight", "--niter", "2")

    class Cut(Exception):
        pass

    write = train_main._write_host_sidecar

    def write_then_cut(run_dir, step, losses):
        write(run_dir, step, losses)
        if step == 6:
            raise Cut

    monkeypatch.setattr(train_main, "_write_host_sidecar", write_then_cut)
    with pytest.raises(Cut):
        _run(tmp_path, "cut", "--niter", "2", "--save_latest_freq", "3")
    monkeypatch.undo()
    res = _run(tmp_path, "cut", "--niter", "2", "--save_latest_freq", "3",
               "--continue_train")
    assert "resumed from step 6 (epoch 2, skipping 2 consumed batches)" \
        in capsys.readouterr().out
    assert res["step"] == 8 and res["epochs"][0]["steps"] == 2
    a, b = _metrics(tmp_path, "straight"), _metrics(tmp_path, "cut")
    assert [r["step"] for r in b] == list(range(1, 9))
    for ra, rb in zip(a, b):
        assert {k: v for k, v in ra.items() if k.startswith("loss")} == \
            {k: v for k, v in rb.items() if k.startswith("loss")}


def test_prune_epochs(tmp_path):
    run = tmp_path / "r"
    run.mkdir()
    for k in (1, 2, 3):
        for suffix in ("", "_G", "_G_ema"):
            (run / f"epoch_{k}{suffix}.pt").write_bytes(b"")
    (run / "latest.pt").write_bytes(b"")
    removed = ckpt.prune_epochs(str(tmp_path), "r", 2)
    assert removed == ["epoch_1.pt", "epoch_1_G.pt", "epoch_1_G_ema.pt"]
    assert ckpt.prune_epochs(str(tmp_path), "r", 0) == []
    assert sorted(os.listdir(run))[0] == "epoch_2.pt"


@pytest.mark.parametrize("flags,match", [
    (["--gan_mode", "wgangp"], "loss_D"),
    (["--netD", "multiscale", "--n_layers_D", "2"], "loss_D"),
    (["--skip_nonfinite", "3"], "notfinite_G"),
    (["--tb_logdir", "tb"], "loss_G"),
    (["--dataset_mode", "celeba"], "dataset_mode")])
def test_unported_flags_raise(tmp_path, flags, match):
    if "celeba" in flags:
        # a data source the port does not have
        with pytest.raises(NotImplementedError, match=match):
            _run(tmp_path, "x", "--niter", "1", *flags)
        return
    # the flags of the training step and loop are ported: each run trains
    if "--tb_logdir" in flags:
        flags = ["--tb_logdir", str(tmp_path / "tb")]
    res = _run(tmp_path, "x", "--niter", "1", *flags)
    assert res["step"] == 4 and np.isfinite(res["metrics"][match])
    if "--tb_logdir" in flags:
        (ev,) = os.listdir(tmp_path / "tb" / "x")
        assert ev.startswith("events.out.tfevents.")


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a if a != "cpu" else "cuda" for a in BASE]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main.main(argv + ["--name", "c", "--checkpoints_dir",
                                str(tmp_path), "--niter", "1"])
    assert parse_config([]).run.device == "cuda"
