"""The comparator slice end to end through the port's CLIs on the CPU, at a
tiny size (the counterpart of ``tests/test_e2e_smoke.py:129-238``):
pretrain the comparator and check its bundle and exact resume, train the
GAN with ``--comparator_path`` (onehot and score conditioning), and sample
the score-sweep grid."""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import json
import os

import numpy as np
import pytest
import torch

from pcgan_tpu_torch import test as port_test
from pcgan_tpu_torch import train_main
from pcgan_tpu_torch.config import parse_config
from pcgan_tpu_torch.utils import checkpoint as ckpt

COMMON = ["--load_size", "36", "--crop_size", "32", "--n_age_bins", "4",
          "--cmp_nf", "8", "--cmp_n_down", "3", "--device", "cpu",
          "--num_threads", "1", "--niter_decay", "0"]
PRETRAIN = COMMON + ["--model", "comparator", "--dataset_mode", "pairwise",
                     "--max_dataset_size", "24", "--batch_size", "4",
                     "--print_freq", "2"]
GAN = COMMON + ["--dataset_mode", "synthetic", "--max_dataset_size", "4",
                "--batch_size", "2", "--netG", "resnet_6blocks", "--ngf", "8",
                "--ndf", "8", "--cond_inject", "bottleneck", "--print_freq",
                "1", "--niter", "1", "--pool_size", "2"]


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A 2-epoch pretraining run and its 1-epoch resume, beside a straight
    3-epoch run."""
    root = tmp_path_factory.mktemp("cmp")
    ck = ["--checkpoints_dir", str(root)]
    first = train_main.main(PRETRAIN + ck + ["--name", "cmp", "--niter", "2"])
    resumed = train_main.main(PRETRAIN + ck + ["--name", "cmp", "--niter",
                                               "3", "--continue_train"])
    straight = train_main.main(PRETRAIN + ck + ["--name", "straight",
                                                "--niter", "3"])
    return root, first, resumed, straight


def test_pretraining_writes_bundle_and_state(pretrained):
    root, first, _, _ = pretrained
    run = root / "cmp"
    # 24 pairs: 2 held out, 22 trained in 5 steps of 4 a epoch
    assert first["step"] == 10
    assert [e["steps"] for e in first["epochs"]] == [5, 5]
    assert {"comparator.pt", "cmp_latest.pt", "opt.json",
            "metrics.jsonl"} <= set(os.listdir(run))
    rows = [r for r in _rows(run) if r["step"] <= 10]   # before the resume
    train_rows = [r for r in rows if "loss_cmp" in r]
    assert [r["step"] for r in train_rows] == [2, 4, 6, 8, 10]
    assert all(np.isfinite(r["loss_cmp"]) and 0 <= r["acc_cmp"] <= 1
               for r in train_rows)
    evals = [r for r in rows if "eval_acc_cmp" in r]
    assert [r["step"] for r in evals] == [5, 10]
    assert all(r["eval_acc_cmp"] in (0.0, 0.5, 1.0) for r in evals)
    assert first["eval_acc"] == evals[1]["eval_acc_cmp"]

    bundle = torch.load(run / "comparator.pt", weights_only=True)
    assert (bundle["cmp_nf"], bundle["cmp_n_down"], bundle["norm"],
            bundle["dtype"]) == (8, 3, "instance", "bfloat16")
    lo, hi, means = (bundle[k].numpy() for k in ("bin_lo", "bin_hi",
                                                 "bin_means"))
    assert lo.shape == hi.shape == means.shape == (4,)
    assert np.all(np.diff(means) >= 0)
    assert lo[0] == -1e30 and hi[-1] == 1e30
    np.testing.assert_array_equal(lo[1:], hi[:-1])
    np.testing.assert_allclose(hi[:-1], 0.5 * (means[1:] + means[:-1]),
                               rtol=1e-6)
    # the bundle loads by its file or its run directory, flags checked
    for path in (str(run), str(run / "comparator.pt")):
        cfg = parse_config(COMMON + ["--comparator_path", path])
        C, blo, _, bmeans = ckpt.load_comparator_bundle(cfg)
        assert torch.equal(blo, bundle["bin_lo"])
        assert torch.equal(C.state_dict()["fc.weight"],
                           bundle["C"]["fc.weight"])
    with pytest.raises(ValueError, match="--cmp_nf"):
        ckpt.load_comparator_bundle(parse_config(
            COMMON + ["--cmp_nf", "16", "--comparator_path", str(run)]))
    with pytest.raises(FileNotFoundError):
        ckpt.load_comparator_bundle(parse_config(
            COMMON + ["--comparator_path", str(root / "none")]))


def test_resume_equals_the_straight_run(pretrained):
    root, _, resumed, straight = pretrained
    assert resumed["step"] == straight["step"] == 15
    assert [e["epoch"] for e in resumed["epochs"]] == [3]
    a, b = _rows(root / "straight"), _rows(root / "cmp")
    assert [r["step"] for r in a] == [r["step"] for r in b]
    for ra, rb in zip(a, b):
        assert {k: v for k, v in ra.items() if k not in ("wall_s", "epoch")} \
            == {k: v for k, v in rb.items() if k not in ("wall_s", "epoch")}
    s = torch.load(root / "straight" / "cmp_latest.pt", weights_only=True)
    r = torch.load(root / "cmp" / "cmp_latest.pt", weights_only=True)
    assert s["step"] == r["step"] == 15 and s["opt"]["count"] == 15
    assert all(torch.equal(s["C"][k], r["C"][k]) for k in s["C"])


def test_pairwise_hard_pretrains_on_the_easy_base(pretrained):
    """As the JAX CLI (root ``train.py:675-682``) does, every mode but
    ``comparisons`` pretrains on ``pairwise``: a ``pairwise_hard`` epoch is
    the straight run's first epoch."""
    root, _, _, _ = pretrained
    argv = [a if a != "pairwise" else "pairwise_hard" for a in PRETRAIN]
    train_main.main(argv + ["--checkpoints_dir", str(root), "--name", "hard",
                            "--niter", "1"])
    first = [r for r in _rows(root / "straight") if r["step"] <= 5]
    hard = _rows(root / "hard")
    assert [r["step"] for r in hard] == [r["step"] for r in first]
    for ra, rb in zip(hard, first):
        assert {k: v for k, v in ra.items() if k != "wall_s"} \
            == {k: v for k, v in rb.items() if k != "wall_s"}


@pytest.mark.parametrize("cond_mode", ["onehot", "score"])
def test_gan_with_comparator_then_sample(pretrained, tmp_path, cond_mode):
    root = pretrained[0]
    ck = ["--checkpoints_dir", str(tmp_path), "--name", "gan",
          "--cond_mode", cond_mode]
    res = train_main.main(GAN + ck + ["--comparator_path",
                                      str(root / "cmp")])
    assert res["step"] == 2
    rows = _rows(tmp_path / "gan")
    assert all(np.isfinite(r["loss_G_cond"]) and r["loss_G_cond"] != 0.0
               for r in rows)
    # --continue_train takes comparator_path from opt.json
    res = train_main.main(GAN + ck + ["--niter", "2", "--continue_train"])
    assert res["step"] == 4 and res["metrics"]["loss_G_cond"] != 0.0

    out = port_test.main(COMMON + ["--dataset_mode", "synthetic",
                                   "--max_dataset_size", "2",
                                   "--num_test", "2", "--batch_size", "2",
                                   "--checkpoints_dir", str(tmp_path),
                                   "--name", "gan",
                                   "--results_dir", str(tmp_path / "res")])
    pngs = sorted(os.listdir(os.path.join(out["web_dir"], "images")))
    assert len(pngs) == 2 * (1 + 4)
    with open(os.path.join(out["web_dir"], "index.html")) as f:
        html = f.read()
    if cond_mode == "score":
        assert [p[5:-4] for p in pngs[:5]] == [
            "input", "score_+0.33", "score_+1.00", "score_-0.33",
            "score_-1.00"]
        assert "score_-1.00" in html and "age_" not in html
    else:
        assert "age_" in html and "score_" not in html


def test_lambda_cond_zero_leaves_the_comparator_out(pretrained, tmp_path):
    res = train_main.main(GAN + ["--checkpoints_dir", str(tmp_path),
                                 "--name", "g0", "--lambda_cond", "0",
                                 "--comparator_path",
                                 str(pretrained[0] / "cmp")])
    assert res["metrics"]["loss_G_cond"] == 0.0
