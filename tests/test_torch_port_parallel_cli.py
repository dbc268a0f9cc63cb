"""The port's training CLI across two gloo ranks on the CPU.

- ``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
  pcgan_tpu_torch.train_main ... --device cpu --mesh_shape -1`` trains two
  epochs of a tiny synthetic set; rank 0 alone writes the run's files (one
  metrics row a logged step, not one a rank), and the checkpoint holds the
  pool of both ranks and each rank's generators;
- ``--mesh_shape 4`` under two ranks raises in every rank;
- exact resume, in one cohort (``torch_port_parallel_worker.py``) that
  calls ``train_main.main`` on both ranks: a run cut right after its
  mid-epoch 'latest' save at step 6 (of 4 steps an epoch), resumed with
  ``--continue_train``, logs the uninterrupted run's losses bit for bit
  (the pool is on: each rank's pool rows and generators come back);
- each flag of the GSPMD step and the hybrid mesh (A10b) does what JAX
  does with it in one process: ``--zero1`` exits (no data axis to shard
  over), ``--dcn_data 2`` finds one granule, ``--spatial_shards`` trains
  (nothing reads it), and a data x model or data x spatial mesh of two
  devices needs two processes.

Each launch runs under its own timeout, and a cohort that outlives it is
killed with its process group.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from pcgan_tpu_torch import train_main

from torch_port_parallel_worker import REPO, run_cohort

BASE = ["--dataset_mode", "synthetic", "--max_dataset_size", "16",
        "--batch_size", "4", "--load_size", "36", "--crop_size", "32",
        "--netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8",
        "--n_age_bins", "4", "--niter_decay", "0", "--print_freq", "1",
        "--cond_inject", "bottleneck", "--pool_size", "4",
        "--device", "cpu", "--num_threads", "1", "--mesh_shape", "-1"]


def _torchrun(argv, timeout=120):
    """(exit code, output) of a 2-rank torchrun of ``train_main``; on
    timeout the launcher and its ranks are killed together."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "pcgan_tpu_torch.train_main",
         *argv], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out = p.communicate(timeout=timeout)[0]
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    return p.returncode, out


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(rows):
    return [{k: v for k, v in r.items() if k.startswith("loss")}
            for r in rows]


def test_torchrun_two_ranks_train_and_rank0_writes(tmp_path):
    rc, out = _torchrun(BASE + ["--name", "dp", "--checkpoints_dir",
                                str(tmp_path), "--niter", "2",
                                "--save_epoch_freq", "1",
                                "--display_freq", "3"])
    assert rc == 0, out
    assert "devices: 2 (cpu), mesh {'data': 2}" in out
    run = tmp_path / "dp"
    rows = _metrics(run)
    # 16 rows, 8 a rank, 2 a rank a batch: 4 steps an epoch
    assert [r["step"] for r in rows] == list(range(1, 9))
    assert {"latest.pt", "latest_G.pt", "epoch_1.pt", "epoch_2.pt",
            "opt.json", "loss_curves.svg"} <= set(os.listdir(run))
    assert len(os.listdir(run / "web" / "images")) == 2     # steps 3 and 6
    sd = torch.load(run / "latest.pt", weights_only=True)
    assert sd["step"] == 8 and len(sd["ranks"]) == 2
    assert tuple(sd["pool"]["imgs"].shape) == (4, 32, 32, 3)
    assert not torch.equal(sd["ranks"][0]["rng"], sd["ranks"][1]["rng"])


def test_torchrun_mesh_larger_than_the_world_raises(tmp_path):
    rc, out = _torchrun(BASE[:-2] + ["--mesh_shape", "4", "--name", "m4",
                                     "--checkpoints_dir", str(tmp_path),
                                     "--niter", "1"])
    assert rc != 0
    assert "--mesh_shape 4" in out


def test_resume_is_exact_across_ranks(tmp_path):
    def argv(name, *extra):
        return BASE + ["--name", name, "--checkpoints_dir", str(tmp_path),
                       "--niter", "2", "--save_epoch_freq", "0", *extra]
    cut = argv("cut", "--save_latest_freq", "3")
    runs = run_cohort({"train": {"kind": "train_runs", "runs": [
        (argv("straight"), None), (cut, 6),
        (cut + ["--continue_train"], None)]}}, tmp_path)
    assert [r["train"] for r in runs] == [[8, "cut", 8]] * 2
    a, b = _metrics(tmp_path / "straight"), _metrics(tmp_path / "cut")
    assert [r["step"] for r in b] == list(range(1, 9))
    assert _losses(a) == _losses(b)


_A10B = {"zero1": (SystemExit, "data axis > 1"),
         "spatial_shards": None,
         "dcn_data": (ValueError, "granule"),
         "mesh_shape_data,model": (ValueError, "--mesh_shape 1,2"),
         "mesh_shape_data,spatial": (ValueError, "--mesh_shape 1,2")}


@pytest.mark.parametrize("flags", [
    ["--zero1"], ["--spatial_shards", "2"], ["--dcn_data", "2"],
    ["--mesh_shape", "1,2", "--mesh_axes", "data,model"],
    ["--mesh_shape", "1,2", "--mesh_axes", "data,spatial"]],
    ids=lambda f: f[0].lstrip("-") + ("_" + f[-1] if len(f) > 2 else ""))
def test_a10b_flags_raise(tmp_path, flags):
    """One process, as JAX's train.py on one device: the ``_A10B`` error
    of each flag, or (``--spatial_shards``) a plain run."""
    key = flags[0].lstrip("-") + ("_" + flags[-1] if len(flags) > 2 else "")
    argv = BASE[:-2] + flags + ["--checkpoints_dir", str(tmp_path),
                                "--niter", "1", "--max_dataset_size", "4"]
    if _A10B[key] is None:
        assert train_main.main(argv)["step"] == 1
        return
    cls, match = _A10B[key]
    with pytest.raises(cls, match=match):
        train_main.main(argv)
