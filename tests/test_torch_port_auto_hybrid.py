"""The hybrid mesh of the port (``--dcn_data``,
``pcgan_tpu_torch/parallel/mesh.py``) against
``pcgan_tpu.parallel.mesh.make_hybrid_mesh``.

- The layout: the data axis factors granule-major over the granules, the
  inner axes stay inside one, an oversized granule gives its first ranks;
  the port's rank array equals JAX's device-id array for the same
  granules. The constructor's errors are JAX's, word for word.
- A step on a permuted layout equals the step on the plain layout: in
  ``test_torch_port_auto_step.py``, whose four-rank cohort runs both.
- The train CLI under two torchrun agents (``--nnodes 2 --node_rank k``,
  gloo), one rank a node, with ``--mesh_shape 2 --dcn_data 2 --zero1``:
  both agents exit 0, the mesh reads one granule a node, and the loss
  stream is the one-process plain run's (1e-4 rel).
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest

from pcgan_tpu.parallel.mesh import make_hybrid_mesh

from pcgan_tpu_torch import train_main
from pcgan_tpu_torch.parallel.mesh import hybrid_layout

from torch_port_parallel_worker import REPO, _free_port

LAYOUTS = {  # name: (shape, axes, dcn_data, granule of id, devices)
    "data_model_4x2": ((4, 2), ("data", "model"), 2, lambda i: i % 2, 8),
    "data_auto": ((-1,), ("data",), 4, lambda i: i % 4, 8),
    "subset": ((4,), ("data",), 2, lambda i: i % 2, 8),
    "data_model_2x2": ((2, 2), ("data", "model"), 2, lambda i: i % 2, 4)}
ERRORS = {  # the cases of tests/test_hybrid_mesh.py
    "divisible": ((4,), ("data",), 3, lambda i: i % 3, 8),
    "one_granule": ((8,), ("data",), 2, lambda i: 0, 8),
    "no_data_axis": ((8,), ("model",), 2, lambda i: i % 2, 8),
    "three_granules": ((6,), ("data",), 2, lambda i: i % 3, 6),
    "short": ((6,), ("data",), 2, lambda i: i // 4, 6)}
BASE = ["--dataset_mode", "synthetic", "--max_dataset_size", "16",
        "--batch_size", "4", "--load_size", "36", "--crop_size", "32",
        "--netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8",
        "--n_age_bins", "4", "--niter_decay", "0", "--print_freq", "1",
        "--cond_inject", "bottleneck", "--pool_size", "4", "--dtype",
        "float32", "--device", "cpu", "--num_threads", "1", "--niter", "1"]


def _jax(shape, axes, dcn, granule, n):
    mesh = make_hybrid_mesh(shape, axes, dcn, devices=jax.devices()[:n],
                            granule_of=lambda d: granule(d.id))
    return np.vectorize(lambda d: d.id)(mesh.devices)


def _port(shape, axes, dcn, granule, n):
    return hybrid_layout(shape, axes, dcn, list(range(n)),
                         [granule(i) for i in range(n)])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_matches_jax(name):
    want = _jax(*LAYOUTS[name])
    got = _port(*LAYOUTS[name])
    np.testing.assert_array_equal(got, want)
    if name == "data_model_2x2":
        assert got.tolist() == [[0, 2], [1, 3]]


@pytest.mark.parametrize("name", list(ERRORS))
def test_constructor_errors_match_jax(name):
    with pytest.raises(ValueError) as j:
        _jax(*ERRORS[name])
    with pytest.raises(ValueError) as p:
        _port(*ERRORS[name])
    assert str(p.value) == str(j.value)


def _losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["loss_G"] for r in rows if "loss_G" in r]


def test_cli_under_two_torchrun_agents(tmp_path):
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "GROUP_RANK"):
        env.pop(k, None)
    argv = BASE + ["--checkpoints_dir", str(tmp_path), "--name", "dcn",
                   "--mesh_shape", "2", "--dcn_data", "2", "--zero1"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
         "--node_rank", str(k), "--nproc_per_node", "1", "--master_addr",
         "127.0.0.1", "--master_port", port, "-m",
         "pcgan_tpu_torch.train_main", *argv], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for k in range(2)]
    try:
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "sharded-state step over mesh data=2 + zero1" in outs[0]
    train_main.main(BASE + ["--checkpoints_dir", str(tmp_path), "--name",
                            "one", "--mesh_shape", "1"])
    got, want = (_losses(tmp_path / n) for n in ("dcn", "one"))
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
