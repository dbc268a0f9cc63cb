"""A cell on several cards: one worker process a card, joined over
localhost as ``torchrun`` joins them (its environment variables, one
OpenMP thread a process), each running ``portbench/run.py --worker``."""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

RUN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "run.py")
FORBIDDEN = ("jax", "jaxlib", "flax", "pcgan_tpu")
WORKER_TIMEOUT_S = 330


def loaded_forbidden():
    """Top-level module names of JAX or the JAX package in this process,
    compared whole (``pcgan_tpu_torch`` is not ``pcgan_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(cell, seed: int, seconds: float, traced: bool, t0: float,
                device: str = "cuda", extra=(), patch: str = "") -> list:
    """Each rank's result (``train_cell.program_run``), in rank order.
    ``patch`` ('module:function', the fault tests) is called in each
    worker before its run."""
    world = int(cell.traffic["ranks"])
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="portbench_ranks_") as d:
        with open(os.path.join(d, "cell.pkl"), "wb") as f:
            pickle.dump({"cell": cell, "device": device,
                         "extra": list(extra), "patch": patch}, f)
        procs = []
        try:
            for r in range(world):
                env = dict(os.environ, MASTER_ADDR="localhost",
                           MASTER_PORT=str(port), WORLD_SIZE=str(world),
                           RANK=str(r), LOCAL_RANK=str(r),
                           OMP_NUM_THREADS="1")
                cmd = [sys.executable, RUN, "--worker", d,
                       "--workload", cell.name, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace",
                       str(int(traced)), "--t0", repr(t0)]
                procs.append(subprocess.Popen(cmd, env=env,
                                              start_new_session=True))
            deadline = time.time() + WORKER_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, 9)
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(procs)
               if p.returncode != 0]
        if bad:
            raise RuntimeError(f"portbench: worker ranks failed (rank, "
                               f"exit code): {bad}")
        out = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
