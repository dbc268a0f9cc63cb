"""Caps torch's intra-op threads in a pytest-xdist worker (a helper, not a
test file; every ``test_torch_port_*.py`` imports it).

Under ``-n N`` each of the N worker processes runs its tests beside the
others, and torch's default pool takes every core in each of them, so N
pools of one thread a core (beside XLA's) contend for the same cores. In a
worker the pool gets its share of the cores, cores // N and at least one;
a run without xdist keeps torch's default. The ranks of a gloo cohort run
on one thread already (``torch_port_parallel_worker.main``)."""

import os

import torch


def worker_threads() -> int:
    """This process's share of the cores under xdist, else torch's pool."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers <= 1:
        return torch.get_num_threads()
    return max(1, len(os.sched_getaffinity(0)) // workers)


torch.set_num_threads(worker_threads())
