"""The benchmark of the PyTorch port (``pcgan_tpu_torch``) on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the cards of this machine and
prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit, which are also the last lines of standard error. It exits non-zero
without a result when the cards the cell asks for are missing, when the
run fails, or when JAX or the JAX package was loaded.

A cell on several cards starts one worker process a card (this file with
``--worker``), joined as ``torchrun`` would join them, and runs the
comparison and the report in this process.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
# kernel build caches inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, os.path.join(REPO, "build", "portbench", sub))

def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--worker", default="", help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = _args(argv)
    if a.worker:
        return _worker(a)
    from portbench.harness.spec import find_cell
    cell = find_cell(a.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA "
              f"card(s), this machine has {have}", file=sys.stderr)
        return 3
    from portbench.harness.report import run_cell
    line, checks = run_cell(cell, a.seed, a.seconds, bool(a.trace), T0)
    for name, row in checks.items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def _worker(a) -> int:
    with open(os.path.join(a.worker, "cell.pkl"), "rb") as f:
        job = pickle.load(f)
    from portbench.harness import ranks, train_cell
    if job["patch"]:
        import importlib
        mod, _, fn = job["patch"].partition(":")
        getattr(importlib.import_module(mod), fn)()
    out = train_cell.program_run(job["cell"], a.seed, a.seconds,
                                 bool(a.trace), a.t0, job["device"],
                                 job["extra"])
    bad = ranks.loaded_forbidden()
    if bad:
        print(f"portbench: rank {out['rank']} loaded {bad}", file=sys.stderr)
        return 4
    with open(os.path.join(a.worker, f"rank{out['rank']}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
