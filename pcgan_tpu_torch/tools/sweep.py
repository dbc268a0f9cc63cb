"""Sequential hyperparameter sweep over the port's trainer (counterpart of
``tools/sweep.py``).

    python -m pcgan_tpu_torch.tools.sweep --grid "lr=1e-4,2e-4;lambda_L1=50,100" \\
        --name ablate --checkpoints_dir /tmp/runs \\
        [--summary_metric loss_G] [--compare loss_G] -- \\
        --dataset_mode synthetic --crop_size 64 --batch_size 8 --niter 2

Runs ``python -m pcgan_tpu_torch.train_main`` once per grid combination
(the cartesian product), naming each run ``<name>__k=v__k=v`` under the
shared checkpoints dir, then collects every run's LAST metrics.jsonl
record (train losses and any ``eval_*`` keys) into
``<checkpoints_dir>/<name>_sweep.json`` and prints a ranked table.
``--compare KEY`` also renders the multi-run overlay SVG
(``tools/compare_runs.py``) for that metric.

Combinations run one after another (one card, one process at a time). A
failing combination is recorded with its return code and log tail, the
summary names it, and the sweep goes on: one diverged run must not cost
the grid. The command exits 1 when no combination succeeded.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_grid(spec: str):
    """'lr=1e-4,2e-4;lambda_L1=50,100' -> [('lr', ['1e-4','2e-4']), ...]
    (values stay strings: the trainer's parser owns the types)."""
    axes = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"grid axis {part!r} is not key=v1,v2,...")
        key, _, vals = part.partition("=")
        values = [v.strip() for v in vals.split(",") if v.strip()]
        if not values:
            raise ValueError(f"grid axis {key!r} has no values")
        axes.append((key.strip().lstrip("-"), values))
    if not axes:
        raise ValueError(f"empty grid spec {spec!r}")
    return axes


def combo_name(base: str, combo) -> str:
    return base + "".join(f"__{k}={v}" for k, v in combo)


def last_metrics(run_dir: str):
    """The last record of metrics.jsonl (train keys merged with the latest
    eval record's ``eval_*`` keys), or None."""
    from pcgan_tpu_torch.utils.loss_plot import read_metrics
    try:
        records = read_metrics(os.path.join(run_dir, "metrics.jsonl"))
    except OSError:
        return None
    last_train, last_eval = None, {}
    for rec in records:
        if any(k.startswith("eval_") for k in rec):
            last_eval = rec
        else:
            last_train = rec
    if last_train is None and not last_eval:
        return None
    out = dict(last_train or {})
    out.update({k: v for k, v in last_eval.items() if k.startswith("eval_")})
    return out


def run_sweep(grid, base_args, name: str, checkpoints_dir: str,
              summary_metric: str = "loss_G", python=sys.executable) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    keys = [k for k, _ in grid]
    results = []
    for values in itertools.product(*[v for _, v in grid]):
        combo = list(zip(keys, values))
        run_name = combo_name(name, combo)
        argv = [python, "-m", "pcgan_tpu_torch.train_main", *base_args,
                "--name", run_name, "--checkpoints_dir", checkpoints_dir]
        for k, v in combo:
            argv += [f"--{k}", v]
        t0 = time.time()
        print(f"sweep: {run_name} ...", flush=True)
        p = subprocess.run(argv, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True, env=env)
        rec = {"name": run_name, "combo": dict(combo),
               "returncode": p.returncode,
               "wall_s": round(time.time() - t0, 1)}
        if p.returncode != 0:
            rec["log_tail"] = p.stdout[-2000:]
            print(f"sweep: {run_name} FAILED rc={p.returncode}", flush=True)
        else:
            rec["metrics"] = last_metrics(
                os.path.join(checkpoints_dir, run_name)) or {}
        results.append(rec)

    ok = [r for r in results if r["returncode"] == 0
          and summary_metric in r.get("metrics", {})]
    ok.sort(key=lambda r: r["metrics"][summary_metric])
    summary = {"name": name, "grid": {k: v for k, v in grid},
               "summary_metric": summary_metric, "runs": results,
               "best": ok[0]["name"] if ok else None}
    out_path = os.path.join(checkpoints_dir, f"{name}_sweep.json")
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\nsweep summary ({summary_metric} ascending) -> {out_path}")
    for r in ok:
        print(f"  {r['metrics'][summary_metric]:>10.4f}  {r['name']}"
              f"  ({r['wall_s']}s)")
    for r in results:
        if r["returncode"] != 0:
            print(f"      FAILED  {r['name']} (rc={r['returncode']})")
    return summary


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        own, base_args = argv[:split], argv[split + 1:]
    else:
        own, base_args = argv, []
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--grid", required=True,
                   help="semicolon-separated axes: key=v1,v2;key2=v3,v4")
    p.add_argument("--name", default="sweep")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--summary_metric", default="loss_G",
                   help="rank runs by this metrics.jsonl key (ascending)")
    p.add_argument("--compare", default="",
                   help="also render the multi-run overlay SVG for this "
                        "metric (tools/compare_runs.py)")
    args = p.parse_args(own)

    grid = parse_grid(args.grid)
    os.makedirs(args.checkpoints_dir, exist_ok=True)
    summary = run_sweep(grid, base_args, args.name, args.checkpoints_dir,
                        args.summary_metric)
    if args.compare:
        from pcgan_tpu_torch.tools.compare_runs import main as compare_main
        dirs = [os.path.join(args.checkpoints_dir, r["name"])
                for r in summary["runs"] if r["returncode"] == 0]
        if len(dirs) >= 2:
            svg = os.path.join(args.checkpoints_dir,
                               f"{args.name}_compare_{args.compare}.svg")
            compare_main(["--runs", ",".join(dirs), "--key", args.compare,
                          "--out", svg])
            print(f"comparison SVG -> {svg}")
    return 0 if any(r["returncode"] == 0 for r in summary["runs"]) else 1


if __name__ == "__main__":
    sys.exit(main())
