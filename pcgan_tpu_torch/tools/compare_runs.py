"""Overlay one metric from several runs in one SVG (counterpart of
``tools/compare_runs.py``).

    python -m pcgan_tpu_torch.tools.compare_runs --runs /ckpt/base,/ckpt/ada \\
        --key loss_G_L1 --out /tmp/compare_l1.svg
    python -m pcgan_tpu_torch.tools.compare_runs --runs a,b --key eval_fid \\
        --x epoch

One polyline per run, drawn by ``utils/loss_plot.render_loss_svg``. Run
labels default to the directory basenames (``--labels`` overrides);
``--x epoch`` plots against the epoch column (default: step).
"""

from __future__ import annotations

import argparse
import os


def comparison_svg(series, key: str, x_key: str = "step",
                   width: int = 960, height: int = 400) -> str:
    """``series``: (label, records) pairs. The runs are merged into one
    record stream with per-run key names (``<key> [label]``) and drawn by
    ``render_loss_svg``."""
    from pcgan_tpu_torch.utils.loss_plot import render_loss_svg
    merged, keys = [], []
    for label, records in series:
        name = f"{key} [{label}]"
        keys.append(name)
        for r in records:
            if key in r and x_key in r:
                merged.append({"step": float(r[x_key]),
                               name: float(r[key])})
    merged.sort(key=lambda r: r["step"])
    return render_loss_svg(merged, keys=keys, width=width, height=height,
                           title=f"{key} across runs (x = {x_key})",
                           x_label=x_key)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        description="overlay one metric from several runs into one SVG")
    ap.add_argument("--runs", required=True,
                    help="comma-separated run dirs (each containing "
                         "metrics.jsonl)")
    ap.add_argument("--key", required=True,
                    help="metric key to compare (e.g. loss_G_L1, eval_fid)")
    ap.add_argument("--labels", default="",
                    help="comma-separated legend labels (default: dir names)")
    ap.add_argument("--x", default="step", dest="x_key",
                    help="x axis column: step (default) or epoch")
    ap.add_argument("--out", default="compare.svg")
    args = ap.parse_args(argv)

    from pcgan_tpu_torch.utils.loss_plot import read_metrics

    dirs = [d.strip() for d in args.runs.split(",") if d.strip()]
    if len(dirs) < 2:
        raise SystemExit("--runs needs at least two run dirs to compare")
    labels = ([lb.strip() for lb in args.labels.split(",") if lb.strip()]
              if args.labels else
              [os.path.basename(os.path.normpath(d)) for d in dirs])
    if len(labels) != len(dirs):
        raise SystemExit(f"--labels gave {len(labels)} names for "
                         f"{len(dirs)} runs")
    series, hits = [], 0
    for label, d in zip(labels, dirs):
        src = os.path.join(d, "metrics.jsonl")
        if not os.path.exists(src):
            raise SystemExit(f"no metrics.jsonl under {d}")
        records = read_metrics(src)
        n = sum(1 for r in records if args.key in r and args.x_key in r)
        if n == 0:
            print(f"note: run '{label}' has no '{args.key}' rows", flush=True)
        hits += n
        series.append((label, records))
    if hits == 0:
        raise SystemExit(f"metric '{args.key}' appears in none of the runs")
    svg = comparison_svg(series, args.key, x_key=args.x_key)
    with open(args.out, "w") as f:
        f.write(svg)
    print(f"wrote {args.out} ({len(series)} runs, key={args.key})",
          flush=True)
    return args.out


if __name__ == "__main__":
    main()
