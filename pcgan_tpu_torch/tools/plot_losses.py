"""Render loss curves from a run's metrics.jsonl to a standalone SVG
(counterpart of ``tools/plot_losses.py``).

The trainer already re-renders ``loss_curves.svg`` every epoch
(``utils/loss_plot.py``); this CLI covers after-the-fact use:

    python -m pcgan_tpu_torch.tools.plot_losses checkpoints/<name> \\
        [--keys loss_G,loss_D]
    python -m pcgan_tpu_torch.tools.plot_losses path/to/metrics.jsonl \\
        --out /tmp/loss.svg
"""

import argparse
import os


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run", help="run dir containing metrics.jsonl, or the "
                               "jsonl file itself")
    p.add_argument("--out", default="", help="output .svg path (default: "
                                             "loss_curves.svg next to input)")
    p.add_argument("--keys", default="", help="comma-separated series "
                                              "(default: all loss keys)")
    args = p.parse_args(argv)

    from pcgan_tpu_torch.utils.loss_plot import read_metrics, render_loss_svg

    src = args.run
    if os.path.isdir(src):
        src = os.path.join(src, "metrics.jsonl")
    if not os.path.exists(src):
        raise SystemExit(f"no metrics file at {src}")
    records = read_metrics(src)
    if not records:
        raise SystemExit(f"{src} has no records")
    keys = [k for k in args.keys.split(",") if k] or None
    svg = render_loss_svg(records, keys=keys,
                          title=os.path.basename(os.path.dirname(src)) or
                          "training losses")
    out = args.out or os.path.join(os.path.dirname(src), "loss_curves.svg")
    with open(out, "w") as f:
        f.write(svg)
    print(f"wrote {out} ({len(records)} records)")
    return out


if __name__ == "__main__":
    main()
