"""Static loss-curve rendering from metrics.jsonl (a copy of ``pcgan_tpu/utils/loss_plot.py``).

The reference plots live loss curves through a visdom server
(``Visualizer.plot_current_losses``). This module renders a
dependency-free static SVG from the ``metrics.jsonl`` the trainer writes:
one polyline per loss series, auto-scaled axes, a legend, written next to
the log (``loss_curves.svg``) and re-rendered every epoch.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

# keys that are bookkeeping, not plottable loss series
_META_KEYS = frozenset({"step", "epoch", "wall_s", "imgs_per_sec", "lr"})

# categorical palette (colorblind-safe, dark-on-white)
_COLORS = ("#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e",
           "#8c564b", "#e377c2", "#17becf", "#bcbd22", "#7f7f7f")


def read_metrics(jsonl_path: str) -> List[Dict[str, float]]:
    records = []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line from a live writer
    return records


def _series_keys(records: Sequence[Dict]) -> List[str]:
    """Default series: loss_* keys only. Everything shares ONE y-range, so
    mixing in e.g. eval_fid_images (=1024) would squash the loss curves to
    a flat line; other keys are plottable by passing them explicitly."""
    keys: List[str] = []
    for r in records:
        for k, v in r.items():
            if k in _META_KEYS or k in keys or not k.startswith("loss"):
                continue
            if isinstance(v, (int, float)):
                keys.append(k)
    return keys


def _fmt(v: float) -> str:
    a = abs(v)
    if a != 0 and (a < 1e-2 or a >= 1e4):
        return f"{v:.2e}"
    return f"{v:.3g}"


def render_loss_svg(records: Sequence[Dict], keys: Optional[Sequence[str]] = None,
                    width: int = 960, height: int = 400,
                    title: str = "training losses",
                    x_label: str = "step") -> str:
    """Render loss series to an SVG string. ``records`` are metrics.jsonl
    rows (must contain ``step``); ``keys`` defaults to every numeric
    non-bookkeeping key present."""
    records = [r for r in records if "step" in r]
    if keys is None:
        keys = _series_keys(records)
    keys = [k for k in keys if any(k in r for r in records)]
    ml, mr, mt, mb = 64, 160, 28, 36  # margins: left/right/top/bottom
    pw, ph = width - ml - mr, height - mt - mb
    parts = [
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{width}' "
        f"height='{height}' viewBox='0 0 {width} {height}' "
        f"font-family='monospace' font-size='11'>",
        f"<rect width='{width}' height='{height}' fill='white'/>",
        f"<text x='{ml}' y='16' font-size='13'>{title}</text>",
    ]
    if not records or not keys:
        parts.append(f"<text x='{ml}' y='{height // 2}'>no data</text></svg>")
        return "\n".join(parts)

    xs = [float(r["step"]) for r in records]
    x0, x1 = min(xs), max(xs)
    ys = [float(r[k]) for r in records for k in keys if k in r]
    y0, y1 = min(ys), max(ys)
    if x1 == x0:
        x1 = x0 + 1.0
    if y1 == y0:
        y1 = y0 + 1.0
    pad = 0.05 * (y1 - y0)
    y0, y1 = y0 - pad, y1 + pad

    def X(x):
        return ml + (x - x0) / (x1 - x0) * pw

    def Y(y):
        return mt + (1.0 - (y - y0) / (y1 - y0)) * ph

    # frame + gridlines + tick labels
    parts.append(f"<rect x='{ml}' y='{mt}' width='{pw}' height='{ph}' "
                 "fill='none' stroke='#888'/>")
    for i in range(5):
        gy = y0 + (y1 - y0) * i / 4
        py = Y(gy)
        parts.append(f"<line x1='{ml}' y1='{py:.1f}' x2='{ml + pw}' "
                     f"y2='{py:.1f}' stroke='#ddd'/>")
        parts.append(f"<text x='{ml - 6}' y='{py + 4:.1f}' "
                     f"text-anchor='end'>{_fmt(gy)}</text>")
    for i in range(5):
        gx = x0 + (x1 - x0) * i / 4
        px = X(gx)
        parts.append(f"<text x='{px:.1f}' y='{height - 12}' "
                     f"text-anchor='middle'>{int(gx)}</text>")
    parts.append(f"<text x='{ml + pw // 2}' y='{height - 1}' "
                 f"text-anchor='middle'>{x_label}</text>")

    for i, k in enumerate(keys):
        color = _COLORS[i % len(_COLORS)]
        pts = [(X(float(r["step"])), Y(float(r[k])))
               for r in records if k in r]
        path = " ".join(f"{px:.1f},{py:.1f}" for px, py in pts)
        parts.append(f"<polyline points='{path}' fill='none' "
                     f"stroke='{color}' stroke-width='1.3'/>")
        ly = mt + 14 + 16 * i
        last = next(float(r[k]) for r in reversed(records) if k in r)
        parts.append(f"<line x1='{ml + pw + 8}' y1='{ly - 4}' "
                     f"x2='{ml + pw + 26}' y2='{ly - 4}' stroke='{color}' "
                     "stroke-width='2'/>")
        parts.append(f"<text x='{ml + pw + 30}' y='{ly}'>"
                     f"{k} = {_fmt(last)}</text>")
    parts.append("</svg>")
    return "\n".join(parts)


def write_loss_plot(run_dir: str, jsonl: str = "metrics.jsonl",
                    out: str = "loss_curves.svg",
                    keys: Optional[Sequence[str]] = None) -> Optional[str]:
    """Render ``run_dir/metrics.jsonl`` -> ``run_dir/loss_curves.svg``.
    Returns the output path, or None when there is nothing to plot yet.
    Write is atomic (tmp + rename) so a browser refresh never sees a torn
    file."""
    src = os.path.join(run_dir, jsonl)
    if not os.path.exists(src):
        return None
    records = read_metrics(src)
    if not records:
        return None
    svg = render_loss_svg(records, keys=keys)
    dst = os.path.join(run_dir, out)
    tmp = dst + ".tmp"
    with open(tmp, "w") as f:
        f.write(svg)
    os.replace(tmp, dst)
    return dst
