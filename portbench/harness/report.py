"""One run of a cell: the program's run, the comparison with the plain
reference, the metrics and the result line."""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.harness import canvases, checks, flops, peaks, weights
from portbench.harness import grid_cell, train_cell
from portbench.harness import ranks as ranks_mod
from portbench.harness.trace import breakdown
from portbench.reference import grid as ref_grid
from portbench.reference import train as ref_train

GIB = float(2 ** 30)


def run_cell(cell, seed: int, seconds: float, traced: bool, t0: float,
             device: str = "cuda", extra=(), patch=None
             ) -> Tuple[Dict, Dict]:
    """(result line, checks) of one run; ``device``, ``extra`` (argv added
    to the configuration's) and ``patch`` serve the CPU tests (on several
    ranks ``patch`` is a 'module:function' each worker calls first)."""
    kind = cell.traffic["kind"]
    world = int(cell.traffic.get("ranks", 1))
    if kind == "train" and world > 1:
        bare = dataclasses.replace(cell, readers={})
        ranks = ranks_mod.run_workers(bare, seed, seconds, traced, t0,
                                      device, extra, patch or "")
    elif kind == "train":
        ranks = [train_cell.program_run(cell, seed, seconds, traced, t0,
                                        device, extra, patch)]
    elif kind == "grid":
        ranks = [grid_cell.program_run(cell, seed, seconds, traced, t0,
                                       device, extra, patch)]
    else:
        raise SystemExit(f"portbench: traffic kind {kind!r} has no runner")
    bad = ranks_mod.loaded_forbidden()
    if bad:
        raise SystemExit(f"portbench: JAX or the JAX package was loaded: "
                         f"{bad}")
    dev = torch.device(device)
    nums, extra = (_check_train(cell, seed, ranks, dev) if kind == "train"
                   else _check_grid(cell, seed, ranks[0], dev))
    correct, rows = checks.judge(_compared(cell, nums, extra), cell.limits)
    line = _line(cell, ranks, traced, correct, dev)
    line["checks"] = rows
    return line, rows


def _spec(cell) -> ref_train.StepSpec:
    m = cell.config["model"]
    return ref_train.StepSpec(
        n_blocks=m["n_blocks"], n_layers_d=m["n_layers_D"],
        cmp_n_down=m["cmp_n_down"] if m.get("comparator") else 0,
        n_bins=m["n_bins"], load=m["load"], crop=m["crop"], pool=m["pool"],
        lambda_l1=m["lambda_L1"], lambda_cond=m.get("lambda_cond", 0.0),
        lr=m["lr"],
        beta1=m["beta1"], beta2=m["beta2"], block=m["ref_rows"])


def _check_train(cell, seed: int, ranks: List[Dict], dev
                 ) -> Tuple[Dict[str, float], Dict]:
    """(numbers, readings) of the ranks' first steps against the
    reference's."""
    m, tr = cell.config["model"], cell.traffic
    images, ages = canvases.make_canvases(tr["data_rows"], m["native"], seed,
                                          dev)
    fed = [(b["image"], b["age"], b["bin"]) for r in ranks for b in r["fed"]]
    bad = checks.bad_rows(fed, images, ages, m["n_bins"])
    del images
    w = weights.draw(m, seed, dev)
    anchors = None
    if m.get("comparator"):
        lo, hi = weights.anchors(seed, m["n_bins"])
        anchors = (lo.to(dev), hi.to(dev))
    steps = len(ranks[0]["fed"])
    inputs = [[(r["fed"][t]["image"], r["fed"][t]["age"]) for r in ranks]
              for t in range(steps)]
    seeds = [ref_train.rank_seed(seed + 2, r) for r in range(len(ranks))]
    ref = ref_train.train_steps(_spec(cell), w, anchors, inputs, seeds, dev)
    nums, extra = checks.train_readings(ranks, ref)
    nums["data_rows"] = float(bad)
    return nums, extra


def _compared(cell, nums: Dict[str, float], extra=None) -> Dict[str, float]:
    """The numbers the cell's limits name; the others, and ``extra``, are
    printed to standard error as readings."""
    for k, v in {**nums, **(extra or {})}.items():
        if k not in cell.limits:
            print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    return {k: v for k, v in nums.items() if k in cell.limits}


def _check_grid(cell, seed: int, run: Dict, dev
                ) -> Tuple[Dict[str, float], Dict]:
    m = cell.config["model"]
    images, _ = run["canvases"]
    g = weights.draw(m, seed, dev, nets=("G",))["G"]
    crop_gap = 0.0
    per_image = []
    for (crops, fakes), rows in run["kept"].values():
        rc, rf = ref_grid.grid(g, images[rows], m["n_blocks"], m["n_bins"],
                               m["load"], m["crop"], dev)
        if crops.shape != tuple(rc.shape) or fakes.shape != tuple(rf.shape):
            return {"crop_gap": math.inf, "image_gap_p99": math.inf}, {}
        crop_gap = max(crop_gap, float(np.abs(crops - rc.cpu().numpy()).max()))
        per = np.abs(fakes - rf.cpu().numpy()).mean(axis=(2, 3, 4))
        per_image.extend(np.nan_to_num(per, nan=np.inf).ravel().tolist())
    return checks.grid_numbers(crop_gap, per_image), {}


def _e2e(cell, ranks: List[Dict]) -> Dict[str, float]:
    r0 = ranks[0]
    window = max(r["window_s"] for r in ranks)
    out = {"setup_s": max(r["setup_s"] for r in ranks),
           "peak_mem_gib": max(r["peak_bytes"] for r in ranks) / GIB}
    if cell.traffic["kind"] == "train":
        out["train_imgs_per_s"] = r0["images"] / window
    else:
        out["grid_faces_per_s"] = r0["faces"] / window
        out["grid_ms_p95"] = 1e3 * float(np.percentile(r0["latencies"], 95))
    return out


def _ctx(cell, ranks: List[Dict]) -> Dict:
    m, tr = cell.config["model"], cell.traffic
    r0 = ranks[0]
    kind = tr["kind"]
    if kind == "train":
        per_step = flops.train_step_flops(m, tr["batch_per_rank"])
        b = tr["batch_per_rank"]
        steps = r0["steps"]
    else:
        per_step = flops.grid_flops(m, tr["faces_per_call"])
        b = tr["faces_per_call"]
        steps = r0["calls"]
    out_bytes = 2 if m["dtype"] == "bfloat16" else 4
    return {
        "kind": kind, "world": len(ranks), "steps": steps,
        "window_s": max(r["window_s"] for r in ranks),
        "flops_per_step": per_step,
        "peak_flops": peaks.PEAK_FLOPS[m["dtype"]],
        "hbm_bytes_per_s": peaks.HBM_BYTES_PER_S,
        "b1_bytes": b * (m["native"] ** 2 * 3 + m["crop"] ** 2 * 3
                         * out_bytes),
        "traces": [(r["trace"], r.get("traced_steps", 0)) for r in ranks
                   if r["trace"] is not None],
        "dispatch_ms": float(np.mean([r.get("dispatch_ms", math.nan)
                                      for r in ranks])),
        "data_wait_ms": float(np.mean([r.get("data_wait_ms",
                                             r.get("data_ms", math.nan))
                                       for r in ranks])),
    }


def _line(cell, ranks: List[Dict], traced: bool, correct: bool, dev) -> Dict:
    world = len(ranks)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                       else "cpu"),
              "count": world,
              "memory_peak_bytes": max(r["peak_bytes"] for r in ranks),
              "power_limit_w": (peaks.power_limit() if dev.type == "cuda"
                                else "none")}
    attempted = sum(r.get("steps", r.get("calls", 0)) for r in ranks[:1])
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": sum(r["failed"] for r in ranks)}
    if not traced:
        # a name's part before its first dot names the quantity; the rest
        # tells apart the cells whose bounds differ
        vals = _e2e(cell, ranks)
        line["metrics"] = {m["name"]: {"value": vals[m["name"].split(".")[0]],
                                       "unit": m["unit"]}
                           for m in cell.end_to_end}
    else:
        ctx = _ctx(cell, ranks)
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        line["metrics"] = metrics
        tr = [t for t, _ in ctx["traces"]]
        device["busy_s"] = float(np.mean([t.busy_s for t in tr]))
        device["window_s"] = float(np.mean([t.window_s for t in tr]))
        line["breakdown"] = breakdown(tr[0])
    line["device"] = device
    return line
