"""The readings that set each cell's limits, each judged by the cell's
limits as a run would judge it.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        [--program] [--out <file.json>]

Without ``--program`` it reads the upper ends: the plain reference put in
the program's place and computed one precision step below the
configuration's (fp8 for bf16, ``reference/lowp.py``), and the faults a
cell can have, planted in the reference put in the program's place; none
of it runs the program. For a training cell, each seed's reference steps
(as many as the cell compares, at the cell's batch, on rows drawn from
the seed) are compared, by every number the cell could compare, with: the
fp8 reference (``control``); a step that reads half of each rank's rows
(``half_batch``); on several ranks, each rank updating with its own
gradients, the exchange left out (``no_exchange``). A step that leaves
the state unchanged reads 1 by the change measures and needs no run. For
a grid cell: the fp8 crops and images (``control``), and one call's
answers altered where they are produced, two faces' images swapped
(``altered``).

With ``--program`` (training cells on one card) it reads the lower ends:
for each seed, the program's set-up and first steps as a run makes them
(no window), compared as a run compares them, all seeds in one process.

Each reading is printed as one JSON line, with ``correct`` as the cell's
limits judge its numbers. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _rank_dict(r):
    return {"losses": r.losses, "grad_norms": r.grad_norms,
            "change_norms": r.change_norms,
            "first_update": r.first_update, "change": r.change}


def _judged(cell, nums, extra=None) -> dict:
    """``nums`` and ``extra``, with ``correct`` as the cell's limits judge
    the numbers they name (a control has no fed rows to count)."""
    from portbench.harness import checks
    correct, _ = checks.judge(
        {k: v for k, v in nums.items() if k in cell.limits},
        {k: v for k, v in cell.limits.items() if k in nums})
    return {"correct": correct, **nums, **(extra or {})}


def train_control(cell, seed: int, device) -> dict:
    import numpy as np
    import torch
    from portbench.harness import canvases, checks, weights
    from portbench.harness.report import _spec
    from portbench.reference import lowp
    from portbench.reference import train as ref_train
    m, tr = cell.config["model"], cell.traffic
    world, b = int(tr.get("ranks", 1)), tr["batch_per_rank"]
    steps = tr["check_steps"]
    images, ages = canvases.make_canvases(tr["data_rows"], m["native"], seed,
                                          device)
    order = np.random.default_rng(seed).permutation(len(images))
    inputs = []
    for t in range(steps):
        row = []
        for r in range(world):
            idx = order[(t * world + r) * b:(t * world + r + 1) * b]
            row.append((images[idx], ages[idx]))
        inputs.append(row)
    w = weights.draw(m, seed, device)
    anchors = None
    if m.get("comparator"):
        lo, hi = weights.anchors(seed, m["n_bins"])
        anchors = (lo.to(device), hi.to(device))
    seeds = [ref_train.rank_seed(seed + 2, r) for r in range(world)]
    spec = _spec(cell)
    ref = ref_train.train_steps(spec, w, anchors, inputs, seeds, device)
    out = {}

    def numbers(rank_readings):
        ranks = [_rank_dict(r) for r in rank_readings]
        return _judged(cell, *checks.train_readings(ranks, ref))

    out["control"] = numbers([ref_train.train_steps(
        spec, w, anchors, inputs, seeds, device, q=lowp.fp8)])
    out["half_batch"] = numbers([ref_train.train_steps(
        spec, w, anchors, inputs, seeds, device, half_batch=True)])
    if world > 1:
        alone = dataclasses.replace(spec, pool=spec.pool // world)
        out["no_exchange"] = numbers([ref_train.train_steps(
            alone, w, anchors, [[row[r]] for row in inputs], [seeds[r]],
            device) for r in range(world)])
    torch.cuda.empty_cache() if device.type == "cuda" else None
    return out


def grid_control(cell, seed: int, device) -> dict:
    import numpy as np
    import torch
    from portbench.harness import canvases, checks, weights
    from portbench.reference import grid as ref_grid
    from portbench.reference import lowp
    m, tr = cell.config["model"], cell.traffic
    f = tr["faces_per_call"]
    images, _ = canvases.make_canvases(tr["data_rows"], m["native"], seed,
                                       device)
    g = weights.draw(m, seed, device, nets=("G",))["G"]
    order = np.random.default_rng(seed).permutation(len(images))
    crop = {"control": 0.0, "altered": 0.0}
    per = {"control": [], "altered": []}
    for call in range(tr["check_max"]):
        rows = order[call * f:(call + 1) * f]
        rc, rf = ref_grid.grid(g, images[rows], m["n_blocks"], m["n_bins"],
                               m["load"], m["crop"], device)
        _, qf = ref_grid.grid(g, images[rows], m["n_blocks"], m["n_bins"],
                              m["load"], m["crop"], device, q=lowp.fp8)
        bad = rf.clone()
        bad[[0, 1]] = rf[[1, 0]]
        for name, (c, x) in (("control", (lowp.fp8(rc), qf)),
                             ("altered", (rc, bad))):
            crop[name] = max(crop[name], float((c - rc).abs().max()))
            per[name].extend((x - rf).abs().mean(dim=(2, 3, 4)).flatten()
                             .tolist())
    out = {k: _judged(cell, checks.grid_numbers(crop[k], per[k]))
           for k in crop}
    del g
    torch.cuda.empty_cache() if device.type == "cuda" else None
    return out


def program_readings(cell, seed: int, device) -> dict:
    """The program's run of ``seed`` up to its window, compared as a run
    compares it."""
    from portbench.harness import report, train_cell
    run = train_cell.program_run(cell, seed, 0.0, False, time.time(),
                                 device.type)
    return {"program": _judged(cell, *report._check_train(cell, seed, [run],
                                                          device))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    import torch
    from portbench.harness.spec import find_cell
    cell = find_cell(a.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda")
    if a.program and (cell.traffic["kind"] != "train" or cell.chips != 1):
        print("control: --program reads training cells on one card",
              file=sys.stderr)
        return 2
    run = (program_readings if a.program
           else train_control if cell.traffic["kind"] == "train"
           else grid_control)
    res = {"workload": a.workload,
           "device": torch.cuda.get_device_name(0), "seeds": {}}
    for s in (int(x) for x in a.seeds.split(",")):
        t = time.time()
        res["seeds"][s] = run(cell, s, device)
        res["seeds"][s]["seconds"] = time.time() - t
        print(json.dumps({s: res["seeds"][s]}), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
