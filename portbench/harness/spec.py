"""Finding a cell's pieces by name.

``BENCHMARK.json`` (at the repository root) names each cell's
configuration and traffic mix. The harness reads:

- the configuration from the file its ``configs`` entry names;
- the traffic mix from ``traffic/<traffic>.json``;
- the cell's correctness limits from ``limits/<cell>.json``;
- each per-layer metric's reader from ``metrics/<quantity>.py``, the
  quantity being the metric's name up to its first dot (a ``read(ctx)``
  function returning a number, or None when the run has nothing for it to
  read): ``dispatch_ms.train`` and ``dispatch_ms.256`` are one quantity,
  reported in cells that report different end-to-end metrics.

A cell reports the end-to-end metrics whose ``workloads`` list it, or that
have none, and the per-layer metrics whose ``workloads`` list it, or that
have none and move an end-to-end metric the cell reports. Adding a cell, a
configuration, a mix or a metric is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def load_benchmark(repo: str = REPO) -> Dict:
    with open(os.path.join(repo, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reader(path: str) -> Callable:
    name = "portbench_metric_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _listed(entry: Dict, cell: str) -> Optional[bool]:
    w = entry.get("workloads")
    return None if w is None else cell in w


def find_cell(workload: str, repo: str = REPO,
              bench: Optional[Dict] = None) -> Cell:
    bench = bench if bench is not None else load_benchmark(repo)
    here = os.path.join(repo, "portbench")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         f"BENCHMARK.json ({', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = _json(os.path.join(repo, entry["file"]))
    traffic = _json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    if traffic.get("ranks", 1) != w["chips"]:
        raise SystemExit(f"portbench: traffic {w['traffic']} runs "
                         f"{traffic.get('ranks', 1)} ranks, the cell asks "
                         f"for {w['chips']} chips")
    limits = _json(os.path.join(here, "limits", workload + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if _listed(m, workload) in (None, True)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _listed(m, workload)
             or (_listed(m, workload) is None and m["moves"] in names)]
    cell = Cell(workload, int(w["chips"]), config, traffic,
                limits["limits"], e2e, layer)
    for m in layer:
        cell.readers[m["name"]] = _reader(os.path.join(
            here, "metrics", m["name"].split(".")[0] + ".py"))
    return cell
