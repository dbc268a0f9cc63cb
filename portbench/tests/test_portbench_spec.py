"""A later change adds a cell, a configuration, a traffic mix and a
per-layer metric as files and entries only: the harness finds them by
name."""

import json
import os
import shutil

from portbench.harness import spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)


def test_dropped_in_files_are_found(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    pb = tmp_path / "portbench"
    cfg = json.load(open(pb / "configs" / "pcgan_utk128.json"))
    cfg["name"] = "pcgan_utk64"
    cfg["model"]["crop"] = 64
    (pb / "configs" / "pcgan_utk64.json").write_text(json.dumps(cfg))
    traffic = json.load(open(pb / "traffic" / "train_b32.json"))
    traffic["batch_per_rank"] = 8
    (pb / "traffic" / "train_b8.json").write_text(json.dumps(traffic))
    (pb / "limits" / "train_utk64_b8.json").write_text(
        json.dumps({"limits": {"loss_gap": 1.0}}))
    (pb / "metrics" / "steps_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    bench["configs"].append({"name": "pcgan_utk64", "source": "x",
                             "file": "portbench/configs/pcgan_utk64.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "train_utk64_b8",
                               "config": "pcgan_utk64", "traffic": "train_b8",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "training loop",
                               "moves": "train_imgs_per_s",
                               "workloads": ["train_utk64_b8"]})
    next(m for m in bench["end_to_end"]
         if m["name"] == "train_imgs_per_s")["workloads"].append(
        "train_utk64_b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("train_utk64_b8", repo=str(tmp_path))
    assert cell.config["model"]["crop"] == 64
    assert cell.traffic["batch_per_rank"] == 8
    assert cell.limits == {"loss_gap": 1.0}
    assert {m["name"] for m in cell.end_to_end} == {
        "train_imgs_per_s", "peak_mem_gib", "setup_s"}
    assert cell.readers["steps_seen.train"]({"steps": 7}) == 7.0
    # the cells already there keep their own metrics
    old = spec.find_cell("train_utk128", repo=str(tmp_path))
    assert "steps_seen.train" not in old.readers
