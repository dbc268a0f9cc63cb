"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds (widths
8, resnet_6blocks, 32 px crops of 40 px canvases, batch 4), for the
benchmark's CPU tests; ``dtype`` float32 unless asked.

``PARKED`` holds the cells kept out of ``BENCHMARK.json`` until their
runs on the card spread less (``PERF.md``, open questions): their traffic
and limits files and their runners stay, and their CPU tests run them."""

import copy

from portbench.harness.spec import find_cell, load_benchmark

SEED = 2 ** 31 + 12345
PARKED = [
    {"name": "grid_utk128", "config": "pcgan_utk128", "traffic": "grid_b8",
     "chips": 1},
    {"name": "train_utk128_dp4", "config": "pcgan_utk128",
     "traffic": "train_b32_dp4", "chips": 4},
]


def find_any(name: str):
    """The cell ``name`` of ``BENCHMARK.json`` or of ``PARKED``."""
    bench = load_benchmark()
    bench["workloads"] = bench["workloads"] + PARKED
    return find_cell(name, bench=bench)


def tiny(name: str, dtype: str = "float32"):
    """(cell, extra argv) of ``name`` at the tiny size."""
    cell = find_any(name)
    cfg = copy.deepcopy(cell.config)
    m = cfg["model"]
    m.update(ngf=8, ndf=8, n_blocks=6, native=40, load=36, crop=32, pool=8,
             dtype=dtype, ref_rows=4)
    if m.get("comparator"):
        m.update(cmp_nf=8, cmp_n_down=3)
    cell.config = cfg
    t = dict(cell.traffic)
    if t["kind"] == "train":
        t.update(batch_per_rank=4, data_rows=64, trace_steps=2)
    else:
        t.update(data_rows=32, check_share=0.5, check_max=2, trace_calls=2)
    cell.traffic = t
    extra = ["--ngf", "8", "--ndf", "8", "--netG", "resnet_6blocks",
             "--load_size", "36", "--crop_size", "32", "--dtype", dtype,
             "--num_threads", "1"]
    if t["kind"] == "train":
        extra += ["--pool_size", "8"]
        if m.get("comparator"):
            extra += ["--cmp_nf", "8", "--cmp_n_down", "3"]
    return cell, extra
