"""The aging-grid cell: ``pcgan_tpu_torch.test``'s per-batch path as a
closed loop with one caller, without the PNG writing.

Set-up builds the configuration's G with seeded weights in eval mode, the
port's unshuffled ``Loader`` over the canvases, B1's centre crop
(``make_preprocess(train=False)``) and ``make_sampler``. Each call takes
the loader's next batch of faces and, as ``test.main`` does, uploads it,
crops it, renders every face at every age bin and copies the crops and
the images back to the host; its latency runs from the batch's hand-off
to the images on the host. The window runs calls for ``--seconds``.
Calls drawn from the seed keep their outputs for the comparison.
"""

from __future__ import annotations

import tempfile
import time
import warnings
from typing import Dict

import numpy as np
import torch

from portbench.harness import canvases, weights
from portbench.harness.train_cell import (_check_sizes, _Phases, _sync,
                                          _traced)


def program_run(cell, seed: int, seconds: float, traced: bool,
                t_start: float, device_name: str = "cuda", extra=(),
                patch=None) -> Dict:
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.data.loader import Loader, with_bins
    from pcgan_tpu_torch.device import resolve_device
    from pcgan_tpu_torch.models import define_G
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    from pcgan_tpu_torch.sample import make_sampler

    m, tr = cell.config["model"], cell.traffic
    faces = tr["faces_per_call"]
    with tempfile.TemporaryDirectory(prefix="portbench_") as run_dir:
        cfg = parse_config(
            list(cell.config["grid_argv"])
            + ["--dataset_mode", "synthetic", "--name", "portbench",
               "--checkpoints_dir", run_dir, "--results_dir", run_dir,
               "--batch_size", str(faces), "--seed", str(seed),
               "--device", device_name] + list(extra), is_train=False)
    _check_sizes(cfg, m, ("ngf", "n_bins", "load", "crop", "dtype",
                          "n_blocks"))
    device = resolve_device(cfg.run.device)
    phase = _Phases(t_start)
    phase("imports")
    images, ages = canvases.make_canvases(tr["data_rows"], m["native"], seed,
                                          device)
    phase("canvases")
    ld = Loader(canvases.CanvasSet(images, ages), faces, shuffle=False,
                drop_last=False, num_threads=cfg.data.num_threads)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        G = define_G(cfg).to(device).eval()
    weights.load(G, weights.draw(m, seed, device, nets=("G",))["G"])
    pre = make_preprocess(cfg, train=False)
    sampler = make_sampler(cfg, G)
    ns = {"sampler": sampler}
    if patch is not None:
        patch(ns)
    sampler = ns["sampler"]
    phase("generator")

    def feed():
        while True:
            yield from with_bins(iter(ld), cfg.data.n_age_bins,
                                 cfg.data.max_age)

    calls = feed()
    per_epoch = -(-len(images) // faces)
    keep_draw = np.random.default_rng(seed).random(1 << 20)
    kept = {}
    count = 0
    data_s = 0.0

    def one_call():
        nonlocal count, data_s
        t = time.perf_counter()
        raw = next(calls)
        t0 = time.perf_counter()
        x = torch.from_numpy(raw["image"]).to(device)
        batch = pre(None, {"image": x})
        imgs = batch["image"].float()
        fakes = sampler(imgs).cpu().numpy()
        crops = imgs.cpu().numpy()
        t1 = time.perf_counter()
        data_s += t0 - t
        k = count
        count += 1
        return k, t1 - t0, crops, fakes

    for _ in range(tr["warm_calls"]):
        one_call()
    _sync(device)
    phase("warm-up")
    setup_s = time.time() - t_start
    lat = []
    data_s = 0.0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        k, dt, crops, fakes = one_call()
        lat.append(dt)
        if (keep_draw[k % keep_draw.size] < tr["check_share"]
                and len(kept) < tr["check_max"]):
            kept[k] = (crops, fakes)
    window_s = time.perf_counter() - t0
    if not kept:                      # a window too short to draw one
        kept[k] = (crops, fakes)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    n = len(lat)
    out = {"rank": 0, "world": 1, "calls": n, "faces": n * faces,
           "window_s": window_s, "setup_s": setup_s, "peak_bytes": int(peak),
           "latencies": lat, "data_ms": 1e3 * data_s / max(1, n),
           "kept": {k: (v, _rows(k, per_epoch, faces, len(images)))
                    for k, v in kept.items()},
           "canvases": (images, ages), "failed": 0, "trace": None}
    if traced:
        out["trace"], out["traced_steps"] = _traced(
            one_call, tr["trace_calls"], device)
    calls.close()
    del G, sampler
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _rows(k: int, per_epoch: int, faces: int, n: int) -> np.ndarray:
    """The canvases the k-th call of an unshuffled loader served."""
    lo = (k % per_epoch) * faces
    return np.arange(lo, min(n, lo + faces))
