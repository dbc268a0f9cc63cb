"""The training cells: the per-step body of the port's training loop
(``pcgan_tpu_torch.train_main._train_gan``) driven over a measured window.

Set-up builds what ``_train_gan`` builds, from the benchmark's inputs:
the mesh (one process, or one rank of a data-parallel cohort), the
configuration's models with seeded weights, the frozen comparator and its
anchors, the train state, the data-parallel step with B1's preprocessing,
and the port's ``Loader`` (shuffled, sharded by rank) over the canvases,
fed through ``_epoch_batches`` (bins attached, the ``--prefetch`` thread).
The first steps are the loop's own steps on the first rows, read for the
comparison (their losses, the first gradient from Adam's moments, the
parameters' first update and their change); a few more warm the step.
Then the window: each step takes the loop's next batch, uploads it with
``_to_device``, calls the step, and every ``print_freq`` steps fetches
the metrics, as the loop does. A single process stops after
``--seconds``; a cohort runs the step count its ranks agreed on in set-up
(the time they take for ``--seconds``), so every rank issues the same
collectives. The rate is images over the
window's wall time, which ends when the device has finished.

With ``--trace 1`` the window is followed by a traced stretch of steps
under ``torch.profiler`` for the per-layer metrics.
"""

from __future__ import annotations

import math
import sys
import tempfile
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import canvases, trace, weights
from portbench.harness.checks import slice_norms


def _argv(cell, seed: int, world: int, device: str, run_dir: str,
          extra=()) -> List[str]:
    t = cell.traffic
    return (list(cell.config["argv"])
            + ["--dataset_mode", "synthetic", "--name", "portbench",
               "--checkpoints_dir", run_dir, "--seed", str(seed),
               "--batch_size", str(t["batch_per_rank"] * world),
               "--mesh_shape", "-1" if world > 1 else "1",
               "--device", device] + list(extra))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_sizes(cfg, m: Dict, keys=None) -> None:
    """The program's configuration must be the one the reference models
    (on ``keys``, default every size the reference reads)."""
    got = {"ngf": cfg.model.ngf, "ndf": cfg.model.ndf,
           "n_bins": cfg.data.n_age_bins, "load": cfg.data.load_size,
           "crop": cfg.data.crop_size, "n_layers_D": cfg.model.n_layers_D,
           "cmp_nf": cfg.model.cmp_nf, "cmp_n_down": cfg.model.cmp_n_down,
           "pool": cfg.train.pool_size, "lambda_L1": cfg.train.lambda_L1,
           "lambda_cond": cfg.train.lambda_cond, "lr": cfg.train.lr,
           "beta1": cfg.train.beta1, "beta2": cfg.train.beta2,
           "dtype": cfg.model.dtype,
           "n_blocks": int(cfg.model.netG.split("_")[1].rstrip("blocks"))}
    bad = {k: (v, m[k]) for k, v in got.items()
           if k in m and (keys is None or k in keys) and v != m[k]}
    if bad:
        raise SystemExit(f"portbench: the program's configuration differs "
                         f"from the reference's (program, reference): {bad}")


def program_run(cell, seed: int, seconds: float, traced: bool, t_start: float,
                device_name: str = "cuda", extra=(),
                patch=None) -> Dict:
    """One process's (one rank's) run. Returns its readings and numbers;
    the fed rows of the first steps are under 'fed'. ``patch(ns)`` may
    replace the step's maker in ``ns`` before set-up (the fault tests)."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.parallel.mesh import mesh_from_config
    from pcgan_tpu_torch.parallel.train_parallel import \
        make_parallel_train_step

    ns = {"make_parallel_train_step": make_parallel_train_step}
    if patch is not None:
        patch(ns)
    world = int(cell.traffic.get("ranks", 1))
    with tempfile.TemporaryDirectory(prefix="portbench_") as run_dir:
        cfg = parse_config(_argv(cell, seed, world, device_name, run_dir,
                                 extra), is_train=True)
        _check_sizes(cfg, cell.config["model"])
        mesh = mesh_from_config(cfg)
        _Phases(t_start, mesh.rank)("imports and mesh")
        try:
            return _run(cell, cfg, mesh, seed, seconds, traced, t_start, ns)
        finally:
            mesh.close()


def _run(cell, cfg, mesh, seed, seconds, traced, t_start, ns) -> Dict:
    from pcgan_tpu_torch.data.loader import make_process_loader
    from pcgan_tpu_torch.models import define_C, define_D, define_G
    from pcgan_tpu_torch.parallel.mesh import rank_seed
    from pcgan_tpu_torch.parallel.train_parallel import (pool_for_mesh,
                                                         shard_train_state)
    from pcgan_tpu_torch.train import create_train_state
    from pcgan_tpu_torch.train_main import _epoch_batches, _to_device

    m, tr = cell.config["model"], cell.traffic
    device = mesh.device
    world, rank = mesh.world, mesh.rank
    phase = _Phases(t_start, rank)
    images, ages = canvases.make_canvases(tr["data_rows"], m["native"],
                                          seed, device)
    ds = canvases.CanvasSet(images, ages)
    phase("canvases")
    ld = make_process_loader(cfg, ds, shuffle=True, seed=cfg.train.seed,
                             mesh=mesh)
    cfg = pool_for_mesh(cfg, mesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        G = define_G(cfg).to(device)
    D = define_D(cfg).to(device)
    w = weights.draw(m, seed, device)
    weights.load(G, w["G"])
    weights.load(D, w["D"])
    C = anchors = None
    if m.get("comparator"):
        C = define_C(cfg).to(device)
        weights.load(C, w["C"])
        lo, hi = weights.anchors(seed, m["n_bins"])
        anchors = (lo.numpy(), hi.numpy(), None)
    del w
    phase("models")
    state = create_train_state(
        cfg, G, D, torch.Generator().manual_seed(
            rank_seed(cfg.train.seed + 2, mesh.data_rank)),
        max(1, len(ld)), C=C, bin_anchors=anchors)
    state = shard_train_state(state, mesh)
    step_fn = ns["make_parallel_train_step"](cfg, G, D, state.C, mesh)

    def feed():
        while True:
            yield from _epoch_batches(cfg, ld)

    batches = feed()
    named = {"G": list(G.named_parameters()), "D": list(D.named_parameters())}
    start = {net: [p.detach().clone() for _, p in ps]
             for net, ps in named.items()}
    print_freq = cfg.train.print_freq
    gstep = 0
    failed = 0

    def fetch(metrics) -> Dict[str, float]:
        nonlocal failed
        host = dict(zip(metrics, torch.stack(
            list(metrics.values())).cpu().tolist()))
        if not all(math.isfinite(v) for v in host.values()):
            failed += 1
        return host

    def one_step(spans=None):
        nonlocal gstep
        t0 = time.perf_counter()
        raw = next(batches)
        batch = {"image": _to_device(raw["image"], device),
                 "bin": _to_device(raw["bin"], device)}
        t1 = time.perf_counter()
        metrics = step_fn(state, batch)
        t2 = time.perf_counter()
        gstep += 1
        if gstep % print_freq == 0:
            fetch(metrics)
        if spans is not None:
            spans["data_wait"] += t1 - t0
            spans["dispatch"] += t2 - t1
        return raw, metrics

    # ---- the comparison's steps: the loop's own first steps ---------------
    fed, losses = [], []
    grad_norms = None
    for k in range(tr["check_steps"]):
        raw, metrics = one_step()
        fed.append({"image": np.array(raw["image"]),
                    "age": np.array(raw["age"]),
                    "bin": np.array(raw["bin"])})
        host = fetch(metrics)
        losses.append({"loss_G": host["loss_G"], "loss_D": host["loss_D"]})
        if k == 0:
            grad_norms = {
                "G": _moment_norms(state.opt_g, named["G"], cfg.train.beta1),
                "D": _moment_norms(state.opt_d, named["D"], cfg.train.beta1)}
            first_update = _changes(named, start)
    change = _changes(named, start)
    change_norms = {net: {n: slice_norms(d) for n, d in ds.items()}
                    for net, ds in change.items()}
    del start
    phase("first steps")
    # ---- warm-up, then the window -----------------------------------------
    _sync(device)
    tw = time.perf_counter()
    for _ in range(tr["warm_steps"]):
        one_step()
    _sync(device)
    n_window = None
    if world > 1:
        # the cohort agrees on a step count that fills --seconds
        per = (time.perf_counter() - tw) / max(1, tr["warm_steps"])
        n = torch.tensor([max(1, int(seconds / per))], device=device)
        torch.distributed.all_reduce(n, torch.distributed.ReduceOp.MIN)
        n_window = int(n)
    phase("warm-up")
    setup_s = time.time() - t_start
    spans = {"data_wait": 0.0, "dispatch": 0.0}
    steps = 0
    t0 = time.perf_counter()
    while (steps < n_window) if n_window else (
            time.perf_counter() - t0 < seconds):
        one_step(spans)
        steps += 1
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out = {"rank": rank, "world": world, "steps": steps,
           "images": steps * tr["batch_per_rank"], "window_s": window_s,
           "setup_s": setup_s, "peak_bytes": int(peak), "failed": failed,
           "dispatch_ms": 1e3 * spans["dispatch"] / max(1, steps),
           "data_wait_ms": 1e3 * spans["data_wait"] / max(1, steps),
           "losses": losses, "grad_norms": grad_norms,
           "change_norms": change_norms, "first_update": first_update,
           "change": change, "fed": fed, "trace": None}
    if traced:
        out["trace"], out["traced_steps"] = _traced(
            one_step, tr["trace_steps"], device)
    batches.close()
    del state, step_fn, G, D, C
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


class _Phases:
    """Prints each set-up phase's end, in seconds since the process
    started, to standard error."""

    def __init__(self, t_start: float, rank: int = 0):
        self.t0, self.rank = t_start, rank

    def __call__(self, name: str) -> None:
        print(f"set-up rank {self.rank}: {name} done at "
              f"{time.time() - self.t0:.2f} s", file=sys.stderr, flush=True)


def _traced(one_step, n: int, device):
    """``n`` more steps (or calls) under the profiler: (trace, n)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        for _ in range(n):
            one_step()
        _sync(device)
    return trace.reduce(prof), n


def _changes(named, start) -> Dict[str, Dict[str, torch.Tensor]]:
    """Each parameter's change since ``start``, on the host, one tensor
    at a time (nothing held on the card)."""
    return {net: {n: (p.detach() - p0).cpu()
                  for (n, p), p0 in zip(ps, start[net])}
            for net, ps in named.items()}


def _moment_norms(opt, named, beta1: float) -> Dict[str, List[float]]:
    """The slice norms of the gradient Adam got at its first step:
    exp_avg / (1 - beta1) after one update."""
    out = {}
    for name, p in named:
        st = opt.state.get(p)
        out[name] = ([math.nan] if not st else
                     slice_norms(st["exp_avg"] / (1.0 - beta1)))
    return out
