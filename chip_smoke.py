#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``pcgan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

1. device: the card's name and power limit from nvidia-smi;
2. build: compile every CUDA kernel of the port from ``pcgan_tpu_torch/csrc``
   (one nvcc per source, started together);
3. B1 kernel check: the preprocessing kernel against its plain PyTorch
   version on the card (TF32 off) at the main path's shape and at a ragged
   and an identity shape, in f32 and bf16 output, then timed beside its
   plain version, one library yardstick and its bound;
4. sampling path: ``pcgan_tpu_torch.test.main`` end to end (synthetic
   data, resnet_9blocks at full width, 128 px, 10 bins, bf16), with launch
   counts read around each run, the written grid checked, the grid rate
   after warm-up, and one more run under torch.profiler (device time per
   batch by kernel, the device's busy share of the batch windows);
5. sampling parity: the same seeded G in f32 on the card against the CPU;
6. B2 kernel check: the weight-gradient kernel against its plain version at
   the G tail's shape (bf16 and f32), a ragged and a C_out 8 shape, timed
   in turns beside its plain version and cuDNN's weight-gradient conv;
7. path 2: ``pcgan_tpu_torch.tools.bench_lowch.main`` (tail and stem, bf16)
   with B2's launches read around it, and the routed VJP held against the
   direct one;
8. path 1: ``pcgan_tpu_torch.train_main.main`` at the default GAN's full
   width in bf16 for 3 epochs of 8 steps, its outputs and a
   ``--continue_train`` resume checked, steps/s after the first epoch, and
   a fresh 2 x 4-step run under torch.profiler;
9. training parity: one f32 step of a small config on the card against the
   CPU from the same seeded weights.

The last three lines of standard output are the card line, one JSON line of
kernels and ``{"ok": true, "device": {...}}``. Needs one CUDA card; exits
non-zero without printing a result when there is none, or when run outside
a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): f32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# main path: the sampler's input batch (test.py, --batch_size 8) of 200 px
# synthetic canvases, resized to --load_size 143 and center-cropped to 128
MAIN_B, NATIVE, LOAD, CROP, C = 8, 200, 143, 128, 3
NETG, NGF, NB = "resnet_9blocks", 64, 10
DEV = "cuda"
F32_TOL = 2e-5        # kernel vs plain, f32 output: summation order only
PARITY_TOL = 1e-4     # f32 G on the card vs the CPU (the golden grid's atol)
INPUT_SPREAD_F32 = 1e-4      # input injection: columns agree to f32 noise
BOTTLENECK_SPREAD_F32 = 1e-3  # bottleneck injection: columns really differ
# B2 vs its plain version: both sum f32 products, in another order; the
# first card runs measured ~1e-6 of the largest entry
B2_REL_TOL = 1e-5
# routed vs direct conv VJP in bf16: both round to bf16 (8 mantissa bits)
# after different f32 sums; the reflect-pad transpose adds up to 4 bf16
# values at the borders
BF16_REL_TOL = 3e-2
# the default GAN's G tail: 2B = 16 images at 128 px, 64 -> 3, 7x7
TAIL = (16, CROP + 6, CROP + 6, 64, 3, 7)
TRAIN_STEP_TOL = 1e-4        # f32 step losses, card vs CPU
LR = 2e-4


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """Spacing of bf16 at |v|, magnitudes below 2^-7 counted as 2^-7 (values
    that cancel to ~0 are then held to 6e-5, above the f32 noise)."""
    a = np.maximum(np.abs(v.astype(np.float32)), 2.0 ** -7)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit PNG written by the port's encoder (filter 0 rows)."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    check(bool((rows[:, 0] == 0).all()), f"{path}: unexpected PNG filter")
    return rows[:, 1:].reshape(h, w, -1)


def cuda_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean ms per call over back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def phase_device(torch) -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    card = r.stdout.strip().splitlines()[0]
    say(f"device: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} visible")
    print(card, flush=True)
    return card


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor
    from pcgan_tpu_torch.ops import _build, cuda_preprocess, cuda_wgrad
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:      # one nvcc each, together
        for f in [pool.submit(m.build) for m in (cuda_preprocess,
                                                 cuda_wgrad)]:
            f.result()
    say(f"build (B1 + B2): {time.perf_counter() - t0:.2f} s")
    for log in sorted(os.listdir(_build.BUILD_DIR)):
        if log.endswith(".log"):
            with open(os.path.join(_build.BUILD_DIR, log)) as f:
                for line in f:
                    if re.search(r"registers|spill|smem", line):
                        say(f"ptxas: {line.strip()}")


def _preprocess_case(torch, rng, b, native, load, crop):
    dev = torch.device(DEV)
    imgs = torch.from_numpy(rng.integers(0, 256, (b, native, native, C),
                                         dtype=np.uint8)).to(dev)
    span = load - crop
    cy = torch.from_numpy(rng.integers(0, span + 1, b).astype(np.int32)).to(dev)
    cx = torch.from_numpy(rng.integers(0, span + 1, b).astype(np.int32)).to(dev)
    fl = torch.from_numpy(rng.integers(0, 2, b).astype(np.int32)).to(dev)
    return imgs, cy, cx, fl


def phase_kernel_check(torch) -> dict:
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.ops.preprocess import (crop_rows, preprocess_batch,
                                                resize_matrix)
    rng = np.random.default_rng(0)
    cases = {"main": (MAIN_B, NATIVE, LOAD, CROP),
             "ragged": (4, 50, 43, 32),
             "identity": (2, CROP, CROP, CROP)}
    err_f32, ulps_bf16 = 0.0, 0.0
    for name, (b, native, load, crop) in cases.items():
        imgs, cy, cx, fl = _preprocess_case(torch, rng, b, native, load, crop)
        for dt in (torch.float32, torch.bfloat16):
            got = cp.preprocess_batch_cuda(imgs, cy, cx, fl, load, crop,
                                           out_dtype=dt)
            want = preprocess_batch(imgs, cy, cx, fl.bool(), load, crop,
                                    out_dtype=dt)
            torch.cuda.synchronize()
            check(got.shape == (b, crop, crop, C) and got.dtype == dt,
                  f"kernel {name}: {tuple(got.shape)} {got.dtype}")
            g = got.float().cpu().numpy()
            w = want.float().cpu().numpy()
            check(bool(np.isfinite(g).all()), f"kernel {name}: non-finite")
            err = float(np.abs(g - w).max())
            if dt == torch.float32:
                err_f32 = max(err_f32, err)
                check(err <= F32_TOL, f"kernel {name} f32: max abs err {err}"
                      f" > {F32_TOL}")
            else:
                ulps = float((np.abs(g - w) / bf16_ulp(w)).max())
                ulps_bf16 = max(ulps_bf16, ulps)
                check(ulps <= 1.0, f"kernel {name} bf16: {ulps} ulp > 1")
            say(f"kernel {name} {str(dt)[6:]}: max abs err {err:.3g}")

    # timing at the main path's shape and output dtype (bf16)
    imgs, cy, cx, fl = _preprocess_case(torch, rng, MAIN_B, NATIVE, LOAD, CROP)
    flb = fl.bool()
    bf16 = torch.bfloat16
    ms_pairs = {"ms": [], "plain_ms": []}
    for key in ("plain_ms", "ms", "ms", "plain_ms"):      # in turns
        fn = ((lambda: cp.preprocess_batch_cuda(imgs, cy, cx, fl, LOAD, CROP,
                                                out_dtype=bf16))
              if key == "ms" else
              (lambda: preprocess_batch(imgs, cy, cx, flb, LOAD, CROP,
                                        out_dtype=bf16)))
        ms_pairs[key].append(cuda_ms(torch, fn))
    # library yardstick (timed only, never called by the port): the same two
    # contractions as two batched f32 products, TF32 off, inputs pre-gathered
    mh = torch.from_numpy(resize_matrix(NATIVE, LOAD)).to(DEV)
    mw = mh
    ys, xs = crop_rows(cy, cx, flb, LOAD, CROP)
    mh_b, mw_b = mh[ys], mw[xs]
    xf = imgs.float()

    def library():
        t = torch.matmul(mh_b, xf.view(MAIN_B, NATIVE, NATIVE * C))
        return torch.einsum("bpw,bowc->bopc", mw_b,
                            t.view(MAIN_B, CROP, NATIVE, C))
    library_ms = cuda_ms(torch, library)
    # bound: what this run's inputs need. Each row of Mh/Mw is non-zero only
    # over the filter's support, so the work is the band of the rows the
    # crops read, not the dense products the kernel's body does.
    nz = (mh != 0).sum(1)
    flops = 2 * C * (NATIVE * int(nz[ys].sum()) + CROP * int(nz[xs].sum()))
    dense_flops = 2 * MAIN_B * C * (CROP * NATIVE * NATIVE
                                    + CROP * NATIVE * CROP)
    band_bytes = 4 * (int(nz[ys.unique()].sum()) + int(nz[xs.unique()].sum()))
    nbytes = (imgs.numel() + band_bytes + 3 * MAIN_B * 4
              + MAIN_B * CROP * CROP * C * 2)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    out = {"name": "preprocess", "route": "cuda",
           "source": "pcgan_tpu_torch/csrc/preprocess.cu",
           "replaces": "pcgan_tpu/ops/pallas_preprocess.py:104",
           "max_abs_err": err_f32, "max_ulp_bf16": ulps_bf16,
           "ms": min(ms_pairs["ms"]), "kernel_ms": min(ms_pairs["ms"]),
           "plain_ms": min(ms_pairs["plain_ms"]), "library_ms": library_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes, "kernel_dense_flops": dense_flops,
           "shape": f"B{MAIN_B} {NATIVE}->{LOAD}->{CROP} C{C} u8->bf16",
           "timings_in_turns_ms": ms_pairs}
    say(f"kernel timing: {json.dumps(out)}")
    return out


def _argv(tmp, name, inject, num_test=16):
    return ["--dataset_mode", "synthetic", "--max_dataset_size", str(num_test),
            "--num_test", str(num_test), "--batch_size", "8",
            "--netG", NETG, "--ngf", str(NGF), "--crop_size", str(CROP),
            "--load_size", str(LOAD), "--n_age_bins", str(NB),
            "--dtype", "bfloat16",
            "--cond_inject", inject, "--name", name,
            "--checkpoints_dir", os.path.join(tmp, "ck"),
            "--results_dir", os.path.join(tmp, "res")]


def _seeded_G(torch, argv, seed=0):
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_G
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return define_G(parse_config(argv, is_train=False),
                        torch.Generator().manual_seed(seed))


def _main_run(torch, argv):
    """One run of the main path with the launch count zeroed just before and
    read just after."""
    from pcgan_tpu_torch import test as port_test
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    cp.launches = cw.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = port_test.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(cw.launches == 0, f"sampling path: {cw.launches} B2 launches")
    return res, cp.launches, wall


def _check_grid(torch, argv, res, inject):
    """Rows and PNGs on disk; the grid recomputed on the same inputs agrees
    with the PNGs within 1 u8 LSB; column spread vs image spread."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.data.loader import create_dataset
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    from pcgan_tpu_torch.sample import make_sampler
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    from pcgan_tpu_torch.utils.visualizer import tensor_to_u8
    cfg = parse_config(argv, is_train=False)
    web = res["web_dir"]
    with open(os.path.join(web, "index.html")) as f:
        html = f.read()
    rows = html.count("<h3>")
    check(rows == cfg.run.num_test == res["done"],
          f"{inject}: {rows} index.html rows, want {cfg.run.num_test}")
    pngs = [n for n in os.listdir(os.path.join(web, "images"))
            if n.endswith(".png")]
    check(len(pngs) == rows * (1 + cfg.data.n_age_bins),
          f"{inject}: {len(pngs)} PNGs for {rows} rows")

    G = _seeded_G(torch, argv)
    ckpt.restore_generator(G, cfg.run.checkpoints_dir, cfg.run.name)
    G = G.to(DEV).eval()
    ds = create_dataset(cfg, train=False)
    raw = torch.from_numpy(np.stack([ds.get_raw(i)["image"]
                                     for i in range(8)])).to(DEV)
    imgs = make_preprocess(cfg, train=False)(None, {"image": raw})["image"]
    imgs = imgs.float()
    fakes = make_sampler(cfg, G)(imgs).cpu().numpy()       # (8, 10, H, W, C)
    check(fakes.shape == (8, NB, CROP, CROP, C), f"grid {fakes.shape}")
    check(bool(np.isfinite(fakes).all()), f"{inject}: non-finite grid")
    png_in = read_png(os.path.join(web, "images", "0000_input.png"))
    check(np.array_equal(png_in, tensor_to_u8(imgs[0].cpu().numpy())),
          f"{inject}: input PNG differs from the preprocessed image")
    labels = sorted(n for n in pngs if n.startswith("0000_age_"))
    for b, n in enumerate(labels):
        d = np.abs(read_png(os.path.join(web, "images", n)).astype(int)
                   - tensor_to_u8(fakes[0, b]).astype(int)).max()
        check(d <= 1, f"{inject}: {n} differs by {d} LSB from the grid")
    col = np.abs(fakes - fakes[:, :1])
    img = np.abs(fakes - fakes[:1])
    stats = {"column_spread_max": float(col.max()),
             "column_spread_mean": float(col.mean()),
             "image_spread_mean": float(img.mean())}
    say(f"{inject} grid (bf16): {stats}")
    if inject == "bottleneck":
        # the columns differ by more than one u8 step of the written PNGs
        check(stats["column_spread_max"] > 2 / 255,
              f"bottleneck: grid columns do not differ {stats}")
    else:
        # the condition is cancelled by the stem's instance norm: columns
        # agree up to bf16 noise, far below the difference between images
        check(stats["column_spread_mean"] <= 0.1 * stats["image_spread_mean"],
              f"input: grid columns differ beyond bf16 noise {stats}")
    return stats


def phase_main_path(torch, tmp) -> dict:
    from pcgan_tpu_torch.utils.checkpoint import save_generator
    out = {"launches_per_run": {}}
    for inject in ("input", "bottleneck"):
        argv = _argv(tmp, f"smoke_{inject}", inject)
        save_generator(_seeded_G(torch, argv), os.path.join(tmp, "ck"),
                       f"smoke_{inject}")
        res, launches, wall = _main_run(torch, argv)
        say(f"main path {inject}: {res['done']} grids in {wall:.2f} s, "
            f"preprocess kernel launches {launches}, batch s "
            f"{[round(s, 4) for s in res['batch_seconds']]}")
        check(launches == len(res["batch_seconds"]) == 2,
              f"{inject}: {launches} kernel launches for "
              f"{len(res['batch_seconds'])} batches")
        out["launches_per_run"][inject] = launches
        out[inject] = _check_grid(torch, argv, res, inject)

    # grid rate after warm-up: 8 batches of 8 inputs, the first is warm-up
    argv = _argv(tmp, "smoke_bottleneck", "bottleneck", num_test=64)
    res, launches, wall = _main_run(torch, argv)
    check(launches == len(res["batch_seconds"]) == 8,
          f"rate run: {launches} launches for {len(res['batch_seconds'])}")
    out["launches_per_run"]["rate"] = launches
    steady = res["batch_seconds"][1:]
    inputs_per_s = 8 * len(steady) / sum(steady)
    out["rate"] = {"inputs_per_s": inputs_per_s,
                   "grid_images_per_s": inputs_per_s * NB,
                   "batch_seconds": res["batch_seconds"],
                   "cli_wall_s": wall, "grids_written": res["done"]}
    say(f"grid rate after warm-up: {inputs_per_s:.1f} inputs/s = "
        f"{inputs_per_s * NB:.1f} generated images/s (8 x {NB} per batch, "
        f"bf16); CLI wall {wall:.2f} s for {res['done']} grids incl. PNGs")
    out["profile"] = _profile_run(torch, tmp)
    out["launches_per_run"]["profile"] = out["profile"]["launches"]
    out["launches"] = sum(out["launches_per_run"].values())
    return out


def _device_rows(torch, prof, n: int) -> list:
    """(device ms, launches, name) per kernel of a trace, per one of ``n``
    batches or steps, largest first. Ranges a region annotates on the
    device timeline (``Optimizer.step`` and the like) overlap the kernels
    inside them and are left out."""
    rows = []
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((us / 1e3 / n, e.count / n, e.key))
    return sorted(rows, reverse=True)


def _profile_run(torch, tmp, batches: int = 4) -> dict:
    """One more run of the main path under torch.profiler: device time per
    batch by kernel, and the device's busy share of the batch windows
    (host u8 batch -> preprocessing -> G forward -> grid on the host)."""
    from torch.profiler import ProfilerActivity, profile
    argv = _argv(tmp, "smoke_bottleneck", "bottleneck", num_test=8 * batches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res, launches, _ = _main_run(torch, argv)
    n = len(res["batch_seconds"])
    check(launches == n == batches,
          f"profile run: {launches} launches for {n} batches")
    rows = _device_rows(torch, prof, n)
    device_ms = sum(r[0] for r in rows)
    window_ms = sum(res["batch_seconds"]) * 1e3 / n
    check(device_ms > 0, "profile run: no device time traced")
    b1_ms = sum(r[0] for r in rows if "preprocess_kernel" in r[2])
    out = {"launches": launches, "device_ms_per_batch": device_ms,
           "preprocess_kernel_ms_per_batch": b1_ms,
           "window_ms_per_batch": window_ms,
           "device_busy_share": device_ms / window_ms,
           "device_launches_per_batch": sum(r[1] for r in rows),
           "top_kernels_ms_per_batch": [[round(ms, 4), cnt, name[:100]]
                                        for ms, cnt, name in rows[:15]]}
    say(f"profile (bf16, bottleneck, {n} batches of 8 x {NB} bins, every "
        f"batch traced): device {device_ms:.3f} ms of {window_ms:.3f} ms "
        f"window per batch, busy share {device_ms / window_ms:.3f}, "
        f"preprocessing kernel {b1_ms:.4f} ms")
    for ms, cnt, name in rows[:15]:
        say(f"  {ms:9.4f} ms/batch {cnt:6.1f} launches/batch  {name[:100]}")
    return out


def phase_card_parity(torch, tmp) -> dict:
    """f32 G on the card vs the CPU on 2 images; column spread per injection
    on the card."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.data.synthetic import SyntheticAgingDataset
    from pcgan_tpu_torch.ops.preprocess import preprocess_batch
    from pcgan_tpu_torch.sample import make_sampler
    ds = SyntheticAgingDataset(size=2)
    raw = torch.from_numpy(np.stack([ds.get_raw(i)["image"] for i in range(2)]))
    off = torch.full((2,), (LOAD - CROP) // 2)
    x = preprocess_batch(raw, off, off, torch.zeros(2, dtype=torch.bool),
                         LOAD, CROP)
    out = {}
    for inject in ("input", "bottleneck"):
        argv = _argv(tmp, "parity", inject)
        argv[argv.index("bfloat16")] = "float32"
        cfg = parse_config(argv, is_train=False)
        G = _seeded_G(torch, argv, seed=1).eval()
        card = make_sampler(cfg, G.to(DEV))(x.to(DEV)).cpu().numpy()
        spread = float(np.abs(card - card[:, :1]).max())
        out[f"{inject}_column_spread_max"] = spread
        if inject == "input":
            check(spread <= INPUT_SPREAD_F32,
                  f"f32 input: columns differ by {spread}")
            continue
        check(spread >= BOTTLENECK_SPREAD_F32,
              f"f32 bottleneck: columns agree ({spread})")
        t0 = time.perf_counter()
        cpu = make_sampler(cfg, G.cpu())(x).numpy()
        err = float(np.abs(card - cpu).max())
        out.update(max_abs_err=err, tol=PARITY_TOL,
                   cpu_seconds=time.perf_counter() - t0)
        check(bool(np.isfinite(card).all()), "f32 card grid non-finite")
        check(err <= PARITY_TOL, f"f32 card vs CPU: max abs err {err}")
        # how far the bf16 path (the main path's dtype) is from f32 on the
        # same weights: reported, the bf16 gate is the main path's own
        argv[argv.index("float32")] = "bfloat16"
        G16 = _seeded_G(torch, argv, seed=1).to(DEV).eval()
        bf16 = make_sampler(parse_config(argv, is_train=False), G16)(
            x.to(DEV)).cpu().numpy()
        out.update(bf16_vs_f32_max=float(np.abs(bf16 - card).max()),
                   bf16_vs_f32_mean=float(np.abs(bf16 - card).mean()))
    say(f"card parity (f32, TF32 off, 2 images x {NB} bins): {out}")
    return out


def _wgrad_case(torch, rng, b, hp, wp, cin, cout, k, dtype):
    x = torch.from_numpy(rng.standard_normal((b, hp, wp, cin)).astype(
        np.float32)).to(DEV, dtype)
    dy = torch.from_numpy(rng.standard_normal(
        (b, hp - k + 1, wp - k + 1, cout)).astype(np.float32)).to(DEV, dtype)
    return x, dy


def phase_wgrad_check(torch) -> dict:
    """B2 against its plain version; then timed in turns at the G tail's
    shape in bf16 (the training path's dtype) with its bound and cuDNN's
    weight-gradient conv as the library yardstick."""
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    rng = np.random.default_rng(1)
    cases = [("tail", TAIL, torch.bfloat16), ("tail", TAIL, torch.float32),
             ("ragged", (3, 37, 29, 24, 1, 3), torch.float32),
             ("cout8", (2, 40, 40, 16, 8, 7), torch.bfloat16)]
    worst = worst_abs = 0.0
    for name, (b, hp, wp, cin, cout, k), dt in cases:
        x, dy = _wgrad_case(torch, rng, b, hp, wp, cin, cout, k, dt)
        got = cw.wgrad_cuda(x, dy, k)
        again = cw.wgrad_cuda(x, dy, k)
        want = cw.wgrad_plain(x, dy, k)
        torch.cuda.synchronize()
        check(got.shape == (k, k, cin, cout) and got.dtype == torch.float32,
              f"wgrad {name}: {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"wgrad {name}: non-finite")
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        worst, worst_abs = max(worst, rel), max(worst_abs, err)
        check(rel <= B2_REL_TOL, f"wgrad {name} {dt}: max err {rel:.3g} of "
              f"max|plain| > {B2_REL_TOL}")
        check(bool(torch.equal(got, again)),
              f"wgrad {name}: two launches differ")
        say(f"wgrad {name} {str(dt)[6:]}: max err {rel:.3g} of max|plain|, "
            f"deterministic")

    b, hp, wp, cin, cout, k = TAIL
    x, dy = _wgrad_case(torch, rng, b, hp, wp, cin, cout, k, torch.bfloat16)
    ms = {"ms": [], "plain_ms": []}
    for key in ("plain_ms", "ms", "ms", "plain_ms"):          # in turns
        fn = ((lambda: cw.wgrad_cuda(x, dy, k)) if key == "ms"
              else (lambda: cw.wgrad_plain(x, dy, k)))
        ms[key].append(cuda_ms(torch, fn, iters=50 if key == "ms" else 10,
                               warmup=3))
    xn, dn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    library_ms = cuda_ms(torch, lambda: torch.nn.grad.conv2d_weight(
        xn, (cout, cin, k, k), dn), iters=50, warmup=3)
    h, w = hp - k + 1, wp - k + 1
    flops = 2 * k * k * cin * cout * b * h * w
    nbytes = 2 * (x.numel() + dy.numel()) + 4 * k * k * cin * cout
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    out = {"name": "wgrad", "route": "cuda",
           "source": "pcgan_tpu_torch/csrc/wgrad.cu",
           "replaces": "pcgan_tpu/ops/pallas_wgrad.py:82",
           "max_abs_err": worst_abs, "max_err_of_max_plain": worst,
           "ms": min(ms["ms"]), "plain_ms": min(ms["plain_ms"]),
           "library_ms": library_ms,
           "library": "torch.nn.grad.conv2d_weight (cuDNN), bf16",
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bound_peaks": "3.35 TB/s HBM3; 989 TFLOP/s bf16 tensor cores",
           "flops": flops, "bytes": nbytes,
           "f32_fma_floor_ms": flops / PEAK_F32_FLOPS * 1e3,
           "shape": f"x_pad {TAIL[:4]} bf16, dy C_out {cout}, k {k}",
           "timings_in_turns_ms": ms}
    say(f"wgrad timing: {json.dumps(out)}")
    return out


def phase_path2(torch) -> dict:
    """``bench_lowch.main`` in bf16 at 128 px, batch 16; B2 launches once
    per routed tail VJP and never for the stem. Then the routed VJP is held
    against the direct one on the same tensors (not counted)."""
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    from pcgan_tpu_torch.ops import lowch_conv as lc
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.tools import bench_lowch
    cp.launches = cw.launches = 0
    res = bench_lowch.main(["--size", str(CROP), "--batch", "16"])
    torch.cuda.synchronize()
    launches = cw.launches
    check(cp.launches == 0, f"path 2: {cp.launches} B1 launches")
    tail, stem = (res[n] for n in sorted(res, key=lambda n: not
                                         n.startswith("tail")))
    check(tail["wgrad_launches"] == tail["calls"]["routed f+vjp"] > 0,
          f"path 2: {tail['wgrad_launches']} B2 launches for "
          f"{tail['calls']['routed f+vjp']} routed tail VJPs")
    check(stem["wgrad_launches"] == 0,
          f"path 2: {stem['wgrad_launches']} B2 launches for the stem")
    check(launches == tail["wgrad_launches"],
          f"path 2: {launches} B2 launches in all")
    gen = torch.Generator().manual_seed(2)
    errs = {}
    for name, (cin, cout) in (("tail", (64, 3)), ("stem", (13, 64))):
        x = torch.randn((16, CROP, CROP, cin), generator=gen).to(
            DEV, torch.bfloat16).requires_grad_()
        w = (torch.randn((7, 7, cin, cout), generator=gen) * 0.05).to(
            DEV, torch.bfloat16).requires_grad_()
        dy = torch.randn((16, CROP, CROP, cout), generator=gen).to(
            DEV, torch.bfloat16)
        direct = torch.autograd.grad(
            lc.conv_valid_ref(lc.reflect_pad(x, 3), w), (x, w), dy)
        routed = torch.autograd.grad(lc.lowch_reflect_conv(x, w, 3), (x, w),
                                     dy)
        for gname, a, b in (("dx", direct[0], routed[0]),
                            ("dw", direct[1], routed[1])):
            check(bool(torch.isfinite(b).all()), f"{name} {gname} non-finite")
            rel = float((a.float() - b.float()).abs().max()) / float(
                a.float().abs().max())
            errs[f"{name}_{gname}"] = rel
            check(rel <= BF16_REL_TOL, f"path 2 {name} {gname}: routed vs "
                  f"direct {rel:.3g} of max > {BF16_REL_TOL}")
    out = {"launches": launches, "routed_vs_direct_rel": errs,
           "ms": {n: r["ms"] for n, r in res.items()}}
    say(f"path 2 (bench_lowch, bf16, 16 x {CROP} px): {json.dumps(out)}")
    return out


def _train_argv(tmp, name, niter, size=64, extra=()):
    return ["--dataset_mode", "synthetic", "--max_dataset_size", str(size),
            "--batch_size", "8", "--netG", NETG, "--ngf", str(NGF),
            "--netD", "basic", "--ndf", "64", "--n_layers_D", "3",
            "--norm", "instance", "--crop_size", str(CROP),
            "--load_size", str(LOAD), "--n_age_bins", str(NB),
            "--dtype", "bfloat16", "--gan_mode", "lsgan", "--lambda_L1",
            "100", "--pool_size", "50", "--lr_policy", "linear",
            "--niter", str(niter), "--niter_decay", "0",
            "--save_epoch_freq", "1", "--print_freq", "4",
            "--cond_inject", "bottleneck", "--name", name,
            "--checkpoints_dir", os.path.join(tmp, "train"), *extra]


def _train_run(torch, argv):
    """One run of path 1 with every launch count zeroed just before and
    read just after."""
    from pcgan_tpu_torch import train_main
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    cp.launches = cw.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = train_main.main(argv)
    torch.cuda.synchronize()
    return res, cp.launches, cw.launches, time.perf_counter() - t0


def phase_path1(torch, tmp) -> dict:
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    name = "smoke_train"
    argv = _train_argv(tmp, name, niter=3)
    res, b1, b2, wall = _train_run(torch, argv)
    steps = res["step"]
    check(steps == 24 and [e["steps"] for e in res["epochs"]] == [8, 8, 8],
          f"path 1: {steps} steps, epochs {res['epochs']}")
    check(b1 == steps, f"path 1: {b1} B1 launches for {steps} steps")
    run = os.path.join(tmp, "train", name)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    check([r["step"] for r in rows] == [4, 8, 12, 16, 20, 24],
          f"path 1: metrics rows at {[r['step'] for r in rows]}")
    for r in rows:
        for k in ("loss_G", "loss_G_GAN", "loss_G_L1", "loss_D",
                  "loss_D_real", "loss_D_fake"):
            check(bool(np.isfinite(r[k])), f"path 1: {k} {r[k]} at "
                  f"step {r['step']}")
    files = set(os.listdir(run))
    want = {"loss_curves.svg", "latest.pt", "latest_G.pt", "opt.json"} | {
        f"epoch_{e}{s}.pt" for e in (1, 2, 3) for s in ("", "_G")}
    check(want <= files, f"path 1: missing {sorted(want - files)}")
    # parameters moved from their seeded init
    cfg = parse_config(argv)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        g0 = define_G(cfg, torch.Generator().manual_seed(cfg.train.seed))
    d0 = define_D(cfg, torch.Generator().manual_seed(cfg.train.seed + 1))
    sd = torch.load(ckpt.state_path(os.path.join(tmp, "train"), name),
                    weights_only=True)
    for net, init in (("G", g0), ("D", d0)):
        moved = [k for k, v in init.state_dict().items()
                 if not torch.equal(v, sd[net][k])]
        check(len(moved) == len(init.state_dict()),
              f"path 1: {net} tensors that did not move: "
              f"{sorted(set(init.state_dict()) - set(moved))}")
    later = res["epochs"][1:]
    steps_per_s = sum(e["steps"] for e in later) / sum(
        e["train_seconds"] for e in later)
    out = {"steps": steps, "b1_launches": b1, "b2_launches": b2,
           "cli_wall_s": wall, "epochs": res["epochs"],
           "steps_per_s": steps_per_s, "images_per_s": 8 * steps_per_s,
           "last_metrics": res["metrics"]}
    say(f"path 1: {steps} steps in {wall:.2f} s (CLI wall incl. "
        f"checkpoints); epochs 2-3 ({sum(e['steps'] for e in later)} "
        f"steps) {steps_per_s:.3f} steps/s = "
        f"{8 * steps_per_s:.2f} images/s (batch 8, bf16); B1 launches {b1}, "
        f"B2 launches {b2}")
    # resume: one more epoch from the epoch-3 'latest'
    res2, b1r, _, _ = _train_run(
        torch, _train_argv(tmp, name, niter=4, extra=("--continue_train",)))
    check(res2["step"] == 32 and [e["epoch"] for e in res2["epochs"]] == [4],
          f"path 1 resume: step {res2['step']}, epochs {res2['epochs']}")
    check(b1r == 8, f"path 1 resume: {b1r} B1 launches for 8 steps")
    out["resume"] = {"step": res2["step"], "b1_launches": b1r,
                     "metrics": res2["metrics"]}
    out["profile"] = _profile_train(torch, tmp)
    out["launches_per_run"] = {"train": b1, "resume": b1r,
                               "profile": out["profile"]["launches"]}
    return out


def _profile_train(torch, tmp, steps: int = 4) -> dict:
    """Path 1 under torch.profiler: a fresh run of two epochs of 4 steps.
    Device ms per step by kernel is averaged over all 8 steps; the step
    window is the second epoch's (first batch to the last step done), when
    the synthetic images are cached as in steady training. The run's
    checkpoint writes are stubbed out, so the trace holds data,
    preprocessing, the steps and the print points."""
    from torch.profiler import ProfilerActivity, profile
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    argv = _train_argv(tmp, "smoke_train_profile", niter=2, size=8 * steps)
    saves = ckpt.save_state, ckpt.save_generator
    ckpt.save_state = ckpt.save_generator = lambda *a, **k: None
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res, b1, _, _ = _train_run(torch, argv)
    finally:
        ckpt.save_state, ckpt.save_generator = saves
    n = 2 * steps
    check(b1 == n == res["step"],
          f"profile run: {b1} B1 launches for {res['step']} steps")
    rows = _device_rows(torch, prof, n)
    device_ms = sum(r[0] for r in rows)
    window_ms = res["epochs"][1]["train_seconds"] * 1e3 / steps
    check(device_ms > 0, "profile run: no device time traced")
    out = {"launches": b1, "device_ms_per_step": device_ms,
           "window_ms_per_step": window_ms,
           "device_busy_share": device_ms / window_ms,
           "device_launches_per_step": sum(r[1] for r in rows),
           "preprocess_kernel_ms_per_step": sum(
               r[0] for r in rows if "preprocess_kernel" in r[2]),
           "top_kernels_ms_per_step": [[round(ms, 4), cnt, name[:100]]
                                       for ms, cnt, name in rows[:20]]}
    say(f"training profile (bf16, 2 epochs of {steps} steps of batch 8, "
        f"every step traced, no checkpoint writes): device "
        f"{device_ms:.3f} ms of {window_ms:.3f} ms window per step, busy "
        f"share {device_ms / window_ms:.3f}, "
        f"{out['device_launches_per_step']:.1f} launches per step")
    for ms, cnt, name in rows[:20]:
        say(f"  {ms:9.4f} ms/step {cnt:7.1f} launches/step  {name[:100]}")
    return out


def phase_train_parity(torch) -> dict:
    """One f32 step (TF32 off) of a small config on the card and on the CPU
    from the same seeded weights and batch: losses within 1e-4, parameters
    within the Adam first-step envelope."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.train import create_train_state, make_train_step
    cfg = parse_config(["--netG", "resnet_6blocks", "--ngf", "16", "--ndf",
                        "16", "--crop_size", "32", "--load_size", "32",
                        "--batch_size", "4", "--n_age_bins", "4",
                        "--pool_size", "0", "--dtype", "float32",
                        "--cond_inject", "bottleneck", "--lr_policy",
                        "constant"])
    rng = np.random.default_rng(4)
    batch = {"image": torch.from_numpy(
                 rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)),
             "bin": torch.from_numpy(rng.integers(0, 4, 4)),
             "target_bin": torch.from_numpy(rng.integers(0, 4, 4))}
    runs = {}
    for dev in ("cpu", DEV):
        G = define_G(cfg, torch.Generator().manual_seed(7)).to(dev)
        D = define_D(cfg, torch.Generator().manual_seed(8)).to(dev)
        state = create_train_state(cfg, G, D, torch.Generator().manual_seed(0))
        m = make_train_step(cfg, G, D)(
            state, {k: v.to(dev) for k, v in batch.items()})
        runs[dev] = ({k: float(v) for k, v in m.items()},
                     {f"{n}.{k}": v.detach().cpu() for n, net in
                      (("G", G), ("D", D))
                      for k, v in net.state_dict().items()})
    (mc, pc), (mg, pg) = runs["cpu"], runs[DEV]
    loss_err = max(abs(mc[k] - mg[k]) for k in mc)
    check(loss_err <= TRAIN_STEP_TOL, f"train parity: losses differ by "
          f"{loss_err} (cpu {mc}, card {mg})")
    g0 = define_G(cfg, torch.Generator().manual_seed(7)).state_dict()
    d0 = define_D(cfg, torch.Generator().manual_seed(8)).state_dict()
    init = {**{f"G.{k}": v for k, v in g0.items()},
            **{f"D.{k}": v for k, v in d0.items()}}
    worst = {"max": 0.0, "median": 0.0, "frac": 0.0}
    for k, v0 in init.items():
        diff = ((pc[k] - v0) - (pg[k] - v0)).abs().numpy()
        worst["max"] = max(worst["max"], float(diff.max()))
        worst["median"] = max(worst["median"], float(np.median(diff)))
        worst["frac"] = max(worst["frac"], float((diff > 0.25 * LR).mean()))
    check(worst["max"] <= 2.1 * LR and worst["median"] < 2e-6
          and worst["frac"] < 2e-3,
          f"train parity: parameters outside the Adam envelope {worst}")
    out = {"loss_max_abs_err": loss_err, "param_delta_diff": worst,
           "losses_card": mg}
    say(f"train parity (f32, TF32 off, resnet_6blocks ngf/ndf 16, 32 px, "
        f"batch 4, one step): {json.dumps(out)}")
    return out


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "pcgan_tpu_torch")):
        fail("run chip_smoke.py from a checkout of the repository "
             "(pcgan_tpu_torch/ is missing)")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    sys.path.insert(0, HERE)
    from pcgan_tpu_torch.device import resolve_device
    resolve_device("cuda")                     # TF32 off for every phase
    t_start = time.perf_counter()
    card = phase_device(torch)
    phase_build()
    b1 = phase_kernel_check(torch)
    b2 = phase_wgrad_check(torch)
    with tempfile.TemporaryDirectory() as tmp:
        sampling = phase_main_path(torch, tmp)
        parity = phase_card_parity(torch, tmp)
        path2 = phase_path2(torch)
        path1 = phase_path1(torch, tmp)
        train_parity = phase_train_parity(torch)
    b1["launches_per_path"] = {
        "sampling": sampling["launches_per_run"],
        "training": path1["launches_per_run"], "bench_lowch": 0}
    b1["launches"] = sampling["launches"] + sum(
        path1["launches_per_run"].values())
    b2["launches_per_path"] = {"bench_lowch": path2["launches"],
                               "training": path1["b2_launches"],
                               "sampling": 0}
    b2["launches"] = path2["launches"] + path1["b2_launches"]
    check(b1["launches"] > 0 and b2["launches"] > 0,
          f"a kernel was never launched on its path: B1 {b1['launches']}, "
          f"B2 {b2['launches']}")
    say(f"summary: {json.dumps({'sampling': sampling, 'parity': parity, 'path2': path2, 'path1': path1, 'train_parity': train_parity})}")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": [b1, b2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
