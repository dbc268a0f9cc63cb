#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``pcgan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught, but for
the one named in phase 2):

1. device: the card's name and power limit from nvidia-smi;
2. build: compile every CUDA kernel of the port from ``pcgan_tpu_torch/csrc``
   (one nvcc per source) and the host JPEG decoder (g++ against the host's
   libjpeg, or against the vendored ABI-62 headers and the libjpeg of
   Pillow's wheel), all started together; libjpeg's ABI and the route are
   printed, or, on a host with neither libjpeg, the decoder's
   ``JpegUnavailable`` and the switch of phases 13-15 to PNG copies of the
   fixtures;
3. B1 kernel check: the preprocessing kernel against its plain PyTorch
   version on the card (TF32 off) at the sampling shape (center crop), the
   training shape (random crops and flips), the comparator's 2B shapes
   (both pair members with random crops and flips; held-out pairs center
   cropped), the 250 px CACD canvas (B 32, 250 -> 286 -> 256) and the
   ``--host_decode_m 6`` canvas (B 32, 150 -> 143 -> 128), the batches of
   phases 14-15 (32 and 2 x 64 with random crops and flips; 64, 63 and 2
   center cropped), a ragged, an identity and an upscale shape with flips,
   in f32 and bf16 output, then timed (graph
   replay, eager, and with a cold L2) beside its plain version, one library
   yardstick and its bound;
4. sampling path: ``pcgan_tpu_torch.test.main`` end to end (synthetic
   data, resnet_9blocks at full width, 128 px, 10 bins, bf16), with launch
   counts read around each run, the written grid checked, the grid rate
   after warm-up, and one more run under torch.profiler (device time per
   batch by kernel, the device's busy share of the batch windows);
5. sampling parity: the same seeded G in f32 on the card against the CPU;
6. B2 kernel check: the weight-gradient kernel against its plain version at
   the G tail's shape (bf16 and f32) and at the shapes the tensor-core
   tiling must take in bf16 (Cin 24 and 300, k 1 and 3, C_out 1 and 8, Wp
   not a multiple of 16, rows of two segments), timed in turns beside its
   plain version and cuDNN's weight-gradient conv, then with a cold L2;
7. path 2: ``pcgan_tpu_torch.tools.bench_lowch.main`` (tail and stem, bf16)
   with B2's launches read around it, and the routed VJP held against the
   direct one;
8. path 1: ``pcgan_tpu_torch.train_main.main`` at the default GAN's full
   width in bf16 for 3 epochs of 8 steps, its outputs and a
   ``--continue_train`` resume checked, steps/s after the first epoch, and
   a fresh 2 x 4-step run under torch.profiler;
9. training parity: one f32 step of a small config on the card against the
   CPU from the same seeded weights;
10. path 3: comparator pretraining (``train_main.main --model comparator
    --dataset_mode pairwise``) at the default comparator's width in bf16, 2
    epochs and 1 resumed, its bundle and anchors checked, pairs/s after the
    first epoch, and a fresh 2 x 4-step run under torch.profiler;
11. path 1 with the comparator: the phase-8 GAN with ``--comparator_path``
    at ``--lambda_cond 10`` (6 epochs of 8 steps, the cond loss non-zero, C
    unchanged, steps/s over epochs 2-6 with their spread, and a profiled
    2 x 4-step run beside phase 8's), then
    one epoch in ``--cond_mode score`` and its score-sweep grid from
    ``pcgan_tpu_torch.test.main``;
12. comparator parity: one f32 comparator step and one f32 GAN step with
    the cond loss, card against CPU;
13. the host decoder: the committed JPEG fixtures
    (``tests/torch_port_data``) against their digests, and PNG copies of the
    fixtures' source canvases (the numpy PNG reader) against the canvases
    (without libjpeg: a JPEG folder raising ``JpegUnavailable``, and the
    PNGs only); batch against single decodes over each 128-image folder
    (each fixture under four age-shifted names), decode images/s at 1 and 8
    threads for each format;
14. path 4, real images: ``train_main.main`` with
    ``scripts/train_utkface_128.sh``'s flags over the folder (batch 32, the
    frozen phase-10 comparator, bf16; 6 epochs, steps/s over epochs 2-6 with
    their spread beside phase 11's, and 1 resumed on the seeded
    permutation), ``test.main`` with ``test_aging_grid.sh``'s flags (50
    grids, PNGs decoded), a profiled 2 x 4-step run, a pack of the folder
    equal to the live decode and one packed epoch, ``sort_unlabeled`` with
    phase 10's bundle and one sorted epoch; with libjpeg the folder holds
    the JPEGs, and the rate is read again over the PNG copies;
15. path 3 label-free: ``pretrain_comparator.sh``'s flags (batch 64, the
    default comparator, 1 epoch) over a comparisons CSV of the folder
    (anchors by score quantiles of its image pool, recomputed) and over the
    folder's pairs;
16. evaluation at ``scripts/train_256_fid.sh``'s width (resnet_9blocks,
    250 px CACD canvases -> 286 -> 256, batch 32, bf16, 10 bins) over a
    pack of 1,024 synthetic canvases: ``pcgan_tpu_torch.evaluate`` with
    every metric of the random feature space (finite, B1 launches), the
    eval rate after a one-batch warm-up and the shares of G, the feature
    nets and the epilogue, the same pass with TF32 allowed;
    ``compute_fid_stats`` then ``evaluate --fid_stats`` (``fid`` equal to
    ``fid_stream`` on the same rows); a seeded InceptionV3 ``.pth`` made
    here (its images/s at 299 px and its card-vs-CPU features) and phase
    10's comparator as feature spaces; ``train_main`` with the script's
    list (one epoch, holdout 0.1, EMA eval), its ``eval_*`` / ``eval_h_*``
    rows; the evaluator's f32 moments, card against CPU;
17. serving at full width, ``scripts/export_and_serve.sh`` through the
    port: ``tools.export_serving`` with the script's export list and
    ``--verify`` on phase 14's checkpoint in bf16, again with
    ``--quant_int8 --calib_dataroot`` over phase 14's folder, phase 10's
    comparator with ``--comparator_path``, and an f32 export; the int8
    conv's s32 accumulators card vs CPU bit for bit at every trunk shape;
    the f32 artifact card vs CPU; rows/s of direct calls at batch 8 and 80
    (bf16, int8) with device ms and launches a call and the int8/bf16
    ratio; the HTTP host in-process with the script's serve flags
    (``--warmup_batch 8 --batch_window_ms 5``) under the port's loadtest
    (concurrency 8 x batch 8; its JSON line, then with window 0) beside
    phase 4's grid rate; the image routes over a fixture JPEG, the abuse
    battery, ``POST /reload`` to the int8 artifact under load; B1 on
    ``test.main --quant_int8 --anim 24``;
18. the lever path at full width (``train_utkface_128.sh``'s shape over
    the synthetic set: resnet_9blocks, ngf/ndf 64, 128 px, batch 32, bf16,
    10 bins): ``train_main.main`` with every lever at once (the multiscale
    D under spectral norm with attention, R1, feature matching, the VGG19
    loss over a seeded trunk written here as a ``.pth``, DiffAugment with
    ADA, ``--skip_nonfinite``, EMA, grad norms, dropout, TensorBoard) for
    3 epochs of 10 steps (steps/s, peak memory, the final ``ada_p``), a
    profiled 2 x 2-step run of it beside the plain step's at the same
    shape (device ms and launches per step); 4 steps each of
    ``--gan_mode wgangp``, ``--norm batch`` (then ``test.main`` sampling
    from its checkpoint) and ``--netD pixel``; ``--grad_accum 4`` against
    ``--grad_accum 1`` in f32 (every metric and Adam first moment within
    1e-4 of max(1, max|x|) with cuDNN off, the difference with cuDNN's
    batch-dependent algorithms reported, each run's peak memory);
    ``--remat`` against none at 256 px (the peak must fall; the step-time
    cost); a forced non-finite step (``notfinite_G/D`` 1, params, EMA and
    Adam counts held) and the cost of the check; one f32 step with
    spectral norm, the multiscale D, R1 and feature matching, card
    against CPU;
19. the generator variants and the device cache at full width (phase
    18's shape): (a) ``--netG unet_128``, 3 epochs (steps/s), a profiled
    run beside phase 18's plain step, ``test.main``'s grid rate and an
    ``--anim`` sweep, its int8 accumulators at the one-pixel innermost
    levels card vs CPU, bf16 and int8 exports with ``--verify`` and their
    rows/s at batch 80; (b) ``unet_256`` at 256 px with ``--remat``
    against without (peak memory must fall); (c) ``resnet_9blocks
    @resize_conv --g_attn`` profiled beside the plain step; (d) path 4's
    flags with the JAX default routes (cond-bias stem, s2d tail) against
    ``--no-lowch_matmul``, profiled, and the tail conv's f+vjp as the
    direct conv, the s2d conv and ``lowch_reflect_conv`` (B2), held
    against each other; (e) card vs CPU: an f32 unet step, an f32
    ``@resize_conv --g_attn`` forward, the bf16 routes against the
    direct conv; (f) at path 4's flags with cuDNN deterministic: two
    streaming runs (the second traced by ``--profile_steps``) with the same
    losses and the same final state bit for bit, one more under ``torch.use_deterministic_algorithms(True)`` (no
    op may raise), ``--device_cache``'s batches and loss stream
    bit-identical to the streaming run's, steps/s and host-to-device bytes
    a step from ``--profile_steps`` traces; a resident cache of 4,096
    canvases (upload s, steps/s against the host Loader). B2 stays off
    every new CLI path;
20. the tools at ``bench.py``'s config (resnet_9blocks, ngf/ndf 64, 128
    px, batch 64, bf16, 10 bins), each through its ``main(argv)``: (a) the
    bench's headline (B1's launches counted inside its timed loop),
    ``--e2e`` over 512 synthetic JPEGs, ``--e2e --packed``, ``--e2e
    --device_cache``, ``--infer`` live, ``--serving`` and
    ``--quant_int8``, and ``--latency`` with its traced ``device_ms``,
    each line checked for its JAX metric name and a finite positive
    value; (b) ``profile_step`` over 6 steps: its class shares, its
    device ms a step against the headline's wall time a step and within
    15% of an independent profile of ``train_main`` at the same config,
    its roofline (each op call floored at max(FLOPs / peak, bytes / peak
    bandwidth) from its recorded shapes): the floor must cover >= 95% of
    the device ms a step and no op may run below 0.95x its floor;
    (c) ``profile_e2e``, every stage positive; (d) ``tune_batch`` over
    batch 32 and 64, then batch 64 with the process capped to 0.5% of
    the card: out of memory on every rung of the dial ladder; (e)
    ``memory_plan --sweep`` at 256 px, batch 64: remat and accumulation 4
    peak below the base row; (f) ``doctor``; (g) a seeded
    resnet_9blocks and phase 19's unet_128 exported to ``.pth`` through
    the mirror template and imported back bit-identical, the mirror's f32
    forward on the card within 1e-4 of the port's G; (h)
    ``average_ckpts`` over phase 8's epochs 2-3 (their mean) and
    ``test.main --epoch swa``, ``plot_losses`` and ``compare_runs`` over
    phase 14's and phase 8's metrics, a two-combination ``sweep``;
21. the repairs and the last one-card flags: (a) phase 19 (f)'s
    bit-for-bit runs restated, and the device ms a step of the port's pad
    backward (``ops/pad.py``) in phase 20's bench trace beside the 9.4 ms
    ATen's atomic backward took there, and the headline beside its rate
    then; (b) phase 20's floor,
    ``ratio_to_floor`` and covered share; (c) ``--dtype float16`` at phase
    18's plain shape (4 profiled steps, every loss finite, B1's launches,
    device ms, launches and steps/s beside phase 18's bf16 profile), the
    f16 G card vs CPU on the same weights within the CPU test's limits,
    and at full width (128 px, one row; the CPU reference computed in a
    process of its own beside phases 21-22, reported after phase 22); (d)
    a ``--no-pallas_pipeline`` run (B1 launched no time) and its plain
    route on a CUDA batch against B1's within B1's gates;
22. data parallelism across processes (``parallel/``): (a) two ranks
    spawned on the one card over gloo (CUDA tensors, f32, TF32 off, pool
    off, target bins pinned; the default GAN at full width, global batch
    16, B1 center-cropping each rank's rows) take 3 steps from one warm
    state: every loss within TRAIN_STEP_TOL of one rank's on the whole
    batch, the parameters within the lockstep's Adam envelope, the ranks
    bit-identical, B1's launches on each rank, the two ranks' FID within
    2e-3 of one rank's; their images/s, two ranks time-slicing one card
    through host-staged gloo, is no data-parallel speed; (b)
    ``train_utkface_128_dp8.sh``'s flags (batch 256, bf16, phase 10's
    comparator) over phase 14's faces under four names each (512 images)
    through ``torchrun --standalone --nproc_per_node 1`` on NCCL (this
    script re-entered with ``--dp-worker``), profiled, its loss stream
    bit-identical to the same run without torchrun (cuDNN deterministic
    for both): steps/s, images/s, device ms and launches a step, the NCCL
    kernels and their ms, peak memory; (c) ``--device_cache_sharded`` under
    NCCL: every batch bit-identical to the replicated cache's, the
    gather's ms; (d) ``evaluate`` under torchrun: its record equal to the
    plain run's;
23. sharded training state (``parallel/auto.py``): (a) two ranks spawned
    on the one card over gloo (CUDA tensors, f32, TF32 off; the default
    GAN at full width, global batch 8, B1 randomly cropping and flipping
    the raw u8 canvases, target bins and the pool's slots drawn, pool on)
    take 3 steps, each from the one rank's state before it, under
    ``--zero1`` (data 2) and under data 1 x model 2: every loss within
    TRAIN_STEP_TOL of one rank's plain step on the global batch, the
    parameters within the Adam envelope, the ranks' gathered states
    bit-identical, B1 launched on each rank; each rank's resident state
    bytes beside the plain rank's, the collectives a step and their ms;
    (b) the train CLI under ``torchrun --nproc_per_node 1`` (this script
    re-entered with ``--auto-worker``) with ``--mesh_shape 1
    --spatial_shards 2`` and with ``--mesh_shape 1,1 --mesh_axes
    data,model``: both loss streams bit-identical to the plain run's
    (cuDNN deterministic for all three); in (a)'s spawn, ``--netG
    resnet_9blocks@resize_conv`` at data 1 x model 2 for 3 steps: the two
    ranks bit-identical (the nearest upsample's backward);
24. the spatial mesh axis (``parallel/spatial.py``): B1 writing the bands
    of a spatial axis of 2 and 4 at 256 px (each bit-identical to the
    whole crop's rows, within the gates of its plain twin's band; the band
    form timed beside the whole crop); (a) two ranks on the one card over
    gloo (phase 23 (a)'s spawned ranks, which run these steps after
    their own: one spawn fewer) at data 1 x spatial 2 (f32, the default
    GAN at full width, 256 px crops of 286 px u8 canvases, global batch 4,
    everything
    drawn, pool on) take 3 steps, each from one rank's state before it:
    the losses of the forward passes within 1e-5 of max(1, |loss|) of one
    rank's plain step (``loss_G_GAN`` and ``loss_G``, which read D after
    its Adam update, within TRAIN_STEP_TOL, as phase 23 holds them), the
    parameters within the Adam envelope, the ranks bit-identical, B1
    launched on each rank writing its band; each rank's peak allocated
    bytes beside one rank's, the collectives a step by kind (the halo
    exchanges and their gradients, the band sums) and their ms; (b)
    ``train_256_fid.sh``'s flags (bf16, batch 32, the lowch routes) for 4
    steps under ``torchrun --nproc_per_node 2`` over gloo on the one card
    (this script re-entered with ``--spatial-worker``) at ``--mesh_shape
    1,2 --mesh_axes data,spatial``: the loss stream within the bf16
    bounds stated before the first run (of max(0.1, |loss|): 2e-2 at the
    first step, 1e-1 at every step) of the plain run's, each rank's peak
    memory;
25. the model levers on bands: B1's band at 1-row, odd-start and uneven
    heights (bit-identical to the whole crop's rows, within the gates of
    its plain twin's band); two ranks on the one card over gloo (phase 23
    (a)'s spawned ranks, after phase 24 (a)'s) at data 1 x spatial 2
    (f32, full width, 256 px crops, global batch 4, everything drawn,
    dropout too, pool on, every attention block's gamma 0.5) take 3
    steps, each from one rank's state before it, of ``--netG
    resnet_9blocks@resize_conv --g_attn --d_attn --netD multiscale --norm
    group --no-no_dropout --remat --remat_blocks 3`` and of ``--netG
    unet_256 --no-no_dropout --remat --remat_blocks 2``, held as phase 24
    (a) holds its steps; no rank keeps a whole square image for the
    backward where one rank's step keeps some (``spatial.SavedAudit``),
    and what autograd keeps a rank beside one rank's; each rank's peak
    allocated bytes beside one rank's, the bytes held before the first
    step and the owners of its peak (the allocator's memory history); the
    collectives a step by kind beside one step's without ``--remat``
    (which must re-issue halo exchanges), the attention's gathers, the
    phase's time.

``python3 chip_smoke.py --cards N`` on a machine with N cards runs phase
22 (a) with one NCCL rank a card, the collectives' kernels of one
profiled step, and the sharded cache across the ranks; then, under
``torchrun --nproc_per_node N`` on NCCL, each step from one card's state
before it against one card's plain step (losses within 1e-4 rel, the
parameters within the one-step envelope, every rank bit-identical; peak
memory and collectives a rank): phase 24 on the cards,
``train_256_fid.sh``'s shape in f32 (batch 32, 3 steps) at data 2 x
spatial 2 and at data 1 x spatial 2 x model 2, and phase 25's lever
resnet at data 1 x spatial 4; then phase 23 on the cards,
``train_utkface_128_dp8.sh``'s shape in f32 (batch 256, 3 steps) over
``--mesh_shape 2,2 --mesh_axes data,model --zero1`` (resident state
bytes too), then the train CLI on that mesh under torchrun (exit code 0,
finite losses, B1 3 times a rank, the first step within 1e-4 rel of one
card's plain run, rank 0's checkpoint resumed on one card), and
``ServedGenerator.data_parallel`` over the N cards against one card's
call (f32 within 1e-5) with both rates.

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
# what each time in the kernels line measures; `ms` and `library_ms` were
# eager calls before the port's kernels moved to graph replay (a break in
# their series): eager_ms and library_eager_ms continue the old one
TIMING_NOTE = ("ms and library_ms: CUDA-graph replay, 200 calls on the same "
               "inputs, warm L2; cold_ms and library_cold_ms: one call after "
               "a 256 MB read evicts the L2, median of 30; eager_ms, plain_ms "
               "and library_eager_ms: back-to-back eager calls")


def _jsonable(v):
    """numpy values in the summary line."""
    return v.tolist() if hasattr(v, "tolist") else str(v)


_T0 = time.perf_counter()


def say(msg: str) -> None:
    """A progress line, after the seconds since the script started (where
    the phases' time goes)."""
    print(f"[chip_smoke] {time.perf_counter() - _T0:7.1f} s| {msg}",
          flush=True)


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
    """Mean ms per call over back-to-back eager calls, CUDA events: the
    device time, or the host's when each call's Python work takes longer."""
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


def graph_ms(torch, fn, calls: int = 20, reps: int = 10) -> float:
    """Mean ms per call of ``fn`` replayed from one CUDA graph of ``calls``
    calls, CUDA events: the device time of its launches, without the host
    time of the Python wrapper (which runs once per call, at capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * reps)


def cold_ms(torch, fn, iters: int = 30, flush_mb: int = 256) -> float:
    """Median ms of one call of ``fn`` with a cold L2: before each call a
    read of ``flush_mb`` MB (five times the H100's 50 MB L2; a read leaves
    clean lines, so the call pays no write-back) evicts its inputs, and a
    device sleep lets the host enqueue the call before the device reaches
    it. CUDA events around the call alone."""
    flush = torch.ones((flush_mb << 20) // 4, dtype=torch.int32, device=DEV)
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in ev:
        flush.sum()
        torch.cuda._sleep(100_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


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


def phase_build() -> dict:
    from concurrent.futures import ThreadPoolExecutor
    from pcgan_tpu_torch import native
    from pcgan_tpu_torch.ops import _build, cuda_preprocess, cuda_wgrad
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:      # one nvcc each and g++, together
        kernels = [pool.submit(m.build) for m in (cuda_preprocess, cuda_wgrad)]
        decoder = pool.submit(native.load)
        for f in kernels:
            f.result()
        try:
            decoder.result()
            jpeg = None
        except native.JpegUnavailable as e:
            # a host without libjpeg: the decoder raises, naming it; phases
            # 13-15 then run over PNG copies of the fixtures (any other
            # build failure is not caught)
            jpeg = str(e)
    out = {"build_s": time.perf_counter() - t0, "jpeg_unavailable": jpeg}
    if jpeg is None:
        # the loaded library's name says which libjpeg it was linked to
        route = ("wheel: " + os.path.basename(_build.wheel_libjpeg())
                 if "_wheel_" in os.path.basename(native.load()._name)
                 else "system -ljpeg")
        out.update(libjpeg_abi=native.jpeg_abi(),
                   libjpeg_turbo=native.jpeg_turbo_version(),
                   libjpeg_route=route)
        say(f"build (B1 + B2 with nvcc, the JPEG decoder with g++): "
            f"{out['build_s']:.2f} s; libjpeg ABI {out['libjpeg_abi']}, "
            f"headers' libjpeg-turbo {out['libjpeg_turbo'] or 'no'} "
            f"(MMMmmmppp), linked to {route}")
    else:
        say(f"build (B1 + B2 with nvcc): {out['build_s']:.2f} s; NO JPEG "
            f"DECODER on this host, phases 13-15 read PNGs: {jpeg}")
    # ptxas -v per kernel: its (mangled) name, then spills, then registers
    # and static shared memory
    for log in sorted(os.listdir(_build.BUILD_DIR)):
        if log.endswith(".log"):
            with open(os.path.join(_build.BUILD_DIR, log)) as f:
                text = f.read()
            for name, body in re.findall(
                    r"Function properties for (\S+)\n(.*?)(?=ptxas info    : "
                    r"Compile time)", text, re.S):
                stats = " | ".join(
                    m.strip() for m in re.findall(
                        r"(\d+ bytes spill stores.*|Used \d+ registers.*)",
                        body))
                kernel = re.search(r"(preprocess|wgrad_tc|wgrad_fma|"
                                   r"wgrad_reduce|norm_fwd|norm_bwd)"
                                   r"_kernel(I.*?EE)?", name)
                say(f"ptxas {kernel.group(0) if kernel else name}: {stats}")
    return out


def _preprocess_case(torch, rng, b, native, load, crop, center=False):
    """A u8 batch and its crop offsets and flips: random, or the sampling
    path's center crop without flips."""
    dev = torch.device(DEV)
    imgs = torch.from_numpy(rng.integers(0, 256, (b, native, native, C),
                                         dtype=np.uint8)).to(dev)
    span = load - crop
    if center:
        cy = cx = torch.full((b,), span // 2, dtype=torch.int32, device=dev)
        fl = torch.zeros(b, dtype=torch.int32, device=dev)
        return imgs, cy, cx, fl
    cy = torch.from_numpy(rng.integers(0, span + 1, b).astype(np.int32)).to(dev)
    cx = torch.from_numpy(rng.integers(0, span + 1, b).astype(np.int32)).to(dev)
    fl = torch.from_numpy(rng.integers(0, 2, b).astype(np.int32)).to(dev)
    return imgs, cy, cx, fl


def phase_kernel_check(torch) -> dict:
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.ops.preprocess import (crop_rows, preprocess_batch,
                                                resize_matrix)
    rng = np.random.default_rng(0)
    # (B, native, load, crop, center crop without flips)
    cases = {"sampling": (MAIN_B, NATIVE, LOAD, CROP, True),
             "training": (MAIN_B, NATIVE, LOAD, CROP, False),
             # comparator pretraining: both pair members in one call, and
             # the held-out pairs' center crops (an anchor batch of 8
             # images is the sampling shape)
             "comparator": (2 * MAIN_B, NATIVE, LOAD, CROP, False),
             "comparator_eval": (2 * MAIN_B, NATIVE, LOAD, CROP, True),
             # train_256_fid.sh's CACD canvas, and the --host_decode_m 6
             # canvas of a 200 px folder
             "cacd_256": (32, 250, 286, 256, False),
             "decode_m6": (32, 150, LOAD, CROP, False),
             # path 4's batch of train_utkface_128.sh; label-free
             # pretraining's 2 x 64 pair members; sort_unlabeled's and the
             # anchors' center-cropped batches of 64, the last anchor batch
             # of the 127-image pool, and the grid's last batch of 50 rows
             "real_images": (REAL_B, NATIVE, LOAD, CROP, False),
             "pairs_b64": (128, NATIVE, LOAD, CROP, False),
             "center_b64": (64, NATIVE, LOAD, CROP, True),
             "anchor_tail": (63, NATIVE, LOAD, CROP, True),
             "grid_tail": (2, NATIVE, LOAD, CROP, True),
             "ragged": (4, 50, 43, 32, False),
             "identity": (2, CROP, CROP, CROP, False),
             "upscale": (3, 30, 64, 48, False)}
    err_f32, ulps_bf16 = 0.0, 0.0
    for name, (b, native, load, crop, center) in cases.items():
        imgs, cy, cx, fl = _preprocess_case(torch, rng, b, native, load, crop,
                                            center)
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

    # timing at the sampling path's shape and output dtype (bf16): the
    # kernel from a CUDA graph (its device time) and eagerly through its
    # wrapper, in turns with the plain version (eager: it copies the resize
    # matrices from the host, which a graph cannot hold)
    imgs, cy, cx, fl = _preprocess_case(torch, rng, MAIN_B, NATIVE, LOAD, CROP)
    flb = fl.bool()
    bf16 = torch.bfloat16

    def kernel():
        return cp.preprocess_batch_cuda(imgs, cy, cx, fl, LOAD, CROP,
                                        out_dtype=bf16)

    def plain():
        return preprocess_batch(imgs, cy, cx, flb, LOAD, CROP, out_dtype=bf16)
    ms_pairs = {"ms": [], "plain_ms": []}
    for key in ("plain_ms", "ms", "ms", "plain_ms"):      # in turns
        ms_pairs[key].append(graph_ms(torch, kernel) if key == "ms"
                             else cuda_ms(torch, plain))
    eager_ms = cuda_ms(torch, kernel)
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
    library_ms = graph_ms(torch, library)
    library_eager_ms = cuda_ms(torch, library)
    # bound: what this run's inputs need. Row y of Mh (Mw) is non-zero only
    # over the filter's support, so image b needs only the input rows
    # (columns) in the union of the supports of its crop's rows (columns),
    # u8, read once; the non-zero taps of the distinct rows the crops use;
    # crop offsets and flips; the bf16 output. Operations: the vertical pass
    # over the needed columns only, then the horizontal pass per output
    # pixel, one FMA per non-zero tap.
    sup_h, sup_w = mh[ys] != 0, mw[xs] != 0             # (B, crop, NATIVE)
    rows_in, cols_in = sup_h.any(1).sum(1), sup_w.any(1).sum(1)     # (B,)
    flops = 2 * C * (int((sup_h.sum((1, 2)) * cols_in).sum())
                     + CROP * int(sup_w.sum()))
    nz = (mh != 0).sum(1)
    band_bytes = 4 * (int(nz[ys.unique()].sum()) + int(nz[xs.unique()].sum()))
    nbytes = (C * int((rows_in * cols_in).sum()) + band_bytes
              + 3 * MAIN_B * 4 + MAIN_B * CROP * CROP * C * 2)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    out = {"name": "preprocess", "route": "cuda",
           "source": "pcgan_tpu_torch/csrc/preprocess.cu",
           "replaces": "pcgan_tpu/ops/pallas_preprocess.py:104",
           "max_abs_err": err_f32, "max_ulp_bf16": ulps_bf16,
           "ms": min(ms_pairs["ms"]), "eager_ms": eager_ms,
           "cold_ms": cold_ms(torch, kernel),
           "plain_ms": min(ms_pairs["plain_ms"]), "library_ms": library_ms,
           "library_eager_ms": library_eager_ms,
           "library_cold_ms": cold_ms(torch, library),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes,
           "input_rows_cols": [[int(r), int(c)] for r, c in
                               zip(rows_in, cols_in)],
           "shape": f"B{MAIN_B} {NATIVE}->{LOAD}->{CROP} C{C} u8->bf16",
           "timing": TIMING_NOTE,
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


def _seeded_C(torch, argv, seed=0):
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_C
    return define_C(parse_config(argv), torch.Generator().manual_seed(seed))


def _norm_sites(net) -> int:
    """A net's instance-norm sites: each call of the net launches the fused
    norm once at each (and once more each in its backward)."""
    from pcgan_tpu_torch.models.layers import InstanceNorm
    return sum(isinstance(m, InstanceNorm) for m in net.modules())


def _main_run(torch, argv):
    """One run of the main path with the launch counts zeroed just before
    and read just after; the fused norm's is ``res["norm_launches"]``, one
    forward launch at each G site a batch (one G call on the batch's rows
    times the bins, no backward)."""
    from pcgan_tpu_torch import test as port_test
    from pcgan_tpu_torch.ops import cuda_instance_norm as cin
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    cp.launches = cw.launches = cin.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = port_test.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(cw.launches == 0, f"sampling path: {cw.launches} B2 launches")
    res["norm_launches"] = cin.launches
    want = _norm_sites(_seeded_G(torch, argv)) * len(res["batch_seconds"])
    check(cin.launches == want > 0,
          f"sampling path: {cin.launches} fused norm launches for "
          f"{len(res['batch_seconds'])} batches, want {want}")
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
    out = {"launches_per_run": {}, "norm_launches_per_run": {}}
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
        out["norm_launches_per_run"][inject] = res["norm_launches"]
        out[inject] = _check_grid(torch, argv, res, inject)

    # grid rate after warm-up: 8 batches of 8 inputs, the first is warm-up
    argv = _argv(tmp, "smoke_bottleneck", "bottleneck", num_test=64)
    res, launches, wall = _main_run(torch, argv)
    check(launches == len(res["batch_seconds"]) == 8,
          f"rate run: {launches} launches for {len(res['batch_seconds'])}")
    out["launches_per_run"]["rate"] = launches
    out["norm_launches_per_run"]["rate"] = res["norm_launches"]
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
    out["norm_launches_per_run"]["profile"] = \
        out["profile"]["norm_launches"]
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
    out = {"launches": launches, "norm_launches": res["norm_launches"],
           "device_ms_per_batch": device_ms,
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
    """B2 against its plain version, bf16 on the tensor-core route and f32
    on the f32-FMA route; then timed in turns at the G tail's shape in bf16
    (the training path's dtype) with its bound and cuDNN's weight-gradient
    conv as the library yardstick."""
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    rng = np.random.default_rng(1)
    bf16, f32 = torch.bfloat16, torch.float32
    # (B, Hp, Wp, Cin, Cout, k): Wp 29, 21 and 13 are not multiples of 16;
    # Wp 262 splits each row into two segments
    cases = [("tail", TAIL, bf16), ("tail", TAIL, f32),
             ("segments", (2, 20, 262, 64, 3, 7), bf16),
             ("ragged", (3, 37, 29, 24, 1, 3), bf16),
             ("ragged", (3, 37, 29, 24, 1, 3), f32),
             ("cout8", (2, 40, 40, 16, 8, 7), bf16),
             ("cin300", (2, 19, 21, 300, 2, 7), bf16),
             ("k1", (2, 12, 13, 5, 4, 1), bf16)]
    worst = worst_abs = 0.0
    for name, (b, hp, wp, cin, cout, k), dt in cases:
        x, dy = _wgrad_case(torch, rng, b, hp, wp, cin, cout, k, dt)
        got = cw.wgrad_cuda(x, dy, k)
        check(cw.last_tensor_core == (dt == bf16),
              f"wgrad {name} {dt}: not on the {dt} route")
        again = cw.wgrad_cuda(x, dy, k)
        want = cw.wgrad_plain(x, dy, k)
        torch.cuda.synchronize()
        check(got.shape == (k, k, cin, cout) and got.dtype == f32,
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

    # timing: the kernel from a CUDA graph (its device time) and eagerly,
    # in turns with the plain version (eager: 49 einsums); cuDNN both ways
    b, hp, wp, cin, cout, k = TAIL
    x, dy = _wgrad_case(torch, rng, b, hp, wp, cin, cout, k, bf16)

    def kernel():
        return cw.wgrad_cuda(x, dy, k)

    def plain():
        return cw.wgrad_plain(x, dy, k)
    ms = {"ms": [], "plain_ms": []}
    for key in ("plain_ms", "ms", "ms", "plain_ms"):          # in turns
        ms[key].append(graph_ms(torch, kernel) if key == "ms"
                       else cuda_ms(torch, plain, iters=10, warmup=3))
    eager_ms = cuda_ms(torch, kernel, iters=50, warmup=3)
    xn, dn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)

    def library():
        return torch.nn.grad.conv2d_weight(xn, (cout, cin, k, k), dn)
    library_ms = graph_ms(torch, library)
    library_eager_ms = cuda_ms(torch, library, iters=50, warmup=3)
    h, w = hp - k + 1, wp - k + 1
    flops = 2 * k * k * cin * cout * b * h * w
    nbytes = 2 * (x.numel() + dy.numel()) + 4 * k * k * cin * cout
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    out = {"name": "wgrad", "route": "cuda",
           "source": "pcgan_tpu_torch/csrc/wgrad.cu",
           "replaces": "pcgan_tpu/ops/pallas_wgrad.py:82",
           "max_abs_err": worst_abs, "max_err_of_max_plain": worst,
           "ms": min(ms["ms"]), "eager_ms": eager_ms,
           "cold_ms": cold_ms(torch, kernel),
           "plain_ms": min(ms["plain_ms"]), "library_ms": library_ms,
           "library_eager_ms": library_eager_ms,
           "library_cold_ms": cold_ms(torch, library),
           "library": "torch.nn.grad.conv2d_weight (cuDNN), bf16",
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bound_peaks": "3.35 TB/s HBM3; 989 TFLOP/s bf16 tensor cores",
           "flops": flops, "bytes": nbytes,
           "shape": f"x_pad {TAIL[:4]} bf16, dy C_out {cout}, k {k}",
           "timing": TIMING_NOTE,
           "timings_in_turns_ms": ms}
    say(f"wgrad timing: {json.dumps(out)}")
    return out


# G's 256 px sites on its 2B = 64 rows (pcgan_cacd256): the stem (and the
# last up conv) and the trunk (the blocks' second norm adds the residual);
# then D's leaky sites on 64 rows, whose 31 x 31 planes take the 2-byte
# loads
NORM_SHAPES = {"stem_256": ((64, 64, 256, 256), "relu", False),
               "trunk_256": ((64, 256, 64, 64), "relu", False),
               "trunk_256_residual": ((64, 256, 64, 64), "none", True),
               "d1_256": ((64, 128, 64, 64), "leaky", False),
               "d2_256": ((64, 256, 32, 32), "leaky", False),
               "d3_256": ((64, 512, 31, 31), "leaky", False)}


def phase_norm_check(torch) -> dict:
    """The fused instance norm (``ops/cuda_instance_norm.py``) against its
    plain version at G's 256 px stem and trunk shapes, forward and
    backward, then timed there, each direction beside its bytes bound, the
    plain version and ``torch.nn.functional.instance_norm`` (the library
    yardstick, never called by the port)."""
    from pcgan_tpu_torch.ops import cuda_instance_norm as cin
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(2)
    rows = {}
    for name, (shape, act, residual) in NORM_SHAPES.items():
        def rand():
            return (torch.randn(shape, device=DEV, generator=gen) * 1.5
                    + 0.5).to(torch.bfloat16)
        x, g = rand(), rand()
        res = rand() if residual else None
        out, stats = cin.forward_cuda(x, act, res)
        dx = cin.backward_cuda(x, g, stats, act)
        want, want_stats = cin.plain_forward(x, act, res)
        same = cin.plain_forward(x, act, res, stats=stats)[0]
        want_dx = cin.plain_backward(x, g, stats, act)
        again = cin.backward_cuda(x, g, cin.forward_cuda(x, act, res)[1],
                                  act)
        torch.cuda.synchronize()
        check(bool(torch.equal(dx, again)), f"norm {name}: two runs differ")
        # from the kernel's moments the plain output has the kernel's bits;
        # from its own, a norm output may round the other way (one ulp of
        # it, many of a residual sum that cancels it)
        check(bool(torch.equal(out, same)),
              f"norm {name}: the output differs from the plain version's "
              f"from the same moments")
        mean, rstd = want_stats[0], want_stats[1]
        stats_err = float(torch.maximum(
            (stats[0] - mean).abs() / (mean.abs() + 1 / rstd),
            (stats[1] - rstd).abs() / (rstd * (1 + (mean * rstd) ** 2)))
            .max())
        w, wd = want.float().cpu().numpy(), want_dx.float().cpu().numpy()
        ulps = float((np.abs(out.float().cpu().numpy() - w)
                      / bf16_ulp(w)).max())
        scale = np.abs(wd).max(axis=(2, 3), keepdims=True) * 2.0 ** -7
        a = np.maximum(np.abs(wd), scale)
        ulps_dx = float((np.abs(dx.float().cpu().numpy() - wd)
                         / 2.0 ** (np.floor(np.log2(a)) - 7)).max())
        check(stats_err <= 1e-5 and ulps_dx <= 1.0,
              f"norm {name}: moments {stats_err:.3g} (of the plain "
              f"version's scale), backward {ulps_dx} ulp of the plain "
              f"version")
        del want, same, want_dx, again

        def fwd():
            return cin.forward_cuda(x, act, res)

        def bwd():
            return cin.backward_cuda(x, g, stats, act)

        def plain_fwd():
            return cin.plain_forward(x, act, res)

        def plain_bwd():
            return cin.plain_backward(x, g, stats, act)
        xl = x.detach().requires_grad_()

        def library():
            return F.instance_norm(x, eps=1e-5)

        def library_fwd_bwd():
            return torch.autograd.grad(F.instance_norm(xl, eps=1e-5), xl, g)
        n, c = shape[:2]
        numel = x.numel()
        fwd_bytes = 2 * numel * (3 if residual else 2) + 12 * n * c
        bwd_bytes = 6 * numel + 12 * n * c
        row = {"shape": list(shape), "act": act, "residual": residual,
               "stats_err": stats_err, "max_ulp_fwd_own_moments": ulps,
               "max_ulp_bwd": ulps_dx}
        for key, fn, plain, nbytes in (("fwd", fwd, plain_fwd, fwd_bytes),
                                       ("bwd", bwd, plain_bwd, bwd_bytes)):
            turns = {"ms": [], "plain_ms": []}
            for k in ("plain_ms", "ms", "ms", "plain_ms"):      # in turns
                turns[k].append(graph_ms(torch, fn) if k == "ms"
                                else cuda_ms(torch, plain, iters=20,
                                             warmup=3))
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            ms = min(turns["ms"])
            row[key] = {"ms": ms, "eager_ms": cuda_ms(torch, fn),
                        "cold_ms": cold_ms(torch, fn),
                        "plain_ms": min(turns["plain_ms"]),
                        "bound_ms": bound, "bound_by": "bytes",
                        "bytes": nbytes, "of_bound": ms / bound,
                        "timings_in_turns_ms": turns}
        row["fwd"]["library_ms"] = graph_ms(torch, library)
        row["fwd"]["library_eager_ms"] = cuda_ms(torch, library)
        row["bwd"]["library_fwd_bwd_eager_ms"] = cuda_ms(
            torch, library_fwd_bwd, iters=50, warmup=3)
        rows[name] = row
        say(f"norm {name}: {json.dumps(row)}")
        del x, g, res, out, dx, stats, xl
        torch.cuda.empty_cache()
    out = {"name": "instance_norm", "route": "cuda",
           "source": "pcgan_tpu_torch/csrc/instance_norm.cu",
           "replaces": "none (XLA fused it; the port's bf16 composite, "
                       "models/layers.py instance_norm)",
           "library": "torch.nn.functional.instance_norm (bf16), forward; "
                      "forward + backward eager",
           "bound_peaks": "3.35 TB/s HBM3", "timing": TIMING_NOTE,
           "shapes": rows}
    say(f"norm timing: {json.dumps(out)}")
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


def _epoch_rates(epochs) -> dict:
    """Steps/s over the epochs after the first (pooled), and each epoch's
    with their min, median and max: the spread of the rate."""
    later = epochs[1:]
    each = [e["steps"] / e["train_seconds"] for e in later]
    return {"pooled": sum(e["steps"] for e in later)
            / sum(e["train_seconds"] for e in later),
            "epochs": each, "min": min(each), "median": float(np.median(each)),
            "max": max(each)}


def _rates_str(r, batch) -> str:
    return (f"{r['pooled']:.3f} steps/s = {batch * r['pooled']:.1f} images/s "
            f"(per epoch min / median / max {r['min']:.3f} / "
            f"{r['median']:.3f} / {r['max']:.3f})")


def _train_run(torch, argv):
    """One run of path 1 with every launch count zeroed just before and
    read just after; the fused norm's is ``res["norm_launches"]``."""
    from pcgan_tpu_torch import train_main
    from pcgan_tpu_torch.ops import cuda_instance_norm as cin
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    cp.launches = cw.launches = cin.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = train_main.main(argv)
    torch.cuda.synchronize()
    res["norm_launches"] = cin.launches
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
    # the fused norm, each way, at every site of one G call and two D calls
    # a step (the D step's real and fake share one 2B pass; the G step)
    sites = _norm_sites(g0) + 2 * _norm_sites(d0)
    norm = res["norm_launches"]
    check(norm == 2 * sites * steps > 0,
          f"path 1: {norm} fused norm launches for {steps} steps of "
          f"{sites} sites")
    later = res["epochs"][1:]
    steps_per_s = sum(e["steps"] for e in later) / sum(
        e["train_seconds"] for e in later)
    out = {"steps": steps, "b1_launches": b1, "b2_launches": b2,
           "norm_launches": norm, "norm_sites_per_step": sites,
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
    check(res2["norm_launches"] == 2 * sites * 8,
          f"path 1 resume: {res2['norm_launches']} fused norm launches for "
          f"8 steps of {sites} sites")
    out["resume"] = {"step": res2["step"], "b1_launches": b1r,
                     "norm_launches": res2["norm_launches"],
                     "metrics": res2["metrics"]}
    out["profile"] = _profile_train(torch, tmp)
    out["launches_per_run"] = {"train": b1, "resume": b1r,
                               "profile": out["profile"]["launches"]}
    out["norm_launches_per_run"] = {
        "train": norm, "resume": res2["norm_launches"],
        "profile": out["profile"]["norm_launches"]}
    return out


def _profile_train(torch, tmp, steps: int = 4, argv=None,
                   what: str = "training") -> dict:
    """Path 1 (or ``argv``'s run) under torch.profiler: a fresh run of two
    epochs of 4 steps. Device ms per step by kernel is averaged over all 8
    steps; the step window is the second epoch's (first batch to the last
    step done), when the synthetic images are cached as in steady training.
    The run's checkpoint writes (and a comparator run's anchor bundle) are
    stubbed out, so the trace holds data, preprocessing, the steps and the
    print points."""
    from torch.profiler import ProfilerActivity, profile
    from pcgan_tpu_torch import train_main
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    if argv is None:
        argv = _train_argv(tmp, "smoke_train_profile", niter=2,
                           size=8 * steps)
    saved = (ckpt.save_state, ckpt.save_generator, ckpt.save_comparator_state,
             train_main._save_anchor_bundle)
    ckpt.save_state = ckpt.save_generator = lambda *a, **k: None
    ckpt.save_comparator_state = lambda *a, **k: None
    train_main._save_anchor_bundle = lambda *a, **k: None
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res, b1, _, _ = _train_run(torch, argv)
    finally:
        (ckpt.save_state, ckpt.save_generator, ckpt.save_comparator_state,
         train_main._save_anchor_bundle) = saved
    n = 2 * steps
    check(b1 == n == res["step"],
          f"{what} profile run: {b1} B1 launches for {res['step']} steps")
    rows = _device_rows(torch, prof, n)
    device_ms = sum(r[0] for r in rows)
    window_ms = res["epochs"][1]["train_seconds"] * 1e3 / steps
    check(device_ms > 0, f"{what} profile run: no device time traced")
    out = {"launches": b1, "norm_launches": res["norm_launches"],
           "device_ms_per_step": device_ms,
           "window_ms_per_step": window_ms,
           "device_busy_share": device_ms / window_ms,
           "device_launches_per_step": sum(r[1] for r in rows),
           "preprocess_kernel_ms_per_step": sum(
               r[0] for r in rows if "preprocess_kernel" in r[2]),
           "top_kernels_ms_per_step": [[round(ms, 4), cnt, name[:100]]
                                       for ms, cnt, name in rows[:20]],
           "nccl_ms_per_step": [[round(ms, 4), cnt, name[:100]]
                                for ms, cnt, name in rows
                                if "nccl" in name.lower()],
           # the host side of the collectives (c10d's "<backend>:<op>"
           # records): NCCL launches no kernel for an in-place all-reduce
           # of one rank
           "collectives_per_step": {
               e.key: e.count / n for e in prof.key_averages()
               if e.key.startswith(("nccl:", "gloo:"))}}
    say(f"{what} profile (2 epochs of {steps} steps, "
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


# --------------------------------------------------------------------------- #
# the comparator slice: path 3 (pretraining) and path 1 with the comparator
# --------------------------------------------------------------------------- #

# the default comparator (--cmp_nf 64 --cmp_n_down 4), batch 8 pairs, 160
# base images: 160 pairs, 16 held out, 18 steps an epoch
CMP_SIZE, CMP_STEPS, CMP_HELD_OUT = 160, 18, 16
COND_TOL = 1e-4              # f32 comparator / cond-loss step, card vs CPU
COND_EPOCHS = 6              # phase 11's rate: epochs 2-6, 40 steps


def _cmp_argv(tmp, name, niter, size=CMP_SIZE, extra=()):
    return ["--model", "comparator", "--dataset_mode", "pairwise",
            "--cmp_nf", "64", "--cmp_n_down", "4", "--norm", "instance",
            "--load_size", str(LOAD), "--crop_size", str(CROP),
            "--batch_size", "8", "--dtype", "bfloat16",
            "--max_dataset_size", str(size), "--n_age_bins", str(NB),
            "--lr_policy", "linear", "--niter", str(niter),
            "--niter_decay", "0", "--save_epoch_freq", "1",
            "--print_freq", "6", "--name", name,
            "--checkpoints_dir", os.path.join(tmp, "cmp"), *extra]


def phase_path3(torch, tmp) -> dict:
    """Comparator pretraining at full width, its outputs and resume, the
    pair rate after the first epoch, and a profiled 2 x 4-step run."""
    name = "smoke_cmp"
    run = os.path.join(tmp, "cmp", name)
    res, b1, b2, wall = _train_run(torch, _cmp_argv(tmp, name, niter=2))
    steps = res["step"]
    check(steps == 2 * CMP_STEPS
          and [e["steps"] for e in res["epochs"]] == [CMP_STEPS] * 2,
          f"path 3: {steps} steps, epochs {res['epochs']}")
    # one B1 launch per step (both members in one 2B call), one per
    # held-out batch of 8 pairs each epoch, one per anchor batch of 8
    want_b1 = steps + 2 * (CMP_HELD_OUT // 8) + CMP_SIZE // 8
    check(b1 == want_b1 and b2 == 0,
          f"path 3: {b1} B1 launches (want {want_b1}), {b2} B2 launches")
    # the fused norm at every comparator site: forward and backward a step
    # (one 2B call), forward only for each held-out batch of 8 pairs each
    # epoch and for the one anchor call
    sites = _norm_sites(_seeded_C(torch, _cmp_argv(tmp, name, niter=2)))

    def want_norm(steps, epochs):
        return sites * (2 * steps + epochs * (CMP_HELD_OUT // 8) + 1)
    norm = res["norm_launches"]
    check(norm == want_norm(steps, 2) > 0,
          f"path 3: {norm} fused norm launches, want {want_norm(steps, 2)}")
    files = set(os.listdir(run))
    want = {"comparator.pt", "cmp_latest.pt", "cmp_epoch_1.pt",
            "cmp_epoch_2.pt", "metrics.jsonl", "opt.json"}
    check(want <= files, f"path 3: missing {sorted(want - files)}")
    check(res["eval_acc"] is not None and np.isfinite(res["eval_acc"]),
          f"path 3: held-out accuracy {res['eval_acc']}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        for k in ("loss_cmp", "acc_cmp", "eval_acc_cmp"):
            if k in r:
                check(bool(np.isfinite(r[k])), f"path 3: {k} {r[k]}")
    bundle = torch.load(os.path.join(run, "comparator.pt"),
                        weights_only=True)
    lo, hi, means = (bundle[k].numpy() for k in ("bin_lo", "bin_hi",
                                                 "bin_means"))
    check(bool(np.all(np.diff(means) >= 0)), f"path 3: means {means}")
    check(lo[0] == -1e30 and hi[-1] == 1e30
          and bool(np.array_equal(lo[1:], hi[:-1])),
          f"path 3: intervals do not tile the score axis: {lo} {hi}")
    check(bool(np.isfinite(means).all()) and means[-1] > means[0],
          f"path 3: degenerate anchors {means}")
    second = res["epochs"][1]
    pairs_per_s = 8 * second["steps"] / second["train_seconds"]
    out = {"steps": steps, "b1_launches": b1, "norm_launches": norm,
           "cli_wall_s": wall,
           "epochs": res["epochs"], "pairs_per_s": pairs_per_s,
           "eval_acc": res["eval_acc"], "last_metrics": res["metrics"],
           "bin_means": means.tolist()}
    say(f"path 3: {steps} steps in {wall:.2f} s (CLI wall incl. eval, "
        f"anchors, checkpoints); epoch 2 ({second['steps']} steps) "
        f"{pairs_per_s:.2f} pairs/s (batch 8, bf16, 2.9 M params); "
        f"held-out accuracy {res['eval_acc']}; B1 launches {b1}; bin means "
        f"{[round(m, 4) for m in means.tolist()]}")
    res2, b1r, _, _ = _train_run(
        torch, _cmp_argv(tmp, name, niter=3, extra=("--continue_train",)))
    check(res2["step"] == 3 * CMP_STEPS
          and [e["epoch"] for e in res2["epochs"]] == [3],
          f"path 3 resume: step {res2['step']}, epochs {res2['epochs']}")
    want_b1 = CMP_STEPS + CMP_HELD_OUT // 8 + CMP_SIZE // 8
    check(b1r == want_b1, f"path 3 resume: {b1r} B1 launches, want {want_b1}")
    check(res2["norm_launches"] == want_norm(CMP_STEPS, 1),
          f"path 3 resume: {res2['norm_launches']} fused norm launches, "
          f"want {want_norm(CMP_STEPS, 1)}")
    out["resume"] = {"step": res2["step"], "b1_launches": b1r,
                     "norm_launches": res2["norm_launches"],
                     "eval_acc": res2["eval_acc"]}
    # profiled: 32 pairs, none held out, 4 steps an epoch
    out["profile"] = _profile_train(
        torch, tmp, argv=_cmp_argv(tmp, "smoke_cmp_profile", niter=2,
                                   size=32, extra=("--cmp_eval_frac", "0")),
        what="comparator")
    out["launches_per_run"] = {"pretrain": b1, "resume": b1r,
                               "profile": out["profile"]["launches"]}
    out["norm_launches_per_run"] = {
        "pretrain": norm, "resume": res2["norm_launches"],
        "profile": out["profile"]["norm_launches"]}
    out["bundle_dir"] = run
    return out


def _capture_comparator():
    """Wraps ``load_comparator_bundle`` so the frozen C a run loads can be
    read after it; returns (the list it lands in, the restore callable)."""
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    loaded, orig = [], ckpt.load_comparator_bundle

    def load(*a, **k):
        out = orig(*a, **k)
        loaded.append(out[0])
        return out
    ckpt.load_comparator_bundle = load

    def restore():
        ckpt.load_comparator_bundle = orig
    return loaded, restore


def phase_path1_cond(torch, tmp, bundle_dir, plain_profile) -> dict:
    """The phase-8 GAN with the frozen comparator at --lambda_cond 10, then
    one epoch in score mode and its score-sweep grid."""
    from pcgan_tpu_torch import test as port_test
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    cond = ("--comparator_path", bundle_dir, "--lambda_cond", "10",
            "--cmp_nf", "64", "--cmp_n_down", "4")
    bundle = torch.load(os.path.join(bundle_dir, "comparator.pt"),
                        weights_only=True)
    out = {}
    for mode, niter in (("onehot", COND_EPOCHS), ("score", 1)):
        name = f"smoke_cond_{mode}"
        loaded, restore = _capture_comparator()
        try:
            res, b1, b2, wall = _train_run(torch, _train_argv(
                tmp, name, niter=niter,
                extra=cond + ("--cond_mode", mode)))
        finally:
            restore()
        steps = res["step"]
        check(steps == 8 * niter and b1 == steps,
              f"path 1 cond {mode}: {steps} steps, {b1} B1 launches")
        with open(os.path.join(tmp, "train", name, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        conds = [r["loss_G_cond"] for r in rows]
        check(len(rows) == steps // 4 and all(
            np.isfinite(c) and c != 0.0 for c in conds),
            f"path 1 cond {mode}: loss_G_cond {conds}")
        check(len(loaded) == 1, f"path 1 cond {mode}: C loaded "
              f"{len(loaded)} times")
        sd = loaded[0].state_dict()
        check(next(loaded[0].parameters()).device.type == DEV
              and all(torch.equal(sd[k].cpu(), v)
                      for k, v in bundle["C"].items()),
              f"path 1 cond {mode}: C changed or is off the card")
        out[mode] = {"steps": steps, "b1_launches": b1, "b2_launches": b2,
                     "cli_wall_s": wall, "epochs": res["epochs"],
                     "loss_G_cond": conds, "last_metrics": res["metrics"]}
    rates = _epoch_rates(out["onehot"]["epochs"])
    out["onehot"].update(steps_per_s=rates["pooled"], rates=rates)
    say(f"path 1 with C: epochs 2-{COND_EPOCHS} ({8 * (COND_EPOCHS - 1)} "
        f"steps) {_rates_str(rates, 8)} (bf16, batch 8, lambda_cond 10); "
        f"loss_G_cond "
        f"{out['onehot']['loss_G_cond']}; score mode loss_G_cond "
        f"{out['score']['loss_G_cond']}; C bit-identical after both runs")
    prof = _profile_train(torch, tmp, argv=_train_argv(
        tmp, "smoke_cond_profile", niter=2, size=32, extra=cond),
        what="training with C")
    out["profile"] = prof
    out["cond_cost"] = {
        "device_ms_per_step": [plain_profile["device_ms_per_step"],
                               prof["device_ms_per_step"]],
        "launches_per_step": [plain_profile["device_launches_per_step"],
                              prof["device_launches_per_step"]],
        "window_ms_per_step": [plain_profile["window_ms_per_step"],
                               prof["window_ms_per_step"]]}
    say(f"the cond loss on the card (phase 8 -> with C, same call): "
        f"{json.dumps(out['cond_cost'])}")

    # the score-sweep grid of the score-mode checkpoint
    cp.launches = 0
    argv = ["--dataset_mode", "synthetic", "--max_dataset_size", "8",
            "--num_test", "8", "--batch_size", "8", "--name",
            "smoke_cond_score", "--checkpoints_dir", os.path.join(tmp, "train"),
            "--results_dir", os.path.join(tmp, "res"), "--device", DEV]
    res = port_test.main(argv)
    torch.cuda.synchronize()
    pngs = os.listdir(os.path.join(res["web_dir"], "images"))
    cols = sorted((n for n in pngs if n.startswith("0000_score_")),
                  key=lambda n: float(n[11:-4]))
    check(res["done"] == 8 and len(cols) == NB
          and len(pngs) == 8 * (1 + NB) and cp.launches == 1,
          f"score grid: {res['done']} rows, columns {cols}, {len(pngs)} "
          f"PNGs, {cp.launches} B1 launches")
    out["score_grid"] = {"columns": [c[5:-4] for c in cols],
                         "b1_launches": cp.launches}
    say(f"score grid: 8 rows x {NB} columns {out['score_grid']['columns']}")
    out["launches_per_run"] = {"onehot": out["onehot"]["b1_launches"],
                               "score": out["score"]["b1_launches"],
                               "profile": prof["launches"],
                               "score_grid": cp.launches}
    return out


def _scaled_comparator(torch, cfg, seed):
    """A seeded C with its Dense kernels 20x their init, so the scores are
    O(1) and the losses depend on them."""
    from pcgan_tpu_torch.models import define_C
    C = define_C(cfg, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        C.fc.weight.mul_(20.0)
        C.head.weight.mul_(20.0)
    return C


def phase_cond_parity(torch) -> dict:
    """One f32 comparator step and one f32 GAN step with the cond loss
    (pinned target bins, pool off), card against CPU from the same seeded
    weights: every loss within 1e-4."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.train import (create_comparator_state,
                                       create_train_state,
                                       make_comparator_step, make_train_step)
    small = ["--crop_size", "32", "--load_size", "32", "--batch_size", "4",
             "--n_age_bins", "4", "--dtype", "float32", "--lr_policy",
             "constant", "--cmp_nf", "16", "--cmp_n_down", "3"]
    rng = np.random.default_rng(6)

    def img(n):
        return torch.from_numpy(rng.uniform(-1, 1, (n, 32, 32, 3)).astype(
            np.float32))
    out = {}
    cfg = parse_config(small + ["--model", "comparator"])
    pairs = {"image_a": img(4), "image_b": img(4),
             "label": torch.from_numpy(rng.integers(0, 3, 4))}
    runs = {}
    for dev in ("cpu", DEV):
        C = _scaled_comparator(torch, cfg, 5).to(dev)
        state = create_comparator_state(cfg, C, torch.Generator())
        m = make_comparator_step(cfg, C)(
            state, {k: v.to(dev) for k, v in pairs.items()})
        runs[dev] = {k: float(v) for k, v in m.items()}
    err = max(abs(runs["cpu"][k] - runs[DEV][k]) for k in runs["cpu"])
    check(err <= COND_TOL, f"comparator parity: {runs}")
    out["comparator_step"] = {"max_abs_err": err, "card": runs[DEV]}

    cfg = parse_config(small + ["--netG", "resnet_6blocks", "--ngf", "16",
                                "--ndf", "16", "--pool_size", "0",
                                "--cond_inject", "bottleneck",
                                "--lambda_cond", "10"])
    batch = {"image": img(4), "bin": torch.from_numpy(rng.integers(0, 4, 4)),
             "target_bin": torch.from_numpy(rng.integers(0, 4, 4))}
    runs = {}
    for dev in ("cpu", DEV):
        C = _scaled_comparator(torch, cfg, 5)
        with torch.no_grad():
            mu = C(batch["image"])[0]
        means = torch.sort(mu)[0]
        mid = 0.5 * (means[1:] + means[:-1])
        anchors = (torch.cat([torch.tensor([-1e30]), mid]),
                   torch.cat([mid, torch.tensor([1e30])]), means)
        state = create_train_state(
            cfg, define_G(cfg, torch.Generator().manual_seed(7)).to(dev),
            define_D(cfg, torch.Generator().manual_seed(8)).to(dev),
            torch.Generator().manual_seed(0), C=C, bin_anchors=anchors)
        m = make_train_step(cfg, state.G, state.D, state.C)(
            state, {k: v.to(dev) for k, v in batch.items()})
        runs[dev] = {k: float(v) for k, v in m.items()}
    err = max(abs(runs["cpu"][k] - runs[DEV][k]) for k in runs["cpu"])
    check(err <= COND_TOL and runs[DEV]["loss_G_cond"] != 0.0,
          f"cond-loss step parity: {runs}")
    out["gan_step_with_C"] = {"max_abs_err": err, "card": runs[DEV]}
    say(f"comparator parity (f32, TF32 off, cmp_nf 16, 32 px, batch 4, one "
        f"step each): {json.dumps(out)}")
    return out


# --------------------------------------------------------------------------- #
# real images: the host decoder (phase 13), path 4 (phase 14) and the
# label-free comparator inputs (phase 15)
# --------------------------------------------------------------------------- #

FIXTURES = os.path.join(HERE, "tests", "torch_port_data")
AGE_SHIFTS = (0, 7, 14, 21)      # four names per fixture: 128 images
REAL_B, REAL_STEPS = 32, 4       # train_utkface_128.sh's batch: 4 steps/epoch
REAL_EPOCHS = 6                  # path 4's rate: epochs 2-6, 20 steps


def _fixture_canvases():
    """``make_faces.canvases()``: each fixture's (UTKFace stem, source image,
    kind), made from the port's seeded synthetic canvases without Pillow."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_faces", os.path.join(FIXTURES, "make_faces.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return list(mod.canvases())


def _real_folder(tmp, png: bool):
    """The 32 fixtures under four age-shifted UTKFace names each: the
    committed JPEGs, or, on a host without libjpeg, their source canvases
    written as PNGs by the port's encoder. Returns (folder, {file name: the
    RGB image its decode must give} for the PNGs, else None)."""
    from pcgan_tpu_torch.utils.visualizer import encode_png
    folder = os.path.join(tmp, "faces_png" if png else "faces")
    os.makedirs(folder)
    files, want = [], {} if png else None
    if png:
        for stem, img, _ in _fixture_canvases():
            rgb = np.repeat(img[..., None], 3, 2) if img.ndim == 2 else img
            files.append((stem, ".png", encode_png(img), rgb))
    else:
        for name in sorted(os.listdir(os.path.join(FIXTURES, "faces"))):
            with open(os.path.join(FIXTURES, "faces", name), "rb") as f:
                files.append((name[:-4], ".jpg", f.read(), None))
    for stem, ext, data, rgb in files:
        age, gender, race, stamp = stem.split("_")
        for k, shift in enumerate(AGE_SHIFTS):
            name = f"{int(age) + shift}_{gender}_{race}_{stamp[:-1]}{k}{ext}"
            with open(os.path.join(folder, name), "wb") as f:
                f.write(data)
            if png:
                want[name] = rgb
    return folder, want


def _check_jpeg_fixtures() -> dict:
    """The committed JPEGs decode to their Pillow digests, bit for bit."""
    import hashlib
    from pcgan_tpu_torch import native
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        meta = json.load(f)
    names = sorted(meta["files"])
    paths = [os.path.join(FIXTURES, "faces", n) for n in names]
    imgs, st = native.decode_batch(paths, 200, 200, threads=8)
    check(not st.any(), f"decoder: status {st.tolist()}")
    differ = [n for n, img in zip(names, imgs) if hashlib.sha256(
        img.tobytes()).hexdigest() != meta["files"][n]["sha256"]]
    out = {"fixtures": len(names), "sha256_differ": differ,
           "libjpeg_abi": native.jpeg_abi(),
           "libjpeg_turbo": native.jpeg_turbo_version()}
    check(not differ, f"decoder: {len(differ)} of {len(names)} fixtures "
          f"decode to other bits than Pillow's (libjpeg ABI "
          f"{out['libjpeg_abi']}, libjpeg-turbo {out['libjpeg_turbo'] or 'no'})"
          f": {differ}")
    say(f"decoder: {len(names)} JPEG fixtures bit-identical to their digests")
    return out


def _check_png_copies(ds, want, jpeg_ok) -> dict:
    """Every PNG copy decodes to the canvas written into it; without
    libjpeg (``jpeg_ok`` False) the port's JPEG decode raises, naming it."""
    from pcgan_tpu_torch import native
    from pcgan_tpu_torch.data.utkface import UTKFaceDataset
    raised = None
    if not jpeg_ok:
        try:
            UTKFaceDataset(os.path.join(FIXTURES, "faces")).get_raw_batch([0])
            raised = ""
        except native.JpegUnavailable as e:
            raised = str(e)
        check("libjpeg" in raised,
              f"decoder: a JPEG folder without libjpeg gave {raised!r}")
    imgs = ds.get_raw_batch(np.arange(len(ds)), num_threads=8)["image"]
    for p, img in zip(ds.paths, imgs):
        check(np.array_equal(img, want[os.path.basename(p)]),
              f"decoder: {p} does not decode to the canvas written")
    say(("" if jpeg_ok else "decoder: no libjpeg on this host, a JPEG folder "
         "raises JpegUnavailable; ") + f"{len(want)} PNG copies of the "
        f"fixtures decode to their canvases bit for bit")
    return {"fixtures": len(want) // len(AGE_SHIFTS), "png_exact": True,
            "jpeg_raises": raised}


def phase_decoder(folder, want, jpeg_ok=False) -> dict:
    """The fixtures against their committed digests (JPEG) or the canvases
    written (PNG, ``want``), batch against single decodes, and the decode
    rate over the 128 images at 1 and 8 threads."""
    from pcgan_tpu_torch.data.utkface import UTKFaceDataset
    ds = UTKFaceDataset(folder)
    check(len(ds) == 32 * len(AGE_SHIFTS) and ds.native == 200,
          f"decoder: folder of {len(ds)} at {ds.native} px")
    out = _check_jpeg_fixtures() if want is None else _check_png_copies(
        ds, want, jpeg_ok)
    idx = np.arange(len(ds))
    batch = ds.get_raw_batch(idx, num_threads=8)["image"]
    for i in idx:
        check(np.array_equal(batch[i], ds.get_raw(int(i))["image"]),
              f"decoder: batch and single decode differ at {ds.paths[i]}")
    rates = {}
    for threads in (1, 8, 1, 8):
        t0 = time.perf_counter()
        ds.get_raw_batch(idx, num_threads=threads)
        rates.setdefault(str(threads), []).append(
            len(ds) / (time.perf_counter() - t0))
    kind = "JPEG, libjpeg" if want is None else "PNG, numpy"
    out.update(format=kind, images=len(ds), images_per_s=rates,
               nproc=os.cpu_count(), affinity=len(os.sched_getaffinity(0)))
    say(f"decoder: batch == single over {len(ds)} images; images/s (200 px "
        f"{kind}, twice each) {json.dumps(rates)} on nproc {out['nproc']} "
        f"(affinity {out['affinity']})")
    return out


def _real_argv(tmp, folder, name, niter, extra=()):
    """train_utkface_128.sh's flags: only --dataroot, the epochs and the
    cadences differ; bf16 as phase 8."""
    return ["--dataroot", folder, "--name", name, "--model", "pcgan",
            "--dataset_mode", "aging", "--netG", NETG, "--netD", "basic",
            "--norm", "instance", "--load_size", str(LOAD), "--crop_size",
            str(CROP), "--batch_size", str(REAL_B), "--n_age_bins", str(NB),
            "--gan_mode", "lsgan", "--lambda_L1", "100", "--lambda_cond",
            "10", "--lr", "0.0002", "--beta1", "0.5", "--pool_size", "64",
            "--mesh_shape", "1", "--dtype", "bfloat16",
            "--niter", str(niter), "--niter_decay", "0", "--print_freq", "2",
            "--save_epoch_freq", "1",
            "--checkpoints_dir", os.path.join(tmp, "real"), *extra]


def _batches_drawn():
    """Wraps the folder dataset's batch decode so the indices each run
    draws can be read after it; returns (the list, the restore callable)."""
    from pcgan_tpu_torch.data.utkface import UTKFaceDataset
    drawn, orig = [], UTKFaceDataset.get_raw_batch

    def spy(self, idx, num_threads=8):
        drawn.append(np.asarray(idx).copy())
        return orig(self, idx, num_threads)
    UTKFaceDataset.get_raw_batch = spy

    def restore():
        UTKFaceDataset.get_raw_batch = orig
    return drawn, restore


def _check_cond_rows(run_dir, what):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        for k in ("loss_G", "loss_D", "loss_G_cond"):
            check(bool(np.isfinite(r[k])), f"{what}: {k} {r[k]}")
        # a Gaussian NLL with 0.5 log_var: non-zero, of either sign
        check(r["loss_G_cond"] != 0.0, f"{what}: loss_G_cond is 0")
    return [r["loss_G_cond"] for r in rows]


def phase_path4(torch, tmp, folder, bundle_dir, cond_rates) -> dict:
    """Path 4, real images at full width: train_utkface_128.sh's run
    (REAL_EPOCHS epochs and 1 resumed, then a profiled 2 x 4-step run),
    test_aging_grid.sh's grids over the folder, a pack of the folder and
    one packed epoch, sort_unlabeled with phase 10's bundle and one sorted
    epoch."""
    from pcgan_tpu_torch import test as port_test
    from pcgan_tpu_torch.data.packed import PackedDataset
    from pcgan_tpu_torch.data.utkface import UTKFaceDataset
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.tools import pack_dataset, sort_unlabeled
    cond = ("--comparator_path", bundle_dir)
    name = "real_utk128"
    run = os.path.join(tmp, "real", name)
    res, b1, b2, wall = _train_run(torch, _real_argv(
        tmp, folder, name, REAL_EPOCHS, cond))
    steps = res["step"]
    check(steps == REAL_EPOCHS * REAL_STEPS and b1 == steps and b2 == 0
          and [e["steps"] for e in res["epochs"]]
          == [REAL_STEPS] * REAL_EPOCHS,
          f"path 4: {steps} steps, {b1} B1 / {b2} B2 launches, epochs "
          f"{res['epochs']}")
    conds = _check_cond_rows(run, "path 4")
    rates = _epoch_rates(res["epochs"])
    ratio = rates["pooled"] / cond_rates["pooled"]
    out = {"steps": steps, "b1_launches": b1, "cli_wall_s": wall,
           "epochs": res["epochs"], "steps_per_s": rates["pooled"],
           "images_per_s": REAL_B * rates["pooled"], "rates": rates,
           "phase11_rates_batch8": cond_rates,
           "steps_per_s_vs_phase11": ratio,
           "loss_G_cond": conds, "last_metrics": res["metrics"]}
    with open(os.path.join(run, "opt.json")) as f:
        split = json.load(f)["split"]
    check(split["phase_root"] == folder and split["dataset_len"] == 128,
          f"path 4: split record {split}")
    say(f"path 4: {steps} steps in {wall:.2f} s; epochs 2-{REAL_EPOCHS} "
        f"({REAL_STEPS * (REAL_EPOCHS - 1)} steps of {REAL_B}) "
        f"{_rates_str(rates, REAL_B)} (bf16, with C) beside phase 11's "
        f"{_rates_str(cond_rates, 8)} at batch 8: {ratio:.3f}x its steps/s; "
        f"loss_G_cond {conds}; B1 launches {b1}")

    # resume one epoch: the loader replays the next epoch's seeded
    # permutation (seed 0 + epoch index REAL_EPOCHS)
    drawn, restore = _batches_drawn()
    try:
        res2, b1r, _, _ = _train_run(torch, _real_argv(
            tmp, folder, name, REAL_EPOCHS + 1, cond + ("--continue_train",)))
    finally:
        restore()
    order = np.arange(128)
    np.random.default_rng(REAL_EPOCHS).shuffle(order)
    want = [order[k * REAL_B:(k + 1) * REAL_B] for k in range(REAL_STEPS)]
    check(res2["step"] == (REAL_EPOCHS + 1) * REAL_STEPS and b1r == REAL_STEPS
          and [e["epoch"] for e in res2["epochs"]] == [REAL_EPOCHS + 1]
          and len(drawn) == REAL_STEPS
          and all(np.array_equal(a, b) for a, b in zip(drawn, want)),
          f"path 4 resume: step {res2['step']}, {b1r} B1 launches, epochs "
          f"{res2['epochs']}, batches not the next epoch's permutation")
    out["resume"] = {"step": res2["step"], "b1_launches": b1r,
                     "metrics": res2["metrics"]}
    out["profile"] = _profile_train(
        torch, tmp, steps=REAL_STEPS, what="path 4 (batch 32, with C)",
        argv=_real_argv(tmp, folder, "real_profile", 2, cond))

    # test_aging_grid.sh's flags over the folder
    cp.launches = 0
    argv = ["--dataroot", folder, "--name", name, "--dataset_mode", "aging",
            "--netG", NETG, "--norm", "instance", "--load_size", str(LOAD),
            "--crop_size", str(CROP), "--n_age_bins", str(NB), "--epoch",
            "latest", "--num_test", "50", "--checkpoints_dir",
            os.path.join(tmp, "real"), "--results_dir",
            os.path.join(tmp, "real_res")]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # input injection
        grid = port_test.main(argv)
    torch.cuda.synchronize()
    b1g = cp.launches
    pngs = sorted(n for n in os.listdir(os.path.join(grid["web_dir"],
                                                     "images"))
                  if n.endswith(".png"))
    check(grid["done"] == 50 and len(pngs) == 50 * (1 + NB) and b1g == 7,
          f"path 4 grid: {grid['done']} rows, {len(pngs)} PNGs, {b1g} B1 "
          f"launches")
    for n in pngs:
        img = read_png(os.path.join(grid["web_dir"], "images", n))
        check(img.shape == (CROP, CROP, C), f"path 4 grid: {n} {img.shape}")
    out["grid"] = {"rows": grid["done"], "pngs": len(pngs), "b1_launches": b1g,
                   "batch_seconds": grid["batch_seconds"]}
    say(f"path 4 grid: {grid['done']} rows x {NB} bins, {len(pngs)} PNGs "
        f"decoded; B1 launches {b1g}")

    # a pack of the folder: its rows are the live decode's, bit for bit
    pack = os.path.join(tmp, "pack")
    t0 = time.perf_counter()
    meta = pack_dataset.main(["--dataroot", folder, "--out", pack,
                              "--num_threads", "8"])
    pack_s = time.perf_counter() - t0
    live = UTKFaceDataset(folder)
    rows = PackedDataset(pack)
    check(meta["n"] == 128 and meta["size"] == 200
          and np.array_equal(rows.imgs, live.get_raw_batch(
              np.arange(128))["image"])
          and np.array_equal(rows.ages, live.ages),
          "path 4: the pack's rows differ from the live decode")
    res3, b1p, _, _ = _train_run(torch, _real_argv(
        tmp, pack, "real_packed", 1, cond + ("--dataset_mode", "packed")))
    check(res3["step"] == REAL_STEPS and b1p == REAL_STEPS,
          f"path 4 packed: {res3['step']} steps, {b1p} B1 launches")
    _check_cond_rows(os.path.join(tmp, "real", "real_packed"), "packed")
    out["packed"] = {"pack_s": pack_s, "step": res3["step"],
                     "b1_launches": b1p, "epochs": res3["epochs"]}

    # sort the folder with phase 10's bundle, then one sorted epoch
    cp.launches = 0
    labels = os.path.join(tmp, "labels.csv")
    srt = sort_unlabeled.main(["--dataroot", folder, "--comparator_path",
                               bundle_dir, "--n_age_bins", str(NB),
                               "--out", labels])
    torch.cuda.synchronize()
    b1s = cp.launches
    occ = srt["occupancy"]
    with open(labels) as f:
        lines = f.read().splitlines()
    # quantile bins of 128 scores, each image four times (its age-shifted
    # copies): 12 or 13 a bin, up to 16 where copies share a score
    check(lines[0] == "path,bin,score" and len(lines) == 129
          and [ln.split(",")[0] for ln in lines[1:]] == live.paths
          and all(0 <= int(ln.split(",")[1]) < NB for ln in lines[1:])
          and all(np.isfinite(float(ln.split(",")[2])) for ln in lines[1:])
          and int(occ.sum()) == 128 and occ.min() >= 8 and occ.max() <= 16
          and b1s == 2,
          f"sort_unlabeled: {len(lines)} lines, occupancy {occ.tolist()}, "
          f"{b1s} B1 launches")
    res4, b1t, _, _ = _train_run(torch, _real_argv(
        tmp, folder, "real_sorted", 1,
        cond + ("--dataset_mode", "sorted", "--labels_csv", labels)))
    check(res4["step"] == REAL_STEPS and b1t == REAL_STEPS,
          f"path 4 sorted: {res4['step']} steps, {b1t} B1 launches")
    _check_cond_rows(os.path.join(tmp, "real", "real_sorted"), "sorted")
    out["sorted"] = {"occupancy": occ.tolist(), "b1_sort": b1s,
                     "step": res4["step"], "b1_launches": b1t}
    say(f"path 4 pack: 128 rows of 200 px in {pack_s:.2f} s, equal to the "
        f"live decode; packed epoch {REAL_STEPS} steps; sort_unlabeled "
        f"occupancy {occ.tolist()}; sorted epoch {REAL_STEPS} steps")
    out["launches_per_run"] = {"train": b1, "resume": b1r,
                               "profile": out["profile"]["launches"],
                               "grid": b1g, "packed": b1p,
                               "sort_unlabeled": b1s, "sorted": b1t}
    return out


def phase_path4_png(torch, tmp, png_folder, bundle_dir, jpeg_rates) -> dict:
    """Path 4's rate over the PNG copies of the same faces (the format every
    earlier card run of path 4 read), beside the JPEG folder's in the same
    call."""
    res, b1, _, _ = _train_run(torch, _real_argv(
        tmp, png_folder, "real_png", REAL_EPOCHS,
        ("--comparator_path", bundle_dir)))
    check(res["step"] == REAL_EPOCHS * REAL_STEPS and b1 == res["step"],
          f"path 4 PNG: {res['step']} steps, {b1} B1 launches")
    rates = _epoch_rates(res["epochs"])
    ratio = jpeg_rates["pooled"] / rates["pooled"]
    say(f"path 4 PNG folder: {_rates_str(rates, REAL_B)}; the JPEG folder "
        f"{_rates_str(jpeg_rates, REAL_B)}: {ratio:.3f}x")
    return {"rates": rates, "b1_launches": b1, "jpeg_vs_png": ratio}


def _comparisons_csv(folder, rows=320, seed=0) -> str:
    """pathA,pathB,label rows over the folder, labelled from the names'
    ages (all three labels), one header row, paths relative to the CSV."""
    from pcgan_tpu_torch.data.utkface import list_images, parse_age
    paths = list_images(folder)
    rng = np.random.default_rng(seed)
    lines, seen = ["image_a,image_b,label"], set()
    while len(lines) <= rows or len(seen) < 3:
        a, b = (paths[i] for i in rng.integers(0, len(paths), 2))
        gap = parse_age(a) - parse_age(b)
        lab = 2 if abs(gap) <= 3 else (0 if gap > 0 else 1)
        seen.add(lab)
        lines.append(f"{os.path.relpath(a, os.path.dirname(folder))},"
                     f"{os.path.relpath(b, os.path.dirname(folder))},"
                     f"{('0', 'b', 'tie')[lab]}")
    path = os.path.join(os.path.dirname(folder), "comparisons.csv")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def phase_path3_label_free(torch, tmp, folder) -> dict:
    """pretrain_comparator.sh's flags at the default comparator's width, 1
    epoch: over a comparisons CSV (anchors by score quantiles over its image
    pool) and over the folder's pairs (anchors by age bins)."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.data import loader as data_loader
    from pcgan_tpu_torch.data.pairwise import ComparisonsCSVDataset
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    from pcgan_tpu_torch.train import compute_quantile_anchors
    from pcgan_tpu_torch.utils.checkpoint import load_comparator_bundle
    csv = _comparisons_csv(folder)
    script = ["--model", "comparator", "--load_size", str(LOAD),
              "--crop_size", str(CROP), "--batch_size", "64", "--n_age_bins",
              str(NB), "--niter", "1", "--niter_decay", "0", "--lr", "0.0002",
              "--print_freq", "2", "--checkpoints_dir",
              os.path.join(tmp, "cmp_real")]
    ds = ComparisonsCSVDataset(csv)
    n_rows, pool = len(ds), ds.image_pool_dataset()
    argv = script + ["--dataset_mode", "comparisons", "--comparisons_csv",
                     csv, "--name", "cmp_csv"]
    res, b1, b2, wall = _train_run(torch, argv)
    n_eval = n_rows // 10
    steps = (n_rows - n_eval) // 64
    want_b1 = steps + 1 + -(-len(pool) // 64)
    check(res["step"] == steps and b1 == want_b1 and b2 == 0,
          f"label-free: {res['step']} steps (want {steps}), {b1} B1 launches "
          f"(want {want_b1})")
    check(res["eval_acc"] is not None and np.isfinite(res["eval_acc"]),
          f"label-free: held-out accuracy {res['eval_acc']}")
    bundle = torch.load(res["bundle"], weights_only=True)
    lo, hi, means = (bundle[k] for k in ("bin_lo", "bin_hi", "bin_means"))
    check(bool((means[1:] >= means[:-1]).all()) and lo[0] == -1e30
          and hi[-1] == 1e30 and torch.equal(lo[1:], hi[:-1]),
          f"label-free: anchors do not tile the score axis: {lo} {hi}")
    # the anchors are the score quantiles of the CSV's image pool
    cfg = parse_config(argv + ["--comparator_path", res["bundle"]])
    C = load_comparator_bundle(cfg, DEV)[0].eval()
    pre = make_preprocess(cfg, train=False)
    imgs = torch.cat([pre(None, {"image": torch.from_numpy(b["image"]).to(
        DEV)})["image"] for b in data_loader.Loader(
        pool, 64, shuffle=False, drop_last=False, num_threads=8)])
    qlo, qhi, qmeans = compute_quantile_anchors(C, imgs, NB)
    err = float((qmeans - means).abs().max())
    check(err <= 1e-3 * float(means.abs().max()) + 1e-6,
          f"label-free: bundle means differ from the pool's quantile means "
          f"by {err}")
    first = res["epochs"][0]
    out = {"rows": n_rows, "pool": len(pool), "steps": res["step"],
           "b1_launches": b1, "cli_wall_s": wall, "eval_acc": res["eval_acc"],
           "pairs_per_s_first_epoch": 64 * first["steps"]
           / first["train_seconds"],
           "bin_means": means.tolist(), "quantile_means_err": err}
    say(f"label-free: {n_rows} CSV rows ({n_eval} held out), {res['step']} "
        f"steps of 64 pairs in {wall:.2f} s, held-out accuracy "
        f"{res['eval_acc']}; quantile anchors over {len(pool)} images, means "
        f"{[round(m, 4) for m in means.tolist()]} (recomputed within {err:.3g})"
        f"; B1 launches {b1}")
    # the script's default data source: pairs over the folder
    res2, b1f, _, _ = _train_run(torch, script + [
        "--dataset_mode", "pairwise", "--dataroot", folder, "--name",
        "cmp_pairs"])
    check(res2["step"] == (128 - 12) // 64 and b1f == res2["step"] + 1 + 2
          and np.isfinite(res2["eval_acc"]),
          f"folder pairs: {res2['step']} steps, {b1f} B1 launches, accuracy "
          f"{res2['eval_acc']}")
    out["folder_pairs"] = {"steps": res2["step"], "b1_launches": b1f,
                           "eval_acc": res2["eval_acc"]}
    out["launches_per_run"] = {"csv": b1, "folder_pairs": b1f}
    return out


# --------------------------------------------------------------------------- #
# evaluation (phase 16)
# --------------------------------------------------------------------------- #

EVAL_N, EVAL_B, EVAL_NATIVE = 1024, 32, 250      # the CACD canvas
EVAL_LOAD, EVAL_CROP = 286, 256                  # train_256_fid.sh
EVAL_FID_RTOL = 2e-3     # fid vs fid_stream on equal real rows (CPU tests')
EVAL_SUB = 256           # images of the pth: and comparator feature runs
FID256 = ["--name", "cacd256", "--model", "pcgan", "--netG",
          "resnet_9blocks", "--netD", "basic", "--norm", "instance",
          "--load_size", "286", "--crop_size", "256", "--batch_size", "32",
          "--dtype", "bfloat16", "--n_age_bins", "10", "--gan_mode", "lsgan",
          "--lambda_L1", "100", "--pool_size", "64", "--niter", "100",
          "--niter_decay", "100", "--lr", "0.0002", "--beta1", "0.5",
          "--eval_fid_epoch_freq", "5", "--eval_fid_images", "1024",
          "--max_ckpt_keep", "5", "--print_freq", "100", "--save_epoch_freq",
          "5"]


def _eval_argv(tmp, pack, *extra):
    """train_256_fid.sh's structural flags for the eval CLIs over the pack
    of 250 px canvases."""
    return ["--dataroot", pack, "--dataset_mode", "packed", "--name",
            "cacd256", "--netG", "resnet_9blocks", "--norm", "instance",
            "--load_size", str(EVAL_LOAD), "--crop_size", str(EVAL_CROP),
            "--batch_size", str(EVAL_B), "--dtype", "bfloat16",
            "--n_age_bins", str(NB), "--checkpoints_dir",
            os.path.join(tmp, "eval_ck"), "--results_dir",
            os.path.join(tmp, "eval_res"), *extra]


def _seeded_inception_pth(torch, path, seed=0):
    """A torchvision-named inception_v3 state dict with seeded weights (conv,
    BN, fc), made here: nothing is downloaded."""
    from pcgan_tpu_torch.models.inception import (BasicConv2d,
                                                  InceptionV3Features)
    rng = np.random.default_rng(seed)
    sd = {}
    for prefix, mod in InceptionV3Features().named_modules():
        if isinstance(mod, BasicConv2d):
            co, ci, kh, kw = mod.conv.weight.shape
            sd[f"{prefix}.conv.weight"] = torch.from_numpy(rng.normal(
                0, np.sqrt(2.0 / (ci * kh * kw)), (co, ci, kh, kw)).astype(
                    np.float32))
            for k, v in (("weight", rng.uniform(0.5, 1.5, co)),
                         ("bias", rng.normal(0, 0.1, co)),
                         ("running_mean", rng.normal(0, 0.1, co)),
                         ("running_var", rng.uniform(0.5, 1.5, co))):
                sd[f"{prefix}.bn.{k}"] = torch.from_numpy(v.astype(np.float32))
    sd["fc.weight"] = torch.from_numpy(
        rng.normal(0, 0.02, (1000, 2048)).astype(np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return path


def _eval_cli(torch, argv):
    """``pcgan_tpu_torch.evaluate.main`` with B1's count zeroed just before
    and read just after; (record, B1 launches, wall s)."""
    from pcgan_tpu_torch import evaluate
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    cp.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # input injection
        rec = evaluate.main(argv)
    torch.cuda.synchronize()
    return rec, cp.launches, time.perf_counter() - t0


def _finite(rec, what):
    bad = {k: v for k, v in rec.items()
           if isinstance(v, float) and not np.isfinite(v)}
    check(not bad, f"{what}: non-finite metrics {bad}")


def _eval_timed(torch, cfg, G, pack, tf32=False):
    """One direct evaluator pass over the pack with its wall-time split:
    images/s after a one-batch warm-up, and the shares of G, the feature
    nets and the epilogue in the whole pass."""
    from pcgan_tpu_torch.data import loader as data_loader
    from pcgan_tpu_torch.data.packed import PackedDataset
    from pcgan_tpu_torch.eval_lib import make_fid_evaluator
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        run = make_fid_evaluator(cfg, None, DEV)
        times = {}
        cp.launches = 0
        ld = data_loader.Loader(PackedDataset(pack), EVAL_B, shuffle=False)
        rec = run(G, data_loader.with_bins(iter(ld), NB), max_images=EVAL_N,
                  seed=0, times=times)
        launches = cp.launches
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    total = sum(times["batch"]) + times["epilogue"]
    return rec, {
        "images_per_s": (EVAL_N - EVAL_B) / sum(times["batch"][1:]),
        "batches": len(times["batch"]),
        "share_g": times["g"] / total,
        "share_features": times["features"] / total,
        "share_epilogue": times["epilogue"] / total,
        "share_other": times["other"] / total,
        "seconds": total, "b1_launches": launches}


def _inception_rate(torch, pth):
    """The Inception feature net's images/s at 299 px, batch 32 (f32, TF32
    off), from CUDA events; and card-vs-CPU features on 4 images."""
    from pcgan_tpu_torch.models.inception import make_inception_feature_fn
    f_card, _ = make_inception_feature_fn(pth, device=DEV)
    x = torch.rand(EVAL_B, 299, 299, 3, generator=torch.Generator()
                   .manual_seed(0)) * 2 - 1
    xc = x.to(DEV)
    with torch.inference_mode():
        ms = cuda_ms(torch, lambda: f_card(xc), iters=10, warmup=3)
        card = f_card(xc[:4]).cpu().numpy()
        f_cpu, _ = make_inception_feature_fn(pth)
        cpu = f_cpu(x[:4]).numpy()
    err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    check(np.isfinite(card).all() and err <= PARITY_TOL,
          f"Inception card vs CPU (f32, 4 images): relative error {err}")
    return {"ms_per_batch32": ms, "images_per_s": EVAL_B / ms * 1e3,
            "card_vs_cpu_rel_err": err}


def _eval_parity(torch) -> dict:
    """The evaluator in f32 on the card against the CPU at the CPU tests'
    small shape (32 px from 36, ngf 8, resnet_6blocks, 4 bins): the
    streamed moments within 1e-4 of their largest entry."""
    from pcgan_tpu_torch import config as tcfg
    from pcgan_tpu_torch import eval_lib
    from pcgan_tpu_torch.models import define_G
    from pcgan_tpu_torch.ops import fid as fid_ops
    cfg = tcfg.Config(
        data=tcfg.DataConfig(n_age_bins=4, crop_size=32, load_size=36,
                             batch_size=4),
        model=tcfg.ModelConfig(netG="resnet_6blocks", ngf=8, dtype="float32",
                               cond_inject="bottleneck"),
        run=tcfg.RunConfig(kid=True, kid_subsets=1, ssim=True))
    G = define_G(cfg, torch.Generator().manual_seed(3)).eval()
    rng = np.random.default_rng(0)
    batches = [{"image": rng.integers(0, 256, (4, 36, 36, 3), np.uint8),
                "bin": rng.integers(0, 4, 4)} for _ in range(6)]
    seen, real = [], fid_ops.fid_from_stats

    def spy(a, b):
        seen.append((a, b))
        return real(a, b)
    fid_ops.fid_from_stats = spy
    try:
        recs = [eval_lib.make_fid_evaluator(cfg, None, dev)(
            G.to(dev), iter(batches), max_images=24) for dev in (DEV, "cpu")]
    finally:
        fid_ops.fid_from_stats = real
    err = 0.0
    for card, cpu in zip(seen[0], seen[1]):
        check(float(card.count) == float(cpu.count) == 24.0,
              "eval parity: counts differ")
        for k in ("s", "ss"):
            a, b = getattr(card, k).numpy(), getattr(cpu, k).numpy()
            err = max(err, float(np.abs(a - b).max() / np.abs(b).max()))
    check(err <= PARITY_TOL, f"eval parity: moments differ by {err} of their "
          f"largest entry")
    return {"moments_rel_err": err, "tol": PARITY_TOL,
            "fid_card": recs[0]["fid"], "fid_cpu": recs[1]["fid"],
            "kid_card": recs[0]["kid"], "kid_cpu": recs[1]["kid"],
            "ssim_card": recs[0]["ssim"], "ssim_cpu": recs[1]["ssim"]}


def phase_eval(torch, tmp, bundle_dir) -> dict:
    """Phase 16: the evaluation workflow at train_256_fid.sh's width (B1's
    CACD shape, 250 -> 286 -> 256, batch 32, bf16, 10 bins) over 1,024
    synthetic 250 px canvases in a pack."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.data.packed import write_pack
    from pcgan_tpu_torch.data.synthetic import SyntheticAgingDataset
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.tools import compute_fid_stats
    from pcgan_tpu_torch.utils.checkpoint import save_generator
    t_phase = time.perf_counter()
    pack = os.path.join(tmp, "eval_pack")
    t0 = time.perf_counter()
    write_pack(SyntheticAgingDataset(size=EVAL_N, native=EVAL_NATIVE, seed=4),
               pack, num_threads=8)
    pack_s = time.perf_counter() - t0
    argv = _eval_argv(tmp, pack)
    G = _seeded_G(torch, argv, seed=2)
    save_generator(G, os.path.join(tmp, "eval_ck"), "cacd256")
    out = {"pack_s": pack_s}

    # evaluate with every metric of the random feature space
    metrics = ["--fid_features", "random", "--kid", "--fid_per_bin",
               "--prdc", "--ssim", "--is_score", "--num_test", str(EVAL_N)]
    rec, b1, wall = _eval_cli(torch, argv + metrics)
    _finite(rec, "evaluate")
    want = {"fid", "kid", "kid_std", "fid_per_bin_mean", "precision",
            "recall", "density", "coverage", "ssim", "is_mean", "is_std"}
    check(want <= set(rec) and rec["fid_images"] == EVAL_N
          and b1 == EVAL_N // EVAL_B
          and sum(k.startswith("fid_bin_") for k in rec) >= 2,
          f"evaluate: {sorted(rec)}, {rec['fid_images']} images, {b1} B1 "
          f"launches")
    out["evaluate"] = {"record": rec, "b1_launches": b1, "wall_s": wall}
    cfg = parse_config(argv + metrics, is_train=False)
    G = G.to(DEV)
    rec_t, timing = _eval_timed(torch, cfg, G, pack)
    check(rec_t["fid"] == rec["fid"] or abs(rec_t["fid"] - rec["fid"])
          <= EVAL_FID_RTOL * rec["fid"],
          f"evaluator vs evaluate CLI: fid {rec_t['fid']} vs {rec['fid']}")
    rec_tf32, timing_tf32 = _eval_timed(torch, cfg, G, pack, tf32=True)
    out["timing"] = timing
    out["tf32"] = {"fid_tf32": rec_tf32["fid"], "fid_f32": rec_t["fid"],
                   "fid_rel_diff": abs(rec_tf32["fid"] - rec_t["fid"])
                   / rec_t["fid"], "kid_tf32": rec_tf32["kid"],
                   "kid_f32": rec_t["kid"],
                   "images_per_s_tf32": timing_tf32["images_per_s"]}
    say(f"evaluate (train_256_fid.sh width, {EVAL_N} x {EVAL_NATIVE} px "
        f"canvases -> 256, batch {EVAL_B}, bf16 G, f32 random features): "
        f"fid {rec['fid']:.6g}, kid {rec['kid']:.6g}, ssim "
        f"{rec['ssim']:.6g}, is {rec['is_mean']:.6g}, prdc "
        f"{rec['precision']:.3f}/{rec['recall']:.3f}; CLI {wall:.2f} s; "
        f"eval rate {timing['images_per_s']:.1f} images/s after one batch; "
        f"time shares G {timing['share_g']:.3f}, features "
        f"{timing['share_features']:.3f}, epilogue "
        f"{timing['share_epilogue']:.3f}, rest {timing['share_other']:.3f}; "
        f"B1 launches {b1}; TF32 on: fid {rec_tf32['fid']:.6g} "
        f"({out['tf32']['fid_rel_diff']:.3g} relative), "
        f"{timing_tf32['images_per_s']:.1f} images/s")

    # compute_fid_stats over the same rows, then --fid_stats
    stats = os.path.join(tmp, "eval_stats.npz")
    cp.launches = 0
    srec = compute_fid_stats.main(argv + ["--fid_features", "random",
                                          "--out", stats])
    torch.cuda.synchronize()
    b1s = cp.launches
    rec2, b1f, wall2 = _eval_cli(torch, argv + [
        "--fid_features", "random", "--num_test", str(EVAL_N),
        "--fid_stats", stats])
    gap = abs(rec2["fid"] - rec2["fid_stream"]) / rec2["fid_stream"]
    check(srec["images"] == EVAL_N and b1s == EVAL_N // EVAL_B
          and rec2["fid_stats_images"] == EVAL_N and gap <= EVAL_FID_RTOL,
          f"--fid_stats: {srec}, {b1s} B1 launches, fid {rec2['fid']} vs "
          f"fid_stream {rec2['fid_stream']}")
    out["fid_stats"] = {"images": srec["images"], "b1_launches": b1s,
                        "fid": rec2["fid"], "fid_stream": rec2["fid_stream"],
                        "rel_gap": gap, "b1_launches_eval": b1f}
    say(f"compute_fid_stats: {EVAL_N} images, B1 launches {b1s}; evaluate "
        f"--fid_stats: fid {rec2['fid']:.6g} vs fid_stream "
        f"{rec2['fid_stream']:.6g} ({gap:.2g} relative)")

    # an InceptionV3 .pth made here, and the comparator of phase 10
    pth = _seeded_inception_pth(torch, os.path.join(tmp, "inception.pth"))
    inc = _inception_rate(torch, pth)
    rec3, b1i, wall3 = _eval_cli(torch, argv + [
        "--fid_features", f"pth:{pth}", "--is_score", "--num_test",
        str(EVAL_SUB)])
    _finite(rec3, "evaluate pth:")
    rec4, b1c, wall4 = _eval_cli(torch, argv + [
        "--fid_features", "comparator", "--comparator_path", bundle_dir,
        "--kid", "--num_test", str(EVAL_SUB)])
    _finite(rec4, "evaluate comparator")
    check(b1i == b1c == EVAL_SUB // EVAL_B and "cond_accuracy" in rec4
          and "is_mean" in rec3,
          f"pth / comparator evals: {b1i} / {b1c} B1 launches, {rec3}, {rec4}")
    out["inception"] = {**inc, "record": rec3, "wall_s": wall3,
                        "b1_launches": b1i}
    out["comparator"] = {"record": rec4, "wall_s": wall4, "b1_launches": b1c}
    say(f"Inception (seeded .pth, f32): {inc['images_per_s']:.1f} images/s "
        f"at 299 px batch 32, card vs CPU {inc['card_vs_cpu_rel_err']:.3g}; "
        f"evaluate pth: fid {rec3['fid']:.6g} is {rec3['is_mean']:.6g} in "
        f"{wall3:.2f} s; comparator features: fid {rec4['fid']:.6g} "
        f"cond_accuracy {rec4['cond_accuracy']:.3f} in {wall4:.2f} s")

    # train_256_fid.sh's list: data, epochs and the eval cadence cut
    res, b1t, _, twall = _train_run(torch, ["--dataroot", pack,
                                           "--dataset_mode", "packed"]
                                    + FID256 + [
        "--niter", "1", "--niter_decay", "0", "--eval_fid_epoch_freq", "1",
        "--holdout_frac", "0.1", "--ema_decay", "0.999", "--eval_use_ema",
        "--checkpoints_dir", os.path.join(tmp, "eval_train")])
    with open(os.path.join(res["run_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    ev = [r for r in rows if "eval_fid" in r]
    n_train = EVAL_N - round(EVAL_N * 0.1)
    steps = n_train // EVAL_B
    check(res["step"] == steps and len(ev) == 1
          and np.isfinite(ev[0]["eval_fid"]) and np.isfinite(ev[0]["eval_h_fid"])
          and ev[0]["eval_fid_images"] == steps * EVAL_B
          and b1t == steps + steps + (EVAL_N - n_train) // EVAL_B,
          f"train_256_fid: {res['step']} steps, eval rows {ev}, B1 {b1t}")
    ep = res["epochs"][0]
    out["train"] = {"steps": res["step"], "steps_per_s": ep["steps"]
                    / ep["train_seconds"], "epoch": ep, "eval": res["evals"],
                    "b1_launches": b1t, "wall_s": twall,
                    "eval_row": ev[0]}
    say(f"train_256_fid.sh (1 epoch of {steps} steps, 256 px batch 32 bf16, "
        f"holdout 0.1, EMA eval): {out['train']['steps_per_s']:.3f} steps/s "
        f"over epoch 1 (first step included); in-training eval "
        f"{res['evals'][0]['seconds']:.2f} s (eval_fid {ev[0]['eval_fid']:.6g}"
        f" over {ev[0]['eval_fid_images']:.0f}, eval_h_fid "
        f"{ev[0]['eval_h_fid']:.6g} over {ev[0]['eval_h_fid_images']:.0f}); "
        f"B1 launches {b1t}")

    out["parity"] = _eval_parity(torch)
    say(f"eval parity (f32, card vs CPU, small shape): {out['parity']}")
    out["launches_per_run"] = {"evaluate": b1, "timed": timing["b1_launches"],
                               "timed_tf32": timing_tf32["b1_launches"],
                               "compute_fid_stats": b1s, "fid_stats": b1f,
                               "inception": b1i, "comparator": b1c,
                               "train_256_fid": b1t}
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 16: {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------- #
# phase 17: serving at full width
# --------------------------------------------------------------------------- #

SERVE_BATCHES = (8, 80)          # a direct call of 8 rows; one 8-input grid
SERVE_CALLS = 10                 # timed calls after 3 warm-up calls
SERVE_F32_TOL = 1e-4             # f32 artifact, card vs CPU
ANIM_FRAMES = 24
# (B, Cin, H, Cout, k, stride, padding, dilation) of the full-width G's
# trunk: the down convs, a block conv (its reflect pad done), the
# bottleneck projection at 10 bins (K = 266; not on an input-injection G,
# so a shape check), the deconvs as zero-inserted convs
TRUNK_SHAPES = {
    "down_64_128_s2": (2, NGF, CROP, 2 * NGF, 3, 2, ((1, 1), (1, 1)), 1),
    "down_128_256_s2": (2, 2 * NGF, CROP // 2, 4 * NGF, 3, 2,
                        ((1, 1), (1, 1)), 1),
    "block_256_256": (2, 4 * NGF, CROP // 4 + 2, 4 * NGF, 3, 1,
                      ((0, 0), (0, 0)), 1),
    "bottleneck_1x1_k266": (2, 4 * NGF + NB, CROP // 4, 4 * NGF, 1, 1,
                            ((0, 0), (0, 0)), 1),
    "deconv_256_128": (2, 4 * NGF, CROP // 4, 2 * NGF, 3, 1,
                       ((1, 2), (1, 2)), 2),
    "deconv_128_64": (2, 2 * NGF, CROP // 2, NGF, 3, 1, ((1, 2), (1, 2)), 2),
}


def _export_cli(argv) -> dict:
    """``tools.export_serving.main`` with its log kept: the artifact dir and
    the --verify numbers it printed."""
    import contextlib
    import io
    from pcgan_tpu_torch.tools import export_serving
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out_dir = export_serving.main(argv)
    text = log.getvalue()
    for line in text.splitlines():
        say(f"  export: {line}")
    m = re.search(r"verify: max\|exported - live\| = (\S+)"
                  r"(?: \(mean (\S+)\))?", text)
    check(m is not None, f"export {argv}: no verify line")
    return {"dir": out_dir, "wall_s": time.perf_counter() - t0,
            "verify_max": float(m.group(1)),
            "verify_mean": float(m.group(2)) if m.group(2) else None,
            "mb": os.path.getsize(os.path.join(
                out_dir, "comparator.pt2" if "--comparator_path" in argv
                else "generator.pt2")) / 1e6}


def _int8_accum_check(torch, shapes=None) -> dict:
    """s32 accumulators of the int8 conv, card against CPU, at every trunk
    shape of the full-width G (or at ``shapes``): random int8 activations,
    a seeded weight quantized as the G's are."""
    from pcgan_tpu_torch.ops import quant as tq
    rng = np.random.default_rng(17)
    out = {}
    for name, (b, ci, h, co, k, s, pads, dil) in (shapes
                                                  or TRUNK_SHAPES).items():
        xq = torch.from_numpy(rng.integers(-127, 128, (b, ci, h, h))
                              .astype(np.int8))
        w = torch.from_numpy(rng.normal(0, 0.02, (co, ci, k, k))
                             .astype(np.float32))
        wmat, _ = tq.quantize_conv_weight(w)
        acc_cpu, geom = tq.int8_conv_accum(xq, wmat, (k, k), s, pads, dil)
        acc_dev, _ = tq.int8_conv_accum(xq.to(DEV), wmat.to(DEV), (k, k), s,
                                        pads, dil)
        equal = bool(torch.equal(acc_cpu, acc_dev.cpu()))
        check(equal, f"int8 accumulators {name}: card differs from the CPU")
        out[name] = {"M": int(acc_cpu.shape[0]), "K": int(wmat.shape[1]),
                     "N": int(co), "out": list(geom), "bit_identical": equal}
    say(f"int8 s32 accumulators card == CPU bit for bit at "
        f"{ {n: (v['M'], v['K'], v['N']) for n, v in out.items()} }")
    return out


def _artifact_rate(torch, served, batch: int, what: str) -> dict:
    """rows/s of direct calls (numpy in, numpy out) after warm-up on the
    host's clock, then device ms and launches per call from a profiled
    run of the same calls."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(batch)
    x = rng.uniform(-1, 1, (batch, CROP, CROP, C)).astype(np.float32)
    c = np.eye(NB, dtype=np.float32)[rng.integers(0, NB, batch)]
    for _ in range(3):
        served(x, c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_CALLS):
        y = served(x, c)
    wall = (time.perf_counter() - t0) / SERVE_CALLS
    check(y.shape == (batch, CROP, CROP, C) and bool(np.isfinite(y).all()),
          f"{what} batch {batch}: output {y.shape}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SERVE_CALLS):
            served(x, c)
        torch.cuda.synchronize()
    rows = _device_rows(torch, prof, SERVE_CALLS)
    device_ms = sum(r[0] for r in rows)
    check(device_ms > 0, f"{what}: no device time traced")
    out = {"rows_per_s": batch / wall, "ms_per_call": wall * 1e3,
           "device_ms_per_call": device_ms,
           "launches_per_call": sum(r[1] for r in rows),
           "device_busy_share": device_ms / (wall * 1e3),
           "top_kernels_ms_per_call": [[round(ms, 4), cnt, name[:90]]
                                       for ms, cnt, name in rows[:8]]}
    say(f"artifact {what} batch {batch}: {out['rows_per_s']:.1f} rows/s "
        f"({out['ms_per_call']:.3f} ms a call), device "
        f"{device_ms:.3f} ms and {out['launches_per_call']:.1f} launches a "
        f"call, busy {out['device_busy_share']:.3f}")
    for ms, cnt, name in rows[:8]:
        say(f"  {ms:9.4f} ms/call {cnt:6.1f} launches/call  {name[:90]}")
    return out


def _start_host(artifact_dir, warm=(), **kw):
    """The port's host in-process on 127.0.0.1:0 (serve_http.main's
    warm-up included, then one call at each batch size of ``warm``: the
    coalesced buckets a timed run will reach); returns (httpd, base
    url)."""
    import threading
    from pcgan_tpu_torch.tools import serve_http
    httpd, served = serve_http.make_server(artifact_dir, "127.0.0.1", 0,
                                           device=DEV, **kw)
    for b in (kw.get("warmup_batch", 0), *warm):
        serve_http._warmup(served, b)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop_host(httpd):
    httpd.watch_stop.set()
    httpd.shutdown()
    httpd.server_close()


def _served_rate_cli(artifact_dir, window: float) -> dict:
    """export_and_serve.sh's serve list as its own process
    (``python -m pcgan_tpu_torch.tools.serve_http --warmup_batch 8
    --batch_window_ms W``), the port's loadtest from this one: a warm-up
    pass over the coalesced batch sizes, then the timed pass. The host
    process is stopped at the end."""
    import socket
    import threading
    from pcgan_tpu_torch.tools import loadtest
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "pcgan_tpu_torch.tools.serve_http",
         "--artifact_dir", artifact_dir, "--port", str(port),
         "--warmup_batch", "8", "--batch_window_ms", f"{window:g}",
         "--device", DEV], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.perf_counter()
        log = []
        for line in proc.stdout:
            log.append(line.rstrip())
            if line.startswith("serving "):
                break
        check(proc.poll() is None and log and log[-1].startswith("serving"),
              f"serve_http (window {window}) did not start: {log[-5:]}")
        start_s = time.perf_counter() - t0
        threading.Thread(target=lambda: [None for _ in proc.stdout],
                         daemon=True).start()
        url = f"http://127.0.0.1:{port}"
        loadtest.run_loadtest(url, concurrency=8, requests=64, batch=8)
        rec = loadtest.run_loadtest(url, concurrency=8, requests=64, batch=8)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    print(json.dumps(rec), flush=True)
    check(rec["requests_err"] == 0 and rec["requests_ok"] == 64,
          f"loadtest against the serve_http process, window {window}: {rec}")
    rec["host_start_s"] = start_s
    return rec


def _image_routes(url, face: bytes) -> dict:
    """The raw-image routes over one fixture JPEG: 200, a PNG/GIF that
    decodes at the right size and frame count."""
    from PIL import Image
    from pcgan_tpu_torch.client import ServingClient
    cl = ServingClient(url)
    import io
    out = {}
    for route, body, size, frames in (
            ("generate_image", cl.generate_image(face, bin=3),
             (CROP, CROP), 1),
            ("progression_image", cl.progression_image(face),
             (CROP * (NB + 1), CROP), 1),
            ("progression_gif", cl.progression_gif(face, frames=8),
             (CROP, CROP), 8)):
        with Image.open(io.BytesIO(body)) as im:
            got = (im.size, getattr(im, "n_frames", 1), im.format)
            im.seek(0)
            px = np.asarray(im.convert("RGB"))
        check(got[:2] == (size, frames) and px.std() > 0,
              f"{route}: {got}, want {size} and {frames} frames")
        out[route] = {"bytes": len(body), "size": list(got[0]),
                      "frames": got[1], "format": got[2]}
    say(f"image routes over a fixture JPEG: {out}")
    return out


def _reload_under_load(url, int8_dir) -> dict:
    """POST /reload to the int8 artifact while a loadtest runs: no request
    fails, and /healthz names the new directory."""
    import threading
    from pcgan_tpu_torch.client import ServingClient
    from pcgan_tpu_torch.tools import loadtest
    box = {}
    t = threading.Thread(target=lambda: box.update(loadtest.run_loadtest(
        url, concurrency=4, requests=48, batch=8)))
    t.start()
    time.sleep(0.3)
    cl = ServingClient(url)
    t0 = time.perf_counter()
    rec = cl.reload(int8_dir)
    reload_s = time.perf_counter() - t0
    t.join()
    health = cl.healthz()
    check(rec["status"] == "reloaded" and box.get("requests_err") == 0
          and box.get("requests_ok") == 48
          and health["artifact_dir"] == os.path.abspath(int8_dir),
          f"reload under load: {rec.get('status')}, loadtest {box}, "
          f"healthz names {health.get('artifact_dir')}")
    say(f"reload to the int8 artifact under load: {reload_s:.2f} s, "
        f"loadtest {json.dumps(box)}")
    return {"reload_s": reload_s, "loadtest": box,
            "artifact_dir": health["artifact_dir"]}


def _anim_run(torch, tmp, folder) -> dict:
    """test.main --quant_int8 --anim 24 on phase 14's checkpoint over the
    folder, B1's launches counted around it; the GIFs decode to 24 frames."""
    from PIL import Image
    from pcgan_tpu_torch import test as port_test
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    argv = ["--dataroot", folder, "--name", "real_utk128", "--dataset_mode",
            "aging", "--netG", NETG, "--norm", "instance", "--load_size",
            str(LOAD), "--crop_size", str(CROP), "--n_age_bins", str(NB),
            "--num_test", "16", "--checkpoints_dir",
            os.path.join(tmp, "real"), "--results_dir",
            os.path.join(tmp, "anim_res"), "--quant_int8", "--anim",
            str(ANIM_FRAMES), "--device", DEV]
    cp.launches = cw.launches = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = port_test.main(argv)
    torch.cuda.synchronize()
    b1 = cp.launches
    img_dir = os.path.join(res["web_dir"], "images")
    gifs = sorted(n for n in os.listdir(img_dir) if n.endswith(".gif"))
    for n in gifs:
        with Image.open(os.path.join(img_dir, n)) as im:
            check(getattr(im, "n_frames", 1) == ANIM_FRAMES
                  and im.size == (CROP, CROP),
                  f"anim {n}: {getattr(im, 'n_frames', 1)} frames {im.size}")
    check(res["done"] == 16 and len(gifs) == 16 and b1 == 2
          and cw.launches == 0,
          f"anim run: {res['done']} rows, {len(gifs)} GIFs, {b1} B1 / "
          f"{cw.launches} B2 launches")
    say(f"test.main --quant_int8 --anim {ANIM_FRAMES}: {len(gifs)} GIFs of "
        f"{ANIM_FRAMES} frames, batch s "
        f"{[round(s, 3) for s in res['batch_seconds']]}; B1 launches {b1}")
    return {"b1_launches": b1, "gifs": len(gifs),
            "batch_seconds": res["batch_seconds"]}


def phase_serving(torch, tmp, folder, bundle_dir, grid_rate) -> dict:
    """Phase 17: export_and_serve.sh through the port at full width: phase
    14's checkpoint exported bf16 and int8 (calibrated on the folder) and
    phase 10's comparator, each verified against the live model on the
    card; the int8 conv's accumulators card vs CPU; an f32 artifact card
    vs CPU; the artifacts' rates; the HTTP host under loadtest (window 5
    and 0), its image routes, the abuse battery and a reload under load;
    B1 on test.main --quant_int8 --anim 24."""
    from pcgan_tpu_torch.serving import load_exported
    from pcgan_tpu_torch.tools import loadtest
    t_phase = time.perf_counter()
    srv = os.path.join(tmp, "serving")
    base = ["--name", "real_utk128", "--checkpoints_dir",
            os.path.join(tmp, "real"), "--netG", NETG, "--crop_size",
            str(CROP), "--n_age_bins", str(NB), "--device", DEV]
    out = {"exports": {}}
    ex = out["exports"]
    ex["bf16"] = _export_cli(base + ["--out_dir", os.path.join(srv, "bf16"),
                                     "--verify"])
    ex["int8"] = _export_cli(base + ["--out_dir", os.path.join(srv, "int8"),
                                     "--verify", "--quant_int8",
                                     "--calib_dataroot", folder])
    ex["comparator"] = _export_cli(["--comparator_path", bundle_dir,
                                    "--out_dir", os.path.join(srv, "cmp"),
                                    "--verify", "--device", DEV])
    ex["f32"] = _export_cli(base + ["--out_dir", os.path.join(srv, "f32"),
                                    "--dtype", "float32", "--verify"])
    check(ex["bf16"]["verify_max"] <= 5e-2
          and ex["int8"]["verify_max"] <= 0.3
          and ex["int8"]["verify_mean"] <= 0.03
          and ex["comparator"]["verify_max"] <= 5e-2
          and ex["f32"]["verify_max"] <= 5e-2,
          f"export verify limits: {ex}")
    say(f"exports: " + ", ".join(
        f"{k} {v['mb']:.1f} MB in {v['wall_s']:.1f} s (verify max "
        f"{v['verify_max']:.2e}, mean {v['verify_mean']})"
        for k, v in ex.items()))

    out["int8_accumulators"] = _int8_accum_check(torch)

    # the f32 artifact: card against CPU on real rows
    rows = np.stack([_face_row(folder, i) for i in range(4)])
    cond = np.eye(NB, dtype=np.float32)[[0, 3, 6, 9]]
    a = load_exported(ex["f32"]["dir"], device=DEV)(rows, cond)
    b = load_exported(ex["f32"]["dir"], device="cpu")(rows, cond)
    f32_err = float(np.abs(a - b).max())
    check(f32_err <= SERVE_F32_TOL, f"f32 artifact card vs CPU {f32_err}")
    out["f32_card_vs_cpu"] = f32_err
    say(f"f32 artifact card vs CPU on 4 face rows: max |diff| {f32_err:.3e}")

    rates = {}
    for kind in ("bf16", "int8"):
        served = load_exported(ex[kind]["dir"], device=DEV)
        for b in SERVE_BATCHES:
            rates[f"{kind}_b{b}"] = _artifact_rate(torch, served, b, kind)
    out["artifact_rates"] = rates
    out["int8_over_bf16"] = {
        f"b{b}": rates[f"int8_b{b}"]["rows_per_s"]
        / rates[f"bf16_b{b}"]["rows_per_s"] for b in SERVE_BATCHES}
    out["int8_over_bf16_device"] = {
        f"b{b}": rates[f"bf16_b{b}"]["device_ms_per_call"]
        / rates[f"int8_b{b}"]["device_ms_per_call"] for b in SERVE_BATCHES}
    say(f"int8/bf16 rows/s: {out['int8_over_bf16']}; bf16/int8 device ms "
        f"(>1: int8 faster): {out['int8_over_bf16_device']}")

    # the host, with export_and_serve.sh's serve flags, then window 0
    out["http"] = {}
    for window in (5.0, 0.0):
        httpd, url = _start_host(ex["bf16"]["dir"], warm=(16, 32, 64),
                                 warmup_batch=8, batch_window_ms=window)
        try:
            rec = loadtest.run_loadtest(url, concurrency=8, requests=64,
                                        batch=8)
            print(json.dumps(rec), flush=True)
            check(rec["requests_err"] == 0 and rec["requests_ok"] == 64,
                  f"loadtest window {window}: {rec}")
            out["http"][f"window_{window:g}"] = rec
            if window:
                faces = os.path.join(FIXTURES, "faces")
                with open(os.path.join(faces, sorted(os.listdir(faces))[0]),
                          "rb") as f:
                    out["image_routes"] = _image_routes(url, f.read())
                out["reload"] = _reload_under_load(url, ex["int8"]["dir"])
        finally:
            _stop_host(httpd)
    # the served rate: the host as its own process, as the script runs it
    # (its window; window 0 is the in-process host's above, which leaves
    # room for phase 24)
    out["served_rate"] = {"window_5": _served_rate_cli(ex["bf16"]["dir"],
                                                       5.0)}
    for where, recs in (("host process", out["served_rate"]),
                        ("in-process host", out["http"])):
        say(f"served rate, {where} (bf16, concurrency 8 x batch 8): "
            + "; ".join(f"window {k[7:]} ms {r['value']} rows/s (p50 "
                        f"{r['p50_ms']} / p99 {r['p99_ms']} ms, "
                        f"{r['device_dispatches']} dispatches)"
                        for k, r in recs.items())
            + f"; phase 4's grid {grid_rate['grid_images_per_s']:.1f} "
              f"images/s in this call")
    out["grid_images_per_s_phase4"] = grid_rate["grid_images_per_s"]

    token = "smoke-token"
    httpd, url = _start_host(ex["bf16"]["dir"], auth_token=token,
                             request_timeout=2.0)
    try:
        ab = loadtest.run_abuse(url, auth_token=token, slow_wait=3.0)
    finally:
        _stop_host(httpd)
    check(not ab["failed"] and ab["value"] == 6, f"abuse battery: {ab}")
    out["abuse"] = ab["cases"]
    say(f"abuse battery: {ab['cases']}")

    out["anim"] = _anim_run(torch, tmp, folder)
    out["launches_per_run"] = {"anim": out["anim"]["b1_launches"]}
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 17: {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------- #
# phase 18: the lever path at full width
# --------------------------------------------------------------------------- #

LEVER_B, LEVER_STEPS = 32, 10    # 320 synthetic images: 10 steps an epoch
LEVER_NDF = 64
LEVER_EPOCHS = 3                 # the all-levers run: 30 steps
# f32 grad_accum 4 vs 1, of max(1, max|x|), cuDNN off: the stem's weight
# gradient sums 2^20 terms that its instance norm makes cancel, 5.0e-5
# apart on an H100 80GB HBM3 at 700 W (1e-5 holds at the CPU tests' size)
ACCUM_TOL = 1e-4
LEVER_TOL = 1e-4                 # f32 lever step losses, card vs CPU
SN_STATE_TOL = 1e-5              # spectral norm's u / sigma, card vs CPU
REMAT_SIZE, REMAT_LOAD = 256, 286    # train_256_fid.sh's shape


def _lever_argv(tmp, name, niter, steps=None, extra=()):
    """train_utkface_128.sh's shape over the synthetic set: resnet_9blocks,
    ngf/ndf 64, crop 128 (load 143), batch 32, bf16, 10 bins; ``steps`` an
    epoch (LEVER_STEPS by default)."""
    steps = LEVER_STEPS if steps is None else steps
    return ["--dataset_mode", "synthetic", "--max_dataset_size",
            str(LEVER_B * steps), "--name", name, "--netG", NETG, "--ngf",
            str(NGF), "--ndf", str(LEVER_NDF), "--netD", "basic", "--norm",
            "instance",
            "--load_size", str(LOAD), "--crop_size", str(CROP),
            "--batch_size", str(LEVER_B), "--n_age_bins", str(NB),
            "--gan_mode", "lsgan", "--lambda_L1", "100", "--lr", "0.0002",
            "--beta1", "0.5", "--pool_size", "64", "--dtype", "bfloat16",
            "--niter", str(niter), "--niter_decay", "0", "--print_freq", "2",
            "--save_epoch_freq", "1",
            "--checkpoints_dir", os.path.join(tmp, "levers"), *extra]


def _all_levers(vgg_pth, tb_dir):
    return ["--netD", "multiscale", "--num_D", "2", "--spectral_norm",
            "--d_attn", "--lambda_r1", "10", "--lambda_feat", "10",
            "--lambda_vgg", "10", "--vgg_path", vgg_pth, "--diff_augment",
            "color,translation,cutout", "--ada_target", "0.6",
            "--skip_nonfinite", "3", "--ema_decay", "0.999",
            "--log_grad_norm", "--no-no_dropout", "--tb_logdir", tb_dir]


def _lever_rows(run_dir, keys, what):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    check(len(rows) > 0, f"{what}: no metrics rows")
    for r in rows:
        for k in keys:
            check(k in r and bool(np.isfinite(r[k])),
                  f"{what}: {k} {r.get(k)} at step {r['step']}")
    return rows


def _lever_batch(torch, n, size, seed):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.uniform(
                -1, 1, (n, size, size, 3)).astype(np.float32)).to(DEV),
            "bin": torch.from_numpy(rng.integers(0, NB, n)).to(DEV),
            "target_bin": torch.from_numpy(rng.integers(0, NB, n)).to(DEV)}


def _lever_state(torch, argv):
    """(cfg, state, step) of ``argv`` at full width on the card, from
    seeded weights (the library route of ``train_main``), at a constant
    lr."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.train import create_train_state, make_train_step
    cfg = parse_config([*argv, "--lr_policy", "constant"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        G = define_G(cfg, torch.Generator().manual_seed(7)).to(DEV)
    D = define_D(cfg, torch.Generator().manual_seed(8)).to(DEV)
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(0))
    return cfg, state, make_train_step(cfg, G, D)


def _timed_steps(torch, state, step, batch, warm=3, n=5):
    """(ms per step over ``n`` steps after ``warm``, peak bytes of the timed
    steps)."""
    for _ in range(warm):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, batch)
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3 / n,
            torch.cuda.max_memory_allocated())


def _lever_accum(torch, tmp) -> dict:
    """--grad_accum 4 against --grad_accum 1 at the same global batch (32),
    f32 (TF32 off), pool off, targets pinned: every metric and both nets'
    Adam first moments within ACCUM_TOL of max(1, max|x|) with cuDNN off
    (ATen's convs: cuBLAS products whose f32 sums differ only in order).
    With cuDNN on, its algorithms differ between batch 8 and 32 (the 7x7
    stem's weight gradient by FFT or not), and the difference is only
    reported. Each run's peak memory is cuDNN's."""
    from pcgan_tpu_torch.utils.checkpoint import adam_state
    batch = _lever_batch(torch, LEVER_B, CROP, 18)
    runs = {}
    for cudnn in (True, False):
        torch.backends.cudnn.enabled = cudnn
        try:
            for accum in (1, 4):
                argv = _lever_argv(tmp, "accum", 1, extra=(
                    "--dtype", "float32", "--pool_size", "0", "--grad_accum",
                    str(accum)))
                _, state, step = _lever_state(torch, argv)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                m = step(state, batch)
                torch.cuda.synchronize()
                runs[cudnn, accum] = {
                    "metrics": {k: float(v) for k, v in m.items()},
                    "mu": {w: adam_state(o, net)["mu"] for w, o, net in
                           (("G", state.opt_g, state.G),
                            ("D", state.opt_d, state.D))},
                    "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
                    "step_s": time.perf_counter() - t0}
                del state, step
                torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.enabled = True

    def worst(a, b):
        errs = {k: abs(b["metrics"][k] - v) / max(1.0, abs(v))
                for k, v in a["metrics"].items()}
        for w in ("G", "D"):
            for k, v in a["mu"][w].items():
                errs[f"{w}.mu.{k}"] = (
                    float((b["mu"][w][k] - v).abs().max())
                    / max(1.0, float(v.abs().max())))
        return sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    exact = worst(runs[False, 1], runs[False, 4])
    check(exact[0][1] <= ACCUM_TOL, f"grad_accum 4 vs 1 (cuDNN off): "
          f"{exact[0][1]} > {ACCUM_TOL}: {exact}")
    return {"max_rel_err": exact[0][1], "tol": ACCUM_TOL, "worst": exact,
            "cudnn_on_worst": worst(runs[True, 1], runs[True, 4]),
            # the same batch-32 step, cuDNN on against off: f32 noise alone
            "cudnn_vs_aten_accum1": worst(runs[False, 1], runs[True, 1]),
            "peak_gb": {a: runs[True, a]["peak_gb"] for a in (1, 4)},
            "first_step_s": {a: runs[True, a]["step_s"] for a in (1, 4)}}


def _lever_remat(torch, tmp) -> dict:
    """--remat (every block) against none at train_256_fid.sh's shape
    (256 px, batch 32, bf16): peak memory of the timed steps must fall."""
    batch = _lever_batch(torch, LEVER_B, REMAT_SIZE, 19)
    out = {}
    for name, extra in (("plain", ()), ("remat", ("--remat",))):
        argv = _lever_argv(tmp, "remat", 1, extra=(
            "--crop_size", str(REMAT_SIZE), "--load_size", str(REMAT_LOAD),
            *extra))
        _, state, step = _lever_state(torch, argv)
        ms, peak = _timed_steps(torch, state, step, batch)
        out[name] = {"ms_per_step": ms, "peak_gb": peak / 2**30}
        del state, step
        torch.cuda.empty_cache()
    check(out["remat"]["peak_gb"] < out["plain"]["peak_gb"],
          f"remat: peak memory did not fall {out}")
    out["memory_saved_gb"] = out["plain"]["peak_gb"] - out["remat"]["peak_gb"]
    out["step_time_cost"] = out["remat"]["ms_per_step"] / out["plain"][
        "ms_per_step"]
    return out


def _lever_nonfinite(torch, tmp) -> dict:
    """A forced non-finite step (an inf in the batch) at full width, bf16,
    --skip_nonfinite 3 --ema_decay 0.999: notfinite_G/D read 1 and the
    params, the EMA twin and both Adam counts hold; the next finite step
    moves them. Then the check's own cost: check_finite over G's and D's
    gradients, and five steps with and without the flag."""
    from pcgan_tpu_torch.train import adam_count, check_finite, init_skip_state
    argv = _lever_argv(tmp, "skip", 1, extra=(
        "--skip_nonfinite", "3", "--ema_decay", "0.999"))
    _, state, step = _lever_state(torch, argv)
    good = _lever_batch(torch, LEVER_B, CROP, 20)
    bad = {k: v.clone() for k, v in good.items()}
    bad["image"][0, 5, 7, 1] = float("inf")

    def snap():
        return ({k: v.detach().clone() for k, v in
                 state.G.state_dict().items()},
                {k: v.clone() for k, v in state.ema.items()},
                int(adam_count(state.opt_g)), int(adam_count(state.opt_d)))
    step(state, good)
    g0, e0, cg0, cd0 = snap()
    m = {k: float(v) for k, v in step(state, bad).items()}
    g1, e1, cg1, cd1 = snap()
    check(m["notfinite_G"] == 1 and m["notfinite_D"] == 1,
          f"non-finite step: counters {m}")
    check(all(torch.equal(g0[k], g1[k]) for k in g0)
          and all(torch.equal(e0[k], e1[k]) for k in e0)
          and (cg1, cd1) == (cg0, cd0) == (1, 1),
          f"non-finite step: state moved (counts G {cg0}->{cg1}, D "
          f"{cd0}->{cd1})")
    m2 = {k: float(v) for k, v in step(state, good).items()}
    g2, _, cg2, cd2 = snap()
    check((cg2, cd2) == (2, 2) and m2["notfinite_G"] == 1
          and not all(torch.equal(g1[k], g2[k]) for k in g1),
          f"after the skipped step: counts {cg2}, {cd2}, {m2}")
    grads = ([torch.randn_like(p) for p in state.G.parameters()]
             + [torch.randn_like(p) for p in state.D.parameters()])
    skip = init_skip_state(DEV)
    check_ms = cuda_ms(torch, lambda: check_finite(grads, skip, 3), iters=50)
    on_ms, _ = _timed_steps(torch, state, step, good)
    del state, step
    _, state, step = _lever_state(torch, _lever_argv(tmp, "noskip", 1, extra=(
        "--ema_decay", "0.999")))
    off_ms, _ = _timed_steps(torch, state, step, good)
    del state, step
    torch.cuda.empty_cache()
    return {"metrics_bad_step": m, "check_finite_ms": check_ms,
            "n_grad_tensors": len(grads), "step_ms_skip_on": on_ms,
            "step_ms_skip_off": off_ms}


def _step_parity(torch, flags, what, tol) -> dict:
    """One f32 step (TF32 off) of a small config (32 px, batch 4, 4 bins,
    pool off, constant lr, ``flags``) on the card and on the CPU from the
    same seeded weights: losses within ``tol``, parameters within the Adam
    first-step envelope, spectral norm's state within SN_STATE_TOL."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.train import create_train_state, make_train_step
    cfg = parse_config(["--crop_size", "32", "--load_size", "32",
                        "--batch_size", "4", "--n_age_bins", "4",
                        "--pool_size", "0", "--dtype", "float32",
                        "--lr_policy", "constant", *flags])
    rng = np.random.default_rng(21)
    batch = {"image": torch.from_numpy(
                 rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)),
             "bin": torch.from_numpy(rng.integers(0, 4, 4)),
             "target_bin": torch.from_numpy(rng.integers(0, 4, 4))}
    runs = {}
    for dev in ("cpu", DEV):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
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
    loss_err = max(abs(mc[k] - mg[k]) / max(1.0, abs(mc[k])) for k in mc)
    check(loss_err <= tol, f"{what}: losses differ by {loss_err}"
          f" (cpu {mc}, card {mg})")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        g0 = define_G(cfg, torch.Generator().manual_seed(7)).state_dict()
    d0 = define_D(cfg, torch.Generator().manual_seed(8)).state_dict()
    init = {**{f"G.{k}": v for k, v in g0.items()},
            **{f"D.{k}": v for k, v in d0.items()}}
    worst = {"max": 0.0, "median": 0.0, "frac": 0.0}
    sn_err = 0.0
    for k, v0 in init.items():
        if ".sn." in k:
            sn_err = max(sn_err, float((pc[k] - pg[k]).abs().max()))
            continue
        diff = ((pc[k] - v0) - (pg[k] - v0)).abs().numpy()
        worst["max"] = max(worst["max"], float(diff.max()))
        worst["median"] = max(worst["median"], float(np.median(diff)))
        worst["frac"] = max(worst["frac"], float((diff > 0.25 * LR).mean()))
    check(worst["max"] <= 2.1 * LR and worst["median"] < 2e-6
          and worst["frac"] < 2e-3,
          f"{what}: parameters outside the Adam envelope {worst}")
    check(sn_err <= SN_STATE_TOL, f"{what}: spectral norm state "
          f"differs by {sn_err}")
    return {"loss_max_rel_err": loss_err, "param_delta_diff": worst,
            "sn_state_max_abs_err": sn_err, "losses_card": mg}


def _lever_parity(torch) -> dict:
    """One f32 step with spectral norm, the multiscale D, R1 and feature
    matching, card against CPU (``_step_parity``)."""
    return _step_parity(torch, [
        "--netG", "resnet_6blocks", "--ngf", "16", "--ndf", "16",
        "--cond_inject", "bottleneck", "--netD", "multiscale", "--num_D",
        "2", "--n_layers_D", "2", "--spectral_norm", "--lambda_r1", "10",
        "--lambda_feat", "10"], "lever parity", LEVER_TOL)


def phase_levers(torch, tmp) -> dict:
    """Phase 18: the lever path at full width (resnet_9blocks, ngf/ndf 64,
    128 px, batch 32, bf16, 10 bins over the synthetic set)."""
    from pcgan_tpu_torch import test as port_test
    from pcgan_tpu_torch.models.vgg import random_vgg19
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    t0 = time.perf_counter()
    vgg_pth = os.path.join(tmp, "vgg19_seeded.pth")
    torch.save(random_vgg19(0).state_dict(), vgg_pth)
    tb_dir = os.path.join(tmp, "tb")
    levers = _all_levers(vgg_pth, tb_dir)
    out, launches = {}, {}

    # all levers at once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, b1, b2, wall = _train_run(torch, _lever_argv(
        tmp, "levers_all", LEVER_EPOCHS, extra=levers))
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = LEVER_EPOCHS * LEVER_STEPS
    check(res["step"] == n and b1 == n and b2 == 0,
          f"all levers: {res['step']} steps, {b1} B1 / {b2} B2 launches")
    keys = ("loss_G", "loss_D", "loss_D_r1", "loss_G_feat", "loss_G_vgg",
            "ada_p", "ada_rt", "grad_norm_G", "grad_norm_D", "notfinite_G",
            "notfinite_D")
    rows = _lever_rows(os.path.join(tmp, "levers", "levers_all"), keys,
                       "all levers")
    check(rows[-1]["notfinite_G"] == 0 and rows[-1]["notfinite_D"] == 0,
          f"all levers: skipped updates {rows[-1]}")
    check(len(os.listdir(os.path.join(tb_dir, "levers_all"))) == 1,
          "all levers: no TensorBoard event file")
    launches["all_levers"] = b1
    rates = _epoch_rates(res["epochs"])
    out["all_levers"] = {"steps": n, "cli_wall_s": wall,
                         "rates": rates, "peak_gb": peak,
                         "final_ada_p": rows[-1]["ada_p"],
                         "last_row": rows[-1]}
    say(f"levers (all at once, 30 steps): {_rates_str(rates, LEVER_B)}; "
        f"peak {peak:.3f} GB allocated; final ada_p {rows[-1]['ada_p']}")
    prof = _profile_train(torch, tmp, steps=2, argv=_lever_argv(
        tmp, "levers_profile", 2, steps=2, extra=levers), what="lever step")
    plain = _profile_train(torch, tmp, steps=2, argv=_lever_argv(
        tmp, "plain_profile", 2, steps=2), what="plain step (same shape)")
    launches["profiles"] = prof["launches"] + plain["launches"]
    out["all_levers"]["profile"] = prof
    out["plain_profile"] = plain
    out["lever_over_plain_device_ms"] = (prof["device_ms_per_step"]
                                         / plain["device_ms_per_step"])
    say(f"levers: device {prof['device_ms_per_step']:.3f} ms and "
        f"{prof['device_launches_per_step']:.1f} launches per step against "
        f"the plain step's {plain['device_ms_per_step']:.3f} ms and "
        f"{plain['device_launches_per_step']:.1f}: "
        f"x{out['lever_over_plain_device_ms']:.3f}")

    # one lever each: wgangp, batch norm (then sampling), the pixel D
    for name, extra, keys in (
            ("wgangp", ("--gan_mode", "wgangp"), ("loss_D", "loss_G")),
            ("batch_norm", ("--norm", "batch"), ("loss_D", "loss_G")),
            ("pixel", ("--netD", "pixel"), ("loss_D", "loss_G"))):
        res, b1, _, wall = _train_run(torch, _lever_argv(
            tmp, f"levers_{name}", 1, steps=4, extra=extra))
        check(res["step"] == 4 and b1 == 4, f"{name}: {res['step']} steps, "
              f"{b1} B1 launches")
        _lever_rows(os.path.join(tmp, "levers", f"levers_{name}"), keys,
                    name)
        launches[name] = b1
        out[name] = {"cli_wall_s": wall, "metrics": res["metrics"]}
    cp.launches = 0
    res = port_test.main([
        "--dataset_mode", "synthetic", "--max_dataset_size", "8",
        "--num_test", "8", "--batch_size", "8", "--netG", NETG, "--ngf",
        str(NGF), "--norm", "batch", "--crop_size", str(CROP), "--load_size",
        str(LOAD), "--n_age_bins", str(NB), "--dtype", "bfloat16",
        "--name", "levers_batch_norm",
        "--checkpoints_dir", os.path.join(tmp, "levers"),
        "--results_dir", os.path.join(tmp, "levers_res")])
    check(res["done"] == 8 and cp.launches > 0,
          f"batch-norm sampling: {res['done']} grids, {cp.launches} B1")
    launches["batch_norm_sampling"] = cp.launches
    grid = read_png(os.path.join(res["web_dir"], "images",
                                 os.listdir(os.path.join(
                                     res["web_dir"], "images"))[0]))
    check(grid.std() > 0, "batch-norm sampling: a flat grid image")
    say(f"levers: wgangp, batch norm (and its sampling grid, "
        f"{res['done']} inputs) and the pixel D trained 4 steps each")

    out["accum"] = _lever_accum(torch, tmp)
    say(f"levers: grad_accum 4 vs 1 (f32, batch 32): "
        f"{json.dumps(out['accum'])}")
    out["remat"] = _lever_remat(torch, tmp)
    say(f"levers: remat at {REMAT_SIZE} px, batch 32, bf16: "
        f"{json.dumps(out['remat'])}")
    out["nonfinite"] = _lever_nonfinite(torch, tmp)
    say(f"levers: forced non-finite step: {json.dumps(out['nonfinite'])}")
    out["parity"] = _lever_parity(torch)
    say(f"levers: card-vs-CPU parity (f32, TF32 off, SN + multiscale + R1 + "
        f"FM, one step): {json.dumps(out['parity'])}")
    out["launches_per_run"] = launches
    out["seconds"] = time.perf_counter() - t0
    say(f"phase 18 (levers): {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------- #
# phase 19: the generator variants and the device cache at full width
# --------------------------------------------------------------------------- #

UNET_EPOCHS = 3                  # unet_128 at batch 32: 30 steps
VARIANT_TOL = 1e-4               # f32 card vs CPU: a unet step, a resize+attn G
VARIANT_BF16 = (5e-2, 5e-3)      # bf16 route vs direct conv: max, mean
TAIL_X = (32, 64, CROP, CROP)    # path 4's G tail input, NCHW, bf16
CACHE_N = 4096                   # 200 px canvases: 0.49 GB resident
CACHE_WARM, CACHE_STEPS = 3, 12  # steps of each loader: warm-up, timed
# the full-width unet_128's innermost int8 convs (8 x 8 x 512 at 2 x 2 in,
# one pixel a sample out: fewer rows than cuBLASLt's int8 GEMM takes
# unpadded) and the next level's
UNET_INT8_SHAPES = {
    "innermost_down_512_s2": (8, 8 * NGF, 2, 8 * NGF, 4, 2,
                              ((1, 1), (1, 1)), 1),
    "innermost_up_512": (8, 8 * NGF, 1, 8 * NGF, 4, 1, ((2, 2), (2, 2)), 2),
    "level1_down_512_s2": (8, 8 * NGF, 4, 8 * NGF, 4, 2, ((1, 1), (1, 1)),
                           1)}


def _variant_argv(tmp, name, niter, netG, steps=None, extra=()):
    """Phase 18's shape (train_utkface_128.sh's: ngf/ndf 64, 128 px, batch
    32, bf16, 10 bins, basic D, synthetic) with ``netG``."""
    return _lever_argv(tmp, name, niter, steps=steps,
                       extra=("--netG", netG, *extra))


def _b2_after(what):
    """The B2 launches of the run just made (``_train_run`` zeroes the
    count first): none on a generator-variant path."""
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    check(cw.launches == 0, f"{what}: {cw.launches} B2 launches")


def _grid_rate(torch, argv, n_batches, what) -> dict:
    """``test.main`` over ``n_batches`` batches of 8; inputs/s after the
    first (warm-up) batch; B1's launches counted around it."""
    from pcgan_tpu_torch import test as port_test
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    cp.launches = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = port_test.main(argv)
    torch.cuda.synchronize()
    check(res["done"] == 8 * n_batches and cp.launches == n_batches,
          f"{what}: {res['done']} grids, {cp.launches} B1 launches")
    steady = res["batch_seconds"][1:]
    rate = 8 * len(steady) / sum(steady) if steady else None
    return {"b1_launches": cp.launches, "inputs_per_s": rate,
            "batch_seconds": res["batch_seconds"], "web_dir": res["web_dir"]}


def _unet128(torch, tmp, plain) -> dict:
    """(a) unet_128 at train_utkface_128.sh's shape: steps/s over epochs
    2-3, a profiled step beside phase 18's plain resnet step, the grid rate
    and an --anim sweep from its checkpoint, bf16 and int8 artifacts with
    --verify and their rows/s at batch 80."""
    from pcgan_tpu_torch.serving import load_exported
    out, launches = {}, {}
    res, b1, b2, wall = _train_run(torch, _variant_argv(
        tmp, "unet128", UNET_EPOCHS, "unet_128"))
    n = UNET_EPOCHS * LEVER_STEPS
    check(res["step"] == n and b1 == n and b2 == 0,
          f"unet_128: {res['step']} steps, {b1} B1 / {b2} B2 launches")
    _lever_rows(os.path.join(tmp, "levers", "unet128"),
                ("loss_G", "loss_G_L1", "loss_D"), "unet_128")
    launches["train"] = b1
    rates = _epoch_rates(res["epochs"])
    out["train"] = {"steps": n, "cli_wall_s": wall, "rates": rates,
                    "last_metrics": res["metrics"]}
    say(f"unet_128 (batch 32, bf16, 30 steps): {_rates_str(rates, LEVER_B)}")
    # two epochs of 2 steps (a depth cut to keep the script in its time)
    prof = _profile_train(torch, tmp, steps=2, argv=_variant_argv(
        tmp, "unet128_profile", 2, "unet_128", steps=2),
        what="unet_128 step")
    _b2_after("unet_128 profile")
    launches["profile"] = prof["launches"]
    out["profile"] = prof
    out["over_plain_device_ms"] = (prof["device_ms_per_step"]
                                   / plain["device_ms_per_step"])
    out["over_plain_launches"] = (prof["device_launches_per_step"]
                                  / plain["device_launches_per_step"])
    say(f"unet_128: device {prof['device_ms_per_step']:.3f} ms, "
        f"{prof['device_launches_per_step']:.1f} launches, busy "
        f"{prof['device_busy_share']:.3f} per step against phase 18's plain "
        f"resnet step's {plain['device_ms_per_step']:.3f} ms, "
        f"{plain['device_launches_per_step']:.1f}: "
        f"x{out['over_plain_device_ms']:.3f} / "
        f"x{out['over_plain_launches']:.3f}")
    grid = ["--dataset_mode", "synthetic", "--batch_size", "8", "--netG",
            "unet_128", "--ngf", str(NGF), "--crop_size", str(CROP),
            "--load_size", str(LOAD), "--n_age_bins", str(NB), "--dtype",
            "bfloat16", "--name", "unet128", "--checkpoints_dir",
            os.path.join(tmp, "levers"), "--results_dir",
            os.path.join(tmp, "variants_res")]
    g = _grid_rate(torch, grid + ["--max_dataset_size", "64", "--num_test",
                                  "64"], 8, "unet_128 grid")
    tiles = sorted(f for f in os.listdir(os.path.join(g["web_dir"], "images"))
                   if f.startswith("0000_age_"))
    check(len(tiles) == NB, f"unet_128 grid: {len(tiles)} tiles in a row")
    img = read_png(os.path.join(g["web_dir"], "images", tiles[0]))
    check(img.shape == (CROP, CROP, C) and img.std() > 0,
          f"unet_128 grid: tile {img.shape}")
    launches["grid"] = g["b1_launches"]
    out["grid_inputs_per_s"] = g["inputs_per_s"]
    a = _grid_rate(torch, grid + ["--max_dataset_size", "8", "--num_test",
                                  "8", "--anim", "8", "--results_dir",
                                  os.path.join(tmp, "variants_anim")], 1,
                   "unet_128 --anim")
    gifs = [f for f in os.listdir(os.path.join(a["web_dir"], "images"))
            if f.endswith("_aging.gif")]
    check(len(gifs) == 8, f"unet_128 --anim: {len(gifs)} GIFs")
    launches["anim"] = a["b1_launches"]
    say(f"unet_128 grid: {g['inputs_per_s']:.1f} inputs/s after warm-up "
        f"(8 x {NB} per batch, bf16); --anim 8 wrote {len(gifs)} GIFs")
    out["int8_accumulators"] = _int8_accum_check(torch, UNET_INT8_SHAPES)
    base = ["--name", "unet128", "--checkpoints_dir",
            os.path.join(tmp, "levers"), "--crop_size", str(CROP),
            "--n_age_bins", str(NB), "--device", DEV, "--verify"]
    srv = os.path.join(tmp, "variants_srv")
    ex = {"bf16": _export_cli(base + ["--out_dir", os.path.join(srv, "bf16")]),
          "int8": _export_cli(base + ["--out_dir", os.path.join(srv, "int8"),
                                      "--quant_int8", "--calib_batches",
                                      "2"])}
    check(ex["bf16"]["verify_max"] <= 5e-2 and ex["int8"]["verify_max"] <= 0.3
          and ex["int8"]["verify_mean"] <= 0.03,
          f"unet_128 export verify limits: {ex}")
    out["exports"] = ex
    for kind, e in ex.items():
        served = load_exported(e["dir"], device=DEV)
        e["batch80"] = _artifact_rate(torch, served, 80, f"unet_128 {kind}")
        del served
    out["launches"] = launches
    return out


def _unet256_remat(torch, tmp) -> dict:
    """(b) unet_256 at train_256_fid.sh's 256 px, batch 32, bf16: peak
    memory and step ms with --remat (the 7 levels below the outermost)
    against without; the peak must fall."""
    batch = _lever_batch(torch, LEVER_B, REMAT_SIZE, 23)
    out = {}
    for name, extra in (("plain", ()), ("remat", ("--remat",))):
        argv = _variant_argv(tmp, "unet256", 1, "unet_256", extra=(
            "--crop_size", str(REMAT_SIZE), "--load_size", str(REMAT_LOAD),
            *extra))
        _, state, step = _lever_state(torch, argv)
        ms, peak = _timed_steps(torch, state, step, batch)
        out[name] = {"ms_per_step": ms, "peak_gb": peak / 2**30,
                     "n_remat": state.G.n_remat}
        del state, step
        torch.cuda.empty_cache()
    check(out["remat"]["peak_gb"] < out["plain"]["peak_gb"]
          and out["remat"]["n_remat"] == 7,
          f"unet_256 remat: peak memory did not fall {out}")
    out["peak_ratio"] = out["remat"]["peak_gb"] / out["plain"]["peak_gb"]
    out["step_time_cost"] = (out["remat"]["ms_per_step"]
                             / out["plain"]["ms_per_step"])
    say(f"unet_256 remat (256 px, batch 32, bf16): {json.dumps(out)}")
    return out


def _tail_forms(torch) -> dict:
    """(d) the G tail at path 4's shape (x (32, 64, 128, 128) bf16, reflect
    pad 3 (x_pad 134 x 134), 7x7, 64 -> 3): forward + VJP (dx, dw) as the
    direct conv, the r=4 s2d conv (the JAX default's form) and
    ``lowch_reflect_conv`` (its weight gradient is B2), each the mean of
    back-to-back eager calls (CUDA events); their outputs and gradients
    agree within BF16_REL_TOL of the largest entry."""
    import torch.nn.functional as F
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    from pcgan_tpu_torch.ops import lowch_conv as lc
    g = torch.Generator().manual_seed(24)
    x = torch.randn(TAIL_X, generator=g).to(DEV, torch.bfloat16)
    w = (0.02 * torch.randn((3, TAIL_X[1], 7, 7), generator=g)).to(DEV)
    dy = torch.randn((TAIL_X[0], 3, CROP, CROP), generator=g).to(
        DEV, torch.bfloat16)
    x.requires_grad_(True)
    w.requires_grad_(True)

    def direct():
        return F.conv2d(F.pad(x, (3, 3, 3, 3), mode="reflect"),
                        w.to(torch.bfloat16))

    def s2d():
        return lc.s2d_conv_nchw(F.pad(x, (3, 3, 3, 3), mode="reflect"),
                                w.to(torch.bfloat16), 4)

    def routed():
        y = lc.lowch_reflect_conv(x.permute(0, 2, 3, 1),
                                  w.permute(2, 3, 1, 0), 3)
        return y.permute(0, 3, 1, 2)

    forms = {"direct": direct, "s2d": s2d, "lowch_reflect_conv": routed}
    res, out = {}, {}
    cw.launches = 0
    for name, fn in forms.items():
        y = fn()
        dx, dw = torch.autograd.grad(y, (x, w), dy)
        res[name] = (y.float(), dx.float(), dw.float())

        def fvjp(fn=fn):
            return torch.autograd.grad(fn(), (x, w), dy)
        out[name] = {"fwd_ms": cuda_ms(torch, lambda fn=fn: fn(), iters=50,
                                       warmup=5),
                     "fwd_vjp_ms": cuda_ms(torch, fvjp, iters=50, warmup=5)}
    b2 = cw.launches
    check(b2 > 0, "tail forms: lowch_reflect_conv launched no B2")
    ref = res["direct"]
    for name in ("s2d", "lowch_reflect_conv"):
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(res[name], ref)]
        out[name]["rel_err_vs_direct"] = errs
        check(max(errs) <= BF16_REL_TOL, f"tail {name} vs direct: {errs}")
    out["b2_launches"] = b2
    out["s2d_over_direct"] = (out["s2d"]["fwd_vjp_ms"]
                              / out["direct"]["fwd_vjp_ms"])
    say(f"tail forms (x {TAIL_X} bf16, 7x7 64 -> 3, f+vjp): "
        + ", ".join(f"{k} {v['fwd_ms']:.3f} / {v['fwd_vjp_ms']:.3f} ms"
                    for k, v in out.items() if isinstance(v, dict))
        + f"; s2d / direct x{out['s2d_over_direct']:.3f}; B2 launches {b2}")
    return out


def _variant_parity(torch) -> dict:
    """(e) card against CPU: one f32 unet_32 step (``_step_parity``); the
    f32 forward of a resize_conv + g_attn G (gamma 0.5); the bf16 s2d tail
    and separated-condition stem against the direct conv on the card."""
    import torch.nn.functional as F
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_G
    from pcgan_tpu_torch.models.generator import broadcast_cond
    from pcgan_tpu_torch.models.layers import TorchConv
    out = {"unet_step": _step_parity(torch, [
        "--netG", "unet_32", "--ngf", "16", "--ndf", "16"],
        "unet step parity", VARIANT_TOL)}
    cfg = parse_config(["--netG", "resnet_6blocks@resize_conv", "--g_attn",
                        "--ngf", "16", "--crop_size", "32", "--n_age_bins",
                        "4", "--cond_inject", "bottleneck", "--dtype",
                        "float32"], is_train=False)
    G = define_G(cfg, torch.Generator().manual_seed(25)).eval()
    with torch.no_grad():
        G.attn.gamma.fill_(0.5)
    rng = np.random.default_rng(25)
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3)).astype(
        np.float32))
    c = torch.eye(4)[torch.from_numpy(rng.integers(0, 4, 4))]
    with torch.no_grad():
        y_cpu = G(x, c)
        y_dev = G.to(DEV)(x.to(DEV), c.to(DEV)).cpu()
    err = float((y_cpu - y_dev).abs().max())
    check(err <= VARIANT_TOL, f"resize_conv + g_attn G card vs CPU: {err}")
    out["resize_attn_forward_max_abs_err"] = err
    # the bf16 routes on the card against the direct conv, same weights
    g = torch.Generator().manual_seed(26)
    bf = torch.bfloat16
    xt = torch.randn((8, 64, CROP, CROP), generator=g).to(DEV)
    xs = torch.rand((8, 3, CROP, CROP), generator=g).to(DEV) * 2 - 1
    cs = torch.eye(NB)[torch.arange(8) % NB].to(DEV)
    routes = {}
    for name, (cin, cout) in (("tail_s2d", (64, 3)), ("stem_cond", (3 + NB,
                                                                     64))):
        on = TorchConv(cin, cout, 7, 1, 3, "reflect", True, bf,
                       lowch_matmul=True)
        off = TorchConv(cin, cout, 7, 1, 3, "reflect", True, bf)
        with torch.no_grad():
            on.weight.normal_(0, 0.02, generator=g)
            on.bias.normal_(0, 0.02, generator=g)
            off.load_state_dict(on.state_dict())
            on, off = on.to(DEV), off.to(DEV)
            if name == "tail_s2d":
                check(on.s2d_r == 4, "tail: no s2d route")
                a, b = on(xt), off(xt)
            else:
                a = on(xs, cs)
                b = off(torch.cat([xs, broadcast_cond(cs, CROP, CROP)], 1))
        d = (a.float() - b.float()).abs()
        routes[name] = {"max": float(d.max()), "mean": float(d.mean())}
        check(routes[name]["max"] <= VARIANT_BF16[0]
              and routes[name]["mean"] <= VARIANT_BF16[1],
              f"{name} vs the direct conv (bf16, card): {routes[name]}")
    out["bf16_routes_vs_direct"] = routes
    say(f"variant parity: {json.dumps(out)}")
    return out


def _h2d_bytes(trace_path) -> float:
    """Host-to-device bytes of a chrome trace's memcpy rows."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    rows = [e for e in events if e.get("cat") == "gpu_memcpy"
            and "HtoD" in e.get("name", "")]
    check(all("bytes" in e.get("args", {}) for e in rows),
          f"{trace_path}: memcpy rows without bytes")
    return float(sum(e["args"]["bytes"] for e in rows))


class _TiledCanvases:
    """``n`` 200 px canvases: 256 synthetic faces, each row rolled by its
    tile index (every row distinct), for the resident-cache run."""

    def __init__(self, n, seed=0):
        from pcgan_tpu_torch.data.synthetic import SyntheticAgingDataset
        base = SyntheticAgingDataset(size=256, native=NATIVE, seed=seed)
        self.tiles = [base.get_raw(i) for i in range(256)]
        self.n = n

    def __len__(self):
        return self.n

    def get_raw(self, i):
        t = self.tiles[i % 256]
        return {"image": np.roll(t["image"], i // 256, axis=1),
                "age": t["age"]}


def _loader_rate(torch, cfg, state, step, ld, what) -> dict:
    """Steps/s of ``ld``'s batches through train_main's own upload (or
    gather), B1 and the step: CACHE_WARM warm-up steps, then CACHE_STEPS
    timed ones."""
    from pcgan_tpu_torch import train_main
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    pre = make_preprocess(cfg, train=True)
    cp.launches = 0
    it = train_main._epoch_batches(cfg, ld)
    t0 = None
    for i in range(CACHE_WARM + CACHE_STEPS):
        if i == CACHE_WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        raw = next(it)
        batch = pre(state.generator,
                    {"image": train_main._to_device(raw["image"], DEV)})
        batch["bin"] = train_main._to_device(raw["bin"], DEV)
        step(state, batch)
    torch.cuda.synchronize()
    rate = CACHE_STEPS / (time.perf_counter() - t0)
    it.close()
    check(cp.launches == CACHE_WARM + CACHE_STEPS,
          f"{what}: {cp.launches} B1 launches")
    return {"steps_per_s": rate, "b1_launches": cp.launches}


def _summing(to_device, sums):
    """``train_main._to_device`` that also appends a checksum of every u8
    image batch of path 4's size it uploads (or passes on, gathered) to
    ``sums``."""
    def spy(v, device):
        t = to_device(v, device)
        if (t.dim() == 4 and t.shape[0] == REAL_B
                and not t.is_floating_point()):
            w = t.long()
            sums.append(int(w.sum()) + 7 * int(w[:, ::7, ::5].sum()))
        return t
    return spy


def _state_diff(torch, path_a, path_b) -> list:
    """The keys of two checkpoints whose tensors are not bit-identical."""
    def flat(v, key=""):
        if isinstance(v, dict):
            for k, x in v.items():
                yield from flat(x, f"{key}/{k}")
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                yield from flat(x, f"{key}/{i}")
        else:
            yield key, v
    a, b = [dict(flat(torch.load(p, map_location="cpu", weights_only=True)))
            for p in (path_a, path_b)]
    bad = sorted(set(a) ^ set(b))
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        same = (torch.equal(x, y) if isinstance(x, torch.Tensor)
                and isinstance(y, torch.Tensor) else x == y)
        if not same:
            bad.append(k)
    return bad


def _device_cache(torch, tmp, folder, bundle_dir) -> dict:
    """(f) --device_cache at path 4's flags over the folder: two streaming
    runs give the same losses and the same final state (parameters, Adam
    moments) bit for bit, the batches and the loss stream of a cached run
    equal the streaming run's bit for bit, one more streaming run under
    ``torch.use_deterministic_algorithms(True)`` (which raises at any op
    with no deterministic CUDA kernel), steps/s both ways, host-to-device
    bytes per step from a --profile_steps 4 trace of each; then a resident
    cache of CACHE_N synthetic canvases from a pack: its decode and upload
    seconds, and steps/s against the host Loader at batch 32."""
    from pcgan_tpu_torch import train_main
    from pcgan_tpu_torch.data.device_cache import DeviceCacheLoader
    from pcgan_tpu_torch.data.loader import Loader, create_dataset
    from pcgan_tpu_torch.data.packed import write_pack
    cond = ("--comparator_path", bundle_dir)
    out, launches, runs = {}, {}, {}
    steps = 2 * REAL_STEPS
    real_to_device = train_main._to_device
    # cuDNN's deterministic algorithms; the pads and the comparison loss
    # differentiate without atomics (ops/pad.py), so the runs repeat bit
    # for bit
    torch.backends.cudnn.deterministic = True
    try:
        for name, extra in (("stream", ()), ("stream_strict", ()),
                            ("cache", ("--device_cache",)),
                            ("stream_profiled", ("--profile_steps", "4")),
                            ("cache_profiled", ("--device_cache",
                                                "--profile_steps", "4"))):
            sums = []
            train_main._to_device = _summing(real_to_device, sums)
            strict = name == "stream_strict"
            if strict:
                # every op of the step must have a deterministic CUDA
                # kernel: torch raises at one that has not (cuBLAS asks for
                # a fixed workspace first)
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
                torch.use_deterministic_algorithms(True)
            try:
                res, b1, b2, wall = _train_run(torch, _real_argv(
                    tmp, folder, f"cache_{name}", 2, cond + extra))
            finally:
                train_main._to_device = real_to_device
                if strict:
                    torch.use_deterministic_algorithms(False)
                    os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            check(res["step"] == steps and b1 == steps and b2 == 0
                  and len(sums) == steps,
                  f"cache {name}: {res['step']} steps, {b1} B1 / {b2} B2 "
                  f"launches, {len(sums)} batches seen")
            run_dir = os.path.join(tmp, "real", f"cache_{name}")
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                losses = [{k: v for k, v in json.loads(line).items()
                           if k.startswith("loss")} for line in f]
            runs[name] = {"sums": sums, "losses": losses, "wall_s": wall,
                          "rates": _epoch_rates(res["epochs"])}
            if name.endswith("profiled"):
                trace = os.path.join(run_dir, "trace", "trace.json")
                runs[name]["h2d_bytes_per_step"] = _h2d_bytes(trace) / 4
            launches[name] = b1
    finally:
        torch.backends.cudnn.deterministic = False
    check(all(runs[n]["sums"] == runs["stream"]["sums"] for n in runs),
          "device cache: the batches differ from the streaming run's")

    def gap(a, b):
        return max(abs(x[k] - y[k]) / max(1.0, abs(y[k]))
                   for x, y in zip(a, b) for k in y)
    s, c = runs["stream"]["losses"], runs["cache"]["losses"]
    check(len(s) == len(c) > 0 and all(set(a) == set(b)
                                       for a, b in zip(s, c)),
          "device cache: metrics rows differ in shape")
    # the second streaming run is the traced one: tracing reads the step,
    # it does not change it
    again = runs["stream_profiled"]["losses"]
    state_diff = _state_diff(torch, *[
        os.path.join(tmp, "real", f"cache_{n}", "latest.pt")
        for n in ("stream", "stream_profiled")])
    check(again == s and not state_diff,
          f"two streaming runs differ: losses {gap(again, s)} apart, state "
          f"tensors {state_diff[:8]}")
    diff = gap(c, s)
    identical = c == s
    check(identical, f"device cache: loss stream {diff} from the streaming "
          f"run's (bit for bit wanted)")
    strict_same = runs["stream_strict"]["losses"] == s
    out["loss_stream"] = {
        "identical": identical, "max_rel_gap": diff,
        "stream_vs_stream_identical": True,
        "stream_vs_stream_state_identical": True,
        "strict_deterministic_ran": True,
        "strict_identical": strict_same,
        "cache_profiled_max_rel_gap": gap(runs["cache_profiled"]["losses"],
                                          s)}
    out["runs"] = {n: {k: v for k, v in r.items() if k != "sums"}
                   for n, r in runs.items()}
    say(f"device cache (path 4's flags, {steps} steps): two streaming runs "
        f"bit-identical in losses and in the final state; the run under "
        f"use_deterministic_algorithms raised nothing (losses identical "
        f"{strict_same}); the cached run's batches and loss stream "
        f"bit-identical to the streaming run's; epoch-2 steps/s "
        f"stream {runs['stream']['rates']['pooled']:.3f}, cache "
        f"{runs['cache']['rates']['pooled']:.3f}; host-to-device bytes per "
        f"step stream {runs['stream_profiled']['h2d_bytes_per_step']:.0f}, "
        f"cache {runs['cache_profiled']['h2d_bytes_per_step']:.0f}")

    # a resident cache of CACHE_N canvases, and the host Loader over them
    pack = os.path.join(tmp, "cache_pack")
    t0 = time.perf_counter()
    write_pack(_TiledCanvases(CACHE_N), pack, num_threads=8)
    pack_s = time.perf_counter() - t0
    argv = _lever_argv(tmp, "cache_big", 1, extra=(
        "--dataset_mode", "packed", "--dataroot", pack,
        "--max_dataset_size", str(CACHE_N)))
    cfg, state, step = _lever_state(torch, argv)
    ds = create_dataset(cfg, train=True)
    dc = DeviceCacheLoader(cfg, ds, DEV, seed=0)
    check(dc.nbytes >= CACHE_N * NATIVE * NATIVE * C,
          f"resident cache: {dc.nbytes} bytes")
    big = {"rows": CACHE_N, "gb": dc.nbytes / 1e9, "pack_s": pack_s,
           "decode_s": dc.decode_s, "upload_s": dc.upload_s,
           "upload_gb_per_s": dc.nbytes / 1e9 / dc.upload_s}
    big["cache"] = _loader_rate(torch, cfg, state, step, dc, "cache rate")
    del dc
    torch.cuda.empty_cache()
    host = Loader(ds, cfg.data.batch_size, shuffle=True,
                  num_threads=cfg.data.num_threads, seed=0)
    big["host_loader"] = _loader_rate(torch, cfg, state, step, host,
                                      "host Loader rate")
    big["cache_over_host"] = (big["cache"]["steps_per_s"]
                              / big["host_loader"]["steps_per_s"])
    launches["resident_cache"] = big["cache"]["b1_launches"]
    launches["resident_host"] = big["host_loader"]["b1_launches"]
    del state, step
    torch.cuda.empty_cache()
    out["resident"] = big
    say(f"resident cache of {CACHE_N} canvases ({big['gb']:.3f} GB): decode "
        f"{big['decode_s']:.2f} s, upload {big['upload_s']:.3f} s "
        f"({big['upload_gb_per_s']:.2f} GB/s); steps/s at batch 32 cache "
        f"{big['cache']['steps_per_s']:.3f} against the host Loader's "
        f"{big['host_loader']['steps_per_s']:.3f} "
        f"(x{big['cache_over_host']:.3f})")
    out["launches"] = launches
    return out


def phase_variants(torch, tmp, folder, bundle_dir, plain) -> dict:
    """Phase 19: the generator variants and the device cache at full
    width: (a) unet_128, (b) unet_256 remat, (c) resize_conv + g_attn, (d)
    the JAX default routes against --no-lowch_matmul at path 4's flags and
    the tail's three forms, (e) card-vs-CPU parity, (f) --device_cache.
    ``plain``: phase 18's profiled plain resnet step at the same shape."""
    t0 = time.perf_counter()
    out, launches = {}, {}
    out["unet_128"] = _unet128(torch, tmp, plain)
    launches.update({f"unet_128_{k}": v for k, v in
                     out["unet_128"]["launches"].items()})
    out["unet_256_remat"] = _unet256_remat(torch, tmp)

    prof = _profile_train(torch, tmp, steps=2, argv=_variant_argv(
        tmp, "resize_attn_profile", 2, "resnet_9blocks@resize_conv", steps=2,
        extra=("--g_attn",)), what="resize_conv + g_attn step")
    _b2_after("resize_conv + g_attn")
    launches["resize_attn_profile"] = prof["launches"]
    out["resize_attn"] = {
        "profile": prof,
        "over_plain_device_ms": (prof["device_ms_per_step"]
                                 / plain["device_ms_per_step"]),
        "over_plain_launches": (prof["device_launches_per_step"]
                                / plain["device_launches_per_step"])}
    ra = out["resize_attn"]
    say(f"resize_conv + g_attn: x{ra['over_plain_device_ms']:.3f} the plain "
        f"step's device ms, x{ra['over_plain_launches']:.3f} its launches")

    cond = ("--comparator_path", bundle_dir)
    routes = {}
    for name, extra in (("lowch", ()), ("direct", ("--no-lowch_matmul",))):
        routes[name] = _profile_train(
            torch, tmp, steps=REAL_STEPS, what=f"path 4 step ({name})",
            argv=_real_argv(tmp, folder, f"routes_{name}", 2, cond + extra))
        _b2_after(f"routes {name}")
        launches[f"routes_{name}"] = routes[name]["launches"]
    routes["lowch_over_direct_device_ms"] = (
        routes["lowch"]["device_ms_per_step"]
        / routes["direct"]["device_ms_per_step"])
    routes["tail"] = _tail_forms(torch)
    out["routes"] = routes
    say(f"JAX default routes at path 4's flags: device "
        f"{routes['lowch']['device_ms_per_step']:.3f} ms a step against "
        f"{routes['direct']['device_ms_per_step']:.3f} with "
        f"--no-lowch_matmul (x{routes['lowch_over_direct_device_ms']:.3f})")

    out["parity"] = _variant_parity(torch)
    out["cache"] = _device_cache(torch, tmp, folder, bundle_dir)
    launches.update({f"cache_{k}": v for k, v in
                     out["cache"]["launches"].items()})
    out["launches_per_run"] = launches
    out["b2_tail_launches"] = routes["tail"]["b2_launches"]
    out["seconds"] = time.perf_counter() - t0
    say(f"phase 19 (generator variants, device cache): "
        f"{out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------- #
# phase 20: the tools on the card
# --------------------------------------------------------------------------- #

TOOLS_B = 64                      # bench.py's headline batch at 128 px
TOOLS_E2E_STEPS = 10              # each --e2e run's timed steps
PROFILE_STEPS = 6                 # profile_step's traced steps
PROFILE_TOL = 0.15                # its device ms a step vs _profile_train's
COVER_MIN = 0.95                  # the floor's share of the device ms a step
FLOOR_MIN = 0.95                  # no op below its floor by more than 5%
OOM_FRACTION = 0.005              # of the card: 0.4 GB, below any step
SWEEP_ARGV = ["--dataset_mode", "synthetic", "--max_dataset_size", "8",
              "--batch_size", "4", "--netG", "resnet_6blocks", "--ngf", "8",
              "--ndf", "8", "--crop_size", "32", "--load_size", "36",
              "--n_age_bins", "4", "--niter", "1", "--niter_decay", "0",
              "--print_freq", "1"]


def _counted(torch, fn, *args):
    """fn(*args) with B1's and B2's counts zeroed before and read after:
    (result, B1 launches)."""
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    cp.launches = cw.launches = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = fn(*args)
    torch.cuda.synchronize()
    check(cw.launches == 0, f"tools: {cw.launches} B2 launches")
    return out, cp.launches


def _bench_line(torch, argv, metric, launches_want):
    from pcgan_tpu_torch import bench
    line, b1 = _counted(torch, bench.main, argv)
    check(line["metric"] == metric, f"bench {argv}: metric {line['metric']}, "
          f"want {metric}")
    check(bool(np.isfinite(line["value"])) and line["value"] > 0,
          f"bench {argv}: value {line['value']}")
    check(line["device"] == torch.cuda.get_device_name(0),
          f"bench {argv}: device {line['device']}")
    check(b1 == launches_want, f"bench {argv}: {b1} B1 launches, want "
          f"{launches_want}")
    say(f"bench {' '.join(argv) or '(headline)'}: {json.dumps(line)}; "
        f"B1 launches {b1}")
    return line, b1


def _tools_bench(torch) -> tuple:
    """(a) every mode of the bench at bench.py's config."""
    out, launches = {}, {}
    head, launches["headline"] = _bench_line(
        torch, ["--skip_e2e"], f"train_imgs_per_sec_per_chip_{CROP}px",
        3 + 30)
    out["headline"] = head
    out["headline_wall_ms_per_step"] = TOOLS_B / head["value"] * 1e3
    steps = ["--steps", str(TOOLS_E2E_STEPS)]
    for flags, tag in ((["--e2e"], "_e2e"), (["--e2e", "--packed"],
                                            "_e2e_packed"),
                       (["--e2e", "--device_cache"], "_e2e_cached")):
        out[tag[1:]], launches[tag[1:]] = _bench_line(
            torch, flags + steps, f"train_imgs_per_sec_per_chip_{CROP}px{tag}",
            3 + TOOLS_E2E_STEPS)
    for flags, tag in ((["--infer"], ""), (["--infer", "--serving"],
                                           "_serving"),
                       (["--infer", "--quant_int8"], "_int8")):
        out["infer" + tag], _ = _bench_line(
            torch, flags, f"infer_imgs_per_sec_per_chip_{CROP}px{tag}", 0)
    lat, _ = _bench_line(torch, ["--latency"], f"sample_latency_p50_{CROP}px",
                         0)
    check(lat["device_ms"] is not None and lat["device_ms"] > 0
          and lat["p99_ms"] >= lat["value"],
          f"bench --latency: device_ms {lat['device_ms']}, p99 "
          f"{lat['p99_ms']}")
    out["latency"] = lat
    say(f"bench headline {head['value']} imgs/s at batch {TOOLS_B} "
        f"({out['headline_wall_ms_per_step']:.2f} ms a step, B1 in the "
        f"timed loop); e2e {out['e2e']['value']}, packed "
        f"{out['e2e_packed']['value']}, cached {out['e2e_cached']['value']}; "
        f"infer {out['infer']['value']}, serving "
        f"{out['infer_serving']['value']}, int8 {out['infer_int8']['value']}"
        f" imgs/s; latency p50 {lat['value']} p99 {lat['p99_ms']} ms, "
        f"device {lat['device_ms']} ms")
    return out, launches


def _bench_train_argv(tmp, name, steps):
    """train_main at bench.py's headline config over the synthetic set."""
    return ["--dataset_mode", "synthetic", "--max_dataset_size",
            str(TOOLS_B * steps), "--batch_size", str(TOOLS_B), "--netG",
            NETG, "--ngf", str(NGF), "--ndf", "64", "--crop_size", str(CROP),
            "--load_size", str(LOAD), "--n_age_bins", str(NB), "--dtype",
            "bfloat16", "--pool_size", str(TOOLS_B), "--niter", "2",
            "--niter_decay", "0", "--print_freq", str(steps),
            "--save_epoch_freq", "1", "--name", name,
            "--checkpoints_dir", os.path.join(tmp, "tools")]


def _tools_profile_step(torch, tmp, head_ms) -> tuple:
    """(b) profile_step: its classes, its step time against the headline's
    wall time, its device ms against an independent profiler read."""
    from pcgan_tpu_torch.tools import profile_step
    trace_dir = os.path.join(tmp, "tools", "profile_step")
    rep, b1 = _counted(torch, profile_step.main, [
        "--steps", str(PROFILE_STEPS), "--trace_dir", trace_dir])
    check(b1 == 5 + PROFILE_STEPS, f"profile_step: {b1} B1 launches")
    check(rep["steps"] == PROFILE_STEPS and rep["total_device_us"] > 0,
          f"profile_step: {rep['steps']} steps, {rep['total_device_us']} "
          f"device us")
    pct = sum(c["pct"] for c in rep["by_class"].values())
    check(abs(pct - 100) <= 0.01 * len(rep["by_class"]),
          f"profile_step: class shares sum to {pct}")
    roof = rep["roofline"]
    check(roof["device_ms_per_step"] <= head_ms,
          f"profile_step: {roof['device_ms_per_step']} device ms a step > "
          f"the headline's {head_ms:.3f} ms wall a step")
    indep = _profile_train(torch, tmp, steps=2, argv=_bench_train_argv(
        tmp, "bench_profile", 2), what="bench-config")
    ratio = roof["device_ms_per_step"] / indep["device_ms_per_step"]
    say(f"profile_step: {roof['device_ms_per_step']} device ms a step, "
        f"mean step span {rep['mean_step_ms']} ms (headline wall "
        f"{head_ms:.3f} ms), independent read "
        f"{indep['device_ms_per_step']:.3f} ms: x{ratio:.4f} (limit "
        f"1 +- {PROFILE_TOL}); classes "
        + ", ".join(f"{k} {v['pct']}%" for k, v in rep["by_class"].items()))
    say(f"roofline: floor {roof['floor_ms_per_step']} ms a step, "
        f"ratio_to_floor {roof['ratio_to_floor']}, covered "
        f"{roof['covered_share']} of the device ms "
        f"({roof['counted_ms_per_step']} of {roof['device_ms_per_step']}; "
        f"uncounted {roof['uncounted_ms_per_step']} ms), the lowest op "
        f"x{roof['min_op_ratio']} its floor")
    for o in roof["ops"][:12]:
        say(f"  {o['us'] / PROFILE_STEPS:10.1f} us/step  floor "
            f"{o['floor_us'] / PROFILE_STEPS:9.1f}  x{o['ratio']}  {o['op']}")
    check(abs(ratio - 1) <= PROFILE_TOL,
          f"profile_step: device ms a step x{ratio:.4f} the independent "
          f"read's")
    check(roof["covered_share"] is not None
          and roof["covered_share"] >= COVER_MIN,
          f"roofline: the floor covers {roof['covered_share']} of the "
          f"device ms a step, want >= {COVER_MIN}")
    low = [o for o in roof["ops"] if o["ratio"] is not None
           and o["ratio"] < FLOOR_MIN]
    check(roof["min_op_ratio"] is not None and not low
          and roof["min_op_ratio"] >= FLOOR_MIN,
          f"roofline: ops under {FLOOR_MIN}x their floor (a miscounted "
          f"cost): {low}, lowest x{roof['min_op_ratio']}")
    for t in rep["top_ops"][:10]:
        say(f"  {t['us'] / PROFILE_STEPS:10.1f} us/step {t['launches'] / PROFILE_STEPS:6.1f} "
            f"launches/step  {t['category']:<28s} {t['kernel'][:80]}")
    rep.pop("trace_file")
    return {"report": rep, "independent": indep, "ratio": ratio}, {
        "profile_step": b1, "profile_step_check": indep["launches"]}


def _tools_tune(torch) -> tuple:
    """(d) tune_batch over 32 and 64, then one candidate under a memory cap:
    out of memory on every rung of the ladder."""
    import gc
    from pcgan_tpu_torch.tools import tune_batch
    out, b1 = _counted(torch, tune_batch.main, [
        "--size", "128", "--candidates", "32,64", "--steps", "3"])
    check(all(r.get("imgs_per_sec_per_chip", 0) > 0 for r in out["rows"])
          and out["best"] is not None,
          f"tune_batch: rows {out['rows']}, best {out['best']}")
    tried = []
    measure = tune_batch.try_measure

    def recording(cfg, steps, warmup=3):
        tried.append((cfg.model.remat, cfg.train.grad_accum))
        return measure(cfg, steps, warmup)

    gc.collect()
    torch.cuda.empty_cache()
    tune_batch.try_measure = recording
    torch.cuda.set_per_process_memory_fraction(OOM_FRACTION, 0)
    try:
        capped, b1c = _counted(torch, tune_batch.main, [
            "--size", "128", "--candidates", "64", "--steps", "3"])
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, 0)
        tune_batch.try_measure = measure
    row = capped["rows"][0]
    check(capped["best"] is None and "out of memory" in row.get("error", "")
          and tried == [(False, 1), (True, 1), (True, 2), (True, 4)],
          f"tune_batch capped to {OOM_FRACTION} of the card: row {row}, "
          f"rungs {tried}")
    say(f"tune_batch: {json.dumps(out)}; capped to {OOM_FRACTION} of the "
        f"card: rungs {tried}, DOES NOT FIT ({row['error'][:60]}...)")
    return {"run": out, "capped": capped, "rungs": tried}, {
        "tune_batch": b1, "tune_batch_capped": b1c}


def _tools_memory_plan(torch) -> tuple:
    """(e) memory_plan --sweep at 256 px, batch 64: remat and accumulation
    4 below the base row's peak."""
    from pcgan_tpu_torch.tools import memory_plan
    out, b1 = _counted(torch, memory_plan.main, [
        "--size", "256", "--batch", "64", "--sweep"])
    rows = {(r["remat"], r["grad_accum"]): r for r in out["rows"]}
    check(all(r.get("peak_gib") for r in out["rows"]),
          f"memory_plan: rows {out['rows']}")
    base = rows[(False, 1)]["peak_gib"]
    ratios = {f"remat={int(k[0])} accum={k[1]}": r["peak_gib"] / base
              for k, r in rows.items()}
    check(rows[(True, 1)]["peak_gib"] < base
          and rows[(False, 4)]["peak_gib"] < base,
          f"memory_plan: peaks {ratios} of the base row's")
    say(f"memory_plan 256 px batch 64 (measured, limit "
        f"{out['hbm_limit_gib']} GiB): base peak {base} GiB; "
        + ", ".join(f"{k} x{v:.3f}" for k, v in ratios.items())
        + " (phase 18 at 128/256 px: accumulation 0.48x, remat 0.51x)")
    return {"run": out, "peak_over_base": ratios}, {"memory_plan": b1}


def _tools_doctor(torch) -> dict:
    """(f) doctor: the kernels built, the device check, the card's line."""
    from pcgan_tpu_torch.tools import doctor
    rep, _ = _counted(torch, doctor.main, [])
    check(rep["device_check"] == "ok"
          and rep["kernels"] == {"B1 preprocess": "built",
                                 "B2 wgrad": "built",
                                 "N1 instance norm": "built"}
          and rep["card"] == torch.cuda.get_device_name(0)
          and rep["power_limit"],
          f"doctor: {rep}")
    say(f"doctor: {rep['card']}, {rep['memory_gib']} GiB, power "
        f"{rep['power_limit']}; nvcc {rep['nvcc']}; decoder "
        f"{rep['jpeg_decoder'][:60]}; device check {rep['device_check']}")
    return rep


def _tools_pth_case(torch, tmp, netG, inject, run_dir=None) -> dict:
    """Export a G to .pth through the mirror template, import it back
    (bit-identical), and the mirror's f32 forward on the exported weights
    against the port's G on the card."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_G
    from pcgan_tpu_torch.tools import export_pth, import_pth
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    from pcgan_tpu_torch.utils import pth_mirror
    arch = ["--netG", netG, "--ngf", str(NGF), "--norm", "instance",
            "--cond_inject", inject, "--crop_size", str(CROP),
            "--n_age_bins", str(NB)]
    cfg = parse_config(arch + ["--dtype", "float32"], is_train=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        G = define_G(cfg, torch.Generator().manual_seed(7))
    ck = os.path.join(tmp, "tools", "pth")
    if run_dir is None:
        name = f"seeded_{netG}"
        ckpt.save_generator(G, ck, name)
    else:                                   # a trained run's checkpoint
        ck, name = os.path.split(run_dir)
        ckpt.restore_generator(G, ck, name)
    pth = os.path.join(tmp, "tools", f"{netG}_net_G.pth")
    export_pth.main(["--name", name, "--checkpoints_dir", ck, "--out", pth,
                     *arch])
    back = import_pth.main(["--pth", pth, "--name", f"back_{netG}",
                            "--checkpoints_dir", os.path.join(tmp, "tools",
                                                              "pth"), *arch])
    got = torch.load(back, weights_only=True)
    want = G.state_dict()
    check(set(got) == set(want) and all(torch.equal(got[k], v)
                                        for k, v in want.items()),
          f"pth {netG}: the round trip is not bit-identical")
    sd = torch.load(pth, weights_only=True)
    stem = 3 + (NB if inject == "input" else 0)
    if netG.startswith("unet_"):
        mirror = pth_mirror.build_unet(stem, 3, int(netG[5:]).bit_length()
                                       - 1, ngf=NGF)
    else:
        mirror = pth_mirror.ResnetG(stem, 3, ngf=NGF,
                                    n_blocks=int(netG.split("_")[1][0]),
                                    cond_nc=NB, cond_inject=inject)
    mirror.load_state_dict(sd)
    mirror, G = mirror.to(DEV).eval(), G.to(DEV).eval()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (4, CROP, CROP, 3)).astype(
        np.float32)).to(DEV)
    c = torch.from_numpy(np.eye(NB, dtype=np.float32)[
        [0, NB // 3, 2 * NB // 3, NB - 1]]).to(DEV)
    with torch.no_grad():
        y = G(x, c)
        xin = x.permute(0, 3, 1, 2)
        if inject == "input":
            cmap = c[:, :, None, None].expand(-1, -1, CROP, CROP)
            ym = mirror(torch.cat([xin, cmap], 1))
        else:
            ym = mirror(xin, c)
        err = float((ym.permute(0, 2, 3, 1) - y).abs().max())
    check(err <= PARITY_TOL, f"pth {netG}: mirror vs port G max err {err:.3g}")
    say(f"pth {netG} ({inject}, {'trained' if run_dir else 'seeded'}): "
        f"{len(sd)} tensors exported, imported back bit-identical, mirror "
        f"f32 forward vs the port's G on the card max err {err:.3g}")
    return {"tensors": len(sd), "max_abs_err": err}


def _tools_run_tools(torch, tmp) -> tuple:
    """(h) SWA over phase 8's epoch tags and a grid from it, the plots over
    phase 14's and phase 8's metrics, a two-combination sweep (the runs
    and the best of them)."""
    from pcgan_tpu_torch import test as port_test
    from pcgan_tpu_torch.tools import (average_ckpts, compare_runs,
                                       plot_losses, sweep)
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    out = {}
    train = os.path.join(tmp, "train")
    average_ckpts.main(["--checkpoints_dir", train, "--name", "smoke_train",
                        "--tags", "epoch_2,epoch_3", "--out", "swa"])
    sds = [torch.load(ckpt.generator_path(train, "smoke_train", t),
                      weights_only=True) for t in ("epoch_2", "epoch_3",
                                                   "swa")]
    for k, v in sds[2].items():
        want = ((sds[0][k].double() + sds[1][k].double()) / 2).float()
        check(torch.equal(v, want if average_ckpts.is_param(k, v)
                          else sds[1][k]), f"average_ckpts: {k}")
    argv = _argv(tmp, "smoke_train", "bottleneck", num_test=16)
    argv[argv.index("--checkpoints_dir") + 1] = train
    res, b1 = _counted(torch, port_test.main, argv + ["--epoch", "swa"])
    check(b1 == 2 and res["done"] == 16,
          f"test --epoch swa: {res['done']} grids, {b1} B1 launches")
    out["swa_grids"] = res["done"]
    real = os.path.join(tmp, "real", "real_utk128")
    svg = plot_losses.main([real, "--out", os.path.join(tmp, "tools",
                                                        "loss.svg")])
    cmp_svg = compare_runs.main([
        "--runs", f"{real},{os.path.join(train, 'smoke_train')}", "--key",
        "loss_G", "--out", os.path.join(tmp, "tools", "compare.svg")])
    with open(svg) as f, open(cmp_svg) as g:
        n_plot, n_cmp = f.read().count("<polyline"), g.read().count(
            "<polyline")
    check(n_plot >= 4 and n_cmp == 2,
          f"plot_losses {n_plot} series, compare_runs {n_cmp}")
    t0 = time.perf_counter()
    rc = sweep.main(["--grid", "lambda_L1=50,100", "--name", "sw",
                     "--checkpoints_dir", os.path.join(tmp, "tools",
                                                       "sweep"), "--",
                     *SWEEP_ARGV])
    with open(os.path.join(tmp, "tools", "sweep", "sw_sweep.json")) as f:
        summary = json.load(f)
    check(rc == 0 and [r["returncode"] for r in summary["runs"]] == [0, 0]
          and all(np.isfinite(r["metrics"]["loss_G"])
                  for r in summary["runs"]),
          f"sweep: rc {rc}, {summary['runs']}")
    low = min(summary["runs"], key=lambda r: r["metrics"]["loss_G"])
    check(summary["best"] == low["name"], f"sweep: best {summary['best']}, "
          f"lowest loss_G {low['name']}")
    out.update(plot_series=n_plot, compare_series=n_cmp,
               sweep_s=time.perf_counter() - t0, sweep_best=summary["best"])
    say(f"run tools: SWA of epochs 2-3 = their mean, {res['done']} grids "
        f"from it; loss plot {n_plot} series, comparison {n_cmp}; sweep of "
        f"2 combinations in {out['sweep_s']:.1f} s, best {summary['best']}")
    return out, {"test_swa": b1}


def phase_tools(torch, tmp) -> dict:
    """Phase 20: every ported tool through its main(argv) on the card, at
    bench.py's config unless stated."""
    t_phase = time.perf_counter()
    out, launches = {}, {}
    out["bench"], la = _tools_bench(torch)
    launches.update(la)
    head_ms = out["bench"]["headline_wall_ms_per_step"]
    out["profile_step"], la = _tools_profile_step(torch, tmp, head_ms)
    launches.update(la)
    from pcgan_tpu_torch.tools import profile_e2e
    rep, launches["profile_e2e"] = _counted(torch, profile_e2e.main,
                                            ["--steps", "10"])
    stages = ("decode_ms_per_batch", "with_bins_ms", "upload_ms",
              "dispatch_ms", "step_ms", "e2e_ms")
    check(all(rep[k] > 0 for k in stages) and launches["profile_e2e"] == 36,
          f"profile_e2e: {rep}, {launches['profile_e2e']} B1 launches")
    say(f"profile_e2e: {json.dumps(rep)}")
    out["profile_e2e"] = rep
    out["tune_batch"], la = _tools_tune(torch)
    launches.update(la)
    out["memory_plan"], la = _tools_memory_plan(torch)
    launches.update(la)
    out["doctor"] = _tools_doctor(torch)
    out["pth"] = {"resnet_9blocks": _tools_pth_case(
        torch, tmp, NETG, "bottleneck")}
    unet = os.path.join(tmp, "levers", "unet128")
    if os.path.isfile(os.path.join(unet, "latest_G.pt")):
        out["pth"]["unet_128"] = _tools_pth_case(torch, tmp, "unet_128",
                                                 "input", run_dir=unet)
    out["run_tools"], la = _tools_run_tools(torch, tmp)
    launches.update(la)
    out["launches_per_run"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase 20 (tools): {out['seconds']:.1f} s; B1 launches {launches}")
    return out


# --------------------------------------------------------------------------- #
# phase 21: the repaired step and roofline, --dtype float16, the leftovers
# --------------------------------------------------------------------------- #

# before the fold, on an H100 80GB HBM3 at 700 W: ATen's atomic pad
# backward in a bench step, and train_imgs_per_sec_per_chip_128px
ATEN_PAD_BWD_MS = 9.4
ATEN_PAD_HEADLINE = 516.75
F16_STEPS = 2                     # an epoch of the profiled f16 run (as
                                  # phase 18's profiled plain step)
# the f16 G, card against CPU, at the CPU test's shape and limits
# (tests/test_torch_port_f16.py: max 6.25e-3, mean 6.25e-4)
F16_MAX, F16_MEAN = 6.25e-3, 6.25e-4
PAD_NODES = ("ReflectPad2dBackward", "ReplicatePad2dBackward")


def _pad_backward_ms(trace_dir, steps) -> tuple:
    """(device ms a step, kernels a step, pad backward calls a step) of the
    kernels launched inside the port's pad Functions' backward nodes in a
    ``utils.profiling.trace``."""
    import collections
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    ops, ranges = {}, collections.defaultdict(list)
    for e in events:
        if e.get("cat") != "cpu_op" or "dur" not in e:
            continue
        ops[e.get("args", {}).get("External id")] = e
        if e["name"] in PAD_NODES:
            t0 = float(e["ts"])
            ranges[(e["pid"], e["tid"])].append((t0, t0 + float(e["dur"])))
    us = kernels = 0
    for e in events:
        if e.get("cat") != "kernel" or "dur" not in e:
            continue
        op = ops.get(e.get("args", {}).get("External id"))
        if op is None:
            continue
        t = float(op["ts"])
        if any(a <= t <= b for a, b in ranges[(op["pid"], op["tid"])]):
            us += float(e["dur"])
            kernels += 1
    calls = sum(len(v) for v in ranges.values())
    return us / steps / 1e3, kernels / steps, calls / steps


def _f16_runs(torch, tmp, bf16) -> tuple:
    """(c) phase 18's plain step shape in f16, profiled for 2 x F16_STEPS
    steps (every loss finite, B1's launches, device ms, launches and
    window a step) beside ``bf16``, phase 18's profiled plain step at the
    same shape."""
    prof = _profile_train(torch, tmp, steps=F16_STEPS, what="f16 plain step",
                          argv=_lever_argv(tmp, "dtype_f16", 2,
                                           steps=F16_STEPS, extra=(
                                               "--dtype", "float16",
                                               "--print_freq", "1")))
    rows = _lever_rows(os.path.join(tmp, "levers", "dtype_f16"),
                       ("loss_G", "loss_D", "loss_G_GAN", "loss_G_L1",
                        "loss_D_real", "loss_D_fake"), "f16 run")
    check(len(rows) == 2 * F16_STEPS,
          f"f16 run: {len(rows)} metrics rows, want {2 * F16_STEPS}")
    keys = ("device_ms_per_step", "device_launches_per_step",
            "window_ms_per_step", "device_busy_share")
    out = {"float16": {"b1_launches": prof["launches"],
                       "finite_steps": len(rows),
                       "last_losses": {k: v for k, v in rows[-1].items()
                                       if k.startswith("loss")},
                       **{k: prof[k] for k in keys}},
           "bfloat16": {k: bf16[k] for k in keys}}
    f16, bf = out["float16"], out["bfloat16"]
    out["f16_over_bf16_device_ms"] = (f16["device_ms_per_step"]
                                      / bf["device_ms_per_step"])
    say(f"--dtype float16 at phase 18's plain shape: {f16['finite_steps']} "
        f"finite steps, B1 {f16['b1_launches']} launches; "
        f"{f16['device_ms_per_step']:.3f} device ms, "
        f"{f16['device_launches_per_step']:.1f} launches and "
        f"{f16['window_ms_per_step']:.3f} ms window a step "
        f"({1e3 / f16['window_ms_per_step']:.3f} steps/s), against phase "
        f"18's bf16 {bf['device_ms_per_step']:.3f} device ms, "
        f"{bf['device_launches_per_step']:.1f} launches, "
        f"{bf['window_ms_per_step']:.3f} ms window "
        f"({1e3 / bf['window_ms_per_step']:.3f} steps/s) (f16 "
        f"x{out['f16_over_bf16_device_ms']:.3f} the bf16 device ms; no gain "
        f"claimed)")
    return out, {"float16_run": prof["launches"]}


F16_CASES = {   # name: (flags, rows, gated by the CPU test's limits)
    "small": (["--netG", "resnet_6blocks", "--ngf", "8", "--crop_size",
               "32", "--load_size", "36", "--n_age_bins", "4"], 2, True),
    "full": (["--netG", NETG, "--ngf", str(NGF), "--crop_size", str(CROP),
              "--load_size", str(LOAD), "--n_age_bins", str(NB)], 1, False)}
F16_CPU_S = 600     # the full-width CPU reference's limit (phases 21-22)


def _f16_case(torch, what):
    """(G in f16 on the CPU from its seed, input rows, conditions) of one
    F16_CASES case."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_G
    flags, rows, _ = F16_CASES[what]
    cfg = parse_config(flags + ["--dtype", "float16", "--cond_inject",
                                "bottleneck", "--device", "cpu"])
    G = define_G(cfg, torch.Generator().manual_seed(3)).eval()
    s, nb = cfg.data.crop_size, cfg.data.n_age_bins
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (rows, s, s, 3)).astype(
        np.float32))
    return G, x, torch.eye(nb)[rng.integers(0, nb, rows)]


def _f16_cpu_child(path: str) -> None:
    """``chip_smoke.py --f16-cpu <out.npy>``: the full-width f16 G's
    forward on the CPU (no card), written to ``out.npy``."""
    sys.path.insert(0, HERE)
    import torch
    G, x, c = _f16_case(torch, "full")
    with torch.no_grad():
        np.save(path, G(x, c).numpy())


def _f16_cpu_start(tmp):
    """Starts the full-width CPU reference in a process of its own at the
    lowest priority on 4 threads with no card (the card machines' CPU runs
    an f16 conv slowly: a 128 px row takes about a minute), so that it
    runs beside phases 21 and 22; its handle for ``_f16_full``."""
    import atexit
    path = os.path.join(tmp, "f16_cpu_full.npy")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "4"}
    log = open(path + ".log", "w")
    p = subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                          "--f16-cpu", path], env=env, stdout=log,
                         stderr=subprocess.STDOUT, preexec_fn=lambda:
                         os.nice(19))
    atexit.register(lambda: p.poll() is None and (p.kill(), p.wait()))
    return {"proc": p, "log": log, "path": path, "t0": time.perf_counter()}


def _f16_parity(torch, tmp) -> dict:
    """(c) The f16 G on the card against the same seeded weights on the
    CPU, at the CPU test's shape (resnet_6blocks, ngf 8, 32 px, 4 bins)
    within its limits; at full width (the main path's 128 px, one row) the
    card's rows, held against the CPU reference that ``_f16_cpu_start``
    computes beside phases 21-22, in ``_f16_full``."""
    import copy
    out = {"cpu_full": _f16_cpu_start(tmp)}
    for what in F16_CASES:
        G, x, c = _f16_case(torch, what)
        with torch.no_grad():
            got = copy.deepcopy(G).to(DEV)(x.to(DEV), c.to(DEV)).cpu().numpy()
            want = G(x, c).numpy() if what == "small" else None
        check(bool(np.isfinite(got).all()), f"f16 G {what} on the card: "
              f"non-finite")
        if want is None:
            out["full_card"] = got
            continue
        err = np.abs(got - want)
        out[what] = {"max": float(err.max()), "mean": float(err.mean())}
        check(err.max() <= F16_MAX and err.mean() <= F16_MEAN,
              f"f16 G card vs CPU: max {err.max()}, mean {err.mean()} "
              f"(limits {F16_MAX}, {F16_MEAN})")
    say(f"f16 G card vs CPU, same weights: CPU test's shape max "
        f"{out['small']['max']:.3e} mean {out['small']['mean']:.3e} (limits "
        f"{F16_MAX}, {F16_MEAN}); the full-width CPU reference ({CROP} px, "
        f"one row) runs beside phases 21-22")
    return out


def _f16_full(parity) -> dict:
    """Phase 21 (c)'s full-width gap, after phase 22: waits for the CPU
    reference (F16_CPU_S from its start at most) and reports the card's
    rows against it."""
    job = parity.pop("cpu_full")
    p = job["proc"]
    try:
        p.wait(timeout=max(1.0, F16_CPU_S - (time.perf_counter()
                                              - job["t0"])))
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
    finally:
        job["log"].close()
    with open(job["log"].name) as f:
        log = f.read()
    check(p.returncode == 0, f"f16 full-width CPU reference: exit "
          f"{p.returncode} after {time.perf_counter() - job['t0']:.1f} s:\n"
          f"{log[-2000:]}")
    err = np.abs(parity.pop("full_card") - np.load(job["path"]))
    parity["full"] = {"max": float(err.max()), "mean": float(err.mean()),
                      "cpu_s": time.perf_counter() - job["t0"]}
    say(f"f16 G card vs CPU at full width ({CROP} px, one row): max "
        f"{err.max():.3e} mean {err.mean():.3e} (reported; the CPU "
        f"reference done {parity['full']['cpu_s']:.1f} s after its start)")
    return parity["full"]


def _no_pallas(torch, tmp) -> dict:
    """(d) --no-pallas_pipeline: a training run on the card launches B1 no
    time; make_preprocess with the flag off equals the kernel's route on
    the same CUDA batch and draws within B1's gates, in f32 and bf16."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    steps = 4
    res, b1, b2, _ = _train_run(torch, _lever_argv(
        tmp, "no_pallas", 1, steps=steps, extra=("--no-pallas_pipeline",)))
    check(res["step"] == steps and b1 == 0 and b2 == 0,
          f"--no-pallas_pipeline run: {res['step']} steps, {b1} B1 / {b2} "
          f"B2 launches (want 0)")
    _lever_rows(os.path.join(tmp, "levers", "no_pallas"),
                ("loss_G", "loss_D"), "--no-pallas_pipeline run")
    rng = np.random.default_rng(21)
    imgs = torch.from_numpy(rng.integers(0, 256, (REAL_B, NATIVE, NATIVE, C),
                                         dtype=np.uint8)).to(DEV)
    out = {"run_b1_launches": b1, "steps": res["step"]}
    for dt, name in ((torch.float32, "float32"), (torch.bfloat16,
                                                   "bfloat16")):
        got = {}
        for flag in ("--pallas_pipeline", "--no-pallas_pipeline"):
            cfg = parse_config(["--load_size", str(LOAD), "--crop_size",
                                str(CROP), "--dtype", name, flag,
                                "--device", DEV])
            cp.launches = 0
            got[flag] = make_preprocess(cfg, train=True)(
                torch.Generator().manual_seed(5), {"image": imgs})["image"]
            torch.cuda.synchronize()
            check(cp.launches == (1 if flag == "--pallas_pipeline" else 0),
                  f"preprocess {flag}: {cp.launches} B1 launches")
        k = got["--pallas_pipeline"].float().cpu().numpy()
        t = got["--no-pallas_pipeline"].float().cpu().numpy()
        err = np.abs(k - t)
        if dt == torch.float32:
            out["f32_max_abs_err"] = float(err.max())
            check(err.max() <= F32_TOL, f"twin vs B1 f32: {err.max()}")
        else:
            out["bf16_max_ulps"] = float((err / bf16_ulp(k)).max())
            check(out["bf16_max_ulps"] <= 1.0,
                  f"twin vs B1 bf16: {out['bf16_max_ulps']} ulps")
    say(f"--no-pallas_pipeline: {steps} steps with 0 B1 launches; the plain "
        f"route on the card vs B1 on the same batch and draws (B {REAL_B}, "
        f"{NATIVE} -> {LOAD} -> {CROP}): f32 {out['f32_max_abs_err']:.3e}, "
        f"bf16 {out['bf16_max_ulps']:.2f} ulps")
    return out


def phase_leftovers(torch, tmp, levers, variants, tools) -> dict:
    """Phase 21: (a) the deterministic step (phase 19 (f)'s bit-for-bit
    checks, the pad backward's device ms in the bench's step), (b) the
    roofline (phase 20's floor and its covered share), (c) --dtype float16
    at phase 18's plain shape beside its bf16 profile, the f16 G card vs
    CPU, (d)
    --no-pallas_pipeline."""
    t0 = time.perf_counter()
    out, launches = {}, {}
    ls = variants["cache"]["loss_stream"]
    pad_ms, pad_kernels, pad_calls = _pad_backward_ms(
        os.path.join(tmp, "tools", "profile_step"), PROFILE_STEPS)
    check(pad_calls > 0 and pad_kernels > 0,
          f"no pad backward found in the bench's trace ({pad_calls} calls)")
    head = tools["bench"]["headline"]["value"]
    out["c1"] = {"stream_vs_stream_identical":
                 ls["stream_vs_stream_identical"],
                 "cache_identical": ls["identical"],
                 "strict_identical": ls["strict_identical"],
                 "pad_backward_ms_per_step": pad_ms,
                 "pad_backward_kernels_per_step": pad_kernels,
                 "pad_backward_calls_per_step": pad_calls,
                 "aten_pad_backward_ms": ATEN_PAD_BWD_MS,
                 "headline_imgs_s": head,
                 "aten_pad_headline_imgs_s": ATEN_PAD_HEADLINE}
    say(f"C1: two streaming runs and the cached run bit-identical (phase 19 "
        f"(f)); the pad backward in the bench's step {pad_ms:.3f} ms a step "
        f"({pad_calls:.0f} calls, {pad_kernels:.0f} kernels) against ATen's "
        f"{ATEN_PAD_BWD_MS} before the fold; headline {head} imgs/s against "
        f"{ATEN_PAD_HEADLINE} then")
    roof = tools["profile_step"]["report"]["roofline"]
    out["c2"] = {k: roof[k] for k in (
        "floor_ms_per_step", "device_ms_per_step", "ratio_to_floor",
        "covered_share", "min_op_ratio", "uncounted_ms_per_step")}
    out["c2"]["mean_step_ms"] = tools["profile_step"]["report"]["mean_step_ms"]
    say(f"C2: floor {roof['floor_ms_per_step']} ms of "
        f"{roof['device_ms_per_step']} device ms a step, ratio_to_floor "
        f"{roof['ratio_to_floor']}, covered {roof['covered_share']}, lowest "
        f"op x{roof['min_op_ratio']} its floor")
    out["f16"], la = _f16_runs(torch, tmp, levers["plain_profile"])
    launches.update(la)
    out["f16"]["parity"] = _f16_parity(torch, tmp)
    out["no_pallas"] = _no_pallas(torch, tmp)
    launches["no_pallas_run"] = out["no_pallas"]["run_b1_launches"]
    out["launches_per_run"] = launches
    out["seconds"] = time.perf_counter() - t0
    say(f"phase 21 (repairs, float16, leftovers): {out['seconds']:.1f} s; "
        f"B1 launches {launches}")
    return out


# --------------------------------------------------------------------------- #
# phase 22: data parallelism across processes
# --------------------------------------------------------------------------- #

DP_B, DP_STEPS = 16, 3           # (a): the two ranks' global batch, steps
DP_EVAL_N = 64                   # (a): eval rows, 4 global batches
DP_EVAL_TOL = 2e-3               # FID, two ranks vs one (the CPU tests')
DP_TIMEOUT = 240                 # s: a spawned cohort or torchrun is killed
DP8_B, DP8_STEPS = 256, 2        # (b): train_utkface_128_dp8.sh's batch
DP8_COPIES = 4                   # names a phase-14 file: 512 faces, 2 steps
DP8_EVAL_N, DP8_EVAL_B = 256, 64  # (d)
DP8_EXTRA = ()                   # flags a CPU rehearsal appends to (b)


def _dp_inputs() -> dict:
    """Phase 22 (a)'s config and inputs, which its spawned ranks read from
    a file: the default GAN at full width in f32 parity mode (pool off,
    target bins pinned by the batches; ``--cond_inject input``, the
    scripts' default, where the stem's instance norm cancels the
    condition, so the evaluator's target permutation moves no fake), and
    seeded u8 global batches: a warm-up step's, DP_STEPS steps' and the
    eval rows'."""
    rng = np.random.default_rng(22)

    def batch(targets=True):
        b = {"image": rng.integers(0, 256, (DP_B, NATIVE, NATIVE, C),
                                   dtype=np.uint8),
             "bin": rng.integers(0, NB, DP_B)}
        if targets:
            b["target_bin"] = rng.integers(0, NB, DP_B)
        return b
    return {"dev": DEV, "argv": [
        "--netG", NETG, "--ngf", str(NGF), "--netD", "basic", "--ndf",
        str(NGF), "--norm", "instance", "--crop_size", str(CROP),
        "--load_size", str(LOAD), "--n_age_bins", str(NB), "--batch_size",
        str(DP_B), "--dtype", "float32", "--pool_size", "0", "--gan_mode",
        "lsgan", "--lambda_L1", "100", "--lr_policy", "constant",
        "--cond_inject", "input"],
        "batches": [batch() for _ in range(1 + DP_STEPS)],
        "evals": [batch(False) for _ in range(DP_EVAL_N // DP_B)]}


def _dp_steps(torch, mesh, inputs, work):
    """The steps of ``inputs`` with the data-parallel step (B1
    center-crops each rank's rows: no draw, so one rank and two see the
    same images), each from the one-rank reference's state before it
    (``{work}/s{i}.pt``, as the CPU locksteps start each step from JAX's
    state), then the evaluator over the eval rows with the warm state's G
    (``s0.pt``). ``mesh`` None is the
    reference on the whole batch: it starts from ``s0.pt`` (the warm
    state), goes on from its own states and writes them."""
    import warnings as _w
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.eval_lib import make_fid_evaluator
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.parallel.train_parallel import (
        make_parallel_train_step, shard_train_state)
    from pcgan_tpu_torch.train import create_train_state
    from pcgan_tpu_torch.utils.checkpoint import load_state, save_state
    cfg = parse_config(inputs["argv"], is_train=True)
    batches, evals = inputs["batches"], inputs["evals"]
    dev = torch.device(inputs["dev"]) if mesh is None else mesh.device
    with _w.catch_warnings():
        _w.simplefilter("ignore", RuntimeWarning)   # input injection
        G, D = define_G(cfg).to(dev), define_D(cfg).to(dev)
    state = shard_train_state(create_train_state(
        cfg, G, D, torch.Generator().manual_seed(0)), mesh)
    step = make_parallel_train_step(cfg, G, D, mesh=mesh,
                                    train_preprocess=False)

    def rows(b):
        b = b if mesh is None else mesh.local_rows(b)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    cp.launches = 0
    losses, secs, params = [], [], []
    for i, b in enumerate(batches[1:]):
        if mesh is None and i:
            save_state(state, os.path.dirname(work), os.path.basename(work),
                       f"s{i}")
        elif mesh is not None or not i:
            load_state(state, torch.load(os.path.join(work, f"s{i}.pt"),
                                         weights_only=True))
        raw = rows(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, raw)
        losses.append({k: float(v) for k, v in m.items()})   # syncs
        secs.append(time.perf_counter() - t0)
        params.append({f"{n}.{k}": v.detach().cpu().clone() for n, net in
                       (("G", G), ("D", D))
                       for k, v in net.named_parameters()})
    train_b1 = cp.launches
    out = {"losses": losses, "step_s": secs, "params": params}
    if mesh is not None and inputs.get("profile"):
        out["collective_kernels"] = _dp_profiled_step(torch, step, state,
                                                      rows(batches[-1]))
    # the evaluator scores the warm state's G, the same bits on every
    # rank and in the reference: the FIDs then differ by the evaluator's
    # reduction alone, not by the steps' sign flips
    load_state(state, torch.load(os.path.join(work, "s0.pt"),
                                 weights_only=True))
    cp.launches = 0
    out["eval"] = make_fid_evaluator(cfg, None, dev, mesh)(
        G, iter([rows(e) for e in evals]),
        max_images=sum(len(e["bin"]) for e in evals), seed=0)
    out["b1"] = {"train": train_b1, "eval": cp.launches}
    if mesh is not None and inputs.get("cache_argv"):
        out["cache"] = _dp_cache_ranks(torch, mesh, inputs["cache_argv"])
    return out


def _dp_profiled_step(torch, step, state, raw) -> list:
    """One more step under torch.profiler: (device ms, launches, name) of
    each collective kernel in it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        float(step(state, raw)["loss_G"])
    return [[round(ms, 4), cnt, name[:100]]
            for ms, cnt, name in _device_rows(torch, prof, 1)
            if "nccl" in name.lower()]


def _dp_cache_ranks(torch, mesh, argv) -> dict:
    """The sharded cache over ``mesh``: this rank's rows of every batch of
    an epoch and of the eval pass equal to its rows of the replicated
    cache's batch; the two gathers' ms."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.data.device_cache import DeviceCacheLoader
    from pcgan_tpu_torch.data.loader import create_dataset
    cfg = parse_config(argv, is_train=True)
    ds = create_dataset(cfg, train=True)
    shard = DeviceCacheLoader(cfg, ds, mesh.device, seed=cfg.train.seed,
                              mesh=mesh, sharded=True)
    whole = DeviceCacheLoader(cfg, ds, mesh.device, seed=cfg.train.seed)
    n = 0
    for a, b in zip([*shard, *shard.eval_iter()],
                    [*whole, *whole.eval_iter()]):
        b = mesh.local_rows(b)
        check(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in b),
              f"sharded cache, rank {mesh.rank}: a batch differs from its "
              f"rows of the replicated cache's")
        n += 1
    idx = np.arange(cfg.data.batch_size)
    return {"batches_identical": n, "n_loc": shard.n_loc,
            "gather_ms_sharded": cuda_ms(torch, lambda: shard._gather(idx),
                                         iters=20, warmup=3),
            "gather_ms_replicated": cuda_ms(
                torch, lambda: whole._gather(idx), iters=20, warmup=3)}


def _dp_rank(rank, port, work):
    """A spawned rank of phase 22 (a) (gloo over CUDA tensors, every rank
    on cuda:0), or of ``--cards N`` (NCCL, rank r on cuda:r)."""
    sys.path.insert(0, HERE)
    import torch
    from pcgan_tpu_torch.parallel.mesh import init_distributed
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    mesh = init_distributed(inputs["dev"], backend=inputs["backend"],
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=inputs["world"],
                            local_rank=0 if inputs["shared"] else rank)
    try:
        torch.save(_dp_steps(torch, mesh, inputs, work),
                   os.path.join(work, f"rank{rank}.pt"))
    finally:
        mesh.close()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_ranks(torch, tmp, world=2, backend="gloo", shared=True,
              cache_argv=None) -> dict:
    """(a) ``world`` ranks spawned over ``backend`` (``shared``: all on the
    one card) against one rank, each step from the one rank's state before
    it: the loss of every step within TRAIN_STEP_TOL abs + rel, the
    parameters after it within the lockstep's one-step Adam envelope, the
    ranks alike bit for bit, the FID within DP_EVAL_TOL. On cards of their
    own (``not shared``) the ranks also profile one more step for the
    collectives' kernels and, with ``cache_argv``, check the sharded cache
    across them."""
    import torch.multiprocessing as mp
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.parallel.train_parallel import (
        make_parallel_train_step)
    from pcgan_tpu_torch.train import create_train_state
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    from pcgan_tpu_torch.config import parse_config
    name = f"dp_{world}_{backend}"
    work = os.path.join(tmp, name)
    os.makedirs(work)
    inputs = {**_dp_inputs(), "world": world, "backend": backend,
              "shared": shared, "profile": not shared,
              "cache_argv": cache_argv}
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    cfg = parse_config(inputs["argv"], is_train=True)
    batches = inputs["batches"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        G = define_G(cfg, torch.Generator().manual_seed(1)).to(DEV)
        D = define_D(cfg, torch.Generator().manual_seed(2)).to(DEV)
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(0))
    # one warm-up step, so Adam's moments scale every compared update
    make_parallel_train_step(cfg, G, D, train_preprocess=False)(
        state, {k: torch.from_numpy(v).to(DEV) for k, v in
                batches[0].items()})
    ckpt.save_state(state, tmp, name, "s0")
    del state, G, D
    one = _dp_steps(torch, None, inputs, work)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = mp.start_processes(_dp_rank, args=(_free_port(), work),
                             nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=2):
            check(time.perf_counter() - t0 < DP_TIMEOUT,
                  f"{world} ranks: not done in {DP_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(world)]
    two = ranks[0]
    check(all(r["losses"] == two["losses"]
              and all(torch.equal(v, r["params"][i][k])
                      for i, ps in enumerate(two["params"])
                      for k, v in ps.items()) for r in ranks[1:]),
          f"{world} ranks: the ranks' losses or parameters differ")
    gap = 0.0
    for i, (a, b) in enumerate(zip(two["losses"], one["losses"])):
        check(set(a) == set(b), f"{world} ranks: step {i} metric keys "
              f"differ")
        for k in b:
            d = abs(a[k] - b[k])
            gap = max(gap, d / (1.0 + abs(b[k])))
            check(d <= TRAIN_STEP_TOL + TRAIN_STEP_TOL * abs(b[k]),
                  f"{world} ranks: step {i} {k} {a[k]} vs one rank {b[k]}")
    worst = {"median": 0.0, "max": 0.0, "share": 0.0}
    for i, (ps, ref) in enumerate(zip(two["params"], one["params"])):
        for k, v in ref.items():
            diff = (ps[k] - v).abs().numpy()
            if k == "G.stem.weight":
                # the stem's condition channels: instance norm cancels
                # them, so their gradient is zero and a step moves them by
                # +-lr on the sign of f32 noise; only the sign-flip bound
                # applies
                check(diff[:, C:].max() <= 2.1 * LR,
                      f"{world} ranks: step {i}: the stem's condition "
                      f"channels moved by {diff[:, C:].max()}")
                diff = diff[:, :C]
            med, mx = float(np.median(diff)), float(diff.max())
            share = float((diff > 0.25 * LR).mean())
            worst = {"median": max(worst["median"], med),
                     "max": max(worst["max"], mx),
                     "share": max(worst["share"], share)}
            check(med < 2e-6 and mx <= 2.1 * LR and share < 2e-3,
                  f"{world} ranks: step {i}: {k} off one rank's by median "
                  f"{med}, max {mx}, share {share}")
    fid1, fid2 = one["eval"]["fid"], two["eval"]["fid"]
    check(two["eval"]["fid_images"] == one["eval"]["fid_images"] == DP_EVAL_N
          and abs(fid2 - fid1) <= DP_EVAL_TOL * max(1.0, abs(fid1)),
          f"{world}-rank eval: fid {fid2} vs one rank's {fid1}")
    b1 = {f"rank{r}": x["b1"] for r, x in enumerate(ranks)}
    check(all(v == {"train": DP_STEPS, "eval": DP_EVAL_N // DP_B}
              for v in b1.values()),
          f"{world} ranks: B1 launches {b1}")
    rate = DP_B / float(np.mean(two["step_s"][1:]))
    out = {"world": world, "backend": backend, "shared_card": shared,
           "loss_max_rel_gap": gap, "param_diff": worst,
           "eval": {"fid_ranks": fid2, "fid_one_rank": fid1},
           "b1_launches": b1, "one_rank_b1": one["b1"],
           "images_per_s_ranks": rate,
           "images_per_s_one_rank": DP_B / float(np.mean(
               one["step_s"][1:])), "spawn_wall_s": wall}
    how = ("time-slicing one card through host-staged gloo, not a "
           "data-parallel speed" if shared else f"one card each, {backend}")
    say(f"(a) {world} {backend} ranks ({how}; f32, full width, global batch "
        f"{DP_B}): losses within {gap:.3g} (rel) of one rank's over "
        f"{DP_STEPS} steps, parameters median/max/share "
        f"{worst['median']:.3g}/{worst['max']:.3g}/{worst['share']:.3g}, "
        f"ranks bit-identical; FID {fid2:.6g} vs {fid1:.6g}; B1 {b1}; "
        f"{rate:.1f} images/s, one rank {out['images_per_s_one_rank']:.1f}")
    if not shared:
        out["collective_kernels"] = [r["collective_kernels"] for r in ranks]
        say(f"  collectives of one profiled step, rank 0: "
            f"{out['collective_kernels'][0]}")
    if cache_argv:
        out["cache"] = [r["cache"] for r in ranks]
        check(all(c["batches_identical"] > 0 for c in out["cache"]),
              f"sharded cache across ranks: {out['cache']}")
        say(f"  sharded cache across {world} ranks: every rank's rows of "
            f"{out['cache'][0]['batches_identical']} batches bit-identical "
            f"to the replicated cache's; gather ms a rank (sharded, "
            f"replicated) {[(round(c['gather_ms_sharded'], 4), round(c['gather_ms_replicated'], 4)) for c in out['cache']]}")
    return out


def _dp_folder(tmp, folder):
    """Phase 14's faces under DP8_COPIES names each (another stamp digit):
    512 images, two batches of train_utkface_128_dp8.sh's 256."""
    out = os.path.join(tmp, "faces_dp8")
    os.makedirs(out)
    for name in sorted(os.listdir(folder)):
        stem, ext = os.path.splitext(name)
        for k in range(DP8_COPIES):
            with open(os.path.join(folder, name), "rb") as f, open(
                    os.path.join(out, f"{stem}{k}{ext}"), "wb") as g:
                g.write(f.read())
    return out


def _dp8_argv(tmp, folder, bundle_dir, name):
    """train_utkface_128_dp8.sh's flags: only --dataroot, the epochs and
    the cadences differ; bf16 as phase 8."""
    return ["--dataroot", folder, "--name", name, "--model", "pcgan",
            "--dataset_mode", "aging", "--netG", NETG, "--netD", "basic",
            "--norm", "instance", "--load_size", str(LOAD), "--crop_size",
            str(CROP), "--batch_size", str(DP8_B), "--n_age_bins", str(NB),
            "--gan_mode", "lsgan", "--lambda_L1", "100", "--lambda_cond",
            "10", "--comparator_path", bundle_dir, "--niter", "2",
            "--niter_decay", "0", "--lr", "0.0002", "--beta1", "0.5",
            "--pool_size", "64", "--print_freq", "1", "--save_epoch_freq",
            "0", "--num_threads", "16", "--mesh_shape", "-1", "--dtype",
            "bfloat16", "--checkpoints_dir", os.path.join(tmp, "dp8"),
            *DP8_EXTRA]


def _dp8_eval_argv(tmp, folder, results):
    """evaluate over the 512 faces from phase 14's checkpoint."""
    return ["--name", "real_utk128", "--checkpoints_dir",
            os.path.join(tmp, "real"), "--dataroot", folder,
            "--dataset_mode", "aging", "--num_test", str(DP8_EVAL_N),
            "--batch_size", str(DP8_EVAL_B), "--mesh_shape", "-1",
            "--results_dir", os.path.join(tmp, results), *DP8_EXTRA]


def _dp_cache_check(torch, mesh, argv) -> dict:
    """(c) the sharded cache over ``mesh`` (one NCCL rank): every batch of
    an epoch and of the eval pass equal to the replicated cache's bit for
    bit; the gather's ms beside the replicated one's."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.data.device_cache import DeviceCacheLoader
    from pcgan_tpu_torch.data.loader import create_dataset
    cfg = parse_config(argv, is_train=True)
    ds = create_dataset(cfg, train=True)
    shard = DeviceCacheLoader(cfg, ds, mesh.device, seed=cfg.train.seed,
                              mesh=mesh, sharded=True)
    whole = DeviceCacheLoader(cfg, ds, mesh.device, seed=cfg.train.seed)
    n = 0
    for a, b in zip([*shard, *shard.eval_iter()],
                    [*whole, *whole.eval_iter()]):
        check(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in b),
              "sharded cache: a batch differs from the replicated cache's")
        n += 1
    check(n == 2 * len(whole) > 0, f"sharded cache: {n} batches compared")
    idx = np.arange(cfg.data.batch_size)
    return {"batches_identical": n,
            "gather_ms_sharded": cuda_ms(torch, lambda: shard._gather(idx),
                                         iters=20, warmup=3),
            "gather_ms_replicated": cuda_ms(
                torch, lambda: whole._gather(idx), iters=20, warmup=3)}


def _dp_worker(spec_path: str) -> None:
    """``chip_smoke.py --dp-worker <spec>`` under ``torchrun
    --nproc_per_node 1``: (b) the dp8 run on NCCL, profiled, (c) the
    sharded cache, (d) evaluate's CLI; writes the results to the spec's
    ``out``."""
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist
    from pcgan_tpu_torch.parallel.mesh import init_distributed
    with open(spec_path) as f:
        spec = json.load(f)
    mesh = init_distributed(spec["dev"])   # torchrun's rank: NCCL on cuda
    want = "nccl" if spec["dev"] == "cuda" else "gloo"
    check(mesh.group is not None and mesh.world == 1
          and dist.get_backend(mesh.group) == want,
          f"torchrun worker: world {mesh.world}, group {mesh.group}")
    torch.backends.cudnn.deterministic = True   # as the plain runs
    try:
        torch.cuda.reset_peak_memory_stats()
        out = {"backend": dist.get_backend(mesh.group),
               "profile": _profile_train(torch, spec["tmp"], spec["steps"],
                                         spec["train_argv"],
                                         "(b) dp8 under torchrun (NCCL)"),
               "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        out["cache"] = _dp_cache_check(torch, mesh, spec["train_argv"])
        out["eval"], out["eval_b1"], _ = _eval_cli(torch, spec["eval_argv"])
    finally:
        mesh.close()
    with open(spec["out"], "w") as f:
        json.dump(out, f, default=_jsonable)


def _torchrun_worker(spec_path: str):
    """(exit code, output) of ``torchrun --standalone --nproc_per_node 1
    chip_smoke.py --dp-worker <spec>``; past DP_TIMEOUT the launcher and its
    rank are killed together."""
    import signal
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", os.path.join(HERE, "chip_smoke.py"),
         "--dp-worker", spec_path], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log = p.communicate(timeout=DP_TIMEOUT)[0]
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    return p.returncode, log


def _dp_metrics(tmp, name):
    with open(os.path.join(tmp, "dp8", name, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k.startswith("loss")} for line in f]


def phase_data_parallel(torch, tmp, folder, bundle_dir) -> dict:
    """Phase 22: (a) two gloo ranks on the one card against one rank; (b)
    train_utkface_128_dp8.sh's flags under ``torchrun --standalone
    --nproc_per_node 1`` (NCCL), its loss stream bit-identical to the same
    run without torchrun, both profiled; (c) the sharded cache under NCCL
    against the replicated one; (d) evaluate's CLI under torchrun against
    the plain run."""
    t_phase = time.perf_counter()
    out = {"two_ranks": _dp_ranks(torch, tmp)}
    faces = _dp_folder(tmp, folder)
    torch.cuda.empty_cache()
    spec = {"tmp": tmp, "dev": DEV, "steps": DP8_STEPS,
            "out": os.path.join(tmp, "dp_worker.json"),
            "train_argv": _dp8_argv(tmp, faces, bundle_dir, "dp8_torchrun"),
            "eval_argv": _dp8_eval_argv(tmp, faces, "dp_eval_torchrun")}
    spec_path = os.path.join(tmp, "dp_worker_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    rc, log = _torchrun_worker(spec_path)
    torchrun_s = time.perf_counter() - t0
    for line in log.splitlines():
        if line.startswith("[chip_smoke]"):
            say(f"  torchrun| {line[len('[chip_smoke] '):]}")
    check(rc == 0, f"torchrun worker exited {rc}:\n{log[-4000:]}")
    with open(spec["out"]) as f:
        worker = json.load(f)
    torch.backends.cudnn.deterministic = True
    try:
        plain = _profile_train(torch, tmp, DP8_STEPS,
                               _dp8_argv(tmp, faces, bundle_dir, "dp8_plain"),
                               "(b) dp8 without torchrun")
        rec, eval_b1, _ = _eval_cli(torch,
                                    _dp8_eval_argv(tmp, faces, "dp_eval"))
    finally:
        torch.backends.cudnn.deterministic = False
    a, b = _dp_metrics(tmp, "dp8_torchrun"), _dp_metrics(tmp, "dp8_plain")
    check(len(a) == 2 * DP8_STEPS and a == b,
          f"(b) the torchrun loss stream differs from the plain run's: "
          f"{a} vs {b}")
    check(worker["eval"] == rec,
          f"(d) evaluate under torchrun {worker['eval']} vs plain {rec}")
    want = "nccl:" if DEV == "cuda" else "gloo:"
    check(any(k.startswith(want)
              for k in worker["profile"]["collectives_per_step"]),
          f"(b) no {want[:-1]} collective in the torchrun run's trace")
    prof = worker["profile"]
    steps_per_s = 1e3 / prof["window_ms_per_step"]
    out["dp8"] = {
        "loss_stream_identical": True, "steps": len(a),
        "torchrun": prof, "plain": plain,
        "steps_per_s_profiled": steps_per_s,
        "images_per_s_profiled": DP8_B * steps_per_s,
        "device_ms_per_step": prof["device_ms_per_step"],
        "device_ms_per_step_plain": plain["device_ms_per_step"],
        "launches_per_step": prof["device_launches_per_step"],
        "nccl_ms_per_step": prof["nccl_ms_per_step"],
        "collectives_per_step": prof["collectives_per_step"],
        "peak_gb": worker["peak_gb"], "torchrun_call_s": torchrun_s}
    out["cache"] = worker["cache"]
    out["eval"] = {"identical": True, "record": rec,
                   "b1_torchrun": worker["eval_b1"], "b1_plain": eval_b1}
    nccl = sum(r[0] for r in prof["nccl_ms_per_step"])
    say(f"(b) train_utkface_128_dp8.sh's flags (batch {DP8_B}, bf16) under "
        f"torchrun on NCCL, world 1: loss stream bit-identical to the plain "
        f"run over {len(a)} steps; {steps_per_s:.3f} steps/s = "
        f"{DP8_B * steps_per_s:.1f} images/s under the profiler; device "
        f"{prof['device_ms_per_step']:.3f} ms a step (plain "
        f"{plain['device_ms_per_step']:.3f}), "
        f"{prof['device_launches_per_step']:.1f} launches a step (plain "
        f"{plain['device_launches_per_step']:.1f}); collectives a step "
        f"{prof['collectives_per_step']}, NCCL kernels {nccl:.4f} ms a step "
        f"in {prof['nccl_ms_per_step']}; peak {worker['peak_gb']:.2f} GiB")
    say(f"(c) sharded cache under NCCL: {worker['cache']['batches_identical']}"
        f" batches bit-identical to the replicated cache's; gather "
        f"{worker['cache']['gather_ms_sharded']:.4f} ms against "
        f"{worker['cache']['gather_ms_replicated']:.4f} ms replicated")
    say(f"(d) evaluate under torchrun equals the plain run: fid "
        f"{rec['fid']:.6g} over {rec['fid_images']} images")
    out["launches_per_run"] = {
        "two_ranks": sum(sum(v.values()) for v in
                         out["two_ranks"]["b1_launches"].values()),
        "one_rank": sum(out["two_ranks"]["one_rank_b1"].values()),
        "dp8_torchrun": prof["launches"], "dp8_plain": plain["launches"],
        "eval_torchrun": worker["eval_b1"], "eval_plain": eval_b1}
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 22: {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------- #
# phase 23: sharded training state across cards
# --------------------------------------------------------------------------- #

AUTO_B, AUTO_STEPS = 8, 3        # (a): the global batch, compared steps
AUTO_POOL = 16                   # (a): the pool on, global
AUTO_MESHES = {                  # (a): the mesh flags of each cohort run
    "zero1_data2": ["--mesh_shape", "2", "--zero1"],
    "data1_model2": ["--mesh_shape", "1,2", "--mesh_axes", "data,model"]}
AUTO_CLI = {                     # (b): one card under torchrun
    "spatial_shards": ["--mesh_shape", "1", "--spatial_shards", "2"],
    "data1_model1": ["--mesh_shape", "1,1", "--mesh_axes", "data,model"]}
AUTO_CARDS_STEPS = 3             # --cards: the CLI's steps
AUTO_SERVE_B, AUTO_SERVE_CALLS = 64, 10   # --cards: data_parallel


def _auto_inputs() -> dict:
    """Phase 23 (a)'s config and inputs, which its spawned ranks read from
    a file: the default GAN at full width in f32 with everything drawn
    (crops, flips, target bins, pool slots) and the pool on; seeded u8
    global batches, a warm-up step's and AUTO_STEPS steps'."""
    rng = np.random.default_rng(23)
    return {"dev": DEV, "argv": [
        "--netG", NETG, "--ngf", str(NGF), "--netD", "basic", "--ndf",
        str(NGF), "--norm", "instance", "--crop_size", str(CROP),
        "--load_size", str(LOAD), "--n_age_bins", str(NB), "--batch_size",
        str(AUTO_B), "--dtype", "float32", "--pool_size", str(AUTO_POOL),
        "--gan_mode", "lsgan", "--lambda_L1", "100", "--lr_policy",
        "constant", "--cond_inject", "input"],
        "batches": [{"image": rng.integers(0, 256, (AUTO_B, NATIVE, NATIVE,
                                                    C), dtype=np.uint8),
                     "bin": rng.integers(0, NB, AUTO_B)}
                    for _ in range(1 + AUTO_STEPS)]}


def _peak_owners(torch, snap, held, top=6) -> dict:
    """The allocations live at the peak of a memory-history trace
    (``torch.cuda.memory._snapshot()`` after
    ``_record_memory_history``), ``held`` the allocated bytes when it
    started: the peak, and the live bytes grouped by the three innermost
    frames in the repository that allocated them (``?`` for the backward's
    allocations, which have no Python frame), largest first."""
    trace = snap["device_traces"][torch.cuda.current_device()]
    sizes, cur, peak, at = {}, 0, 0, -1
    for i, e in enumerate(trace):        # the peak's event
        if e["action"] == "alloc":
            sizes[e["addr"]] = e["size"]
            cur += e["size"]
        elif e["action"] == "free_completed" and e["addr"] in sizes:
            cur -= sizes.pop(e["addr"])
        if cur > peak:
            peak, at = cur, i
    live = {}
    for e in trace[:at + 1]:             # what is live there
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    owners = {}
    for e in live.values():
        mine = [f for f in e.get("frames") or []
                if f["filename"].startswith(HERE)
                and "site-packages" not in f["filename"]]
        where = " < ".join(f"{os.path.relpath(f['filename'], HERE)}:"
                           f"{f['line']} {f['name']}" for f in mine[:3])
        owners[where or "?"] = owners.get(where or "?", 0) + e["size"]
    return {"held_before": held, "peak": held + peak,
            "owners": sorted(((b, w) for w, b in owners.items()),
                             reverse=True)[:top]}


def _audited(torch, dev, n, fn, history):
    """fn() under ``spatial.SavedAudit(n)`` and, with ``history`` on a
    card, the allocator's memory history: (fn's result, what autograd kept
    and any whole square image among it, and ``_peak_owners``)."""
    from pcgan_tpu_torch.parallel.spatial import SavedAudit
    history = history and torch.device(dev).type == "cuda"
    if history:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.memory._record_memory_history(
            enabled="all", context="alloc", stacks="python",
            max_entries=1_000_000)
    try:
        with SavedAudit(n) as audit:
            res = fn()
        if history:
            torch.cuda.synchronize()
            snap = torch.cuda.memory._snapshot()
    finally:
        if history:
            torch.cuda.memory._record_memory_history(enabled=None)
    rep = {"saved_bytes": audit.saved_bytes, "whole": audit.whole[:4],
           "n_whole": len(audit.whole)}
    if history:
        rep.update(_peak_owners(torch, snap, held))
    return res, rep


def _auto_steps(torch, mesh, inputs, work, flags=(), steps=None,
                timed=True) -> dict:
    """``_auto_steps_body`` with cuDNN's deterministic algorithms, on one
    rank as on the ranks, so that cuDNN's atomic algorithms add nothing to
    the gap the gates read (on an H100 80GB HBM3, two runs of phase 25
    differed x4.6 in their largest parameter gap without it; with it two
    passes still differ by a few percent: other reductions)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _auto_steps_body(torch, mesh, inputs, work, flags, steps,
                                timed)
    finally:
        torch.backends.cudnn.deterministic = prev


def _auto_steps_body(torch, mesh, inputs, work, flags=(), steps=None,
                     timed=True) -> dict:
    """The steps of ``inputs``: with ``mesh`` None the one-rank plain step
    on the whole batch from the warm state ``{work}/s0.pt``, writing the
    state before each later step; else the sharded-state step over the
    mesh of ``flags``, each step from the plain run's state before it.
    Returns the losses, the parameters after each step, B1's launches,
    and on the mesh the resident state bytes (sharded and whole), the
    collectives a step and (one more step, the device synchronized around
    each collective) their ms. ``steps``: the first steps only; ``timed``
    False: no timed step. With ``inputs['audit']`` (the compared spatial
    size, for one rank's run) each step runs under ``_audited``, the first
    with the memory history too."""
    import warnings as _w
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.parallel import auto
    from pcgan_tpu_torch.parallel.mesh import DataMesh, make_mesh
    from pcgan_tpu_torch.parallel.train_parallel import (
        make_parallel_train_step)
    from pcgan_tpu_torch.train import create_train_state
    from pcgan_tpu_torch.utils.checkpoint import load_state, save_state
    cfg = parse_config(inputs["argv"] + list(flags), is_train=True)
    if mesh is not None:
        p = cfg.parallel
        mesh = make_mesh(DataMesh(mesh.world, mesh.rank, mesh.device,
                                  mesh.group), p.mesh_shape, p.mesh_axes)
    dev = torch.device(inputs["dev"]) if mesh is None else mesh.device

    def fresh(i):
        with _w.catch_warnings():
            _w.simplefilter("ignore", RuntimeWarning)   # input injection
            G, D = define_G(cfg).to(dev), define_D(cfg).to(dev)
        state = create_train_state(cfg, G, D,
                                   torch.Generator().manual_seed(0),
                                   vgg=_vgg_of(cfg))
        load_state(state, torch.load(os.path.join(work, f"s{i}.pt"),
                                     weights_only=True))
        return state

    def rows(b, rws=None):
        b = b if mesh is None else mesh.local_rows(b, rws)
        return {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in b.items()}

    def params(state):
        return {f"{n}.{k}": v.detach().cpu().clone()
                for n, net in (("G", state.G), ("D", state.D))
                for k, v in net.named_parameters()}
    out = {"losses": [], "params": [], "step_s": [], "collectives": [],
           "audit": []}
    n_audit = inputs.get("audit") if mesh is None else (
        mesh.size("spatial") if inputs.get("audit") else None)

    def run(i, step, state, raw):
        if not n_audit:
            return step(state, raw)
        m, rep = _audited(torch, dev, n_audit, lambda: step(state, raw),
                          history=i == 0)
        out["audit"].append(rep)
        return m
    cp.launches = 0
    torch.cuda.reset_peak_memory_stats()
    if mesh is None:
        state = fresh(0)
        step = make_parallel_train_step(cfg, state.G, state.D)
        for i, b in enumerate(inputs["batches"][1:]):
            if i:
                save_state(state, os.path.dirname(work),
                           os.path.basename(work), f"s{i}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = run(i, step, state, rows(b))
            out["losses"].append({k: float(v) for k, v in m.items()})
            out["step_s"].append(time.perf_counter() - t0)
            out["params"].append(params(state))
        out["bytes"] = auto.state_bytes(state)
        out["b1"] = cp.launches
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        return out
    rws = auto.batch_rows(cfg, mesh)
    for i, b in enumerate(inputs["batches"][1:][:steps]):
        state = fresh(i)
        whole = auto.state_bytes(state)
        auto.shard_state(state, mesh, cfg.parallel.zero1)
        step = auto.make_sharded_train_step(cfg, state.G, state.D,
                                            mesh=mesh)
        raw = rows(b, rws)
        before = dict(auto.COLLECTIVES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = run(i, step, state, raw)
        out["losses"].append({k: float(v) for k, v in m.items()})
        out["step_s"].append(time.perf_counter() - t0)
        out["collectives"].append({
            k: v - before.get(k, 0) for k, v in auto.COLLECTIVES.items()
            if v - before.get(k, 0)})
        out["bytes"] = {"rank": state.shard_plan.resident_bytes(state),
                        "whole": whole}
        with auto.gathered(state):
            out["params"].append(params(state))
    out["b1"] = cp.launches
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["coords"] = {ax: mesh.coord(ax) for ax in mesh.axes}
    if not timed:
        return out
    # one more step with the collectives timed (synchronized: slower)
    auto.TIMING["on"] = True
    auto.COLLECTIVE_MS.clear()
    try:
        float(step(state, raw)["loss_G"])
    finally:
        auto.TIMING["on"] = False
    out["collective_ms"] = dict(auto.COLLECTIVE_MS)
    return out


def _vgg_of(cfg):
    """``--lambda_vgg``'s frozen trunk (``--vgg_path random``: the seeded
    random VGG19 the train CLI builds), else None."""
    if cfg.train.lambda_vgg <= 0:
        return None
    from pcgan_tpu_torch.models.vgg import random_vgg19
    return random_vgg19(0)


def _auto_rank(rank, port, work):
    """A spawned rank of phase 23 (a): gloo over CUDA tensors, both ranks
    on cuda:0; each mesh of AUTO_MESHES in turn."""
    sys.path.insert(0, HERE)
    import torch
    from pcgan_tpu_torch.parallel.mesh import init_distributed
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    mesh = init_distributed(inputs["dev"], backend="gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2, local_rank=0)
    try:
        res = {name: _auto_steps(torch, mesh, inputs, work, flags)
               for name, flags in AUTO_MESHES.items()}
        res["resize_conv"] = _resize_steps(torch, mesh, inputs)
        torch.save(res, os.path.join(work, f"rank{rank}.pt"))
        # phase 24 (a)'s ranks, in this spawn (one spawn fewer)
        sp_work = os.path.join(os.path.dirname(work), "spatial")
        if os.path.exists(os.path.join(sp_work, "inputs.pt")):
            sp_inputs = torch.load(os.path.join(sp_work, "inputs.pt"),
                                   weights_only=False)
            torch.save(_auto_steps(torch, mesh, sp_inputs, sp_work,
                                   SP_MESH),
                       os.path.join(sp_work, f"rank{rank}.pt"))
        # phase 25's ranks too: each lever config, then one step of it
        # without --remat (its collectives)
        for name in LEVER_SP:
            lw = os.path.join(os.path.dirname(work), f"levers_{name}")
            if not os.path.exists(os.path.join(lw, "inputs.pt")):
                continue
            li = torch.load(os.path.join(lw, "inputs.pt"),
                            weights_only=False)
            t0 = time.perf_counter()
            res = _auto_steps(torch, mesh, li, lw, SP_MESH)
            plain = _auto_steps(torch, mesh, _without_remat(li), lw,
                                SP_MESH, steps=1, timed=False)
            res["no_remat"] = {"collectives": plain["collectives"][-1],
                               "peak_bytes": plain["peak_bytes"]}
            res["wall_s"] = time.perf_counter() - t0
            torch.save(res, os.path.join(lw, f"rank{rank}.pt"))
        # phase 26's ranks: each loss-lever config
        for name in LOSS_SP:
            lw = os.path.join(os.path.dirname(work), f"losses_{name}")
            if not os.path.exists(os.path.join(lw, "inputs.pt")):
                continue
            li = torch.load(os.path.join(lw, "inputs.pt"),
                            weights_only=False)
            t0 = time.perf_counter()
            res = _auto_steps(torch, mesh, li, lw, SP_MESH)
            res["wall_s"] = time.perf_counter() - t0
            torch.save(res, os.path.join(lw, f"rank{rank}.pt"))
    finally:
        mesh.close()


RESIZE_FLAGS = ["--netG", "resnet_9blocks@resize_conv", "--mesh_shape",
                "1,2", "--mesh_axes", "data,model"]


def _resize_steps(torch, mesh, inputs) -> dict:
    """Phase 23 (a)'s ``@resize_conv`` check: the nearest 2x upsample of
    ``--netG resnet_9blocks@resize_conv`` at data 1 x model 2, AUTO_STEPS
    steps from the same seeded state on both ranks; each step's losses
    and a digest of every gathered parameter."""
    import hashlib
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.parallel import auto
    from pcgan_tpu_torch.parallel.mesh import DataMesh, make_mesh
    from pcgan_tpu_torch.train import create_train_state
    cfg = parse_config(inputs["argv"] + RESIZE_FLAGS, is_train=True)
    p = cfg.parallel
    mesh = make_mesh(DataMesh(mesh.world, mesh.rank, mesh.device,
                              mesh.group), p.mesh_shape, p.mesh_axes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        G = define_G(cfg, torch.Generator().manual_seed(1)).to(mesh.device)
        D = define_D(cfg, torch.Generator().manual_seed(2)).to(mesh.device)
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(0))
    auto.shard_state(state, mesh, False)
    step = auto.make_sharded_train_step(cfg, G, D, mesh=mesh)
    rws = auto.batch_rows(cfg, mesh)
    out = {"losses": [], "digests": []}
    for b in inputs["batches"][1:]:
        m = step(state, {k: torch.from_numpy(np.asarray(v)).to(mesh.device)
                         for k, v in mesh.local_rows(b, rws).items()})
        out["losses"].append({k: float(v) for k, v in m.items()})
        with auto.gathered(state):
            out["digests"].append({
                f"{n}.{k}": hashlib.sha256(
                    v.detach().cpu().numpy().tobytes()).hexdigest()
                for n, net in (("G", G), ("D", D))
                for k, v in net.named_parameters()})
    return out


def _adam_sup(count: int, b1: float = 0.5, b2: float = 0.999) -> float:
    """The largest |update| / lr of Adam's step number ``count`` (bias
    corrected), whatever the gradients: by Cauchy-Schwarz over the two
    moments' weights, (1-b1)/(1-b1^t) * sqrt((1-b2^t)/(1-b2) * sum_k<t
    (b1^2/b2)^k). 1 at the first step, 1.054 at the second and 1.229 at
    the fourth for the default betas (0.5, 0.999)."""
    t = count
    s = sum((b1 * b1 / b2) ** k for k in range(t))
    return (1 - b1) / (1 - b1 ** t) * float(np.sqrt((1 - b2 ** t)
                                                    / (1 - b2) * s))


def _adam_pair(count: int, b1: float = 0.5, b2: float = 0.999) -> float:
    """The largest gap / lr between two Adam updates of step ``count``
    from the same moments m, v and different gradients: u(g) = c (b1 m +
    (1-b1) g) / sqrt(b2 v + (1-b2) g^2), c = sqrt(1-b2^t)/(1-b1^t). The m
    term keeps m's sign in both, and the g term is at most c (1-b1) /
    sqrt(1-b2) either way, so one update lies within ``_adam_sup`` and the
    other is at most that g term past zero: 2.00 lr at count 2, 2.12 at
    3, 2.29 at 4 (0.5, 0.999)."""
    t = count
    return _adam_sup(t, b1, b2) + (1 - b1) / (1 - b1 ** t) * float(
        np.sqrt((1 - b2 ** t) / (1 - b2)))


ENV_SHARE = 2e-3          # the envelope's share beyond lr/4
ENV_SHARE_MIN = 5000      # tensors held to it alone: 10 entries or more


def _inert(argv) -> set:
    """The parameters of the config ``argv`` whose gradient is 0 in exact
    arithmetic, so that both runs step them by Adam's sign of f32 noise:
    under ``--gan_mode wgangp`` the bias of each of D's logit convs (the
    critic's loss, -mean D(real) + mean D(fake), cancels a constant, and
    the penalty reads only input gradients)."""
    import torch
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_D
    cfg = parse_config(argv, is_train=True)
    if cfg.train.gan_mode != "wgangp":
        return set()
    with torch.device("meta"):
        D = define_D(cfg)
    return {f"D.{pre + '.' if pre else ''}convs.{len(m.convs) - 1}.bias"
            for pre, m in D.named_modules() if hasattr(m, "convs")}


def _envelope(name, got, want, start, what, count=2, inert=()) -> dict:
    """One Adam step's parameter change within the lockstep's envelope:
    bulk (each tensor's median) below 2e-6; entries beyond lr/4 under
    ENV_SHARE of all the parameters together and of each tensor of
    ENV_SHARE_MIN entries or more (a smaller tensor's share would be one
    entry); and the sign-flip bound at most: 2.1 lr, or ``_adam_pair`` of
    the step's Adam count ``count`` where that is larger (a step from a
    state three or more steps on; the stem's condition channels, which
    instance norm cancels, and the ``inert`` parameters (``_inert``) to the
    sign-flip bound alone). Returns the worst median, max, share (of all
    and of the tensors held alone), the max in lr and the bound in lr."""
    bound_lr = max(2.1, _adam_pair(count))
    bound = bound_lr * LR
    worst = {"median": 0.0, "max": 0.0, "share": 0.0, "share_tensor": 0.0}
    beyond = total = 0
    for k, v in want.items():
        diff = ((got[k] - start[k]) - (v - start[k])).abs().numpy()
        if k == "G.stem.weight":
            check(diff[:, C:].max() <= bound,
                  f"{what}: {name}: the stem's condition channels moved by "
                  f"{diff[:, C:].max()} (bound {bound})")
            diff = diff[:, :C]
        if k in inert:
            check(diff.max() <= bound, f"{what}: {name}: {k}, whose "
                  f"gradient is 0 in exact arithmetic, moved by "
                  f"{diff.max()} (bound {bound})")
            continue
        med, mx = float(np.median(diff)), float(diff.max())
        n_beyond = int((diff > 0.25 * LR).sum())
        beyond, total = beyond + n_beyond, total + diff.size
        share = n_beyond / diff.size if diff.size >= ENV_SHARE_MIN else 0.0
        worst = {"median": max(worst["median"], med),
                 "max": max(worst["max"], mx), "share": 0.0,
                 "share_tensor": max(worst["share_tensor"], share)}
        check(med < 2e-6 and mx <= bound and share < ENV_SHARE,
              f"{what}: {name} {k} off one rank's by median {med}, max "
              f"{mx} (bound {bound}), share {share}")
    worst["share"] = beyond / total
    check(worst["share"] < ENV_SHARE, f"{what}: {name}: {beyond} of {total} "
          f"entries off one rank's by more than lr/4")
    worst.update(max_lr=worst["max"] / LR, bound_lr=bound_lr)
    return worst


def _worst_of(steps) -> dict:
    """The worst of each ``_envelope`` reading over the steps, and each
    step's max and bound in lr (the readings the bound is set against)."""
    worst = {k: max(w[k] for w in steps) for k in steps[0]}
    worst["steps_lr"] = [(round(w["max_lr"], 4), round(w["bound_lr"], 4))
                         for w in steps]
    return worst


def _auto_ranks(torch, tmp) -> dict:
    """(a) two gloo ranks on the one card against one rank's plain step;
    the spawn also takes phase 24 (a)'s band steps (``_spatial_prepare``
    first makes their inputs and one rank's run)."""
    import torch.multiprocessing as mp
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.parallel.train_parallel import (
        make_parallel_train_step)
    from pcgan_tpu_torch.train import create_train_state
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    work = os.path.join(tmp, "auto")
    os.makedirs(work)
    inputs = _auto_inputs()
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    cfg = parse_config(inputs["argv"], is_train=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        G = define_G(cfg, torch.Generator().manual_seed(1)).to(DEV)
        D = define_D(cfg, torch.Generator().manual_seed(2)).to(DEV)
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(0))
    # one warm-up step, so Adam's moments scale every compared update
    make_parallel_train_step(cfg, G, D)(
        state, {k: torch.from_numpy(v).to(DEV) for k, v in
                inputs["batches"][0].items()})
    ckpt.save_state(state, tmp, "auto", "s0")
    del state, G, D
    one = _auto_steps(torch, None, inputs, work)
    torch.cuda.empty_cache()
    _spatial_prepare(torch, tmp)
    t25 = time.perf_counter()
    for name in LEVER_SP:
        _spatial_prepare(torch, tmp, f"levers_{name}", _lever_inputs(name))
    prep_s = time.perf_counter() - t25
    t26 = time.perf_counter()
    for name in LOSS_SP:
        _spatial_prepare(torch, tmp, f"losses_{name}", _loss_inputs(name))
    prep26_s = time.perf_counter() - t26
    t0 = time.perf_counter()
    ctx = mp.start_processes(_auto_rank, args=(_free_port(), work),
                             nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=2):
            check(time.perf_counter() - t0 < DP_TIMEOUT,
                  f"phase 23 (a): not done in {DP_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    starts = [one["params"][i - 1] if i else None
              for i in range(AUTO_STEPS)]
    s0 = torch.load(os.path.join(work, "s0.pt"), weights_only=True)
    starts[0] = {f"{n}.{k}": v for n in ("G", "D")
                 for k, v in s0[n].items()
                 if f"{n}.{k}" in one["params"][0]}
    out = {"one_rank": {"bytes": one["bytes"], "b1": one["b1"]},
           "spawn_wall_s": wall, "levers_prepare_s": prep_s,
           "losses_prepare_s": prep26_s}
    # the nearest 2x upsample's backward under a model axis: the ranks of
    # the line must stay alike bit for bit
    rz = [ranks[r]["resize_conv"] for r in range(2)]
    apart = sorted({k for i, d in enumerate(rz[0]["digests"])
                    for k, v in d.items() if rz[1]["digests"][i][k] != v})
    check(rz[0]["losses"] == rz[1]["losses"] and not apart,
          f"(a) @resize_conv at data 1 x model 2: the ranks drift apart: "
          f"losses {rz[0]['losses']} vs {rz[1]['losses']}; parameters "
          f"{apart[:8]}")
    out["resize_conv_model2"] = {"steps": AUTO_STEPS, "bit_identical": True,
                                 "losses": rz[0]["losses"]}
    say(f"(a) resnet_9blocks@resize_conv at data 1 x model 2 (f32, global "
        f"batch {AUTO_B}): the two ranks bit-identical over {AUTO_STEPS} "
        f"steps (losses and every parameter)")
    for name in AUTO_MESHES:
        a, b = ranks[0][name], ranks[1][name]
        what = f"(a) {name}"
        apart = sorted({k for i, ps in enumerate(a["params"])
                        for k, v in ps.items()
                        if not torch.equal(v, b["params"][i][k])})
        check(a["losses"] == b["losses"] and not apart,
              f"{what}: the ranks differ: losses {a['losses']} vs "
              f"{b['losses']}; parameters {apart[:8]}")
        gap = 0.0
        for i, (x, y) in enumerate(zip(a["losses"], one["losses"])):
            check(set(x) == set(y), f"{what}: step {i} metric keys differ")
            for k in y:
                d = abs(x[k] - y[k])
                gap = max(gap, d / (1.0 + abs(y[k])))
                check(d <= TRAIN_STEP_TOL + TRAIN_STEP_TOL * abs(y[k]),
                      f"{what}: step {i} {k} {x[k]} vs one rank {y[k]}")
        worst = _worst_of([_envelope(f"step {i}", a["params"][i],
                                     one["params"][i], starts[i], what,
                                     count=i + 2)
                           for i in range(AUTO_STEPS)])
        b1 = [ranks[r][name]["b1"] for r in range(2)]
        check(b1 == [AUTO_STEPS] * 2,
              f"{what}: B1 launches {b1} (want {AUTO_STEPS} a rank)")
        out[name] = {
            "loss_max_rel_gap": gap, "param_diff": worst, "b1_launches": b1,
            "bytes_rank": [ranks[r][name]["bytes"]["rank"]
                           for r in range(2)],
            "bytes_one_rank": a["bytes"]["whole"],
            "collectives_per_step": a["collectives"][-1],
            "collective_ms": [ranks[r][name]["collective_ms"]
                              for r in range(2)],
            "step_s": a["step_s"], "one_rank_step_s": one["step_s"],
            "coords": [ranks[r][name]["coords"] for r in range(2)]}
        rb, wb = out[name]["bytes_rank"][0], a["bytes"]["whole"]
        say(f"(a) {name}, two gloo ranks on one card (f32, full width, "
            f"global batch {AUTO_B}, everything drawn, pool on): losses "
            f"within {gap:.3g} (rel) of one rank's over {AUTO_STEPS} steps, "
            f"parameters median/max/share {worst['median']:.3g}/"
            f"{worst['max']:.3g}/{worst['share']:.3g} (max/bound in lr a "
            f"step {worst['steps_lr']}), ranks "
            f"bit-identical; B1 {b1}; resident bytes a rank: params "
            f"{rb['params']} adam {rb['adam']} ema {rb['ema']} total "
            f"{rb['total']} (one rank: {wb['params']}, {wb['adam']}, "
            f"{wb['ema']}, {wb['total']}); collectives a step "
            f"{out[name]['collectives_per_step']}, their ms (synchronized) "
            f"{out[name]['collective_ms']}")
    return out


def _auto_worker(spec_path: str) -> None:
    """``chip_smoke.py --auto-worker <spec>`` under torchrun: every run of
    the spec's ``runs`` ({name: argv}) through ``train_main.main`` (cuDNN
    deterministic), with B1's launches and peak memory; on the sharded
    step, the resident state bytes and the collectives of the last step
    (with the spec's ``time_collectives``, the device synchronized around
    each, and their ms); rank r writes ``{out}.rank{r}``. The process
    group is made once for all the runs (each run joins it): a group that
    ``train_main`` destroyed and made again would find the first one's
    NCCL ids in torchrun's store under the same group names."""
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist
    from pcgan_tpu_torch import train_main
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.parallel import auto
    with open(spec_path) as f:
        spec = json.load(f)
    own = not dist.is_initialized()
    if own:
        backend = "gloo"
        if torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            backend = "nccl"
        dist.init_process_group(backend)
    torch.backends.cudnn.deterministic = True
    auto.TIMING["on"] = bool(spec.get("time_collectives"))
    seen = {}
    make = auto.make_sharded_train_step

    def delta(after, before):
        return {k: v - before.get(k, 0) for k, v in after.items()
                if v - before.get(k, 0)}

    def watched(cfg, G, D, C=None, mesh=None, **kw):
        inner = make(cfg, G, D, C, mesh, **kw)

        def step(state, raw):
            n, ms = dict(auto.COLLECTIVES), dict(auto.COLLECTIVE_MS)
            m = inner(state, raw)
            seen["collectives"] = delta(auto.COLLECTIVES, n)
            seen["collective_ms"] = delta(auto.COLLECTIVE_MS, ms)
            seen["bytes"] = state.shard_plan.resident_bytes(state)
            return m
        return step
    auto.make_sharded_train_step = watched
    out = {}
    try:
        for name, argv in spec["runs"].items():
            seen.clear()
            cp.launches = 0
            torch.cuda.reset_peak_memory_stats()
            res = train_main.main(argv)
            out[name] = {"step": res["step"], "b1": cp.launches,
                         "peak_gb": torch.cuda.max_memory_allocated()
                         / 2 ** 30, "bytes": seen.get("bytes"),
                         "collectives_per_step": seen.get("collectives"),
                         "collective_ms": seen.get("collective_ms")}
    finally:
        auto.make_sharded_train_step = make
        if own:
            dist.destroy_process_group()
    rank = int(os.environ.get("RANK", 0))
    with open(f"{spec['out']}.rank{rank}", "w") as f:
        json.dump(out, f, default=_jsonable)


def _torchrun_start(spec_path: str, nproc: int = 1,
                    flag: str = "--auto-worker"):
    """Starts ``torchrun --standalone --nproc_per_node nproc chip_smoke.py
    <flag> <spec>``, its output going to ``{spec}.log``; its handle for
    ``_torchrun_wait``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    log = open(f"{spec_path}.log", "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(nproc),
             os.path.join(HERE, "chip_smoke.py"), flag, spec_path], env=env,
            stdout=log, stderr=subprocess.STDOUT, text=True,
            start_new_session=True), log
    except BaseException:
        log.close()
        raise


def _torchrun_wait(handle):
    """(exit code, output) of a started torchrun, killed past
    DP_TIMEOUT."""
    import signal
    p, log = handle
    try:
        p.wait(timeout=DP_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        log.close()
    with open(log.name) as f:
        return p.returncode, f.read()


def _torchrun_auto(spec_path: str, nproc: int = 1,
                   flag: str = "--auto-worker"):
    """(exit code, output) of ``torchrun --standalone --nproc_per_node
    nproc chip_smoke.py <flag> <spec>``, killed past DP_TIMEOUT."""
    return _torchrun_wait(_torchrun_start(spec_path, nproc, flag))


def _loss_rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k.startswith("loss")} for line in f]


def _auto_cli(torch, tmp) -> dict:
    """(b) the train CLI under torchrun on one card, each mesh of AUTO_CLI,
    against the plain run: loss streams bit-identical."""
    from pcgan_tpu_torch import train_main
    from pcgan_tpu_torch.ops import cuda_preprocess as cp

    def argv(name, extra=()):
        return _train_argv(tmp, name, 1, size=32,
                           extra=("--print_freq", "1", *extra))
    spec = {"out": os.path.join(tmp, "auto_cli.json"),
            "runs": {n: argv(f"auto_{n}", f) for n, f in AUTO_CLI.items()}}
    path = os.path.join(tmp, "auto_cli_spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    rc, log = _torchrun_auto(path)
    call_s = time.perf_counter() - t0
    check(rc == 0, f"(b) torchrun worker exited {rc}:\n{log[-4000:]}")
    with open(spec["out"] + ".rank0") as f:
        worker = json.load(f)
    torch.backends.cudnn.deterministic = True
    try:
        cp.launches = 0
        train_main.main(argv("auto_plain"))
        plain_b1 = cp.launches
    finally:
        torch.backends.cudnn.deterministic = False
    want = _loss_rows(os.path.join(tmp, "train", "auto_plain"))
    for name in AUTO_CLI:
        got = _loss_rows(os.path.join(tmp, "train", f"auto_{name}"))
        check(len(got) == 4 and got == want,
              f"(b) {name}: the loss stream differs from the plain run's: "
              f"{got} vs {want}")
        check(worker[name]["b1"] == plain_b1 > 0,
              f"(b) {name}: B1 launches {worker[name]['b1']} vs plain "
              f"{plain_b1}")
    say(f"(b) the train CLI under torchrun on one card with "
        f"{' and '.join(' '.join(f) for f in AUTO_CLI.values())}: loss "
        f"streams bit-identical to the plain run's over {len(want)} steps; "
        f"B1 {[worker[n]['b1'] for n in AUTO_CLI]} (plain {plain_b1})")
    return {"identical": True, "steps": len(want), "call_s": call_s,
            "b1": {**{n: worker[n]["b1"] for n in AUTO_CLI},
                   "plain": plain_b1}}


def phase_sharded_state(torch, tmp) -> dict:
    """Phase 23: (a) two gloo ranks on the one card, ``--zero1`` and a
    model axis, against one rank; (b) the mesh flags of size 1 under
    torchrun on one card, bit-identical to the plain run."""
    t0 = time.perf_counter()
    out = {"ranks": _auto_ranks(torch, tmp)}
    out["cli"] = _auto_cli(torch, tmp)
    a = out["ranks"]
    out["launches_per_run"] = {
        **{f"{n}_ranks": sum(a[n]["b1_launches"]) for n in AUTO_MESHES},
        "one_rank": a["one_rank"]["b1"],
        **{f"cli_{n}": v for n, v in out["cli"]["b1"].items()}}
    out["phase_s"] = time.perf_counter() - t0
    say(f"phase 23: {out['phase_s']:.1f} s; B1 launches "
        f"{out['launches_per_run']}")
    return out


def _auto_cards_inputs() -> dict:
    """--cards' sharded-state inputs: ``train_utkface_128_dp8.sh``'s shape
    (the default GAN at full width, batch DP8_B of 128 px crops from 200 px
    u8 canvases, pool 64) in f32, everything drawn; a warm-up step's and
    AUTO_CARDS_STEPS steps' seeded batches."""
    rng = np.random.default_rng(26)
    argv = ["--netG", NETG, "--ngf", str(NGF), "--netD", "basic", "--ndf",
            str(NGF), "--norm", "instance", "--load_size", str(LOAD),
            "--crop_size", str(CROP), "--batch_size", str(DP8_B),
            "--n_age_bins", str(NB), "--gan_mode", "lsgan", "--lambda_L1",
            "100", "--lr", "0.0002", "--beta1", "0.5", "--pool_size", "64",
            "--dtype", "float32", "--lr_policy", "constant", *DP8_EXTRA]
    return {"dev": DEV, "argv": argv,
            "batches": [{"image": rng.integers(0, 256, (DP8_B, NATIVE,
                                                        NATIVE, C),
                                               dtype=np.uint8),
                         "bin": rng.integers(0, NB, DP8_B)}
                        for _ in range(1 + AUTO_CARDS_STEPS)]}


AUTO_CARDS_MESHES = {"data2_model2_zero1": ["--mesh_shape", "2,2",
                                            "--mesh_axes", "data,model",
                                            "--zero1"]}


def _auto_cards_cli(torch, tmp, n) -> dict:
    """--cards: the train CLI at ``train_utkface_128_dp8.sh``'s shape
    (synthetic data, f32) under ``torchrun --nproc_per_node n`` with
    AUTO_CARDS_MESHES' 2 x 2 data x model ``--zero1`` mesh on NCCL: the
    routing to the sharded step, the loader sharded by data coordinate and
    rank 0 writing the gathered checkpoint. Held to: exit code 0, every
    logged loss finite, B1 AUTO_CARDS_STEPS times a rank, the first step's
    losses within 1e-4 rel of one card's plain run of the same batches
    (later steps compound Adam's sign flips, C5), and the checkpoint
    resuming on one card (``--continue_train``, finite losses)."""
    from pcgan_tpu_torch import train_main
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    ck = os.path.join(tmp, "cards")
    flags = ["--dataset_mode", "synthetic", "--max_dataset_size",
             str(DP8_B * AUTO_CARDS_STEPS), "--netG", NETG, "--netD",
             "basic", "--norm", "instance", "--load_size", str(LOAD),
             "--crop_size", str(CROP), "--batch_size", str(DP8_B),
             "--n_age_bins", str(NB), "--gan_mode", "lsgan", "--lambda_L1",
             "100", "--niter", "1", "--niter_decay", "0", "--lr", "0.0002",
             "--beta1", "0.5", "--pool_size", "64", "--print_freq", "1",
             "--save_epoch_freq", "0", "--num_threads", "8", "--dtype",
             "float32", "--checkpoints_dir", ck, *DP8_EXTRA]
    spec = {"out": os.path.join(tmp, "auto_cards_cli.json"),
            "runs": {"sharded": flags + AUTO_CARDS_MESHES[
                "data2_model2_zero1"] + ["--name", "sharded"]}}
    path = os.path.join(tmp, "auto_cards_cli_spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    rc, log = _torchrun_auto(path, n)
    call_s = time.perf_counter() - t0
    check(rc == 0, f"--cards {n} CLI: torchrun exited {rc}:\n{log[-4000:]}")
    ranks = []
    for r in range(n):
        with open(f"{spec['out']}.rank{r}") as f:
            ranks.append(json.load(f)["sharded"])
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.reset_peak_memory_stats()
        cp.launches = 0
        train_main.main(flags + ["--mesh_shape", "1", "--name", "plain"])
        plain = {"b1": cp.launches,
                 "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        # the gathered checkpoint rank 0 wrote, resumed on one card
        train_main.main(flags + ["--mesh_shape", "1", "--name", "sharded",
                                 "--continue_train", "--niter", "2"])
    finally:
        torch.backends.cudnn.deterministic = False
    rows = _loss_rows(os.path.join(ck, "sharded"))
    want = _loss_rows(os.path.join(ck, "plain"))
    s = AUTO_CARDS_STEPS
    check(len(rows) == 2 * s and len(want) == s,
          f"--cards CLI: {len(rows)} logged steps (want {2 * s}: {s} on the "
          f"cards, {s} resumed on one card), plain {len(want)}")
    check(all(np.isfinite(v) for row in rows for v in row.values()),
          f"--cards CLI: non-finite losses {rows}")
    gap = max(abs(rows[0][k] - want[0][k]) / max(abs(want[0][k]), 1e-12)
              for k in want[0])
    check(gap <= 1e-4, f"--cards CLI: the first step's losses are {gap:.3g} "
          f"(rel) off one card's: {rows[0]} vs {want[0]}")
    check(all(r["b1"] == s for r in ranks),
          f"--cards CLI: B1 launches {[r['b1'] for r in ranks]} (want {s})")
    out = {"first_step_rel_gap": gap, "call_s": call_s, "plain": plain,
           "ranks": ranks, "resumed_on_one_card": rows[s:]}
    say(f"--cards {n}: the train CLI over data=2 x model=2 + zero1 on NCCL "
        f"(the dp8 shape, f32, batch {DP8_B}): rc 0, every loss finite, B1 "
        f"{[r['b1'] for r in ranks]}; first step within {gap:.3g} (rel) of "
        f"one card's; rank 0's checkpoint resumed on one card for {s} "
        f"finite steps; peak GiB a rank "
        f"{[round(r['peak_gb'], 3) for r in ranks]} (one card "
        f"{plain['peak_gb']:.3f}); collectives a step "
        f"{ranks[0]['collectives_per_step']}")
    return out


def _auto_cards(torch, tmp, n) -> dict:
    """--cards: ``train_utkface_128_dp8.sh``'s shape in f32 under
    ``torchrun --nproc_per_node n`` with a 2 x 2 data x model mesh and
    ``--zero1`` on NCCL, each of AUTO_CARDS_STEPS steps from one card's
    state before it (C5: consecutive steps compound Adam's sign flips on
    near-zero gradients), against one card's plain step: losses within
    1e-4 rel, the parameters within the one-step envelope, every rank
    bit-identical; then the train CLI on that mesh (``_auto_cards_cli``);
    then data_parallel over the n cards against one card's call on the
    same shards, its gap to the whole batch's call printed."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_G
    from pcgan_tpu_torch.serving import export_generator, load_exported
    inputs = _auto_cards_inputs()
    res = _cards_run(torch, tmp, "auto_cards", inputs, AUTO_CARDS_MESHES, n,
                     AUTO_CARDS_STEPS)
    name = "data2_model2_zero1"
    r = res[name]
    out = {"train": res}
    say(f"--cards {n}: data=2 x model=2 + zero1 on NCCL (the dp8 shape, f32,"
        f" batch {DP8_B}, each step from one card's state): losses within "
        f"{r['loss_max_rel_gap']:.3g} (rel) of one card's over "
        f"{AUTO_CARDS_STEPS} steps, parameters median/max/share "
        f"{r['param_diff']['median']:.3g}/{r['param_diff']['max']:.3g}/"
        f"{r['param_diff']['share']:.3g} (max/bound in lr a step "
        f"{r['param_diff']['steps_lr']}), ranks bit-identical; peak bytes a "
        f"rank {r['peak_bytes_rank']} (one card "
        f"{res['one_card']['peak_bytes']}); resident bytes a rank "
        f"{r['bytes_rank']}; collectives a step {r['collectives_per_step']}"
        f", their ms (synchronized) a rank {r['collective_ms']}")
    out["cli"] = _auto_cards_cli(torch, tmp, n)
    # data_parallel over the cards against one card's call
    cfg = parse_config(inputs["argv"], is_train=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        G = define_G(cfg, torch.Generator().manual_seed(5))
    export_generator(cfg, G, os.path.join(tmp, "dp_serve"))
    served = load_exported(os.path.join(tmp, "dp_serve"), device=DEV)
    call = served.data_parallel([torch.device(DEV, i) for i in range(n)])
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (AUTO_SERVE_B, CROP, CROP, C)).astype(np.float32)
    c = np.eye(NB, dtype=np.float32)[rng.integers(0, NB, AUTO_SERVE_B)]
    # Like batch sizes: each card's rows against one card's call on
    # those rows alone (the gate), beside one card's call on the whole
    # batch: cuDNN picks its algorithms by the batch size, so one card's
    # call at AUTO_SERVE_B // n rows and at AUTO_SERVE_B rows may sum in
    # another order
    got, whole = call(x, c), served(x, c)
    k = AUTO_SERVE_B // n
    alone = np.concatenate([served(x[i * k:(i + 1) * k], c[i * k:(i + 1) * k])
                            for i in range(n)])
    err = float(np.abs(got - alone).max())
    err_whole = float(np.abs(got - whole).max())
    err_batch = float(np.abs(alone - whole).max())
    check(err <= 1e-5, f"--cards: data_parallel off one card's call on the "
          f"same {k}-row shards by {err} (against the {AUTO_SERVE_B}-row "
          f"call {err_whole}; one card at {k} rows against {AUTO_SERVE_B}: "
          f"{err_batch})")

    def rate(fn):
        for _ in range(3):
            fn(x, c)
        t = time.perf_counter()
        for _ in range(AUTO_SERVE_CALLS):
            fn(x, c)
        return AUTO_SERVE_B * AUTO_SERVE_CALLS / (time.perf_counter() - t)
    out["serve"] = {"max_abs_err": err, "err_against_whole_call": err_whole,
                    "one_card_batch_gap": err_batch,
                    "rows_per_s_cards": rate(call),
                    "rows_per_s_one_card": rate(served)}
    say(f"--cards {n}: data_parallel (f32, batch {AUTO_SERVE_B}, {k} rows a "
        f"card) within {err:.3g} of one card's call on the same {k}-row "
        f"shards; {err_whole:.3g} off one card's {AUTO_SERVE_B}-row call, "
        f"where one card's {k}-row calls are {err_batch:.3g} off it; "
        f"{out['serve']['rows_per_s_cards']:.1f}"
        f" rows/s over {n} cards, {out['serve']['rows_per_s_one_card']:.1f}"
        f" on one (host round trip included)")
    return out


# --------------------------------------------------------------------------- #
# phase 24: the spatial mesh axis
# --------------------------------------------------------------------------- #

SP_B, SP_STEPS, SP_POOL = 4, 3, 8    # (a): global batch, steps, pool
SP_NATIVE, SP_LOAD, SP_CROP = 286, 286, 256   # (a): 256 px crops of 286
SP_MESH = ["--mesh_shape", "1,2", "--mesh_axes", "data,spatial"]
# (a): every loss within 1e-5 of max(1, |loss|) of one rank's step, where
# the G pass reads D after its Adam update (loss_G_GAN, loss_G): of one
# rank's step with D, once updated, replaced by the band run's updated D
# (``_spatial_d_swapped``). Against one rank's own step those two are held
# to TRAIN_STEP_TOL, as phase 23 (a) holds every loss: Adam moves D's
# near-zero-gradient entries by up to 2 lr on f32 summation noise (the
# parameters' envelope), and D's output moves with them
SP_LOSS_REL = 1e-5
SP_AFTER_D_UPDATE = ("loss_G", "loss_G_GAN")
# phase 26: under R1 or the gradient penalty, loss_D and loss_D_r1 read
# D's input gradient, which jumps where a leaky ReLU's input sits within
# f32 noise of 0 (D at 256 px has millions a layer; one summation order
# takes the other slope): held to TRAIN_STEP_TOL, as phase 23 (a) holds
# every loss against one rank's own step (loss_D met 1.9e-5 of it on an
# H100 80GB HBM3 at 700 W, step 2 of resnet_losses)
SP_PENALTY_LOSSES = ("loss_D", "loss_D_r1")
SP_CLI_STEPS, SP_CLI_B = 4, 32   # (b): train_256_fid.sh's flags, 4 steps
# (b): the bf16 bounds stated before the first run (PERF.md, PR 14): the
# first logged step (the same weights) within 2e-2 of max(0.1, |loss|) of
# the plain run's, every step within 1e-1 (two runs whose bf16 convs round
# in another order drift apart through Adam by a few bf16 ulps a step; a
# wrong halo row moves a loss by more than that from the first step on)
SP_BF16_FIRST, SP_BF16_REL = 2e-2, 1e-1
SP_CARDS_STEPS = 3               # --cards: 3 steps, f32, within 1e-4 rel
SP_CARDS_MESHES = {               # --cards: the meshes over NCCL
    "data2_spatial2": ["--mesh_shape", "2,2", "--mesh_axes",
                       "data,spatial"],
    "spatial2_model2": ["--mesh_shape", "1,2,2", "--mesh_axes",
                        "data,spatial,model"]}
SP_FID = ["--netG", "resnet_9blocks", "--netD", "basic", "--norm",
          "instance", "--load_size", "286", "--crop_size", "256",
          "--batch_size", "32", "--n_age_bins", "10", "--gan_mode", "lsgan",
          "--lambda_L1", "100", "--pool_size", "64", "--lr", "0.0002",
          "--beta1", "0.5", "--niter", "1", "--niter_decay", "0",
          "--print_freq", "1", "--save_epoch_freq", "0", "--num_threads",
          "8", "--dataset_mode", "synthetic"]   # train_256_fid.sh's flags


def _spatial_inputs(cards: bool = False, extra=(), seed=None) -> dict:
    """Phase 24 (a)'s config and inputs: the default GAN at full width in
    f32, 256 px crops of 286 px u8 canvases with everything drawn (crops,
    flips, target bins, pool slots), the pool on; seeded global batches, a
    warm-up step's and SP_STEPS steps'. ``cards``: --cards' inputs,
    train_256_fid.sh's model, batch and pool in f32, SP_CARDS_STEPS
    steps. ``extra``: flags after the config's (phase 25's levers)."""
    rng = np.random.default_rng(seed or (25 if cards else 24))
    b, steps = (SP_CLI_B, SP_CARDS_STEPS) if cards else (SP_B, SP_STEPS)
    argv = ["--netG", NETG, "--ngf", str(NGF), "--netD", "basic", "--ndf",
            str(NGF), "--norm", "instance", "--crop_size", str(SP_CROP),
            "--load_size", str(SP_LOAD), "--n_age_bins", str(NB),
            "--batch_size", str(b), "--dtype", "float32", "--gan_mode",
            "lsgan", "--lambda_L1", "100", "--lr_policy", "constant"]
    argv += (["--pool_size", "64", "--lr", "0.0002", "--beta1", "0.5"]
             if cards else ["--pool_size", str(SP_POOL), "--cond_inject",
                            "input"])
    return {"dev": DEV, "argv": argv + list(extra),
            "batches": [{"image": rng.integers(0, 256, (b, SP_NATIVE,
                                                        SP_NATIVE, C),
                                               dtype=np.uint8),
                         "bin": rng.integers(0, NB, b)}
                        for _ in range(1 + steps)]}


def _b1_band_check(torch, case, bands) -> float:
    """B1 writing each band ``(r0, rows)`` of the crops of ``case`` (images,
    offsets, flips at phase 24's shape) in f32 and bf16: bit-identical to
    the kernel's whole crop sliced, within F32_TOL (f32) or a bf16 ulp of
    the plain twin's band; returns the largest f32 gap."""
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.ops.preprocess import preprocess_batch
    imgs, cy, cx, fl = case
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        whole = cp.preprocess_batch_cuda(imgs, cy, cx, fl, SP_LOAD, SP_CROP,
                                         out_dtype=dt)
        for r0, h in bands:
            band = cp.preprocess_batch_cuda(imgs, cy, cx, fl, SP_LOAD,
                                            SP_CROP, out_dtype=dt, row0=r0,
                                            n_rows=h)
            check(torch.equal(band, whole[:, r0:r0 + h]),
                  f"B1 band [{r0}, {r0 + h}) ({dt}): not the whole crop's "
                  f"rows")
            plain = preprocess_batch(imgs, cy, cx, fl.bool(), SP_LOAD,
                                     SP_CROP, out_dtype=dt, row0=r0,
                                     n_rows=h)
            err = float((band.float() - plain.float()).abs().max())
            lim = F32_TOL if dt == torch.float32 else 2.0 ** -7
            check(err <= lim, f"B1 band [{r0}, {r0 + h}) {dt}: {err} off "
                  f"its plain twin")
            if dt == torch.float32:
                worst = max(worst, err)
    return worst


def _b1_bands(torch) -> dict:
    """B1 writing bands on the card: each band of a spatial axis of 2 and
    4 (rows [r0, r0 + h) of every crop) bit-identical to the kernel's whole
    crop sliced and within F32_TOL of the plain twin's band, at phase 24's
    shape; then the band form timed beside the whole crop (graph replay)."""
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    from pcgan_tpu_torch.ops.preprocess import preprocess_batch
    from pcgan_tpu_torch.parallel.spatial import bands_of
    rng = np.random.default_rng(240)
    imgs, cy, cx, fl = _preprocess_case(torch, rng, SP_B, SP_NATIVE, SP_LOAD,
                                        SP_CROP, False)
    out = {"shape": f"B{SP_B} {SP_NATIVE}->{SP_LOAD}->{SP_CROP} C{C}"}
    _b1_band_check(torch, (imgs, cy, cx, fl),
                   [(b.r0, b.h) for n in (2, 4) for b in bands_of(SP_CROP, n)])
    half = bands_of(SP_CROP, 2)[1]

    def band_call():
        return cp.preprocess_batch_cuda(imgs, cy, cx, fl, SP_LOAD, SP_CROP,
                                        out_dtype=torch.float32,
                                        row0=half.r0, n_rows=half.h)

    def whole_call():
        return cp.preprocess_batch_cuda(imgs, cy, cx, fl, SP_LOAD, SP_CROP,
                                        out_dtype=torch.float32)
    out["band_ms"] = graph_ms(torch, band_call)
    out["whole_ms"] = graph_ms(torch, whole_call)
    out["band_rows"] = half.h
    say(f"B1 bands of 2 and 4 ranks bit-identical to the whole crop's "
        f"rows (f32, bf16) and within the gates of the plain twin; the "
        f"band of {half.h} rows {out['band_ms']:.5f} ms, the whole crop "
        f"{out['whole_ms']:.5f} ms (f32, graph replay, {out['shape']})")
    return out


def _spatial_prepare(torch, tmp, name: str = "spatial",
                     inputs=None) -> dict:
    """``inputs`` (phase 24 (a)'s by default), one rank's warm-up state and
    its plain steps (each from the state before it, ``_auto_steps``),
    written under ``{tmp}/{name}`` for the ranks (phase 23 (a)'s spawn, or
    --cards' torchrun); returns the plain steps. ``inputs['gamma']``: every
    attention block's gamma before the warm-up step (at 0 the block is the
    identity); ``inputs['ada_p']``: ADA's p before it (at 0 no sample is
    augmented)."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.parallel.train_parallel import (
        make_parallel_train_step)
    from pcgan_tpu_torch.train import create_train_state
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    work = os.path.join(tmp, name)
    os.makedirs(work)
    inputs = inputs or _spatial_inputs()
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    cfg = parse_config(inputs["argv"], is_train=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        G = define_G(cfg, torch.Generator().manual_seed(1)).to(DEV)
        D = define_D(cfg, torch.Generator().manual_seed(2)).to(DEV)
    if "gamma" in inputs:
        with torch.no_grad():
            for net in (G, D):
                for k, prm in net.named_parameters():
                    if k.endswith("attn.gamma"):
                        prm.fill_(inputs["gamma"])
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(0),
                               vgg=_vgg_of(cfg))
    if "ada_p" in inputs:
        state.aug_p = torch.tensor(inputs["ada_p"], device=DEV)
    make_parallel_train_step(cfg, G, D)(
        state, {k: torch.from_numpy(v).to(DEV) for k, v in
                inputs["batches"][0].items()})
    ckpt.save_state(state, tmp, name, "s0")
    del state, G, D
    torch.cuda.empty_cache()
    one = _auto_steps(torch, None, inputs, work)
    torch.save(one, os.path.join(work, "one.pt"))
    torch.cuda.empty_cache()
    return one


def _spatial_d_swapped(torch, work, band) -> list:
    """One rank's plain step i again from its state before it, with D,
    once Adam has updated it, replaced by the band run's updated D
    (``band``: the band run's parameters after each step): the G pass's
    losses (SP_AFTER_D_UPDATE) of each step. Against the band run's, they
    show whether D's update alone parts the two runs' G losses."""
    from pcgan_tpu_torch import train as ttrain
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.parallel.train_parallel import (
        make_parallel_train_step)
    from pcgan_tpu_torch.train import create_train_state
    from pcgan_tpu_torch.utils.checkpoint import load_state
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    cfg = parse_config(inputs["argv"], is_train=True)
    update, d_after, out = ttrain.StepParts.update, {}, []

    def swapped(self, state, which, grads):
        update(self, state, which, grads)
        if which == "D":
            with torch.no_grad():
                for k, p in state.D.named_parameters():
                    p.copy_(d_after[k])
    ttrain.StepParts.update = swapped
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True     # as ``_auto_steps``
    try:
        for i, b in enumerate(inputs["batches"][1:]):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                G, D = define_G(cfg).to(DEV), define_D(cfg).to(DEV)
            state = create_train_state(cfg, G, D,
                                       torch.Generator().manual_seed(0),
                                       vgg=_vgg_of(cfg))
            load_state(state, torch.load(os.path.join(work, f"s{i}.pt"),
                                         weights_only=True))
            d_after.clear()
            d_after.update({k[2:]: v.to(DEV) for k, v in band[i].items()
                            if k.startswith("D.")})
            m = make_parallel_train_step(cfg, G, D)(
                state, {k: torch.from_numpy(v).to(DEV) for k, v in
                        b.items()})
            out.append({k: float(m[k]) for k in SP_AFTER_D_UPDATE})
    finally:
        ttrain.StepParts.update = update
        torch.backends.cudnn.deterministic = prev
    return out


def _against_one(torch, what, ranks, one, work, steps, loss_ok) -> dict:
    """Every rank's gathered parameters bit-identical to rank 0's, each
    step's losses ``loss_ok(i, key, got, want)`` against one rank's, and
    the parameters within the one-step envelope of one rank's step from
    the same state (``{work}/s0.pt``, then one rank's after each step),
    the config's inert parameters (``_inert``) to its sign-flip bound."""
    a = ranks[0]
    for r, b in enumerate(ranks[1:], 1):
        apart = sorted({k for i, ps in enumerate(a["params"])
                        for k, v in ps.items()
                        if not torch.equal(v, b["params"][i][k])})
        check(a["losses"] == b["losses"] and not apart,
              f"{what}: ranks 0 and {r} differ: losses {a['losses']} vs "
              f"{b['losses']}; parameters {apart[:8]}")
    for i, (x, y) in enumerate(zip(a["losses"], one["losses"])):
        check(set(x) == set(y), f"{what}: step {i} metric keys differ")
        for k in y:
            check(loss_ok(i, k, x[k], y[k]),
                  f"{what}: step {i} {k} {x[k]} vs one rank {y[k]}")
    starts = [one["params"][i - 1] if i else None for i in range(steps)]
    s0 = torch.load(os.path.join(work, "s0.pt"), weights_only=True)
    starts[0] = {f"{n}.{k}": v for n in ("G", "D") for k, v in s0[n].items()
                 if f"{n}.{k}" in one["params"][0]}
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    inert = _inert(inputs["argv"])
    worst = _worst_of([_envelope(f"step {i}", a["params"][i],
                                 one["params"][i], starts[i], what,
                                 count=i + 2, inert=inert)
                       for i in range(steps)])
    b1 = [r["b1"] for r in ranks]
    check(b1 == [steps] * len(ranks), f"{what}: B1 launches {b1} (want "
          f"{steps} a rank)")
    return worst


def _spatial_ranks(torch, work, what="(a) data 1 x spatial 2",
                   desc=None) -> dict:
    """Two gloo ranks on the one card at data 1 x spatial 2 (run in phase
    23 (a)'s spawn) against one rank's plain step, of the inputs under
    ``work`` (phase 24 (a)'s, or a phase-25 lever config's, described by
    ``desc``)."""
    one = torch.load(os.path.join(work, "one.pt"), weights_only=False)
    a, b = [torch.load(os.path.join(work, f"rank{r}.pt"),
                       weights_only=False) for r in range(2)]
    swap = _spatial_d_swapped(torch, work, a["params"])
    gaps = {"forward": 0.0, "after_d_update": 0.0, "d_swapped": 0.0,
            "penalty": 0.0}
    from pcgan_tpu_torch.config import parse_config
    t = parse_config(torch.load(os.path.join(work, "inputs.pt"),
                                weights_only=False)["argv"]).train
    penalty = (SP_PENALTY_LOSSES if t.lambda_r1 > 0 or t.gan_mode == "wgangp"
               else ())

    def rel(x, y):
        return abs(x - y) / max(1.0, abs(y))

    def loss_ok(i, k, x, y):
        if k in penalty:
            gaps["penalty"] = max(gaps["penalty"], rel(x, y))
            return abs(x - y) <= TRAIN_STEP_TOL + TRAIN_STEP_TOL * abs(y)
        if k not in SP_AFTER_D_UPDATE:
            gaps["forward"] = max(gaps["forward"], rel(x, y))
            return rel(x, y) <= SP_LOSS_REL
        gaps["after_d_update"] = max(gaps["after_d_update"], rel(x, y))
        gaps["d_swapped"] = max(gaps["d_swapped"], rel(x, swap[i][k]))
        return (rel(x, swap[i][k]) <= SP_LOSS_REL and abs(x - y)
                <= TRAIN_STEP_TOL + TRAIN_STEP_TOL * abs(y))
    worst = _against_one(torch, what, [a, b], one, work, SP_STEPS, loss_ok)
    halo = {k: v for k, v in a["collectives"][-1].items()
            if k.endswith("/spatial")}
    check(halo.get("halo/spatial", 0) > 0 and halo.get(
        "halo_grad/spatial", 0) > 0, f"{what}: no halo exchange ran: "
          f"{a['collectives'][-1]}")
    b1 = [a["b1"], b["b1"]]
    out = {"loss_max_rel_gap": gaps["forward"],
           "loss_penalty_gap": gaps["penalty"],
           "loss_after_d_update_gap": gaps["after_d_update"],
           "loss_d_swapped_gap": gaps["d_swapped"],
           "param_diff": worst, "b1_launches": b1,
           "peak_bytes_rank": [a["peak_bytes"], b["peak_bytes"]],
           "peak_bytes_one_rank": one["peak_bytes"],
           "collectives_per_step": a["collectives"][-1],
           "collective_ms": [a["collective_ms"], b["collective_ms"]],
           "step_s": a["step_s"], "one_rank_step_s": one["step_s"]}
    desc = desc or (f"f32, full width, {SP_CROP} px crops of {SP_NATIVE} px "
                    f"canvases, global batch {SP_B}, everything drawn, pool "
                    f"on")
    pen = (f", {'/'.join(penalty)} (D's input gradient) within "
           f"{gaps['penalty']:.3g}" if penalty else "")
    say(f"{what}, two gloo ranks on one card ({desc}): the forward "
        f"passes' losses within "
        f"{gaps['forward']:.3g} (of max(1, |loss|)) of one rank's over "
        f"{SP_STEPS} steps{pen}; loss_G_GAN, loss_G within "
        f"{gaps['d_swapped']:.3g} of one rank's step with D swapped for the "
        f"band run's updated D, and {gaps['after_d_update']:.3g} of one "
        f"rank's own; parameters median/max/share "
        f"{worst['median']:.3g}/{worst['max']:.3g}/{worst['share']:.3g} "
        f"(max/bound in lr a step {worst['steps_lr']}), "
        f"ranks bit-identical; B1 {b1}; peak allocated bytes a rank "
        f"{out['peak_bytes_rank']} (one rank {one['peak_bytes']}); "
        f"collectives a step {out['collectives_per_step']}, their ms "
        f"(synchronized) {out['collective_ms']}; step s {a['step_s']} "
        f"(one rank {one['step_s']})")
    return out


def _spatial_worker(spec_path: str) -> None:
    """``chip_smoke.py --spatial-worker <spec>`` under ``torchrun
    --nproc_per_node 2`` on one card: both ranks on cuda:0 over gloo (NCCL
    takes one rank a card), then ``_auto_worker``."""
    import torch.distributed as dist
    os.environ["LOCAL_RANK"] = "0"
    dist.init_process_group("gloo")
    try:
        _auto_worker(spec_path)
    finally:
        dist.destroy_process_group()


def _spatial_cli(torch, tmp) -> dict:
    """(b) train_256_fid.sh's flags (bf16, the lowch routes) under
    ``torchrun --nproc_per_node 2`` over gloo on the one card at
    ``--mesh_shape 1,2 --mesh_axes data,spatial``, against the same flags
    with no mesh: the loss streams within SP_BF16_REL."""
    from pcgan_tpu_torch import train_main
    from pcgan_tpu_torch.ops import cuda_preprocess as cp
    flags = SP_FID + ["--max_dataset_size", str(SP_CLI_B * SP_CLI_STEPS),
                      "--dtype", "bfloat16", "--checkpoints_dir",
                      os.path.join(tmp, "spatial_cli")]
    spec = {"out": os.path.join(tmp, "spatial_cli.json"),
            "time_collectives": False,
            "runs": {"spatial": flags + SP_MESH + ["--name", "spatial"]}}
    path = os.path.join(tmp, "spatial_cli_spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    # the plain run meanwhile, on the same card (nothing here is timed)
    handle = _torchrun_start(path, 2, "--spatial-worker")
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.reset_peak_memory_stats()
        cp.launches = 0
        train_main.main(flags + ["--mesh_shape", "1", "--name", "plain"])
        plain = {"b1": cp.launches,
                 "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    finally:
        torch.backends.cudnn.deterministic = False
        rc, log = _torchrun_wait(handle)
    call_s = time.perf_counter() - t0
    check(rc == 0, f"(b) torchrun exited {rc}:\n{log[-4000:]}")
    ranks = []
    for r in range(2):
        with open(f"{spec['out']}.rank{r}") as f:
            ranks.append(json.load(f)["spatial"])
    got = _loss_rows(os.path.join(tmp, "spatial_cli", "spatial"))
    want = _loss_rows(os.path.join(tmp, "spatial_cli", "plain"))
    check(len(got) == len(want) == SP_CLI_STEPS,
          f"(b) {len(got)} vs {len(want)} logged steps")
    gaps = [max(abs(x[k] - y[k]) / max(0.1, abs(y[k])) for k in y)
            for x, y in zip(got, want)]
    gap = max(gaps)
    check(gaps[0] <= SP_BF16_FIRST and gap <= SP_BF16_REL,
          f"(b) the band run's losses are {gaps} off the plain run's "
          f"(bounds {SP_BF16_FIRST} at the first step, {SP_BF16_REL}): "
          f"{got} vs {want}")
    check(all(r["b1"] == SP_CLI_STEPS for r in ranks),
          f"(b) B1 launches {[r['b1'] for r in ranks]}")
    out = {"loss_max_rel_gap": gap, "gap_by_step": gaps,
           "bounds": [SP_BF16_FIRST, SP_BF16_REL],
           "peak_gb_rank": [r["peak_gb"] for r in ranks],
           "b1": [r["b1"] for r in ranks], "plain": plain,
           "collectives_per_step": ranks[0]["collectives_per_step"],
           "call_s": call_s}
    say(f"(b) train_256_fid.sh's flags (bf16, batch 32, 256 px, the lowch "
        f"routes) under torchrun --nproc_per_node 2 over gloo on one card "
        f"at data 1 x spatial 2: loss stream within {gaps} of the plain "
        f"run's by step (of max(0.1, |loss|); bounds {SP_BF16_FIRST} at the "
        f"first step, {SP_BF16_REL}); peak GiB a "
        f"rank {[round(g, 3) for g in out['peak_gb_rank']]} (plain "
        f"{plain['peak_gb']:.3f}); B1 {out['b1']} (plain {plain['b1']}); "
        f"collectives a step {out['collectives_per_step']}; the torchrun "
        f"call, with the plain run beside it, {call_s:.1f} s")
    return out


def phase_spatial(torch, tmp) -> dict:
    """Phase 24: the spatial axis. B1's bands on the card; (a) two gloo
    ranks on the one card at data 1 x spatial 2 against one rank (both
    run in phase 23 (a): ``_spatial_prepare``, ``_auto_rank``); (b)
    train_256_fid.sh's flags under torchrun at ``--mesh_shape 1,2``
    against the plain run."""
    t0 = time.perf_counter()
    out = {"b1_bands": _b1_bands(torch)}
    out["ranks"] = _spatial_ranks(torch, os.path.join(tmp, "spatial"))
    torch.cuda.empty_cache()
    out["cli"] = _spatial_cli(torch, tmp)
    out["launches_per_run"] = {
        "ranks": sum(out["ranks"]["b1_launches"]),
        "cli_ranks": sum(out["cli"]["b1"]),
        "cli_plain": out["cli"]["plain"]["b1"]}
    out["phase_s"] = time.perf_counter() - t0
    say(f"phase 24: {out['phase_s']:.1f} s; B1 launches "
        f"{out['launches_per_run']}")
    return out


# --------------------------------------------------------------------------- #
# phase 25: the model levers on bands
# --------------------------------------------------------------------------- #

LEVER_SP = {   # phase 25: each config's lever flags (phase 24 (a)'s after)
    "resnet_levers": ["--netG", "resnet_9blocks@resize_conv", "--g_attn",
                      "--d_attn", "--netD", "multiscale", "--norm", "group",
                      "--no-no_dropout", "--remat", "--remat_blocks", "3"],
    "unet256": ["--netG", "unet_256", "--no-no_dropout", "--remat",
                "--remat_blocks", "2"]}
SP_GAMMA = 0.5                    # every attention block's gamma


def _lever_inputs(name) -> dict:
    """Phase 25's inputs of one lever config: phase 24 (a)'s (256 px, f32,
    global batch 4, pool on, everything drawn) with the config's flags,
    the attention's gamma at SP_GAMMA, batches of their own seed."""
    inputs = _spatial_inputs(extra=LEVER_SP[name],
                             seed=251 + list(LEVER_SP).index(name))
    inputs["gamma"] = SP_GAMMA
    inputs["audit"] = 2               # SP_MESH's spatial size
    return inputs


def _without_remat(inputs) -> dict:
    """``inputs`` with ``--remat`` and ``--remat_blocks N`` taken out."""
    argv, out = inputs["argv"], []
    skip = False
    for a in argv:
        if skip:
            skip = False
        elif a == "--remat_blocks":
            skip = True
        elif a != "--remat":
            out.append(a)
    return {**inputs, "argv": out}


def phase_spatial_levers(torch, tmp, prepare_s: float) -> dict:
    """Phase 25: the model levers at data 1 x spatial 2 (two gloo ranks on
    the one card, run in phase 23 (a)'s spawn after phase 24 (a)'s, their
    one-rank runs prepared there in ``prepare_s``), each of the LEVER_SP
    configs held as phase 24 (a) holds its steps; the collectives a step
    beside the same step without --remat; B1's band at 1-row, uneven and
    odd-start heights."""
    from pcgan_tpu_torch.parallel.spatial import bands_of
    t0 = time.perf_counter()
    rng = np.random.default_rng(250)
    case = _preprocess_case(torch, rng, SP_B, SP_NATIVE, SP_LOAD, SP_CROP,
                            False)
    bands = ([(0, 1), (SP_CROP // 2 - 1, 1), (SP_CROP - 1, 1), (5, 19)]
             + [(b.r0, b.h) for b in bands_of(SP_CROP, 3)])
    out = {"b1_bands": {"bands": bands,
                        "f32_max_err": _b1_band_check(torch, case, bands)}}
    say(f"phase 25: B1's band at {bands} (1-row, odd-start and uneven "
        f"heights) bit-identical to the whole crop's rows (f32, bf16), "
        f"within {out['b1_bands']['f32_max_err']:.3g} of its plain twin")
    wall = 0.0
    for name, flags in LEVER_SP.items():
        work = os.path.join(tmp, f"levers_{name}")
        gamma = f", gamma {SP_GAMMA}" if "--g_attn" in flags else ""
        desc = (f"f32, full width, {' '.join(flags)}{gamma}, {SP_CROP} px "
                f"crops, global batch {SP_B}, everything drawn (dropout "
                f"too), pool on")
        r = out[name] = _spatial_ranks(torch, work, f"phase 25 {name}", desc)
        rank0 = torch.load(os.path.join(work, "rank0.pt"), weights_only=False)
        r["no_remat"] = rank0["no_remat"]
        r["ranks_wall_s"] = rank0["wall_s"]
        wall += rank0["wall_s"]
        mine = {k: v for k, v in r["collectives_per_step"].items()
                if k.endswith("/spatial")}
        plain = {k: v for k, v in rank0["no_remat"]["collectives"].items()
                 if k.endswith("/spatial")}
        check(mine.get("halo/spatial", 0) > plain.get("halo/spatial", 0) > 0,
              f"phase 25 {name}: --remat re-issued no halo exchange: {mine} "
              f"vs {plain} without it")
        if "--g_attn" in flags:
            check(mine.get("gather_band/spatial", 0) > 0
                  and mine.get("gather_band_grad/spatial", 0) > 0,
                  f"phase 25 {name}: no gather of the attention's keys: "
                  f"{mine}")
        say(f"phase 25 {name}: collectives a step on the spatial line "
            f"{mine}, without --remat {plain}; peak allocated bytes a rank "
            f"{r['peak_bytes_rank']} (without --remat "
            f"{rank0['no_remat']['peak_bytes']}, one rank "
            f"{r['peak_bytes_one_rank']}); the ranks' steps "
            f"{rank0['wall_s']:.1f} s")
        r["memory"] = _lever_memory(torch, work, name)
    out["launches_per_run"] = {name: sum(out[name]["b1_launches"])
                               for name in LEVER_SP}
    out["phase_s"] = time.perf_counter() - t0 + prepare_s + wall
    say(f"phase 25: {out['phase_s']:.1f} s (the one-rank prepare "
        f"{prepare_s:.1f} s and the ranks' {wall:.1f} s in phase 23's spawn "
        f"included); B1 launches {out['launches_per_run']}")
    return out


def _lever_memory(torch, work, name, phase="phase 25") -> dict:
    """Phase 25's (or 26's) memory audit of one config: no band rank keeps
    a whole square image for the backward, where one rank's step keeps
    some (``spatial.SavedAudit``); what autograd keeps a rank against one
    rank's; the bytes held before the first step and the owners of the
    peak (``_peak_owners``) on rank 0 and on one rank."""
    one = torch.load(os.path.join(work, "one.pt"), weights_only=False)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    check(any(a["n_whole"] for a in one["audit"]),
          f"{phase} {name}: the audit saw no whole image in one rank's "
          f"step")
    for r, rk in enumerate(ranks):
        seen = [(i, a["whole"]) for i, a in enumerate(rk["audit"])
                if a["n_whole"]]
        check(not seen, f"{phase} {name}: rank {r} keeps whole square "
              f"images for the backward (step, shapes): {seen}")
    kept = [[a["saved_bytes"] for a in rk["audit"]] for rk in ranks]
    ratio = [round(max(k) / max(a["saved_bytes"] for a in one["audit"]), 4)
             for k in kept]
    out = {"saved_bytes_one_rank": [a["saved_bytes"] for a in one["audit"]],
           "saved_bytes_rank": kept, "saved_ratio": ratio,
           "one_rank": {k: one["audit"][0].get(k)
                        for k in ("held_before", "peak", "owners")},
           "rank0": {k: ranks[0]["audit"][0].get(k)
                     for k in ("held_before", "peak", "owners")}}
    say(f"{phase} {name}: no whole square image kept by either rank (one "
        f"rank's step keeps {one['audit'][0]['n_whole']}, e.g. "
        f"{one['audit'][0]['whole'][:2]}); kept for the backward a rank "
        f"x{ratio} of one rank's ({out['saved_bytes_one_rank'][0]} B)")
    for who in ("one_rank", "rank0"):
        m = out[who]
        if m["peak"] is not None:
            say(f"  {who}: {m['held_before']} B held before the first "
                f"step, peak {m['peak']} B; live at the peak: "
                + "; ".join(f"{b} B {w}" for b, w in m["owners"]))
    return out


# --------------------------------------------------------------------------- #
# phase 26: the loss and data levers on bands
# --------------------------------------------------------------------------- #

LOSS_SP = {   # phase 26: each config's loss and data levers (24 (a)'s after)
    "resnet_losses": ["--lambda_r1", "10", "--lambda_feat", "10",
                      "--lambda_vgg", "10", "--vgg_path", "random",
                      "--diff_augment", "color,translation,cutout",
                      "--ada_target", "0.6"],
    "wgangp_attn": ["--gan_mode", "wgangp", "--netD", "multiscale",
                    "--d_attn", "--norm", "group", "--lambda_feat", "10",
                    "--diff_augment", "translation,cutout"]}
LOSS_ADA_P = 0.5                  # ADA's p before the warm-up step
LOSS_KEYS = ("loss_D", "loss_D_r1", "loss_G_feat", "loss_G_vgg", "ada_p",
             "ada_rt")            # the new terms (the GP rides in loss_D)


def _loss_inputs(name) -> dict:
    """Phase 26's inputs of one loss-lever config: phase 24 (a)'s (256 px,
    f32, global batch 4, pool on, everything drawn, the augmentation and
    ADA's gates and GP's weights too) with the config's flags, the
    attention's gamma at SP_GAMMA, ADA's p at LOSS_ADA_P before the
    warm-up step (at 0 no sample is augmented), batches of their own
    seed."""
    inputs = _spatial_inputs(extra=LOSS_SP[name],
                             seed=261 + list(LOSS_SP).index(name))
    inputs["gamma"] = SP_GAMMA
    if "--ada_target" in LOSS_SP[name]:
        inputs["ada_p"] = LOSS_ADA_P
    inputs["audit"] = 2               # SP_MESH's spatial size
    return inputs


def phase_spatial_losses(torch, tmp, prepare_s: float) -> dict:
    """Phase 26: the loss and data levers at data 1 x spatial 2 (two gloo
    ranks on the one card, run in phase 23 (a)'s spawn after phase 25's,
    their one-rank runs prepared there in ``prepare_s``), each of the
    LOSS_SP configs held as phase 25 holds its configs (``_spatial_ranks``:
    the losses, the new terms among them, against one rank's, the
    envelope, the ranks bit-identical, B1 SP_STEPS times a rank), no whole
    image kept on a band rank with R1's and GP's double backward in the
    audit (``_lever_memory``), and the collectives a step counted."""
    t0 = time.perf_counter()
    out, wall = {}, 0.0
    for name, flags in LOSS_SP.items():
        work = os.path.join(tmp, f"losses_{name}")
        ada = (f", ADA's p from {LOSS_ADA_P}" if "--ada_target" in flags
               else "")
        desc = (f"f32, full width, {' '.join(flags)}{ada}, gamma "
                f"{SP_GAMMA}, {SP_CROP} px crops, global batch {SP_B}, "
                f"everything drawn, pool on")
        r = out[name] = _spatial_ranks(torch, work, f"phase 26 {name}", desc)
        one = torch.load(os.path.join(work, "one.pt"), weights_only=False)
        rank0 = torch.load(os.path.join(work, "rank0.pt"), weights_only=False)
        r["ranks_wall_s"] = rank0["wall_s"]
        wall += rank0["wall_s"]
        gaps = {}
        for k in LOSS_KEYS:
            if k in one["losses"][0]:
                gaps[k] = max(abs(x[k] - y[k]) / max(1.0, abs(y[k]))
                              for x, y in zip(rank0["losses"],
                                              one["losses"]))
        r["term_gaps"] = gaps
        r["terms"] = [{k: x[k] for k in gaps} for x in rank0["losses"]]
        mine = {k: v for k, v in r["collectives_per_step"].items()
                if k.endswith("/spatial")}
        r["spatial_collectives"] = mine
        if "--d_attn" in flags:
            check(mine.get("gather_band/spatial", 0) > 0
                  and mine.get("gather_band_grad/spatial", 0) > 0,
                  f"phase 26 {name}: no gather of the attention's keys: "
                  f"{mine}")
        if "ada_p" in gaps:
            ps = {round(x["ada_p"], 9) for x in one["losses"]}
            check(len(ps) > 1, f"phase 26 {name}: ADA's p never moved: "
                  f"{ps}")
        say(f"phase 26 {name}: the new terms within {gaps} (of max(1, "
            f"|term|)) of one rank's, rank 0's {r['terms']}; collectives a "
            f"step on the spatial line {mine}; peak allocated bytes a rank "
            f"{r['peak_bytes_rank']} (one rank {r['peak_bytes_one_rank']}); "
            f"the ranks' steps {rank0['wall_s']:.1f} s")
        r["memory"] = _lever_memory(torch, work, name, "phase 26")
    out["launches_per_run"] = {name: sum(out[name]["b1_launches"])
                               for name in LOSS_SP}
    out["phase_s"] = time.perf_counter() - t0 + prepare_s + wall
    say(f"phase 26: {out['phase_s']:.1f} s (the one-rank prepare "
        f"{prepare_s:.1f} s and the ranks' {wall:.1f} s in phase 23's spawn "
        f"included); B1 launches {out['launches_per_run']}")
    return out


def _spatial_cards_worker(work: str) -> None:
    """``chip_smoke.py --spatial-cards-worker <dir>`` under torchrun, one
    NCCL rank a card: each mesh of ``{dir}/meshes.json`` ({name: flags})
    in turn, every step from one card's state before it
    (``_auto_steps``); rank r writes ``{dir}/rank{r}.pt``."""
    sys.path.insert(0, HERE)
    import torch
    from pcgan_tpu_torch.parallel.mesh import init_distributed
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    with open(os.path.join(work, "meshes.json")) as f:
        meshes = json.load(f)
    mesh = init_distributed(DEV)
    try:
        res = {name: _auto_steps(torch, mesh, inputs, work, flags)
               for name, flags in meshes.items()}
        torch.save(res, os.path.join(work, f"rank{mesh.rank}.pt"))
    finally:
        mesh.close()


def _cards_run(torch, tmp, name, inputs, meshes, n, steps) -> dict:
    """--cards: one card's plain steps of ``inputs`` (``_spatial_prepare``
    under ``{tmp}/{name}``), then each mesh of ``meshes`` ({name: flags})
    under ``torchrun --nproc_per_node n`` on NCCL, each step from one
    card's state before it, against one card's plain step: losses within
    1e-4 rel, the parameters within the one-step envelope, every rank
    bit-identical."""
    work = os.path.join(tmp, name)
    one = _spatial_prepare(torch, tmp, name, inputs)
    with open(os.path.join(work, "meshes.json"), "w") as f:
        json.dump(meshes, f)
    t0 = time.perf_counter()
    rc, log = _torchrun_auto(work, n, "--spatial-cards-worker")
    call_s = time.perf_counter() - t0
    check(rc == 0, f"--cards {name}: torchrun exited {rc}:\n{log[-4000:]}")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(n)]
    out = {"one_card": {"peak_bytes": one["peak_bytes"],
                        "bytes": one["bytes"], "step_s": one["step_s"]},
           "call_s": call_s}
    for mname in meshes:
        rk = [r[mname] for r in ranks]
        gap = {"max": 0.0}

        def loss_ok(i, k, x, y):
            d = abs(x - y) / max(abs(y), 1e-12) if x != y else 0.0
            gap["max"] = max(gap["max"], d)
            return d <= 1e-4
        worst = _against_one(torch, f"--cards {mname}", rk, one, work, steps,
                             loss_ok)
        out[mname] = {"loss_max_rel_gap": gap["max"], "param_diff": worst,
                      "peak_bytes_rank": [r["peak_bytes"] for r in rk],
                      "bytes_rank": [r["bytes"]["rank"] for r in rk],
                      "collectives_per_step": rk[0]["collectives"][-1],
                      "collective_ms": [r["collective_ms"] for r in rk],
                      "coords": [r["coords"] for r in rk],
                      "step_s": rk[0]["step_s"]}
    torch.cuda.empty_cache()
    return out


def _spatial_cards(torch, tmp, n) -> dict:
    """--cards: train_256_fid.sh's model, batch and pool in f32 at data 2 x
    spatial 2 and at data 1 x spatial 2 x model 2, and phase 25's and
    phase 26's first configs at data 1 x spatial 4, on NCCL
    (``_cards_run``)."""
    runs = {"train_256_fid": (_spatial_inputs(cards=True), SP_CARDS_MESHES,
                              SP_CARDS_STEPS, f"train_256_fid.sh's model, "
                              f"f32, batch {SP_CLI_B}"),
            "resnet_levers": (_lever_inputs("resnet_levers"),
                              {"data1_spatial4": ["--mesh_shape", "1,4",
                                                  "--mesh_axes",
                                                  "data,spatial"]},
                              SP_STEPS, f"phase 25's lever resnet, f32, "
                              f"batch {SP_B}"),
            "resnet_losses": (_loss_inputs("resnet_losses"),
                              {"data1_spatial4": ["--mesh_shape", "1,4",
                                                  "--mesh_axes",
                                                  "data,spatial"]},
                              SP_STEPS, f"phase 26's loss-lever resnet, f32, "
                              f"batch {SP_B}")}
    out = {}
    for run, (inputs, meshes, steps, desc) in runs.items():
        res = out[run] = _cards_run(torch, tmp, f"cards_{run}", inputs,
                                    meshes, n, steps)
        for name in meshes:
            r = res[name]
            say(f"--cards {n}: {name} on NCCL ({desc}, each step from one "
                f"card's state): losses within {r['loss_max_rel_gap']:.3g} "
                f"(rel) of one card's over {steps} steps, parameters "
                f"median/max/share {r['param_diff']['median']:.3g}/"
                f"{r['param_diff']['max']:.3g}/{r['param_diff']['share']:.3g}"
                f" (max/bound in lr a step {r['param_diff']['steps_lr']})"
                f", ranks bit-identical; peak allocated bytes a rank "
                f"{r['peak_bytes_rank']} (one card "
                f"{res['one_card']['peak_bytes']}); collectives a step "
                f"{r['collectives_per_step']}, their ms (synchronized) a "
                f"rank {r['collective_ms']}")
    return out


DP_CARDS_CACHE = ["--dataset_mode", "synthetic", "--max_dataset_size",
                  "1000", "--batch_size", "256", "--crop_size", "128",
                  "--load_size", "143"]   # --cards: the sharded cache's rows


def main_cards(n: int) -> None:
    """``chip_smoke.py --cards N``, on a machine with N cards: phase 22 (a)
    with one NCCL rank a card (rank r on cuda:r) against one rank, the
    collectives' kernels of one profiled step on each rank, and the
    sharded cache across the ranks (every rank's rows against the
    replicated cache's); then phases 24 and 25 on the cards
    (``_spatial_cards``) and phase 23 (``_auto_cards``). Prints the card
    line, then a JSON summary."""
    if not os.path.isdir(os.path.join(HERE, "pcgan_tpu_torch")):
        fail("run chip_smoke.py from a checkout of the repository "
             "(pcgan_tpu_torch/ is missing)")
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        fail(f"--cards {n}: needs {n} CUDA cards")
    sys.path.insert(0, HERE)
    from pcgan_tpu_torch.device import resolve_device
    resolve_device("cuda")
    t0 = time.perf_counter()
    card = phase_device(torch)
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        out = _dp_ranks(torch, tmp, n, "nccl", shared=False,
                        cache_argv=DP_CARDS_CACHE)
        torch.cuda.empty_cache()
        spatial = _spatial_cards(torch, tmp, n)
        torch.cuda.empty_cache()
        sharded = _auto_cards(torch, tmp, n)
    say(f"total {time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    print(json.dumps({"cards": n, "data_parallel": out,
                      "sharded_state": sharded, "spatial": spatial},
                     default=_jsonable), flush=True)


def _face_row(folder, i) -> np.ndarray:
    """Image i of the folder as the host's image routes give it to G: f32
    [-1, 1] at the crop size (the folder's 200 px canvas resized)."""
    from pcgan_tpu_torch.data.resample import pil_resize_np
    from pcgan_tpu_torch.data.utkface import UTKFaceDataset
    img = UTKFaceDataset(folder).get_raw(i)["image"]
    return pil_resize_np(img, CROP).astype(np.float32) / 127.5 - 1.0


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
    build = phase_build()
    b1 = phase_kernel_check(torch)
    b2 = phase_wgrad_check(torch)
    norm = phase_norm_check(torch)
    with tempfile.TemporaryDirectory() as tmp:
        sampling = phase_main_path(torch, tmp)
        parity = phase_card_parity(torch, tmp)
        path2 = phase_path2(torch)
        path1 = phase_path1(torch, tmp)
        train_parity = phase_train_parity(torch)
        path3 = phase_path3(torch, tmp)
        cond = phase_path1_cond(torch, tmp, path3["bundle_dir"],
                                path1["profile"])
        cond_parity = phase_cond_parity(torch)
        jpeg_ok = build["jpeg_unavailable"] is None
        folder, want = _real_folder(tmp, png=not jpeg_ok)
        decoder = phase_decoder(folder, want)
        if jpeg_ok:
            # the same faces as PNGs: the decode rate of each format
            png_folder, png_want = _real_folder(tmp, png=True)
            decoder["png"] = phase_decoder(png_folder, png_want, jpeg_ok)
        path4 = phase_path4(torch, tmp, folder, path3["bundle_dir"],
                            cond["onehot"]["rates"])
        if jpeg_ok:
            path4["png_folder"] = phase_path4_png(
                torch, tmp, png_folder, path3["bundle_dir"], path4["rates"])
            path4["launches_per_run"]["png_folder"] = \
                path4["png_folder"]["b1_launches"]
        label_free = phase_path3_label_free(torch, tmp, folder)
        evaluation = phase_eval(torch, tmp, path3["bundle_dir"])
        serving = phase_serving(torch, tmp, folder, path3["bundle_dir"],
                                sampling["rate"])
        levers = phase_levers(torch, tmp)
        variants = phase_variants(torch, tmp, folder, path3["bundle_dir"],
                                  levers["plain_profile"])
        tools = phase_tools(torch, tmp)
        leftovers = phase_leftovers(torch, tmp, levers, variants, tools)
        dp = phase_data_parallel(torch, tmp, folder, path3["bundle_dir"])
        _f16_full(leftovers["f16"]["parity"])
        sharded = phase_sharded_state(torch, tmp)
        spatial = phase_spatial(torch, tmp)
        spatial_levers = phase_spatial_levers(
            torch, tmp, sharded["ranks"]["levers_prepare_s"])
        spatial_losses = phase_spatial_losses(
            torch, tmp, sharded["ranks"]["losses_prepare_s"])
    b1["band_form"] = spatial["b1_bands"]
    b1["launches_per_path"] = {
        "sampling": sampling["launches_per_run"],
        "training": path1["launches_per_run"], "bench_lowch": 0,
        "comparator": path3["launches_per_run"],
        "training_cond": cond["launches_per_run"],
        "real_images": path4["launches_per_run"],
        "label_free": label_free["launches_per_run"],
        "evaluation": evaluation["launches_per_run"],
        "serving": serving["launches_per_run"],
        "levers": levers["launches_per_run"],
        "g_variants": variants["launches_per_run"],
        "tools": tools["launches_per_run"],
        "leftovers": leftovers["launches_per_run"],
        "data_parallel": dp["launches_per_run"],
        "sharded_state": sharded["launches_per_run"],
        "spatial": spatial["launches_per_run"],
        "spatial_levers": spatial_levers["launches_per_run"],
        "spatial_losses": spatial_losses["launches_per_run"]}
    per_path = {p: sum(v.values()) if isinstance(v, dict) else v
                for p, v in b1["launches_per_path"].items()}
    b1["launches"] = sum(per_path.values())
    b2["launches_per_path"] = {"bench_lowch": path2["launches"],
                               "training": path1["b2_launches"],
                               "sampling": 0, "comparator": 0,
                               "training_cond": 0, "real_images": 0,
                               "label_free": 0, "evaluation": 0,
                               "serving": 0, "levers": 0, "g_variants": 0,
                               "tools": 0, "leftovers": 0,
                               "data_parallel": 0, "sharded_state": 0,
                               "spatial": 0, "spatial_levers": 0,
                               "spatial_losses": 0,
                               "tail_forms": variants["b2_tail_launches"]}
    b2["launches"] = (path2["launches"] + path1["b2_launches"]
                      + variants["b2_tail_launches"])
    check(b1["launches"] > 0 and b2["launches"] > 0
          and all(per_path[p] > 0 for p in per_path if p != "bench_lowch"),
          f"a kernel was never launched on its path: B1 {per_path}, "
          f"B2 {b2['launches']}")
    say(f"summary: {json.dumps({'build': build, 'sampling': sampling, 'parity': parity, 'path2': path2, 'path1': path1, 'train_parity': train_parity, 'path3': path3, 'path1_cond': cond, 'cond_parity': cond_parity, 'decoder': decoder, 'path4': path4, 'label_free': label_free, 'evaluation': evaluation, 'serving': serving, 'levers': levers, 'variants': variants, 'tools': tools, 'leftovers': leftovers, 'data_parallel': dp, 'sharded_state': sharded, 'spatial': spatial, 'spatial_levers': spatial_levers, 'spatial_losses': spatial_losses}, default=_jsonable)}")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    from pcgan_tpu_torch.ops import cuda_instance_norm
    # counted per run (zeroed before each) where each run checks its count;
    # the whole script's other paths launch it too, uncounted here
    norm["launches_per_path"] = {
        "sampling": sampling["norm_launches_per_run"],
        "training": path1["norm_launches_per_run"],
        "comparator": path3["norm_launches_per_run"]}
    norm["launches"] = sum(sum(v.values())
                           for v in norm["launches_per_path"].values())
    check(norm["launches"] > 0, "the fused instance norm never launched")
    print(json.dumps({"kernels": [b1, b2, norm]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        _dp_worker(sys.argv[2])         # phase 22's rank under torchrun
    elif sys.argv[1:2] == ["--auto-worker"]:
        _auto_worker(sys.argv[2])       # phase 23's ranks under torchrun
    elif sys.argv[1:2] == ["--spatial-worker"]:
        _spatial_worker(sys.argv[2])    # phase 24 (b)'s ranks, one card
    elif sys.argv[1:2] == ["--spatial-cards-worker"]:
        _spatial_cards_worker(sys.argv[2])   # --cards' spatial ranks
    elif sys.argv[1:2] == ["--f16-cpu"]:
        _f16_cpu_child(sys.argv[2])     # phase 21 (c)'s CPU reference
    elif sys.argv[1:2] == ["--cards"]:
        main_cards(int(sys.argv[2]))    # phase 22 (a) over N cards
    else:
        main()
