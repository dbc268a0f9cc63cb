"""Benchmark of the port (counterpart of the root ``bench.py``).

    python -m pcgan_tpu_torch.bench [--smoke] [--steps N] [--batch N]
        [--size PX] [--e2e [--packed | --device_cache]] [--infer
        [--serving] [--quant_int8]] [--latency] [--device cpu]

Prints ONE JSON line under the JAX bench's metric names:

- the headline, ``train_imgs_per_sec_per_chip_{size}px``: the fused G/D
  step (``train.make_train_step``) at the JAX bench's config
  (resnet_9blocks, bf16, 128 px, batch 64, the pool on) with kernel B1
  preprocessing a native-size (B, 200, 200, 3) u8 batch already on the
  device inside the timed loop; with the ``e2e_imgs_s`` and
  ``e2e_cached_imgs_s`` riders (``--skip_e2e`` drops them);
- ``--e2e``: the same step fed by synthetic JPEGs on disk through the
  native libjpeg decoder, ``with_bins``, the prefetch thread and the
  upload (``_e2e``); ``--packed`` from a pack, ``--device_cache`` from the
  device-resident cache (``_e2e_packed``, ``_e2e_cached``);
- ``--infer``: G's forward at the training batch
  (``infer_imgs_per_sec_per_chip_{size}px``), ``--serving`` through the
  exported artifact (``serving.export_generator`` + ``load_exported``),
  ``--quant_int8`` after one calibration pass;
- ``--latency``: one-image sample latency, p50 and p99 of the wall time,
  and ``device_ms``, the device time of one forward mined from a
  ``torch.profiler`` trace (``tools/profile_step.py mine_trace``; null
  where the trace has no device lane).

Under ``torchrun --nproc_per_node N`` the headline and ``--e2e`` split
the global batch over the ranks (``parallel/train_parallel.py``; the e2e
loader shards every epoch, ``--device_cache_sharded`` splits the cache's
rows), ``train_imgs_per_sec_per_chip_*`` divides the global rate by N, as
the root ``bench.py`` divides by its mesh's chips, and rank 0 prints the
line.

Every line names the device it ran on. ``vs_baseline`` divides by
``benchmarks/baseline_torch.json``'s rate only when that file's ``device``
is the kind of device this run used, else it is null. The device is
``--device`` (cuda unless cpu is asked for); ``--smoke`` picks only the
tiny config. A failing rider raises: nothing is swallowed.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from pcgan_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                    RunConfig, TrainConfig)

NATIVE = 200                     # the synthetic canvases' side, as in JAX
BASELINE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "baseline_torch.json")


def bench_config(size: int = 128, batch: int = 0, smoke: bool = False,
                 host_decode_m: int = 8, host_resize: bool = False,
                 quant_int8: bool = False, device: str = "cuda") -> Config:
    """The JAX bench's configs (``bench.py:353-394``): ``--smoke``'s tiny
    f32 resnet_6blocks at 32 px (batch 4: one device), else resnet_9blocks
    in bf16 at ``size`` px, batch 64 (8 at 512 px), load 143/128 of the
    size, 10 bins, the pool rounded up to a multiple of the batch, remat
    only at >= 256 px with batch > 64."""
    run = RunConfig(device=device)
    if smoke:
        b = batch or 4
        return Config(
            data=DataConfig(batch_size=b, crop_size=32, load_size=36,
                            n_age_bins=4),
            model=ModelConfig(netG="resnet_6blocks", ngf=8, ndf=8,
                              dtype="float32", quant_int8=quant_int8),
            train=TrainConfig(pool_size=8), run=run)
    b = batch or (8 if size >= 512 else 64)
    return Config(
        data=DataConfig(batch_size=b, crop_size=size,
                        load_size=int(size * 143 / 128), n_age_bins=10,
                        host_decode_m=host_decode_m, host_resize=host_resize),
        model=ModelConfig(netG="resnet_9blocks", dtype="bfloat16",
                          remat=(size >= 256 and b > 64),
                          quant_int8=quant_int8),
        train=TrainConfig(pool_size=((50 + b - 1) // b) * b), run=run)


def _device(cfg: Config) -> torch.device:
    from pcgan_tpu_torch.device import resolve_device
    return resolve_device(cfg.run.device)


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def train_step_fn(cfg: Config, device: torch.device, mesh=None):
    """(state, run): the seeded G, D and train state on ``device`` and
    ``run(raw) -> metrics``, one B1 preprocessing of ``raw`` ({'image':
    (b, N, N, 3) u8, 'bin': (b,)} on the device) and one fused step,
    data-parallel over ``mesh`` (``raw`` is then the rank's rows)."""
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.parallel.mesh import rank_seed
    from pcgan_tpu_torch.parallel.train_parallel import (
        make_parallel_train_step, pool_for_mesh, shard_train_state)
    from pcgan_tpu_torch.train import create_train_state
    cfg = pool_for_mesh(cfg, mesh)
    G = define_G(cfg, torch.Generator().manual_seed(0)).to(device)
    D = define_D(cfg, torch.Generator().manual_seed(1)).to(device)
    rank = 0 if mesh is None else mesh.rank
    state = shard_train_state(create_train_state(
        cfg, G, D, torch.Generator().manual_seed(rank_seed(2, rank)), 1000),
        mesh)
    step = make_parallel_train_step(cfg, G, D, mesh=mesh)

    def run(raw):
        return step(state, raw)

    return state, run


def raw_batch(cfg: Config, device: torch.device, seed: int = 0,
              mesh=None) -> dict:
    """A seeded native-size u8 global batch and its bins (the rank's rows
    of it under ``mesh``), resident on ``device``."""
    rng = np.random.default_rng(seed)
    b = cfg.data.batch_size
    raw = {"image": rng.integers(0, 256, (b, NATIVE, NATIVE, 3),
                                 dtype=np.uint8),
           "bin": rng.integers(0, cfg.data.n_age_bins, b)}
    if mesh is not None:
        raw = mesh.local_rows(raw)
    return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}


def _sync(metrics) -> float:
    # reading a loss back waits for the step that made it
    return float(metrics["loss_G"])


def _timed_steps(run, batches, steps: int, warmup: int) -> float:
    """Seconds of ``steps`` calls of ``run(next(batches))`` after
    ``warmup`` ones, synced by reading the last step's loss."""
    for _ in range(warmup):
        m = run(next(batches))
    _sync(m)
    t0 = time.perf_counter()
    for _ in range(steps):
        m = run(next(batches))
    _sync(m)
    return time.perf_counter() - t0


def _world(mesh) -> int:
    return 1 if mesh is None else mesh.world


def measure(cfg: Config, steps: int, warmup: int = 3, mesh=None) -> float:
    """The headline: images/s per device of B1 + the fused step on a
    resident batch (over ``mesh``: the global rate over its ranks)."""
    device = _device(cfg) if mesh is None else mesh.device
    _, run = train_step_fn(cfg, device, mesh)
    dt = _timed_steps(run, itertools.repeat(raw_batch(cfg, device,
                                                      mesh=mesh)),
                      steps, warmup)
    return cfg.data.batch_size * steps / dt / _world(mesh)


def write_jpegs(folder: str, n_images: int, seed: int = 0) -> None:
    """``n_images`` seeded noise JPEGs of 200 px under UTKFace-style
    ``{age}_0_0_{i}.jpg`` names."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for i in range(n_images):
        arr = rng.integers(0, 256, (NATIVE, NATIVE, 3), dtype=np.uint8)
        Image.fromarray(arr).save(
            os.path.join(folder, f"{int(rng.integers(1, 90))}_0_0_{i}.jpg"),
            quality=90)


def upload(raw: dict, device: torch.device) -> dict:
    """A host batch's arrays on ``device`` (``non_blocking`` copies)."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in raw.items()}


def host_batches(cfg: Config, ld):
    """The loader's batches with their bins, epoch after epoch, made on the
    prefetch thread (the training loop's host path)."""
    from pcgan_tpu_torch.data.loader import prefetch, with_bins

    def epochs():
        while True:
            yield from with_bins(iter(ld), cfg.data.n_age_bins,
                                 cfg.data.max_age)

    return prefetch(epochs(), cfg.data.prefetch)


def measure_e2e(cfg: Config, steps: int, warmup: int = 3,
                n_images: int = 512, packed: bool = False,
                device_cache: bool = False,
                cache_sharded: bool = False, mesh=None) -> float:
    """The headline step fed from disk: synthetic JPEGs -> the native
    decoder (or a pack, or the device cache, whole or sharded over the
    ranks) -> with_bins -> upload -> B1 -> step. Building the pack or the
    cache is outside the timed loop. Over ``mesh`` every rank writes its
    own copy of the files and loads its shard of every epoch."""
    from pcgan_tpu_torch.data.loader import make_process_loader
    from pcgan_tpu_torch.data.utkface import UTKFaceDataset
    device = _device(cfg) if mesh is None else mesh.device
    tmpdir = tempfile.mkdtemp(prefix="bench_e2e_")
    it = None
    try:
        write_jpegs(tmpdir, n_images)
        _, run = train_step_fn(cfg, device, mesh)
        ds = UTKFaceDataset(tmpdir, decode_m=cfg.data.host_decode_m)
        if packed:
            from pcgan_tpu_torch.data.packed import PackedDataset, write_pack
            pack_dir = os.path.join(tmpdir, "pack")
            write_pack(ds, pack_dir, num_threads=cfg.data.num_threads)
            ds = PackedDataset(pack_dir)
        if device_cache or cache_sharded:
            from pcgan_tpu_torch.data.device_cache import DeviceCacheLoader
            dc = DeviceCacheLoader(cfg, ds, device, shuffle=True, seed=0,
                                   mesh=mesh, sharded=cache_sharded)

            def cached():
                while True:
                    yield from iter(dc)

            batches = cached()
        else:
            ld = make_process_loader(cfg, ds, shuffle=True, mesh=mesh)
            it = host_batches(cfg, ld)
            batches = (upload(raw, device) for raw in it)
        dt = _timed_steps(run, batches, steps, warmup)
        return cfg.data.batch_size * steps / dt / _world(mesh)
    finally:
        if it is not None:
            it.close()
        shutil.rmtree(tmpdir, ignore_errors=True)


def infer_inputs(cfg: Config, device: torch.device, bs: int, seed: int = 0):
    """(x, cond) for G at batch ``bs`` in the compute dtype: seeded normal
    images and one-hot (or, in score mode, uniform [-1, 1]) conditions."""
    from pcgan_tpu_torch.models.registry import compute_dtype
    dt = compute_dtype(cfg.model.dtype)
    s = cfg.data.crop_size
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (bs, s, s, cfg.data.input_nc)).astype(np.float32))
    if cfg.cond_nc == cfg.data.n_age_bins:
        cond = torch.from_numpy(np.eye(cfg.data.n_age_bins, dtype=np.float32)[
            rng.integers(0, cfg.data.n_age_bins, bs)])
    else:
        cond = torch.from_numpy(rng.uniform(
            -1, 1, (bs, cfg.cond_nc)).astype(np.float32))
    return x.to(device, dt), cond.to(device, dt)


def seeded_G(cfg: Config, device: torch.device):
    from pcgan_tpu_torch.models import define_G
    return define_G(cfg, torch.Generator().manual_seed(0)).to(device).eval()


def _timed_calls(fn, args, steps: int, warmup: int) -> float:
    with torch.inference_mode():
        for _ in range(warmup):
            y = fn(*args)
        float(y[0, 0, 0, 0])
        t0 = time.perf_counter()
        for _ in range(steps):
            y = fn(*args)
        float(y[0, 0, 0, 0])
    return time.perf_counter() - t0


def measure_infer(cfg: Config, steps: int, warmup: int = 3,
                  serving: bool = False) -> float:
    """Images/s of G's forward at the training batch on resident inputs;
    under ``--quant_int8`` after one calibration pass (static activation
    scales, the production path). ``serving`` times the exported artifact's
    program on f32 inputs instead (export and load untimed)."""
    from pcgan_tpu_torch.ops.quant import calibrate_quant
    device = _device(cfg)
    bs = cfg.data.batch_size
    G = seeded_G(cfg, device)
    x, cond = infer_inputs(cfg, device, bs)
    if cfg.model.quant_int8:
        calibrate_quant(G, [(x, cond)])
    if not serving:
        return bs * steps / _timed_calls(G, (x, cond), steps, warmup)
    from pcgan_tpu_torch.serving import export_generator, load_exported
    tmpdir = tempfile.mkdtemp(prefix="pcgan_serving_bench_")
    try:
        t0 = time.perf_counter()
        export_generator(cfg, G, tmpdir, platforms=(device.type,))
        served = load_exported(tmpdir, device=device.type)
        print(f"# export+load: {time.perf_counter() - t0:.1f}s", flush=True)
        program = served._program.module
        args = (x.float(), cond.float())
        return bs * steps / _timed_calls(program, args, steps, warmup)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def measure_latency(cfg: Config, n: int = 50, traced: int = 20):
    """One-image sample latency: (p50 ms, p99 ms, device_ms). The wall
    times are what a caller sees, synced by reading an output pixel;
    ``device_ms`` is the device time of one forward, mined from a trace of
    ``traced`` forwards, or None where the trace has no device lane."""
    from pcgan_tpu_torch.tools.profile_step import mine_trace
    from pcgan_tpu_torch.utils.profiling import trace
    device = _device(cfg)
    G = seeded_G(cfg, device)
    x, cond = infer_inputs(cfg, device, 1)
    times = []
    with torch.inference_mode():
        float(G(x, cond)[0, 0, 0, 0])
        for _ in range(n):
            t0 = time.perf_counter()
            float(G(x, cond)[0, 0, 0, 0])
            times.append(time.perf_counter() - t0)
        trace_dir = tempfile.mkdtemp(prefix="pcgan_lat_trace_")
        try:
            with trace(trace_dir, device):
                for _ in range(traced):
                    float(G(x, cond)[0, 0, 0, 0])
            rep = mine_trace(trace_dir)
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
    device_ms = (rep["total_device_us"] / traced / 1e3
                 if rep["total_device_us"] > 0 else None)
    return (float(np.percentile(times, 50)) * 1e3,
            float(np.percentile(times, 99)) * 1e3,
            None if device_ms is None else round(device_ms, 3))


def vs_baseline(value: float, cfg: Config, device: torch.device):
    """value over ``benchmarks/baseline_torch.json``'s 128 px rate when
    that file measured the same kind of device, else None."""
    if cfg.data.crop_size != 128 or not os.path.exists(BASELINE):
        return None
    with open(BASELINE) as f:
        base = json.load(f)
    ref = base.get("imgs_per_sec_per_chip_128px")
    if not ref or base.get("device") != device.type:
        return None
    return round(value / ref, 2)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--smoke", action="store_true", help="tiny config")
    p.add_argument("--latency", action="store_true",
                   help="measure p50/p99 single-image sample latency instead")
    p.add_argument("--infer", action="store_true",
                   help="measure batched G-only inference throughput")
    p.add_argument("--serving", action="store_true",
                   help="with --infer: time the exported serving artifact "
                        "instead of the live model")
    p.add_argument("--quant_int8", action="store_true",
                   help="with --infer: int8-PTQ the G trunk convs")
    p.add_argument("--e2e", action="store_true",
                   help="end-to-end rate incl. JPEG decode + host->device "
                        "upload (synthetic on-disk dataset)")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--host_decode_m", type=int, default=8,
                   help="e2e mode: libjpeg DCT-domain decode scale M/8")
    p.add_argument("--host_resize", action="store_true",
                   help="e2e mode: resize to load_size on the host")
    p.add_argument("--packed", action="store_true",
                   help="e2e mode: serve the dataset from a pack")
    p.add_argument("--device_cache", action="store_true",
                   help="e2e mode: dataset resident on the device")
    p.add_argument("--device_cache_sharded", action="store_true",
                   help="e2e mode: the cache's rows sharded over the ranks")
    p.add_argument("--skip_e2e", action="store_true",
                   help="omit the e2e riders from the default headline")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None) -> dict:
    """Runs the bench; prints its JSON line and returns it."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.serving and not args.infer:
        p.error("--serving modifies --infer; pass both")
    if args.quant_int8 and not args.infer:
        p.error("--quant_int8 is inference-only here; pass --infer")
    if args.packed and not args.e2e:
        p.error("--packed modifies --e2e; pass both")
    if (args.device_cache or args.device_cache_sharded) and not args.e2e:
        p.error("--device_cache modifies --e2e here; pass both")
    if (args.device_cache or args.device_cache_sharded) and args.packed:
        p.error("--device_cache and --packed are alternative input paths")
    cfg = bench_config(args.size, args.batch or 0, args.smoke,
                       args.host_decode_m, args.host_resize, args.quant_int8,
                       args.device)
    from pcgan_tpu_torch.parallel.mesh import init_distributed
    mesh = init_distributed(args.device)
    try:
        line = _bench(args, cfg, mesh)
    finally:
        mesh.close()
    if mesh.rank == 0:
        print(json.dumps(line), flush=True)
    return line


def _bench(args, cfg: Config, mesh) -> dict:
    steps = args.steps or (5 if args.smoke else 30)
    device = mesh.device
    name = device_name(device)
    s = cfg.data.crop_size
    # the one-process path keeps mesh None: no collective at all
    dp = mesh if mesh.group is not None else None

    if args.latency:
        p50, p99, device_ms = measure_latency(cfg)
        line = {"metric": f"sample_latency_p50_{s}px", "value": round(p50, 3),
                "unit": "ms", "vs_baseline": None, "p99_ms": round(p99, 3),
                "device_ms": device_ms, "device": name}
    elif args.infer:
        value = measure_infer(cfg, max(steps, 20), serving=args.serving)
        tag = ("_serving" if args.serving else "") + (
            "_int8" if args.quant_int8 else "")
        line = {"metric": f"infer_imgs_per_sec_per_chip_{s}px{tag}",
                "value": round(value, 2), "unit": "imgs/s/chip",
                "vs_baseline": None, "batch": cfg.data.batch_size,
                "device": name}
    else:
        if args.e2e:
            value = measure_e2e(cfg, steps, packed=args.packed,
                                device_cache=args.device_cache,
                                cache_sharded=args.device_cache_sharded,
                                mesh=dp)
        else:
            value = measure(cfg, steps, mesh=dp)
        suffix = ("_e2e_cached_sharded"
                  if args.e2e and args.device_cache_sharded
                  else "_e2e_cached" if args.e2e and args.device_cache
                  else "_e2e_packed" if args.e2e and args.packed
                  else "_e2e" if args.e2e else "")
        line = {"metric": f"train_imgs_per_sec_per_chip_{s}px{suffix}",
                "value": round(value, 2), "unit": "imgs/s/chip",
                "vs_baseline": vs_baseline(value, cfg, device),
                "device": name}
        if not args.e2e and not args.smoke and not args.skip_e2e:
            # the riders: the same step fed from disk, then from the
            # device cache; a rider that fails raises
            rider_steps = max(10, steps // 2)
            line["e2e_imgs_s"] = round(measure_e2e(cfg, rider_steps,
                                                   mesh=dp), 2)
            flags = []
            if args.host_decode_m < 8:
                flags.append(f"host_decode_m={args.host_decode_m} "
                             f"(NON-parity DCT fast decode)")
            if args.host_resize:
                flags.append("host_resize (parity math, non-default route)")
            line["e2e_note"] = "; ".join(flags) or "parity input path"
            line["e2e_cached_imgs_s"] = round(measure_e2e(
                cfg, rider_steps, device_cache=True,
                cache_sharded=dp is not None, mesh=dp), 2)
        if dp is not None:
            line["ranks"] = dp.world
    return line


if __name__ == "__main__":
    main()
