"""Break the end-to-end (real-JPEG) train rate into host-path stages
(counterpart of ``tools/profile_e2e.py``).

    python -m pcgan_tpu_torch.tools.profile_e2e [--size 128] [--batch 64]
        [--steps 20] [--n_images 512] [--host_decode_m 8] [--smoke]
        [--device cpu]

Each stage of the bench's ``--e2e`` path is timed alone, then the
overlapped loop, so the gap between the headline and ``--e2e`` is
attributed with numbers:

  1. decode      ``UTKFaceDataset.get_raw_batch`` (the native libjpeg pool)
  2. with_bins   the host's age binning
  3. upload      ``.to(device, non_blocking=True)`` of the loader's arrays,
                 synced on the card
  4. dispatch    the host's enqueue rate of B1 + the step on a resident
                 batch (not synced per call)
  5. step        the device-bound rate (the bench's headline)
  6. e2e loop    the prefetch thread, upload, B1 and the step overlapped
                 (what ``bench --e2e`` reports)

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

import numpy as np


def _ms(t0: float, n: int) -> float:
    return round((time.perf_counter() - t0) / n * 1e3, 3)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--batch", type=int, default=None,
                   help="default 64 (--smoke: the bench's smoke batch)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--n_images", type=int, default=512)
    p.add_argument("--host_decode_m", type=int, default=8)
    p.add_argument("--smoke", action="store_true", help="tiny config")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import torch
    from pcgan_tpu_torch.bench import (_device, bench_config, host_batches,
                                       train_step_fn, upload, write_jpegs)
    from pcgan_tpu_torch.data.loader import Loader, with_bins
    from pcgan_tpu_torch.data.utkface import UTKFaceDataset

    cfg = bench_config(args.size, args.batch or (0 if args.smoke else 64),
                       smoke=args.smoke,
                       host_decode_m=args.host_decode_m, device=args.device)
    device = _device(cfg)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    B, nt, steps = cfg.data.batch_size, cfg.data.num_threads, args.steps
    if args.n_images < 2 * B:
        raise SystemExit(f"--n_images {args.n_images} < two batches of {B}")
    tmpdir = tempfile.mkdtemp(prefix="prof_e2e_")
    report = {}
    it = None
    try:
        write_jpegs(tmpdir, args.n_images)
        ds = UTKFaceDataset(tmpdir, decode_m=cfg.data.host_decode_m)
        ld = Loader(ds, B, shuffle=True, num_threads=nt)

        # 1. decode only
        idx = np.arange(B)
        ds.get_raw_batch(idx, num_threads=nt)                      # warm
        t0 = time.perf_counter()
        for k in range(steps):
            off = (k * B) % (args.n_images - B)
            ds.get_raw_batch(np.arange(off, off + B), num_threads=nt)
        report["decode_ms_per_batch"] = _ms(t0, steps)

        # 2. with_bins
        raw = ds.get_raw_batch(idx, num_threads=nt)
        t0 = time.perf_counter()
        for _ in range(steps):
            next(with_bins(iter([raw]), cfg.data.n_age_bins,
                           cfg.data.max_age))
        report["with_bins_ms"] = _ms(t0, steps)

        # 3. upload
        batch = next(with_bins(iter([raw]), cfg.data.n_age_bins,
                               cfg.data.max_age))
        upload(batch, device)                                      # warm
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            dev_batch = upload(batch, device)
        sync()
        report["upload_ms"] = _ms(t0, steps)
        report["batch_mb"] = round(
            sum(v.nbytes for v in batch.values()) / 1e6, 2)

        # 4/5. dispatch + step on the resident batch
        _, run = train_step_fn(cfg, device)
        for _ in range(3):
            m = run(dev_batch)
        float(m["loss_G"])
        t0 = time.perf_counter()
        for _ in range(steps):
            m = run(dev_batch)
        report["dispatch_ms"] = _ms(t0, steps)
        float(m["loss_G"])
        t0 = time.perf_counter()
        for _ in range(steps):
            m = run(dev_batch)
        float(m["loss_G"])
        report["step_ms"] = _ms(t0, steps)
        report["step_imgs_s"] = round(B / report["step_ms"] * 1e3, 1)

        host = (report["decode_ms_per_batch"] + report["with_bins_ms"]
                + report["upload_ms"] + report["dispatch_ms"])
        report["host_path_ms"] = round(host, 3)
        report["bound"] = "host" if host > report["step_ms"] else "device"

        # 6. the overlapped loop (bench --e2e's shape)
        it = host_batches(cfg, ld)
        for _ in range(3):
            m = run(upload(next(it), device))
        float(m["loss_G"])
        t0 = time.perf_counter()
        for _ in range(steps):
            m = run(upload(next(it), device))
        float(m["loss_G"])
        report["e2e_ms"] = _ms(t0, steps)
        report["e2e_imgs_s"] = round(B / report["e2e_ms"] * 1e3, 1)
    finally:
        if it is not None:
            it.close()
        shutil.rmtree(tmpdir, ignore_errors=True)
    report["device"] = (torch.cuda.get_device_name(device) if cuda
                        else "cpu")
    print(json.dumps(report, indent=2), flush=True)
    return report


if __name__ == "__main__":
    main()
