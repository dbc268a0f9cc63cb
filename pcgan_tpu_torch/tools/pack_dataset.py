"""Pack a dataset into the pre-decoded mmap format (``--dataset_mode packed``;
counterpart of the root ``tools/pack_dataset.py``, the same flags).

Decodes every image once through the decode the live loader uses (the
native libjpeg batch decoder, full-scale DCT) and writes a pack directory
that epochs read with no decode work::

    python -m pcgan_tpu_torch.tools.pack_dataset --dataroot ./datasets/utkface --out ./packs/utk
    python -m pcgan_tpu_torch.tools.pack_dataset --dataroot ... --out ... --resize_to 143
    python -m pcgan_tpu_torch.tools.pack_dataset --source synthetic --max_dataset_size 256 --out ...

``--resize_to`` pre-applies the host resize (Pillow's bicubic, the filter
``--host_resize`` uses), shrinking the pack and the host-to-device copy;
train with ``--load_size`` at most that size. The pack's format is the JAX
package's: either package reads the other's packs.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> dict:
    """Runs the CLI; returns the pack's meta dict."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataroot", default="",
                    help="UTKFace-style image folder (age_*.jpg names)")
    ap.add_argument("--source", default="aging",
                    choices=["aging", "single", "synthetic"],
                    help="dataset to pack (aging/single need --dataroot)")
    ap.add_argument("--out", required=True, help="pack directory to create")
    ap.add_argument("--resize_to", type=int, default=0,
                    help="pre-resize rows to this size on the host (PIL "
                         "bicubic, the reference's own transform); 0 = keep "
                         "the native canvas")
    ap.add_argument("--resize_method", default="bicubic",
                    choices=["bicubic", "bilinear", "nearest"])
    ap.add_argument("--max_dataset_size", type=int, default=-1)
    ap.add_argument("--native_size", type=int, default=0,
                    help="host-decode canvas in px; 0 (default) auto-detects "
                         "from the first image (UTKFace 200, CACD 250: "
                         "uniform folders then pack with no host resample)")
    ap.add_argument("--num_threads", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0,
                    help="synthetic source seed")
    args = ap.parse_args(argv)

    from pcgan_tpu_torch.data.packed import write_pack
    if args.source == "synthetic":
        from pcgan_tpu_torch.data.synthetic import SyntheticAgingDataset
        n = args.max_dataset_size if args.max_dataset_size > 0 else 100
        ds = SyntheticAgingDataset(size=n, seed=args.seed)
    else:
        if not args.dataroot:
            ap.error("--dataroot is required for --source aging/single")
        from pcgan_tpu_torch.data.utkface import UTKFaceDataset
        # cap the probed canvas as the live loader does when a target size
        # exists; with no --resize_to the probe's result is announced below
        cap = max(200, 2 * args.resize_to) if args.resize_to > 0 else 0
        ds = UTKFaceDataset(args.dataroot, max_size=args.max_dataset_size,
                            native=args.native_size, native_cap=cap,
                            require_age=(args.source == "aging"))
        row = args.resize_to if args.resize_to > 0 else ds.out_size
        hint = ("" if args.resize_to > 0
                else " (pass --resize_to or --native_size to shrink)")
        print(f"decode canvas: {ds.out_size}px "
              f"({'probed' if args.native_size == 0 else 'pinned'}); "
              f"pack rows: {row}x{row}x3 u8{hint}", flush=True)

    t0 = time.time()
    meta = write_pack(ds, args.out, resize_to=args.resize_to,
                      resize_method=args.resize_method,
                      num_threads=args.num_threads,
                      source=args.dataroot or args.source, log_every=10)
    dt = time.time() - t0
    mb = meta["n"] * meta["size"] * meta["size"] * 3 / 1e6
    print(f"packed {meta['n']} rows @ {meta['size']}px -> {args.out} "
          f"({mb:.1f} MB) in {dt:.1f}s; train with "
          f"--dataset_mode packed --dataroot {args.out}", flush=True)
    return meta


if __name__ == "__main__":
    main()
