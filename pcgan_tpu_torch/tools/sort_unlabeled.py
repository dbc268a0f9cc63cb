"""Sort unlabeled images into age-condition bins with a trained comparator
(counterpart of the root ``tools/sort_unlabeled.py``; the PC-GAN paper's
sorting step, where the comparator sorts an unlabeled pool into condition
bins)::

    python -m pcgan_tpu_torch.tools.sort_unlabeled --dataroot ./faces_unlabeled \\
        --comparator_path ./checkpoints/cmp_utk --n_age_bins 10 --out labels.csv

Scores every image with the frozen comparator (``comparator.pt``, f32, on
the card unless ``--device cpu``) after kernel B1's center crop, assigns
bins by the comparator's anchor intervals (``--by anchors``) or by score
quantiles (``--by quantiles``, equal occupancy), and writes the
``path,bin,score`` CSV that ``--dataset_mode sorted --labels_csv`` reads.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    """Runs the CLI; returns {'out', 'paths', 'bins', 'scores',
    'occupancy'}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataroot", required=True)
    p.add_argument("--comparator_path", required=True)
    p.add_argument("--out", default="labels.csv")
    p.add_argument("--n_age_bins", type=int, default=10)
    p.add_argument("--by", choices=["anchors", "quantiles"],
                   default="quantiles")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--load_size", type=int, default=143)
    p.add_argument("--crop_size", type=int, default=128)
    p.add_argument("--cmp_nf", type=int, default=64)
    p.add_argument("--cmp_n_down", type=int, default=4)
    p.add_argument("--num_threads", type=int, default=8)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from pcgan_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                        TrainConfig)
    from pcgan_tpu_torch.data.loader import Loader
    from pcgan_tpu_torch.data.utkface import UTKFaceDataset
    from pcgan_tpu_torch.device import resolve_device
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    from pcgan_tpu_torch.utils.checkpoint import load_comparator_bundle

    device = resolve_device(args.device)
    cfg = Config(
        data=DataConfig(dataroot=args.dataroot, load_size=args.load_size,
                        crop_size=args.crop_size,
                        n_age_bins=args.n_age_bins),
        model=ModelConfig(cmp_nf=args.cmp_nf, cmp_n_down=args.cmp_n_down,
                          dtype="float32"),
        train=TrainConfig(comparator_path=args.comparator_path))
    C, _lo, hi, _means = load_comparator_bundle(cfg, device)
    C.eval()

    ds = UTKFaceDataset(args.dataroot, require_age=False)
    ld = Loader(ds, args.batch_size, shuffle=False, drop_last=False,
                num_threads=args.num_threads)
    pre = make_preprocess(cfg, train=False)       # center crop, no flip
    scores = []
    with torch.no_grad():
        for raw in iter(ld):
            x = pre(None, {"image": torch.from_numpy(raw["image"]).to(
                device)})["image"]
            scores.append(C(x)[0].float().cpu().numpy())
    mu = np.concatenate(scores)[:len(ds)]          # f32, as the JAX tool's

    nb = args.n_age_bins
    if args.by == "anchors":
        edges = np.asarray(hi)[:-1]                  # nb-1 interior midpoints
        bins = np.searchsorted(edges, mu)
    else:
        qs = np.quantile(mu, np.linspace(0, 1, nb + 1)[1:-1])
        bins = np.searchsorted(qs, mu)
    bins = np.clip(bins, 0, nb - 1)

    with open(args.out, "w") as f:
        f.write("path,bin,score\n")
        for path, b, s in zip(ds.paths, bins, mu):
            f.write(f"{path},{int(b)},{float(s):.6f}\n")
    occ = np.bincount(bins, minlength=nb)
    print(f"wrote {len(ds)} rows to {args.out}; bin occupancy {occ.tolist()}",
          flush=True)
    return {"out": args.out, "paths": list(ds.paths), "bins": bins,
            "scores": mu, "occupancy": occ}


if __name__ == "__main__":
    main()
