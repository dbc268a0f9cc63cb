"""Precompute real-side FID statistics (counterpart of the root
``tools/compute_fid_stats.py``; the pytorch-fid ``.npz`` workflow).

    python -m pcgan_tpu_torch.tools.compute_fid_stats --dataroot <imgs> \\
        --out stats.npz [--fid_features random|comparator|pth:<file>] \\
        [--crop_size 128] [--max_dataset_size N] [--device cpu]

One pass over every image of the dataset with the eval transform (kernel
B1's center crop, no flip; what ``evaluate`` feeds the feature net),
streaming ``ops/fid.FIDStats`` on the device, then ``save_stats`` with the
JAX tool's meta keys (``fid_features``, ``crop_size``, ``images``). Either
framework's ``--fid_stats`` reads the file: ``fid`` is then measured
against this frozen reference and ``fid_stream`` keeps the same-pass
number. Runs on cuda unless ``--device cpu``. Under ``torchrun
--nproc_per_node N`` rank r folds every N-th image from image r on, the
statistics are summed over the ranks and rank 0 alone writes the file.
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> dict:
    """Runs the CLI; returns the record it prints."""
    from pcgan_tpu_torch.config import build_parser, parse_config
    argv = list(sys.argv[1:] if argv is None else argv)
    p = build_parser(is_train=False)
    p.add_argument("--out", type=str, required=True,
                   help="output .npz statistics file")
    out_path = p.parse_args(argv).out
    for i, a in enumerate(argv):        # the config parser has no --out
        if a == "--out":
            argv = argv[:i] + argv[i + 2:]
            break
        if a.startswith("--out="):
            argv = argv[:i] + argv[i + 1:]
            break
    cfg = parse_config(argv, is_train=False)

    from pcgan_tpu_torch.parallel.mesh import mesh_from_config
    mesh = mesh_from_config(cfg)
    try:
        return _compute(cfg, mesh, out_path)
    finally:
        mesh.close()


def _compute(cfg, mesh, out_path: str) -> dict:
    import numpy as np
    import torch
    from pcgan_tpu_torch.data import loader as data_loader
    from pcgan_tpu_torch.eval_lib import make_feature_extractor
    from pcgan_tpu_torch.ops import fid as fid_ops
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    from pcgan_tpu_torch.utils import checkpoint as ckpt

    device = mesh.device
    bundle = (ckpt.load_comparator_bundle(cfg, device)
              if cfg.train.comparator_path else None)
    feature_fn, d = make_feature_extractor(cfg, bundle, device)
    pre = make_preprocess(cfg, train=False)
    ds = data_loader.create_dataset(cfg, train=False)
    if mesh.data_size > 1:
        # every data coordinate its share; a model line shares one
        ds = data_loader.SubsetDataset(ds, np.arange(
            mesh.data_rank, len(ds), mesh.data_size))
    ld = data_loader.Loader(ds, cfg.data.batch_size, shuffle=False,
                            drop_last=False, num_threads=cfg.data.num_threads,
                            resize_to=data_loader.host_resize_size(cfg))
    stats = fid_ops.init_stats(d, device)
    with torch.inference_mode():
        for raw in ld:
            img = pre(None, {"image": torch.from_numpy(raw["image"]).to(
                device)})["image"].float()
            stats = fid_ops.update_stats(stats, feature_fn(img))
    if mesh.data_group is not None:
        stats = fid_ops.reduce_stats(stats, mesh.data_group)
    stats = stats.to("cpu")
    n = int(stats.count)
    if n < 2:
        raise SystemExit(f"only {n} images under {cfg.data.dataroot}: need "
                         f">= 2 for a covariance")
    rec = {"out": out_path, "images": n, "feature_dim": d,
           "fid_features": cfg.run.fid_features,
           "crop_size": cfg.data.crop_size}
    if mesh.rank == 0:
        fid_ops.save_stats(out_path, stats, meta={
            "fid_features": cfg.run.fid_features,
            "crop_size": cfg.data.crop_size,
            "images": n,
        })
        print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
