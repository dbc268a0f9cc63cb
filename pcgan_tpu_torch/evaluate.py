"""Evaluation entry point of the port (counterpart of the root ``evaluate.py``).

    python -m pcgan_tpu_torch.evaluate --name utk128 --dataroot ... \\
        --num_test 500 [--comparator_path ...] [--device cpu]

One pass over the eval set (``eval_lib.make_fid_evaluator``) gives the FID
between real and generated images (targets are the permuted real bins),
and, from the same pass, ``--kid``, ``--fid_per_bin``, ``--prdc``,
``--is_score``, ``--ssim``, ``--lpips`` and, with a comparator, the
condition accuracy. ``--fid_stats <file.npz>`` (from
``tools/compute_fid_stats`` of either framework) measures ``fid`` against
frozen real statistics and keeps the streamed number as ``fid_stream``.
``--holdout_frac`` reproduces the training run's seeded split, checked
against the split record in its ``opt.json``, and adds ``holdout_*`` keys
for the rows training never saw. Prints one JSON line and appends it to
``{results_dir}/{name}/eval.jsonl``. Runs on cuda unless ``--device cpu``,
on one device.
"""

from __future__ import annotations

import dataclasses
import json
import os


def _holdout_dataset_cfg(cfg):
    """(dataset cfg, split record or None) for ``--holdout_frac``: the
    training run's frac and seed must match (a missing seed in its
    ``opt.json`` cannot be verified and warns), and a folder run reads the
    training phase's root."""
    from pcgan_tpu_torch.config import load_run_opt, opt_value
    from pcgan_tpu_torch.data import loader as data_loader
    opt = load_run_opt(cfg.run.checkpoints_dir, cfg.run.name)
    if opt is None:
        print("WARNING: no readable opt.json for this run: cannot verify the "
              "held-out split matches training; holdout_* keys are only "
              "meaningful if --dataroot/--phase/--holdout_frac/--seed "
              "exactly match the training run", flush=True)
        return cfg, None
    tf = opt_value(opt, "data", "holdout_frac", 0.0)
    tseed = opt_value(opt, "train", "seed", None)
    if tseed is None:
        print("WARNING: the run's opt.json records no train.seed: cannot "
              "verify that --seed matches the training split", flush=True)
    if tf != cfg.data.holdout_frac or (tseed is not None
                                       and tseed != cfg.train.seed):
        raise SystemExit(
            f"--holdout_frac: this run trained with holdout_frac={tf} "
            f"seed={tseed} but eval got --holdout_frac "
            f"{cfg.data.holdout_frac} --seed {cfg.train.seed}: a different "
            f"frac or seed derives a DIFFERENT permutation, so holdout_* keys "
            f"would silently mix trained-on rows. Pass the training values "
            f"(or drop --holdout_frac for a plain eval)")
    split = opt.get("split")
    if not isinstance(split, dict):
        print("WARNING: opt.json has no split record (run predates it): "
              "cannot verify the held-out split matches training; ensure "
              "--dataroot/--phase resolve the same rows", flush=True)
        return cfg, None
    t_phase = split.get("phase")
    if (isinstance(t_phase, str) and t_phase
            and cfg.data.dataset_mode in ("aging", "single")):
        t_root = data_loader.phase_root(cfg.data.dataroot, t_phase)
        e_root = data_loader.phase_root(cfg.data.dataroot, cfg.run.phase)
        if t_root != e_root:
            print(f"holdout: reproducing the TRAINING split: reading "
                  f"{t_root} (the run trained with --phase {t_phase}), not "
                  f"{e_root}", flush=True)
            cfg = dataclasses.replace(
                cfg, run=dataclasses.replace(cfg.run, phase=t_phase))
    return cfg, split


def main(argv=None) -> dict:
    """Runs the CLI; returns the record it prints."""
    from pcgan_tpu_torch.config import parse_config
    # structural flags default from the run's opt.json, as in evaluate.py
    cfg = parse_config(argv, is_train=False, opt_defaults="on")
    if cfg.data.device_cache or cfg.data.device_cache_sharded:
        print("note: --device_cache is a training-loop lever; evaluate "
              "streams from the host (flag ignored)", flush=True)
    from pcgan_tpu_torch.eval_lib import (check_eval_budget, check_one_device,
                                          make_fid_evaluator)
    check_one_device(cfg)
    check_eval_budget(cfg, cfg.run.num_test, "--num_test")

    from pcgan_tpu_torch.data import loader as data_loader
    from pcgan_tpu_torch.device import resolve_device
    from pcgan_tpu_torch.models import define_G
    from pcgan_tpu_torch.utils import checkpoint as ckpt

    device = resolve_device(cfg.run.device)
    if not ckpt.exists(cfg.run.checkpoints_dir, cfg.run.name, cfg.run.epoch,
                       use_ema=cfg.run.use_ema):
        raise SystemExit(
            f"checkpoint [{cfg.run.epoch}{'_G_ema' if cfg.run.use_ema else '_G'}"
            f"] not found under "
            f"{os.path.join(cfg.run.checkpoints_dir, cfg.run.name)}")
    G = ckpt.restore_generator(define_G(cfg), cfg.run.checkpoints_dir,
                               cfg.run.name, cfg.run.epoch,
                               use_ema=cfg.run.use_ema).to(device)
    bundle = (ckpt.load_comparator_bundle(cfg, device)
              if cfg.train.comparator_path else None)
    run = make_fid_evaluator(cfg, bundle, device)

    ds_cfg, split = (_holdout_dataset_cfg(cfg) if cfg.data.holdout_frac > 0
                     else (cfg, None))
    ds = data_loader.create_dataset(ds_cfg, train=False)
    if split is not None:
        tlen = split.get("dataset_len")
        if isinstance(tlen, int) and tlen != len(ds):
            raise SystemExit(
                f"--holdout_frac: the training run resolved a {tlen}-row "
                f"dataset (opt.json split record: phase "
                f"{split.get('phase')!r}, root {split.get('phase_root')!r}) "
                f"but eval resolved {len(ds)} rows: the held-out permutation "
                f"would NOT match the training split. Point --dataroot/"
                f"--max_dataset_size at the training run's data (or drop "
                f"--holdout_frac for a plain eval)")
    ds, ds_hold = data_loader.split_holdout(ds, cfg.data.holdout_frac,
                                            seed=cfg.train.seed)

    def loader(rows):
        return data_loader.Loader(rows, cfg.data.batch_size, shuffle=False,
                                  num_threads=cfg.data.num_threads,
                                  resize_to=data_loader.host_resize_size(cfg))

    def evaluate(rows):
        return run(G, data_loader.with_bins(iter(loader(rows)),
                                            cfg.data.n_age_bins,
                                            cfg.data.max_age),
                   max_images=cfg.run.num_test, seed=cfg.train.seed)

    rec = evaluate(ds)
    if ds_hold is not None:
        if len(loader(ds_hold)) == 0:
            raise SystemExit(
                f"--holdout_frac {cfg.data.holdout_frac} leaves fewer than "
                f"one batch ({len(ds_hold)} rows < --batch_size "
                f"{cfg.data.batch_size}) for held-out eval")
        rec_h = evaluate(ds_hold)
        rec.update({f"holdout_{k}": v for k, v in rec_h.items()})
    rec["epoch"] = cfg.run.epoch

    out_dir = os.path.join(cfg.run.results_dir, cfg.run.name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "eval.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
