"""Training entry point of the port (counterpart of the root ``train.py:23-553``).

    python -m pcgan_tpu_torch.train_main --dataset_mode synthetic \\
        --name run --checkpoints_dir ./checkpoints [--device cpu]

Per step: a host u8 batch (synthetic data, a UTKFace-style JPEG folder
decoded by the native libjpeg thread pool, a pack, or comparator-sorted
labels; made on a background thread, resized on the host under
``--host_resize``) goes to the device, kernel B1 random-crops, flips and
normalizes it, and the fused G/D step (``pcgan_tpu_torch/train.py``)
updates both nets.
The loop keeps the reference loop's surface: epochs, ``--print_freq``
console lines and ``metrics.jsonl`` rows (with ``imgs_per_sec`` and
``lr``), ``--display_freq`` preview grids, ``loss_curves.svg`` every epoch,
``latest`` / ``epoch_N`` checkpoints (``--save_latest_freq``,
``--save_epoch_freq``, ``--max_ckpt_keep``) and ``--continue_train`` with
exact resume: the loader replays the epoch's seeded permutation and skips
the batches the restored step already consumed. With ``--comparator_path``
(and ``--lambda_cond > 0`` or ``--cond_mode score``) the frozen comparator
and its score anchors join the step. ``--eval_fid_epoch_freq N`` scores G
(or, with ``--eval_use_ema``, its EMA twin) every N epochs through the
streaming FID evaluator (``eval_lib.py``) over ``--eval_fid_images`` rows
of the training data, writing ``eval_*`` rows to ``metrics.jsonl``;
``--holdout_frac`` holds a seeded share of the rows out of training and
adds ``eval_h_*`` rows for them.

``--model comparator`` pretrains the comparator instead (root
``train.py:654-827``): pairs drawn over the folder at ``--dataroot`` or
the synthetic set (every ``--dataset_mode`` but ``comparisons`` pretrains
on ``pairwise``, as the reference does), or the human pairs of
``--comparisons_csv``; B1 on both members of every pair, accuracy on a
held-out split each epoch, ``cmp_latest`` / ``cmp_epoch_N`` checkpoints
with exact resume, and at the end the bundle ``comparator.pt`` (C plus
per-bin score anchors: by age bins, or by score quantiles of the CSV's
images when no ages exist) a GAN run reads::

    python -m pcgan_tpu_torch.train_main --model comparator \
        --dataset_mode pairwise --name cmp
    python -m pcgan_tpu_torch.train_main --dataset_mode synthetic \
        --name gan --comparator_path ./checkpoints/cmp

Runs on cuda unless ``--device cpu``. Flags the port does not implement
raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def main(argv=None) -> dict:
    """Runs the CLI; returns {'run_dir', 'step', 'metrics' (the last logged
    losses), 'epochs': [{'epoch', 'steps', 'train_seconds'}], 'evals': the
    in-training FID records}, where ``train_seconds`` is an epoch's wall
    time from its first batch to its last step finished on the device
    (checkpoints, evals and plots excluded)."""
    from pcgan_tpu_torch.config import amend_run_opt, parse_config
    # under --continue_train, structural flags and the state-tree togglers
    # default from the run's own opt.json, as in train.py
    cfg = parse_config(argv, is_train=True, opt_defaults="resume")
    if cfg.model.quant_int8:
        # round() has zero gradient: a quantized trunk would train nothing
        raise SystemExit("--quant_int8 is an inference-only lever (test.py/"
                         "export_serving/bench --infer); training through "
                         "int8 quantization has zero gradients")
    from pcgan_tpu_torch.train import reject_unported_train
    reject_unported_train(cfg)

    from pcgan_tpu_torch.data import loader as data_loader
    from pcgan_tpu_torch.device import resolve_device
    from pcgan_tpu_torch.utils.metrics import MetricsLogger

    device = resolve_device(cfg.run.device)
    run_dir = os.path.join(cfg.run.checkpoints_dir, cfg.run.name)
    os.makedirs(run_dir, exist_ok=True)
    cfg.save(os.path.join(run_dir, "opt.json"))
    if cfg.model.model == "comparator":
        # pretraining builds its own pair loaders (with a held-out split)
        logger = MetricsLogger(run_dir)
        try:
            return _train_comparator(cfg, device, logger, run_dir)
        finally:
            logger.close()
    ds = data_loader.create_dataset(cfg, train=True)
    amend_run_opt(cfg.run.checkpoints_dir, cfg.run.name, "split", {
        "dataset_len": len(ds), "phase": cfg.run.phase,
        "phase_root": (
            data_loader.phase_root(cfg.data.dataroot, cfg.run.phase)
            if cfg.data.dataset_mode in ("aging", "single") else None),
        "holdout_frac": cfg.data.holdout_frac, "seed": cfg.train.seed})
    # the held-out rows are carved before any loader sees the dataset:
    # training and the train-side eval only touch the remainder
    ds, holdout_ds = data_loader.split_holdout(ds, cfg.data.holdout_frac,
                                               seed=cfg.train.seed)
    if holdout_ds is not None:
        print(f"holdout: {len(holdout_ds)} rows held out "
              f"({cfg.data.holdout_frac:.0%}), {len(ds)} train rows",
              flush=True)
    ld = data_loader.Loader(ds, cfg.data.batch_size,
                            shuffle=not cfg.data.serial_batches,
                            num_threads=cfg.data.num_threads,
                            seed=cfg.train.seed,
                            resize_to=data_loader.host_resize_size(cfg))
    steps_per_epoch = max(1, len(ld))
    print(f"device: {device}; dataset [{cfg.data.dataset_mode}] size "
          f"{len(ds)}, {steps_per_epoch} steps/epoch", flush=True)
    logger = MetricsLogger(run_dir)
    try:
        return _train_gan(cfg, device, ld, steps_per_epoch, logger, run_dir,
                          holdout_ds)
    finally:
        logger.close()


def _train_gan(cfg, device, ld, steps_per_epoch, logger, run_dir,
               holdout_ds=None) -> dict:
    import torch
    from pcgan_tpu_torch.data.loader import prefetch, with_bins
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    from pcgan_tpu_torch.train import (PlateauScheduler, create_train_state,
                                       make_train_step)
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    from pcgan_tpu_torch.utils.loss_plot import write_loss_plot
    from pcgan_tpu_torch.utils.metrics import StepTimer

    t = cfg.train
    seed = t.seed
    G = define_G(cfg, torch.Generator().manual_seed(seed)).to(device)
    D = define_D(cfg, torch.Generator().manual_seed(seed + 1)).to(device)
    C = bin_anchors = None
    # score mode consumes the comparator even at lambda_cond 0: real images
    # are conditioned on their own comparator score
    if t.comparator_path and (t.lambda_cond > 0
                              or cfg.model.cond_mode == "score"):
        C, *bin_anchors = ckpt.load_comparator_bundle(cfg, device)
        print(f"loaded frozen comparator from {t.comparator_path}",
              flush=True)
    state = create_train_state(cfg, G, D,
                               torch.Generator().manual_seed(seed + 2),
                               steps_per_epoch, C=C, bin_anchors=bin_anchors)
    print("---------- Networks initialized -------------", flush=True)
    nets = [("G", G), ("D", D)]
    if C is not None:
        nets.append(("C (frozen)", C))
    for name, net in nets:
        if cfg.run.verbose:
            print(net, flush=True)
        n = sum(p.numel() for p in net.parameters())
        print(f"[Network {name}] Total number of parameters : "
              f"{n / 1e6:.3f} M", flush=True)
    print("-----------------------------------------------", flush=True)

    epochs_done = resume_skip = 0
    resume_losses = []
    if t.continue_train and ckpt.state_exists(cfg.run.checkpoints_dir,
                                              cfg.run.name, cfg.run.epoch):
        ckpt.restore_state(state, cfg.run.checkpoints_dir, cfg.run.name,
                           cfg.run.epoch)
        # exact resume: the data cursor follows from the restored step
        epochs_done = state.step // steps_per_epoch
        resume_skip = state.step % steps_per_epoch
        ld.epoch = epochs_done
        print(f"resumed from step {state.step} (epoch "
              f"{t.epoch_count + epochs_done}"
              + (f", skipping {resume_skip} consumed batches"
                 if resume_skip else "") + ")", flush=True)
        if resume_skip:
            resume_losses = _read_host_sidecar(run_dir, state.step)

    step_fn = make_train_step(cfg, G, D, state.C)
    pre = make_preprocess(cfg, train=True)
    timer = StepTimer()
    total_epochs = t.niter + t.niter_decay
    plateau = None
    if t.lr_policy == "plateau":
        plateau = PlateauScheduler()
        plateau.scale = state.lr_scale
        plateau.best = state.plateau_best
        plateau.bad_epochs = int(state.plateau_bad)

    def save_g(tag):
        ckpt.save_generator(G, cfg.run.checkpoints_dir, cfg.run.name, tag)
        if state.ema is not None:
            ckpt.save_generator(state.ema, cfg.run.checkpoints_dir,
                                cfg.run.name, tag, use_ema=True)

    def save(tag):
        ckpt.save_state(state, cfg.run.checkpoints_dir, cfg.run.name, tag)
        save_g(tag)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    display = _make_display(cfg, G, run_dir, device)
    fid_eval = (_make_fid_eval(cfg, device, G, state, bin_anchors, ld,
                               holdout_ds, logger)
                if t.eval_fid_epoch_freq > 0 else None)
    last_latest_save = 0
    gstep = state.step
    epochs, evals, last_metrics = [], [], {}
    for epoch in range(t.epoch_count + epochs_done, total_epochs + 1):
        epoch_t0 = time.time()
        epoch_losses, resume_losses = resume_losses, []
        metrics = None
        timer.start()
        ld.skip_next, resume_skip = resume_skip, 0
        steps = 0
        t_first = None
        for raw in prefetch(with_bins(iter(ld), cfg.data.n_age_bins,
                                      cfg.data.max_age), cfg.data.prefetch):
            if t_first is None:
                t_first = time.perf_counter()
            images = torch.from_numpy(raw["image"]).to(device)
            batch = pre(state.generator, {"image": images})
            batch["bin"] = torch.from_numpy(raw["bin"]).to(device)
            metrics = step_fn(state, batch)
            gstep += 1
            steps += 1
            timer.tick(cfg.data.batch_size)
            if gstep % t.display_freq == 0:
                display(state, raw, epoch)
            if gstep % t.print_freq == 0:
                # one device->host copy for all losses; it also syncs
                host = dict(zip(metrics, torch.stack(
                    list(metrics.values())).cpu().tolist()))
                epoch_losses.append(host["loss_G"])
                last_metrics = host
                logger.log(gstep, host, epoch=epoch,
                           imgs_per_sec=timer.rate(),
                           lr=state.sched_g(gstep) * state.lr_scale)
                timer.start()
            if t.save_latest_freq > 0 and gstep % t.save_latest_freq == 0:
                last_latest_save = gstep
                save("latest")
                _write_host_sidecar(run_dir, gstep, epoch_losses)
        sync()
        if steps:
            epochs.append({"epoch": epoch, "steps": steps,
                           "train_seconds": time.perf_counter() - t_first})
        if plateau is not None and metrics is not None:
            metric = (float(np.mean(epoch_losses)) if epoch_losses
                      else float(metrics["loss_G"]))
            new_scale = plateau.update(metric)
            if new_scale != state.lr_scale:
                state.lr_scale = new_scale
                print(f"plateau: loss_G stalled at {metric:.4f}, lr scale -> "
                      f"{new_scale:g}", flush=True)
            state.plateau_best = plateau.best
            state.plateau_bad = float(plateau.bad_epochs)
        # 'latest' at every epoch end unless a numbered save below writes it
        # or the mid-epoch cadence just did
        if (t.save_latest_freq == 0
                and (t.save_epoch_freq <= 0
                     or epoch % t.save_epoch_freq != 0)) or (
                t.save_latest_freq > 0
                and gstep // t.save_latest_freq
                > last_latest_save // t.save_latest_freq):
            last_latest_save = gstep
            save("latest")
        if t.save_epoch_freq > 0 and epoch % t.save_epoch_freq == 0:
            save(f"epoch_{epoch}")
            save("latest")
            removed = ckpt.prune_epochs(cfg.run.checkpoints_dir, cfg.run.name,
                                        t.max_ckpt_keep)
            if removed:
                print(f"pruned old checkpoints: {removed}", flush=True)
        if fid_eval is not None and epoch % t.eval_fid_epoch_freq == 0:
            evals.append(fid_eval(epoch))
        write_loss_plot(run_dir)
        print(f"End of epoch {epoch}/{total_epochs} \t "
              f"({time.time() - epoch_t0:.1f}s)", flush=True)
    save("latest")
    return {"run_dir": run_dir, "step": state.step, "metrics": last_metrics,
            "epochs": epochs, "evals": evals}


def _make_fid_eval(cfg, device, G, state, bin_anchors, ld, holdout_ds,
                   logger):
    """In-training FID (root ``train.py:298-372``): the startup guards, the
    evaluator over the train split's rows in loader order, and over the
    held-out rows when ``--holdout_frac`` is set. Returns f(epoch) -> {'epoch',
    'seconds', 'eval_fid', ...}, which also logs the ``eval_*`` and
    ``eval_h_*`` row."""
    import copy
    import torch
    from pcgan_tpu_torch.data import loader as data_loader
    from pcgan_tpu_torch.eval_lib import check_eval_budget, make_fid_evaluator
    t, d = cfg.train, cfg.data
    # fail at startup, not hours in at the first epoch-end eval
    check_eval_budget(cfg, t.eval_fid_images, "--eval_fid_images")
    if t.eval_use_ema and state.ema is None:
        raise SystemExit("--eval_use_ema needs --ema_decay > 0 (there is no "
                         "EMA twin to evaluate)")
    bundle = (state.C, *bin_anchors) if state.C is not None else None
    run_fid = make_fid_evaluator(cfg, bundle, device)

    def loader(rows):
        return data_loader.Loader(rows, d.batch_size, shuffle=False,
                                  num_threads=d.num_threads,
                                  resize_to=data_loader.host_resize_size(cfg))

    sources = [("eval_", loader(ld.ds))]
    if holdout_ds is not None:
        h_ld = loader(holdout_ds)
        if len(h_ld) == 0:
            raise SystemExit(
                f"--holdout_frac {d.holdout_frac} leaves fewer than one batch "
                f"({len(holdout_ds)} rows < --batch_size {d.batch_size}) for "
                f"eval")
        sources.append(("eval_h_", h_ld))
    # --eval_use_ema scores the EMA twin (what ships): a copy of G whose
    # parameters take the EMA values before each eval
    twin = copy.deepcopy(G) if t.eval_use_ema else None

    def fid_eval(epoch: int) -> dict:
        net = G
        if twin is not None:
            with torch.no_grad():
                for n, p in twin.named_parameters():
                    p.copy_(state.ema[n])
            net = twin
        t0 = time.perf_counter()
        out = {}
        for prefix, eval_ld in sources:
            rec = run_fid(net, data_loader.with_bins(
                iter(eval_ld), d.n_age_bins, d.max_age),
                max_images=t.eval_fid_images, seed=t.seed)
            out.update({prefix + k: float(v) for k, v in rec.items()})
        logger.log(state.step, out, epoch=epoch)
        print(f"eval (epoch {epoch}): " + ", ".join(
            f"{k} {v:.4g}" for k, v in out.items()), flush=True)
        return {"epoch": epoch, "seconds": time.perf_counter() - t0, **out}

    return fid_eval


def _train_comparator(cfg, device, logger, run_dir) -> dict:
    """Comparator pretraining (root ``train.py:654-827``). Returns {'run_dir',
    'step', 'metrics' (the last logged losses), 'epochs' (as ``main``),
    'eval_acc' (the last held-out accuracy, or None), 'bundle' (the
    ``comparator.pt`` path)}."""
    import dataclasses
    import torch
    from pcgan_tpu_torch.data import loader as data_loader
    from pcgan_tpu_torch.data.pairwise import held_out_split
    from pcgan_tpu_torch.models import define_C
    from pcgan_tpu_torch.models.comparator import comparison_accuracy
    from pcgan_tpu_torch.ops.preprocess import make_pair_preprocess
    from pcgan_tpu_torch.train import (create_comparator_state,
                                       make_comparator_step)
    from pcgan_tpu_torch.utils import checkpoint as ckpt

    t, d = cfg.train, cfg.data
    if d.dataset_mode == "comparisons":
        ds = data_loader.create_dataset(cfg, train=True)
    else:
        # every other mode is an age-labelled source: pairs with synthesized
        # labels over the easy base, as the reference does (pairwise_hard
        # included)
        ds = data_loader.create_dataset(dataclasses.replace(
            cfg, data=dataclasses.replace(d, dataset_mode="pairwise")))
    # held-out pairs (--cmp_eval_frac), never trained on: the epoch-end
    # accuracy on them is the out-of-sample metric
    train_ds, eval_ds = held_out_split(ds, t.cmp_eval_frac, t.seed)
    n_eval = 0 if eval_ds is None else len(eval_ds)
    resize_to = data_loader.host_resize_size(cfg)
    ld = data_loader.Loader(train_ds, d.batch_size, shuffle=True,
                            num_threads=d.num_threads, seed=t.seed,
                            resize_to=resize_to)
    steps_per_epoch = max(1, len(ld))
    print(f"device: {device}; comparator pairs: {len(train_ds)} train / "
          f"{n_eval} held out, {steps_per_epoch} steps/epoch", flush=True)

    C = define_C(cfg, torch.Generator().manual_seed(t.seed)).to(device)
    state = create_comparator_state(cfg, C,
                                    torch.Generator().manual_seed(t.seed + 1),
                                    steps_per_epoch)
    print(f"[Network C] Total number of parameters : "
          f"{sum(p.numel() for p in C.parameters()) / 1e6:.3f} M", flush=True)
    if cfg.run.verbose:
        print(C, flush=True)
    epochs_done = resume_skip = 0
    if t.continue_train and ckpt.state_exists(cfg.run.checkpoints_dir,
                                              cfg.run.name, "cmp_latest"):
        ckpt.restore_comparator_state(state, cfg.run.checkpoints_dir,
                                      cfg.run.name, "cmp_latest")
        epochs_done = state.step // steps_per_epoch
        resume_skip = state.step % steps_per_epoch
        ld.epoch = epochs_done
        print(f"resumed comparator from step {state.step} (epoch "
              f"{t.epoch_count + epochs_done})", flush=True)
    step_fn = make_comparator_step(cfg, C)
    pre = make_pair_preprocess(cfg, train=True)
    eval_pre = make_pair_preprocess(cfg, train=False)   # center crop, no flip

    def upload(raw):
        return {k: torch.from_numpy(raw[k]).to(device)
                for k in ("image_a", "image_b", "label")}

    @torch.no_grad()
    def eval_acc():
        # per-pair accuracy over the whole split: drop_last=False leaves a
        # partial last batch, so batch means are weighted by batch size
        hits = total = 0.0
        for raw in data_loader.Loader(eval_ds, min(d.batch_size, n_eval),
                                      shuffle=False, drop_last=False,
                                      num_threads=d.num_threads,
                                      resize_to=resize_to):
            b = eval_pre(None, upload(raw))
            bsz = b["label"].shape[0]
            mu, log_var = C(torch.cat([b["image_a"], b["image_b"]]))
            acc = float(comparison_accuracy(
                mu[:bsz], log_var[:bsz], mu[bsz:], log_var[bsz:],
                b["label"], cfg.model.tie_margin))
            hits += acc * bsz
            total += bsz
        return hits / total if total else float("nan")

    total_epochs = t.niter + t.niter_decay
    gstep = state.step
    epochs, last_metrics, acc = [], {}, None
    for epoch in range(t.epoch_count + epochs_done, total_epochs + 1):
        ld.skip_next, resume_skip = resume_skip, 0
        steps, t_first = 0, None
        for raw in data_loader.prefetch(iter(ld), d.prefetch):
            if t_first is None:
                t_first = time.perf_counter()
            metrics = step_fn(state, pre(state.generator, upload(raw)))
            gstep += 1
            steps += 1
            if gstep % t.print_freq == 0:
                last_metrics = dict(zip(metrics, torch.stack(
                    list(metrics.values())).cpu().tolist()))
                logger.log(gstep, last_metrics, epoch=epoch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if steps:
            epochs.append({"epoch": epoch, "steps": steps,
                           "train_seconds": time.perf_counter() - t_first})
        if eval_ds is not None:
            acc = eval_acc()
            logger.log(gstep, {"eval_acc_cmp": acc}, epoch=epoch)
            print(f"comparator held-out accuracy: {acc:.4f}", flush=True)
        ckpt.save_comparator_state(state, cfg.run.checkpoints_dir,
                                   cfg.run.name, "cmp_latest")
        if t.save_epoch_freq > 0 and epoch % t.save_epoch_freq == 0:
            ckpt.save_comparator_state(state, cfg.run.checkpoints_dir,
                                       cfg.run.name, f"cmp_epoch_{epoch}")
        print(f"End of comparator epoch {epoch}/{total_epochs}", flush=True)
    path = _save_anchor_bundle(cfg, ds, C, device)
    print(f"saved comparator + bin anchors to {path}", flush=True)
    return {"run_dir": run_dir, "step": state.step, "metrics": last_metrics,
            "epochs": epochs, "eval_acc": acc, "bundle": path}


def _save_anchor_bundle(cfg, ds, C, device) -> str:
    """Score anchors, then the bundle ``comparator.pt``; returns its path
    (root ``train.py:789-827``). The anchors are fitted on the first
    min(len, 512) images, center-cropped by B1: by age bins over the pairs'
    base dataset, or, for a comparisons CSV (no ages anywhere), by score
    quantiles over its unlabeled image pool."""
    import torch
    from pcgan_tpu_torch.data import loader as data_loader
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    from pcgan_tpu_torch.train import (compute_bin_anchors,
                                       compute_quantile_anchors)
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    d = cfg.data
    label_free = hasattr(ds, "image_pool_dataset")
    base = ds.image_pool_dataset() if label_free else ds.base
    n_anchor = min(len(base), 512)
    pre = make_preprocess(cfg, train=False)
    it = iter(data_loader.Loader(
        base, min(d.batch_size, n_anchor), shuffle=False, drop_last=False,
        num_threads=d.num_threads,
        resize_to=data_loader.host_resize_size(cfg)))
    if not label_free:
        it = data_loader.with_bins(it, d.n_age_bins, d.max_age)
    imgs, bins, seen = [], [], 0
    for b in it:
        imgs.append(pre(None, {"image": torch.from_numpy(
            b["image"]).to(device)})["image"])
        if not label_free:
            bins.append(b["bin"])
        seen += b["image"].shape[0]
        if seen >= n_anchor:
            break
    imgs = torch.cat(imgs)[:n_anchor]
    if label_free:
        lo, hi, means = compute_quantile_anchors(C, imgs, d.n_age_bins)
    else:
        lo, hi, means = compute_bin_anchors(
            C, imgs, np.concatenate(bins)[:n_anchor], d.n_age_bins)
    return ckpt.save_comparator_bundle(C, lo, hi, means, cfg,
                                       cfg.run.checkpoints_dir, cfg.run.name)


def _write_host_sidecar(run_dir, step, epoch_losses):
    """The current epoch's print-point losses beside the mid-epoch 'latest'
    checkpoint, so a resumed plateau metric averages the same points."""
    path = os.path.join(run_dir, "latest_host.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": int(step),
                   "epoch_losses": [float(x) for x in epoch_losses]}, f)
    os.replace(tmp, path)


def _read_host_sidecar(run_dir, step):
    """The loss list saved at exactly ``step``, else [] (a stale or broken
    sidecar starts the epoch metric fresh)."""
    try:
        with open(os.path.join(run_dir, "latest_host.json")) as f:
            rec = json.load(f)
        if int(rec.get("step", -1)) == int(step):
            return [float(x) for x in rec.get("epoch_losses", [])]
    except (OSError, ValueError, TypeError, AttributeError):
        pass
    return []


def _make_display(cfg, G, run_dir, device):
    """Every --display_freq steps, render G on a fixed preview input (the
    first two images of the first batch seen, center-cropped) at every age
    bin and add the strip to {run_dir}/web (PNG + index.html)."""
    import torch
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    from pcgan_tpu_torch.sample import make_sampler
    from pcgan_tpu_torch.utils.visualizer import (HTMLPage, save_image,
                                                  tensor_to_u8)
    sampler = make_sampler(cfg, G)
    pre = make_preprocess(cfg, train=False)
    page = HTMLPage(os.path.join(run_dir, "web"), title=cfg.run.name)
    cache = {}

    def display(state, raw, epoch):
        if "preview" not in cache:
            img = torch.from_numpy(raw["image"][:2]).to(device)
            cache["preview"] = pre(None, {"image": img})["image"].float()
        real = cache["preview"]
        fakes = sampler(real).cpu().numpy()           # (n, nb, H, W, C)
        G.train()
        real = real.cpu().numpy()
        grid = np.concatenate(
            [np.concatenate([real[i]] + list(fakes[i]), axis=1)
             for i in range(real.shape[0])], axis=0)
        fn = f"epoch{epoch:03d}_step{state.step:07d}.png"
        save_image(tensor_to_u8(grid), os.path.join(run_dir, "web", "images",
                                                    fn))
        page.add_header(f"epoch {epoch} step {state.step}")
        page.add_images([fn], [fn], width=min(1024, grid.shape[1]))
        page.save()

    return display


if __name__ == "__main__":
    main()
