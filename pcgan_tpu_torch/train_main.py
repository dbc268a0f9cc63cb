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

Run-level levers: ``--metrics_lag`` (each print point's metrics are read
at the next one), ``--log_memory`` (the CUDA allocator's bytes in use and
peak), ``--tb_logdir`` (TensorBoard event files), ``--profile_steps N`` (a
``torch.profiler`` trace of N steps under ``{run}/trace``),
``--debug_nans`` (autograd anomaly mode and a finiteness check of every
step), ``--init_g_from name/tag`` (warm-start G), ``--lambda_vgg`` with
``--vgg_path``.

``--device_cache`` uploads the (train-split) dataset to the device once and
gathers every batch there (``data/device_cache.py``), for GAN training,
its in-training eval and comparator pretraining; the sample stream is the
host Loader's.

Runs on cuda unless ``--device cpu``. The flags the port does not implement
(the sharded device cache, multi-device meshes) raise
``NotImplementedError``, as do the XLA-only ``--profile_server``,
``--compile_cache`` and ``--xla_opt`` for good.
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
    if cfg.run.debug_nans:
        # autograd names the op whose backward made a NaN; the loop checks
        # every step's metrics and raises on the first non-finite one
        import torch
        torch.autograd.set_detect_anomaly(True)
    run_dir = os.path.join(cfg.run.checkpoints_dir, cfg.run.name)
    os.makedirs(run_dir, exist_ok=True)
    cfg.save(os.path.join(run_dir, "opt.json"))
    tb_dir = (os.path.join(cfg.run.tb_logdir, cfg.run.name)
              if cfg.run.tb_logdir else "")
    if cfg.model.model == "comparator":
        # pretraining builds its own pair loaders (with a held-out split)
        if cfg.train.metrics_lag:
            print("--metrics_lag applies to the GAN training loop; "
                  "comparator pretraining prints eagerly (ignored)",
                  flush=True)
        logger = MetricsLogger(run_dir, tb_logdir=tb_dir)
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
    if cfg.data.device_cache:
        # the whole (train-split) dataset rides to the device once; epochs
        # gather their batches there, in the host Loader's order
        from pcgan_tpu_torch.data.device_cache import DeviceCacheLoader
        ld = DeviceCacheLoader(cfg, ds, device,
                               shuffle=not cfg.data.serial_batches,
                               seed=cfg.train.seed)
    else:
        ld = data_loader.Loader(ds, cfg.data.batch_size,
                                shuffle=not cfg.data.serial_batches,
                                num_threads=cfg.data.num_threads,
                                seed=cfg.train.seed,
                                resize_to=data_loader.host_resize_size(cfg))
    steps_per_epoch = max(1, len(ld))
    print(f"device: {device}; dataset [{cfg.data.dataset_mode}] size "
          f"{len(ds)}, {steps_per_epoch} steps/epoch", flush=True)
    logger = MetricsLogger(run_dir, tb_logdir=tb_dir)
    try:
        return _train_gan(cfg, device, ld, steps_per_epoch, logger, run_dir,
                          holdout_ds)
    finally:
        logger.close()


def _train_gan(cfg, device, ld, steps_per_epoch, logger, run_dir,
               holdout_ds=None) -> dict:
    import torch
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
    vgg = _load_vgg(cfg) if t.lambda_vgg > 0 else None
    if t.init_g_from and not t.continue_train:
        # warm-start G from a G-only checkpoint: fresh D and optimizers,
        # the EMA twin starts at the loaded weights
        name, _, tag = t.init_g_from.rpartition("/")
        ckpt.restore_generator(G, cfg.run.checkpoints_dir,
                               name or cfg.run.name, tag or "latest")
        print(f"initialized G from [{t.init_g_from}]", flush=True)
    state = create_train_state(cfg, G, D,
                               torch.Generator().manual_seed(seed + 2),
                               steps_per_epoch, C=C, bin_anchors=bin_anchors,
                               vgg=vgg)
    from pcgan_tpu_torch.utils.summary import print_networks
    print_networks({"G": G, "D": D, "C (frozen)": C},
                   verbose=cfg.run.verbose)

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
            ckpt.save_generator(ckpt.ema_state_dict(G, state.ema),
                                cfg.run.checkpoints_dir, cfg.run.name, tag,
                                use_ema=True)

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
    def fetch(metrics):
        # one device->host copy for all metrics; it also syncs
        host = dict(zip(metrics, torch.stack(
            list(metrics.values())).cpu().tolist()))
        if cfg.run.debug_nans:
            bad = sorted(k for k, v in host.items() if not np.isfinite(v))
            if bad:
                raise FloatingPointError(f"--debug_nans: non-finite {bad}")
        return host

    def log(g, host, epoch, rate):
        nonlocal last_metrics
        epoch_losses.append(host["loss_G"])
        last_metrics = host
        logger.log(g, {**host, **_mem_metrics(device, t.log_memory)},
                   epoch=epoch, imgs_per_sec=rate,
                   lr=state.sched_g(g) * state.lr_scale)

    # --metrics_lag: the fetch of a print point's metrics waits for the
    # NEXT print point, when the card has further steps queued behind it;
    # the rows are the same, the rate is measured fetch to fetch
    pending = None
    lag_anchor = {"t": None, "g": 0}

    def log_pending():
        nonlocal pending
        g, m, ep = pending
        pending = None
        host = fetch(m)
        now = time.perf_counter()
        rate = None
        if lag_anchor["t"] is not None and g > lag_anchor["g"]:
            rate = ((g - lag_anchor["g"]) * cfg.data.batch_size
                    / max(now - lag_anchor["t"], 1e-9))
        lag_anchor.update(t=now, g=g)
        log(g, host, ep, rate)

    profiler = _Profiler(cfg.run.profile_steps, run_dir, device)
    last_latest_save = 0
    gstep = state.step
    epochs, evals, last_metrics = [], [], {}
    for epoch in range(t.epoch_count + epochs_done, total_epochs + 1):
        epoch_t0 = time.time()
        epoch_losses, resume_losses = resume_losses, []
        metrics = None
        timer.start()
        lag_anchor.update(t=time.perf_counter(), g=gstep)
        ld.skip_next, resume_skip = resume_skip, 0
        steps = 0
        t_first = None
        for raw in _epoch_batches(cfg, ld):
            if t_first is None:
                t_first = time.perf_counter()
            profiler.tick()
            images = _to_device(raw["image"], device)
            batch = pre(state.generator, {"image": images})
            batch["bin"] = _to_device(raw["bin"], device)
            metrics = step_fn(state, batch)
            gstep += 1
            steps += 1
            timer.tick(cfg.data.batch_size)
            if cfg.run.debug_nans and gstep % t.print_freq:
                fetch(metrics)
            if gstep % t.display_freq == 0:
                display(state, raw, epoch)
            if gstep % t.print_freq == 0:
                if t.metrics_lag:
                    if pending is not None:
                        log_pending()
                    pending = (gstep, metrics, epoch)
                else:
                    host = fetch(metrics)
                    log(gstep, host, epoch, timer.rate())
                    timer.start()
            if t.save_latest_freq > 0 and gstep % t.save_latest_freq == 0:
                if pending is not None:
                    # the save must not leave the pending row unwritten
                    log_pending()
                last_latest_save = gstep
                save("latest")
                _write_host_sidecar(run_dir, gstep, epoch_losses)
        if pending is not None:
            log_pending()
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
    profiler.close()
    save("latest")
    return {"run_dir": run_dir, "step": state.step, "metrics": last_metrics,
            "epochs": epochs, "evals": evals}


def _to_device(v, device):
    """A batch entry on ``device``: host numpy arrays are uploaded, the
    device cache's tensors are already there."""
    import torch
    return torch.as_tensor(v).to(device)


def _epoch_batches(cfg, ld):
    """One epoch of raw batches with age bins: gathered on the device under
    ``--device_cache`` (no host stage), else made on the host by the
    ``--prefetch`` thread."""
    from pcgan_tpu_torch.data.loader import prefetch, with_bins
    if getattr(ld, "is_device_cache", False):
        return iter(ld)
    return prefetch(with_bins(iter(ld), cfg.data.n_age_bins,
                              cfg.data.max_age), cfg.data.prefetch)


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

    def d_bins(it):
        return data_loader.with_bins(it, d.n_age_bins, d.max_age)

    if getattr(ld, "is_device_cache", False):
        # the train-side eval reads the resident cache in the host eval
        # loader's order; the held-out rows still stream from the host
        sources = [("eval_", ld.eval_iter)]
    else:
        train_ld = loader(ld.ds)
        sources = [("eval_", lambda: d_bins(iter(train_ld)))]
    if holdout_ds is not None:
        h_ld = loader(holdout_ds)
        if len(h_ld) == 0:
            raise SystemExit(
                f"--holdout_frac {d.holdout_frac} leaves fewer than one batch "
                f"({len(holdout_ds)} rows < --batch_size {d.batch_size}) for "
                f"eval")
        sources.append(("eval_h_", lambda: d_bins(iter(h_ld))))
    # --eval_use_ema scores the EMA twin (what ships): a copy of G that
    # takes the EMA parameters (and G's norm state) before each eval
    twin = copy.deepcopy(G) if t.eval_use_ema else None

    def fid_eval(epoch: int) -> dict:
        net = G
        if twin is not None:
            from pcgan_tpu_torch.utils.checkpoint import ema_state_dict
            twin.load_state_dict(ema_state_dict(G, state.ema))
            net = twin
        t0 = time.perf_counter()
        out = {}
        for prefix, source in sources:
            rec = run_fid(net, source(), max_images=t.eval_fid_images,
                          seed=t.seed)
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
    if d.device_cache:
        # pair batches (image_a / image_b canvases, labels) cache as the
        # GAN's do; the held-out and anchor loaders stay on the host
        from pcgan_tpu_torch.data.device_cache import DeviceCacheLoader
        ld = DeviceCacheLoader(cfg, train_ds, device, shuffle=True,
                               seed=t.seed)
    else:
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
    from pcgan_tpu_torch.utils.summary import print_networks
    print_networks({"C": C}, verbose=cfg.run.verbose)
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
        return {k: _to_device(raw[k], device)
                for k in ("image_a", "image_b", "label")}

    @torch.no_grad()
    def eval_acc():
        # per-pair accuracy over the whole split: drop_last=False leaves a
        # partial last batch, so batch means are weighted by batch size
        C.eval()
        try:
            return _eval_acc()
        finally:
            C.train()

    def _eval_acc():
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
        for raw in (iter(ld) if d.device_cache
                    else data_loader.prefetch(iter(ld), d.prefetch)):
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


def _load_vgg(cfg):
    """The frozen VGG19 trunk of ``--lambda_vgg``: ``--vgg_path`` (a
    torchvision vgg19 ``.pth`` or an ``.npz``), or a seeded random trunk for
    ``random``; None for an empty path (the state then raises)."""
    from pcgan_tpu_torch.models.vgg import load_vgg19, random_vgg19
    path = cfg.train.vgg_path
    if path == "random":
        print("WARNING: --vgg_path random — perceptual loss runs in "
              "FRESH-INIT VGG feature space (smoke/CI only; point "
              "--vgg_path at a torchvision vgg19 .pth for the published "
              "pix2pixHD loss)", flush=True)
        return random_vgg19(0)
    if path:
        net = load_vgg19(path)
        print(f"loaded VGG19 trunk from {path}", flush=True)
        return net
    return None


def _mem_metrics(device, on: bool) -> dict:
    """--log_memory: the caching allocator's bytes in use and their peak
    (a host-side read, no sync); {} off the card."""
    if not on or device.type != "cuda":
        return {}
    import torch
    ms = torch.cuda.memory_stats(device)
    return {"mem_hbm_gb": round(ms["allocated_bytes.all.current"] / 2**30, 3),
            "mem_hbm_peak_gb": round(ms["allocated_bytes.all.peak"] / 2**30,
                                     3)}


class _Profiler:
    """--profile_steps N: a ``utils.profiling.trace`` (CPU and, on the card,
    CUDA activity) of N steady-state steps after 3 warm-up steps, written to
    ``{run_dir}/trace/trace.json`` (chrome trace format)."""

    def __init__(self, n_steps: int, run_dir: str, device):
        self.left, self.skip = n_steps, 3
        self.run_dir, self.device = run_dir, device
        self.prof = None

    def tick(self) -> None:
        """Call before every step."""
        if self.left <= 0 and self.prof is None:
            return
        if self.skip > 0:
            self.skip -= 1
            return
        if self.prof is None:
            from pcgan_tpu_torch.utils.profiling import trace
            self.prof = trace(os.path.join(self.run_dir, "trace"),
                              self.device)
            self.prof.__enter__()
            print(f"profiling {self.left} steps -> {self.run_dir}/trace",
                  flush=True)
            return
        self.left -= 1
        if self.left <= 0:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        self.prof.__exit__(None, None, None)    # syncs, writes the trace
        self.prof, self.left = None, 0
        print("profile trace written", flush=True)


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
            img = _to_device(raw["image"][:2], device)
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
