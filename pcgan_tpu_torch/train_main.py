"""Training entry point of the port (counterpart of the root ``train.py:23-553``).

    python -m pcgan_tpu_torch.train_main --dataset_mode synthetic \\
        --name run --checkpoints_dir ./checkpoints [--device cpu]

Per step: a host u8 batch (synthetic data, generated on a background
thread) goes to the device, kernel B1 random-crops, flips and normalizes it,
and the fused G/D step (``pcgan_tpu_torch/train.py``) updates both nets.
The loop keeps the reference loop's surface: epochs, ``--print_freq``
console lines and ``metrics.jsonl`` rows (with ``imgs_per_sec`` and
``lr``), ``--display_freq`` preview grids, ``loss_curves.svg`` every epoch,
``latest`` / ``epoch_N`` checkpoints (``--save_latest_freq``,
``--save_epoch_freq``, ``--max_ckpt_keep``) and ``--continue_train`` with
exact resume: the loader replays the epoch's seeded permutation and skips
the batches the restored step already consumed. Runs on cuda unless
``--device cpu``. Flags the port does not implement raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def main(argv=None) -> dict:
    """Runs the CLI; returns {'run_dir', 'step', 'metrics' (the last logged
    losses), 'epochs': [{'epoch', 'steps', 'train_seconds'}]}, where
    ``train_seconds`` is an epoch's wall time from its first batch to its
    last step finished on the device (checkpoints and plots excluded)."""
    from pcgan_tpu_torch.config import amend_run_opt, parse_config
    # under --continue_train, structural flags and the state-tree togglers
    # default from the run's own opt.json, as in train.py
    cfg = parse_config(argv, is_train=True, opt_defaults="resume")
    if cfg.model.quant_int8:
        raise SystemExit("--quant_int8 is an inference-only lever; training "
                         "through int8 quantization has zero gradients")
    from pcgan_tpu_torch.train import reject_unported_train
    reject_unported_train(cfg)

    from pcgan_tpu_torch.data import loader as data_loader
    from pcgan_tpu_torch.device import resolve_device
    from pcgan_tpu_torch.utils.metrics import MetricsLogger

    device = resolve_device(cfg.run.device)
    run_dir = os.path.join(cfg.run.checkpoints_dir, cfg.run.name)
    os.makedirs(run_dir, exist_ok=True)
    cfg.save(os.path.join(run_dir, "opt.json"))
    ds = data_loader.create_dataset(cfg, train=True)
    amend_run_opt(cfg.run.checkpoints_dir, cfg.run.name, "split", {
        "dataset_len": len(ds), "phase": cfg.run.phase, "phase_root": None,
        "holdout_frac": cfg.data.holdout_frac, "seed": cfg.train.seed})
    ld = data_loader.Loader(ds, cfg.data.batch_size,
                            shuffle=not cfg.data.serial_batches,
                            num_threads=cfg.data.num_threads,
                            seed=cfg.train.seed)
    steps_per_epoch = max(1, len(ld))
    print(f"device: {device}; dataset [{cfg.data.dataset_mode}] size "
          f"{len(ds)}, {steps_per_epoch} steps/epoch", flush=True)
    logger = MetricsLogger(run_dir)
    try:
        return _train_gan(cfg, device, ld, steps_per_epoch, logger, run_dir)
    finally:
        logger.close()


def _train_gan(cfg, device, ld, steps_per_epoch, logger, run_dir) -> dict:
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
    state = create_train_state(cfg, G, D,
                               torch.Generator().manual_seed(seed + 2),
                               steps_per_epoch)
    print("---------- Networks initialized -------------", flush=True)
    for name, net in (("G", G), ("D", D)):
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

    step_fn = make_train_step(cfg, G, D)
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
    last_latest_save = 0
    gstep = state.step
    epochs, last_metrics = [], {}
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
        write_loss_plot(run_dir)
        print(f"End of epoch {epoch}/{total_epochs} \t "
              f"({time.time() - epoch_t0:.1f}s)", flush=True)
    save("latest")
    return {"run_dir": run_dir, "step": state.step, "metrics": last_metrics,
            "epochs": epochs}


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
