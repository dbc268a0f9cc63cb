"""Test / sampling entry point of the port (counterpart of the root ``test.py``).

Loads a generator checkpoint and writes aging-progression grids
[input | aged@bin0 | ... | aged@binK] as PNGs + an HTML index under
``{results_dir}/{name}/{phase}_{epoch}/``. All bins render in one batched
forward per input batch. The inputs come from any ported
``--dataset_mode``: a UTKFace-style folder in ``aging`` mode reads
``{dataroot}/{phase}`` when that folder exists (``--phase test`` by
default), and ``--host_resize`` resizes on the host. ``--anim N`` also
writes an N-frame aging sweep per input as ``{i:04d}_aging.gif`` (Pillow),
and ``--quant_int8`` samples through the int8 trunk with dynamic scales.
Runs on cuda unless ``--device cpu``::

    python -m pcgan_tpu_torch.test --dataset_mode synthetic --name run \\
        --checkpoints_dir ./checkpoints --results_dir ./results
    python -m pcgan_tpu_torch.test --dataroot ./datasets/utkface \\
        --dataset_mode aging --name utk128 --netG resnet_9blocks \\
        --norm instance --load_size 143 --crop_size 128 --n_age_bins 10 \\
        --epoch latest --num_test 50
"""

from __future__ import annotations

import os
import time


def main(argv=None) -> dict:
    """Runs the CLI; returns {'web_dir', 'done', 'batch_seconds'} where
    ``batch_seconds`` holds each batch's wall time from the raw host batch
    to the grid back on the host (preprocessing + sampler)."""
    from pcgan_tpu_torch.config import parse_config
    # structural flags default from the run's opt.json, as in test.py
    cfg = parse_config(argv, is_train=False, opt_defaults="on")
    if cfg.data.device_cache or cfg.data.device_cache_sharded:
        print("note: --device_cache is a training-loop lever; test.py "
              "streams from the host (flag ignored)", flush=True)
    if cfg.run.anim == 1:
        raise SystemExit("--anim needs >= 2 frames (or 0 to disable)")

    import torch
    from pcgan_tpu_torch.data import loader as data_loader
    from pcgan_tpu_torch.device import resolve_device
    from pcgan_tpu_torch.models import define_G
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    from pcgan_tpu_torch.sample import (aging_grid_visuals, make_anim_sampler,
                                        make_sampler)
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    from pcgan_tpu_torch.utils.visualizer import (HTMLPage, save_animation,
                                                  save_visuals_row)

    device = resolve_device(cfg.run.device)
    web_dir = os.path.join(cfg.run.results_dir, cfg.run.name,
                           f"{cfg.run.phase}_{cfg.run.epoch}")
    os.makedirs(web_dir, exist_ok=True)

    G = define_G(cfg)
    suffix = "_G_ema" if cfg.run.use_ema else "_G"
    if not ckpt.exists(cfg.run.checkpoints_dir, cfg.run.name, cfg.run.epoch,
                       use_ema=cfg.run.use_ema):
        raise SystemExit(
            f"checkpoint [{cfg.run.epoch}{suffix}] not found under "
            f"{os.path.join(cfg.run.checkpoints_dir, cfg.run.name)} — train "
            f"first (with --ema_decay > 0 for --use_ema) or pass "
            f"--epoch <tag>")
    ckpt.restore_generator(G, cfg.run.checkpoints_dir, cfg.run.name,
                           cfg.run.epoch, use_ema=cfg.run.use_ema)
    G = G.to(device).eval()
    print(f"loaded generator checkpoint [{cfg.run.epoch}{suffix}] on "
          f"{device}", flush=True)
    n_params = sum(p.numel() for p in G.parameters())
    print("---------- Networks initialized -------------", flush=True)
    if cfg.run.verbose:
        print(G, flush=True)
    print(f"[Network G] Total number of parameters : {n_params / 1e6:.3f} M",
          flush=True)
    print("-----------------------------------------------", flush=True)

    ds = data_loader.create_dataset(cfg, train=False)
    bs = min(cfg.data.batch_size, cfg.run.num_test)
    ld = data_loader.Loader(ds, bs, shuffle=False, drop_last=False,
                            num_threads=cfg.data.num_threads,
                            resize_to=data_loader.host_resize_size(cfg))
    pre = make_preprocess(cfg, train=False)   # center crop, no flip
    sampler = make_sampler(cfg, G)
    anim_sampler = (make_anim_sampler(cfg, G, cfg.run.anim)
                    if cfg.run.anim > 0 else None)

    page = HTMLPage(web_dir, title=f"{cfg.run.name} [{cfg.run.epoch}]")
    done, batch_seconds = 0, []
    for raw in data_loader.with_bins(iter(ld), cfg.data.n_age_bins,
                                     cfg.data.max_age):
        t0 = time.perf_counter()
        images = torch.from_numpy(raw["image"]).to(device)
        batch = pre(None, {"image": images})
        imgs = batch["image"].float()
        fakes = sampler(imgs).cpu().numpy()                  # (B, nb, H, W, C)
        frames = (anim_sampler(imgs).cpu().numpy()           # (B, T, H, W, C)
                  if anim_sampler is not None else None)
        imgs = imgs.cpu().numpy()
        batch_seconds.append(time.perf_counter() - t0)
        for i in range(imgs.shape[0]):
            if done >= cfg.run.num_test:
                break
            visuals = aging_grid_visuals(cfg, imgs[i], fakes[i])
            save_visuals_row(page, f"{done:04d}", visuals)
            if frames is not None:
                fn = f"{done:04d}_aging.gif"
                save_animation(frames[i], os.path.join(page.img_dir, fn))
                page.add_images([fn], [f"{cfg.run.anim}-frame sweep"])
            done += 1
        if done >= cfg.run.num_test:
            break
    page.save()
    print(f"wrote {done} aging grids to {web_dir}/index.html", flush=True)
    return {"web_dir": web_dir, "done": done, "batch_seconds": batch_seconds}


if __name__ == "__main__":
    main()
