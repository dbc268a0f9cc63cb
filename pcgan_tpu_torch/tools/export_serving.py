"""Export a trained generator (or comparator) as a self-contained
``torch.export`` serving artifact (counterpart of the root
``tools/export_serving.py``; ``pcgan_tpu_torch/serving.py`` holds the
format)::

    python -m pcgan_tpu_torch.tools.export_serving --name run1 \\
        --checkpoints_dir ./checkpoints --netG resnet_9blocks \\
        --crop_size 128 --n_age_bins 10 --out_dir ./serving/run1 --verify

The artifact holds the weights and a symbolic batch dimension, exported on
the CPU for ``cuda`` and ``cpu``; a host serves it with torch + numpy::

    from pcgan_tpu_torch.serving import load_exported
    g = load_exported("./serving/run1")          # device="cuda" by default
    fakes = g(images, cond)            # f32 [-1,1] NHWC -> f32 [-1,1]
    grid = g.progression(images)       # (B, n_conditions, H, W, C)

Architecture flags resolve as: explicit flag > the run's ``opt.json`` >
the training defaults. ``--verify`` runs the loaded artifact against the
live model on random inputs; ``--use_ema`` exports the EMA twin;
``--quant_int8`` calibrates static int8 activation scales first
(``--calib_dataroot`` rows, else the synthetic face-like set);
``--comparator_path`` exports the pretrained comparator instead. The live
model (calibration, ``--verify``) runs on ``--device`` (cuda unless cpu).
"""

from __future__ import annotations

import argparse
import os


def _calib_images(args, n: int, rng):
    """n representative images for int8 activation-scale calibration, f32
    [-1,1] NHWC at crop_size: ``--calib_dataroot`` rows (real data), else
    the synthetic face-like aging set; uniform noise only for contracts
    that are not 3-channel, which the image sets cannot fill."""
    import numpy as np
    if args.input_nc != 3:
        return rng.uniform(-1, 1, (n, args.crop_size, args.crop_size,
                                   args.input_nc)).astype(np.float32)
    from pcgan_tpu_torch.data.resample import pil_resize_np
    if args.calib_dataroot:
        from pcgan_tpu_torch.data.utkface import UTKFaceDataset
        # native=0: the folder's own canvas (a 250 px CACD row must not be
        # resampled through the 200 px default first), capped at 2x crop
        ds = UTKFaceDataset(args.calib_dataroot, require_age=False,
                            native=0,
                            native_cap=max(200, 2 * args.crop_size))
    else:
        from pcgan_tpu_torch.data.synthetic import SyntheticAgingDataset
        ds = SyntheticAgingDataset(size=n, seed=0)
    idx = np.linspace(0, len(ds) - 1, n).astype(int)   # spread over the set
    rows = np.stack([pil_resize_np(ds.get_raw(int(i))["image"],
                                   args.crop_size) for i in idx])
    return rows.astype(np.float32) / 127.5 - 1.0


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--name", default=None,
                   help="run name (required unless --comparator_path)")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--tag", default="latest")
    p.add_argument("--use_ema", action="store_true",
                   help="export the EMA twin ({tag}_G_ema)")
    p.add_argument("--out_dir", default=None,
                   help="artifact directory (default <ckpt_dir>/<name>/"
                        "serving[_ema])")
    p.add_argument("--platforms", default="cuda,cpu",
                   help="comma-separated devices the artifact is for "
                        "(cuda, cpu); the program itself is exported once, "
                        "on the CPU")
    p.add_argument("--fixed_batch", type=int, default=None,
                   help="pin the batch dimension (default: symbolic, one "
                        "artifact serves every batch size)")
    p.add_argument("--verify", action="store_true",
                   help="run the loaded artifact against the live model on "
                        "random inputs, on --device")
    p.add_argument("--comparator_path", default=None,
                   help="export the pretrained COMPARATOR of this run "
                        "directory (or comparator.pt) instead of a "
                        "generator (--name/--tag/--use_ema ignored)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the live model runs (calibration, --verify)")
    # architecture flags: explicit > the run's opt.json > training defaults
    p.add_argument("--cmp_nf", type=int, default=None)
    p.add_argument("--cmp_n_down", type=int, default=None)
    p.add_argument("--netG", default=None)
    p.add_argument("--ngf", type=int, default=None)
    p.add_argument("--norm", default=None)
    p.add_argument("--g_attn", action="store_true", default=None,
                   help="the run used --g_attn (resnet G only)")
    p.add_argument("--cond_inject", default=None)
    p.add_argument("--cond_mode", default=None, choices=["onehot", "score"])
    p.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                   help="compute dtype INSIDE the artifact (the call "
                        "contract stays f32). Default: bfloat16 for the "
                        "generator, float32 for --comparator_path (scoring "
                        "ranks near-ties, as tools/sort_unlabeled does)")
    p.add_argument("--quant_int8", action="store_true",
                   help="int8-PTQ the generator trunk inside the artifact: "
                        "each trunk conv an im2col and one s8 x s8 -> s32 "
                        "product (cuBLASLt on the card). NON-parity: "
                        "outputs differ at quantization-noise level. "
                        "Activation scales are calibrated here across "
                        "random conditions on --calib_dataroot rows (real "
                        "data, recommended) or synthetic face-like images, "
                        "and stored in the artifact")
    p.add_argument("--calib_batches", type=int, default=4,
                   help="calibration batches of 8 for --quant_int8")
    p.add_argument("--calib_dataroot", default=None,
                   help="with --quant_int8: a folder of face images to "
                        "calibrate the static activation scales on "
                        "(default: the synthetic face-like set)")
    p.add_argument("--crop_size", type=int, default=None)
    p.add_argument("--n_age_bins", type=int, default=None)
    p.add_argument("--input_nc", type=int, default=None)
    p.add_argument("--output_nc", type=int, default=None)
    return p


def _resolve(args):
    """Fill the architecture flags: explicit > run opt.json > default."""
    from pcgan_tpu_torch.config import load_run_opt, opt_value
    opt = load_run_opt(args.checkpoints_dir, args.name) if args.name else None
    if args.comparator_path and opt is None:
        # comparator pretraining writes opt.json into its run directory,
        # the directory that holds comparator.pt
        d = os.path.abspath(args.comparator_path)
        if os.path.isfile(d):
            d = os.path.dirname(d)
        opt = load_run_opt(os.path.dirname(d), os.path.basename(d))

    def arch(flag, section, hard):
        v = getattr(args, flag)
        return v if v is not None else opt_value(opt, section, flag, hard)

    args.cmp_nf = arch("cmp_nf", "model", 64)
    args.cmp_n_down = arch("cmp_n_down", "model", 4)
    args.netG = arch("netG", "model", "resnet_9blocks")
    args.ngf = arch("ngf", "model", 64)
    args.norm = arch("norm", "model", "instance")
    args.g_attn = arch("g_attn", "model", False)
    args.cond_inject = arch("cond_inject", "model", "input")
    args.cond_mode = arch("cond_mode", "model", "onehot")
    args.crop_size = arch("crop_size", "data", 128)
    args.n_age_bins = arch("n_age_bins", "data", 10)
    args.input_nc = arch("input_nc", "data", 3)
    args.output_nc = arch("output_nc", "data", 3)
    if opt is not None:
        print("config: architecture defaults from the run's opt.json "
              "(explicit flags override)", flush=True)
    return args


def _export_comparator(args, platforms, device) -> str:
    import numpy as np
    import torch
    from pcgan_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                        TrainConfig)
    from pcgan_tpu_torch.serving import export_comparator, load_exported
    from pcgan_tpu_torch.utils.checkpoint import load_comparator_bundle
    args.dtype = args.dtype or "float32"
    cfg = Config(
        data=DataConfig(crop_size=args.crop_size, n_age_bins=args.n_age_bins,
                        input_nc=args.input_nc),
        model=ModelConfig(cmp_nf=args.cmp_nf, cmp_n_down=args.cmp_n_down,
                          norm=args.norm, dtype=args.dtype),
        train=TrainConfig(comparator_path=args.comparator_path))
    C = load_comparator_bundle(cfg)[0].eval()
    root = args.comparator_path
    out_dir = args.out_dir or os.path.join(
        os.path.dirname(root) if os.path.isfile(root) else root, "serving")
    path = export_comparator(cfg, C, out_dir, platforms=platforms,
                             fixed_batch=args.fixed_batch)
    print(f"exported comparator -> {path} "
          f"({os.path.getsize(path) / 1e6:.1f} MB, platforms={platforms})",
          flush=True)
    if args.verify:
        served = load_exported(out_dir, device=device.type)
        b = args.fixed_batch or 3
        imgs = np.random.default_rng(0).uniform(
            -1, 1, (b, args.crop_size, args.crop_size,
                    args.input_nc)).astype(np.float32)
        mu, _ = served(imgs)
        C = C.to(device)
        with torch.no_grad():
            want = C(torch.from_numpy(imgs).to(device).to(
                C.convs[0].compute_dtype))[0].float().cpu().numpy()
        err = float(np.abs(mu - want).max())
        print(f"verify: max|exported - live| = {err:.2e}", flush=True)
        if not np.isfinite(err) or err > 5e-2:
            raise SystemExit("verification FAILED")
    return out_dir


def _calibrate(args, cfg, G, device) -> None:
    import numpy as np
    import torch
    from pcgan_tpu_torch.ops.quant import calibrate_quant
    crng = np.random.default_rng(0)
    bs, n_cal = 8, max(1, args.calib_batches)
    rows = _calib_images(args, n_cal * bs, crng)
    batches = []
    for bi in range(n_cal):
        imgs = torch.from_numpy(rows[bi * bs:(bi + 1) * bs]).to(device)
        if cfg.cond_nc == args.n_age_bins:
            cond = np.eye(args.n_age_bins, dtype=np.float32)[
                crng.integers(0, args.n_age_bins, bs)]
        else:
            cond = crng.uniform(-1, 1, (bs, 1)).astype(np.float32)
        batches.append((imgs, torch.from_numpy(cond).to(device)))
    calibrate_quant(G, batches)
    src = args.calib_dataroot or "synthetic face-like images"
    print(f"calibrated int8 activation scales on {len(batches)} batches "
          f"from {src}", flush=True)


def main(argv=None) -> str:
    """Runs the CLI; returns the artifact directory."""
    args = _resolve(_parser().parse_args(argv))
    platforms = [s.strip() for s in args.platforms.split(",") if s.strip()]
    from pcgan_tpu_torch.serving import check_platforms
    try:
        platforms = check_platforms(platforms)
    except ValueError as e:
        raise SystemExit(f"--platforms: {e}")
    import numpy as np
    import torch
    from pcgan_tpu_torch.device import resolve_device
    device = resolve_device(args.device)

    if args.comparator_path and args.quant_int8:
        # rather than silently exporting an unquantized comparator
        raise SystemExit("--quant_int8 applies to generator exports only; "
                         "the comparator exports f32 (scoring ranks "
                         "near-ties; see --dtype help)")
    if args.comparator_path:
        return _export_comparator(args, platforms, device)

    from pcgan_tpu_torch.config import Config, DataConfig, ModelConfig
    from pcgan_tpu_torch.models import define_G
    from pcgan_tpu_torch.serving import export_generator, load_exported
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    if not args.name:
        raise SystemExit("--name is required (or pass --comparator_path)")
    args.dtype = args.dtype or "bfloat16"   # generator perf-path default
    cfg = Config(
        data=DataConfig(crop_size=args.crop_size, n_age_bins=args.n_age_bins,
                        input_nc=args.input_nc, output_nc=args.output_nc),
        model=ModelConfig(netG=args.netG, ngf=args.ngf, norm=args.norm,
                          g_attn=bool(args.g_attn),
                          cond_inject=args.cond_inject,
                          cond_mode=args.cond_mode, dtype=args.dtype,
                          quant_int8=args.quant_int8))
    G = define_G(cfg)
    ckpt.restore_generator(G, args.checkpoints_dir, args.name, args.tag,
                           use_ema=args.use_ema)
    G = G.to(device).eval()
    if args.quant_int8:
        _calibrate(args, cfg, G, device)

    out_dir = args.out_dir or os.path.join(
        args.checkpoints_dir, args.name,
        "serving_ema" if args.use_ema else "serving")
    path = export_generator(cfg, G, out_dir, platforms=platforms,
                            fixed_batch=args.fixed_batch,
                            ema_source=args.use_ema)
    batch = "symbolic" if args.fixed_batch is None else args.fixed_batch
    print(f"exported [{args.tag}{'_G_ema' if args.use_ema else '_G'}] -> "
          f"{path} ({os.path.getsize(path) / 1e6:.1f} MB, "
          f"platforms={platforms}, batch={batch})", flush=True)

    if args.verify:
        served = load_exported(out_dir, device=device.type)
        b = args.fixed_batch or 3
        rng = np.random.default_rng(0)
        imgs = rng.uniform(-1, 1, (b, args.crop_size, args.crop_size,
                                   args.input_nc)).astype(np.float32)
        conds = served.all_conditions()
        cond = conds[rng.integers(0, conds.shape[0], b)]
        got = served(imgs, cond)
        dt = G.compute_dtype
        with torch.no_grad():
            want = G(torch.from_numpy(imgs).to(device).to(dt),
                     torch.from_numpy(cond).to(device).to(dt)
                     ).float().cpu().numpy()
        err = float(np.abs(got - want).max())
        mean_err = float(np.abs(got - want).mean())
        print(f"verify: max|exported - live| = {err:.2e} "
              f"(mean {mean_err:.2e})", flush=True)
        max_tol, mean_tol = ((0.3, 0.03) if args.quant_int8
                             else (5e-2, 5e-2))
        if not np.isfinite(err) or err > max_tol or mean_err > mean_tol:
            raise SystemExit("verification FAILED")
    return out_dir


if __name__ == "__main__":
    main()
