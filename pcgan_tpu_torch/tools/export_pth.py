"""Export a trained G of the port to a reference-layout PyTorch ``.pth``
(counterpart of ``tools/export_pth.py``, the inverse of ``import_pth``).

    python -m pcgan_tpu_torch.tools.export_pth --name run1 \\
        --checkpoints_dir ./checkpoints --out latest_net_G.pth

Reads ``{tag}_G.pt`` (``--use_ema``: ``{tag}_G_ema.pt``). The output's
names come from a TEMPLATE state_dict, so the code that made the template
loads it: ``--like your_reference.pth`` clones a reference's names,
otherwise the pix2pix-layout mirror in ``utils/pth_mirror.py`` gives them
(input injection and instance or batch norm for the resnet G, input
injection and instance norm for the U-Net). Architecture flags default to
the run's ``opt.json``. The file is a plain tensor state_dict
(``torch.load(..., weights_only=True)`` reads it).
"""

from __future__ import annotations

import argparse
import os


def build_mirror_state_dict(netG: str, in_nc: int, out_nc: int, ngf: int,
                            norm: str, cond_inject: str = "input",
                            cond_nc: int = 0):
    """Template names from the mirror (pix2pix-family layout). ``in_nc``
    is the STEM's input channels (the condition's included only under
    input injection); bottleneck injection adds the 1x1 projection."""
    from pcgan_tpu_torch.utils.pth_mirror import ResnetG, build_unet
    base = netG.partition("@")[0]
    if base in ("resnet_9blocks", "resnet_6blocks"):
        n_blocks = 9 if base.endswith("9blocks") else 6
        return ResnetG(in_nc, out_nc, ngf=ngf, n_blocks=n_blocks,
                       batchnorm=(norm == "batch"), cond_nc=cond_nc,
                       cond_inject=cond_inject).state_dict()
    if base.startswith("unet_"):
        if cond_inject != "input":
            raise NotImplementedError(
                "the unet mirror supports input injection only; pass a "
                "matching checkpoint via --like for cond_inject=bottleneck "
                "unet export")
        if norm == "batch":
            raise NotImplementedError(
                "the unet mirror is instance-norm only; pass a reference "
                "checkpoint via --like for batchnorm unet export")
        size = int(base.split("_")[1])
        return build_unet(in_nc, out_nc, num_downs=size.bit_length() - 1,
                          ngf=ngf).state_dict()
    raise NotImplementedError(f"no torch mirror for netG [{netG}]")


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--name", required=True)
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--tag", default="latest")
    p.add_argument("--use_ema", action="store_true",
                   help="export the EMA twin ({tag}_G_ema)")
    p.add_argument("--out", default=None,
                   help="output path (default <ckpt_dir>/<name>/"
                        "<tag>_net_G[_ema].pth)")
    p.add_argument("--like", default=None,
                   help="reference .pth whose names/layout to clone "
                        "(default: the mirror in utils/pth_mirror.py)")
    # explicit > the run's opt.json > training default
    p.add_argument("--netG", default=None)
    p.add_argument("--ngf", type=int, default=None)
    p.add_argument("--norm", default=None)
    p.add_argument("--cond_inject", default=None)
    p.add_argument("--cond_mode", default=None, choices=["onehot", "score"])
    p.add_argument("--crop_size", type=int, default=None)
    p.add_argument("--n_age_bins", type=int, default=None)
    p.add_argument("--input_nc", type=int, default=None)
    p.add_argument("--output_nc", type=int, default=None)
    p.add_argument("--allow_pickle", action="store_true",
                   help="permit weights_only=False torch.load for a "
                        "full-module --like file — EXECUTES pickled code "
                        "from it; only for files you trust")
    args = p.parse_args(argv)

    from pcgan_tpu_torch.config import load_run_opt, opt_value
    opt = load_run_opt(args.checkpoints_dir, args.name)

    def arch(flag, section, hard):
        v = getattr(args, flag)
        return v if v is not None else opt_value(opt, section, flag, hard)

    args.netG = arch("netG", "model", "resnet_9blocks")
    args.ngf = arch("ngf", "model", 64)
    args.norm = arch("norm", "model", "instance")
    args.cond_inject = arch("cond_inject", "model", "input")
    args.cond_mode = arch("cond_mode", "model", "onehot")
    args.crop_size = arch("crop_size", "data", 128)
    args.n_age_bins = arch("n_age_bins", "data", 10)
    args.input_nc = arch("input_nc", "data", 3)
    args.output_nc = arch("output_nc", "data", 3)
    if opt is not None:
        print("config: architecture defaults from the run's opt.json "
              "(explicit flags override)", flush=True)

    import numpy as np
    import torch
    from pcgan_tpu_torch.config import Config, DataConfig, ModelConfig
    from pcgan_tpu_torch.models import define_G
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    from pcgan_tpu_torch.utils.pth import load_pth
    from pcgan_tpu_torch.utils.pth_export import export_generator_pth

    cfg = Config(
        data=DataConfig(crop_size=args.crop_size, n_age_bins=args.n_age_bins,
                        input_nc=args.input_nc, output_nc=args.output_nc),
        model=ModelConfig(netG=args.netG, ngf=args.ngf, norm=args.norm,
                          cond_inject=args.cond_inject,
                          cond_mode=args.cond_mode, dtype="float32"))
    G = ckpt.restore_generator(define_G(cfg, torch.Generator().manual_seed(0)),
                               args.checkpoints_dir, args.name, args.tag,
                               use_ema=args.use_ema)
    if args.like:
        tmpl = load_pth(args.like, allow_pickle=args.allow_pickle)
    else:
        stem_nc = args.input_nc + (cfg.cond_nc
                                   if args.cond_inject == "input" else 0)
        tmpl = build_mirror_state_dict(
            args.netG, stem_nc, args.output_nc, args.ngf, args.norm,
            cond_inject=args.cond_inject, cond_nc=cfg.cond_nc)
    sd = export_generator_pth(G.state_dict(), args.netG, tmpl,
                              cond_inject=args.cond_inject)
    out_path = args.out
    if out_path is None:
        suffix = "_net_G_ema.pth" if args.use_ema else "_net_G.pth"
        out_path = os.path.join(args.checkpoints_dir, args.name,
                                f"{args.tag}{suffix}")
    torch.save({k: torch.from_numpy(np.array(v, copy=True))
                for k, v in sd.items()}, out_path)
    print(f"exported {args.name}/{args.tag}"
          f"{'_G_ema' if args.use_ema else '_G'} -> {out_path} "
          f"({len(sd)} tensors)", flush=True)
    return out_path


if __name__ == "__main__":
    main()
