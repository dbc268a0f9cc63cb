"""Convert a reference PyTorch generator ``.pth`` into the port's G-only
checkpoint (counterpart of ``tools/import_pth.py``).

    python -m pcgan_tpu_torch.tools.import_pth --pth latest_net_G.pth \\
        --netG resnet_9blocks --name imported --checkpoints_dir ./checkpoints \\
        --crop_size 128 --n_age_bins 10

Writes ``{checkpoints_dir}/{name}/{tag}_G.pt``
(``utils/checkpoint.py save_generator``): ``python -m
pcgan_tpu_torch.test --name imported`` samples from it and ``python -m
pcgan_tpu_torch.train_main --init_g_from imported/latest`` fine-tunes from
it (fresh D and optimizers). The file is read with ``weights_only=True``
unless ``--allow_pickle``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pth", required=True)
    p.add_argument("--netG", default="resnet_9blocks")
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--norm", default="instance")
    p.add_argument("--cond_inject", default="input")
    p.add_argument("--crop_size", type=int, default=128)
    p.add_argument("--n_age_bins", type=int, default=10)
    p.add_argument("--input_nc", type=int, default=3)
    p.add_argument("--output_nc", type=int, default=3)
    p.add_argument("--name", default="imported")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--tag", default="latest")
    p.add_argument("--allow_pickle", action="store_true",
                   help="permit weights_only=False torch.load fallback for "
                        "full-module saves — EXECUTES pickled code from the "
                        "file; only for checkpoints you trust")
    args = p.parse_args(argv)

    import torch
    from pcgan_tpu_torch.config import Config, DataConfig, ModelConfig
    from pcgan_tpu_torch.models import define_G
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    from pcgan_tpu_torch.utils.pth import load_pth
    from pcgan_tpu_torch.utils.pth_import import import_generator_pth

    cfg = Config(
        data=DataConfig(crop_size=args.crop_size, n_age_bins=args.n_age_bins,
                        input_nc=args.input_nc, output_nc=args.output_nc),
        model=ModelConfig(netG=args.netG, ngf=args.ngf, norm=args.norm,
                          cond_inject=args.cond_inject, dtype="float32"))
    G = define_G(cfg, torch.Generator().manual_seed(0))
    sd = load_pth(args.pth, allow_pickle=args.allow_pickle)
    G.load_state_dict(import_generator_pth(sd, G.state_dict(), args.netG,
                                           args.cond_inject), strict=True)
    path = ckpt.save_generator(G, args.checkpoints_dir, args.name, args.tag)
    print(f"imported {args.pth} -> {path}")
    print(f"sample with: python -m pcgan_tpu_torch.test --name {args.name} "
          f"--checkpoints_dir {args.checkpoints_dir} --netG {args.netG} "
          f"--ngf {args.ngf} --norm {args.norm} --cond_inject "
          f"{args.cond_inject} --crop_size {args.crop_size} --n_age_bins "
          f"{args.n_age_bins}")
    return path


if __name__ == "__main__":
    main()
