"""Network factories keyed by ``--netG`` / ``--netD`` (counterpart of ``pcgan_tpu/models/registry.py:38-137``).

``define_G`` / ``define_D`` / ``define_C`` build the module and draw its
initial weights from an explicit ``torch.Generator`` (seeded from
``--seed`` when none is given). The generator variants this port does
not implement yet (``unet_*``, ``resize_conv``, ``--g_attn``) raise
``NotImplementedError``.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from pcgan_tpu_torch.config import Config
from pcgan_tpu_torch.models.comparator import Comparator
from pcgan_tpu_torch.models.discriminator import (MultiScaleDiscriminator,
                                                  NLayerDiscriminator,
                                                  PixelDiscriminator)
from pcgan_tpu_torch.models.generator import ResnetGenerator
from pcgan_tpu_torch.models.layers import NORMS, init_weights, make_initializer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

_N_BLOCKS = {"resnet_9blocks": 9, "resnet_6blocks": 6}


def _reject_unported(cfg: Config) -> None:
    m = cfg.model
    name = m.netG
    if "@" in name or name.startswith("unet_"):
        raise NotImplementedError(
            f"--netG {name} is not ported to pcgan_tpu_torch yet "
            f"(resnet_9blocks | resnet_6blocks with deconv upsampling)")
    if name not in _N_BLOCKS:
        raise NotImplementedError(f"netG [{name}] not implemented")
    if m.g_attn:
        raise NotImplementedError(
            "--g_attn is not ported to pcgan_tpu_torch yet")
    _reject_unported_common(cfg)


def _reject_unported_common(cfg: Config) -> None:
    m = cfg.model
    if m.norm not in NORMS:
        raise NotImplementedError(f"norm [{m.norm}] not implemented")
    if m.dtype not in DTYPES:
        raise NotImplementedError(
            f"--dtype {m.dtype} is not ported to pcgan_tpu_torch yet "
            f"({' | '.join(DTYPES)})")


def define_G(cfg: Config,
             generator: Optional[torch.Generator] = None) -> ResnetGenerator:
    """The generator of ``cfg`` with freshly drawn weights (f32 params on
    the CPU; move it with ``.to(device)``)."""
    if (cfg.model.netG.startswith("resnet") and cfg.model.norm == "instance"
            and cfg.model.cond_inject == "input"):
        # the stem conv of a spatially-constant condition map (full
        # stride-1 reflect padding) is constant, and the instance norm
        # that follows subtracts exactly that constant: the JAX package
        # measures ~3e-6 between conditions in f32
        warnings.warn(
            "resnet generator + instance norm + cond_inject='input': the "
            "condition is mathematically cancelled by the stem's instance "
            "norm — G trains (reference-faithfully) UNCONDITIONAL. Use "
            "--cond_inject bottleneck (or --netG unet_*) for an effective "
            "conditional resnet G.", RuntimeWarning, stacklevel=2)
    if cfg.model.remat_blocks != -1 and not cfg.model.remat:
        warnings.warn(
            f"--remat_blocks {cfg.model.remat_blocks} without --remat is "
            f"INERT (the generator rematerializes nothing); pass --remat "
            f"to make the block dial take effect", RuntimeWarning,
            stacklevel=2)
    _reject_unported(cfg)
    G = ResnetGenerator(
        input_nc=cfg.data.input_nc, output_nc=cfg.data.output_nc,
        cond_nc=cfg.cond_nc, ngf=cfg.model.ngf,
        n_blocks=_N_BLOCKS[cfg.model.netG], norm=cfg.model.norm,
        use_dropout=not cfg.model.no_dropout,
        cond_inject=cfg.model.cond_inject, dtype=DTYPES[cfg.model.dtype],
        quant_trunk=cfg.model.quant_int8, n_remat=_n_remat(cfg))
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    init_weights(G, make_initializer(cfg.model.init_type,
                                     cfg.model.init_gain), generator)
    return G


def _n_remat(cfg: Config) -> int:
    """Blocks under --remat: all, or the first --remat_blocks."""
    m = cfg.model
    if not m.remat:
        return 0
    n = _N_BLOCKS[m.netG]
    return n if m.remat_blocks < 0 else min(m.remat_blocks, n)


def define_D(cfg: Config, generator: Optional[torch.Generator] = None):
    """The discriminator of ``cfg`` (``--netD basic | n_layers | pixel |
    multiscale``, ``--spectral_norm``, ``--d_attn``) with freshly drawn
    weights (f32 params on the CPU)."""
    m = cfg.model
    _reject_unported_common(cfg)
    kw = dict(input_nc=cfg.data.input_nc, cond_nc=cfg.cond_nc, ndf=m.ndf,
              norm=m.norm, dtype=DTYPES[m.dtype],
              spectral_norm=m.spectral_norm)
    if m.netD == "pixel":
        if m.d_attn:
            raise NotImplementedError(
                "--d_attn is a PatchGAN lever (the pixel D is a stack of 1x1 "
                "convs with no spatial stack to attend over); use --netD "
                "basic/n_layers/multiscale")
        D = PixelDiscriminator(**kw)
    elif m.netD in ("basic", "n_layers"):
        D = NLayerDiscriminator(
            n_layers=3 if m.netD == "basic" else m.n_layers_D,
            d_attn=m.d_attn, **kw)
    elif m.netD == "multiscale":
        if m.num_D < 1:
            raise NotImplementedError(f"--num_D {m.num_D}: need >= 1")
        D = MultiScaleDiscriminator(n_layers=m.n_layers_D, num_D=m.num_D,
                                    d_attn=m.d_attn, **kw)
    else:
        raise NotImplementedError(f"netD [{m.netD}] not implemented")
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed + 1)
    init_weights(D, make_initializer(m.init_type, m.init_gain), generator)
    return D


def define_C(cfg: Config,
             generator: Optional[torch.Generator] = None) -> Comparator:
    """The pairwise comparator of ``cfg`` (``--cmp_nf``, ``--cmp_n_down``,
    ``--norm``, ``--dtype``) with freshly drawn weights (f32 params on the
    CPU)."""
    _reject_unported_common(cfg)
    m = cfg.model
    C = Comparator(input_nc=cfg.data.input_nc, nf=m.cmp_nf,
                   n_down=m.cmp_n_down, norm=m.norm, dtype=DTYPES[m.dtype])
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    init_weights(C, make_initializer(m.init_type, m.init_gain), generator)
    return C
