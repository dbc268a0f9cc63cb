"""Network factories keyed by ``--netG`` / ``--netD`` (counterpart of ``pcgan_tpu/models/registry.py:38-137``).

``define_G`` / ``define_D`` / ``define_C`` build the module and draw its
initial weights from an explicit ``torch.Generator`` (seeded from
``--seed`` when none is given). ``--netG`` is ``resnet_{6,9}blocks``,
optionally ``@<variant>`` (any variant but ``deconv`` upsamples by a
resize conv, as in the JAX registry), or ``unet_<size>`` with size a
power of 2. ``--dtype`` sets the modules' dtype (``DTYPES``: bfloat16,
float32 or float16; params stay f32); ``compute_dtype`` gives the step's
and the inputs' dtype, which is f32 for any run that is not bf16, as in
the JAX package (``pcgan_tpu/train.py:265``).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch import nn

from pcgan_tpu_torch.config import Config
from pcgan_tpu_torch.models.comparator import Comparator
from pcgan_tpu_torch.models.discriminator import (MultiScaleDiscriminator,
                                                  NLayerDiscriminator,
                                                  PixelDiscriminator)
from pcgan_tpu_torch.models.generator import ResnetGenerator, UnetGenerator
from pcgan_tpu_torch.models.layers import NORMS, init_weights, make_initializer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def compute_dtype(name: str) -> torch.dtype:
    """The step's compute dtype for ``--dtype name``: bf16 for bfloat16,
    else f32. An f16 run's modules cast per layer (convs in f16, norm
    moments in f32) while its step, its preprocessed images and its
    conditions stay f32; there is no loss scaling."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32

_N_BLOCKS = {"resnet_9blocks": 9, "resnet_6blocks": 6}


def _reject_unported_common(cfg: Config) -> None:
    m = cfg.model
    if m.norm not in NORMS:
        raise NotImplementedError(f"norm [{m.norm}] not implemented")
    if m.dtype not in DTYPES:
        raise ValueError(f"--dtype {m.dtype}: one of {' | '.join(DTYPES)}")


def unet_num_downs(name: str) -> int:
    """``unet_<size>`` -> log2(size); a size that is not a power of 2
    raises."""
    base = name.partition("@")[0]
    size = int(base.split("_")[1])
    if size & (size - 1):
        raise NotImplementedError(f"netG [{name}]: size must be a power of 2")
    return size.bit_length() - 1


def define_G(cfg: Config,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """The generator of ``cfg`` with freshly drawn weights (f32 params on
    the CPU; move it with ``.to(device)``)."""
    m = cfg.model
    base, _, variant = m.netG.partition("@")
    if (base.startswith("resnet") and m.norm == "instance"
            and m.cond_inject == "input"):
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
    if m.remat_blocks != -1 and not m.remat:
        warnings.warn(
            f"--remat_blocks {m.remat_blocks} without --remat is "
            f"INERT (the generator rematerializes nothing); pass --remat "
            f"to make the block dial take effect", RuntimeWarning,
            stacklevel=2)
    _reject_unported_common(cfg)
    kw = dict(input_nc=cfg.data.input_nc, output_nc=cfg.data.output_nc,
              cond_nc=cfg.cond_nc, ngf=m.ngf, norm=m.norm,
              use_dropout=not m.no_dropout, cond_inject=m.cond_inject,
              dtype=DTYPES[m.dtype], quant_trunk=m.quant_int8)
    if base in _N_BLOCKS:
        G = ResnetGenerator(n_blocks=_N_BLOCKS[base], n_remat=_n_remat(cfg),
                            upsample=variant or "deconv",
                            lowch_matmul=m.lowch_matmul, g_attn=m.g_attn,
                            **kw)
    elif base.startswith("unet_"):
        if m.g_attn:
            raise NotImplementedError(
                "--g_attn is a resnet-generator lever (the unet's recursive "
                "skip structure has no single bottleneck trunk to host it); "
                "use --netG resnet_9blocks/resnet_6blocks")
        G = UnetGenerator(num_downs=unet_num_downs(base),
                          n_remat=_n_remat(cfg), **kw)
    else:
        raise NotImplementedError(f"netG [{m.netG}] not implemented")
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    init_weights(G, make_initializer(m.init_type, m.init_gain), generator)
    return G


def _n_remat(cfg: Config) -> int:
    """Resnet blocks, or U-Net levels (the outermost excluded), under
    --remat: all, or the first --remat_blocks."""
    m = cfg.model
    if not m.remat:
        return 0
    base = m.netG.partition("@")[0]
    n = (_N_BLOCKS[base] if base in _N_BLOCKS
         else unet_num_downs(base) - 1)
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
