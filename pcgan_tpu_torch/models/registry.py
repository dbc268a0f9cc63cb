"""Network factory keyed by ``--netG`` (counterpart of ``pcgan_tpu/models/registry.py:38-104``).

``define_G`` builds the module and draws its initial weights from an
explicit ``torch.Generator`` (seeded from ``--seed`` when none is given).
Flags this port does not implement yet raise ``NotImplementedError``.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from pcgan_tpu_torch.config import Config
from pcgan_tpu_torch.models.discriminator import NLayerDiscriminator
from pcgan_tpu_torch.models.generator import ResnetGenerator
from pcgan_tpu_torch.models.layers import init_weights, make_initializer

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
    for flag, on in (("--g_attn", m.g_attn), ("--quant_int8", m.quant_int8)):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported to pcgan_tpu_torch yet")
    _reject_unported_common(cfg)


def _reject_unported_common(cfg: Config) -> None:
    m = cfg.model
    if m.cond_mode != "onehot":
        raise NotImplementedError(
            f"--cond_mode {m.cond_mode} is not ported to pcgan_tpu_torch yet "
            f"(onehot only)")
    if m.norm not in ("instance", "none"):
        raise NotImplementedError(
            f"--norm {m.norm} is not ported to pcgan_tpu_torch yet "
            f"(instance | none)")
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
        cond_inject=cfg.model.cond_inject, dtype=DTYPES[cfg.model.dtype])
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    init_weights(G, make_initializer(cfg.model.init_type,
                                     cfg.model.init_gain), generator)
    return G


def define_D(cfg: Config,
             generator: Optional[torch.Generator] = None
             ) -> NLayerDiscriminator:
    """The PatchGAN discriminator of ``cfg`` (``--netD basic|n_layers``)
    with freshly drawn weights (f32 params on the CPU)."""
    m = cfg.model
    if m.netD not in ("basic", "n_layers"):
        raise NotImplementedError(
            f"--netD {m.netD} is not ported to pcgan_tpu_torch yet "
            f"(basic | n_layers)")
    for flag, on in (("--spectral_norm", m.spectral_norm),
                     ("--d_attn", m.d_attn)):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported to pcgan_tpu_torch yet")
    _reject_unported_common(cfg)
    D = NLayerDiscriminator(
        input_nc=cfg.data.input_nc, cond_nc=cfg.cond_nc, ndf=m.ndf,
        n_layers=3 if m.netD == "basic" else m.n_layers_D, norm=m.norm,
        dtype=DTYPES[m.dtype])
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed + 1)
    init_weights(D, make_initializer(m.init_type, m.init_gain), generator)
    return D
