"""Conditional resnet generator and self-attention (counterpart of
``pcgan_tpu/models/generator.py:51-249``).

ResnetGenerator (``--netG resnet_9blocks|resnet_6blocks``):
  ReflectionPad(3) -> Conv7x7(ngf) -> norm -> ReLU
  -> 2x [Conv3x3 s2 p1 (ngf*2, ngf*4) -> norm -> ReLU]          (downsample)
  -> n_blocks x ResnetBlock(reflect-pad Conv3x3 + norm + ReLU [+ dropout],
                            reflect-pad Conv3x3 + norm, residual add)
  -> 2x [ConvTranspose3x3 s2 p1 op1 -> norm -> ReLU]            (upsample)
  -> ReflectionPad(3) -> Conv7x7(output_nc) -> tanh (in f32)

The age condition (a one-hot over ``n_age_bins``) is broadcast to an HxW map
and channel-concatenated to the input (``cond_inject='input'``) or to the
bottleneck features (``'bottleneck'``, followed by a 1x1 projection back to
the trunk width). ``forward`` takes and returns NHWC, like the JAX module.

``--norm`` is instance, batch, group or none, one norm module per site.
With dropout (``--no-no_dropout``) a training forward draws one keep-mask
per block from an explicit ``torch.Generator``; ``--remat`` recomputes the
first ``--remat_blocks`` blocks in the backward pass.

``quant_trunk`` (``--quant_int8``) runs the trunk convs in int8
(``ops/quant.py``): the down convs, the bottleneck projection, both convs of
every block and the deconvs. Stem and tail stay in the compute dtype, as in
the JAX package (``generator.py:150-154``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pcgan_tpu_torch.models.layers import (Norm, TorchConv, TorchConvTranspose,
                                           conv_bias_before_norm,
                                           frozen_stats, norm_uses_bias)


def broadcast_cond(cond: torch.Tensor, h: int, w: int,
                   dtype=torch.float32) -> torch.Tensor:
    """(N, C_cond) condition vector -> (N, C_cond, H, W) constant map."""
    return cond.to(dtype)[:, :, None, None].expand(-1, -1, h, w)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, norm: str = "instance",
                 use_dropout: bool = False, pad_mode: str = "reflect",
                 dtype=torch.float32, quant: bool = False):
        super().__init__()
        # both convs feed a norm: bias dropped where provably inert
        use_bias = conv_bias_before_norm(norm)
        self.conv0 = TorchConv(dim, dim, 3, 1, 1, pad_mode, use_bias, dtype,
                               quant)
        self.norm0 = Norm(norm, dim)
        self.conv1 = TorchConv(dim, dim, 3, 1, 1, pad_mode, use_bias, dtype,
                               quant)
        self.norm1 = Norm(norm, dim)
        self.use_dropout = use_dropout

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: the dropout mask (bool, x's shape) of a training
        forward, drawn by the caller (flax ``nn.Dropout(0.5)``: kept
        entries are scaled by 2)."""
        h = F.relu(self.norm0(self.conv0(x)))
        if keep is not None:
            h = torch.where(keep, h / 0.5, torch.zeros_like(h))
        h = self.norm1(self.conv1(h))
        return x + h


class SelfAttention(nn.Module):
    """SAGAN self-attention (``pcgan_tpu/models/generator.py:79-131``), on
    NCHW: 1x1 projections theta/phi/g (no bias), key and value max-pooled
    2x, softmax over the keys in f32, the output projection o, and ``x +
    gamma * o`` with gamma starting at 0 (the identity at init). The two
    products are explicit matmuls, as in JAX. ``spectral_norm`` puts each
    projection under spectral norm (``--d_attn --spectral_norm``)."""

    def __init__(self, dim: int, dtype=torch.float32,
                 spectral_norm: bool = False):
        super().__init__()
        k8, k2 = max(dim // 8, 1), max(dim // 2, 1)
        kw = dict(use_bias=False, dtype=dtype, spectral_norm=spectral_norm)
        self.theta = TorchConv(dim, k8, 1, **kw)
        self.phi = TorchConv(dim, k8, 1, **kw)
        self.g = TorchConv(dim, k2, 1, **kw)
        self.o = TorchConv(k2, dim, 1, **kw)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        if h % 2 or w % 2:
            raise ValueError(f"SelfAttention needs even spatial dims for the "
                             f"pooled key/value branches, got {h}x{w}")
        q = self.theta(x).flatten(2).transpose(1, 2)          # (n, hw, k8)
        k = F.max_pool2d(self.phi(x), 2, 2).flatten(2)        # (n, k8, hw/4)
        v = F.max_pool2d(self.g(x), 2, 2).flatten(2)         # (n, k2, hw/4)
        attn = torch.softmax(torch.bmm(q, k).float(), dim=-1).to(x.dtype)
        o = torch.bmm(attn, v.transpose(1, 2))               # (n, hw, k2)
        o = self.o(o.transpose(1, 2).reshape(n, -1, h, w))
        return x + self.gamma.to(x.dtype) * o


class ResnetGenerator(nn.Module):
    def __init__(self, input_nc: int = 3, output_nc: int = 3,
                 cond_nc: int = 10, ngf: int = 64, n_blocks: int = 9,
                 n_downsampling: int = 2, norm: str = "instance",
                 use_dropout: bool = False, cond_inject: str = "input",
                 dtype=torch.float32, quant_trunk: bool = False,
                 n_remat: int = 0):
        super().__init__()
        if cond_inject not in ("input", "bottleneck"):
            # loud: a typo here must not silently build an UNCONDITIONAL G
            raise NotImplementedError(
                f"cond_inject [{cond_inject}] (want input | bottleneck)")
        self.cond_inject = cond_inject
        self.use_dropout = use_dropout
        # --remat: the first n_remat blocks recompute their activations in
        # the backward pass (torch.utils.checkpoint); names are unchanged,
        # so checkpoints cross-load with and without it
        self.n_remat = n_remat
        # convs feeding a norm drop their bias when the norm makes it inert
        norm_bias = conv_bias_before_norm(norm)
        stem_in = input_nc + (cond_nc if cond_inject == "input" else 0)
        self.stem = TorchConv(stem_in, ngf, 7, 1, 3, "reflect", norm_bias,
                              dtype)
        self.stem_norm = Norm(norm, ngf)
        self.down = nn.ModuleList(
            TorchConv(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, 2, 1, "zero",
                      norm_bias, dtype, quant_trunk)
            for i in range(n_downsampling))
        self.down_norm = nn.ModuleList(Norm(norm, ngf * 2 ** (i + 1))
                                       for i in range(n_downsampling))
        trunk = ngf * 2 ** n_downsampling
        # project back to the trunk width so blocks stay residual (no norm
        # follows -> bias stays live)
        self.cond_proj = (
            TorchConv(trunk + cond_nc, trunk, 1, 1, 0, "zero",
                      norm_uses_bias(norm), dtype, quant_trunk)
            if cond_inject == "bottleneck" else None)
        self.blocks = nn.ModuleList(
            ResnetBlock(trunk, norm, use_dropout, dtype=dtype,
                        quant=quant_trunk)
            for _ in range(n_blocks))
        ups = [ngf * 2 ** (n_downsampling - i) // 2
               for i in range(n_downsampling)]
        self.up = nn.ModuleList(
            TorchConvTranspose(2 * f, f, 3, 2, 1, 1, norm_bias, dtype,
                               quant_trunk) for f in ups)
        self.up_norm = nn.ModuleList(Norm(norm, f) for f in ups)
        self.tail = TorchConv(ngf, output_nc, 7, 1, 3, "reflect", True, dtype)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (N,H,W,input_nc) in [-1,1]; cond: (N,cond_nc).
        Returns (N,H,W,output_nc) f32. A training forward of a G with
        dropout draws one keep-mask (p = 0.5) per block, in block order,
        from ``generator`` (on x's device)."""
        dropout = self.use_dropout and self.training
        if dropout and generator is None:
            raise ValueError("a training forward with dropout needs the "
                             "train state's generator")
        h = x.permute(0, 3, 1, 2)
        if self.cond_inject == "input":
            h = torch.cat([h, broadcast_cond(cond, h.shape[2], h.shape[3],
                                             h.dtype)], 1)
        h = F.relu(self.stem_norm(self.stem(h)))
        for conv, norm in zip(self.down, self.down_norm):
            h = F.relu(norm(conv(h)))
        if self.cond_proj is not None:
            h = torch.cat([h, broadcast_cond(cond, h.shape[2], h.shape[3],
                                             h.dtype)], 1)
            h = self.cond_proj(h)
        remat = self.training and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            keep = (torch.rand(h.shape, generator=generator,
                               device=h.device) < 0.5) if dropout else None
            if remat and i < self.n_remat:
                # the recompute in the backward pass must not move the norm
                # state a second time; the mask is an input, so it replays
                h = checkpoint(block, h, keep, use_reentrant=False,
                               context_fn=_recompute_frozen(block))
            else:
                h = block(h, keep)
        for deconv, norm in zip(self.up, self.up_norm):
            h = F.relu(norm(deconv(h)))
        h = self.tail(h)
        return torch.tanh(h.float()).permute(0, 2, 3, 1)


def _recompute_frozen(block: nn.Module):
    return lambda: (contextlib.nullcontext(), frozen_stats(block))
