"""Conditional resnet generator (counterpart of ``pcgan_tpu/models/generator.py:51-76, 134-249``).

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

``quant_trunk`` (``--quant_int8``) runs the trunk convs in int8
(``ops/quant.py``): the down convs, the bottleneck projection, both convs of
every block and the deconvs. Stem and tail stay in the compute dtype, as in
the JAX package (``generator.py:150-154``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pcgan_tpu_torch.models.layers import (Norm, TorchConv, TorchConvTranspose,
                                           conv_bias_before_norm,
                                           norm_uses_bias)


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
        self.conv1 = TorchConv(dim, dim, 3, 1, 1, pad_mode, use_bias, dtype,
                               quant)
        self.norm = Norm(norm)
        self.dropout = nn.Dropout(0.5) if use_dropout else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.norm(self.conv0(x)))
        h = self.dropout(h)
        h = self.norm(self.conv1(h))
        return x + h


class ResnetGenerator(nn.Module):
    def __init__(self, input_nc: int = 3, output_nc: int = 3,
                 cond_nc: int = 10, ngf: int = 64, n_blocks: int = 9,
                 n_downsampling: int = 2, norm: str = "instance",
                 use_dropout: bool = False, cond_inject: str = "input",
                 dtype=torch.float32, quant_trunk: bool = False):
        super().__init__()
        if cond_inject not in ("input", "bottleneck"):
            # loud: a typo here must not silently build an UNCONDITIONAL G
            raise NotImplementedError(
                f"cond_inject [{cond_inject}] (want input | bottleneck)")
        self.cond_inject = cond_inject
        # convs feeding a norm drop their bias when the norm makes it inert
        norm_bias = conv_bias_before_norm(norm)
        self.norm = Norm(norm)
        stem_in = input_nc + (cond_nc if cond_inject == "input" else 0)
        self.stem = TorchConv(stem_in, ngf, 7, 1, 3, "reflect", norm_bias,
                              dtype)
        self.down = nn.ModuleList(
            TorchConv(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, 2, 1, "zero",
                      norm_bias, dtype, quant_trunk)
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
        self.up = nn.ModuleList(
            TorchConvTranspose(ngf * 2 ** (n_downsampling - i),
                               ngf * 2 ** (n_downsampling - i) // 2, 3, 2, 1,
                               1, norm_bias, dtype, quant_trunk)
            for i in range(n_downsampling))
        self.tail = TorchConv(ngf, output_nc, 7, 1, 3, "reflect", True, dtype)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """x: (N,H,W,input_nc) in [-1,1]; cond: (N,cond_nc).
        Returns (N,H,W,output_nc) f32."""
        h = x.permute(0, 3, 1, 2)
        if self.cond_inject == "input":
            h = torch.cat([h, broadcast_cond(cond, h.shape[2], h.shape[3],
                                             h.dtype)], 1)
        h = F.relu(self.norm(self.stem(h)))
        for conv in self.down:
            h = F.relu(self.norm(conv(h)))
        if self.cond_proj is not None:
            h = torch.cat([h, broadcast_cond(cond, h.shape[2], h.shape[3],
                                             h.dtype)], 1)
            h = self.cond_proj(h)
        for block in self.blocks:
            h = block(h)
        for deconv in self.up:
            h = F.relu(self.norm(deconv(h)))
        h = self.tail(h)
        return torch.tanh(h.float()).permute(0, 2, 3, 1)
