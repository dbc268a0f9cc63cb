"""Conditional PatchGAN discriminator (counterpart of ``pcgan_tpu/models/discriminator.py:55-122``).

NLayerDiscriminator (``--netD basic|n_layers``, the 70x70-receptive-field
PatchGAN at n_layers=3):
  Conv4x4 s2 p1 ndf -> LeakyReLU(0.2)
  -> (n_layers-1) x [Conv4x4 s2 p1 -> norm -> LeakyReLU(0.2)]  (cap 8*ndf)
  -> Conv4x4 s1 p1 -> norm -> LeakyReLU(0.2)
  -> Conv4x4 s1 p1 -> 1 channel   (patch logits, no sigmoid)

The age condition map is channel-concatenated to the input image. Convs
that feed a norm carry no bias when the norm removes a per-channel constant
(``conv_bias_before_norm``), as in the JAX module. ``forward`` takes NHWC
and returns NHWC f32 logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pcgan_tpu_torch.models.generator import broadcast_cond
from pcgan_tpu_torch.models.layers import Norm, TorchConv, conv_bias_before_norm


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, cond_nc: int = 10, ndf: int = 64,
                 n_layers: int = 3, norm: str = "instance",
                 dtype=torch.float32):
        super().__init__()
        use_bias = conv_bias_before_norm(norm)
        self.norm = Norm(norm)
        convs = [TorchConv(input_nc + cond_nc, ndf, 4, 2, 1, use_bias=True,
                           dtype=dtype)]
        nf = ndf
        for n in range(1, n_layers):
            nf_next = ndf * min(2 ** n, 8)
            convs.append(TorchConv(nf, nf_next, 4, 2, 1, use_bias=use_bias,
                                   dtype=dtype))
            nf = nf_next
        nf_next = ndf * min(2 ** n_layers, 8)
        convs.append(TorchConv(nf, nf_next, 4, 1, 1, use_bias=use_bias,
                               dtype=dtype))
        convs.append(TorchConv(nf_next, 1, 4, 1, 1, use_bias=True,
                               dtype=dtype))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """x: (N,H,W,C); cond: (N,cond_nc). Returns (N,h,w,1) f32 logits."""
        h = x.permute(0, 3, 1, 2)
        h = torch.cat([h, broadcast_cond(cond, h.shape[2], h.shape[3],
                                         h.dtype)], 1)
        h = F.leaky_relu(self.convs[0](h), 0.2)
        for conv in self.convs[1:-1]:
            h = F.leaky_relu(self.norm(conv(h)), 0.2)
        return self.convs[-1](h).float().permute(0, 2, 3, 1)
