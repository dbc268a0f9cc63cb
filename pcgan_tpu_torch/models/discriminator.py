"""Conditional discriminators (counterpart of ``pcgan_tpu/models/discriminator.py:55-220``).

NLayerDiscriminator (``--netD basic|n_layers``, the 70x70-receptive-field
PatchGAN at n_layers=3):
  Conv4x4 s2 p1 ndf -> LeakyReLU(0.2)
  -> (n_layers-1) x [Conv4x4 s2 p1 -> norm -> LeakyReLU(0.2)]  (cap 8*ndf)
  [-> SelfAttention with --d_attn]
  -> Conv4x4 s1 p1 -> norm -> LeakyReLU(0.2)
  -> Conv4x4 s1 p1 -> 1 channel   (patch logits, no sigmoid)

MultiScaleDiscriminator (``--netD multiscale``): ``num_D`` PatchGANs
``D_0..D_{num_D-1}``, D_k scoring the 2^k-mean-pooled view of the
condition-concatenated input; returns a tuple of patch maps, finest first.
PixelDiscriminator (``--netD pixel``): a 1x1-conv per-pixel classifier.

The age condition map is channel-concatenated to the input image. Convs
that feed a norm carry no bias when the norm removes a per-channel constant
(``conv_bias_before_norm``), as in the JAX modules. ``spectral_norm`` puts
every conv (and the attention projections) under spectral norm, whose
``u``/``sigma`` are buffers (the JAX ``batch_stats``). ``forward`` takes
NHWC and returns NHWC f32 logits; ``return_features=True`` also returns
the post-activation map of every pre-logit block, shallowest first
(n_layers+1 maps; the attention block is not a tap), for ``--lambda_feat``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pcgan_tpu_torch.models.generator import SelfAttention, broadcast_cond
from pcgan_tpu_torch.models.layers import Norm, TorchConv, conv_bias_before_norm
from pcgan_tpu_torch.parallel import spatial


def _nhwc(h: torch.Tensor) -> torch.Tensor:
    return h.permute(0, 2, 3, 1)


def _with_cond(x: torch.Tensor, cond) -> torch.Tensor:
    """NHWC x (+ the broadcast condition) -> NCHW."""
    h = x.permute(0, 3, 1, 2)
    if cond is None:
        return h
    return torch.cat([h, broadcast_cond(cond, h.shape[2], h.shape[3],
                                        h.dtype)], 1)


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, cond_nc: int = 10, ndf: int = 64,
                 n_layers: int = 3, norm: str = "instance",
                 dtype=torch.float32, spectral_norm: bool = False,
                 d_attn: bool = False):
        super().__init__()
        self.n_layers = n_layers
        use_bias = conv_bias_before_norm(norm)
        sn = dict(dtype=dtype, spectral_norm=spectral_norm)
        convs = [TorchConv(input_nc + cond_nc, ndf, 4, 2, 1, use_bias=True,
                           **sn)]
        norms = []
        nf = ndf
        for n in range(1, n_layers):
            nf_next = ndf * min(2 ** n, 8)
            convs.append(TorchConv(nf, nf_next, 4, 2, 1, use_bias=use_bias,
                                   **sn))
            norms.append(Norm(norm, nf_next))
            nf = nf_next
        # --d_attn: between the strided stack and the stride-1 head
        self.attn = (SelfAttention(nf, dtype=dtype,
                                   spectral_norm=spectral_norm)
                     if d_attn else None)
        nf_next = ndf * min(2 ** n_layers, 8)
        convs.append(TorchConv(nf, nf_next, 4, 1, 1, use_bias=use_bias, **sn))
        norms.append(Norm(norm, nf_next))
        convs.append(TorchConv(nf_next, 1, 4, 1, 1, use_bias=True, **sn))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)

    def patch_size(self, size: int) -> int:
        """The side of the patch map for an input of side ``size``."""
        for _ in range(self.n_layers):
            size = (size - 2) // 2 + 1          # k4 s2 p1
        return size - 2                          # two k4 s1 p1

    def feature_sizes(self, size: int) -> tuple:
        """The side of each feature tap (``return_features``) for an input
        of side ``size``, shallowest first."""
        out = []
        for conv in self.convs[:-1]:
            size = conv.out_size(size)
            out.append(size)
        return tuple(out)

    def trunk(self, h: torch.Tensor, H: Optional[int] = None):
        """NCHW (condition already concatenated) -> (NCHW f32 logits, the
        NHWC feature taps). ``H``: h's global height where h is a band of
        it (``parallel/spatial.py``)."""
        feats = []
        h = F.leaky_relu(self.convs[0](h, H=H), 0.2)
        H = None if H is None else self.convs[0].out_size(H)
        feats.append(h)
        for i in range(1, self.n_layers):
            h = F.leaky_relu(self.norms[i - 1](self.convs[i](h, H=H)), 0.2)
            H = None if H is None else self.convs[i].out_size(H)
            feats.append(h)
        if self.attn is not None:
            h = self.attn(h, H)
        h = F.leaky_relu(self.norms[-1](self.convs[-2](h, H=H)), 0.2)
        H = None if H is None else self.convs[-2].out_size(H)
        feats.append(h)
        return (self.convs[-1](h, H=H).float(),
                tuple(_nhwc(f) for f in feats))

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                return_features: bool = False):
        """x: (N,H,W,C); cond: (N,cond_nc). Returns (N,h,w,1) f32 logits
        (and the feature taps); inside ``spatial.banded`` x and the logits
        are this rank's bands."""
        out, feats = self.trunk(_with_cond(x, cond),
                                spatial.global_h(x.shape[1]))
        out = _nhwc(out)
        return (out, feats) if return_features else out


class MultiScaleDiscriminator(nn.Module):
    """pix2pixHD-style multi-scale PatchGAN: ``D_k`` scores the input after
    k exact 2x2/stride-2 mean pools (the condition is concatenated once, at
    full resolution; VALID, as ``nn.avg_pool``: an odd side drops its last
    row). A scale whose patch map would be empty raises. Inside
    ``spatial.banded`` each pool is a window over the bands
    (``spatial.pool2``), each ``D_k`` runs on the band of its scale's
    global height, and each scale's logits are a band."""

    def __init__(self, input_nc: int = 3, cond_nc: int = 10, ndf: int = 64,
                 n_layers: int = 3, num_D: int = 2, norm: str = "instance",
                 dtype=torch.float32, spectral_norm: bool = False,
                 d_attn: bool = False):
        super().__init__()
        self.num_D = num_D
        for k in range(num_D):
            self.add_module(f"D_{k}", NLayerDiscriminator(
                input_nc + cond_nc, 0, ndf, n_layers, norm, dtype,
                spectral_norm, d_attn))

    def patch_size(self, size: int) -> tuple:
        """The side of each scale's patch map for an input of side
        ``size``, finest first."""
        out = []
        for k in range(self.num_D):
            if k:
                size = spatial.conv_out(size, 2, 2, 0)
            out.append(getattr(self, f"D_{k}").patch_size(size))
        return tuple(out)

    def feature_sizes(self, size: int) -> tuple:
        """Each scale's ``NLayerDiscriminator.feature_sizes``, finest
        first."""
        out = []
        for k in range(self.num_D):
            if k:
                size = spatial.conv_out(size, 2, 2, 0)
            out.append(getattr(self, f"D_{k}").feature_sizes(size))
        return tuple(out)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                return_features: bool = False):
        h = _with_cond(x, cond)
        H = spatial.global_h(h.shape[2])
        outs, all_feats = [], []
        for k in range(self.num_D):
            if k:
                h = spatial.pool2(h, H, "avg")
                H = spatial.conv_out(H, 2, 2, 0)
            d = getattr(self, f"D_{k}")
            ph, pw = d.patch_size(H), d.patch_size(h.shape[3])
            if ph < 1 or pw < 1:
                raise ValueError(
                    f"--netD multiscale: D_{k} (input {H}x"
                    f"{h.shape[3]} after {k} 2x pools) produces an empty "
                    f"{max(ph, 0)}x{max(pw, 0)} patch map. Lower --num_D or "
                    f"--n_layers_D, or raise --crop_size: scale k needs "
                    f"crop_size/2^k to survive n_layers_D stride-2 convs "
                    f"plus two 4x4 valid-ish convs.")
            out, feats = d.trunk(h, H)
            outs.append(_nhwc(out))
            all_feats.append(feats)
        if return_features:
            return tuple(outs), tuple(all_feats)
        return tuple(outs)


class PixelDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, cond_nc: int = 10, ndf: int = 64,
                 norm: str = "instance", dtype=torch.float32,
                 spectral_norm: bool = False):
        super().__init__()
        use_bias = conv_bias_before_norm(norm)
        sn = dict(dtype=dtype, spectral_norm=spectral_norm)
        self.convs = nn.ModuleList([
            TorchConv(input_nc + cond_nc, ndf, 1, 1, 0, use_bias=True, **sn),
            TorchConv(ndf, ndf * 2, 1, 1, 0, use_bias=use_bias, **sn),
            TorchConv(ndf * 2, 1, 1, 1, 0, use_bias=True, **sn)])
        self.norms = nn.ModuleList([Norm(norm, ndf * 2)])

    def patch_size(self, size: int) -> int:
        """The side of the logit map for an input of side ``size``."""
        return size

    def feature_sizes(self, size: int) -> tuple:
        """The side of each feature tap: the input's (1x1 convs)."""
        return (size, size)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                return_features: bool = False):
        h = F.leaky_relu(self.convs[0](_with_cond(x, cond)), 0.2)
        f0 = h
        h = F.leaky_relu(self.norms[0](self.convs[1](h)), 0.2)
        out = _nhwc(self.convs[2](h).float())
        if return_features:
            return out, (_nhwc(f0), _nhwc(h))
        return out
