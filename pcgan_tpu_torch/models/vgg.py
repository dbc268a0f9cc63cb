"""VGG relu-tap trunks (counterpart of ``pcgan_tpu/models/vgg.py:71-199``).

torchvision ``vgg16`` / ``vgg19`` ``features`` up to their deepest tap: 3x3
stride-1 pad-1 convs with bias and ReLU, 2x2/2 max pools between stages.
``VGG16Taps`` (LPIPS) taps relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3;
``VGG19Taps`` (``--lambda_vgg``, the pix2pixHD perceptual loss) taps
relu1_1 .. relu5_1, weighted 1/32, 1/16, 1/8, 1/4, 1 under L1
(``vgg_perceptual_loss``; [-1, 1] images go in with no ImageNet
renormalization, as pix2pixHD's ``VGGLoss`` does). The convs sit in
``features`` under their torchvision indices, so a torchvision state
dict's ``features.<i>.weight`` / ``.bias`` load by name. Takes NHWC and
returns NHWC taps, in f32. No weights ship: ``--vgg_path`` names a
torchvision ``.pth`` (or an ``.npz`` of the same keys, or of the JAX
package's flax ``conv_<i>/kernel`` tree), and ``random`` a seeded random
trunk for smoke runs.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pcgan_tpu_torch.parallel import spatial

# (torchvision `features` conv index, out_channels), VGG16 'D' config
CONVS16: Sequence[Tuple[int, int]] = (
    (0, 64), (2, 64),
    (5, 128), (7, 128),
    (10, 256), (12, 256), (14, 256),
    (17, 512), (19, 512), (21, 512),
    (24, 512), (26, 512), (28, 512),
)
TAP_AFTER16 = (2, 7, 14, 21, 28)
POOL_BEFORE16 = (5, 10, 17, 24)
LPIPS_TAP_CHANNELS = (64, 128, 256, 512, 512)


# VGG19 ('E' config) through conv5_1, the pix2pixHD taps
CONVS19: Sequence[Tuple[int, int]] = (
    (0, 64), (2, 64),
    (5, 128), (7, 128),
    (10, 256), (12, 256), (14, 256), (16, 256),
    (19, 512), (21, 512), (23, 512), (25, 512),
    (28, 512),
)
TAP_AFTER19 = (0, 5, 10, 19, 28)         # relu1_1 .. relu5_1
POOL_BEFORE19 = (5, 10, 19, 28)
TAP_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


class _VGGTaps(nn.Module):
    CONVS: Sequence[Tuple[int, int]] = ()
    TAP_AFTER: Sequence[int] = ()
    POOL_BEFORE: Sequence[int] = ()

    def __init__(self):
        super().__init__()
        convs, ch = {}, 3
        for idx, out in self.CONVS:
            convs[str(idx)] = nn.Conv2d(ch, out, 3, 1, 1)
            ch = out
        self.features = nn.ModuleDict(convs)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """NHWC x -> the NHWC taps; inside ``spatial.banded`` x and the
        taps are this rank's bands (``tap_sizes`` gives their global
        heights)."""
        h = x.float().permute(0, 3, 1, 2).contiguous()
        H = spatial.global_h(h.shape[2])
        taps = []
        for idx, _ in self.CONVS:
            if idx in self.POOL_BEFORE:
                h = spatial.pool2(h, H, "max")
                H //= 2
            h = F.relu(self._conv(self.features[str(idx)], h, H))
            if idx in self.TAP_AFTER:
                taps.append(h.permute(0, 2, 3, 1))
        return tuple(taps)

    def tap_sizes(self, size: int) -> Tuple[int, ...]:
        """The side of each tap for an input of side ``size``."""
        out = []
        for idx, _ in self.CONVS:
            if idx in self.POOL_BEFORE:
                size //= 2
            if idx in self.TAP_AFTER:
                out.append(size)
        return tuple(out)

    @staticmethod
    def _conv(conv: nn.Conv2d, h: torch.Tensor, H: int) -> torch.Tensor:
        """The 3x3 pad-1 conv of the NCHW tensor of H rows whose band is
        ``h``: its window fetched over the line, zero rows beyond the
        image (the conv itself outside ``spatial.banded``)."""
        line = spatial.active()
        if line is None:
            return conv(h)
        wins = spatial.conv_windows(H, line.n, 3, 1, 1)
        hw = spatial.fetch(h, H, wins)
        mine = wins[line.coord]
        if mine is None:    # 3 rows of zeros, one output row, dropped
            return F.conv2d(F.pad(hw, (0, 0, 0, 3)), conv.weight,
                            conv.bias, padding=(0, 1))[:, :, :0]
        hw = F.pad(hw, (0, 0, max(0, -mine[0]), max(0, mine[1] - H)))
        return F.conv2d(hw, conv.weight, conv.bias, padding=(0, 1))


class VGG16Taps(_VGGTaps):
    CONVS, TAP_AFTER, POOL_BEFORE = CONVS16, TAP_AFTER16, POOL_BEFORE16


class VGG19Taps(_VGGTaps):
    CONVS, TAP_AFTER, POOL_BEFORE = CONVS19, TAP_AFTER19, POOL_BEFORE19


def _random(net: _VGGTaps, seed: int) -> _VGGTaps:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in net.features.values():
            fan_in = conv.weight[0].numel()
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              / fan_in ** 0.5)
            conv.bias.zero_()
    return net.eval().requires_grad_(False)


def random_vgg16(seed: int = 0) -> VGG16Taps:
    """A seeded random trunk (``--lpips_vgg16 random``, smoke runs only):
    each kernel normal(0, 1/fan_in), biases zero, from a CPU
    ``torch.Generator``. The JAX package draws its own with flax, so the
    two frameworks' numbers differ by design."""
    return _random(VGG16Taps(), seed)


def random_vgg19(seed: int = 0) -> VGG19Taps:
    """``random_vgg16``'s twin for the perceptual loss (``--vgg_path
    random``)."""
    return _random(VGG19Taps(), seed)


def import_vgg_pth(state_dict: Dict[str, Any], net: _VGGTaps) -> _VGGTaps:
    """Fill ``net`` in place from a torchvision vgg state dict
    (``features.<i>.*``, or a bare ``features`` module's ``<i>.*``); the
    classifier is ignored."""
    with torch.no_grad():
        for idx, _ in net.CONVS:
            for wkey in (f"features.{idx}.weight", f"{idx}.weight"):
                if wkey in state_dict:
                    break
            else:
                raise KeyError(f"missing features.{idx}.weight in state_dict "
                               f"(not a torchvision {type(net).__name__[:5]} "
                               f"checkpoint?)")
            conv = net.features[str(idx)]
            w = torch.as_tensor(state_dict[wkey], dtype=torch.float32)
            if tuple(w.shape) != tuple(conv.weight.shape):
                raise ValueError(f"features.{idx}: kernel shape "
                                 f"{tuple(w.shape)} != expected "
                                 f"{tuple(conv.weight.shape)}")
            conv.weight.copy_(w)
            conv.bias.copy_(torch.as_tensor(
                state_dict[wkey[:-len("weight")] + "bias"],
                dtype=torch.float32))
    return net


def load_vgg16(path: str, allow_pickle: bool = False) -> VGG16Taps:
    """``VGG16Taps`` from a torchvision vgg16 ``.pth`` (LPIPS trunk)."""
    from pcgan_tpu_torch.utils.pth import load_pth
    return import_vgg_pth(load_pth(path, allow_pickle=allow_pickle),
                          VGG16Taps()).eval().requires_grad_(False)


def load_vgg19(path: str, allow_pickle: bool = False) -> VGG19Taps:
    """``VGG19Taps`` from a torchvision vgg19 ``.pth``, or from an ``.npz``
    holding either the same ``features.<i>.*`` keys or the JAX package's
    flax tree (``conv_<i>/kernel`` HWIO, ``conv_<i>/bias``)."""
    if path.endswith(".npz"):
        import numpy as np
        with np.load(path) as z:
            sd = {k: z[k] for k in z.files}
        if any(k.startswith("conv_") for k in sd):
            from pcgan_tpu_torch.convert import convert_vgg16_params
            sd = convert_vgg16_params(sd)
    else:
        from pcgan_tpu_torch.utils.pth import load_pth
        sd = load_pth(path, allow_pickle=allow_pickle)
    return import_vgg_pth(sd, VGG19Taps()).eval().requires_grad_(False)


def vgg_perceptual_loss(net: VGG19Taps, x: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """pix2pixHD ``VGGLoss(x, y)``: ``sum_i w_i * mean|tap_i(x) -
    tap_i(y)|`` over ONE 2B forward; gradients flow through ``x`` only.
    Inside ``spatial.banded`` x and y are bands and the loss is this
    rank's share (each tap's ``band_mean`` over its global height)."""
    b = x.shape[0]
    taps = net(torch.cat([x.float(), y.float()]))
    sizes = (net.tap_sizes(spatial.global_h(x.shape[1]))
             if spatial.active() is not None else [None] * len(taps))
    total = torch.zeros((), device=x.device)
    for w, t, h in zip(TAP_WEIGHTS, taps, sizes):
        total = total + w * spatial.band_mean(torch.abs(t[:b]
                                                        - t[b:].detach()), h)
    return total
