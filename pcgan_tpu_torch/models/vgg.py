"""VGG16 relu taps for LPIPS (counterpart of the ``VGG16Taps`` half of
``pcgan_tpu/models/vgg.py``).

torchvision ``vgg16.features`` through relu5_3: 3x3 stride-1 pad-1 convs
with bias and ReLU, 2x2/2 max pools between stages, taps after relu1_2,
relu2_2, relu3_3, relu4_3 and relu5_3. The convs sit in ``features`` under
their torchvision indices, so a torchvision ``vgg16`` state dict's
``features.<i>.weight`` / ``.bias`` load by name. Takes NHWC and returns
NHWC taps, in f32.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

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


class VGG16Taps(nn.Module):
    def __init__(self):
        super().__init__()
        convs, ch = {}, 3
        for idx, out in CONVS16:
            convs[str(idx)] = nn.Conv2d(ch, out, 3, 1, 1)
            ch = out
        self.features = nn.ModuleDict(convs)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        h = x.float().permute(0, 3, 1, 2).contiguous()
        taps = []
        for idx, _ in CONVS16:
            if idx in POOL_BEFORE16:
                h = F.max_pool2d(h, 2, 2)
            h = F.relu(self.features[str(idx)](h))
            if idx in TAP_AFTER16:
                taps.append(h.permute(0, 2, 3, 1))
        return tuple(taps)


def random_vgg16(seed: int = 0) -> VGG16Taps:
    """A seeded random trunk (``--lpips_vgg16 random``, smoke runs only):
    each kernel normal(0, 1/fan_in), biases zero, from a CPU
    ``torch.Generator``. The JAX package draws its own with flax, so the
    two frameworks' numbers differ by design."""
    net = VGG16Taps()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in net.features.values():
            fan_in = conv.weight[0].numel()
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              / fan_in ** 0.5)
            conv.bias.zero_()
    return net.eval().requires_grad_(False)


def import_vgg16_pth(state_dict: Dict[str, Any], net: VGG16Taps) -> VGG16Taps:
    """Fill ``net`` in place from a torchvision ``vgg16`` state dict
    (``features.<i>.*``, or a bare ``features`` module's ``<i>.*``); the
    classifier is ignored."""
    with torch.no_grad():
        for idx, _ in CONVS16:
            for wkey in (f"features.{idx}.weight", f"{idx}.weight"):
                if wkey in state_dict:
                    break
            else:
                raise KeyError(f"missing features.{idx}.weight in state_dict "
                               f"(not a torchvision vgg16 checkpoint?)")
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
    return import_vgg16_pth(load_pth(path, allow_pickle=allow_pickle),
                            VGG16Taps()).eval().requires_grad_(False)
