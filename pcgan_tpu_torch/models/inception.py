"""InceptionV3 pool3 features (2048-d) and the torchvision ``.pth`` import
(counterpart of ``pcgan_tpu/models/inception.py``).

``--fid_features pth:<inception_v3.pth>`` reads a torchvision
``inception_v3`` (or pytorch-fid) state dict; nothing is downloaded. The
module keeps torchvision's module names (``Conv2d_1a_3x3``, ``Mixed_5b``,
``branch1x1``, ...). Each ``BasicConv2d`` holds its conv weight and its
eval-mode BatchNorm folded at import with eps 1e-3, in f32:
``scale = gamma / sqrt(var + eps)``, ``bias = beta - mean * scale``.

It matches the JAX package's network, which is not pytorch-fid's in one
place: every ``InceptionE`` block (``Mixed_7b`` and ``Mixed_7c``) average
pools its ``branch_pool`` with ``count_include_pad=False``, where
pytorch-fid's ``FIDInceptionE_2`` (``Mixed_7c``) max-pools. Inputs in
[-1, 1] are resized to 299x299 with ``jax.image.resize(..., "bilinear")``'s
own weights (half-pixel centres, a widened triangle when shrinking), then
clipped to [-1, 1]. Takes NHWC; computes in f32.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
N_CONV_UNITS = 94       # BasicConv2d units in InceptionV3's feature trunk


class BasicConv2d(nn.Module):
    """conv (no bias) + folded BN (scale, bias) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size, stride: int = 1,
                 padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding,
                              bias=False)
        self.scale = nn.Parameter(torch.ones(cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return F.relu(y * self.scale[:, None, None] + self.bias[:, None, None])


def _avg_pool_nip(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 'same' average pool that divides by the valid taps."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=(1, 1))
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool_nip(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool_nip(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    """Both ``Mixed_7b`` and ``Mixed_7c``: average-pooled ``branch_pool``
    (the JAX package's choice, not pytorch-fid's max pool in 7c)."""

    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avg_pool_nip(x))], dim=1)


class InceptionV3Features(nn.Module):
    """(B, 299, 299, 3) in [-1, 1] -> (B, 2048) pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float().permute(0, 3, 1, 2).contiguous()
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(h)))
        h = _max_pool(h)
        h = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(h)))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            h = getattr(self, name)(h)
        return h.mean(dim=(2, 3))


def bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of ``jax.image.resize``'s bilinear resize
    along one axis (``jax._src.image.scale.compute_weight_mat``, no
    translation, antialias on): half-pixel sample points, a triangle kernel
    widened by n_in / n_out when the axis shrinks, columns normalized."""
    f32 = np.float32
    # jax.image.resize passes the scale as a Python float: 1 / scale is
    # taken in f64 and rounded to f32 where it meets the f32 sample grid
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    # XLA fuses (i + 0.5) * inv_scale - 0.5 into one rounding (an FMA):
    # the f64 product of two f32 values is exact, so round once from f64
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
              * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 299, 299, C) as ``jax.image.resize(...,
    "bilinear")``: one weight matrix per axis (``bilinear_weights``),
    applied as two products in f32."""
    _, h, w, _ = x.shape
    if (h, w) == (299, 299):
        return x
    wh = torch.from_numpy(bilinear_weights(h, 299)).to(x.device)
    ww = torch.from_numpy(bilinear_weights(w, 299)).to(x.device)
    t = torch.einsum("bhwc,ho->bowc", x.float(), wh)
    return torch.einsum("bowc,wp->bopc", t, ww)


def import_inception_pth(state_dict: Dict[str, Any],
                         net: InceptionV3Features) -> InceptionV3Features:
    """Fill ``net`` in place from a torchvision ``inception_v3`` state dict:
    per ``BasicConv2d`` the ``<name>.conv.weight`` and the four
    ``<name>.bn.*`` tensors, folded in f32. The aux classifier and ``fc``
    are ignored. Returns ``net``."""
    filled = 0
    with torch.no_grad():
        for prefix, mod in net.named_modules():
            if not isinstance(mod, BasicConv2d):
                continue
            wkey = f"{prefix}.conv.weight"
            if wkey not in state_dict:
                raise KeyError(f"missing {wkey} in state_dict (not a "
                               f"torchvision inception_v3 checkpoint?)")
            w = torch.as_tensor(state_dict[wkey], dtype=torch.float32)
            if tuple(w.shape) != tuple(mod.conv.weight.shape):
                raise ValueError(f"{prefix}: kernel shape {tuple(w.shape)} "
                                 f"!= expected "
                                 f"{tuple(mod.conv.weight.shape)}")

            def bn(k):
                return torch.as_tensor(state_dict[f"{prefix}.bn.{k}"],
                                       dtype=torch.float32)
            scale = bn("weight") / torch.sqrt(bn("running_var") + BN_EPS)
            mod.conv.weight.copy_(w)
            mod.scale.copy_(scale)
            mod.bias.copy_(bn("bias") - bn("running_mean") * scale)
            filled += 1
    if filled != N_CONV_UNITS:
        raise ValueError(f"filled {filled} conv units, expected "
                         f"{N_CONV_UNITS}")
    return net


def make_inception_feature_fn(pth_path: str, allow_pickle: bool = False,
                              device=None) -> Tuple[Any, int]:
    """(f(images (B,H,W,C) in [-1,1]) -> (B, 2048) f32, 2048) from a
    ``.pth`` file; a missing file raises."""
    from pcgan_tpu_torch.utils.pth import load_pth
    net = import_inception_pth(load_pth(pth_path, allow_pickle=allow_pickle),
                               InceptionV3Features())
    net = net.eval().requires_grad_(False)
    if device is not None:
        net = net.to(device)

    def f(images: torch.Tensor) -> torch.Tensor:
        return net(torch.clamp(resize_299(images.float()), -1.0, 1.0))

    f.net = net
    return f, 2048
