"""Streaming FID (counterpart of ``pcgan_tpu/ops/fid.py``).

Frechet distance between two feature distributions, accumulated as running
(count, sum, sum of outer products) statistics on the features' device in
f32; no feature matrix is kept for FID itself. The epilogue (``finalize``,
``fid_from_stats``) runs on the host in f32, as the JAX evaluator pulls its
statistics to the host before it: the trace of ``sqrtm(C1 C2)`` is taken as
``tr sqrtm(S1 C2 S1)`` with ``S1 = sqrtm(C1)``, two symmetric ``eigh``.

``--fid_features random`` is a fixed random conv net. Its weights are the
JAX package's flax init under ``PRNGKey(42)``, which torch cannot redraw,
so they are read from ``fid_random_features.npz`` beside this file
(written by ``tests/torch_port_data/make_random_features.py``). Statistics
files (``save_stats`` / ``load_stats``) have the JAX package's ``.npz``
layout, so either framework reads the other's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

RANDOM_FEATURES_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "fid_random_features.npz")


# --------------------------------------------------------------------------- #
# feature extractor
# --------------------------------------------------------------------------- #


def same_pad(n: int, k: int = 3, stride: int = 2) -> Tuple[int, int]:
    """(low, high) padding of XLA's ``SAME`` for one spatial axis: the
    output has ceil(n / stride) positions and an odd total pad puts the
    extra row at the end, so an even size at stride 2 pads (0, 1)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class RandomConvFeatures(nn.Module):
    """``depth`` 3x3 stride-2 ``SAME`` convs (``width * min(2^i, 4)``
    channels, bias, tanh-approximated GELU as ``flax.linen.gelu``), a global
    mean pool and a Linear to ``features``; f32 throughout. Takes NHWC."""

    def __init__(self, in_ch: int = 3, width: int = 64, depth: int = 4,
                 features: int = 192):
        super().__init__()
        convs, ch = [], in_ch
        for i in range(depth):
            out = width * min(2 ** i, 4)
            convs.append(nn.Conv2d(ch, out, 3, 2, 0))
            ch = out
        self.convs = nn.ModuleList(convs)
        self.fc = nn.Linear(ch, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float().permute(0, 3, 1, 2)
        for conv in self.convs:
            ph, pw = same_pad(h.shape[2]), same_pad(h.shape[3])
            h = F.gelu(conv(F.pad(h, (*pw, *ph))), approximate="tanh")
        return self.fc(h.mean(dim=(2, 3)))


def load_random_features(channels: int = 3) -> RandomConvFeatures:
    """The JAX package's ``PRNGKey(42)`` random feature net with its exact
    weights. Only 3 input channels exist: flax draws the first conv's
    kernel at its input width, so another width is another draw, which the
    committed file does not hold."""
    from pcgan_tpu_torch.convert import convert_random_features_params
    if channels != 3:
        raise ValueError(
            f"--fid_features random with {channels} image channels: the "
            f"port carries the JAX package's PRNGKey(42) feature weights for "
            f"3 channels only (flax draws the first conv at the input width, "
            f"which torch cannot redraw)")
    with np.load(RANDOM_FEATURES_NPZ) as z:
        flat = {k: z[k] for k in z.files}
    net = RandomConvFeatures()
    net.load_state_dict(convert_random_features_params(flat), strict=True)
    return net.eval().requires_grad_(False)


def make_feature_fn(channels: int = 3, device=None
                    ) -> Tuple[Callable[[torch.Tensor], torch.Tensor], int]:
    """(f(images (B,H,W,C) in [-1,1]) -> (B, 192) f32 features, 192)."""
    net = load_random_features(channels)
    if device is not None:
        net = net.to(device)
    return net, net.fc.out_features


# --------------------------------------------------------------------------- #
# streaming statistics
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class FIDStats:
    count: torch.Tensor    # 0-dim f32
    s: torch.Tensor        # (d,)   sum of features
    ss: torch.Tensor       # (d, d) sum of outer products

    def to(self, device) -> "FIDStats":
        return FIDStats(self.count.to(device), self.s.to(device),
                        self.ss.to(device))


def init_stats(d: int, device=None) -> FIDStats:
    return FIDStats(count=torch.zeros((), device=device),
                    s=torch.zeros((d,), device=device),
                    ss=torch.zeros((d, d), device=device))


def update_stats(stats: FIDStats, feats: torch.Tensor) -> FIDStats:
    f = feats.float()
    return FIDStats(count=stats.count + f.shape[0],
                    s=stats.s + f.sum(dim=0),
                    ss=stats.ss + f.T @ f)


def merge_stats(a: FIDStats, b: FIDStats) -> FIDStats:
    return FIDStats(a.count + b.count, a.s + b.s, a.ss + b.ss)


def finalize(stats: FIDStats) -> Tuple[torch.Tensor, torch.Tensor]:
    n = torch.clamp(stats.count, min=2.0)
    mu = stats.s / n
    cov = (stats.ss - n * torch.outer(mu, mu)) / (n - 1.0)
    return mu, cov


def save_stats(path: str, stats: FIDStats, meta: dict) -> None:
    """The JAX package's statistics file: raw sums (``count`` 0-dim,
    ``s``, ``ss``, f32) plus ``meta_<key>`` entries, as ``np.savez``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, count=stats.count.detach().cpu().numpy(),
             s=stats.s.detach().cpu().numpy(),
             ss=stats.ss.detach().cpu().numpy(),
             **{f"meta_{k}": np.asarray(v) for k, v in meta.items()})


def load_stats(path: str) -> Tuple[FIDStats, dict]:
    """(FIDStats on the CPU, meta dict) from a ``save_stats`` file of
    either framework."""
    with np.load(path) as z:
        stats = FIDStats(
            count=torch.from_numpy(np.asarray(z["count"], np.float32)),
            s=torch.from_numpy(np.asarray(z["s"], np.float32)),
            ss=torch.from_numpy(np.asarray(z["ss"], np.float32)))
        meta = {k[len("meta_"):]: z[k].item() if z[k].ndim == 0 else z[k]
                for k in z.files if k.startswith("meta_")}
    return stats, meta


def _sqrtm_psd(c: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    w, v = torch.linalg.eigh(c)
    w = torch.sqrt(torch.clamp(w, min=eps))
    return (v * w[None, :]) @ v.T


def fid_from_stats(real: FIDStats, fake: FIDStats) -> torch.Tensor:
    """Frechet distance of two statistics, computed where they lie (the
    evaluator hands it CPU copies) in f32."""
    mu1, c1 = finalize(real)
    mu2, c2 = finalize(fake)
    s1 = _sqrtm_psd(c1)
    a = s1 @ c2 @ s1
    w = torch.linalg.eigh(a)[0]
    tr_sqrt = torch.sum(torch.sqrt(torch.clamp(w, min=0.0)))
    diff = mu1 - mu2
    return diff @ diff + torch.trace(c1) + torch.trace(c2) - 2.0 * tr_sqrt
