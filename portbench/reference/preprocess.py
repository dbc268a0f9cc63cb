"""Plain reference of the input pipeline: PIL's antialiased bicubic resize
of a u8 canvas to the load size, the crop, the mirror flip and the
normalisation to [-1, 1], in float32, written from PIL's definition.

PIL resamples each axis with a filter of support 2 (a = -0.5 cubic),
stretched by the scale when it shrinks; each output pixel's weights are
normalised to sum to 1. Along one axis that is a matrix product, so the
whole transform is two products per image. The age bins are the decade
bins of the face-aging literature for 10 bins over ages up to 116.
"""

from __future__ import annotations

import numpy as np
import torch


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    return np.where(x <= 1.0, ((a + 2) * x - (a + 3)) * x * x + 1,
                    np.where(x < 2.0, ((a * x - 5 * a) * x + 8 * a) * x
                             - 4 * a, 0.0))


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64: PIL's bicubic resize along one axis."""
    if n_in == n_out:
        return np.eye(n_out)
    scale = n_in / n_out
    stretch = max(scale, 1.0)
    out = np.zeros((n_out, n_in))
    src = np.arange(n_in) + 0.5
    for i in range(n_out):
        centre = (i + 0.5) * scale
        lo = max(int(np.floor(centre - 2 * stretch)), 0)
        hi = min(int(np.ceil(centre + 2 * stretch)) + 1, n_in)
        w = _cubic((src[lo:hi] - centre) / stretch)
        out[i, lo:hi] = w / w.sum()
    return out


def crops(images: np.ndarray, cy, cx, flip, load: int, crop: int,
          device) -> torch.Tensor:
    """(B, crop, crop, 3) float32 in [-1, 1] from (B, N, N, 3) u8 canvases:
    resized to ``load``, cropped at rows ``cy`` and columns ``cx``, the
    columns reversed where ``flip``."""
    n = images.shape[1]
    m = torch.from_numpy(resize_weights(n, load)).to(device,
                                                     torch.float64)
    x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    x = x.to(torch.float64)
    out = []
    for b in range(x.shape[0]):
        rows = m[int(cy[b]):int(cy[b]) + crop]
        cols = m[int(cx[b]):int(cx[b]) + crop]
        if bool(flip[b]):
            cols = cols.flip(0)
        img = torch.einsum("oh,hwc->owc", rows, x[b])
        img = torch.einsum("pw,owc->opc", cols, img)
        out.append(img * (2.0 / 255.0) - 1.0)
    return torch.stack(out).clamp(-1.0, 1.0).float()


def age_bins(ages, n_bins: int = 10, max_age: int = 116) -> np.ndarray:
    """Decade bins (0-9, ..., 80-89, 90+) for 10 bins, else equal bins
    over [0, max_age + 1)."""
    ages = np.asarray(ages, np.float64)
    if n_bins == 10 and max_age >= 100:
        return np.clip(ages // 10, 0, 9).astype(np.int64)
    width = (max_age + 1.0) / n_bins
    return np.clip(np.floor(ages / width), 0, n_bins - 1).astype(np.int64)
