"""SSIM between each input face and its aged output (counterpart of
``pcgan_tpu/ops/ssim.py``, ``--ssim``).

Wang et al. 2004: 11x11 Gaussian window (sigma 1.5) applied as VALID
filtering, C1 = (0.01 L)^2, C2 = (0.03 L)^2 with data range L = 2 (images
in [-1, 1]), filtered-moment covariances, the map averaged over positions
and channels to one number per image. The separable window is two products
with banded (n - 10, n) matrices, built in numpy as the JAX package builds
them; computed in f32.
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_taps(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-0.5 * ((np.arange(size) - (size - 1) / 2) / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def _band_matrix(n: int, size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """(n - size + 1, n) valid-filtering operator for the 1-D window."""
    taps = _gaussian_taps(size, sigma)
    out = np.zeros((n - size + 1, n), np.float32)
    for i in range(n - size + 1):
        out[i, i:i + size] = taps
    return out


def ssim_pair(x: torch.Tensor, y: torch.Tensor, *, data_range: float = 2.0,
              size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Per-image SSIM between (B, H, W, C) float batches -> (B,) f32."""
    x, y = x.float(), y.float()
    _, h, w, _ = x.shape
    wh = torch.from_numpy(_band_matrix(h, size, sigma)).to(x.device)
    ww = torch.from_numpy(_band_matrix(w, size, sigma)).to(x.device)

    def filt(img):
        t = torch.einsum("ih,bhwc->biwc", wh, img)
        return torch.einsum("jw,biwc->bijc", ww, t)

    mu_x, mu_y = filt(x), filt(y)
    sxx = filt(x * x) - mu_x * mu_x
    syy = filt(y * y) - mu_y * mu_y
    sxy = filt(x * y) - mu_x * mu_y
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2.0 * mu_x * mu_y + c1) * (2.0 * sxy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sxx + syy + c2)
    return torch.mean(num / den, dim=(1, 2, 3))
