"""Plain reference of the aging grid: each input face, centre-cropped (no
flip), rendered by the generator at every age bin (one-hot conditions in
bin order), in float32."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import models
from portbench.reference.preprocess import crops


def grid(g: dict, canvases: np.ndarray, n_blocks: int, n_bins: int,
         load: int, crop: int, device, q=None):
    """(crops (B, crop, crop, 3), fakes (B, n_bins, crop, crop, 3)), both
    float32, from (B, N, N, 3) u8 canvases."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = canvases.shape[0]
    mid = np.full(b, (load - crop) // 2)
    real = crops(canvases, mid, mid, np.zeros(b, bool), load, crop, device)
    conds = torch.eye(n_bins, device=device)
    with torch.no_grad():
        fakes = torch.stack([
            models.generator(g, real[i:i + 1].expand(n_bins, -1, -1, -1),
                             conds, n_blocks, q) for i in range(b)])
    return real, fakes
