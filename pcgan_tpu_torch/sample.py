"""Aging-progression sampling (counterpart of ``pcgan_tpu/sample.py``).

Given a G and input faces, renders the same identity at every age bin in
ONE batched forward: the (B, n_bins) product is flattened into the batch.
Each image is repeated ``n_bins`` times consecutively, the conditions are
tiled, and the result is reshaped to (B, n_bins, ...), the order of the JAX
sampler. Under ``--cond_mode score`` the columns sweep the normalized
comparator score over [-1, 1] in ``n_age_bins`` even steps instead.
``make_anim_sampler`` renders a smooth ``n_frames`` sweep the same way
(``test.py --anim``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pcgan_tpu_torch.config import Config
from pcgan_tpu_torch.data.binning import (all_bins_onehot, bin_center_age,
                                          interp_bins_onehot, score_sweep)


def _sweep_sampler(G: torch.nn.Module, conds_of):
    """f(images (B,H,W,C)) -> (B, T, H, W, C): every one of the T condition
    rows ``conds_of(dtype, device)`` for every input, in one forward."""
    @torch.no_grad()
    def sample(images: torch.Tensor) -> torch.Tensor:
        G.eval()
        b = images.shape[0]
        conds = conds_of(images.dtype, images.device)             # (T, K)
        t = conds.shape[0]
        x = images.repeat_interleave(t, dim=0)                    # (B*T, ...)
        c = conds.repeat(b, 1)
        fakes = G(x, c)
        return fakes.reshape(b, t, *fakes.shape[1:])

    return sample


def make_sampler(cfg: Config, G: torch.nn.Module):
    """Returns f(images (B,H,W,C)) -> (B, n_bins, H, W, C) f32, under
    ``torch.no_grad`` with G in eval mode."""
    nb = cfg.data.n_age_bins
    sweep = score_sweep if cfg.model.cond_mode == "score" else all_bins_onehot
    return _sweep_sampler(G, lambda dtype, device: sweep(nb, dtype, device))


def make_anim_sampler(cfg: Config, G: torch.nn.Module, n_frames: int):
    """Like ``make_sampler`` over ``n_frames`` conditions, for the smooth
    aging animation: score mode sweeps [-1, 1]; onehot mode blends adjacent
    bins' one-hots (``interp_bins_onehot``), so a frame that lands on a bin
    equals that bin's grid column."""
    nb = cfg.data.n_age_bins
    if cfg.model.cond_mode == "score":
        return _sweep_sampler(
            G, lambda dtype, device: score_sweep(n_frames, dtype, device))
    return _sweep_sampler(
        G, lambda dtype, device: interp_bins_onehot(nb, n_frames, dtype,
                                                    device))


def aging_grid_visuals(cfg: Config, real: np.ndarray,
                       fakes: np.ndarray) -> Dict[str, np.ndarray]:
    """Row dict for the HTML page: input + one fake per condition, labeled
    by the bin's representative age (onehot) or the swept normalized score
    (score mode), the reference results-page layout."""
    out = {"input": real}
    if cfg.model.cond_mode == "score":
        sweep = score_sweep(fakes.shape[0])[:, 0].numpy()
        for b in range(fakes.shape[0]):
            out[f"score_{sweep[b]:+.2f}"] = fakes[b]
        return out
    for b in range(fakes.shape[0]):
        age = int(bin_center_age(b, cfg.data.n_age_bins, cfg.data.max_age))
        out[f"age_{age:03d}"] = fakes[b]
    return out
