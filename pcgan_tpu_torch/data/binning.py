"""Age binning / condition encoding (counterpart of ``pcgan_tpu/data/binning.py``).

Default bin edges follow the face-aging literature's decades when
``n_age_bins == 10``; otherwise uniform bins over [0, max_age]. Host-side
helpers are numpy; condition tensors are torch.
"""

from __future__ import annotations

import numpy as np
import torch


def bin_edges(n_bins: int, max_age: int = 116) -> np.ndarray:
    """Right-open bin edges, length n_bins+1: age a falls in bin i iff
    edges[i] <= a < edges[i+1] (last bin closed)."""
    if n_bins == 10 and max_age >= 100:
        # decade bins: 0-9, 10-19, ..., 80-89, 90+
        return np.array([0, 10, 20, 30, 40, 50, 60, 70, 80, 90, max_age + 1],
                        dtype=np.float32)
    e = np.linspace(0.0, float(max_age) + 1.0, n_bins + 1)
    return e.astype(np.float32)


def age_to_bin(age, n_bins: int, max_age: int = 116) -> np.ndarray:
    """age (int array or scalar) -> int32 bin index in [0, n_bins)."""
    edges = bin_edges(n_bins, max_age)
    idx = np.searchsorted(edges, np.asarray(age, np.float32), side="right") - 1
    return np.clip(idx, 0, n_bins - 1).astype(np.int32)


def bin_to_onehot(bin_idx, n_bins: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Integer bins (tensor or array) -> (..., n_bins) one-hot condition."""
    idx = torch.as_tensor(bin_idx, device=device).long()
    return torch.eye(n_bins, dtype=dtype, device=idx.device)[idx]


def age_to_onehot(age, n_bins: int, max_age: int = 116, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    return bin_to_onehot(age_to_bin(age, n_bins, max_age), n_bins, dtype,
                         device)


def bin_center_age(bin_idx, n_bins: int, max_age: int = 116) -> np.ndarray:
    """Inverse map: representative age per bin (for labeling sample grids)."""
    edges = bin_edges(n_bins, max_age)
    centers = (edges[:-1] + edges[1:]) / 2.0
    return centers[np.asarray(bin_idx, np.int32)]


def all_bins_onehot(n_bins: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """(n_bins, n_bins) identity: one condition vector per bin, for the
    aging-progression grid."""
    return torch.eye(n_bins, dtype=dtype, device=device)


def ramp_f32(stop: float, n: int) -> np.ndarray:
    """``jnp.linspace(0, stop, n)`` in f32 as XLA computes it, bit for bit:
    ``i * (stop * (1 / (n - 1)))``, the last point ``stop`` itself
    (``torch.linspace`` and ``np.linspace`` round some points an ulp
    apart, which would move a frame's blend)."""
    if n == 1:
        return np.zeros(1, np.float32)
    step = np.float32(stop) * (np.float32(1) / np.float32(n - 1))
    out = np.arange(n - 1, dtype=np.float32) * step
    return np.append(out, np.float32(stop)).astype(np.float32)


def interp_bins_onehot(n_bins: int, n_frames: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """(n_frames, n_bins) SOFT one-hot sweep from bin 0 to bin n_bins-1:
    frame positions tile [0, n_bins-1] evenly and each row blends the two
    adjacent bins' one-hots linearly (rows sum to 1; a position on a bin IS
    that bin's one-hot). The onehot-mode condition of ``test.py --anim``."""
    p = torch.from_numpy(ramp_f32(float(n_bins - 1), n_frames))
    lo = torch.clamp(torch.floor(p).long(), 0, n_bins - 1)
    hi = torch.clamp(lo + 1, 0, n_bins - 1)
    frac = (p - lo.float())[:, None]
    eye = torch.eye(n_bins)
    return ((1.0 - frac) * eye[lo] + frac * eye[hi]).to(dtype=dtype,
                                                        device=device)


# --------------------------------------------------------------------------- #
# continuous score conditioning (--cond_mode score): the comparator's score
# normalized to [-1, 1] by the pretraining-time anchor range
# --------------------------------------------------------------------------- #


def bin_to_score(bin_idx, n_bins: int) -> torch.Tensor:
    """Bin index -> normalized score in [-1, 1] (bin centers, evenly
    spaced), f32: the score-mode condition when no comparator scores the
    real images."""
    b = torch.as_tensor(bin_idx).float()
    return 2.0 * (b + 0.5) / float(n_bins) - 1.0


def score_sweep(n_steps: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(n_steps, 1) condition column sweeping the normalized score range
    [-1, 1]: the score-mode analogue of ``all_bins_onehot``."""
    return torch.linspace(-1.0, 1.0, n_steps, dtype=torch.float32,
                          device=device)[:, None].to(dtype)


def normalize_score(mu, score_min, score_max) -> torch.Tensor:
    """Raw comparator score -> [-1, 1] given the anchor range (the extreme
    bins' mean scores), clipped to the conditioning interval."""
    mu = torch.as_tensor(mu).float()
    span = torch.clamp(torch.as_tensor(score_max - score_min).float(),
                       min=1e-6)
    return torch.clamp(2.0 * (mu - score_min) / span - 1.0, -1.0, 1.0)


def denormalize_score(s, score_min, score_max) -> torch.Tensor:
    """[-1, 1] normalized score -> raw comparator score."""
    s = torch.as_tensor(s).float()
    return score_min + (s + 1.0) * 0.5 * (score_max - score_min)
