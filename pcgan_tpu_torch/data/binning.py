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
