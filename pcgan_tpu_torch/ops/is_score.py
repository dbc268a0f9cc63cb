"""Inception Score (counterpart of ``pcgan_tpu/ops/is_score.py``,
``--is_score``; Salimans et al. 2016).

exp(E_x KL(p(y|x) || p(y))) over a classifier's label distribution, as mean
and std over ``splits`` contiguous chunks. The evaluator applies the
classifier head (one (K, d) product) to the retained fake features, so IS
costs no extra forward. The head is the ``fc.*`` of the ``--fid_features
pth:<file>`` InceptionV3 checkpoint, or, under ``--fid_features random``, a
numpy-seeded random head (the JAX package's, bit for bit; smoke runs only).
The score itself is numpy in f64, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_EPS = 1e-16


def inception_score_from_probs(probs: np.ndarray,
                               splits: int = 10) -> Tuple[float, float]:
    """(N, K) class probabilities -> (mean, std) over ``splits`` chunks
    (clamped so every chunk is non-empty)."""
    probs = np.asarray(probs, np.float64)
    if probs.ndim != 2 or probs.shape[0] < 1:
        raise ValueError(f"probs must be (N, K) with N >= 1; got {probs.shape}")
    splits = max(1, min(int(splits), probs.shape[0]))
    scores = []
    for chunk in np.array_split(probs, splits):
        marginal = chunk.mean(axis=0, keepdims=True)
        kl = (chunk * (np.log(chunk + _EPS) - np.log(marginal + _EPS))).sum(1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def load_inception_fc(pth_path: str, allow_pickle: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(W (K, 2048), b (K,)) classifier head of a torchvision
    ``inception_v3`` / pytorch-fid state dict."""
    from pcgan_tpu_torch.utils.pth import load_pth
    sd = load_pth(pth_path, allow_pickle=allow_pickle)
    if "fc.weight" not in sd:
        raise ValueError(
            f"{pth_path} carries no fc.weight: --is_score needs an "
            f"InceptionV3 checkpoint with its classifier head (torchvision "
            f"inception_v3 and pytorch-fid exports both have one)")
    w = np.asarray(sd["fc.weight"], np.float32)
    if w.ndim != 2:
        raise ValueError(f"fc.weight must be 2-D; got {w.shape}")
    b = (np.asarray(sd["fc.bias"], np.float32) if "fc.bias" in sd
         else np.zeros((w.shape[0],), np.float32))
    if b.shape != (w.shape[0],):
        raise ValueError(f"fc.bias shape {b.shape} != ({w.shape[0]},)")
    return w, b


def random_fc(dim: int, n_classes: int = 1000,
              seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded random classifier head (numpy ``default_rng(seed)``, the JAX
    package's draw) for ``--fid_features random`` smoke runs."""
    r = np.random.default_rng(seed)
    return (r.normal(0.0, 0.05, (n_classes, dim)).astype(np.float32),
            np.zeros((n_classes,), np.float32))
