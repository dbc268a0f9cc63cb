"""Precision / recall / density / coverage (counterpart of
``pcgan_tpu/ops/prdc.py``).

k-NN manifold metrics between real and fake feature rows, as the ``prdc``
package defines them (Kynkaanniemi et al. 2019; Naeem et al. 2020): each
point's radius is the distance to its k-th nearest neighbour in its own set
(the (k+1)-th smallest distance counting itself), membership is strict
``<``, and everything is compared in squared euclidean distance. Products
and ``topk`` on the features' device.
"""

from __future__ import annotations

from typing import Dict

import torch


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d), (m, d) -> (n, m) squared distances, clamped at 0 (the
    expansion |a|^2 + |b|^2 - 2ab can dip below 0 in f32)."""
    a, b = a.float(), b.float()
    an = torch.sum(a * a, dim=1, keepdim=True)
    bn = torch.sum(b * b, dim=1, keepdim=True)
    return torch.clamp(an + bn.T - 2.0 * (a @ b.T), min=0.0)


def _knn_radii_sq(x: torch.Tensor, k: int) -> torch.Tensor:
    """(n, d) -> (n,) squared distance to each row's k-th nearest other
    row."""
    neg_small, _ = torch.topk(-_sq_dists(x, x), k + 1, dim=1)
    return -neg_small[:, k]


def prdc_from_features(real: torch.Tensor, fake: torch.Tensor, k: int = 5
                       ) -> Dict[str, torch.Tensor]:
    """Precision/recall/density/coverage between (n, d) real and (m, d)
    fake features; needs n, m > k."""
    r_rad2 = _knn_radii_sq(real, k)
    f_rad2 = _knn_radii_sq(fake, k)
    d2 = _sq_dists(real, fake)
    in_real_ball = d2 < r_rad2[:, None]         # fake j inside real i's ball
    in_fake_ball = d2 < f_rad2[None, :]         # real i inside fake j's ball
    return {
        "precision": in_real_ball.any(dim=0).float().mean(),
        "recall": in_fake_ball.any(dim=1).float().mean(),
        "density": in_real_ball.float().sum(dim=0).mean() / k,
        "coverage": in_real_ball.any(dim=1).float().mean(),
    }
