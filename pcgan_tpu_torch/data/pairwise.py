"""Pairwise-comparison datasets for comparator pretraining (counterpart of
``pcgan_tpu/data/pairwise.py:24-60``; numpy only, so a seed gives the JAX
package's pairs and labels).

``PairwiseComparisonDataset`` synthesizes labels from a base dataset's ages
with a tie threshold (|age_a - age_b| <= tie_years -> tie). Labels: 0 = a
older, 1 = b older, 2 = tie. The human-annotation CSV source
(``--dataset_mode comparisons``) decodes image files and is not ported.
"""

from __future__ import annotations

import numpy as np


class PairwiseComparisonDataset:
    def __init__(self, base, pairs_per_epoch: int = None, tie_years: int = 3,
                 seed: int = 0):
        self.base = base
        self.tie_years = tie_years
        self.n_pairs = pairs_per_epoch or len(base)
        rng = np.random.default_rng(seed)
        n = len(base)
        self._idx = rng.integers(0, n, size=(self.n_pairs, 2))

    def __len__(self):
        return self.n_pairs

    def get_raw(self, i: int):
        ia, ib = map(int, self._idx[i])
        a, b = self.base.get_raw(ia), self.base.get_raw(ib)
        da = a["age"] - b["age"]
        label = 2 if abs(da) <= self.tie_years else (0 if da > 0 else 1)
        return {"image_a": a["image"], "image_b": b["image"],
                "label": np.int32(label)}


class Subset:
    """Index-subset view over any ``get_raw`` dataset: the held-out pairs of
    comparator pretraining, whose accuracy is measured out of sample."""

    def __init__(self, base, indices):
        self.base = base
        self.indices = np.asarray(indices, np.int64)

    def __len__(self):
        return len(self.indices)

    def get_raw(self, i: int):
        return self.base.get_raw(int(self.indices[i]))


def held_out_split(ds, frac: float, seed: int):
    """(train pairs, held-out pairs or None): the seeded split of comparator
    pretraining (root ``train.py:687-691``). A fraction ``frac`` of the
    pairs is held out, only when there are at least 20."""
    n_eval = int(len(ds) * frac) if len(ds) >= 20 else 0
    if not n_eval:
        return ds, None
    perm = np.random.default_rng(seed + 0x0e7a1).permutation(len(ds))
    return Subset(ds, perm[n_eval:]), Subset(ds, perm[:n_eval])
