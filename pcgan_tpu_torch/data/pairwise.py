"""Pairwise-comparison datasets for comparator pretraining (counterpart of
``pcgan_tpu/data/pairwise.py``; numpy only, so a seed gives the JAX
package's pairs and labels).

Two sources. Labels: 0 = a older, 1 = b older, 2 = tie.

- ``PairwiseComparisonDataset`` synthesizes labels from a base dataset's
  ages with a tie threshold (|age_a - age_b| <= tie_years -> tie).
- ``ComparisonsCSVDataset`` reads human annotations, ``pathA,pathB,label``
  rows (``--dataset_mode comparisons --comparisons_csv f.csv``): no ages
  anywhere, the paper's label-free setting.
"""

from __future__ import annotations

import os

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


class _ImageLoaderMixin:
    """Host decode onto the fixed ``native`` canvas (``data/utkface.py
    load_canvas``: the port's decode, then a bicubic resize when the size
    differs), bit-identical to the JAX package's PIL decode."""

    def _decode(self, path: str) -> np.ndarray:
        from pcgan_tpu_torch.data.utkface import load_canvas
        return load_canvas(path, self.native)


class ComparisonsCSVDataset(_ImageLoaderMixin):
    """Human pairwise annotations: CSV rows ``pathA,pathB,label`` with label
    in {0: A older, 1: B older, 2: tie}; the string labels ``a``/``b``/
    ``tie`` (and ``older``/``younger``) are accepted, and a first row whose
    label is none of these and whose first column is no file is a header.
    Relative paths resolve against the CSV's directory, then ``dataroot``.

    ``image_pool_dataset()`` is the de-duplicated set of the CSV's images as
    an unlabeled dataset: the score anchors are fitted on it by quantiles
    after pretraining.
    """

    _LABELS = {"0": 0, "1": 1, "2": 2, "a": 0, "b": 1, "tie": 2,
               "older": 0, "younger": 1}

    def __init__(self, csv_path: str, dataroot: str = "", native: int = 200,
                 max_size: int = -1):
        self.native = native
        if not csv_path or not os.path.isfile(csv_path):
            raise FileNotFoundError(
                f"--comparisons_csv [{csv_path}] not found; expected CSV of "
                f"pathA,pathB,label rows")
        base_dirs = [os.path.dirname(os.path.abspath(csv_path))]
        if dataroot:
            base_dirs.append(dataroot)
        rows = []
        with open(csv_path) as f:
            for ln, line in enumerate(f):
                parts = [p.strip() for p in line.strip().split(",")]
                if len(parts) < 3 or not parts[0]:
                    continue
                lab = self._LABELS.get(parts[2].lower())
                if (ln == 0 and lab is None
                        and not self._is_file(parts[0], base_dirs)):
                    continue   # header row (bad label + non-path first col)
                if lab is None:
                    raise ValueError(
                        f"{csv_path}:{ln + 1}: bad label {parts[2]!r} "
                        f"(want 0/1/2 or a/b/tie)")
                rows.append((self._resolve(parts[0], base_dirs),
                             self._resolve(parts[1], base_dirs), lab))
        if max_size and max_size > 0:
            rows = rows[:max_size]
        if not rows:
            raise ValueError(f"{csv_path}: no comparison rows parsed")
        self.rows = rows

    @staticmethod
    def _is_file(path, base_dirs):
        return (os.path.isfile(path)
                or any(os.path.isfile(os.path.join(d, path))
                       for d in base_dirs))

    @staticmethod
    def _resolve(path, base_dirs):
        if os.path.isabs(path) and os.path.isfile(path):
            return path
        for d in base_dirs:
            cand = os.path.join(d, path)
            if os.path.isfile(cand):
                return cand
        raise FileNotFoundError(f"comparison image not found: {path}")

    def __len__(self):
        return len(self.rows)

    def get_raw(self, i: int):
        pa, pb, label = self.rows[i]
        return {"image_a": self._decode(pa), "image_b": self._decode(pb),
                "label": np.int32(label)}

    def image_pool_dataset(self):
        paths = sorted({p for pa, pb, _ in self.rows for p in (pa, pb)})
        return _UnlabeledImages(paths, self.native)


class _UnlabeledImages(_ImageLoaderMixin):
    """Unique-image view over a comparisons CSV (for score-anchor fitting)."""

    def __init__(self, paths, native):
        self.paths = paths
        self.native = native

    def __len__(self):
        return len(self.paths)

    def get_raw(self, i: int):
        return {"image": self._decode(self.paths[i])}
