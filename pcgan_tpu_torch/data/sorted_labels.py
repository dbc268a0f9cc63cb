"""A dataset over comparator-sorted pseudo-labels (counterpart of
``pcgan_tpu/data/sorted_labels.py``): reads the ``path,bin,score`` CSV that
``python -m pcgan_tpu_torch.tools.sort_unlabeled`` writes, so an unlabeled
image pool trains the conditional GAN on comparator-derived bins
(``--dataset_mode sorted --labels_csv labels.csv``).
"""

from __future__ import annotations

import csv
import os

import numpy as np

from pcgan_tpu_torch.data.utkface import load_canvas


class SortedLabelsDataset:
    """Protocol: __len__, get_raw(i) -> {'image': u8 (native, native, 3),
    'bin': int32}."""

    def __init__(self, labels_csv: str, native: int = 200, max_size: int = -1):
        self.native = native
        if not os.path.exists(labels_csv):
            raise FileNotFoundError(
                f"{labels_csv} not found: generate it with python -m "
                f"pcgan_tpu_torch.tools.sort_unlabeled")
        paths, bins = [], []
        with open(labels_csv) as f:
            for row in csv.DictReader(f):
                paths.append(row["path"])
                bins.append(int(row["bin"]))
        if max_size and max_size > 0:
            paths, bins = paths[:max_size], bins[:max_size]
        self.paths = paths
        self.bins = np.asarray(bins, np.int32)

    def __len__(self):
        return len(self.paths)

    def get_raw(self, i: int):
        return {"image": load_canvas(self.paths[i], self.native),
                "bin": np.int32(self.bins[i])}
