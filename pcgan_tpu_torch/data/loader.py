"""Host data loader (counterpart of ``pcgan_tpu/data/loader.py:42-49, 215-316``).

The loader emits RAW batches (native-size u8 + integer labels) as numpy;
all image math happens on the device (ops/preprocess.py). Only the
synthetic dataset modes are ported; the JPEG folder modes (native decoder)
and ``--host_resize`` (PIL) are later work and raise.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from pcgan_tpu_torch.config import Config
from pcgan_tpu_torch.data.binning import age_to_bin
from pcgan_tpu_torch.data.synthetic import SyntheticAgingDataset


def create_dataset(cfg: Config, train: bool = True):
    mode = cfg.data.dataset_mode
    ms = cfg.data.max_dataset_size
    if mode in ("synthetic", "synthetic_hard"):
        size = ms if ms and ms > 0 else 100
        return SyntheticAgingDataset(
            size=size, seed=cfg.train.seed, max_age=cfg.data.max_age,
            variant=("hard" if mode == "synthetic_hard" else "easy"))
    raise NotImplementedError(
        f"dataset_mode [{mode}] is not ported to pcgan_tpu_torch yet "
        f"(synthetic | synthetic_hard only)")


class Loader:
    """Iterable over stacked numpy batches, threaded ``get_raw``, optional
    shuffle (the JAX ``Loader``, ``pcgan_tpu/data/loader.py:215-287``,
    single process, no host resize).

    Each epoch yields len(ds)//batch (``drop_last``) or ceil(len(ds)/batch)
    batches of {'image': (B,H,W,C) u8, 'age': (B,) i64}. A shuffled epoch
    permutes with ``np.random.default_rng(seed + epoch)``, so the port's
    batches are the JAX loader's, row for row. ``skip_next`` drops the
    first N batches of the next epoch at the index level (exact mid-epoch
    resume replays the epoch's permutation and skips what was consumed).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_threads: int = 4, seed: int = 0, drop_last: bool = True):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.epoch = 0
        self.skip_next = 0

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        nb = len(self)
        start, self.skip_next = min(self.skip_next, nb), 0
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            for b in range(start, nb):
                idx = order[b * self.bs:(b + 1) * self.bs]
                items = list(pool.map(self.ds.get_raw, idx))
                yield {k: np.stack([it[k] for it in items]) for k in items[0]}


def with_bins(it: Iterator[Dict], n_bins: int, max_age: int = 116):
    """Attach integer age-bin labels host-side."""
    for batch in it:
        if "age" in batch:
            batch = dict(batch)
            batch["bin"] = age_to_bin(batch["age"], n_bins, max_age)
        yield batch


def prefetch(it: Iterator[Dict], size: int = 2) -> Iterator[Dict]:
    """Run the upstream iterator (host data generation) on a background
    thread, ``size`` batches ahead of the consumer, so host work overlaps
    the device's step. ``size <= 0`` iterates inline. An exception in the
    producer is re-raised in the consumer. When the consumer stops early
    (it raised, broke off, or was closed), the producer stops too and
    closes the upstream iterator, so no thread or worker pool outlives
    it."""
    if size <= 0:
        yield from it
        return
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for b in it:
                if not put(b):
                    break
            else:
                put(end)
        except BaseException as e:   # re-raised below, never swallowed
            put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()
