"""Host data loader (counterpart of ``pcgan_tpu/data/loader.py:31-113, 169-316``).

The loader emits RAW batches (native-size u8 + integer labels) as numpy;
all image math happens on the device (ops/preprocess.py), unless
``--host_resize`` resizes to ``--load_size`` on the host first.
``create_dataset`` follows the reference's ``--dataset_mode`` dispatch:
the synthetic sets, UTKFace-style folders (``aging``, ``single``), packs,
comparator-sorted labels, the comparisons CSV and pairs over any of the
age-labelled sources. ``split_holdout`` carves ``--holdout_frac``'s seeded
held-out rows, the JAX package's split index for index. Multi-process
sharding is not ported (ROADMAP.md A10).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from pcgan_tpu_torch.config import Config
from pcgan_tpu_torch.data.binning import age_to_bin
from pcgan_tpu_torch.data.pairwise import PairwiseComparisonDataset
from pcgan_tpu_torch.data.resample import pil_resize_np
from pcgan_tpu_torch.data.synthetic import SyntheticAgingDataset


def phase_root(dataroot: str, phase: str) -> str:
    """``{dataroot}/{phase}`` when that folder exists (train/val/test splits
    side by side), else ``dataroot`` itself."""
    sub = os.path.join(dataroot, phase)
    return sub if phase and os.path.isdir(sub) else dataroot


def create_dataset(cfg: Config, train: bool = True):
    mode = cfg.data.dataset_mode
    ms = cfg.data.max_dataset_size
    if mode in ("synthetic", "synthetic_hard"):
        size = ms if ms and ms > 0 else 100
        return SyntheticAgingDataset(
            size=size, seed=cfg.train.seed, max_age=cfg.data.max_age,
            variant=("hard" if mode == "synthetic_hard" else "easy"))
    if mode in ("aging", "single"):
        from pcgan_tpu_torch.data.utkface import UTKFaceDataset
        # --native_size 0 probes the folder's own canvas (UTKFace 200, CACD
        # 250); the cap bounds mixed folders of large photos at 2x load_size
        ds = UTKFaceDataset(phase_root(cfg.data.dataroot, cfg.run.phase),
                            max_size=ms, native=cfg.data.native_size,
                            native_cap=max(200, 2 * cfg.data.load_size),
                            require_age=(mode == "aging"),
                            decode_m=cfg.data.host_decode_m)
        if ds.out_size < min(ds.native, cfg.data.load_size):
            # the DCT downscale (--host_decode_m < 8) left less resolution
            # than a full decode gives this load_size
            raise ValueError(
                f"--host_decode_m {cfg.data.host_decode_m} decodes to a "
                f"{ds.out_size}px canvas but --load_size {cfg.data.load_size} "
                f"needs {min(ds.native, cfg.data.load_size)}px of source "
                f"resolution; raise host_decode_m or lower load_size")
        return ds
    if mode == "packed":
        from pcgan_tpu_torch.data.packed import PackedDataset
        ds = PackedDataset(cfg.data.dataroot, max_size=ms)
        if ds.resized and cfg.data.load_size > ds.out_size:
            raise ValueError(
                f"pack at {cfg.data.dataroot} was pre-resized to "
                f"{ds.out_size}px but --load_size {cfg.data.load_size} wants "
                f"more source resolution; re-pack without --resize_to (or "
                f"with --resize_to >= load_size)")
        return ds
    if mode == "sorted":
        from pcgan_tpu_torch.data.sorted_labels import SortedLabelsDataset
        return SortedLabelsDataset(cfg.data.labels_csv, max_size=ms)
    if mode in ("pairwise", "pairwise_hard"):
        # pairs over the folder at --dataroot when it exists, else over the
        # synthetic set (the hard one for pairwise_hard)
        if cfg.data.dataroot and os.path.isdir(cfg.data.dataroot):
            base_mode = "aging"
        else:
            base_mode = ("synthetic_hard" if mode == "pairwise_hard"
                         else "synthetic")
        base = create_dataset(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, dataset_mode=base_mode)),
            train)
        return PairwiseComparisonDataset(base, tie_years=3, seed=cfg.train.seed)
    if mode == "comparisons":
        # human pairwise annotations: no ages anywhere
        from pcgan_tpu_torch.data.pairwise import ComparisonsCSVDataset
        return ComparisonsCSVDataset(cfg.data.comparisons_csv,
                                     dataroot=cfg.data.dataroot, max_size=ms)
    raise NotImplementedError(f"dataset_mode [{mode}] not implemented")


class SubsetDataset:
    """Index-remapped view over a raw dataset (the JAX ``SubsetDataset``,
    ``pcgan_tpu/data/loader.py:120-152``): the same ``get_raw`` / ``ages``
    protocol, and ``get_raw_batch`` passes through with remapped indices
    when the base has it, so a folder's native batch decode serves
    subsets."""

    def __init__(self, base, indices):
        self.ds = base
        self.indices = np.asarray(indices, np.int64)
        self.ages = (np.asarray(base.ages)[self.indices]
                     if hasattr(base, "ages") else None)
        for attr in ("native", "out_size", "max_age"):
            if hasattr(base, attr):
                setattr(self, attr, getattr(base, attr))
        if hasattr(base, "get_raw_batch"):
            self.get_raw_batch = self._get_raw_batch

    def __len__(self):
        return len(self.indices)

    def get_raw(self, i: int):
        return self.ds.get_raw(int(self.indices[int(i)]))

    def _get_raw_batch(self, idx, num_threads: int = 8):
        return self.ds.get_raw_batch(self.indices[np.asarray(idx, np.int64)],
                                     num_threads=num_threads)


def split_holdout(ds, frac: float, seed: int = 0):
    """(train view, held-out view) for ``--holdout_frac``: the permutation
    ``np.random.default_rng(seed ^ 0x42D).permutation(len(ds))``, its first
    round(n * frac) rows held out, both sides sorted (the JAX
    ``split_holdout``, ``pcgan_tpu/data/loader.py:155-166``). It depends
    only on (len(ds), frac, seed), so evaluation reproduces it. frac <= 0
    returns (ds, None)."""
    if frac <= 0:
        return ds, None
    if not 0 < frac < 1:
        raise ValueError(f"--holdout_frac must be in (0, 1); got {frac}")
    n = len(ds)
    n_hold = max(1, int(round(n * frac)))
    if n_hold >= n:
        raise ValueError(
            f"--holdout_frac {frac} leaves no training rows (dataset size "
            f"{n}); lower the fraction or enlarge the dataset")
    perm = np.random.default_rng(seed ^ 0x42D).permutation(n)
    return (SubsetDataset(ds, np.sort(perm[n_hold:])),
            SubsetDataset(ds, np.sort(perm[:n_hold])))


def host_resize_size(cfg: Config) -> int:
    """Loader ``resize_to`` for --host_resize: load_size when the preprocess
    mode includes a resize, else 0 (off)."""
    d = cfg.data
    return d.load_size if (d.host_resize and "resize" in d.preprocess) else 0


class Loader:
    """Iterable over stacked numpy batches, optional shuffle (the JAX
    ``Loader``, ``pcgan_tpu/data/loader.py:215-303``, single process).

    Each epoch yields len(ds)//batch (``drop_last``) or ceil(len(ds)/batch)
    batches of {'image': (B,H,W,C) u8, 'age': (B,) i64} (or the dataset's
    own keys). A shuffled epoch permutes with
    ``np.random.default_rng(seed + epoch)``, so the port's batches are the
    JAX loader's, row for row. A dataset with ``get_raw_batch`` (a folder:
    one native decode call a batch; a pack: one gather) serves whole
    batches; others go through ``get_raw`` on a thread pool.
    ``skip_next`` drops the first N batches of the next epoch at the index
    level (exact mid-epoch resume). ``resize_to`` > 0 resizes every u8
    image key on the host to (resize_to, resize_to) with Pillow's bicubic
    (``pil_resize_np``, ``--host_resize``).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_threads: int = 4, seed: int = 0, drop_last: bool = True,
                 resize_to: int = 0):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.resize_to = int(resize_to)
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
        get_batch = getattr(self.ds, "get_raw_batch", None)
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            for b in range(start, nb):
                idx = order[b * self.bs:(b + 1) * self.bs]
                if get_batch is not None:
                    batch = get_batch(idx, num_threads=self.num_threads)
                else:
                    items = list(pool.map(self.ds.get_raw, idx))
                    batch = {k: np.stack([it[k] for it in items])
                             for k in items[0]}
                yield self._host_resize(batch, pool)

    def _host_resize(self, batch: Dict[str, np.ndarray],
                     pool: ThreadPoolExecutor) -> Dict[str, np.ndarray]:
        if self.resize_to <= 0:
            return batch
        size = self.resize_to

        def one(a):
            return pil_resize_np(a, size, "bicubic")

        out = dict(batch)
        for k, v in batch.items():
            # both spatial sizes must match to skip
            if (v.ndim == 4 and v.dtype == np.uint8
                    and v.shape[1:3] != (size, size)):
                out[k] = np.stack(list(pool.map(one, v)))
        return out


def with_bins(it: Iterator[Dict], n_bins: int, max_age: int = 116):
    """Attach integer age-bin labels host-side (a batch that already has
    ``bin``s, as sorted mode's, and no ages passes through)."""
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
