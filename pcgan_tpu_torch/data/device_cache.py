"""Device-resident dataset cache, one device (counterpart of the replicated
layout of ``pcgan_tpu/data/device_cache.py:53-155, 219-289``).

``--device_cache`` uploads the whole dataset once: every row is decoded
through the host ``Loader`` (the dataset's own ``get_raw_batch``,
``--host_resize``, ``with_bins``), and its u8 canvases and numeric labels
go to the device in one copy each. Each step then uploads only the batch's
indices and gathers the batch on the device (``index_select``), so there is
no per-step decode, no prefetch thread and no pageable image upload; kernel
B1 preprocesses the gathered batch as usual.

Epoch shuffles are the host ``Loader``'s exactly (a numpy permutation
seeded ``seed + epoch``, ``skip_next`` at the index level), so the sample
stream, and with it the metric stream and exact resume, is bit-identical
to the streaming path. The cache may take at most 60% of the card's memory
(a clear ``SystemExit`` otherwise); a CPU device is uncapped. The sharded
layout (``--device_cache_sharded``) needs several devices and is not
ported (ROADMAP.md A10).
"""

from __future__ import annotations

import time
from typing import Dict, Iterator

import numpy as np
import torch

from pcgan_tpu_torch.config import Config


class DeviceCacheLoader:
    """Loader-shaped iterable whose batches are gathered on ``device``: the
    ``ds``, ``bs``, ``epoch``, ``skip_next``, ``__len__``, ``__iter__``
    surface the training loops use, plus ``eval_iter``. Batches are dicts of
    device tensors (u8 images, integer labels with ``bin``), equal to the
    host path's for the same (seed, epoch, step)."""

    is_device_cache = True

    def __init__(self, cfg: Config, ds, device, *, shuffle: bool = True,
                 seed: int = 0, max_bytes: int = 0):
        self.ds = ds
        self.bs = cfg.data.batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.skip_next = 0
        self.device = torch.device(device)
        n = len(ds)
        if n < self.bs:
            raise SystemExit(
                f"--device_cache: dataset has {n} rows < batch_size {self.bs}")
        t0 = time.perf_counter()
        host = self._decode_rows(cfg, ds)
        t1 = time.perf_counter()
        if not host:
            raise SystemExit("--device_cache: dataset yielded no cacheable "
                             "(numeric array) batch keys")
        per_device = sum(v.nbytes for v in host.values())
        if not max_bytes and self.device.type == "cuda":
            # 60% of the card leaves room for the model, optimizer and
            # activations; a clear exit beats an out-of-memory error
            total = torch.cuda.mem_get_info(self.device)[1]
            max_bytes = int(total * 0.6)
        if max_bytes and per_device > max_bytes:
            raise SystemExit(
                f"--device_cache: dataset is {per_device / 2**30:.2f} GiB "
                f"per device > the {max_bytes / 2**30:.2f} GiB cap (60% of "
                f"device memory); try --device_cache_sharded (per-device "
                f"cost divides by the data axis) or the host Loader")
        self.n = n
        self._cache = {k: torch.from_numpy(v).to(self.device)
                       for k, v in host.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # the build's two parts: the host pass over the rows, the upload
        self.decode_s, self.upload_s = t1 - t0, time.perf_counter() - t1
        self.nbytes = per_device
        print(f"device cache: {n} rows, {per_device / 2**30:.2f} GiB "
              f"resident per device (keys: {sorted(host)}; decoded in "
              f"{self.decode_s:.2f} s, uploaded in {self.upload_s:.2f} s)",
              flush=True)

    @staticmethod
    def _decode_rows(cfg: Config, ds) -> Dict[str, np.ndarray]:
        """One pass over every row through the streaming path's own host
        machinery (native decode, ``--host_resize``, the age -> bin map),
        so the cached rows are the ones the host path would upload."""
        from pcgan_tpu_torch.data.loader import (Loader, host_resize_size,
                                                 with_bins)
        build = Loader(ds, batch_size=min(cfg.data.batch_size, len(ds)),
                       shuffle=False, drop_last=False,
                       num_threads=cfg.data.num_threads,
                       resize_to=host_resize_size(cfg))
        chunks: Dict[str, list] = {}
        for b in with_bins(iter(build), cfg.data.n_age_bins,
                           cfg.data.max_age):
            for k, v in b.items():
                v = np.asarray(v)
                if v.dtype.kind in "iufb":
                    chunks.setdefault(k, []).append(v)
        return {k: np.ascontiguousarray(np.concatenate(v, axis=0))
                for k, v in chunks.items()}

    def _gather(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        i = torch.from_numpy(idx).to(self.device)
        return {k: v.index_select(0, i) for k, v in self._cache.items()}

    def __len__(self) -> int:
        return self.n // self.bs

    def eval_iter(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Index-order batches straight from the cache: the host eval
        loader's order (no shuffle, drop_last), without touching the
        training epoch and skip cursors."""
        for b in range(len(self)):
            yield self._gather(np.arange(b * self.bs, (b + 1) * self.bs))

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        order = np.arange(self.n)
        if self.shuffle:
            # the host Loader's seeding: resume replays the right epoch
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        nb = len(self)
        start, self.skip_next = min(self.skip_next, nb), 0
        for b in range(start, nb):
            yield self._gather(order[b * self.bs:(b + 1) * self.bs])
