"""Device-resident dataset cache (counterpart of
``pcgan_tpu/data/device_cache.py``).

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
(a clear ``SystemExit`` otherwise); a CPU device is uncapped.

Two layouts:

- replicated (``--device_cache``): the whole dataset on the one device;
  a data-parallel run refuses it, as JAX's multi-process pods do;
- sharded (``--device_cache_sharded``, ``pcgan_tpu/data/device_cache.py:
  155-217``): the rows, padded to a multiple of the data axis N, split
  over its coordinates in contiguous blocks, so each card holds 1/N of the
  dataset and each rank decodes only its block (the ranks of a model line
  hold the same block). A step uploads the global batch's indices; each
  rank takes the rows it owns (a masked local ``index_select``, zeros
  elsewhere) and one ``reduce_scatter_tensor`` over the data axis sums
  them so that the rank at data coordinate d receives rows [d*b, (d+1)*b)
  of the global batch (``rows``' positions under the sharded-state step),
  the rows it trains on. Batch-sized traffic moves; the dataset never
  does. The sample stream is the replicated cache's, index for index. A
  process outside torchrun holds every row and issues no collective.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator

import numpy as np
import torch

import torch.distributed as dist

from pcgan_tpu_torch.config import Config
from pcgan_tpu_torch.parallel.rows import Rows


class DeviceCacheLoader:
    """Loader-shaped iterable whose batches are gathered on ``device``: the
    ``ds``, ``bs``, ``epoch``, ``skip_next``, ``__len__``, ``__iter__``
    surface the training loops use, plus ``eval_iter``. Batches are dicts of
    device tensors (u8 images, integer labels with ``bin``), equal to the
    host path's for the same (seed, epoch, step). ``bs`` is the global
    batch; a rank of ``mesh`` receives its rows of it (``sharded``): those
    of ``rows`` (a ``parallel.rows.Rows``) when given, else its data
    coordinate's block."""

    is_device_cache = True

    def __init__(self, cfg: Config, ds, device, *, shuffle: bool = True,
                 seed: int = 0, max_bytes: int = 0, mesh=None,
                 sharded: bool = False, rows=None):
        world = 1 if mesh is None else mesh.data_size
        if mesh is not None and mesh.world > 1 and not sharded:
            raise SystemExit(
                "--device_cache keeps a replicated copy of the whole dataset "
                "on one device, which a data-parallel run does not build; "
                "use --device_cache_sharded (each rank decodes and holds its "
                "row block) or the host loader")
        self.ds = ds
        self.bs = cfg.data.batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.skip_next = 0
        self.device = torch.device(device)
        self.group = None if mesh is None else mesh.data_group
        self.world, self.rank = world, 0 if mesh is None else mesh.data_rank
        # the rows of each data coordinate, in the group's rank order (the
        # order reduce_scatter_tensor hands out its chunks)
        self.rows = rows or Rows(world, self.rank, max(1, self.bs // world))
        self.coords = [0]
        if self.group is not None:
            line = mesh.line("data")
            by_group = {dist.get_group_rank(self.group, int(r)): c
                        for c, r in enumerate(line)}
            self.coords = [by_group[g] for g in range(world)]
        n = len(ds)
        if n < self.bs:
            raise SystemExit(
                f"--device_cache: dataset has {n} rows < batch_size {self.bs}")
        if self.bs % world:
            raise SystemExit(f"--batch_size {self.bs} must be divisible by "
                             f"the process count ({world})")
        # sharded: rank r owns rows [r*n_loc, (r+1)*n_loc) of the rows
        # padded to a multiple of the world size; pad rows are zeros and
        # never indexed
        self.n_loc = -(-n // world) if sharded else n
        self.lo = self.rank * self.n_loc
        t0 = time.perf_counter()
        host = self._decode_rows(cfg, ds, self.lo, min(self.lo + self.n_loc,
                                                       n), self.n_loc)
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
                f"device memory); try --device_cache_sharded over more "
                f"ranks (per-device cost divides by the data axis) or the "
                f"host Loader")
        self.n = n
        self._cache = {k: torch.from_numpy(v).to(self.device)
                       for k, v in host.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # the build's two parts: the host pass over the rows, the upload
        self.decode_s, self.upload_s = t1 - t0, time.perf_counter() - t1
        self.nbytes = per_device
        print(f"device cache: {n} rows"
              + (f" sharded over {world} ranks" if sharded else "")
              + f", {per_device / 2**30:.2f} GiB "
              f"resident per device (keys: {sorted(host)}; decoded in "
              f"{self.decode_s:.2f} s, uploaded in {self.upload_s:.2f} s)",
              flush=True)

    @staticmethod
    def _decode_rows(cfg: Config, ds, lo: int, hi: int,
                     rows: int) -> Dict[str, np.ndarray]:
        """One pass over rows [lo, hi) through the streaming path's own
        host machinery (native decode, ``--host_resize``, the age -> bin
        map), so the cached rows are the ones the host path would upload;
        zero rows pad the block to ``rows``."""
        from pcgan_tpu_torch.data.loader import (Loader, SubsetDataset,
                                                 host_resize_size, with_bins)
        # a rank whose block lies wholly in the padding decodes one row for
        # the shapes and holds zeros
        view = ds if (lo, hi) == (0, len(ds)) else SubsetDataset(
            ds, np.arange(lo, hi) if hi > lo else [0])
        build = Loader(view, batch_size=min(cfg.data.batch_size, len(view)),
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
        out = {}
        for k, v in chunks.items():
            v = np.concatenate(v, axis=0)[:max(hi - lo, 0)]
            if v.shape[0] < rows:
                v = np.concatenate([v, np.zeros((rows - v.shape[0],)
                                                + v.shape[1:], v.dtype)])
            out[k] = np.ascontiguousarray(v)
        return out

    def _gather(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        """The global batch ``idx``'s rows on this rank: an index_select of
        the resident rows, or, sharded over a group, the masked local
        gather and one reduce-scatter per key."""
        i = torch.from_numpy(idx).to(self.device)
        if self.group is None and self.n_loc == self.n:
            return {k: v.index_select(0, i) for k, v in self._cache.items()}
        if self.group is not None:
            b = self.bs // self.world
            i = torch.cat([i[Rows(self.world, c, self.rows.seg).index(b)
                             .to(i.device)] for c in self.coords])
        loc = i - self.lo
        own = (loc >= 0) & (loc < self.n_loc)
        loc = loc.clamp(0, self.n_loc - 1)
        out = {}
        for k, v in self._cache.items():
            rows = v.index_select(0, loc)
            rows = torch.where(own.view((-1,) + (1,) * (v.dim() - 1)), rows,
                               torch.zeros((), dtype=v.dtype,
                                           device=v.device))
            if self.group is None:
                out[k] = rows
                continue
            mine = rows.new_empty((rows.shape[0] // self.world,)
                                  + rows.shape[1:])
            dist.reduce_scatter_tensor(mine, rows, group=self.group)
            out[k] = mine
        return out

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
