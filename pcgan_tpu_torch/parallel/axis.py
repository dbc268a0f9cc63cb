"""The collectives over one mesh axis, and their counters.

``Axis`` runs the collectives of this rank's line along one mesh axis in
coordinate order; ``parallel/auto.py`` (the sharded-state step) and
``parallel/spatial.py`` (the halo exchanges and band sums) use it. Each
collective adds one to ``COLLECTIVES['{kind}/{axis}']`` (on the spatial
line: ``halo`` and ``halo_grad``, a conv's halo rows and their gradient;
``all_reduce_sum``, the band sums; ``gather_band`` and
``gather_band_grad``, an operand gathered whole and its gradient); with
``TIMING['on']`` the device is synchronized around it and its wall ms
add to ``COLLECTIVE_MS``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch
import torch.distributed as dist

COLLECTIVES: Dict[str, int] = {}
COLLECTIVE_MS: Dict[str, float] = {}
TIMING = {"on": False}


@contextlib.contextmanager
def record(kind: str, device: torch.device):
    COLLECTIVES[kind] = COLLECTIVES.get(kind, 0) + 1
    if not TIMING["on"]:
        yield
        return

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    sync()
    t0 = time.perf_counter()
    yield
    sync()
    COLLECTIVE_MS[kind] = (COLLECTIVE_MS.get(kind, 0.0)
                           + 1e3 * (time.perf_counter() - t0))


class Axis:
    """The collectives over this rank's line along one mesh axis, in
    coordinate order (a group's own rank order is its sorted global ranks,
    which the hybrid mesh permutes)."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.axis_group(axis)
        self.n, self.coord = mesh.size(axis), mesh.coord(axis)
        self.name, self.device = axis, mesh.device
        if self.group is not None:
            line = mesh.line(axis)
            self.group_rank = [dist.get_group_rank(self.group, r)
                               for r in line]
            self.nccl = dist.get_backend(self.group) == "nccl"

    def _record(self, kind: str):
        return record(f"{kind}/{self.name}", self.device)

    def all_gather(self, flat: torch.Tensor, kind: str = "all_gather"
                   ) -> List[torch.Tensor]:
        """Every coordinate's ``flat`` (1-D, equal sizes), in coordinate
        order. Over gloo a 16-bit tensor travels as bytes (the copy is
        exact)."""
        dtype = flat.dtype
        if not self.nccl and flat.element_size() == 2:
            flat = flat.view(torch.uint8)
        with self._record(kind):
            if self.nccl:
                out = flat.new_empty((self.n * flat.numel(),))
                dist.all_gather_into_tensor(out, flat, group=self.group)
                by_rank = list(out.chunk(self.n))
            else:
                by_rank = [torch.empty_like(flat) for _ in range(self.n)]
                dist.all_gather(by_rank, flat.contiguous(), group=self.group)
        return [by_rank[g].view(dtype) for g in self.group_rank]

    def reduce_scatter_mean(self, chunks: List[torch.Tensor]
                            ) -> torch.Tensor:
        """The mean over the line of chunk ``coord`` of ``chunks`` (one
        1-D chunk per coordinate, equal sizes)."""
        with self._record("reduce_scatter"):
            if self.nccl:
                by_rank = [None] * self.n
                for c, g in enumerate(self.group_rank):
                    by_rank[g] = chunks[c]
                mine = chunks[0].new_empty(chunks[0].shape)
                dist.reduce_scatter_tensor(mine, torch.cat(by_rank),
                                           group=self.group)
            else:
                flat = torch.cat(chunks)
                dist.all_reduce(flat, group=self.group)
                mine = flat.chunk(self.n)[self.coord]
        return mine / torch.tensor(self.n, dtype=mine.dtype,
                                   device=mine.device)

    def all_reduce_sum(self, flat: torch.Tensor, kind: str = "all_reduce"
                       ) -> torch.Tensor:
        """``flat`` summed over the line (a new tensor)."""
        flat = flat.clone()
        with self._record(kind):
            dist.all_reduce(flat, group=self.group)
        return flat

    def all_reduce_mean(self, flat: torch.Tensor) -> torch.Tensor:
        flat = self.all_reduce_sum(flat)
        return flat / torch.tensor(self.n, dtype=flat.dtype,
                                   device=flat.device)

    def gather_dims(self, shards: List[torch.Tensor], dims: List[int]
                    ) -> List[torch.Tensor]:
        """Each tensor whole again: its shards over the line concatenated
        along its dim, one collective for the list."""
        if not shards:
            return []
        flat = torch.cat([s.detach().reshape(-1) for s in shards])
        parts = [p.split([s.numel() for s in shards])
                 for p in self.all_gather(flat)]
        return [torch.cat([p[i].view(s.shape) for p in parts], dim)
                for i, (s, dim) in enumerate(zip(shards, dims))]
