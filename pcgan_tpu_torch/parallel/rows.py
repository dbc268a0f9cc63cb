"""A rank's rows of the global batch, for the sharded-state step
(``parallel/auto.py``).

JAX's GSPMD step is the one-device step over the global batch: every
per-row draw (B1's crops and flips, the target bins, the pool's slots,
dropout, DiffAugment and GP's alphas) is made for the global B rows. The
port's ranks therefore draw alike, for the global rows, from generators
seeded alike, and each keeps the rows of its data coordinate d of N.

A (micro)batch of ``seg`` local rows is rows [d*seg, (d+1)*seg) of the
global (micro)batch of N*seg rows. A tensor that stacks k such
(micro)batches along dim 0 (the 2B generator input ``[real, real]``, the
fused D pass ``[real, fake]``, or a whole batch of k microbatches under
``--grad_accum k``) holds the union of those rows of each segment.
``Rows(1, 0, seg)`` is the one-device path: every row, in order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class Rows:
    n: int       # the data axis
    coord: int   # this rank's data coordinate
    seg: int     # local rows of one (micro)batch

    def total(self, count: int) -> int:
        """The global row count of a local ``count``."""
        if count % self.seg:
            raise ValueError(f"{count} rows are not whole (micro)batches of "
                             f"{self.seg}")
        return count * self.n

    def index(self, count: int) -> torch.Tensor:
        """The global positions (CPU int64, ascending) of a local
        ``count`` rows."""
        k = self.total(count) // (self.n * self.seg)
        base = (torch.arange(k) * (self.n * self.seg)
                + self.coord * self.seg)
        return (base[:, None] + torch.arange(self.seg)).reshape(-1)

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t``, a draw for the global rows."""
        return t[self.index(t.shape[0] // self.n).to(t.device)]


def global_rows(rows: Optional[Rows], count: int) -> int:
    return count if rows is None else rows.total(count)


def take_rows(rows: Optional[Rows], t: torch.Tensor) -> torch.Tensor:
    return t if rows is None else rows.take(t)


def rand(shape, generator, rows: Optional[Rows] = None, **kwargs
         ) -> torch.Tensor:
    """``torch.rand(shape)`` of this rank's rows: drawn for the global rows
    and sliced (the draw itself under ``rows=None``)."""
    shape = tuple(shape)
    full = (global_rows(rows, shape[0]),) + shape[1:]
    return take_rows(rows, torch.rand(full, generator=generator, **kwargs))


def randint(low: int, high: int, count: int, generator,
            rows: Optional[Rows] = None) -> torch.Tensor:
    """``torch.randint(low, high, (count,))`` of this rank's rows."""
    return take_rows(rows, torch.randint(
        low, high, (global_rows(rows, count),), generator=generator))
