"""Device-resident fake-image pool (counterpart of ``pcgan_tpu/utils/image_pool.py:31-87``).

The reference's ``ImagePool`` shows D a 50/50 mix of current and historical
fakes. Here the pool is a tensor state on the device and a query is one
vectorized functional update, with no host round trip. Per batch item i:

  - while the pool is warming up (count < pool_size): insert fake_i and
    return it;
  - else with p=0.5 return fake_i untouched, with p=0.5 swap it with a
    uniformly random slot and return the evicted historical fake. Only
    slots written before this batch are ever swapped in: at the warm-up
    boundary (count < P < count + B) the unwritten slots hold zeros.

Conditions travel with their images. Duplicate random slots within one
batch resolve to the last writer, as the JAX package's scatter does on
its CPU and TPU backends. ``query_with_draws`` holds the logic and takes
the draws; ``query`` draws them from a ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass
class PoolState:
    imgs: torch.Tensor    # (P, H, W, C)
    conds: torch.Tensor   # (P, cond_nc)
    count: torch.Tensor   # scalar int32: filled slots; -1 = pool disabled


def init_pool(pool_size: int, img_shape: Tuple[int, int, int], cond_nc: int,
              dtype=torch.float32, device=None) -> PoolState:
    if pool_size <= 0:
        # disabled: one-slot buffers and the count sentinel; queries return
        # their inputs
        return PoolState(torch.zeros((1, *img_shape), dtype=dtype, device=device),
                         torch.zeros((1, cond_nc), dtype=dtype, device=device),
                         torch.tensor(-1, dtype=torch.int32, device=device))
    return PoolState(
        torch.zeros((pool_size, *img_shape), dtype=dtype, device=device),
        torch.zeros((pool_size, cond_nc), dtype=dtype, device=device),
        torch.tensor(0, dtype=torch.int32, device=device))


def query_with_draws(state: PoolState, fakes: torch.Tensor,
                     conds: torch.Tensor, rand_idx: torch.Tensor,
                     swap: torch.Tensor
                     ) -> Tuple[PoolState, torch.Tensor, torch.Tensor]:
    """One query with its draws given: ``rand_idx`` (B,) slots in [0, P),
    ``swap`` (B,) bool. Returns (new_state, images_for_D, conds_for_D)."""
    b = fakes.shape[0]
    p = state.imgs.shape[0]
    dev = state.imgs.device
    rand_idx = rand_idx.to(device=dev, dtype=torch.long)
    swap = swap.to(device=dev, dtype=torch.bool)
    count = state.count
    disabled = count < 0
    pos = count.long() + torch.arange(b, device=dev)
    warm = pos < p
    can_swap = rand_idx < count
    write_idx = torch.where(warm, pos.clamp(0, p - 1), rand_idx)
    do_write = (warm | (swap & can_swap)) & ~disabled
    use_history = swap & can_swap & ~warm & ~disabled

    fk = fakes.to(state.imgs.dtype)
    ck = conds.to(state.conds.dtype)
    old_imgs = state.imgs[write_idx]
    old_conds = state.conds[write_idx]
    out_imgs = torch.where(use_history[:, None, None, None], old_imgs, fk)
    out_conds = torch.where(use_history[:, None], old_conds, ck)
    new_imgs_rows = torch.where(do_write[:, None, None, None], fk, old_imgs)
    new_conds_rows = torch.where(do_write[:, None], ck, old_conds)
    # last writer wins: every row writes the value of the last row that
    # targets its slot, so the scatter's order does not matter
    ar = torch.arange(b, device=dev)
    same = write_idx[:, None] == write_idx[None, :]
    last = torch.where(same, ar[None, :], -1).amax(dim=1)
    imgs = state.imgs.index_put((write_idx,), new_imgs_rows[last])
    cond_buf = state.conds.index_put((write_idx,), new_conds_rows[last])
    new_count = torch.where(disabled, count,
                            torch.clamp(count + b, max=p).to(count.dtype))
    return (PoolState(imgs, cond_buf, new_count),
            out_imgs.to(fakes.dtype), out_conds.to(conds.dtype))


def query(state: PoolState, fakes: torch.Tensor, conds: torch.Tensor,
          generator: Optional[torch.Generator] = None
          ) -> Tuple[PoolState, torch.Tensor, torch.Tensor]:
    """Draw the slots and swap bits from ``generator`` (a CPU generator;
    the draws are copied to the pool's device), then query."""
    b = fakes.shape[0]
    p = state.imgs.shape[0]
    rand_idx = torch.randint(0, p, (b,), generator=generator)
    swap = torch.rand(b, generator=generator) < 0.5
    return query_with_draws(state, fakes, conds, rand_idx, swap)
