"""Reflect and replicate padding with a deterministic backward (the port's
``pcgan_tpu/models/layers.py pad2d``).

ATen's CUDA backward of ``reflection_pad2d`` and ``replication_pad2d`` adds
each padded cotangent element onto its source pixel with atomics, so two
runs of the same step differ in the last bits. ``ReflectPad2d`` and
``ReplicatePad2d`` pad as ``F.pad`` does, and their backward (``pad_fold``)
slices out the interior and folds the border cotangents back onto their
sources by slice-adds in a fixed order: the same bits on every run, on the
card and on the CPU.

Layout NCHW; the pad is the same ``p`` on all four sides of H and W.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _fold_edges(g: torch.Tensor, p: int, mode: str, dim: int) -> torch.Tensor:
    """The transpose of a ``mode`` pad of ``p`` along ``dim`` (2 or 3): a
    new contiguous tensor of the interior with the 2p border slices added
    onto their sources, the top (left) border first."""
    n = g.shape[dim] - 2 * p
    out = g.narrow(dim, p, n).clone(memory_format=torch.contiguous_format)
    lo, hi = g.narrow(dim, 0, p), g.narrow(dim, n + p, p)
    if mode == "reflect":
        # padded row i < p mirrors source row p - i; row n + p + j mirrors
        # source row n - 2 - j (a one-row border is its own mirror image)
        if p > 1:
            lo, hi = lo.flip(dim), hi.flip(dim)
        out.narrow(dim, 1, p).add_(lo)
        out.narrow(dim, n - 1 - p, p).add_(hi)
    else:
        out.narrow(dim, 0, 1).add_(lo.sum(dim, keepdim=True))
        out.narrow(dim, n - 1, 1).add_(hi.sum(dim, keepdim=True))
    return out


def pad_fold(g: torch.Tensor, p: int, mode: str) -> torch.Tensor:
    """The transpose of ``F.pad(x, (p, p, p, p), mode=mode)`` on an NCHW
    cotangent (``mode`` reflect or replicate): H first, then W. Returns a
    contiguous tensor of x's shape; no atomics, no index ops."""
    if p == 0:
        return g.contiguous()
    return _fold_edges(_fold_edges(g, p, mode, 2), p, mode, 3)


class ReflectPad2d(torch.autograd.Function):
    """``F.pad(x, (p,) * 4, mode="reflect")`` with ``pad_fold`` as its
    backward. The forward keeps no tensor and no state, so ``checkpoint``
    recomputes it freely; the backward is made of differentiable ops, so a
    double backward goes through it too."""

    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return F.pad(x, (p, p, p, p), mode="reflect")

    @staticmethod
    def backward(ctx, g):
        return pad_fold(g, ctx.p, "reflect"), None


class ReplicatePad2d(torch.autograd.Function):
    """``ReflectPad2d``'s counterpart for ``mode="replicate"``."""

    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return F.pad(x, (p, p, p, p), mode="replicate")

    @staticmethod
    def backward(ctx, g):
        return pad_fold(g, ctx.p, "replicate"), None


_FUNCTIONS = {"reflect": ReflectPad2d, "replicate": ReplicatePad2d}


def pad2d(x: torch.Tensor, p: int, mode: str) -> torch.Tensor:
    """Pad H and W of an NCHW tensor by ``p`` (torch ``ReflectionPad2d`` /
    ``ReplicationPad2d``) through the mode's Function."""
    if p == 0:
        return x
    if mode not in _FUNCTIONS:
        raise NotImplementedError(f"pad mode [{mode}]")
    return _FUNCTIONS[mode].apply(x, p)
