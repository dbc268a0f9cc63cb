"""Reflect and replicate padding with a deterministic backward (the port's
``pcgan_tpu/models/layers.py pad2d``).

ATen's CUDA backward of ``reflection_pad2d`` and ``replication_pad2d`` adds
each padded cotangent element onto its source pixel with atomics, so two
runs of the same step differ in the last bits. ``ReflectPad2d`` and
``ReplicatePad2d`` pad as ``F.pad`` does, and their backward (``pad_fold``)
slices out the interior and folds the border cotangents back onto their
sources by slice-adds in a fixed order: the same bits on every run, on the
card and on the CPU.

Layout NCHW; ``pad2d`` pads the same ``p`` on all four sides of H and W,
``pad_edges`` each edge by its own amount (a band of an image split
along H pads only where the image ends).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _fold_edges(g: torch.Tensor, lo: int, hi: int, mode: str,
                dim: int) -> torch.Tensor:
    """The transpose of a ``mode`` pad of ``lo`` before and ``hi`` after
    along ``dim`` (2 or 3): a new contiguous tensor of the interior with
    the border slices added onto their sources, the top (left) border
    first."""
    n = g.shape[dim] - lo - hi
    out = g.narrow(dim, lo, n).clone(memory_format=torch.contiguous_format)
    top, bottom = g.narrow(dim, 0, lo), g.narrow(dim, n + lo, hi)
    if mode == "reflect":
        # padded row i < lo mirrors source row lo - i; row n + lo + j
        # mirrors source row n - 2 - j (a one-row border is its own mirror
        # image)
        if lo:
            out.narrow(dim, 1, lo).add_(top.flip(dim) if lo > 1 else top)
        if hi:
            out.narrow(dim, n - 1 - hi, hi).add_(bottom.flip(dim) if hi > 1
                                                 else bottom)
    else:
        if lo:
            out.narrow(dim, 0, 1).add_(top.sum(dim, keepdim=True))
        if hi:
            out.narrow(dim, n - 1, 1).add_(bottom.sum(dim, keepdim=True))
    return out


def pad_fold(g: torch.Tensor, p: int, mode: str) -> torch.Tensor:
    """The transpose of ``F.pad(x, (p, p, p, p), mode=mode)`` on an NCHW
    cotangent (``mode`` reflect or replicate): H first, then W. Returns a
    contiguous tensor of x's shape; no atomics, no index ops."""
    if p == 0:
        return g.contiguous()
    return _fold_edges(_fold_edges(g, p, p, mode, 2), p, p, mode, 3)


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


class PadEdges(torch.autograd.Function):
    """``F.pad(x, (left, right, top, bottom), mode)`` (reflect or
    replicate) with the fold of each edge as its backward, H first: the
    pads of a band, which pads only the image's global top and bottom
    (``parallel/spatial.py``)."""

    @staticmethod
    def forward(ctx, x, top, bottom, left, right, mode):
        ctx.pads, ctx.mode = (top, bottom, left, right), mode
        return F.pad(x, (left, right, top, bottom), mode=mode)

    @staticmethod
    def backward(ctx, g):
        top, bottom, left, right = ctx.pads
        g = _fold_edges(g, top, bottom, ctx.mode, 2)
        return (_fold_edges(g, left, right, ctx.mode, 3), None, None, None,
                None, None)


_FUNCTIONS = {"reflect": ReflectPad2d, "replicate": ReplicatePad2d}


def pad2d(x: torch.Tensor, p: int, mode: str) -> torch.Tensor:
    """Pad H and W of an NCHW tensor by ``p`` (torch ``ReflectionPad2d`` /
    ``ReplicationPad2d``) through the mode's Function."""
    if p == 0:
        return x
    if mode not in _FUNCTIONS:
        raise NotImplementedError(f"pad mode [{mode}]")
    return _FUNCTIONS[mode].apply(x, p)


def pad_edges(x: torch.Tensor, top: int, bottom: int, left: int, right: int,
              mode: str) -> torch.Tensor:
    """Pad an NCHW tensor by ``top``/``bottom`` rows and ``left``/``right``
    columns: zeros (``mode`` zero, ``F.pad``'s own backward slices), or
    reflect/replicate through ``PadEdges``."""
    if not (top or bottom or left or right):
        return x
    if mode == "zero":
        return F.pad(x, (left, right, top, bottom))
    if mode not in _FUNCTIONS:
        raise NotImplementedError(f"pad mode [{mode}]")
    return PadEdges.apply(x, top, bottom, left, right, mode)
