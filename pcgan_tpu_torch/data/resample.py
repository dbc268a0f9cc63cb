"""Pillow's 8-bit resize in numpy, bit for bit (no Pillow needed).

``resample`` reproduces ``PIL.Image.resize`` on an RGB u8 image for the
bicubic, bilinear and nearest filters (Pillow's ``Resample.c``
``ImagingResample`` and ``Geometry.c`` ``ImagingScaleAffine``):

- per axis, each output pixel's taps are the filter (in Pillow's own
  arithmetic, double precision) over ``[int(center - support + 0.5),
  int(center + support + 0.5))``, normalized by their sum, then rounded
  to fixed point with 22 fraction bits;
- the horizontal pass, then the vertical pass, each an integer sum that
  starts at half an LSB and is shifted and clipped to u8; a pass is
  skipped when its axis keeps its size;
- nearest takes source index ``int(x)`` of a position that starts at half
  a step and is advanced by one step per output pixel, in double.

``pil_resize_np`` is the square form the loader, the pack writer and the
folder decode use (counterpart of ``pcgan_tpu/data/loader.py:169-184``).
"""

from __future__ import annotations

import functools

import numpy as np

PIL_RESIZE_METHODS = ("bicubic", "bilinear", "nearest")
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x):
    # Pillow's bicubic_filter (a = -0.5), in its Horner form
    x = np.abs(x)
    return np.where(
        x < 1.0, ((1.5 * x - 2.5) * x) * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5, 0.0))


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


@functools.lru_cache(maxsize=128)
def _coeffs(in_size: int, out_size: int, method: str):
    """(first tap (out,), fixed-point taps (out, K) int32) of one axis,
    ``precompute_coeffs`` + ``normalize_coeffs_8bpc``; taps past an output
    pixel's span are 0."""
    fil, support = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    k = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for x in range(ksize):        # in tap order, as Pillow sums them
        w = np.where(x < xmax, fil(((x + xmin) - center + 0.5) * ss), 0.0)
        k[:, x] = w
        ww = ww + w
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    scaled = k * float(1 << _PRECISION_BITS)
    kk = np.trunc(np.where(k < 0, scaled - 0.5, scaled + 0.5)).astype(np.int32)
    kk.setflags(write=False)
    return xmin, kk


def _pass(a: np.ndarray, axis: int, out_size: int, method: str) -> np.ndarray:
    """One separable pass of ``a`` (H, W, C) u8 along ``axis`` (1 =
    horizontal, 0 = vertical) to ``out_size``."""
    n = a.shape[axis]
    xmin, kk = _coeffs(n, out_size, method)
    shape = list(a.shape)
    shape[axis] = out_size
    # int32 sums, as Pillow's: |sum| <= 255 * 2^22 * sum|w|, and sum|w| is
    # at most 1.25 for these filters, below 2^31
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int32)
    for t in range(kk.shape[1]):
        src = np.take(a, np.minimum(xmin + t, n - 1), axis=axis)
        w = kk[:, t, None] if axis == 1 else kk[:, t, None, None]
        acc += src.astype(np.int32) * w
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    step = in_size / out_size
    pos = np.cumsum(np.concatenate([[step * 0.5],
                                    np.full(out_size - 1, step)]))
    return np.minimum(pos.astype(np.int64), in_size - 1)


def resample(img: np.ndarray, out_h: int, out_w: int,
             method: str = "bicubic") -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((out_w, out_h), method)`` for an
    (H, W, 3) u8 array, bit for bit."""
    if method not in PIL_RESIZE_METHODS:
        raise ValueError(f"resize method [{method}] (want one of "
                         f"{PIL_RESIZE_METHODS})")
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resample takes an (H, W, C) u8 array, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.copy()
    if method == "nearest":
        return img[_nearest_index(h, out_h)][:, _nearest_index(w, out_w)]
    out = img
    if out_w != w:
        out = _pass(out, 1, out_w, method)
    if out_h != h:
        out = _pass(out, 0, out_h, method)
    return out


def pil_resize_np(img: np.ndarray, size: int,
                  method: str = "bicubic") -> np.ndarray:
    """Resize one u8 HWC array to (size, size) as PIL does; the array itself
    when both spatial sizes already match. The host-resize primitive of the
    live loader (``--host_resize``), the pack writer (``--resize_to``) and
    the folder decode, so their rows agree by construction."""
    if img.shape[:2] == (size, size):
        return img
    return resample(img, size, size, method)
