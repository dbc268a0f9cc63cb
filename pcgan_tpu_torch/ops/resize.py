"""PIL-matching resize matrices (host-side numpy, cached).

A PIL-style antialiased resize is linear and separable: along each axis it is
a product with an (out_size, in_size) matrix. ``resize_matrix`` is a
bit-for-bit copy of ``pcgan_tpu/ops/preprocess.py``'s, so both packages
resize identically. The plain preprocessing (ops/preprocess.py) reads it;
the kernel's wrapper (ops/cuda_preprocess.py) reads its band form,
``resize_band``.
"""

from __future__ import annotations

import functools

import numpy as np


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x, a=-0.5):
    # PIL's cubic filter (Catmull-Rom family, a = -0.5)
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    return np.where(
        x <= 1.0, (a + 2) * x3 - (a + 3) * x2 + 1,
        np.where(x < 2.0, a * x3 - 5 * a * x2 + 8 * a * x - 4 * a, 0.0))


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int, method: str = "bicubic"
                  ) -> np.ndarray:
    """(out_size, in_size) row-stochastic interpolation matrix reproducing
    PIL ``Image.resize`` along one axis (antialiased, PIL's default)."""
    if method == "nearest":
        m = np.zeros((out_size, in_size), np.float32)
        scale = in_size / out_size
        # PIL nearest: src = int(center) with center = (i + 0.5) * scale
        idx = np.minimum((np.arange(out_size) + 0.5) * scale,
                         in_size - 1).astype(np.int64)
        m[np.arange(out_size), idx] = 1.0
        return m
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    fil, support = _FILTERS[method]
    scale = in_size / out_size
    fscale = max(scale, 1.0)                       # antialias on downsample
    sup = support * fscale
    m = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(np.floor(center - sup)), 0)
        hi = min(int(np.ceil(center + sup)) + 1, in_size)
        j = np.arange(lo, hi)
        w = fil((j + 0.5 - center) / fscale)
        s = w.sum()
        if s > 0:
            m[i, lo:hi] = w / s
        else:
            m[i, min(int(center), in_size - 1)] = 1.0
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def resize_band(in_size: int, out_size: int, method: str = "bicubic"
                ) -> tuple[np.ndarray, np.ndarray]:
    """``resize_matrix`` as a band: ``lo`` (out,) int32 and ``taps``
    (out, K) f32 with ``M[y, lo[y] + t] == taps[y, t]`` and M zero outside
    ``[lo[y], lo[y] + K)``. K is the widest span of non-zero weights of any
    row (7 at 200 -> 143 bicubic, 1 for identity and nearest); ``lo`` is
    clamped so that ``lo + K <= in_size`` and is non-decreasing. The taps
    are M's own floats; taps past a row's support are M's zeros."""
    m = resize_matrix(in_size, out_size, method)
    nz = m != 0
    first = nz.argmax(1)
    last = in_size - 1 - nz[:, ::-1].argmax(1)
    k = int((last - first + 1).max())
    lo = np.minimum(first, in_size - k).astype(np.int32)
    taps = np.take_along_axis(m, lo[:, None] + np.arange(k), 1)
    lo.setflags(write=False)
    taps.setflags(write=False)
    return lo, taps
