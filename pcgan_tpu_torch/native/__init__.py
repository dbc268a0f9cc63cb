"""The host JPEG decoder of the port (counterpart of ``pcgan_tpu/native``).

``jpeg_decoder.cc`` is a C++ thread pool over libjpeg: one ctypes call
decodes a batch of files straight into one contiguous u8 numpy buffer, with
the GIL released. It is built at first use by ``g++`` into
``build/pcgan_tpu_torch/`` (``ops/_build.py``), under the build's file
lock. A missing compiler or libjpeg raises (``JpegUnavailable`` for
libjpeg): the port keeps no JPEG decode path without it
(``PCGAN_NO_NATIVE`` is not read). Folders of PNGs never reach it.

A full-scale decode is bit-identical to ``PIL.Image.open(p).convert("RGB")``
for baseline, progressive and greyscale JPEGs; what it cannot serve exactly
comes back as a per-image status (``E_DIMS``, ``E_COLOR``, ...), and the
caller handles that image (``data/utkface.py``).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence, Tuple

import numpy as np

# status codes (mirror jpeg_decoder.cc)
OK, E_OPEN, E_DECODE, E_DIMS, E_COLOR = 0, 1, 2, 3, 4
# libjpeg's J_COLOR_SPACE values that pcgan_probe_file reports
JCS_GRAYSCALE, JCS_RGB, JCS_YCbCr, JCS_CMYK, JCS_YCCK = 1, 2, 3, 4, 5

_lock = threading.Lock()
_lib = None
# what g++ says when libjpeg's header or library is not installed
_NO_LIBJPEG = ("jpeglib.h: No such file", "cannot find -ljpeg")


class JpegUnavailable(RuntimeError):
    """This host has no libjpeg (header or library) to build the decoder."""


def load() -> ctypes.CDLL:
    """The decoder library, built at the first call; raises
    ``JpegUnavailable`` when libjpeg is missing, RuntimeError when g++ is
    missing or the build fails otherwise."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            from pcgan_tpu_torch.ops._build import build_host
            try:
                path = build_host("pcgan_jpeg", "native/jpeg_decoder.cc")
            except RuntimeError as e:
                if any(s in str(e) for s in _NO_LIBJPEG):
                    raise JpegUnavailable(
                        "JPEG decoding needs libjpeg's header and library "
                        "(jpeglib.h, libjpeg.so; e.g. the libjpeg-turbo "
                        "development package), which this host lacks; "
                        f"folders of PNGs decode without it. {e}") from None
                raise
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:      # built elsewhere, no libjpeg.so here
                if "libjpeg" in str(e):
                    raise JpegUnavailable(
                        f"the JPEG decoder {path} cannot load libjpeg on this "
                        f"host: {e}") from None
                raise
            u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(
                ctypes.c_int)
            lib.pcgan_decode_batch.restype = ctypes.c_int
            lib.pcgan_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u8p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ip, ctypes.c_int]
            lib.pcgan_decode_file.restype = ctypes.c_int
            lib.pcgan_decode_file.argtypes = [
                ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
            lib.pcgan_probe_file.restype = ctypes.c_int
            lib.pcgan_probe_file.argtypes = [ctypes.c_char_p, ip, ip, ip]
            lib.pcgan_jpeg_abi.restype = ctypes.c_int
            lib.pcgan_jpeg_turbo_version.restype = ctypes.c_int
            _lib = lib
    return _lib


def jpeg_abi() -> int:
    """libjpeg's ABI version (62/70/80)."""
    return int(load().pcgan_jpeg_abi())


def jpeg_turbo_version() -> int:
    """libjpeg-turbo's version as MMMmmmppp, 0 for another libjpeg."""
    return int(load().pcgan_jpeg_turbo_version())


def probe(path: str) -> Tuple[int, int, int, int]:
    """(status, width, height, colour space) from the JPEG header alone
    (``jpeg_read_header``; no pixel is decoded). Status is OK, E_OPEN or
    E_DECODE; the rest is 0 unless OK."""
    w, h, cs = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    st = load().pcgan_probe_file(os.fsencode(path), ctypes.byref(w),
                                 ctypes.byref(h), ctypes.byref(cs))
    return int(st), w.value, h.value, cs.value


def decode_batch(paths: Sequence[str], height: int, width: int,
                 threads: int = 8, out: np.ndarray = None,
                 scale_num: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Decode ``paths`` into an (N, height, width, 3) u8 RGB batch with the
    C++ thread pool. ``scale_num``/8 applies libjpeg's DCT-domain downscale
    (height and width are then the scaled sizes); 8 is the full-scale,
    PIL-exact decode. Returns (batch, status): status[i] != OK means image
    i was not written and the caller fills that slot."""
    lib = load()
    n = len(paths)
    if out is None:
        out = np.empty((n, height, width, 3), np.uint8)
    elif (out.shape != (n, height, width, 3) or out.dtype != np.uint8
          or not out.flags.c_contiguous):
        # an explicit check, not an assert: the C++ side writes n*h*w*3
        # bytes into this buffer
        raise ValueError(
            f"out buffer must be C-contiguous uint8 of shape "
            f"{(n, height, width, 3)}, got {out.dtype} {out.shape}")
    status = np.zeros(n, np.int32)
    if n == 0:
        return out, status
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.pcgan_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        height, width, int(threads),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), int(scale_num))
    return out, status


def decode_file(path: str, height: int, width: int,
                scale_num: int = 8) -> Tuple[np.ndarray, int]:
    """One file into a new (height, width, 3) u8 array: (image, status)."""
    out = np.empty((height, width, 3), np.uint8)
    st = load().pcgan_decode_file(
        os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        height, width, int(scale_num))
    return out, int(st)
