"""Kernel B1: fused resize + crop + flip + normalize on Hopper.

Replaces ``pcgan_tpu/ops/pallas_preprocess.py`` ``pallas_preprocess_batch``.
The CUDA C++ source is ``pcgan_tpu_torch/csrc/preprocess.cu`` (route: nvcc
-> shared library -> ctypes); its header comment gives the design and the
bound. ``preprocess_batch_cuda`` takes CUDA tensors only: it launches the
kernel or raises. ``ops/preprocess.py make_preprocess`` chooses between it
and the plain version by the batch's device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pcgan_tpu_torch.ops import _build
from pcgan_tpu_torch.ops.resize import resize_band
from pcgan_tpu_torch.utils import tracing

SOURCE = "preprocess.cu"

# kernel launches made by this wrapper; chip_smoke.py zeroes and reads it
# around the main path to show the path went through the kernel
launches = 0

_OUT_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _kernel():
    fn = _build.load("pcgan_preprocess", SOURCE).pcgan_preprocess
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load the kernel now (first use does it otherwise)."""
    _kernel()


@functools.lru_cache(maxsize=32)
def _band_on(in_size: int, out_size: int, method: str,
             device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Device copies of ``resize_band(in_size, out_size, method)``."""
    lo, taps = resize_band(in_size, out_size, method)
    return torch.tensor(lo, device=device), torch.tensor(taps, device=device)


def preprocess_batch_cuda(imgs: torch.Tensor, crop_y: torch.Tensor,
                          crop_x: torch.Tensor, flip: torch.Tensor,
                          load_size: int, crop_size: int,
                          method: str = "bicubic",
                          out_dtype=torch.float32, row0: int = 0,
                          n_rows: int = None) -> torch.Tensor:
    """Launch the kernel on ``imgs`` (B, H, W, C) u8, contiguous, on a CUDA
    device; crop_y/crop_x/flip are (B,) integer/bool tensors. Returns
    (B, crop, crop, C) in ``out_dtype`` (f32 or bf16) on the same device,
    enqueued on the current stream; with ``row0``/``n_rows``, only rows
    [row0, row0 + n_rows) of each crop, (B, n_rows, crop, C): a band of a
    spatial axis (an empty band launches nothing)."""
    global launches
    if imgs.device.type != "cuda":
        raise ValueError(f"preprocess kernel: imgs on {imgs.device}, want cuda")
    if imgs.dtype != torch.uint8 or imgs.dim() != 4:
        raise ValueError(f"preprocess kernel: want (B,H,W,C) uint8, got "
                         f"{tuple(imgs.shape)} {imgs.dtype}")
    if not imgs.is_contiguous():
        raise ValueError("preprocess kernel: imgs must be contiguous NHWC")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"preprocess kernel: out_dtype {out_dtype} not in "
                         f"{_OUT_DTYPES}")
    b, h, w, c = imgs.shape
    if not 0 < crop_size <= load_size:
        raise ValueError(f"preprocess kernel: crop {crop_size} must be in "
                         f"(0, load {load_size}]")
    n_rows = crop_size - row0 if n_rows is None else n_rows
    if row0 < 0 or n_rows < 0 or row0 + n_rows > crop_size:
        raise ValueError(f"preprocess kernel: rows [{row0}, "
                         f"{row0 + n_rows}) are not in a crop of "
                         f"{crop_size}")
    dev = imgs.device
    idx = []
    for name, t in (("crop_y", crop_y), ("crop_x", crop_x), ("flip", flip)):
        if t.shape != (b,):
            raise ValueError(f"preprocess kernel: {name} shape "
                             f"{tuple(t.shape)}, want ({b},)")
        idx.append(tracing.upload(t, dev, torch.int32).contiguous())
    lo_h, taps_h = _band_on(h, load_size, method, dev)
    lo_w, taps_w = _band_on(w, load_size, method, dev)
    out = torch.empty((b, n_rows, crop_size, c), dtype=out_dtype,
                      device=dev)
    if n_rows == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(imgs.data_ptr(), lo_h.data_ptr(), taps_h.data_ptr(),
                        lo_w.data_ptr(), taps_w.data_ptr(),
                        idx[0].data_ptr(), idx[1].data_ptr(),
                        idx[2].data_ptr(), out.data_ptr(),
                        int(out_dtype == torch.bfloat16),
                        b, h, w, c, load_size, crop_size,
                        taps_h.shape[1], taps_w.shape[1], row0, n_rows,
                        stream)
    if err != 0:
        raise RuntimeError(f"preprocess kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out

