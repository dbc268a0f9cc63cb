"""Kernel B2: weight gradient of a stride-1 VALID conv with tiny C_out.

Replaces ``pcgan_tpu/ops/pallas_wgrad.py`` ``conv_wgrad_lowcout``::

    dW[i, j, ci, co] = sum_{b,h,w} x_pad[b, h+i, w+j, ci] * dy[b, h, w, co]

The CUDA C++ source is ``pcgan_tpu_torch/csrc/wgrad.cu`` (route: nvcc ->
shared library -> ctypes); its header comment gives the design and the
bound. ``wgrad_cuda`` takes CUDA tensors only: it launches the kernel or
raises. ``wgrad_plain`` is the plain PyTorch version of the same function.
``conv_wgrad_lowcout`` chooses between them by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pcgan_tpu_torch.ops import _build

SOURCE = "wgrad.cu"
MAX_COUT = 8

# kernel launches made by this wrapper (one per call: both passes of the
# kernel); chip_smoke.py zeroes and reads it around the paths it drives
launches = 0

_IN_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib():
    lib = _build.load("pcgan_wgrad", SOURCE)
    lib.pcgan_wgrad_nparts.argtypes = [ctypes.c_int] * 6
    lib.pcgan_wgrad_nparts.restype = ctypes.c_int
    lib.pcgan_wgrad.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                                + [ctypes.c_void_p])
    lib.pcgan_wgrad.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel now (first use does it otherwise)."""
    _lib()


def _check(x_pad: torch.Tensor, dy: torch.Tensor, k: int):
    if x_pad.dim() != 4 or dy.dim() != 4:
        raise ValueError(f"wgrad: want x_pad (B,Hp,Wp,Cin) and dy (B,H,W,Cout),"
                         f" got {tuple(x_pad.shape)} and {tuple(dy.shape)}")
    b, hp, wp, _ = x_pad.shape
    want = (b, hp - k + 1, wp - k + 1)
    if tuple(dy.shape[:3]) != want:
        raise ValueError(f"wgrad: dy {tuple(dy.shape)} does not match x_pad "
                         f"{tuple(x_pad.shape)} at k {k} (want {want} + Cout)")


def wgrad_plain(x_pad: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: one f32 contraction over (b, h, w) per tap.
    Returns (k, k, Cin, Cout) f32."""
    _check(x_pad, dy, k)
    _, hp, wp, cin = x_pad.shape
    h, w, cout = dy.shape[1:]
    dyf = dy.float()
    dw = torch.empty((k, k, cin, cout), dtype=torch.float32,
                     device=x_pad.device)
    for i in range(k):
        for j in range(k):
            dw[i, j] = torch.einsum("bhwc,bhwo->co",
                                    x_pad[:, i:i + h, j:j + w].float(), dyf)
    return dw


def wgrad_cuda(x_pad: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors x_pad (B, Hp, Wp, Cin) and dy
    (B, Hp-k+1, Wp-k+1, Cout), contiguous NHWC, both f32 or both bf16,
    1 <= Cout <= 8. Returns (k, k, Cin, Cout) f32 on the same device,
    enqueued on the current stream."""
    global launches
    _check(x_pad, dy, k)
    if x_pad.device.type != "cuda" or dy.device != x_pad.device:
        raise ValueError(f"wgrad kernel: x_pad on {x_pad.device}, dy on "
                         f"{dy.device}; want one cuda device")
    if x_pad.dtype not in _IN_DTYPES or dy.dtype != x_pad.dtype:
        raise ValueError(f"wgrad kernel: want x_pad and dy both in "
                         f"{_IN_DTYPES}, got {x_pad.dtype} and {dy.dtype}")
    if not (x_pad.is_contiguous() and dy.is_contiguous()):
        raise ValueError("wgrad kernel: x_pad and dy must be contiguous NHWC")
    b, hp, wp, cin = x_pad.shape
    cout = dy.shape[3]
    if not 1 <= cout <= MAX_COUT:
        raise ValueError(f"wgrad kernel: Cout {cout} not in [1, {MAX_COUT}]")
    dev = x_pad.device
    out = torch.empty((k, k, cin, cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        lib = _lib()
        nparts = lib.pcgan_wgrad_nparts(b, hp, wp, cin, cout, k)
        if nparts <= 0:
            raise ValueError(f"wgrad kernel: shapes x_pad {tuple(x_pad.shape)}"
                             f", Cout {cout}, k {k} not supported (CUDA "
                             f"error {-nparts})")
        scratch = torch.empty((nparts, out.numel()), dtype=torch.float32,
                              device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pcgan_wgrad(x_pad.data_ptr(), dy.data_ptr(),
                              scratch.data_ptr(), out.data_ptr(),
                              int(x_pad.dtype == torch.bfloat16),
                              b, hp, wp, cin, cout, k, nparts, stream)
    if err != 0:
        raise RuntimeError(f"wgrad kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def conv_wgrad_lowcout(x_pad: torch.Tensor, dy: torch.Tensor,
                       k: int) -> torch.Tensor:
    """dW (k, k, Cin, Cout) f32: the kernel on a CUDA tensor, the plain
    version on a CPU tensor; any other device raises."""
    if x_pad.device.type == "cuda":
        return wgrad_cuda(x_pad.contiguous(), dy.contiguous(), k)
    if x_pad.device.type == "cpu":
        return wgrad_plain(x_pad, dy, k)
    raise ValueError(f"wgrad: unsupported device {x_pad.device}")
