"""Int8 post-training quantization of the G trunk for inference
(counterpart of ``pcgan_tpu/ops/quant.py``).

The JAX package's scheme, unchanged:

- weights: per-output-channel symmetric int8, ``scale = max(absmax,
  1e-12) / 127`` over everything but the output channel;
- activations: per-tensor symmetric int8, from a calibrated static absmax
  (``calibrate_quant``) or, uncalibrated, from the tensor's own absmax on
  every call;
- accumulation in int32, dequantized as ``y_s32 * (xs * ws)`` in f32 and
  cast to the compute dtype. A transposed conv is the same conv over the
  input with zeros inserted between its pixels (exact in int8).

JAX hands XLA an int8 ``conv_general_dilated``. Here the conv is an im2col
(``Tensor.unfold`` over the padded int8 input) and ONE s8 x s8 -> s32
product, ``torch._int_mm``: cuBLASLt's integer GEMM on the card, ATen's on
the CPU. Integer sums are exact, so the card and the CPU give the same s32
accumulators bit for bit, and the same dequantized outputs.

``torch._int_mm`` on the card wants M > 16 and K, N multiples of 8, with
the second operand column-major. K is made a multiple of 8 by zero input
channels (exact in integers); the weight matrix is kept as (Cout, K)
row-major and passed transposed. A product that the library refuses raises;
nothing falls back to another route.

Every scale is ``max(absmax, 1e-12) / 127`` by true division
(``scale_of``). A CUDA op that divides by a Python number (a CPU scalar)
multiplies by its f32 reciprocal instead, which is an ulp off for some
absmaxes and flips the rounding of the values on a boundary; so the 127
is a tensor on the absmax's own device, and the card quantizes as the CPU
and the JAX package do.

Inference only: ``round`` has no gradient, and the training CLI rejects
``--quant_int8``.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Pads = Sequence[Tuple[int, int]]


def scale_of(absmax: torch.Tensor) -> torch.Tensor:
    """``max(absmax, 1e-12) / 127`` in f32, by true division on every
    device (see the module docstring)."""
    return torch.clamp(absmax, min=1e-12) / absmax.new_full((), 127.0)


def quantize_weight(weight: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an OIHW conv weight (f32) ->
    (int8 weight, (Cout,) f32 scales). The JAX package reduces its HWIO
    kernel over (kh, kw, cin): the same sets of values."""
    w = weight.float()
    scale = scale_of(w.abs().amax(dim=(1, 2, 3)))
    q = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8: the scale from the tensor's own
    absmax (a 0-d f32 tensor)."""
    scale = scale_of(x.float().abs().amax())
    return quantize_act_static(x, scale), scale


def quantize_act_static(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 of ``x`` at a given scale (``torch.round``: half to even, as
    ``jnp.round``)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def deconv_as_conv_weight(weight: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d's (Cin, Cout, k, k) -> the OIHW weight of the
    equivalent conv over the zero-inserted input: transposed and flipped
    spatially (the JAX package's ``jnp.flip(kernel, (0, 1))`` of HWIO)."""
    return weight.permute(1, 0, 2, 3).flip(2, 3)


def _k_pad(cin: int, kh: int, kw: int) -> int:
    """Zero input channels that make K = cin * kh * kw a multiple of 8."""
    return (-cin) % (8 // math.gcd(8, kh * kw))


def weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """int8 OIHW weight -> (Cout, K) row-major, K = Cin_pad * kh * kw in
    (cin, kh, kw) order, the columns of ``im2col_int8``."""
    co, ci, kh, kw = wq.shape
    cp = _k_pad(ci, kh, kw)
    if cp:
        wq = F.pad(wq, (0, 0, 0, 0, 0, cp))
    return wq.reshape(co, -1).contiguous()


def quantize_conv_weight(weight: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW f32 -> (the (Cout, K) int8 matrix, (Cout,) f32 scales): what
    every call computes from the f32 weight, or what an export stores."""
    wq, ws = quantize_weight(weight)
    return weight_matrix(wq), ws


def im2col_int8(xq: torch.Tensor, kernel: Tuple[int, int],
                stride: int, padding: Pads, dilation: int = 1):
    """(N, C, H, W) int8 -> ((N*Ho*Wo, K) int8, (N, Ho, Wo)): zero
    padding ``((lo, hi), (lo, hi))``, ``dilation - 1`` zeros between input
    pixels (``lhs_dilation``), zero channels up to a K that is a multiple
    of 8, then the (cin, kh, kw) patch of every output pixel."""
    kh, kw = kernel
    n, c, h, w = xq.shape
    (hlo, hhi), (wlo, whi) = padding
    cp = _k_pad(c, kh, kw)
    if dilation == 1:
        xp = F.pad(xq, (wlo, whi, hlo, hhi, 0, cp))
    else:
        hd, wd = (h - 1) * dilation + 1, (w - 1) * dilation + 1
        xp = xq.new_zeros((n, c + cp, hlo + hd + hhi, wlo + wd + whi))
        xp[:, :c, hlo:hlo + hd:dilation, wlo:wlo + wd:dilation] = xq
    cols = xp.unfold(2, kh, stride).unfold(3, kw, stride)  # N,C,Ho,Wo,kh,kw
    ho, wo = cols.shape[2], cols.shape[3]
    a = cols.permute(0, 2, 3, 1, 4, 5).reshape(n * ho * wo, -1)
    return a, (n, ho, wo)


def int8_conv_accum(xq: torch.Tensor, wmat: torch.Tensor,
                    kernel: Tuple[int, int], stride: int, padding: Pads,
                    dilation: int = 1):
    """The s32 accumulators of the int8 conv, ((N*Ho*Wo, Cout) int32,
    (N, Ho, Wo)): the im2col times the (Cout, K) weight matrix, passed
    transposed (column-major, as cuBLASLt's integer GEMM takes it). Exact:
    card and CPU agree on them bit for bit."""
    a, geom = im2col_int8(xq, kernel, stride, padding, dilation)
    n, ho, wo = geom
    if ho * wo <= 16:
        # cuBLASLt's int8 GEMM wants more than 16 rows; a U-Net's innermost
        # level has one pixel a sample. Zero rows give zero sums, dropped.
        # Decided on the static pixel count, so an export with a symbolic
        # batch pads for every batch size
        m = a.shape[0]
        return torch._int_mm(F.pad(a, (0, 0, 0, 16)), wmat.t())[:m], geom
    return torch._int_mm(a, wmat.t()), geom


def int8_conv(x: torch.Tensor, weight: torch.Tensor, stride: int,
              padding: Pads, lhs_dilation: int = 1,
              out_dtype=torch.bfloat16,
              act_scale: Optional[torch.Tensor] = None,
              qweight: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """Quantize, conv in int8, dequantize: x (N, C, H, W) in any float
    dtype, ``weight`` the OIHW f32 conv weight (``deconv_as_conv_weight``
    for a transposed conv) -> (N, Cout, Ho, Wo) in ``out_dtype``.

    ``act_scale``: a calibrated static scale (absmax / 127); None quantizes
    dynamically per tensor. ``qweight``: the ``quantize_conv_weight`` of
    ``weight``, when it was computed once beforehand (the same numbers)."""
    if act_scale is None:
        xq, xs = quantize_act(x)
    else:
        xs = act_scale
        xq = quantize_act_static(x, xs)
    wmat, ws = qweight if qweight is not None else \
        quantize_conv_weight(weight)
    acc, (n, ho, wo) = int8_conv_accum(
        xq, wmat, tuple(weight.shape[2:]), stride, padding, lhs_dilation)
    y = (acc.float() * (xs * ws)).to(out_dtype)
    return y.reshape(n, ho, wo, -1).permute(0, 3, 1, 2)


def quant_sites(module: torch.nn.Module) -> list:
    """The (name, module) pairs of ``module`` that quantize (``quant``
    set), in module order."""
    return [(name, m) for name, m in module.named_modules()
            if getattr(m, "quant", False)]


@torch.no_grad()
def calibrate_quant(module: torch.nn.Module,
                    batches: Iterable[tuple]) -> torch.nn.Module:
    """Run ``module(*args)`` for each args tuple of ``batches`` and record,
    at every quantizing site, the running max of its activation's absmax
    (``act_absmax``). Afterwards the sites quantize with these STATIC
    scales; calibration passes themselves quantize dynamically. Returns
    ``module``."""
    sites = [m for _, m in quant_sites(module)]
    for m in sites:
        m.calibrating = True
    try:
        for args in batches:
            module(*args)
    finally:
        for m in sites:
            m.calibrating = False
    return module


def act_absmaxes(module: torch.nn.Module) -> dict:
    """{site name: its calibrated absmax (0-d f32 tensor) or None}."""
    return {name: m.act_absmax for name, m in quant_sites(module)}


def set_act_absmaxes(module: torch.nn.Module, absmaxes: dict) -> None:
    """Set the sites' calibrated absmaxes from ``{site name: value}``;
    every site must be named."""
    sites = dict(quant_sites(module))
    if set(absmaxes) != set(sites):
        raise ValueError(f"absmaxes name {sorted(absmaxes)}, the module's "
                         f"quantizing sites are {sorted(sites)}")
    for name, v in absmaxes.items():
        ref = next(iter(sites[name].parameters()))
        sites[name].act_absmax = torch.as_tensor(
            v, dtype=torch.float32).reshape(()).to(ref.device)


def freeze_quant_weights(module: torch.nn.Module) -> torch.nn.Module:
    """Quantize every site's weight once and keep the int8 matrix and
    scales as buffers, which the sites then use instead of quantizing the
    f32 weight on each call: the same numbers, fewer passes (what an export
    stores). Returns ``module``."""
    for _, m in quant_sites(module):
        m.freeze_weight()
    return module
