"""Building-block layers (counterpart of ``pcgan_tpu/models/layers.py``).

Modules compute in NCHW; weights are stored in PyTorch's own layouts
(Conv2d ``(Cout, Cin, kH, kW)``, ConvTranspose2d ``(Cin, Cout, kH, kW)``)
as f32 parameters. Each conv casts its input and weight to the module's
compute dtype per layer, as the JAX modules do (``layers.py:180``), rather
than relying on autocast: in bf16 the conv runs in bf16 with f32
accumulation, an f32 bias add promotes, and the result is cast back.

The convs are ``torch.nn.functional.conv2d`` / ``conv_transpose2d`` (cuDNN on
the card), as the JAX package leaves them to XLA. With ``quant`` set (the
G trunk under ``--quant_int8``) a conv runs in int8 instead
(``ops/quant.py``), with the JAX package's three activation-scale modes
(``layers.py:88-110``). The bf16-only
``--lowch_matmul`` reformulations of the stem/tail convs compute the same
function in real arithmetic; the port runs the plain conv for them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import math

import torch
import torch.nn.functional as F
from torch import nn

# --------------------------------------------------------------------------- #
# init (normal | xavier | kaiming | orthogonal), JAX semantics
# --------------------------------------------------------------------------- #

# jax.nn.initializers.truncated_normal's std correction for a [-2, 2] cut
_TRUNC_STD = 0.87962566103423978


def _fans(shape: Sequence[int]):
    """(fan_in, fan_out) of an HWIO conv kernel or an (in, out) Dense
    kernel: the receptive field times the in / out width."""
    *rf, ci, co = shape
    return ci * math.prod(rf), co * math.prod(rf)


def _orthogonal(shape, gain, generator):
    """jax.nn.initializers.orthogonal(scale=gain, column_axis=-1)."""
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    transpose = n_rows < n_cols
    a = torch.randn((n_cols, n_rows) if transpose else (n_rows, n_cols),
                    generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if transpose:
        q = q.T
    return (gain * q).reshape(shape).float()


def make_initializer(init_type: str, init_gain: float) -> Callable:
    """Returns init(shape_hwio, generator) -> f32 tensor of that HWIO shape,
    with the JAX package's fan conventions (``layers.py:39-54``)."""
    if init_type == "normal":
        return lambda shape, g: torch.randn(shape, generator=g) * init_gain
    if init_type == "xavier":
        # torch xavier_normal_(gain=g): std = g * sqrt(2 / (fan_in + fan_out))
        def xavier(shape, g):
            fi, fo = _fans(shape)
            return torch.randn(shape, generator=g) * (
                init_gain * math.sqrt(2.0 / (fi + fo)))
        return xavier
    if init_type == "kaiming":
        # jax he_normal: truncated normal (+-2 std), std = sqrt(2 / fan_in)
        def kaiming(shape, g):
            std = math.sqrt(2.0 / _fans(shape)[0]) / _TRUNC_STD
            t = torch.empty(shape)
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)
            return t
        return kaiming
    if init_type == "orthogonal":
        return lambda shape, g: _orthogonal(shape, init_gain, g)
    raise NotImplementedError(f"init_type [{init_type}] not implemented")


def init_weights(module: nn.Module, init: Callable,
                 generator: Optional[torch.Generator]) -> None:
    """Draw every conv kernel with ``init`` (in HWIO, converted to the
    module's layout) and every Linear kernel (in flax's (in, out), then
    transposed) in module order; biases start at zero."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (TorchConv, TorchConvTranspose)):
                m.weight.copy_(m.weight_from_hwio(
                    init(m.hwio_shape(), generator)))
            elif isinstance(m, nn.Linear):
                m.weight.copy_(init((m.in_features, m.out_features),
                                    generator).T)
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()


# --------------------------------------------------------------------------- #
# convs
# --------------------------------------------------------------------------- #

_PAD_MODES = {"reflect": "reflect", "replicate": "replicate"}


class _QuantSite(nn.Module):
    """The int8 PTQ state of one conv (``quant=True``).

    ``act_absmax`` (a non-persistent buffer, so G checkpoints are unchanged,
    as the JAX ``quant`` collection lives beside the params) selects the
    activation scale:
    - while ``calibrating`` (``ops.quant.calibrate_quant``): record the
      running max of ``|xd|`` and quantize dynamically;
    - calibrated (``act_absmax`` set): the static ``max(absmax, 1e-12)/127``;
    - uncalibrated (None): dynamic per-tensor quantization.
    ``freeze_weight`` stores the int8 weight matrix and its scales
    (``w_q``, ``w_scale``), used instead of quantizing on each call."""

    def _init_quant(self, quant: bool) -> None:
        self.quant = quant
        self.calibrating = False
        if quant:
            self.register_buffer("act_absmax", None, persistent=False)
            self.register_buffer("w_q", None, persistent=False)
            self.register_buffer("w_scale", None, persistent=False)

    def _act_scale(self, xd: torch.Tensor) -> Optional[torch.Tensor]:
        if self.calibrating:
            cur = xd.float().abs().amax()
            self.act_absmax = (cur if self.act_absmax is None
                               else torch.maximum(self.act_absmax, cur))
            return None
        if self.act_absmax is not None:
            from pcgan_tpu_torch.ops.quant import scale_of
            return scale_of(self.act_absmax)
        return None

    def conv_weight(self) -> torch.Tensor:
        """The OIHW f32 weight of the conv that the int8 path computes."""
        return self.weight

    def freeze_weight(self) -> None:
        from pcgan_tpu_torch.ops.quant import quantize_conv_weight
        with torch.no_grad():
            self.w_q, self.w_scale = quantize_conv_weight(self.conv_weight())

    def _int8_conv(self, xd: torch.Tensor, stride: int, padding,
                   dilation: int = 1, scale_from=None) -> torch.Tensor:
        """``scale_from``: the tensor whose absmax sets the scale (the
        pre-pad activation of a reflect/replicate conv; padding by
        reflection cannot raise it)."""
        from pcgan_tpu_torch.ops.quant import int8_conv
        qweight = None if self.w_q is None else (self.w_q, self.w_scale)
        return int8_conv(xd, self.conv_weight(), stride, padding,
                         lhs_dilation=dilation, out_dtype=self.compute_dtype,
                         act_scale=self._act_scale(
                             xd if scale_from is None else scale_from),
                         qweight=qweight)


class TorchConv(_QuantSite):
    """torch ``nn.Conv2d(in, out, k, stride=s, padding=p, bias=b)`` with
    zero, reflect or replicate padding, computing in ``dtype`` (in int8
    with ``quant``)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, pad_mode: str = "zero",
                 use_bias: bool = True, dtype=torch.float32,
                 quant: bool = False):
        super().__init__()
        if pad_mode not in ("zero", *_PAD_MODES):
            raise NotImplementedError(f"pad_mode [{pad_mode}]")
        self.stride, self.padding, self.pad_mode = stride, padding, pad_mode
        self.compute_dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self._init_quant(quant)

    def hwio_shape(self):
        co, ci, kh, kw = self.weight.shape
        return (kh, kw, ci, co)

    @staticmethod
    def weight_from_hwio(k: torch.Tensor) -> torch.Tensor:
        return k.permute(3, 2, 0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xd = x.to(self.compute_dtype)
        p = self.padding
        xp = xd
        if p and self.pad_mode != "zero":
            xp = F.pad(xd, (p, p, p, p), mode=_PAD_MODES[self.pad_mode])
        zero_pad = p if self.pad_mode == "zero" else 0
        if self.quant:
            y = self._int8_conv(xp, self.stride,
                                ((zero_pad, zero_pad), (zero_pad, zero_pad)),
                                scale_from=xd)
        else:
            y = F.conv2d(xp, self.weight.to(self.compute_dtype),
                         stride=self.stride, padding=zero_pad)
        if self.bias is not None:
            y = y + self.bias.view(1, -1, 1, 1)
        return y.to(self.compute_dtype)


class TorchConvTranspose(_QuantSite):
    """torch ``nn.ConvTranspose2d(in, out, k, stride=s, padding=p,
    output_padding=op)``; output size ``(H-1)*s - 2p + k + op``. With
    ``quant``, the JAX package's lowering in int8 (``layers.py:341-350``):
    the flipped kernel over the input with ``s - 1`` zeros inserted
    between pixels, padded ``(k-1-p, k-1-p+op)``."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 2, padding: int = 1, output_padding: int = 1,
                 use_bias: bool = True, dtype=torch.float32,
                 quant: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self.compute_dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(in_ch, features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self._init_quant(quant)

    def hwio_shape(self):
        ci, co, kh, kw = self.weight.shape
        return (kh, kw, ci, co)

    @staticmethod
    def weight_from_hwio(k: torch.Tensor) -> torch.Tensor:
        # the JAX kernel (kH, kW, Cin, Cout) is the torch weight transposed;
        # JAX flips it spatially at apply time (pcgan_tpu/utils/pth_export.py)
        return k.permute(2, 3, 0, 1)

    def conv_weight(self) -> torch.Tensor:
        from pcgan_tpu_torch.ops.quant import deconv_as_conv_weight
        return deconv_as_conv_weight(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            k = self.weight.shape[2]
            lo = k - 1 - self.padding
            hi = lo + self.output_padding
            y = self._int8_conv(x.to(self.compute_dtype), 1,
                                ((lo, hi), (lo, hi)), dilation=self.stride)
        else:
            y = F.conv_transpose2d(
                x.to(self.compute_dtype), self.weight.to(self.compute_dtype),
                stride=self.stride, padding=self.padding,
                output_padding=self.output_padding)
        if self.bias is not None:
            y = y + self.bias.view(1, -1, 1, 1)
        return y.to(self.compute_dtype)


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch ``InstanceNorm2d(affine=False, track_running_stats=False)`` on
    NCHW, in the JAX package's two forms (``layers.py:401-420``).

    f32: exact two-pass mean/var. bf16: single-pass E[x^2]-E[x]^2 with f32
    accumulation (x*x rounds in bf16, as in JAX), output cast to bf16.
    """
    if x.dtype == torch.float32:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps)
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    mean2 = (x * x).float().mean(dim=(2, 3), keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class Norm(nn.Module):
    """Dispatch on ``--norm``: instance | none (batch and group are not
    ported yet)."""

    def __init__(self, kind: str = "instance"):
        super().__init__()
        if kind not in ("instance", "none"):
            raise NotImplementedError(
                f"--norm {kind} is not ported to pcgan_tpu_torch yet "
                f"(instance | none)")
        self.kind = kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x) if self.kind == "instance" else x


def norm_uses_bias(kind: str) -> bool:
    """The reference template disables conv bias when the following norm has
    affine params (batch); instance norm (no affine) keeps conv bias."""
    return kind != "batch"


def conv_bias_before_norm(kind: str) -> bool:
    """Whether a conv IMMEDIATELY followed by this norm carries a bias:
    instance (affine=False) and batch remove a per-channel constant exactly,
    so the JAX package drops those biases; group and none keep them."""
    return kind in ("group", "none")
