"""Low-channel 7x7 conv reformulations (counterpart of ``pcgan_tpu/ops/lowch_conv.py:40-176``).

The resnet generator's stem and tail convs (``ReflectionPad2d(3) +
Conv2d(3+cond -> 64 / 64 -> 3, 7)``) have a tiny channel count on one side.
The JAX package routes them through reformulations that put every
(kernel-tap, channel) pair on the matrix unit's lanes:

    tap-matmul (tiny C_out): P = x_pad @ W[(Cin), (tap, Cout)], then a
                             49-term shifted sum of P's tap slices
    col-matmul (tiny C_in):  the 49 shifted input views on the channel axis
                             (im2col), contracted once with W[(tap, Cin), Cout]

``lowch_reflect_conv`` is reflect pad + stride-1 conv as a
``torch.autograd.Function``: the forward is routed as above; the data
gradient is a conv of the zero-padded cotangent with the flipped kernel
followed by ``reflect_fold`` (the transpose of the reflect pad); the weight
gradient is kernel B2 (``ops/cuda_wgrad.py``) when C_out <= 8, on a CUDA
tensor, its plain version on a CPU tensor, and the native weight-gradient
conv otherwise. The matrix products and convs here are PyTorch's, as the
JAX package leaves those parts to XLA.

Layouts are the JAX package's: activations NHWC, kernels HWIO
(k, k, Cin, Cout). Everything is stride-1 VALID on a pre-padded input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pcgan_tpu_torch.ops.cuda_wgrad import MAX_COUT, conv_wgrad_lowcout


def _taps(kh: int, kw: int):
    return [(i, j) for i in range(kh) for j in range(kw)]


def conv_valid_ref(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Reference: direct stride-1 VALID conv (NHWC x HWIO -> NHWC)."""
    y = F.conv2d(x_pad.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """``jnp.pad(x, p, mode='reflect')`` on H and W of an NHWC tensor."""
    if p == 0:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
    return y.permute(0, 2, 3, 1).contiguous()


def tap_matmul_conv(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 VALID conv for tiny C_out via the tap-matmul reformulation.
    Exact up to float association."""
    b, hp, wp, cin = x_pad.shape
    kh, kw, _, cout = w.shape
    h, wd = hp - kh + 1, wp - kw + 1
    # (Cin, k*k*Cout), lane order (tap-major, channel-minor)
    wm = w.reshape(kh * kw, cin, cout).permute(1, 0, 2).reshape(
        cin, kh * kw * cout)
    p = torch.matmul(x_pad.reshape(b * hp * wp, cin), wm.to(x_pad.dtype))
    p = p.reshape(b, hp, wp, kh * kw * cout)
    acc = torch.zeros((b, h, wd, cout), dtype=torch.float32,
                      device=x_pad.device)
    for t, (i, j) in enumerate(_taps(kh, kw)):
        acc = acc + p[:, i:i + h, j:j + wd,
                      t * cout:(t + 1) * cout].float()
    return acc.to(x_pad.dtype)


def col_matmul_conv(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 VALID conv for tiny C_in: the k*k shifted input views on the
    channel axis (im2col), contracted once with the (k*k*Cin, Cout) weight
    matrix."""
    b, hp, wp, cin = x_pad.shape
    kh, kw, _, cout = w.shape
    h, wd = hp - kh + 1, wp - kw + 1
    cols = torch.cat([x_pad[:, i:i + h, j:j + wd, :]
                      for (i, j) in _taps(kh, kw)], dim=-1)
    wm = w.reshape(kh * kw * cin, cout)
    y = torch.matmul(cols.reshape(b * h * wd, kh * kw * cin),
                     wm.to(x_pad.dtype))
    return y.reshape(b, h, wd, cout)


def reflect_fold(g_pad: torch.Tensor, p: int) -> torch.Tensor:
    """Transpose of ``reflect_pad(x, p)`` on H and W of an NHWC cotangent:
    slice the interior and fold the border gradients back onto their
    reflected sources."""
    if p == 0:
        return g_pad
    gh = g_pad[:, p:-p].clone()
    gh[:, 1:p + 1] += g_pad[:, :p].flip(1)
    gh[:, -p - 1:-1] += g_pad[:, -p:].flip(1)
    gw = gh[:, :, p:-p].clone()
    gw[:, :, 1:p + 1] += gh[:, :, :p].flip(2)
    gw[:, :, -p - 1:-1] += gh[:, :, -p:].flip(2)
    return gw


def _route(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    cin, cout = w.shape[2], w.shape[3]
    if cout <= cin:
        return tap_matmul_conv(x_pad, w)
    return col_matmul_conv(x_pad, w)


class LowchReflectConv(torch.autograd.Function):
    """ReflectionPad2d(p) + stride-1 conv (k = 2p+1), NHWC x HWIO."""

    @staticmethod
    def forward(ctx, x, w, p):
        ctx.p = p
        ctx.save_for_backward(x, w)
        return _route(reflect_pad(x, p), w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        p = ctx.p
        kh, kw, cin, cout = w.shape
        dy = dy.contiguous()
        # dx: full correlation of dy with the flipped kernel, then the
        # reflect pad's transpose
        wf = w.flip(0, 1).permute(2, 3, 0, 1)     # (Cin, Cout, k, k): OIHW
        dx_pad = F.conv2d(dy.permute(0, 3, 1, 2), wf.to(dy.dtype),
                          padding=(kh - 1, kw - 1)).permute(0, 2, 3, 1)
        dx = reflect_fold(dx_pad, p)
        # dw
        x_pad = reflect_pad(x, p)
        if cout <= MAX_COUT:
            dw = conv_wgrad_lowcout(x_pad, dy, kh)
        else:
            # one pass over x through the native weight-gradient conv
            dw = torch.nn.grad.conv2d_weight(
                x_pad.permute(0, 3, 1, 2), (cout, cin, kh, kw),
                dy.permute(0, 3, 1, 2)).permute(2, 3, 1, 0)
        return dx.to(x.dtype), dw.to(w.dtype), None


def lowch_reflect_conv(x: torch.Tensor, w: torch.Tensor,
                       p: int) -> torch.Tensor:
    """ReflectionPad2d(p) + stride-1 conv with every pass routed as in the
    module docstring. x (B, H, W, Cin), w (k, k, Cin, Cout), k = 2p+1;
    returns (B, H, W, Cout) in x's dtype."""
    return LowchReflectConv.apply(x, w, p)
