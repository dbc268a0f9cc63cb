"""Low-channel 7x7 conv reformulations (counterpart of ``pcgan_tpu/ops/lowch_conv.py``).

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

The space-to-depth form (``s2d_conv``, the JAX bf16 G's tail) folds an
r x r pixel block into channels, so the conv has r*r*C_out outputs;
``s2d_reflect_conv`` adds the reflect pad with ``reflect_fold`` as its
transpose. ``reflect_conv`` is a reflect-pad conv without the padded
tensor (``TorchConv``'s ``fused_reflect``).

Layouts are the JAX package's: activations NHWC, kernels HWIO
(k, k, Cin, Cout), everything stride-1 VALID on a pre-padded input; the
``*_nchw`` forms take the port's NCHW / OIHW, as ``TorchConv`` calls
them.
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


# --------------------------------------------------------------------------- #
# space-to-depth reformulation (pcgan_tpu/ops/lowch_conv.py:184-282): the
# form the JAX package's bf16 G runs for its tail (models/layers.py:199-216)
# --------------------------------------------------------------------------- #


def _s2d_embed(w: torch.Tensor, r: int, dtype) -> torch.Tensor:
    """Embed a (k, k, cin, cout) HWIO kernel into the space-to-depth conv's
    (k', k', r*r*cin, r*r*cout) kernel with pads and reshapes only (no
    gather). For output phase (r1, r2), tap (i, j) lands at grid (q, s)
    with i = q*r + s - r1: the (q, s) unfolding of w's rows front-padded by
    r1 zeros. Channel order is the JAX package's: input (r1*r + r2)*cin +
    ci, output (r1*r + r2)*cout + c."""
    k, _, cin, cout = w.shape
    kp = 1 + (r - 1 + k - 1) // r
    blocks = []
    for r1 in range(r):
        for r2 in range(r):
            # F.pad pads the last dims first: (ci, c) untouched, then W, H
            wp_ = F.pad(w.permute(2, 3, 0, 1),
                        (r2, kp * r - k - r2, r1, kp * r - k - r1))
            wp_ = wp_.permute(2, 3, 0, 1)                # (kp*r, kp*r, ci, c)
            blk = wp_.reshape(kp, r, kp, r, cin, cout)
            blk = blk.permute(0, 2, 1, 3, 4, 5)          # (q1,q2,s1,s2,ci,c)
            blocks.append(blk.reshape(kp, kp, r * r * cin, cout))
    w2 = torch.stack(blocks, dim=-2)                     # (...,(r1,r2),c)
    return w2.reshape(kp, kp, r * r * cin, r * r * cout).to(dtype)


def _s2d_fold(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, C, r*Hs, r*Ws) NCHW -> (B, r*r*C, Hs, Ws), channel (r1*r + r2)*C
    + c: the JAX package's space-to-depth order (``F.pixel_unshuffle``'s is
    channel-major, c*r*r + r1*r + r2)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // r, r, w // r, r).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, r * r * c, h // r, w // r)


def _s2d_unfold(y: torch.Tensor, r: int) -> torch.Tensor:
    """The inverse of ``_s2d_fold``: (B, r*r*C, Hs, Ws) -> (B, C, r*Hs,
    r*Ws)."""
    b, c, h, w = y.shape
    c //= r * r
    y = y.reshape(b, r, r, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, c, h * r, w * r)


def s2d_conv_nchw(x_pad: torch.Tensor, w_oihw: torch.Tensor,
                  r: int = 4) -> torch.Tensor:
    """``s2d_conv`` on the port's layouts: x_pad (B, Cin, Hp, Wp), w
    (Cout, Cin, k, k) -> (B, Cout, H, W), H = Hp - k + 1, in x_pad's
    dtype."""
    b, cin, hp, wp = x_pad.shape
    k = w_oihw.shape[2]
    h, wd = hp - k + 1, wp - k + 1
    if h % r or wd % r:
        raise ValueError(f"s2d_conv: output {h}x{wd} must be divisible by "
                         f"{r}")
    # pad so Hp, Wp divide by r (the padded rows only meet zero weights)
    hp2, wp2 = -(-hp // r) * r, -(-wp // r) * r
    x2 = F.pad(x_pad, (0, wp2 - wp, 0, hp2 - hp))
    w2 = _s2d_embed(w_oihw.permute(2, 3, 1, 0), r, x_pad.dtype)
    ys = F.conv2d(_s2d_fold(x2, r), w2.permute(3, 2, 0, 1))
    return _s2d_unfold(ys, r)


def s2d_conv(x_pad: torch.Tensor, w: torch.Tensor, r: int = 4
             ) -> torch.Tensor:
    """Stride-1 VALID conv for tiny C_out via space-to-depth: an r x r
    pixel block folds into channels, so the conv has r*r*C_out output
    channels instead of C_out, at k'^2 r^2 / k^2 the FLOPs (2.9x for k 7,
    r 4). One dense conv that autograd differentiates natively. NHWC x
    HWIO -> NHWC, as the JAX function; raises when the output's H or W is
    not divisible by r."""
    y = s2d_conv_nchw(x_pad.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), r)
    return y.permute(0, 2, 3, 1)


class S2dReflectConv(torch.autograd.Function):
    """ReflectionPad2d(p) + stride-1 conv (k = 2p+1) through ``s2d_conv``;
    NHWC x HWIO. The data gradient is the s2d-space full correlation of the
    cotangent with the flipped embedded kernel, then ``reflect_fold`` (the
    reflect pad's transpose); the weight gradient is autograd of
    ``s2d_conv`` with respect to w."""

    @staticmethod
    def forward(ctx, x, w, p, r):
        ctx.p, ctx.r = p, r
        ctx.save_for_backward(x, w)
        return s2d_conv(reflect_pad(x, p), w, r)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        p, r = ctx.p, ctx.r
        x_pad = reflect_pad(x, p)
        b, hp, wp, cin = x_pad.shape
        dy = dy.contiguous()
        # dx: s2d-space full correlation, then fold the reflect borders
        w2 = _s2d_embed(w, r, dy.dtype)
        kp = w2.shape[0]
        hp2, wp2 = -(-hp // r) * r, -(-wp // r) * r
        dys = _s2d_fold(dy.permute(0, 3, 1, 2), r)
        # conv_transpose == correlation with the flipped, transposed kernel
        # over the cotangent zero-padded by kp - 1
        dx2 = F.conv2d(dys, w2.flip(0, 1).permute(2, 3, 0, 1),
                       padding=kp - 1)
        dx_pad = _s2d_unfold(dx2, r)[:, :, :hp, :wp].permute(0, 2, 3, 1)
        dx = reflect_fold(dx_pad, p)
        # dw: s2d_conv's own autograd with respect to w
        with torch.enable_grad():
            wv = w.detach().requires_grad_(True)
            (dw,) = torch.autograd.grad(s2d_conv(x_pad.detach(), wv, r), wv,
                                        dy)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def s2d_reflect_conv(x: torch.Tensor, w: torch.Tensor, p: int,
                     r: int = 4) -> torch.Tensor:
    """ReflectionPad2d(p) + stride-1 conv (k = 2p+1) in space-to-depth form
    with the reflect pad's transpose done by ``reflect_fold``. x (B, H, W,
    Cin), w (k, k, Cin, Cout) -> (B, H, W, Cout)."""
    return S2dReflectConv.apply(x, w, p, r)


# --------------------------------------------------------------------------- #
# reflect-pad conv without the padded tensor (pcgan_tpu/models/layers.py:
# 255-313, TorchConv's ``fused_reflect``)
# --------------------------------------------------------------------------- #


def reflect_conv_nchw(x: torch.Tensor, w: torch.Tensor,
                      p: int) -> torch.Tensor:
    """Stride-1 conv with ReflectionPad2d(p), k = 2p+1, without the padded
    tensor: the conv with zero padding p plus thin border corrections. Top
    and bottom: for each kernel row reading reflected rows, a 1 x k conv
    over the strip of reflected source rows with reflected column ends
    (this also covers the corners); left and right: for each kernel column
    reading reflected columns, a k x 1 conv over the source-column strip
    with zero row padding, which leaves out the terms the row pass added.
    x (B, Cin, H, W), w (Cout, Cin, k, k) -> (B, Cout, H, W); equal to pad
    then VALID conv up to float association."""
    h, wd = x.shape[2], x.shape[3]
    y = F.conv2d(x, w, padding=p)

    def colpad(rows):
        # reflected column ends: positions -p..-1 = cols p..1, positions
        # W..W+p-1 = cols W-2..W-1-p
        left = rows[..., 1:p + 1].flip(-1)
        right = rows[..., wd - 1 - p:wd - 1].flip(-1)
        return torch.cat([left, rows, right], dim=-1)

    for r in range(p):
        nr = p - r
        # top: out rows i < nr miss kernel row r reading x-row (p - i - r)
        strip = colpad(x[:, :, 1:p - r + 1].flip(2))      # rows p-r .. 1
        corr = F.conv2d(strip, w[:, :, r:r + 1])
        y = torch.cat([y[:, :, :nr] + corr, y[:, :, nr:]], dim=2)
        # bottom: kernel row k-1-r reads reflected rows below the image
        rb = 2 * p - r
        strip = colpad(x[:, :, h - 1 - p + r:h - 1])      # rows h-1-(p-r)..h-2
        corr = F.conv2d(strip, w[:, :, rb:rb + 1])
        y = torch.cat([y[:, :, :h - nr], y[:, :, h - nr:] + corr.flip(2)],
                      dim=2)
    return _reflect_cols(y, x, w, p, row_pad=p)


def _reflect_cols(y: torch.Tensor, x: torch.Tensor, w: torch.Tensor, p: int,
                  row_pad: int) -> torch.Tensor:
    """``y`` plus the terms of the reflected column ends: for each kernel
    column reading reflected columns, a k x 1 conv over the source-column
    strip of ``x`` with ``row_pad`` zero rows (p where ``y`` padded the rows
    with zeros, 0 where ``x``'s rows are padded already)."""
    wd = x.shape[3]
    for c in range(p):
        nc = p - c
        # left: out cols j < nc miss kernel col c reading x-col (p - j - c)
        strip = x[..., 1:p - c + 1].flip(3)               # cols p-c .. 1
        corr = F.conv2d(strip, w[..., c:c + 1], padding=(row_pad, 0))
        y = torch.cat([y[..., :nc] + corr, y[..., nc:]], dim=3)
        cb = 2 * p - c
        strip = x[..., wd - 1 - p + c:wd - 1]             # cols w-1-(p-c)..w-2
        corr = F.conv2d(strip, w[..., cb:cb + 1], padding=(row_pad, 0))
        y = torch.cat([y[..., :wd - nc], y[..., wd - nc:] + corr.flip(3)],
                      dim=3)
    return y


def reflect_conv_cols(x_rows: torch.Tensor, w: torch.Tensor,
                      p: int) -> torch.Tensor:
    """``reflect_conv_nchw``'s columns alone: a stride-1 conv (k = 2p+1)
    over ``x_rows``, whose rows are padded already (a band with its halo
    rows, reflected where the image ends), with ReflectionPad(p) on W done
    without the padded tensor. (B, Cin, h + 2p, W) -> (B, Cout, h, W)."""
    y = F.conv2d(x_rows, w, padding=(0, p))
    return _reflect_cols(y, x_rows, w, p, row_pad=0)


def reflect_conv(x: torch.Tensor, kernel: torch.Tensor,
                 p: int) -> torch.Tensor:
    """``reflect_conv_nchw`` on the JAX function's layouts: x (B, H, W, Cin)
    NHWC, kernel (k, k, Cin, Cout) HWIO -> NHWC."""
    y = reflect_conv_nchw(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                          p)
    return y.permute(0, 2, 3, 1)
