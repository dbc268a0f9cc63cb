"""Building-block layers (counterpart of ``pcgan_tpu/models/layers.py``).

Modules compute in NCHW; weights are stored in PyTorch's own layouts
(Conv2d ``(Cout, Cin, kH, kW)``, ConvTranspose2d ``(Cin, Cout, kH, kW)``)
as f32 parameters. Each conv casts its input and weight to the module's
compute dtype per layer, as the JAX modules do (``layers.py:180``), rather
than relying on autocast: in bf16 the conv runs in bf16 with f32
accumulation, an f32 bias add promotes, and the result is cast back.

The convs are ``torch.nn.functional.conv2d`` / ``conv_transpose2d`` (cuDNN on
the card), as the JAX package leaves them to XLA. ``--norm`` builds one
norm module per site (instance, batch, group or none, flax's numbers), and
``--spectral_norm`` puts a conv's kernel under flax's ``SpectralNorm``.
Batch norm's running stats and spectral norm's u/sigma are buffers of a
``StatefulModule``: a train-mode forward writes them unless
``frozen_stats`` holds them, and ``stats_state`` / ``load_stats_state``
save and restore them (the train step's D-state rule).

With ``quant`` set (the G trunk under ``--quant_int8``) a conv runs in int8
instead (``ops/quant.py``), with the JAX package's three activation-scale
modes (``layers.py:88-110``). The resnet G's bf16 routes are the JAX
package's (``layers.py:156-216``): the stem folds the constant condition
channels into a per-sample bias (``TorchConv.forward(x, cond)``), and
under ``lowch_matmul`` a bf16 reflect conv with at most 8 output channels
(the tail) runs as an r=4 space-to-depth conv (``ops/lowch_conv.py``).
``fused_reflect`` (a module field, no CLI flag) computes a reflect conv
without the padded tensor. ``ResizeConv`` is a nearest 2x resize then a
3x3 conv (``--netG resnet_*@resize_conv``). Inside ``parallel.spatial.
banded`` the convs, the resize conv and the norms compute on bands.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pcgan_tpu_torch.ops.pad import pad2d, pad_edges
from pcgan_tpu_torch.parallel import spatial

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
    transposed) in module order; biases start at zero. Batch norm scales
    are N(1, 0.02) (the reference's init), spectral norm's ``u`` N(0, 1)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(1.0 + 0.02 * torch.randn(
                    m.weight.shape, generator=generator))
            elif isinstance(m, SpectralNorm):
                m.u.copy_(torch.randn(m.u.shape, generator=generator))
                continue
            elif isinstance(m, (TorchConv, TorchConvTranspose)):
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

_PAD_MODES = ("reflect", "replicate")


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
                 quant: bool = False, spectral_norm: bool = False,
                 lowch_matmul: bool = False, fused_reflect: bool = False):
        super().__init__()
        if pad_mode not in ("zero", *_PAD_MODES):
            raise NotImplementedError(f"pad_mode [{pad_mode}]")
        self.stride, self.padding, self.pad_mode = stride, padding, pad_mode
        self.compute_dtype = dtype
        k, p = kernel_size, padding
        full_reflect = (pad_mode == "reflect" and stride == 1 and p > 0
                        and k == 2 * p + 1)
        self.full_reflect = full_reflect
        # the tail's space-to-depth route (r 4: 3 -> 48 output channels);
        # the stem is deliberately not routed, as in the JAX package
        self.s2d_r = (4 if lowch_matmul and full_reflect
                      and dtype == torch.bfloat16 and features <= 8 else 0)
        self.fused_reflect = fused_reflect
        self.weight = nn.Parameter(
            torch.empty(features, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self._init_quant(quant)
        # --spectral_norm: the kernel divided by its largest singular value
        self.sn = SpectralNorm(features) if spectral_norm else None

    def hwio_shape(self):
        co, ci, kh, kw = self.weight.shape
        return (kh, kw, ci, co)

    @staticmethod
    def weight_from_hwio(k: torch.Tensor) -> torch.Tensor:
        return k.permute(3, 2, 0, 1)

    def out_size(self, H: int) -> int:
        """The output height of an input of ``H`` rows."""
        k = self.weight.shape[2]
        return (H + 2 * self.padding - k) // self.stride + 1

    def forward(self, x: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                H: Optional[int] = None) -> torch.Tensor:
        """``cond`` (N, nc): the condition channels of a conditional G's
        stem, kept apart (the bf16 path). The conv of a spatially constant
        channel through a full stride-1 reflect pad is constant, so those
        channels add exactly a per-sample bias, ``cond @ sum_taps(W_cond)``,
        and the conv runs over the image channels alone (10/13 of the stem's
        FLOPs skipped at 10 bins). The weight keeps its concat shape
        (F, C_img + nc, k, k).

        ``H``: x's global height where x is this rank's band of it
        (``parallel/spatial.py``): the conv then computes its output's band
        from x and the halo rows of the neighbouring bands. The routes are
        chosen by the global shape."""
        dt = self.compute_dtype
        xd = x.to(dt)
        p = self.padding
        line = spatial.active() if H is not None else None
        gh = x.shape[2] if line is None else H
        # route precedence as in the JAX package: the s2d and fused-reflect
        # forms before int8 (they are the tail/stem forms, which PTQ keeps
        # in the compute dtype)
        s2d = (self.s2d_r and gh % self.s2d_r == 0
               and x.shape[3] % self.s2d_r == 0)
        fused = (not s2d and self.fused_reflect and self.full_reflect
                 and min(gh, x.shape[3]) >= p + 2)
        quant = self.quant and not (s2d or fused)
        if line is not None and quant:
            raise NotImplementedError("an int8 conv on a band (int8 is an "
                                      "inference lever)")
        if cond is not None and (quant or not self.full_reflect):
            raise ValueError(
                "separated-cond TorchConv requires a full stride-1 reflect "
                "conv (constant channels must stay constant through the "
                "padding) in the compute dtype")
        wd = cond_bias = None
        if not quant:
            w = self.weight
            if self.sn is not None:
                w = self.sn.normalize(w, w.permute(2, 3, 1, 0))
            wd = w.to(dt)
        if cond is not None:
            xc = x.shape[1]
            # the tap sum accumulates in f32 and rounds once to the compute
            # dtype, as jnp.sum of a bf16 array does
            w_cond = wd[:, xc:].float().sum(dim=(2, 3)).to(dt)   # (F, nc)
            cond_bias = (cond.to(dt) @ w_cond.T)[:, :, None, None]
            wd = wd[:, :xc]
        if line is not None:
            y = self._band_conv(xd, wd, H, "s2d" if s2d else
                                "fused" if fused else "plain")
        elif s2d:
            from pcgan_tpu_torch.ops.lowch_conv import s2d_conv_nchw
            y = s2d_conv_nchw(pad2d(xd, p, "reflect"), wd, self.s2d_r)
        elif fused:
            from pcgan_tpu_torch.ops.lowch_conv import reflect_conv_nchw
            y = reflect_conv_nchw(xd, wd, p)
        else:
            xp = xd if self.pad_mode == "zero" else pad2d(xd, p,
                                                          self.pad_mode)
            zero_pad = p if self.pad_mode == "zero" else 0
            if quant:
                y = self._int8_conv(
                    xp, self.stride,
                    ((zero_pad, zero_pad), (zero_pad, zero_pad)),
                    scale_from=xd)
            else:
                y = F.conv2d(xp, wd, stride=self.stride, padding=zero_pad)
        if cond_bias is not None:
            y = y + cond_bias
        if self.bias is not None:
            y = y + self.bias.view(1, -1, 1, 1)
        return y.to(dt)

    def _band_conv(self, xd: torch.Tensor, wd: torch.Tensor, H: int,
                   route: str) -> torch.Tensor:
        """This rank's band of the conv's output from its band ``xd`` of
        the H-row input: the window of input rows its output band reads
        (halo rows fetched from the neighbouring bands), padded at the
        image's global top and bottom only, then the route's conv (no
        bias; ``forward`` adds it)."""
        line = spatial.active()
        k, s, p = wd.shape[2], self.stride, self.padding
        wins = spatial.conv_windows(H, line.n, k, s, p)
        mine = wins[line.coord]
        w_out = (xd.shape[3] + 2 * p - k) // s + 1
        if route == "s2d":
            # the fold groups rows by 4: every band a multiple of 4
            rows = [b.h for b in spatial.bands_of(self.out_size(H), line.n)]
            if any(h % self.s2d_r for h in rows):
                raise ValueError(
                    f"the space-to-depth tail on a band: {H} rows over a "
                    f"spatial axis of {line.n} give bands of {rows} rows; "
                    f"each must divide by {self.s2d_r}")
        xw = spatial.fetch(xd, H, wins)
        top = bottom = 0
        if mine is None:
            if route != "plain":
                return spatial.empty_like_out(xw, wd, (
                    xd.shape[0], wd.shape[0], 0, w_out))
            # the band's ops on k rows of zeros (one output row, dropped):
            # the graph of an empty band is the other ranks', so a double
            # backward (R1's, GP's) reaches the same collectives on each
            xw = torch.cat([xw, xw.new_zeros(xw.shape[:2] + (k,)
                                             + xw.shape[3:])], 2)
        else:
            top, bottom = max(0, -mine[0]), max(0, mine[1] - H)
        mode = self.pad_mode
        if route == "s2d":
            from pcgan_tpu_torch.ops.lowch_conv import s2d_conv_nchw
            y = s2d_conv_nchw(pad_edges(xw, top, bottom, p, p, "reflect"),
                              wd, self.s2d_r)
        elif route == "fused":
            from pcgan_tpu_torch.ops.lowch_conv import reflect_conv_cols
            y = reflect_conv_cols(pad_edges(xw, top, bottom, 0, 0,
                                            "reflect"), wd, p)
        elif mode == "zero":
            y = F.conv2d(pad_edges(xw, top, bottom, 0, 0, "zero"), wd,
                         stride=s, padding=(0, p))
        else:
            y = F.conv2d(pad_edges(xw, top, bottom, p, p, mode), wd,
                         stride=s)
        return y if mine is not None else y[:, :, :0]


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

    def out_size(self, H: int) -> int:
        """The output height of an input of ``H`` rows."""
        k = self.weight.shape[2]
        return ((H - 1) * self.stride - 2 * self.padding + k
                + self.output_padding)

    def forward(self, x: torch.Tensor, H: Optional[int] = None
                ) -> torch.Tensor:
        """``H``: x's global height where x is this rank's band of it: the
        output band is then computed from the input rows it reads
        (``parallel/spatial.py``)."""
        if H is not None and spatial.active() is not None:
            if self.quant:
                raise NotImplementedError("an int8 conv on a band (int8 is "
                                          "an inference lever)")
            y = self._band_deconv(x.to(self.compute_dtype), H)
        elif self.quant:
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

    def _band_deconv(self, xd: torch.Tensor, H: int) -> torch.Tensor:
        """This rank's band of the output from the input rows its output
        band reads: the transposed conv over that window (no padding along
        H), its rows cropped to the band."""
        line = spatial.active()
        wd = self.weight.to(self.compute_dtype)
        k, s, p = wd.shape[2], self.stride, self.padding
        op = self.output_padding
        H_out, wins = spatial.deconv_windows(H, line.n, k, s, p, op)
        mine = wins[line.coord]
        xw = spatial.fetch(xd, H, wins)
        w_out = (xd.shape[3] - 1) * s - 2 * p + k + op
        if mine is None:
            return spatial.empty_like_out(xw, wd, (xd.shape[0], wd.shape[1],
                                                   0, w_out))
        band = spatial.band_of(H_out, line.n, line.coord)
        y = F.conv_transpose2d(xw, wd, stride=s, padding=(0, p),
                               output_padding=(0, op))
        first = band.r0 + p - mine[0] * s
        return y[:, :, first:first + band.h]


class ResizeConv(nn.Module):
    """A nearest 2x resize, then a 3x3 stride-1 zero-padded ``TorchConv``
    (``pcgan_tpu/models/layers.py:371-398``, at the scale its one caller
    uses): the upsampling of ``--netG resnet_*@resize_conv``. At an exact
    2x, ``F.interpolate``'s nearest takes source pixel i // 2, as
    ``jax.image.resize``'s does. On a band (``H`` given inside
    ``spatial.banded``) the upsample writes this rank's band of the 2H
    rows from its fetched source rows (``spatial.upsample2``), then the
    conv's band form runs at height 2H."""

    def __init__(self, in_ch: int, features: int, use_bias: bool = True,
                 dtype=torch.float32, quant: bool = False):
        super().__init__()
        self.conv = TorchConv(in_ch, features, 3, 1, 1, "zero", use_bias,
                              dtype, quant)

    def out_size(self, H: int) -> int:
        return 2 * H

    def forward(self, x: torch.Tensor, H: Optional[int] = None
                ) -> torch.Tensor:
        if H is not None and spatial.active() is not None:
            return self.conv(spatial.upsample2(x, H), H=2 * H)
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


# --------------------------------------------------------------------------- #
# state beside the parameters: batch norm's running stats, spectral norm's
# power-iteration vector
# --------------------------------------------------------------------------- #


class StatefulModule(nn.Module):
    """A module whose buffers are state that a train-mode forward updates
    (flax's mutable ``batch_stats`` collection). ``update_stats`` (on by
    default) lets a forward read the state without writing it
    (``frozen_stats``). A write rebinds the buffer to a new tensor, so a
    reference kept by ``stats_state`` still holds the old value."""

    update_stats = True

    def _write(self, name: str, value: torch.Tensor) -> None:
        if self.training and self.update_stats:
            self._buffers[name] = value.detach()


@contextlib.contextmanager
def frozen_stats(*modules: nn.Module):
    """Forwards inside read every ``StatefulModule``'s state of ``modules``
    but do not write it."""
    mods = [m for mod in modules for m in mod.modules()
            if isinstance(m, StatefulModule)]
    prev = [m.update_stats for m in mods]
    for m in mods:
        m.update_stats = False
    try:
        yield
    finally:
        for m, p in zip(mods, prev):
            m.update_stats = p


def stats_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """{buffer path: tensor} of every ``StatefulModule`` in ``module`` (the
    JAX package's non-param collections): references, not copies."""
    return {f"{n}.{b}" if n else b: t
            for n, m in module.named_modules()
            if isinstance(m, StatefulModule)
            for b, t in m._buffers.items()}


def load_stats_state(module: nn.Module, state: Dict[str, torch.Tensor]
                     ) -> None:
    """Rebinds the buffers of ``stats_state`` to the tensors of ``state``."""
    for key, t in state.items():
        path, _, leaf = key.rpartition(".")
        module.get_submodule(path)._buffers[leaf] = t


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNorm(StatefulModule):
    """flax ``nn.SpectralNorm`` (one power iteration, eps 1e-12) of one conv
    kernel. The kernel is seen as flax sees it, its HWIO form reshaped to
    (kh*kw*cin, cout). Every forward, train or eval, iterates once from the
    stored ``u`` (1, cout) with ``u`` and ``v`` outside autograd, and
    divides the kernel by ``sigma = v W u^T``; a train-mode forward stores
    the new ``u`` and ``sigma``."""

    def __init__(self, features: int):
        super().__init__()
        # drawn N(0, 1) by ``init_weights`` from the model's generator
        self.register_buffer("u", torch.zeros(1, features))
        self.register_buffer("sigma", torch.ones(()))

    def normalize(self, weight: torch.Tensor, hwio: torch.Tensor
                  ) -> torch.Tensor:
        """``weight`` divided by the spectral norm of ``hwio`` (the same
        kernel in HWIO order)."""
        mat = hwio.reshape(-1, hwio.shape[-1])
        with torch.no_grad():
            m = mat.detach()
            v = _l2_normalize(self.u @ m.T)
            u = _l2_normalize(v @ m)
        sigma = (v @ mat @ u.T)[0, 0]
        self._write("u", u)
        self._write("sigma", sigma)
        return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch ``InstanceNorm2d(affine=False, track_running_stats=False)`` on
    NCHW, in the JAX package's two forms (``layers.py:401-420``).

    f32: exact two-pass mean/var. bf16: single-pass E[x^2]-E[x]^2 with f32
    accumulation (x*x rounds in bf16, as in JAX), output cast to bf16.
    Inside ``spatial.banded`` x is this rank's band along H: the moments
    are the band's sums over the spatial line, over its count.
    """
    if spatial.active() is not None:
        return _band_instance_norm(x, eps)
    if x.dtype == torch.float32:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps)
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    mean2 = (x * x).float().mean(dim=(2, 3), keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _band_instance_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``instance_norm`` of a band: the same two forms, each moment a sum
    over the band summed over the line (``spatial.line_sum``) over the
    line's count; f32 takes two collectives, bf16 one."""
    n, c, h, w = x.shape
    count = x.new_tensor([float(h * w)], dtype=torch.float32)
    if x.dtype == torch.float32:
        tot = spatial.line_sum(torch.cat([x.sum(dim=(2, 3)).reshape(-1),
                                          count]))
        cnt = tot[-1].detach()
        mean = (tot[:-1] / cnt).view(n, c, 1, 1)
        var = spatial.line_sum((x - mean).square().sum(dim=(2, 3))) / cnt
        return (x - mean) * torch.rsqrt(var.view(n, c, 1, 1) + eps)
    xf = x.float()
    tot = spatial.line_sum(torch.cat([xf.sum(dim=(2, 3)).reshape(-1),
                                      (x * x).float().sum(dim=(2, 3))
                                      .reshape(-1), count]))
    cnt = tot[-1].detach()
    mean = (tot[:n * c] / cnt).view(n, c, 1, 1)
    mean2 = (tot[n * c:2 * n * c] / cnt).view(n, c, 1, 1)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class InstanceNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


def _affine(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
            weight: torch.Tensor, bias: torch.Tensor, eps: float
            ) -> torch.Tensor:
    """flax ``_normalize`` on NCHW with per-channel f32 (C,) stats: ``(x -
    mean) * (rsqrt(var + eps) * scale) + bias`` in f32, cast to x's dtype."""
    mul = torch.rsqrt(var + eps) * weight
    y = (x.float() - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
    return (y + bias.view(1, -1, 1, 1)).to(x.dtype)


_BN_GROUP = None       # the data axis batch norm's moments span


@contextlib.contextmanager
def batch_norm_group(group):
    """Train-mode batch norm inside computes its moments over the rows of
    every rank of ``group`` (a process group of equal local batches; None:
    this process's rows): flax's batch norm over the global batch of the
    sharded-state step (``parallel/auto.py``)."""
    global _BN_GROUP
    prev, _BN_GROUP = _BN_GROUP, group
    try:
        yield
    finally:
        _BN_GROUP = prev


class _GroupMean(torch.autograd.Function):
    """The mean of ``x`` over ``group``'s ranks; its backward is the same
    mean of the gradient (differentiable again, for GP's double
    backward)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / torch.tensor(dist.get_world_size(group), dtype=y.dtype,
                                device=y.device)

    @staticmethod
    def backward(ctx, g):
        return _GroupMean.apply(g, ctx.group), None


class BatchNorm(StatefulModule):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on NCHW: train mode
    normalizes by the batch's f32 stats (``E[x^2] - E[x]^2``, clipped at 0)
    and moves the running stats toward them with the BIASED variance; eval
    mode reads the running stats. Inside ``batch_norm_group`` the batch is
    the global one: the moments are averaged over the group; inside
    ``spatial.banded`` they are first summed over the spatial line."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return _affine(x, self.running_mean, self.running_var,
                           self.weight, self.bias, self.eps)
        xf = x.float()
        if spatial.active() is not None:
            # a band: the rows' sums over the spatial line, over its count
            # (the data ranks of a line hold equal counts)
            tot = spatial.line_sum(torch.cat([
                xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)),
                xf.new_tensor([float(xf[:, 0].numel())])]))
            c = xf.shape[1]
            mean, mean2 = (tot[:2 * c] / tot[-1].detach()).view(2, c)
        else:
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = xf.square().mean(dim=(0, 2, 3))
        if _BN_GROUP is not None:
            mean, mean2 = _GroupMean.apply(torch.stack([mean, mean2]),
                                           _BN_GROUP).unbind(0)
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        m = self.momentum
        self._write("running_mean",
                    m * self.running_mean + (1 - m) * mean.detach())
        self._write("running_var",
                    m * self.running_var + (1 - m) * var.detach())
        return _affine(x, mean, var, self.weight, self.bias, self.eps)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=min(32, C))`` on NCHW: eps 1e-6 (flax's
    default), f32 stats ``E[x^2] - E[x]^2`` per (sample, group). Inside
    ``spatial.banded`` the moments are the band's f32 sums of x and x^2,
    summed over the line with the rows' count (one collective; an empty
    band adds zeros)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.groups = min(32, features)
        if features % self.groups:
            raise ValueError(f"Number of groups ({self.groups}) does not "
                             f"divide the number of channels ({features}).")
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        g = self.groups
        xf = x.float().reshape(n, g, c // g, h, w)
        if spatial.active() is not None:
            tot = spatial.line_sum(torch.cat([
                xf.sum(dim=(2, 3, 4)).reshape(-1),
                xf.square().sum(dim=(2, 3, 4)).reshape(-1),
                xf.new_tensor([float(c // g * h * w)])]))
            cnt = tot[-1].detach()
            mean = (tot[:n * g] / cnt).view(n, g, 1, 1, 1)
            mean2 = (tot[n * g:2 * n * g] / cnt).view(n, g, 1, 1, 1)
        else:
            mean = xf.mean(dim=(2, 3, 4), keepdim=True)
            mean2 = xf.square().mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        mul = (torch.rsqrt(var + self.eps)
               * self.weight.view(1, g, c // g, 1, 1))
        y = ((xf - mean) * mul).reshape(n, c, h, w)
        return (y + self.bias.view(1, -1, 1, 1)).to(x.dtype)


NORMS = ("instance", "batch", "group", "none")


def Norm(kind: str = "instance", features: Optional[int] = None
         ) -> nn.Module:
    """The norm of ``--norm`` over ``features`` channels: instance | batch
    | group | none (``pcgan_tpu/models/layers.py:423-452``)."""
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        return BatchNorm(features)
    if kind == "group":
        return GroupNorm(features)
    if kind == "none":
        return nn.Identity()
    raise NotImplementedError(f"norm [{kind}] not implemented")


def norm_uses_bias(kind: str) -> bool:
    """The reference template disables conv bias when the following norm has
    affine params (batch); instance norm (no affine) keeps conv bias."""
    return kind != "batch"


def conv_bias_before_norm(kind: str) -> bool:
    """Whether a conv IMMEDIATELY followed by this norm carries a bias:
    instance (affine=False) and batch remove a per-channel constant exactly,
    so the JAX package drops those biases; group and none keep them."""
    return kind in ("group", "none")
