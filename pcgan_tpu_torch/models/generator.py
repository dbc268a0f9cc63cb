"""Conditional generators and self-attention (counterpart of
``pcgan_tpu/models/generator.py``): the resnet G and the U-Net.

ResnetGenerator (``--netG resnet_9blocks|resnet_6blocks``):
  ReflectionPad(3) -> Conv7x7(ngf) -> norm -> ReLU
  -> 2x [Conv3x3 s2 p1 (ngf*2, ngf*4) -> norm -> ReLU]          (downsample)
  -> n_blocks x ResnetBlock(reflect-pad Conv3x3 + norm + ReLU [+ dropout],
                            reflect-pad Conv3x3 + norm, residual add)
  -> 2x [ConvTranspose3x3 s2 p1 op1 -> norm -> ReLU]            (upsample)
  -> ReflectionPad(3) -> Conv7x7(output_nc) -> tanh (in f32)

The age condition (a one-hot over ``n_age_bins``) is broadcast to an HxW map
and channel-concatenated to the input (``cond_inject='input'``) or to the
bottleneck features (``'bottleneck'``, followed by a 1x1 projection back to
the trunk width). ``forward`` takes and returns NHWC, like the JAX module.

``--norm`` is instance, batch, group or none, one norm module per site.
Inside ``parallel.spatial.banded`` either G computes on this rank's band of
rows (its layers told their input's global height; the condition map
broadcast at the band's height).
With dropout (``--no-no_dropout``) a training forward draws one keep-mask
per block from an explicit ``torch.Generator``, at the global shape (every
rank draws the whole mask and keeps its rows and band); ``--remat``
recomputes the first ``--remat_blocks`` blocks in the backward pass, a
band's halo exchanges and band sums included (``_checkpoint``).

``quant_trunk`` (``--quant_int8``) runs the trunk convs in int8
(``ops/quant.py``): the down convs, the bottleneck projection, both convs of
every block and the deconvs. Stem and tail stay in the compute dtype, as in
the JAX package (``generator.py:150-154``).

The resnet G's variants: ``upsample='resize_conv'`` (``--netG
resnet_*@resize_conv``) upsamples by a nearest resize and a 3x3 conv;
``g_attn`` puts one ``SelfAttention`` after block ``n_blocks // 2 - 1``
(never rematerialized); ``lowch_matmul`` on the bf16 path keeps the
condition out of the stem's input (a per-sample bias, ``TorchConv``) and
runs the tail in space-to-depth form.

UnetGenerator (``--netG unet_<size>``, ``num_downs = log2(size)``): a
recursive U-Net of ``num_downs`` levels, outermost to innermost:
  down: LeakyReLU(0.2) (not at the outermost) -> Conv4x4 s2 p1 -> norm
        (not at the outer- or innermost level)
  up:   ReLU -> ConvTranspose4x4 s2 p1 -> norm [-> dropout] -> concat the
        level's input on the channel axis; the outermost ends in tanh (f32)
The condition joins the input (``'input'``) or the innermost level's down
output (``'bottleneck'``). The ``num_downs - 5`` middle levels carry
dropout; ``--remat`` recomputes the innermost ``--remat_blocks`` levels
(the outermost never).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from pcgan_tpu_torch.models.layers import (Norm, ResizeConv, TorchConv,
                                           TorchConvTranspose,
                                           conv_bias_before_norm,
                                           frozen_stats, norm_uses_bias)
from pcgan_tpu_torch.parallel import rows as draw
from pcgan_tpu_torch.parallel import spatial


def broadcast_cond(cond: torch.Tensor, h: int, w: int,
                   dtype=torch.float32) -> torch.Tensor:
    """(N, C_cond) condition vector -> (N, C_cond, H, W) constant map."""
    return cond.to(dtype)[:, :, None, None].expand(-1, -1, h, w)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, norm: str = "instance",
                 use_dropout: bool = False, pad_mode: str = "reflect",
                 dtype=torch.float32, quant: bool = False):
        super().__init__()
        # both convs feed a norm: bias dropped where provably inert
        use_bias = conv_bias_before_norm(norm)
        self.conv0 = TorchConv(dim, dim, 3, 1, 1, pad_mode, use_bias, dtype,
                               quant)
        self.norm0 = Norm(norm, dim)
        self.conv1 = TorchConv(dim, dim, 3, 1, 1, pad_mode, use_bias, dtype,
                               quant)
        self.norm1 = Norm(norm, dim)
        self.use_dropout = use_dropout

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None,
                H: Optional[int] = None) -> torch.Tensor:
        """``keep``: the dropout mask (bool, x's shape) of a training
        forward, drawn by the caller (flax ``nn.Dropout(0.5)``: kept
        entries are scaled by 2). ``H``: x's global height where x is a
        band of it (``parallel/spatial.py``)."""
        h = F.relu(self.norm0(self.conv0(x, H=H)))
        if keep is not None:
            h = torch.where(keep, h / 0.5, torch.zeros_like(h))
        h = self.norm1(self.conv1(h, H=H))
        return x + h


class SelfAttention(nn.Module):
    """SAGAN self-attention (``pcgan_tpu/models/generator.py:79-131``), on
    NCHW: 1x1 projections theta/phi/g (no bias), key and value max-pooled
    2x, softmax over the keys in f32, the output projection o, and ``x +
    gamma * o`` with gamma starting at 0 (the identity at init). The two
    products are explicit matmuls, as in JAX. ``spectral_norm`` puts each
    projection under spectral norm (``--d_attn --spectral_norm``).

    On a band (``H``, x's global height, given inside ``spatial.banded``)
    the queries are the band's rows; phi and g are pooled by the global
    row pairs (``spatial.pool2``) and gathered whole over the line
    (``spatial.gather_band``), so each query's softmax runs over all HW/4
    keys; the output projection and the residual stay on the band."""

    def __init__(self, dim: int, dtype=torch.float32,
                 spectral_norm: bool = False):
        super().__init__()
        k8, k2 = max(dim // 8, 1), max(dim // 2, 1)
        kw = dict(use_bias=False, dtype=dtype, spectral_norm=spectral_norm)
        self.theta = TorchConv(dim, k8, 1, **kw)
        self.phi = TorchConv(dim, k8, 1, **kw)
        self.g = TorchConv(dim, k2, 1, **kw)
        self.o = TorchConv(k2, dim, 1, **kw)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor, H: Optional[int] = None
                ) -> torch.Tensor:
        n, c, h, w = x.shape
        gh = h if H is None or spatial.active() is None else H
        if gh % 2 or w % 2:
            raise ValueError(f"SelfAttention needs even spatial dims for the "
                             f"pooled key/value branches, got {gh}x{w}")
        q = self.theta(x, H=H).flatten(2).transpose(1, 2)     # (n, hw, k8)
        k, v = (spatial.gather_band(spatial.pool2(conv(x, H=H), gh, "max"),
                                    gh // 2).flatten(2)
                for conv in (self.phi, self.g))     # (n, k8|k2, HW/4)
        attn = torch.softmax(torch.bmm(q, k).float(), dim=-1).to(x.dtype)
        o = torch.bmm(attn, v.transpose(1, 2))               # (n, hw, k2)
        o = self.o(o.transpose(1, 2).reshape(n, v.shape[1], h, w), H=H)
        return x + self.gamma.to(x.dtype) * o


class ResnetGenerator(nn.Module):
    def __init__(self, input_nc: int = 3, output_nc: int = 3,
                 cond_nc: int = 10, ngf: int = 64, n_blocks: int = 9,
                 n_downsampling: int = 2, norm: str = "instance",
                 use_dropout: bool = False, cond_inject: str = "input",
                 dtype=torch.float32, quant_trunk: bool = False,
                 n_remat: int = 0, upsample: str = "deconv",
                 lowch_matmul: bool = False, g_attn: bool = False):
        super().__init__()
        if cond_inject not in ("input", "bottleneck"):
            # loud: a typo here must not silently build an UNCONDITIONAL G
            raise NotImplementedError(
                f"cond_inject [{cond_inject}] (want input | bottleneck)")
        self.cond_inject = cond_inject
        self.use_dropout = use_dropout
        self.compute_dtype = dtype
        # the bf16 path keeps the constant condition map out of the stem's
        # input: TorchConv folds it into a per-sample bias
        self.stem_cond = (cond_inject == "input" and lowch_matmul
                          and dtype == torch.bfloat16)
        # --remat: the first n_remat blocks recompute their activations in
        # the backward pass (torch.utils.checkpoint); names are unchanged,
        # so checkpoints cross-load with and without it
        self.n_remat = n_remat
        # convs feeding a norm drop their bias when the norm makes it inert
        norm_bias = conv_bias_before_norm(norm)
        stem_in = input_nc + (cond_nc if cond_inject == "input" else 0)
        self.stem = TorchConv(stem_in, ngf, 7, 1, 3, "reflect", norm_bias,
                              dtype, lowch_matmul=lowch_matmul)
        self.stem_norm = Norm(norm, ngf)
        self.down = nn.ModuleList(
            TorchConv(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, 2, 1, "zero",
                      norm_bias, dtype, quant_trunk)
            for i in range(n_downsampling))
        self.down_norm = nn.ModuleList(Norm(norm, ngf * 2 ** (i + 1))
                                       for i in range(n_downsampling))
        trunk = ngf * 2 ** n_downsampling
        # project back to the trunk width so blocks stay residual (no norm
        # follows -> bias stays live)
        self.cond_proj = (
            TorchConv(trunk + cond_nc, trunk, 1, 1, 0, "zero",
                      norm_uses_bias(norm), dtype, quant_trunk)
            if cond_inject == "bottleneck" else None)
        self.blocks = nn.ModuleList(
            ResnetBlock(trunk, norm, use_dropout, dtype=dtype,
                        quant=quant_trunk)
            for _ in range(n_blocks))
        # --g_attn: mid-trunk global context at the bottleneck resolution
        self.attn_after = n_blocks // 2 - 1 if g_attn else None
        self.attn = SelfAttention(trunk, dtype) if g_attn else None
        ups = [ngf * 2 ** (n_downsampling - i) // 2
               for i in range(n_downsampling)]
        # any upsample but 'deconv' is the resize conv, as in the JAX module
        self.up = nn.ModuleList(
            TorchConvTranspose(2 * f, f, 3, 2, 1, 1, norm_bias, dtype,
                               quant_trunk) if upsample == "deconv" else
            ResizeConv(2 * f, f, norm_bias, dtype, quant_trunk)
            for f in ups)
        self.up_norm = nn.ModuleList(Norm(norm, f) for f in ups)
        self.tail = TorchConv(ngf, output_nc, 7, 1, 3, "reflect", True, dtype,
                              lowch_matmul=lowch_matmul)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                rows=None) -> torch.Tensor:
        """x: (N,H,W,input_nc) in [-1,1]; cond: (N,cond_nc).
        Returns (N,H,W,output_nc) f32. A training forward of a G with
        dropout draws one keep-mask (p = 0.5) per block, in block order,
        from ``generator`` (on x's device); ``rows``
        (``parallel.rows.Rows``): for the global batch, x being this
        rank's rows of it."""
        dropout = self.use_dropout and self.training
        if dropout and generator is None:
            raise ValueError("a training forward with dropout needs the "
                             "train state's generator")
        h = x.permute(0, 3, 1, 2)
        # inside spatial.banded x is this rank's band of the image: every
        # conv is told its input's global height
        H = spatial.global_h(h.shape[2])
        if self.stem_cond:
            h = self.stem(h, cond, H=H)
        else:
            if self.cond_inject == "input":
                h = torch.cat([h, broadcast_cond(cond, h.shape[2], h.shape[3],
                                                 h.dtype)], 1)
            h = self.stem(h, H=H)
        h = F.relu(self.stem_norm(h))
        for conv, norm in zip(self.down, self.down_norm):
            h = F.relu(norm(conv(h, H=H)))
            H = conv.out_size(H)
        if self.cond_proj is not None:
            h = torch.cat([h, broadcast_cond(cond, h.shape[2], h.shape[3],
                                             h.dtype)], 1)
            h = self.cond_proj(h, H=H)
        remat = self.training and torch.is_grad_enabled()
        keeps = ([spatial.band_slice(k)
                  for k in self.draw_keeps(h, H, generator, rows)]
                 if dropout else [None] * len(self.blocks))
        for i, (block, keep) in enumerate(zip(self.blocks, keeps)):
            if remat and i < self.n_remat:
                # the recompute in the backward pass must not move the norm
                # state a second time; the mask is an input, so it replays
                h = _checkpoint(block, (block,), h, keep, H)
            else:
                h = block(h, keep, H)
            if i == self.attn_after:
                h = self.attn(h, H)
        for deconv, norm in zip(self.up, self.up_norm):
            h = F.relu(norm(deconv(h, H=H)))
            H = deconv.out_size(H)
        h = self.tail(h, H=H)
        return torch.tanh(h.float()).permute(0, 2, 3, 1)

    def draw_keeps(self, h: torch.Tensor, H: int, generator: torch.Generator,
                   rows=None) -> list:
        """The keep-mask (p = 0.5) of every block of a training forward with
        dropout, in block order, at the trunk's global shape (``H`` rows;
        ``rows``: for the global batch, this rank's rows kept)."""
        shape = h.shape[:2] + (H,) + h.shape[3:]
        return [draw.rand(shape, generator, rows, device=h.device) < 0.5
                for _ in self.blocks]


def _recompute_frozen(*modules: nn.Module):
    return lambda: (contextlib.nullcontext(), frozen_stats(*modules))


def _checkpoint(fn, modules, *args):
    """``fn(*args)`` recomputed in the backward pass without moving the
    norm state of ``modules`` a second time. On a band the recompute runs
    the whole segment (no early stop), so every rank re-issues all its halo
    exchanges and band sums, in the forward's order."""
    early = spatial.active() is None
    with set_checkpoint_early_stop(early):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_recompute_frozen(*modules))


class UnetSkipBlock(nn.Module):
    """One U-Net level's own layers (``pcgan_tpu/models/generator.py:
    252-313``); ``UnetGenerator`` runs the recursion, so no level holds the
    next as a submodule. ``in_nc``: the channels of the level's input
    (``outer_nc`` but at the outermost); ``up_in``: the channels into the
    up conv (2 * ``inner_nc`` below a submodule, ``inner_nc`` plus the
    condition's at an injecting innermost level)."""

    def __init__(self, in_nc: int, outer_nc: int, inner_nc: int, up_in: int,
                 outermost: bool = False, innermost: bool = False,
                 norm: str = "instance", use_dropout: bool = False,
                 inject_cond: bool = False, quant: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.outermost, self.use_dropout = outermost, use_dropout
        self.inject_cond = inject_cond
        use_bias = norm_uses_bias(norm)
        # a conv that feeds this level's norm drops its inert bias
        norm_bias = conv_bias_before_norm(norm)
        # quantize everything except the image-edge convs (outermost level)
        q = quant and not outermost
        down_normed = not (outermost or innermost)
        self.down = TorchConv(
            in_nc, inner_nc, 4, 2, 1, "zero",
            norm_bias if down_normed else (use_bias or outermost), dtype, q)
        self.down_norm = Norm(norm, inner_nc) if down_normed else None
        self.up = TorchConvTranspose(up_in, outer_nc, 4, 2, 1, 0,
                                     True if outermost else norm_bias,
                                     dtype, q)
        self.up_norm = None if outermost else Norm(norm, outer_nc)

    def down_path(self, x: torch.Tensor, cond: torch.Tensor,
                  H: Optional[int] = None) -> torch.Tensor:
        """``H``: x's global height where x is a band of it."""
        h = x if self.outermost else F.leaky_relu(x, 0.2)
        h = self.down(h, H=H)
        if self.down_norm is not None:
            h = self.down_norm(h)
        if self.inject_cond:
            h = torch.cat([h, broadcast_cond(cond, h.shape[2], h.shape[3],
                                             h.dtype)], 1)
        return h

    def up_path(self, x: torch.Tensor, h: torch.Tensor,
                keep: Optional[torch.Tensor], H: Optional[int] = None
                ) -> torch.Tensor:
        """``keep``: the dropout mask (bool, the up output's shape) of a
        training forward at a dropout level (flax ``nn.Dropout(0.5)``).
        ``H``: h's global height where h is a band of it (the skip concat
        pairs x's band with the up output's band of the same height)."""
        h = self.up(F.relu(h), H=H)
        if self.outermost:
            return torch.tanh(h.float())
        h = self.up_norm(h)
        if keep is not None:
            h = torch.where(keep, h / 0.5, torch.zeros_like(h))
        return torch.cat([x, h], 1)


class UnetGenerator(nn.Module):
    """``levels[i]`` is the flax tree's ``UnetSkipBlock_i``: level 0 is the
    innermost, level ``num_downs - 1`` the outermost. ``forward`` takes and
    returns NHWC like the resnet G."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3,
                 cond_nc: int = 10, ngf: int = 64, num_downs: int = 7,
                 norm: str = "instance", use_dropout: bool = False,
                 cond_inject: str = "input", dtype=torch.float32,
                 quant_trunk: bool = False, n_remat: int = 0):
        super().__init__()
        if cond_inject not in ("input", "bottleneck"):
            # loud: a typo here must not silently build an UNCONDITIONAL G
            raise NotImplementedError(
                f"cond_inject [{cond_inject}] (want input | bottleneck)")
        self.bottleneck = cond_inject == "bottleneck"
        self.compute_dtype = dtype
        # --remat: the innermost n_remat levels (at most num_downs - 1)
        self.n_remat = n_remat
        nc = 0 if self.bottleneck else cond_nc
        # (outer_nc, inner_nc) per level, innermost first
        widths = ([(ngf * 8, ngf * 8)] * (num_downs - 4)
                  + [(ngf * 4, ngf * 8), (ngf * 2, ngf * 4), (ngf, ngf * 2),
                     (output_nc, ngf)])
        levels = []
        for i, (outer, inner) in enumerate(widths):
            innermost, outermost = i == 0, i == num_downs - 1
            up_in = (inner + (cond_nc if self.bottleneck else 0)
                     if innermost else 2 * inner)
            levels.append(UnetSkipBlock(
                input_nc + nc if outermost else outer, outer, inner, up_in,
                outermost=outermost, innermost=innermost, norm=norm,
                use_dropout=use_dropout and 0 < i <= num_downs - 5,
                inject_cond=innermost and self.bottleneck,
                quant=quant_trunk, dtype=dtype))
        self.levels = nn.ModuleList(levels)

    def draw_keeps(self, x: torch.Tensor, generator: torch.Generator,
                   rows=None) -> dict:
        """{level: keep-mask of its up output} of a training forward with
        dropout, drawn (p = 0.5) innermost level first from ``generator``
        on x's device (for the global batch under ``rows``) at the global
        shape (inside ``spatial.banded`` x is a band: every rank draws the
        whole mask); level i works at 1/2^(depth-1-i) of x's size."""
        n = x.shape[0]
        sizes = self._sizes(spatial.global_h(x.shape[1]), x.shape[2])
        return {i: draw.rand((n, lvl.up.weight.shape[1]) + sizes[i],
                             generator, rows, device=x.device) < 0.5
                for i, lvl in enumerate(self.levels) if lvl.use_dropout}

    def _sizes(self, h: int, w: int) -> list:
        """(height, width) of each level's input (its up output), level
        0 the innermost, by the down convs' arithmetic."""
        out = [None] * len(self.levels)
        for i in range(len(self.levels) - 1, -1, -1):
            out[i] = (h, w)
            h, w = (self.levels[i].down.out_size(h),
                    self.levels[i].down.out_size(w))
        return out

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                rows=None) -> torch.Tensor:
        """x: (N,H,W,input_nc) in [-1,1]; cond: (N,cond_nc). Returns
        (N,H,W,output_nc) f32. A training forward with dropout draws its
        masks with ``draw_keeps`` from ``generator`` (``rows``: for the
        global batch)."""
        dropout = self.training and any(lvl.use_dropout
                                        for lvl in self.levels)
        keeps = {}
        if dropout:
            if generator is None:
                raise ValueError("a training forward with dropout needs the "
                                 "train state's generator")
            keeps = (self.draw_keeps(x, generator) if rows is None
                     else self.draw_keeps(x, generator, rows))
            keeps = {i: spatial.band_slice(k) for i, k in keeps.items()}
        h = x.permute(0, 3, 1, 2)
        H = spatial.global_h(h.shape[2])
        if not self.bottleneck:
            h = torch.cat([h, broadcast_cond(cond, h.shape[2], h.shape[3],
                                             h.dtype)], 1)
        remat = self.training and torch.is_grad_enabled()
        return self._level(len(self.levels) - 1, h, cond, keeps,
                           remat, H).permute(0, 2, 3, 1)

    def _level(self, i: int, x: torch.Tensor, cond: torch.Tensor,
               keeps: dict, remat: bool, H: int) -> torch.Tensor:
        """Level i on x, of ``H`` global rows (a band of them inside
        ``spatial.banded``)."""
        lvl = self.levels[i]
        h = lvl.down_path(x, cond, H)
        inner_h = lvl.down.out_size(H)
        if i > 0:
            if remat and i - 1 < self.n_remat:
                # the level and everything inside it recompute in the
                # backward pass, without moving the norm state a second
                # time; the masks are inputs, so they replay
                h = _checkpoint(self._level, self.levels[:i], i - 1, h, cond,
                                keeps, remat, inner_h)
            else:
                h = self._level(i - 1, h, cond, keeps, remat, inner_h)
        return lvl.up_path(x, h, keeps.get(i), inner_h)
