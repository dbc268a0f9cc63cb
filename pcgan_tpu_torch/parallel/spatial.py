"""The ``spatial`` mesh axis: activations split along H (the counterpart
of GSPMD's H partition under ``P('data', 'spatial', None, None)``,
``pcgan_tpu/parallel/auto.py:50-53, 134-146``).

Each rank of a spatial line holds, and computes on, one band of rows of
every activation of G, D and C. One partition rule serves every height:
rank k of n holds rows ``[min(k*c, H), min((k+1)*c, H))`` with ``c =
ceil(H/n)``, as GSPMD pads an uneven dim, so the last bands may be short
or empty (``band_of``). Widths, channels and batch rows stay whole.

Inside ``banded(line, H)`` (entered by the sharded-state step around its
preprocessing and its passes, as ``models/layers.py batch_norm_group`` is)
the layers compute on bands:

- a conv needs rows of the neighbouring bands (its halo). Every rank
  knows every band and every conv's window, so the exchange is planned
  alike on every rank with no collective: ``fetch`` exports each band's
  top and bottom slabs (the rows the ranks above and below read) and
  all-gathers them over the line (gloo cannot move CUDA tensors point to
  point; one all-gather serves both backends). When the slabs would reach
  across a whole band (a band thinner than the halo, or empty) every rank
  exports its whole band instead. The backward sends each halo gradient
  back the same way and its owner adds them in rank order, so the result
  is the same bits on every run; it is differentiable again (its own
  backward is the exchange), so a double backward (R1, the gradient
  penalty) runs on bands. Pads (reflect, replicate, zero) apply at
  the global top and bottom only;
- a mean over H (instance and batch norm's moments, C's pool) is a sum
  over the band, summed over the line (``line_sum``, whose backward sums
  the gradient over the line), divided by the line's count, which rides
  in the same all-reduce: unequal bands weigh by rows;
- every rank of a line runs the same layers in the same order, a rank
  whose band is empty included (its outputs stay joined to the graph; a
  conv or pool computes on a dummy window of zeros and keeps none of
  its output, so its graph is the other ranks'), so the collectives of
  the forward and of the backward (autograd runs the nodes in reverse
  creation order) pair up, those of a double backward too.

A loss is this rank's share of the line's loss (``band_mean``: the band's
sum over the line's count, which the band rule gives without a
collective); the shares sum to the one-device loss, so the parameter
gradients are summed over the line (``parallel/auto.py``).

The model levers run on bands too: a 2x2/stride-2 pool is a k2 s2 p0
window over the bands (``pool2``), so a band that starts on an odd row or
is odd in height still pools the global row pairs; a nearest 2x upsample
fetches its source rows (``upsample2``); an operand every row needs whole
(self-attention's pooled keys and values) is all-gathered over the line
(``gather_band``), its gradient summed back to each owner in rank order.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from pcgan_tpu_torch.parallel.axis import Axis

# --------------------------------------------------------------------------- #
# bands
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Band:
    """Rows ``[r0, r0 + h)`` of a tensor of global height ``H``."""
    H: int
    r0: int
    h: int

    @property
    def r1(self) -> int:
        return self.r0 + self.h


def band_of(H: int, n: int, coord: int) -> Band:
    """Rank ``coord``'s band of ``H`` rows over ``n`` ranks."""
    c = -(-H // n)
    r0 = min(coord * c, H)
    return Band(H, r0, min(r0 + c, H) - r0)


def bands_of(H: int, n: int) -> List[Band]:
    return [band_of(H, n, k) for k in range(n)]


def conv_out(H: int, k: int, s: int, p: int) -> int:
    return (H + 2 * p - k) // s + 1


def conv_windows(H: int, n: int, k: int, s: int, p: int
                 ) -> List[Optional[Tuple[int, int]]]:
    """Each rank's input rows ``[lo, hi)`` (beyond ``[0, H)`` where the
    conv pads) for its band of the conv's output; None for an empty
    output band."""
    out = []
    for b in bands_of(conv_out(H, k, s, p), n):
        out.append(None if b.h == 0 else
                   (b.r0 * s - p, (b.r1 - 1) * s - p + k))
    return out


def deconv_windows(H: int, n: int, k: int, s: int, p: int, op: int
                   ) -> Tuple[int, List[Optional[Tuple[int, int]]]]:
    """(output height, each rank's input rows ``[lo, hi)``) of a
    transposed conv: output row y takes input row i at tap y - (i*s - p)."""
    H_out = (H - 1) * s - 2 * p + k + op
    out = []
    for b in bands_of(H_out, n):
        if b.h == 0:
            out.append(None)
            continue
        lo = max(0, -(-(b.r0 + p - k + 1) // s))
        hi = min(H, (b.r1 - 1 + p) // s + 1)
        out.append((lo, hi))
    return H_out, out


def _clip(w, H) -> Tuple[int, int]:
    """The real rows of a window (an empty range for None)."""
    if w is None:
        return (0, 0)
    lo, hi = max(w[0], 0), min(w[1], H)
    return (lo, hi) if lo < hi else (0, 0)


def plan_text(H: int, n: int, k: int = 0, s: int = 1, p: int = 0) -> str:
    """``32: 8+8+8+8`` (the band heights of H rows over n ranks); with a
    conv, its halo rows a rank: ``halo 1/2``."""
    text = f"{H}: " + "+".join(str(b.h) for b in bands_of(H, n))
    if k:
        lay = _Layout(H, n, [_clip(w, H) for w in conv_windows(H, n, k, s,
                                                                p)])
        text += (" whole bands" if lay.whole
                 else f" halo {lay.top}/{lay.bottom}")
    return text


def band_plan(cfg, n: int) -> dict:
    """{layer: its input's band heights over n ranks and its halo} of G and
    D at ``--crop_size`` (``tools/doctor.py``), read off the models: G and
    D built from ``cfg`` on the meta device run once, and each conv,
    deconv, attention block (its pooled keys, which every rank gathers
    whole), resize conv, 2x2 pool and logit map records its input's height
    in forward order. Layers of one plan under numbered names share a line
    (``*`` for the number)."""
    import re
    import warnings
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.models.generator import SelfAttention
    from pcgan_tpu_torch.models.layers import (ResizeConv, TorchConv,
                                               TorchConvTranspose)
    with torch.device("meta"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # input injection
        nets = {"G": define_G(cfg).eval(), "D": define_D(cfg).eval()}
    rows, pools = [], []

    def label(net, name):
        head, _, rest = name.partition(".")
        return (f"{head} {rest}" if re.fullmatch(r"D_\d+", head)
                else f"{net} {name}")

    def record(net, name, mod):
        def pre(_, args):
            H = args[0].shape[2]
            at = label(net, name)
            if isinstance(mod, SelfAttention):
                rows.append((f"{at} pooled keys", _attn_text(H, n)))
                return
            conv = mod.conv if isinstance(mod, ResizeConv) else mod
            k, st, p = conv.weight.shape[2], conv.stride, conv.padding
            kind = f"{k}x{k}" + (f" s{st}" if st > 1 else "")
            if isinstance(mod, ResizeConv):
                rows.append((f"{at} resize 2x", plan_text(H, n) + " -> "
                             + plan_text(2 * H, n, k, st, p)))
            elif isinstance(mod, TorchConvTranspose):
                rows.append((f"{at} deconv {kind}", plan_text(H, n)))
            else:
                rows.append((f"{at} {kind}", plan_text(H, n, k, st, p)))
        return pre

    hooks, inner = [], ()
    for net, model in nets.items():
        for name, mod in model.named_modules():
            if isinstance(mod, (SelfAttention, ResizeConv)):
                inner += (name + ".",)          # their convs: one line
            elif (not isinstance(mod, (TorchConv, TorchConvTranspose))
                  or name.startswith(inner)):
                continue
            hooks.append(mod.register_forward_pre_hook(
                record(net, name, mod)))
    h = cfg.data.crop_size
    x = torch.empty(1, h, h, cfg.data.input_nc, device="meta")
    c = torch.empty(1, cfg.cond_nc, device="meta")
    _STATE["plan"] = lambda H: pools.append(H)
    try:
        with torch.no_grad():
            nets["G"](x, c)
            preds = nets["D"](x, c)
    finally:
        _STATE["plan"] = None
        for hk in hooks:
            hk.remove()
    for i, H in enumerate(pools, 1):       # the multiscale D's, in order
        at = next(j for j, (k, _) in enumerate(rows)
                  if k.startswith(f"D_{i} "))
        rows.insert(at, (f"D_{i} pool 2x2", plan_text(H, n, 2, 2, 0)))
    preds = preds if isinstance(preds, tuple) else (preds,)
    for i, pred in enumerate(preds):        # NHWC logit maps
        pre = f"D_{i}" if len(preds) > 1 else "D"
        rows.append((f"{pre} logits", plan_text(pred.shape[1], n)))
    groups: dict = {}
    for k, text in rows:
        groups.setdefault(re.sub(r"\.\d+", ".*", k), []).append((k, text))
    out = {}
    for key, members in groups.items():
        if len(members) > 1 and len({t for _, t in members}) == 1:
            out[key] = members[0][1]
        else:
            out.update(members)
    return out


def _attn_text(H: int, n: int) -> str:
    """``8: 2+2+2+2 halo 0/0, keys 4 rows gathered`` (the 2x2 pool's)."""
    return (f"{plan_text(H, n, 2, 2, 0)}, keys {conv_out(H, 2, 2, 0)} rows "
            f"gathered")


# --------------------------------------------------------------------------- #
# the context the layers read
# --------------------------------------------------------------------------- #


_STATE = {"line": None, "image_h": None, "plan": None}


def spatial_line(mesh) -> Optional[Axis]:
    """The collectives of this rank's spatial line, None for a spatial
    axis of size 1."""
    from pcgan_tpu_torch.parallel.mesh import SPATIAL
    return None if mesh.size(SPATIAL) <= 1 else Axis(mesh, SPATIAL)


@contextlib.contextmanager
def banded(line: Optional[Axis], image_h: int):
    """Inside, the layers compute on this rank's bands of images of
    ``image_h`` rows (``line`` None: the plain path)."""
    prev = dict(_STATE)
    _STATE.update(line=line, image_h=int(image_h))
    try:
        yield
    finally:
        _STATE.update(prev)


def active() -> Optional[Axis]:
    """The spatial line the layers compute over, None outside ``banded``."""
    return _STATE["line"]


def image_band() -> Band:
    line = _STATE["line"]
    return band_of(_STATE["image_h"], line.n, line.coord)


def global_h(local_h: int) -> int:
    """The global height of a network's input image of ``local_h`` rows:
    the image's inside ``banded`` (the band must be this rank's), else
    ``local_h``."""
    line = _STATE["line"]
    if line is None:
        return local_h
    b = image_band()
    if local_h != b.h:
        raise ValueError(f"spatial rank {line.coord}: an input of {local_h} "
                         f"rows is not its band of the {b.H}-row image "
                         f"({b.h} rows)")
    return b.H


# --------------------------------------------------------------------------- #
# the halo exchange
# --------------------------------------------------------------------------- #


class _Layout:
    """The slabs every rank exports for a set of windows over the bands of
    H rows: the top ``top`` rows (read by the ranks above) and the bottom
    ``bottom`` rows (read by the ranks below) of each band, or, where
    those would reach across a whole band, the whole band (``top`` = the
    widest band, ``bottom`` = 0)."""

    def __init__(self, H: int, n: int, windows: Sequence[Tuple[int, int]]):
        self.bands, self.windows = bands_of(H, n), list(windows)
        top = bottom = 0
        for i, b in enumerate(self.bands):
            for j, (w0, w1) in enumerate(self.windows):
                lo, hi = max(w0, b.r0), min(w1, b.r1)
                if j == i or lo >= hi:
                    continue
                if j < i:
                    top = max(top, hi - b.r0)
                else:
                    bottom = max(bottom, b.r1 - lo)
        c = max(b.h for b in self.bands)
        self.whole = c > 0 and top + bottom >= c
        if self.whole:
            top, bottom = c, 0
        self.top, self.bottom = top, bottom

    @property
    def rows(self) -> int:
        return self.top + self.bottom

    def pieces(self, j: int):
        """The (source rank, first row, rows) pieces of rank j's window,
        in row order."""
        w0, w1 = self.windows[j]
        out = []
        for i, b in enumerate(self.bands):
            lo, hi = max(w0, b.r0), min(w1, b.r1)
            if lo < hi:
                out.append((i, lo, hi - lo))
        return out

    def slot(self, i: int, j: int, row: int) -> int:
        """Where global ``row`` of band i sits in i's export for rank j."""
        b = self.bands[i]
        if j > i and self.bottom:
            return self.top + self.bottom - (b.r1 - row)
        return row - b.r0

    def export(self, x: torch.Tensor) -> torch.Tensor:
        """This band's slabs (N, C, top + bottom, W), zero where the band
        is shorter."""
        h = x.shape[2]
        buf = x.new_zeros(x.shape[:2] + (self.rows,) + x.shape[3:])
        t = min(self.top, h)
        buf[:, :, :t] = x[:, :, :t]
        u = min(self.bottom, h)
        if u:
            buf[:, :, self.rows - u:] = x[:, :, h - u:]
        return buf


class _Fetch(torch.autograd.Function):
    """Rank j's window ``windows[j]`` of a tensor banded over the line
    (see ``fetch``); the backward is the exchange's adjoint
    (``_ReturnHalo``), itself differentiable, so a double backward (R1's,
    the gradient penalty's) runs on bands."""

    @staticmethod
    def forward(ctx, x, line, lay):
        ctx.line, ctx.lay, ctx.shape = line, lay, x.shape
        me = line.coord
        slabs = line.all_gather(lay.export(x).reshape(-1), "halo")
        out = []
        for i, r0, h in lay.pieces(me):
            if i == me:
                out.append(x[:, :, r0 - lay.bands[me].r0:][:, :, :h])
            else:
                s = lay.slot(i, me, r0)
                src = slabs[i].view(x.shape[:2] + (lay.rows,)
                                    + x.shape[3:])
                out.append(src[:, :, s:s + h])
        if not out:
            return x.new_zeros(x.shape[:2] + (0,) + x.shape[3:])
        return torch.cat(out, 2)     # a new tensor, never a view of x

    @staticmethod
    def backward(ctx, g):
        return _ReturnHalo.apply(g, ctx.line, ctx.lay, ctx.shape), None, None


class _ReturnHalo(torch.autograd.Function):
    """The halo exchange's adjoint: each window gradient ``g`` back on its
    owners' bands, every halo gradient returned to its owner (one
    all-gather), which adds them in rank order (the same bits on every
    run). Linear, so its backward is the exchange again (``_Fetch``)."""

    @staticmethod
    def forward(ctx, g, line, lay, shape):
        ctx.line, ctx.lay = line, lay
        n, me = line.n, line.coord
        b = lay.bands[me]
        slab = shape[:2] + (lay.rows,) + shape[3:]
        ret = g.new_zeros((n,) + slab)
        gx = g.new_zeros(shape)
        at = 0
        for i, r0, h in lay.pieces(me):
            piece = g[:, :, at:at + h]
            if i == me:
                gx[:, :, r0 - b.r0:r0 - b.r0 + h] += piece
            else:
                s = lay.slot(i, me, r0)
                ret[i, :, :, s:s + h] = piece
            at += h
        back = line.all_gather(ret.reshape(-1), "halo_grad")
        t, u = min(lay.top, b.h), min(lay.bottom, b.h)
        for j in range(n):
            if j == me:
                continue
            mine = back[j].view((n,) + slab)[me]
            if t:
                gx[:, :, :t] += mine[:, :, :t]
            if u:
                gx[:, :, b.h - u:] += mine[:, :, lay.rows - u:]
        return gx

    @staticmethod
    def backward(ctx, gg):
        return _Fetch.apply(gg, ctx.line, ctx.lay), None, None, None


def fetch(x: torch.Tensor, H: int,
          windows: Sequence[Optional[Tuple[int, int]]]) -> torch.Tensor:
    """This rank's rows ``[lo, hi)`` ∩ ``[0, H)`` of the NCHW tensor whose
    band (of H rows over the line) is ``x``; ``windows`` holds every
    rank's ``(lo, hi)`` (None: nothing), alike on every rank. Without a
    halo to move no collective runs, on every rank alike."""
    line = _STATE["line"]
    lay = _Layout(H, line.n, [_clip(w, H) for w in windows])
    if lay.rows == 0:
        w0, w1 = lay.windows[line.coord]
        r0 = lay.bands[line.coord].r0
        return x[:, :, w0 - r0:w1 - r0] if w1 > w0 else x[:, :, :0]
    return _Fetch.apply(x, line, lay)


class _Gather(torch.autograd.Function):
    """The whole tensor from every rank's band (``gather_band``); the
    backward is its adjoint (``_SumBand``), itself differentiable."""

    @staticmethod
    def forward(ctx, x, line, H):
        ctx.line, ctx.H = line, H
        bands = bands_of(H, line.n)
        pad = x.new_zeros(x.shape[:2] + (bands[0].h,) + x.shape[3:])
        pad[:, :, :x.shape[2]] = x
        parts = line.all_gather(pad.reshape(-1), "gather_band")
        return torch.cat([p.view(pad.shape)[:, :, :b.h]
                          for p, b in zip(parts, bands)], 2)

    @staticmethod
    def backward(ctx, g):
        return _SumBand.apply(g, ctx.line, ctx.H), None, None


class _SumBand(torch.autograd.Function):
    """``gather_band``'s adjoint: this rank's rows of the whole gradient
    summed over the line (one all-gather of every rank's whole gradient,
    each owner adding its rows' in rank order: the same bits on every
    run). Linear, so its backward is the gather again."""

    @staticmethod
    def forward(ctx, g, line, H):
        ctx.line, ctx.H = line, H
        b = band_of(H, line.n, line.coord)
        g = g.contiguous()
        parts = line.all_gather(g.reshape(-1), "gather_band_grad")
        gx = parts[0].view(g.shape)[:, :, b.r0:b.r1].clone()
        for p in parts[1:]:
            gx += p.view(g.shape)[:, :, b.r0:b.r1]
        return gx

    @staticmethod
    def backward(ctx, gg):
        return _Gather.apply(gg, ctx.line, ctx.H), None, None


def gather_band(x: torch.Tensor, H: int) -> torch.Tensor:
    """The whole NCHW tensor of ``H`` rows whose band is ``x``, from every
    rank of the line in rank order (one all-gather, each band padded to the
    widest); ``x`` itself outside ``banded``."""
    line = _STATE["line"]
    return x if line is None else _Gather.apply(x, line, H)


def pool2(x: torch.Tensor, H: int, mode: str) -> torch.Tensor:
    """The 2x2/stride-2 ``'max'`` or ``'avg'`` pool (VALID: an odd height or
    width drops its last row or column) of the NCHW tensor of ``H`` rows
    whose band is ``x``: this rank's band of the ``H // 2`` pooled rows,
    its window fetched over the line (the whole pool outside
    ``banded``)."""
    pool = F.max_pool2d if mode == "max" else F.avg_pool2d
    line = _STATE["line"]
    if line is None:
        if _STATE["plan"] is not None and mode == "avg":
            _STATE["plan"](H)   # band_plan's: the multiscale D's pools
        return pool(x, 2, 2)
    wins = conv_windows(H, line.n, 2, 2, 0)
    xw = fetch(x, H, wins)
    if wins[line.coord] is None:
        # the pool of two rows of zeros, dropped: an empty band's graph is
        # the other ranks' (``TorchConv._band_conv``)
        xw = torch.cat([xw, xw.new_zeros(xw.shape[:2] + (2,)
                                         + xw.shape[3:])], 2)
        return pool(xw, 2, 2)[:, :, :0]
    return pool(xw, 2, 2)


def upsample2(x: torch.Tensor, H: int) -> torch.Tensor:
    """The nearest 2x upsample (output row r reads row r // 2) of the NCHW
    tensor of ``H`` rows whose band is ``x``: this rank's band of the 2H
    rows, its source rows ``[r0 // 2, ceil(r1 / 2))`` fetched over the
    line."""
    line = _STATE["line"]
    out = bands_of(2 * H, line.n)
    wins = [None if b.h == 0 else (b.r0 // 2, -(-b.r1 // 2)) for b in out]
    b = out[line.coord]
    xw = fetch(x, H, wins).repeat_interleave(2, dim=2)
    first = b.r0 - 2 * (b.r0 // 2)
    return xw[:, :, first:first + b.h].repeat_interleave(2, dim=3)


def band_slice(t: torch.Tensor) -> torch.Tensor:
    """This rank's band (along dim 2) of a whole tensor every rank holds,
    such as a dropout mask drawn at the global shape (``t`` itself outside
    ``banded``)."""
    line = _STATE["line"]
    if line is None:
        return t
    b = band_of(t.shape[2], line.n, line.coord)
    return t[:, :, b.r0:b.r1]


# --------------------------------------------------------------------------- #
# sums over the line
# --------------------------------------------------------------------------- #


class _LineSum(torch.autograd.Function):
    """``x`` summed over the line; its backward is the same sum of the
    gradient (differentiable again)."""

    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return line.all_reduce_sum(x, "all_reduce_sum")

    @staticmethod
    def backward(ctx, g):
        return _LineSum.apply(g, ctx.line), None


def line_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the spatial line (``x`` itself outside
    ``banded``)."""
    line = _STATE["line"]
    return x if line is None else _LineSum.apply(x, line)


def line_total(x: torch.Tensor) -> torch.Tensor:
    """A value every rank of the line holds (a count, the losses for the
    metrics) summed over the line, outside autograd."""
    line = _STATE["line"]
    if line is None:
        return x
    return line.all_reduce_sum(x.detach(), "all_reduce_sum")


def band_mean(x: torch.Tensor, H: Optional[int] = None) -> torch.Tensor:
    """``torch.mean(x)`` of the line's NHWC tensor of ``H`` rows whose band
    is ``x``, as this rank's share: the band's sum over the line's count,
    which the band rule gives every rank alike (``torch.mean`` itself
    outside ``banded``)."""
    line = _STATE["line"]
    if line is None:
        return torch.mean(x)
    if H is None:
        raise ValueError("band_mean of a band needs the tensor's global "
                         "height")
    count = x.shape[0] * H
    for d in x.shape[2:]:
        count *= d
    return x.sum() / count


def share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of a value alike on every rank of the line (1/n
    of it), so the shares sum to it."""
    line = _STATE["line"]
    if line is None:
        return x
    return x / torch.tensor(float(line.n), dtype=x.dtype, device=x.device)


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """(N, C) mean over H and W of an NCHW tensor banded along H: the
    band's sums over the line, over the line's count."""
    if _STATE["line"] is None:
        return x.mean(dim=(2, 3))
    n, c = x.shape[:2]
    local = torch.cat([x.sum(dim=(2, 3)).reshape(-1),
                       x.new_tensor([float(x.shape[2] * x.shape[3])])])
    tot = line_sum(local)
    return tot[:-1].view(n, c) / tot[-1].detach()


def empty_like_out(x: torch.Tensor, w: torch.Tensor, shape) -> torch.Tensor:
    """A layer's empty output band (``shape`` has 0 rows) kept in the
    graph of its input and weight, so its backward (and the halo
    collectives behind it) runs on this rank as on the others. The
    products make the zero gradients whole tensors (a sum's own backward
    is a stride-0 expand, which an in-place accumulation refuses)."""
    zero = (x * 0).sum() + (w * 0).sum()
    return x.new_zeros(shape) + zero.to(x.dtype)


class SavedAudit:
    """Inside ``with``, watches what autograd saves for the backward
    (``torch.autograd.graph.saved_tensors_hooks``; the run is unchanged):
    ``saved_bytes``, the bytes of the distinct storages it keeps,
    parameters aside, and ``whole``, the shapes of the 4-d tensors whose
    rows equal their columns and exceed what a band of ``n`` ranks holds
    with a 7x7 conv's halo, ``ceil(h/n) + 6``: a whole square image,
    which a band run of square crops never keeps (a lever quietly
    computing on the whole image does). Levels of 2n + 6 rows or fewer are
    not seen. The rows and columns are dims 2 and 3, but of an NHWC view
    of an NCHW activation (dim 2, its width, innermost in memory: D's and
    VGG's feature taps) dims 1 and 2."""

    def __init__(self, n: int):
        self.n = n
        self.storages: dict = {}
        self.whole: List[tuple] = []
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)

    def _pack(self, t: torch.Tensor) -> torch.Tensor:
        if not (t.requires_grad and t.is_leaf):
            st = t.untyped_storage()
            self.storages[st.data_ptr()] = st.nbytes()
            h = w = 0
            if t.dim() == 4:
                nhwc = (t.shape[2] > 1 and t.stride(2) == 1
                        and t.stride(3) != 1)
                h, w = t.shape[1:3] if nhwc else t.shape[2:]
            if h and h == w and h > -(-h // self.n) + 6:
                self.whole.append(tuple(t.shape))
        return t

    @property
    def saved_bytes(self) -> int:
        return sum(self.storages.values())

    def __enter__(self) -> "SavedAudit":
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._hooks.__exit__(*exc)
