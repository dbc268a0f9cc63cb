"""Instance norm of bf16 NCHW with its activation and residual, as one
autograd Function: ``act(IN(x)) [+ residual]``.

The CUDA C++ source is ``pcgan_tpu_torch/csrc/instance_norm.cu`` (route:
nvcc -> shared library -> ctypes); its header comment gives the function,
the design and the bound. It replaces no TPU kernel: it does in one pass
each way what ``models/layers.py instance_norm``'s bf16 form and the
activation or residual after it do in about a dozen launches. ``act`` is
``none``, ``relu`` or ``leaky`` (``leaky_relu(0.2)``).

``NormAct`` takes CUDA tensors only: it launches the kernels or raises.
It saves x and the per-plane (mean, rstd, keep) rows, nothing of f32. Its
backward is the backward kernel; under ``create_graph`` (R1, the gradient
penalty) the kernel runs inside ``NormGrad``, which is differentiable
once: that second derivative is ``plain_double_backward``, in plain
PyTorch, from moments recomputed under autograd so that it sees how they
move.
``plain_forward``/``plain_backward`` are the kernels' arithmetic in plain
PyTorch, which the tests hold the kernels to. ``models/layers.py`` routes
a CUDA bf16 tensor outside a spatial band here and keeps its composite for
every other case.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pcgan_tpu_torch.ops import _build

SOURCE = "instance_norm.cu"
ACTS = ("none", "relu", "leaky")
SLOPE = 0.2             # leaky's negative slope

# kernel launches made by this wrapper (forward and backward); chip_smoke.py
# and the card tests read it to show a path went through the kernels
launches = 0


@functools.cache
def _lib():
    lib = _build.load("pcgan_instance_norm", SOURCE)
    lib.pcgan_instance_norm_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    lib.pcgan_instance_norm_bwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.pcgan_instance_norm_fwd.restype = ctypes.c_int
    lib.pcgan_instance_norm_bwd.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernels now (first use does it otherwise)."""
    _lib()


# --------------------------------------------------------------------------- #
# the plain version: the kernels' arithmetic in plain PyTorch
# --------------------------------------------------------------------------- #


def moments(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(3, N*C) f32 rows (mean, rstd, keep) of x's planes, as the bf16
    composite computes them: mean and mean of bf16(x * x) in f32, the
    variance clamped at 0 (keep 1 where it was not cut, where torch's clamp
    passes its gradient), rstd = rsqrt(var + eps)."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3))
    var = (x * x).float().mean(dim=(2, 3)) - mean.square()
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    return torch.stack([mean, rstd, (var >= 0).float().detach()]).view(3, -1)


def _planes(stats: torch.Tensor, x: torch.Tensor):
    n, c = x.shape[:2]
    return (s.view(n, c, 1, 1) for s in stats)


def epilogue(y: torch.Tensor, act: str = "none",
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """``act(y) [+ residual]``; act is none, relu or leaky
    (``leaky_relu(0.2)``)."""
    if act == "relu":
        y = F.relu(y)
    elif act == "leaky":
        y = F.leaky_relu(y, SLOPE)
    elif act != "none":
        raise ValueError(f"act {act!r}: want none | relu | leaky")
    return y if residual is None else residual + y


def _act_grad(g: torch.Tensor, y: torch.Tensor, act: str) -> torch.Tensor:
    """g through the activation's backward, in g's dtype, as torch's."""
    if act == "relu":
        return torch.where(y > 0, g, torch.zeros_like(g))
    if act == "leaky":
        return torch.where(y > 0, g, g * SLOPE)
    return g


def plain_forward(x: torch.Tensor, act: str = "none",
                  residual: torch.Tensor | None = None, eps: float = 1e-5,
                  stats: torch.Tensor | None = None):
    """(out, stats): ``act(bf16((x - mean) * rstd)) [+ residual]`` in x's
    dtype and ``moments(x)`` (or the ``stats`` given)."""
    stats = moments(x, eps) if stats is None else stats
    mean, rstd, _ = _planes(stats, x)
    return epilogue(((x.float() - mean) * rstd).to(x.dtype), act,
                    residual), stats


def plain_backward(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                   act: str = "none") -> torch.Tensor:
    """dx of ``plain_forward``'s out from out's gradient g: ``rstd * (g' -
    mean(g') - xhat * mean(g' * xhat) * keep)``, g' = g through the
    activation, in f32, rounded once to x's dtype."""
    mean, rstd, keep = _planes(stats, x)
    xhat = (x.float() - mean) * rstd
    gp = _act_grad(g, xhat.to(x.dtype), act).float()
    mg = gp.mean(dim=(2, 3), keepdim=True)
    mgx = (gp * xhat).mean(dim=(2, 3), keepdim=True) * keep
    return (rstd * (gp - mg - xhat * mgx)).to(x.dtype)


def plain_double_backward(x: torch.Tensor, g: torch.Tensor,
                          gg: torch.Tensor, act: str = "none",
                          eps: float = 1e-5):
    """(of x, of g): the gradients of ``<plain_backward(x, g, moments(x)),
    gg>``, the backward's own backward, with the moments recomputed under
    autograd so that it sees how they move with x."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        g = g.detach().requires_grad_()
        dx = plain_backward(x, g, moments(x, eps), act)
        return torch.autograd.grad(dx, (x, g), gg)


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #


def _check(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"instance norm kernel: {what} on {x.device}, "
                         f"want cuda")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"instance norm kernel: want {what} (N,C,H,W) "
                         f"bfloat16, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"instance norm kernel: {what} must be contiguous "
                         f"NCHW")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def forward_cuda(x: torch.Tensor, act: str = "none",
                 residual: torch.Tensor | None = None, eps: float = 1e-5):
    """``plain_forward`` by the forward kernel on x's current stream."""
    global launches
    _check(x, "x")
    if residual is not None:
        _check(residual, "residual")
        if residual.shape != x.shape or residual.device != x.device:
            raise ValueError(f"instance norm kernel: residual "
                             f"{tuple(residual.shape)} on {residual.device}"
                             f", want x's {tuple(x.shape)} on {x.device}")
    n, c, h, w = x.shape
    out = torch.empty_like(x)
    stats = torch.empty((3, n * c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().pcgan_instance_norm_fwd(
            x.data_ptr(), 0 if residual is None else residual.data_ptr(),
            out.data_ptr(), stats.data_ptr(), n * c, h * w, ACTS.index(act),
            eps, _stream(x))
    if err != 0:
        raise RuntimeError(f"instance norm forward kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    return out, stats


def backward_cuda(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                  act: str = "none") -> torch.Tensor:
    """``plain_backward`` by the backward kernel on x's current stream."""
    global launches
    _check(x, "x")
    _check(g, "the gradient")
    n, c, h, w = x.shape
    if g.shape != x.shape or stats.shape != (3, n * c) \
            or stats.dtype != torch.float32 or not stats.is_contiguous():
        raise ValueError(f"instance norm kernel: gradient {tuple(g.shape)} "
                         f"and stats {tuple(stats.shape)} {stats.dtype} do "
                         f"not fit x {tuple(x.shape)}")
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().pcgan_instance_norm_bwd(
            x.data_ptr(), g.data_ptr(), stats.data_ptr(), dx.data_ptr(),
            n * c, h * w, ACTS.index(act), _stream(x))
    if err != 0:
        raise RuntimeError(f"instance norm backward kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    return dx


class NormAct(torch.autograd.Function):
    """``act(IN(x)) [+ residual]`` by the forward kernel; saves x and the
    (3, N*C) moments. Its backward is the backward kernel, inside
    ``NormGrad`` under ``create_graph``."""

    @staticmethod
    def forward(ctx, x, residual, act, eps):
        out, stats = forward_cuda(x, act, residual, eps)
        ctx.save_for_backward(x, stats)
        ctx.act, ctx.eps, ctx.residual = act, eps, residual is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, stats = ctx.saved_tensors
        g = g.contiguous()
        if torch.is_grad_enabled():
            # create_graph (R1, the gradient penalty): dx is differentiated
            dx = NormGrad.apply(x, g, stats, ctx.act, ctx.eps)
        else:
            # the same kernel without a Function's ~10 us of host time a
            # call, 29-32 calls a training step
            dx = backward_cuda(x, g, stats, ctx.act)
        return dx, (g if ctx.residual else None), None, None


class NormGrad(torch.autograd.Function):
    """``NormAct``'s dx by the backward kernel, under ``create_graph`` as
    without it. Differentiable once: its backward is
    ``plain_double_backward``."""

    @staticmethod
    def forward(ctx, x, g, stats, act, eps):
        ctx.save_for_backward(x, g)
        ctx.act, ctx.eps = act, eps
        return backward_cuda(x, g, stats, act)

    @staticmethod
    @once_differentiable
    def backward(ctx, gg):
        x, g = ctx.saved_tensors
        gx, gg_ = plain_double_backward(x, g, gg.contiguous(), ctx.act,
                                        ctx.eps)
        return gx, gg_, None, None, None


def fused(x: torch.Tensor, act: str = "none",
          residual: torch.Tensor | None = None,
          eps: float = 1e-5) -> torch.Tensor:
    """``act(IN(x)) [+ residual]`` for x (N, C, H, W) bf16 on a CUDA
    device through ``NormAct``; raises on any other device."""
    if act not in ACTS:
        raise ValueError(f"instance norm: act {act!r} not in {ACTS}")
    # the kernels read contiguous NCHW; the copy, if any, stays in the
    # graph (a double backward reaches x through it)
    x = x.contiguous()
    residual = None if residual is None else residual.contiguous()
    return NormAct.apply(x, residual, act, eps)
