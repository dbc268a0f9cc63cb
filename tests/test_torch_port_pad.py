"""The port's deterministic reflect/replicate pad (``ops/pad.py``), CPU.

``ReflectPad2d`` / ``ReplicatePad2d`` pad as ``F.pad`` does and fold the
border cotangents back by slice-adds (``pad_fold``) instead of ATen's
atomics. Held here: the forward bit for bit and the gradient against
``F.pad``'s autograd (f32 within 1e-6; bf16 within 2^-6 of the summed
magnitudes folded onto each pixel: at most four adds, each rounding to
bf16's 8 bits on one side or the other), the gradient against ``jax.vjp`` of
``pcgan_tpu.models.layers.pad2d`` within 1e-6, ``gradcheck`` and
``gradgradcheck`` in f64, and the autograd graphs of the port's G, D and C
losses: no node of an op whose CUDA backward adds by atomics.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pcgan_tpu.models import layers as jl
from pcgan_tpu_torch.config import parse_config
from pcgan_tpu_torch.models import comparator as tc
from pcgan_tpu_torch.models import layers as tl
from pcgan_tpu_torch.models.registry import define_C, define_D, define_G
from pcgan_tpu_torch.ops.pad import (ReflectPad2d, ReplicatePad2d, pad2d,
                                     pad_fold)

MODES = ["reflect", "replicate"]
SHAPE = (2, 3, 9, 10)

# autograd nodes whose CUDA kernels add by atomics (or raise under
# torch.use_deterministic_algorithms)
ATOMIC_NODES = {"ReflectionPad1DBackward0", "ReflectionPad2DBackward0",
                "ReflectionPad3DBackward0", "ReplicationPad1DBackward0",
                "ReplicationPad2DBackward0", "ReplicationPad3DBackward0",
                "GatherBackward0", "IndexSelectBackward0",
                "ScatterAddBackward0", "IndexAddBackward0",
                "EmbeddingBackward0", "AdaptiveAvgPool2DBackward0",
                "UpsampleBilinear2DBackward0", "UpsampleBicubic2DBackward0",
                "NllLossBackward0", "CumsumBackward0",
                "RepeatInterleaveBackward0"}


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _grads(x, p, mode, g):
    xa = x.clone().requires_grad_(True)
    xb = x.clone().requires_grad_(True)
    ya, yb = pad2d(xa, p, mode), F.pad(xb, (p,) * 4, mode=mode)
    (ga,) = torch.autograd.grad(ya, xa, g)
    (gb,) = torch.autograd.grad(yb, xb, g)
    return ya, yb, ga, gb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_matches_f_pad_autograd(mode, p, dtype):
    x = torch.from_numpy(_x(SHAPE)).to(dtype)
    hp, wp = SHAPE[2] + 2 * p, SHAPE[3] + 2 * p
    g = torch.from_numpy(_x((*SHAPE[:2], hp, wp), seed=1)).to(dtype)
    ya, yb, ga, gb = _grads(x, p, mode, g)
    assert ya.dtype == dtype and torch.equal(ya, yb)
    assert ga.dtype == dtype and ga.is_contiguous()
    a, b = ga.float().numpy(), gb.float().numpy()
    mass = pad_fold(g.double().abs(), p, mode).numpy()
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -6 * mass
    assert np.all(np.abs(a - b) <= tol), np.abs(a - b).max()


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_gradient_matches_jax_vjp(mode, p):
    x = _x((2, 8, 11, 3))                     # NHWC for JAX
    _, vjp = jax.vjp(lambda t: jl.pad2d(t, p, mode), jnp.asarray(x))
    g = _x((2, 8 + 2 * p, 11 + 2 * p, 3), seed=2)
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = pad2d(xt, p, mode)
    np.testing.assert_array_equal(
        y.detach().permute(0, 2, 3, 1).numpy(),
        np.asarray(jl.pad2d(jnp.asarray(x), p, mode)))
    (got,) = torch.autograd.grad(
        y, xt, torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape,p", [((1, 2, 4, 5), 1), ((2, 1, 5, 4), 3),
                                     ((1, 1, 3, 3), 2)])
@pytest.mark.parametrize("mode", MODES)
def test_gradcheck_f64(mode, shape, p):
    x = torch.from_numpy(_x(shape)).double().requires_grad_(True)
    fn = (lambda t: pad2d(t, p, mode))
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


def test_fold_leaves_the_cotangent_alone_and_is_repeatable():
    """The fold writes only its own output (a view of a contiguous
    cotangent would alias it) and gives the same bits on every call."""
    g = torch.from_numpy(_x((1, 1, 7, 7)))
    g0 = g.clone()
    a, b = pad_fold(g, 2, "reflect"), pad_fold(g, 2, "reflect")
    assert torch.equal(g, g0) and torch.equal(a, b)
    assert pad2d(g, 0, "reflect") is g
    with pytest.raises(NotImplementedError):
        pad2d(g, 1, "circular")


@pytest.mark.parametrize("pad_mode,fn", [("reflect", ReflectPad2d),
                                         ("replicate", ReplicatePad2d)])
def test_torch_conv_routes_its_pad_through_the_function(pad_mode, fn):
    conv = tl.TorchConv(3, 4, 3, 1, 1, pad_mode)
    conv.weight.data.normal_()
    y = conv(torch.from_numpy(_x((1, 3, 6, 6))).requires_grad_(True))
    names = _graph_names(y)
    assert f"{fn.__name__}Backward" in names
    assert not names & ATOMIC_NODES


def _graph_names(*outs):
    seen, names = set(), set()
    stack = [o.grad_fn for o in outs if o.grad_fn is not None]
    while stack:
        n = stack.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        names.add(type(n).__name__)
        stack.extend(f for f, _ in n.next_functions)
    return names


SMALL = ["--crop_size", "32", "--load_size", "36", "--ngf", "8", "--ndf",
         "8", "--n_age_bins", "4", "--cmp_nf", "8", "--cmp_n_down", "3",
         "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--netG", "resnet_6blocks", "--cond_inject", "bottleneck"],
    ["--netG", "resnet_6blocks", "--dtype", "bfloat16"],
    ["--netG", "resnet_6blocks@resize_conv", "--g_attn", "--netD",
     "multiscale", "--n_layers_D", "2", "--spectral_norm", "--d_attn",
     "--norm", "group"],
    ["--netG", "unet_32", "--netD", "pixel", "--norm", "batch"],
])
def test_step_graphs_hold_no_atomic_backward(flags):
    """Every pad, gather and pool in the port's G, D and C losses
    differentiates without atomics on the card."""
    cfg = parse_config(SMALL + ["--dtype", "float32"] + flags)
    G, D, C = define_G(cfg), define_D(cfg), define_C(cfg)
    x = torch.from_numpy(_x((2, 32, 32, 3))).requires_grad_(True)
    cond = torch.eye(4)[:2]
    fake = G(x, cond)
    pred = D(fake, cond)
    preds = pred if isinstance(pred, (list, tuple)) else [pred]
    mu, log_var = C(torch.cat([x, fake]))
    cmp_loss = tc.comparison_loss(mu[:2], log_var[:2], mu[2:], log_var[2:],
                                  torch.tensor([0, 2]))
    names = _graph_names(cmp_loss, *[torch.as_tensor(p).sum()
                                     for p in _flat(preds)])
    assert not names & ATOMIC_NODES, names & ATOMIC_NODES


def _flat(xs):
    for x in xs:
        if isinstance(x, (list, tuple)):
            yield from _flat(x)
        else:
            yield x


def test_comparison_loss_picks_the_label_column_exactly():
    """The masked pick equals gather bit for bit, forward and backward."""
    rng = np.random.default_rng(3)
    mu = torch.from_numpy(rng.normal(size=(2, 6)).astype(np.float32))
    lv = torch.from_numpy(rng.normal(size=(2, 6)).astype(np.float32))
    label = torch.tensor([0, 1, 2, 2, 1, 0])
    m1 = mu.clone().requires_grad_(True)
    loss = tc.comparison_loss(m1[0], lv[0], m1[1], lv[1], label)
    m2 = mu.clone().requires_grad_(True)
    logp = tc.pairwise_log_probs(m2[0], lv[0], m2[1], lv[1])
    ref = -torch.mean(logp.gather(-1, label[:, None]))
    assert torch.equal(loss, ref)
    (g1,), (g2,) = (torch.autograd.grad(loss, m1),
                    torch.autograd.grad(ref, m2))
    torch.testing.assert_close(g1, g2, rtol=0, atol=1e-7)
