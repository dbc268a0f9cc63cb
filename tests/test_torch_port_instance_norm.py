"""The fused instance norm (``pcgan_tpu_torch/ops/cuda_instance_norm.py``,
``csrc/instance_norm.cu``): its plain version against autograd of the
composite it replaces (CPU), the route ``models/layers.py`` takes, and the
kernels against the plain version on a CUDA card (``cuda`` marker; they
skip where no card is present). This file imports no jax; on the card::

    python -m pytest tests/test_torch_port_instance_norm.py --noconftest -q -p no:cacheprovider

Tolerances, with their reasons:

- plain forward == the composite, bit for bit: the same operations in the
  same order.
- plain backward against autograd of the composite: the composite rounds
  to bf16 three times on the way to dx (the f32 path's gradient, the
  ``x * x`` path's, their sum) and the plain version once, each rounding
  within 2^-9 of the sum of the terms' magnitudes ``s = rstd * (|g'| +
  |mean g'| + (|xhat| + |mean| rstd) |mean(g' xhat)|)`` (the ``x * x``
  path's term is ``x rstd^2 mean(g' xhat)``, of the uncentred x; the f32
  path's mean term cancels its offset): at most ``2^-7 * s`` apart.
- the double backward's second derivative (``plain_double_backward``)
  against the composite's, in f32 (where no rounding hides it): 1e-4 of
  the largest entry, sums in another order.
- card, forward: the moments are f32 sums in another order: the mean
  within 1e-5 of ``|mean| + 1 / rstd``, rstd within 1e-5 of itself times
  ``1 + (mean rstd)^2``, how much ``E[x^2] - E[x]^2`` amplifies a sum's
  error. From the kernel's moments the plain version's output has the
  kernel's bits: the same f32 operations, each rounded once. (From its own
  moments a norm output may round to the neighbouring bf16 value, and
  where the residual cancels it that one ulp is many of the sum's.)
- card, backward from the same moments: f32 sums in another order, then
  one rounding: one bf16 ulp of the plain dx, magnitudes below 2^-7 of the
  plane's largest |dx| counting as that.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch

from pcgan_tpu_torch.models import layers
from pcgan_tpu_torch.ops import cuda_instance_norm as cin
from pcgan_tpu_torch.parallel import spatial
from pcgan_tpu_torch.utils import tracing

ACTS = ("none", "relu", "leaky")
BF16 = torch.bfloat16


def _composite(x, act, residual=None):
    """Today's composite: the bf16 (or f32) instance norm, then the
    activation and the residual, as separate ops."""
    return layers.epilogue(layers._instance_norm(x, 1e-5), act, residual)


def _x(shape, seed=0, dtype=BF16, device="cpu"):
    """Planes of random scale and offset, so rstd and the mean vary."""
    g = np.random.default_rng(seed)
    n, c = shape[:2]
    x = (g.normal(size=shape) * g.uniform(0.2, 3.0, (n, c, 1, 1))
         + g.normal(size=(n, c, 1, 1)))
    return torch.tensor(x, dtype=torch.float32).to(device=device, dtype=dtype)


def _flat(n, c, side, value):
    """A plane of one bf16 value: bf16(value^2) < value^2, so the variance
    clamps to 0 (value 1 + 2^-7: its square 1.01569 rounds to 1.015625)."""
    return torch.full((n, c, side, side), value, dtype=BF16)


def _counted(fn):
    tracing.enable()
    try:
        out = fn()
    finally:
        tracing.disable()
    return out, tracing.drain()["counters"]


class _OneRankLine:
    """A spatial line of one rank: the band is the whole image."""
    n, coord = 1, 0

    def all_reduce_sum(self, flat, kind="all_reduce"):
        return flat


# --------------------------------------------------------------------------- #
# CPU: the plain version against the composite
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("side", [31, 64, 128])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_composite(act, residual, side):
    x = _x((2, 3, side, side), seed=side)
    if side == 31:
        # one plane whose variance clamps to 0
        x[1, 2] = _flat(1, 1, side, 1 + 2 ** -7)[0, 0]
    res = _x(x.shape, seed=1) if residual else None
    g = _x(x.shape, seed=2)

    xr = x.clone().requires_grad_()
    rr = res.clone().requires_grad_() if residual else None
    want = _composite(xr, act, rr)
    want.backward(g)

    got, stats = cin.plain_forward(x, act, res)
    assert torch.equal(got, want.detach())
    mean, rstd, keep = stats.view(3, 2, 3, 1, 1)
    if side == 31:
        assert keep[1, 2].item() == 0.0 and keep.sum().item() == 5
    else:
        assert bool((keep == 1).all())

    dx = cin.plain_backward(x, g, stats, act)
    xhat = (x.float() - mean) * rstd
    gp = cin._act_grad(g, xhat.to(BF16), act).float()
    s = rstd * (gp.abs() + gp.mean((2, 3), keepdim=True).abs()
                + (xhat.abs() + (mean * rstd).abs())
                * (gp * xhat).mean((2, 3), keepdim=True).abs())
    err = (dx.float() - xr.grad.float()).abs()
    assert bool((err <= 2.0 ** -7 * s).all()), float((err / s).max())
    if residual:
        assert torch.equal(rr.grad, g)

    # the Function takes CUDA tensors only
    with pytest.raises(ValueError, match="want cuda"):
        cin.fused(x, act, res)


@pytest.mark.parametrize("act", ACTS)
def test_create_graph_backward_matches_composite(act):
    """R1's double backward: ``plain_double_backward``, the backward of the
    Function's backward, is the composite's second derivative, of x and of
    the gradient g (f32 operands)."""
    x0 = _x((2, 3, 8, 8), seed=3, dtype=torch.float32)
    g0 = _x(x0.shape, seed=4, dtype=torch.float32)
    w = _x(x0.shape, seed=5, dtype=torch.float32)
    x, g = x0.clone().requires_grad_(), g0.clone().requires_grad_()
    gx, = torch.autograd.grad(_composite(x, act), x, g, create_graph=True)
    want = torch.autograd.grad((gx * w).sum(), (x, g))
    got = cin.plain_double_backward(x0, g0, w, act)
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale


def test_norm_act_other_norms_keep_their_composition():
    x = _x((2, 4, 6, 6), seed=6, dtype=torch.float32)
    res = _x(x.shape, seed=7, dtype=torch.float32)
    for kind in ("batch", "group", "none"):
        norm = layers.Norm(kind, 4)
        assert torch.equal(layers.norm_act(norm, x, "relu"),
                           torch.relu(norm(x)))
        assert torch.equal(layers.norm_act(norm, x, "leaky", res),
                           res + torch.nn.functional.leaky_relu(norm(x), 0.2))


@pytest.mark.parametrize("case", ["cpu_bf16", "f32", "band"])
def test_route_takes_the_composite(case):
    """A CPU tensor, an f32 tensor and a band take the composite, counted
    as ``norm/plain``."""
    dtype = torch.float32 if case == "f32" else BF16
    x = _x((2, 3, 16, 16), seed=8, dtype=dtype)
    res = _x(x.shape, seed=9, dtype=dtype)
    before = cin.launches
    if case == "band":
        with spatial.banded(_OneRankLine(), 16):
            got, counters = _counted(
                lambda: layers.instance_norm(x, act="leaky", residual=res))
    else:
        got, counters = _counted(
            lambda: layers.instance_norm(x, act="leaky", residual=res))
    assert counters == {"norm/plain": 1}
    assert cin.launches == before
    assert torch.equal(got, _composite(x, "leaky", res))


def test_generator_sites_are_counted():
    """Every instance-norm site of the resnet G is one counted call."""
    from pcgan_tpu_torch.models.generator import ResnetGenerator
    G = ResnetGenerator(3, 3, 4, ngf=4, n_blocks=2, dtype=BF16)
    x = torch.zeros(1, 16, 16, 3)
    _, counters = _counted(lambda: G(x, torch.zeros(1, 4)))
    # stem, two down, two per block, two up
    assert counters == {"norm/plain": 1 + 2 + 2 * 2 + 2}


# --------------------------------------------------------------------------- #
# the card: the kernels against the plain version
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no "
                    "CPU mode")
    from pcgan_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _ulp(v):
    a = np.maximum(np.abs(np.asarray(v, np.float32)), 2.0 ** -7)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


# (rows, channels, side, act, residual): every instance-norm site of
# pcgan_utk128 (128 px) and pcgan_cacd256 (256 px), the G's on its 2B = 64
# rows, D's and the comparator's on 64; then the kernels' other routes: a
# plane larger than shared memory, a plane of odd length
SHAPES = [
    # pcgan_utk128: G stem/up, down/up, down/blocks; D; comparator
    (64, 64, 128, "relu", False), (64, 128, 64, "relu", False),
    (64, 256, 32, "relu", False), (64, 256, 32, "none", True),
    (64, 128, 32, "leaky", False), (64, 256, 16, "leaky", False),
    (64, 512, 15, "leaky", False), (64, 512, 8, "leaky", False),
    # pcgan_cacd256: G stem/up, down/up, down/blocks; D
    (64, 64, 256, "relu", False), (64, 128, 128, "relu", False),
    (64, 256, 64, "relu", False), (64, 256, 64, "none", True),
    (64, 128, 64, "leaky", False), (64, 256, 32, "leaky", False),
    (64, 512, 31, "leaky", False),
    # no shared-memory copy of x; a residual at an odd plane length
    (2, 3, 384, "relu", True), (3, 5, 31, "none", True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,side,act,residual", SHAPES)
def test_kernels_match_plain(cuda_device, n, c, side, act, residual):
    x = _x((n, c, side, side), seed=side, device=cuda_device)
    res = _x(x.shape, seed=1, device=cuda_device) if residual else None
    g = _x(x.shape, seed=2, device=cuda_device)
    before = cin.launches
    out, stats = cin.forward_cuda(x, act, res)
    dx = cin.backward_cuda(x, g, stats, act)
    assert cin.launches == before + 2
    want_stats = cin.moments(x)
    want = cin.plain_forward(x, act, res, stats=stats)[0]
    want_dx = cin.plain_backward(x, g, stats, act)
    torch.cuda.synchronize()

    assert torch.equal(stats[2], want_stats[2])
    mean, rstd, _ = want_stats
    kappa = 1 + (mean * rstd).square()
    assert bool(((stats[0] - mean).abs()
                 <= 1e-5 * (mean.abs() + 1 / rstd)).all())
    assert bool(((stats[1] - rstd).abs() <= 1e-5 * kappa * rstd).all())
    assert torch.equal(out, want)

    wd = want_dx.float().cpu().numpy()
    floor = 2.0 ** -7 * np.abs(wd).max(axis=(2, 3), keepdims=True)
    a = np.maximum(np.abs(wd), floor)
    err = np.abs(dx.float().cpu().numpy() - wd)
    assert bool((err <= 2.0 ** (np.floor(np.log2(a)) - 7)).all()), \
        float(err.max())


@pytest.mark.cuda
def test_kernels_misaligned_and_deterministic(cuda_device):
    """A tensor 2 bytes off a 16-byte boundary takes the 2-byte loads (its
    sums run in another order); every route gives the same bits twice."""
    x = _x((4, 8, 32, 32), seed=10, device=cuda_device)
    g = _x(x.shape, seed=11, device=cuda_device)
    xs = torch.empty(x.numel() + 1, dtype=BF16, device=cuda_device)
    xs[1:].copy_(x.view(-1))
    xm = xs[1:].view(x.shape)
    assert xm.data_ptr() % 16 != 0
    for v in (x, xm):
        (out, stats), (out2, stats2) = (cin.forward_cuda(v, "leaky")
                                        for _ in range(2))
        assert torch.equal(out, out2) and torch.equal(stats, stats2)
        assert torch.equal(out, cin.plain_forward(v, "leaky",
                                                  stats=stats)[0])
        dxs = [cin.backward_cuda(v, g, stats, "leaky") for _ in range(2)]
        assert torch.equal(dxs[0], dxs[1])


@pytest.mark.cuda
def test_main_path_launches(cuda_device):
    """A bf16 G and D forward and backward on the card take the kernels at
    every instance-norm site (two launches each), counted as
    ``norm/fused``; a band takes the composite."""
    from pcgan_tpu_torch.models.discriminator import NLayerDiscriminator
    from pcgan_tpu_torch.models.generator import ResnetGenerator
    G = ResnetGenerator(3, 3, 4, ngf=8, n_blocks=3, dtype=BF16).to(
        cuda_device)
    D = NLayerDiscriminator(3, 4, ndf=8, dtype=BF16).to(cuda_device)
    x = torch.rand(2, 64, 64, 3, device=cuda_device) * 2 - 1
    cond = torch.zeros(2, 4, device=cuda_device)
    before = cin.launches

    def step():
        D(G(x, cond), cond).float().mean().backward()
    _, counters = _counted(step)
    sites = (1 + 2 + 2 * 3 + 2) + 3
    assert counters == {"norm/fused": sites}
    assert cin.launches == before + 2 * sites

    before = cin.launches
    with spatial.banded(_OneRankLine(), 16):
        _, counters = _counted(lambda: layers.instance_norm(
            _x((2, 3, 16, 16), device=cuda_device), act="relu"))
    assert counters == {"norm/plain": 1} and cin.launches == before


@pytest.mark.cuda
def test_create_graph_on_card(cuda_device):
    """R1's double backward through the fused D: under create_graph the
    first-order dx is the backward kernel's (one forward and one backward
    launch, the kernel's bits), and the second derivative matches the
    composite's in f32 operands' terms (bf16 here: 2% of the largest entry,
    the two paths round at different places)."""
    x0 = _x((2, 4, 16, 16), seed=12, device=cuda_device)
    g = _x(x0.shape, seed=13, device=cuda_device)
    out, stats = cin.forward_cuda(x0, "leaky")
    want_gx = cin.backward_cuda(x0, g, stats, "leaky")
    grads = []
    for fused, fn in ((True, lambda x: cin.fused(x, "leaky")),
                      (False, lambda x: _composite(x, "leaky"))):
        x = x0.clone().requires_grad_()
        before = cin.launches
        gx, = torch.autograd.grad(fn(x), x, g, create_graph=True)
        if fused:
            assert cin.launches == before + 2
            assert torch.equal(gx, want_gx) and gx.requires_grad
        grads.append(torch.autograd.grad(gx.float().square().sum(), x)[0])
        if fused:
            # the second derivative is plain PyTorch: no launch
            assert cin.launches == before + 2
    scale = float(grads[1].float().abs().max())
    assert float((grads[0].float() - grads[1].float()).abs().max()) \
        <= 0.02 * scale
