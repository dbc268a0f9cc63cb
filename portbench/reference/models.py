"""Plain reference of PC-GAN's networks, written from the published
architectures (pix2pix/CycleGAN's resnet generator and 70x70 PatchGAN,
PC-GAN's pairwise comparator) as functions of a parameter dict.

The parameter names and shapes are those of the models' checkpoints, so
one set of seeded weights feeds the program and this reference alike.
Images are NHWC in [-1, 1]; the age condition is a one-hot map
concatenated to the image channels. Every layer computes in float32;
``q``, where given, rounds each convolution's or linear layer's input and
weight first (the lower-precision control, ``lowp.py``).

Generator (``resnet_<n>blocks``): reflect-pad 3, conv 7x7 -> instance norm
-> ReLU; two stride-2 3x3 convs -> IN -> ReLU; n residual blocks of two
reflect-padded 3x3 convs with IN (ReLU between); two stride-2 transposed
3x3 convs (output padding 1) -> IN -> ReLU; reflect-pad 3, conv 7x7 with
bias -> tanh. Convs that feed an instance norm carry no bias (IN removes
it exactly).

Discriminator (``basic``, three layers): conv 4x4 s2 with bias ->
LeakyReLU(0.2); two conv 4x4 s2 -> IN -> LReLU; conv 4x4 s1 -> IN ->
LReLU; conv 4x4 s1 with bias to one channel (patch logits).

Comparator: ``n_down`` conv 4x4 s2 (the first with bias, the others
followed by IN), LReLU(0.2) after each; the spatial mean; linear -> LReLU;
linear to (mu, log var), log var clipped to [-10, 10].

Instance norm: per sample and channel, biased variance, eps 1e-5, no
affine parameters.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Spec = List[Tuple[str, Tuple[int, ...]]]


def g_spec(ngf: int, n_blocks: int, cond_nc: int, in_nc: int = 3,
           out_nc: int = 3) -> Spec:
    s = [("stem.weight", (ngf, in_nc + cond_nc, 7, 7)),
         ("down.0.weight", (2 * ngf, ngf, 3, 3)),
         ("down.1.weight", (4 * ngf, 2 * ngf, 3, 3))]
    for i in range(n_blocks):
        s += [(f"blocks.{i}.conv0.weight", (4 * ngf, 4 * ngf, 3, 3)),
              (f"blocks.{i}.conv1.weight", (4 * ngf, 4 * ngf, 3, 3))]
    # transposed convs keep (in, out, k, k)
    s += [("up.0.weight", (4 * ngf, 2 * ngf, 3, 3)),
          ("up.1.weight", (2 * ngf, ngf, 3, 3)),
          ("tail.weight", (out_nc, ngf, 7, 7)), ("tail.bias", (out_nc,))]
    return s


def d_spec(ndf: int, cond_nc: int, n_layers: int = 3, in_nc: int = 3
           ) -> Spec:
    s = [("convs.0.weight", (ndf, in_nc + cond_nc, 4, 4)),
         ("convs.0.bias", (ndf,))]
    nf = ndf
    for n in range(1, n_layers + 1):
        nxt = ndf * min(2 ** n, 8)
        s.append((f"convs.{n}.weight", (nxt, nf, 4, 4)))
        nf = nxt
    s += [(f"convs.{n_layers + 1}.weight", (1, nf, 4, 4)),
          (f"convs.{n_layers + 1}.bias", (1,))]
    return s


def c_spec(nf: int, n_down: int, in_nc: int = 3) -> Spec:
    s, ch = [], in_nc
    for i in range(n_down):
        feats = nf * min(2 ** i, 8)
        s.append((f"convs.{i}.weight", (feats, ch, 4, 4)))
        if i == 0:
            s.append(("convs.0.bias", (feats,)))
        ch = feats
    return s + [("fc.weight", (4 * nf, ch)), ("fc.bias", (4 * nf,)),
                ("head.weight", (2, 4 * nf)), ("head.bias", (2,))]


Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _conv(x, w, b=None, stride=1, padding=0, q: Quant = None):
    if q is not None:
        x, w = q(x), q(w)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def _deconv(x, w, q: Quant = None):
    if q is not None:
        x, w = q(x), q(w)
    return F.conv_transpose2d(x, w, stride=2, padding=1, output_padding=1)


def _linear(x, w, b, q: Quant = None):
    if q is not None:
        x, w = q(x), q(w)
    return F.linear(x, w, b)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def cond_map(cond: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return cond[:, :, None, None].expand(-1, -1, h, w)


def generator(p: Params, x: torch.Tensor, cond: torch.Tensor,
              n_blocks: int, q: Quant = None) -> torch.Tensor:
    """x (N, H, W, 3), cond (N, K) -> (N, H, W, 3)."""
    h = x.permute(0, 3, 1, 2)
    h = torch.cat([h, cond_map(cond, h.shape[2], h.shape[3])], 1)
    h = F.relu(instance_norm(_conv(F.pad(h, (3,) * 4, mode="reflect"),
                                   p["stem.weight"], q=q)))
    for i in range(2):
        h = F.relu(instance_norm(_conv(h, p[f"down.{i}.weight"], stride=2,
                                       padding=1, q=q)))
    for i in range(n_blocks):
        r = F.pad(h, (1,) * 4, mode="reflect")
        r = F.relu(instance_norm(_conv(r, p[f"blocks.{i}.conv0.weight"],
                                       q=q)))
        r = F.pad(r, (1,) * 4, mode="reflect")
        h = h + instance_norm(_conv(r, p[f"blocks.{i}.conv1.weight"], q=q))
    for i in range(2):
        h = F.relu(instance_norm(_deconv(h, p[f"up.{i}.weight"], q=q)))
    h = _conv(F.pad(h, (3,) * 4, mode="reflect"), p["tail.weight"],
              p["tail.bias"], q=q)
    return torch.tanh(h).permute(0, 2, 3, 1)


def discriminator(p: Params, x: torch.Tensor, cond: torch.Tensor,
                  n_layers: int = 3, q: Quant = None) -> torch.Tensor:
    """x (N, H, W, 3), cond (N, K) -> patch logits (N, h, w, 1)."""
    h = x.permute(0, 3, 1, 2)
    h = torch.cat([h, cond_map(cond, h.shape[2], h.shape[3])], 1)
    h = F.leaky_relu(_conv(h, p["convs.0.weight"], p["convs.0.bias"], 2, 1,
                           q=q), 0.2)
    for n in range(1, n_layers + 1):
        stride = 2 if n < n_layers else 1
        h = F.leaky_relu(instance_norm(_conv(h, p[f"convs.{n}.weight"],
                                             stride=stride, padding=1,
                                             q=q)), 0.2)
    k = n_layers + 1
    h = _conv(h, p[f"convs.{k}.weight"], p[f"convs.{k}.bias"], 1, 1, q=q)
    return h.permute(0, 2, 3, 1)


def comparator(p: Params, x: torch.Tensor, n_down: int, q: Quant = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, H, W, 3) -> (mu (N,), log_var (N,))."""
    h = x.permute(0, 3, 1, 2)
    for i in range(n_down):
        h = _conv(h, p[f"convs.{i}.weight"], p.get(f"convs.{i}.bias"), 2, 1,
                  q=q)
        if i > 0:
            h = instance_norm(h)
        h = F.leaky_relu(h, 0.2)
    h = F.leaky_relu(_linear(h.mean(dim=(2, 3)), p["fc.weight"],
                             p["fc.bias"], q), 0.2)
    out = _linear(h, p["head.weight"], p["head.bias"], q)
    return out[:, 0], out[:, 1].clamp(-10.0, 10.0)


def cond_loss(mu, log_var, lo, hi) -> torch.Tensor:
    """Per-sample Gaussian NLL, under the comparator's own variance, of the
    nearest score inside the target interval [lo, hi]."""
    target = torch.minimum(torch.maximum(mu, lo), hi)
    return 0.5 * torch.exp(-log_var) * (mu - target) ** 2 + 0.5 * log_var
