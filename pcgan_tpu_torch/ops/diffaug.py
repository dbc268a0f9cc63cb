"""Differentiable augmentation, DiffAugment and ADA (counterpart of ``pcgan_tpu/ops/diffaug.py:40-143``).

``--diff_augment`` (comma-separated, e.g. ``color,translation,cutout``)
applies a random differentiable transform to every image D sees:

  color        per-sample brightness (+U(-.5,.5)), saturation (channel-mean
               anchor, xU(0,2)) and contrast (pixel-mean anchor,
               xU(.5,1.5)), in that order
  translation  per-sample integer shift of up to 1/8 of the image size,
               zero-padded
  cutout       per-sample half-size square zeroed at a random position
               (it may hang over the border)

``--ada_target`` gates each op per sample with probability p (ADA): every
op is computed for the whole batch and blended in where ``u < p``.

Each transform is split into a draw (from a ``torch.Generator``, on the
CPU) and an apply of the drawn parameters on x's device, so the same draw
can be applied to two batches (the step's feature-matching views) and a
test can apply the JAX package's draws. Images are NHWC.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

POLICIES = ("color", "translation", "cutout")

Draw = Dict[str, torch.Tensor]


def parse_policy(policy: str) -> Sequence[str]:
    names = [p.strip() for p in policy.split(",") if p.strip()]
    bad = [p for p in names if p not in POLICIES]
    if bad:
        raise ValueError(f"--diff_augment: unknown policy {bad}; "
                         f"choose from {POLICIES}")
    return names


# --------------------------------------------------------------------------- #
# draws
# --------------------------------------------------------------------------- #


def _randint(g: torch.Generator, lo: int, hi: int, n: int) -> torch.Tensor:
    return torch.randint(lo, hi, (n,), generator=g)


def draw_op(name: str, g: torch.Generator, shape) -> Draw:
    """The parameters of op ``name`` for a batch of NHWC ``shape``."""
    b, h, w, _ = shape
    if name == "color":
        return {"bright": torch.rand(b, generator=g) - 0.5,
                "sat": torch.rand(b, generator=g) * 2.0,
                "cont": torch.rand(b, generator=g) + 0.5}
    if name == "translation":
        sy, sx = max(1, int(h * 0.125)), max(1, int(w * 0.125))
        return {"dy": _randint(g, -sy, sy + 1, b),
                "dx": _randint(g, -sx, sx + 1, b)}
    if name == "cutout":
        ch, cw = max(1, int(h * 0.5)), max(1, int(w * 0.5))
        return {"oy": _randint(g, -(ch // 2), h - ch // 2, b),
                "ox": _randint(g, -(cw // 2), w - cw // 2, b)}
    raise ValueError(f"--diff_augment: unknown policy {name}")


# --------------------------------------------------------------------------- #
# applies
# --------------------------------------------------------------------------- #


def apply_color(x: torch.Tensor, d: Draw) -> torch.Tensor:
    def col(v):
        return v.to(x.device, x.dtype).view(-1, 1, 1, 1)
    x = x + col(d["bright"])
    c_mean = x.mean(dim=-1, keepdim=True)
    x = (x - c_mean) * col(d["sat"]) + c_mean
    p_mean = x.float().mean(dim=(1, 2, 3), keepdim=True).to(x.dtype)
    return (x - p_mean) * col(d["cont"]) + p_mean


def apply_translation(x: torch.Tensor, d: Draw) -> torch.Tensor:
    """out[y, x] = in[y - dy, x - dx], zero outside."""
    b, h, w, _ = x.shape
    dev = x.device
    iy = torch.arange(h, device=dev)[None] - d["dy"].to(dev)[:, None]
    ix = torch.arange(w, device=dev)[None] - d["dx"].to(dev)[:, None]
    vy, vx = (iy >= 0) & (iy < h), (ix >= 0) & (ix < w)
    out = x[torch.arange(b, device=dev)[:, None, None],
            iy.clamp(0, h - 1)[:, :, None], ix.clamp(0, w - 1)[:, None, :]]
    keep = (vy[:, :, None] & vx[:, None, :])[..., None]
    return out * keep.to(x.dtype)


def apply_cutout(x: torch.Tensor, d: Draw) -> torch.Tensor:
    b, h, w, _ = x.shape
    dev = x.device
    ch, cw = max(1, int(h * 0.5)), max(1, int(w * 0.5))
    oy = d["oy"].to(dev).view(-1, 1, 1)
    ox = d["ox"].to(dev).view(-1, 1, 1)
    iy = torch.arange(h, device=dev)[None, :, None]
    ix = torch.arange(w, device=dev)[None, None, :]
    cut = (iy >= oy) & (iy < oy + ch) & (ix >= ox) & (ix < ox + cw)
    return x * (1.0 - cut[..., None].to(x.dtype))


_APPLY = {"color": apply_color, "translation": apply_translation,
          "cutout": apply_cutout}


class Augment:
    """The ``--diff_augment`` policy chain; with ``ada`` each op is gated
    per sample at probability p (``make_ada_augment``: a sample whose gate
    ``u >= p`` passes through that op untouched)."""

    def __init__(self, policy: str, ada: bool = False):
        self.names = list(parse_policy(policy))
        self.ada = ada
        if ada and not self.names:
            raise ValueError("ADA needs a non-empty --diff_augment policy")

    def __bool__(self) -> bool:
        return bool(self.names)

    def draw(self, generator: torch.Generator, x: torch.Tensor
             ) -> List[Draw]:
        """One draw per op (plus its gates ``u`` under ADA) for batch x."""
        out = []
        for n in self.names:
            d = draw_op(n, generator, x.shape)
            if self.ada:
                d["u"] = torch.rand(x.shape[0], generator=generator)
            out.append(d)
        return out

    def apply(self, x: torch.Tensor, draws: List[Draw],
              p: Optional[Union[float, torch.Tensor]] = None
              ) -> torch.Tensor:
        """The chain on x with ``draws``; ``p`` is ADA's probability."""
        for n, d in zip(self.names, draws):
            y = _APPLY[n](x, d)
            if self.ada:
                fire = d["u"].to(x.device).view(-1, 1, 1, 1) < p
                y = torch.where(fire, y, x)
            x = y
        return x
