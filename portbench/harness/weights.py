"""Seeded weights and comparator anchors, made by the benchmark and handed
alike to the program and to the plain reference.

Every parameter of G, D and the comparator is one slice of a single
normal draw (std 0.02, pix2pix's init scale) made on the card from the
seed; the slices follow the reference's parameter list, whose names and
shapes are the models' checkpoint names, and the program's modules must
hold exactly those parameters.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import models

STD = 0.02


def sub_seed(seed: int, stream: int) -> int:
    """An independent seed for one use of the run's seed."""
    state = np.random.SeedSequence([int(seed) % 2 ** 63, 7919, stream])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def specs(m: Dict) -> Dict[str, models.Spec]:
    out = {"G": models.g_spec(m["ngf"], m["n_blocks"], m["n_bins"]),
           "D": models.d_spec(m["ndf"], m["n_bins"], m["n_layers_D"])}
    if m.get("comparator"):
        out["C"] = models.c_spec(m["cmp_nf"], m["cmp_n_down"])
    return out


def draw(m: Dict, seed: int, device, nets=("G", "D", "C")
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'G': {name: tensor}, 'D': ..., 'C': ...} (float32 on ``device``);
    ``nets`` picks the nets to return, the draw covering all of them."""
    sp = specs(m)
    flat: List[Tuple[str, str, Tuple[int, ...]]] = [
        (net, name, shape) for net in ("G", "D", "C") if net in sp
        for name, shape in sp[net]]
    total = sum(math.prod(s) for _, _, s in flat)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    values = torch.randn(total, generator=g, device=device) * STD
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    lo = 0
    for net, name, shape in flat:
        n = math.prod(shape)
        if net in nets:
            out.setdefault(net, {})[name] = values[lo:lo + n].view(shape)
        lo += n
    return out


def load(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Copy ``tensors`` into ``module``'s parameters; raise unless the
    names and shapes are the same sets."""
    params = dict(module.named_parameters())
    have = {k: tuple(v.shape) for k, v in params.items()}
    want = {k: tuple(v.shape) for k, v in tensors.items()}
    if have != want:
        raise RuntimeError(
            f"portbench: {type(module).__name__}'s parameters differ from "
            f"the reference's: only in the program "
            f"{sorted(set(have.items()) - set(want.items()))}, only in the "
            f"reference {sorted(set(want.items()) - set(have.items()))}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(tensors[k])


def anchors(seed: int, n_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each bin's comparator score interval [lo, hi]: centres spread over
    [-1, 1] in bin order with a little jitter, half-widths 0.05-0.15."""
    g = torch.Generator().manual_seed(sub_seed(seed, 3))
    centre = torch.linspace(-1.0, 1.0, n_bins) + 0.05 * torch.randn(
        n_bins, generator=g)
    half = 0.05 + 0.1 * torch.rand(n_bins, generator=g)
    return centre - half, centre + half
