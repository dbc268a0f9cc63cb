"""Network summaries (counterpart of ``pcgan_tpu/utils/summary.py``): the
reference's ``print_networks(verbose)`` surface.

Every net prints ``[Network G] Total number of parameters : X.XXX M``;
``--verbose`` adds the parameter table (name, shape, dtype, count), one
row per parameter in module order.
"""

from __future__ import annotations

from torch import nn


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def format_network(name: str, module: nn.Module,
                   verbose: bool = False) -> str:
    """One network's summary block; ``verbose`` adds the parameter
    table."""
    lines = []
    if verbose:
        lines.append(f"[Network {name}] parameters:")
        rows = [(n, tuple(p.shape), str(p.dtype).replace("torch.", ""),
                 p.numel()) for n, p in module.named_parameters()]
        w = max((len(r[0]) for r in rows), default=0)
        for n, shape, dt, k in rows:
            lines.append(f"  {n:<{w}}  {str(shape):<20} {dt:<9} {k:>10,}")
    lines.append(f"[Network {name}] Total number of parameters : "
                 f"{count_params(module) / 1e6:.3f} M")
    return "\n".join(lines)


def print_networks(nets: dict, verbose: bool = False) -> None:
    """``nets``: {name: module or None}, in the reference's banner."""
    print("---------- Networks initialized -------------", flush=True)
    for name, module in nets.items():
        if module is None:
            continue
        print(format_network(name, module, verbose), flush=True)
    print("-----------------------------------------------", flush=True)
