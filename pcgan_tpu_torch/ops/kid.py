"""Kernel Inception Distance (counterpart of ``pcgan_tpu/ops/kid.py``).

KID is the squared MMD between real and generated features under the
polynomial kernel k(x, y) = (x.y / d + 1)^3, estimated without bias
(Binkowski et al. 2018), averaged over ``subsets`` random subsets of
``subset_size`` features per side drawn without replacement; the result is
the mean and the standard deviation across subsets. The kernel matrices are
products on the features' device. The JAX package draws its subsets with
``jax.random.choice``, which torch cannot reproduce: here they come from a
seeded CPU ``torch.Generator``, so the two agree exactly only where the
draw does not matter (one subset of every feature).
"""

from __future__ import annotations

from typing import Tuple

import torch


def polynomial_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """k(x, y) = (x.y / d + 1)^3 for row-feature matrices (m, d), (n, d)."""
    d = x.shape[-1]
    return (x @ y.T / d + 1.0) ** 3


def mmd2_unbiased(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unbiased squared MMD between equal-size feature blocks (m, d): the
    within-set sums leave out the diagonal (self pairs)."""
    m = x.shape[0]
    kxx = polynomial_kernel(x, x)
    kyy = polynomial_kernel(y, y)
    kxy = polynomial_kernel(x, y)

    def off(k):
        return (torch.sum(k) - torch.trace(k)) / (m * (m - 1))
    return off(kxx) + off(kyy) - 2.0 * torch.mean(kxy)


def kid_from_features(real: torch.Tensor, fake: torch.Tensor,
                      subsets: int = 100, subset_size: int = 1000,
                      seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(KID mean, KID std) over ``subsets`` subsets of
    min(subset_size, n_real, n_fake) rows per side, each drawn without
    replacement by ``torch.Generator().manual_seed(seed)`` on the CPU.
    The std is the population std (``jnp.std``). Needs n >= 2 a side."""
    m = min(subset_size, real.shape[0], fake.shape[0])
    if m < 2:
        raise ValueError(f"KID needs >= 2 features per side, got "
                         f"{real.shape[0]} real / {fake.shape[0]} fake")
    real, fake = real.float(), fake.float()
    gen = torch.Generator().manual_seed(seed)
    vals = []
    for _ in range(subsets):
        xi = torch.randperm(real.shape[0], generator=gen)[:m]
        yi = torch.randperm(fake.shape[0], generator=gen)[:m]
        vals.append(mmd2_unbiased(real[xi.to(real.device)],
                                  fake[yi.to(fake.device)]))
    vals = torch.stack(vals)
    return vals.mean(), vals.std(unbiased=False)
