"""Uncertainty-aware Siamese comparator + Thurstone pairwise likelihood
(counterpart of ``pcgan_tpu/models/comparator.py``).

A shared CNN maps each face to a score distribution ``N(mu, sigma^2)``; a
pair (i, j) is compared through the Thurstone Case-V model with ties via a
decision margin m:

    s      = sqrt(sigma_i^2 + sigma_j^2 + eps)
    P(i>j) = Phi((mu_i - mu_j - m) / s)
    P(j>i) = Phi((mu_j - mu_i - m) / s)
    P(tie) = 1 - P(i>j) - P(j>i)

trained with cross-entropy on 3-way labels (0: i older, 1: j older, 2: tie).
After pretraining the comparator is frozen; the GAN's condition-consistency
loss asks whether C(G(x, target)) scores inside the target bin's interval.

Trunk: ``n_down`` stride-2 4x4 convs with zero padding 1 (channels
``nf * min(2^i, 8)``), the port's ``Norm`` after every conv but the first,
LeakyReLU 0.2; then a global mean pool and two Linear layers, all three in
f32. Convs cast per layer to the compute dtype; parameters stay f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pcgan_tpu_torch.models.layers import Norm, TorchConv, conv_bias_before_norm
from pcgan_tpu_torch.parallel import spatial

_SQRT2 = 1.4142135623730951


def ndtr(z: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF Phi(z), in f32."""
    return 0.5 * (1.0 + torch.erf(z.float() / _SQRT2))


class Comparator(nn.Module):
    def __init__(self, input_nc: int = 3, nf: int = 64, n_down: int = 4,
                 norm: str = "instance", dtype=torch.float32):
        super().__init__()
        use_bias = conv_bias_before_norm(norm)     # normed convs: no bias
        convs, ch = [], input_nc
        for i in range(n_down):
            feats = nf * min(2 ** i, 8)
            convs.append(TorchConv(ch, feats, 4, 2, 1,
                                   use_bias=use_bias or i == 0, dtype=dtype))
            ch = feats
        self.convs = nn.ModuleList(convs)
        # one norm after every conv but the first
        self.norms = nn.ModuleList(Norm(norm, nf * min(2 ** i, 8))
                                   for i in range(1, n_down))
        self.fc = nn.Linear(ch, nf * 4)
        self.head = nn.Linear(nf * 4, 2)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """x: (N,H,W,C) in [-1,1] -> (mu (N,), log_var (N,)), both f32;
        ``return_features=True`` returns the (N, 4*nf) embedding instead."""
        # contiguous NCHW: a permuted (channels-last) input makes cuDNN
        # return channels-last weight gradients, which the fused Adam of
        # pretraining refuses beside its contiguous parameters
        h = x.permute(0, 3, 1, 2).contiguous()
        # inside spatial.banded x is this rank's band: the convs take their
        # halos, and the pool is the band's sum over the line's count
        H = spatial.global_h(h.shape[2])
        for i, conv in enumerate(self.convs):
            h = conv(h, H=H)
            H = conv.out_size(H)
            if i > 0:
                h = self.norms[i - 1](h)
            h = F.leaky_relu(h, 0.2)
        h = F.leaky_relu(self.fc(spatial.mean_hw(h.float())), 0.2)
        if return_features:
            return h
        out = self.head(h)
        # clamp log_var for numerical stability of the pairwise z-score
        return out[:, 0], torch.clamp(out[:, 1], -10.0, 10.0)


def pairwise_log_probs(mu_i, log_var_i, mu_j, log_var_j,
                       margin: float = 0.5, eps: float = 1e-6) -> torch.Tensor:
    """Log-probabilities of the 3 outcomes [i>j, j>i, tie], shape (N, 3)."""
    s = torch.sqrt(torch.exp(log_var_i) + torch.exp(log_var_j) + eps)
    z = (mu_i - mu_j) / s
    m = margin / s
    p_i = ndtr(z - m)
    p_j = ndtr(-z - m)
    p_tie = torch.clamp(1.0 - p_i - p_j, eps, 1.0)
    probs = torch.stack([p_i, p_j, p_tie], dim=-1)
    return torch.log(torch.clamp(probs, eps, 1.0))


def comparison_loss(mu_i, log_var_i, mu_j, log_var_j, label,
                    margin: float = 0.5) -> torch.Tensor:
    """Cross-entropy on 3-way labels (0: i older, 1: j older, 2: tie)."""
    logp = pairwise_log_probs(mu_i, log_var_i, mu_j, log_var_j, margin)
    # the label's column by a mask, not ``gather``: gather's backward adds
    # by atomics on the card
    pick = label.long()[:, None] == torch.arange(3, device=logp.device)
    return -torch.mean(torch.where(pick, logp, 0.0).sum(-1))


def comparison_accuracy(mu_i, log_var_i, mu_j, log_var_j, label,
                        margin: float = 0.5) -> torch.Tensor:
    """Share of pairs whose most likely outcome is the label (a tie in the
    log-probabilities takes the first outcome, as ``jnp.argmax`` does)."""
    logp = pairwise_log_probs(mu_i, log_var_i, mu_j, log_var_j, margin)
    return torch.mean((torch.argmax(logp, dim=-1) == label.long()).float())


def condition_consistency_loss(mu_fake: torch.Tensor,
                               log_var_fake: torch.Tensor,
                               mu_lo: torch.Tensor,
                               mu_hi: torch.Tensor) -> torch.Tensor:
    """Frozen-comparator condition loss for the GAN: the Gaussian NLL, under
    the comparator's own predicted variance, of the nearest score inside the
    target interval [mu_lo, mu_hi] (one point in score mode)."""
    target = torch.clamp(mu_fake, mu_lo, mu_hi)
    inv_var = torch.exp(-log_var_fake)
    return torch.mean(0.5 * inv_var * (mu_fake - target) ** 2
                      + 0.5 * log_var_fake)
