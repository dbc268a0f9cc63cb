"""Adversarial criteria and D regularizers (counterpart of ``pcgan_tpu/ops/gan_loss.py:16-143``).

``--gan_mode`` ``vanilla`` (sigmoid BCE on logits), ``lsgan`` (MSE against
0/1 targets), ``wgangp`` (Wasserstein critic; the step adds
``gradient_penalty``) and ``hinge``. Discriminators emit raw patch logits,
or a tuple of them (``--netD multiscale``), whose per-scale criteria are
averaged; every loss reduces in f32. ``gradient_penalty`` and
``r1_penalty`` are double backward: ``torch.autograd.grad`` of the summed
logits with ``create_graph=True``, so D's parameter gradient flows through
the input gradient.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

PORTED_MODES = ("vanilla", "lsgan", "wgangp", "hinge")


def split_pred(pred, bsz: int):
    """Split a 2B-batched D output into its (first B, second B) halves,
    per scale for a multiscale tuple."""
    if isinstance(pred, (tuple, list)):
        return (tuple(p[:bsz] for p in pred), tuple(p[bsz:] for p in pred))
    return pred[:bsz], pred[bsz:]


def _sum_logits(out) -> torch.Tensor:
    """Total sum of D logits across all scales (torch grad_outputs=ones
    semantics for the penalties' double backward)."""
    if isinstance(out, (tuple, list)):
        return sum(o.float().sum() for o in out)
    return out.float().sum()


def gan_loss(logits, target_is_real: bool, mode: str = "lsgan",
             for_discriminator: bool = True) -> torch.Tensor:
    """Loss for one batch of D outputs (reference GANLoss semantics); a
    multiscale tuple averages the per-scale criteria."""
    if isinstance(logits, (tuple, list)):
        per = [gan_loss(lg, target_is_real, mode, for_discriminator)
               for lg in logits]
        return sum(per) / len(per)
    x = logits.float()
    if mode == "lsgan":
        return torch.mean((x - (1.0 if target_is_real else 0.0)) ** 2)
    if mode == "vanilla":
        # stable BCE-with-logits against a constant target, as in JAX
        t = 1.0 if target_is_real else 0.0
        return torch.mean(torch.clamp(x, min=0) - x * t
                          + torch.log1p(torch.exp(-x.abs())))
    if mode == "wgangp":
        return -torch.mean(x) if target_is_real else torch.mean(x)
    if mode == "hinge":
        if for_discriminator:
            return (torch.mean(F.relu(1.0 - x)) if target_is_real
                    else torch.mean(F.relu(1.0 + x)))
        return -torch.mean(x)
    raise NotImplementedError(f"gan_mode [{mode}] not implemented")


def overfit_heuristic(pred_real, mode: str = "lsgan") -> torch.Tensor:
    """ADA's r_t = E[sign(D(real) - mid)] (mid 0.5 for lsgan, else 0); a
    multiscale tuple averages the per-scale means."""
    if isinstance(pred_real, (tuple, list)):
        per = [overfit_heuristic(p, mode) for p in pred_real]
        return sum(per) / len(per)
    mid = 0.5 if mode == "lsgan" else 0.0
    return torch.mean(torch.sign(pred_real.float() - mid))


def feature_matching_loss(fake_feats, real_feats) -> torch.Tensor:
    """pix2pixHD feature matching: per scale ``4/n_feat * sum_l
    mean|f_fake - f_real|``, averaged over scales (callers detach the real
    side)."""
    if fake_feats and isinstance(fake_feats[0], (tuple, list)):
        per = [feature_matching_loss(f, r)
               for f, r in zip(fake_feats, real_feats)]
        return sum(per) / len(per)
    w = 4.0 / max(len(fake_feats), 1)
    total = torch.zeros((), device=fake_feats[0].device)
    for f, r in zip(fake_feats, real_feats):
        total = total + w * torch.mean(torch.abs(f.float() - r.float()))
    return total


def _input_grad(d_apply: Callable, x: torch.Tensor, cond) -> torch.Tensor:
    x = x.float().detach().requires_grad_(True)
    (g,) = torch.autograd.grad(_sum_logits(d_apply(x, cond)), x,
                               create_graph=True)
    return g.float()


def gradient_penalty(d_apply: Callable, real: torch.Tensor,
                     fake: torch.Tensor, cond, eps: torch.Tensor
                     ) -> torch.Tensor:
    """WGAN-GP on the interpolates ``eps*real + (1-eps)*fake`` (reference
    ``cal_gradient_penalty``, 'mixed'): ``mean((||grad||_2 - 1)^2)`` with
    the norm over each sample's pixels. ``d_apply(x, cond) -> logits``;
    ``eps``: (B,1,1,1) uniform draws in f32."""
    inter = eps * real.float() + (1.0 - eps) * fake.float()
    g = _input_grad(d_apply, inter, cond)
    gnorm = torch.sqrt(torch.sum(g ** 2, dim=(1, 2, 3)) + 1e-16)
    return torch.mean((gnorm - 1.0) ** 2)


def r1_penalty(d_apply: Callable, real: torch.Tensor, cond) -> torch.Tensor:
    """R1 (Mescheder et al. 2018): ``E[||grad_x D(x)||^2]`` on real images;
    the caller scales by ``lambda_r1 / 2``."""
    g = _input_grad(d_apply, real, cond)
    return torch.mean(torch.sum(g ** 2, dim=(1, 2, 3)))
