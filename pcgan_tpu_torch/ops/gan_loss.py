"""Adversarial criteria and D regularizers (counterpart of ``pcgan_tpu/ops/gan_loss.py:16-143``).

``--gan_mode`` ``vanilla`` (sigmoid BCE on logits), ``lsgan`` (MSE against
0/1 targets), ``wgangp`` (Wasserstein critic; the step adds
``gradient_penalty``) and ``hinge``. Discriminators emit raw patch logits,
or a tuple of them (``--netD multiscale``), whose per-scale criteria are
averaged; every loss reduces in f32. ``gradient_penalty`` and
``r1_penalty`` are double backward: ``torch.autograd.grad`` of the summed
logits with ``create_graph=True``, so D's parameter gradient flows through
the input gradient. Inside ``parallel.spatial.banded`` the logits are this
rank's band of ``H`` rows (each multiscale scale a band of its own
height) and every loss is this rank's share of it: ``gan_loss`` and
feature matching are band means (``band_mean``, each feature over its own
global height), the penalties sum each sample's squared input gradient
over its band and then over the line (``line_sum``) before the norm, and
take their share of the batch mean (``share``). ``_sum_logits`` of a band
is that band's own sum, so the halo exchange's backward gives each rank
its band of the input gradient of the global sum. ADA's r_t is the line's
whole value on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from pcgan_tpu_torch.parallel.spatial import (band_mean, line_sum,
                                              line_total, share)

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
             for_discriminator: bool = True, H=None) -> torch.Tensor:
    """Loss for one batch of D outputs (reference GANLoss semantics); a
    multiscale tuple averages the per-scale criteria. ``H``: the logits'
    global height where they are a band of it (of a tuple: each scale's,
    a tuple too)."""
    if isinstance(logits, (tuple, list)):
        hs = [None] * len(logits) if H is None else H
        per = [gan_loss(lg, target_is_real, mode, for_discriminator, h)
               for lg, h in zip(logits, hs)]
        return sum(per) / len(per)
    x = logits.float()

    def mean(v):
        return band_mean(v, H)
    if mode == "lsgan":
        return mean((x - (1.0 if target_is_real else 0.0)) ** 2)
    if mode == "vanilla":
        # stable BCE-with-logits against a constant target, as in JAX
        t = 1.0 if target_is_real else 0.0
        return mean(torch.clamp(x, min=0) - x * t
                    + torch.log1p(torch.exp(-x.abs())))
    if mode == "wgangp":
        return -mean(x) if target_is_real else mean(x)
    if mode == "hinge":
        if for_discriminator:
            return (mean(F.relu(1.0 - x)) if target_is_real
                    else mean(F.relu(1.0 + x)))
        return -mean(x)
    raise NotImplementedError(f"gan_mode [{mode}] not implemented")


def overfit_heuristic(pred_real, mode: str = "lsgan", H=None
                      ) -> torch.Tensor:
    """ADA's r_t = E[sign(D(real) - mid)] (mid 0.5 for lsgan, else 0); a
    multiscale tuple averages the per-scale means. ``H`` as in
    ``gan_loss``: on a band, each rank's shares summed over the line (one
    collective), so every rank holds r_t and ADA's p moves alike."""
    return line_total(_sign_mean(pred_real, mode, H))


def _sign_mean(pred_real, mode: str, H) -> torch.Tensor:
    if isinstance(pred_real, (tuple, list)):
        hs = [None] * len(pred_real) if H is None else H
        per = [_sign_mean(p, mode, h) for p, h in zip(pred_real, hs)]
        return sum(per) / len(per)
    mid = 0.5 if mode == "lsgan" else 0.0
    return band_mean(torch.sign(pred_real.float() - mid), H)


def feature_matching_loss(fake_feats, real_feats, H=None) -> torch.Tensor:
    """pix2pixHD feature matching: per scale ``4/n_feat * sum_l
    mean|f_fake - f_real|``, averaged over scales (callers detach the real
    side). ``H``: each feature's global height where the features are
    bands of it (of a multiscale D, a tuple per scale), each mean then
    this rank's share."""
    if fake_feats and isinstance(fake_feats[0], (tuple, list)):
        hs = [None] * len(fake_feats) if H is None else H
        per = [feature_matching_loss(f, r, h)
               for f, r, h in zip(fake_feats, real_feats, hs)]
        return sum(per) / len(per)
    hs = [None] * len(fake_feats) if H is None else H
    w = 4.0 / max(len(fake_feats), 1)
    total = torch.zeros((), device=fake_feats[0].device)
    for f, r, h in zip(fake_feats, real_feats, hs):
        total = total + w * band_mean(torch.abs(f.float() - r.float()), h)
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
    gnorm = torch.sqrt(line_sum(torch.sum(g ** 2, dim=(1, 2, 3))) + 1e-16)
    return share(torch.mean((gnorm - 1.0) ** 2))


def r1_penalty(d_apply: Callable, real: torch.Tensor, cond) -> torch.Tensor:
    """R1 (Mescheder et al. 2018): ``E[||grad_x D(x)||^2]`` on real images;
    the caller scales by ``lambda_r1 / 2``."""
    g = _input_grad(d_apply, real, cond)
    return share(torch.mean(line_sum(torch.sum(g ** 2, dim=(1, 2, 3)))))
