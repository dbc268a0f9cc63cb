"""Adversarial criteria (counterpart of ``pcgan_tpu/ops/gan_loss.py:16-62``).

``--gan_mode`` ``vanilla`` (sigmoid BCE on logits), ``lsgan`` (MSE against
0/1 targets) and ``hinge``. Discriminators emit raw patch logits; every loss
reduces in f32. ``wgangp`` and the gradient penalties (GP, R1), feature
matching and the ADA heuristic are not ported yet and raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PORTED_MODES = ("vanilla", "lsgan", "hinge")


def split_pred(pred: torch.Tensor, bsz: int):
    """Split a 2B-batched D output into its (first B, second B) halves."""
    return pred[:bsz], pred[bsz:]


def gan_loss(logits: torch.Tensor, target_is_real: bool, mode: str = "lsgan",
             for_discriminator: bool = True) -> torch.Tensor:
    """Loss for one batch of D outputs (reference GANLoss semantics)."""
    x = logits.float()
    if mode == "lsgan":
        return torch.mean((x - (1.0 if target_is_real else 0.0)) ** 2)
    if mode == "vanilla":
        # stable BCE-with-logits against a constant target, as in JAX
        t = 1.0 if target_is_real else 0.0
        return torch.mean(torch.clamp(x, min=0) - x * t
                          + torch.log1p(torch.exp(-x.abs())))
    if mode == "hinge":
        if for_discriminator:
            return (torch.mean(F.relu(1.0 - x)) if target_is_real
                    else torch.mean(F.relu(1.0 + x)))
        return -torch.mean(x)
    if mode == "wgangp":
        raise NotImplementedError(
            "--gan_mode wgangp (and its gradient penalty) is not ported to "
            "pcgan_tpu_torch yet (vanilla | lsgan | hinge)")
    raise NotImplementedError(f"gan_mode [{mode}] not implemented")
