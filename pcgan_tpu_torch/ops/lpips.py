"""LPIPS perceptual distance (counterpart of ``pcgan_tpu/ops/lpips.py``,
``--lpips``).

The ``lpips-vgg`` configuration (Zhang et al. 2018): the VGG16 relu taps of
``models/vgg.py``, each unit-normalized over channels per location, squared
differences weighted by the per-channel ``lin`` calibration, a spatial
mean, summed over taps; between each input face and its aged output. Inputs
in [-1, 1] are shifted and scaled by the ``lpips`` package's ScalingLayer
constants. Without ``--lpips_lins`` every channel is weighted 1/C (the
evaluator then reports ``lpips_uniform``, not ``lpips``). f32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from pcgan_tpu_torch.models.vgg import LPIPS_TAP_CHANNELS

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _normalize(t: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    n = torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True))
    return t / (n + eps)


def uniform_lins(device=None) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.full((c,), 1.0 / c, device=device)
                 for c in LPIPS_TAP_CHANNELS)


def import_lpips_lins(state_dict) -> Tuple[torch.Tensor, ...]:
    """The learned calibration of an ``lpips`` package ``LPIPS(net='vgg')``
    state dict: ``lin<k>.model.1.weight`` (1, C_k, 1, 1), clamped
    non-negative as the package does at use time."""
    lins = []
    for k, c in enumerate(LPIPS_TAP_CHANNELS):
        for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
            if key in state_dict:
                break
        else:
            raise KeyError(f"missing lin{k}.model.1.weight (not an "
                           f"LPIPS(net='vgg') state_dict?)")
        w = torch.as_tensor(state_dict[key], dtype=torch.float32).reshape(-1)
        if w.shape[0] != c:
            raise ValueError(f"lin{k}: {w.shape[0]} channels, expected {c}")
        lins.append(torch.clamp(w, min=0.0))
    return tuple(lins)


def load_lpips_lins(path: str, allow_pickle: bool = False):
    from pcgan_tpu_torch.utils.pth import load_pth
    return import_lpips_lins(load_pth(path, allow_pickle=allow_pickle))


def lpips_pair(vgg16, x: torch.Tensor, y: torch.Tensor,
               lins: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Per-image LPIPS distances of two [-1, 1] NHWC batches -> (B,), one
    2B trunk forward; ``lins=None`` weights channels uniformly."""
    if lins is None:
        lins = uniform_lins(x.device)
    b = x.shape[0]
    shift = torch.tensor(_SHIFT, device=x.device)
    scale = torch.tensor(_SCALE, device=x.device)
    xin = (torch.cat([x, y]).float() - shift) / scale
    total = torch.zeros((b,), device=x.device)
    for w, t in zip(lins, vgg16(xin)):
        t = _normalize(t.float())
        d2 = (t[:b] - t[b:]) ** 2
        total = total + torch.mean(torch.sum(d2 * w.to(t.device), dim=-1),
                                   dim=(1, 2))
    return total
