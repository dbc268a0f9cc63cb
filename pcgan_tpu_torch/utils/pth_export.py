"""Export the port's G to a reference-layout PyTorch ``.pth`` (counterpart
of ``pcgan_tpu/utils/pth_export.py:42-121``, the inverse of
``pth_import``).

The output takes its names from a TEMPLATE ``state_dict`` (the user's own
reference ``.pth``, or the in-repo mirror of ``utils/pth_mirror.py``), so
the code that made the template loads it. The template's conv-like tensors
are walked in registration order and each slot is filled from the port's
G in architectural order, the shape checked at every pair; no transpose is
needed (the port's conv and deconv layouts are torch's). Bias slots the
template has at convs feeding a parameterless instance norm are
forward-inert and absent from the port's G: they get zeros, which leave
every output unchanged. Batch norm's weight, bias and running statistics
map by the same walk; any other template tensor (``num_batches_tracked``)
passes through untouched.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from pcgan_tpu_torch.utils.pth_import import (_ordered_units, check_counts,
                                              generator_order)


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def export_generator_pth(g_state_dict, netG: str, template_state_dict,
                         cond_inject: str = "input"
                         ) -> "OrderedDict[str, np.ndarray]":
    """An OrderedDict of f32 numpy arrays under the template's names, with
    every conv kernel and bias and every norm tensor replaced by the port
    G's (``g_state_dict``). Count and shape mismatches raise ValueError."""
    order = generator_order(netG, cond_inject)
    convs, norms = _ordered_units(template_state_dict)
    check_counts(convs, norms, netG, order, "template")
    out = OrderedDict((k, _np(v)) for k, v in template_state_dict.items())
    conv_sites = [name for name, kind in order if kind != "norm"]
    norm_sites = [name for name, kind in order if kind == "norm"]
    for name, (tname, w, b) in zip(conv_sites, convs):
        if f"{name}.weight" not in g_state_dict:
            raise KeyError(f"port G has no tensor {name}.weight -> {tname}")
        wt = _np(g_state_dict[f"{name}.weight"]).astype(np.float32)
        if wt.shape != tuple(w.shape):
            raise ValueError(
                f"shape mismatch at {name} -> {tname}: port {wt.shape} vs "
                f"template {tuple(w.shape)}")
        out[tname] = wt
        bias = g_state_dict.get(f"{name}.bias")
        if b is not None:
            # the port drops the bias of a conv feeding a parameterless
            # instance norm; the template's inert slot gets zeros
            out[tname[:-len("weight")] + "bias"] = (
                np.zeros(tuple(b.shape), np.float32) if bias is None
                else _np(bias).astype(np.float32))
        elif bias is not None:
            raise ValueError(
                f"template has no bias tensor at {tname} but the port's "
                f"generator carries one — architecture/norm mismatch")
    for name, (prefix, g) in zip(norm_sites, norms):
        if f"{name}.running_mean" not in g_state_dict:
            raise ValueError("template expects BatchNorm tensors; the port's "
                             f"G has none at {name} (instance norm?)")
        if tuple(g_state_dict[f"{name}.weight"].shape) != tuple(
                g["weight"].shape):
            raise ValueError(f"norm shape mismatch at {name} -> {prefix}")
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{prefix}.{leaf}"] = _np(
                g_state_dict[f"{name}.{leaf}"]).astype(np.float32)
    return out
