"""Import a reference PyTorch generator ``.pth`` into the port's G
(counterpart of ``pcgan_tpu/utils/pth_import.py:39-220``).

A torch ``state_dict`` keeps its modules' registration order, so the
importer does not depend on the reference's layer names: it walks the
file's conv-like tensors (4-d weights) in order and zips them against the
port's G in architectural order (``generator_order``), checking the shape
at every pair. The layouts are the same on both sides, so no tensor is
transposed or flipped: ``Conv2d`` weights are (co, ci, kh, kw) and
``ConvTranspose2d`` weights (ci, co, kh, kw) in the file and in the port
(``convert.py``: the port's deconv is torch's own).

A conv feeding a parameterless instance norm carries a bias in the
reference that the port drops (the norm removes any per-channel constant
exactly); that bias is skipped. Batch norm's weight, bias and running
statistics map by the same ordered walk. The file is read by
``utils/pth.py load_pth``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

Order = List[Tuple[str, str]]


def resnet_generator_order(n_blocks: int, n_downsampling: int = 2,
                           cond_inject: str = "input") -> Order:
    """Ordered (port module name, kind) of the resnet G; kind is conv,
    deconv or norm."""
    order: Order = [("stem", "conv"), ("stem_norm", "norm")]
    for i in range(n_downsampling):
        order += [(f"down.{i}", "conv"), (f"down_norm.{i}", "norm")]
    if cond_inject == "bottleneck":
        order.append(("cond_proj", "conv"))
    for b in range(n_blocks):
        order += [(f"blocks.{b}.conv0", "conv"), (f"blocks.{b}.norm0", "norm"),
                  (f"blocks.{b}.conv1", "conv"), (f"blocks.{b}.norm1", "norm")]
    for i in range(n_downsampling):
        order += [(f"up.{i}", "deconv"), (f"up_norm.{i}", "norm")]
    order.append(("tail", "conv"))
    return order


def unet_generator_order(num_downs: int) -> Order:
    """The U-Net in torch's registration order: the down conv of every
    level from the outermost to the innermost, then the up convs from the
    innermost back out. The port's ``levels.0`` is the innermost level."""
    n = num_downs
    order: Order = []
    for lvl in range(n - 1, -1, -1):
        order.append((f"levels.{lvl}.down", "conv"))
        if 0 < lvl < n - 1:          # middle levels have a down norm
            order.append((f"levels.{lvl}.down_norm", "norm"))
    for lvl in range(n):
        order.append((f"levels.{lvl}.up", "deconv"))
        if lvl < n - 1:              # all but the outermost have an up norm
            order.append((f"levels.{lvl}.up_norm", "norm"))
    return order


def generator_order(netG: str, cond_inject: str = "input") -> Order:
    base = netG.partition("@")[0]
    if base == "resnet_9blocks":
        return resnet_generator_order(9, cond_inject=cond_inject)
    if base == "resnet_6blocks":
        return resnet_generator_order(6, cond_inject=cond_inject)
    if base.startswith("unet_"):
        size = int(base.split("_")[1])
        return unet_generator_order(size.bit_length() - 1)
    raise NotImplementedError(f"no import order for netG [{netG}]")


def _ordered_units(state_dict):
    """Walk ``state_dict`` in order: (convs: [(key, weight, bias or None)],
    norms: [(prefix, {'weight', 'bias', 'mean', 'var'})]), tensors on the
    CPU in f32 (the JAX ``_ordered_units``)."""
    def t(v):
        return torch.as_tensor(v).detach().cpu().float()

    convs, norms = [], []
    conv_prefixes = {k.rpartition(".")[0] for k in state_dict
                     if (k.endswith(".weight") or k == "weight")
                     and t(state_dict[k]).dim() == 4}
    norm_groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for k in state_dict.keys():
        v = t(state_dict[k])
        prefix, _, field = k.rpartition(".")
        if (k.endswith(".weight") or k == "weight") and v.dim() == 4:
            b = state_dict.get(k[:-len("weight")] + "bias")
            convs.append((k, v, None if b is None else t(b)))
        elif (k.endswith((".weight", ".bias", ".running_mean",
                          ".running_var")) and v.dim() == 1
              and prefix not in conv_prefixes):  # conv biases aren't norms
            g = norm_groups.setdefault(prefix, {})
            g[field.replace("running_", "")] = v
            if len(g) == 1:
                norms.append((prefix, g))        # first-seen order
    return convs, norms


def check_counts(convs, norms, netG: str, order: Order, what: str) -> None:
    """Count checks of a ``.pth``'s units against the architecture."""
    n_conv = sum(1 for _, kind in order if kind != "norm")
    n_norm = sum(1 for _, kind in order if kind == "norm")
    if len(convs) != n_conv:
        raise ValueError(
            f"conv-tensor count mismatch: {what} has {len(convs)}, "
            f"architecture [{netG}] expects {n_conv} "
            f"({[c[0] for c in convs]})")
    if norms and len(norms) != n_norm:
        raise ValueError(
            f"norm-tensor count mismatch: {what} has {len(norms)} affine "
            f"norms, architecture [{netG}] has {n_norm} norm sites — "
            f"mixed/partial-affine checkpoints unsupported")


def _need(sd, key: str, src: str):
    if key not in sd:
        raise KeyError(f"port G has no tensor {key} <- {src} (have "
                       f"{list(sd)[:8]}...)")
    return sd[key]


def import_generator_pth(state_dict, g_state_dict, netG: str,
                         cond_inject: str = "input"
                         ) -> "OrderedDict[str, torch.Tensor]":
    """The port G's ``g_state_dict`` with every conv weight (and bias where
    the port has one) and every batch-norm tensor taken from the reference
    ``state_dict``, matched by architectural order; count and shape
    mismatches raise ValueError, a site the port lacks KeyError."""
    order = generator_order(netG, cond_inject)
    convs, norms = _ordered_units(state_dict)
    check_counts(convs, norms, netG, order, "checkpoint")
    out = OrderedDict((k, v.detach().clone())
                      for k, v in g_state_dict.items())
    conv_sites = [name for name, kind in order if kind != "norm"]
    norm_sites = [name for name, kind in order if kind == "norm"]
    for name, (tname, w, b) in zip(conv_sites, convs):
        dst = _need(out, f"{name}.weight", tname)
        if tuple(dst.shape) != tuple(w.shape):
            raise ValueError(
                f"shape mismatch at {name} <- {tname}: port "
                f"{tuple(dst.shape)} vs torch {tuple(w.shape)}")
        out[f"{name}.weight"] = w.to(dst.dtype).clone()
        # a file bias the port lacks sits at a conv feeding a parameterless
        # instance norm, where it is forward-inert: skipped
        if b is not None and f"{name}.bias" in out:
            out[f"{name}.bias"] = b.to(dst.dtype).clone()
    for name, (prefix, g) in zip(norm_sites, norms):
        dst = _need(out, f"{name}.weight", prefix)
        if dst.shape != g["weight"].shape:
            raise ValueError(f"norm shape mismatch at {name} <- {prefix}")
        for leaf, src in (("weight", "weight"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            out[f"{name}.{leaf}"] = g[src].to(
                _need(out, f"{name}.{leaf}", prefix).dtype).clone()
    return out
