"""Weight bridge: flax param trees (G, D) and a JAX ``TrainState`` -> the port.

The flax tree of ``pcgan_tpu``'s ResnetGenerator names its convs by creation
order (``TorchConv_N`` / ``ResnetBlock_i`` / ``TorchConvTranspose_i``; with
bottleneck injection the 1x1 projection takes ``TorchConv_{nd+1}`` and the
tail's index shifts by one), the walk of ``pcgan_tpu/utils/pth_import.py:39-60``.
The discriminator's convs are ``TorchConv_0..n`` in order. Kernels are
HWIO: conv weights become OIHW, deconv weights become ``ConvTranspose2d``'s
``(Cin, Cout, kH, kW)`` by ``transpose(2, 3, 0, 1)`` with no flip
(``pcgan_tpu/utils/pth_export.py:84-94``). Biases exist only where the flax
tree has them. Adam's moments have their parameters' shapes and take the
same walk.

To dump a JAX generator for ``load_flax_npz`` (on the JAX side)::

    from flax.traverse_util import flatten_dict
    flat = flatten_dict(g_vars["params"], sep="/")
    np.savez("G_flax.npz", **{k: np.asarray(v) for k, v in flat.items()})
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested flax params -> {'a/b/kernel': array}. A flat dict passes
    through; a ``{'params': ...}`` variables dict is unwrapped."""
    if set(tree) == {"params"} and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_params(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def load_flax_npz(path: str) -> Dict[str, np.ndarray]:
    """An npz of flax param paths joined with '/' -> flat numpy dict."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def resnet_param_map(n_blocks: int, n_downsampling: int = 2,
                     cond_inject: str = "input"
                     ) -> List[Tuple[str, str, str]]:
    """Ordered (flax module path, torch module name, kind) for the resnet
    generator; kind is conv or deconv."""
    order = [("TorchConv_0", "stem", "conv")]
    for i in range(n_downsampling):
        order.append((f"TorchConv_{i + 1}", f"down.{i}", "conv"))
    extra = 0
    if cond_inject == "bottleneck":
        order.append((f"TorchConv_{n_downsampling + 1}", "cond_proj", "conv"))
        extra = 1
    for b in range(n_blocks):
        for j in range(2):
            order.append((f"ResnetBlock_{b}/TorchConv_{j}",
                          f"blocks.{b}.conv{j}", "conv"))
    for i in range(n_downsampling):
        order.append((f"TorchConvTranspose_{i}", f"up.{i}", "deconv"))
    order.append((f"TorchConv_{n_downsampling + 1 + extra}", "tail", "conv"))
    return order


def conv_weight_from_flax(kernel: np.ndarray) -> np.ndarray:
    """HWIO (kH, kW, Cin, Cout) -> Conv2d OIHW."""
    return np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1))


def deconv_weight_from_flax(kernel: np.ndarray) -> np.ndarray:
    """HWIO (kH, kW, Cin, Cout) -> ConvTranspose2d (Cin, Cout, kH, kW)."""
    return np.ascontiguousarray(np.asarray(kernel).transpose(2, 3, 0, 1))


def _count(flat: Mapping, pattern: str) -> int:
    rx = re.compile(pattern)
    return len({m.group(0) for k in flat if (m := rx.match(k))})


def _walk(flat: Mapping, order) -> "Tuple[OrderedDict[str, torch.Tensor], set]":
    """(flax path, torch name, kind) walk of one '/'-flat tree -> an ordered
    torch dict, plus the set of flax keys consumed."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    used = set()
    for path, name, kind in order:
        kernel = flat[f"{path}/kernel"]
        to_torch = conv_weight_from_flax if kind == "conv" \
            else deconv_weight_from_flax
        sd[f"{name}.weight"] = torch.from_numpy(
            to_torch(kernel).astype(np.float32))
        used.add(f"{path}/kernel")
        if f"{path}/bias" in flat:
            sd[f"{name}.bias"] = torch.from_numpy(
                np.asarray(flat[f"{path}/bias"], np.float32).copy())
            used.add(f"{path}/bias")
    return sd, used


def _convert(flax_params: Mapping, order_of, what: str
             ) -> "OrderedDict[str, torch.Tensor]":
    flat = flatten_params(flax_params)
    sd, used = _walk(flat, order_of(flat))
    left = sorted(set(flat) - used)
    if left:
        raise ValueError(f"flax tensors with no place in the port's {what}: "
                         f"{left}")
    return sd


def _generator_order(flat: Mapping):
    n_blocks = _count(flat, r"ResnetBlock_\d+/")
    n_down = _count(flat, r"TorchConvTranspose_\d+/")
    n_top_convs = _count(flat, r"TorchConv_\d+/")
    if n_top_convs not in (n_down + 2, n_down + 3):
        raise ValueError(f"not a resnet generator tree: {n_top_convs} top "
                         f"convs for {n_down} upsampling layers")
    inject = "bottleneck" if n_top_convs == n_down + 3 else "input"
    return resnet_param_map(n_blocks, n_down, inject)


def _discriminator_order(flat: Mapping):
    """NLayerDiscriminator: flax ``TorchConv_0..n`` -> ``convs.0..n``."""
    n = _count(flat, r"TorchConv_\d+/")
    if n < 3 or any(f"TorchConv_{i}/kernel" not in flat for i in range(n)):
        raise ValueError(f"not an NLayerDiscriminator tree: {sorted(flat)}")
    return [(f"TorchConv_{i}", f"convs.{i}", "conv") for i in range(n)]


def convert_generator_params(flax_params: Mapping
                             ) -> "OrderedDict[str, torch.Tensor]":
    """Flax ResnetGenerator params (nested or '/'-flat, numpy or jax
    arrays) -> a ``state_dict`` for ``ResnetGenerator``. The block count,
    the downsampling depth and the injection site are read off the tree;
    every flax tensor must be consumed."""
    return _convert(flax_params, _generator_order, "generator")


def convert_discriminator_params(flax_params: Mapping
                                 ) -> "OrderedDict[str, torch.Tensor]":
    """Flax NLayerDiscriminator params -> a ``state_dict`` for the port's
    ``NLayerDiscriminator`` (HWIO -> OIHW; every tensor consumed)."""
    return _convert(flax_params, _discriminator_order, "discriminator")


def _adam_moments(opt_state):
    """The ScaleByAdamState (count, mu, nu) inside an optax.adam state."""
    for s in opt_state if isinstance(opt_state, (tuple, list)) else [opt_state]:
        if hasattr(s, "mu") and hasattr(s, "nu"):
            return s
    raise ValueError("no Adam moments (mu/nu) in the optimizer state")


def convert_train_state(jax_state) -> dict:
    """A JAX ``pcgan_tpu.train.TrainState`` (its arrays, fetched to the host)
    -> the payload ``pcgan_tpu_torch.utils.checkpoint.load_state`` takes:
    G and D ``state_dict``s, both optimizers' count and Adam moments ``mu``
    / ``nu`` under the port's parameter names, the EMA twin, the pool, the
    step, ``lr_scale`` and plateau memory. The JAX key has no torch
    counterpart; the port's step generator is left as it is."""
    def opt(opt_state, convert):
        adam = _adam_moments(opt_state)
        return {"count": int(np.asarray(adam.count)),
                "mu": convert(adam.mu), "nu": convert(adam.nu)}

    gs = jax_state
    pool = gs.pool
    return {
        "step": int(np.asarray(gs.step)),
        "G": convert_generator_params(gs.g_params),
        "D": convert_discriminator_params(gs.d_params),
        "opt_g": opt(gs.g_opt, convert_generator_params),
        "opt_d": opt(gs.d_opt, convert_discriminator_params),
        "ema": (None if gs.ema_params is None
                else convert_generator_params(gs.ema_params)),
        "pool": {k: torch.from_numpy(np.array(getattr(pool, k)))
                 for k in ("imgs", "conds", "count")},
        "lr_scale": float(np.asarray(gs.lr_scale)),
        "plateau_best": float(np.asarray(gs.plateau_best)),
        "plateau_bad": float(np.asarray(gs.plateau_bad)),
    }
