"""Weight bridge: flax param trees (G, D, C), a JAX ``TrainState`` /
``ComparatorState`` and a JAX comparator bundle -> the port.

The flax tree of ``pcgan_tpu``'s ResnetGenerator names its convs by creation
order (``TorchConv_N`` / ``ResnetBlock_i`` / ``TorchConvTranspose_i``; with
bottleneck injection the 1x1 projection takes ``TorchConv_{nd+1}`` and the
tail's index shifts by one), the walk of ``pcgan_tpu/utils/pth_import.py:39-60``.
The discriminator's convs are ``TorchConv_0..n`` in order. Kernels are
HWIO: conv weights become OIHW, deconv weights become ``ConvTranspose2d``'s
``(Cin, Cout, kH, kW)`` by ``transpose(2, 3, 0, 1)`` with no flip
(``pcgan_tpu/utils/pth_export.py:84-94``). Biases exist only where the flax
tree has them. Adam's moments have their parameters' shapes and take the
same walk. The comparator's trunk convs are ``TorchConv_0..n-1`` (a bias on
the first only under instance norm) and its two heads ``Dense_0`` /
``Dense_1``, whose (in, out) kernels become ``nn.Linear``'s (out, in).

To dump a JAX generator for ``load_flax_npz`` (on the JAX side)::

    from flax.traverse_util import flatten_dict
    flat = flatten_dict(g_vars["params"], sep="/")
    np.savez("G_flax.npz", **{k: np.asarray(v) for k, v in flat.items()})

and a JAX comparator bundle (``<run>/comparator``, written by ``train.py
--model comparator``; same imports)::

    from pcgan_tpu.eval_lib import load_comparator_bundle
    _, c_vars, lo, hi, means = load_comparator_bundle(cfg)  # --comparator_path
    np.savez("C_flax.npz", **{k: np.asarray(v) for k, v in
                              flatten_dict(c_vars["params"], sep="/").items()})
    np.savez("C_anchors.npz", bin_lo=lo, bin_hi=hi, bin_means=means)

A JAX generator calibrated for int8 (``calibrate_quant``) carries a
``quant`` collection beside its params: one ``act_absmax`` per trunk site
(``TorchConv_1/act_absmax``, ``ResnetBlock_0/TorchConv_0/act_absmax``,
``TorchConvTranspose_0/act_absmax``, ...). ``convert_generator_quant``
maps it onto the port's site names for ``ops.quant.set_act_absmaxes``, and
``generator_quant_to_flax`` maps the port's calibrated absmaxes back.

then, on the port's side, write the port's bundle::

    a = np.load("C_anchors.npz")
    b = convert_comparator_bundle({"c_vars": load_flax_npz("C_flax.npz"),
                                   **{k: a[k] for k in a.files}})
    torch.save(b, "<run>/comparator.pt")
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


def _quant_order(flat: Mapping):
    """(flax path, port site) of a resnet G's ``quant`` collection: the
    param walk without the stem and the tail, which never quantize."""
    n_blocks = _count(flat, r"ResnetBlock_\d+/")
    n_down = _count(flat, r"TorchConvTranspose_\d+/")
    inject = ("bottleneck" if f"TorchConv_{n_down + 1}/act_absmax" in flat
              else "input")
    order = resnet_param_map(n_blocks, n_down, inject)
    return [(path, name) for path, name, _ in order[1:-1]]


def convert_generator_quant(flax_quant: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX G's ``quant`` collection (nested or '/'-flat; a ``{'quant':
    ...}`` variables dict is unwrapped) -> ``{port site name: 0-d f32
    absmax}`` (``down.0``, ``blocks.0.conv1``, ``up.1``, ...). Every
    entry must be consumed."""
    if "quant" in flax_quant and isinstance(flax_quant["quant"], Mapping):
        flax_quant = flax_quant["quant"]
    flat = flatten_params(flax_quant)
    out, used = {}, set()
    for path, name in _quant_order(flat):
        key = f"{path}/act_absmax"
        out[name] = torch.tensor(float(np.asarray(flat[key])),
                                 dtype=torch.float32)
        used.add(key)
    left = sorted(set(flat) - used)
    if left:
        raise ValueError(f"quant entries with no site in the port's "
                         f"generator: {left}")
    return out


def generator_quant_to_flax(absmaxes: Mapping, n_blocks: int,
                            n_downsampling: int = 2,
                            cond_inject: str = "input") -> dict:
    """The port's ``{site name: absmax}`` (``ops.quant.act_absmaxes``) ->
    a nested flax ``quant`` collection of f32 numpy scalars."""
    order = resnet_param_map(n_blocks, n_downsampling, cond_inject)[1:-1]
    tree: dict = {}
    for path, name, _ in order:
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node["act_absmax"] = np.asarray(
            torch.as_tensor(absmaxes[name]).float().cpu().numpy())
    return tree


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


def convert_comparator_params(flax_params: Mapping
                              ) -> "OrderedDict[str, torch.Tensor]":
    """Flax Comparator params -> a ``state_dict`` for the port's
    ``Comparator``: ``TorchConv_i`` -> ``convs.i`` (HWIO -> OIHW),
    ``Dense_0`` / ``Dense_1`` -> ``fc`` / ``head`` (kernel transposed).
    Every flax tensor must be consumed."""
    def order(flat):
        n = _count(flat, r"TorchConv_\d+/")
        if n < 1 or any(f"Dense_{i}/kernel" not in flat for i in (0, 1)):
            raise ValueError(f"not a Comparator tree: {sorted(flat)}")
        return [(f"TorchConv_{i}", f"convs.{i}", "conv") for i in range(n)]

    flat = flatten_params(flax_params)
    sd, used = _walk(flat, order(flat))
    for path, name in (("Dense_0", "fc"), ("Dense_1", "head")):
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(flat[f"{path}/kernel"], np.float32).T))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(flat[f"{path}/bias"], np.float32).copy())
        used |= {f"{path}/kernel", f"{path}/bias"}
    left = sorted(set(flat) - used)
    if left:
        raise ValueError(f"flax tensors with no place in the port's "
                         f"comparator: {left}")
    return sd


def convert_comparator_state(jax_state) -> dict:
    """A JAX ``pcgan_tpu.train.ComparatorState`` -> the payload
    ``pcgan_tpu_torch.utils.checkpoint.load_comparator_state`` takes: C's
    ``state_dict``, Adam's count and moments under the port's names, the
    step. The JAX key has no torch counterpart."""
    adam = _adam_moments(jax_state.opt)
    return {"step": int(np.asarray(jax_state.step)),
            "C": convert_comparator_params(jax_state.params),
            "opt": {"count": int(np.asarray(adam.count)),
                    "mu": convert_comparator_params(adam.mu),
                    "nu": convert_comparator_params(adam.nu)}}


def convert_comparator_bundle(payload: Mapping) -> dict:
    """A JAX comparator bundle ``{'c_vars', 'bin_lo', 'bin_hi',
    'bin_means'}`` (numpy or jax arrays; ``bin_means`` may be absent or
    None) -> the port's ``comparator.pt`` payload. ``cmp_nf``, ``cmp_n_down``
    and ``norm`` are read off the tree; the JAX bundle does not record the
    compute dtype that pretrained it, so the payload has none."""
    sd = convert_comparator_params(payload["c_vars"])
    n_down = sum(1 for k in sd if k.startswith("convs.")
                 and k.endswith(".weight"))
    means = payload.get("bin_means")

    def f32(v):
        return torch.from_numpy(np.array(v, np.float32))
    return {"C": sd, "bin_lo": f32(payload["bin_lo"]),
            "bin_hi": f32(payload["bin_hi"]),
            "bin_means": None if means is None else f32(means),
            "cmp_nf": int(sd["convs.0.weight"].shape[0]),
            "cmp_n_down": n_down,
            "norm": "none" if "convs.1.bias" in sd else "instance"}


# --------------------------------------------------------------------------- #
# evaluation feature nets
# --------------------------------------------------------------------------- #


def convert_random_features_params(flax_params: Mapping
                                   ) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``RandomConvFeatures`` params (``Conv_i`` HWIO + bias,
    ``Dense_0``) -> a ``state_dict`` for the port's ``RandomConvFeatures``
    (``convs.i``, ``fc``). Every flax tensor must be consumed."""
    flat = flatten_params(flax_params)
    n = _count(flat, r"Conv_\d+/")
    if n < 1 or "Dense_0/kernel" not in flat:
        raise ValueError(f"not a RandomConvFeatures tree: {sorted(flat)}")
    sd, used = _walk(flat, [(f"Conv_{i}", f"convs.{i}", "conv")
                            for i in range(n)])
    sd["fc.weight"] = torch.from_numpy(np.ascontiguousarray(
        np.asarray(flat["Dense_0/kernel"], np.float32).T))
    sd["fc.bias"] = torch.from_numpy(
        np.asarray(flat["Dense_0/bias"], np.float32).copy())
    used |= {"Dense_0/kernel", "Dense_0/bias"}
    left = sorted(set(flat) - used)
    if left:
        raise ValueError(f"flax tensors with no place in the port's random "
                         f"feature net: {left}")
    return sd


def convert_inception_params(flax_params: Mapping
                             ) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``InceptionV3Features`` params (BN already folded: per unit
    ``kernel`` HWIO, ``scale``, ``bias``) -> a ``state_dict`` for the port's
    ``InceptionV3Features``: ``Mixed_5b/branch1x1/kernel`` ->
    ``Mixed_5b.branch1x1.conv.weight`` (OIHW), ``scale``/``bias`` by name."""
    flat = flatten_params(flax_params)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, v in flat.items():
        unit, leaf = key.rsplit("/", 1)
        name = unit.replace("/", ".")
        v = np.asarray(v, np.float32)
        if leaf == "kernel":
            sd[f"{name}.conv.weight"] = torch.from_numpy(
                conv_weight_from_flax(v))
        elif leaf in ("scale", "bias"):
            sd[f"{name}.{leaf}"] = torch.from_numpy(v.copy())
        else:
            raise ValueError(f"flax tensor with no place in the port's "
                             f"Inception: {key}")
    return sd


def convert_vgg16_params(flax_params: Mapping
                         ) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``VGG16Taps`` params (``conv_<i>`` HWIO + bias) -> a
    ``state_dict`` for the port's ``VGG16Taps`` (``features.<i>``)."""
    flat = flatten_params(flax_params)
    order = sorted({int(m.group(1)) for k in flat
                    if (m := re.match(r"conv_(\d+)/", k))})
    sd, used = _walk(flat, [(f"conv_{i}", f"features.{i}", "conv")
                            for i in order])
    left = sorted(set(flat) - used)
    if left:
        raise ValueError(f"flax tensors with no place in the port's VGG16: "
                         f"{left}")
    return sd


def convert_lpips_lins(lins) -> Tuple[torch.Tensor, ...]:
    """The JAX package's LPIPS calibration (a tuple of (C_k,) arrays) ->
    the port's tuple of f32 tensors."""
    return tuple(torch.from_numpy(np.array(w, np.float32)) for w in lins)
