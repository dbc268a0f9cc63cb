"""Weight bridge: flax param trees (G, D, C), a JAX ``TrainState`` /
``ComparatorState`` and a JAX comparator bundle -> the port.

The flax tree of ``pcgan_tpu``'s ResnetGenerator names its convs by creation
order (``TorchConv_N`` / ``ResnetBlock_i`` / ``TorchConvTranspose_i``; with
bottleneck injection the 1x1 projection takes ``TorchConv_{nd+1}`` and the
tail's index shifts by one), the walk of ``pcgan_tpu/utils/pth_import.py:39-60``.
Its norms are ``Norm_k/{BatchNorm_0,GroupNorm_0}`` in creation order (the
stem's, the down convs', the up convs'; ``ResnetBlock_i/Norm_{0,1}``), their
``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` becoming
``weight``/``bias``/``running_mean``/``running_var``. The discriminators'
convs are ``TorchConv_0..n`` in order (under ``D_k/`` for the multiscale
D), their norms ``Norm_k``, the attention's 1x1 convs ``attn/{theta,phi,
g,o}``, and spectral norm's ``batch_stats`` ``SpectralNorm_j/<conv>/
kernel/{u,sigma}`` become ``<conv>.sn.{u,sigma}``. Kernels are
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


def _generator_order(flat: Mapping):
    n_blocks = _count(flat, r"ResnetBlock_\d+/")
    n_down = _count(flat, r"TorchConvTranspose_\d+/")
    n_top_convs = _count(flat, r"TorchConv_\d+/")
    if n_top_convs not in (n_down + 2, n_down + 3):
        raise ValueError(f"not a resnet generator tree: {n_top_convs} top "
                         f"convs for {n_down} upsampling layers")
    inject = "bottleneck" if n_top_convs == n_down + 3 else "input"
    return resnet_param_map(n_blocks, n_down, inject)


# flax norm leaves -> the port's (batch norm: params and running stats)
_NORM_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                "var": "running_var"}


def _norm_key(parts, site: str) -> str:
    """``Norm_k/<BatchNorm_0|GroupNorm_0>/<leaf>`` -> ``<site>.<leaf>``."""
    if len(parts) != 3 or parts[1] not in ("BatchNorm_0", "GroupNorm_0"):
        raise KeyError("/".join(parts))
    return f"{site}.{_NORM_LEAVES[parts[2]]}"


def _generator_translator(flat: Mapping):
    """flax key of a resnet G's params or batch_stats -> (port key, kind).
    Norm sites in creation order: the stem's, the down convs', the up
    convs' (``Norm_k``); each block's ``Norm_0`` / ``Norm_1``."""
    convs = {path: (name, kind) for path, name, kind in
             _generator_order(flat)}
    n_down = _count(flat, r"TorchConvTranspose_\d+/")
    sites = (["stem_norm"] + [f"down_norm.{i}" for i in range(n_down)]
             + [f"up_norm.{i}" for i in range(n_down)])

    def translate(key: str):
        parts = key.split("/")
        if parts[0].startswith("ResnetBlock_") and parts[1].startswith(
                "Norm_"):
            site = f"blocks.{parts[0][12:]}.norm{parts[1][5:]}"
            return _norm_key(parts[1:], site), "plain"
        if parts[0].startswith("Norm_"):
            return _norm_key(parts, sites[int(parts[0][5:])]), "plain"
        name, kind = convs["/".join(parts[:-1])]
        if parts[-1] == "kernel":
            return f"{name}.weight", kind
        return f"{name}.{parts[-1]}", "plain"
    return translate


def _translate_tree(flat: Mapping, translate, what: str,
                    state: Mapping = None
                    ) -> "OrderedDict[str, torch.Tensor]":
    """Every tensor of a '/'-flat flax tree (plus its ``batch_stats``
    collection when ``state`` is given) under the port's name, kernels in
    the port's layout; a tensor with no place raises."""
    flat = dict(flat)
    if state:
        flat.update(flatten_params(state.get("batch_stats", state)))
    to_torch = {"conv": conv_weight_from_flax,
                "deconv": deconv_weight_from_flax, "plain": np.asarray}
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, v in flat.items():
        try:
            name, kind = translate(key)
        except (KeyError, ValueError, IndexError):
            raise ValueError(f"flax tensors with no place in the port's "
                             f"{what}: {[key]}") from None
        sd[name] = torch.from_numpy(np.array(to_torch[kind](v), np.float32))
    return sd


def convert_generator_params(flax_params: Mapping, state: Mapping = None
                             ) -> "OrderedDict[str, torch.Tensor]":
    """Flax ResnetGenerator params (nested or '/'-flat, numpy or jax
    arrays) -> a ``state_dict`` for ``ResnetGenerator``; with ``state`` (the
    G's ``batch_stats`` collection) the running stats too. The block count,
    the downsampling depth and the injection site are read off the tree;
    every flax tensor must be consumed."""
    flat = flatten_params(flax_params)
    return _translate_tree(flat, _generator_translator(flat), "generator",
                           state)


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


def _d_module(mod) -> str:
    out = []
    for c in mod:
        if c.startswith("TorchConv_"):
            out.append(f"convs.{c[10:]}")
        elif c.startswith("D_") or c in ("attn", "theta", "phi", "g", "o"):
            out.append(c)
        else:
            raise KeyError(c)
    return ".".join(out)


def _discriminator_key(key: str):
    """flax key of an NLayer / pixel / multiscale D's params or batch_stats
    -> (port key, kind): ``TorchConv_i`` -> ``convs.i``, ``Norm_k`` ->
    ``norms.k``, the attention's ``attn/<theta|phi|g|o>`` 1x1 convs and
    ``attn/gamma``, ``D_k/`` prefixes, and spectral norm's
    ``SpectralNorm_j/<conv>/kernel/<u|sigma>`` -> ``<conv>.sn.<u|sigma>``."""
    parts = [c for c in key.split("/") if not c.startswith("SpectralNorm_")]
    if parts[-1] in ("u", "sigma"):
        if parts[-2] != "kernel":
            raise KeyError(key)
        return f"{_d_module(parts[:-2])}.sn.{parts[-1]}", "plain"
    if len(parts) >= 3 and parts[-3].startswith("Norm_"):
        site = ".".join(parts[:-3] + [f"norms.{parts[-3][5:]}"])
        return _norm_key(parts[-3:], site), "plain"
    *mod, leaf = parts
    if leaf == "kernel":
        return f"{_d_module(mod)}.weight", "conv"
    return ".".join([_d_module(mod), leaf] if mod else [leaf]), "plain"


def convert_discriminator_params(flax_params: Mapping, state: Mapping = None
                                 ) -> "OrderedDict[str, torch.Tensor]":
    """Flax discriminator params (NLayer, pixel or multiscale, with
    ``--d_attn``'s attention) -> a ``state_dict`` for the port's module;
    with ``state`` (``d_state``, the ``batch_stats`` collection) spectral
    norm's u/sigma and batch norm's running stats too. Every flax tensor
    must be consumed."""
    return _translate_tree(flatten_params(flax_params), _discriminator_key,
                           "discriminator", state)


def _adam_moments(opt_state):
    """The ScaleByAdamState (count, mu, nu) inside an optax.adam state
    (also under ``optax.apply_if_finite``)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if hasattr(opt_state, "inner_state"):
        return _adam_moments(opt_state.inner_state)
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            try:
                return _adam_moments(s)
            except ValueError:
                pass
    raise ValueError("no Adam moments (mu/nu) in the optimizer state")


def _skip_counters(opt_state):
    """``optax.apply_if_finite``'s counters, or None without the wrapper."""
    if not hasattr(opt_state, "notfinite_count"):
        return None
    return {k: torch.tensor(np.asarray(getattr(opt_state, k)))
            for k in ("notfinite_count", "last_finite", "total_notfinite")}


def convert_train_state(jax_state) -> dict:
    """A JAX ``pcgan_tpu.train.TrainState`` (its arrays, fetched to the host)
    -> the payload ``pcgan_tpu_torch.utils.checkpoint.load_state`` takes:
    G and D ``state_dict``s with their ``g_state`` / ``d_state`` (spectral
    norm's u/sigma, batch norm's running stats), both optimizers' count and
    Adam moments ``mu`` / ``nu`` under the port's parameter names and
    their ``--skip_nonfinite`` counters, the EMA twin, the pool, the step,
    ADA's p, ``lr_scale`` and plateau memory. The JAX key has no torch
    counterpart; the port's generators are left as they are."""
    def opt(opt_state, convert):
        adam = _adam_moments(opt_state)
        return {"count": int(np.asarray(adam.count)),
                "mu": convert(adam.mu), "nu": convert(adam.nu),
                "skip": _skip_counters(opt_state)}

    gs = jax_state
    pool = gs.pool
    return {
        "step": int(np.asarray(gs.step)),
        "G": convert_generator_params(gs.g_params, gs.g_state),
        "D": convert_discriminator_params(gs.d_params, gs.d_state),
        "opt_g": opt(gs.g_opt, convert_generator_params),
        "opt_d": opt(gs.d_opt, convert_discriminator_params),
        "ema": (None if gs.ema_params is None
                else convert_generator_params(gs.ema_params)),
        "pool": {k: torch.from_numpy(np.array(getattr(pool, k)))
                 for k in ("imgs", "conds", "count")},
        "aug_p": (None if gs.aug_p is None
                  else float(np.asarray(gs.aug_p))),
        "lr_scale": float(np.asarray(gs.lr_scale)),
        "plateau_best": float(np.asarray(gs.plateau_best)),
        "plateau_bad": float(np.asarray(gs.plateau_bad)),
    }


def _comparator_key(key: str):
    parts = key.split("/")
    heads = {"Dense_0": "fc", "Dense_1": "head"}
    if parts[0] in heads and len(parts) == 2:
        leaf = "weight" if parts[1] == "kernel" else parts[1]
        return f"{heads[parts[0]]}.{leaf}", "plain"
    if parts[0].startswith("Norm_"):
        return _norm_key(parts, f"norms.{parts[0][5:]}"), "plain"
    if parts[0].startswith("TorchConv_") and len(parts) == 2:
        if parts[1] == "kernel":
            return f"convs.{parts[0][10:]}.weight", "conv"
        return f"convs.{parts[0][10:]}.{parts[1]}", "plain"
    raise KeyError(key)


def convert_comparator_params(flax_params: Mapping, state: Mapping = None
                              ) -> "OrderedDict[str, torch.Tensor]":
    """Flax Comparator params -> a ``state_dict`` for the port's
    ``Comparator``: ``TorchConv_i`` -> ``convs.i`` (HWIO -> OIHW),
    ``Norm_k`` -> ``norms.k`` (with ``state``, batch norm's running stats
    too), ``Dense_0`` / ``Dense_1`` -> ``fc`` / ``head`` (the (in, out)
    kernel transposed to Linear's (out, in)). Every flax tensor must be
    consumed."""
    flat = flatten_params(flax_params)
    if _count(flat, r"TorchConv_\d+/") < 1 or any(
            f"Dense_{i}/kernel" not in flat for i in (0, 1)):
        raise ValueError(f"not a Comparator tree: {sorted(flat)}")
    flat = {k: (np.asarray(v).T if k.startswith("Dense_")
                and k.endswith("/kernel") else v) for k, v in flat.items()}
    return _translate_tree(flat, _comparator_key, "comparator", state)


def convert_comparator_state(jax_state) -> dict:
    """A JAX ``pcgan_tpu.train.ComparatorState`` -> the payload
    ``pcgan_tpu_torch.utils.checkpoint.load_comparator_state`` takes: C's
    ``state_dict``, Adam's count and moments under the port's names, the
    step. The JAX key has no torch counterpart."""
    adam = _adam_moments(jax_state.opt)
    return {"step": int(np.asarray(jax_state.step)),
            "C": convert_comparator_params(jax_state.params,
                                           jax_state.state),
            "opt": {"count": int(np.asarray(adam.count)),
                    "mu": convert_comparator_params(adam.mu),
                    "nu": convert_comparator_params(adam.nu)}}


def convert_comparator_bundle(payload: Mapping) -> dict:
    """A JAX comparator bundle ``{'c_vars', 'bin_lo', 'bin_hi',
    'bin_means'}`` (numpy or jax arrays; ``bin_means`` may be absent or
    None) -> the port's ``comparator.pt`` payload. ``cmp_nf``, ``cmp_n_down``
    and ``norm`` are read off the tree; the JAX bundle does not record the
    compute dtype that pretrained it, so the payload has none."""
    c_vars = payload["c_vars"]
    if "params" in c_vars:          # a variables dict: params + batch_stats
        sd = convert_comparator_params(c_vars["params"],
                                       c_vars.get("batch_stats"))
    else:
        sd = convert_comparator_params(c_vars)
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
            "norm": ("batch" if "norms.0.running_mean" in sd
                     else "group" if "norms.0.weight" in sd
                     else "none" if "convs.1.bias" in sd else "instance")}


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
    """Flax ``VGG16Taps`` / ``VGG19Taps`` params (``conv_<i>`` HWIO + bias)
    -> a ``state_dict`` for the port's trunk (``features.<i>``)."""
    flat = flatten_params(flax_params)
    order = sorted({int(m.group(1)) for k in flat
                    if (m := re.match(r"conv_(\d+)/", k))})
    sd, used = _walk(flat, [(f"conv_{i}", f"features.{i}", "conv")
                            for i in order])
    left = sorted(set(flat) - used)
    if left:
        raise ValueError(f"flax tensors with no place in the port's VGG: "
                         f"{left}")
    return sd


def convert_lpips_lins(lins) -> Tuple[torch.Tensor, ...]:
    """The JAX package's LPIPS calibration (a tuple of (C_k,) arrays) ->
    the port's tuple of f32 tensors."""
    return tuple(torch.from_numpy(np.array(w, np.float32)) for w in lins)
