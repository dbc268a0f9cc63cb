"""Checkpoints of the port (counterpart of ``pcgan_tpu/utils/checkpoint.py``).

A G-only checkpoint is the module's ``state_dict`` saved with ``torch.save``
at ``{checkpoints_dir}/{name}/{tag}_G.pt`` (``{tag}_G_ema.pt`` for the EMA
twin); the sampler reads it. A full training state is ``{tag}.pt`` beside
it. Comparator pretraining writes its state as ``cmp_latest.pt`` /
``cmp_epoch_N.pt`` and, at its end, the bundle ``comparator.pt``: the
frozen C and its score anchors, which a GAN run reads through
``--comparator_path``. Every file loads with ``weights_only=True``: no
pickled code runs.
"""

from __future__ import annotations

import os
import re

import torch
from torch import nn


def _save(payload: dict, path: str) -> str:
    """``torch.save`` to ``path`` atomically (tmp + rename)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def generator_path(checkpoints_dir: str, name: str, tag: str = "latest",
                   use_ema: bool = False) -> str:
    suffix = "_G_ema" if use_ema else "_G"
    return os.path.join(checkpoints_dir, name, f"{tag}{suffix}.pt")


def save_generator(G, checkpoints_dir: str, name: str,
                   tag: str = "latest", use_ema: bool = False) -> str:
    """``G``: the module, or a ``state_dict`` of it (the EMA twin: its
    parameters with G's norm state, ``ema_state_dict``)."""
    sd = G.state_dict() if isinstance(G, nn.Module) else G
    return _save(_cpu(sd), generator_path(checkpoints_dir, name, tag,
                                          use_ema))


def ema_state_dict(G: nn.Module, ema: dict) -> dict:
    """G's ``state_dict`` with the EMA twin's parameters: the running
    statistics of batch norm are shared, as in the JAX package."""
    return {**G.state_dict(), **ema}


def restore_generator(G: nn.Module, checkpoints_dir: str, name: str,
                      tag: str = "latest", use_ema: bool = False) -> nn.Module:
    """Loads the checkpoint into ``G`` in place (strict) and returns it."""
    path = generator_path(checkpoints_dir, name, tag, use_ema)
    state = torch.load(path, map_location="cpu", weights_only=True)
    G.load_state_dict(state, strict=True)
    return G


def exists(checkpoints_dir: str, name: str, tag: str = "latest",
           use_ema: bool = False) -> bool:
    return os.path.isfile(generator_path(checkpoints_dir, name, tag, use_ema))


# --------------------------------------------------------------------------- #
# full training state
# --------------------------------------------------------------------------- #


def state_path(checkpoints_dir: str, name: str, tag: str = "latest") -> str:
    return os.path.join(checkpoints_dir, name, f"{tag}.pt")


def state_exists(checkpoints_dir: str, name: str, tag: str = "latest") -> bool:
    return os.path.isfile(state_path(checkpoints_dir, name, tag))


def _cpu(sd: dict) -> dict:
    return {k: v.detach().cpu() for k, v in sd.items()}


def adam_state(opt: torch.optim.Optimizer, module: nn.Module,
               skip: dict = None) -> dict:
    """A ``torch.optim.Adam`` over ``module``'s parameters in optax's terms,
    keyed by parameter name: {'count': steps taken, 'mu': {name: first
    moment}, 'nu': {name: second moment}, 'skip': the ``--skip_nonfinite``
    counters or None} (zeros before the first step), copied to the CPU."""
    count, mu, nu = 0, {}, {}
    for n, p in module.named_parameters():
        st = opt.state.get(p) or {}
        if st:
            count = int(st["step"])
        mu[n] = st.get("exp_avg", torch.zeros_like(p))
        nu[n] = st.get("exp_avg_sq", torch.zeros_like(p))
    return {"count": count, "mu": _cpu(mu), "nu": _cpu(nu),
            "skip": None if skip is None else _cpu(skip)}


def _load_skip(skip: dict, sd: dict, what: str) -> None:
    """The ``--skip_nonfinite`` counters of a payload into the run's (in
    place, on their device)."""
    if skip is None:
        return
    if sd.get("skip") is None:
        raise ValueError(f"{what}: the checkpoint has no --skip_nonfinite "
                         f"counters (it was trained without the flag)")
    for k, v in skip.items():
        skip[k] = sd["skip"][k].to(v.device, v.dtype)


@torch.no_grad()
def load_adam_state(opt: torch.optim.Optimizer, module: nn.Module,
                    sd: dict) -> None:
    """Loads an ``adam_state`` payload (or ``convert``'s optax moments) into
    ``opt``; the tensors are copied to the parameters' devices."""
    names = [n for n, _ in module.named_parameters()]
    for key in ("mu", "nu"):
        if set(sd[key]) != set(names):
            raise ValueError(f"optimizer state {key}: parameters "
                             f"{sorted(set(sd[key]) ^ set(names))} do not "
                             f"match")
    index = {id(p): i for i, p in enumerate(opt.param_groups[0]["params"])}
    torch_sd = opt.state_dict()
    torch_sd["state"] = {
        index[id(p)]: {"step": torch.tensor(float(sd["count"])),
                       "exp_avg": sd["mu"][n].detach().clone(),
                       "exp_avg_sq": sd["nu"][n].detach().clone()}
        for n, p in module.named_parameters()}
    opt.load_state_dict(torch_sd)


def save_state(state, checkpoints_dir: str, name: str,
               tag: str = "latest") -> str:
    """The full training state (``pcgan_tpu_torch.train.TrainState``) at
    ``{checkpoints_dir}/{name}/{tag}.pt``: G and D with their norm and
    spectral-norm state, both optimizers and their skip counters, EMA,
    pool, step, the step's and dropout's generator states, ADA's p,
    ``lr_scale`` and plateau memory. The frozen comparator and VGG trunk
    are not in it. Written atomically (tmp + rename)."""
    payload = {
        "step": int(state.step),
        "G": _cpu(state.G.state_dict()), "D": _cpu(state.D.state_dict()),
        "opt_g": adam_state(state.opt_g, state.G, state.skip_g),
        "opt_d": adam_state(state.opt_d, state.D, state.skip_d),
        "ema": None if state.ema is None else _cpu(state.ema),
        "pool": {"imgs": state.pool.imgs.cpu(), "conds": state.pool.conds.cpu(),
                 "count": state.pool.count.cpu()},
        "rng": state.generator.get_state(),
        "dropout_rng": (None if state.dropout_generator is None
                        else state.dropout_generator.get_state()),
        "aug_p": None if state.aug_p is None else float(state.aug_p),
        "lr_scale": float(state.lr_scale),
        "plateau_best": float(state.plateau_best),
        "plateau_bad": float(state.plateau_bad),
    }
    return _save(payload, state_path(checkpoints_dir, name, tag))


def restore_state(state, checkpoints_dir: str, name: str,
                  tag: str = "latest"):
    """Loads a ``save_state`` checkpoint into ``state`` in place (tensors
    keep their devices; ``weights_only`` loading) and returns it."""
    return load_state(state, torch.load(
        state_path(checkpoints_dir, name, tag), map_location="cpu",
        weights_only=True))


def load_state(state, sd: dict):
    """Loads a payload of ``save_state``'s layout (or of
    ``convert.convert_train_state``, which has no ``rng``) into ``state``
    in place and returns it."""
    from pcgan_tpu_torch.utils.image_pool import PoolState
    state.G.load_state_dict(sd["G"], strict=True)
    state.D.load_state_dict(sd["D"], strict=True)
    load_adam_state(state.opt_g, state.G, sd["opt_g"])
    load_adam_state(state.opt_d, state.D, sd["opt_d"])
    _load_skip(state.skip_g, sd["opt_g"], "G optimizer")
    _load_skip(state.skip_d, sd["opt_d"], "D optimizer")
    if state.aug_p is not None:
        if sd.get("aug_p") is None:
            raise ValueError("the checkpoint has no ADA probability (it was "
                             "trained without --ada_target)")
        state.aug_p = torch.tensor(float(sd["aug_p"]),
                                   device=state.aug_p.device)
    if state.dropout_generator is not None and sd.get("dropout_rng") \
            is not None:
        state.dropout_generator.set_state(sd["dropout_rng"])
    if (sd["ema"] is None) != (state.ema is None):
        raise ValueError("checkpoint and run disagree on --ema_decay (EMA "
                         "twin present in one only)")
    if state.ema is not None:
        with torch.no_grad():
            for k, v in state.ema.items():
                v.copy_(sd["ema"][k])
    dev = state.pool.imgs.device
    p = sd["pool"]
    if p["imgs"].shape != state.pool.imgs.shape:
        raise ValueError(f"checkpoint pool {tuple(p['imgs'].shape)} vs run "
                         f"{tuple(state.pool.imgs.shape)} (--pool_size)")
    state.pool = PoolState(p["imgs"].to(dev), p["conds"].to(dev),
                           p["count"].to(dev))
    if "rng" in sd:
        state.generator.set_state(sd["rng"])
    state.step = int(sd["step"])
    state.lr_scale = float(sd["lr_scale"])
    state.plateau_best = float(sd["plateau_best"])
    state.plateau_bad = float(sd["plateau_bad"])
    return state


# --------------------------------------------------------------------------- #
# comparator: pretraining state and the frozen bundle
# --------------------------------------------------------------------------- #


def save_comparator_state(state, checkpoints_dir: str, name: str,
                          tag: str = "cmp_latest") -> str:
    """A ``pcgan_tpu_torch.train.ComparatorState`` (C, Adam, step, the step
    generator) at ``{checkpoints_dir}/{name}/{tag}.pt``, atomically."""
    return _save({"step": int(state.step), "C": _cpu(state.C.state_dict()),
                  "opt": adam_state(state.opt, state.C, state.skip),
                  "rng": state.generator.get_state()},
                 state_path(checkpoints_dir, name, tag))


def restore_comparator_state(state, checkpoints_dir: str, name: str,
                             tag: str = "cmp_latest"):
    return load_comparator_state(state, torch.load(
        state_path(checkpoints_dir, name, tag), map_location="cpu",
        weights_only=True))


def load_comparator_state(state, sd: dict):
    """Loads a ``save_comparator_state`` payload (or
    ``convert.convert_comparator_state``'s, which has no ``rng``) into
    ``state`` in place and returns it."""
    state.C.load_state_dict(sd["C"], strict=True)
    load_adam_state(state.opt, state.C, sd["opt"])
    _load_skip(state.skip, sd["opt"], "comparator optimizer")
    if "rng" in sd:
        state.generator.set_state(sd["rng"])
    state.step = int(sd["step"])
    return state


BUNDLE = "comparator.pt"
# the flags that fix the bundle's tensor shapes and trunk math
_BUNDLE_FLAGS = ("cmp_nf", "cmp_n_down", "norm")


def save_comparator_bundle(C: nn.Module, bin_lo, bin_hi, bin_means, cfg,
                           checkpoints_dir: str, name: str) -> str:
    """``{checkpoints_dir}/{name}/comparator.pt``: C's ``state_dict``, the
    score anchors (``bin_means`` may be None) and the structural flags of
    the run that wrote it (``cmp_nf``, ``cmp_n_down``, ``norm``, ``dtype``)."""
    def f32(v):
        return None if v is None else torch.as_tensor(
            v, dtype=torch.float32).cpu()
    return _save({
        "C": _cpu(C.state_dict()),
        "bin_lo": f32(bin_lo), "bin_hi": f32(bin_hi),
        "bin_means": f32(bin_means),
        **{k: getattr(cfg.model, k) for k in (*_BUNDLE_FLAGS, "dtype")}},
        os.path.join(checkpoints_dir, name, BUNDLE))


def load_comparator_bundle(cfg, device=None):
    """``(C, bin_lo, bin_hi, bin_means)`` from ``--comparator_path`` (the
    bundle's ``.pt`` file or the run directory that holds it); the eval-side
    loader of ``pcgan_tpu/eval_lib.py:476-505``. ``cmp_nf``, ``cmp_n_down``
    and ``norm`` must match ``cfg``; C computes in ``cfg``'s ``--dtype``
    (the bundle's params are f32 whatever dtype pretrained them). A bundle
    without bin means gives ``bin_means=None``."""
    from pcgan_tpu_torch.models import define_C
    path = cfg.train.comparator_path
    if os.path.isdir(path):
        path = os.path.join(path, BUNDLE)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"--comparator_path {cfg.train.comparator_path}: no comparator "
            f"bundle (pretrain one with --model comparator)")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for k in _BUNDLE_FLAGS:
        if k in sd and sd[k] != getattr(cfg.model, k):
            raise ValueError(
                f"comparator bundle {path} was pretrained with --{k} "
                f"{sd[k]}, this run has {getattr(cfg.model, k)}: pass "
                f"--{k} {sd[k]}")
    C = define_C(cfg)
    C.load_state_dict(sd["C"], strict=True)
    return (C.to(device) if device is not None else C, sd["bin_lo"],
            sd["bin_hi"], sd.get("bin_means"))


def prune_epochs(checkpoints_dir: str, name: str, max_to_keep: int) -> list:
    """Keep only the newest ``max_to_keep`` ``epoch_<k>`` checkpoints (full
    state and the ``_G``/``_G_ema`` twins); ``latest`` files are never
    touched; ``max_to_keep <= 0`` keeps everything. Returns the removed
    file names."""
    if max_to_keep <= 0:
        return []
    base = os.path.join(checkpoints_dir, name)
    if not os.path.isdir(base):
        return []
    pat = re.compile(r"^epoch_(\d+)(_G(_ema)?)?\.pt$")
    epochs = {}
    for f in os.listdir(base):
        m = pat.match(f)
        if m:
            epochs.setdefault(int(m.group(1)), []).append(f)
    keep = set(sorted(epochs)[-max_to_keep:])
    removed = sorted(f for k, files in epochs.items() if k not in keep
                     for f in files)
    for f in removed:
        os.remove(os.path.join(base, f))
    return removed
