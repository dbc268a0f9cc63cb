"""Checkpoints of the port (counterpart of ``pcgan_tpu/utils/checkpoint.py``).

A G-only checkpoint is the module's ``state_dict`` saved with ``torch.save``
at ``{checkpoints_dir}/{name}/{tag}_G.pt`` (``{tag}_G_ema.pt`` for the EMA
twin); the sampler reads it. A full training state is ``{tag}.pt`` beside
it. Both load with ``weights_only=True``: no pickled code runs.
"""

from __future__ import annotations

import os
import re

import torch
from torch import nn


def generator_path(checkpoints_dir: str, name: str, tag: str = "latest",
                   use_ema: bool = False) -> str:
    suffix = "_G_ema" if use_ema else "_G"
    return os.path.join(checkpoints_dir, name, f"{tag}{suffix}.pt")


def save_generator(G, checkpoints_dir: str, name: str,
                   tag: str = "latest", use_ema: bool = False) -> str:
    """``G``: the module, or a ``state_dict`` of it (the EMA twin)."""
    path = generator_path(checkpoints_dir, name, tag, use_ema)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sd = G.state_dict() if isinstance(G, nn.Module) else G
    state = {k: v.detach().cpu() for k, v in sd.items()}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


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


def adam_state(opt: torch.optim.Optimizer, module: nn.Module) -> dict:
    """A ``torch.optim.Adam`` over ``module``'s parameters in optax's terms,
    keyed by parameter name: {'count': steps taken, 'mu': {name: first
    moment}, 'nu': {name: second moment}} (zeros before the first step)."""
    count, mu, nu = 0, {}, {}
    for n, p in module.named_parameters():
        st = opt.state.get(p) or {}
        if st:
            count = int(st["step"])
        mu[n] = st.get("exp_avg", torch.zeros_like(p))
        nu[n] = st.get("exp_avg_sq", torch.zeros_like(p))
    return {"count": count, "mu": mu, "nu": nu}


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
    ``{checkpoints_dir}/{name}/{tag}.pt``: G, D, both optimizers, EMA, pool,
    step, the step generator's state, ``lr_scale`` and plateau memory.
    Written atomically (tmp + rename)."""
    def cpu(d):
        return {k: v.detach().cpu() for k, v in d.items()}

    def opt(o, net):
        sd = adam_state(o, net)
        return {"count": sd["count"], "mu": cpu(sd["mu"]), "nu": cpu(sd["nu"])}

    payload = {
        "step": int(state.step),
        "G": cpu(state.G.state_dict()), "D": cpu(state.D.state_dict()),
        "opt_g": opt(state.opt_g, state.G),
        "opt_d": opt(state.opt_d, state.D),
        "ema": None if state.ema is None else cpu(state.ema),
        "pool": {"imgs": state.pool.imgs.cpu(), "conds": state.pool.conds.cpu(),
                 "count": state.pool.count.cpu()},
        "rng": state.generator.get_state(),
        "lr_scale": float(state.lr_scale),
        "plateau_best": float(state.plateau_best),
        "plateau_bad": float(state.plateau_bad),
    }
    path = state_path(checkpoints_dir, name, tag)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


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
