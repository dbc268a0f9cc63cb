"""Training core: one fused G/D step (counterpart of ``pcgan_tpu/train.py:56-618``).

One step holds both alternating updates of the reference's
``optimize_parameters``:

1. one 2B generator forward on ``[real, real]`` with ``[cond_target,
   cond_real]``; its graph is kept and back-propagated only after the D
   update (the torch form of the JAX step's ``jax.vjp`` reuse);
2. the D update on the detached fake, mixed through the fake pool with the
   pool's conditions, in ONE 2B D pass (the norm is per-sample):
   ``L_D = 0.5 * (gan(D(real), 1) + gan(D(pool(fake)), 0))``;
3. the G update against the UPDATED D (sequential mode):
   ``L_G = gan(D(fake, cond_target), 1) + lambda_L1 * mean|idt - real|``,
   the L1 term in f32. Only G's parameters are differentiated, so no
   G-loss gradient reaches D;
4. Adam with optax's semantics: the lr is the schedule at the
   pre-increment step count, times ``lr_scale``;
   the EMA twin with the ``(1+t)/(10+t)`` ramp when ``--ema_decay > 0``.

Compute runs in ``--dtype`` (bf16 or f32); params, optimizer state and
losses are f32. Step randomness (target bins, pool draws) comes from the
state's CPU ``torch.Generator``, which checkpoints carry, so a resumed run
draws what the uninterrupted one would have.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from pcgan_tpu_torch.config import Config
from pcgan_tpu_torch.data.binning import bin_to_onehot
from pcgan_tpu_torch.models.registry import DTYPES
from pcgan_tpu_torch.ops.gan_loss import gan_loss, split_pred
from pcgan_tpu_torch.utils import image_pool

# --------------------------------------------------------------------------- #
# LR schedules (the reference's --lr_policy)
# --------------------------------------------------------------------------- #


def make_lr_schedule(cfg: Config, steps_per_epoch: int,
                     base_lr: Optional[float] = None) -> Callable[[int], float]:
    """Per-step schedule reproducing the reference's per-epoch policies.

    linear: flat for ``niter`` epochs, then linear decay to 0 over
    ``niter_decay`` (reference lambda_rule). ``base_lr`` overrides the peak
    (the TTUR D optimizer, ``--lr_d``); the decay shape is shared."""
    t = cfg.train
    spe = max(1, steps_per_epoch)
    peak = t.lr if base_lr is None else base_lr
    if t.lr_policy not in ("linear", "step", "cosine", "constant", "plateau"):
        raise NotImplementedError(f"lr_policy [{t.lr_policy}]")

    def sched(step: int) -> float:
        epoch = step // spe + t.epoch_count        # 1-based like the reference
        if t.lr_policy == "linear":
            f = 1.0 - max(0.0, epoch - t.niter) / float(t.niter_decay + 1)
        elif t.lr_policy == "step":
            f = 0.1 ** (max(0, epoch - 1) // t.lr_decay_iters)
        elif t.lr_policy == "cosine":
            f = 0.5 * (1.0 + math.cos(math.pi * (epoch - 1) / float(t.niter)))
        else:
            # constant; plateau's factor enters through lr_scale instead
            f = 1.0
        return peak * min(max(f, 0.0), 1.0)

    return sched


class PlateauScheduler:
    """Host-side ReduceLROnPlateau (``--lr_policy plateau``; torch
    ``ReduceLROnPlateau(mode='min', factor=0.2, threshold=0.01,
    patience=5)`` semantics). The loop feeds each epoch's loss and writes the
    returned factor into ``TrainState.lr_scale``."""

    def __init__(self, factor: float = 0.2, patience: int = 5,
                 threshold: float = 0.01, min_scale: float = 1e-4):
        self.factor, self.patience = factor, patience
        self.threshold, self.min_scale = threshold, min_scale
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def update(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.scale = max(self.scale * self.factor, self.min_scale)
            self.bad_epochs = 0
        return self.scale


# --------------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------------- #


def make_adam(module: nn.Module, b1: float, b2: float) -> torch.optim.Adam:
    """``torch.optim.Adam`` over a module's parameters, fused on the card and
    foreach on the CPU. Its update is ``optax.adam``'s: bias-corrected
    moments, eps outside ``sqrt(v_hat)``. ``adam_step`` sets the lr."""
    params = list(module.parameters())
    impl = {"fused": True} if params[0].is_cuda else {"foreach": True}
    return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=1e-8, **impl)


def adam_step(opt: torch.optim.Adam, grads: List[torch.Tensor],
              lr: float) -> None:
    """One step of ``opt`` with ``grads`` (one per parameter, in order) at
    learning rate ``lr``; no ``.grad`` is left behind."""
    group = opt.param_groups[0]
    for p, g in zip(group["params"], grads, strict=True):
        p.grad = g
    group["lr"] = lr
    opt.step()
    opt.zero_grad(set_to_none=True)


# --------------------------------------------------------------------------- #
# train state
# --------------------------------------------------------------------------- #


@dataclass
class TrainState:
    step: int
    G: nn.Module
    D: nn.Module
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    sched_g: Callable[[int], float]     # lr by step count
    sched_d: Callable[[int], float]     # --lr_d (TTUR) or --lr, same decay
    pool: image_pool.PoolState
    generator: torch.Generator          # CPU: target bins, pool draws, crops
    ema: Optional[Dict[str, torch.Tensor]] = None   # EMA twin of G's params
    lr_scale: float = 1.0               # host-driven LR factor (plateau)
    plateau_best: float = float("inf")  # plateau scheduler memory
    plateau_bad: float = 0.0


def reject_unported_train(cfg: Config) -> None:
    """Every training flag this slice does not implement raises when it is
    set away from its default; none is ignored."""
    t, m, d, r, p = cfg.train, cfg.model, cfg.data, cfg.run, cfg.parallel
    if m.model != "pcgan":
        raise NotImplementedError(
            f"--model {m.model} is not ported to pcgan_tpu_torch yet (pcgan)")
    if t.gan_mode == "wgangp":
        raise NotImplementedError(
            "--gan_mode wgangp (and its gradient penalty) is not ported to "
            "pcgan_tpu_torch yet (vanilla | lsgan | hinge)")
    off = {
        "--lambda_r1": t.lambda_r1 > 0, "--lambda_feat": t.lambda_feat > 0,
        "--lambda_vgg": t.lambda_vgg > 0,
        "--diff_augment": bool(t.diff_augment.replace(",", "").strip()),
        "--ada_target": t.ada_target > 0, "--grad_accum": t.grad_accum != 1,
        "--skip_nonfinite": t.skip_nonfinite > 0,
        "--metrics_lag": t.metrics_lag,
        "--log_grad_norm": t.log_grad_norm, "--log_memory": t.log_memory,
        "--init_g_from": bool(t.init_g_from),
        "--comparator_path": bool(t.comparator_path),
        "--eval_fid_epoch_freq": t.eval_fid_epoch_freq > 0,
        "--eval_use_ema": t.eval_use_ema,
        "--remat": m.remat, "--no-no_dropout": not m.no_dropout,
        "--holdout_frac": d.holdout_frac > 0,
        "--device_cache": d.device_cache,
        "--device_cache_sharded": d.device_cache_sharded,
        "--tb_logdir": bool(r.tb_logdir),
        "--profile_steps": r.profile_steps > 0,
        "--profile_server": r.profile_server > 0,
        "--debug_nans": r.debug_nans,
        "--compile_cache": bool(r.compile_cache),
        "--xla_opt": bool(r.xla_opt),
        "--mesh_shape/--mesh_axes": (p.mesh_shape != (-1,)
                                     or p.mesh_axes != ("data",)),
        "--spatial_shards": p.spatial_shards != 1, "--zero1": p.zero1,
        "--dcn_data": p.dcn_data != 1,
    }
    for flag, on in off.items():
        if on:
            raise NotImplementedError(
                f"{flag} is not ported to pcgan_tpu_torch's training yet")


def create_train_state(cfg: Config, G: nn.Module, D: nn.Module,
                       generator: torch.Generator,
                       steps_per_epoch: int = 1) -> TrainState:
    """Optimizers, lr schedules, pool and EMA around G and D (already on
    their device; the pool lives on G's device). ``generator`` is the
    step's CPU generator."""
    t = cfg.train
    dev = next(G.parameters()).device
    s = cfg.data.crop_size
    ema = ({n: p.detach().clone() for n, p in G.named_parameters()}
           if cfg.train.ema_decay > 0 else None)
    pool = image_pool.init_pool(cfg.train.pool_size,
                                (s, s, cfg.data.output_nc), cfg.cond_nc,
                                device=dev)
    return TrainState(
        step=0, G=G, D=D, opt_g=make_adam(G, t.beta1, t.beta2),
        opt_d=make_adam(D, t.beta1, t.beta2),
        sched_g=make_lr_schedule(cfg, steps_per_epoch),
        sched_d=make_lr_schedule(cfg, steps_per_epoch,
                                 t.lr_d if t.lr_d > 0 else None),
        pool=pool, generator=generator, ema=ema)


# --------------------------------------------------------------------------- #
# the step
# --------------------------------------------------------------------------- #


def make_train_step(cfg: Config, G: nn.Module, D: nn.Module) -> Callable:
    """The fused G/D step: ``train_step(state, batch) -> metrics`` updates
    ``state`` in place (params, optimizer moments, pool, EMA, step) and
    returns the 0-dim f32 losses on the device, under the JAX step's keys.

    batch: {'image': (B,H,W,C) in [-1,1] on the device, 'bin': (B,) ints,
    optional 'target_bin': (B,) ints (else drawn uniformly)}."""
    reject_unported_train(cfg)
    t = cfg.train
    nb = cfg.data.n_age_bins
    cd = DTYPES[cfg.model.dtype]
    g_params = list(G.parameters())
    d_params = list(D.parameters())

    def train_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        real = batch["image"].to(cd)
        bsz = real.shape[0]
        dev = real.device
        if "target_bin" in batch:
            target_bin = torch.as_tensor(batch["target_bin"])
        else:
            target_bin = torch.randint(0, nb, (bsz,),
                                       generator=state.generator)
        cond_real = bin_to_onehot(batch["bin"], nb, cd, dev)
        cond_target = bin_to_onehot(target_bin.to(dev), nb, cd, dev)

        # ---- one 2B generator forward, its graph kept for the G update ----
        out = G(torch.cat([real, real]), torch.cat([cond_target, cond_real]))
        fake, idt = out[:bsz], out[bsz:]

        # ---- D update: detached fake, pool-mixed, one 2B pass --------------
        state.pool, fake_d, cond_fake_d = image_pool.query(
            state.pool, fake.detach(), cond_target, state.generator)
        xx = torch.cat([real, fake_d.to(cd)])
        cc = torch.cat([cond_real, cond_fake_d.to(cd)])
        pred_real, pred_fake = split_pred(D(xx, cc), bsz)
        l_d_real = gan_loss(pred_real, True, t.gan_mode)
        l_d_fake = gan_loss(pred_fake, False, t.gan_mode)
        d_loss = 0.5 * (l_d_real + l_d_fake)
        adam_step(state.opt_d, torch.autograd.grad(d_loss, d_params),
                  state.sched_d(state.step) * state.lr_scale)

        # ---- G update against the updated D (sequential reference mode) ---
        pred = D(fake, cond_target)
        l_g_gan = gan_loss(pred, True, t.gan_mode, for_discriminator=False)
        l_g_l1 = torch.mean(torch.abs(idt.float() - real.float()))
        g_loss = l_g_gan + t.lambda_L1 * l_g_l1
        adam_step(state.opt_g, torch.autograd.grad(g_loss, g_params),
                  state.sched_g(state.step) * state.lr_scale)

        if state.ema is not None:
            # ramped decay min(d, (1+t)/(10+t)) debiases the init
            d = min(t.ema_decay, (1.0 + state.step) / (10.0 + state.step))
            with torch.no_grad():
                ema = list(state.ema.values())
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, g_params, alpha=1.0 - d)
        state.step += 1
        metrics = {"loss_G": g_loss, "loss_G_GAN": l_g_gan,
                   "loss_G_L1": l_g_l1,
                   "loss_G_cond": torch.zeros((), device=dev),
                   "loss_D": d_loss, "loss_D_real": l_d_real,
                   "loss_D_fake": l_d_fake}
        return {k: v.detach().float() for k, v in metrics.items()}

    return train_step
