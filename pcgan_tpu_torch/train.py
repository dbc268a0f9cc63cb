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

With a frozen comparator C (``--comparator_path``, ``--lambda_cond > 0``)
the G loss adds ``lambda_cond * condition_consistency_loss(C(fake))``
against the target's score interval; its gradient flows through C into G.
``--cond_mode score`` conditions on a normalized comparator score instead of
a one-hot (``pcgan_tpu/train.py:328-366``). Comparator pretraining
(``pcgan_tpu/train.py:626-751``) is at the end of this module.

Compute runs in ``--dtype`` (bf16 or f32); params, optimizer state and
losses are f32. Step randomness (target bins or scores, pool draws) comes
from the state's CPU ``torch.Generator``, which checkpoints carry, so a
resumed run draws what the uninterrupted one would have.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pcgan_tpu_torch.config import Config
from pcgan_tpu_torch.data.binning import (bin_to_onehot, bin_to_score,
                                          denormalize_score, normalize_score)
from pcgan_tpu_torch.models.comparator import (comparison_accuracy,
                                               comparison_loss,
                                               condition_consistency_loss)
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
    # the frozen comparator and its score anchors (on G's device): per-bin
    # score intervals for the cond loss, and the raw-score range (the
    # extreme bins' mean scores) that score mode normalizes by. Loaded from
    # the comparator bundle, never trained, not in the checkpoint.
    C: Optional[nn.Module] = None
    bin_lo: Optional[torch.Tensor] = None      # (n_bins,) f32
    bin_hi: Optional[torch.Tensor] = None
    score_min: Optional[torch.Tensor] = None   # 0-dim f32
    score_max: Optional[torch.Tensor] = None


def reject_unported_train(cfg: Config) -> None:
    """Every training flag this slice does not implement raises when it is
    set away from its default; none is ignored."""
    t, m, d, r, p = cfg.train, cfg.model, cfg.data, cfg.run, cfg.parallel
    if m.model not in ("pcgan", "comparator"):
        raise NotImplementedError(f"--model {m.model} not implemented "
                                  f"(pcgan | comparator)")
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
        "--remat": m.remat, "--no-no_dropout": not m.no_dropout,
        "--device_cache": d.device_cache,
        "--device_cache_sharded": d.device_cache_sharded,
        "--tb_logdir": bool(r.tb_logdir),
        "--profile_steps": r.profile_steps > 0,
        "--profile_server": r.profile_server > 0,
        "--debug_nans": r.debug_nans,
        "--compile_cache": bool(r.compile_cache),
        "--xla_opt": bool(r.xla_opt),
        # one card: a one-device data axis (1, or -1 for all of one)
        "--mesh_shape/--mesh_axes": (p.mesh_shape not in ((-1,), (1,))
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
                       steps_per_epoch: int = 1,
                       C: Optional[nn.Module] = None,
                       bin_anchors: Optional[Tuple] = None) -> TrainState:
    """Optimizers, lr schedules, pool and EMA around G and D (already on
    their device; the pool lives on G's device). ``generator`` is the
    step's CPU generator. ``C`` is the frozen comparator (moved to G's
    device, its parameters out of autograd) and ``bin_anchors`` its
    ``(lo, hi, bin_means or None)``; without means the score range stays
    (-1, 1), without anchors the intervals are [0, 0]
    (``pcgan_tpu/train.py:216-227``)."""
    t = cfg.train
    dev = next(G.parameters()).device
    s = cfg.data.crop_size
    nb = cfg.data.n_age_bins
    ema = ({n: p.detach().clone() for n, p in G.named_parameters()}
           if cfg.train.ema_decay > 0 else None)
    pool = image_pool.init_pool(cfg.train.pool_size,
                                (s, s, cfg.data.output_nc), cfg.cond_nc,
                                device=dev)
    if C is not None:
        C = C.to(dev).eval().requires_grad_(False)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32).to(dev)
    bin_lo = bin_hi = torch.zeros(nb, device=dev)
    score_min, score_max = f32(-1.0), f32(1.0)
    if bin_anchors is not None:
        bin_lo, bin_hi = f32(bin_anchors[0]), f32(bin_anchors[1])
        if len(bin_anchors) > 2 and bin_anchors[2] is not None:
            means = f32(bin_anchors[2])
            score_min, score_max = means[0], means[-1]
    return TrainState(
        step=0, G=G, D=D, opt_g=make_adam(G, t.beta1, t.beta2),
        opt_d=make_adam(D, t.beta1, t.beta2),
        sched_g=make_lr_schedule(cfg, steps_per_epoch),
        sched_d=make_lr_schedule(cfg, steps_per_epoch,
                                 t.lr_d if t.lr_d > 0 else None),
        pool=pool, generator=generator, ema=ema, C=C, bin_lo=bin_lo,
        bin_hi=bin_hi, score_min=score_min, score_max=score_max)


# --------------------------------------------------------------------------- #
# the step
# --------------------------------------------------------------------------- #


def make_train_step(cfg: Config, G: nn.Module, D: nn.Module,
                    C: Optional[nn.Module] = None) -> Callable:
    """The fused G/D step: ``train_step(state, batch) -> metrics`` updates
    ``state`` in place (params, optimizer moments, pool, EMA, step) and
    returns the 0-dim f32 losses on the device, under the JAX step's keys.
    With ``C`` (``state.C``) and ``--lambda_cond > 0`` the G loss carries
    the condition-consistency term.

    batch: {'image': (B,H,W,C) in [-1,1] on the device, 'bin': (B,) ints,
    optional 'target_bin': (B,) ints (else drawn uniformly); in score mode
    optional 'target_score': (B,) in [-1, 1] (else from 'target_bin', else
    drawn uniformly)}."""
    reject_unported_train(cfg)
    t = cfg.train
    nb = cfg.data.n_age_bins
    cd = DTYPES[cfg.model.dtype]
    use_cond_loss = t.lambda_cond > 0.0 and C is not None
    score_mode = cfg.model.cond_mode == "score"
    g_params = list(G.parameters())
    d_params = list(D.parameters())

    def conditions(state: TrainState, batch: Dict, real: torch.Tensor):
        """(cond_real, cond_target, cond_lo, cond_hi): G's conditions and
        the target's raw score interval for the cond loss."""
        bsz, dev = real.shape[0], real.device
        if not score_mode:
            if "target_bin" in batch:
                target_bin = torch.as_tensor(batch["target_bin"]).to(dev)
            else:
                target_bin = torch.randint(
                    0, nb, (bsz,), generator=state.generator).to(dev)
            return (bin_to_onehot(batch["bin"], nb, cd, dev),
                    bin_to_onehot(target_bin, nb, cd, dev),
                    state.bin_lo[target_bin], state.bin_hi[target_bin])
        if "target_score" in batch:
            s_target = torch.as_tensor(batch["target_score"]).float()
        elif "target_bin" in batch:
            s_target = bin_to_score(batch["target_bin"], nb)
        else:
            s_target = torch.rand(bsz, generator=state.generator) * 2.0 - 1.0
        s_target = s_target.to(dev)
        if C is not None:
            # the real image's own comparator score: label-free conditioning
            with torch.no_grad():
                mu_r, _ = C(real)
            s_real = normalize_score(mu_r, state.score_min, state.score_max)
        else:
            s_real = bin_to_score(batch["bin"], nb).to(dev)
        # score mode's interval is one point: the raw target score
        raw_target = denormalize_score(s_target, state.score_min,
                                       state.score_max)
        return (s_real[:, None].to(cd), s_target[:, None].to(cd),
                raw_target, raw_target)

    def train_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        real = batch["image"].to(cd)
        bsz = real.shape[0]
        dev = real.device
        cond_real, cond_target, cond_lo, cond_hi = conditions(state, batch,
                                                              real)

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
        if use_cond_loss:
            # C is frozen (no parameter of it is differentiated): the
            # gradient reaches G through fake only
            mu, log_var = C(fake)
            l_g_cond = condition_consistency_loss(mu, log_var, cond_lo,
                                                  cond_hi)
            g_loss = g_loss + t.lambda_cond * l_g_cond
        else:
            l_g_cond = torch.zeros((), device=dev)
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
                   "loss_G_cond": l_g_cond,
                   "loss_D": d_loss, "loss_D_real": l_d_real,
                   "loss_D_fake": l_d_fake}
        return {k: v.detach().float() for k, v in metrics.items()}

    return train_step


# --------------------------------------------------------------------------- #
# comparator pretraining (pcgan_tpu/train.py:626-751)
# --------------------------------------------------------------------------- #


@dataclass
class ComparatorState:
    step: int
    C: nn.Module
    opt: torch.optim.Adam
    sched: Callable[[int], float]       # lr by step count
    generator: torch.Generator          # CPU: crop offsets and flips


def create_comparator_state(cfg: Config, C: nn.Module,
                            generator: torch.Generator,
                            steps_per_epoch: int = 1) -> ComparatorState:
    """Adam over C (already on its device) at ``--lr`` on the
    ``--lr_policy`` schedule, as ``make_optimizer`` builds it in the JAX
    package; ``generator`` is the step's CPU generator."""
    t = cfg.train
    return ComparatorState(step=0, C=C, opt=make_adam(C, t.beta1, t.beta2),
                           sched=make_lr_schedule(cfg, steps_per_epoch),
                           generator=generator)


def make_comparator_step(cfg: Config, C: nn.Module) -> Callable:
    """One pretraining step on a pair batch {'image_a', 'image_b': (B,H,W,C)
    in [-1,1], 'label': (B,) (0: a older, 1: b older, 2: tie)}: both members
    in ONE 2B forward of the shared trunk, the Thurstone cross-entropy, one
    Adam step. Updates ``state`` in place and returns {'loss_cmp',
    'acc_cmp'} as 0-dim f32 tensors on the device."""
    reject_unported_train(cfg)
    margin = cfg.model.tie_margin
    cd = DTYPES[cfg.model.dtype]
    params = list(C.parameters())

    def step(state: ComparatorState, batch: Dict) -> Dict[str, torch.Tensor]:
        a = batch["image_a"].to(cd)
        bsz = a.shape[0]
        label = torch.as_tensor(batch["label"]).to(a.device)
        mu, log_var = C(torch.cat([a, batch["image_b"].to(cd)]))
        pair = (mu[:bsz], log_var[:bsz], mu[bsz:], log_var[bsz:], label,
                margin)
        loss = comparison_loss(*pair)
        with torch.no_grad():
            acc = comparison_accuracy(*pair)
        adam_step(state.opt, torch.autograd.grad(loss, params),
                  state.sched(state.step))
        state.step += 1
        return {"loss_cmp": loss.detach().float(), "acc_cmp": acc}

    return step


@torch.no_grad()
def _scores(C: nn.Module, images: torch.Tensor) -> np.ndarray:
    return C(images)[0].double().cpu().numpy()


def compute_bin_anchors(C: nn.Module, images: torch.Tensor, bins,
                        n_bins: int):
    """Per-bin comparator score intervals from real data: (lo, hi, means),
    each (n_bins,) f32 on the CPU. ``means`` are the per-bin mean scores;
    empty bins are filled by linear interpolation over the bin index (and
    edge extension), not by a spurious 0."""
    mu = _scores(C, images)
    b = np.asarray(bins)
    means = np.full(n_bins, np.nan)
    for k in range(n_bins):
        sel = b == k
        if sel.any():
            means[k] = mu[sel].mean()
    if np.isnan(means).all():
        raise ValueError("no anchor images fell into any bin")
    return _tile_anchor_intervals(means)


def compute_quantile_anchors(C: nn.Module, images: torch.Tensor,
                             n_bins: int):
    """Score anchors with no age labels: the images split into ``n_bins``
    equal-occupancy groups along the score axis, each bin anchored at its
    group's mean score."""
    mu = _scores(C, images)
    if mu.size == 0:
        raise ValueError("no images to fit score anchors on")
    groups = np.array_split(np.argsort(mu), n_bins)
    means = np.array([mu[g].mean() if len(g) else np.nan for g in groups])
    return _tile_anchor_intervals(means)


def _tile_anchor_intervals(means):
    """(n_bins,) per-bin mean scores (possibly with NaN gaps) -> (lo, hi,
    means): gap-filled sorted means, and intervals tiled at the midpoints
    between neighbours with +-1e30 at the ends. float64 on the host."""
    means = np.asarray(means, np.float64)
    idx = np.arange(means.shape[0], dtype=np.float64)
    ok = ~np.isnan(means)
    means = np.interp(idx, idx[ok], means[ok])   # fill gaps + extend edges
    means = np.sort(means)                # monotone for degenerate comparators
    mid = 0.5 * (means[1:] + means[:-1])
    lo = np.concatenate([[-1e30], mid])
    hi = np.concatenate([mid, [1e30]])
    return tuple(torch.from_numpy(v.astype(np.float32)) for v in (lo, hi, means))
