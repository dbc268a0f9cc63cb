"""Training core: one fused G/D step (counterpart of ``pcgan_tpu/train.py:56-618``).

One step holds both alternating updates of the reference's
``optimize_parameters``:

1. one 2B generator forward on ``[real, real]`` with ``[cond_target,
   cond_real]``; its graph is kept and back-propagated only after the D
   update (the torch form of the JAX step's ``jax.vjp`` reuse);
2. the D update on the detached fake, mixed through the fake pool with the
   pool's conditions, in ONE 2B D pass when the norm is per-sample (two
   sequential passes under ``--norm batch``):
   ``L_D = 0.5 * (gan(D(real), 1) + gan(D(pool(fake)), 0))``, plus
   ``lambda_gp * GP`` (``--gan_mode wgangp``, which drops the 0.5) and
   ``lambda_r1/2 * R1``;
3. the G update against the UPDATED D (sequential mode):
   ``L_G = gan(D(fake, cond_target), 1) + lambda_L1 * mean|idt - real|``
   ``+ lambda_cond * cond + lambda_feat * FM + lambda_vgg * VGG``, the L1
   term in f32. Only G's parameters are differentiated, so no G-loss
   gradient reaches D;
4. Adam with optax's semantics: the lr is the schedule at the optimizer's
   own pre-increment count, times ``lr_scale``; under ``--skip_nonfinite N``
   a non-finite gradient rejects the update (``optax.apply_if_finite``);
   the EMA twin with the ``(1+t)/(10+t)`` ramp when ``--ema_decay > 0``.

D's state beside its parameters (spectral norm's u/sigma, batch norm's
running stats) is the one its D-loss passes write; the penalties, the
feature targets and the G pass read the step's starting state and write
nothing (``StepParts``). ``--diff_augment`` augments every image D sees,
gated per sample by ADA's p under ``--ada_target``.

With a frozen comparator C (``--comparator_path``, ``--lambda_cond > 0``)
the G loss adds ``lambda_cond * condition_consistency_loss(C(fake))``
against the target's score interval; its gradient flows through C into G.
``--cond_mode score`` conditions on a normalized comparator score instead of
a one-hot (``pcgan_tpu/train.py:328-366``). Comparator pretraining
(``pcgan_tpu/train.py:626-751``) is at the end of this module;
``--grad_accum`` is ``accum.py``.

Compute runs in ``--dtype`` (bf16 or f32); params, optimizer state and
losses are f32. Step randomness (target bins or scores, pool draws,
augmentation, GP's interpolation) comes from the state's CPU
``torch.Generator`` and G's dropout masks from its device generator, which
checkpoints carry, so a resumed run draws what the uninterrupted one
would have.
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
from pcgan_tpu_torch.models.layers import (frozen_stats, load_stats_state,
                                           stats_state)
from pcgan_tpu_torch.models.registry import DTYPES
from pcgan_tpu_torch.models.vgg import vgg_perceptual_loss
from pcgan_tpu_torch.ops.diffaug import Augment, parse_policy
from pcgan_tpu_torch.ops.gan_loss import (feature_matching_loss, gan_loss,
                                          gradient_penalty, overfit_heuristic,
                                          r1_penalty, split_pred)
from pcgan_tpu_torch.utils import image_pool

# --------------------------------------------------------------------------- #
# LR schedules (the reference's --lr_policy)
# --------------------------------------------------------------------------- #


def make_lr_schedule(cfg: Config, steps_per_epoch: int,
                     base_lr: Optional[float] = None) -> Callable:
    """Per-step schedule reproducing the reference's per-epoch policies.

    linear: flat for ``niter`` epochs, then linear decay to 0 over
    ``niter_decay`` (reference lambda_rule). ``base_lr`` overrides the peak
    (the TTUR D optimizer, ``--lr_d``); the decay shape is shared."""
    t = cfg.train
    spe = max(1, steps_per_epoch)
    peak = t.lr if base_lr is None else base_lr
    if t.lr_policy not in ("linear", "step", "cosine", "constant", "plateau"):
        raise NotImplementedError(f"lr_policy [{t.lr_policy}]")

    def sched(step):
        """lr at ``step`` (an int -> float, or a count tensor -> a tensor on
        its device, so the fused optimizer reads it without a host sync)."""
        host = not isinstance(step, torch.Tensor)
        s = torch.as_tensor(step, dtype=torch.float64)
        epoch = torch.floor(s / spe) + t.epoch_count   # 1-based like the ref
        if t.lr_policy == "linear":
            f = 1.0 - torch.clamp(epoch - t.niter, min=0.0) / float(
                t.niter_decay + 1)
        elif t.lr_policy == "step":
            f = 0.1 ** torch.floor(torch.clamp(epoch - 1, min=0.0)
                                   / t.lr_decay_iters)
        elif t.lr_policy == "cosine":
            f = 0.5 * (1.0 + torch.cos(math.pi * (epoch - 1) / float(t.niter)))
        else:
            # constant; plateau's factor enters through lr_scale instead
            f = torch.ones_like(epoch)
        lr = peak * torch.clamp(f, 0.0, 1.0)
        return float(lr) if host else lr

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


def adam_count(opt: torch.optim.Adam):
    """The optimizer's own step count (optax's ``count``): 0 before the
    first update, else Adam's ``step`` tensor (on the parameters' device
    when fused), which a skipped update leaves unchanged."""
    st = opt.state.get(opt.param_groups[0]["params"][0])
    return st["step"] if st else 0


def adam_step(opt: torch.optim.Adam, grads: List[torch.Tensor], lr,
              found_inf: Optional[torch.Tensor] = None) -> None:
    """One step of ``opt`` with ``grads`` (one per parameter, in order) at
    learning rate ``lr`` (a float, or a 0-dim tensor); no ``.grad`` is left
    behind. ``found_inf`` (0-dim f32, 1 = reject) skips the update: params,
    moments and Adam's count all hold. Fused Adam takes it on the device
    (no host sync); on the CPU the flag is read."""
    group = opt.param_groups[0]
    fused = group["fused"]
    if isinstance(lr, torch.Tensor) and not fused:
        lr = float(lr)
    if found_inf is not None and not fused and bool(found_inf):
        return
    for p, g in zip(group["params"], grads, strict=True):
        p.grad = g
    group["lr"] = lr.float() if isinstance(lr, torch.Tensor) else lr
    if found_inf is not None and fused:
        opt.found_inf = found_inf
    try:
        opt.step()
    finally:
        opt.found_inf = None
        opt.zero_grad(set_to_none=True)


def init_skip_state(device) -> Dict[str, torch.Tensor]:
    """``optax.apply_if_finite``'s counters: consecutive non-finite updates,
    whether the last one was finite, and the running total."""
    return {"notfinite_count": torch.zeros((), dtype=torch.int32,
                                           device=device),
            "last_finite": torch.ones((), dtype=torch.bool, device=device),
            "total_notfinite": torch.zeros((), dtype=torch.int32,
                                           device=device)}


def check_finite(grads: List[torch.Tensor], skip: Dict[str, torch.Tensor],
                 max_consecutive: int) -> torch.Tensor:
    """``optax.apply_if_finite(inner, max_consecutive)`` on the device:
    updates ``skip`` in place and returns the reject flag (0-dim f32) for
    ``adam_step``: any inf/nan in ``grads`` rejects the update unless the
    consecutive count then exceeds ``max_consecutive`` (it passes through,
    so a persistent divergence surfaces). One multi-tensor kernel scans
    the gradients; nothing is read back."""
    found = torch.zeros((), device=grads[0].device)
    torch._amp_foreach_non_finite_check_and_unscale_(
        grads, found, torch.ones((), device=grads[0].device))
    finite = found == 0
    one = torch.ones((), dtype=torch.int32, device=found.device)
    count = torch.where(finite, torch.zeros_like(one),
                        skip["notfinite_count"] + one)
    skip["notfinite_count"] = count
    skip["last_finite"] = finite
    skip["total_notfinite"] = skip["total_notfinite"] + (~finite).int()
    return ((~finite) & (count <= max_consecutive)).float()


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of every entry."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


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
    sched_g: Callable                   # lr by the optimizer's count
    sched_d: Callable                   # --lr_d (TTUR) or --lr, same decay
    pool: image_pool.PoolState
    generator: torch.Generator          # CPU: target bins, pool, aug, GP
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
    # G's dropout masks (--no-no_dropout), on G's device
    dropout_generator: Optional[torch.Generator] = None
    aug_p: Optional[torch.Tensor] = None       # ADA probability, 0-dim f32
    # --skip_nonfinite counters of each optimizer (init_skip_state)
    skip_g: Optional[Dict[str, torch.Tensor]] = None
    skip_d: Optional[Dict[str, torch.Tensor]] = None
    vgg: Optional[nn.Module] = None     # frozen VGG19 trunk (--lambda_vgg)


# the XLA compiler's own flags: nothing in PyTorch takes them
_XLA_ONLY = {
    "--profile_server": "starts jax.profiler's live server; use "
                        "--profile_steps for a torch.profiler trace",
    "--compile_cache": "is JAX's persistent compilation cache",
    "--xla_opt": "sets XLA compiler options",
}


def reject_unported_train(cfg: Config) -> None:
    """Every training flag the port does not implement raises when it is
    set away from its default; none is ignored. The XLA-only flags raise
    for good."""
    t, m, d, r, p = cfg.train, cfg.model, cfg.data, cfg.run, cfg.parallel
    if m.model not in ("pcgan", "comparator"):
        raise NotImplementedError(f"--model {m.model} not implemented "
                                  f"(pcgan | comparator)")
    for flag, on in (("--profile_server", r.profile_server > 0),
                     ("--compile_cache", bool(r.compile_cache)),
                     ("--xla_opt", bool(r.xla_opt))):
        if on:
            raise NotImplementedError(
                f"{flag} {_XLA_ONLY[flag]}: an XLA-only flag with no "
                f"counterpart in pcgan_tpu_torch")
    off = {
        "--device_cache": d.device_cache,
        "--device_cache_sharded": d.device_cache_sharded,
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
                       bin_anchors: Optional[Tuple] = None,
                       vgg: Optional[nn.Module] = None) -> TrainState:
    """Optimizers, lr schedules, pool and EMA around G and D (already on
    their device; the pool lives on G's device). ``generator`` is the
    step's CPU generator. ``C`` is the frozen comparator (moved to G's
    device, its parameters out of autograd) and ``bin_anchors`` its
    ``(lo, hi, bin_means or None)``; without means the score range stays
    (-1, 1), without anchors the intervals are [0, 0]
    (``pcgan_tpu/train.py:216-227``). ``vgg`` is the frozen VGG19 trunk
    ``--lambda_vgg`` needs."""
    t = cfg.train
    if t.lambda_vgg > 0 and vgg is None:
        raise ValueError("--lambda_vgg > 0 needs VGG trunk variables: pass "
                         "--vgg_path <torchvision vgg19 .pth> (or 'random' "
                         "for a smoke run)")
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
    if vgg is not None:
        vgg = vgg.to(dev).eval().requires_grad_(False)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32).to(dev)
    bin_lo = bin_hi = torch.zeros(nb, device=dev)
    score_min, score_max = f32(-1.0), f32(1.0)
    if bin_anchors is not None:
        bin_lo, bin_hi = f32(bin_anchors[0]), f32(bin_anchors[1])
        if len(bin_anchors) > 2 and bin_anchors[2] is not None:
            means = f32(bin_anchors[2])
            score_min, score_max = means[0], means[-1]
    skip = t.skip_nonfinite > 0
    return TrainState(
        step=0, G=G, D=D, opt_g=make_adam(G, t.beta1, t.beta2),
        opt_d=make_adam(D, t.beta1, t.beta2),
        sched_g=make_lr_schedule(cfg, steps_per_epoch),
        sched_d=make_lr_schedule(cfg, steps_per_epoch,
                                 t.lr_d if t.lr_d > 0 else None),
        pool=pool, generator=generator, ema=ema, C=C, bin_lo=bin_lo,
        bin_hi=bin_hi, score_min=score_min, score_max=score_max,
        dropout_generator=(None if cfg.model.no_dropout else
                           torch.Generator(device=dev).manual_seed(
                               t.seed + 3)),
        # ADA starts un-augmented (p=0) and ramps up only if D overfits
        aug_p=f32(0.0) if t.ada_target > 0 else None,
        skip_g=init_skip_state(dev) if skip else None,
        skip_d=init_skip_state(dev) if skip else None, vgg=vgg)


# --------------------------------------------------------------------------- #
# the step
# --------------------------------------------------------------------------- #


def gp_eps(generator: torch.Generator, bsz: int) -> torch.Tensor:
    """WGAN-GP's interpolation weights: (B,1,1,1) U[0, 1) f32 draws."""
    return torch.rand((bsz, 1, 1, 1), generator=generator)


class StepParts:
    """The loss plumbing the fused step (``make_train_step``) and the
    accumulated one (``accum.make_accum_train_step``) share: conditions,
    the D loss with its penalties and the G loss, with JAX's D-state rule.
    The D state (spectral norm's u/sigma, batch norm's running stats) that
    persists is the one the D-loss passes write; the penalties, the
    feature targets and the G pass read the state they start from and
    write nothing."""

    def __init__(self, cfg: Config, G: nn.Module, D: nn.Module,
                 C: Optional[nn.Module] = None):
        reject_unported_train(cfg)
        t = cfg.train
        self.cfg, self.t, self.G, self.D, self.C = cfg, t, G, D, C
        self.nb = cfg.data.n_age_bins
        self.cd = DTYPES[cfg.model.dtype]
        self.use_cond_loss = t.lambda_cond > 0.0 and C is not None
        self.score_mode = cfg.model.cond_mode == "score"
        # batch norm: real and fake take two sequential D passes, the
        # running stats chained through both; every other norm is
        # per-sample, so both halves share ONE 2B pass
        self.fuse_d = cfg.model.norm != "batch"
        self.use_ada = t.ada_target > 0
        if self.use_ada:
            if not parse_policy(t.diff_augment):
                raise ValueError("--ada_target needs a non-empty "
                                 "--diff_augment policy to adapt (e.g. "
                                 "color,translation,cutout)")
            if t.gan_mode == "wgangp":
                # a critic's output level is translation-invariant, so
                # sign(D(real)) measures drift, not overfitting
                raise ValueError(
                    "--ada_target is undefined for --gan_mode wgangp (the "
                    "critic's output level is translation-invariant, so the "
                    "overfitting heuristic r_t measures drift, not "
                    "overfitting); use lsgan/vanilla/hinge, or plain "
                    "--diff_augment without ADA")
        self.aug = Augment(t.diff_augment, ada=self.use_ada)
        self.d_params = list(D.parameters())
        self.g_params = list(G.parameters())

    def augment(self, state: TrainState, x: torch.Tensor, p, draws=None):
        """(augmented x, the draws): a fresh draw from the state's
        generator unless ``draws`` are given."""
        if draws is None:
            draws = self.aug.draw(state.generator, x)
        return self.aug.apply(x, draws, p), draws

    def conditions(self, state: TrainState, batch: Dict,
                   real: torch.Tensor):
        """(cond_real, cond_target, cond_lo, cond_hi): G's conditions and
        the target's raw score interval for the cond loss."""
        nb, cd, C = self.nb, self.cd, self.C
        bsz, dev = real.shape[0], real.device
        if not self.score_mode:
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

    def d_loss(self, state: TrainState, real, fake_det, fake_d, cond_real,
               cond_target, cond_fake_d, p):
        """The D loss of one (micro)batch: (loss, l_real, l_fake, r1, r_t).
        D's state moves by the D-loss passes only; GP and R1 read the state
        this call started from."""
        t, D, cd = self.t, self.D, self.cd
        bsz = real.shape[0]
        start = stats_state(D)
        if self.fuse_d:
            xx = torch.cat([real, fake_d.to(cd)])
            cc = torch.cat([cond_real, cond_fake_d.to(cd)])
            if self.aug:     # per-sample draws across the whole 2B batch
                xx, _ = self.augment(state, xx, p)
            pred_real, pred_fake = split_pred(D(xx, cc), bsz)
            r1_real = xx[:bsz]
        else:
            real_d, fake_dd = real, fake_d.to(cd)
            if self.aug:
                real_d, _ = self.augment(state, real_d, p)
                fake_dd, _ = self.augment(state, fake_dd, p)
            pred_real = D(real_d, cond_real)
            pred_fake = D(fake_dd, cond_fake_d.to(cd))
            r1_real = real_d
        l_real = gan_loss(pred_real, True, t.gan_mode)
        l_fake = gan_loss(pred_fake, False, t.gan_mode)
        loss = 0.5 * (l_real + l_fake)
        end = stats_state(D)
        load_stats_state(D, start)
        with frozen_stats(D):
            if t.gan_mode == "wgangp":
                # real <-> CURRENT fake (not the pool mix); with DiffAugment
                # both endpoints are augmented, then interpolated
                gp_real, gp_fake = real, fake_det.to(cd)
                if self.aug:
                    gp_real, _ = self.augment(state, gp_real, p)
                    gp_fake, _ = self.augment(state, gp_fake, p)
                eps = gp_eps(state.generator, bsz).to(real.device)
                gp = gradient_penalty(D, gp_real, gp_fake, cond_target, eps)
                loss = l_real + l_fake + t.lambda_gp * gp
            r1 = torch.zeros((), device=real.device)
            if t.lambda_r1 > 0:
                # on the same (augmented) real view D just scored
                r1 = r1_penalty(D, r1_real, cond_real)
                loss = loss + (0.5 * t.lambda_r1) * r1
        load_stats_state(D, end)
        with torch.no_grad():
            # ADA's overfitting signal from the real view D just scored
            rt = (overfit_heuristic(pred_real, t.gan_mode) if self.use_ada
                  else torch.zeros((), device=real.device))
        return loss, l_real, l_fake, r1, rt

    def g_loss(self, state: TrainState, out, real, cond_real, cond_target,
               cond_lo, cond_hi, p):
        """The G loss of one (micro)batch against the current D, which must
        hold the step's starting state (read, not written): (loss, l_gan,
        l_l1, l_cond, l_feat, l_vgg)."""
        t, D = self.t, self.D
        bsz = real.shape[0]
        fake, idt = out[:bsz], out[bsz:]
        zero = torch.zeros((), device=real.device)
        with frozen_stats(D):
            draws = self.aug.draw(state.generator, fake) if self.aug else None
            if t.lambda_feat > 0:
                # D's features on the real batch are the constant targets;
                # the real view takes the same augmentation draw as the fake
                real_fm = (self.aug.apply(real, draws, p) if self.aug
                           else real)
                with torch.no_grad():
                    _, real_feats = D(real_fm, cond_real,
                                      return_features=True)
            fake_for_d = self.aug.apply(fake, draws, p) if self.aug else fake
            if t.lambda_feat > 0:
                pred, fake_feats = D(fake_for_d, cond_target,
                                     return_features=True)
                l_feat = feature_matching_loss(fake_feats, real_feats)
            else:
                pred = D(fake_for_d, cond_target)
                l_feat = zero
        l_gan = gan_loss(pred, True, t.gan_mode, for_discriminator=False)
        l_l1 = torch.mean(torch.abs(idt.float() - real.float()))
        l_cond = zero
        if self.use_cond_loss:
            # C is frozen: the gradient reaches G through fake only
            mu, log_var = self.C(fake)
            l_cond = condition_consistency_loss(mu, log_var, cond_lo,
                                                cond_hi)
        l_vgg = (vgg_perceptual_loss(state.vgg, idt, real)
                 if t.lambda_vgg > 0 else zero)
        loss = (l_gan + t.lambda_L1 * l_l1 + t.lambda_cond * l_cond
                + t.lambda_feat * l_feat + t.lambda_vgg * l_vgg)
        return loss, l_gan, l_l1, l_cond, l_feat, l_vgg

    def update(self, state: TrainState, which: str, grads) -> None:
        """One Adam step of G or D at the schedule's lr for the optimizer's
        own count, under ``--skip_nonfinite``'s check when it is set."""
        opt, sched, skip = ((state.opt_g, state.sched_g, state.skip_g)
                            if which == "G" else
                            (state.opt_d, state.sched_d, state.skip_d))
        found_inf = None
        if skip is not None:
            found_inf = check_finite(grads, skip, self.t.skip_nonfinite)
            count = adam_count(opt)
        else:
            count = state.step      # == the count when no update is skipped
        adam_step(opt, grads, sched(count) * state.lr_scale, found_inf)

    def ada_update(self, state: TrainState, rt: torch.Tensor,
                   n_images: int) -> None:
        """ADA's controller: p moves by sign(r_t - target) * n_images /
        (ada_kimg * 1000), clipped to [0, 1]."""
        t = self.t
        adj = torch.sign(rt - t.ada_target) * (n_images
                                               / (t.ada_kimg * 1000.0))
        state.aug_p = torch.clamp(state.aug_p + adj, 0.0, 1.0)

    def ema_update(self, state: TrainState) -> None:
        """The EMA twin with the ramped decay min(d, (1+t)/(10+t)); a
        skipped G update holds it (decay 1)."""
        t = self.t
        d = min(t.ema_decay, (1.0 + state.step) / (10.0 + state.step))
        ema = list(state.ema.values())
        with torch.no_grad():
            if state.skip_g is None:
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, self.g_params, alpha=1.0 - d)
            else:
                dt = torch.where(state.skip_g["last_finite"],
                                 torch.tensor(d, device=ema[0].device),
                                 torch.ones((), device=ema[0].device))
                torch._foreach_mul_(ema, dt)
                torch._foreach_add_(ema, torch._foreach_mul(self.g_params,
                                                            1.0 - dt))

    def metrics(self, state, losses: Dict[str, torch.Tensor], g_grads,
                d_grads, rt) -> Dict[str, torch.Tensor]:
        """The step's metrics under the JAX step's keys, 0-dim f32."""
        t = self.t
        m = dict(losses)
        if t.lambda_r1 <= 0:
            del m["loss_D_r1"]
        if t.lambda_feat <= 0:
            del m["loss_G_feat"]
        if t.lambda_vgg <= 0:
            del m["loss_G_vgg"]
        if state.skip_g is not None:
            m["notfinite_G"] = state.skip_g["total_notfinite"]
            m["notfinite_D"] = state.skip_d["total_notfinite"]
        if self.use_ada:
            m["ada_p"] = state.aug_p
            m["ada_rt"] = rt
        if t.log_grad_norm:
            m["grad_norm_G"] = global_norm(g_grads)
            m["grad_norm_D"] = global_norm(d_grads)
        return {k: v.detach().float() for k, v in m.items()}


def make_train_step(cfg: Config, G: nn.Module, D: nn.Module,
                    C: Optional[nn.Module] = None) -> Callable:
    """The fused G/D step: ``train_step(state, batch) -> metrics`` updates
    ``state`` in place (params, optimizer moments, norm and spectral-norm
    state, pool, EMA, ADA's p, the skip counters, step) and returns the
    0-dim f32 metrics on the device, under the JAX step's keys. With ``C``
    (``state.C``) and ``--lambda_cond > 0`` the G loss carries the
    condition-consistency term. ``--grad_accum > 1`` returns
    ``accum.make_accum_train_step``'s step instead.

    batch: {'image': (B,H,W,C) in [-1,1] on the device, 'bin': (B,) ints,
    optional 'target_bin': (B,) ints (else drawn uniformly); in score mode
    optional 'target_score': (B,) in [-1, 1] (else from 'target_bin', else
    drawn uniformly)}."""
    if cfg.train.grad_accum != 1:
        from pcgan_tpu_torch.accum import make_accum_train_step
        return make_accum_train_step(cfg, G, D, C)
    parts = StepParts(cfg, G, D, C)
    t = cfg.train

    def train_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        real = batch["image"].to(parts.cd)
        bsz = real.shape[0]
        cond_real, cond_target, cond_lo, cond_hi = parts.conditions(
            state, batch, real)
        p = state.aug_p          # this step augments at the step-start p

        # ---- one 2B generator forward, its graph kept for the G update ----
        out = G(torch.cat([real, real]), torch.cat([cond_target, cond_real]),
                generator=state.dropout_generator)
        fake_det = out[:bsz].detach()

        # ---- D update: detached fake, pool-mixed --------------------------
        state.pool, fake_d, cond_fake_d = image_pool.query(
            state.pool, fake_det, cond_target, state.generator)
        d_start = stats_state(D)
        d_loss, l_d_real, l_d_fake, l_d_r1, rt = parts.d_loss(
            state, real, fake_det, fake_d, cond_real, cond_target,
            cond_fake_d, p)
        d_grads = list(torch.autograd.grad(d_loss, parts.d_params))
        parts.update(state, "D", d_grads)
        if parts.use_ada:
            parts.ada_update(state, rt, bsz)

        # ---- G update against the updated D (sequential reference mode),
        # which reads the step's starting D state ----------------------------
        d_new = stats_state(D)
        load_stats_state(D, d_start)
        g_loss, l_g_gan, l_g_l1, l_g_cond, l_g_feat, l_g_vgg = parts.g_loss(
            state, out, real, cond_real, cond_target, cond_lo, cond_hi, p)
        load_stats_state(D, d_new)
        g_grads = list(torch.autograd.grad(g_loss, parts.g_params))
        parts.update(state, "G", g_grads)
        if state.ema is not None:
            parts.ema_update(state)
        state.step += 1
        return parts.metrics(state, {
            "loss_G": g_loss, "loss_G_GAN": l_g_gan, "loss_G_L1": l_g_l1,
            "loss_G_cond": l_g_cond, "loss_D": d_loss,
            "loss_D_real": l_d_real, "loss_D_fake": l_d_fake,
            "loss_D_r1": l_d_r1, "loss_G_feat": l_g_feat,
            "loss_G_vgg": l_g_vgg}, g_grads, d_grads, rt)

    return train_step


# --------------------------------------------------------------------------- #
# comparator pretraining (pcgan_tpu/train.py:626-751)
# --------------------------------------------------------------------------- #


@dataclass
class ComparatorState:
    step: int
    C: nn.Module
    opt: torch.optim.Adam
    sched: Callable                     # lr by the optimizer's count
    generator: torch.Generator          # CPU: crop offsets and flips
    skip: Optional[Dict[str, torch.Tensor]] = None  # --skip_nonfinite


def create_comparator_state(cfg: Config, C: nn.Module,
                            generator: torch.Generator,
                            steps_per_epoch: int = 1) -> ComparatorState:
    """Adam over C (already on its device) at ``--lr`` on the
    ``--lr_policy`` schedule, as ``make_optimizer`` builds it in the JAX
    package; ``generator`` is the step's CPU generator."""
    t = cfg.train
    dev = next(C.parameters()).device
    return ComparatorState(step=0, C=C, opt=make_adam(C, t.beta1, t.beta2),
                           sched=make_lr_schedule(cfg, steps_per_epoch),
                           generator=generator,
                           skip=(init_skip_state(dev)
                                 if t.skip_nonfinite > 0 else None))


def make_comparator_step(cfg: Config, C: nn.Module) -> Callable:
    """One pretraining step on a pair batch {'image_a', 'image_b': (B,H,W,C)
    in [-1,1], 'label': (B,) (0: a older, 1: b older, 2: tie)}: both members
    in ONE 2B forward of the shared trunk, the Thurstone cross-entropy, one
    Adam step (skipped under ``--skip_nonfinite``'s rule). Updates
    ``state`` in place and returns {'loss_cmp', 'acc_cmp'} as 0-dim f32
    tensors on the device."""
    reject_unported_train(cfg)
    margin = cfg.model.tie_margin
    skip_n = cfg.train.skip_nonfinite
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
        grads = list(torch.autograd.grad(loss, params))
        found_inf, count = None, state.step
        if state.skip is not None:
            found_inf = check_finite(grads, state.skip, skip_n)
            count = adam_count(state.opt)
        adam_step(state.opt, grads, state.sched(count), found_inf)
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
