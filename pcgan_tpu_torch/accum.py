"""Gradient-accumulated train step (counterpart of ``pcgan_tpu/accum.py:47-435``).

``--grad_accum N`` splits the batch into N equal microbatches and applies
ONE optimizer update per net on the averaged gradients: batch_size
optimizer semantics at batch_size/N activation memory. Every per-sample
loss is a mean, so the average of equal microbatch gradients is the
full-batch gradient and the step matches ``train.make_train_step`` on the
same batch up to float association (``--norm batch`` aside, whose batch
statistics are per microbatch).

The reference's sequential semantics take two phases:

- phase A runs the microbatches for D's gradients: G forwards without a
  graph, the fake pool and the norm state thread through the microbatches;
  then D updates once;
- phase B replays the same microbatches (the same conditions and the same
  dropout masks, from the restored device generator) for G's gradients
  against the UPDATED D, which reads the step's starting D state; then G
  updates once. G's forward is recomputed rather than kept: keeping N
  graphs would cost the memory this mode exists to save.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from pcgan_tpu_torch.config import Config
from pcgan_tpu_torch.models.layers import load_stats_state, stats_state
from pcgan_tpu_torch.train import StepParts, TrainState, reduce_span
from pcgan_tpu_torch.utils.tracing import span


def make_accum_train_step(cfg: Config, G: nn.Module, D: nn.Module,
                          C: Optional[nn.Module] = None, group=None,
                          parts: Optional[StepParts] = None) -> Callable:
    """Drop-in for ``train.make_train_step`` when ``--grad_accum`` > 1
    (same state, same batch, same metrics). ``group`` averages over the
    data axis where the JAX step calls ``pmean``: the accumulated D and G
    gradients, the microbatch-mean r_t, the metrics and the norm state
    (``pcgan_tpu/accum.py:276, 284-285, 373, 411, 424-426``). ``parts``
    replaces the step's ``StepParts`` (the sharded-state step's)."""
    accum = int(cfg.train.grad_accum)
    if accum < 2:
        raise ValueError("make_accum_train_step needs grad_accum >= 2; use "
                         "train.make_train_step otherwise")
    parts = parts or StepParts(cfg, G, D, C, group)

    def train_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        big = batch["image"].shape[0]
        if big % accum:
            raise ValueError(f"(per-device) batch {big} must be divisible "
                             f"by --grad_accum {accum}")
        bsz = big // accum
        parts.begin(bsz)
        mbs = [{k: v[i * bsz:(i + 1) * bsz] for k, v in batch.items()}
               for i in range(accum)]
        p = state.aug_p
        drop_gen = state.dropout_generator
        drop_start = None if drop_gen is None else drop_gen.get_state()
        g_start, d_start = stats_state(G), stats_state(D)

        # ---- phase A: D gradients over the microbatches --------------------
        conds, d_sum, sums = [], None, torch.zeros(5, device=batch[
            "image"].device)
        for mb in mbs:
            real = mb["image"].to(parts.cd)
            c = parts.conditions(state, mb, real)
            conds.append(c)
            cond_real, cond_target = c[0], c[1]
            with span("step/g_forward"), torch.no_grad():
                out = parts.g_forward(state, torch.cat([real, real]),
                                      torch.cat([cond_target, cond_real]))
            fake_det = out[:bsz]
            with span("step/pool"):
                fake_d, cond_fake_d = parts.pool_query(state, fake_det,
                                                       cond_target)
            with span("step/d_loss"):
                losses = parts.d_loss(state, real, fake_det, fake_d,
                                      cond_real, cond_target, cond_fake_d, p)
            with span("step/d_backward"):
                grads = torch.autograd.grad(losses[0], parts.d_params)
            if d_sum is None:
                d_sum = list(grads)
            else:
                torch._foreach_add_(d_sum, grads)
            sums += torch.stack([v.detach().float() for v in losses])
        d_grads = torch._foreach_div(d_sum, float(accum))
        d_mean = sums / accum
        # the microbatch-mean r_t (d_mean[4]) rides in D's collective
        with reduce_span(parts, "step/d_reduce"):
            d_grads, rt = parts.reduce_grads("D", list(d_grads), d_mean[4])
        with span("step/d_adam"):
            parts.update(state, "D", d_grads)
        if parts.use_ada:
            # the microbatch-mean r_t is the full batch's
            parts.ada_update(state, rt, big * parts.world)

        # ---- phase B: G gradients against the updated D --------------------
        g_new, d_new = stats_state(G), stats_state(D)
        load_stats_state(G, g_start)
        load_stats_state(D, d_start)
        if drop_gen is not None:
            drop_gen.set_state(drop_start)
        g_sum, gsums = None, torch.zeros(6, device=d_mean.device)
        for mb, (cond_real, cond_target, cond_lo, cond_hi) in zip(mbs,
                                                                   conds):
            real = mb["image"].to(parts.cd)
            with span("step/g_forward"):
                out = parts.g_forward(state, torch.cat([real, real]),
                                      torch.cat([cond_target, cond_real]))
            with span("step/g_loss"):
                losses = parts.g_loss(state, out, real, cond_real,
                                      cond_target, cond_lo, cond_hi, p)
            with span("step/g_backward"):
                grads = torch.autograd.grad(losses[0], parts.g_params)
            if g_sum is None:
                g_sum = list(grads)
            else:
                torch._foreach_add_(g_sum, grads)
            gsums += torch.stack([v.detach().float() for v in losses])
        load_stats_state(G, g_new)
        load_stats_state(D, d_new)
        g_grads = list(torch._foreach_div(g_sum, float(accum)))
        with reduce_span(parts, "step/g_reduce"):
            g_grads, _ = parts.reduce_grads("G", g_grads)
        with span("step/g_adam"):
            parts.update(state, "G", g_grads)
        if state.ema is not None:
            with span("step/ema"):
                parts.ema_update(state)
        state.step += 1
        parts.sync_stats()
        g_mean = gsums / accum
        names_g = ("loss_G", "loss_G_GAN", "loss_G_L1", "loss_G_cond",
                   "loss_G_feat", "loss_G_vgg")
        names_d = ("loss_D", "loss_D_real", "loss_D_fake", "loss_D_r1")
        losses = {**dict(zip(names_g, g_mean)), **dict(zip(names_d, d_mean))}
        with span("step/metrics"):
            return parts.metrics(state, losses, g_grads, d_grads, rt)

    return train_step
