"""Plain reference of PC-GAN's training step (pix2pix's alternating
update, PC-GAN's frozen-comparator condition loss), in float32.

One step, on a global batch of rows from one or more ranks:

1. each rank draws, from its own CPU generator and in this order, the
   crop rows and columns (uniform in [0, load - crop]) and the mirror
   flips (u < 0.5) of its rows, then the target bins (uniform over the
   bins); the crops are made from the u8 canvases (``preprocess.py``);
2. G renders every real face at its target bin; the fakes, detached, go
   through each rank's share of the fake pool (below), which also draws
   from the rank's generator: a slot per row, then a swap bit (u < 0.5);
3. D's loss is 0.5 * (mean (D(real | bin) - 1)^2 + mean D(pool fake |
   pool bin)^2) (LSGAN), and Adam updates D;
4. against the updated D, G's loss is mean (D(fake | target) - 1)^2 +
   lambda_L1 * mean |G(real | bin) - real| + lambda_cond * mean NLL of
   the nearest in-interval score under the frozen comparator, and Adam
   updates G.

The pool (pix2pix's ImagePool in the batch form of the JAX package,
whose scatter the port copies): every row targets a slot, its next free
slot while fewer than P are filled, else the slot it drew. A row at a
free slot stores itself there and returns itself; another row whose swap
bit is set and whose slot was filled before this batch returns that
slot's image from before the batch and stores itself; any other row
returns itself and puts back the slot's image from before the batch. Of
several rows on one slot, the last one's value stays.

Adam: m and v moments, bias-corrected, eps outside the square root; the
learning rate is the schedule's constant first stretch.

The batch is processed in blocks of rows, every loss being a mean over
samples of per-sample terms (instance norm works per sample), so the
gradient of a block is its share of the whole batch's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import models
from portbench.reference.preprocess import age_bins, crops


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s step generator given rank 0's: rank 0
    keeps it; another rank takes a SeedSequence draw of (seed, rank)."""
    if rank == 0:
        return int(seed)
    state = np.random.SeedSequence([int(seed) % 2 ** 63, int(rank)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclass
class StepSpec:
    n_blocks: int
    n_layers_d: int
    cmp_n_down: int          # 0: no comparator
    n_bins: int
    load: int
    crop: int
    pool: int                # pool slots in all (each rank holds pool/ranks)
    lambda_l1: float
    lambda_cond: float
    lr: float
    beta1: float
    beta2: float
    eps: float = 1e-8
    block: int = 16          # rows per block


@dataclass
class Readings:
    """What the comparison reads: each step's losses, the norms of the
    first step's gradient (as Adam gets it) and of each parameter's change
    over the steps, by slice along the parameter's second dimension; the
    first update and the change themselves, on the host."""
    losses: List[Dict[str, float]] = field(default_factory=list)
    grad_norms: Dict[str, Dict[str, List[float]]] = field(
        default_factory=dict)
    change_norms: Dict[str, Dict[str, List[float]]] = field(
        default_factory=dict)
    first_update: Dict[str, Dict[str, torch.Tensor]] = field(
        default_factory=dict)
    change: Dict[str, Dict[str, torch.Tensor]] = field(default_factory=dict)


class _Adam:
    def __init__(self, params: Dict[str, torch.Tensor], spec: StepSpec):
        self.p, self.s = params, spec
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        s = self.s
        self.t += 1
        c1, c2 = 1 - s.beta1 ** self.t, 1 - s.beta2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(s.beta1).add_(g, alpha=1 - s.beta1)
            self.v[k].mul_(s.beta2).addcmul_(g, g, value=1 - s.beta2)
            m_hat, v_hat = self.m[k] / c1, self.v[k] / c2
            self.p[k].sub_(s.lr * m_hat / (v_hat.sqrt() + s.eps))


class _Pool:
    def __init__(self, size: int, crop: int, n_bins: int, device):
        self.imgs = torch.zeros((size, crop, crop, 3), device=device)
        self.conds = torch.zeros((size, n_bins), device=device)
        self.count = 0

    def query(self, fakes, conds, slots, swap):
        size, before = self.imgs.shape[0], self.count
        old_imgs, old_conds = self.imgs.clone(), self.conds.clone()
        out_i, out_c = fakes.clone(), conds.clone()
        for i in range(fakes.shape[0]):
            pos = before + i
            slot = pos if pos < size else int(slots[i])
            swaps = pos >= size and bool(swap[i]) and slot < before
            if swaps:
                out_i[i], out_c[i] = old_imgs[slot], old_conds[slot]
            if pos < size or swaps:
                self.imgs[slot], self.conds[slot] = fakes[i], conds[i]
            else:
                self.imgs[slot] = old_imgs[slot]
                self.conds[slot] = old_conds[slot]
        self.count = min(before + fakes.shape[0], size)
        return out_i, out_c


def _onehot(bins: torch.Tensor, n: int) -> torch.Tensor:
    return torch.eye(n, device=bins.device)[bins]


def _blocks(n: int, k: int):
    return [slice(i, min(n, i + k)) for i in range(0, n, k)]


def train_steps(spec: StepSpec, weights: Dict[str, Dict[str, torch.Tensor]],
                anchors: Optional[Tuple[torch.Tensor, torch.Tensor]],
                inputs: Sequence[Sequence[Tuple[np.ndarray, np.ndarray]]],
                seeds: Sequence[int], device, q=None,
                half_batch: bool = False) -> Readings:
    """Runs ``len(inputs)`` steps. ``inputs[t][r]`` is rank r's (u8
    canvases, ages) of step t; ``seeds[r]`` seeds rank r's generator;
    ``weights`` holds 'G', 'D' and, with a comparator, 'C' (float32, not
    modified); ``anchors`` the (lo, hi) score interval of each bin.
    ``q`` computes every layer in the control's lower precision;
    ``half_batch`` is a planted fault (each rank's step reads the first
    half of its rows)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    s = spec
    ranks = len(seeds)
    gens = [torch.Generator().manual_seed(int(x) % 2 ** 63) for x in seeds]
    g = {k: v.detach().float().clone() for k, v in weights["G"].items()}
    d = {k: v.detach().float().clone() for k, v in weights["D"].items()}
    c = ({k: v.detach().float() for k, v in weights["C"].items()}
         if s.cmp_n_down else None)
    g0 = {k: v.clone() for k, v in g.items()}
    d0 = {k: v.clone() for k, v in d.items()}
    opt_g, opt_d = _Adam(g, s), _Adam(d, s)
    pools = [_Pool(s.pool // ranks, s.crop, s.n_bins, device)
             for _ in range(ranks)]
    out = Readings()
    span = s.load - s.crop
    for t, step_in in enumerate(inputs):
        real, bins, target = [], [], []
        for r in range(ranks):
            imgs, ages = step_in[r]
            b = imgs.shape[0]
            cy = torch.randint(0, span + 1, (b,), generator=gens[r])
            cx = torch.randint(0, span + 1, (b,), generator=gens[r])
            fl = torch.rand((b,), generator=gens[r]) < 0.5
            real.append(crops(imgs, cy.numpy(), cx.numpy(), fl.numpy(),
                              s.load, s.crop, device))
            bins.append(torch.from_numpy(age_bins(ages, s.n_bins)))
            target.append(torch.randint(0, s.n_bins, (b,),
                                        generator=gens[r]))
        sizes = [x.shape[0] for x in real]
        real = torch.cat(real)
        bins = torch.cat(bins).to(device)
        target = torch.cat(target).to(device)
        cond_r = _onehot(bins, s.n_bins)
        cond_t = _onehot(target, s.n_bins)
        n = real.shape[0]
        with torch.no_grad():
            fake = torch.cat([models.generator(g, real[sl], cond_t[sl],
                                               s.n_blocks, q)
                              for sl in _blocks(n, s.block)])
        fake_d, cond_d, lo = [], [], 0
        for r in range(ranks):
            b = sizes[r]
            slots = torch.randint(0, pools[r].imgs.shape[0], (b,),
                                  generator=gens[r])
            swap = torch.rand(b, generator=gens[r]) < 0.5
            fi, fc = pools[r].query(fake[lo:lo + b], cond_t[lo:lo + b],
                                    slots, swap)
            fake_d.append(fi)
            cond_d.append(fc)
            lo += b
        fake_d, cond_d = torch.cat(fake_d), torch.cat(cond_d)
        keep = _kept_rows(sizes, half_batch, device)
        losses = {}
        # ---- D update ----------------------------------------------------
        d_grads = {k: torch.zeros_like(v) for k, v in d.items()}
        loss_d = 0.0
        rows = keep.numel()
        for sl in _blocks(rows, s.block):
            idx = keep[sl]
            dp = {k: v.requires_grad_(True) for k, v in d.items()}
            pr = models.discriminator(dp, real[idx], cond_r[idx],
                                      s.n_layers_d, q)
            pf = models.discriminator(dp, fake_d[idx], cond_d[idx],
                                      s.n_layers_d, q)
            per = pr[0].numel()
            part = 0.5 * (((pr - 1) ** 2).sum() + (pf ** 2).sum()) / (
                rows * per)
            gr = torch.autograd.grad(part, list(dp.values()))
            for k, gk in zip(dp, gr):
                d_grads[k] += gk
            loss_d += float(part.detach())
            for v in d.values():
                v.requires_grad_(False)
        losses["loss_D"] = loss_d
        opt_d.step(d_grads)
        # ---- G update against the updated D -------------------------------
        g_grads = {k: torch.zeros_like(v) for k, v in g.items()}
        loss_g = 0.0
        for sl in _blocks(rows, s.block):
            idx = keep[sl]
            k_rows = idx.numel()
            gp = {k: v.requires_grad_(True) for k, v in g.items()}
            o = models.generator(gp, torch.cat([real[idx], real[idx]]),
                                 torch.cat([cond_t[idx], cond_r[idx]]),
                                 s.n_blocks, q)
            fk, idt = o[:k_rows], o[k_rows:]
            pred = models.discriminator(d, fk, cond_t[idx], s.n_layers_d, q)
            part = ((pred - 1) ** 2).sum() / (rows * pred[0].numel())
            part = part + s.lambda_l1 * (idt - real[idx]).abs().sum() / (
                rows * real[0].numel())
            if c is not None and s.lambda_cond > 0:
                mu, lv = models.comparator(c, fk, s.cmp_n_down, q)
                tb = target[idx]
                part = part + s.lambda_cond * models.cond_loss(
                    mu, lv, anchors[0][tb], anchors[1][tb]).sum() / rows
            gr = torch.autograd.grad(part, list(gp.values()))
            for k, gk in zip(gp, gr):
                g_grads[k] += gk
            loss_g += float(part.detach())
            for v in g.values():
                v.requires_grad_(False)
        losses["loss_G"] = loss_g
        opt_g.step(g_grads)
        out.losses.append(losses)
        if t == 0:
            out.grad_norms = {"G": _norms(g_grads), "D": _norms(d_grads)}
            out.first_update = _changes(g, g0, d, d0)
    out.change = _changes(g, g0, d, d0)
    out.change_norms = {net: _norms(ds) for net, ds in out.change.items()}
    return out


def _changes(g, g0, d, d0) -> Dict[str, Dict[str, torch.Tensor]]:
    return {"G": {k: (g[k] - g0[k]).cpu() for k in g},
            "D": {k: (d[k] - d0[k]).cpu() for k in d}}


def _kept_rows(sizes, half_batch: bool, device) -> torch.Tensor:
    idx, lo = [], 0
    for b in sizes:
        idx.append(torch.arange(lo, lo + (b // 2 if half_batch else b)))
        lo += b
    return torch.cat(idx).to(device)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, List[float]]:
    """Each tensor's norms of its slices along the second dimension (its
    own norm when it has one)."""
    out = {}
    for k, v in tensors.items():
        v = v.detach().double()
        dims = [0] + list(range(2, v.dim())) if v.dim() > 1 else None
        out[k] = (torch.linalg.vector_norm(v, dim=dims).tolist()
                  if dims else [float(torch.linalg.vector_norm(v))])
    return out
