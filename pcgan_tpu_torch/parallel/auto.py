"""Sharded training state across cards (counterpart of
``pcgan_tpu/parallel/auto.py:46-186``): the ``model`` axis, ``--zero1``
and the ``spatial`` axis (``parallel/spatial.py``).

JAX's GSPMD step is the one-device step over the global batch, its state
placed by one per-leaf rule (``state_shardings``):

- ``model``: G's and D's parameters, both Adam trees and the EMA twin
  shard their output-channel dim (JAX's last) over the model axis when it
  divides;
- ``--zero1``: the Adam trees also shard one further dim over ``data``,
  the first that divides searching from JAX's last dim down to its first;
- every other leaf (the 3- and 13-channel edges, the pool, scalars) is
  replicated.

JAX's dims map to the port's layout as ``convert.py`` maps the tensors:
a conv's HWIO kernel is the torch weight's (O, I, H, W), a transposed
conv's (I, O, H, W), so the output channels are dim 0 of a conv weight
and dim 1 of a transposed one.

In PyTorch the collectives are written out around the fused step
(``train.make_train_step``, ``accum.make_accum_train_step`` under
``--grad_accum``). Per step, on each rank:

1. gather on use: each model-sharded parameter is all-gathered over the
   model group (one flat buffer a network) into the modules;
2. the forward and backward run on the full parameters over the rank's
   rows, those of its data coordinate (``parallel/rows.py``: every
   per-row draw is made for the global batch from generators seeded
   alike, and the fake pool is global: the fakes are all-gathered over the
   data group and every rank runs the pool's query on the global batch);
   ``--norm batch`` reduces its moments over the data group;
3. the gradients' model shards are averaged over the data group, or, under
   ``--zero1``, reduce-scattered over it along the leaf's data dim;
4. one ``torch.optim.Adam`` step on this rank's shard tensors and moments,
   then (``--zero1``) the updated shards all-gathered over the data group,
   and the EMA twin's shard updated; D is gathered again for the G pass;
5. the full copies of the model-sharded parameters are dropped.

Under a spatial axis > 1 the step runs inside ``spatial.banded``: each
rank computes on its band of rows of every image, B1 writes only that
band, the pool keeps each image's band, each loss is the band's share,
and the gradients are summed over the spatial group before step 3.

So each rank keeps params/m + Adam/(m*d under ``--zero1``, else m) +
EMA/m of the divisible leaves. An N-rank step equals the one-device
step on the global batch up to f32 summation order. The collectives are
chosen by the group's backend: NCCL's ``all_gather_into_tensor`` and
``reduce_scatter_tensor``; gloo's list ``all_gather`` and, since gloo
cannot reduce-scatter a CUDA tensor, an ``all_reduce`` of which the rank
keeps its slice.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from pcgan_tpu_torch.parallel.axis import (COLLECTIVE_MS,  # noqa: F401
                                           COLLECTIVES, TIMING)
from pcgan_tpu_torch.parallel.axis import Axis as _Axis
from pcgan_tpu_torch.parallel.axis import record as _record
from pcgan_tpu_torch.parallel import spatial
from pcgan_tpu_torch.parallel.mesh import (DATA, MODEL, SPATIAL, DataMesh,
                                           all_reduce_flat)
from pcgan_tpu_torch.parallel.rows import Rows
from pcgan_tpu_torch.train import (StepParts, adam_count, adam_step,
                                   check_finite, make_train_step)
from pcgan_tpu_torch.utils import image_pool, tracing

# --------------------------------------------------------------------------- #
# the per-leaf rule
# --------------------------------------------------------------------------- #


def jax_dims(module: nn.Module) -> Dict[str, tuple]:
    """{parameter name: the torch dim of each of JAX's dims}: a conv's
    (H, W, I, O) kernel is the torch (O, I, H, W) weight, a transposed
    conv's is (I, O, H, W), a Dense kernel (in, out) is ``Linear``'s (out,
    in); vectors and scalars keep their dims."""
    from pcgan_tpu_torch.models.layers import TorchConv, TorchConvTranspose
    out = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if p.dim() == 4 and isinstance(m, TorchConv):
                out[name] = (2, 3, 1, 0)
            elif p.dim() == 4 and isinstance(m, TorchConvTranspose):
                out[name] = (2, 3, 0, 1)
            elif p.dim() == 2 and isinstance(m, nn.Linear):
                out[name] = (1, 0)
            elif p.dim() <= 1:
                out[name] = tuple(range(p.dim()))
            else:
                raise ValueError(f"no JAX layout known for {name} "
                                 f"({type(m).__name__}, {tuple(p.shape)})")
    return out


def leaf_spec(jshape: Sequence[int], n_model: int, n_data: int,
              zero1: bool, opt_leaf: bool) -> List[Optional[str]]:
    """JAX's ``state_shardings`` leaf rule over a leaf of JAX shape
    ``jshape``: the axis name (or None) of each of its dims."""
    spec: List[Optional[str]] = [None] * len(jshape)
    model_dim = None
    if n_model > 1 and jshape and jshape[-1] >= n_model \
            and jshape[-1] % n_model == 0:
        spec[-1] = MODEL
        model_dim = len(jshape) - 1
    if zero1 and n_data > 1 and opt_leaf:
        for d in range(len(jshape) - 1, -1, -1):
            if d != model_dim and jshape[d] >= n_data \
                    and jshape[d] % n_data == 0:
                spec[d] = DATA
                break
    return spec


@dataclass(frozen=True)
class LeafPlan:
    """Where a parameter's shards lie, in torch dims: ``model_dim`` for the
    parameter, its moments and its EMA; ``data_dim`` (``--zero1``) for its
    moments only."""
    model_dim: Optional[int] = None
    data_dim: Optional[int] = None


def plan_module(module: nn.Module, n_model: int, n_data: int,
                zero1: bool) -> "OrderedDict[str, LeafPlan]":
    """The ``LeafPlan`` of every parameter of ``module``, in order."""
    dims = jax_dims(module)
    out = OrderedDict()
    for name, p in module.named_parameters():
        order = dims[name]
        jshape = [p.shape[t] for t in order]
        spec = leaf_spec(jshape, n_model, n_data, zero1, True)
        out[name] = LeafPlan(
            model_dim=order[spec.index(MODEL)] if MODEL in spec else None,
            data_dim=order[spec.index(DATA)] if DATA in spec else None)
    return out


def uses_sharded_step(cfg, mesh: DataMesh) -> bool:
    """The GSPMD step's routing (root ``train.py:253-271``): ``--zero1``, a
    model axis > 1 or a spatial axis > 1."""
    return (bool(cfg.parallel.zero1) or mesh.size(MODEL) > 1
            or mesh.size(SPATIAL) > 1)


def _narrow(t: torch.Tensor, dim: Optional[int], n: int, coord: int
            ) -> torch.Tensor:
    if dim is None or n == 1:
        return t
    k = t.shape[dim] // n
    return t.narrow(dim, coord * k, k)


# --------------------------------------------------------------------------- #
# the sharded state
# --------------------------------------------------------------------------- #


@dataclass
class _Leaf:
    name: str
    param: nn.Parameter      # the module's (full during a step)
    plan: LeafPlan
    master: torch.Tensor     # this rank's model shard (``param`` if none)
    opt: torch.Tensor        # the tensor Adam steps: ``master``, or its
                             # data shard (a view of it where contiguous)
    copy: bool = False       # ``opt`` a copy, its storage held only while
                             # Adam steps it


class StatePlan:
    """This rank's shards of G's and D's parameters, Adam moments and EMA
    twin (``shard_state`` builds it into a ``TrainState``)."""

    def __init__(self, mesh: DataMesh, G: nn.Module, D: nn.Module,
                 zero1: bool):
        self.mesh = mesh
        self.model, self.data = _Axis(mesh, MODEL), _Axis(mesh, DATA)
        self.spatial = _Axis(mesh, SPATIAL)
        self.zero1 = bool(zero1) and self.data.n > 1
        self.nets = {"G": G, "D": D}
        self.leaves: Dict[str, List[_Leaf]] = {}
        for net, mod in self.nets.items():
            plan = plan_module(mod, self.model.n, self.data.n, self.zero1)
            leaves = []
            for name, p in mod.named_parameters():
                lp = plan[name]
                master = p
                if lp.model_dim is not None:
                    master = _narrow(p.detach(), lp.model_dim, self.model.n,
                                     self.model.coord).clone()
                opt, copy = master, False
                if lp.data_dim is not None:
                    # fused Adam steps a contiguous view in place; another
                    # shard is copied for the update and gathered back
                    opt = _narrow(master.detach(), lp.data_dim, self.data.n,
                                  self.data.coord)
                    if not opt.is_contiguous():
                        opt, copy = opt.clone(), True
                        opt.untyped_storage().resize_(0)
                leaves.append(_Leaf(name, p, lp, master, opt, copy))
            self.leaves[net] = leaves

    # ---- the modules' parameters ------------------------------------------
    def _model_sharded(self, net: str) -> List[_Leaf]:
        return [lf for lf in self.leaves[net] if lf.plan.model_dim is not None]

    def gather(self, net: str) -> None:
        """The model-sharded parameters of ``net`` whole in the module."""
        lvs = self._model_sharded(net)
        fulls = self.model.gather_dims([lf.master for lf in lvs],
                                       [lf.plan.model_dim for lf in lvs])
        for lf, full in zip(lvs, fulls):
            lf.param.data = full

    def release(self, net: str) -> None:
        """Drops the full copies of ``net``'s model-sharded parameters."""
        for lf in self._model_sharded(net):
            lf.param.data = lf.param.data.new_empty((0,))

    def masters(self, net: str) -> List[torch.Tensor]:
        return [lf.master for lf in self.leaves[net]]

    def opt_tensors(self, net: str) -> List[torch.Tensor]:
        return [lf.opt for lf in self.leaves[net]]

    # ---- the gradients ----------------------------------------------------
    def reduce(self, net: str, grads: List[torch.Tensor]
               ) -> List[torch.Tensor]:
        """The gradients of the tensors Adam steps: the model shard of each
        full gradient, summed over the spatial group (each band's share of
        the loss), averaged over the data group (reduce-scattered along
        the leaf's data dim under ``--zero1``), and the leaves the model
        axis replicates averaged over the model group."""
        m, d = self.model, self.data
        shards = [_narrow(g, lf.plan.model_dim, m.n, m.coord)
                  for lf, g in zip(self.leaves[net], grads)]
        if self.spatial.group is not None:
            with _record("all_reduce_sum/spatial", self.mesh.device):
                shards = all_reduce_flat(shards, self.spatial.group)
        out = shards if d.group is None else self._data_mean(net, shards)
        rep = [i for i, lf in enumerate(self.leaves[net])
               if lf.plan.model_dim is None]
        if m.group is not None and rep:
            # a leaf the model axis replicates is stepped on every rank of
            # the line from the gradient that rank computed; their mean
            # keeps the copies alike should a kernel not be reproducible
            flat = m.all_reduce_mean(torch.cat(
                [out[i].reshape(-1) for i in rep]))
            for i, piece in zip(rep, flat.split([out[i].numel()
                                                 for i in rep])):
                out[i] = piece.view(out[i].shape)
        return out

    def _data_mean(self, net: str, shards: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
        d = self.data
        out = list(shards)
        scat = [i for i, lf in enumerate(self.leaves[net])
                if lf.plan.data_dim is not None]
        rest = [i for i in range(len(shards)) if i not in scat]
        if scat:
            chunks = [torch.cat([_narrow(shards[i], self.leaves[net][i]
                                         .plan.data_dim, d.n, c).reshape(-1)
                                 for i in scat]) for c in range(d.n)]
            mine = d.reduce_scatter_mean(chunks)
            for i, piece in zip(scat, mine.split(
                    [self.leaves[net][i].opt.numel() for i in scat])):
                out[i] = piece.view(self.leaves[net][i].opt.shape)
        if rest:
            flat = d.all_reduce_mean(torch.cat(
                [shards[i].reshape(-1) for i in rest]))
            for i, piece in zip(rest, flat.split(
                    [shards[i].numel() for i in rest])):
                out[i] = piece.view(shards[i].shape)
        return out

    def grad_norm(self, net: str, grads: List[torch.Tensor]) -> torch.Tensor:
        """``optax.global_norm`` of the whole averaged gradient from this
        rank's shards: each shard's sum of squares over its copies on the
        mesh, summed over the world."""
        world = self.mesh.world
        total = torch.zeros((), device=grads[0].device)
        for lf, g in zip(self.leaves[net], grads):
            copies = world
            if lf.plan.model_dim is not None:
                copies //= self.model.n
            if lf.plan.data_dim is not None and self.zero1:
                copies //= self.data.n
            total = total + g.float().square().sum() / copies
        with _record("all_reduce/world", self.mesh.device):
            dist.all_reduce(total, group=self.mesh.group)
        return total.sqrt()

    def any_rank(self, flag: torch.Tensor) -> torch.Tensor:
        """``flag`` summed over the world (a non-finite shard anywhere)."""
        flag = flag.clone()
        with _record("all_reduce/world", self.mesh.device):
            dist.all_reduce(flag, group=self.mesh.group)
        return flag

    # ---- around Adam's step -----------------------------------------------
    @torch.no_grad()
    def before_update(self, net: str) -> None:
        """The copied data shards of ``net`` filled from its model shards."""
        for lf in self.leaves[net]:
            if lf.copy:
                lf.opt.untyped_storage().resize_(
                    lf.opt.numel() * lf.opt.element_size())
                lf.opt.copy_(_narrow(lf.master, lf.plan.data_dim,
                                     self.data.n, self.data.coord))

    @torch.no_grad()
    def after_update(self, net: str) -> None:
        """``--zero1``: the updated data shards all-gathered into the model
        shards (the copies then freed); then D (which the G pass reads)
        whole in its module."""
        if self.zero1:
            lvs = [lf for lf in self.leaves[net]
                   if lf.plan.data_dim is not None]
            fulls = self.data.gather_dims([lf.opt for lf in lvs],
                                          [lf.plan.data_dim for lf in lvs])
            for lf, full in zip(lvs, fulls):
                lf.master.copy_(full)
                if lf.copy:
                    lf.opt.untyped_storage().resize_(0)
        if net == "D":
            self.gather("D")

    # ---- whole tensors for checkpoints and evaluation ---------------------
    def whole(self, net: str, tensors: List[torch.Tensor], opt: bool
              ) -> List[torch.Tensor]:
        """Each leaf's tensor whole from this rank's shard of it (``opt``:
        shaped like the tensors Adam steps, else like the masters)."""
        lvs = self.leaves[net]
        out = list(tensors)
        if opt and self.zero1:
            idx = [i for i, lf in enumerate(lvs)
                   if lf.plan.data_dim is not None]
            for i, t in zip(idx, self.data.gather_dims(
                    [out[i] for i in idx],
                    [lvs[i].plan.data_dim for i in idx])):
                out[i] = t
        idx = [i for i, lf in enumerate(lvs) if lf.plan.model_dim is not None]
        for i, t in zip(idx, self.model.gather_dims(
                [out[i] for i in idx], [lvs[i].plan.model_dim for i in idx])):
            out[i] = t
        return out

    def moments(self, opt: torch.optim.Adam, net: str):
        """(count, [exp_avg], [exp_avg_sq]) whole (zeros before the first
        step)."""
        count, mu, nu = 0, [], []
        for lf in self.leaves[net]:
            st = opt.state.get(lf.opt) or {}
            if st:
                count = int(st["step"])
            mu.append(st.get("exp_avg", torch.zeros_like(lf.opt)))
            nu.append(st.get("exp_avg_sq", torch.zeros_like(lf.opt)))
        return count, self.whole(net, mu, True), self.whole(net, nu, True)

    def resident_bytes(self, state) -> Dict[str, int]:
        """This rank's bytes of parameters, Adam moments and EMA twin
        between steps."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)
        params = sum(nbytes([lf.master for lf in lvs])
                     for lvs in self.leaves.values())
        adam = sum(nbytes([v for st in opt.state.values()
                           for k, v in st.items() if k != "step"])
                   for opt in (state.opt_g, state.opt_d))
        ema = 0 if state.ema is None else nbytes(state.ema.values())
        return {"params": params, "adam": adam, "ema": ema,
                "total": params + adam + ema}


def state_bytes(state) -> Dict[str, int]:
    """The resident bytes of a plain (one-device) ``TrainState``, as
    ``StatePlan.resident_bytes`` counts them."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    params = nbytes(list(state.G.parameters()) + list(state.D.parameters()))
    adam = sum(nbytes([v for st in opt.state.values()
                       for k, v in st.items() if k != "step"])
               for opt in (state.opt_g, state.opt_d))
    ema = 0 if state.ema is None else nbytes(state.ema.values())
    return {"params": params, "adam": adam, "ema": ema,
            "total": params + adam + ema}


def _adam_over(tensors: List[torch.Tensor], like: torch.optim.Adam
               ) -> torch.optim.Adam:
    g = like.param_groups[0]
    impl = {"fused": True} if g["fused"] else {"foreach": True}
    return torch.optim.Adam(tensors, lr=0.0, betas=g["betas"], eps=g["eps"],
                            **impl)


@torch.no_grad()
def shard_state(state, mesh: DataMesh, zero1: bool = False):
    """This rank's part of a ``TrainState`` created (and restored) as on one
    device, every rank from the same seeds (``place_auto_state``): the
    parameters, Adam moments and EMA of the divisible leaves keep their
    shards, Adam steps the shard tensors, and the full copies of the
    model-sharded parameters are dropped until a step gathers them. The
    pool and the generators stay whole and alike on every rank."""
    from pcgan_tpu_torch.utils.checkpoint import adam_state
    plan = StatePlan(mesh, state.G, state.D, zero1)
    for net, attr in (("G", "opt_g"), ("D", "opt_d")):
        old = getattr(state, attr)
        sd = adam_state(old, plan.nets[net])
        new = _adam_over(plan.opt_tensors(net), old)
        if old.state:
            torch_sd = new.state_dict()
            torch_sd["state"] = {}
            for i, lf in enumerate(plan.leaves[net]):
                def shard(t):
                    t = _narrow(t.to(lf.opt.device), lf.plan.model_dim,
                                plan.model.n, plan.model.coord)
                    if plan.zero1:
                        t = _narrow(t, lf.plan.data_dim, plan.data.n,
                                    plan.data.coord)
                    return t.clone()
                torch_sd["state"][i] = {
                    "step": torch.tensor(float(sd["count"])),
                    "exp_avg": shard(sd["mu"][lf.name]),
                    "exp_avg_sq": shard(sd["nu"][lf.name])}
            new.load_state_dict(torch_sd)
        setattr(state, attr, new)
    if state.ema is not None:
        state.ema = OrderedDict(
            (lf.name, _narrow(state.ema[lf.name], lf.plan.model_dim,
                              plan.model.n, plan.model.coord).clone())
            for lf in plan.leaves["G"])
    plan.pool_h = state.pool.imgs.shape[1]
    if plan.spatial.group is not None:
        # each rank keeps its band of every pooled image
        b = spatial.band_of(plan.pool_h, plan.spatial.n, plan.spatial.coord)
        state.pool = image_pool.PoolState(
            state.pool.imgs[:, b.r0:b.r1].clone(), state.pool.conds,
            state.pool.count)
    for net in plan.nets:
        plan.release(net)
    state.shard_plan = plan
    return state


def _whole_pool(plan: StatePlan, pool):
    """The pool with each image whole: the bands of the spatial line
    gathered (each padded to the widest band)."""
    sp, imgs = plan.spatial, pool.imgs
    bands = spatial.bands_of(plan.pool_h, sp.n)
    pad = imgs.new_zeros((imgs.shape[0], bands[0].h) + imgs.shape[2:])
    pad[:, :imgs.shape[1]] = imgs
    parts = sp.all_gather(pad.reshape(-1))
    whole = torch.cat([p.view(pad.shape)[:, :b.h]
                       for p, b in zip(parts, bands)], 1)
    return image_pool.PoolState(whole, pool.conds, pool.count)


class _WholeAdam:
    """What ``utils.checkpoint.adam_state`` reads of an optimizer: its
    per-parameter state, here whole and keyed by the module's
    parameters."""

    def __init__(self, plan: StatePlan, opt: torch.optim.Adam, net: str):
        count, mu, nu = plan.moments(opt, net)
        self.state = {}
        if opt.state:
            self.state = {lf.param: {"step": torch.tensor(float(count)),
                                     "exp_avg": m, "exp_avg_sq": v}
                          for lf, m, v in zip(plan.leaves[net], mu, nu)}


@contextlib.contextmanager
def gathered(state, optimizer: bool = False):
    """Inside, ``state`` reads as a one-device state: G and D whole in their
    modules, ``state.ema`` whole and (``optimizer``) ``opt_g``/``opt_d``
    whole for ``save_state``, the pool's images whole. Every rank enters
    it (it gathers); a state without a plan passes through."""
    plan = state.shard_plan
    if plan is None:
        yield state
        return
    for net in plan.nets:
        plan.gather(net)
    saved = (state.ema, state.opt_g, state.opt_d, state.pool)
    try:
        if plan.spatial.group is not None:
            state.pool = _whole_pool(plan, state.pool)
        if state.ema is not None:
            state.ema = OrderedDict(zip(state.ema, plan.whole(
                "G", list(state.ema.values()), False)))
        if optimizer:
            state.opt_g = _WholeAdam(plan, state.opt_g, "G")
            state.opt_d = _WholeAdam(plan, state.opt_d, "D")
        yield state
    finally:
        state.ema, state.opt_g, state.opt_d, state.pool = saved
        for net in plan.nets:
            plan.release(net)


# --------------------------------------------------------------------------- #
# the step
# --------------------------------------------------------------------------- #


class ShardedParts(StepParts):
    """``StepParts`` of the sharded-state step: global draws, the global
    pool, sharded reductions and updates (the module docstring)."""

    def __init__(self, cfg, G: nn.Module, D: nn.Module,
                 C: Optional[nn.Module], mesh: DataMesh):
        super().__init__(cfg, G, D, C, mesh.data_group)
        self.n_data, self.coord = mesh.data_size, mesh.data_rank
        self.data = _Axis(mesh, DATA)
        self.plan: Optional[StatePlan] = None

    def begin(self, bsz: int) -> None:
        self.rows = Rows(self.n_data, self.coord, bsz)

    def pool_query(self, state, fake, cond):
        if self.data.group is None:
            return super().pool_query(state, fake, cond)
        full = [torch.cat([p.view(t.shape) for p in
                           self.data.all_gather(t.reshape(-1))])
                for t in (fake, cond)]
        state.pool, fake_d, cond_d = image_pool.query(
            state.pool, *full, state.generator)
        return self.rows.take(fake_d), self.rows.take(cond_d)

    def reduces(self) -> bool:
        return True

    def reduce_grads(self, which, grads, rt=None):
        if rt is not None and self.group is not None:
            rt = self.data.all_reduce_mean(rt.reshape(1)).view(())
        return self.plan.reduce(which, grads), rt

    def update(self, state, which, grads) -> None:
        opt, sched, skip = ((state.opt_g, state.sched_g, state.skip_g)
                            if which == "G" else
                            (state.opt_d, state.sched_d, state.skip_d))
        found_inf = None
        if skip is not None:
            found_inf = check_finite(grads, skip, self.t.skip_nonfinite,
                                     reduce=self.plan.any_rank)
            count = adam_count(opt)
        else:
            count = state.step
        self.plan.before_update(which)
        adam_step(opt, grads, sched(count) * state.lr_scale, found_inf)
        self.plan.after_update(which)

    def ema_update(self, state) -> None:
        self._ema_step(state, list(state.ema.values()),
                       self.plan.masters("G"))

    def sync_stats(self) -> None:
        """Nothing to average: the norm state moved alike on every rank
        (global batch moments, whole weights)."""

    def grad_norm(self, which, grads):
        return self.plan.grad_norm(which, grads)

    def metrics(self, state, losses, g_grads, d_grads, rt):
        """The losses are each band's share: summed over the spatial line
        (one collective), they are the global batch's."""
        if spatial.active() is not None:
            keys = list(losses)
            tot = spatial.line_total(torch.stack(
                [losses[k].detach().float() for k in keys]))
            losses = dict(zip(keys, tot.unbind()))
        return super().metrics(state, losses, g_grads, d_grads, rt)


def make_sharded_train_step(cfg, G: nn.Module, D: nn.Module,
                            C: Optional[nn.Module] = None,
                            mesh: Optional[DataMesh] = None,
                            with_preprocess: bool = True,
                            train_preprocess: bool = True) -> Callable:
    """step(state, raw) -> metrics of a ``shard_state``'d state over
    ``mesh`` (``make_auto_train_step``'s counterpart). ``raw`` holds this
    rank's rows of the global batch (``Rows``' layout: its data
    coordinate's rows of each microbatch); with ``with_preprocess``, u8
    canvases that B1 crops and flips with draws made for the global batch.
    Under a spatial axis > 1 each rank computes on its band of every image
    (``parallel/spatial.py``): B1 writes only the band, or the band of a
    whole preprocessed image is taken. The metrics are the global batch's,
    alike on every rank.

    The ranks of a model line compute the same rows and step what they
    hold from what they computed, so they must compute alike bit for bit:
    a model axis > 1 makes cuDNN deterministic (its transposed convs'
    default algorithms add by atomics)."""
    from pcgan_tpu_torch.models.layers import batch_norm_group
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    if mesh.size(MODEL) > 1:
        torch.backends.cudnn.deterministic = True
    parts = ShardedParts(cfg, G, D, C, mesh)
    inner = make_train_step(cfg, G, D, C, parts=parts)
    pre = (make_preprocess(cfg, train=train_preprocess) if with_preprocess
           else None)
    accum = max(1, int(cfg.train.grad_accum))
    line = spatial.spatial_line(mesh)

    def step(state, raw):
        with tracing.span("step"):
            return sharded_step(state, raw)

    def sharded_step(state, raw):
        plan = parts.plan = state.shard_plan
        rows = Rows(parts.n_data, parts.coord,
                    raw["image"].shape[0] // accum)
        # a spatial line splits every image along H: B1 writes this rank's
        # band of each crop (or the band of a whole image is taken)
        H = (raw["image"].shape[1] if pre is None
             else pre.crop_of(raw["image"].shape[1]))
        band = (None if line is None
                else spatial.band_of(H, line.n, line.coord))
        plan.gather("G")
        plan.gather("D")
        try:
            with batch_norm_group(parts.group), spatial.banded(line, H):
                if pre is not None:
                    with tracing.span("step/preprocess"):
                        batch = pre(state.generator, raw, rows, band)
                elif band is not None:
                    batch = {**raw, "image": raw["image"][:, band.r0:band.r1]}
                else:
                    batch = raw
                return inner(state, batch)
        finally:
            plan.release("G")
            plan.release("D")

    return step


def batch_rows(cfg, mesh: DataMesh) -> Rows:
    """The ``Rows`` of this rank's part of every global batch: its data
    coordinate's rows of each of the ``--grad_accum`` microbatches."""
    b = cfg.data.batch_size // mesh.data_size
    return Rows(mesh.data_size, mesh.data_rank,
                b // max(1, int(cfg.train.grad_accum)))

