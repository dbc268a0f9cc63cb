"""The data-parallel steps and the per-rank train state (counterpart of
``pcgan_tpu/parallel/train_parallel.py:56-345``).

Each rank runs the fused step (``train.make_train_step``, or
``accum.make_accum_train_step`` under ``--grad_accum``) on its own rows of
the global batch with the mesh's data-axis group as the JAX step's
``axis_name``: the gradients are averaged in the step, so the parameters,
optimizer moments, EMA twin, ADA's p and the norm state stay alike on every
rank and never diverge. An N-rank step on a global batch B equals the
one-device step on B (the average of the ranks' gradients is the
full-batch gradient of the mean losses), up to f32 summation order.

Kernel B1 preprocesses each rank's local u8 rows on its own card, drawing
crops and flips from the rank's generator (JAX folds ``axis_index`` into
the preprocessing key). The fake-image pool is sharded: each rank keeps
``pool_size / N`` rows of history, with the count alike on every rank
(``shard_train_state``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from pcgan_tpu_torch.config import Config
from pcgan_tpu_torch.parallel.mesh import DataMesh, rank_seed
from pcgan_tpu_torch.utils import tracing


def _group(mesh: Optional[DataMesh]):
    return None if mesh is None else mesh.data_group


def pool_for_mesh(cfg: Config, mesh: Optional[DataMesh]) -> Config:
    """``cfg`` with ``--pool_size`` rounded up to a multiple of the data
    axis, as the root ``train.py:199-206`` does, so every rank holds an
    equal share."""
    n = 1 if mesh is None else mesh.data_size
    pool = cfg.train.pool_size
    if pool > 0 and pool % n:
        pool = -(-pool // n) * n
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, pool_size=pool))
    return cfg


def shard_train_state(state, mesh: Optional[DataMesh]):
    """This rank's part of a state created as on one device (JAX's
    ``shard_train_state``): the pool keeps rows [r*k, (r+1)*k) of its P =
    N*k (the shard of ``P('data')``; P must divide by N), and G's dropout
    masks come from a generator seeded for the rank. Everything else is
    replicated: every rank created it from the same seeds. A world of one
    returns ``state`` unchanged."""
    from pcgan_tpu_torch.utils.image_pool import PoolState
    if mesh is None or mesh.data_size == 1:
        return state
    n, r = mesh.data_size, mesh.data_rank
    pool = state.pool
    if int(pool.count) >= 0:      # -1: the disabled pool's sentinel
        p = pool.imgs.shape[0]
        if p % n:
            raise ValueError(f"pool_size {p} must divide data axis {n}")
        k = p // n
        state.pool = PoolState(pool.imgs[r * k:(r + 1) * k].clone(),
                               pool.conds[r * k:(r + 1) * k].clone(),
                               pool.count)
    gen = state.dropout_generator
    if gen is not None:
        state.dropout_generator = torch.Generator(
            device=gen.device).manual_seed(rank_seed(gen.initial_seed(), r))
    return state


def make_parallel_train_step(cfg: Config, G: nn.Module, D: nn.Module,
                             C: Optional[nn.Module] = None,
                             mesh: Optional[DataMesh] = None,
                             with_preprocess: bool = True,
                             train_preprocess: bool = True) -> Callable:
    """step(state, raw) -> metrics, data-parallel over ``mesh``'s group.

    ``raw`` holds this rank's rows. With ``with_preprocess``, raw =
    {'image': (b, N, N, 3) u8 on the device, 'bin', optional
    'target_bin'/'target_score'}, which B1 crops and flips (center crop
    without ``train_preprocess``) from ``state.generator`` first; else the
    images are crop-sized floats in [-1, 1]. ``mesh=None`` (or a world of
    one outside torchrun) is the one-device step, issuing no collective."""
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    from pcgan_tpu_torch.train import make_train_step
    inner = make_train_step(cfg, G, D, C, group=_group(mesh))
    pre = (make_preprocess(cfg, train=train_preprocess) if with_preprocess
           else None)

    def step(state, raw):
        with tracing.span("step"):
            if pre is not None:
                with tracing.span("step/preprocess"):
                    raw = pre(state.generator, raw)
            return inner(state, raw)

    return step


def make_parallel_comparator_step(cfg: Config, C: nn.Module,
                                  mesh: Optional[DataMesh] = None,
                                  with_preprocess: bool = True) -> Callable:
    """The comparator's pretraining step, data-parallel over ``mesh``'s
    group. With ``with_preprocess`` the raw pairs {'image_a', 'image_b':
    u8, 'label'} go through B1 first, both members in one launch with
    their own crops and flips from ``state.generator``
    (``pcgan_tpu/parallel/train_parallel.py:315-325``)."""
    from pcgan_tpu_torch.ops.preprocess import make_pair_preprocess
    from pcgan_tpu_torch.train import make_comparator_step
    inner = make_comparator_step(cfg, C, group=_group(mesh))
    pre = make_pair_preprocess(cfg, train=True) if with_preprocess else None

    def step(state, raw):
        return inner(state, raw if pre is None else pre(state.generator,
                                                        raw))

    return step
