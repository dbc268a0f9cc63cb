"""The data side of the port's data parallelism against the JAX package:
``resolve_mesh_shape``, the process-sharded loader, the sharded pool's
layout, the evaluator's permutation slice, a world of one (no group, the
plain step bit for bit), the cards a launch cannot use, and, in one cohort of two gloo ranks
(``torch_port_parallel_worker.py``): the sharded device cache (each rank's
rows of every batch, gathered by the masked local ``index_select`` and one
``reduce_scatter_tensor``, concatenate to the replicated cache's batch),
multi-process evaluation (two ranks' record within 2e-3 of one rank's on
the same global batches; G injects its condition at the input, where
instance norm cancels it, so the ranks' block-diagonal target permutation
and one rank's full one render the same fakes to f32 noise) and
``--mesh_shape`` against the world size.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from flax import struct

from pcgan_tpu.data.loader import Loader as JLoader
from pcgan_tpu.eval_lib import _local_perm_slice as j_local_perm_slice
from pcgan_tpu.parallel import make_mesh
from pcgan_tpu.parallel import shard_train_state as j_shard_train_state
from pcgan_tpu.parallel.mesh import resolve_mesh_shape as j_resolve
from pcgan_tpu.utils.image_pool import init_pool as j_init_pool

from pcgan_tpu_torch.config import parse_config
from pcgan_tpu_torch.data import loader as data_loader
from pcgan_tpu_torch.data.device_cache import DeviceCacheLoader
from pcgan_tpu_torch.eval_lib import _local_perm_slice, make_fid_evaluator
from pcgan_tpu_torch.models import define_D, define_G
from pcgan_tpu_torch.ops.preprocess import make_preprocess
from pcgan_tpu_torch.parallel.mesh import (DataMesh, init_distributed,
                                           resolve_mesh_shape)
from pcgan_tpu_torch.parallel.train_parallel import (
    make_parallel_train_step, pool_for_mesh, shard_train_state)
from pcgan_tpu_torch.train import create_train_state, make_train_step

from torch_port_levers import one_torch_thread  # noqa: F401
from torch_port_parallel_worker import run_cohort

CPU = torch.device("cpu")
SMALL = ["--crop_size", "32", "--load_size", "36", "--netG",
         "resnet_6blocks", "--ngf", "8", "--ndf", "8", "--n_age_bins", "4",
         "--dtype", "float32", "--device", "cpu"]


@pytest.mark.parametrize("shape,n", [
    ((-1,), 8), ((2, -1), 8), ((4,), 8), ((8,), 8), ((-1,), 1), ((1,), 2),
    ((-1, -1), 8), ((3, -1), 8), ((16,), 8), ((2, 8), 8)])
def test_resolve_mesh_shape_matches_jax(shape, n):
    try:
        want = j_resolve(shape, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve_mesh_shape(shape, n)
        assert str(got.value) == str(e)
        return
    assert resolve_mesh_shape(shape, n) == want


class _Rows:
    """A dataset whose rows are their own indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get_raw(self, i):
        return {"idx": np.array(int(i))}


@pytest.mark.parametrize("n_rows,shuffle", [(24, True), (27, True),
                                            (24, False)])
def test_process_loader_shards_match_jax(n_rows, shuffle):
    """Rank r's batches are the JAX ``Loader(shard_id=r, num_shards=2)``'s
    at half the global batch; the shards are disjoint, and with the rows a
    multiple of the global batch they cover every row each epoch."""
    cfg = parse_config(["--batch_size", "4", "--num_threads", "2"])
    ds = _Rows(n_rows)
    lds = [data_loader.make_process_loader(
        cfg, ds, shuffle=shuffle, seed=7, mesh=DataMesh(world=2, rank=r))
        for r in range(2)]
    jlds = [JLoader(ds, 2, shuffle=shuffle, seed=7, num_threads=2,
                    shard_id=r, num_shards=2) for r in range(2)]
    for _ in range(2):
        seen = []
        for ld, jld in zip(lds, jlds):
            got = [b["idx"].tolist() for b in ld]
            assert got == [b["idx"].tolist() for b in jld]
            assert len(got) == len(ld) == len(jld)
            seen += sum(got, [])
        assert len(set(seen)) == len(seen)
        if n_rows % 4 == 0:
            assert sorted(seen) == list(range(n_rows))
    with pytest.raises(SystemExit, match="divisible by the process count"):
        data_loader.make_process_loader(parse_config(["--batch_size", "3"]),
                                        ds, shuffle=True,
                                        mesh=DataMesh(world=2))


@struct.dataclass
class _PoolOnly:
    pool: object


@pytest.mark.parametrize("pool,world,want", [(5, 2, 6), (6, 2, 6),
                                             (50, 4, 52), (0, 2, 0)])
def test_pool_layout_is_the_jax_shard(pool, world, want):
    """``--pool_size`` rounds up to a multiple of the data axis (root
    ``train.py:199-206``), and each rank holds the rows of the JAX pool's
    shard on its device, with the count alike."""
    cfg = pool_for_mesh(parse_config(SMALL + ["--pool_size", str(pool)]),
                        DataMesh(world=world))
    assert cfg.train.pool_size == want
    if not want:
        return
    mesh = make_mesh((world,), ("data",), devices=jax.devices()[:world])
    jpool = j_shard_train_state(
        _PoolOnly(j_init_pool(want, (32, 32, 3), 4)), mesh).pool
    shard = jpool.imgs.addressable_shards[0].data.shape
    for r in range(world):
        state = shard_train_state(create_train_state(
            cfg, define_G(cfg), define_D(cfg),
            torch.Generator().manual_seed(0)), DataMesh(world=world, rank=r))
        assert tuple(state.pool.imgs.shape) == shard == (want // world, 32,
                                                         32, 3)
        assert state.pool.conds.shape == (want // world, 4)
        assert int(state.pool.count) == int(jpool.count) == 0
    with pytest.raises(ValueError, match="must divide data axis"):
        shard_train_state(create_train_state(
            parse_config(SMALL + ["--pool_size", "5"]), define_G(cfg),
            define_D(cfg), torch.Generator()), DataMesh(world=2))


def test_local_perm_slice_matches_jax():
    for n_proc, idx in ((1, 0), (2, 0), (2, 1), (4, 3)):
        a, b = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(3):
            assert np.array_equal(_local_perm_slice(a, 6, n_proc, idx),
                                  j_local_perm_slice(b, 6, n_proc, idx))


def test_world_size_one_is_the_plain_step(monkeypatch):
    """Outside torchrun no process group exists and the data-parallel step
    (B1's preprocessing included) is ``make_train_step``'s bit for bit."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    mesh = init_distributed("cpu")
    assert mesh.group is None and mesh.world == 1
    assert not dist.is_initialized()
    cfg = parse_config(SMALL + ["--batch_size", "2", "--pool_size", "4",
                                "--cond_inject", "bottleneck"])
    rng = np.random.default_rng(0)
    raws = [{"image": torch.from_numpy(rng.integers(0, 256, (2, 40, 40, 3),
                                                    dtype=np.uint8)),
             "bin": torch.from_numpy(rng.integers(0, 4, 2))}
            for _ in range(2)]
    runs = []
    for dp in (True, False):
        G = define_G(cfg, torch.Generator().manual_seed(1))
        D = define_D(cfg, torch.Generator().manual_seed(2))
        state = shard_train_state(create_train_state(
            cfg, G, D, torch.Generator().manual_seed(3)), mesh)
        if dp:
            step = make_parallel_train_step(cfg, G, D, mesh=mesh)
        else:
            pre, plain = make_preprocess(cfg, train=True), make_train_step(
                cfg, G, D)

            def step(st, raw):
                return plain(st, pre(st.generator, raw))
        ms = [step(state, raw) for raw in raws]
        runs.append((ms, {**G.state_dict(), **D.state_dict()}))
    (m1, s1), (m0, s0) = runs
    for a, b in zip(m1, m0):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(s1[k], s0[k]) for k in s0)
    assert not dist.is_initialized()


def test_cards_the_launch_cannot_use_raise(monkeypatch):
    """Outside torchrun ``--mesh_shape -1`` with two cards visible raises,
    naming torchrun, rather than train on one of them; under torchrun a
    LOCAL_RANK without its card raises before any group forms."""
    from pcgan_tpu_torch.parallel.mesh import mesh_from_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        mesh_from_config(parse_config(["--mesh_shape", "-1"]))
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2"):
        init_distributed("cuda")
    assert not dist.is_initialized()


# --------------------------------------------------------------------------- #
# the cohort
# --------------------------------------------------------------------------- #

CACHE_ARGV = ["--dataset_mode", "synthetic", "--max_dataset_size", "21",
              "--batch_size", "4", "--crop_size", "32", "--load_size", "36"]
EVAL_B, EVAL_N = 4, 16
SHAPES = ((-1,), (2,), (1,), (4,))


def _eval_inputs():
    cfg = parse_config(SMALL + ["--batch_size", str(EVAL_B), "--kid",
                                "--kid_subsets", "2", "--kid_subset_size",
                                "8", "--ssim", "--cond_inject", "input"])
    rng = np.random.default_rng(4)
    batches = [{"image": torch.from_numpy(rng.integers(
                    0, 256, (EVAL_B, 36, 36, 3), dtype=np.uint8)),
                "bin": torch.from_numpy(rng.integers(0, 4, EVAL_B))}
               for _ in range(EVAL_N // EVAL_B)]
    G = define_G(cfg, torch.Generator().manual_seed(5))
    return cfg, G, batches


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    cfg, G, batches = _eval_inputs()
    return run_cohort({
        "cache": {"kind": "cache_batches", "cfg": parse_config(CACHE_ARGV)},
        "eval": {"kind": "fid_eval", "cfg": cfg, "G": G.state_dict(),
                 "batches": batches, "max_images": EVAL_N - EVAL_B,
                 "seed": 3},
        "mesh": {"kind": "mesh_shape_raises", "shapes": SHAPES}},
        tmp_path_factory.mktemp("dp_data"))


def test_sharded_cache_gather_equals_replicated(cohort):
    """21 rows pad to 22 (11 a rank, rank 1's last row zeros); every
    training and eval batch, gathered across the ranks, is the replicated
    cache's."""
    cfg = parse_config(CACHE_ARGV)
    ds = data_loader.create_dataset(cfg, train=True)
    whole = DeviceCacheLoader(cfg, ds, CPU, shuffle=True, seed=3)
    want = {"epoch": list(whole), "eval": list(whole.eval_iter())}
    assert [r["cache"]["n_loc"] for r in cohort] == [11, 11]
    for part, batches in want.items():
        assert len(batches) == 5
        for i, w in enumerate(batches):
            for k, v in w.items():
                got = torch.cat([r["cache"][part][i][k] for r in cohort])
                assert got.dtype == v.dtype and torch.equal(got, v), (part,
                                                                      i, k)


def test_two_rank_eval_matches_one_rank(cohort):
    cfg, G, batches = _eval_inputs()
    want = make_fid_evaluator(cfg, None, CPU)(
        G, iter(batches), max_images=EVAL_N - EVAL_B, seed=3)
    for r in cohort:
        got = r["eval"]
        assert set(got) == set(want) >= {"fid", "kid", "kid_std", "ssim"}
        assert got["fid_images"] == want["fid_images"] == EVAL_N - EVAL_B
        for k, v in want.items():
            assert abs(got[k] - v) <= 2e-3 * max(1.0, abs(v)), (k, got[k], v)


def test_mesh_shape_against_the_world(cohort):
    """``--mesh_shape`` must give a data axis of the world size: -1 and 2
    over two ranks do; 1 (a subset) and 4 (more than the ranks) raise."""
    for r in cohort:
        got = r["mesh"]
        assert got[(-1,)] is None and got[(2,)] is None
        assert "a data axis of 1 over 2" in got[(1,)]
        assert "--mesh_shape 4" in got[(4,)]
