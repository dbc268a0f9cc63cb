"""The port's sharded-state step (``pcgan_tpu_torch/parallel/auto.py``)
over gloo cohorts against ``pcgan_tpu.parallel.auto.make_auto_train_step``
on a CPU mesh of the same shape, and against the port's own one-device
step.

Against JAX (golden sizes, f32, pool off, target bins pinned,
``with_preprocess=False``): JAX draws the weights, takes one warm-up step
and then two; before each, its state is carried into the port, and each
rank of a cohort (``torch_port_parallel_worker.sharded_steps``) takes the
step on its rows. Cases: ``--zero1`` on a data axis of 2; data 1 x model
2 with ``--grad_accum 2``; data 2 x model 2 with ``--zero1`` and an EMA
twin, on four ranks. The limits are the data-parallel lockstep's
(``test_torch_port_parallel_step.py``): losses 1e-4 abs + rel, the
gradients (Adam's first moments) 1e-4 of each tensor's scale away from a
ReLU kink, the parameters within the one-step Adam envelope, the EMA
twin no further from JAX's than the parameters are (it moves by a share
of their difference from it). After the
step each rank holds exactly the blocks of every sharded leaf that JAX's
``state_shardings`` gives its coordinates (``torch_port_auto.
check_shards``), and the ranks' gathered states are alike bit for bit.

N ranks against one (the port alone, everything drawn): from a state the
one-device port saved after a warm-up step, a 2 x 2 ``--zero1`` cohort
takes one step on u8 canvases that B1 crops and flips, with the pool on,
``--norm batch``, dropout and the target bins drawn; it equals the port's
one-device step on the global batch (losses and gradients 1e-5 of scale,
the parameters within the Adam envelope).

The hybrid mesh: the 2 x 2 steps again with granule = rank % 2
(``--dcn_data 2``, the ranks laid out [[0, 2], [1, 3]]) equal the plain
layout's.

Checkpoints: the train CLI on two ranks (``--mesh_shape 1,2 --mesh_axes
data,model``, pool and EMA on), cut right after its mid-epoch 'latest'
save at step 6 and resumed with ``--continue_train``, logs the
uninterrupted run's losses bit for bit; its checkpoint is the one-device
state, which a one-device ``TrainState`` restores whole.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import os

import numpy as np
import pytest
import torch

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch.models import define_D, define_G
from pcgan_tpu_torch.parallel.train_parallel import make_parallel_train_step
from pcgan_tpu_torch.train import create_train_state
from pcgan_tpu_torch.utils.checkpoint import (adam_state, load_state,
                                              restore_generator,
                                              restore_state, save_state)

from test_torch_port_parallel_step import (KINK, _adam_envelope,
                                           compare_gan_step)
from torch_port_auto import check_shards, jax_auto_run
from torch_port_levers import assert_close
from torch_port_parallel_worker import run_cohort

STEPS = 2
CASES = {  # name: (overrides, mesh shape, axes, zero1, global batch)
    "zero1_d2": ({}, (2,), ("data",), True, 4),
    "model_1x2_accum": ({"train": {"grad_accum": 2}}, (1, 2),
                        ("data", "model"), False, 4),
    "both_2x2_ema": ({"train": {"ema_decay": 0.999}}, (2, 2),
                     ("data", "model"), True, 4)}
GLOBAL = ["--batch_size", "4", "--load_size", "36", "--crop_size", "32",
          "--netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8",
          "--n_age_bins", "4", "--cond_inject", "bottleneck", "--norm",
          "batch", "--no-no_dropout", "--pool_size", "4", "--dtype",
          "float32", "--lr_policy", "constant", "--mesh_shape", "2,2",
          "--mesh_axes", "data,model", "--zero1"]
CLI = ["--dataset_mode", "synthetic", "--max_dataset_size", "16",
       "--batch_size", "4", "--load_size", "36", "--crop_size", "32",
       "--netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8",
       "--n_age_bins", "4", "--niter_decay", "0", "--print_freq", "1",
       "--cond_inject", "bottleneck", "--pool_size", "4", "--ema_decay",
       "0.999", "--device", "cpu", "--num_threads", "1", "--mesh_shape",
       "1,2", "--mesh_axes", "data,model", "--niter", "2",
       "--save_epoch_freq", "0"]


def _global_inputs():
    """(cfg, payload after a one-device warm-up step, raw u8 batch) of the
    N-against-one case."""
    cfg = tcfg.parse_config(GLOBAL + ["--device", "cpu"])
    G = define_G(cfg, torch.Generator().manual_seed(1))
    D = define_D(cfg, torch.Generator().manual_seed(2))
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(5))
    step = make_parallel_train_step(cfg, G, D)
    rng = np.random.default_rng(7)

    def raw():
        return {"image": rng.integers(0, 256, (4, 36, 36, 3), np.uint8),
                "bin": rng.integers(0, 4, 4).astype(np.int64)}
    step(state, {k: torch.from_numpy(v) for k, v in raw().items()})
    return cfg, state, raw()


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    runs = {name: jax_auto_run(over, shape, axes, zero1, b, STEPS)
            for name, (over, shape, axes, zero1, b) in CASES.items()}
    work = tmp_path_factory.mktemp("auto_step")

    def cases(world):
        return {name: {"kind": "sharded_steps", "cfg": tc,
                       "payloads": payloads, "batches": bs,
                       "shape": CASES[name][1], "axes": CASES[name][2]}
                for name, (tc, _, payloads, bs, _) in runs.items()
                if int(np.prod(CASES[name][1])) == world}
    cfg, state, raw = _global_inputs()
    save_state(state, str(work), "g", "warm")
    payload = torch.load(work / "g" / "warm.pt", weights_only=False)
    four = cases(4)
    # the same steps on a permuted layout: granule = rank % 2 lays the
    # ranks out [[0, 2], [1, 3]]
    four["both_2x2_ema_hybrid"] = {**four["both_2x2_ema"], "dcn_data": 2,
                                   "granules": [0, 1, 0, 1]}
    four["global"] = {"kind": "sharded_steps", "cfg": cfg,
                      "payloads": [payload], "batches": [raw],
                      "shape": (2, 2), "axes": ("data", "model"),
                      "preprocess": True}
    two = cases(2)

    def argv(name, *extra):
        return CLI + ["--name", name, "--checkpoints_dir", str(work), *extra]
    cut = argv("cut", "--save_latest_freq", "3")
    two["resume"] = {"kind": "train_runs", "runs": [
        (argv("straight"), None), (cut, 6), (cut + ["--continue_train"], None)]}
    ranks = {2: run_cohort(two, work, world=2),
             4: run_cohort(four, work, world=4, timeout=240)}
    return runs, ranks, (cfg, payload, raw), work


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_jax_auto_step(cohorts, case):
    runs, ranks, *_ = cohorts
    _, codes, payloads, _, want = runs[case]
    world = int(np.prod(CASES[case][1]))
    checked = 0
    for i, (jm, after) in enumerate(want):
        smooth = min(r[case][i]["relu_margin"] for r in ranks[world]) > KINK
        checked += smooth
        compare_gan_step(payloads[i], jm, after, ranks[world][0][case][i],
                         grads=smooth)
        if CASES[case][0].get("train", {}).get("ema_decay"):
            # the EMA moves by (1 - decay) of the parameters' difference
            # from it: its error is at most theirs
            got = ranks[world][0][case][i]
            for k, v in after["ema"].items():
                err = np.abs(got["ema"][k].numpy() - v.numpy())
                bound = np.abs(got["G"][k].numpy() - after["G"][k].numpy())
                assert (err <= bound + 1e-6).all(), k
    assert checked >= 1


@pytest.mark.parametrize("case", list(CASES) + ["global"])
def test_each_rank_holds_its_shards_and_ranks_agree(cohorts, case):
    runs, ranks, *_ = cohorts
    world = 4 if case == "global" else int(np.prod(CASES[case][1]))
    group = ranks[world]
    if case != "global":
        codes = runs[case][1]
        ema = bool(CASES[case][0].get("train", {}).get("ema_decay"))
        for r in group:
            for res in r[case]:
                check_shards(res, codes, ema)
    first = group[0][case]
    for r in group[1:]:
        for a, b in zip(first, r[case]):
            assert a["metrics"] == b["metrics"]
            for net in ("G", "D"):
                for k, v in a[net].items():
                    assert torch.equal(v, b[net][k]), (case, net, k)


def test_n_ranks_match_one_rank_on_the_global_batch(cohorts):
    """Everything drawn (crops, flips, target bins, pool, dropout) and
    batch norm over the global batch: the 2 x 2 cohort's step equals the
    one-device step."""
    _, ranks, (cfg, payload, raw), _ = cohorts
    got = ranks[4][0]["global"][0]
    one = tcfg.parse_config(GLOBAL[:-5] + ["--device", "cpu"])
    G, D = define_G(one), define_D(one)
    state = create_train_state(one, G, D, torch.Generator().manual_seed(0))
    load_state(state, payload)
    m = make_parallel_train_step(one, G, D)(
        state, {k: torch.from_numpy(v) for k, v in raw.items()})
    assert set(m) == set(got["metrics"])
    for k, v in m.items():
        assert_close(k, got["metrics"][k], float(v), 1e-5)
    for net, opt, mod in (("G", "opt_g", G), ("D", "opt_d", D)):
        mine = adam_state(getattr(state, opt), mod)
        for k, mu in mine["mu"].items():
            assert_close(f"{net}.mu.{k}", got[opt]["mu"][k], mu, 1e-5)
        sd = mod.state_dict()
        for k, v in sd.items():
            if k in mine["mu"]:
                _adam_envelope(f"{net}.{k}",
                               (v - payload[net][k]).numpy(),
                               (got[net][k] - payload[net][k]).numpy())
            else:        # batch norm's running stats: global moments
                assert_close(f"{net}.state.{k}", got[net][k], v, 1e-5)


def _losses(path):
    import json
    with open(path) as f:
        return [{k: v for k, v in r.items() if k.startswith("loss")}
                for r in map(json.loads, f) if "loss_G" in r]


def test_resume_is_exact_and_loads_on_one_device(cohorts):
    *_, work = cohorts
    assert [r["resume"] for r in cohorts[1][2]] == [[8, "cut", 8]] * 2
    a, b = (_losses(os.path.join(work, n, "metrics.jsonl"))
            for n in ("straight", "cut"))
    assert len(a) == 8 and a == b
    one = tcfg.parse_config(CLI[:-8] + ["--device", "cpu"])
    G, D = define_G(one), define_D(one)
    state = create_train_state(one, G, D, torch.Generator().manual_seed(0))
    restore_state(state, str(work), "straight", "latest")
    assert state.step == 8
    G2 = restore_generator(define_G(one), str(work), "straight", "latest")
    for k, v in G2.state_dict().items():
        assert torch.equal(G.state_dict()[k], v), k
    assert adam_state(state.opt_g, G)["count"] == 8


def test_step_on_permuted_hybrid_mesh_matches_plain(cohorts):
    """The hybrid mesh with granule = rank % 2 (``--dcn_data 2``) permutes
    the ranks of the 2 x 2 mesh; its steps equal the plain layout's (JAX's
    ``test_step_on_permuted_hybrid_mesh_matches_plain``): the metrics
    within 1e-5 of scale, the parameters within the one-step Adam
    envelope, the ranks alike bit for bit."""
    runs, ranks, *_ = cohorts
    payloads = runs["both_2x2_ema"][2]
    assert [r["both_2x2_ema_hybrid"][0]["coords"] for r in ranks[4]] == [
        {"data": 0, "model": 0}, {"data": 1, "model": 0},
        {"data": 0, "model": 1}, {"data": 1, "model": 1}]
    for i, start in enumerate(payloads):
        a = ranks[4][0]["both_2x2_ema"][i]
        b = ranks[4][0]["both_2x2_ema_hybrid"][i]
        for k, v in a["metrics"].items():
            assert_close(k, b["metrics"][k], v, 1e-5)
        for net in ("G", "D"):
            for k in a["opt_g" if net == "G" else "opt_d"]["mu"]:
                _adam_envelope(f"{net}.{k}",
                               (a[net][k] - start[net][k]).numpy(),
                               (b[net][k] - start[net][k]).numpy())
        for r in ranks[4][1:]:
            for k, v in b["G"].items():
                assert torch.equal(r["both_2x2_ema_hybrid"][i]["G"][k], v), k
