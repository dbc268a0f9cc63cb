"""The port's step under a ``spatial`` mesh axis (``parallel/spatial.py``
through ``parallel/auto.py``) over gloo cohorts, against
``pcgan_tpu.parallel.auto.make_auto_train_step`` on CPU meshes of the same
shape, and against the port's own one-device step.

Against JAX (golden sizes, f32, pool off, target bins pinned,
``with_preprocess=False``; ``tests/test_auto_parallel.py``'s meshes): data
x spatial (2, 4) and (4, 2), and data x spatial x model (2, 2, 2) with an
EMA twin. JAX draws the weights and takes two steps from them; before
each, its state is carried into the port and each rank of an
eight-rank cohort (``torch_port_parallel_worker.sharded_steps``) takes
the step on its band of its rows. At (2, 4) the bands are 8 rows of the
image and 2 of the bottleneck, and D's last maps (3 and 2 rows) leave
ranks empty. Every step is held to JAX's one-device ``make_train_step``
import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
from the same state on the same batch within the sharded-state
lockstep's envelope (``test_torch_port_auto_step.py``): losses 1e-4 abs +
rel, the gradients (Adam's first moments) 1e-4 of scale away from a ReLU
kink, the parameters within the one-step Adam envelope, the EMA no
further off than the parameters. The first step (from the fresh state)
is also held to JAX's GSPMD step within JAX's own limits
(``tests/test_auto_parallel.py``: losses rtol 2e-3, parameters atol
1e-3), and every step to the port's own one-device step from the same
state within the lockstep's envelope. Every rank of the mesh holds the
same bits.

N ranks against one (the port alone, everything drawn: B1's plain twin
writes each rank's band of the crops, flips, target bins and pool slots
drawn for the global batch): from a state the one-device port saved after
a warm-up step, three steps on u8 canvases equal the one-device steps on
the global batch (run on one thread, as each rank runs: the CPU convs'
sums depend on the thread count, and batch norm over two rows amplifies
that to 1e-4 by the third step), losses within 1e-5 rel, the parameters
within three Adam steps' envelope, the pool (gathered from its bands)
within 1e-5. The
meshes: 2 x 2 x 2 data x spatial x model with the pool and an EMA twin;
1 x 4 with ``--norm batch`` (moments over data x spatial) and
``--grad_accum 2``; 1 x 2 with a frozen comparator (its pool a band sum
over the line), the condition loss and the pixel D.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch.models import define_C, define_D, define_G
from pcgan_tpu_torch.parallel.train_parallel import make_parallel_train_step
from pcgan_tpu_torch.train import create_train_state, make_train_step
from pcgan_tpu_torch.utils.checkpoint import adam_state, load_state, \
    save_state

from test_torch_port_parallel_step import KINK, compare_gan_step
from torch_port_auto import jax_auto_run
from torch_port_levers import LR, assert_close
from torch_port_parallel_worker import finish_cohort, run_cohort, \
    start_cohort

STEPS = 2
CASES = {  # name: (overrides, mesh shape, axes)
    "data2_spatial4": ({}, (2, 4), ("data", "spatial")),
    "data4_spatial2": ({}, (4, 2), ("data", "spatial")),
    "data2_spatial2_model2_ema": ({"train": {"ema_decay": 0.999}},
                                  (2, 2, 2), ("data", "spatial", "model"))}
SIZES = ["--batch_size", "4", "--load_size", "36", "--crop_size", "32",
         "--netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8",
         "--n_age_bins", "4", "--cond_inject", "bottleneck", "--pool_size",
         "4", "--dtype", "float32", "--lr_policy", "constant", "--device",
         "cpu"]
GLOBAL = {  # name: (flags, mesh shape, axes, comparator)
    "global_2x2x2": (["--ema_decay", "0.999"], (2, 2, 2),
                     ("data", "spatial", "model"), False),
    "global_1x4_bn_accum": (["--norm", "batch", "--grad_accum", "2"], (1, 4),
                            ("data", "spatial"), False),
    "global_1x2_cmp_pixel": (["--lambda_cond", "1", "--cmp_nf", "8",
                              "--cmp_n_down", "3", "--netD", "pixel"],
                             (1, 2), ("data", "spatial"), True)}
ANCHORS = (torch.tensor([-1e30, -0.5, 0.0, 0.5]),
           torch.tensor([-0.5, 0.0, 0.5, 1e30]),
           torch.tensor([-0.75, -0.25, 0.25, 0.75]))


def _mesh_flags(shape, axes):
    return ["--mesh_shape", ",".join(map(str, shape)), "--mesh_axes",
            ",".join(axes)]


def _global_case(name, work):
    """(case for the cohort, one-device inputs) of an N-against-one run:
    a warm state after one one-device step, three global u8 batches."""
    flags, shape, axes, cmp = GLOBAL[name]
    cfg = tcfg.parse_config(SIZES + flags)
    G = define_G(cfg, torch.Generator().manual_seed(1))
    D = define_D(cfg, torch.Generator().manual_seed(2))
    C = define_C(cfg, torch.Generator().manual_seed(4)) if cmp else None
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(5),
                               C=C, bin_anchors=ANCHORS if cmp else None)
    rng = np.random.default_rng(17)
    raws = [{"image": rng.integers(0, 256, (4, 36, 36, 3), np.uint8),
             "bin": rng.integers(0, 4, 4).astype(np.int64)}
            for _ in range(4)]
    make_parallel_train_step(cfg, G, D, C)(
        state, {k: torch.from_numpy(v) for k, v in raws[0].items()})
    save_state(state, str(work), name, "warm")
    payload = torch.load(work / name / "warm.pt", weights_only=False)
    case = {"kind": "spatial_steps",
            "cfg": tcfg.parse_config(SIZES + flags
                                     + _mesh_flags(shape, axes)),
            "payload": payload, "batches": raws[1:], "shape": shape,
            "axes": axes, "C": None if C is None else C.state_dict(),
            "anchors": ANCHORS if cmp else None}
    return case, (cfg, payload, raws[1:], case["C"])


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    return run_cohorts(tmp_path_factory.mktemp("spatial_step"))


def run_cohorts(work):
    """(JAX's GSPMD runs, each world's ranks, the N-against-one inputs,
    JAX's one-device steps) of every case."""
    by_world, one = {}, {}
    for name, (_, shape, _, _) in GLOBAL.items():
        case, one[name] = _global_case(name, work)
        by_world.setdefault(_world(shape), {})[name] = case
    # the cohorts without JAX inputs run while JAX steps
    started = {w: start_cohort(cases, work, world=w, tag=str(w))
               for w, cases in by_world.items() if w != 8}
    one_jax = {name: [] for name in CASES}

    def jax_case(name):
        over, shape, axes = CASES[name]
        return jax_auto_run(over, shape, axes, False, 4, STEPS, warm=False,
                            one_device=one_jax[name])
    with ThreadPoolExecutor(len(CASES)) as pool:   # XLA compiles outside
        runs = dict(zip(CASES, pool.map(jax_case, CASES)))   # the GIL
    for name, (tc, _, payloads, bs, _) in runs.items():
        shape, axes = CASES[name][1:]
        by_world[8][name] = {
            "kind": "sharded_steps", "cfg": tc, "payloads": payloads,
            "batches": bs, "shape": shape, "axes": axes}
    ranks = {8: run_cohort(by_world[8], work, world=8, timeout=300)}
    ranks.update({w: finish_cohort(h, timeout=300)
                  for w, h in started.items()})
    return runs, ranks, one, one_jax


def _world(shape):
    return int(np.prod(shape))


def _one_device(tc, payload, batch):
    """The port's one-device step from ``payload`` on the whole batch (one
    thread, as each rank of a cohort runs: the CPU convs' sums depend on
    the thread count): (metrics, the state after it)."""
    cfg = dataclasses.replace(tc, parallel=tcfg.ParallelConfig())
    G, D = define_G(cfg), define_D(cfg)
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(0))
    load_state(state, payload)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m = make_train_step(cfg, G, D)(state, {
            k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        torch.set_num_threads(threads)
    return ({k: float(v) for k, v in m.items()},
            {"G": G.state_dict(), "D": D.state_dict(),
             "opt_g": adam_state(state.opt_g, G),
             "opt_d": adam_state(state.opt_d, D), "ema": state.ema})


def _ema_within(got, want):
    """The EMA twin no further from the reference's than G's parameters
    are (it moves by a share of their difference from it)."""
    for k, v in want["ema"].items():
        err = np.abs(got["ema"][k].numpy() - v.numpy())
        bound = np.abs(got["G"][k].numpy() - want["G"][k].numpy())
        assert (err <= bound + 1e-6).all(), k


@pytest.mark.parametrize("case", list(CASES))
def test_spatial_step_matches_jax_auto_step(cohorts, case):
    """Every step within the sharded-state lockstep's envelope of JAX's
    one-device step from the same state; the first step (from the fresh
    state) also within JAX's own limits of its GSPMD step (losses 2e-3
    rel, every parameter 1e-3 abs), and every step within the envelope of
    the port's one-device step from the same state."""
    runs, ranks, _, one_jax = cohorts
    tc, _, payloads, bs, want = runs[case]
    group = ranks[_world(CASES[case][1])]
    jm, after = want[0]
    got = group[0][case][0]
    assert set(got["metrics"]) == set(jm)
    for k, v in jm.items():
        assert abs(got["metrics"][k] - v) <= 2e-3 * abs(v), \
            (k, got["metrics"][k], v)
    for net in ("G", "D"):
        for k, v in after[net].items():
            err = float((got[net][k] - v).abs().max())
            assert err <= 1e-3, (net, k, err)
    checked = 0
    for i in range(len(want)):
        got = group[0][case][i]
        smooth = min(r[case][i]["relu_margin"] for r in group) > KINK
        checked += smooth
        jm1, jax_one = one_jax[case][i]
        compare_gan_step(payloads[i], jm1, jax_one, got, grads=smooth)
        om, one = _one_device(tc, payloads[i], bs[i])
        compare_gan_step(payloads[i], om, one, got, grads=smooth)
        if one["ema"] is not None:
            _ema_within(got, jax_one)
            _ema_within(got, one)
    assert checked >= 1


@pytest.mark.parametrize("case", list(CASES) + list(GLOBAL))
def test_ranks_of_a_spatial_line_agree(cohorts, case):
    _, ranks, _, _ = cohorts
    shape = CASES[case][1] if case in CASES else GLOBAL[case][1]
    res = [r[case] if case in CASES else [r[case]]
           for r in ranks[_world(shape)]]
    for other in res[1:]:
        for a, b in zip(res[0], other):
            assert a.get("steps", a["metrics"]) == b.get("steps",
                                                         b["metrics"])
            for net in ("G", "D"):
                for k, v in a[net].items():
                    assert torch.equal(v, b[net][k]), (case, net, k)


@pytest.mark.parametrize("case", list(GLOBAL))
def test_n_ranks_match_one_rank_over_three_drawn_steps(cohorts, case):
    _, ranks, one, _ = cohorts
    cfg, payload, raws, c_sd = one[case]
    got = ranks[_world(GLOBAL[case][1])][0][case]
    G, D = define_G(cfg), define_D(cfg)
    C = None
    if c_sd is not None:
        C = define_C(cfg)
        C.load_state_dict(c_sd)
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(0),
                               C=C, bin_anchors=ANCHORS if C else None)
    load_state(state, payload)
    step = make_parallel_train_step(cfg, G, D, state.C)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # as each rank of the cohort runs
    try:
        ms = [step(state, {k: torch.from_numpy(v) for k, v in raw.items()})
              for raw in raws]
    finally:
        torch.set_num_threads(threads)
    for i, m in enumerate(ms):
        assert set(m) == set(got["steps"][i])
        for k, v in m.items():
            assert_close(f"step {i} {k}", got["steps"][i][k], float(v),
                         1e-5)
    if C is not None:
        assert got["steps"][-1]["loss_G_cond"] > 0
    for net, opt, mod in (("G", "opt_g", G), ("D", "opt_d", D)):
        mine = adam_state(getattr(state, opt), mod)
        assert got[opt]["count"] == mine["count"] == 4
        for k, v in mod.state_dict().items():
            d = np.abs((got[net][k] - v).numpy())
            if k in mine["mu"]:
                # three Adam steps apart at most, the bulk far closer
                assert d.max() <= 3 * 2.1 * LR, (net, k, d.max())
                assert float(np.median(d)) < 1e-5, (net, k)
            else:       # batch norm's running stats: global moments
                assert_close(f"{net}.state.{k}", got[net][k], v, 1e-5)
    if state.ema is not None:
        for k, v in state.ema.items():
            assert float((got["ema"][k] - v).abs().max()) <= 3 * 2.1 * LR
    # each rank held its band of the pool; gathered, it is the pool
    _, shape, axes, _ = GLOBAL[case]
    assert got["band_pool"][0][1] == 32 // shape[axes.index("spatial")]
    assert got["pool"]["count"] == int(state.pool.count)
    assert_close("pool", got["pool"]["imgs"], state.pool.imgs, 1e-5)


def _mu_gap(got, want) -> float:
    """The largest first-moment gap of any tensor over its scale."""
    out = 0.0
    for opt in ("opt_g", "opt_d"):
        for k, w in want[opt]["mu"].items():
            w, g = np.asarray(w), np.asarray(got[opt]["mu"][k])
            out = max(out, float(np.abs(g - w).max()
                                 / (np.abs(w).max() + 1e-12)))
    return out


if __name__ == "__main__":
    # ``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
    # tests/test_torch_port_spatial_step.py``: each JAX case's losses (the
    # largest gap over 1 + |loss|) and first moments (``_mu_gap``) against
    # JAX's one-device step from the same state, of the port's cohort and
    # of JAX's GSPMD step
    import tempfile
    import conftest  # noqa: F401  (the CPU mesh's device count)
    with tempfile.TemporaryDirectory() as tmp:
        runs, ranks, _, one_jax = run_cohorts(__import__("pathlib").Path(
            tmp))
    for case in CASES:
        for i, (gm, gspmd) in enumerate(runs[case][4]):
            jm, ref = one_jax[case][i]
            got = ranks[_world(CASES[case][1])][0][case][i]
            gap = {who: max(abs(m[k] - v) / (1 + abs(v))
                            for k, v in jm.items())
                   for who, m in (("port", got["metrics"]), ("gspmd", gm))}
            print(f"{case} step {i}: port losses {gap['port']:.3g}, "
                  f"moments {_mu_gap(got, ref):.3g}; JAX GSPMD losses "
                  f"{gap['gspmd']:.3g}, moments {_mu_gap(gspmd, ref):.3g}")
