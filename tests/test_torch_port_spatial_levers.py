"""The model levers under a ``spatial`` mesh axis (ROADMAP.md A10d items
1-6: attention, the multiscale D, the U-Net, the resize conv, group norm,
dropout and ``--remat`` on bands) over gloo cohorts of four ranks.

Against JAX (golden sizes: ngf/ndf 8, 4 bins, f32, ``--lr_policy
constant``, pool off, target bins pinned, ``with_preprocess=False``): JAX
draws the weights, sets every attention block's ``gamma`` to 0.5 (at 0 the
block is the identity) and takes a warm-up step; before each of two steps
its state is carried into the port and each rank takes the step on its
band (of its rows). Every step is held to JAX's one-device
``make_train_step`` from the same state on the same batch within the
sharded-state lockstep's envelope (``test_torch_port_auto_step.py``):
losses 1e-4 abs + rel, Adam's first moments 1e-4 of scale away from a
ReLU kink, the parameters within the one-step Adam envelope. Dropout
replays JAX's masks (``test_torch_port_unet_step._jax_dropout_masks``),
drawn for the global batch, each rank keeping its rows and its band. The
cases:

- ``resize_attn_multiscale_group`` at data 1 x spatial 4, 32 px:
  ``resnet_6blocks@resize_conv --g_attn --d_attn --netD multiscale
  --n_layers_D 2 --norm group`` (G's attention on 2-row bands, D_1's on
  1-row bands, D_1's patch map 2 rows over four ranks);
- ``dropout_remat`` at data 2 x spatial 2, 32 px: ``resnet_6blocks
  --no-no_dropout --remat`` (the masks need the data rows);
- ``unet64_dropout_remat`` at data 1 x spatial 4, 64 px: ``unet_64
  --no-no_dropout --remat --cond_inject input`` (one dropout level, the
  innermost levels on 1-row and empty bands; unet_32 has no dropout
  level; at the bottleneck injection the one-hot's exact zeros meet a
  ReLU, a kink at every step).

N ranks against one (the port alone, everything drawn: B1's plain twin
writes each rank's band of the crops, flips, target bins, pool slots and
dropout masks drawn for the global batch; gamma 0.5): from a state the
one-device port saved after a warm-up step, three steps on u8 canvases
equal the one-device steps on the global batch (run on one thread, as each
rank runs), losses within 1e-5 rel, the parameters within three Adam
steps' envelope, the pool (gathered from its bands) within 1e-5. The
cases: the resnet G with every lever (``@resize_conv --g_attn --d_attn
--netD multiscale --n_layers_D 2 --norm group --no-no_dropout --remat
--remat_blocks 3``) at data 2 x spatial 2, and ``unet_64 --no-no_dropout
--remat --grad_accum 2`` at data 1 x spatial 4 (each microbatch's
backward, and its recompute, inside the band context). Every rank of a
line holds the same bits.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import dataclasses
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.train import create_train_state as j_create_train_state
from pcgan_tpu.train import make_train_step as j_make_train_step

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch.convert import convert_train_state
from pcgan_tpu_torch.models import define_D, define_G
from pcgan_tpu_torch.parallel.spatial import SavedAudit
from pcgan_tpu_torch.parallel.train_parallel import make_parallel_train_step
from pcgan_tpu_torch.train import create_train_state
from pcgan_tpu_torch.utils.checkpoint import adam_state, load_state, \
    save_state

from test_torch_port_parallel_step import KINK, compare_gan_step
from test_torch_port_unet_step import _jax_dropout_masks
from torch_port_levers import LR, NB, assert_close, cfgs, jax_models
from torch_port_parallel_worker import finish_cohort, run_cohort, \
    start_cohort

WORLD, STEPS, GAMMA = 4, 2, 0.5
INERT = 2e-6    # a first moment below this: a gradient of 0 (``_compare``)
DATA_1X4 = ((1, 4), ("data", "spatial"))
DATA_2X2 = ((2, 2), ("data", "spatial"))
RESIZE_ATTN = dict(netG="resnet_6blocks@resize_conv", g_attn=True,
                   d_attn=True, netD="multiscale", n_layers_D=2, norm="group")
CASES = {  # name: (model overrides, crop, global batch, mesh)
    "resize_attn_multiscale_group": (RESIZE_ATTN, 32, 2, DATA_1X4),
    "dropout_remat": (dict(no_dropout=False, remat=True), 32, 4, DATA_2X2),
    "unet64_dropout_remat": (dict(netG="unet_64", no_dropout=False,
                                  remat=True, cond_inject="input"), 64, 2,
                             DATA_1X4)}
SIZES = ["--n_age_bins", "4", "--ngf", "8", "--ndf", "8", "--dtype",
         "float32", "--lr_policy", "constant", "--cond_inject", "bottleneck",
         "--device", "cpu"]
GLOBAL = {  # name: (flags, crop, global batch, mesh)
    "global_resnet_levers": (
        ["--netG", "resnet_6blocks@resize_conv", "--g_attn", "--d_attn",
         "--netD", "multiscale", "--n_layers_D", "2", "--norm", "group",
         "--no-no_dropout", "--remat", "--remat_blocks", "3", "--pool_size",
         "4"], 32, 4, DATA_2X2),
    "global_unet64_accum": (["--netG", "unet_64", "--no-no_dropout",
                             "--remat", "--grad_accum", "2", "--pool_size",
                             "4"], 64, 2, DATA_1X4)}


def _mesh_cfg(tc, mesh):
    shape, axes = mesh
    return dataclasses.replace(tc, parallel=tcfg.ParallelConfig(
        mesh_shape=shape, mesh_axes=axes))


def _with_gamma(params):
    """Every attention block's gamma at GAMMA."""
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.full_like(v, GAMMA)
                         if getattr(path[-1], "key", None) == "gamma" else v),
        params)


def _batches(n, crop, b, seed):
    rng = np.random.default_rng(seed)
    return [{"image": rng.random((b, crop, crop, 3), np.float32) * 2 - 1,
             "bin": rng.integers(0, NB, b).astype(np.int32),
             "target_bin": rng.integers(0, NB, b).astype(np.int32)}
            for _ in range(n)]


def _jax_case(name):
    """(port cfg with the mesh, [payload before step i], [batch i], [(JAX
    metrics, payload after step i)], [dropout masks of step i]) of JAX's
    one-device step after a warm-up step."""
    model, crop, b, mesh = CASES[name]
    jc, tc = cfgs(model=model, data=dict(batch_size=b, crop_size=crop,
                                         load_size=crop))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        Gj, Dj = jax_models(jc)
    jstate = jax.jit(lambda r: j_create_train_state(jc, Gj, Dj, r, 1000))(
        jax.random.PRNGKey(3))
    jstate = jstate.replace(g_params=_with_gamma(jstate.g_params),
                            d_params=_with_gamma(jstate.d_params))
    jstep = jax.jit(j_make_train_step(jc, Gj, Dj, steps_per_epoch=1000))
    bs = _batches(STEPS + 1, crop, b, seed=len(name))

    def run(st, batch):
        return jstep(st, {k: jnp.asarray(v) for k, v in batch.items()})
    jstate, _ = run(jstate, bs[0])
    payloads, want, keeps = [], [], []
    for batch in bs[1:]:
        payloads.append(convert_train_state(jax.device_get(jstate)))
        keeps.append(_jax_dropout_masks(jc, Gj, jstate, batch)
                     if model.get("no_dropout") is False else None)
        jstate, jm = run(jstate, batch)
        want.append(({k: float(v) for k, v in jm.items()},
                     convert_train_state(jax.device_get(jstate))))
    return _mesh_cfg(tc, mesh), payloads, bs[1:], want, keeps


def _global_case(name, work):
    """(case for the cohort, one-device inputs) of an N-against-one run:
    a warm state after one one-device step (gamma at GAMMA), three global
    u8 batches."""
    flags, crop, b, (shape, axes) = GLOBAL[name]
    argv = SIZES + flags + ["--batch_size", str(b), "--crop_size",
                            str(crop), "--load_size", str(crop + 4)]
    cfg = tcfg.parse_config(argv)
    G = define_G(cfg, torch.Generator().manual_seed(1))
    D = define_D(cfg, torch.Generator().manual_seed(2))
    with torch.no_grad():
        for net in (G, D):
            for k, p in net.named_parameters():
                if k.endswith("gamma"):
                    p.fill_(GAMMA)
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(19)
    raws = [{"image": rng.integers(0, 256, (b, crop + 4, crop + 4, 3),
                                   np.uint8),
             "bin": rng.integers(0, 4, b).astype(np.int64)}
            for _ in range(4)]
    make_parallel_train_step(cfg, G, D)(
        state, {k: torch.from_numpy(v) for k, v in raws[0].items()})
    save_state(state, str(work), name, "warm")
    payload = torch.load(work / name / "warm.pt", weights_only=False)
    mesh = ["--mesh_shape", ",".join(map(str, shape)), "--mesh_axes",
            ",".join(axes)]
    case = {"kind": "spatial_steps", "cfg": tcfg.parse_config(argv + mesh),
            "payload": payload, "batches": raws[1:], "shape": shape,
            "axes": axes}
    return case, (cfg, payload, raws[1:])


def _one_device(name, cfg, payload, raws):
    """The one-device port's three steps of an N-against-one case from its
    warm state, on one thread (as each rank of the cohort runs), the first
    under ``spatial.SavedAudit`` at the case's spatial size: (metrics,
    state, G, D, the audit)."""
    shape, axes = GLOBAL[name][3]
    G, D = define_G(cfg), define_D(cfg)
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(0))
    load_state(state, payload)
    step = make_parallel_train_step(cfg, G, D)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with SavedAudit(dict(zip(axes, shape))["spatial"]) as audit:
            ms = [step(state, {k: torch.from_numpy(v)
                               for k, v in raws[0].items()})]
        ms += [step(state, {k: torch.from_numpy(v) for k, v in raw.items()})
               for raw in raws[1:]]
    finally:
        torch.set_num_threads(threads)
    return ms, state, G, D, audit


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    """(JAX's runs, their cohort's ranks, the one-device runs of the
    N-against-one cases, their cohort's ranks); the cohort without JAX
    inputs runs while the one-device port and JAX step, JAX's cases in
    threads (XLA compiles outside the GIL)."""
    work = tmp_path_factory.mktemp("spatial_levers")
    one, cases = {}, {}
    for name in GLOBAL:
        cases[name], one[name] = _global_case(name, work)
    started = start_cohort(cases, work, world=WORLD, tag="global")
    one = {name: _one_device(name, *one[name]) for name in GLOBAL}
    with ThreadPoolExecutor(len(CASES)) as pool:
        runs = dict(zip(CASES, pool.map(_jax_case, CASES)))
    jax_ranks = run_cohort({
        name: {"kind": "sharded_steps", "cfg": tc, "payloads": payloads,
               "batches": bs, "keeps": keeps, "shape": CASES[name][3][0],
               "axes": CASES[name][3][1]}
        for name, (tc, payloads, bs, _, keeps) in runs.items()},
        work, world=WORLD, timeout=300)
    return runs, jax_ranks, one, finish_cohort(started, timeout=300)


@pytest.mark.parametrize("case", list(CASES))
def test_lever_band_step_matches_jax_step(cohorts, case):
    runs, ranks, _, _ = cohorts
    _, payloads, _, want, keeps = runs[case]
    if keeps[0] is not None:      # JAX's masks kept half the units
        assert all(0.3 < float(m.float().mean()) < 0.7
                   for k in keeps for m in k.values())
    checked = 0
    for i, (jm, after) in enumerate(want):
        smooth = min(r[case][i]["relu_margin"] for r in ranks) > KINK
        checked += smooth
        _compare(payloads[i], jm, after, ranks[0][case][i], smooth)
    assert checked >= 1


def _compare(start, jm, want, got, grads, inert=()):
    """``compare_gan_step``, but for the inert tensors: a conv bias that a
    one-channel group (``--norm group`` at C <= 32) subtracts again has a
    gradient of 0 in exact arithmetic, so both frameworks step it by Adam's
    sign of f32 noise; those are held to the sign-flip bound alone, 2.1
    lr (as ``chip_smoke.py _envelope`` holds the stem's condition
    channels). They are the tensors whose reference first moment is below
    INERT, and ``inert``'s ((net, name) pairs known to be such biases,
    whose noise scales with the step's other gradients)."""
    inert = {(net, k) for net, opt in (("G", "opt_g"), ("D", "opt_d"))
             for k, mu in want[opt]["mu"].items()
             if float(np.abs(np.asarray(mu)).max()) < INERT} | set(inert)

    def live(p):
        q = dict(p)
        for net, opt in (("G", "opt_g"), ("D", "opt_d")):
            q[net] = {k: v for k, v in p[net].items()
                      if (net, k) not in inert}
            q[opt] = {**p[opt], "mu": {k: v for k, v in p[opt]["mu"].items()
                                       if (net, k) not in inert}}
        return q
    compare_gan_step(live(start), jm, live(want), live(got), grads=grads)
    for net, k in inert:
        d = ((got[net][k] - start[net][k]) - (want[net][k] - start[net][k]))
        assert float(d.abs().max()) <= 2.1 * LR, (net, k)


@pytest.mark.parametrize("case", list(CASES) + list(GLOBAL))
def test_ranks_of_a_lever_line_agree(cohorts, case):
    _, jax_ranks, _, global_ranks = cohorts
    res = ([r[case] for r in jax_ranks] if case in CASES
           else [[r[case]] for r in global_ranks])
    for other in res[1:]:
        for a, b in zip(res[0], other):
            assert a.get("steps", a["metrics"]) == b.get("steps",
                                                         b["metrics"])
            for net in ("G", "D"):
                for k, v in a[net].items():
                    assert torch.equal(v, b[net][k]), (case, net, k)


@pytest.mark.parametrize("case", list(GLOBAL))
def test_lever_ranks_match_one_rank_over_three_drawn_steps(cohorts, case):
    _, _, one, ranks = cohorts
    ms, state, G, D, _ = one[case]
    got = ranks[0][case]
    for i, m in enumerate(ms):
        assert set(m) == set(got["steps"][i])
        for k, v in m.items():
            assert_close(f"step {i} {k}", got["steps"][i][k], float(v),
                         1e-5)
    for net, opt, mod in (("G", "opt_g", G), ("D", "opt_d", D)):
        mine = adam_state(getattr(state, opt), mod)
        assert got[opt]["count"] == mine["count"] == 4
        for k, v in mod.state_dict().items():
            d = np.abs((got[net][k] - v).numpy())
            assert d.max() <= 3 * 2.1 * LR, (net, k, d.max())
            # the bulk far closer, but for a gradient of 0 (``_compare``)
            assert (float(np.median(d)) < 1e-5
                    or float(mine["mu"][k].abs().max()) < INERT), (net, k)
    assert got["pool"]["count"] == int(state.pool.count)
    assert_close("pool", got["pool"]["imgs"], state.pool.imgs, 1e-5)


@pytest.mark.parametrize("case", list(GLOBAL))
def test_lever_ranks_keep_no_whole_image(cohorts, case):
    """No rank of a lever line keeps a whole square image for the backward
    (``spatial.SavedAudit``: no lever computes on the whole image), where
    the one-device step keeps some; each rank keeps under twice its share
    (1 / ranks) of what the one-device step keeps (0.28-0.41 of it at
    these sizes, for shares of 0.25)."""
    _, _, one, ranks = cohorts
    plain = one[case][4]            # the one-device port's first step
    assert plain.whole, "the audit saw no whole image in the plain step"
    for r in ranks:
        for i, seen in enumerate(r[case]["saved"]):
            assert seen["whole"] == [], (case, i, seen["whole"][:4])
            assert (seen["saved_bytes"] * len(ranks)
                    < 2 * plain.saved_bytes), (case, i, seen["saved_bytes"])
