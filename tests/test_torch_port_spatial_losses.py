"""The loss and data levers under a ``spatial`` mesh axis (R1, the
gradient penalty, feature matching, VGG, DiffAugment and ADA on bands).

The band pieces, against the whole image, on one cohort of four gloo ranks
(``torch_port_parallel_worker.band_losses``, a 1 x 4 data x spatial mesh)
at heights that give even (32: 8 each), odd (30: 8+8+8+6, 13: 4+4+4+1),
1-row and empty bands (6: 2+2+2+0, 3: 1+1+1+0, 2: 1+1+0+0):

- second derivatives through the halo exchange and the key gather (their
  adjoints are autograd Functions whose backward is the forward
  collective): a layer's input gradient of ``sum(y * y * cot)`` taken with
  ``create_graph``, then the gradients of ``sum(gx * v)`` with respect to
  the input band and the parameters (summed over the line): D's convs
  (4x4 s2 and s1, zero pad), instance norm, group norm, self-attention
  (its pool and gather) and ``gather_band`` itself;
- R1 and the gradient penalty (each sample's squared input gradient summed
  over its band, then over the line, before the norm) with feature
  matching, on the PatchGAN D and on the multiscale D with attention and
  group norm: the losses, the input gradients of real and fake and D's
  parameter gradients;
- DiffAugment's ops with ADA's gates at p 0.5 (draws made for the whole
  batch): the translation window (rows ``[r0 - sy, r1 + sy)`` fetched,
  zero beyond the image), cutout by global row and the colour's per-sample
  mean over the line, forward and input gradient;
- the VGG19 perceptual loss (random trunk): its 3x3 convs on fetched
  windows, its max pools on bands (VALID: 30 rows pool to 15, 7, 3, 1),
  each tap's mean a band share, down to taps with 1-row and empty bands.

Everything within 1e-5 of scale in f32 (summation order); D's parameter
gradients within 1e-5 of the largest of them.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.models.vgg import init_vgg_vars
from pcgan_tpu.train import create_train_state as j_create_train_state
from pcgan_tpu.train import make_train_step as j_make_train_step

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch.convert import convert_train_state, convert_vgg16_params
from pcgan_tpu_torch.models import define_D, define_G
from pcgan_tpu_torch.models.vgg import random_vgg19
from pcgan_tpu_torch.ops import diffaug
from pcgan_tpu_torch.parallel.train_parallel import make_parallel_train_step
from pcgan_tpu_torch.train import create_train_state
from pcgan_tpu_torch.utils.checkpoint import adam_state, load_state, \
    save_state

from test_torch_port_parallel_step import KINK
from test_torch_port_spatial_levers import (DATA_1X4, DATA_2X2, SIZES,
                                            _batches, _compare, _mesh_cfg,
                                            _with_gamma)
from torch_port_levers import (LR, assert_close, cfgs, jax_aug_draws,
                               jax_models, step_keys)
from torch_port_parallel_worker import (build_piece, finish_cohort,
                                        loss_piece, run_cohort,
                                        run_loss_piece, second_piece,
                                        start_cohort)

WORLD, TOL = 4, 1e-5


def _cases():
    out = {}

    def add(name, heights, **spec):
        for h in heights:
            out[f"{name}_H{h}"] = {**spec, "H": h, "seed": len(out) + 301}

    def second(name, heights, **piece):
        for h in heights:
            out[f"second_{name}_H{h}"] = {
                "kind": "second", "H": h, "seed": len(out) + 301,
                "piece": {**piece, "H": h}}
    second("conv4_s2", (32, 13, 6), kind="conv", cin=3, cout=4, k=4, s=2,
           p=1, mode="zero")
    second("conv4_s1", (8, 6, 3), kind="conv", cin=3, cout=2, k=4, s=1,
           p=1, mode="zero")
    second("inorm", (30, 3), kind="inorm", cin=3)
    second("gnorm", (13, 3), kind="gnorm", cin=4)
    second("attn", (8, 6, 4), kind="attn", cin=16)
    second("gather", (8, 3, 2), kind="gather", cin=3)
    add("penalties_basic", (32, 30), kind="penalties", flags=[])
    add("penalties_ms_attn_group", (32,), kind="penalties",
        flags=["--netD", "multiscale", "--n_layers_D", "2", "--d_attn",
               "--norm", "group"])
    add("augment", (32, 30, 6, 3), kind="augment",
        policy="color,translation,cutout")
    add("vgg", (32, 30), kind="vgg", B=1)
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("spatial_losses")
    return run_cohort({"pieces": {"kind": "band_losses", "specs": CASES}},
                      work, world=WORLD, timeout=300)


def _whole(spec):
    """The case on the whole batch: (values, input gradients, parameter
    gradients), as the worker lays them out."""
    if spec["kind"] == "second":
        piece = dict(spec["piece"], seed=spec["seed"])
        mod, x, cond, cot = build_piece(piece)
        gx, grads = second_piece(mod, x, cond, cot, None, piece)
        return {"gx": gx}, grads[:1], grads[1:]
    mod, inp = loss_piece(spec)
    vals, grads = run_loss_piece(mod, inp, spec)
    return vals, grads[:1], grads[1:]


@pytest.mark.parametrize("name", list(CASES))
def test_band_loss_piece_matches_whole_image(ranks, name):
    spec = CASES[name]
    vals, gin, gw = _whole(spec)
    dim = 2 if spec["kind"] == "second" else 1    # NCHW pieces, NHWC
    got = [r["pieces"][name] for r in ranks]
    for k, v in vals.items():
        if k in ("gx", "y"):       # bands: put together along H
            assert_close(k, torch.cat([g[k] for g in got], dim), v, TOL)
        else:                       # the line's whole value on every rank
            for g in got:
                assert_close(k, g[k], v, TOL)
    for i, want in enumerate(gin):
        assert_close(f"input grad {i}",
                     torch.cat([g["gin"][i] for g in got], dim), want, TOL)
    # the parameter gradients at 1e-5 of the largest one: a conv bias
    # before a one-channel group (``--norm group`` at C <= 32) has a
    # gradient of 0 in exact arithmetic, f32 noise of the others' scale
    assert len(got[0]["gw"]) == len(gw)
    scale = max([1.0] + [float(w.abs().max()) for w in gw])
    for i, want in enumerate(gw):
        for g in got:
            err = float((g["gw"][i] - want).abs().max())
            assert err <= TOL * scale, (f"param grad {i}", err, scale)
    if spec["kind"] == "second":
        # the second derivative is not trivially zero
        assert any(float(w.abs().max()) > 0 for w in gin + gw)


# --------------------------------------------------------------------------- #
# band steps against JAX's one-device step, and N ranks against one
# --------------------------------------------------------------------------- #

STEPS, ADA_P = 2, 0.5
LOSS_CASES = {  # name: (model, train, crop, global batch, mesh)
    "r1_feat_vgg_aug_ada": (
        {}, dict(lambda_r1=10.0, lambda_feat=10.0, lambda_vgg=10.0,
                 vgg_path="random", diff_augment="color,translation,cutout",
                 ada_target=0.6, ada_kimg=0.008), 32, 2, DATA_1X4),
    "wgangp_ms_attn_group": (
        dict(netD="multiscale", n_layers_D=2, d_attn=True, norm="group"),
        dict(gan_mode="wgangp", lambda_feat=10.0, diff_augment="translation"),
        32, 2, DATA_2X2)}
GLOBAL_LOSSES = (["--lambda_r1", "10", "--lambda_feat", "10", "--lambda_vgg",
                  "10", "--vgg_path", "random", "--diff_augment",
                  "color,translation,cutout", "--ada_target", "0.6",
                  "--ada_kimg", "0.016", "--pool_size", "4"], 32, 4, DATA_2X2)


def _draws(jc, jstate, b, crop):
    """The JAX step's augmentation draws and GP weights at ``jstate`` for a
    global batch of ``b``, in the port's call order (``replay_jax_draws``):
    the fused D pass's 2B batch, GP's two endpoints, then G's pass."""
    t = jc.train
    names = diffaug.parse_policy(t.diff_augment)
    _, _, _, r_gp, r_aug = step_keys(jstate, bool(names))
    folds = [(0, 2 * b)] + ([(2, b), (3, b)] if t.gan_mode == "wgangp"
                            else []) + [(4, b)]
    aug = [((n, crop, crop, 3),
            jax_aug_draws(jax.random.fold_in(r_aug, k), names,
                          (n, crop, crop, 3), t.ada_target > 0))
           for k, n in folds] if names else []
    eps = (torch.from_numpy(np.array(jax.random.uniform(r_gp, (b, 1, 1, 1))))
           if t.gan_mode == "wgangp" else None)
    return {"aug": aug, "gp_eps": eps}


def _jax_loss_case(name):
    """(port cfg with the mesh, [payload before step i], [batch i], [(JAX
    metrics, payload after step i)], [draws of step i], the VGG trunk's
    state dict or None) of JAX's one-device step after a warm-up step
    (attention gammas at GAMMA, ADA's p set to ADA_P after it)."""
    model, train, crop, b, mesh = LOSS_CASES[name]
    jc, tc = cfgs(model=model, train=train,
                  data=dict(batch_size=b, crop_size=crop, load_size=crop))
    vgg_vars = vgg = None
    if jc.train.lambda_vgg > 0:
        vgg_vars = init_vgg_vars(jax.random.PRNGKey(0))
        vgg = convert_vgg16_params(vgg_vars["params"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        Gj, Dj = jax_models(jc)
    jstate = jax.jit(lambda r: j_create_train_state(
        jc, Gj, Dj, r, 1000, vgg_vars=vgg_vars))(jax.random.PRNGKey(3))
    jstate = jstate.replace(g_params=_with_gamma(jstate.g_params),
                            d_params=_with_gamma(jstate.d_params))
    jstep = jax.jit(j_make_train_step(jc, Gj, Dj, steps_per_epoch=1000))
    bs = _batches(STEPS + 1, crop, b, seed=len(name))

    def run(st, batch):
        return jstep(st, {k: jnp.asarray(v) for k, v in batch.items()})
    jstate, _ = run(jstate, bs[0])
    if jstate.aug_p is not None:
        jstate = jstate.replace(aug_p=jnp.full_like(jstate.aug_p, ADA_P))
    payloads, want, draws = [], [], []
    for batch in bs[1:]:
        payloads.append(convert_train_state(jax.device_get(jstate)))
        draws.append(_draws(jc, jstate, b, crop))
        jstate, jm = run(jstate, batch)
        want.append(({k: float(v) for k, v in jm.items()},
                     convert_train_state(jax.device_get(jstate))))
    return _mesh_cfg(tc, mesh), payloads, bs[1:], want, draws, vgg


def _global_loss_case(work):
    """(case for the cohort, one-device inputs) of the N-against-one run:
    a warm state after one one-device step, ADA's p then set to ADA_P, and
    three global u8 batches; the random VGG19 trunk (``--vgg_path
    random``'s) shared."""
    flags, crop, b, (shape, axes) = GLOBAL_LOSSES
    argv = SIZES + flags + ["--batch_size", str(b), "--crop_size",
                            str(crop), "--load_size", str(crop + 4)]
    cfg = tcfg.parse_config(argv)
    G = define_G(cfg, torch.Generator().manual_seed(1))
    D = define_D(cfg, torch.Generator().manual_seed(2))
    vgg = random_vgg19(0)
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(5),
                               vgg=vgg)
    rng = np.random.default_rng(23)
    raws = [{"image": rng.integers(0, 256, (b, crop + 4, crop + 4, 3),
                                   np.uint8),
             "bin": rng.integers(0, 4, b).astype(np.int64)}
            for _ in range(4)]
    make_parallel_train_step(cfg, G, D)(
        state, {k: torch.from_numpy(v) for k, v in raws[0].items()})
    state.aug_p = torch.tensor(ADA_P)
    save_state(state, str(work), "losses", "warm")
    payload = torch.load(work / "losses" / "warm.pt", weights_only=False)
    mesh = ["--mesh_shape", ",".join(map(str, shape)), "--mesh_axes",
            ",".join(axes)]
    case = {"kind": "spatial_steps", "cfg": tcfg.parse_config(argv + mesh),
            "payload": payload, "batches": raws[1:], "shape": shape,
            "axes": axes, "vgg": vgg.state_dict()}
    return case, (cfg, payload, raws[1:], vgg)


def _one_device_losses(cfg, payload, raws, vgg):
    """The one-device port's three steps from the warm state, on one
    thread (as each rank runs): (metrics, state, G, D)."""
    G, D = define_G(cfg), define_D(cfg)
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(0),
                               vgg=vgg)
    load_state(state, payload)
    step = make_parallel_train_step(cfg, G, D)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ms = [step(state, {k: torch.from_numpy(v) for k, v in raw.items()})
              for raw in raws]
    finally:
        torch.set_num_threads(threads)
    return ms, state, G, D


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(JAX's runs, their cohort's ranks, the one-device run of the
    N-against-one case, its cohort's ranks): the cohort without JAX inputs
    runs while the one-device port and JAX step, JAX's cases in threads."""
    work = tmp_path_factory.mktemp("spatial_loss_steps")
    case, one = _global_loss_case(work)
    started = start_cohort({"global_losses": case}, work, world=WORLD,
                           tag="global")
    one = _one_device_losses(*one)
    with ThreadPoolExecutor(len(LOSS_CASES)) as pool:
        runs = dict(zip(LOSS_CASES, pool.map(_jax_loss_case, LOSS_CASES)))
    jax_ranks = run_cohort({
        name: {"kind": "sharded_steps", "cfg": tc, "payloads": payloads,
               "batches": bs, "draws": draws, "vgg": vgg,
               "shape": LOSS_CASES[name][4][0],
               "axes": LOSS_CASES[name][4][1]}
        for name, (tc, payloads, bs, _, draws, vgg) in runs.items()},
        work, world=WORLD, timeout=300)
    return runs, jax_ranks, one, finish_cohort(started, timeout=300)


def _group_biases(tc):
    """(net, name) of each conv bias of G and D that a one-channel group
    norm follows (inert: ``test_torch_port_spatial_levers._compare``),
    the conv named after its norm."""
    import re
    from pcgan_tpu_torch.models.layers import GroupNorm
    out = set()
    for net, model in (("G", define_G(tc)), ("D", define_D(tc))):
        mods = dict(model.named_modules())
        for name, norm in mods.items():
            if not (isinstance(norm, GroupNorm)
                    and norm.groups == norm.weight.shape[0]):
                continue
            conv = re.sub(r"norms\.(\d+)$",
                          lambda m: f"convs.{int(m[1]) + 1}", name)
            conv = re.sub(r"_norm(\.\d+)?$", r"\1",
                          re.sub(r"norm(\d+)$", r"conv\1", conv))
            if getattr(mods[conv], "bias", None) is not None:
                out.add((net, f"{conv}.bias"))
    return out


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_band_step_matches_jax_step(steps, case):
    runs, ranks, _, _ = steps
    tc, payloads, _, want, _, _ = runs[case]
    inert = _group_biases(tc)
    checked = 0
    for i, (jm, after) in enumerate(want):
        smooth = min(r[case][i]["relu_margin"] for r in ranks) > KINK
        checked += smooth
        _compare(payloads[i], jm, after, ranks[0][case][i], smooth, inert)
    assert checked >= 1
    if "ada_p" in want[0][0]:      # p moved, alike in both
        assert {round(jm["ada_p"], 6) for jm, _ in want} != {ADA_P}


@pytest.mark.parametrize("case", list(LOSS_CASES) + ["global_losses"])
def test_ranks_of_a_loss_line_agree(steps, case):
    _, jax_ranks, _, global_ranks = steps
    res = ([r[case] for r in jax_ranks] if case in LOSS_CASES
           else [[r[case]] for r in global_ranks])
    for other in res[1:]:
        for a, b in zip(res[0], other):
            assert a.get("steps", a["metrics"]) == b.get("steps",
                                                         b["metrics"])
            for net in ("G", "D"):
                for k, v in a[net].items():
                    assert torch.equal(v, b[net][k]), (case, net, k)


def test_loss_ranks_match_one_rank_over_three_drawn_steps(steps):
    """N ranks against the one-device port over three drawn steps (every
    draw made for the global batch: B1's crops and flips, the target bins,
    the pool, the augmentation and ADA's gates), ADA's p moving alike."""
    _, _, (ms, state, G, D), ranks = steps
    got = ranks[0]["global_losses"]
    ps = [float(m["ada_p"]) for m in ms]
    assert len(set(ps)) > 1, ps
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
            assert float(np.median(d)) < 1e-5, (net, k)
    assert got["pool"]["count"] == int(state.pool.count)
    assert_close("pool", got["pool"]["imgs"], state.pool.imgs, 1e-5)
    for seen in (s for r in ranks for s in r["global_losses"]["saved"]):
        assert seen["whole"] == [], seen["whole"][:4]
