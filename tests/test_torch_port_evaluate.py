"""The port's evaluator and its CLIs against the JAX package, end to end on
the CPU at the golden small shape (32 px crop from 36, ``ngf 8``,
``resnet_6blocks``, 4 bins, f32, comparator ``cmp_nf 8``), numpy-seeded
inputs and converted G and C weights.

Tolerances (the feature rows are f32 sums through G, the feature net and
the moments, in another summation order):

- Streamed moments (count, s, ss) and the retained feature rows within
  1e-4 of their largest entry; the target bins and the eval row count
  exact; ``cond_accuracy`` exact.
- ``fid`` in the full-rank case (comparator features, d 32, 64 images)
  within 1e-4 of the larger of itself and tr C1 + tr C2 (FID cancels the
  traces against 2 tr sqrtm, so its f32 error scales with them). With the
  random features (d 192) and 24 images the covariances are
  rank-deficient: ``sqrt(max(w, eps))`` of the near-zero eigenvalues
  varies between LAPACK builds by more than the moments do, so ``fid`` and
  the per-bin FIDs are held within 2e-3 relative (measured: 3.3e-5
  relative on the CPU).
- KID with one subset of every row (the draw then does not matter) within
  1e-3 relative + 5e-6 (it cancels kernel means of order 1 in f32;
  measured up to 1.7e-6); PRDC within 1e-6; SSIM within 1e-5; IS within
  1e-4.
- Stats files written by either framework's ``compute_fid_stats`` give
  the same ``fid`` through either framework's ``evaluate --fid_stats``,
  within the rank-deficient tolerance above.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu import config as jcfg
from pcgan_tpu import eval_lib as jeval
from pcgan_tpu.models.registry import define_C as j_define_C
from pcgan_tpu.models.registry import define_G as j_define_G
from pcgan_tpu.models.registry import init_params
from pcgan_tpu.ops import fid as jfid
from pcgan_tpu.ops import kid as jkid

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch import eval_lib as teval
from pcgan_tpu_torch import evaluate as port_evaluate
from pcgan_tpu_torch import train_main
from pcgan_tpu_torch.convert import (convert_comparator_params,
                                     convert_generator_params)
from pcgan_tpu_torch.models import define_C, define_G
from pcgan_tpu_torch.ops import fid as tfid
from pcgan_tpu_torch.ops import kid as tkid
from pcgan_tpu_torch.tools import compute_fid_stats as port_stats
from pcgan_tpu_torch.utils.checkpoint import save_generator

B, LOAD, S, NB, NF, CNF = 4, 36, 32, 4, 8, 8
RANK_DEFICIENT_RTOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the host's cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _cfgs(cond_mode="onehot", **run):
    kw = dict(
        data=dict(n_age_bins=NB, crop_size=S, load_size=LOAD, batch_size=B),
        model=dict(netG="resnet_6blocks", ngf=NF, cmp_nf=CNF, cmp_n_down=3,
                   dtype="float32", cond_inject="bottleneck",
                   cond_mode=cond_mode),
        run=dict(kid_subsets=1, kid_subset_size=1000, prdc_k=3, **run))
    return tuple(mod.Config(data=mod.DataConfig(**kw["data"]),
                            model=mod.ModelConfig(**kw["model"]),
                            run=mod.RunConfig(**kw["run"]))
                 for mod in (jcfg, tcfg))


def _nets(jc, tc):
    """Seeded JAX G and C, and the port's twins on converted weights."""
    cond_nc = 1 if tc.model.cond_mode == "score" else NB
    jG, jC = j_define_G(jc), j_define_C(jc)
    gp = init_params(jG, jax.random.PRNGKey(5), jnp.zeros((1, S, S, 3)),
                     jnp.zeros((1, cond_nc)), train=False)["params"]
    cp = init_params(jC, jax.random.PRNGKey(6), jnp.zeros((1, S, S, 3)),
                     train=False)["params"]
    G, C = define_G(tc), define_C(tc)
    G.load_state_dict(convert_generator_params(gp))
    C.load_state_dict(convert_comparator_params(cp))
    return (jG, gp, jC, cp), (G.eval(), C.eval())


def _batches(seed, n, b=B):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (b, LOAD, LOAD, 3), np.uint8),
             "bin": rng.integers(0, NB, b).astype(np.int32)}
            for _ in range(n // b)]


def _anchors(C, batches):
    """Score intervals that split the comparator's scores of the inputs,
    so cond_accuracy is neither 0 nor 1."""
    with torch.no_grad():
        x = torch.from_numpy(np.concatenate([b["image"] for b in batches])
                             [:, :S, :S].astype(np.float32) / 127.5 - 1)
        mu = C(x)[0].numpy()
    q = np.quantile(mu, np.linspace(0, 1, NB + 1)).astype(np.float32)
    lo, hi = q[:-1].copy(), q[1:].copy()
    lo[0], hi[-1] = -1e3, 1e3
    return lo, hi, ((lo + hi) / 2).astype(np.float32)


class _Spy:
    """Records the inputs of the metric functions both evaluators call."""

    def __init__(self, monkeypatch):
        self.rec = {"jax": {}, "port": {}}
        for side, fidm, kidm, evm in (("jax", jfid, jkid, jeval),
                                      ("port", tfid, tkid, teval)):
            self._wrap(monkeypatch, fidm, "fid_from_stats", side, "stats")
            self._wrap(monkeypatch, kidm, "kid_from_features", side, "rows")
            self._wrap(monkeypatch, evm, "_per_bin_fid", side, "bins")

    def _wrap(self, mp, mod, name, side, key):
        real = getattr(mod, name)

        def f(*a, **k):
            leaves = jax.tree_util.tree_leaves(a[0]) if side == "jax" else []
            if not any(isinstance(x, jax.core.Tracer) for x in leaves):
                self.rec[side].setdefault(key, a)
            return real(*a, **k)
        mp.setattr(mod, name, f)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _near(a, b, frac):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=frac * np.abs(b).max())


def _run_both(jc, tc, jnets, tnets, batches, bundle, monkeypatch, n):
    jG, gp, jC, cp = jnets
    G, C = tnets
    lo, hi, means = bundle
    spy = _Spy(monkeypatch)
    with jax.default_matmul_precision("highest"):
        want = jeval.make_fid_evaluator(
            jc, jG, (jC, {"params": cp}, lo, hi, means))(
                {"params": gp}, iter(batches), max_images=n, seed=0)
    times = {}
    got = teval.make_fid_evaluator(
        tc, (C, *(torch.from_numpy(a) for a in bundle)), "cpu")(
            G, iter(batches), max_images=n, seed=0, times=times)
    # the optional wall-time split: one entry a batch, every part timed
    assert len(times["batch"]) == len(batches)
    assert all(times[k] > 0 for k in ("g", "features", "epilogue"))
    return want, got, spy.rec


def _assert_common(want, got, rec, fid_rtol):
    assert set(got) == set(want)
    assert got["fid_images"] == want["fid_images"]
    (jr, jf), (tr, tf) = rec["jax"]["stats"], rec["port"]["stats"]
    for j, t in ((jr, tr), (jf, tf)):
        assert float(t.count) == float(j.count)
        _near(t.s, j.s, 1e-4)
        _near(t.ss, j.ss, 1e-4)
    for a, c in zip(rec["port"]["rows"][:2], rec["jax"]["rows"][:2]):
        _near(a, c, 1e-4)
    # FID cancels tr c1 + tr c2 against 2 tr sqrtm(...): its error scales
    # with the traces, not with its own (possibly tiny) value
    scale = sum(float(np.trace(_np(jfid.finalize(st)[1]))) for st in (jr, jf))
    assert abs(got["fid"] - want["fid"]) <= fid_rtol * max(abs(want["fid"]),
                                                           scale)
    assert got["cond_accuracy"] == want["cond_accuracy"]
    assert 0.0 < got["cond_accuracy"] < 1.0
    # KID cancels kernel means of order 1 summed in f32
    assert abs(got["kid"] - want["kid"]) <= 1e-3 * abs(want["kid"]) + 5e-6
    for k in ("precision", "recall", "density", "coverage"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    if "ssim" in want:
        assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-5)
    if "is_mean" in want:
        assert got["is_mean"] == pytest.approx(want["is_mean"], rel=1e-4)
        assert got["is_std"] == pytest.approx(want["is_std"], rel=1e-3,
                                              abs=1e-6)


@pytest.mark.parametrize("mode", ["onehot", "score"])
def test_evaluator_matches_jax_random_features(mode, monkeypatch):
    flags = dict(kid=True, prdc=True, ssim=True, is_score=True,
                 fid_per_bin=(mode == "onehot"))
    jc, tc = _cfgs(mode, **flags)
    jnets, tnets = _nets(jc, tc)
    batches = _batches(1, 24)
    bundle = _anchors(tnets[1], batches)
    want, got, rec = _run_both(jc, tc, jnets, tnets, batches, bundle,
                               monkeypatch, 24)
    assert got["fid_images"] == 24
    _assert_common(want, got, rec, RANK_DEFICIENT_RTOL)
    if mode == "onehot":
        (_, jbr, _, jbf, _), (_, tbr, _, tbf, _) = (rec["jax"]["bins"],
                                                    rec["port"]["bins"])
        np.testing.assert_array_equal(_np(tbr), _np(jbr))
        np.testing.assert_array_equal(_np(tbf), _np(jbf))
        bins = [k for k in want if k.startswith("fid_bin_")]
        assert bins and {k for k in got if k.startswith("fid_bin_")} == \
            set(bins)
        for k in bins + ["fid_per_bin_mean"]:
            assert abs(got[k] - want[k]) <= RANK_DEFICIENT_RTOL * abs(want[k])


def test_evaluator_matches_jax_full_rank_comparator_features(monkeypatch):
    """--fid_features comparator: d = 4 * cmp_nf = 32 and 64 images, so
    the covariances have full rank and FID agrees tightly."""
    jc, tc = _cfgs(fid_features="comparator", kid=True, prdc=True)
    jnets, tnets = _nets(jc, tc)
    batches = _batches(2, 64, b=8)
    bundle = _anchors(tnets[1], batches)
    jc = jcfg.replace(jc, data=jcfg.replace(jc.data, batch_size=8))
    tc = tcfg.replace(tc, data=tcfg.replace(tc.data, batch_size=8))
    want, got, rec = _run_both(jc, tc, jnets, tnets, batches, bundle,
                               monkeypatch, 64)
    assert rec["port"]["stats"][0].s.shape == (4 * CNF,)
    _assert_common(want, got, rec, 1e-4)


def test_evaluator_refuses_instead_of_falling_back(tmp_path):
    _, tc = _cfgs(kid=True, prdc=True)
    G, C = define_G(tc).eval(), define_C(tc).eval()
    bundle = (C, torch.zeros(NB), torch.ones(NB), None)

    def cfg(**run):
        return tcfg.replace(tc, run=tcfg.replace(tc.run, **run))
    with pytest.raises(FileNotFoundError):
        teval.make_fid_evaluator(
            cfg(fid_features=f"pth:{tmp_path / 'none.pth'}"), None, "cpu")
    with pytest.raises(ValueError, match="--comparator_path"):
        teval.make_fid_evaluator(cfg(fid_features="comparator"), None, "cpu")
    run = teval.make_fid_evaluator(tc, bundle, "cpu")
    with pytest.raises(ValueError, match="finite eval budget"):
        run(G, iter(_batches(0, 8)), max_images=0)
    with pytest.raises(ValueError, match="--prdc needs more than"):
        run(G, iter(_batches(0, 3, b=3)), max_images=3)
    grow = _batches(0, 4) + _batches(1, 16, b=16)
    with pytest.raises(ValueError, match="exceeds the KID/per-bin"):
        run(G, iter(grow), max_images=8)
    stats = tfid.init_stats(192)
    stats.count += 10
    for meta, match in (({"fid_features": "random", "crop_size": S + 1},
                         "crop_size"),
                        ({"fid_features": "comparator", "crop_size": S},
                         "--fid_features")):
        tfid.save_stats(str(tmp_path / "s.npz"), stats, meta)
        with pytest.raises(ValueError, match=match):
            teval.make_fid_evaluator(cfg(fid_stats=str(tmp_path / "s.npz")),
                                     None, "cpu")
    tfid.save_stats(str(tmp_path / "d.npz"), tfid.init_stats(8), {})
    with pytest.raises(ValueError, match="feature dim 8"):
        teval.make_fid_evaluator(cfg(fid_stats=str(tmp_path / "d.npz")),
                                 None, "cpu")
    with pytest.raises(NotImplementedError, match="one device"):
        teval.check_one_device(tcfg.parse_config(["--mesh_shape", "2"]))


# --------------------------------------------------------------------------- #
# the CLIs
# --------------------------------------------------------------------------- #


CLI = ["--dataset_mode", "synthetic", "--max_dataset_size", "16",
       "--batch_size", str(B), "--load_size", str(LOAD), "--crop_size",
       str(S), "--netG", "resnet_6blocks", "--ngf", str(NF), "--n_age_bins",
       str(NB), "--dtype", "float32", "--cond_inject", "bottleneck",
       "--name", "run", "--mesh_shape", "1"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One seeded G saved for both frameworks' CLIs."""
    from pcgan_tpu.utils import checkpoint as jax_ckpt
    root = tmp_path_factory.mktemp("ck")
    jG = j_define_G(jcfg.parse_config(CLI, is_train=False))
    gp = init_params(jG, jax.random.PRNGKey(5), jnp.zeros((1, S, S, 3)),
                     jnp.zeros((1, NB)), train=False)["params"]
    jax_ckpt.save({"g_params": gp, "g_state": {}}, str(root / "jck"), "run",
                  "latest_G", wait=True)
    G = define_G(tcfg.parse_config(CLI, is_train=False))
    G.load_state_dict(convert_generator_params(gp))
    save_generator(G, str(root / "pck"), "run")
    return root


def test_stats_files_cross_between_the_frameworks_clis(checkpoints,
                                                       tmp_path):
    """Each framework's compute_fid_stats over the same 16 synthetic images,
    then each framework's evaluate --fid_stats on the other's file (and on
    its own): the frozen statistics agree to 1e-4 and so does fid."""
    import evaluate as jax_evaluate
    from tools import compute_fid_stats as jax_stats
    root = checkpoints
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jax_stats.main(CLI + ["--out", jpath])
    rec = port_stats.main(CLI + ["--out", tpath, "--device", "cpu"])
    assert rec["images"] == 16 and rec["feature_dim"] == 192
    (js, jm), (ts, tm) = tfid.load_stats(jpath), tfid.load_stats(tpath)
    assert jm == tm == {"fid_features": "random", "crop_size": S,
                        "images": 16}
    _near(ts.s, js.s, 1e-4)
    _near(ts.ss, js.ss, 1e-4)

    def jax_fid(path):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            jax_evaluate.main(CLI + [
                "--checkpoints_dir", str(root / "jck"), "--results_dir",
                str(tmp_path / "jres"), "--num_test", "8", "--fid_stats",
                path])
        with open(tmp_path / "jres" / "run" / "eval.jsonl") as f:
            return json.loads(f.readlines()[-1])

    def port_fid(path):
        return port_evaluate.main(CLI + [
            "--checkpoints_dir", str(root / "pck"), "--results_dir",
            str(tmp_path / "pres"), "--num_test", "8", "--fid_stats", path,
            "--device", "cpu"])

    for path in (jpath, tpath):
        want, got = jax_fid(path), port_fid(path)
        assert got["fid_stats_images"] == want["fid_stats_images"] == 16
        assert got["fid_images"] == want["fid_images"] == 8
        for k in ("fid", "fid_stream"):
            assert abs(got[k] - want[k]) <= RANK_DEFICIENT_RTOL * want[k], k


def _run_dir(root, opt_seed=True, frac=0.25, seed=0, dataset_len=16):
    """A port run directory with G and an opt.json split record."""
    import shutil
    from pcgan_tpu_torch.config import amend_run_opt
    ck = root / "hk"
    if ck.exists():
        shutil.rmtree(ck)
    (ck / "run").mkdir(parents=True)
    shutil.copy(root / "pck" / "run" / "latest_G.pt", ck / "run")
    tcfg.parse_config(CLI + ["--holdout_frac", str(frac), "--seed",
                             str(seed)]).save(str(ck / "run" / "opt.json"))
    if not opt_seed:
        with open(ck / "run" / "opt.json") as f:
            opt = json.load(f)
        del opt["train"]["seed"]
        with open(ck / "run" / "opt.json", "w") as f:
            json.dump(opt, f)
    amend_run_opt(str(ck), "run", "split", {
        "dataset_len": dataset_len, "phase": "train", "phase_root": None,
        "holdout_frac": frac, "seed": seed})
    return ck


@pytest.mark.parametrize("case,match", [
    ("frac", "trained with holdout_frac=0.25"),
    ("seed", "seed=0 but eval got"),
    ("rows", "resolved a 20-row dataset"),
    ("no_seed", None), ("no_opt", None)])
def test_evaluate_holdout_guards(checkpoints, tmp_path, capsys, case, match):
    """The training split is reproduced or refused: a different frac, seed
    or row count raises; an opt.json without train.seed cannot be verified
    and warns (no fallback to the eval's own seed); a run without opt.json
    warns."""
    ck = _run_dir(checkpoints, opt_seed=(case != "no_seed"),
                  dataset_len=20 if case == "rows" else 16)
    if case == "no_opt":
        os.remove(ck / "run" / "opt.json")
    argv = CLI + ["--checkpoints_dir", str(ck), "--results_dir",
                  str(tmp_path / "res"), "--num_test", "8", "--device",
                  "cpu", "--holdout_frac",
                  "0.5" if case == "frac" else "0.25",
                  "--seed", "3" if case == "seed" else "0"]
    if match:
        with pytest.raises(SystemExit, match=match):
            port_evaluate.main(argv)
        return
    rec = port_evaluate.main(argv)
    out = capsys.readouterr().out
    assert rec["fid_images"] == 8 and rec["holdout_fid_images"] == 4
    assert np.isfinite(rec["fid"]) and np.isfinite(rec["holdout_fid"])
    want = ("records no train.seed" if case == "no_seed"
            else "no readable opt.json")
    assert want in out


TRAIN = ["--dataset_mode", "synthetic", "--max_dataset_size", "20",
         "--batch_size", "2", "--load_size", str(LOAD), "--crop_size",
         str(S), "--netG", "resnet_6blocks", "--ngf", str(NF), "--ndf",
         str(NF), "--n_age_bins", str(NB), "--niter", "2", "--niter_decay",
         "0", "--print_freq", "5", "--name", "t", "--device", "cpu",
         "--eval_fid_epoch_freq", "2", "--eval_fid_images", "8"]


def test_in_training_fid_writes_eval_and_holdout_rows(tmp_path):
    res = train_main.main(TRAIN + [
        "--checkpoints_dir", str(tmp_path), "--holdout_frac", "0.2",
        "--ema_decay", "0.999", "--eval_use_ema", "--kid", "--ssim"])
    assert [e["epoch"] for e in res["evals"]] == [2]
    with open(tmp_path / "t" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    ev = [r for r in rows if "eval_fid" in r]
    assert len(ev) == 1 and ev[0]["epoch"] == 2 and ev[0]["step"] == 16
    for k in ("eval_fid", "eval_kid", "eval_ssim", "eval_h_fid",
              "eval_h_kid", "eval_h_ssim"):
        assert np.isfinite(ev[0][k]), k
    assert ev[0]["eval_fid_images"] == 8 and ev[0]["eval_h_fid_images"] == 4
    with open(tmp_path / "t" / "opt.json") as f:
        split = json.load(f)["split"]
    assert split["holdout_frac"] == 0.2 and split["dataset_len"] == 20
    # the eval scored the EMA twin: evaluate on the saved twin, over the
    # reproduced split with the same seed, gives the same numbers
    rec = port_evaluate.main([
        "--dataset_mode", "synthetic", "--max_dataset_size", "20",
        "--batch_size", "2", "--name", "t", "--checkpoints_dir",
        str(tmp_path), "--results_dir", str(tmp_path / "res"), "--device",
        "cpu", "--num_test", "8", "--holdout_frac", "0.2", "--use_ema",
        "--kid", "--ssim"])
    for k in ("fid", "kid", "ssim"):
        assert rec[k] == ev[0][f"eval_{k}"], k
        assert rec[f"holdout_{k}"] == ev[0][f"eval_h_{k}"], k


@pytest.mark.parametrize("flags,match", [
    (["--eval_use_ema"], "--ema_decay"),
    (["--kid", "--eval_fid_images", "0"], "finite --eval_fid_images"),
    (["--prdc", "--eval_fid_images", "4"], "--prdc_k"),
    (["--holdout_frac", "0.05"], "fewer than one batch")])
def test_in_training_fid_startup_guards(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        train_main.main(TRAIN + ["--checkpoints_dir", str(tmp_path)] + flags)
