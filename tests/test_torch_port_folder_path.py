"""The real-image slice against the JAX package, end to end on the CPU.

- Path: the first batch of the JPEG fixture folder (the loader's seeded
  shuffle, ``with_bins``) through B1's plain version with pinned crops and
  flips equals JAX's (f32, 2e-5: summation order only); one train step
  from it agrees at the lockstep tolerance of
  ``tests/test_torch_port_train_step.py`` (losses 1e-4 abs + 1e-4 rel,
  parameters within the Adam first-step envelope).
- Label-free path: comparator pretraining from a comparisons CSV writes
  quantile anchors equal to JAX's ``compute_quantile_anchors`` on the
  converted comparator over the CSV's image pool (1e-5), and
  ``sort_unlabeled`` gives the JAX tool's rows and bins on converted
  weights (scores within 1e-5).
- The scripts' argument lists (``scripts/train_utkface_128.sh``,
  ``test_aging_grid.sh``, ``pretrain_comparator.sh`` over a folder and over
  a CSV, ``train_256_fid.sh`` with its in-training FID) run through the
  port's CLIs, with only the data, the widths, the
  epochs and the cadences cut to a CPU's size.
Skips only where g++ or libjpeg is missing on this host.
"""

import importlib.util
import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu import config as jcfg
from pcgan_tpu import eval_lib
from pcgan_tpu import native as jnative
from pcgan_tpu.data import loader as jloader
from pcgan_tpu.data.pairwise import ComparisonsCSVDataset as JCSV
from pcgan_tpu.data.utkface import UTKFaceDataset as JUTK
from pcgan_tpu.models.registry import define_C as j_define_C
from pcgan_tpu.models.registry import define_D as j_define_D
from pcgan_tpu.models.registry import define_G as j_define_G
from pcgan_tpu.models.registry import init_params
from pcgan_tpu.ops import preprocess as jpre
from pcgan_tpu.train import compute_quantile_anchors as j_quantile_anchors
from pcgan_tpu.train import create_train_state as j_create_train_state
from pcgan_tpu.train import make_train_step as j_make_train_step

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch import models as tmodels
from pcgan_tpu_torch import native, train_main
from pcgan_tpu_torch import test as port_test
from pcgan_tpu_torch.convert import (convert_comparator_bundle,
                                     convert_comparator_params,
                                     convert_discriminator_params,
                                     convert_generator_params,
                                     convert_train_state)
from pcgan_tpu_torch.data import loader as tloader
from pcgan_tpu_torch.data.utkface import UTKFaceDataset as TUTK
from pcgan_tpu_torch.data.utkface import list_images, parse_age
from pcgan_tpu_torch.models import define_C, define_D, define_G
from pcgan_tpu_torch.ops import preprocess as tpre
from pcgan_tpu_torch.tools import sort_unlabeled
from pcgan_tpu_torch.train import create_train_state, make_train_step
from pcgan_tpu_torch.utils.checkpoint import load_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = os.path.join(ROOT, "tests", "torch_port_data", "faces")
B, LOAD, S, NB, NF, LR = 4, 36, 32, 4, 8, 2e-4


@pytest.fixture(scope="module")
def decoders():
    try:
        native.load()
    except RuntimeError as e:
        pytest.skip(f"the port's JPEG decoder cannot be built here: {e}")
    if not jnative.available():
        pytest.skip("the JAX package's native decoder is unavailable")


def _cfgs():
    kw = dict(
        data=dict(batch_size=B, crop_size=S, load_size=LOAD, n_age_bins=NB),
        model=dict(netG="resnet_6blocks", netD="basic", ngf=NF, ndf=NF,
                   dtype="float32", cond_inject="bottleneck", cmp_nf=NF,
                   cmp_n_down=3),
        train=dict(gan_mode="lsgan", lambda_L1=100.0, pool_size=0, lr=LR,
                   lr_policy="constant"))

    def build(mod):
        return mod.Config(data=mod.DataConfig(**kw["data"]),
                          model=mod.ModelConfig(**kw["model"]),
                          train=mod.TrainConfig(**kw["train"]))
    return build(jcfg), build(tcfg)


def test_first_folder_batch_and_one_step_match_jax(decoders):
    jb = next(jloader.with_bins(iter(jloader.Loader(
        JUTK(FACES), B, shuffle=True, seed=0, num_threads=2)), NB))
    tb = next(tloader.with_bins(iter(tloader.Loader(
        TUTK(FACES), B, shuffle=True, seed=0, num_threads=2)), NB))
    for k in ("image", "age", "bin"):
        np.testing.assert_array_equal(tb[k], jb[k])
    cy, cx = np.int32([0, 4, 2, 1]), np.int32([4, 0, 3, 2])
    fl = np.int32([1, 0, 0, 1])
    jx = np.asarray(jpre.preprocess_batch(
        jnp.asarray(jb["image"]), jnp.asarray(cy), jnp.asarray(cx),
        jnp.asarray(fl), LOAD, S))
    tx = tpre.preprocess_batch(
        torch.from_numpy(tb["image"]), torch.from_numpy(cy),
        torch.from_numpy(cx), torch.from_numpy(fl).bool(), LOAD, S)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=2e-5)

    jc, tc = _cfgs()
    Gj, Dj = j_define_G(jc), j_define_D(jc)
    jstate = j_create_train_state(jc, Gj, Dj, jax.random.PRNGKey(3), 1000)
    G, D = define_G(tc), define_D(tc)
    state = create_train_state(tc, G, D, torch.Generator().manual_seed(0))
    load_state(state, convert_train_state(jstate))
    g0 = convert_generator_params(jstate.g_params)
    d0 = convert_discriminator_params(jstate.d_params)
    target = np.int32([3, 0, 1, 2])
    jstate, jm = jax.jit(j_make_train_step(jc, Gj, Dj, steps_per_epoch=1000))(
        jstate, {"image": jnp.asarray(jx), "bin": jnp.asarray(jb["bin"]),
                 "target_bin": jnp.asarray(target)})
    tm = make_train_step(tc, state.G, state.D)(
        state, {"image": tx, "bin": torch.from_numpy(tb["bin"]),
                "target_bin": torch.from_numpy(target)})
    assert set(tm) == set(jm)
    for k in jm:
        jv, tv = float(jm[k]), float(tm[k])
        assert abs(jv - tv) <= 1e-4 + 1e-4 * abs(jv), (k, jv, tv)
    for j0, j1, net in (
            (g0, convert_generator_params(jstate.g_params), state.G),
            (d0, convert_discriminator_params(jstate.d_params), state.D)):
        t1 = net.state_dict()
        for k in j1:
            diff = np.abs((j1[k] - j0[k]).numpy() - (t1[k] - j0[k]).numpy())
            assert np.median(diff) < 2e-6, k
            assert diff.max() <= 2.1 * LR, k
            assert float((diff > 0.25 * LR).mean()) < 2e-3, k


def _scaled_comparator(jc, tc, seed=1):
    """JAX C with non-zero biases and Dense kernels 20x their init (scores
    O(1)), and the port's C on the same weights."""
    jC = j_define_C(jc)
    v = init_params(jC, jax.random.PRNGKey(seed), jnp.zeros((1, S, S, 3)))
    params = {k: {n: (a + 0.01 if a.ndim == 1 else
                      a * 20.0 if k.startswith("Dense") else a)
                  for n, a in d.items()} for k, d in v["params"].items()}
    C = define_C(tc)
    C.load_state_dict(convert_comparator_params(params), strict=True)
    return jC, {"params": params}, C


def _comparisons_csv(tmp_path, n_rows=24, seed=0):
    """At least ``n_rows`` pathA,pathB,label rows over the fixtures,
    labelled from their ages, holding all three labels; one header row,
    paths relative to the CSV."""
    paths = list_images(FACES)
    rng = np.random.default_rng(seed)
    names = {0: "0", 1: "b", 2: "tie"}
    rows, seen = ["image_a,image_b,label"], set()
    while len(rows) <= n_rows or len(seen) < 3:
        a, b = (paths[i] for i in rng.integers(0, len(paths), 2))
        gap = parse_age(a) - parse_age(b)
        lab = 2 if abs(gap) <= 3 else (0 if gap > 0 else 1)
        rows.append(f"{os.path.relpath(a, tmp_path)},"
                    f"{os.path.relpath(b, tmp_path)},{names[lab]}")
        seen.add(lab)
    p = tmp_path / "pairs.csv"
    p.write_text("\n".join(rows) + "\n")
    return str(p)


def test_csv_pretraining_writes_jax_quantile_anchors(decoders, tmp_path,
                                                    monkeypatch):
    jc, tc = _cfgs()
    jC, jv, C = _scaled_comparator(jc, tc)
    monkeypatch.setattr(tmodels, "define_C", lambda *a, **k: C)
    csv = _comparisons_csv(tmp_path)
    res = train_main.main([
        "--model", "comparator", "--dataset_mode", "comparisons",
        "--comparisons_csv", csv, "--load_size", str(LOAD), "--crop_size",
        str(S), "--n_age_bins", str(NB), "--cmp_nf", str(NF), "--cmp_n_down",
        "3", "--batch_size", "8", "--niter", "0", "--niter_decay", "0",
        "--dtype", "float32", "--device", "cpu", "--num_threads", "2",
        "--name", "cmp", "--checkpoints_dir", str(tmp_path / "ck")])
    bundle = torch.load(res["bundle"], weights_only=True)
    pool = JCSV(csv).image_pool_dataset()
    pre = jpre.make_preprocess(jc, train=False)
    imgs = jnp.concatenate([
        pre(jax.random.PRNGKey(0), {"image": jnp.asarray(b["image"])})["image"]
        for b in jloader.Loader(pool, 8, shuffle=False, drop_last=False)])
    with jax.default_matmul_precision("highest"):
        want = j_quantile_anchors(jC, jv, imgs, NB)
    for k, w in zip(("bin_lo", "bin_hi", "bin_means"), want):
        np.testing.assert_allclose(bundle[k].numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5)
    means = bundle["bin_means"].numpy()
    assert np.all(np.diff(means) > 0)
    np.testing.assert_array_equal(bundle["bin_lo"].numpy()[1:],
                                  bundle["bin_hi"].numpy()[:-1])


def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_labels(path):
    with open(path) as f:
        rows = [line.strip().split(",") for line in f][1:]
    return ([r[0] for r in rows], np.int64([r[1] for r in rows]),
            np.float64([r[2] for r in rows]))


@pytest.mark.parametrize("by", ["quantiles", "anchors"])
def test_sort_unlabeled_gives_jax_bins(decoders, tmp_path, monkeypatch, by):
    jc, tc = _cfgs()
    jC, jv, _ = _scaled_comparator(jc, tc, seed=2)
    ds = JUTK(FACES, require_age=False)
    pre = jpre.make_preprocess(jc, train=False)
    imgs = pre(jax.random.PRNGKey(0), {"image": jnp.asarray(
        ds.get_raw_batch(np.arange(len(ds)))["image"])})["image"]
    with jax.default_matmul_precision("highest"):
        lo, hi, means = j_quantile_anchors(jC, jv, imgs, NB)
    torch.save(convert_comparator_bundle({"c_vars": jv, "bin_lo": lo,
                                          "bin_hi": hi, "bin_means": means}),
               tmp_path / "comparator.pt")
    flags = ["--dataroot", FACES, "--n_age_bins", str(NB), "--by", by,
             "--batch_size", "8", "--load_size", str(LOAD), "--crop_size",
             str(S), "--cmp_nf", str(NF), "--cmp_n_down", "3",
             "--num_threads", "2"]
    res = sort_unlabeled.main(flags + [
        "--comparator_path", str(tmp_path), "--device", "cpu",
        "--out", str(tmp_path / "port.csv")])
    monkeypatch.setattr(eval_lib, "load_comparator_bundle",
                        lambda cfg: (jC, jv, lo, hi, means))
    with jax.default_matmul_precision("highest"):
        _load_jax_tool("sort_unlabeled").main(flags + [
            "--comparator_path", str(tmp_path / "jax_bundle"),
            "--out", str(tmp_path / "jax.csv")])
    tp, tbins, ts = _read_labels(tmp_path / "port.csv")
    jp, jbins, js = _read_labels(tmp_path / "jax.csv")
    assert tp == jp == list_images(FACES) and len(tp) == 32
    np.testing.assert_array_equal(tbins, jbins)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    assert set(tbins) <= set(range(NB))
    if by == "quantiles":
        assert res["occupancy"].tolist() == [8, 8, 8, 8]


# --------------------------------------------------------------------------- #
# the scripts' argument lists
# --------------------------------------------------------------------------- #

# cuts to a CPU's size, appended after each script's own flags (the last
# value of a flag wins); the data, epochs and cadences are the only other
# differences
CPU = ["--netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8", "--cmp_nf",
       "8", "--cmp_n_down", "3", "--load_size", "36", "--crop_size", "32",
       "--max_dataset_size", "8", "--batch_size", "4", "--niter", "1",
       "--niter_decay", "0", "--print_freq", "1", "--num_threads", "2",
       "--device", "cpu"]
PRETRAIN = ["--name", "cmp_utk", "--model", "comparator", "--load_size",
            "143", "--crop_size", "128", "--batch_size", "64",
            "--n_age_bins", "10", "--niter", "20", "--niter_decay", "0",
            "--lr", "0.0002", "--print_freq", "50"]
TRAIN = ["--name", "utk128", "--model", "pcgan", "--dataset_mode", "aging",
         "--netG", "resnet_9blocks", "--netD", "basic", "--norm", "instance",
         "--load_size", "143", "--crop_size", "128", "--batch_size", "32",
         "--n_age_bins", "10", "--gan_mode", "lsgan", "--lambda_L1", "100",
         "--lambda_cond", "10", "--niter", "100", "--niter_decay", "100",
         "--lr", "0.0002", "--beta1", "0.5", "--pool_size", "64",
         "--print_freq", "100", "--save_epoch_freq", "5", "--mesh_shape",
         "1"]
FID256 = ["--name", "cacd256", "--model", "pcgan", "--netG",
          "resnet_9blocks", "--netD", "basic", "--norm", "instance",
          "--load_size", "286", "--crop_size", "256", "--batch_size", "32",
          "--dtype", "bfloat16", "--n_age_bins", "10", "--gan_mode", "lsgan",
          "--lambda_L1", "100", "--pool_size", "64", "--niter", "100",
          "--niter_decay", "100", "--lr", "0.0002", "--beta1", "0.5",
          "--eval_fid_epoch_freq", "5", "--eval_fid_images", "1024",
          "--max_ckpt_keep", "5", "--print_freq", "100", "--save_epoch_freq",
          "5"]
TEST = ["--name", "utk128", "--dataset_mode", "aging", "--netG",
        "resnet_9blocks", "--norm", "instance", "--load_size", "143",
        "--crop_size", "128", "--n_age_bins", "10", "--epoch", "latest",
        "--num_test", "50"]


def test_the_scripts_argument_lists_run_through_the_port(decoders, tmp_path):
    ck = ["--checkpoints_dir", str(tmp_path / "ck")]
    data = ["--dataroot", FACES]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # input injection
        cmp = train_main.main(data + PRETRAIN + ["--dataset_mode", "pairwise"]
                              + CPU + ck)
        csv = train_main.main(data + PRETRAIN + [
            "--dataset_mode", "comparisons", "--comparisons_csv",
            _comparisons_csv(tmp_path)] + CPU + ck + ["--name", "cmp_csv"])
        gan = train_main.main(data + TRAIN + [
            "--comparator_path", cmp["bundle"]] + CPU + ck)
        out = port_test.main(data + TEST + CPU + ck + [
            "--results_dir", str(tmp_path / "res"), "--num_test", "3"])
    # 8 pairs (or CSV rows), none held out below 20: 2 steps of 4
    assert cmp["step"] == csv["step"] == 2
    # the cond loss is a Gaussian NLL with 0.5 * log_var: non-zero, of
    # either sign
    assert gan["step"] == 2 and gan["metrics"]["loss_G_cond"] != 0.0
    with open(os.path.join(gan["run_dir"], "opt.json")) as f:
        split = json.load(f)["split"]
    assert split["phase_root"] == FACES and split["dataset_len"] == 8
    assert out["done"] == 3
    pngs = os.listdir(os.path.join(out["web_dir"], "images"))
    assert len(pngs) == 3 * (1 + 10)


def test_train_256_fid_argument_list_runs_through_the_port(decoders,
                                                           tmp_path):
    """``scripts/train_256_fid.sh``'s list (bf16, in-training FID) over the
    folder, cut to a CPU's size; the FID cadence and budget are cut with
    the epochs."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # input injection
        res = train_main.main(["--dataroot", FACES] + FID256 + CPU + [
            "--checkpoints_dir", str(tmp_path), "--eval_fid_epoch_freq",
            "1", "--eval_fid_images", "8", "--save_epoch_freq", "1"])
    assert res["step"] == 2 and len(res["evals"]) == 1
    with open(os.path.join(res["run_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    ev = [r for r in rows if "eval_fid" in r]
    assert len(ev) == 1 and ev[0]["eval_fid_images"] == 8
    assert np.isfinite(ev[0]["eval_fid"])


@pytest.mark.parametrize("extra", [[], ["--host_resize"]])
def test_sampler_over_a_folder_matches_the_jax_cli(decoders, tmp_path, extra):
    """``pcgan_tpu_torch.test`` over the JPEG folder in aging mode (with and
    without ``--host_resize``) writes the root ``test.py``'s PNGs from the
    same converted G, within 1 u8 LSB (f32 noise can flip one rounding of
    the final quantization)."""
    import test as jax_cli
    from PIL import Image
    from pcgan_tpu.config import parse_config as jax_parse
    from pcgan_tpu.utils import checkpoint as jax_ckpt
    from pcgan_tpu_torch.config import parse_config as port_parse
    from pcgan_tpu_torch.utils.checkpoint import save_generator

    args = ["--dataroot", FACES, "--dataset_mode", "aging", "--num_test",
            "5", "--batch_size", "4", "--crop_size", str(S), "--load_size",
            str(LOAD), "--netG", "resnet_6blocks", "--ngf", str(NF),
            "--n_age_bins", str(NB), "--dtype", "float32", "--cond_inject",
            "bottleneck", "--name", "run"] + extra
    jG = j_define_G(jax_parse(args, is_train=False))
    params = init_params(jG, jax.random.PRNGKey(5), jnp.zeros((1, S, S, 3)),
                         jnp.zeros((1, NB)), train=False)["params"]
    jax_ckpt.save({"g_params": params, "g_state": {}}, str(tmp_path / "jck"),
                  "run", "latest_G", wait=True)
    G = define_G(port_parse(args, is_train=False))
    G.load_state_dict(convert_generator_params(params))
    save_generator(G, str(tmp_path / "pck"), "run")
    jax_cli.main(args + ["--checkpoints_dir", str(tmp_path / "jck"),
                         "--results_dir", str(tmp_path / "jres")])
    out = port_test.main(args + ["--checkpoints_dir", str(tmp_path / "pck"),
                                 "--results_dir", str(tmp_path / "pres"),
                                 "--device", "cpu"])
    assert out["done"] == 5
    jdir = tmp_path / "jres" / "run" / "test_latest" / "images"
    pdir = tmp_path / "pres" / "run" / "test_latest" / "images"
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir)) and len(names) == 5 * (1 + NB)
    for n in names:
        a, b = (np.asarray(Image.open(d / n).convert("RGB"), np.int16)
                for d in (jdir, pdir))
        assert a.shape == b.shape == (S, S, 3), n
        assert np.abs(a - b).max() <= 1, n


@pytest.mark.parametrize("mesh,ok", [("1", True), ("-1", True), ("2", False),
                                     ("1,1", False)])
def test_one_card_mesh_flags(mesh, ok):
    """``--mesh_shape 1`` (train_utkface_128.sh) and ``-1`` mean one card;
    any other mesh is multi-device and still raises."""
    from pcgan_tpu_torch.train import reject_unported_train
    argv = ["--mesh_shape", mesh] + (["--mesh_axes", "data,model"]
                                     if "," in mesh else [])
    cfg = tcfg.parse_config(argv)
    if ok:
        reject_unported_train(cfg)
    else:
        with pytest.raises(NotImplementedError, match="--mesh_shape"):
            reject_unported_train(cfg)
