"""The port's evaluation ops and feature nets against the JAX package on the
same numpy inputs and converted weights.

- Random FID features: the committed ``fid_random_features.npz`` equals
  flax's ``PRNGKey(42)`` init bit for bit and matches its recorded sha256;
  the forward (XLA's asymmetric ``SAME`` pad at stride 2, flax's tanh
  GELU) within 1e-5 abs + 1e-5 rel at even and odd sizes.
- Streaming moments (count, s, ss) within 1e-4 relative; ``finalize``
  within 1e-5 of the covariance's scale; FID from statistics within 1e-4
  relative in a full-rank case (n >= 2d). Stats files cross both ways with
  identical arrays and meta.
- KID: the kernel and ``mmd2_unbiased`` within 1e-5 relative; the full
  estimator where no draw matters (one subset of every row) within 1e-5.
  PRDC exactly (the same memberships), SSIM within 1e-5 abs, IS and its
  random head bit for bit.
- InceptionV3 from one seeded torchvision-named ``.pth`` through both
  importers: features of a batch of 2 at 299 px within 1e-4 of the largest
  entry; the 299 px resize (up from 128, down from 320 with antialiasing)
  within 1e-5 abs; flax params converted by ``convert_inception_params``
  equal the port's own import.
- VGG16 taps and LPIPS (uniform and learned lins) on converted weights
  within 1e-4 relative; ``split_holdout`` index for index.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pcgan_tpu.data import loader as jloader
from pcgan_tpu.ops import fid as jfid
from pcgan_tpu.ops import is_score as jis
from pcgan_tpu.ops import kid as jkid
from pcgan_tpu.ops import lpips as jlpips
from pcgan_tpu.ops import prdc as jprdc
from pcgan_tpu.ops import ssim as jssim

from pcgan_tpu_torch.convert import (convert_inception_params,
                                     convert_lpips_lins,
                                     convert_random_features_params,
                                     convert_vgg16_params, flatten_params)
from pcgan_tpu_torch.data import loader as tloader
from pcgan_tpu_torch.data.synthetic import SyntheticAgingDataset
from pcgan_tpu_torch.models import inception as tinc
from pcgan_tpu_torch.models import vgg as tvgg
from pcgan_tpu_torch.ops import fid as tfid
from pcgan_tpu_torch.ops import is_score as tis
from pcgan_tpu_torch.ops import kid as tkid
from pcgan_tpu_torch.ops import lpips as tlpips
from pcgan_tpu_torch.ops import prdc as tprdc
from pcgan_tpu_torch.ops import ssim as tssim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGEST = os.path.join(ROOT, "tests", "torch_port_data",
                      "fid_random_features.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the host's cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol, atol=atol)


# --------------------------------------------------------------------------- #
# random FID features
# --------------------------------------------------------------------------- #


def test_committed_random_features_equal_jax_init_and_checksum():
    from flax.traverse_util import flatten_dict
    v = jfid.RandomConvFeatures().init(jax.random.PRNGKey(42),
                                       jnp.zeros((1, 32, 32, 3)))
    want = {k: np.asarray(a) for k, a in
            flatten_dict(v["params"], sep="/").items()}
    with np.load(tfid.RANDOM_FEATURES_NPZ) as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k])
    assert sum(a.size for a in got.values()) == 1_010_240
    with open(DIGEST) as f:
        rec = json.load(f)
    with open(tfid.RANDOM_FEATURES_NPZ, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == rec["sha256"]
    assert rec["values"] == 1_010_240 and rec["seed"] == 42


@pytest.mark.parametrize("n", [6, 7, 8, 32, 33])
def test_same_pad_is_xla_same(n):
    """Even sizes pad (0, 1) at stride 2, odd sizes (1, 1)."""
    want = jax.lax.padtype_to_pads((n,), (3,), (2,), "SAME")[0]
    assert tfid.same_pad(n) == tuple(want)
    assert tfid.same_pad(32) == (0, 1) and tfid.same_pad(33) == (1, 1)


def test_gelu_is_flax_tanh_gelu():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    from flax import linen as nn
    # f32 tanh of two libraries: within 1e-6 abs + 1e-6 rel
    _close(F.gelu(_t(x), approximate="tanh"), nn.gelu(jnp.asarray(x)),
           1e-6, 1e-6)
    # the exact erf form differs by more than that: the choice matters
    assert np.abs(F.gelu(_t(x)).numpy()
                  - np.asarray(nn.gelu(jnp.asarray(x)))).max() > 1e-4


@pytest.mark.parametrize("size", [32, 33])
def test_random_features_forward_matches_jax(size):
    rng = np.random.default_rng(size)
    x = rng.uniform(-1, 1, (3, size, size, 3)).astype(np.float32)
    f, d = jfid.make_feature_fn(size, 3)
    net, d2 = tfid.make_feature_fn(3)
    assert d == d2 == 192
    want = np.asarray(f(jnp.asarray(x)))
    got = net(_t(x)).detach().numpy()
    _close(got, want, 1e-5, 1e-5)


def test_random_features_refuse_other_channel_counts():
    with pytest.raises(ValueError, match="3 channels only"):
        tfid.make_feature_fn(1)


def test_convert_random_features_roundtrip():
    with np.load(tfid.RANDOM_FEATURES_NPZ) as z:
        flat = {k: z[k] for k in z.files}
    sd = convert_random_features_params(flat)
    np.testing.assert_array_equal(sd["convs.1.weight"].numpy(),
                                  flat["Conv_1/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc.weight"].numpy(),
                                  flat["Dense_0/kernel"].T)
    with pytest.raises(ValueError, match="no place"):
        convert_random_features_params({**flat, "Extra/kernel": flat[
            "Dense_0/bias"]})


# --------------------------------------------------------------------------- #
# streaming statistics and the Frechet distance
# --------------------------------------------------------------------------- #


def _feature_batches(seed, n_batches=4, b=32, d=16, shift=0.0):
    rng = np.random.default_rng(seed)
    mix = rng.normal(0, 1, (d, d)).astype(np.float32) / np.sqrt(d)
    return [(rng.normal(shift, 1, (b, d)).astype(np.float32) @ mix)
            for _ in range(n_batches)]


def _stream(mod, batches, d, to):
    st = mod.init_stats(d)
    for x in batches:
        st = mod.update_stats(st, to(x))
    return st


def test_streamed_moments_and_full_rank_fid_match_jax():
    d = 16
    real, fake = _feature_batches(0, d=d), _feature_batches(1, d=d, shift=0.3)
    jr, jf = (_stream(jfid, b, d, jnp.asarray) for b in (real, fake))
    tr, tf = (_stream(tfid, b, d, _t) for b in (real, fake))
    for j, t in ((jr, tr), (jf, tf)):
        assert float(t.count) == float(j.count) == 128.0
        _close(t.s, j.s, 1e-4, 1e-4 * np.abs(np.asarray(j.s)).max())
        _close(t.ss, j.ss, 1e-4, 1e-4 * np.abs(np.asarray(j.ss)).max())
    (jmu, jcov), (tmu, tcov) = jfid.finalize(jr), tfid.finalize(tr)
    _close(tmu, jmu, 0, 1e-5)
    _close(tcov, jcov, 0, 1e-5 * np.abs(np.asarray(jcov)).max())
    # full rank (n = 128 >= 2d): the Frechet chain agrees tightly
    want = float(jfid.fid_from_stats(jr, jf))
    assert want > 0.1
    _close(float(tfid.fid_from_stats(tr, tf)), want, 1e-4)
    merged = tfid.merge_stats(tr, tf)
    assert float(merged.count) == 256.0


def test_stats_files_cross_both_ways(tmp_path):
    d = 8
    batches = _feature_batches(2, n_batches=2, b=8, d=d)
    meta = {"fid_features": "random", "crop_size": 32, "images": 16}
    jst, tst = _stream(jfid, batches, d, jnp.asarray), _stream(
        tfid, batches, d, _t)
    jfid.save_stats(str(tmp_path / "j.npz"), jst, meta)
    tfid.save_stats(str(tmp_path / "t.npz"), tst, meta)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    t_from_j, tmeta = tfid.load_stats(str(tmp_path / "j.npz"))
    j_from_t, jmeta = jfid.load_stats(str(tmp_path / "t.npz"))
    assert tmeta == jmeta == meta
    for k in ("count", "s", "ss"):
        np.testing.assert_array_equal(getattr(t_from_j, k).numpy(),
                                      np.asarray(getattr(jst, k)))
        np.testing.assert_array_equal(np.asarray(getattr(j_from_t, k)),
                                      getattr(tst, k).numpy())


# --------------------------------------------------------------------------- #
# KID, PRDC, SSIM, IS
# --------------------------------------------------------------------------- #


def test_kid_kernel_and_mmd_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (20, 12)).astype(np.float32)
    y = rng.normal(0.2, 1, (20, 12)).astype(np.float32)
    _close(tkid.polynomial_kernel(_t(x), _t(y)),
           jkid.polynomial_kernel(jnp.asarray(x), jnp.asarray(y)), 1e-5)
    want = float(jkid.mmd2_unbiased(jnp.asarray(x), jnp.asarray(y)))
    _close(float(tkid.mmd2_unbiased(_t(x), _t(y))), want, 1e-5, 1e-7)


def test_kid_where_the_draw_does_not_matter_matches_jax():
    """One subset of every row: both frameworks' draws are permutations of
    the whole set, which the estimator does not see."""
    rng = np.random.default_rng(4)
    r = rng.normal(0, 1, (24, 12)).astype(np.float32)
    f = rng.normal(0.3, 1, (24, 12)).astype(np.float32)
    jm, js = jkid.kid_from_features(jnp.asarray(r), jnp.asarray(f),
                                    subsets=1, subset_size=100, seed=0)
    tm, ts = tkid.kid_from_features(_t(r), _t(f), subsets=1,
                                    subset_size=100, seed=7)
    _close(float(tm), float(jm), 1e-5, 1e-7)
    assert float(ts) == float(js) == 0.0
    # many subsets: seeded and repeatable, a population std
    a = tkid.kid_from_features(_t(r), _t(f), subsets=5, subset_size=10)
    b = tkid.kid_from_features(_t(r), _t(f), subsets=5, subset_size=10)
    assert float(a[0]) == float(b[0]) and float(a[1]) > 0
    with pytest.raises(ValueError, match=">= 2 features"):
        tkid.kid_from_features(_t(r[:1]), _t(f), subsets=1)


def test_prdc_matches_jax():
    rng = np.random.default_rng(5)
    r = rng.normal(0, 1, (40, 8)).astype(np.float32)
    f = rng.normal(0.5, 1.2, (36, 8)).astype(np.float32)
    want = jprdc.prdc_from_features(jnp.asarray(r), jnp.asarray(f), k=3)
    got = tprdc.prdc_from_features(_t(r), _t(f), k=3)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) < 1e-6, k


def test_ssim_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, x.shape), -1, 1).astype(np.float32)
    np.testing.assert_array_equal(tssim._band_matrix(32),
                                  jssim._band_matrix(32))
    _close(tssim.ssim_pair(_t(x), _t(y)),
           jssim.ssim_pair(jnp.asarray(x), jnp.asarray(y)), 0, 1e-5)


def test_is_score_matches_jax(tmp_path):
    w, b = tis.random_fc(192)
    jw, jb = jis.random_fc(192)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(b, jb)
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 2, (25, 10))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    assert tis.inception_score_from_probs(probs, 4) == \
        jis.inception_score_from_probs(probs, 4)
    sd = {"fc.weight": torch.randn(10, 2048), "fc.bias": torch.randn(10)}
    torch.save(sd, tmp_path / "inc.pth")
    for a, c in zip(tis.load_inception_fc(str(tmp_path / "inc.pth")),
                    jis.load_inception_fc(str(tmp_path / "inc.pth"))):
        np.testing.assert_array_equal(a, c)
    torch.save({"x": torch.zeros(1)}, tmp_path / "nofc.pth")
    with pytest.raises(ValueError, match="fc.weight"):
        tis.load_inception_fc(str(tmp_path / "nofc.pth"))


# --------------------------------------------------------------------------- #
# InceptionV3
# --------------------------------------------------------------------------- #


def seeded_inception_state_dict(seed: int = 0) -> dict:
    """A torchvision-named ``inception_v3`` state dict with seeded weights
    (conv, BN, plus the fc and aux tensors a real file carries)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for prefix, mod in tinc.InceptionV3Features().named_modules():
        if not isinstance(mod, tinc.BasicConv2d):
            continue
        co, ci, kh, kw = mod.conv.weight.shape
        sd[f"{prefix}.conv.weight"] = torch.from_numpy(rng.normal(
            0, np.sqrt(2.0 / (ci * kh * kw)), (co, ci, kh, kw)).astype(
                np.float32))
        for k, v in (("weight", rng.uniform(0.5, 1.5, co)),
                     ("bias", rng.normal(0, 0.1, co)),
                     ("running_mean", rng.normal(0, 0.1, co)),
                     ("running_var", rng.uniform(0.5, 1.5, co))):
            sd[f"{prefix}.bn.{k}"] = torch.from_numpy(v.astype(np.float32))
    sd["fc.weight"] = torch.from_numpy(
        rng.normal(0, 0.02, (1000, 2048)).astype(np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    sd["AuxLogits.fc.bias"] = torch.zeros(1000)
    return sd


def _flax_template(net, size):
    """Zero params of ``net``'s tree, shaped by ``jax.eval_shape`` (flax's
    eager init of these nets costs tens of seconds on a CPU)."""
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                  shapes)["params"]


@pytest.fixture(scope="module")
def inception_pair(tmp_path_factory):
    """One seeded ``.pth`` through both importers, and one batch of 2 at
    299 px through both nets: JAX's ``make_inception_feature_fn`` body
    (import into the flax tree, clip, apply) with a jitted apply."""
    from pcgan_tpu.models import inception as jinc
    from pcgan_tpu.utils.pth_import import load_pth
    path = str(tmp_path_factory.mktemp("inc") / "inception_v3.pth")
    torch.save(seeded_inception_state_dict(), path)
    net = jinc.InceptionV3Features()
    flax_params = jinc.import_inception_pth(load_pth(path),
                                            _flax_template(net, 299))
    tf, td = tinc.make_inception_feature_fn(path)
    x = np.random.default_rng(8).uniform(-1, 1, (2, 299, 299, 3)).astype(
        np.float32)
    want = jax.jit(net.apply)({"params": flax_params},
                              jnp.clip(jnp.asarray(x), -1.0, 1.0))
    return {"path": path, "jax": np.asarray(want),
            "port": tf(_t(x)).detach().numpy(), "dim": td, "net": tf.net,
            "flax_params": flax_params}


def test_inception_features_match_jax(inception_pair):
    assert inception_pair["dim"] == 2048
    want, got = inception_pair["jax"], inception_pair["port"]
    assert want.shape == got.shape == (2, 2048)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.01
    _close(got, want, 0, 1e-4 * np.abs(want).max())


def test_flax_inception_params_convert_to_the_port(inception_pair):
    """The flax tree the JAX importer builds, converted, equals the port's
    own import of the same file."""
    sd = convert_inception_params(inception_pair["flax_params"])
    own = inception_pair["net"].state_dict()
    assert set(sd) == set(own) and len(sd) == 3 * tinc.N_CONV_UNITS
    for k in own:
        _close(sd[k], own[k], 1e-6, 1e-7)


@pytest.mark.parametrize("size", [128, 320])
def test_resize_to_299_matches_jax_image_resize(size):
    """Up from 128 px (plain half-pixel bilinear) and down from 320 px
    (antialiased), as ``jax.image.resize(..., "bilinear")``."""
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear")
    _close(tinc.resize_299(_t(x)), want, 0, 1e-5)


def test_inception_avg_pools_in_mixed_7c():
    """The JAX package's Mixed_7c average-pools its branch_pool (the
    reference's choice, not pytorch-fid's max pool): the branch sees the
    3x3 mean, with count_include_pad=False at the border."""
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    want = torch.tensor([[2.5, 3.0], [4.5, 5.0]])
    assert torch.allclose(tinc._avg_pool_nip(x)[0, 0, :2, :2], want)


def test_inception_import_checks(tmp_path):
    with pytest.raises(KeyError, match="Conv2d_1a_3x3"):
        tinc.import_inception_pth({}, tinc.InceptionV3Features())
    with pytest.raises(FileNotFoundError):
        tinc.make_inception_feature_fn(str(tmp_path / "missing.pth"))
    torch.save(torch.nn.Linear(2, 2), tmp_path / "module.pth")
    with pytest.raises(ValueError, match="allow_pickle"):
        tinc.make_inception_feature_fn(str(tmp_path / "module.pth"))


# --------------------------------------------------------------------------- #
# VGG16 and LPIPS
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def vgg_pair():
    from pcgan_tpu.models.vgg import VGG16Taps
    rng = np.random.default_rng(3)
    tmpl = _flax_template(VGG16Taps(), 32)
    jv = {"params": jax.tree_util.tree_map(
        lambda a: (rng.normal(0, np.sqrt(2.0 / np.prod(a.shape[:-1])),
                              a.shape) if a.ndim == 4
                   else rng.normal(0, 0.05, a.shape)).astype(np.float32),
        tmpl)}
    net = tvgg.VGG16Taps()
    net.load_state_dict(convert_vgg16_params(jv), strict=True)
    return jv, net.eval()


def test_vgg16_taps_and_lpips_match_jax(vgg_pair):
    from pcgan_tpu.models.vgg import vgg16_taps
    jv, net = vgg_pair
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.2, x.shape), -1, 1).astype(np.float32)
    for a, c in zip(net(_t(x)), jax.jit(vgg16_taps)(jv, jnp.asarray(x))):
        assert tuple(a.shape) == c.shape
        _close(a.detach(), c, 0, 1e-4 * float(jnp.abs(c).max()) + 1e-7)
    lins = tuple(jnp.asarray(rng.uniform(0, 1, c).astype(np.float32))
                 for c in tvgg.LPIPS_TAP_CHANNELS)
    for jl, tl in ((None, None), (lins, convert_lpips_lins(lins))):
        want = np.asarray(jax.jit(jlpips.lpips_pair)(jv, jnp.asarray(x),
                                            jnp.asarray(y), jl))
        _close(tlpips.lpips_pair(net, _t(x), _t(y), tl).detach(), want, 1e-4)


def test_vgg16_and_lins_import_from_pth(tmp_path, vgg_pair):
    from pcgan_tpu.models.vgg import import_vgg16_pth
    jv, net = vgg_pair
    sd = {f"features.{k}": v for k, v in net.state_dict().items()
          if k.startswith("features.")}
    sd = {k.replace("features.features.", "features."): v
          for k, v in sd.items()}
    torch.save(sd, tmp_path / "vgg16.pth")
    got = tvgg.load_vgg16(str(tmp_path / "vgg16.pth"))
    for k, v in net.state_dict().items():
        assert torch.equal(got.state_dict()[k], v)
    flat = flatten_params(import_vgg16_pth(
        {k: v.numpy() for k, v in sd.items()}, jv["params"]))
    assert len(flat) == 26
    rng = np.random.default_rng(10)
    lins_sd = {f"lin{k}.model.1.weight": torch.from_numpy(
        rng.normal(0, 1, (1, c, 1, 1)).astype(np.float32))
        for k, c in enumerate(tvgg.LPIPS_TAP_CHANNELS)}
    torch.save(lins_sd, tmp_path / "lins.pth")
    for a, c in zip(tlpips.load_lpips_lins(str(tmp_path / "lins.pth")),
                    jlpips.load_lpips_lins(str(tmp_path / "lins.pth"))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        assert float(a.min()) >= 0.0


def test_random_vgg16_is_seeded():
    a, b = tvgg.random_vgg16(0), tvgg.random_vgg16(0)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k


# --------------------------------------------------------------------------- #
# the held-out split
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n,frac,seed", [(100, 0.1, 0), (37, 0.25, 5),
                                         (1024, 0.1, 0)])
def test_split_holdout_matches_jax_index_for_index(n, frac, seed):
    ds = SyntheticAgingDataset(size=n, seed=1)
    tt, th = tloader.split_holdout(ds, frac, seed=seed)
    jt, jh = jloader.split_holdout(ds, frac, seed=seed)
    np.testing.assert_array_equal(tt.indices, jt.indices)
    np.testing.assert_array_equal(th.indices, jh.indices)
    np.testing.assert_array_equal(tt.ages, jt.ages)
    assert len(tt) + len(th) == n
    i = len(th) // 2
    np.testing.assert_array_equal(th.get_raw(i)["image"],
                                  ds.get_raw(int(jh.indices[i]))["image"])
    assert tloader.split_holdout(ds, 0.0) == (ds, None)
    with pytest.raises(ValueError, match="holdout_frac"):
        tloader.split_holdout(ds, 1.5)
