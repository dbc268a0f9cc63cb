"""The port's real-image datasets and loader against the JAX package's on
the same files: UTKFace-style folders (mixed sizes, PNG, greyscale,
progressive and CMYK JPEGs, unlabeled files), packs written by either
package and read by the other, the comparisons CSV (header, string and bad
labels, path resolution), comparator-sorted labels, both canvas guards, and
the ``Loader`` with and without ``resize_to``. Tolerance: bit-identical
images, equal ages, bins, labels and paths. Skips only where g++ or libjpeg
is missing on this host."""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from pcgan_tpu import config as jcfg
from pcgan_tpu import native as jnative
from pcgan_tpu.data import loader as jloader
from pcgan_tpu.data import packed as jpacked
from pcgan_tpu.data.pairwise import ComparisonsCSVDataset as JCSV
from pcgan_tpu.data.sorted_labels import SortedLabelsDataset as JSorted
from pcgan_tpu.data.utkface import UTKFaceDataset as JUTK

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch import native
from pcgan_tpu_torch.data import loader as tloader
from pcgan_tpu_torch.data import packed as tpacked
from pcgan_tpu_torch.data.pairwise import ComparisonsCSVDataset as TCSV
from pcgan_tpu_torch.data.sorted_labels import SortedLabelsDataset as TSorted
from pcgan_tpu_torch.data.utkface import UTKFaceDataset as TUTK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = os.path.join(ROOT, "tests", "torch_port_data", "faces")


@pytest.fixture(scope="module")
def decoders():
    try:
        native.load()
    except RuntimeError as e:
        pytest.skip(f"the port's JPEG decoder cannot be built here: {e}")
    if not jnative.available():
        pytest.skip("the JAX package's native decoder is unavailable")


def _faces(n):
    return sorted(os.listdir(FACES))[:n]


@pytest.fixture(scope="module")
def mixed(decoders, tmp_path_factory):
    """Fixture JPEGs on the 200 px canvas, plus an off-canvas JPEG, an on-
    and an off-canvas PNG, a CMYK JPEG and an unlabeled file."""
    root = tmp_path_factory.mktemp("mixed")
    for n in _faces(6) + [f for f in sorted(os.listdir(FACES))
                          if f.startswith(("71_", "76_"))]:
        shutil.copy(os.path.join(FACES, n), root / n)
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (80, 64, 3), np.uint8)).save(
        root / "44_1_0_small.jpg", quality=90)
    Image.fromarray(rng.integers(0, 256, (200, 200, 3), np.uint8)).save(
        root / "45_0_0_p.png")
    Image.fromarray(rng.integers(0, 256, (120, 150, 4), np.uint8),
                    "RGBA").save(root / "46_0_0_q.png")
    Image.fromarray(rng.integers(0, 256, (200, 200, 4), np.uint8),
                    "CMYK").save(root / "47_0_0_c.jpg", quality=90)
    shutil.copy(os.path.join(FACES, _faces(1)[0]), root / "face.jpg")
    return str(root)


def _same_rows(t, j, idx=None):
    idx = range(len(j)) if idx is None else idx
    for i in idx:
        a, b = t.get_raw(i), j.get_raw(i)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("require_age", [True, False])
def test_folder_dataset_matches_jax(mixed, require_age):
    t = TUTK(mixed, require_age=require_age, native=0)
    j = JUTK(mixed, require_age=require_age, native=0)
    assert t.paths == j.paths and (t.native, t.out_size) == (j.native, 200)
    np.testing.assert_array_equal(t.ages, j.ages)
    assert len(t) == (12 if require_age else 13)
    _same_rows(t, j)
    batch = t.get_raw_batch(np.arange(len(t))[::-1], num_threads=3)
    for k, i in enumerate(range(len(t))[::-1]):
        np.testing.assert_array_equal(batch["image"][k], j.get_raw(i)["image"])
        assert batch["age"][k] == j.ages[i]


def test_probe_cap_and_dct_scaled_folder(decoders, tmp_path):
    for n in _faces(4):
        shutil.copy(os.path.join(FACES, n), tmp_path / n)
    assert TUTK(str(tmp_path), native=0, native_cap=150).native == 150
    t, j = TUTK(str(tmp_path), decode_m=6), JUTK(str(tmp_path), decode_m=6)
    assert t.out_size == j.out_size == 150
    idx = np.arange(4)
    np.testing.assert_array_equal(t.get_raw_batch(idx)["image"],
                                  j.get_raw_batch(idx)["image"])
    np.testing.assert_array_equal(t.get_raw(2)["image"],
                                  t.get_raw_batch(idx)["image"][2])
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(
        tmp_path / "50_0_0_small.jpg")
    # a JPEG off the canvas at decode_m < 8 takes the JAX dataset's PIL
    # draft route, bit for bit
    small, jsmall = TUTK(str(tmp_path), decode_m=6), JUTK(str(tmp_path),
                                                          decode_m=6)
    i = small.paths.index(str(tmp_path / "50_0_0_small.jpg"))
    np.testing.assert_array_equal(small.get_raw(i)["image"],
                                  jsmall.get_raw(i)["image"])


def _cfgs(**data):
    return (jcfg.Config(data=jcfg.DataConfig(**data)),
            tcfg.Config(data=tcfg.DataConfig(**data)))


def test_canvas_guards_match_jax(mixed, tmp_path):
    jc, tc = _cfgs(dataroot=mixed, dataset_mode="aging", host_decode_m=4,
                   load_size=143)
    for mod, cfg in ((jloader, jc), (tloader, tc)):
        with pytest.raises(ValueError, match="host_decode_m 4"):
            mod.create_dataset(cfg)
    pack = str(tmp_path / "pack")
    tpacked.write_pack(TUTK(mixed), pack, resize_to=64)
    jc, tc = _cfgs(dataroot=pack, dataset_mode="packed", load_size=143)
    for mod, cfg in ((jloader, jc), (tloader, tc)):
        with pytest.raises(ValueError, match="pre-resized to 64px"):
            mod.create_dataset(cfg)
    jc, tc = _cfgs(dataroot=pack, dataset_mode="packed", load_size=64)
    assert len(tloader.create_dataset(tc)) == len(jloader.create_dataset(jc))


@pytest.mark.parametrize("resize_to,method", [(0, "bicubic"),
                                              (143, "bicubic"),
                                              (64, "bilinear")])
def test_packs_cross_read_both_ways(mixed, tmp_path, resize_to, method):
    t, j = TUTK(mixed), JUTK(mixed)
    tp, jp = str(tmp_path / "t"), str(tmp_path / "j")
    tm = tpacked.write_pack(t, tp, resize_to=resize_to, resize_method=method,
                            num_threads=2, source="s")
    jm = jpacked.write_pack(j, jp, resize_to=resize_to, resize_method=method,
                            num_threads=2, source="s")
    assert tm == jm
    assert tpacked.is_pack_dir(jp) and jpacked.is_pack_dir(tp)
    for f in ("images.npy", "ages.npy"):
        with open(os.path.join(tp, f), "rb") as a, \
                open(os.path.join(jp, f), "rb") as b:
            assert a.read() == b.read(), f
    _same_rows(tpacked.PackedDataset(jp), jpacked.PackedDataset(tp))
    pk = tpacked.PackedDataset(jp, max_size=5)
    assert len(pk) == 5 and pk.resized == bool(resize_to)
    b = pk.get_raw_batch([4, 0])
    np.testing.assert_array_equal(b["image"][0], pk.get_raw(4)["image"])


def _write_csv(root, lines):
    os.makedirs(root / "ann", exist_ok=True)
    p = root / "ann" / "pairs.csv"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


@pytest.fixture()
def csv_tree(mixed, tmp_path):
    """Four images beside the CSV (``ann/img/``) and four only under the
    ``dataroot`` (``tmp_path``); the CSV is ``ann/pairs.csv``."""
    names = sorted(os.listdir(mixed))
    for n in names[:4]:
        shutil.copy(os.path.join(mixed, n), tmp_path / n)
    os.makedirs(tmp_path / "ann" / "img")
    for n in names[4:8]:
        shutil.copy(os.path.join(mixed, n), tmp_path / "ann" / "img" / n)
    return tmp_path, names


def test_comparisons_csv_matches_jax(csv_tree):
    root, names = csv_tree
    absp = os.path.join(str(root), names[0])
    csv = _write_csv(root, [
        "path_a,path_b,label",
        f"img/{names[4]},img/{names[5]},0",
        f"{names[1]},img/{names[6]},B",
        f"{absp},img/{names[7]},tie",
        f"img/{names[5]},{names[2]},older",
        f"{names[3]},img/{names[4]},younger",
        "", f"img/{names[6]},{names[3]}",          # skipped: < 3 columns
    ])
    t, j = TCSV(csv, dataroot=str(root)), JCSV(csv, dataroot=str(root))
    assert t.rows == j.rows and len(t) == 5
    assert [r[2] for r in t.rows] == [0, 1, 2, 0, 1]
    _same_rows(t, j)
    tp, jp = t.image_pool_dataset(), j.image_pool_dataset()
    assert tp.paths == jp.paths and len(tp) == 8
    _same_rows(tp, jp)
    assert len(TCSV(csv, dataroot=str(root), max_size=2)) == 2


def test_comparisons_csv_errors_match_jax(csv_tree):
    root, names = csv_tree
    bad = _write_csv(root, [f"{names[0]},{names[1]},0",
                            f"{names[1]},{names[2]},maybe"])
    for cls in (TCSV, JCSV):
        with pytest.raises(ValueError, match="pairs.csv:2: bad label"):
            cls(bad, dataroot=str(root))
    missing = _write_csv(root, [f"{names[0]},nope.jpg,1"])
    for cls in (TCSV, JCSV):
        with pytest.raises(FileNotFoundError, match="nope.jpg"):
            cls(missing, dataroot=str(root))
        with pytest.raises(FileNotFoundError, match="comparisons_csv"):
            cls(str(root / "none.csv"))
    header_only = _write_csv(root, ["a,b,label"])
    for cls in (TCSV, JCSV):
        with pytest.raises(ValueError, match="no comparison rows"):
            cls(header_only)


def test_sorted_labels_match_jax(mixed, tmp_path):
    names = sorted(os.listdir(mixed))
    p = tmp_path / "labels.csv"
    with open(p, "w") as f:
        f.write("path,bin,score\n")
        for k, n in enumerate(names):
            f.write(f"{os.path.join(mixed, n)},{k % 4},{k * 0.1:.6f}\n")
    t, j = TSorted(str(p)), JSorted(str(p))
    assert t.paths == j.paths and len(t) == len(names)
    np.testing.assert_array_equal(t.bins, j.bins)
    _same_rows(t, j)
    assert len(TSorted(str(p), max_size=3)) == 3
    with pytest.raises(FileNotFoundError, match="sort_unlabeled"):
        TSorted(str(tmp_path / "none.csv"))


@pytest.mark.parametrize("resize_to", [0, 143, 64])
def test_loader_over_a_folder_matches_jax(decoders, resize_to):
    jds, tds = JUTK(FACES), TUTK(FACES)
    kw = dict(shuffle=True, seed=5, num_threads=2, resize_to=resize_to)
    jl, tl = jloader.Loader(jds, 8, **kw), tloader.Loader(tds, 8, **kw)
    tl.skip_next = jl.skip_next = 1
    for _ in range(2):
        jb = list(jloader.with_bins(iter(jl), 10))
        tb = list(tloader.with_bins(iter(tl), 10))
        assert len(jb) == len(tb) == (3 if tl.epoch == 1 else 4)
        for a, b in zip(jb, tb):
            assert set(a) == set(b) == {"image", "age", "bin"}
            side = resize_to or 200
            assert b["image"].shape == (8, side, side, 3)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_phase_root_and_split_record(decoders, tmp_path):
    assert tloader.phase_root(str(tmp_path), "test") == str(tmp_path)
    os.makedirs(tmp_path / "test")
    for n in _faces(2):
        shutil.copy(os.path.join(FACES, n), tmp_path / "test" / n)
    for phase in ("test", "train", ""):
        assert tloader.phase_root(str(tmp_path), phase) == jloader.phase_root(
            str(tmp_path), phase)
    jc, tc = _cfgs(dataroot=str(tmp_path), dataset_mode="aging")
    jc = jcfg.Config(data=jc.data, run=jcfg.RunConfig(phase="test"))
    tc = tcfg.Config(data=tc.data, run=tcfg.RunConfig(phase="test"))
    assert tloader.create_dataset(tc).paths == jloader.create_dataset(jc).paths
    assert len(tloader.create_dataset(tc)) == 2
    # the pairs of comparator pretraining over a folder
    jc, tc = _cfgs(dataroot=FACES, dataset_mode="pairwise")
    tp, jp = tloader.create_dataset(tc), jloader.create_dataset(jc)
    np.testing.assert_array_equal(tp._idx, jp._idx)
    _same_rows(tp, jp, idx=[0, 5])
    assert json.dumps(tp.base.paths) == json.dumps(jp.base.paths)
