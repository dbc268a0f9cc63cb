"""The one-card leftovers of the port against the JAX package (CPU).

- ``--no-pallas_pipeline``: ``make_preprocess`` runs its plain version on
  the batch's device; on the same u8 batch with JAX's crop offsets and
  flips pinned it equals JAX's ``make_preprocess`` (its plain XLA route,
  the one JAX runs off the TPU) within 2e-5 in f32 and one bf16 ulp in
  bf16 (B1's gates).
- ``--host_decode_m < 8`` on a JPEG off the native canvas or in CMYK: the
  port takes the JAX dataset's PIL route (``draft`` to a power-of-two DCT
  scale, then the bicubic resize), bit for bit, on JPEGs written here with
  Pillow from ``tests/torch_port_data/make_faces.py``'s seeded canvases.
- ``scripts/smoke_cpu.sh``: its two argument lists (read from the script)
  resolve to the JAX ``parse_config``'s configs, and run through the port's
  ``train_main`` and ``test`` with ``--device cpu`` (the train list with
  ``--max_dataset_size 16`` appended, as its ``"$@"`` allows), writing
  checkpoints and an aging grid.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import dataclasses
import os
import shlex
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu import config as jcfg
from pcgan_tpu.data.utkface import UTKFaceDataset as JaxUTKFace
from pcgan_tpu.ops import preprocess as jax_pre
from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch.data.utkface import UTKFaceDataset
from pcgan_tpu_torch.ops import preprocess as port_pre

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(HERE, "torch_port_data"))
import make_faces  # noqa: E402


def bf16_ulp(v):
    a = np.maximum(np.abs(np.asarray(v, np.float32)), 2.0 ** -7)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_no_pallas_pipeline_matches_jax(monkeypatch, dtype, train):
    argv = ["--load_size", "40", "--crop_size", "32", "--dtype", dtype,
            "--no-pallas_pipeline"]
    jc = jcfg.parse_config(argv, is_train=train)
    pc = tcfg.parse_config(argv + ["--device", "cpu"], is_train=train)
    assert not jc.data.pallas_pipeline and not pc.data.pallas_pipeline
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (4, 50, 50, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax_pre.make_preprocess(jc, train=train)(
        key, {"image": jnp.asarray(imgs)})["image"], np.float32)
    # JAX's draws for this key, handed to the port's draws in order
    r1, r2, r3 = jax.random.split(key, 3)
    draws = [np.asarray(jax.random.randint(r, (4,), 0, 9)) for r in (r1, r2)]
    flips = np.asarray(jax.random.bernoulli(r3, 0.5, (4,)))
    monkeypatch.setattr(torch, "randint", lambda *a, **k: torch.from_numpy(
        draws.pop(0)))
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.from_numpy(
        np.where(flips, 0.0, 1.0).astype(np.float32)))
    got = port_pre.make_preprocess(pc, train=train)(
        torch.Generator(), {"image": torch.from_numpy(imgs)})["image"]
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    assert draws == [] or not train
    got = got.float().numpy()
    tol = 2e-5 if dtype == "float32" else bf16_ulp(want)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _faces(tmp_path):
    """A folder of three off-canvas JPEGs (160 px, 150 x 210, greyscale
    120 px) and two CMYK JPEGs at the native 200 px, from the fixtures'
    seeded canvases."""
    from PIL import Image
    rows = list(make_faces.canvases())
    folder = tmp_path / "faces"
    folder.mkdir()
    made = [(0, "resize", (160, 160)), (1, "resize", (210, 150)),
            (make_faces.GREY, "resize", (120, 120)), (2, "cmyk", None),
            (3, "cmyk", None)]
    for i, kind, size in made:
        stem, img, _ = rows[i]
        im = Image.fromarray(img)
        if kind == "resize":
            im = im.resize(size, Image.Resampling.BICUBIC)
        else:
            im = im.convert("CMYK")
        im.save(folder / f"{stem}.jpg", quality=90)
    return str(folder)


@pytest.mark.parametrize("decode_m", [4, 6])
def test_off_canvas_and_cmyk_jpegs_decode_as_jax(tmp_path, decode_m):
    folder = _faces(tmp_path)
    jds = JaxUTKFace(folder, native=200, decode_m=decode_m)
    pds = UTKFaceDataset(folder, native=200, decode_m=decode_m)
    assert jds.paths == pds.paths and jds.out_size == pds.out_size
    batch = pds.get_raw_batch(np.arange(len(pds)), num_threads=2)["image"]
    for i in range(len(pds)):
        want = jds.get_raw(i)["image"]
        got = pds.get_raw(i)["image"]
        assert got.shape == want.shape == (pds.out_size, pds.out_size, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(batch[i], want)


def _smoke_lists():
    """The two python command lines of scripts/smoke_cpu.sh, as argv
    lists after the script name (``"$@"`` dropped)."""
    with open(os.path.join(REPO, "scripts", "smoke_cpu.sh")) as f:
        text = f.read().replace("\\\n", " ")
    lists = {}
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if words[:1] == ["python"]:
            lists[words[1]] = [w for w in words[2:] if w != "$@"]
    return lists["train.py"], lists["test.py"]


def _same_config(jc, pc):
    want = dataclasses.asdict(jc)
    got = dataclasses.asdict(pc)
    for k in ("device", "allow_pickle"):
        got["run"].pop(k)
    assert got == want


def test_smoke_cpu_lists_run_through_the_port(tmp_path, monkeypatch):
    from pcgan_tpu_torch import test as port_test
    from pcgan_tpu_torch import train_main
    train, sample = _smoke_lists()
    train = train + ["--max_dataset_size", "16"]
    assert "--dtype" in train and "float32" in train
    _same_config(jcfg.parse_config(train, is_train=True),
                 tcfg.parse_config(train + ["--device", "cpu"]))
    _same_config(jcfg.parse_config(sample, is_train=False),
                 tcfg.parse_config(sample + ["--device", "cpu"],
                                   is_train=False))
    monkeypatch.chdir(tmp_path)          # the lists' default output dirs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # input injection
        res = train_main.main(train + ["--device", "cpu"])
        out = port_test.main(sample + ["--device", "cpu"])
    assert res["step"] == 2                           # 16 images, batch 8
    assert all(np.isfinite(v) for v in res["metrics"].values())
    run = tmp_path / "checkpoints" / "smoke64"
    assert {"latest.pt", "latest_G.pt", "epoch_1_G.pt"} <= set(
        os.listdir(run))
    assert out["done"] == 4
    pngs = os.listdir(os.path.join(out["web_dir"], "images"))
    assert len(pngs) == 4 * (1 + 10)
    assert os.path.exists(os.path.join(out["web_dir"], "index.html"))
