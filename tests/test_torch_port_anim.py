"""pcgan_tpu_torch smooth aging animation (``test.py --anim N``) == the JAX
package's (CPU).

The onehot-mode condition sweep (``interp_bins_onehot``) equals JAX's bit
for bit (``jnp.linspace``'s f32 rounding reproduced); frames that land on a
bin equal that bin's grid column bit for bit; the animation sampler matches
JAX's on converted f32 weights within 1e-4 (the golden grid's atol); the
CLI writes ``{i:04d}_aging.gif`` rows that decode to N frames.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.config import parse_config as jax_parse
from pcgan_tpu.data.binning import interp_bins_onehot as jax_interp
from pcgan_tpu.models.registry import define_G as jax_define_G
from pcgan_tpu.sample import make_anim_sampler as jax_anim_sampler
from pcgan_tpu_torch import convert
from pcgan_tpu_torch.config import parse_config as port_parse
from pcgan_tpu_torch.data.binning import interp_bins_onehot, ramp_f32
from pcgan_tpu_torch.models import define_G as port_define_G
from pcgan_tpu_torch.sample import make_anim_sampler, make_sampler
from pcgan_tpu_torch.utils.visualizer import save_animation

SMALL = ["--netG", "resnet_6blocks", "--crop_size", "32", "--load_size",
         "36", "--ngf", "8", "--n_age_bins", "4", "--dtype", "float32",
         "--cond_inject", "bottleneck"]


@pytest.mark.parametrize("nb,frames", [(4, 4), (5, 13), (10, 24), (3, 7),
                                       (10, 2), (7, 50)])
def test_interp_bins_onehot_equals_jax(nb, frames):
    got = interp_bins_onehot(nb, frames).numpy()
    want = np.asarray(jax_interp(nb, frames))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ramp_f32(float(nb - 1), frames),
        np.asarray(jnp.linspace(0.0, float(nb - 1), frames)))
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
    assert int((got > 1e-6).sum(axis=1).max()) <= 2


def _pair(argv, seed=0):
    jG = jax_define_G(jax_parse(argv, is_train=False))
    cond_nc = 1 if "score" in argv else 4
    jvars = jax.jit(lambda k: jG.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, cond_nc)), train=False))(jax.random.PRNGKey(seed))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pG = port_define_G(port_parse(argv, is_train=False))
    pG.load_state_dict(convert.convert_generator_params(jvars["params"]))
    return jG, jvars, pG.eval()


@pytest.mark.parametrize("mode,frames", [("onehot", 13), ("score", 7)])
def test_anim_sampler_matches_jax(mode, frames):
    argv = SMALL + ["--cond_mode", mode]
    jG, jvars, pG = _pair(argv)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax_anim_sampler(jax_parse(argv, is_train=False), jG,
                                       frames)(jvars, jnp.asarray(x)))
    got = make_anim_sampler(port_parse(argv, is_train=False), pG, frames)(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, frames, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the condition moves every frame
    assert all(np.abs(got[0, i + 1] - got[0, i]).max() > 0
               for i in range(frames - 1))
    if mode == "onehot":
        # 13 frames over 4 bins: frames 0, 4, 8, 12 land on bins 0..3 and
        # equal the grid's columns bit for bit
        grid = make_sampler(port_parse(argv, is_train=False), pG)(
            torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got[:, ::4], grid)
        full = make_anim_sampler(port_parse(argv, is_train=False), pG, 4)(
            torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(full, grid)


def _gif_frames(path):
    from PIL import Image
    with Image.open(path) as im:
        return getattr(im, "n_frames", 1), im.size


@pytest.mark.parametrize("extra", [[], ["--quant_int8"]],
                         ids=["bf16", "int8"])
def test_cli_anim_writes_gifs(tmp_path, extra):
    from pcgan_tpu_torch import test as port_cli
    from pcgan_tpu_torch.utils.checkpoint import save_generator
    argv = [a if a != "float32" else "bfloat16" for a in SMALL]
    args = argv + ["--dataset_mode", "synthetic", "--max_dataset_size", "4",
                   "--batch_size", "2", "--num_test", "3", "--name", "run",
                   "--checkpoints_dir", str(tmp_path),
                   "--results_dir", str(tmp_path / "r"), "--device", "cpu"]
    save_generator(port_define_G(port_parse(args, is_train=False)),
                   str(tmp_path), "run")
    res = port_cli.main(args + ["--anim", "4"] + extra)
    assert res["done"] == 3
    img_dir = os.path.join(res["web_dir"], "images")
    gifs = sorted(f for f in os.listdir(img_dir) if f.endswith(".gif"))
    assert gifs == ["0000_aging.gif", "0001_aging.gif", "0002_aging.gif"]
    for g in gifs:
        assert _gif_frames(os.path.join(img_dir, g)) == (4, (32, 32))
    page = open(os.path.join(res["web_dir"], "index.html")).read()
    assert "0001_aging.gif" in page and "4-frame sweep" in page
    with pytest.raises(SystemExit, match=">= 2 frames"):
        port_cli.main(args + ["--anim", "1"])


def test_save_animation_contract(tmp_path, monkeypatch):
    frames = np.linspace(-1.0, 1.0, 5)[:, None, None, None] * np.ones(
        (5, 8, 8, 3), np.float32)
    path = str(tmp_path / "a.gif")
    save_animation(frames, path, duration_ms=50)
    assert _gif_frames(path) == (5, (8, 8))
    with pytest.raises(ValueError, match=">= 2 frames"):
        save_animation(frames[:1], str(tmp_path / "b.gif"))
    # without Pillow: a clear error, not a bare ModuleNotFoundError
    import builtins
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="Pillow"):
        save_animation(frames, str(tmp_path / "c.gif"))
