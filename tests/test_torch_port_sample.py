"""The ported slice as a whole: ``python -m pcgan_tpu_torch.test`` == the
root ``test.py`` (CPU).

One flax generator is saved through ``pcgan_tpu.utils.checkpoint`` for the
JAX CLI and, converted, through the port's ``save_generator``; both CLIs
then sample the same synthetic images in f32. Every written PNG must agree
within 1 u8 LSB (f32 noise can flip one rounding step of the final
quantization).
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import os
import warnings

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

ARGS = ["--dataset_mode", "synthetic", "--max_dataset_size", "4",
        "--num_test", "3", "--batch_size", "2", "--crop_size", "32",
        "--load_size", "36", "--netG", "resnet_6blocks", "--ngf", "8",
        "--n_age_bins", "4", "--dtype", "float32", "--name", "run"]


def _read(path):
    return np.asarray(Image.open(path).convert("RGB"), np.int16)


@pytest.mark.parametrize("inject", ["input", "bottleneck"])
def test_port_cli_matches_jax_cli(tmp_path, inject):
    import test as jax_cli
    from pcgan_tpu.config import parse_config as jax_parse
    from pcgan_tpu.models.registry import define_G, init_params
    from pcgan_tpu.utils import checkpoint as jax_ckpt
    from pcgan_tpu_torch import convert
    from pcgan_tpu_torch import test as port_cli
    from pcgan_tpu_torch.config import parse_config as port_parse
    from pcgan_tpu_torch.models import define_G as port_define_G
    from pcgan_tpu_torch.utils.checkpoint import save_generator

    args = ARGS + ["--cond_inject", inject]
    jG = define_G(jax_parse(args, is_train=False))
    params = init_params(jG, jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3)),
                         jnp.zeros((1, 4)), train=False)["params"]
    jax_ckpt.save({"g_params": params, "g_state": {}}, str(tmp_path / "jck"),
                  "run", "latest_G", wait=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pG = port_define_G(port_parse(args, is_train=False))
    pG.load_state_dict(convert.convert_generator_params(params))
    save_generator(pG, str(tmp_path / "pck"), "run")

    jax_cli.main(args + ["--checkpoints_dir", str(tmp_path / "jck"),
                         "--results_dir", str(tmp_path / "jres")])
    out = port_cli.main(args + ["--checkpoints_dir", str(tmp_path / "pck"),
                                "--results_dir", str(tmp_path / "pres"),
                                "--device", "cpu"])
    assert out["done"] == 3 and len(out["batch_seconds"]) == 2

    jdir = tmp_path / "jres" / "run" / "test_latest"
    pdir = tmp_path / "pres" / "run" / "test_latest"
    assert out["web_dir"] == str(pdir)
    names = sorted(os.listdir(jdir / "images"))
    assert names == sorted(os.listdir(pdir / "images"))
    assert len(names) == 3 * (1 + 4)
    for n in names:
        a, b = _read(jdir / "images" / n), _read(pdir / "images" / n)
        assert a.shape == b.shape == (32, 32, 3), n
        assert np.abs(a - b).max() <= 1, n
    assert (jdir / "index.html").read_text() == (pdir / "index.html").read_text()


def test_missing_checkpoint_exits(tmp_path):
    from pcgan_tpu_torch import test as port_cli
    with pytest.raises(SystemExit, match="not found"):
        port_cli.main(ARGS + ["--cond_inject", "bottleneck",
                              "--checkpoints_dir", str(tmp_path),
                              "--results_dir", str(tmp_path / "r"),
                              "--device", "cpu"])


@pytest.mark.parametrize("flags", [["--dataset_mode", "celeba"]])
def test_unported_cli_flags_raise(tmp_path, flags):
    from pcgan_tpu_torch import test as port_cli
    from pcgan_tpu_torch.config import parse_config as port_parse
    from pcgan_tpu_torch.models import define_G as port_define_G
    from pcgan_tpu_torch.utils.checkpoint import save_generator
    args = ARGS + ["--cond_inject", "bottleneck",
                   "--checkpoints_dir", str(tmp_path),
                   "--results_dir", str(tmp_path / "r"), "--device", "cpu"]
    save_generator(port_define_G(port_parse(args)), str(tmp_path), "run")
    with pytest.raises(NotImplementedError):
        port_cli.main(args + flags)


def test_device_cuda_without_card_raises(monkeypatch):
    import torch
    from pcgan_tpu_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_png_encoder_round_trips(tmp_path):
    from pcgan_tpu_torch.utils.visualizer import save_image, tensor_to_u8
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    save_image(rgb, str(tmp_path / "a.png"))
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), rgb)
    gray = rng.integers(0, 256, (4, 6), dtype=np.uint8)
    save_image(gray, str(tmp_path / "g.png"))
    assert np.array_equal(np.asarray(Image.open(tmp_path / "g.png")), gray)
    f = rng.uniform(-1.2, 1.2, (3, 3, 3)).astype(np.float32)
    save_image(f, str(tmp_path / "f.png"))
    assert np.array_equal(np.asarray(Image.open(tmp_path / "f.png")),
                          tensor_to_u8(f))
