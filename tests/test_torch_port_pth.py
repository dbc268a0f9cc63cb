"""The port's ``.pth`` import and export == the JAX package's (CPU).

A seeded reference-layout ``.pth`` (the torch mirror, batch-norm running
statistics drawn at random) goes through ``pcgan_tpu.utils.pth_import``
and ``convert.py`` and through the port's ``utils/pth_import.py``: the two
state dicts are equal exactly, and the imported G's f32 forward matches
the JAX G's within 1e-4 (the golden grid's tolerance). The port's export
equals JAX's ``export_generator_pth`` of the same weights, key for key and
bit for bit, and an export-then-import round trip is the identity. The
port's mirror copy (``utils/pth_mirror.py``) is held against
``benchmarks/torch_baseline.py``.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.config import parse_config as jax_parse
from pcgan_tpu.models.registry import define_G as jax_define_G
from pcgan_tpu.models.registry import init_params
from pcgan_tpu.utils import pth_export as jax_export
from pcgan_tpu.utils import pth_import as jax_import
from pcgan_tpu_torch import convert
from pcgan_tpu_torch.config import parse_config as port_parse
from pcgan_tpu_torch.models import define_G as port_define_G
from pcgan_tpu_torch.tools import export_pth, import_pth
from pcgan_tpu_torch.utils import checkpoint as ckpt
from pcgan_tpu_torch.utils import pth_mirror
from pcgan_tpu_torch.utils.pth_export import export_generator_pth
from pcgan_tpu_torch.utils.pth_import import import_generator_pth

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))
import torch_baseline  # noqa: E402

NB, NGF = 4, 8
CASES = [("resnet_6blocks", "instance", "input"),
         ("resnet_6blocks", "instance", "bottleneck"),
         ("resnet_6blocks", "batch", "input"),
         ("unet_32", "instance", "input")]
IDS = ["resnet_input", "resnet_bottleneck", "resnet_batchnorm", "unet_32"]


def _argv(netG, norm, inject):
    return ["--netG", netG, "--norm", norm, "--cond_inject", inject,
            "--ngf", str(NGF), "--crop_size", "32", "--load_size", "36",
            "--n_age_bins", str(NB), "--dtype", "float32"]


def _template(netG, norm, inject):
    stem = 3 + (NB if inject == "input" else 0)
    return export_pth.build_mirror_state_dict(netG, stem, 3, NGF, norm,
                                              inject, NB)


def _seeded_pth(netG, norm, inject, seed=3):
    """A reference-layout state dict with seeded random tensors everywhere
    (running variances positive)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in _template(netG, norm, inject).items():
        if not v.is_floating_point():
            sd[k] = v.clone()
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.2
    return sd


def _jax_vars(netG, norm, inject, seed=0):
    cfg = jax_parse(_argv(netG, norm, inject), is_train=False)
    G = jax_define_G(cfg)
    return G, init_params(G, jax.random.PRNGKey(seed),
                          jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, NB)),
                          train=False)


def _port_G(netG, norm, inject, seed=5):
    cfg = port_parse(_argv(netG, norm, inject) + ["--device", "cpu"],
                     is_train=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return port_define_G(cfg, torch.Generator().manual_seed(seed)).eval()


def _jax_import(sd, netG, norm, inject):
    G, jvars = _jax_vars(netG, norm, inject)
    new = jax_import.import_generator_pth(sd, jvars, netG, inject)
    port_sd = convert.convert_generator_params(new["params"], state=new)
    return G, new, port_sd


@pytest.mark.parametrize("netG,norm,inject", CASES, ids=IDS)
def test_import_equals_jax_and_forward_matches(netG, norm, inject):
    sd = _seeded_pth(netG, norm, inject)
    jG, jvars, want = _jax_import(sd, netG, norm, inject)
    pG = _port_G(netG, norm, inject)
    got = import_generator_pth(sd, pG.state_dict(), netG, inject)
    assert list(got) == list(pG.state_dict())
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    pG.load_state_dict(got, strict=True)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    c = np.eye(NB, dtype=np.float32)[[1, 3]]
    ref = np.asarray(jG.apply(jvars, jnp.asarray(x), jnp.asarray(c),
                              train=False))
    with torch.no_grad():
        out = pG(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("netG,norm,inject", CASES, ids=IDS)
def test_export_equals_jax_and_round_trips(netG, norm, inject):
    _, jvars = _jax_vars(netG, norm, inject, seed=4)
    tmpl = _template(netG, norm, inject)
    want = jax_export.export_generator_pth(jvars, netG, tmpl, inject)
    g_sd = convert.convert_generator_params(jvars["params"], state=jvars)
    got = export_generator_pth(g_sd, netG, tmpl, inject)
    assert list(got) == list(want) == list(tmpl)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    # export, then import into a differently seeded G: the identity
    back = import_generator_pth({k: torch.from_numpy(v) for k, v in
                                 got.items()},
                                _port_G(netG, norm, inject).state_dict(),
                                netG, inject)
    assert set(back) == set(g_sd)
    for k, v in g_sd.items():
        assert torch.equal(back[k], v), k


def test_mismatches_raise_as_in_jax():
    sd = _seeded_pth("resnet_6blocks", "instance", "input")
    # count: a 6-block file into a 9-block G
    _, j9 = _jax_vars("resnet_9blocks", "instance", "input")
    with pytest.raises(ValueError, match="conv-tensor count mismatch"):
        jax_import.import_generator_pth(sd, j9, "resnet_9blocks")
    with pytest.raises(ValueError, match="conv-tensor count mismatch"):
        import_generator_pth(sd, _port_G("resnet_9blocks", "instance",
                                         "input").state_dict(),
                             "resnet_9blocks")
    # shape: the file at another width
    wide = export_pth.build_mirror_state_dict("resnet_6blocks", 3 + NB, 3,
                                              2 * NGF, "instance")
    _, j6 = _jax_vars("resnet_6blocks", "instance", "input")
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_import.import_generator_pth(wide, j6, "resnet_6blocks")
    p6 = _port_G("resnet_6blocks", "instance", "input").state_dict()
    with pytest.raises(ValueError, match="shape mismatch"):
        import_generator_pth(wide, p6, "resnet_6blocks")
    with pytest.raises(ValueError, match="shape mismatch"):
        export_generator_pth(p6, "resnet_6blocks", wide)
    # norm count: a batch-norm file with a norm missing
    bn = _seeded_pth("resnet_6blocks", "batch", "input")
    cut = {k: v for k, v in bn.items() if not k.startswith("net.2.")}
    pbn = _port_G("resnet_6blocks", "batch", "input").state_dict()
    with pytest.raises(ValueError, match="norm-tensor count mismatch"):
        import_generator_pth(cut, pbn, "resnet_6blocks")


@pytest.mark.parametrize("netG,norm,inject", [
    ("resnet_6blocks", "instance", "input"),
    ("resnet_9blocks", "instance", "bottleneck"),
    ("resnet_9blocks", "batch", "input"),
    ("unet_32", "instance", "input"), ("unet_128", "instance", "input")])
def test_mirror_copy_matches_baseline(netG, norm, inject):
    stem = 3 + (NB if inject == "input" else 0)
    base = netG.partition("@")[0]
    if base.startswith("unet_"):
        n = int(base.split("_")[1]).bit_length() - 1
        want = torch_baseline.build_unet(stem, 3, n, ngf=NGF).state_dict()
        got = pth_mirror.build_unet(stem, 3, n, ngf=NGF).state_dict()
    else:
        kw = dict(ngf=NGF, n_blocks=int(base[7]), batchnorm=norm == "batch",
                  cond_nc=NB, cond_inject=inject)
        want = torch_baseline.ResnetG(stem, 3, **kw).state_dict()
        got = pth_mirror.ResnetG(stem, 3, **kw).state_dict()
    assert list(got) == list(want)
    assert [tuple(v.shape) for v in got.values()] == [
        tuple(v.shape) for v in want.values()]


def test_cli_round_trip_with_like(tmp_path, capsys):
    netG, norm, inject = "resnet_6blocks", "batch", "bottleneck"
    G = _port_G(netG, norm, inject, seed=9)
    ck = str(tmp_path / "ck")
    ckpt.save_generator(G, ck, "run", "latest")
    like = str(tmp_path / "like.pth")
    torch.save(_template(netG, norm, inject), like)
    arch = ["--netG", netG, "--norm", norm, "--cond_inject", inject,
            "--ngf", str(NGF), "--crop_size", "32", "--n_age_bins", str(NB)]
    out = export_pth.main(["--name", "run", "--checkpoints_dir", ck,
                           "--like", like, "--out",
                           str(tmp_path / "g.pth"), *arch])
    assert list(torch.load(out, weights_only=True)) == list(
        torch.load(like, weights_only=True))
    path = import_pth.main(["--pth", out, "--name", "back",
                            "--checkpoints_dir", ck, *arch])
    assert path == ckpt.generator_path(ck, "back", "latest")
    back = torch.load(path, weights_only=True)
    for k, v in G.state_dict().items():
        assert torch.equal(back[k], v), k
    assert "sample with: python -m pcgan_tpu_torch.test" in \
        capsys.readouterr().out
