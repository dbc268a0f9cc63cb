"""pcgan_tpu_torch serving export (``serving.py``,
``tools/export_serving.py``) held against the live port G and against the
JAX package's artifact (CPU).

- export -> load -> call equals the live port G: f32 within 1e-6; bf16
  within the export CLI's --verify limit (5e-2); int8 within its int8
  limits (max 0.3, mean 0.03). Measured here: all three exactly 0 (the
  program runs the same ATen ops as the live module). Batches 1, 3 and 5
  go through one symbolic artifact.
- The port's ``ServedGenerator`` and the JAX one on converted f32 weights
  within 1e-4 (the golden grid's atol).
- Fixed-batch pad and slice, score mode, the comparator export, the
  export-dir kind guard, a JAX export directory rejected, and loading with
  the port's model code blocked.
- The export CLI with ``--verify``: plain, ``--quant_int8
  --calib_dataroot`` over the committed face fixtures, ``--use_ema``,
  ``--comparator_path``.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = os.path.join(ROOT, "tests", "torch_port_data", "faces")
SMALL = ["--netG", "resnet_6blocks", "--crop_size", "32", "--load_size",
         "36", "--ngf", "8", "--n_age_bins", "4", "--cond_inject",
         "bottleneck"]


def _port_cfg(dtype="float32", extra=()):
    from pcgan_tpu_torch.config import parse_config
    return parse_config(SMALL + ["--dtype", dtype, *extra], is_train=False)


def _port_g(cfg, seed=0):
    from pcgan_tpu_torch.models import define_G
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return define_G(cfg, torch.Generator().manual_seed(seed)).eval()


def _inputs(b, seed=0, nb=4, score=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
    if score:
        return x, rng.uniform(-1, 1, (b, 1)).astype(np.float32)
    return x, np.eye(nb, dtype=np.float32)[rng.integers(0, nb, b)]


def _live(G, x, c):
    dt = G.stem.compute_dtype
    with torch.no_grad():
        return G(torch.from_numpy(x).to(dt), torch.from_numpy(c).to(dt)
                 ).float().numpy()


_ARTIFACTS = {}


def _artifact(kind, tmp_path_factory):
    """(cfg, live G, artifact dir) per kind, exported once per module: f32,
    bf16, and int8 (bf16 compute, calibrated on one batch of 8)."""
    if kind not in _ARTIFACTS:
        from pcgan_tpu_torch.ops.quant import calibrate_quant
        from pcgan_tpu_torch.serving import export_generator
        dtype = "float32" if kind == "f32" else "bfloat16"
        cfg = _port_cfg(dtype, ("--quant_int8",) if kind == "int8" else ())
        G = _port_g(cfg)
        if kind == "int8":
            x, c = _inputs(8, seed=9)
            calibrate_quant(G, [(torch.from_numpy(x), torch.from_numpy(c))])
        d = str(tmp_path_factory.mktemp(kind))
        export_generator(cfg, G, d)
        _ARTIFACTS[kind] = (cfg, G, d)
    return _ARTIFACTS[kind]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_export_roundtrip_equals_live(tmp_path_factory, kind):
    from pcgan_tpu_torch.serving import load_exported
    cfg, G, d = _artifact(kind, tmp_path_factory)
    assert os.path.isfile(os.path.join(d, "generator.pt2"))
    meta = json.loads(open(os.path.join(d, "meta.json")).read())
    assert meta["format"] == "pcgan_tpu_torch.serving/1"
    assert meta["platforms"] == ["cuda", "cpu"]
    assert meta["fixed_batch"] is None
    assert meta["compute_dtype"] == cfg.model.dtype
    served = load_exported(d, device="cpu")
    max_tol, mean_tol = {"f32": (1e-6, 1e-6), "bf16": (5e-2, 5e-2),
                         "int8": (0.3, 0.03)}[kind]
    for b in (1, 3, 5):
        x, c = _inputs(b, seed=b)
        got = served(x, c)
        want = _live(G, x, c)
        assert got.shape == want.shape == (b, 32, 32, 3)
        d_ = np.abs(got - want)
        assert d_.max() <= max_tol and d_.mean() <= mean_tol, (b, d_.max())
    assert served(np.zeros((0, 32, 32, 3), np.float32),
                  np.zeros((0, 4), np.float32)).shape == (0, 32, 32, 3)


def test_fixed_batch_score_mode_and_conditions(tmp_path):
    from pcgan_tpu_torch.sample import make_sampler
    from pcgan_tpu_torch.serving import export_generator, load_exported
    cfg = _port_cfg()
    G = _port_g(cfg)
    export_generator(cfg, G, str(tmp_path / "fb"), fixed_batch=4)
    served = load_exported(str(tmp_path / "fb"), device="cpu")
    assert served.meta["fixed_batch"] == 4
    x, c = _inputs(6)                     # 4 + a ragged 2 -> two padded calls
    np.testing.assert_allclose(served(x, c), _live(G, x, c), atol=1e-6)
    grid = served.progression(x[:2])
    np.testing.assert_allclose(
        grid, make_sampler(cfg, G)(torch.from_numpy(x[:2])).numpy(),
        atol=1e-6)
    anim = served.animation(x[:1], n_frames=7)
    assert anim.shape == (1, 7, 32, 32, 3)
    np.testing.assert_array_equal(anim[0, ::2], served.progression(x[:1])[0])
    with pytest.raises(ValueError, match=">= 2"):
        served.sweep_conditions(1)
    with pytest.raises(ValueError, match="batch mismatch"):
        served(x[:2], c[:3])
    with pytest.raises(ValueError, match="symbolic-batch"):
        served.data_parallel(["cpu", "cpu"])

    scfg = _port_cfg(extra=("--cond_mode", "score"))
    sG = _port_g(scfg)
    export_generator(scfg, sG, str(tmp_path / "score"))
    s_served = load_exported(str(tmp_path / "score"), device="cpu")
    assert s_served.meta["cond_mode"] == "score"
    assert s_served.meta["cond_nc"] == 1
    np.testing.assert_allclose(s_served.all_conditions()[:, 0],
                               np.linspace(-1, 1, 4))
    x, c = _inputs(3, score=True)
    np.testing.assert_allclose(s_served(x, c), _live(sG, x, c), atol=1e-6)


def _comparator(tmp_path, dtype="float32"):
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_C
    from pcgan_tpu_torch.utils.checkpoint import save_comparator_bundle
    ccfg = parse_config(["--crop_size", "32", "--load_size", "36",
                         "--n_age_bins", "4", "--cmp_nf", "8",
                         "--cmp_n_down", "3", "--dtype", dtype],
                        is_train=False)
    C = define_C(ccfg, torch.Generator().manual_seed(3)).eval()
    save_comparator_bundle(C, np.zeros(4), np.ones(4), np.full(4, 0.5),
                           ccfg, str(tmp_path / "ck"), "cmp")
    return ccfg, C, str(tmp_path / "ck" / "cmp")


def test_comparator_export_and_kind_guard(tmp_path):
    from pcgan_tpu_torch.serving import (export_comparator, export_generator,
                                         load_exported)
    ccfg, C, _ = _comparator(tmp_path)
    export_comparator(ccfg, C, str(tmp_path / "c"))
    served = load_exported(str(tmp_path / "c"), device="cpu")
    assert type(served).__name__ == "ServedComparator"
    x, _ = _inputs(5)
    mu, lv = served(x)
    with torch.no_grad():
        want_mu, want_lv = C(torch.from_numpy(x))
    np.testing.assert_allclose(mu, want_mu.numpy(), atol=1e-6)
    np.testing.assert_allclose(lv, want_lv.numpy(), atol=1e-6)
    np.testing.assert_array_equal(served.score(x), mu)
    export_comparator(ccfg, C, str(tmp_path / "cf"), fixed_batch=2)
    np.testing.assert_allclose(
        load_exported(str(tmp_path / "cf"), device="cpu").score(x), mu,
        atol=1e-6)
    # one directory holds one kind
    cfg = _port_cfg()
    with pytest.raises(ValueError, match="comparator export"):
        export_generator(cfg, _port_g(cfg), str(tmp_path / "c"))
    from pcgan_tpu_torch.tools import serve_http
    with pytest.raises(ValueError, match="generator exports"):
        serve_http.make_server(str(tmp_path / "c"), "127.0.0.1", 0,
                               device="cpu")


def _jax_artifact(tmp_path, seed=7):
    """A JAX f32 G (tiny), its StableHLO export, and the port G with the
    converted weights."""
    from pcgan_tpu.config import parse_config as jax_parse
    from pcgan_tpu.models.registry import define_G as jax_define_G
    from pcgan_tpu.serving import export_generator as jax_export
    from pcgan_tpu_torch import convert
    argv = SMALL + ["--dtype", "float32"]
    jcfg = jax_parse(argv, is_train=False)
    jG = jax_define_G(jcfg)
    jvars = jax.jit(lambda k: jG.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 4)), train=False))(jax.random.PRNGKey(seed))
    jax_export(jcfg, jvars, str(tmp_path / "jax"), platforms=("cpu",), G=jG)
    pcfg = _port_cfg()
    pG = _port_g(pcfg)
    pG.load_state_dict(convert.convert_generator_params(jvars["params"]))
    return pcfg, pG


def test_port_served_matches_jax_served_and_rejects_its_dir(tmp_path):
    from pcgan_tpu.serving import load_exported as jax_load
    from pcgan_tpu_torch.serving import export_generator, load_exported
    pcfg, pG = _jax_artifact(tmp_path)
    export_generator(pcfg, pG, str(tmp_path / "port"))
    j = jax_load(str(tmp_path / "jax"))
    p = load_exported(str(tmp_path / "port"), device="cpu")
    x, c = _inputs(3, seed=4)
    np.testing.assert_allclose(p(x, c), j(x, c), atol=1e-4)
    np.testing.assert_allclose(p.progression(x[:2]), j.progression(x[:2]),
                               atol=1e-4)
    np.testing.assert_allclose(p.animation(x[:1], 5), j.animation(x[:1], 5),
                               atol=1e-4)
    np.testing.assert_array_equal(p.sweep_conditions(9),
                                  j.sweep_conditions(9))
    assert {k: v for k, v in p.meta.items()
            if k not in ("format", "platforms")} == {
        k: v for k, v in j.meta.items() if k not in ("format", "platforms")}
    with pytest.raises(ValueError, match="JAX"):
        load_exported(str(tmp_path / "jax"), device="cpu")
    with pytest.raises(FileNotFoundError, match="not a pcgan_tpu_torch"):
        load_exported(str(tmp_path), device="cpu")
    (tmp_path / "odd").mkdir()
    (tmp_path / "odd" / "meta.json").write_text('{"format": "other/9"}')
    with pytest.raises(ValueError, match="unsupported format"):
        load_exported(str(tmp_path / "odd"), device="cpu")


def test_loading_needs_no_model_code(tmp_path, tmp_path_factory):
    """A serving host imports torch, numpy and pcgan_tpu_torch.serving: the
    program loads and runs with the port's models, ops and config blocked
    (an int8 artifact, whose trunk is the most code)."""
    _, G, d = _artifact("int8", tmp_path_factory)
    x, c = _inputs(2)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "c.npy", c)
    np.save(tmp_path / "want.npy", _live(G, x, c))
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.startswith(("pcgan_tpu_torch.models", "pcgan_tpu_torch.ops",
                            "pcgan_tpu_torch.config", "pcgan_tpu.", "jax")):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
from pcgan_tpu_torch.serving import load_exported
s = load_exported({d!r}, device="cpu")
got = s(np.load({str(tmp_path / 'x.npy')!r}), np.load({str(tmp_path / 'c.npy')!r}))
assert np.array_equal(got, np.load({str(tmp_path / 'want.npy')!r}))
assert not any(m.startswith(("pcgan_tpu_torch.models", "pcgan_tpu_torch.ops"))
               for m in sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]


def test_devices_without_a_card(tmp_path, tmp_path_factory, monkeypatch):
    from pcgan_tpu_torch.serving import check_platforms, load_exported
    _, _, d = _artifact("f32", tmp_path_factory)
    cpu_only = tmp_path / "b"
    cpu_only.mkdir()
    for f in ("generator.pt2", "meta.json"):
        (cpu_only / f).write_bytes(open(os.path.join(d, f), "rb").read())
    meta = json.loads((cpu_only / "meta.json").read_text())
    (cpu_only / "meta.json").write_text(json.dumps({**meta,
                                                    "platforms": ["cpu"]}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(d)                                # device="cuda"
    with pytest.raises(ValueError, match="exported for"):
        load_exported(str(cpu_only), device="cuda")
    with pytest.raises(ValueError, match="tpu"):
        check_platforms(["tpu", "cpu"])
    from pcgan_tpu_torch.tools import serve_http
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_http.make_server(d, "127.0.0.1", 0)


def _save_run(tmp_path, ema=False):
    from pcgan_tpu_torch.utils.checkpoint import save_generator
    cfg = _port_cfg("bfloat16")
    G = _port_g(cfg)
    save_generator(G, str(tmp_path / "ck"), "run")
    if ema:
        save_generator(_port_g(cfg, seed=1), str(tmp_path / "ck"), "run",
                       use_ema=True)
    return G


@pytest.mark.parametrize("flags", [
    [], ["--quant_int8", "--calib_dataroot", FACES, "--calib_batches", "2"],
    ["--use_ema", "--fixed_batch", "2"], ["comparator"]],
    ids=["bf16", "int8", "ema", "comparator"])
def test_cli_export_verify(tmp_path, capsys, flags):
    from pcgan_tpu_torch.tools import export_serving
    out_dir = str(tmp_path / "srv")
    if flags == ["comparator"]:
        _, _, run = _comparator(tmp_path)
        argv = ["--comparator_path", run, "--cmp_nf", "8", "--cmp_n_down",
                "3", "--crop_size", "32", "--n_age_bins", "4"]
    else:
        _save_run(tmp_path, ema="--use_ema" in flags)
        argv = ["--name", "run", "--checkpoints_dir", str(tmp_path / "ck"),
                "--netG", "resnet_6blocks", "--ngf", "8", "--cond_inject",
                "bottleneck", "--crop_size", "32", "--n_age_bins", "4",
                *flags]
    assert export_serving.main(argv + ["--verify", "--out_dir", out_dir,
                                       "--device", "cpu"]) == out_dir
    log = capsys.readouterr().out
    assert "verify: max|exported - live|" in log
    err = float(log.split("verify: max|exported - live| = ")[1].split()[0])
    assert err <= (0.3 if "--quant_int8" in flags else 5e-2)
    meta = json.loads(open(os.path.join(out_dir, "meta.json")).read())
    if flags == ["comparator"]:
        assert meta["kind"] == "comparator"
        assert meta["compute_dtype"] == "float32"
        return
    assert meta["compute_dtype"] == "bfloat16" and meta["netG"] == \
        "resnet_6blocks"
    assert meta["ema_source"] == ("--use_ema" in flags)
    assert meta["fixed_batch"] == (2 if "--fixed_batch" in flags else None)
    if "--quant_int8" in flags:
        assert f"from {FACES}" in log
        ep = torch.export.load(os.path.join(out_dir, "generator.pt2"))
        assert sum(k.endswith("act_absmax") for k in ep.constants) == 17


def test_cli_rejects_bad_requests(tmp_path):
    from pcgan_tpu_torch.tools import export_serving
    _save_run(tmp_path)
    base = ["--name", "run", "--checkpoints_dir", str(tmp_path / "ck"),
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="tpu"):
        export_serving.main(base + ["--platforms", "tpu,cpu"])
    with pytest.raises(SystemExit, match="generator exports only"):
        export_serving.main(["--comparator_path", str(tmp_path),
                             "--quant_int8", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--name is required"):
        export_serving.main(["--device", "cpu"])
