"""The port's run tools == the JAX package's (CPU): the SVGs of
``plot_losses`` and ``compare_runs`` are the same bytes as
``pcgan_tpu/utils/loss_plot.py``'s and ``tools/compare_runs.py``'s on the
same records; ``sweep``'s grid, names and last-metrics merge agree with
``tools/sweep.py``'s, and a two-combination sweep runs end to end through
``python -m pcgan_tpu_torch.train_main``; ``average_ckpts`` equals the
mean of the converted JAX parameter trees within 1e-7 over G-only tags,
full-state tags and EMA twins, with the buffers of the last tag.
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

from pcgan_tpu.config import parse_config as jax_parse
from pcgan_tpu.models.registry import define_G as jax_define_G
from pcgan_tpu.models.registry import init_params
from pcgan_tpu.utils.loss_plot import render_loss_svg as jax_render
from pcgan_tpu_torch import convert
from pcgan_tpu_torch.config import parse_config as port_parse
from pcgan_tpu_torch.models import define_D, define_G
from pcgan_tpu_torch.tools import average_ckpts, compare_runs, plot_losses
from pcgan_tpu_torch.tools import sweep
from pcgan_tpu_torch.train import create_train_state
from pcgan_tpu_torch.utils import checkpoint as ckpt
from tools import compare_runs as jax_compare
from tools import sweep as jax_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8",
         "--crop_size", "32", "--load_size", "36", "--n_age_bins", "4",
         "--dtype", "float32", "--norm", "batch"]


def _records(seed=0, n=12):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        r = {"step": (i + 1) * 10, "epoch": i // 4 + 1,
             "loss_G": float(rng.uniform(1, 5)),
             "loss_D": float(rng.uniform(0, 1)),
             "loss_G_L1": float(rng.uniform(0, 2))}
        if i % 4 == 3:
            r["eval_fid"] = float(rng.uniform(10, 100))
        rows.append(r)
    return rows


def _write_run(d, rows):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "metrics.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


@pytest.mark.parametrize("keys", ["", "loss_G,loss_D"])
def test_plot_losses_svg_equals_jax(tmp_path, keys):
    run = str(tmp_path / "run")
    rows = _records()
    _write_run(run, rows)
    out = plot_losses.main([run, "--out", str(tmp_path / "l.svg"),
                            "--keys", keys])
    want = jax_render(rows, keys=[k for k in keys.split(",") if k] or None,
                      title="run")
    with open(out) as f:
        assert f.read() == want


@pytest.mark.parametrize("x_key", ["step", "epoch"])
def test_compare_runs_svg_equals_jax(tmp_path, x_key):
    series = [("base", _records(1)), ("ada", _records(2))]
    assert compare_runs.comparison_svg(series, "loss_G_L1", x_key) == \
        jax_compare.comparison_svg(series, "loss_G_L1", x_key)
    a, b = str(tmp_path / "base"), str(tmp_path / "ada")
    _write_run(a, series[0][1])
    _write_run(b, series[1][1])
    out = compare_runs.main(["--runs", f"{a},{b}", "--key", "eval_fid",
                             "--x", x_key, "--out", str(tmp_path / "c.svg")])
    with open(out) as f:
        assert f.read() == jax_compare.comparison_svg(
            series, "eval_fid", x_key)
    with pytest.raises(SystemExit, match="at least two"):
        compare_runs.main(["--runs", a, "--key", "loss_G"])


def test_sweep_helpers_equal_jax(tmp_path):
    for spec in ("lr=1e-4,2e-4;--lambda_L1=50,100", "gan_mode=lsgan"):
        assert sweep.parse_grid(spec) == jax_sweep.parse_grid(spec)
    for bad in ("oops", "lr=", ""):
        with pytest.raises(ValueError):
            jax_sweep.parse_grid(bad)
        with pytest.raises(ValueError):
            sweep.parse_grid(bad)
    combo = [("lr", "1e-4"), ("x", "2")]
    assert sweep.combo_name("ab", combo) == jax_sweep.combo_name("ab", combo)
    _write_run(str(tmp_path), _records(3))
    assert sweep.last_metrics(str(tmp_path)) == \
        jax_sweep.last_metrics(str(tmp_path))
    assert sweep.last_metrics(str(tmp_path / "missing")) is None


def test_sweep_end_to_end(tmp_path):
    """Two combinations through the port's trainer, run as the CLI; the
    summary ranks both and the overlay SVG renders."""
    ck = str(tmp_path / "runs")
    p = subprocess.run(
        [sys.executable, "-m", "pcgan_tpu_torch.tools.sweep", "--grid",
         "lambda_L1=50,100", "--name", "ab", "--checkpoints_dir", ck,
         "--compare", "loss_G", "--", "--dataset_mode", "synthetic",
         "--max_dataset_size", "4", "--batch_size", "2", "--load_size", "36",
         "--crop_size", "32", "--netG", "resnet_6blocks", "--ngf", "8",
         "--ndf", "8", "--n_age_bins", "4", "--niter", "1", "--niter_decay",
         "0", "--print_freq", "1", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    with open(os.path.join(ck, "ab_sweep.json")) as f:
        summary = json.load(f)
    assert [r["returncode"] for r in summary["runs"]] == [0, 0]
    assert {r["name"] for r in summary["runs"]} == {
        "ab__lambda_L1=50", "ab__lambda_L1=100"}
    assert all(np.isfinite(r["metrics"]["loss_G"]) for r in summary["runs"])
    assert summary["best"] in {r["name"] for r in summary["runs"]}
    assert os.path.isfile(os.path.join(ck, "ab_compare_loss_G.svg"))


# --------------------------------------------------------------------------- #
# average_ckpts
# --------------------------------------------------------------------------- #


def _converted(seed, scale):
    """A JAX G's (batch norm) variables scaled by ``scale``, converted to
    the port's state dict; running stats drawn per seed."""
    cfg = jax_parse(SMALL, is_train=False)
    G = jax_define_G(cfg)
    v = init_params(G, jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)),
                    jnp.zeros((1, 4)), train=False)
    params = jax.tree.map(lambda x: x * scale, v["params"])
    stats = jax.tree.map(lambda x: x + seed, v["batch_stats"])
    return convert.convert_generator_params(
        params, state={"batch_stats": stats})


def _train_state(g_sd, ema_sd=None, ema=True):
    cfg = port_parse(SMALL + ["--device", "cpu", "--pool_size", "2",
                              "--ema_decay", "0.999" if ema else "0"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        G, D = define_G(cfg), define_D(cfg)
    G.load_state_dict(g_sd)
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(0))
    if ema_sd is not None:
        state.ema = {n: ema_sd[n].clone() for n in state.ema}
    return state


def _mean(sds):
    return {k: np.mean([sd[k].double().numpy() for sd in sds], axis=0)
            for k in sds[0]}


@pytest.mark.parametrize("layout", ["gonly", "full", "mixed", "ema"])
def test_average_ckpts_is_the_mean(tmp_path, layout):
    ck = str(tmp_path)
    sds = [_converted(s, f) for s, f in ((0, 1.0), (1, 3.0), (2, -0.5))]
    tags = ["epoch_1", "epoch_2", "epoch_3"]
    for i, (tag, sd) in enumerate(zip(tags, sds)):
        if layout == "ema":
            # the live G differs; the EMA twins are the averaged trees
            ckpt.save_state(_train_state(sds[0], ema_sd=sd), ck, "run", tag)
        elif layout == "full" or (layout == "mixed" and i % 2):
            ckpt.save_state(_train_state(sd), ck, "run", tag)
        else:
            ckpt.save_generator(sd, ck, "run", tag)
    extra = ["--use_ema"] if layout == "ema" else []
    path = average_ckpts.main(["--checkpoints_dir", ck, "--name", "run",
                               "--tags", ",".join(tags), "--out", "swa",
                               *extra])
    assert path == ckpt.generator_path(ck, "run", "swa")
    got = torch.load(path, weights_only=True)
    mean = _mean(sds)
    last = sds[0] if layout == "ema" else sds[-1]
    params = {n for n, _ in _train_state(sds[0]).G.named_parameters()}
    assert set(got) == set(sds[0])
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        if k in params:
            np.testing.assert_allclose(v.numpy(), mean[k], atol=1e-7, rtol=0,
                                       err_msg=k)
        else:      # running statistics: the last tag's
            assert torch.equal(v, last[k]), k


def test_average_ckpts_errors(tmp_path):
    ck = str(tmp_path)
    sd = _converted(0, 1.0)
    ckpt.save_generator(sd, ck, "run", "a")
    with pytest.raises(SystemExit, match="at least two"):
        average_ckpts.main(["--checkpoints_dir", ck, "--name", "run",
                            "--tags", "a"])
    other = {k: v for k, v in sd.items() if not k.startswith("tail")}
    ckpt.save_generator(other, ck, "run", "b")
    with pytest.raises(SystemExit, match="different G structure"):
        average_ckpts.main(["--checkpoints_dir", ck, "--name", "run",
                            "--tags", "a,b"])
    wide = dict(sd, **{"tail.weight": torch.zeros(3, 16, 7, 7)})
    ckpt.save_generator(wide, ck, "run", "c")
    with pytest.raises(SystemExit, match="different G structure"):
        average_ckpts.main(["--checkpoints_dir", ck, "--name", "run",
                            "--tags", "a,c"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        average_ckpts.main(["--checkpoints_dir", ck, "--name", "run",
                            "--tags", "a,missing"])
    ckpt.save_state(_train_state(sd, ema=False), ck, "run", "full")
    with pytest.raises(SystemExit, match="no EMA twin"):
        average_ckpts.main(["--checkpoints_dir", ck, "--name", "run",
                            "--tags", "full,full", "--use_ema"])


def test_buffer_rule_matches_the_nets():
    """``average_ckpts.is_param`` names exactly the parameters of every G
    variant (batch and group norm, attention, the U-Net)."""
    for extra in (["--norm", "batch"], ["--norm", "group", "--g_attn"],
                  ["--netG", "unet_32", "--norm", "batch"]):
        cfg = port_parse(SMALL + extra + ["--device", "cpu"],
                         is_train=False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            G = define_G(cfg)
        want = {n for n, _ in G.named_parameters()}
        assert {k for k, v in G.state_dict().items()
                if average_ckpts.is_param(k, v)} == want, extra
