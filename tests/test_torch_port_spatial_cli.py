"""The training CLI and the tools under a ``spatial`` mesh axis.

- ``train_main`` on two gloo ranks at ``--mesh_shape 1,2 --mesh_axes
  data,spatial`` (pool and EMA on) and on four at ``--mesh_shape 2,2``
  (data x spatial by the positional axis default) with
  ``--device_cache_sharded`` (a spatial line's ranks gather the same
  rows), each in one cohort
  (``torch_port_parallel_worker.train_runs``): a run cut right after a
  mid-epoch 'latest' save and resumed with ``--continue_train`` logs the
  uninterrupted run's losses bit for bit; the checkpoint (the one-device
  state, the pool's bands gathered) loads into a one-device run; over
  the first epoch (4 steps) the 1 x 2 run's losses, parameters and pool
  equal the one-device CLI run's on the same data (on one thread, as the
  ranks run) within 1e-5. (Later steps may cross a ReLU kink, where f32
  summation order picks the slope: by step 8 a loss may move by 1e-4.)
- The model levers (attention, the multiscale D, the U-Net, the resize
  conv, group norm, dropout, ``--remat``) pass under a spatial axis and
  ``doctor`` prints their band plan; all of them at once (the resnet G)
  and the U-Net with dropout and remat each take two CLI steps at 1 x 2.
  So do the loss and data levers (R1, the gradient penalty, feature
  matching, VGG, DiffAugment, ADA), each alone, with and without a
  spatial axis; R1, feature matching, VGG, DiffAugment and ADA at once,
  and the gradient penalty with the multiscale D, attention and group
  norm, each take two CLI steps at 1 x 2.
- ``tools.doctor`` over a world of two prints the band plan of
  ``--mesh_shape 1,2 --mesh_axes data,spatial``, with R1 on too.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import json
import math
import os

import pytest
import torch

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch import train_main
from pcgan_tpu_torch.models import define_D, define_G
from pcgan_tpu_torch.tools import doctor
from pcgan_tpu_torch.train import create_train_state, reject_unported_train
from pcgan_tpu_torch.utils.checkpoint import (adam_state, restore_state,
                                              state_path)

from torch_port_parallel_worker import finish_cohort, start_cohort

CLI = ["--dataset_mode", "synthetic", "--max_dataset_size", "16",
       "--batch_size", "4", "--load_size", "36", "--crop_size", "32",
       "--netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8",
       "--n_age_bins", "4", "--niter_decay", "0", "--print_freq", "1",
       "--cond_inject", "bottleneck", "--pool_size", "4", "--ema_decay",
       "0.999", "--device", "cpu", "--num_threads", "1", "--niter", "2",
       "--save_epoch_freq", "0", "--dtype", "float32"]
MESHES = {2: ["--mesh_shape", "1,2", "--mesh_axes", "data,spatial"],
          4: ["--mesh_shape", "2,2", "--device_cache_sharded"]}
# the model levers, ported to bands
LEVERS = [["--g_attn"], ["--d_attn"], ["--netD", "multiscale"],
          ["--netG", "unet_32"], ["--netG", "resnet_6blocks@resize_conv"],
          ["--norm", "group"], ["--no-no_dropout"], ["--remat"]]
# every lever at once through the CLI, two steps at 1 x 2
LEVER_RUNS = {
    "levers_resnet": ["--netG", "resnet_6blocks@resize_conv", "--g_attn",
                      "--d_attn", "--netD", "multiscale", "--n_layers_D", "2",
                      "--norm", "group", "--no-no_dropout", "--remat",
                      "--remat_blocks", "2"],
    "levers_unet": ["--netG", "unet_32", "--no-no_dropout", "--remat"],
    "levers_losses": ["--lambda_r1", "10", "--lambda_feat", "10",
                      "--lambda_vgg", "10", "--vgg_path", "random",
                      "--diff_augment", "color,translation,cutout",
                      "--ada_target", "0.6"],
    "levers_wgangp": ["--gan_mode", "wgangp", "--netD", "multiscale",
                      "--n_layers_D", "2", "--d_attn", "--norm", "group",
                      "--lambda_feat", "10", "--diff_augment",
                      "translation"]}
# the loss and data levers, ported to bands
LOSS_LEVERS = [["--lambda_r1", "1"], ["--gan_mode", "wgangp"],
        ["--lambda_feat", "10"], ["--lambda_vgg", "10"],
        ["--diff_augment", "color"],
        ["--diff_augment", "color", "--ada_target", "0.6"]]


def _losses(path):
    with open(path) as f:
        return [{k: v for k, v in r.items() if k.startswith("loss")}
                for r in map(json.loads, f) if "loss_G" in r]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("spatial_cli")

    def argv(world, name, *extra):
        return (CLI + MESHES[world] + ["--name", name, "--checkpoints_dir",
                                       str(work), *extra])
    handles = {}
    for world in MESHES:
        cut = argv(world, f"cut{world}", "--save_latest_freq", "3")
        handles[world] = start_cohort({"resume": {
            "kind": "train_runs", "runs": [
                (argv(world, f"straight{world}"), None), (cut, 6),
                (cut + ["--continue_train"], None)] + (
                [(argv(world, "epoch2", "--niter", "1"), None)]
                + [(argv(world, name, "--niter", "1", "--max_dataset_size",
                         "8", *flags), None)
                   for name, flags in LEVER_RUNS.items()]
                if world == 2 else [])}}, work, world=world, tag=str(world))
    # the first epoch on one device, meanwhile
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_main.main(CLI + ["--name", "one", "--checkpoints_dir",
                               str(work), "--niter", "1"])
    finally:
        torch.set_num_threads(threads)
    ranks = {w: finish_cohort(h, timeout=240) for w, h in handles.items()}
    return work, ranks


@pytest.mark.parametrize("world", sorted(MESHES))
def test_resume_is_exact_and_loads_on_one_device(runs, world):
    work, ranks = runs
    assert [r["resume"][:3] for r in ranks[world]] == [[8, "cut", 8]] * world
    if world == 2:      # the lever runs: two steps each
        assert [r["resume"][4:] for r in ranks[world]] == [
            [2] * len(LEVER_RUNS)] * world
        for name in LEVER_RUNS:
            got = _losses(os.path.join(work, name, "metrics.jsonl"))
            assert len(got) == 2 and all(
                math.isfinite(v) for row in got for v in row.values())
    a, b = (_losses(os.path.join(work, f"{n}{world}", "metrics.jsonl"))
            for n in ("straight", "cut"))
    assert len(a) == 8 and a == b
    cfg = tcfg.parse_config(CLI)
    G, D = define_G(cfg), define_D(cfg)
    state = create_train_state(cfg, G, D, torch.Generator().manual_seed(0))
    restore_state(state, str(work), f"straight{world}", "latest")
    assert state.step == 8 and adam_state(state.opt_g, G)["count"] == 8
    assert state.pool.imgs.shape == (4, 32, 32, 3)


def test_spatial_cli_equals_the_one_device_run(runs):
    work, _ = runs
    want = _losses(os.path.join(work, "one", "metrics.jsonl"))
    got = _losses(os.path.join(work, "epoch2", "metrics.jsonl"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k, v in w.items():
            assert abs(g[k] - v) <= 1e-5 * max(1.0, abs(v)), (k, g[k], v)
    one, two = (torch.load(state_path(str(work), n, "latest"),
                           weights_only=True) for n in ("one", "epoch2"))
    assert int(one["pool"]["count"]) == int(two["pool"]["count"]) == 4
    assert torch.equal(one["pool"]["conds"], two["pool"]["conds"])
    assert float((one["pool"]["imgs"] - two["pool"]["imgs"]).abs().max()
                 ) <= 1e-5
    for net in ("G", "D"):
        for k, v in one[net].items():
            assert float((two[net][k] - v).abs().max()) <= 1e-5, (net, k)


@pytest.mark.parametrize("flags", LEVERS,
                         ids=lambda f: "_".join(f).strip("-"))
def test_ported_levers_pass_under_a_spatial_axis(flags, monkeypatch):
    """A model lever runs under a spatial axis, and ``doctor`` prints its
    band plan with the lever's layers (read off a forward of the models:
    ``--n_layers_D 2``, as at 32 px a 3-layer multiscale D's second scale
    has an empty patch map, which the model refuses)."""
    argv = flags + ["--mesh_shape", "1,2", "--mesh_axes", "data,spatial",
                    "--crop_size", "32", "--n_layers_D", "2"]
    cfg = tcfg.parse_config(argv)
    reject_unported_train(cfg)
    monkeypatch.setenv("WORLD_SIZE", "2")
    rep = doctor.main(["--device", "cpu", *argv])
    assert rep["mesh"] == {"data": 1, "spatial": 2}
    plan = rep["band_plan"]
    want = {"--g_attn": "G attn pooled keys", "--d_attn": "D attn pooled keys",
            "multiscale": "D_1 pool 2x2", "unet_32": "G levels.0.down 4x4 s2",
            "resnet_6blocks@resize_conv": "G up.1 resize 2x"}
    for flag, key in want.items():
        if flag in flags:
            assert key in plan, (key, plan)
    first = "G levels.4.down 4x4 s2" if "unet_32" in flags else "G stem 7x7"
    assert plan[first].startswith("32: 16+16 halo")


@pytest.mark.parametrize("flags", LOSS_LEVERS,
                         ids=lambda f: "_".join(f).strip("-"))
def test_loss_levers_pass_under_a_spatial_axis(flags, monkeypatch):
    """A loss or data lever passes the config check under a spatial axis
    (and without one), and ``doctor`` prints the band plan of its run."""
    argv = flags + ["--mesh_shape", "1,2", "--mesh_axes", "data,spatial",
                    "--crop_size", "32"]
    reject_unported_train(tcfg.parse_config(argv))
    reject_unported_train(tcfg.parse_config(flags))     # no spatial axis
    reject_unported_train(tcfg.parse_config(
        flags + ["--mesh_shape", "1,2", "--mesh_axes", "data,model"]))
    monkeypatch.setenv("WORLD_SIZE", "2")
    rep = doctor.main(["--device", "cpu", *argv])
    assert rep["mesh"] == {"data": 1, "spatial": 2}
    assert rep["band_plan"]["G stem 7x7"] == "32: 16+16 halo 3/3"
    assert rep["band_plan"]["D logits"] == "2: 1+1"


def test_the_band_path_flags_pass():
    reject_unported_train(tcfg.parse_config(
        ["--mesh_shape", "2,2", "--norm", "batch", "--grad_accum", "2",
         "--ema_decay", "0.999", "--comparator_path", "x", "--netD",
         "pixel", "--zero1", "--dtype", "bfloat16", "--lowch_matmul"]))
    reject_unported_train(tcfg.parse_config(
        ["--mesh_shape", "1,2", "--mesh_axes", "data,spatial",
         "--lambda_r1", "1", "--lambda_feat", "10", "--lambda_vgg", "10",
         "--diff_augment", "color", "--ada_target", "0.6"]))


def test_doctor_prints_the_band_plan(monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", "2")
    rep = doctor.main(["--device", "cpu", "--crop_size", "32",
                       "--mesh_shape", "1,2", "--mesh_axes",
                       "data,spatial"])
    assert rep["mesh"] == {"data": 1, "spatial": 2}
    plan = rep["band_plan"]
    assert plan["G stem 7x7"] == "32: 16+16 halo 3/3"
    assert plan["D logits"] == "2: 1+1"
    assert "band_plan" in capsys.readouterr().out
    rep = doctor.main(["--device", "cpu", "--crop_size", "32",
                       "--mesh_shape", "1,2", "--mesh_axes", "data,spatial",
                       "--lambda_r1", "1"])
    assert rep["mesh"] == {"data": 1, "spatial": 2}
    assert rep["band_plan"] == plan
