"""``--device_cache`` in the port (``pcgan_tpu_torch/data/device_cache.py``),
one device: the replicated cases of ``tests/test_device_cache.py``. The
lever changes where the rows live, never what the model sees: the sample
stream, and so every metric stream, is bit-identical to the streaming host
``Loader``'s. Here the device is the CPU (the card's path is the same code
with a CUDA device). The sharded layout across ranks is
``tests/test_torch_port_parallel_data.py``'s; here it runs in one process.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import json
import os

import numpy as np
import pytest
import torch

from pcgan_tpu_torch.config import parse_config
from pcgan_tpu_torch.data import loader as data_loader
from pcgan_tpu_torch.data.device_cache import DeviceCacheLoader
from pcgan_tpu_torch.data.loader import with_bins

from torch_port_levers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _cfg(extra=()):
    return parse_config([
        "--dataset_mode", "synthetic", "--max_dataset_size", "40",
        "--batch_size", "8", "--crop_size", "32", "--load_size", "36",
        "--dtype", "float32", *extra], is_train=True)


def _ds(cfg):
    return data_loader.create_dataset(cfg, train=True)


def _host(cfg, ds, **kw):
    return data_loader.Loader(ds, cfg.data.batch_size,
                              num_threads=cfg.data.num_threads, **kw)


def _equal(hb, db):
    assert set(hb) == set(db)
    for k in hb:
        assert isinstance(db[k], torch.Tensor) and db[k].device == CPU
        assert np.array_equal(hb[k], db[k].numpy()), k


def test_stream_parity_with_host_loader():
    """Two epochs of batches, values and order, equal the host path's."""
    cfg = _cfg()
    ds = _ds(cfg)
    ld = _host(cfg, ds, shuffle=True, seed=3)
    dc = DeviceCacheLoader(cfg, ds, CPU, shuffle=True, seed=3)
    assert len(ld) == len(dc) == 5
    for _ in range(2):
        host = list(with_bins(iter(ld), cfg.data.n_age_bins,
                              cfg.data.max_age))
        dev = list(iter(dc))
        assert len(host) == len(dev)
        for hb, db in zip(host, dev):
            _equal(hb, db)
            assert db["image"].dtype == torch.uint8


def test_stream_equals_the_jax_cache():
    """The port's cached batches equal the JAX package's replicated
    ``DeviceCacheLoader``'s over one epoch (same seeding, same rows)."""
    import jax
    from pcgan_tpu.config import parse_config as jax_parse
    from pcgan_tpu.data import loader as jloader
    from pcgan_tpu.data.device_cache import DeviceCacheLoader as JCache
    from pcgan_tpu.parallel import make_mesh
    argv = ["--dataset_mode", "synthetic", "--max_dataset_size", "24",
            "--batch_size", "8", "--crop_size", "32", "--load_size", "36"]
    jc, tc = jax_parse(argv, is_train=True), parse_config(argv,
                                                          is_train=True)
    mesh = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    want = list(JCache(jc, jloader.create_dataset(jc, train=True), mesh,
                       seed=5))
    got = list(DeviceCacheLoader(tc, _ds(tc), CPU, seed=5))
    assert len(want) == len(got) == 3
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            assert np.array_equal(np.asarray(w[k]), g[k].numpy()), k


def test_skip_next_index_level_resume():
    cfg = _cfg()
    ds = _ds(cfg)
    ld = _host(cfg, ds, shuffle=True, seed=3)
    dc = DeviceCacheLoader(cfg, ds, CPU, shuffle=True, seed=3)
    ld.epoch = dc.epoch = 4
    ld.skip_next = dc.skip_next = 2
    host = list(with_bins(iter(ld), cfg.data.n_age_bins, cfg.data.max_age))
    dev = list(iter(dc))
    assert len(host) == len(dev) == len(ld) - 2
    for hb, db in zip(host, dev):
        _equal(hb, db)
    # the skip is one-shot
    assert dc.skip_next == 0 and len(list(iter(dc))) == len(dc)


def test_rejects_dataset_smaller_than_batch():
    cfg = _cfg(["--max_dataset_size", "4"])
    with pytest.raises(SystemExit, match="rows < batch_size"):
        DeviceCacheLoader(cfg, _ds(cfg), CPU)


def test_max_bytes_cap_rejects_oversized_dataset():
    cfg = _cfg()
    with pytest.raises(SystemExit, match="GiB cap"):
        DeviceCacheLoader(cfg, _ds(cfg), CPU, max_bytes=1024)


def test_eval_iter_matches_host_eval_loader():
    """``eval_iter`` is the host eval loader's order (no shuffle,
    drop_last) and leaves the training cursors alone."""
    cfg = _cfg()
    ds = _ds(cfg)
    dc = DeviceCacheLoader(cfg, ds, CPU, shuffle=True, seed=3)
    host = list(with_bins(iter(_host(cfg, ds, shuffle=False)),
                          cfg.data.n_age_bins, cfg.data.max_age))
    dev = list(dc.eval_iter())
    assert len(host) == len(dev) == 5
    for hb, db in zip(host, dev):
        _equal(hb, db)
    assert dc.epoch == 0 and dc.skip_next == 0


def test_evaluator_accepts_cache_batches():
    """The streaming FID evaluator fed the cache's device batches returns
    the FID of the host batches."""
    from pcgan_tpu_torch.eval_lib import make_fid_evaluator
    from pcgan_tpu_torch.models import define_G
    cfg = _cfg(["--netG", "resnet_6blocks", "--ngf", "8", "--cond_inject",
                "bottleneck"])
    ds = _ds(cfg)
    dc = DeviceCacheLoader(cfg, ds, CPU, shuffle=False)
    G = define_G(cfg)
    run = make_fid_evaluator(cfg, None, CPU)
    host = run(G, with_bins(iter(_host(cfg, ds, shuffle=False)),
                            cfg.data.n_age_bins, cfg.data.max_age),
               max_images=32, seed=1)
    dev = run(G, dc.eval_iter(), max_images=32, seed=1)
    assert host["fid"] == dev["fid"], (host, dev)


def _losses(path, keys=("loss",)):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k.startswith(keys)} for line in f]


GAN = ["--dataset_mode", "synthetic", "--max_dataset_size", "40",
       "--batch_size", "8", "--crop_size", "32", "--load_size", "36",
       "--netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8",
       "--n_age_bins", "4", "--niter_decay", "0", "--print_freq", "2",
       "--display_freq", "3", "--save_latest_freq", "0", "--pool_size", "8",
       "--dtype", "float32", "--device", "cpu"]


def test_cli_metric_stream_identical(tmp_path):
    """``train_main --device_cache`` writes the host path's metrics.jsonl
    loss stream, display grids included, with the in-training eval reading
    the cache and the held-out rows from the host."""
    from pcgan_tpu_torch import train_main
    extra = ["--niter", "2", "--save_epoch_freq", "0", "--holdout_frac",
             "0.2", "--eval_fid_epoch_freq", "2", "--eval_fid_images", "16"]
    for name, flag in (("host", []), ("cached", ["--device_cache"])):
        train_main.main(GAN + extra + ["--name", name, "--checkpoints_dir",
                                       str(tmp_path)] + flag)
    a = _losses(os.path.join(tmp_path, "host", "metrics.jsonl"),
                ("loss", "eval"))
    b = _losses(os.path.join(tmp_path, "cached", "metrics.jsonl"),
                ("loss", "eval"))
    assert a and a == b
    assert any("eval_fid" in r for r in a) and any("eval_h_fid" in r
                                                   for r in a)
    assert os.listdir(os.path.join(tmp_path, "cached", "web", "images"))


def test_cli_resume_with_device_cache(tmp_path):
    """``--continue_train`` under ``--device_cache``: the resumed run's
    loss stream equals the uninterrupted run's."""
    from pcgan_tpu_torch import train_main
    common = GAN + ["--device_cache", "--checkpoints_dir", str(tmp_path)]
    train_main.main(common + ["--name", "full", "--niter", "3",
                              "--save_epoch_freq", "0"])
    train_main.main(common + ["--name", "split", "--niter", "2",
                              "--save_epoch_freq", "2"])
    train_main.main(common + ["--name", "split", "--niter", "3",
                              "--save_epoch_freq", "0", "--continue_train"])
    full = _losses(os.path.join(tmp_path, "full", "metrics.jsonl"))
    split = _losses(os.path.join(tmp_path, "split", "metrics.jsonl"))
    assert full and full == split


def test_comparator_pretraining_cached_identical(tmp_path):
    """Pair batches (image_a / image_b canvases, labels) cache as well:
    pretraining's metric stream, held-out accuracy included, is the host
    path's."""
    from pcgan_tpu_torch import train_main
    common = ["--model", "comparator", "--dataset_mode", "synthetic",
              "--max_dataset_size", "48", "--batch_size", "8",
              "--crop_size", "32", "--load_size", "36", "--cmp_nf", "8",
              "--cmp_n_down", "2", "--n_age_bins", "4", "--niter", "2",
              "--niter_decay", "0", "--print_freq", "2",
              "--save_epoch_freq", "0", "--dtype", "float32", "--device",
              "cpu", "--checkpoints_dir", str(tmp_path)]
    train_main.main(common + ["--name", "h"])
    train_main.main(common + ["--name", "c", "--device_cache"])
    a = _losses(os.path.join(tmp_path, "h", "metrics.jsonl"),
                ("loss", "acc", "eval"))
    b = _losses(os.path.join(tmp_path, "c", "metrics.jsonl"),
                ("loss", "acc", "eval"))
    assert a and a == b


def test_sharded_cache_raises_naming_a10(tmp_path):
    """``--device_cache_sharded`` is ported (A10): in one process it holds
    every row and trains the replicated cache's loss stream; a replicated
    cache over several ranks raises, and ``--zero1`` beside it exits in
    one process, as JAX's train.py (no data axis to shard over)."""
    from pcgan_tpu_torch import train_main
    from pcgan_tpu_torch.parallel.mesh import DataMesh
    from pcgan_tpu_torch.train import reject_unported_train
    reject_unported_train(parse_config(["--device_cache_sharded"]))
    reject_unported_train(parse_config(["--device_cache"]))
    reject_unported_train(parse_config(["--device_cache_sharded",
                                        "--zero1"]))
    with pytest.raises(SystemExit, match="data axis > 1"):
        train_main.main(GAN + ["--device_cache_sharded", "--zero1",
                               "--niter", "1", "--name", "z1",
                               "--checkpoints_dir", str(tmp_path)])
    for name, flag in (("repl", "--device_cache"),
                       ("shard", "--device_cache_sharded")):
        train_main.main(GAN + [flag, "--niter", "1", "--name", name,
                               "--checkpoints_dir", str(tmp_path)])
    a, b = (_losses(os.path.join(tmp_path, n, "metrics.jsonl"))
            for n in ("repl", "shard"))
    assert a and a == b
    cfg = _cfg()
    with pytest.raises(SystemExit, match="--device_cache_sharded"):
        DeviceCacheLoader(cfg, _ds(cfg), CPU, mesh=DataMesh(world=2))
