"""The port's pair datasets against ``pcgan_tpu``'s: for a seed, the same
pairs, labels and images (``--dataset_mode pairwise|pairwise_hard`` over the
synthetic set), and the same held-out split of comparator pretraining."""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest

from pcgan_tpu import config as jcfg
from pcgan_tpu.data import loader as jloader
from pcgan_tpu.data.pairwise import Subset as JSubset

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch.data import loader as tloader
from pcgan_tpu_torch.data.pairwise import held_out_split


def _cfg(mod, mode, n, seed, dataroot="./no_such_folder"):
    return mod.Config(
        data=mod.DataConfig(dataset_mode=mode, max_dataset_size=n,
                            dataroot=dataroot),
        train=mod.TrainConfig(seed=seed))


@pytest.mark.parametrize("mode", ["pairwise", "pairwise_hard"])
@pytest.mark.parametrize("seed", [0, 3])
def test_pairs_and_labels_match_jax(mode, seed):
    jds = jloader.create_dataset(_cfg(jcfg, mode, 30, seed))
    tds = tloader.create_dataset(_cfg(tcfg, mode, 30, seed))
    assert len(tds) == len(jds) == 30
    assert tds.base.variant == jds.base.variant
    np.testing.assert_array_equal(tds._idx, jds._idx)
    labels = [int(tds.get_raw(i)["label"]) for i in range(30)]
    assert labels == [int(jds.get_raw(i)["label"]) for i in range(30)]
    assert set(labels) <= {0, 1, 2}
    for i in (0, 7):
        t, j = tds.get_raw(i), jds.get_raw(i)
        for k in ("image_a", "image_b"):
            np.testing.assert_array_equal(t[k], j[k])
        ages = tds.base.ages[tds._idx[i]]
        gap = int(ages[0]) - int(ages[1])
        assert int(t["label"]) == (2 if abs(gap) <= 3 else 0 if gap > 0
                                   else 1)


@pytest.mark.parametrize("n,frac,seed", [(12, 0.5, 0), (20, 0.1, 0),
                                         (57, 0.25, 4), (160, 0.1, 0)])
def test_held_out_split_matches_jax(n, frac, seed):
    ds = tloader.create_dataset(_cfg(tcfg, "pairwise", n, seed))
    train, held = held_out_split(ds, frac, seed)
    # the JAX split, root train.py:687-691
    n_eval = int(n * frac) if n >= 20 else 0
    perm = np.random.default_rng(seed + 0x0e7a1).permutation(n)
    if not n_eval:
        assert held is None and train is ds
        return
    jheld, jtrain = JSubset(ds, perm[:n_eval]), JSubset(ds, perm[n_eval:])
    assert (len(held), len(train)) == (len(jheld), len(jtrain)) == (
        n_eval, n - n_eval)
    np.testing.assert_array_equal(held.indices, jheld.indices)
    np.testing.assert_array_equal(train.indices, jtrain.indices)
    assert int(held.get_raw(0)["label"]) == int(jheld.get_raw(0)["label"])


def test_jpeg_folder_and_csv_modes_raise(tmp_path):
    """Pairs over an existing --dataroot read its folder (an empty one has
    no labeled images), and the CSV mode needs --comparisons_csv, as in
    the JAX package (the modes themselves: test_torch_port_folder_data.py)."""
    for mod in (tcfg, jcfg):
        loader = tloader if mod is tcfg else jloader
        with pytest.raises(FileNotFoundError, match="no labeled images"):
            loader.create_dataset(_cfg(mod, "pairwise", 8, 0, str(tmp_path)))
        with pytest.raises(FileNotFoundError, match="comparisons_csv"):
            loader.create_dataset(_cfg(mod, "comparisons", 8, 0))
