"""The port's training loader against ``pcgan_tpu/data/loader.py``'s
``Loader`` on the same synthetic dataset: the same batches, row for row,
over two shuffled epochs, after ``skip_next`` (exact mid-epoch resume) and
unshuffled without ``drop_last``, with the same age bins attached."""

import threading

import numpy as np
import pytest

from pcgan_tpu.data import loader as J
from pcgan_tpu.data.synthetic import SyntheticAgingDataset as JDS

from pcgan_tpu_torch.data import loader as T
from pcgan_tpu_torch.data.synthetic import SyntheticAgingDataset as TDS


def _pair(size=10, native=16, seed=3):
    return (JDS(size=size, native=native, seed=seed),
            TDS(size=size, native=native, seed=seed))


def _same(jit, tit, n_bins=4):
    jb = list(J.with_bins(jit, n_bins))
    tb = list(T.with_bins(tit, n_bins))
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    return tb


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_two_epochs_match_jax(shuffle, drop_last):
    jds, tds = _pair()
    jl = J.Loader(jds, 3, shuffle=shuffle, seed=7, drop_last=drop_last,
                  num_threads=2)
    tl = T.Loader(tds, 3, shuffle=shuffle, seed=7, drop_last=drop_last,
                  num_threads=2)
    assert len(jl) == len(tl) == (3 if drop_last else 4)
    first = _same(iter(jl), iter(tl))
    second = _same(iter(jl), iter(tl))
    assert jl.epoch == tl.epoch == 2
    if shuffle:       # a new permutation each epoch
        assert not all(np.array_equal(a["age"], b["age"])
                       for a, b in zip(first, second))


def test_skip_next_and_epoch_cursor_match_jax():
    jds, tds = _pair()
    jl = J.Loader(jds, 2, seed=1, num_threads=1)
    tl = T.Loader(tds, 2, seed=1, num_threads=1)
    jl.epoch = tl.epoch = 3
    jl.skip_next = tl.skip_next = 2
    got = _same(iter(jl), iter(tl))
    assert len(got) == len(tl) - 2
    assert tl.skip_next == 0
    # the skipped epoch's tail is the uninterrupted epoch's tail
    full = T.Loader(tds, 2, seed=1, num_threads=1)
    full.epoch = 3
    tail = list(T.with_bins(iter(full), 4))[2:]
    for a, b in zip(got, tail):
        np.testing.assert_array_equal(a["image"], b["image"])


def test_prefetch_yields_in_order_and_reraises():
    assert list(T.prefetch(iter(range(5)), 2)) == list(range(5))
    assert list(T.prefetch(iter(range(3)), 0)) == [0, 1, 2]

    def broken():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(T.prefetch(broken(), 2))


def test_prefetch_stops_its_producer_when_the_consumer_stops():
    """A training loop that raises or breaks off leaves no producer thread
    and no loader worker pool behind."""
    before = set(threading.enumerate())
    tl = T.Loader(_pair(size=40)[1], 2, seed=1, num_threads=2)
    it = T.prefetch(T.with_bins(iter(tl), 4), 2)
    assert next(it)["image"].shape[0] == 2
    it.close()
    left = [t for t in threading.enumerate() if t not in before]
    assert left == [], left
