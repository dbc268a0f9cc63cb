"""The port's fake-image pool against ``pcgan_tpu/utils/image_pool.py``.

JAX's ``query`` draws its slots and swap bits from a key; the test draws
the same numbers from the same key (``query`` splits it into a slot key
and a swap key) and feeds them to the port's ``query_with_draws``, over a
sequence of batches that crosses the warm-up boundary
(count < P < count + B) and then swaps. Pool contents, outputs and count
must be equal (the pool only moves values).
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.utils import image_pool as J

from pcgan_tpu_torch.utils import image_pool as T

IMG, NC = (4, 4, 3), 5


def _jax_draws(key, b, p):
    r_slot, r_swap = jax.random.split(key)
    return (np.asarray(jax.random.randint(r_slot, (b,), 0, p)),
            np.asarray(jax.random.bernoulli(r_swap, 0.5, (b,))))


@pytest.mark.parametrize("pool_size,bsz", [(6, 4), (5, 2), (3, 4)])
def test_query_with_draws_matches_jax(pool_size, bsz):
    rng = np.random.default_rng(pool_size)
    js = J.init_pool(pool_size, IMG, NC)
    ts = T.init_pool(pool_size, IMG, NC)
    crossed = swapped = False
    for i in range(8):
        fakes = rng.standard_normal((bsz, *IMG)).astype(np.float32)
        conds = np.eye(NC, dtype=np.float32)[rng.integers(0, NC, bsz)]
        key = jax.random.PRNGKey(100 + i)
        count = int(js.count)
        crossed |= count < pool_size < count + bsz
        js, jimg, jcond = J.query(js, jnp.asarray(fakes), jnp.asarray(conds),
                                  key)
        idx, swap = _jax_draws(key, bsz, pool_size)
        ts, timg, tcond = T.query_with_draws(
            ts, torch.from_numpy(fakes), torch.from_numpy(conds),
            torch.from_numpy(idx), torch.from_numpy(swap))
        swapped |= not np.array_equal(np.asarray(jimg), fakes)
        np.testing.assert_array_equal(timg.numpy(), np.asarray(jimg))
        np.testing.assert_array_equal(tcond.numpy(), np.asarray(jcond))
        np.testing.assert_array_equal(ts.imgs.numpy(), np.asarray(js.imgs))
        np.testing.assert_array_equal(ts.conds.numpy(), np.asarray(js.conds))
        assert int(ts.count) == int(js.count)
    assert swapped
    assert crossed or pool_size % bsz == 0


def test_warmup_boundary_never_returns_unwritten_slots():
    """At count 4 of P 6 with B 4, rows 0-1 fill slots 4-5 and rows 2-3
    may swap only with slots 0-3, never with the zero slots 4-5."""
    ts = T.init_pool(6, IMG, NC)
    ts, _, _ = T.query_with_draws(ts, torch.ones(4, *IMG), torch.ones(4, NC),
                                  torch.arange(4), torch.zeros(4, dtype=bool))
    fakes = torch.full((4, *IMG), 2.0)
    ts, out, _ = T.query_with_draws(ts, fakes, torch.ones(4, NC),
                                    torch.tensor([0, 1, 4, 5]),
                                    torch.ones(4, dtype=bool))
    assert int(ts.count) == 6
    # rows 2-3 drew slots 4-5 (unwritten before this batch): no swap
    assert torch.equal(out[2:], fakes[2:])
    assert torch.equal(out[:2], fakes[:2])      # warm rows return the fake


def test_disabled_pool_is_identity():
    for js, ts in ((J.init_pool(0, IMG, NC), T.init_pool(0, IMG, NC)),):
        assert int(ts.count) == int(js.count) == -1
        fakes = torch.randn(3, *IMG)
        conds = torch.eye(NC)[:3]
        ts2, out, oc = T.query(ts, fakes, conds, torch.Generator())
        assert torch.equal(out, fakes) and torch.equal(oc, conds)
        assert int(ts2.count) == -1 and torch.equal(ts2.imgs, ts.imgs)


def test_query_keeps_dtypes_and_device():
    ts = T.init_pool(4, IMG, NC)
    _, out, oc = T.query(ts, torch.randn(2, *IMG).bfloat16(),
                         torch.eye(NC)[:2].bfloat16(),
                         torch.Generator().manual_seed(0))
    assert out.dtype == oc.dtype == torch.bfloat16
    assert ts.imgs.dtype == torch.float32
