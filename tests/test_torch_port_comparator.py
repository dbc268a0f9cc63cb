"""The port's comparator (``pcgan_tpu_torch/models/comparator.py``) against
``pcgan_tpu.models.comparator`` on converted weights, the likelihood and
loss functions, the score anchors and the score helpers.

Small sizes: cmp_nf 8, 2-3 downsamplings, 32 px, 4 bins, f32 (JAX at
``Precision.HIGHEST``). Tolerances: the forward within 1e-5 abs + 1e-5 rel
(f32 convs summed in another order); the closed-form functions within
1e-6 abs + 1e-6 rel (f32 erf/log/exp of two libraries); the anchors within
1e-6 rel. bf16 forward: both frameworks round every conv's output to bf16
(8 mantissa bits, 4e-3 relative) and sum in another order, so mu and
log_var agree within 1e-2 of their largest f32 magnitude and 5e-2 of their
f32 spread over the batch (measured: 2e-3-4e-3 and 1e-2-2e-2).
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu import config as jcfg
from pcgan_tpu.data import binning as jbin
from pcgan_tpu.models import comparator as jcmp
from pcgan_tpu.models.registry import define_C as j_define_C
from pcgan_tpu.models.registry import init_params
from pcgan_tpu.train import compute_bin_anchors as j_bin_anchors
from pcgan_tpu.train import compute_quantile_anchors as j_quantile_anchors

from pcgan_tpu_torch import config as tcfg
from pcgan_tpu_torch.convert import (convert_comparator_bundle,
                                     convert_comparator_params,
                                     flatten_params)
from pcgan_tpu_torch.data import binning as tbin
from pcgan_tpu_torch.models import comparator as tcmp
from pcgan_tpu_torch.models import define_C
from pcgan_tpu_torch.train import compute_bin_anchors, compute_quantile_anchors
from pcgan_tpu_torch.utils.checkpoint import load_comparator_bundle

NB, S, NF = 4, 32, 8


def _cfg(mod, n_down=3, norm="instance", dtype="float32", **train):
    return mod.Config(
        data=mod.DataConfig(n_age_bins=NB, crop_size=S, load_size=S),
        model=mod.ModelConfig(cmp_nf=NF, cmp_n_down=n_down, norm=norm,
                              dtype=dtype),
        train=mod.TrainConfig(**train))


def _images(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, S, S, 3)).astype(np.float32)


def _pair(n_down=3, norm="instance", dtype="float32", seed=1):
    """(JAX C, its variables, the port's C on them). Biases are made
    non-zero so their mapping is checked, and the Dense kernels 20x their
    init so mu and log_var are O(1) rather than O(1e-2)."""
    jc = _cfg(jcfg, n_down, norm, dtype)
    jC = j_define_C(jc)
    variables = init_params(jC, jax.random.PRNGKey(seed),
                            jnp.zeros((1, S, S, 3)))
    params = {k: {n: (a + 0.01 if a.ndim == 1 else
                      a * 20.0 if k.startswith("Dense") else a)
                  for n, a in v.items()}
              for k, v in variables["params"].items()}
    C = define_C(_cfg(tcfg, n_down, norm, dtype))
    C.load_state_dict(convert_comparator_params(params), strict=True)
    return jC, {"params": params}, C


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("n_down,norm", [(2, "instance"), (3, "instance"),
                                         (3, "none")])
def test_forward_matches_jax(n_down, norm):
    jC, jv, C = _pair(n_down, norm)
    x = _images()
    with jax.default_matmul_precision("highest"):
        mu_j, lv_j = jC.apply(jv, jnp.asarray(x), train=False)
        feat_j = jC.apply(jv, jnp.asarray(x), train=False,
                          return_features=True)
    with torch.no_grad():
        mu, lv = C(torch.from_numpy(x))
        feat = C(torch.from_numpy(x), return_features=True)
    assert mu.dtype == lv.dtype == feat.dtype == torch.float32
    assert mu.shape == (6,) and feat.shape == (6, 4 * NF)
    for got, want in ((mu, mu_j), (lv, lv_j), (feat, feat_j)):
        _close(got.numpy(), want, 1e-5, 1e-5)
    # only the first conv carries a bias under instance norm
    assert [c.bias is not None for c in C.convs] == (
        [True] + [norm == "none"] * (n_down - 1))


def test_bf16_forward_matches_jax_bf16():
    jC, jv, C = _pair(dtype="bfloat16")
    _, _, C32 = _pair()
    x = _images(8, seed=3)
    mu_j, lv_j = jC.apply(jv, jnp.asarray(x), train=False)
    with torch.no_grad():
        mu, lv = C(torch.from_numpy(x))
        mu32, lv32 = C32(torch.from_numpy(x))
    assert mu.dtype == torch.float32 and C.convs[1].weight.dtype == torch.float32
    for got, want, ref in ((mu, mu_j, mu32), (lv, lv_j, lv32)):
        spread = float(ref.max() - ref.min())
        err = float(np.abs(got.numpy() - np.asarray(want)).max())
        assert err <= 1e-2 * float(ref.abs().max()), (err, ref)
        assert err <= 5e-2 * spread, (err, spread)


def test_log_var_is_clipped():
    _, _, C = _pair()
    with torch.no_grad():
        C.head.bias.copy_(torch.tensor([0.0, 50.0]))
        assert float(C(torch.from_numpy(_images(2)))[1].min()) == 10.0
        C.head.bias.copy_(torch.tensor([0.0, -50.0]))
        assert float(C(torch.from_numpy(_images(2)))[1].max()) == -10.0


def _likelihood_inputs(seed=5):
    """12 pairs of moderate gaps (every outcome probability >= ~0.05) and 4
    at the extremes: log_var at the +-10 clip, gaps of 40 sigma (the eps
    clamps on p and on p_tie), a tie of equal scores."""
    rng = np.random.default_rng(seed)
    mu_i = np.concatenate([rng.normal(0, 0.3, 12), [0.0, 30.0, -30.0, 5.0]])
    mu_j = np.concatenate([rng.normal(0, 0.3, 12), [0.0, -10.0, 10.0, 5.0]])
    lv_i = np.concatenate([rng.uniform(-0.5, 1.5, 12), [-10, -10, 10, 0]])
    lv_j = np.concatenate([rng.uniform(-0.5, 1.5, 12), [-10, -10, -10, 0]])
    label = rng.integers(0, 3, 16)
    return [a.astype(np.float32) for a in (mu_i, lv_i, mu_j, lv_j)], label


@pytest.mark.parametrize("margin", [0.5, 0.0])
def test_likelihood_functions_match_jax(margin):
    arrays, label = _likelihood_inputs()
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    jl, tl = jnp.asarray(label), torch.from_numpy(label)
    want = jcmp.pairwise_log_probs(*j, margin=margin)
    got = tcmp.pairwise_log_probs(*t, margin=margin)
    _close(got.numpy(), want, 1e-6, 1e-6)
    # the eps clamps were reached
    assert float(got.min()) == pytest.approx(np.log(np.float32(1e-6)))
    _close(tcmp.comparison_loss(*t, tl, margin).numpy(),
           jcmp.comparison_loss(*j, jl, margin), 1e-6, 1e-6)
    assert float(tcmp.comparison_accuracy(*t, tl, margin)) == float(
        jcmp.comparison_accuracy(*j, jl, margin))
    lo = np.array([-1e30, -0.5, 0.1, 0.3] * 4, np.float32)
    hi = np.array([-0.5, 0.1, 0.3, 1e30] * 4, np.float32)
    _close(tcmp.condition_consistency_loss(
               t[0], t[1], torch.from_numpy(lo), torch.from_numpy(hi)).numpy(),
           jcmp.condition_consistency_loss(j[0], j[1], jnp.asarray(lo),
                                           jnp.asarray(hi)), 1e-6, 1e-6)
    # score mode: the interval is one point
    _close(tcmp.condition_consistency_loss(t[0], t[1], t[2], t[2]).numpy(),
           jcmp.condition_consistency_loss(j[0], j[1], j[2], j[2]), 1e-6, 1e-6)


def test_tail_probabilities_match_jax():
    """Gaps of 3-6 sigma: Phi is 0.5 * (1 + erf) in f32 in both packages,
    and XLA's and torch's f32 erf differ by up to 3e-7 (measured over
    [-6, 6] on the CPU), so a tail probability of 1e-5 carries a relative
    error near 1e-2 in either. The probabilities themselves agree within
    2e-7 abs; clamped outcomes agree exactly."""
    rng = np.random.default_rng(6)
    mu_i = rng.uniform(3, 6, 64).astype(np.float32) * rng.choice([-1, 1], 64)
    zero = np.zeros(64, np.float32)
    for margin in (0.5, 2.0):
        want = np.exp(np.asarray(jcmp.pairwise_log_probs(
            jnp.asarray(mu_i), jnp.asarray(zero), jnp.asarray(zero),
            jnp.asarray(zero - 0.7), margin=margin)))
        got = np.exp(tcmp.pairwise_log_probs(
            torch.from_numpy(mu_i), torch.from_numpy(zero),
            torch.from_numpy(zero), torch.from_numpy(zero - 0.7),
            margin=margin).numpy())
        _close(got, want, 2e-7, 0)


def test_accuracy_ties_take_the_first_outcome():
    # equal scores and variances, margin 0: P(i>j) == P(j>i) == 0.5 and the
    # tie clamps to eps, so argmax must pick outcome 0 in both frameworks
    z = np.zeros(3, np.float32)
    label = np.array([0, 1, 2])
    got = tcmp.comparison_accuracy(*[torch.from_numpy(z)] * 4,
                                   torch.from_numpy(label), 0.0)
    want = jcmp.comparison_accuracy(*[jnp.asarray(z)] * 4,
                                    jnp.asarray(label), 0.0)
    assert float(got) == float(want) == pytest.approx(1 / 3)


def test_condition_loss_gradient_matches_jax():
    arrays, _ = _likelihood_inputs()
    lo = np.full(16, -0.2, np.float32)
    hi = np.full(16, 0.4, np.float32)
    gj = jax.grad(lambda m, v: jcmp.condition_consistency_loss(
        m, v, jnp.asarray(lo), jnp.asarray(hi)), argnums=(0, 1))(
        jnp.asarray(arrays[0]), jnp.asarray(arrays[1]))
    m = torch.from_numpy(arrays[0]).requires_grad_()
    v = torch.from_numpy(arrays[1]).requires_grad_()
    loss = tcmp.condition_consistency_loss(m, v, torch.from_numpy(lo),
                                           torch.from_numpy(hi))
    gt = torch.autograd.grad(loss, (m, v))
    for a, b in zip(gt, gj):
        _close(a.numpy(), b, 1e-6, 1e-6)


@pytest.mark.parametrize("bins", [[0, 0, 2, 3, 3, 2, 0, 3],     # bin 1 empty
                                  [3, 3, 3, 3, 3, 3, 3, 3]])    # edges extend
def test_bin_anchors_match_jax(bins):
    jC, jv, C = _pair()
    x = _images(8, seed=7)
    with jax.default_matmul_precision("highest"):
        want = j_bin_anchors(jC, jv, jnp.asarray(x), jnp.asarray(bins), NB)
    got = compute_bin_anchors(C, torch.from_numpy(x), np.asarray(bins), NB)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (NB,)
        _close(g.numpy(), w, 0, 1e-6)
    lo, hi, means = (g.numpy() for g in got)
    assert lo[0] == -1e30 and hi[-1] == 1e30
    np.testing.assert_array_equal(lo[1:], hi[:-1])
    assert np.all(np.diff(means) >= 0)


def test_quantile_anchors_match_jax():
    jC, jv, C = _pair()
    x = _images(10, seed=8)
    with jax.default_matmul_precision("highest"):
        want = j_quantile_anchors(jC, jv, jnp.asarray(x), NB)
    got = compute_quantile_anchors(C, torch.from_numpy(x), NB)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 0, 1e-6)
    with pytest.raises(ValueError, match="no anchor images"):
        compute_bin_anchors(C, torch.from_numpy(x[:0]), np.zeros(0), NB)


def test_score_helpers_match_jax():
    b = np.array([0, 1, 2, 3, 9])
    _close(tbin.bin_to_score(torch.from_numpy(b), 10).numpy(),
           jbin.bin_to_score(jnp.asarray(b), 10), 0, 0)
    sweep = tbin.score_sweep(7)
    assert sweep.shape == (7, 1) and sweep.dtype == torch.float32
    # linspace in f32: the two libraries round an entry differently
    _close(sweep.numpy(), jbin.score_sweep(7), 2e-7, 0)
    assert tbin.score_sweep(3, torch.bfloat16).dtype == torch.bfloat16
    mu = np.array([-3.0, -0.2, 0.0, 0.31, 2.5], np.float32)
    for lo, hi in ((-0.4, 0.6), (0.2, 0.2), (1.0, -1.0)):
        smin, smax = torch.tensor(lo), torch.tensor(hi)
        jmin, jmax = jnp.float32(lo), jnp.float32(hi)
        _close(tbin.normalize_score(torch.from_numpy(mu), smin, smax).numpy(),
               jbin.normalize_score(jnp.asarray(mu), jmin, jmax), 1e-6, 1e-6)
        s = np.linspace(-1, 1, 5).astype(np.float32)
        _close(tbin.denormalize_score(torch.from_numpy(s), smin,
                                      smax).numpy(),
               jbin.denormalize_score(jnp.asarray(s), jmin, jmax), 1e-6, 1e-6)


def test_convert_consumes_every_tensor():
    _, jv, _ = _pair()
    flat = flatten_params(jv)
    sd = convert_comparator_params(flat)
    assert len(sd) == len(flat) == 3 + 1 + 4    # kernels, conv-0 bias, Dense
    with pytest.raises(ValueError, match="no place"):
        convert_comparator_params({**flat, "Extra_0/kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="not a Comparator"):
        convert_comparator_params({k: v for k, v in flat.items()
                                   if not k.startswith("Dense_1")})


@pytest.mark.parametrize("with_means", [True, False])
def test_converted_bundle_loads(tmp_path, with_means):
    jC, jv, _ = _pair()
    lo, hi, means = (np.asarray(a) for a in j_bin_anchors(
        jC, jv, jnp.asarray(_images(8)), jnp.asarray([0, 1, 2, 3] * 2), NB))
    payload = {"c_vars": jv, "bin_lo": lo, "bin_hi": hi}
    if with_means:
        payload["bin_means"] = means
    bundle = convert_comparator_bundle(payload)
    assert {k: bundle[k] for k in ("cmp_nf", "cmp_n_down", "norm")} == {
        "cmp_nf": NF, "cmp_n_down": 3, "norm": "instance"}
    path = tmp_path / "comparator.pt"
    torch.save(bundle, path)
    cfg = _cfg(tcfg, comparator_path=str(tmp_path))
    C, blo, bhi, bmeans = load_comparator_bundle(cfg)
    np.testing.assert_array_equal(blo.numpy(), lo)
    np.testing.assert_array_equal(bhi.numpy(), hi)
    assert (bmeans is None) != with_means
    x = _images(3, seed=9)
    with jax.default_matmul_precision("highest"):
        want = jC.apply(jv, jnp.asarray(x), train=False)[0]
    with torch.no_grad():
        _close(C(torch.from_numpy(x))[0].numpy(), want, 1e-5, 1e-5)
    with pytest.raises(ValueError, match="--cmp_n_down"):
        load_comparator_bundle(_cfg(tcfg, n_down=2,
                                    comparator_path=str(path)))
