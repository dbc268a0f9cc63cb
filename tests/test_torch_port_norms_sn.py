"""The port's stateful layers against flax on the same numpy inputs: batch
norm (outputs and running stats after 3 train forwards, then eval), group
norm, spectral norm (u and sigma after k train forwards, an eval forward
that iterates without storing) and SAGAN self-attention with and without
spectral norm. f32 tolerances: 1e-5 on outputs, 1e-6 on stored state."""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from pcgan_tpu.models import layers as jl
from pcgan_tpu.models.generator import SelfAttention as JSelfAttention

from pcgan_tpu_torch.convert import conv_weight_from_flax, flatten_params
from pcgan_tpu_torch.models import layers as tl
from pcgan_tpu_torch.models.generator import SelfAttention

from torch_port_levers import one_torch_thread  # noqa: F401


def _x(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 2 + 0.5
            ).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


class _JNorm(fnn.Module):
    kind: str

    @fnn.compact
    def __call__(self, x, train):
        return jl.Norm(self.kind)(x, train)


def test_batch_norm_running_stats_match_flax():
    c = 16
    jm = _JNorm("batch")
    xs = [_x((4, 6, 6, c), s) for s in range(4)]
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), True)
    params, stats = v["params"], v["batch_stats"]
    bn = tl.Norm("batch", c)
    flat = flatten_params(params)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(
            np.asarray(flat["Norm_0/BatchNorm_0/scale"])))
        bn.bias.copy_(torch.from_numpy(
            np.asarray(flat["Norm_0/BatchNorm_0/bias"])))
    for x in xs[:3]:
        want, upd = jm.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x), True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        got = bn(_nchw(x))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)
    s = flatten_params(stats)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               s["Norm_0/BatchNorm_0/mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               s["Norm_0/BatchNorm_0/var"], atol=1e-6)
    # eval reads the running stats and writes nothing
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(xs[3]), False)
    before = bn.running_mean.clone()
    got = bn.eval()(_nchw(xs[3]))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)
    assert torch.equal(bn.running_mean, before)
    # a frozen train forward normalizes by the batch and stores nothing
    bn.train()
    with tl.frozen_stats(bn):
        bn(_nchw(xs[3]))
    assert torch.equal(bn.running_mean, before)


@pytest.mark.parametrize("c", [8, 64])
def test_group_norm_matches_flax(c):
    jm = _JNorm("group")
    x = _x((2, 5, 5, c), 9)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), True)
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), v["params"])
    gn = tl.Norm("group", c)
    flat = flatten_params(params)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(np.asarray(
            flat["Norm_0/GroupNorm_0/scale"])))
        gn.bias.copy_(torch.from_numpy(np.asarray(
            flat["Norm_0/GroupNorm_0/bias"])))
    want = jm.apply({"params": params}, jnp.asarray(x), True)
    np.testing.assert_allclose(_nhwc(gn(_nchw(x))), np.asarray(want),
                               atol=2e-5)
    assert gn.groups == min(32, c) and gn.eps == 1e-6


class _JSN(fnn.Module):
    @fnn.compact
    def __call__(self, x, train):
        return fnn.SpectralNorm(jl.TorchConv(8, 4, 2, 1, use_bias=True))(
            x, update_stats=train)


def _sn_conv_from_flax(variables):
    flat = flatten_params(variables["params"])
    st = flatten_params(variables["batch_stats"])
    conv = tl.TorchConv(3, 8, 4, 2, 1, use_bias=True, spectral_norm=True)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            conv_weight_from_flax(flat["TorchConv_0/kernel"])))
        conv.bias.copy_(torch.from_numpy(np.asarray(flat["TorchConv_0/bias"])))
        conv.sn.u.copy_(torch.from_numpy(np.asarray(
            st["SpectralNorm_0/TorchConv_0/kernel/u"])))
        conv.sn.sigma.copy_(torch.from_numpy(np.asarray(
            st["SpectralNorm_0/TorchConv_0/kernel/sigma"])))
    return conv


def test_spectral_norm_state_after_k_forwards():
    jm = _JSN()
    xs = [_x((2, 8, 8, 3), s) for s in range(5)]
    v = jm.init(jax.random.PRNGKey(4), jnp.asarray(xs[0]), True)
    conv = _sn_conv_from_flax(v)
    stats = v["batch_stats"]
    for k, x in enumerate(xs[:4]):
        want, upd = jm.apply({"params": v["params"], "batch_stats": stats},
                             jnp.asarray(x), True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        got = conv(_nchw(x))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)
        st = flatten_params(stats)
        np.testing.assert_allclose(
            conv.sn.u.numpy(), st["SpectralNorm_0/TorchConv_0/kernel/u"],
            atol=1e-6, err_msg=f"u after {k + 1} forwards")
        np.testing.assert_allclose(
            float(conv.sn.sigma),
            float(st["SpectralNorm_0/TorchConv_0/kernel/sigma"]), rtol=1e-6)
    # eval iterates once from the stored u but stores nothing
    want = jm.apply({"params": v["params"], "batch_stats": stats},
                    jnp.asarray(xs[4]), False)
    u0 = conv.sn.u.clone()
    got = conv.eval()(_nchw(xs[4]))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)
    assert torch.equal(conv.sn.u, u0)
    # train and eval forwards of the same input differ only by the stored
    # state: a train forward from u0 computes what eval did, then stores
    conv.train()
    np.testing.assert_allclose(_nhwc(conv(_nchw(xs[4]))), _nhwc(got),
                               atol=1e-6)
    assert not torch.equal(conv.sn.u, u0)


def test_spectral_norm_gradient_flows_through_sigma():
    """d/dW of sum(conv(x)) under SN: u and v are constants, sigma is not
    (flax's stop_gradient on u, v only)."""
    jm = _JSN()
    x = _x((2, 8, 8, 3), 11)
    v = jm.init(jax.random.PRNGKey(5), jnp.asarray(x), True)

    def f(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), True, mutable=["batch_stats"])
        return jnp.sum(out ** 2)
    gj = jax.grad(f)(v["params"])
    conv = _sn_conv_from_flax(v)
    (conv(_nchw(x)) ** 2).sum().backward()
    np.testing.assert_allclose(
        conv.weight.grad.numpy(),
        conv_weight_from_flax(np.asarray(gj["TorchConv_0"]["kernel"])),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sn", [False, True])
def test_self_attention_matches_jax(sn):
    dim = 32
    x = _x((2, 8, 8, dim), 7)
    jm = JSelfAttention(dim, spectral_norm=sn)
    v = jm.init(jax.random.PRNGKey(6), jnp.asarray(x), True)
    params = dict(v["params"])
    params["gamma"] = jnp.float32(0.7)        # away from the identity
    variables = {**v, "params": params}
    if sn:
        want, upd = jm.apply(variables, jnp.asarray(x), True,
                             mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(x), True)
    net = SelfAttention(dim, spectral_norm=sn)
    flat = flatten_params(params)
    st = flatten_params(v.get("batch_stats", {}))
    with torch.no_grad():
        for name in ("theta", "phi", "g", "o"):
            conv = getattr(net, name)
            conv.weight.copy_(torch.from_numpy(
                conv_weight_from_flax(flat[f"{name}/kernel"])))
            if sn:
                key = next(k for k in st if f"/{name}/kernel/u" in k)
                conv.sn.u.copy_(torch.from_numpy(np.asarray(st[key])))
        net.gamma.fill_(0.7)
    got = net(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)
    if sn:
        new = flatten_params(upd["batch_stats"])
        for name in ("theta", "phi", "g", "o"):
            key = next(k for k in new if f"/{name}/kernel/u" in k)
            np.testing.assert_allclose(getattr(net, name).sn.u.numpy(),
                                       np.asarray(new[key]), atol=1e-6)
    # gamma 0 is the identity
    with torch.no_grad():
        net.gamma.zero_()
    assert torch.equal(net(_nchw(x)), _nchw(x))
