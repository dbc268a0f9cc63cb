"""pcgan_tpu_torch int8 PTQ (``ops/quant.py``, ``--quant_int8``) == the JAX
package's (CPU).

- ``int8_conv`` (and the transposed conv's zero-inserted lowering) equals
  JAX's ``int8_conv`` EXACTLY: integer sums are exact, and the quantize /
  dequantize steps are the same f32 operations. On inputs already on the
  int8 grid it also equals the f32 conv exactly.
- ``quantize_weight`` / ``quantize_act`` are bit-equal, .5 ties included
  (both round half to even).
- Calibrated absmaxes equal JAX's ``calibrate_quant`` within 1e-6
  relative (f32), except where a rounding flip (below) sits upstream of a
  site. The int8 G against JAX's on converted weights and scales, f32
  compute: the two f32 G's differ by ~4e-7 (instance-norm summation
  order), and an activation within that noise of a rounding boundary
  rounds the other way in one framework, which moves every later element
  a little (the calibration passes quantize dynamically, so their later
  absmaxes move too). Measured over seeds 0-11 (jitted JAX, the cases
  below): calibration within 1e-6 at every site in 12 of 12 seeds
  (bottleneck injection) and 10 of 12 (input), worst 8.3e-3 relative; the
  G within 1e-5 in 8 of 12 seeds with dynamic scales and 10 of 12 with
  static ones, worst max |diff| 3.9e-2 and mean 6.5e-3. Held to: at least
  8 of 12 seeds within 1e-6 (calibration) and 7 of 12 within 1e-5 (G),
  and per seed calibration within 2e-2 relative and the G within max
  0.05, mean 0.01.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcgan_tpu.config import parse_config as jax_parse
from pcgan_tpu.models.registry import define_G as jax_define_G
from pcgan_tpu.models.registry import init_params
from pcgan_tpu.ops import quant as jq
from pcgan_tpu_torch import convert
from pcgan_tpu_torch.config import parse_config as port_parse
from pcgan_tpu_torch.models import define_G as port_define_G
from pcgan_tpu_torch.ops import quant as tq

SMALL = ["--netG", "resnet_6blocks", "--crop_size", "32", "--load_size",
         "36", "--ngf", "8", "--n_age_bins", "4", "--dtype", "float32",
         "--quant_int8"]
DIMS = ("NHWC", "HWIO", "NHWC")

# (Cin, Cout, k, stride, pad, pad mode, lhs dilation): the G trunk's
# geometry at small widths, a 1x1 K that is not a multiple of 8 (the
# bottleneck projection: 32 + 4 bins), and the deconv's lowering
CONV_CASES = {
    "s1_zero": (8, 16, 3, 1, 1, "zero", 1),
    "s2_zero": (8, 16, 3, 2, 1, "zero", 1),
    "s1_reflect": (16, 16, 3, 1, 1, "reflect", 1),
    "k1_cin36": (36, 32, 1, 1, 0, "zero", 1),
    "k3_cin5": (5, 8, 3, 1, 1, "zero", 1),
    "deconv": (16, 8, 3, 1, 1, "zero", 2),
}


def _jax_conv_args(case):
    cin, cout, k, s, p, mode, dil = case
    if dil > 1:       # ConvTranspose2d(k, s=dil, p, op=1) as JAX lowers it
        lo, hi = k - 1 - p, k - 1 - p + 1
        return (1, 1), ((lo, hi), (lo, hi)), (dil, dil)
    if mode == "reflect":
        return (s, s), ((0, 0), (0, 0)), None
    return (s, s), ((p, p), (p, p)), None


def _operands(case, rng, on_grid):
    cin, cout, k, s, p, mode, dil = case
    if on_grid:
        x = (rng.integers(-127, 128, (2, 9, 9, cin)) * 0.25).astype(
            np.float32)
        x[0, 0, 0, 0] = 127 * 0.25
        w = (rng.integers(-127, 128, (k, k, cin, cout)) * 0.5).astype(
            np.float32)
        w[0, 0, 0, :] = 127 * 0.5
    else:
        x = rng.normal(size=(2, 9, 9, cin)).astype(np.float32)
        w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    if mode == "reflect":
        x = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)), mode="reflect")
    return x, w


def _port_int8_conv(case, x, w):
    """The port's int8 conv on the JAX operands (NHWC, HWIO)."""
    cin, cout, k, s, p, mode, dil = case
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if dil > 1:
        # the torch ConvTranspose2d weight of the JAX HWIO kernel
        wt = tq.deconv_as_conv_weight(torch.from_numpy(w).permute(2, 3, 0, 1))
        lo, hi = k - 1 - p, k - 1 - p + 1
        y = tq.int8_conv(xt, wt, 1, ((lo, hi), (lo, hi)), lhs_dilation=dil,
                         out_dtype=torch.float32)
    else:
        stride, pads, _ = _jax_conv_args(case)
        y = tq.int8_conv(xt, torch.from_numpy(w).permute(3, 2, 0, 1),
                         stride[0], pads, out_dtype=torch.float32)
    return y.permute(0, 2, 3, 1).numpy()


def _jax_int8_conv(case, x, w):
    stride, pads, dil = _jax_conv_args(case)
    wj = jnp.asarray(w)
    if dil is not None:
        wj = jnp.flip(wj, axis=(0, 1))
    return np.asarray(jq.int8_conv(jnp.asarray(x), wj, stride, pads,
                                   lhs_dilation=dil, out_dtype=jnp.float32))


@pytest.mark.parametrize("on_grid", [True, False], ids=["grid", "random"])
@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_int8_conv_equals_jax(name, on_grid):
    case = CONV_CASES[name]
    rng = np.random.default_rng(sorted(CONV_CASES).index(name))
    x, w = _operands(case, rng, on_grid)
    got = _port_int8_conv(case, x, w)
    want = _jax_int8_conv(case, x, w)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if on_grid:
        # lossless quantization: the int8 conv IS the f32 conv
        stride, pads, dil = _jax_conv_args(case)
        wj = jnp.asarray(w)
        if dil is not None:
            wj = jnp.flip(wj, axis=(0, 1))
        ref = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), wj, stride, pads, lhs_dilation=dil,
            dimension_numbers=DIMS, precision=jax.lax.Precision.HIGHEST))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_int8_accumulators_are_the_integer_product():
    """The s32 accumulators equal an int64 reference conv of the int8
    operands (what the card must reproduce bit for bit)."""
    rng = np.random.default_rng(3)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 36, 6, 6)).astype(
        np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (16, 36, 3, 3)).astype(
        np.int8))
    acc, (n, ho, wo) = tq.int8_conv_accum(xq, tq.weight_matrix(wq), (3, 3),
                                          2, ((1, 1), (1, 1)))
    assert acc.dtype == torch.int32 and tq.weight_matrix(wq).shape[1] % 8 == 0
    ref = torch.nn.functional.conv2d(xq.double(), wq.double(), stride=2,
                                     padding=1)
    got = acc.reshape(n, ho, wo, -1).permute(0, 3, 1, 2).double()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("what", ["weight", "act"])
def test_quantize_bit_equal_with_ties(what):
    """Values whose scaled form lands on exact .5 ties round half to even in
    both frameworks (jnp.round, torch.round)."""
    rng = np.random.default_rng(4)
    if what == "weight":
        w = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
        # absmax 127 per channel -> scale 1: entries k + 0.5 are exact ties
        w[0, 0, 0, :] = 127.0
        w[1, 1, 1, :] = np.float32(2.5)
        w[1, 1, 2, :] = np.float32(-3.5)
        w[2, 2, 3, :] = np.float32(0.5)
        qj, sj = jq.quantize_weight(jnp.asarray(w))
        qt, st = tq.quantize_weight(torch.from_numpy(w).permute(3, 2, 0, 1))
        np.testing.assert_array_equal(qt.permute(2, 3, 1, 0).numpy(),
                                      np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        assert int(qt[0, 1, 1, 1]) == 2 and int(qt[0, 2, 1, 1]) == -4
        assert int(qt[0, 3, 2, 2]) == 0
    else:
        x = rng.normal(size=(2, 8, 5, 5)).astype(np.float32)
        x.flat[0] = 127.0
        x.flat[1], x.flat[2], x.flat[3] = 6.5, -0.5, 125.5
        qj, sj = jq.quantize_act(jnp.asarray(x))
        qt, st = tq.quantize_act(torch.from_numpy(x))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert float(st) == float(sj)
        assert [int(v) for v in qt.flatten()[1:4]] == [6, 0, 126]
    assert torch.equal(torch.round(torch.tensor([0.5, 1.5, 2.5, -2.5])),
                       torch.tensor([0.0, 2.0, 2.0, -2.0]))


@functools.lru_cache(maxsize=None)
def _jax_g(argv):
    """(JAX G, jitted init(key), apply(v, x, c), calibrate(v, x, c) ->
    its quant collection) for one flag list, traced once per test module."""
    jG = jax_define_G(jax_parse(list(argv), is_train=False))
    init = jax.jit(lambda k: jG.init({"params": k, "dropout": k},
                                     jnp.zeros((1, 32, 32, 3)),
                                     jnp.zeros((1, 4)), train=False))
    apply = jax.jit(lambda v, x, c: jG.apply(v, x, c, train=False))
    calib = jax.jit(lambda v, x, c: jG.apply(
        v, x, c, train=False, mutable=["quant"])[1]["quant"])
    return jG, init, apply, calib


def _pair(inject, seed, argv=SMALL):
    """(jitted JAX apply and calibrate, JAX variables, the port's G with
    the converted weights)."""
    argv = tuple(argv) + ("--cond_inject", inject)
    _, init, apply, calib = _jax_g(argv)
    jvars = init(jax.random.PRNGKey(seed))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pG = port_define_G(port_parse(list(argv), is_train=False))
    pG.load_state_dict(convert.convert_generator_params(jvars["params"]))
    return (apply, calib), jvars, pG.eval()


def _inputs(seed, n=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, c


def _port(pG, x, c):
    with torch.no_grad():
        return pG(torch.from_numpy(x), torch.from_numpy(c)).numpy()


@pytest.mark.parametrize("inject", ["bottleneck", "input"])
def test_calibrated_absmaxes_match_jax(inject):
    """Seeds 0-11, one calibration batch of 4 each. The module docstring
    states the measured spread and what it is held to."""
    exact, worst = 0, 0.0
    for seed in range(12):
        (_, calib), jvars, pG = _pair(inject, seed)
        x, c = _inputs(50 + seed, n=4)
        want = convert.convert_generator_quant(
            calib(jvars, jnp.asarray(x), jnp.asarray(c)))
        tq.calibrate_quant(pG, [(torch.from_numpy(x), torch.from_numpy(c))])
        got = tq.act_absmaxes(pG)
        assert set(got) == set(want) and len(got) == 2 + 12 + 2 + (
            inject == "bottleneck")
        rel = max(abs(float(got[k]) - float(want[k])) / float(want[k])
                  for k in want)
        worst = max(worst, rel)
        exact += int(rel <= 1e-6)
        if seed == 0:
            # and back: the port's absmaxes as a JAX quant collection
            flat_p = convert.flatten_params(
                convert.generator_quant_to_flax(got, 6, 2, inject))
            assert set(flat_p) == {f"{p}/act_absmax" for p, _ in
                                   convert._quant_order(flat_p)}
            back = convert.convert_generator_quant(flat_p)
            assert all(float(back[k]) == float(got[k]) for k in got)
    assert exact >= 8 and worst <= 2e-2, (exact, worst)


def test_int8_generator_matches_jax_over_seeds():
    """Dynamic and static (JAX-calibrated, converted) scales over seeds
    0-11; the tolerance is the module docstring's."""
    close = {"dynamic": 0, "static": 0}
    for seed in range(12):
        (apply, calib), jvars, pG = _pair("bottleneck", seed)
        x, c = _inputs(seed)
        for mode in ("dynamic", "static"):
            if mode == "static":
                xc, cc = _inputs(100 + seed)
                quant = calib(jvars, jnp.asarray(xc), jnp.asarray(cc))
                jvars = {**jvars, "quant": quant}
                tq.set_act_absmaxes(pG, convert.convert_generator_quant(quant))
            want = np.asarray(apply(jvars, jnp.asarray(x), jnp.asarray(c)))
            d = np.abs(_port(pG, x, c) - want)
            assert d.max() <= 0.05 and d.mean() <= 0.01, (seed, mode,
                                                          d.max(), d.mean())
            close[mode] += int(d.max() <= 1e-5)
    assert close["dynamic"] >= 7 and close["static"] >= 7, close


def test_static_scales_equal_dynamic_on_the_calibration_batch():
    """Calibrating on batch X then running static inference on X equals the
    dynamic output EXACTLY (the JAX package's tests/test_quant.py:95)."""
    _, _, pG = _pair("bottleneck", 4)
    x, c = _inputs(4)
    assert all(v is None for v in tq.act_absmaxes(pG).values())
    y_dyn = _port(pG, x, c)
    tq.calibrate_quant(pG, [(torch.from_numpy(x), torch.from_numpy(c))])
    a1 = {k: float(v) for k, v in tq.act_absmaxes(pG).items()}
    np.testing.assert_array_equal(_port(pG, x, c), y_dyn)
    # a running max: a larger-amplitude batch raises the absmaxes
    tq.calibrate_quant(pG, [(torch.from_numpy(x * 1.5), torch.from_numpy(c))])
    a2 = tq.act_absmaxes(pG)
    assert all(float(a2[k]) >= a1[k] for k in a1)
    assert any(float(a2[k]) > a1[k] for k in a1)


def test_frozen_weights_and_checkpoints():
    """A quant G has the plain G's state_dict (checkpoints load either
    way); weights quantized once (``freeze_quant_weights``, what an export
    stores) give the same bits as quantizing on every call."""
    _, _, pG = _pair("bottleneck", 5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        plain = port_define_G(port_parse(
            [a for a in SMALL if a != "--quant_int8"]
            + ["--cond_inject", "bottleneck"], is_train=False))
    assert list(plain.state_dict()) == list(pG.state_dict())
    plain.load_state_dict(pG.state_dict())
    x, c = _inputs(5)
    y = _port(pG, x, c)
    d = np.abs(_port(plain.eval(), x, c) - y)
    assert 0 < d.max() < 0.2            # quantization noise, not the same path
    tq.freeze_quant_weights(pG)
    assert all(m.w_q is not None and m.w_q.dtype == torch.int8
               for _, m in tq.quant_sites(pG))
    np.testing.assert_array_equal(_port(pG, x, c), y)


def test_bf16_int8_generator_close_to_jax():
    """bf16 compute, dynamic scales: the G's bf16 rounding differs between
    the frameworks, so outputs agree at quantization-noise level (the
    export CLI's --verify limits for int8)."""
    argv = [a if a != "float32" else "bfloat16" for a in SMALL]
    (apply, _), jvars, pG = _pair("bottleneck", 6, argv)
    x, c = _inputs(6)
    want = np.asarray(apply(jvars, jnp.asarray(x), jnp.asarray(c)),
                      np.float32)
    d = np.abs(_port(pG, x, c) - want)
    assert d.max() < 0.3 and d.mean() < 0.03, (d.max(), d.mean())


def test_training_cli_rejects_quant(tmp_path):
    from pcgan_tpu_torch import train_main
    with pytest.raises(SystemExit, match="inference-only"):
        train_main.main(["--quant_int8", "--dataset_mode", "synthetic",
                         "--checkpoints_dir", str(tmp_path),
                         "--device", "cpu"])


def test_convert_rejects_foreign_quant_entries():
    with pytest.raises(ValueError, match="no site"):
        convert.convert_generator_quant(
            {"TorchConv_1": {"act_absmax": np.float32(1)},
             "TorchConvTranspose_0": {"act_absmax": np.float32(1)},
             "Bogus_0": {"act_absmax": np.float32(1)}})
