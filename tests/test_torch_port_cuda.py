"""Kernels B1 (pcgan_tpu_torch/csrc/preprocess.cu) and B2
(pcgan_tpu_torch/csrc/wgrad.cu) against their plain PyTorch versions on a
CUDA card. A CUDA kernel has no CPU mode, so these tests skip
where no card is present. On the card (this file imports no jax, and
``--noconftest`` skips the JAX-side test config)::

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q -p no:cacheprovider

Tolerances: B1 f32 output 2e-5 (summation order only); bf16 output one
bf16 ulp of the plain value (magnitudes below 2^-7 count as 2^-7). B2:
1e-5 of the largest entry (exact products, f32 sums in another order), the
gate ``chip_smoke.py`` holds it to. The evaluator and the Inception
feature net in f32, card against CPU: 1e-4 of the largest entry. The int8
conv's s32 accumulators: equal to the CPU's; a CPU-exported f32 artifact
on the card: 1e-4 of the CPU's output.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch

from pcgan_tpu_torch.ops import cuda_preprocess as cp
from pcgan_tpu_torch.ops.preprocess import preprocess_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no "
                    "CPU mode")
    from pcgan_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def bf16_ulp(v):
    a = np.maximum(np.abs(np.asarray(v, np.float32)), 2.0 ** -7)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("b,native,load,crop", [
    (8, 200, 143, 128), (4, 50, 43, 32), (2, 32, 32, 32), (3, 30, 64, 48)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, b, native, load, crop, out_dtype):
    rng = np.random.default_rng(native)
    imgs = torch.from_numpy(rng.integers(0, 256, (b, native, native, 3),
                                         dtype=np.uint8)).to(cuda_device)
    cy, cx = (torch.from_numpy(rng.integers(0, load - crop + 1, b))
              .to(cuda_device) for _ in range(2))
    fl = torch.from_numpy(rng.integers(0, 2, b)).to(cuda_device)
    before = cp.launches
    got = cp.preprocess_batch_cuda(imgs, cy, cx, fl, load, crop,
                                   out_dtype=out_dtype)
    assert cp.launches == before + 1
    want = preprocess_batch(imgs, cy, cx, fl.bool(), load, crop,
                            out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.shape == (b, crop, crop, 3) and got.dtype == out_dtype
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    if out_dtype == torch.float32:
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)
    else:
        assert np.all(np.abs(g - w) <= bf16_ulp(w))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_flipped_upscale(cuda_device, out_dtype):
    """Every image flipped, at an upscale (30 -> 64 -> 48) whose band
    starts repeat: the horizontal pass reads the crop's columns backwards."""
    rng = np.random.default_rng(7)
    imgs = torch.from_numpy(rng.integers(0, 256, (3, 30, 30, 3),
                                         dtype=np.uint8)).to(cuda_device)
    cy = torch.tensor([0, 8, 16], device=cuda_device)
    cx = torch.tensor([16, 0, 5], device=cuda_device)
    fl = torch.ones(3, dtype=torch.int32, device=cuda_device)
    got = cp.preprocess_batch_cuda(imgs, cy, cx, fl, 64, 48,
                                   out_dtype=out_dtype)
    want = preprocess_batch(imgs, cy, cx, fl.bool(), 64, 48,
                            out_dtype=out_dtype)
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    if out_dtype == torch.float32:
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)
    else:
        assert np.all(np.abs(g - w) <= bf16_ulp(w))


def test_make_preprocess_runs_the_kernel_on_a_cuda_batch(cuda_device):
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    cfg = parse_config(["--load_size", "43", "--crop_size", "32",
                        "--dtype", "bfloat16"], is_train=False)
    imgs = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (4, 50, 50, 3), dtype=np.uint8))
    before = cp.launches
    got = make_preprocess(cfg, train=False)(
        None, {"image": imgs.to(cuda_device)})["image"]
    assert cp.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.bfloat16
    want = make_preprocess(cfg, train=False)(None, {"image": imgs})["image"]
    g, w = got.float().cpu().numpy(), want.float().numpy()
    assert np.all(np.abs(g - w) <= bf16_ulp(w))


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    z = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    f32 = torch.zeros((2, 8, 8, 3), device=cuda_device)
    with pytest.raises(ValueError, match="uint8"):
        cp.preprocess_batch_cuda(f32, z, z, z, 8, 8)
    u8 = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cp.preprocess_batch_cuda(u8.transpose(1, 2), z, z, z, 8, 8)
    with pytest.raises(ValueError, match="crop"):
        cp.preprocess_batch_cuda(u8, z, z, z, 8, 9)


# --------------------------------------------------------------------------- #
# kernel B2 (pcgan_tpu_torch/csrc/wgrad.cu)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("b,hp,wp,cin,cout,k", [
    (16, 134, 134, 64, 3, 7), (3, 37, 29, 24, 1, 3), (2, 40, 40, 16, 8, 7),
    (2, 9, 9, 300, 2, 7), (1, 12, 12, 5, 4, 1), (2, 19, 21, 300, 2, 7),
    (2, 12, 13, 5, 4, 1), (2, 20, 262, 64, 3, 7), (1, 15, 45, 40, 8, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_kernel_matches_plain(cuda_device, b, hp, wp, cin, cout, k,
                                    dtype):
    """Both sum the same f32 products (exact for bf16 inputs) in another
    order: within 1e-5 of the largest entry; two launches give the same
    bits (no atomics). bf16 takes the tensor-core route, f32 the f32-FMA
    route."""
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.standard_normal((b, hp, wp, cin)).astype(
        np.float32)).to(cuda_device, dtype)
    dy = torch.from_numpy(rng.standard_normal(
        (b, hp - k + 1, wp - k + 1, cout)).astype(np.float32)).to(
            cuda_device, dtype)
    before = cw.launches
    got = cw.wgrad_cuda(x, dy, k)
    assert cw.launches == before + 1
    assert cw.last_tensor_core == (dtype == torch.bfloat16)
    want = cw.wgrad_plain(x, dy, k)
    again = cw.wgrad_cuda(x, dy, k)
    torch.cuda.synchronize()
    assert got.shape == (k, k, cin, cout) and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert torch.equal(got, again)


def test_lowch_reflect_conv_dw_on_card_matches_cpu(cuda_device):
    """The routed tail conv's weight gradient: kernel B2 on the card, its
    plain version on the CPU, f32 (TF32 off)."""
    from pcgan_tpu_torch.ops import cuda_wgrad as cw
    from pcgan_tpu_torch.ops.lowch_conv import lowch_reflect_conv
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 16)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((7, 7, 16, 3)) * 0.1).astype(
        np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    grads = []
    for dev in (torch.device("cpu"), cuda_device):
        xd = x.to(dev).requires_grad_()
        wd = w.to(dev).requires_grad_()
        before = cw.launches
        y = lowch_reflect_conv(xd, wd, 3)
        grads.append([g.cpu() for g in torch.autograd.grad(y, (xd, wd),
                                                           dy.to(dev))])
        assert cw.launches == before + (dev.type == "cuda")
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4)


# --------------------------------------------------------------------------- #
# the comparator slice on the card (no hand kernel of its own: cuDNN convs)
# --------------------------------------------------------------------------- #


def _small_cfg(*extra):
    from pcgan_tpu_torch.config import parse_config
    return parse_config(["--netG", "resnet_6blocks", "--ngf", "8", "--ndf",
                         "8", "--crop_size", "32", "--load_size", "32",
                         "--batch_size", "2", "--n_age_bins", "4",
                         "--pool_size", "0", "--cond_inject", "bottleneck",
                         "--lr_policy", "constant", "--cmp_nf", "8",
                         "--cmp_n_down", "3", "--lambda_cond", "5", *extra])


def _seeded_comparator(cfg):
    """A seeded C with its Dense kernels 20x their init (O(1) scores)."""
    from pcgan_tpu_torch.models import define_C
    C = define_C(cfg, torch.Generator().manual_seed(3))
    with torch.no_grad():
        C.fc.weight.mul_(20.0)
        C.head.weight.mul_(20.0)
    return C


def test_comparator_bf16_on_card_matches_f32(cuda_device):
    """bf16 convs (8 mantissa bits) on the card against the f32 comparator
    on the CPU: within 1e-2 of the largest f32 score and 5e-2 of the
    batch's spread, the CPU tests' bf16 tolerance."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (8, 32, 32, 3)).astype(np.float32))
    C32 = _seeded_comparator(_small_cfg("--dtype", "float32"))
    C16 = _seeded_comparator(_small_cfg("--dtype", "bfloat16")).to(
        cuda_device)
    with torch.no_grad():
        want = C32(x)
        got = C16(x.to(cuda_device))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.device.type == "cuda"
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-2 * float(w.abs().max())
        assert err <= 5e-2 * float(w.max() - w.min())


@pytest.mark.parametrize("cond_mode", ["onehot", "score"])
def test_gan_step_with_comparator_on_card_matches_cpu(cuda_device,
                                                      cond_mode):
    """One f32 step with the cond loss, card against CPU from the same
    seeded nets and pinned targets: every loss within 1e-4, the cond loss
    non-zero, C bit-identical afterwards."""
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.train import create_train_state, make_train_step
    cfg = _small_cfg("--dtype", "float32", "--cond_mode", cond_mode)
    rng = np.random.default_rng(4)
    batch = {"image": torch.from_numpy(
                 rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)),
             "bin": torch.from_numpy(rng.integers(0, 4, 2)),
             "target_bin": torch.from_numpy(rng.integers(0, 4, 2)),
             "target_score": torch.tensor([-0.5, 0.75])}
    anchors = (torch.tensor([-1e30, -0.3, 0.0, 0.3]),
               torch.tensor([-0.3, 0.0, 0.3, 1e30]),
               torch.tensor([-0.5, -0.1, 0.1, 0.5]))
    runs = {}
    for dev in (torch.device("cpu"), cuda_device):
        C = _seeded_comparator(cfg)
        c0 = {k: v.clone() for k, v in C.state_dict().items()}
        state = create_train_state(
            cfg, define_G(cfg, torch.Generator().manual_seed(7)).to(dev),
            define_D(cfg, torch.Generator().manual_seed(8)).to(dev),
            torch.Generator().manual_seed(0), C=C, bin_anchors=anchors)
        m = make_train_step(cfg, state.G, state.D, state.C)(
            state, {k: v.to(dev) for k, v in batch.items()})
        runs[dev.type] = {k: float(v) for k, v in m.items()}
        assert all(torch.equal(v.cpu(), c0[k])
                   for k, v in state.C.state_dict().items())
    assert runs["cpu"]["loss_G_cond"] != 0.0
    for k, v in runs["cpu"].items():
        assert abs(runs["cuda"][k] - v) <= 1e-4, (k, v, runs["cuda"][k])


def test_evaluator_on_card_matches_cpu(cuda_device):
    """The streaming FID evaluator in f32 (B1 on the card, G, the random
    features, the moments) against the same pass on the CPU: the moments
    within 1e-4 of their largest entry, each batch through the kernel."""
    from pcgan_tpu_torch import config as tcfg
    from pcgan_tpu_torch import eval_lib
    from pcgan_tpu_torch.models import define_G
    from pcgan_tpu_torch.ops import fid as fid_ops
    cfg = tcfg.Config(
        data=tcfg.DataConfig(n_age_bins=4, crop_size=32, load_size=36,
                             batch_size=4),
        model=tcfg.ModelConfig(netG="resnet_6blocks", ngf=8, dtype="float32",
                               cond_inject="bottleneck"),
        run=tcfg.RunConfig(kid=True, kid_subsets=1, ssim=True))
    G = define_G(cfg, torch.Generator().manual_seed(3)).eval()
    rng = np.random.default_rng(0)
    batches = [{"image": rng.integers(0, 256, (4, 36, 36, 3), np.uint8),
                "bin": rng.integers(0, 4, 4)} for _ in range(4)]
    seen, real = [], fid_ops.fid_from_stats

    def spy(a, b):
        seen.append((a, b))
        return real(a, b)
    fid_ops.fid_from_stats = spy
    try:
        before = cp.launches
        card = eval_lib.make_fid_evaluator(cfg, None, cuda_device)(
            G.to(cuda_device), iter(batches), max_images=16)
        assert cp.launches == before + 4
        cpu = eval_lib.make_fid_evaluator(cfg, None, "cpu")(
            G.cpu(), iter(batches), max_images=16)
    finally:
        fid_ops.fid_from_stats = real
    for a, b in zip(seen[0], seen[1]):
        assert float(a.count) == float(b.count) == 16.0
        for k in ("s", "ss"):
            x, y = getattr(a, k).numpy(), getattr(b, k).numpy()
            np.testing.assert_allclose(x, y, rtol=0,
                                       atol=1e-4 * np.abs(y).max())
    assert set(card) == set(cpu) and np.isfinite(card["fid"])
    assert card["ssim"] == pytest.approx(cpu["ssim"], abs=1e-5)


def test_inception_on_card_matches_cpu(cuda_device, tmp_path):
    """The InceptionV3 feature net (a seeded torchvision-named .pth) in f32
    on the card against the CPU: within 1e-4 of the largest feature."""
    from pcgan_tpu_torch.models import inception as tinc
    rng = np.random.default_rng(0)
    sd = {}
    for prefix, mod in tinc.InceptionV3Features().named_modules():
        if isinstance(mod, tinc.BasicConv2d):
            co, ci, kh, kw = mod.conv.weight.shape
            sd[f"{prefix}.conv.weight"] = torch.from_numpy(rng.normal(
                0, np.sqrt(2.0 / (ci * kh * kw)), (co, ci, kh, kw)).astype(
                    np.float32))
            for k in ("weight", "running_var"):
                sd[f"{prefix}.bn.{k}"] = torch.ones(co)
            for k in ("bias", "running_mean"):
                sd[f"{prefix}.bn.{k}"] = torch.zeros(co)
    torch.save(sd, tmp_path / "inc.pth")
    x = torch.rand(2, 256, 256, 3, generator=torch.Generator()
                   .manual_seed(1)) * 2 - 1
    f_card, _ = tinc.make_inception_feature_fn(str(tmp_path / "inc.pth"),
                                               device=cuda_device)
    f_cpu, _ = tinc.make_inception_feature_fn(str(tmp_path / "inc.pth"))
    with torch.inference_mode():
        a = f_card(x.to(cuda_device)).cpu().numpy()
        b = f_cpu(x).numpy()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("ci,h,co,k,s,pads,dil", [
    (16, 32, 32, 3, 2, ((1, 1), (1, 1)), 1),
    (32, 10, 32, 3, 1, ((0, 0), (0, 0)), 1),
    (42, 8, 32, 1, 1, ((0, 0), (0, 0)), 1),
    (32, 8, 16, 3, 1, ((1, 2), (1, 2)), 2)])
def test_int8_accumulators_card_equal_cpu(cuda_device, ci, h, co, k, s, pads,
                                          dil):
    """The int8 conv's s32 accumulators (cuBLASLt on the card, ATen on the
    CPU) are the same integers: a stride-2 conv, a block conv, a 1x1 with
    K = 42 padded to 48, a zero-inserted deconv."""
    from pcgan_tpu_torch.ops import quant as tq
    rng = np.random.default_rng(ci)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, ci, h, h))
                          .astype(np.int8))
    wmat, _ = tq.quantize_conv_weight(torch.from_numpy(
        rng.normal(0, 0.02, (co, ci, k, k)).astype(np.float32)))
    a, _ = tq.int8_conv_accum(xq, wmat, (k, k), s, pads, dil)
    b, _ = tq.int8_conv_accum(xq.to(cuda_device), wmat.to(cuda_device),
                              (k, k), s, pads, dil)
    assert b.dtype == torch.int32 and torch.equal(a, b.cpu())


def test_cpu_exported_artifact_runs_on_card(cuda_device, tmp_path):
    """An artifact exported on the CPU loads onto the card: f32 within 1e-4
    of the CPU, batch 1 through the symbolic batch, and an int8 artifact
    equal to its live G on the card."""
    import warnings
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_G
    from pcgan_tpu_torch.ops.quant import calibrate_quant
    from pcgan_tpu_torch.serving import export_generator, load_exported
    small = ["--netG", "resnet_6blocks", "--crop_size", "32", "--load_size",
             "36", "--ngf", "8", "--n_age_bins", "4", "--cond_inject",
             "bottleneck"]
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[[0, 2, 3]]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        cfg = parse_config(small + ["--dtype", "float32"], is_train=False)
        export_generator(cfg, define_G(cfg).eval(), str(tmp_path / "f32"))
        qcfg = parse_config(small + ["--dtype", "bfloat16", "--quant_int8"],
                            is_train=False)
        G = define_G(qcfg).to(cuda_device).eval()
    calibrate_quant(G, [(torch.from_numpy(x).to(cuda_device),
                         torch.from_numpy(c).to(cuda_device))])
    export_generator(qcfg, G, str(tmp_path / "int8"))
    on_card = load_exported(str(tmp_path / "f32"))
    on_cpu = load_exported(str(tmp_path / "f32"), device="cpu")
    assert on_card.device.type == "cuda"
    np.testing.assert_allclose(on_card(x, c), on_cpu(x, c), atol=1e-4)
    assert on_card(x[:1], c[:1]).shape == (1, 32, 32, 3)
    with torch.no_grad():
        want = G(torch.from_numpy(x).to(cuda_device).bfloat16(),
                 torch.from_numpy(c).to(cuda_device).bfloat16())
    np.testing.assert_array_equal(load_exported(str(tmp_path / "int8"))(x, c),
                                  want.float().cpu().numpy())


@pytest.mark.parametrize("mode", ["reflect", "replicate"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_backward_is_deterministic_on_card(cuda_device, mode, dtype):
    """The port's reflect/replicate pad (``ops/pad.py``) differentiates
    without atomics: two backward passes give the same bits, the reflect
    fold equals the CPU's (the same elementwise adds in the same order; the
    replicate fold's border sums may reduce in another order), and the pad
    runs under
    ``torch.use_deterministic_algorithms(True)``, where ATen's own
    reflection pad backward raises on the card."""
    from pcgan_tpu_torch.ops.pad import pad2d
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 64, 34, 34)).astype(
        np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((4, 64, 40, 40)).astype(
        np.float32)).to(dtype)

    def grad(device):
        xd = x.to(device).requires_grad_(True)
        (dx,) = torch.autograd.grad(pad2d(xd, 3, mode), xd, g.to(device))
        return dx
    a, b = grad(cuda_device), grad(cuda_device)
    assert torch.equal(a, b)
    if mode == "reflect":
        assert torch.equal(a.cpu(), grad("cpu"))
    torch.use_deterministic_algorithms(True)
    try:
        assert torch.equal(grad(cuda_device), a)
    finally:
        torch.use_deterministic_algorithms(False)


def test_two_ranks_share_the_card(cuda_device, tmp_path):
    """The port's data-parallel step over CUDA tensors: two gloo ranks on
    the one card (``torch_port_parallel_worker.py``), f32, take from one
    warm state the step the one-rank step takes on the whole global batch:
    every loss within 1e-4 abs + 1e-4 rel, the parameters within the
    one-step Adam envelope (``tests/test_torch_port_train_step.py``), the
    ranks alike bit for bit."""
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.train import create_train_state, make_train_step
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    from torch_port_parallel_worker import run_cohort
    cfg = parse_config([
        "--crop_size", "32", "--load_size", "32", "--netG", "resnet_6blocks",
        "--ngf", "8", "--ndf", "8", "--n_age_bins", "4", "--batch_size", "4",
        "--dtype", "float32", "--pool_size", "0", "--lr_policy", "constant",
        "--cond_inject", "bottleneck"], is_train=True)
    rng = np.random.default_rng(12)
    batches = [{"image": torch.from_numpy(rng.random((4, 32, 32, 3),
                                                     np.float32) * 2 - 1),
                "bin": torch.from_numpy(rng.integers(0, 4, 4)),
                "target_bin": torch.from_numpy(rng.integers(0, 4, 4))}
               for _ in range(3)]

    def state_on_card():
        G = define_G(cfg, torch.Generator().manual_seed(1)).to(cuda_device)
        D = define_D(cfg, torch.Generator().manual_seed(2)).to(cuda_device)
        return create_train_state(cfg, G, D,
                                  torch.Generator().manual_seed(0))

    def on_card(b):
        return {k: v.to(cuda_device) for k, v in b.items()}
    state = state_on_card()
    make_train_step(cfg, state.G, state.D)(state, on_card(batches[0]))
    ckpt.save_state(state, str(tmp_path), "warm", "warm")
    payloads = [torch.load(tmp_path / "warm" / "warm.pt", weights_only=True)]
    ranks = run_cohort({"gan": {"kind": "gan_steps", "cfg": cfg,
                                "payloads": payloads,
                                "batches": batches[1:2]}},
                       tmp_path, device="cuda")
    m = make_train_step(cfg, state.G, state.D)(state, on_card(batches[1]))
    got, other = ranks[0]["gan"][0], ranks[1]["gan"][0]
    assert got["metrics"] == other["metrics"]
    for k, v in m.items():
        want = float(v)
        assert abs(got["metrics"][k] - want) <= 1e-4 + 1e-4 * abs(want), k
    lr = cfg.train.lr
    for net, mod in (("G", state.G), ("D", state.D)):
        start = payloads[0][net]
        for k, p in mod.named_parameters():
            assert torch.equal(got[net][k], other[net][k]), (net, k)
            dj = (p.detach().cpu() - start[k]).numpy()
            dt = (got[net][k] - start[k]).numpy()
            diff = np.abs(dj - dt)
            assert np.median(diff) < 2e-6, (net, k, np.median(diff))
            assert diff.max() <= 2.1 * lr, (net, k, diff.max())
            assert float((diff > 0.25 * lr).mean()) < 2e-3, (net, k)
