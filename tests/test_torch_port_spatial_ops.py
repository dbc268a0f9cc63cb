"""The band layers of the spatial axis (``pcgan_tpu_torch/parallel/
spatial.py``) against the whole image, and B1's band.

One cohort of four gloo ranks (``torch_port_parallel_worker.
spatial_pieces``, a 1 x 4 data x spatial mesh) runs every case: each rank
takes its band of a seeded input, computes the layer inside
``spatial.banded`` (its halo rows fetched from the neighbouring bands)
and differentiates ``sum(y * cotangent)`` with ``torch.autograd.grad``.
The bands put together equal the layer on the whole image: the output,
the input gradient and the parameter gradients (summed over the line)
within 1e-5 of scale in f32 (summation order), and bf16 instance norm
within 1e-2 (a bf16 ulp of its output). The heights give every kind of
band over four ranks: even (32: 8 each), uneven (30: 8+8+8+6), thinner
than the halo with an empty band (6: 2+2+2+0, 3: 1+1+1+0) and two empty
bands (2: 1+1+0+0). The s2d route needs bands that divide by 4: 40 rows
(10 a band) raise on every rank.

The model levers' pieces: ``gather_band`` (every rank holds the whole
tensor; each rank's share of the cotangent differs, and the owners' summed
gradients equal the whole image's); the 2x2 max and average pools over
bands that start on odd rows, are odd in height or empty (VALID: 7, 5 and
3 rows drop their last); self-attention (gamma drawn, never 0) on even,
odd, 1-row and empty bands; the resize conv at heights where ``2 *
ceil(H/4)`` is not ``ceil(2H/4)``; group norm (2 channels a group) with an
empty band; and a U-Net level pair (the outer level's down conv and norm,
the innermost's down and up, both skip concats) down to 1-row and empty
bands.

B1's plain twin writing a band equals the slice of its whole crop (the
crop offset clamped first), bit for bit.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
import torch

from pcgan_tpu_torch.ops.preprocess import preprocess_batch

from torch_port_levers import assert_close
from torch_port_parallel_worker import build_piece, run_cohort, run_piece

WORLD = 4


def _cases():
    out = {}

    def add(name, heights, **spec):
        for h in heights:
            out[f"{name}_H{h}"] = {**spec, "H": h,
                                   "seed": len(out) + 101}
    for mode in ("reflect", "replicate", "zero"):
        add(f"conv3_s1_{mode}", (32, 30, 6, 3), kind="conv", cin=4, cout=5,
            k=3, s=1, p=1, mode=mode)
    add("conv3_s2_zero", (32, 30, 6, 3), kind="conv", cin=4, cout=5, k=3,
        s=2, p=1, mode="zero")
    add("conv4_s2_zero", (32, 30, 6), kind="conv", cin=4, cout=5, k=4, s=2,
        p=1, mode="zero")
    add("conv4_s1_zero", (8, 4, 3), kind="conv", cin=4, cout=3, k=4, s=1,
        p=1, mode="zero")
    add("stem7_cond", (32, 30, 6), kind="conv", cin=3, cout=4, k=7, s=1,
        p=3, mode="reflect", cond=2, route="cond")
    add("tail7_s2d", (32, 16, 40), kind="conv", cin=4, cout=3, k=7, s=1,
        p=3, mode="reflect", route="s2d", W=16)
    add("fused3", (32, 30, 6), kind="conv", cin=4, cout=5, k=3, s=1, p=1,
        mode="reflect", route="fused")
    add("fused7", (32, 30, 6), kind="conv", cin=3, cout=4, k=7, s=1, p=3,
        mode="reflect", route="fused")
    add("deconv3", (16, 15, 3, 2), kind="deconv", cin=4, cout=5, k=3, s=2,
        p=1, op=1)
    add("inorm_f32", (32, 30, 6, 3), kind="inorm", cin=4)
    add("inorm_bf16", (32, 30, 6, 3), kind="inorm", cin=4,
        dtype="bfloat16")
    # the model levers' band primitives and layers (ROADMAP A10d 1-6)
    add("gather", (8, 6, 3, 2), kind="gather", cin=3)
    for mode in ("max", "avg"):
        add(f"pool_{mode}", (8, 10, 7, 5, 3), kind="pool", cin=3, mode=mode)
    add("attn", (8, 10, 4, 6), kind="attn", cin=16)
    add("resize", (5, 6, 8), kind="resize", cin=4, cout=5)
    add("gnorm", (30, 6, 3), kind="gnorm", cin=64)
    add("unet_pair", (8, 4), kind="unet_pair", cin=4)
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    ranks = run_cohort({"pieces": {"kind": "spatial_pieces",
                                   "specs": CASES}},
                       tmp_path_factory.mktemp("spatial_ops"), world=WORLD)
    return [r["pieces"] for r in ranks]


def _whole(spec):
    mod, x, cond, cot = build_piece(spec)
    x = x.clone().requires_grad_(True)
    params = [] if mod is None else list(mod.parameters())
    y = run_piece(mod, x, cond, None, spec)
    grads = torch.autograd.grad((y.float() * cot).sum(), [x] + params)
    return y.detach().float(), grads[0].float(), grads[1:]


@pytest.mark.parametrize("name", list(CASES))
def test_band_layer_matches_whole_image(pieces, name):
    spec = CASES[name]
    if spec.get("route") == "s2d" and spec["H"] == 40:
        # the fold groups rows by 4: a band of another height raises
        for r in pieces:
            assert "each must divide by 4" in r[name]["error"]
        return
    y, gx, gw = _whole(spec)
    got = [r[name] for r in pieces]
    tol = 1e-2 if spec.get("dtype") == "bfloat16" else 1e-5
    if spec["kind"] == "gather":
        # every rank holds the whole tensor, and counted the gather
        for g in got:
            assert torch.equal(g["y"], y)
            assert g["collectives"]["gather_band/spatial"] > 0
            assert g["collectives"]["gather_band_grad/spatial"] > 0
    else:
        assert_close(f"{name} y", torch.cat([g["y"] for g in got], 2), y,
                     tol)
    assert_close(f"{name} dx", torch.cat([g["gx"] for g in got], 2), gx,
                 tol)
    for i, want in enumerate(gw):
        for r, g in enumerate(got):
            assert_close(f"{name} dw{i} rank {r}", g["gw"][i], want, tol)


def test_bands_cover_every_kind(pieces):
    """The heights above split into even, uneven, thin and empty bands."""
    from pcgan_tpu_torch.parallel.spatial import bands_of
    kinds = {tuple(b.h for b in bands_of(h, WORLD))
             for h in (32, 30, 6, 3, 2)}
    assert kinds == {(8, 8, 8, 8), (8, 8, 8, 6), (2, 2, 2, 0), (1, 1, 1, 0),
                     (1, 1, 0, 0)}
    # an empty band's rank took part and holds an empty output band
    assert pieces[3]["conv3_s1_zero_H6"]["y"].shape[2] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b1_plain_band_is_the_crop_sliced(dtype):
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(rng.integers(0, 256, (3, 40, 44, 3), np.uint8))
    cy = torch.tensor([0, 3, 9])        # 9 > load - crop: clamped to 4
    cx = torch.tensor([4, 0, 2])
    flip = torch.tensor([True, False, True])
    whole = preprocess_batch(imgs, cy, cx, flip, 36, 32, out_dtype=dtype)
    for r0, n in ((0, 8), (8, 8), (24, 8), (30, 2), (32, 0), (5, 19)):
        band = preprocess_batch(imgs, cy, cx, flip, 36, 32, out_dtype=dtype,
                                row0=r0, n_rows=n)
        assert band.shape == (3, n, 32, 3)
        assert torch.equal(band, whole[:, r0:r0 + n]), (r0, n)
    with pytest.raises(ValueError, match="not in a crop"):
        preprocess_batch(imgs, cy, cx, flip, 36, 32, row0=30, n_rows=4)
