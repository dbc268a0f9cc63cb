"""On-device input preprocessing (counterpart of ``pcgan_tpu/ops/preprocess.py``).

A PIL-style antialiased resize is linear and separable, so resize + crop +
flip + normalize of a u8 batch is two matrix products per channel:

    out[b,:,:,c] = clip(Mh[y0:y0+crop] . img[b,:,:,c] . Mw[x0:x0+crop]^T
                        * 2/255 - 1, -1, 1)

with the rows of the ``Mw`` slice reversed when the image is flipped
(``Mh``/``Mw`` from ops/resize.py). ``preprocess_batch`` is the plain
PyTorch version; ``make_preprocess`` runs it on a CPU tensor and the
hand-written kernel (ops/cuda_preprocess.py), which computes the same
function, on a CUDA tensor.
"""

from __future__ import annotations

import torch

from pcgan_tpu_torch.models.registry import compute_dtype
from pcgan_tpu_torch.ops.cuda_preprocess import preprocess_batch_cuda
from pcgan_tpu_torch.ops.resize import resize_matrix
from pcgan_tpu_torch.parallel import rows as draw
from pcgan_tpu_torch.utils import tracing


# --------------------------------------------------------------------------- #
# plain PyTorch pipeline
# --------------------------------------------------------------------------- #


def crop_rows(crop_y: torch.Tensor, crop_x: torch.Tensor, flip: torch.Tensor,
              load_size: int, crop_size: int):
    """Per-sample row indices into Mh and Mw: (B, crop) each. Offsets clamp
    to [0, load - crop] as ``jax.lax.dynamic_slice`` clamps them."""
    span = load_size - crop_size
    ar = torch.arange(crop_size, device=crop_y.device)
    ys = crop_y.long().clamp(0, span)[:, None] + ar
    cols = torch.where(flip.bool()[:, None], crop_size - 1 - ar, ar)
    xs = crop_x.long().clamp(0, span)[:, None] + cols
    return ys, xs


def preprocess_batch(imgs: torch.Tensor, crop_y: torch.Tensor,
                     crop_x: torch.Tensor, flip: torch.Tensor,
                     load_size: int, crop_size: int,
                     method: str = "bicubic",
                     out_dtype=torch.float32, row0: int = 0,
                     n_rows: int = None) -> torch.Tensor:
    """Fused resize->crop->flip->normalize, plain PyTorch (the twin of
    ``pcgan_tpu/ops/preprocess.py:101-137``).

    imgs: (B, H, W, C) u8 (or float in [0, 255]).
    crop_y/crop_x: (B,) int offsets in resized (load_size) coordinates,
    in [0, load_size - crop_size]. flip: (B,) bool.
    Returns (B, crop_size, crop_size, C) in [-1, 1], ``out_dtype``; with
    ``row0``/``n_rows``, rows [row0, row0 + n_rows) of each crop only (a
    band of an image split along H: the offset clamps first, then the band
    starts ``row0`` rows into the crop).
    """
    _, h, w, _ = imgs.shape
    dev = imgs.device
    n_rows = crop_size - row0 if n_rows is None else n_rows
    if row0 < 0 or n_rows < 0 or row0 + n_rows > crop_size:
        raise ValueError(f"preprocess: rows [{row0}, {row0 + n_rows}) are "
                         f"not in a crop of {crop_size}")
    up = tracing.upload
    m_h = up(torch.from_numpy(resize_matrix(h, load_size, method)), dev)
    m_w = up(torch.from_numpy(resize_matrix(w, load_size, method)), dev)
    ys, xs = crop_rows(up(crop_y, dev), up(crop_x, dev), up(flip, dev),
                       load_size, crop_size)
    ys = ys[:, row0:row0 + n_rows]
    mh_b, mw_b = m_h[ys], m_w[xs]                    # (B, crop, H|W)
    # full f32: u8 pixel data needs >8 mantissa bits through the two
    # products (TF32 off on the card, pcgan_tpu_torch/device.py)
    x = imgs.float() * (2.0 / 255.0)                 # fold ToTensor+Norm scale
    x = torch.einsum("boh,bhwc->bowc", mh_b, x)
    x = torch.einsum("bpw,bowc->bopc", mw_b, x)
    # clamp: PIL clips each resample pass to u8 range; bicubic's negative
    # lobes can otherwise overshoot past the valid range
    return torch.clamp(x - 1.0, -1.0, 1.0).to(out_dtype)


def make_preprocess(cfg, train: bool = True):
    """Returns f(generator, raw_batch, rows=None, band=None) -> batch dict.

    raw_batch: {'image': (B,H,W,C) u8 native-size tensor, ...}. Handles the
    reference's --preprocess modes and --no_flip; at eval (train=False) uses
    center crop and no flip (the reference's test transform). In training,
    crop offsets and flips come from ``generator`` (a CPU torch.Generator);
    ``rows`` (``parallel.rows.Rows``) draws them for the global batch and
    keeps this rank's rows (the sharded-state step); ``band``
    (``parallel.spatial.Band`` of the crop) writes only those rows of each
    crop (a spatial axis). ``f.crop_of(h)`` is the crop's side for
    canvases of side h.
    On a CUDA tensor the hand-written kernel runs; on a CPU tensor the plain
    version; any other device raises. With ``--no-pallas_pipeline`` the
    plain version runs on whatever device the batch is on (the JAX
    package's plain XLA route, ``pcgan_tpu/ops/preprocess.py:169``): the
    user's choice, never a fallback.
    """
    d = cfg.data
    mode = d.preprocess
    if mode == "scale_width":
        raise NotImplementedError(
            "preprocess=scale_width is aspect-preserving in the reference and "
            "incompatible with the static-square device pipeline; use "
            "resize_and_crop (square datasets like aligned UTKFace are "
            "unaffected) or pre-resize your data offline")
    # --host_resize needs nothing here: the loader delivers load_size
    # canvases, and the device resize of a batch already at load_size is
    # the identity
    use_kernel = bool(d.pallas_pipeline)
    load = d.load_size if "resize" in mode else None
    # no 'crop' in the mode -> output the resized size (or, for 'none', the
    # native size: crop=None resolves to the incoming image size below)
    crop = d.crop_size if "crop" in mode else load
    out_dtype = compute_dtype(cfg.model.dtype)

    def crop_of(h):
        return crop or load or h

    def fn(generator, raw, rows=None, band=None):
        imgs = raw["image"]
        b = imgs.shape[0]
        eff_load = load or imgs.shape[1]
        eff_crop = crop_of(imgs.shape[1])
        span = eff_load - eff_crop
        if train and span > 0:
            cy = draw.randint(0, span + 1, b, generator, rows)
            cx = draw.randint(0, span + 1, b, generator, rows)
        else:
            cy = torch.full((b,), span // 2)
            cx = torch.full((b,), span // 2)
        if train and not d.no_flip:
            fl = draw.rand((b,), generator, rows) < 0.5
        else:
            fl = torch.zeros(b, dtype=torch.bool)
        out = {k: v for k, v in raw.items() if k != "image"}
        if imgs.device.type == "cuda":
            run = preprocess_batch_cuda if use_kernel else preprocess_batch
        elif imgs.device.type == "cpu":
            run = preprocess_batch
        else:
            raise ValueError(f"preprocess: unsupported device {imgs.device}")
        kw = {} if band is None else {"row0": band.r0, "n_rows": band.h}
        out["image"] = run(imgs, cy, cx, fl, eff_load, eff_crop,
                           out_dtype=out_dtype, **kw)
        return out

    fn.crop_of = crop_of
    return fn


def make_pair_preprocess(cfg, train: bool = True):
    """Returns f(generator, raw_pairs) -> pair batch for the comparator
    (counterpart of ``pcgan_tpu/parallel/train_parallel.py:145-152``).

    raw_pairs: {'image_a', 'image_b': (B,H,W,C) u8 tensors on one device,
    'label': (B,)}. Both members go through ``make_preprocess`` in ONE call
    over their 2B concatenation (one kernel launch on the card), so every
    image gets its own crop offsets and flip from ``generator``. The
    outputs are the two halves of that 2B batch."""
    pre = make_preprocess(cfg, train)

    def fn(generator, raw):
        a = raw["image_a"]
        both = pre(generator, {"image": torch.cat([a, raw["image_b"]])})
        x = both["image"]
        return {"image_a": x[:a.shape[0]], "image_b": x[a.shape[0]:],
                "label": raw["label"]}

    return fn
