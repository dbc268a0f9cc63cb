"""Streaming FID and its companion metrics (counterpart of
``pcgan_tpu/eval_lib.py``), shared by ``evaluate``, ``tools/compute_fid_stats``
and in-training FID (``train_main``).

Per batch, under ``torch.inference_mode()`` on the run's device: kernel B1
center-crops the raw u8 batch (the eval transform), G renders each face at
a target bin drawn by permuting the batch's own bins (so the generated
condition marginal matches the real one), and both feature sets fold into
streaming FID statistics in f32. G computes in the run's ``--dtype``; the
random and Inception feature nets in f32 (the comparator in ``--dtype``, as
in JAX). ``--kid``, ``--fid_per_bin``, ``--prdc`` and ``--is_score`` keep the
feature rows in buffers on the device; ``--ssim`` and ``--lpips`` fold
per-batch sums; a comparator adds the condition accuracy. After the loop
the statistics come to the host, where the Frechet ``eigh`` chain runs in
f32 (as the JAX evaluator's epilogue does); KID, PRDC, the per-bin moments
and the IS head's softmax run on the buffers' device. Single device only
(multi-process eval is ROADMAP A10). Nothing falls back: a missing weight
file, a mismatched ``--fid_stats`` file, an absent comparator, a budget too
small for a metric or an overflowing buffer raises.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from pcgan_tpu_torch.config import Config
from pcgan_tpu_torch.data.binning import (bin_to_onehot, bin_to_score,
                                          normalize_score)
from pcgan_tpu_torch.ops import fid as fid_ops


def check_eval_budget(cfg: Config, budget: int, flag: str) -> None:
    """The startup guards of the CLIs: the retained-feature metrics need a
    finite budget, PRDC one above ``--prdc_k``."""
    r = cfg.run
    if (r.kid or r.fid_per_bin or r.prdc or r.is_score) and budget <= 0:
        raise SystemExit(f"--kid/--fid_per_bin/--prdc/--is_score need a "
                         f"finite {flag} budget (>0) to size their feature "
                         f"buffers")
    if r.prdc and budget <= r.prdc_k:
        raise SystemExit(f"--prdc needs {flag} > --prdc_k ({r.prdc_k}), "
                         f"got {budget}")


def check_one_device(cfg: Config) -> None:
    """Evaluation runs on one card: ``--mesh_shape 1`` or ``-1`` only."""
    p = cfg.parallel
    if p.mesh_shape not in ((-1,), (1,)) or p.mesh_axes != ("data",):
        raise NotImplementedError(
            "--mesh_shape/--mesh_axes: the port evaluates on one device "
            "(1 or -1); multi-device eval is not ported yet")


def make_feature_extractor(cfg: Config, comparator=None, device=None):
    """``--fid_features`` dispatch -> (f(images (B,H,W,C) in [-1,1]) ->
    (B, d), d): ``random`` (the JAX package's PRNGKey(42) net),
    ``comparator`` (the bundle's trunk embedding; needs
    ``--comparator_path``) or ``pth:<file>`` (a torchvision InceptionV3)."""
    spec = cfg.run.fid_features
    if spec == "random":
        return fid_ops.make_feature_fn(cfg.data.output_nc, device)
    if spec == "comparator":
        if comparator is None:
            raise ValueError("--fid_features comparator requires "
                             "--comparator_path (no comparator loaded)")
        C = comparator[0]

        def f(images):
            return C(images, return_features=True)
        return f, C.fc.out_features
    if spec.startswith("pth:"):
        from pcgan_tpu_torch.models.inception import make_inception_feature_fn
        return make_inception_feature_fn(spec[len("pth:"):],
                                         cfg.run.allow_pickle, device)
    raise NotImplementedError(f"--fid_features [{spec}] not implemented "
                              f"(want random | comparator | pth:<file>)")


def _load_frozen_stats(cfg: Config, d: int):
    """``--fid_stats``: the frozen real-side statistics, checked against
    this run's feature dimension, feature space and crop."""
    frozen, meta = fid_ops.load_stats(cfg.run.fid_stats)
    if int(frozen.s.shape[0]) != d:
        raise ValueError(
            f"--fid_stats {cfg.run.fid_stats}: feature dim "
            f"{int(frozen.s.shape[0])} != this run's {d} (stats were "
            f"computed with --fid_features {meta.get('fid_features', '?')}, "
            f"this run uses {cfg.run.fid_features})")
    if (meta.get("fid_features") is not None
            and str(meta["fid_features"]) != cfg.run.fid_features):
        raise ValueError(
            f"--fid_stats was computed with --fid_features "
            f"{meta['fid_features']!r}; this run uses "
            f"{cfg.run.fid_features!r}: numbers would be meaningless")
    if (meta.get("crop_size") is not None
            and int(meta["crop_size"]) != cfg.data.crop_size):
        raise ValueError(
            f"--fid_stats was computed at crop_size {int(meta['crop_size'])}"
            f"; this run uses {cfg.data.crop_size}")
    return frozen


def _lpips_setup(cfg: Config, device):
    """(trunk, lins or None, result key) for ``--lpips``."""
    from pcgan_tpu_torch.models.vgg import load_vgg16, random_vgg16
    r = cfg.run
    if r.lpips_vgg16 == "random":
        vgg = random_vgg16(0)
        print("WARNING: --lpips_vgg16 random: LPIPS runs in a seeded "
              "fresh-init VGG16 feature space (smoke/CI only; the port's "
              "draw is not the JAX package's)", flush=True)
    elif r.lpips_vgg16:
        vgg = load_vgg16(r.lpips_vgg16, r.allow_pickle)
    else:
        raise ValueError("--lpips needs --lpips_vgg16 <torchvision vgg16 "
                         ".pth> (or 'random' for a smoke run)")
    if r.lpips_lins:
        from pcgan_tpu_torch.ops.lpips import load_lpips_lins
        lins = tuple(w.to(device) for w in load_lpips_lins(
            r.lpips_lins, r.allow_pickle))
        return vgg.to(device), lins, "lpips"
    print("--lpips: no --lpips_lins given: uniform 1/C channel weighting "
          "(a valid perceptual distance, NOT the published LPIPS "
          "calibration); reported as 'lpips_uniform'", flush=True)
    return vgg.to(device), None, "lpips_uniform"


def _is_head(cfg: Config, d: int):
    """The classifier head (W (K, d), b (K,)) numpy for ``--is_score``."""
    from pcgan_tpu_torch.ops import is_score as is_ops
    spec = cfg.run.fid_features
    if spec.startswith("pth:"):
        head = is_ops.load_inception_fc(spec[len("pth:"):],
                                        cfg.run.allow_pickle)
        if head[0].shape[1] != d:
            raise ValueError(
                f"--is_score: fc head input dim {head[0].shape[1]} != the "
                f"feature trunk's {d} (not the matching InceptionV3 "
                f"checkpoint?)")
        return head
    if spec == "random":
        print("WARNING: --is_score with --fid_features random: seeded "
              "random classifier head (smoke/CI only, not comparable to "
              "published IS)", flush=True)
        return is_ops.random_fc(d)
    raise ValueError(
        "--is_score needs an Inception classifier head: use --fid_features "
        "pth:<inception .pth> (or random for a smoke run); the comparator "
        "trunk has no class labels")


def make_fid_evaluator(cfg: Config, comparator: Optional[Tuple] = None,
                       device=None):
    """Returns run(G, raw_batch_iter, max_images, seed) -> metrics dict.

    ``G``: the generator module on ``device`` (scored in eval mode; its
    train/eval mode is restored after). ``raw_batch_iter`` yields
    {'image': (B,H,W,C) u8 numpy, 'bin': (B,) int}. ``comparator`` is the
    bundle ``(C, bin_lo, bin_hi, bin_means or None)`` of
    ``utils/checkpoint.load_comparator_bundle`` with C on ``device``, or
    None. ``max_images`` stops the loop once that many rows are seen (0:
    the whole iterator); ``seed`` seeds the target-bin permutations
    (numpy ``default_rng``, as JAX) and the KID subsets. A ``times`` dict
    receives the wall time of each batch (``batch``, a list) and the
    seconds spent in G, the feature nets, the rest of the loop and the
    epilogue (``g``, ``features``, ``other``, ``epilogue``), with the
    device synchronized at each boundary; without it nothing is timed or
    synchronized."""
    from pcgan_tpu_torch.ops.preprocess import make_preprocess
    from pcgan_tpu_torch.ops.ssim import ssim_pair
    device = torch.device(device or "cpu")
    r = cfg.run
    nb = cfg.data.n_age_bins
    score_mode = cfg.model.cond_mode == "score"
    if r.fid_per_bin and score_mode:
        raise ValueError("--fid_per_bin needs discrete age bins "
                         "(cond_mode=onehot); score mode has no bins")
    retain = r.kid or r.fid_per_bin or r.prdc or r.is_score
    lpips = _lpips_setup(cfg, device) if r.lpips else None
    feature_fn, d = make_feature_extractor(cfg, comparator, device)
    is_head = _is_head(cfg, d) if r.is_score else None
    frozen_real = _load_frozen_stats(cfg, d) if r.fid_stats else None
    pre = make_preprocess(cfg, train=False)
    C = lo = hi = bin_means = None
    if comparator is not None:
        C, lo, hi, bin_means = comparator
        lo, hi = lo.to(device), hi.to(device)
        if bin_means is not None:
            bin_means = bin_means.to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(G, raw_iter: Iterator[Dict], max_images: int = 512,
            seed: int = 0, times: Optional[Dict] = None) -> Dict[str, float]:
        if retain and not max_images:
            raise ValueError("--kid/--fid_per_bin/--prdc/--is_score need a "
                             "finite eval budget (max_images > 0) to size "
                             "the feature buffers")
        was_training = G.training
        G.eval()
        r_stats = fid_ops.init_stats(d, device)
        f_stats = fid_ops.init_stats(d, device)
        hits = torch.zeros((), dtype=torch.int64, device=device)
        n_cmp = 0
        ssim_sum = torch.zeros((), device=device)
        lpips_sum = torch.zeros((), device=device)
        rng = np.random.default_rng(seed)
        seen, bufs, cursor = 0, None, 0
        clock = _Clock(times, sync)
        try:
            with torch.inference_mode():
                for raw in raw_iter:
                    clock.start()
                    b = int(raw["image"].shape[0])
                    if retain and bufs is None:
                        # sized once from the first batch: the loop stops
                        # once seen >= max_images, so the last write starts
                        # at row max_images - 1 at the latest
                        cap = int(max_images) + b
                        bufs = (torch.zeros((cap, d), device=device),
                                torch.zeros((cap, d), device=device),
                                torch.zeros((cap,), dtype=torch.int64,
                                            device=device),
                                torch.zeros((cap,), dtype=torch.int64,
                                            device=device))
                    if bufs is not None and seen + b > bufs[0].shape[0]:
                        raise ValueError(
                            f"eval batch at row {seen} exceeds the KID/"
                            f"per-bin feature buffers ({bufs[0].shape[0]} "
                            f"rows, sized from the first batch); feed "
                            f"fixed-size batches")
                    perm = torch.from_numpy(_local_perm_slice(rng, b))
                    images = torch.from_numpy(raw["image"]).to(device)
                    bins = torch.as_tensor(raw["bin"]).long().to(device)
                    real = pre(None, {"image": images})["image"].float()
                    target = bins[perm.to(device)]
                    if score_mode:
                        s = (normalize_score(bin_means[target], bin_means[0],
                                             bin_means[-1])
                             if bin_means is not None
                             else bin_to_score(target, nb).to(device))
                        cond = s[:, None]
                    else:
                        cond = bin_to_onehot(target, nb)
                    clock.lap("other")
                    fake = G(real, cond).float()
                    clock.lap("g")
                    feats_r, feats_f = feature_fn(real), feature_fn(fake)
                    clock.lap("features")
                    r_stats = fid_ops.update_stats(r_stats, feats_r)
                    f_stats = fid_ops.update_stats(f_stats, feats_f)
                    if bufs is not None:
                        rows = slice(cursor, cursor + b)
                        bufs[0][rows] = feats_r.float()
                        bufs[1][rows] = feats_f.float()
                        if not score_mode:
                            bufs[2][rows] = bins
                            bufs[3][rows] = target
                        cursor += b
                    if C is not None:
                        mu, _ = C(fake)
                        hits += torch.sum((mu >= lo[target])
                                          & (mu < hi[target]))
                        n_cmp += mu.shape[0]
                    if r.ssim:
                        ssim_sum += torch.sum(ssim_pair(real, fake))
                    if lpips is not None:
                        from pcgan_tpu_torch.ops.lpips import lpips_pair
                        lpips_sum += torch.sum(
                            lpips_pair(lpips[0], real, fake, lpips[1]))
                    seen += b
                    clock.lap("other")
                    clock.batch()
                    if max_images and seen >= max_images:
                        break
                clock.start()
                out = _epilogue(cfg, r_stats, f_stats, frozen_real, seen,
                                bufs, cursor, is_head, seed, nb)
                clock.lap("epilogue")
        finally:
            G.train(was_training)
        if r.ssim and seen:
            out["ssim"] = float(ssim_sum) / seen
        if lpips is not None and seen:
            out[lpips[2]] = float(lpips_sum) / seen
        if C is not None and n_cmp > 0:
            out["cond_accuracy"] = float(hits) / float(n_cmp)
        return out

    return run


class _Clock:
    """Wall-time split of the evaluator's loop into a ``times`` dict; a
    no-op without one."""

    def __init__(self, times: Optional[Dict], sync):
        self.times, self.sync = times, sync
        if times is not None:
            times.setdefault("batch", [])
            for k in ("g", "features", "other", "epilogue"):
                times.setdefault(k, 0.0)

    def start(self):
        if self.times is not None:
            self.sync()
            self.t0 = self.t = time.perf_counter()

    def lap(self, key: str):
        if self.times is not None:
            self.sync()
            now = time.perf_counter()
            self.times[key] += now - self.t
            self.t = now

    def batch(self):
        if self.times is not None:
            self.times["batch"].append(self.t - self.t0)


def _epilogue(cfg, r_stats, f_stats, frozen_real, seen, bufs, count,
              is_head, seed, nb) -> Dict[str, float]:
    """The metrics after the streamed loop: the Frechet chain on host
    copies of the statistics (f32), the retained-row metrics on the
    buffers' device. A budget too small for a requested metric raises."""
    r = cfg.run
    r_host, f_host = r_stats.to("cpu"), f_stats.to("cpu")
    if frozen_real is not None:
        out = {"fid": float(fid_ops.fid_from_stats(frozen_real, f_host)),
               "fid_stream": float(fid_ops.fid_from_stats(r_host, f_host)),
               "fid_stats_images": int(frozen_real.count),
               "fid_images": seen}
    else:
        out = {"fid": float(fid_ops.fid_from_stats(r_host, f_host)),
               "fid_images": seen}
    if bufs is None:
        return out
    fr, ff = bufs[0][:count], bufs[1][:count]
    if r.kid:
        from pcgan_tpu_torch.ops.kid import kid_from_features
        if count < 2:
            raise ValueError(f"--kid needs >= 2 eval images, got {count}")
        km, ks = kid_from_features(fr, ff, subsets=r.kid_subsets,
                                   subset_size=r.kid_subset_size, seed=seed)
        out["kid"], out["kid_std"] = float(km), float(ks)
    if r.fid_per_bin:
        if count < 2:
            raise ValueError(f"--fid_per_bin needs >= 2 eval images, got "
                             f"{count}")
        out.update(_per_bin_fid(fr, bufs[2][:count], ff, bufs[3][:count],
                                nb))
    if r.is_score:
        from pcgan_tpu_torch.ops.is_score import inception_score_from_probs
        w, b = (torch.from_numpy(a).to(ff.device) for a in is_head)
        probs = torch.softmax(ff @ w.T + b, dim=-1)
        out["is_mean"], out["is_std"] = inception_score_from_probs(
            probs.cpu().numpy(), splits=r.is_splits)
    if r.prdc:
        from pcgan_tpu_torch.ops.prdc import prdc_from_features
        if count <= r.prdc_k:
            raise ValueError(f"--prdc needs more than --prdc_k "
                             f"({r.prdc_k}) eval images, got {count}")
        out.update({k: float(v) for k, v in
                    prdc_from_features(fr, ff, k=r.prdc_k).items()})
    return out


def _per_bin_fid(feats_r, bins_r, feats_f, bins_f, nb: int
                 ) -> Dict[str, float]:
    """Per-age-bin FID (``--fid_per_bin``): the reals of bin b against the
    fakes generated at bin b, for every bin with >= 2 rows on both sides.
    The per-bin moments come from one-hot products on the buffers' device;
    each Frechet chain runs on the host. Returns {fid_bin_<b>: ...} plus
    ``fid_per_bin_mean``."""
    def stats(f, b):
        oh = torch.nn.functional.one_hot(b, nb).float()       # (n, nb)
        return (oh.sum(dim=0), oh.T @ f,
                torch.einsum("ni,nd,ne->ide", oh, f, f))

    (cr, sr, ssr), (cf, sf, ssf) = ((t.cpu() for t in stats(feats_r, bins_r)),
                                    (t.cpu() for t in stats(feats_f, bins_f)))
    out, vals = {}, []
    for b in range(nb):
        if cr[b] >= 2 and cf[b] >= 2:
            v = float(fid_ops.fid_from_stats(
                fid_ops.FIDStats(cr[b], sr[b], ssr[b]),
                fid_ops.FIDStats(cf[b], sf[b], ssf[b])))
            out[f"fid_bin_{b}"] = v
            vals.append(v)
    if vals:
        out["fid_per_bin_mean"] = sum(vals) / len(vals)
    return out


def _local_perm_slice(rng: np.random.Generator, n: int) -> np.ndarray:
    """The batch's target-bin permutation: the JAX evaluator's
    ``_local_perm_slice`` with one process, ``rng.permutation(n)``."""
    return rng.permutation(n)
