"""The comparison that decides ``correct``: the numbers the program's run
is held to against the plain reference, each beside its limit. Every
candidate number is worked out; a cell compares those its limits file
names and prints the rest as readings.

Training (the first steps, which the window's own call and feed ran on
rows that all differ). A "leaf" is one slice of a parameter along its
second dimension (a conv's input channel, a transposed conv's output
channel, a linear layer's input feature; a bias whole): the stem's
condition channels feed an instance norm that cancels them, so their
gradient is zero in exact arithmetic while the image channels' is not.
A leaf's gap is |program - reference| of its norm over the larger of the
reference's norm of that leaf and of a floor, the median leaf of the net
(or of the leaf's own tensor, for the tensor numbers); leaves whose
reference gradient is under a thousandth of the net's median leaf's move
by round-off alone and are left out.

- ``grad_gap_tensor``: for each weight (a parameter tensor of more than
  one leaf), the median gap of its leaves' first-step gradient as Adam
  got it (the program's from its moments after one step); the worst over
  the weights, the nets and the ranks. A fault in one layer moves most of
  that layer's leaves, and a weight's own floor keeps a small one (G's
  3-channel tail) from hiding under the net's larger leaves. A bias is
  one leaf, whose reading swings as the worst leaf's does (``PERF.md``);
- ``change_gap_tensor``: the same for each leaf's change over the steps;
- ``grad_gap_median``, ``change_gap_median``: the median over each net's
  leaves (the worst over the nets and the ranks);
- ``grad_gap_worst``, ``change_gap_worst``: the worst leaf;
- ``loss_gap_step1``, ``loss_gap_steps``: the largest relative gap of
  the losses, at the first step and over all;
- ``data_rows``: rows of the fed batches that are not the benchmark's
  canvases, carry another age or bin, or repeat.

``flips`` reads what lies behind the worst leaf's change: the share of
entries whose first update has the other sign than the reference's (Adam
moves each entry by the learning rate times its gradient's sign at the
first step), and the share of the leaf's squared change difference that
those entries carry.

Sampling: ``crop_gap`` (the largest difference of a centre crop) and
``image_gap_p99`` (the 99th percentile, over the sampled calls' images,
of one image's mean absolute difference: steadier than the largest, and
an altered answer, every bin of a face, is more than one image in a
hundred of a call).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import numpy as np

INERT = 1e-3
Leaf = Tuple[str, int]


def slice_norms(t) -> List[float]:
    """The norms of ``t``'s slices along its second dimension (its own
    norm when it has one dimension)."""
    import torch
    t = t.detach().double()
    if t.dim() < 2:
        return [float(torch.linalg.vector_norm(t))]
    dims = [0] + list(range(2, t.dim()))
    return torch.linalg.vector_norm(t, dim=dims).tolist()


def _flat(norms: Dict[str, List[float]]) -> Dict[Leaf, float]:
    return {(k, j): v for k, vs in norms.items() for j, v in enumerate(vs)}


def leaf_gaps(prog: Dict[str, List[float]], ref: Dict[str, List[float]],
              ref_grad: Dict[str, List[float]], per_tensor: bool = False
              ) -> Dict[Leaf, float]:
    """Each live leaf's gap (slice norms by parameter name; a NaN or a
    missing leaf reads infinite). ``per_tensor``: the floor is the median
    live leaf of the leaf's own tensor, not of the net."""
    prog, ref, ref_grad = _flat(prog), _flat(ref), _flat(ref_grad)
    med_g = statistics.median(ref_grad.values())
    live = [k for k in ref if ref_grad[k] >= INERT * med_g]
    by: Dict[str, List[float]] = {}
    for k in live:
        by.setdefault(k[0] if per_tensor else "", []).append(ref[k])
    med = {name: statistics.median(v) for name, v in by.items()}
    out = {}
    for k in live:
        floor = med[k[0] if per_tensor else ""]
        gap = abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], floor)
        out[k] = gap if gap == gap else math.inf
    return out


def _weight_medians(gaps: Dict[Leaf, float], norms: Dict[str, List[float]]
                    ) -> Dict[str, float]:
    """The median gap of each weight's live leaves; a weight is a tensor
    of more than one leaf in ``norms`` (a bias is one leaf)."""
    by: Dict[str, List[float]] = {}
    for (name, _), g in gaps.items():
        if len(norms[name]) > 1:
            by.setdefault(name, []).append(g)
    return {name: statistics.median(v) for name, v in by.items()}


def train_numbers(ranks: List[Dict], ref
                  ) -> Tuple[Dict[str, float], Dict[str, object]]:
    """(numbers, where): every candidate number, and where each leaf or
    tensor number's worst sits ((rank, net, parameter[, slice])).
    ``ranks``: each rank's readings {'losses', 'grad_norms',
    'change_norms'}; ``ref``: the reference's ``Readings``."""
    out = dict.fromkeys(("loss_gap_step1", "loss_gap_steps"), 0.0)
    where: Dict[str, object] = {}

    def worst(key, value, at):
        if key not in out or value > out[key]:
            out[key], where[key] = value, at
    for rank, r in enumerate(ranks):
        for t, (p, q) in enumerate(zip(r["losses"], ref.losses,
                                       strict=True)):
            gap = max(abs(p[k] - q[k]) / abs(q[k])
                      for k in ("loss_G", "loss_D"))
            gap = gap if gap == gap else math.inf
            if t == 0:
                worst("loss_gap_step1", gap, None)
            worst("loss_gap_steps", gap, None)
        for net in ref.grad_norms:
            for what in ("grad", "change"):
                norms = (r[what + "_norms"][net],
                         getattr(ref, what + "_norms")[net],
                         ref.grad_norms[net])
                gaps = leaf_gaps(*norms)
                worst(what + "_gap_median", statistics.median(gaps.values()),
                      (rank, net))
                leaf = max(gaps, key=gaps.get)
                worst(what + "_gap_worst", gaps[leaf], (rank, net) + leaf)
                tensors = _weight_medians(
                    leaf_gaps(*norms, per_tensor=True), norms[1])
                name = max(tensors, key=tensors.get)
                worst(what + "_gap_tensor", tensors[name], (rank, net, name))
    return out, where


def flips(rank: Dict, ref, at: Tuple) -> Dict[str, float]:
    """Sign readings of the leaf ``at`` (net, parameter, slice) and of
    each net's live leaves: the share of entries whose first update has
    the other sign than the reference's, and, in the leaf, the share of
    its squared change difference that those entries carry. ``rank`` and
    ``ref`` hold 'first_update' and 'change' tensors by net and
    parameter."""
    net, name, j = at

    def leaf(t, i=j):
        return t if t.dim() < 2 else t[:, i]
    out = {}
    for n, grads in ref.grad_norms.items():
        flat = _flat(grads)
        med_g = statistics.median(flat.values())
        off = total = 0
        for k, i in (k for k, g in flat.items() if g >= INERT * med_g):
            x = leaf(rank["first_update"][n][k], i)
            y = leaf(ref.first_update[n][k], i)
            off += int((x.sign() * y.sign() < 0).sum())
            total += y.numel()
        out[f"flip_share.{n}"] = off / max(1, total)
    pu = leaf(rank["first_update"][net][name]).double()
    ru = leaf(ref.first_update[net][name]).double()
    diff = (leaf(rank["change"][net][name]).double()
            - leaf(ref.change[net][name]).double())
    off = pu.sign() * ru.sign() < 0
    out["flip_share_at_worst"] = float(off.double().mean())
    total = float((diff ** 2).sum())
    out["flipped_diff_share_at_worst"] = (
        float((diff[off] ** 2).sum()) / total if total > 0 else 0.0)
    return out


def train_readings(ranks: List[Dict], ref
                   ) -> Tuple[Dict[str, float], Dict[str, object]]:
    """(numbers, readings): ``train_numbers``'s numbers; where their
    worst sits, and ``flips`` at the worst change leaf."""
    nums, where = train_numbers(ranks, ref)
    extra: Dict[str, object] = {
        k + "_at": ".".join(str(x) for x in at)
        for k, at in where.items() if at is not None}
    at = where["change_gap_worst"]
    extra.update(flips(ranks[at[0]], ref, at[1:]))
    return nums, extra


def grid_numbers(crop_gap: float, per_image: List[float]
                 ) -> Dict[str, float]:
    """The grid's numbers from the largest crop difference and each
    image's mean absolute difference."""
    v = np.asarray(per_image, np.float64)
    return {"crop_gap": crop_gap,
            "image_gap_p99": float(np.percentile(v, 99)),
            "image_gap_worst": float(v.max()),
            "image_gap_median": float(np.median(v)),
            "images_checked": float(v.size)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {'value', 'limit'}}): correct when every number is
    finite and within its limit. A number without a limit, or a limit
    without a number, fails."""
    rows, ok = {}, True
    for k in list(numbers) + [k for k in limits if k not in numbers]:
        v, lim = numbers.get(k, math.nan), limits.get(k)
        rows[k] = {"value": v, "limit": lim}
        if lim is None or not (v == v and v <= lim):
            ok = False
    return ok, rows


def bad_rows(fed, canvases, ages, n_bins: int) -> int:
    """Fed rows that are not one of ``canvases``, carry another age than
    that canvas's or another bin than the reference's bin of its age, or
    repeat an earlier row. ``fed``: (u8 images, ages, bins) of each
    batch."""
    import hashlib

    from portbench.reference.preprocess import age_bins

    def key(a):
        return hashlib.sha1(np.ascontiguousarray(a)).digest()
    index = {}
    for i in range(len(canvases)):
        index.setdefault(key(canvases[i]), i)
    want = age_bins(ages, n_bins)
    seen, bad = set(), 0
    for images, fed_ages, bins in fed:
        for img, age, b in zip(images, fed_ages, bins):
            i = index.get(key(img))
            if (i is None or i in seen or int(age) != int(ages[i])
                    or int(b) != int(want[i])):
                bad += 1
            else:
                seen.add(i)
    return bad
