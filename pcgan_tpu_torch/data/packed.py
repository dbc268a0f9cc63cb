"""Packed pre-decoded datasets: one mmap'd u8 array + labels (counterpart of
``pcgan_tpu/data/packed.py``, the same on-disk format, so each package reads
the other's packs bit for bit).

A pack decodes every image once, through the same decode the live loader
uses, and epochs then read rows from ``np.load(mmap_mode='r')`` with no
decode work. ``resize_to`` pre-applies the host resize (``pil_resize_np``,
the filter ``--host_resize`` uses) and is recorded, so ``create_dataset``
can refuse a ``--load_size`` that would upsample a shrunken canvas.

Layout of a pack directory::

    pack/
      images.npy   (N, S, S, 3) uint8   (np.lib.format, mmap-served)
      ages.npy     (N,)        int64
      meta.json    {"format": "pcgan_pack", "version": 1, "n": N,
                    "size": S, "resize_to": 0|S, "source": "...",
                    "resize_method": "bicubic"}
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from pcgan_tpu_torch.data.resample import PIL_RESIZE_METHODS, pil_resize_np

_FORMAT = "pcgan_pack"
_VERSION = 1


def is_pack_dir(root: str) -> bool:
    return os.path.isfile(os.path.join(root, "meta.json")) and os.path.isfile(
        os.path.join(root, "images.npy"))


def write_pack(ds, out_dir: str, *, resize_to: int = 0,
               resize_method: str = "bicubic", num_threads: int = 4,
               source: str = "", log_every: int = 0) -> Dict:
    """Decode every row of ``ds`` (``__len__``, ``get_raw``, optionally
    ``get_raw_batch``) into a pack directory; returns the meta dict.
    ``resize_to`` > 0 resizes each row with ``pil_resize_np``."""
    n = len(ds)
    if n == 0:
        raise ValueError("refusing to pack an empty dataset")
    if resize_method not in PIL_RESIZE_METHODS:
        raise ValueError(f"resize_method [{resize_method}] "
                         f"(want one of {PIL_RESIZE_METHODS})")
    first = ds.get_raw(0)["image"]
    do_resize = bool(resize_to and resize_to > 0)
    size = int(resize_to) if do_resize else int(first.shape[0])
    os.makedirs(out_dir, exist_ok=True)
    imgs = np.lib.format.open_memmap(
        os.path.join(out_dir, "images.npy"), mode="w+", dtype=np.uint8,
        shape=(n, size, size, 3))
    ages = np.zeros((n,), np.int64)

    def place(j: int, img: np.ndarray):
        if do_resize:
            img = pil_resize_np(img, size, resize_method)
        if img.shape != (size, size, 3):
            raise ValueError(
                f"row {j}: decoded shape {img.shape} does not match the pack "
                f"canvas ({size},{size},3); pack with --resize_to to unify "
                f"mixed-size sources")
        imgs[j] = img

    bs = 64
    gb = getattr(ds, "get_raw_batch", None)
    for start in range(0, n, bs):
        idx = np.arange(start, min(start + bs, n))
        if gb is not None:
            batch = gb(idx, num_threads=num_threads)
            for k, j in enumerate(idx):
                place(int(j), batch["image"][k])
            ages[idx] = batch["age"]
        else:
            for j in idx:
                row = ds.get_raw(int(j))
                place(int(j), row["image"])
                ages[j] = int(row["age"])
        if log_every and (start // bs) % log_every == 0:
            print(f"packed {min(start + bs, n)}/{n}", flush=True)
    imgs.flush()
    del imgs
    np.save(os.path.join(out_dir, "ages.npy"), ages)
    meta = {"format": _FORMAT, "version": _VERSION, "n": int(n),
            "size": int(size), "resize_to": int(resize_to or 0),
            "resize_method": resize_method, "source": source}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class PackedDataset:
    """Loader-protocol view of a pack directory: rows served from an mmap
    with no decode work; ``get_raw_batch`` is one fancy-index gather."""

    def __init__(self, root: str, max_size: int = -1):
        meta_path = os.path.join(root, "meta.json")
        if not os.path.isfile(meta_path):
            raise FileNotFoundError(
                f"{root} is not a pack directory (no meta.json); create one "
                f"with python -m pcgan_tpu_torch.tools.pack_dataset")
        with open(meta_path) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != _FORMAT:
            raise ValueError(f"{meta_path}: not a {_FORMAT} pack")
        if int(self.meta.get("version", -1)) > _VERSION:
            raise ValueError(
                f"{meta_path}: pack version {self.meta['version']} is newer "
                f"than this reader (<= {_VERSION})")
        self.imgs = np.load(os.path.join(root, "images.npy"), mmap_mode="r")
        self.ages = np.load(os.path.join(root, "ages.npy"))
        n = int(self.meta["n"])
        if self.imgs.shape[0] != n or self.ages.shape[0] != n:
            raise ValueError(f"{root}: meta.n={n} does not match arrays "
                             f"({self.imgs.shape[0]}, {self.ages.shape[0]})")
        if max_size and max_size > 0:
            self.imgs = self.imgs[:max_size]
            self.ages = self.ages[:max_size]
        # the canvas guard's surface (as UTKFaceDataset's): full resolution
        # unless packed with resize_to
        self.native = int(self.meta["size"])
        self.out_size = int(self.meta["size"])
        self.resized = int(self.meta.get("resize_to", 0)) > 0

    def __len__(self):
        return int(self.imgs.shape[0])

    def get_raw(self, i: int) -> Dict:
        return {"image": np.asarray(self.imgs[int(i)]),
                "age": int(self.ages[int(i)])}

    def get_raw_batch(self, idx, num_threads: int = 4) -> Dict:
        del num_threads  # no decode work; one gather
        ia = np.asarray(idx, np.int64)
        return {"image": np.asarray(self.imgs[ia]),
                "age": self.ages[ia].astype(np.int64)}
