"""PNG tiles + HTML results pages (counterpart of ``pcgan_tpu/utils/visualizer.py:17-94``).

PNGs are encoded with the standard library (``zlib`` + ``struct``). The
animated GIF/WebP of ``test.py --anim`` goes through Pillow, imported when
it is written, as in the JAX package.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Sequence

import numpy as np


def tensor_to_u8(img) -> np.ndarray:
    """(H,W,C) float in [-1,1] -> u8 RGB (reference util.tensor2im semantics)."""
    x = np.asarray(img, np.float32)
    x = (np.clip(x, -1.0, 1.0) + 1.0) * 127.5
    return np.round(x).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """(H,W) / (H,W,1) gray or (H,W,3) RGB u8 -> PNG bytes (8-bit, filter
    type 0 on every row)."""
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_png wants uint8, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[:, :, 0]
    if a.ndim == 2:
        color = 0
    elif a.ndim == 3 and a.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png: unsupported shape {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image(img, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = img if img.dtype == np.uint8 else tensor_to_u8(img)
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def save_animation(frames, path: str, duration_ms: int = 80):
    """frames: (T,H,W,C) float in [-1,1] (or u8) -> looping animated image.
    The extension picks the container: ``.gif`` (256-color quantized) or
    ``.webp`` (full color, needs a WebP-enabled Pillow)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "--anim writes its GIF/WebP through Pillow, which this host "
            "lacks; install Pillow or sample without --anim") from e
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(frames)
    ims = [Image.fromarray(f if f.dtype == np.uint8 else tensor_to_u8(f))
           for f in arr]
    if len(ims) < 2:
        raise ValueError(f"animation needs >= 2 frames, got {len(ims)}")
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=duration_ms, loop=0)


class HTMLPage:
    """Minimal HTML index of image rows (reference util/html.py surface)."""

    def __init__(self, web_dir: str, title: str):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.title = title
        self.rows: List = []

    def add_header(self, text: str):
        self.rows.append(("h", text))

    def add_images(self, ims: Sequence[str], txts: Sequence[str],
                   width: int = 256):
        self.rows.append(("imgs", list(zip(ims, txts)), width))

    def save(self):
        parts = [f"<!DOCTYPE html><html><head><title>{self.title}</title>"
                 "</head><body>"]
        for row in self.rows:
            if row[0] == "h":
                parts.append(f"<h3>{row[1]}</h3>")
            else:
                _, pairs, width = row
                parts.append("<table border='1' style='border-collapse:collapse'><tr>")
                for im, txt in pairs:
                    parts.append(
                        f"<td style='text-align:center'><img src='images/{im}' "
                        f"width='{width}'><br>{txt}</td>")
                parts.append("</tr></table>")
        parts.append("</body></html>")
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write("\n".join(parts))


def save_visuals_row(page: HTMLPage, name: str, visuals: Dict[str, np.ndarray],
                     width: int = 256):
    """visuals: label -> (H,W,C) float image in [-1,1]."""
    ims, txts = [], []
    for label, img in visuals.items():
        fn = f"{name}_{label}.png"
        save_image(img, os.path.join(page.img_dir, fn))
        ims.append(fn)
        txts.append(label)
    page.add_header(name)
    page.add_images(ims, txts, width)
