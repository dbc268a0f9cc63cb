"""UTKFace-style image folders and the port's image decode (counterpart of
``pcgan_tpu/data/utkface.py``).

Ages come from the UTKFace file name ``{age}_{gender}_{race}_{datetime}
.jpg``. A folder decodes on the host to fixed-size u8 canvases; resize,
crop, flip and normalization run on the device (ops/preprocess.py).

Decoding needs no Pillow for what a face folder holds:

- JPEG (baseline, progressive, greyscale) through the native libjpeg
  decoder (``pcgan_tpu_torch/native``), bit-identical to PIL's
  ``convert("RGB")``; a header probe replaces PIL's header-only open;
- 8-bit non-interlaced grey, RGB and RGBA PNG through a numpy decoder
  (zlib and the five row filters), ``decode_png``;
- an image off the canvas is decoded at its own size and resized by
  ``pil_resize_np`` (bicubic), Pillow's 8-bit resize in numpy.

Only CMYK/YCCK JPEGs and other formats (BMP, WebP, palette, 16-bit or
interlaced PNG) go to PIL, imported when such a file is met; without Pillow
they raise, naming the file.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from pcgan_tpu_torch.data.resample import pil_resize_np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
_JPEG_MAGIC = b"\xff\xd8\xff"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def parse_age(filename: str) -> Optional[int]:
    head = os.path.basename(filename).split("_")[0]
    try:
        age = int(head)
    except ValueError:
        return None
    return age if 0 <= age <= 120 else None


def list_images(root: str, max_size: int = -1) -> List[str]:
    out = []
    for dirpath, _, names in sorted(os.walk(root)):
        for n in sorted(names):
            if n.lower().endswith(IMG_EXTENSIONS):
                out.append(os.path.join(dirpath, n))
    if max_size and max_size > 0:
        out = out[:max_size]
    return out


# --------------------------------------------------------------------------- #
# decoding
# --------------------------------------------------------------------------- #


def sniff(path: str) -> str:
    """'jpeg', 'png' or 'other', from the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(_JPEG_MAGIC):
        return "jpeg"
    return "png" if head == _PNG_MAGIC else "other"


def _pil():
    from PIL import Image
    return Image


def _pil_decode(path: str) -> np.ndarray:
    """The PIL route for CMYK JPEGs and formats the port does not decode."""
    try:
        Image = _pil()
    except ImportError:
        raise RuntimeError(
            f"{path}: not a JPEG in grey, RGB or YCbCr nor an 8-bit "
            f"non-interlaced grey/RGB/RGBA PNG; decoding it needs Pillow, "
            f"which is not installed") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _png_chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        yield data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _png_header(path: str):
    with open(path, "rb") as f:
        data = f.read(33)
    if not data.startswith(_PNG_MAGIC) or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG")
    return struct.unpack(">IIBBBBB", data[16:29])


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The five PNG row filters undone, row by row (PNG spec section 9)."""
    rows = raw.reshape(h, stride + 1)
    if not rows[:, 0].any():    # no filter on any row: nothing to undo
        return rows[:, 1:]
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:      # Sub: a running sum over the pixels, mod 256
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.int64),
                            axis=0).astype(np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: byte by byte
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) u8 RGB of an 8-bit non-interlaced grey, RGB or RGBA PNG, as
    PIL's ``convert("RGB")`` gives it (grey replicated, alpha dropped); None
    for any other PNG."""
    w, h, depth, ctype, _, _, interlace = _png_header(path)
    channels = {0: 1, 2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace != 0:
        return None
    with open(path, "rb") as f:
        data = f.read()
    idat = b"".join(body for kind, body in _png_chunks(data)
                    if kind == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    px = _unfilter(raw[:h * (w * channels + 1)], h, w * channels,
                   channels).reshape(h, w, channels)
    if channels == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) from the header alone: the native probe for a JPEG,
    IHDR for a PNG, PIL's lazy open otherwise."""
    kind = sniff(path)
    if kind == "jpeg":
        from pcgan_tpu_torch import native
        st, w, h, _ = native.probe(path)
        if st != native.OK:
            raise ValueError(f"{path}: unreadable JPEG header")
        return w, h
    if kind == "png":
        w, h = _png_header(path)[:2]
        return w, h
    try:
        Image = _pil()
    except ImportError:
        raise RuntimeError(f"{path}: reading this format needs Pillow, "
                           f"which is not installed") from None
    with Image.open(path) as im:
        return im.size


def decode_image(path: str) -> np.ndarray:
    """(H, W, 3) u8 RGB at the image's own size, bit-identical to
    ``PIL.Image.open(path).convert("RGB")``."""
    kind = sniff(path)
    if kind == "jpeg":
        from pcgan_tpu_torch import native
        st, w, h, cs = native.probe(path)
        if st != native.OK:
            raise ValueError(f"{path}: unreadable JPEG header")
        if cs not in (native.JCS_CMYK, native.JCS_YCCK):
            img, st = native.decode_file(path, h, w)
            if st != native.OK:
                raise ValueError(f"{path}: corrupt JPEG (decoder status "
                                 f"{st})")
            return img
    elif kind == "png":
        img = decode_png(path)
        if img is not None:
            return img
    return _pil_decode(path)


def load_canvas(path: str, size: int) -> np.ndarray:
    """The image on a (size, size) canvas: decoded, then resized bicubic
    when its size differs (``_ImageLoaderMixin._decode`` of the JAX
    package)."""
    return pil_resize_np(decode_image(path), size, "bicubic")


def probe_native_size(paths: List[str], cap: int = 0,
                      default: int = 200) -> int:
    """The host-decode canvas: the smaller side of the first readable image
    among the first 64 (header only). Uniform folders (aligned UTKFace 200,
    CACD 250) then decode onto their own canvas with no host resample.
    ``cap`` > 0 bounds the canvas; ``default`` when nothing is readable."""
    for p in paths[:64]:
        try:
            w, h = image_size(p)
        except (OSError, ValueError):
            continue
        n = max(1, min(w, h))
        return min(n, cap) if cap and cap > 0 else n
    return default


# --------------------------------------------------------------------------- #
# the folder dataset
# --------------------------------------------------------------------------- #


class UTKFaceDataset:
    """Protocol: __len__, ages, get_raw(i) -> {'image': u8 (out_size,
    out_size, 3), 'age': int}, get_raw_batch(idx) (one native call a
    batch).

    ``decode_m``/8 is libjpeg's DCT-domain downscale (``--host_decode_m``,
    not PIL-exact below 8): the canvas becomes ceil(native * m / 8).
    """

    def __init__(self, root: str, native: int = 200, max_size: int = -1,
                 require_age: bool = True, decode_m: int = 8,
                 native_cap: int = 0):
        self.decode_m = max(1, min(8, int(decode_m)))
        paths = list_images(root, -1)
        # native 0 (--native_size 0): the folder's own canvas
        self.native = int(native) if native and native > 0 else (
            probe_native_size(paths, cap=native_cap))
        self.out_size = -(-self.native * self.decode_m // 8)
        items: List[Tuple[str, int]] = []
        for p in paths:
            age = parse_age(p)
            if age is None:
                if require_age:
                    continue
                age = 0
            items.append((p, age))
        if max_size and max_size > 0:
            items = items[:max_size]
        if not items:
            raise FileNotFoundError(
                f"no labeled images under {root} (expected UTKFace-style "
                f"'age_*.jpg' names)")
        self.paths = [p for p, _ in items]
        self.ages = np.array([a for _, a in items], np.int64)

    def __len__(self):
        return len(self.paths)

    def _off_canvas(self, p: str) -> np.ndarray:
        """An image the native decode did not serve (another size, CMYK, a
        PNG or another format): decoded at its own size, then resized
        bicubic to the canvas. A JPEG at ``decode_m < 8`` takes the JAX
        package's route (``pcgan_tpu/data/utkface.py:123-130``): PIL's
        ``draft`` to the nearest power-of-two DCT scale at or above the
        canvas, then the bicubic resize (an approximation of libjpeg's
        m/8 scale, as there)."""
        if self.decode_m < 8 and sniff(p) == "jpeg":
            s = self.out_size
            with _pil().open(p) as im:
                im.draft("RGB", (s, s))
                img = np.asarray(im.convert("RGB"), np.uint8)
            return pil_resize_np(img, s, "bicubic")
        return pil_resize_np(decode_image(p), self.out_size, "bicubic")

    def get_raw(self, i: int):
        p = self.paths[i]
        img = None
        if _is_jpeg_name(p):
            from pcgan_tpu_torch import native
            img, st = native.decode_file(p, self.out_size, self.out_size,
                                         scale_num=self.decode_m)
            if st != native.OK:
                img = None
        if img is None:
            img = self._off_canvas(p)
        return {"image": img, "age": int(self.ages[i])}

    def get_raw_batch(self, idx, num_threads: int = 8):
        """The batch's JPEGs in one call of the native thread pool; every
        other file and each JPEG it reports (off the canvas, CMYK) is filled
        by ``get_raw``'s route on ``num_threads`` threads, so the batch
        equals ``get_raw`` image by image."""
        idx = np.asarray(idx, np.int64)
        paths = [self.paths[int(i)] for i in idx]
        s = self.out_size
        imgs = np.empty((len(paths), s, s, 3), np.uint8)
        jpeg = np.array([_is_jpeg_name(p) for p in paths], bool)
        redo = list(np.nonzero(~jpeg)[0])
        if jpeg.any():
            from pcgan_tpu_torch import native
            sub, status = native.decode_batch(
                [p for p, j in zip(paths, jpeg) if j], s, s,
                threads=num_threads, scale_num=self.decode_m,
                out=imgs if jpeg.all() else None)
            if not jpeg.all():
                imgs[jpeg] = sub
            redo += list(np.nonzero(jpeg)[0][status != native.OK])
        if redo:
            with ThreadPoolExecutor(max(1, num_threads)) as pool:
                for j, img in zip(redo, pool.map(
                        self._off_canvas, [paths[j] for j in redo])):
                    imgs[j] = img
        return {"image": imgs, "age": self.ages[idx].astype(np.int64)}


def _is_jpeg_name(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))
