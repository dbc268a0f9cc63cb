"""The port's image decode against ``pcgan_tpu.native`` and Pillow.

The native libjpeg decoder (``pcgan_tpu_torch/native``) must give the JAX
package's decoder's bits and PIL's ``convert("RGB")`` bits exactly (4:2:0,
4:4:4, progressive, greyscale), report the same status codes, scale in the
DCT domain as the JAX decoder does (scale_num 4 and 6), and its header
probe must read PIL's size. The numpy PNG decoder must give PIL's bits for
all five row filters. Formats only PIL decodes raise, naming the file, when
Pillow is absent. The committed JPEG fixtures decode to ``digests.json``.
Tolerance everywhere: bit-identical. Skips only where g++ or libjpeg is
missing on this host.
"""

import ast
import glob
import hashlib
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from pcgan_tpu import native as jnative
from pcgan_tpu_torch import native
from pcgan_tpu_torch.data import utkface

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "torch_port_data")


@pytest.fixture(scope="module")
def decoders():
    """Both native decoders built, or the test skipped (no g++/libjpeg)."""
    try:
        native.load()
    except RuntimeError as e:
        pytest.skip(f"the port's JPEG decoder cannot be built here: {e}")
    if not jnative.available():
        pytest.skip("the JAX package's native decoder is unavailable")


def _rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _smooth(rng, h, w, c=3):
    """An image with structure (blobs + noise), so the DCT has work."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = np.zeros((h, w, c))
    for ch in range(c):
        cy, cx, s = rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8), 0.2
        out[..., ch] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    out = out * 200 + rng.normal(0, 12, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


JPEG_KINDS = {"420": dict(quality=90, subsampling=2),
              "444": dict(quality=90, subsampling=0),
              "progressive": dict(quality=85, progressive=True),
              "grey": dict(quality=90)}


def _jpegs(tmp_path, kind, n=3, size=(200, 200), seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        im = Image.fromarray(_smooth(rng, size[1], size[0]))
        if kind == "grey":
            im = im.convert("L")
        p = str(tmp_path / f"{20 + i}_0_0_{kind}{i}.jpg")
        im.save(p, **JPEG_KINDS[kind])
        paths.append(p)
    return paths


@pytest.mark.parametrize("kind", list(JPEG_KINDS))
def test_decode_matches_jax_and_pil(decoders, tmp_path, kind):
    paths = _jpegs(tmp_path, kind)
    got, st = native.decode_batch(paths, 200, 200, threads=2)
    want, jst = jnative.decode_batch(paths, 200, 200, threads=2)
    assert not st.any() and not jst.any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack([_rgb(p) for p in paths]))
    for i, p in enumerate(paths):              # one file against the batch
        one, s = native.decode_file(p, 200, 200)
        assert s == native.OK
        np.testing.assert_array_equal(one, got[i])
        np.testing.assert_array_equal(utkface.decode_image(p), got[i])


def test_status_codes_match_jax(decoders, tmp_path):
    good = _jpegs(tmp_path, "420", n=1)[0]
    small = str(tmp_path / "s.jpg")
    Image.fromarray(np.zeros((64, 48, 3), np.uint8)).save(small)
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"not a jpeg" * 8)
    cmyk = str(tmp_path / "c.jpg")
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (40, 40, 4), dtype=np.uint8), "CMYK").save(cmyk)
    paths = [small, bad, str(tmp_path / "missing.jpg"), cmyk, good]
    got, st = native.decode_batch(paths, 200, 200, threads=3)
    want, jst = jnative.decode_batch(paths, 200, 200, threads=3)
    assert list(st) == list(jst) == [native.E_DIMS, native.E_DECODE,
                                     native.E_OPEN, native.E_COLOR, native.OK]
    np.testing.assert_array_equal(got[4], want[4])
    assert native.decode_file(small, 200, 200)[1] == native.E_DIMS
    assert native.decode_file(small, 64, 48)[1] == native.OK


@pytest.mark.parametrize("scale_num", [4, 6])
def test_dct_scaled_decode_matches_jax(decoders, tmp_path, scale_num):
    paths = _jpegs(tmp_path, "420")
    side = -(-200 * scale_num // 8)
    got, st = native.decode_batch(paths, side, side, scale_num=scale_num)
    want, jst = jnative.decode_batch(paths, side, side, scale_num=scale_num)
    assert not st.any() and not jst.any()
    np.testing.assert_array_equal(got, want)
    if scale_num == 4:        # a power of two: PIL's draft is the same scale
        with Image.open(paths[0]) as im:
            im.draft("RGB", (side, side))
            np.testing.assert_array_equal(got[0],
                                          np.asarray(im.convert("RGB")))


@pytest.mark.parametrize("size,kind", [((200, 200), "420"),
                                       ((180, 220), "444"),
                                       ((250, 131), "progressive"),
                                       ((33, 47), "grey")])
def test_header_probe_matches_pil(decoders, tmp_path, size, kind):
    p = _jpegs(tmp_path, kind, n=1, size=size)[0]
    st, w, h, cs = native.probe(p)
    with Image.open(p) as im:
        assert (st, (w, h)) == (native.OK, im.size)
    assert cs == (native.JCS_GRAYSCALE if kind == "grey" else native.JCS_YCbCr)
    assert utkface.image_size(p) == size
    cmyk = str(tmp_path / "c.jpg")
    Image.new("CMYK", (31, 17), (1, 2, 3, 4)).save(cmyk)
    assert native.probe(cmyk)[1:] == (31, 17, native.JCS_CMYK)
    assert native.probe(str(tmp_path / "nope.jpg"))[0] == native.E_OPEN
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff" + b"\x00" * 40)
    assert native.probe(str(bad))[0] == native.E_DECODE


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_png(path, px, ctype, filters, interlace=0, depth=8):
    """A PNG whose row y uses filter ``filters[y % len(filters)]``."""
    h, w = px.shape[:2]
    bpp = 1 if px.ndim == 2 else px.shape[2]
    raw = px.reshape(h, w * bpp).astype(np.int64)
    prior = np.zeros(w * bpp, np.int64)
    rows = []
    for y in range(h):
        f, cur = filters[y % len(filters)], raw[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        pred = [0, left, prior, (left + prior) // 2,
                _paeth(left, prior, upleft)][f]
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,channels", [(0, 1), (2, 3), (6, 4)])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]])
def test_png_decoder_matches_pil(tmp_path, ctype, channels, filters):
    rng = np.random.default_rng(ctype * 10 + len(filters))
    px = _smooth(rng, 23, 31, channels)
    if channels == 1:
        px = px[..., 0]
    p = str(tmp_path / "x.png")
    _write_png(p, px, ctype, filters)
    got = utkface.decode_png(p)
    assert got is not None and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _rgb(p))
    np.testing.assert_array_equal(utkface.decode_image(p), got)
    assert utkface.image_size(p) == (31, 23)


def test_png_saved_by_pil_and_unsupported_pngs(tmp_path):
    rng = np.random.default_rng(3)
    p = str(tmp_path / "pil.png")
    Image.fromarray(_smooth(rng, 40, 50)).save(p)
    np.testing.assert_array_equal(utkface.decode_png(p), _rgb(p))
    pal = str(tmp_path / "pal.png")
    Image.fromarray(_smooth(rng, 20, 20)).convert("P").save(pal)
    interlaced = str(tmp_path / "i.png")
    _write_png(interlaced, _smooth(rng, 8, 8), 2, [0], interlace=1)
    for q in (pal, interlaced):
        assert utkface.decode_png(q) is None
    # PIL decodes the palette PNG for the port
    np.testing.assert_array_equal(utkface.decode_image(pal), _rgb(pal))


def test_pil_only_formats_raise_without_pil(decoders, tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    bmp = str(tmp_path / "30_0_0_x.bmp")
    Image.fromarray(_smooth(rng, 20, 24)).save(bmp)
    cmyk = str(tmp_path / "31_0_0_c.jpg")
    Image.fromarray(rng.integers(0, 256, (20, 24, 4), dtype=np.uint8),
                    "CMYK").save(cmyk)
    # with Pillow, the PIL route gives PIL's bits
    for p in (bmp, cmyk):
        np.testing.assert_array_equal(utkface.decode_image(p), _rgb(p))
    jpg = _jpegs(tmp_path, "420", n=1)[0]
    png = str(tmp_path / "p.png")
    _write_png(png, _smooth(rng, 9, 9), 2, [4])
    monkeypatch.setitem(sys.modules, "PIL", None)
    for p in (bmp, cmyk):
        with pytest.raises(RuntimeError, match=os.path.basename(p)):
            utkface.decode_image(p)
    with pytest.raises(RuntimeError, match="30_0_0_x.bmp"):
        utkface.image_size(bmp)
    # JPEG and PNG need no Pillow
    assert utkface.decode_image(jpg).shape == (200, 200, 3)
    assert utkface.decode_image(png).shape == (9, 9, 3)


def test_missing_libjpeg_raises_naming_it_and_pngs_need_none(tmp_path,
                                                             monkeypatch):
    """A host without libjpeg: the decoder raises JpegUnavailable naming
    jpeglib.h, or libjpeg.so for a library built elsewhere (another build
    failure stays a plain RuntimeError), a JPEG
    folder raises it, and a PNG folder decodes without ever building the
    decoder, to PIL's bits (a PNG off the canvas: PIL's decode, resized by
    Pillow's bicubic)."""
    from pcgan_tpu_torch.ops import _build

    def build_fails(msg):
        def build_host(name, path):
            raise RuntimeError(f"g++ failed on {path} (exit 1):\n{msg}")
        return build_host
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "build_host", build_fails(
        "jpeg_decoder.cc:20:10: error: expected ';' before '}' token"))
    with pytest.raises(RuntimeError, match="expected ';'") as err:
        native.load()
    assert not isinstance(err.value, native.JpegUnavailable)

    def no_libjpeg_so(path):
        raise OSError("libjpeg.so.62: cannot open shared object file: No "
                      "such file or directory")
    # a library built on another host, where libjpeg.so is missing here
    monkeypatch.setattr(_build, "build_host", lambda name, path: "x.so")
    monkeypatch.setattr(native.ctypes, "CDLL", no_libjpeg_so)
    with pytest.raises(native.JpegUnavailable, match="libjpeg.so.62"):
        native.load()
    monkeypatch.setattr(_build, "build_host", build_fails(
        "jpeg_decoder.cc:20:10: fatal error: jpeglib.h: No such file or "
        "directory"))
    with pytest.raises(native.JpegUnavailable, match="jpeglib.h"):
        native.load()
    rng = np.random.default_rng(6)
    pngs = tmp_path / "pngs"
    pngs.mkdir()
    for i, (size, filters) in enumerate([((200, 200), [0]),
                                         ((200, 200), [0, 1, 2, 3, 4]),
                                         ((150, 170), [4])]):
        _write_png(str(pngs / f"{30 + i}_0_0_p{i}.png"),
                   _smooth(rng, *size), 2, filters)
    ds = utkface.UTKFaceDataset(str(pngs))
    batch = ds.get_raw_batch(np.arange(3), num_threads=2)
    for i, p in enumerate(ds.paths):
        with Image.open(p) as im:
            want = np.asarray(im.convert("RGB").resize((200, 200),
                                                       Image.BICUBIC))
        np.testing.assert_array_equal(batch["image"][i], want)
        np.testing.assert_array_equal(ds.get_raw(i)["image"], want)
    assert list(batch["age"]) == [30, 31, 32]
    jpegs = tmp_path / "jpegs"
    jpegs.mkdir()
    _jpegs(jpegs, "420", n=1)
    with pytest.raises(native.JpegUnavailable, match="jpeglib.h"):
        utkface.UTKFaceDataset(str(jpegs)).get_raw_batch([0])


def test_wheel_libjpeg_route_decodes_the_fixtures_to_their_digests(
        monkeypatch):
    """A host without libjpeg builds the decoder against the ABI-62 headers
    vendored in ``native/include`` and links the libjpeg of Pillow's wheel
    (a newer libjpeg-turbo behind the same 6.2 API: its struct-size and
    version check in ``jpeg_CreateDecompress`` must pass). The fixtures then
    decode to ``digests.json`` bit for bit, and ``auto`` takes this route
    when g++ reports no libjpeg."""
    import ctypes
    import shutil
    from pcgan_tpu_torch.ops import _build
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    lib = _build.wheel_libjpeg()
    if not lib:
        pytest.skip("Pillow's wheel carries no libjpeg-*.so.62* here")
    assert os.path.basename(lib).startswith("libjpeg-")
    flags, libs = _build.wheel_jpeg_args(lib)
    assert _build.VENDORED_JPEG_INCLUDE in flags and "-ljpeg" not in libs
    for h in ("jpeglib.h", "jmorecfg.h", "jconfig.h", "LICENSE.md"):
        assert os.path.isfile(os.path.join(_build.VENDORED_JPEG_INCLUDE, h))
    path = _build.build_host("pcgan_jpeg", "native/jpeg_decoder.cc",
                             libjpeg="wheel")
    assert path.endswith(".so") and "_wheel_" in os.path.basename(path)
    monkeypatch.setattr(native, "_lib", native.bind(ctypes.CDLL(path)))
    assert native.jpeg_abi() == 62
    meta, paths = _fixtures()
    port, st = native.decode_batch(list(paths.values()), 200, 200, threads=4)
    assert not st.any()
    for img, name in zip(port, paths):
        assert (hashlib.sha256(img.tobytes()).hexdigest()
                == meta["files"][name]["sha256"]), name
    # auto: the system build fails on a missing libjpeg -> the wheel route
    real = _build._compile

    def no_system_libjpeg(name, src, compiler, fl, lb=()):
        if "-ljpeg" in lb:
            raise RuntimeError("g++ failed: fatal error: jpeglib.h: No such "
                               "file or directory")
        return real(name, src, compiler, fl, lb)
    monkeypatch.setattr(_build, "_compile", no_system_libjpeg)
    assert _build.build_host("pcgan_jpeg", "native/jpeg_decoder.cc") == path
    monkeypatch.setattr(_build, "wheel_libjpeg", lambda: "")
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        _build.build_host("pcgan_jpeg", "native/jpeg_decoder.cc")


def test_no_port_module_imports_pil_at_module_level():
    """PIL is imported only inside the functions that need it."""
    files = sorted(glob.glob(os.path.join(ROOT, "pcgan_tpu_torch", "**",
                                          "*.py"), recursive=True))
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n == "PIL" or n.startswith("PIL.")
                           for n in names), path


def _fixtures():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        meta = json.load(f)
    return meta, {n: os.path.join(FIXTURES, "faces", n) for n in meta["files"]}


def test_fixtures_match_their_digests(decoders):
    meta, paths = _fixtures()
    files = meta["files"]
    assert len(files) == 32
    assert sorted(os.listdir(os.path.join(FIXTURES, "faces"))) == sorted(files)
    assert {v["kind"] for v in files.values()} == {
        "baseline 4:2:0", "greyscale", "progressive 4:2:0"}
    port, st = native.decode_batch(list(paths.values()), 200, 200)
    assert not st.any()
    for img, (name, p) in zip(port, paths.items()):
        rec = files[name]
        pil = _rgb(p)
        assert list(pil.shape) == rec["shape"]
        assert hashlib.sha256(pil.tobytes()).hexdigest() == rec["sha256"]
        assert hashlib.sha256(img.tobytes()).hexdigest() == rec["sha256"]
        assert utkface.parse_age(name) is not None
