"""Regenerate the JPEG fixtures in ``faces/`` and their ``digests.json``.

    python tests/torch_port_data/make_faces.py

32 UTKFace-named JPEGs (``{age}_{gender}_{race}_{YYYYMMDDhhmmssfff}.jpg``),
200 px, quality 90, made by Pillow from ``pcgan_tpu_torch``'s seeded
synthetic canvases (seed 5), each named with its own canvas's age. Image 30
is saved greyscale and image 31 progressive; the rest are baseline 4:2:0.

``digests.json`` holds, per file, the sha256 of Pillow's
``convert("RGB")`` decode: the port's decoder must give the same bits.
``canvases()`` gives the fixtures' source images without Pillow:
``chip_smoke.py`` writes them as PNGs on a host that has no libjpeg.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from pcgan_tpu_torch.data.synthetic import SyntheticAgingDataset  # noqa: E402

N, SEED, QUALITY = 32, 5, 90
GREY, PROGRESSIVE = N - 2, N - 1


def canvases():
    """(UTKFace file stem, u8 image, kind) of each fixture in order: the
    seeded synthetic canvases, image GREY as Pillow's ``convert("L")``
    computes it (ITU-R 601-2 luma in 16-bit fixed point)."""
    ds = SyntheticAgingDataset(size=N, seed=SEED)
    rng = np.random.default_rng(SEED)
    for i in range(N):
        row = ds.get_raw(i)
        gender, race = int(rng.integers(0, 2)), int(rng.integers(0, 5))
        stamp = (f"2017{1 + i % 12:02d}{1 + i % 28:02d}"
                 f"{int(rng.integers(0, 10**9)):09d}")
        img, kind = row["image"], "baseline 4:2:0"
        if i == GREY:
            r, g, b = (img[..., c].astype(np.int64) for c in range(3))
            img = ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
                np.uint8)
            kind = "greyscale"
        if i == PROGRESSIVE:
            kind = "progressive 4:2:0"
        yield f"{row['age']}_{gender}_{race}_{stamp}", img, kind


def main() -> None:
    from PIL import Image
    out = os.path.join(HERE, "faces")
    os.makedirs(out, exist_ok=True)
    for old in os.listdir(out):
        os.remove(os.path.join(out, old))
    digests = {}
    for stem, img, kind in canvases():
        name = f"{stem}.jpg"
        path = os.path.join(out, name)
        Image.fromarray(img).save(path, quality=QUALITY,
                                  progressive=kind.startswith("progressive"))
        with Image.open(path) as f:
            rgb = np.asarray(f.convert("RGB"), np.uint8)
        digests[name] = {
            "kind": kind,
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "shape": list(rgb.shape),
        }
    meta = {"made_by": "tests/torch_port_data/make_faces.py",
            "decoder": "Pillow convert('RGB')", "files": digests}
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(out, n)) for n in digests)
    print(f"wrote {len(digests)} JPEGs ({total} bytes) to {out}")


if __name__ == "__main__":
    main()
