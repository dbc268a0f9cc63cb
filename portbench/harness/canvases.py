"""The benchmark's input faces: synthetic canvases made from the seed.

A frozen copy of the port's procedural faces (``data/synthetic.py``,
"easy" variant): per identity, three gaussian blobs a channel scaled to the
image's maximum, then an age law that darkens the face and adds a
high-frequency wrinkle texture, emitted as u8 at the data set's native
size, as a decoded JPEG would be. The copy draws every parameter for the
whole set in a few calls on the card (``torch.Generator`` there) and builds
the images in large batches, so a set of thousands of faces takes well
under a second; the result is copied to the host once, where the port's
``Loader`` reads it as a training or sampling run reads its decoded
images. The same seed gives the same canvases on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_AGE = 116


def make_canvases(n: int, native: int, seed: int, device,
                  max_age: int = MAX_AGE, chunk: int = 256):
    """``(images (n, native, native, 3) u8 numpy, ages (n,) int64 numpy)``."""
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    ages = torch.randint(1, min(90, max_age), (n,), generator=g,
                         device=device)
    # per image, channel and blob: centre (y, x), width and amplitude
    u = torch.rand((4, n, 3, 3), generator=g, device=device)
    cy, cx = 0.2 + 0.6 * u[0], 0.2 + 0.6 * u[1]
    s = 0.05 + 0.2 * u[2]
    a = 0.3 + 0.7 * u[3]
    ax = torch.arange(native, device=device, dtype=torch.float32) / native
    yy, xx = ax[:, None], ax[None, :]
    wrinkle = 0.5 + 0.5 * torch.sin(40 * np.pi * yy) * torch.sin(
        40 * np.pi * xx)
    out = torch.empty((n, native, native, 3), dtype=torch.uint8,
                      device=device)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        d2 = ((yy - cy[lo:hi, :, :, None, None]) ** 2
              + (xx - cx[lo:hi, :, :, None, None]) ** 2)
        sig = s[lo:hi, :, :, None, None]
        img = (a[lo:hi, :, :, None, None]
               * torch.exp(-d2 / (2 * sig * sig))).sum(dim=2)  # (c, 3, H, W)
        peak = img.flatten(1).amax(dim=1).clamp(min=1e-6)
        img = img / peak[:, None, None, None]
        t = (ages[lo:hi].float() / max_age)[:, None, None, None]
        img = img * (1.0 - 0.4 * t) + 0.35 * t * wrinkle
        out[lo:hi] = (img.clamp(0, 1) * 255).to(torch.uint8).permute(
            0, 2, 3, 1)
    return out.cpu().numpy(), ages.cpu().numpy().astype(np.int64)


class CanvasSet:
    """The port's data-set protocol over the canvases, as the ``Loader``
    reads it: ``__len__``, ``ages`` and ``get_raw_batch(idx)`` (one
    gather, as an in-memory pack serves a batch)."""

    def __init__(self, images: np.ndarray, ages: np.ndarray):
        self.images, self.ages = images, ages

    def __len__(self):
        return len(self.images)

    def get_raw_batch(self, idx, num_threads: int = 1):
        idx = np.asarray(idx)
        return {"image": self.images[idx], "age": self.ages[idx]}
