"""Python client for the serving host (counterpart of
``pcgan_tpu/client.py``; drives ``pcgan_tpu_torch.tools.serve_http`` and the
JAX package's host alike: the wire format is the same).

Stdlib + numpy only: an integrator's process needs neither torch nor model
code::

    from pcgan_tpu_torch.client import ServingClient
    c = ServingClient("http://127.0.0.1:8500")
    c.healthz()                          # artifact metadata
    fakes = c.generate(images, cond)     # (B,H,W,C) f32 in [-1,1]
    grid = c.progression(images)         # (B, n_conditions, H, W, C)
    c.reload("serving/utk128_v2")        # zero-downtime artifact swap

Wire format is the host's: request bodies are ``np.savez`` archives,
responses are single ``.npy`` payloads (``allow_pickle=False`` both ways —
no code-execution path). Non-2xx responses raise :class:`ServingError`
with the host's error text.
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.request
from typing import Optional

import numpy as np


class ServingError(RuntimeError):
    """Non-2xx response from the serving host (carries status + body)."""

    def __init__(self, status: int, body: str):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v, np.float32)
                     for k, v in arrays.items()})
    return buf.getvalue()


class ServingClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8500",
                 timeout: float = 120.0, auth_token: str = ""):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        # serve_http --auth_token: sent as 'Authorization: Bearer <token>'
        # on every request ("" = none)
        self.auth_token = auth_token

    # ---- plumbing -------------------------------------------------------- #

    def _request(self, path: str, body: Optional[bytes] = None,
                 content_type: str = "application/octet-stream") -> bytes:
        headers = {"Content-Type": content_type} if body else {}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        req = urllib.request.Request(
            self.base_url + path, data=body, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            raise ServingError(e.code,
                               e.read().decode("utf-8", "replace")) from None

    def _npy(self, raw: bytes) -> np.ndarray:
        return np.load(io.BytesIO(raw), allow_pickle=False)

    # ---- endpoints ------------------------------------------------------- #

    def healthz(self) -> dict:
        return json.loads(self._request("/healthz"))

    def stats(self) -> dict:
        return json.loads(self._request("/stats"))

    def metrics(self) -> str:
        """Prometheus text exposition (scrape surface)."""
        return self._request("/metrics").decode()

    def generate(self, images: np.ndarray, cond: np.ndarray) -> np.ndarray:
        """images (B,H,W,C) f32 in [-1,1]; cond (B,K) one-hot or (B,1)
        score — must match the artifact's conditioning (see healthz)."""
        return self._npy(self._request(
            "/generate", _npz_bytes(images=images, cond=cond)))

    def progression(self, images: np.ndarray) -> np.ndarray:
        """Full aging grid: (B, n_conditions, H, W, C)."""
        return self._npy(self._request(
            "/progression", _npz_bytes(images=images)))

    def generate_image(self, image_bytes: bytes, bin: Optional[int] = None,
                       score: Optional[float] = None) -> bytes:
        """Raw JPEG/PNG bytes in, PNG bytes of the aged face out (the host
        does the test-time transform). Pass ``bin`` for onehot artifacts or
        ``score`` in [-1, 1] for score-mode artifacts."""
        if (bin is None) == (score is None):
            raise ValueError("pass exactly one of bin= or score=")
        q = f"?bin={int(bin)}" if bin is not None else f"?score={score}"
        return self._request("/generate_image" + q, image_bytes,
                             "application/octet-stream")

    def progression_image(self, image_bytes: bytes) -> bytes:
        """Raw JPEG/PNG bytes in, PNG strip [input | aged@every condition]
        out."""
        return self._request("/progression_image", image_bytes,
                             "application/octet-stream")

    def progression_gif(self, image_bytes: bytes, frames: int = 24) -> bytes:
        """Raw JPEG/PNG bytes in, looping animated GIF of the SMOOTH aging
        sweep out (the serving twin of ``test.py --anim``)."""
        return self._request(f"/progression_gif?frames={int(frames)}",
                             image_bytes, "application/octet-stream")

    def reload(self, artifact_dir: Optional[str] = None) -> dict:
        """Hot-swap the served artifact (empty = re-read the current dir);
        returns the host's JSON ({"status": "reloaded", ...}). The host
        warms the incoming module before publishing; traffic keeps serving
        the old one during the load."""
        body = json.dumps(
            {"artifact_dir": artifact_dir} if artifact_dir else {}).encode()
        return json.loads(self._request("/reload", body, "application/json"))
