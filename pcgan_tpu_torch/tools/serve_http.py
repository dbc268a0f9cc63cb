"""Serving host for an exported generator artifact (counterpart of the root
``tools/serve_http.py``; ``pcgan_tpu_torch/serving.py`` holds the format,
``pcgan_tpu_torch.tools.export_serving`` writes it)::

    python -m pcgan_tpu_torch.tools.serve_http --artifact_dir serving/utk128 \
        --port 8500 --warmup_batch 8 --batch_window_ms 5

Stdlib-only HTTP front (ThreadingHTTPServer) over the ``torch.export``
program on ``--device`` (cuda unless cpu): the host needs torch + numpy,
no model code. The routes, the wire format and the hardening are the JAX
host's:

    POST /generate     body: .npz {images (B,H,W,C) f32 [-1,1], cond (B,K)}
                       -> .npy fakes (B,H,W,C) f32
    POST /progression  body: .npz {images}
                       -> .npy grid (B, n_conditions, H, W, C) f32
    POST /generate_image?bin=K | ?score=S
                       body: raw JPEG/PNG bytes -> PNG of the aged face
                       (decode, shorter-side resize + center crop to the
                       artifact's crop_size on the host; needs Pillow)
    POST /progression_image
                       body: raw JPEG/PNG bytes -> PNG strip
                       [input | aged@cond_0 | ... | aged@cond_{K-1}]
    POST /progression_gif?frames=N
                       body: raw JPEG/PNG bytes -> looping animated GIF of
                       the SMOOTH aging sweep (default 24 frames; the
                       serving twin of test.py --anim)
    GET  /             -> self-contained HTML demo page (drives the raw
                       image routes from a browser; adapts to cond_mode)
    GET  /healthz      -> JSON artifact metadata
    GET  /metrics      -> Prometheus text format (scrape-ready counters)
    POST /reload       body: JSON {"artifact_dir": path} (or empty = re-read
                       the current dir) -> hot-swaps the served artifact;
                       traffic keeps serving the old module during the load

Payloads are numpy's own serialization (np.savez/np.load,
allow_pickle=False: no code execution path). Dispatch is serialized
through a lock: one card, one program; HTTP threads only overlap
parsing/IO. ``--batch_window_ms W`` turns on request coalescing:
concurrent requests within the window fuse into ONE device dispatch,
padded to power-of-two buckets (at most log2(max_batch) distinct batch
sizes reach the card). ``--fixed_batch`` exports instead pad and slice
every request to one shape.

``--watch_seconds N`` polls the artifact dir and hot-swaps automatically
when a re-export lands (meta.json is written last by the exporter, so its
mtime marks a complete artifact): the continuous-deployment twin of
POST /reload; a failed load keeps the old program serving.

Auth: ``--auth_token TOKEN`` (or env PCGAN_SERVE_TOKEN) requires
``Authorization: Bearer TOKEN`` on every route except GET / (demo page —
it has a token field) and GET /healthz (load-balancer readiness probes
stay unauthenticated by convention); comparison is constant-time. No TLS
(terminate at a fronting proxy); binds 127.0.0.1 by default.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import threading
import time

import numpy as np


def _load_npz(body: bytes, *names):
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        missing = [n for n in names if n not in z]
        if missing:
            raise KeyError(f"request .npz missing arrays: {missing}")
        return [np.asarray(z[n], np.float32) for n in names]


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, np.float32), allow_pickle=False)
    return buf.getvalue()


def _pil():
    """The image endpoints are the only Pillow consumers; the npz/npy API
    keeps working on hosts without it."""
    try:
        from PIL import Image
        return Image
    except ImportError as e:
        raise ValueError(
            "the */_image endpoints need Pillow on the serving host; "
            "use the .npz /generate and /progression routes instead") from e


# decompression-bomb guard for the raw-image routes: PIL parses the header
# lazily, so the dimensions are known BEFORE any pixel buffer allocates —
# reject oversized canvases there (a tiny PNG/JPEG body can declare a
# multi-GiB canvas). 16 MPix comfortably covers any real photo upload.
_MAX_IMAGE_PIXELS = 16_000_000


def _decode_image_body(body: bytes, meta: dict) -> np.ndarray:
    """Raw JPEG/PNG bytes -> (1, S, S, 3) f32 in [-1, 1]: shorter side
    bicubic-resized to the artifact's crop_size, then center-cropped — the
    test-time transform family (sample.py eval convention)."""
    Image = _pil()
    if int(meta["input_nc"]) != 3:
        raise ValueError("image endpoints serve 3-channel artifacts only")
    try:
        img = Image.open(io.BytesIO(body))
        w, h = img.size               # header-only — nothing decoded yet
        if w * h > _MAX_IMAGE_PIXELS:
            raise ValueError(
                f"image dimensions {w}x{h} exceed the "
                f"{_MAX_IMAGE_PIXELS}-pixel limit")
        img.load()
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"request body is not a decodable image: {e}") from e
    img = img.convert("RGB")
    s = int(meta["crop_size"])
    w, h = img.size
    scale = s / min(w, h)
    img = img.resize((max(s, round(w * scale)), max(s, round(h * scale))),
                     Image.Resampling.BICUBIC)
    w, h = img.size
    left, top = (w - s) // 2, (h - s) // 2
    img = img.crop((left, top, left + s, top + s))
    return (np.asarray(img, np.float32) / 127.5 - 1.0)[None]


def _png_bytes(arr: np.ndarray) -> bytes:
    """(H, W, C) f32 [-1, 1] -> PNG bytes."""
    Image = _pil()
    u8 = np.clip((np.asarray(arr, np.float32) + 1.0) * 127.5 + 0.5,
                 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, "PNG")
    return buf.getvalue()


def _gif_bytes(frames: np.ndarray, duration_ms: int = 80) -> bytes:
    """(T, H, W, C) f32 [-1, 1] -> looping animated GIF bytes."""
    Image = _pil()
    u8 = np.clip((np.asarray(frames, np.float32) + 1.0) * 127.5 + 0.5,
                 0, 255).astype(np.uint8)
    ims = [Image.fromarray(f) for f in u8]
    buf = io.BytesIO()
    ims[0].save(buf, "GIF", save_all=True, append_images=ims[1:],
                duration=duration_ms, loop=0)
    return buf.getvalue()


def _cond_from_query(query: str, served) -> np.ndarray:
    """?bin=K (onehot artifacts) or ?score=S in [-1,1] (score artifacts)
    -> a (1, cond_nc) condition row."""
    from urllib.parse import parse_qs
    q = parse_qs(query)
    mode = served.meta["cond_mode"]
    if "score" in q:
        if mode != "score":
            raise ValueError("?score= needs a score-mode artifact; this one "
                             "is onehot — use ?bin=K")
        s = float(q["score"][0])
        if not -1.0 <= s <= 1.0:
            raise ValueError(f"score must be in [-1, 1]; got {s}")
        return np.array([[s]], np.float32)
    if "bin" in q:
        if mode == "score":
            raise ValueError("?bin= needs a onehot artifact; this one is "
                             "score-mode — use ?score=S")
        nb = int(served.meta["n_age_bins"])
        k = int(q["bin"][0])
        if not 0 <= k < nb:
            raise ValueError(f"bin must be in [0, {nb}); got {k}")
        return served.all_conditions()[k:k + 1]
    raise ValueError("generate_image needs ?bin=K (onehot) or ?score=S "
                     "(score-mode)")


class Batcher:
    """Request coalescing: concurrent /generate and /progression calls that
    arrive within ``window_ms`` fuse into ONE device dispatch (a larger
    batch costs the card little more; each dispatch costs its launches and
    copies). Cohorts are capped at ``max_rows`` fused rows and pad up to
    power-of-two buckets, so the card sees at most
    log2(max(max_rows, largest single request)) batch sizes instead of one
    per distinct request-mix size."""

    def __init__(self, window_ms: float, max_rows: int = 256):
        self._window = window_ms / 1e3
        self._max_rows = max_rows
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue = []                    # (images, cond, event, slot)
        self.dispatches = 0                 # device-call counter (stats)
        threading.Thread(target=self._run, daemon=True).start()

    def submit(self, images: np.ndarray, cond: np.ndarray,
               served) -> np.ndarray:
        # each request carries the module it was VALIDATED against; cohorts
        # only fuse same-module requests, so a POST /reload mid-window can
        # never concatenate payloads shaped for different artifacts
        ev = threading.Event()
        slot = {}
        with self._cv:
            self._queue.append((images, cond, ev, slot, served))
            self._cv.notify()
        ev.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["out"]

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _take_cohort(self):
        """Pop requests until the ROW budget is spent (always at least one,
        so a single oversize request still serves — alone)."""
        cohort, rows = [], 0
        while self._queue:
            k = self._queue[0][0].shape[0]
            if cohort and (rows + k > self._max_rows
                           or self._queue[0][4] is not cohort[0][4]):
                break
            cohort.append(self._queue.pop(0))
            rows += k
        return cohort

    def _run(self):
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
            time.sleep(self._window)        # coalescing window
            with self._cv:
                batch = self._take_cohort()
            sizes = [b[0].shape[0] for b in batch]
            try:
                imgs = np.concatenate([b[0] for b in batch], axis=0)
                conds = np.concatenate([b[1] for b in batch], axis=0)
                n = imgs.shape[0]
                pad = self._bucket(n) - n
                if pad:
                    imgs = np.concatenate(
                        [imgs, np.repeat(imgs[-1:], pad, axis=0)], axis=0)
                    conds = np.concatenate(
                        [conds, np.repeat(conds[-1:], pad, axis=0)], axis=0)
                out = batch[0][4](imgs, conds)[:n]
                self.dispatches += 1
                at = 0
                for (_, _, ev, slot, _s), k in zip(batch, sizes):
                    slot["out"] = out[at:at + k]
                    at += k
                    ev.set()
            except Exception as e:
                for _, _, ev, slot, _s in batch:
                    slot["err"] = e
                    ev.set()


_DEMO_HTML = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>pcgan_tpu_torch — aging demo</title>
<style>
  :root { color-scheme: light dark; }
  body { font: 15px/1.5 system-ui, sans-serif; max-width: 720px;
         margin: 2rem auto; padding: 0 1rem; }
  h1 { font-size: 1.3rem; } code { font-size: .85em; }
  fieldset { border: 1px solid #8884; border-radius: 8px;
             margin: 1rem 0; padding: .75rem 1rem; }
  label { margin-right: 1rem; }
  #result img { max-width: 100%; border-radius: 6px; margin-top: 1rem; }
  #status { color: #888; min-height: 1.5em; }
  button { padding: .4rem 1rem; }
</style></head><body>
<h1>pcgan_tpu_torch aging demo</h1>
<p id="meta">loading artifact metadata…</p>
<fieldset>
  <legend>input face</legend>
  <input type="file" id="file" accept="image/jpeg,image/png">
  <input type="password" id="token" placeholder="auth token (if required)"
         autocomplete="off" style="margin-left:1rem">
</fieldset>
<fieldset>
  <legend>mode</legend>
  <label><input type="radio" name="mode" value="single" checked> single age</label>
  <label><input type="radio" name="mode" value="strip"> progression strip</label>
  <label><input type="radio" name="mode" value="gif"> animated sweep</label>
  <div id="condrow" style="margin-top:.5rem">
    <label id="condlabel" for="cond"></label>
    <input type="range" id="cond" style="width: 50%; vertical-align: middle">
    <span id="condval"></span>
  </div>
</fieldset>
<button id="go" disabled>age the face</button>
<p id="status"></p>
<div id="result"></div>
<script>
"use strict";
const $ = id => document.getElementById(id);
let meta = null;
function loadMeta() {
  const hdrs = $("token").value
    ? { "Authorization": "Bearer " + $("token").value } : {};
  fetch("/healthz", { headers: hdrs }).then(r => r.json()).then(h => {
    if (!h.meta) {   // auth on: the unauthenticated body is redacted
      $("meta").textContent =
        "auth required — enter the token above to load artifact metadata";
      return;
    }
    meta = h.meta;
    $("meta").textContent = `serving ${h.artifact_dir} — ${meta.netG}, ` +
      `${meta.crop_size}px, cond_mode=${meta.cond_mode}` +
      (meta.cond_mode === "score" ? "" : `, ${meta.n_age_bins} age bins`);
    const c = $("cond");
    if (meta.cond_mode === "score") {
      c.min = -100; c.max = 100; c.value = 0;
      $("condlabel").textContent = "score";
    } else {
      c.min = 0; c.max = meta.n_age_bins - 1; c.value = 0;
      $("condlabel").textContent = "age bin";
    }
    sync(); $("go").disabled = false;
  }).catch(e => { $("meta").textContent = "healthz failed: " + e; });
}
loadMeta();
$("token").addEventListener("change", loadMeta);
function sync() {
  const c = $("cond");
  $("condval").textContent =
    meta && meta.cond_mode === "score" ? (c.value / 100).toFixed(2) : c.value;
  $("condrow").style.display =
    document.querySelector("input[name=mode]:checked").value === "single"
      ? "" : "none";
}
$("cond").addEventListener("input", sync);
document.querySelectorAll("input[name=mode]").forEach(
  r => r.addEventListener("change", sync));
$("go").addEventListener("click", async () => {
  const f = $("file").files[0];
  if (!f) { $("status").textContent = "pick an image first"; return; }
  const mode = document.querySelector("input[name=mode]:checked").value;
  let url;
  if (mode === "single") {
    url = meta.cond_mode === "score"
      ? `/generate_image?score=${$("cond").value / 100}`
      : `/generate_image?bin=${$("cond").value}`;
  } else if (mode === "strip") url = "/progression_image";
  else url = "/progression_gif?frames=24";
  $("status").textContent = "running on device…";
  $("go").disabled = true;
  const t0 = performance.now();
  try {
    const hdrs = $("token").value
      ? { "Authorization": "Bearer " + $("token").value } : {};
    const r = await fetch(url, { method: "POST", body: f, headers: hdrs });
    if (!r.ok) throw new Error((await r.json()).error || r.status);
    const blob = await r.blob();
    $("result").innerHTML = "";
    const img = document.createElement("img");
    img.src = URL.createObjectURL(blob);
    $("result").appendChild(img);
    $("status").textContent =
      `done in ${((performance.now() - t0) / 1e3).toFixed(2)} s`;
  } catch (e) { $("status").textContent = "error: " + e.message; }
  finally { $("go").disabled = false; }
});
</script></body></html>
"""


def _precheck(images: np.ndarray, cond: np.ndarray, meta: dict):
    """Per-request validation BEFORE coalescing: a malformed request must
    400 alone, not poison the fused batch it would ride in."""
    s, in_nc = int(meta["crop_size"]), int(meta["input_nc"])
    if images.ndim != 4 or images.shape[1:] != (s, s, in_nc):
        raise ValueError(
            f"images must be (B,{s},{s},{in_nc}); got {images.shape}")
    if cond.ndim != 2 or cond.shape[1] != int(meta["cond_nc"]):
        raise ValueError(
            f"cond must be (B,{meta['cond_nc']}); got {cond.shape}")
    if images.shape[0] != cond.shape[0]:
        raise ValueError(f"batch mismatch: images {images.shape[0]} vs "
                         f"cond {cond.shape[0]}")


def _warmup(served, b: int):
    """Run one batch-``b`` dummy call before the program takes traffic (its
    first call on a device pays for cuBLAS/cuDNN set-up and allocator
    growth)."""
    if b <= 0:
        return
    m = served.meta
    s_px = int(m["crop_size"])
    served(np.zeros((b, s_px, s_px, int(m["input_nc"])), np.float32),
           served.all_conditions()[np.zeros(b, np.int64)])


# max body bytes a REJECTED request (401 wrong-token / 503 shed) is worth
# draining to preserve keep-alive framing; past this, close the connection
# like the 413 path does (a tokenless client could otherwise
# force a 256 MiB read per request)
_REJECT_DRAIN_CAP = 1 << 20


def make_server(artifact_dir: str, host: str, port: int,
                batch_window_ms: float = 0.0, warmup_batch: int = 0,
                auth_token: str = "", watch_seconds: float = 0.0,
                max_body_bytes: int = 256 * 1024 * 1024,
                request_timeout: float = 30.0, max_pending: int = 32,
                device: str = "cuda"):
    """The host over ``artifact_dir`` on ``device`` (raises on cuda
    without a card): ``(httpd, served)``; call ``httpd.serve_forever()``."""
    import hmac
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from pcgan_tpu_torch.serving import load_exported

    t_start = time.time()
    stats = {"requests": 0, "rows": 0, "errors": 0, "reloads": 0,
             "rejected": 0}
    stats_lock = threading.Lock()
    # bounded in-flight POST count: when the card (or the host)
    # falls behind, shed load with 503 instead of queueing unboundedly —
    # each queued request pins its whole decoded body in memory
    pending = threading.Semaphore(max_pending)

    def _load_checked(path):
        served = load_exported(path, device=device)
        if served.meta.get("kind", "generator") != "generator":
            raise ValueError(
                f"{path} holds a {served.meta['kind']} artifact; "
                f"serve_http serves generator exports (score comparator "
                f"artifacts through pcgan_tpu_torch.serving."
                f"ServedComparator)")
        return served

    # the live artifact lives in a one-slot holder so POST /reload can swap
    # it atomically (python attribute assignment); requests read it once at
    # entry, so in-flight work finishes on the module it started with
    current = {"served": _load_checked(artifact_dir),
               "artifact_dir": os.path.abspath(artifact_dir)}
    served = current["served"]
    lock = threading.Lock()
    batcher = (Batcher(batch_window_ms)
               if batch_window_ms > 0 else None)

    # serializes concurrent reloads (watcher poll + POST /reload racing):
    # two simultaneous load+warm cycles waste a warm-up and the losing
    # writer's work; one at a time is always correct
    swap_lock = threading.Lock()

    def _swap(path: str):
        """Load + warm the artifact at ``path``, then swap it in (shared by
        POST /reload and the --watch_seconds poller). The load happens OFF
        the request lock — traffic keeps serving the old module; the swap
        itself is one attribute assignment."""
        with swap_lock:
            new_served = _load_checked(path)
            # warm BEFORE the swap: the swap is one assignment, but the
            # first call of a fresh program pays its set-up; warming first
            # keeps the reload free of a slow request
            _warmup(new_served, warmup_batch)
            current["served"] = new_served
            current["artifact_dir"] = os.path.abspath(path)
        with stats_lock:
            stats["reloads"] += 1
        return new_served

    watch_stop = threading.Event()
    if watch_seconds > 0:
        # --watch_seconds: continuous-deployment loop — the trainer
        # re-exports IN PLACE (tools/export_serving.py writes meta.json
        # LAST, so its mtime is the commit marker) and the host hot-swaps
        # without any operator action. A failed load keeps the old module
        # serving and retries only when the marker changes again.
        def _sig():
            try:
                st = os.stat(os.path.join(current["artifact_dir"],
                                          "meta.json"))
                return (st.st_mtime_ns, st.st_size)
            except OSError:
                return None

        def _watch():
            last = _sig()
            while not watch_stop.wait(watch_seconds):
                cur = _sig()
                if cur is None or cur == last:
                    continue
                last = cur
                try:
                    _swap(current["artifact_dir"])
                    print(f"watch: reloaded {current['artifact_dir']}",
                          flush=True)
                except Exception as e:    # keep serving the old module
                    print(f"watch: reload failed ({type(e).__name__}: {e});"
                          f" still serving the previous artifact",
                          flush=True)

        threading.Thread(target=_watch, daemon=True).start()

    def dispatch(images, cond):
        served = current["served"]
        if batcher is None:
            with lock:
                return served(images, cond)
        images, cond = served._validate(images, cond)
        if images.shape[0] == 0:           # same contract as the direct path
            return served._empty(images)
        _precheck(images, cond, served.meta)
        return batcher.submit(images, cond, served)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # socket read timeout: a slow-body client (trickling bytes, or
        # sending a Content-Length it never fulfills) times out instead of
        # pinning a handler thread forever; CPython's handle_one_request
        # catches the TimeoutError and closes the connection
        timeout = request_timeout

        def log_message(self, fmt, *args):   # quiet by default
            if os.environ.get("PCGAN_SERVE_VERBOSE"):
                super().log_message(fmt, *args)

        def _reply(self, code: int, body: bytes, ctype: str,
                   close: bool = False):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if close:
                # an unread request body would desync this keep-alive
                # connection (the leftover bytes parse as the next request
                # line) — tell the client the server is closing it
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj, close: bool = False):
            self._reply(code, json.dumps(obj).encode(), "application/json",
                        close=close)

        def _drain(self, n: int) -> None:
            """Consume n unprocessed body bytes in bounded chunks so the
            keep-alive connection stays framed for the next request
            (replying before reading desyncs the socket)."""
            while n > 0:
                chunk = self.rfile.read(min(n, 1 << 20))
                if not chunk:
                    self.close_connection = True
                    return
                n -= len(chunk)

        def _token_ok(self) -> bool:
            if not auth_token:
                return True
            got = self.headers.get("Authorization", "")
            return got.startswith("Bearer ") and hmac.compare_digest(
                got[len("Bearer "):], auth_token)

        def _authorized(self, body_bytes: int = 0) -> bool:
            """Bearer-token check (constant-time). Open routes: GET /
            (demo page carries a token field) and GET /healthz
            (readiness probes — redacted body when auth is on). On
            failure a SMALL pending body is drained so keep-alive framing
            survives the 401; past the drain cap the connection closes
            instead — a tokenless client must not be able to make the
            host read up to --max_body_bytes per rejected request
            (the 413 path already closes without reading)."""
            if self._token_ok():
                return True
            close = body_bytes > _REJECT_DRAIN_CAP
            if not close:
                self._drain(body_bytes)
            self._json(401, {"error": "missing or invalid bearer token "
                                      "(Authorization: Bearer <token>)"},
                       close=close)
            return False

        def do_GET(self):
            if self.path in ("/", "/demo"):
                # self-contained browser demo over the raw-image routes —
                # no assets, no deps; the page reads /healthz to adapt its
                # condition control to the artifact's cond_mode
                return self._reply(200, _DEMO_HTML.encode(),
                                   "text/html; charset=utf-8")
            if self.path == "/healthz":
                # readiness probes stay unauthenticated, but with auth on
                # the unauthenticated body is just the status — artifact
                # meta + the absolute filesystem path are more than a
                # probe needs; send the
                # token to get the full body
                if auth_token and not self._token_ok():
                    return self._json(200, {"status": "ok"})
                return self._json(200, {
                    "status": "ok", "meta": current["served"].meta,
                    "artifact_dir": current["artifact_dir"]})
            if not self._authorized():
                return
            if self.path == "/metrics":
                # Prometheus text exposition format — the standard scrape
                # surface for production monitoring; same counters as /stats
                with stats_lock:
                    st = dict(stats)
                lines = [
                    "# TYPE pcgan_requests_total counter",
                    f"pcgan_requests_total {st['requests']}",
                    "# TYPE pcgan_rows_total counter",
                    f"pcgan_rows_total {st['rows']}",
                    "# TYPE pcgan_errors_total counter",
                    f"pcgan_errors_total {st['errors']}",
                    "# TYPE pcgan_rejected_total counter",
                    f"pcgan_rejected_total {st['rejected']}",
                    "# TYPE pcgan_reloads_total counter",
                    f"pcgan_reloads_total {st['reloads']}",
                    "# TYPE pcgan_device_dispatches_total counter",
                    f"pcgan_device_dispatches_total "
                    f"{batcher.dispatches if batcher else st['requests']}",
                    "# TYPE pcgan_uptime_seconds gauge",
                    f"pcgan_uptime_seconds {time.time() - t_start:.1f}",
                ]
                return self._reply(200, ("\n".join(lines) + "\n").encode(),
                                   "text/plain; version=0.0.4")
            if self.path == "/stats":
                with stats_lock:
                    body = dict(stats)
                body["uptime_s"] = round(time.time() - t_start, 1)
                body["device_dispatches"] = (batcher.dispatches
                                             if batcher else None)
                body["batch_window_ms"] = (batch_window_ms
                                           if batcher else 0.0)
                return self._json(200, body)
            self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0) or 0)
            except ValueError:
                return self._json(400, {"error": "invalid Content-Length"},
                                  close=True)
            if n < 0:
                return self._json(400, {"error": "invalid Content-Length"},
                                  close=True)
            if n > max_body_bytes:
                # refuse WITHOUT reading: one oversized declaration must
                # not make the host buffer gigabytes. The connection
                # closes (the unread body cannot be skipped affordably).
                with stats_lock:
                    stats["rejected"] += 1
                return self._json(
                    413, {"error": f"request body {n} bytes exceeds the "
                                   f"--max_body_bytes limit "
                                   f"({max_body_bytes})"}, close=True)
            if not self._authorized(body_bytes=n):
                return
            if not pending.acquire(blocking=False):
                # load shedding: bounded in-flight depth; the client
                # retries (or a fronting LB routes elsewhere). Same
                # bounded-drain rule as the 401 path: shed requests must
                # not cost the host a full body read
                with stats_lock:
                    stats["rejected"] += 1
                close = n > _REJECT_DRAIN_CAP
                if not close:
                    self._drain(n)
                return self._json(
                    503, {"error": f"server busy ({max_pending} requests "
                                   f"in flight); retry"}, close=close)
            try:
                self._do_post_body(n)
            finally:
                pending.release()

        def _do_post_body(self, n: int):
            try:
                body = self.rfile.read(n)
                if len(body) < n:      # client hung up mid-body
                    self.close_connection = True
                    return
                if self.path == "/reload":
                    # hot swap: load the new artifact OFF the request lock
                    # (a load costs seconds; traffic keeps serving the old
                    # module), then swap the holder atomically. Body: JSON
                    # {"artifact_dir": path} or empty = re-read the current
                    # dir (the trainer re-exported in place).
                    req = json.loads(body) if body else {}
                    if not isinstance(req, dict):
                        raise ValueError("/reload body must be a JSON "
                                         "object or empty")
                    path = req.get("artifact_dir", current["artifact_dir"])
                    new_served = _swap(path)
                    return self._json(200, {"status": "reloaded",
                                            "artifact_dir":
                                                current["artifact_dir"],
                                            "meta": new_served.meta})
                from urllib.parse import urlsplit
                route = urlsplit(self.path)
                if route.path == "/generate":
                    images, cond = _load_npz(body, "images", "cond")
                    out = dispatch(images, cond)
                    rows, reply = images.shape[0], None
                elif route.path == "/progression":
                    (images,) = _load_npz(body, "images")
                    if batcher is None:
                        with lock:
                            out = current["served"].progression(images)
                    else:
                        # the grid rides the coalescing dispatch; the
                        # repeat/tile pairing stays in ONE place
                        out = current["served"].progression(images,
                                                            call=dispatch)
                    rows, reply = out.shape[0] * out.shape[1], None
                elif route.path == "/generate_image":
                    # demo/deployment sugar: raw image in, PNG out — the
                    # host does the test-time transform; same dispatch path
                    srv = current["served"]
                    images = _decode_image_body(body, srv.meta)
                    cond = _cond_from_query(route.query, srv)
                    out = dispatch(images, cond)
                    rows, reply = 1, (_png_bytes(out[0]), "image/png")
                elif route.path == "/progression_image":
                    srv = current["served"]
                    images = _decode_image_body(body, srv.meta)
                    if batcher is None:
                        with lock:
                            grid = srv.progression(images)
                    else:
                        grid = srv.progression(images, call=dispatch)
                    strip = np.concatenate([images[0]] + list(grid[0]),
                                           axis=1)   # [input | aged@conds]
                    rows = grid.shape[1]
                    reply = (_png_bytes(strip), "image/png")
                elif route.path == "/progression_gif":
                    # raw image in, looping animated GIF of the SMOOTH
                    # aging sweep out (?frames=N, default 24) — the serving
                    # twin of test.py --anim
                    from urllib.parse import parse_qsl
                    srv = current["served"]
                    images = _decode_image_body(body, srv.meta)
                    q = dict(parse_qsl(route.query))
                    frames = int(q.get("frames", 24))
                    if not 2 <= frames <= 256:
                        raise ValueError(f"frames must be in [2, 256], "
                                         f"got {frames}")
                    if batcher is None:
                        with lock:
                            anim = srv.animation(images, frames)
                    else:
                        anim = srv.animation(images, frames, call=dispatch)
                    rows = frames
                    reply = (_gif_bytes(anim[0]), "image/gif")
                else:
                    return self._json(404, {"error": f"no route {self.path}"})
                with stats_lock:
                    stats["requests"] += 1
                    stats["rows"] += int(rows)
                if reply is not None:
                    self._reply(200, reply[0], reply[1])
                else:
                    self._reply(200, _npy_bytes(out),
                                "application/octet-stream")
            except TimeoutError:
                # socket read timeout mid-body (slow-loris client): the
                # connection is dead — let handle_one_request close it; a
                # 400 here would be misread as an application error AND
                # leave the timed-out socket in the keep-alive loop
                raise
            except (KeyError, ValueError, OSError,
                    json.JSONDecodeError) as e:
                with stats_lock:
                    stats["errors"] += 1
                self._json(400, {"error": str(e)})
            except Exception as e:   # device OOM / runtime failures: a
                # keep-alive client must still get a status line, not a
                # dead connection
                with stats_lock:
                    stats["errors"] += 1
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    class Server(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5: a burst of more
        # concurrent connections than that overflows the accept queue,
        # and the kernel drops the extra SYNs, which the clients resend
        # only after the 1 s retransmission timeout (a p99 of ~1 s at
        # concurrency 8). One slot per request the host may hold.
        request_queue_size = max(64, 2 * max_pending)

    httpd = Server((host, port), Handler)
    httpd.batcher = batcher            # introspection (stats/tests)
    httpd.current = current
    httpd.watch_stop = watch_stop      # stops the --watch_seconds poller
    return httpd, served


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--artifact_dir", required=True,
                   help="directory from pcgan_tpu_torch.tools.export_serving")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   help="coalesce concurrent requests arriving within this "
                        "window into one device dispatch, padded to "
                        "power-of-two buckets (0 = serialize requests)")
    p.add_argument("--warmup_batch", type=int, default=0,
                   help="run a batch of this size before accepting "
                        "traffic (0 = skip)")
    p.add_argument("--auth_token", default="",
                   help="require 'Authorization: Bearer <token>' on every "
                        "route except GET / and GET /healthz; defaults to "
                        "env PCGAN_SERVE_TOKEN ('' = open)")
    p.add_argument("--watch_seconds", type=float, default=0.0,
                   help="poll the artifact dir's meta.json every N seconds "
                        "and hot-swap automatically when a re-export lands "
                        "(the continuous-deployment twin of POST /reload; "
                        "0 = off)")
    p.add_argument("--max_body_bytes", type=int, default=256 * 1024 * 1024,
                   help="413 any request declaring a larger body, without "
                        "reading it (default 256 MiB ~= batch-256 512px f32)")
    p.add_argument("--request_timeout", type=float, default=30.0,
                   help="socket read timeout per request; slow-body clients "
                        "are disconnected instead of pinning a thread")
    p.add_argument("--max_pending", type=int, default=32,
                   help="maximum concurrent in-flight POSTs; excess "
                        "requests get 503 (load shedding)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the program runs (cuda raises without a "
                        "card)")
    args = p.parse_args(argv)
    if not args.auth_token:
        args.auth_token = os.environ.get("PCGAN_SERVE_TOKEN", "")

    httpd, served = make_server(args.artifact_dir, args.host, args.port,
                                batch_window_ms=args.batch_window_ms,
                                warmup_batch=args.warmup_batch,
                                auth_token=args.auth_token,
                                watch_seconds=args.watch_seconds,
                                max_body_bytes=args.max_body_bytes,
                                request_timeout=args.request_timeout,
                                max_pending=args.max_pending,
                                device=args.device)
    if args.auth_token:
        print("bearer-token auth enabled", flush=True)
    if args.warmup_batch > 0:
        _warmup(served, args.warmup_batch)
        print(f"warmed up batch {args.warmup_batch}", flush=True)
    print(f"serving {args.artifact_dir} on {args.device}, "
          f"http://{args.host}:{httpd.server_address[1]}", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
