"""Concurrent load generator for the serving host (counterpart of the root
``tools/loadtest.py``, over the port's client)::

    python -m pcgan_tpu_torch.tools.loadtest --url http://127.0.0.1:8500 \
        --concurrency 8 --requests 64 --batch 8

Stdlib + numpy only (same footprint as the client it drives). Each worker
thread posts ``--requests / --concurrency`` /generate calls of ``--batch``
random rows shaped from the artifact's /healthz metadata, after ``--warmup``
untimed requests. Reports ONE JSON line:

    p50/p90/p99 request wall latency (ms), aggregate rows/s, error count,
    and the host's device-dispatch delta (how well --batch_window_ms
    coalescing fused the concurrent stream: dispatches << requests when
    the window is doing its job).

This is the measurement harness for serving capacity planning: the rate
through HTTP, beside the artifact's own rate without HTTP. ``--abuse`` runs
the hardening battery instead (``run_abuse``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from pcgan_tpu_torch.client import ServingClient, ServingError


def _payload(meta: dict, batch: int, seed: int):
    """Random request rows shaped for the artifact: images in [-1,1], a
    valid condition per row (uniform over bins, or mid-range scores)."""
    r = np.random.default_rng(seed)
    s, in_nc = int(meta["crop_size"]), int(meta["input_nc"])
    images = r.uniform(-1, 1, (batch, s, s, in_nc)).astype(np.float32)
    if meta["cond_mode"] == "score":
        cond = r.uniform(-1, 1, (batch, 1)).astype(np.float32)
    else:
        nb = int(meta["n_age_bins"])
        cond = np.eye(nb, dtype=np.float32)[r.integers(0, nb, batch)]
    return images, cond


def run_loadtest(url: str, concurrency: int, requests: int, batch: int,
                 warmup: int = 2, timeout: float = 120.0,
                 auth_token: str = "") -> dict:
    client = ServingClient(url, timeout=timeout, auth_token=auth_token)
    meta = client.healthz()["meta"]

    for i in range(warmup):
        client.generate(*_payload(meta, batch, seed=10_000 + i))
    # snapshot AFTER warmup so the dispatch delta covers only the timed
    # concurrent stream (warmup requests are sequential and never fuse)
    stats0 = client.stats()

    # distribute --requests exactly: worker w takes base + 1 spillover
    base, extra = divmod(requests, concurrency)
    per_worker = [base + (1 if w < extra else 0) for w in range(concurrency)]
    latencies, errors = [], []
    lock = threading.Lock()
    start_gate = threading.Barrier(concurrency + 1)

    def worker(wid: int):
        c = ServingClient(url, timeout=timeout, auth_token=auth_token)
        images, cond = _payload(meta, batch, seed=wid)
        start_gate.wait()
        for i in range(per_worker[wid]):
            t0 = time.perf_counter()
            try:
                out = c.generate(images, cond)
                dt = time.perf_counter() - t0
                ok = out.shape[0] == batch
                with lock:
                    (latencies if ok else errors).append(dt)
            except (ServingError, OSError) as e:
                with lock:
                    errors.append(str(e))

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(concurrency)]
    for t in threads:
        t.start()
    start_gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    stats1 = client.stats()

    lat = np.sort(np.asarray(latencies, np.float64)) * 1e3   # ms
    n_ok = len(lat)
    pct = (lambda p: float(lat[min(n_ok - 1, int(p * n_ok))])
           if n_ok else None)
    dispatch_delta = None
    if stats1.get("device_dispatches") is not None:
        dispatch_delta = (stats1["device_dispatches"]
                          - (stats0.get("device_dispatches") or 0))
    return {
        "metric": "serving_rows_per_sec",
        "value": round(n_ok * batch / wall, 2) if wall > 0 else None,
        "unit": "rows/s",
        "requests_ok": n_ok,
        "requests_err": len(errors),
        "concurrency": concurrency,
        "batch": batch,
        "p50_ms": round(pct(0.50), 2) if n_ok else None,
        "p90_ms": round(pct(0.90), 2) if n_ok else None,
        "p99_ms": round(pct(0.99), 2) if n_ok else None,
        "wall_s": round(wall, 3),
        "device_dispatches": dispatch_delta,
        "batch_window_ms": stats1.get("batch_window_ms"),
    }


def _bomb_png() -> bytes:
    """A ~100-byte PNG whose header declares a 5000x5000 canvas (25 MPix —
    over serve_http's 16 MPix cap but under Pillow's own bomb threshold,
    so the HOST's guard is the one exercised) — the decompression-bomb
    probe for the raw-image routes: rejection must happen on the DECLARED
    dimensions, before any pixel buffer allocates."""
    import struct
    import zlib

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    sig = b"\x89PNG\r\n\x1a\n"
    ihdr = struct.pack(">IIBBBBB", 5000, 5000, 8, 2, 0, 0, 0)
    # a (truncated) IDAT so PIL's header parser reaches the size without
    # needing real pixel data, then IEND
    return (sig + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(b""))
            + chunk(b"IEND", b""))


def run_abuse(url: str, auth_token: str = "", timeout: float = 20.0,
              slow_wait: float = 0.0) -> dict:
    """Abuse-case battery: drives the hardening surface of serve_http —
    oversized declared body (413 without
    buffering), garbage npz (400), decompression-bomb image (400), wrong
    token (401 that keeps the connection framed), optional slow-body
    starvation (server closes at --request_timeout) — and asserts the
    host still serves a valid request after every case."""
    import http.client
    import socket
    from urllib.parse import urlsplit
    u = urlsplit(url)
    host, port = u.hostname, u.port or 80
    cases = {}

    def post_raw(path, body, token=None, conn=None, extra=()):
        c = conn or http.client.HTTPConnection(host, port, timeout=timeout)
        c.putrequest("POST", path)
        tok = auth_token if token is None else token
        if tok:
            c.putheader("Authorization", f"Bearer {tok}")
        for k, v in extra:
            c.putheader(k, v)
        if not any(k == "Content-Length" for k, _ in extra):
            c.putheader("Content-Length", str(len(body)))
        c.endheaders()
        if body:
            c.send(body)
        r = c.getresponse()
        payload = r.read()
        return c, r.status, payload

    # 1. oversized declared body -> 413 immediately, body never sent
    c, status, _ = post_raw("/generate", b"",
                            extra=(("Content-Length", str(1 << 40)),))
    cases["oversized_body_413"] = status == 413
    c.close()

    # 2. garbage npz -> 400 (and the worker thread survives)
    c, status, _ = post_raw("/generate", b"this is not an npz payload")
    cases["garbage_npz_400"] = status == 400
    c.close()

    # 3. decompression-bomb PNG on the raw-image route -> 400 on declared
    # dimensions (no pixel buffer may allocate)
    c, status, body = post_raw("/generate_image?bin=0", _bomb_png())
    cases["bomb_image_400"] = (status == 400
                               and b"exceed" in body.lower())
    c.close()

    # 4. wrong token -> 401 AND the keep-alive connection stays framed:
    # the same socket must serve a correct follow-up (the 401 path drains
    # the unread body)
    if auth_token:
        c, status, _ = post_raw("/generate", b"x" * 4096, token="wrong")
        ok_401 = status == 401
        try:
            c.putrequest("GET", "/healthz")
            c.putheader("Authorization", f"Bearer {auth_token}")
            c.endheaders()
            r2 = c.getresponse()
            r2.read()
            cases["wrong_token_401_keepalive"] = ok_401 and r2.status == 200
        except (http.client.HTTPException, OSError):
            # server chose to close the connection — acceptable (framing
            # can't desync a closed socket), but only with the 401 sent
            cases["wrong_token_401_keepalive"] = ok_401
        c.close()

    # 5. slow body: declare a body and never finish sending it; the host
    # must cut the connection at --request_timeout instead of pinning the
    # handler thread. Opt-in (costs slow_wait seconds of wall clock).
    if slow_wait > 0:
        s = socket.create_connection((host, port), timeout=slow_wait + 10)
        req = (f"POST /generate HTTP/1.1\r\nHost: {host}\r\n"
               + (f"Authorization: Bearer {auth_token}\r\n" if auth_token
                  else "")
               + "Content-Length: 1000000\r\n\r\n").encode()
        s.sendall(req + b"x" * 10)      # 10 of 1e6 bytes, then silence
        t0 = time.perf_counter()
        try:
            data = s.recv(65536)        # server closes (possibly silently)
            closed = data == b"" or b"408" in data or b"timed" in data
        except socket.timeout:
            closed = False
        cases["slow_body_disconnected"] = (closed and
                                           time.perf_counter() - t0
                                           <= slow_wait + 5)
        s.close()

    # after every abuse case: the host still serves real traffic
    client = ServingClient(url, timeout=timeout, auth_token=auth_token)
    h = client.healthz()
    alive = h.get("status") == "ok"
    meta = h.get("meta")
    if meta is not None:
        out = client.generate(*_payload(meta, 2, seed=123))
        alive = alive and out.shape[0] == 2
    cases["host_alive_after_abuse"] = alive

    n_ok = sum(bool(v) for v in cases.values())
    return {"metric": "serving_abuse_cases_ok",
            "value": n_ok, "unit": "cases",
            "cases": cases, "failed": [k for k, v in cases.items() if not v]}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--url", default="http://127.0.0.1:8500")
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--requests", type=int, default=64,
                   help="total /generate requests across all workers")
    p.add_argument("--batch", type=int, default=8, help="rows per request")
    p.add_argument("--warmup", type=int, default=2,
                   help="untimed warmup requests before the clock starts")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--auth_token", default="",
                   help="bearer token for a serve_http --auth_token host; "
                        "defaults to env PCGAN_SERVE_TOKEN")
    p.add_argument("--abuse", action="store_true",
                   help="run the abuse-case battery instead of the "
                        "throughput loadtest: oversized body, garbage npz, "
                        "bomb image, wrong token, optional slow body — "
                        "asserting the host stays up and bounded")
    p.add_argument("--slow_wait", type=float, default=0.0,
                   help="with --abuse: also run the slow-body starvation "
                        "case, waiting this long (> the host's "
                        "--request_timeout) for the disconnect")
    args = p.parse_args(argv)
    token = args.auth_token or os.environ.get("PCGAN_SERVE_TOKEN", "")
    if args.abuse:
        result = run_abuse(args.url, auth_token=token,
                           timeout=args.timeout, slow_wait=args.slow_wait)
        print(json.dumps(result))
        return 0 if not result["failed"] else 1
    result = run_loadtest(args.url, args.concurrency, args.requests,
                          args.batch, args.warmup, args.timeout,
                          auth_token=token)
    print(json.dumps(result))
    return 0 if result["requests_err"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
