"""pcgan_tpu_torch serving host (``tools/serve_http.py``), client and
loadtest held against the JAX package's (CPU).

One battery of HTTP requests goes to the JAX host over the JAX artifact and
to the port's host over the port's artifact of the same f32 weights
(converted); each pair gives the same status code, and ``.npy`` bodies
within 1e-4 (the golden grid's atol). The battery covers every route,
auth and the 401 framing, 413, 400s, 503 shedding, the slow-body
timeout, the decompression-bomb guard, reload and watch, coalescing and
the ``/metrics`` names. Then each client against the other framework's
host, and the port's loadtest and abuse battery against the port's host.
"""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import http.client
import io
import json
import os
import shutil
import socket
import sys
import threading
import time
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
FACE = os.path.join(ROOT, "tests", "torch_port_data", "faces",
                    "12_0_1_20170315879651173.jpg")
SMALL = ["--netG", "resnet_6blocks", "--crop_size", "32", "--load_size",
         "36", "--ngf", "8", "--n_age_bins", "4", "--cond_inject",
         "bottleneck", "--dtype", "float32"]
TOKEN = "s3cret"
# host configurations the battery runs against (both frameworks each)
HOSTS = {"plain": {}, "auth": {"auth_token": TOKEN},
         "shed": {"max_pending": 0}, "slow": {"request_timeout": 1.0},
         "window": {"batch_window_ms": 150.0}}


def _export_pair(out, seed):
    """JAX and port f32 artifacts of the same weights under out/{jax,port}."""
    from pcgan_tpu.config import parse_config as jax_parse
    from pcgan_tpu.models.registry import define_G as jax_define_G
    from pcgan_tpu.serving import export_generator as jax_export
    from pcgan_tpu_torch import convert
    from pcgan_tpu_torch.config import parse_config
    from pcgan_tpu_torch.models import define_G
    from pcgan_tpu_torch.serving import export_generator
    jcfg = jax_parse(SMALL, is_train=False)
    jG = jax_define_G(jcfg)
    jvars = jax.jit(lambda k: jG.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 4)), train=False))(jax.random.PRNGKey(seed))
    jax_export(jcfg, jvars, os.path.join(out, "jax"), platforms=("cpu",),
               G=jG)
    pcfg = parse_config(SMALL, is_train=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pG = define_G(pcfg)
    pG.load_state_dict(convert.convert_generator_params(jvars["params"]))
    export_generator(pcfg, pG.eval(), os.path.join(out, "port"),
                     platforms=("cpu",))
    return {"jax": os.path.join(out, "jax"), "port": os.path.join(out, "port")}


class _Hosts:
    """Both frameworks' hosts per configuration, started on first use."""

    def __init__(self, arts):
        self.arts = arts
        self.live = {}

    def url(self, fw, name, art="a", **kw):
        key = (fw, name)
        if key not in self.live:
            if fw == "jax":
                import serve_http as mod
                extra = {}
            else:
                from pcgan_tpu_torch.tools import serve_http as mod
                extra = {"device": "cpu"}
            httpd, _ = mod.make_server(self.arts[art][fw], "127.0.0.1", 0,
                                       **HOSTS.get(name, {}), **kw, **extra)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            self.live[key] = httpd
        return f"127.0.0.1:{self.live[key].server_address[1]}"

    def httpd(self, fw, name):
        return self.live[(fw, name)]

    def close(self):
        for httpd in self.live.values():
            httpd.watch_stop.set()
            httpd.shutdown()
            httpd.server_close()


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    out = tmp_path_factory.mktemp("art")
    arts = {"a": _export_pair(str(out / "a"), 7),
            "b": _export_pair(str(out / "b"), 8)}
    h = _Hosts(arts)
    yield h
    h.close()


# --------------------------------------------------------------------------- #
# raw HTTP
# --------------------------------------------------------------------------- #


def _request(hostport, method, path, body=b"", headers=(), conn=None,
             length=None, token=None):
    host, port = hostport.split(":")
    c = conn or http.client.HTTPConnection(host, int(port), timeout=60)
    c.putrequest(method, path)
    if token:
        c.putheader("Authorization", f"Bearer {token}")
    for k, v in headers:
        c.putheader(k, v)
    if method == "POST":
        c.putheader("Content-Length",
                    str(len(body)) if length is None else length)
    c.endheaders()
    if body:
        c.send(body)
    r = c.getresponse()
    return c, r.status, dict(r.getheaders()), r.read()


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, b)])


def _bomb():
    from pcgan_tpu_torch.tools.loadtest import _bomb_png
    return _bomb_png()


def _face():
    return open(FACE, "rb").read()


def _post(path, body, **kw):
    return lambda url: _request(url, "POST", path, body, **kw)


def _get(path, **kw):
    return lambda url: _request(url, "GET", path, **kw)


def _keepalive_after_401(url):
    """A wrong token with a small body, then a good request on the SAME
    socket: 401 and then 200 (the host drains the unread body)."""
    c, st, hd, body = _request(url, "POST", "/generate", b"x" * 4096,
                               token="wrong")
    c2, st2, _, _ = _request(url, "GET", "/healthz", conn=c, token=TOKEN)
    return c2, (st, st2), hd, body


def _big_401_closes(url):
    c, st, hd, body = _request(url, "POST", "/generate", b"",
                               length=str(8 << 20), token="wrong")
    return c, (st, hd.get("Connection")), hd, body


def _slow_body(url):
    host, port = url.split(":")
    s = socket.create_connection((host, int(port)), timeout=15)
    s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
              b"Content-Length: 100000\r\n\r\n" + b"x" * 10)
    t0 = time.perf_counter()
    data = s.recv(65536)
    return s, (data == b"", time.perf_counter() - t0 < 10), {}, b""


x3, c3 = _inputs(3, seed=1)
BATTERY = {
    # routes
    "healthz": ("plain", _get("/healthz")),
    "demo_page": ("plain", _get("/")),
    "no_route_get": ("plain", _get("/nope")),
    "no_route_post": ("plain", _post("/nope", b"{}")),
    "generate": ("plain", _post("/generate", _npz(images=x3, cond=c3))),
    "progression": ("plain", _post("/progression", _npz(images=x3[:2]))),
    "generate_image": ("plain", _post("/generate_image?bin=2", _face())),
    "progression_image": ("plain", _post("/progression_image", _face())),
    "progression_gif": ("plain", _post("/progression_gif?frames=6",
                                       _face())),
    "stats": ("plain", _get("/stats")),
    "metrics": ("plain", _get("/metrics")),
    # request errors
    "missing_cond_400": ("plain", _post("/generate", _npz(images=x3))),
    "garbage_npz_400": ("plain", _post("/generate", b"not an npz")),
    "wrong_size_400": ("plain", _post("/generate",
                                      _npz(images=x3[:, :16], cond=c3))),
    "bin_out_of_range_400": ("plain", _post("/generate_image?bin=9",
                                            _face())),
    "score_on_onehot_400": ("plain", _post("/generate_image?score=0.5",
                                           _face())),
    "no_condition_400": ("plain", _post("/generate_image", _face())),
    "frames_400": ("plain", _post("/progression_gif?frames=1", _face())),
    "garbage_image_400": ("plain", _post("/generate_image?bin=0",
                                         b"not an image")),
    "bomb_image_400": ("plain", _post("/generate_image?bin=0", _bomb())),
    "reload_missing_dir_400": ("plain", _post(
        "/reload", json.dumps({"artifact_dir": "/nonexistent"}).encode())),
    # framing and hardening
    "oversized_413": ("plain", _post("/generate", b"",
                                     length=str(1 << 40))),
    "bad_content_length_400": ("plain", _post("/generate", b"",
                                              length="banana")),
    "negative_content_length_400": ("plain", _post("/generate", b"",
                                                   length="-5")),
    "shed_503": ("shed", _post("/generate", _npz(images=x3, cond=c3))),
    "slow_body_disconnect": ("slow", _slow_body),
    # auth
    "auth_healthz_redacted": ("auth", _get("/healthz")),
    "auth_healthz_full": ("auth", _get("/healthz", token=TOKEN)),
    "auth_demo_open": ("auth", _get("/")),
    "auth_metrics_401": ("auth", _get("/metrics")),
    "auth_generate_401": ("auth", _post("/generate",
                                        _npz(images=x3, cond=c3))),
    "auth_generate_ok": ("auth", _post("/generate",
                                       _npz(images=x3, cond=c3),
                                       token=TOKEN)),
    "auth_401_keepalive": ("auth", _keepalive_after_401),
    "auth_401_large_body_closes": ("auth", _big_401_closes),
}


def _decoded(body):
    from PIL import Image
    with Image.open(io.BytesIO(body)) as im:
        frames = getattr(im, "n_frames", 1)
        return frames, np.asarray(im.convert("RGB"), np.int16)


@pytest.mark.parametrize("case", sorted(BATTERY))
def test_battery_same_status_and_bodies(hosts, case):
    name, send = BATTERY[case]
    got = {}
    for fw in ("jax", "port"):
        conn, status, headers, body = send(hosts.url(fw, name))
        conn.close()
        got[fw] = (status, headers, body)
    (sj, hj, bj), (sp, hp, bp) = got["jax"], got["port"]
    assert sj == sp, (case, sj, sp, bj[:200], bp[:200])
    ctype = hj.get("Content-Type", "")
    assert hp.get("Content-Type", "") == ctype
    if ctype == "application/octet-stream":
        a = np.load(io.BytesIO(bj), allow_pickle=False)
        b = np.load(io.BytesIO(bp), allow_pickle=False)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=1e-4)
    elif ctype in ("image/png", "image/gif"):
        fj, aj = _decoded(bj)
        fp, ap = _decoded(bp)
        assert fj == fp and aj.shape == ap.shape
        if ctype == "image/png":          # u8 rounding of 1e-4-close floats
            assert np.abs(aj - ap).max() <= 1
    elif case in ("auth_healthz_redacted",):
        assert json.loads(bj) == json.loads(bp) == {"status": "ok"}
    elif case in ("healthz", "auth_healthz_full"):
        mj, mp = json.loads(bj)["meta"], json.loads(bp)["meta"]
        assert {k: v for k, v in mj.items() if k not in ("format",)} == {
            k: v for k, v in mp.items() if k not in ("format",)}
    elif case == "metrics":
        names = [sorted(line.split()[0] for line in b.decode().splitlines()
                        if not line.startswith("#")) for b in (bj, bp)]
        assert names[0] == names[1] and "pcgan_requests_total" in names[0]
    elif case == "stats":
        assert sorted(json.loads(bj)) == sorted(json.loads(bp))
    elif case in ("bomb_image_400",):
        assert b"exceed" in bj.lower() and b"exceed" in bp.lower()


def test_coalescing_counts(hosts):
    """--batch_window_ms: 6 concurrent requests fuse into fewer dispatches
    on both hosts, and every caller gets its own rows back."""
    import concurrent.futures as cf
    reqs = [_inputs(2, seed=20 + i) for i in range(6)]
    out = {}
    for fw in ("jax", "port"):
        url = hosts.url(fw, "window")
        httpd = hosts.httpd(fw, "window")
        d0 = httpd.batcher.dispatches

        def one(i):
            c, st, _, body = _request(url, "POST", "/generate",
                                      _npz(images=reqs[i][0],
                                           cond=reqs[i][1]))
            c.close()
            assert st == 200
            return np.load(io.BytesIO(body))

        with cf.ThreadPoolExecutor(6) as ex:
            out[fw] = list(ex.map(one, range(6)))
        assert httpd.batcher.dispatches - d0 < 6
    for a, b in zip(out["jax"], out["port"]):
        np.testing.assert_allclose(b, a, atol=1e-4)


def _copy_artifact(src, dst):
    """Replace dst's artifact by src's, meta.json last (the exporter's
    commit order)."""
    os.makedirs(dst, exist_ok=True)
    for f in sorted(os.listdir(src), key=lambda f: f == "meta.json"):
        shutil.copyfile(os.path.join(src, f), os.path.join(dst, f) + ".tmp")
        os.replace(os.path.join(dst, f) + ".tmp", os.path.join(dst, f))


def test_reload_and_watch(hosts, tmp_path):
    """POST /reload to artifact b, then --watch_seconds picking up an
    in-place re-export: both hosts swap, /healthz names the directory, and
    the outputs follow (JAX vs port within 1e-4)."""
    from pcgan_tpu_torch.client import ServingClient
    x, c = _inputs(2, seed=30)
    got = {}
    for fw in ("jax", "port"):
        live = str(tmp_path / fw)
        _copy_artifact(hosts.arts["a"][fw], live)
        if fw == "jax":
            import serve_http as mod
            kw = {}
        else:
            from pcgan_tpu_torch.tools import serve_http as mod
            kw = {"device": "cpu"}
        httpd, _ = mod.make_server(live, "127.0.0.1", 0, watch_seconds=0.2,
                                   **kw)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            cl = ServingClient(f"http://127.0.0.1:{httpd.server_address[1]}")
            a = cl.generate(x, c)
            rec = cl.reload(hosts.arts["b"][fw])
            assert rec["status"] == "reloaded"
            assert cl.healthz()["artifact_dir"] == os.path.abspath(
                hosts.arts["b"][fw])
            b = cl.generate(x, c)
            assert np.abs(a - b).max() > 1e-3            # the swap shows
            cl.reload(live)                               # back to a
            np.testing.assert_array_equal(cl.generate(x, c), a)
            time.sleep(0.5)
            _copy_artifact(hosts.arts["b"][fw], live)     # re-export
            for _ in range(100):                          # the watcher
                w = cl.generate(x, c)
                if np.array_equal(w, b):
                    break
                time.sleep(0.1)
            np.testing.assert_array_equal(w, b)
            assert cl.stats()["reloads"] >= 3
            got[fw] = (a, b, w)
        finally:
            httpd.watch_stop.set()
            httpd.shutdown()
            httpd.server_close()
    for i in range(3):
        np.testing.assert_allclose(got["port"][i], got["jax"][i], atol=1e-4)


def test_clients_cross_frameworks(hosts):
    """The port's client against the JAX host and the JAX client against
    the port's host give what each host's own client gets."""
    from pcgan_tpu.client import ServingClient as JaxClient
    from pcgan_tpu.client import ServingError as JaxError
    from pcgan_tpu_torch.client import ServingClient, ServingError
    x, c = _inputs(3, seed=40)
    res = {}
    for fw in ("jax", "port"):
        url = "http://" + hosts.url(fw, "auth")
        for cname, cls, err in (("jax", JaxClient, JaxError),
                                ("port", ServingClient, ServingError)):
            cl = cls(url, auth_token=TOKEN)
            assert cl.healthz()["status"] == "ok"
            assert "pcgan_rows_total" in cl.metrics()
            png = cl.generate_image(_face(), bin=1)
            assert png[:8] == b"\x89PNG\r\n\x1a\n"
            with pytest.raises(err) as ei:
                cls(url).generate(x, c)                     # no token
            assert ei.value.status == 401
            res[(fw, cname)] = (cl.generate(x, c), cl.progression(x[:1]))
    for k in res:
        for i in range(2):
            np.testing.assert_allclose(res[k][i], res[("jax", "jax")][i],
                                       atol=1e-4)
        # the same host answers both clients identically
        np.testing.assert_array_equal(res[k][0], res[(k[0], "port")][0])


def test_port_loadtest_and_abuse(hosts):
    """The port's loadtest (its JSON line) and abuse battery against the
    port's host: every request served, every abuse case passes."""
    from pcgan_tpu_torch.tools import loadtest
    url = "http://" + hosts.url("port", "auth_slow",
                                auth_token=TOKEN, request_timeout=1.0,
                                batch_window_ms=5.0)
    rec = loadtest.run_loadtest(url, concurrency=4, requests=12, batch=2,
                                auth_token=TOKEN)
    assert rec["metric"] == "serving_rows_per_sec"
    assert rec["requests_ok"] == 12 and rec["requests_err"] == 0
    assert rec["value"] > 0 and rec["p50_ms"] <= rec["p99_ms"]
    assert 0 < rec["device_dispatches"] <= 12
    assert rec["batch_window_ms"] == 5.0
    # a listen backlog for a burst of concurrent clients (socketserver's
    # default of 5 drops the extra SYNs: a 1 s retransmission each)
    assert hosts.httpd("port", "auth_slow").request_queue_size >= 64
    ab = loadtest.run_abuse(url, auth_token=TOKEN, slow_wait=2.0)
    assert ab["failed"] == [] and ab["value"] == 6, ab
    assert loadtest.main(["--url", url, "--concurrency", "2", "--requests",
                          "2", "--batch", "1", "--auth_token", TOKEN]) == 0
