"""The port's HTTP daemon (``serve.py``) on the CPU.

The cases of the JAX package's ``tests/test_serve.py`` that need neither
an exported artifact nor a mesh, against the port's daemon around
a port-trained tiny entropic ``.pth`` (32 px, ``device="cpu"``): the
health probe, single and JSON-batch requests against the offline
predictor, rejection, the error paths, the keep-alive close on an
oversized body, the image cap, submit after close, the counters,
coalescing, a connection burst, errors propagated and recovered, a wedged
forward with bounded waits, close with a wedged forward, the compile
grace, the warmed ladder, ``request_timeout 0``, and the CLI (arguments,
the ``--optimize`` flags reaching the predictor, and end to end as a
subprocess with ``--device cpu``; the int8 daemon is in
tests/test_torch_optimize.py).  Then one case for
each fault of the JAX daemon that the port repairs, each failing on the
JAX behaviour: (a) a dead batcher thread, (b) ``close()`` ignoring the
cold-bucket grace, (c) the grace scoped to the whole ladder; and the JAX
daemon beside the port's on the same ``.pth`` and JPEG bytes in float32:
equal classes, scores within 1e-4.
"""

import base64
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from openset_imagenet_tpu_torch import serve as serve_mod
from openset_imagenet_tpu_torch import train as engine
from openset_imagenet_tpu_torch.inference import OpenSetPredictor
from openset_imagenet_tpu_torch.serve import (BatcherDead, DynamicBatcher,
                                              PredictionServer,
                                              PredictionTimeout, ServerStats,
                                              decode_to_input)
from tests.test_torch_worker_host import (  # noqa: F401 (autouse fixture)
    one_torch_thread, tiny_cfg, write_protocol_csvs)

SIZE = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_http")
    write_protocol_csvs(root)
    cfg = tiny_cfg(root, "entropic", epochs=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        engine.worker(cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return cfg.output_directory / "entropic_best.pth"


@pytest.fixture(scope="module")
def predictor(trained):
    return OpenSetPredictor(trained, n_classes=3, image_size=SIZE,
                            device="cpu")


@pytest.fixture()
def server(predictor):
    srv = PredictionServer(("127.0.0.1", 0), predictor,
                           max_batch=8, window_ms=0.0).start()
    yield srv
    srv.close()


def _url(server, path):
    host, port = server.server_address[:2]
    return f"http://{host}:{port}{path}"


def _jpeg_bytes(seed: int) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


def _post(server, body, content_type="application/octet-stream",
          path="/v1/predict"):
    req = urllib.request.Request(
        _url(server, path), data=body, method="POST",
        headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _healthz(server):
    """``(status code, body)`` of ``GET /healthz``."""
    try:
        with urllib.request.urlopen(_url(server, "/healthz"),
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _predictor_reference(predictor, blob):
    """What the offline predictor says about the same bytes."""
    img = decode_to_input(blob, predictor.image_size)
    pred, score = predictor.predict(img[None])
    return int(pred[0]), float(score[0])


def _answer(n, width=2):
    return (np.zeros(n, int), np.ones(n, np.float32),
            np.zeros((n, width), np.float32))


def test_healthz_reports_operating_point(server, predictor):
    code, info = _healthz(server)
    assert code == 200
    batcher = info.pop("batcher")
    assert info == {
        "status": "ok", "n_classes": 3, "image_size": 32,
        "threshold": predictor.threshold, "mode": "softmax",
        "has_background": False,
    }
    assert batcher["wedged"] is False and batcher["alive"] is True
    assert batcher["inflight_forward_s"] is None
    assert batcher["oldest_wait_s"] is None
    assert batcher["queue_depth"] == 0


def test_single_image_matches_offline_predictor(server, predictor):
    blob = _jpeg_bytes(0)
    out = _post(server, blob, "image/jpeg")
    want_pred, want_score = _predictor_reference(predictor, blob)
    assert out["prediction"] == want_pred
    assert out["rejected"] is False
    assert abs(out["score"] - want_score) < 1e-6
    assert "features" not in out
    out = _post(server, blob, "image/jpeg", path="/v1/predict?features=1")
    assert len(out["features"]) == 3
    img = decode_to_input(blob, predictor.image_size)
    _, _, feats = predictor.predict(img[None], return_features=True)
    np.testing.assert_allclose(out["features"], feats[0], rtol=1e-5,
                               atol=1e-7)


def test_json_batch_matches_offline_predictor(server, predictor):
    blobs = [_jpeg_bytes(i) for i in range(3)]
    body = json.dumps(
        {"images": [base64.b64encode(b).decode() for b in blobs]}).encode()
    out = _post(server, body, "application/json", path="/predict")
    assert len(out["results"]) == 3
    for blob, row in zip(blobs, out["results"]):
        want_pred, want_score = _predictor_reference(predictor, blob)
        assert row["prediction"] == want_pred
        assert abs(row["score"] - want_score) < 1e-6


def test_rejection_is_served(predictor):
    """A threshold no softmax reaches marks everything rejected (-1)."""
    old = predictor.threshold
    predictor.threshold = 1.1
    srv = PredictionServer(("127.0.0.1", 0), predictor,
                           max_batch=4, window_ms=0.0).start()
    try:
        out = _post(srv, _jpeg_bytes(1), "image/jpeg")
        assert out["prediction"] == -1
        assert out["rejected"] is True
    finally:
        srv.close()
        predictor.threshold = old


def test_error_paths(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, b"not an image at all", "image/jpeg")
    assert e.value.code == 400
    assert "error" in json.loads(e.value.read())
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, b"{broken", "application/json")
    assert e.value.code == 400
    body = json.dumps({"images": ["!!!not-base64!!!"]}).encode()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, body, "application/json")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, _jpeg_bytes(0), "image/jpeg", path="/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(server, "/nope"), timeout=30)
    assert e.value.code == 404
    req = urllib.request.Request(_url(server, "/v1/predict"), data=b"",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    with urllib.request.urlopen(_url(server, "/stats"), timeout=30) as r:
        assert json.loads(r.read())["errors"] >= 5
    assert "prediction" in _post(server, _jpeg_bytes(2), "image/jpeg")


def test_oversized_body_closes_keepalive_connection(server, monkeypatch):
    """A 413 sent without reading the body drops the connection, so the
    unread bytes are never parsed as the next request."""
    import socket

    monkeypatch.setattr(serve_mod, "MAX_BODY_BYTES", 64)
    host, port = server.server_address[:2]
    body = b"\xff" * 256
    head = (f"POST /v1/predict HTTP/1.1\r\nHost: {host}\r\n"
            f"Content-Type: image/jpeg\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode()
    with socket.create_connection((host, port), timeout=30) as s:
        s.sendall(head + body)
        s.settimeout(30)
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = s.recv(4096)
            assert chunk, f"connection died before a status line: {data!r}"
            data += chunk
        assert b" 413 " in data.split(b"\r\n", 1)[0]
        try:
            while s.recv(4096):
                pass
        except ConnectionError:
            pass


def test_json_batch_image_count_is_capped(server, monkeypatch):
    monkeypatch.setattr(serve_mod, "MAX_IMAGES_PER_REQUEST", 4)
    blob64 = base64.b64encode(_jpeg_bytes(0)).decode()
    body = json.dumps({"images": [blob64] * 5}).encode()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, body, "application/json")
    assert e.value.code == 413
    assert "limit is 4" in json.loads(e.value.read())["error"]
    body = json.dumps({"images": [blob64] * 4}).encode()
    assert len(_post(server, body, "application/json")["results"]) == 4


def test_submit_after_close_raises_not_hangs(predictor):
    b = DynamicBatcher(predictor, max_batch=4, window_ms=0.0)
    b.close()
    with pytest.raises(RuntimeError, match="shutting down"):
        b.submit_many([np.zeros((32, 32, 3), np.uint8)])
    b.close()  # idempotent


def test_stats_reset_zeroes_counters():
    st = ServerStats()
    st.count_request(3)
    st.count_batch(3)
    st.count_error()
    st.reset()
    assert all(v == 0 for v in st.snapshot().values())


def _concurrently(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()


def test_dynamic_batching_coalesces_concurrent_requests(predictor):
    """Concurrent requests share forwards (batches < images), and every
    answer matches the offline predictor."""
    srv = PredictionServer(("127.0.0.1", 0), predictor,
                           max_batch=8, window_ms=250.0).start()
    try:
        blobs = [_jpeg_bytes(i) for i in range(8)]
        want = [_predictor_reference(predictor, b) for b in blobs]
        results = [None] * len(blobs)

        def hit(i):
            results[i] = _post(srv, blobs[i], "image/jpeg")

        _concurrently(hit, len(blobs))
        for got, (pred, score) in zip(results, want):
            assert got["prediction"] == pred
            assert abs(got["score"] - score) < 1e-6
        stats = srv.batcher.stats.snapshot()
        assert stats["images"] == len(blobs)
        assert stats["batches"] < len(blobs)
        assert stats["mean_batch"] > 1.0
    finally:
        srv.close()


def test_connection_burst_survives_listen_backlog(predictor):
    """64 simultaneous connects: request_queue_size absorbs the burst."""
    srv = PredictionServer(("127.0.0.1", 0), predictor,
                           max_batch=8, window_ms=0.0).start()
    barrier = threading.Barrier(64)
    errors = []

    def hit(i):
        try:
            barrier.wait(timeout=60)
            _post(srv, _jpeg_bytes(i), "image/jpeg")
        except Exception as exc:
            errors.append(exc)

    try:
        _concurrently(hit, 64)
        assert not errors, errors[:3]
        assert srv.batcher.stats.snapshot()["images"] == 64
    finally:
        srv.close()


def test_batcher_propagates_predict_errors_and_recovers():
    class Flaky:
        calls = 0

        def predict(self, images, return_features=False):
            Flaky.calls += 1
            if Flaky.calls == 1:
                raise RuntimeError("boom")
            return _answer(len(images))

    b = DynamicBatcher(Flaky(), max_batch=4, window_ms=0.0)
    try:
        img = np.zeros((8, 8, 3), np.uint8)
        with pytest.raises(RuntimeError, match="boom"):
            b.submit_many([img])
        assert b.submit_many([img])[0][0] == 0
        assert b.health()["alive"] is True
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="shutting down"):
        b.submit_many([np.zeros((8, 8, 3), np.uint8)])


class _Hung:
    """A predictor whose forwards after the first wait for ``release``;
    the geometry attributes are what healthz and decode read."""
    n_classes = 2
    image_size = 32
    threshold = 0.0
    mode = "softmax"
    has_background = False

    def __init__(self, wait=30):
        self.calls = 0
        self.release = threading.Event()
        self.wait = wait

    def predict(self, images, return_features=False):
        self.calls += 1
        if self.calls > 1:
            self.release.wait(self.wait)
        return _answer(len(images))


def test_wedged_device_thread_degrades_healthz_and_bounds_waits():
    """A forward that never returns: requests fail bounded (503), healthz
    flips to 503 ``wedged``; once the forward ends, health recovers."""
    hung = _Hung()
    srv = PredictionServer(("127.0.0.1", 0), hung, max_batch=4,
                           window_ms=0.0, request_timeout_s=0.5).start()
    try:
        img = np.zeros((8, 8, 3), np.uint8)
        srv.batcher.submit_many([img])  # completes: the grace is spent
        t0 = time.monotonic()
        with pytest.raises(PredictionTimeout, match="did not complete"):
            srv.batcher.submit_many([img])
        assert time.monotonic() - t0 < 5.0, "wait was not bounded"
        time.sleep(0.2)
        code, info = _healthz(srv)
        assert code == 503 and info["status"] == "wedged"
        assert info["batcher"]["wedged"] is True
        assert info["batcher"]["alive"] is True
        assert info["batcher"]["inflight_forward_s"] > 0.5
        req = urllib.request.Request(
            _url(srv, "/v1/predict"), data=_jpeg_bytes(0), method="POST",
            headers={"Content-Type": "image/jpeg"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 503
        assert "timed out" in json.loads(err.value.read())["error"]
        hung.release.set()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            code, info = _healthz(srv)
            if code == 200:
                break
            time.sleep(0.05)
        assert info["status"] == "ok"
        assert info["batcher"]["wedged"] is False
        assert info["batcher"]["last_forward_age_s"] is not None
    finally:
        hung.release.set()
        srv.close()


def test_close_with_wedged_forward_returns_bounded(monkeypatch):
    """close() abandons a wedged (daemonic) batcher thread after a bounded
    join instead of blocking on it."""
    monkeypatch.setattr(DynamicBatcher, "CLOSE_MARGIN_S", 0.5)
    hung = _Hung(wait=60)
    b = DynamicBatcher(hung, max_batch=4, window_ms=0.0,
                       request_timeout_s=0.3)
    try:
        b.submit_many([np.zeros((8, 8, 3), np.uint8)])
        with pytest.raises(PredictionTimeout):
            b.submit_many([np.zeros((8, 8, 3), np.uint8)])
        t0 = time.monotonic()
        b.close()
        assert time.monotonic() - t0 < 5.0
        assert b._thread.is_alive()  # abandoned, not joined
    finally:
        hung.release.set()


def test_first_forward_gets_compile_grace(monkeypatch):
    """A predictor without bucket tracking: its first forward may be slow
    (grace floor); once one forward completed, the plain timeout."""
    class SlowFirst:
        calls = 0

        def predict(self, images, return_features=False):
            SlowFirst.calls += 1
            if SlowFirst.calls == 1:
                time.sleep(0.8)
            return _answer(len(images))

    monkeypatch.setattr(DynamicBatcher, "FIRST_FORWARD_GRACE_S", 5.0)
    b = DynamicBatcher(SlowFirst(), max_batch=4, window_ms=0.0,
                       request_timeout_s=0.3)
    try:
        assert b._effective_timeout() == 5.0
        done = {}

        def submit():
            done["out"] = b.submit_many([np.zeros((8, 8, 3), np.uint8)])

        t = threading.Thread(target=submit)
        t.start()
        time.sleep(0.5)
        assert b.health()["wedged"] is False
        t.join(10)
        assert done["out"][0][0] == 0
        assert b._effective_timeout() == 0.3
    finally:
        b.close()


class _Buckets:
    """A predictor with the port's bucket tracking: the buckets in
    ``warm`` have completed a forward; every bucket up to ``max_batch``
    counts as compiled only when all are warm (the JAX predicate)."""

    def __init__(self, warm=(), sleep=0.0):
        self.warm = set(warm)
        self.sleep = sleep
        self.started = threading.Event()

    def _bucket(self, n):
        return 1 << max(0, n - 1).bit_length()

    def bucket_warm(self, n):
        return self._bucket(n) in self.warm

    def buckets_compiled_up_to(self, max_batch):
        return all(self._bucket(n) in self.warm
                   for n in range(1, max_batch + 1))

    def predict(self, images, return_features=False):
        self.started.set()
        time.sleep(self.sleep)
        self.warm.add(self._bucket(len(images)))
        return _answer(len(images))


def test_compile_grace_follows_the_bucket_in_use():
    """The grace predicate is the bucket in use, not "first forward
    only": a completed forward of bucket 1 leaves the grace on for a
    batch of 3 (bucket 4, cold), and warm buckets get the plain timeout."""
    p = _Buckets()
    b = DynamicBatcher(p, max_batch=8, window_ms=0.0, request_timeout_s=0.3)
    try:
        assert b._effective_timeout() == b.FIRST_FORWARD_GRACE_S
        b.submit_many([np.zeros((8, 8, 3), np.uint8)])
        assert p.warm == {1}
        assert b._effective_timeout() == 0.3   # the next lone request
        assert b._cold(3) and not b._cold(1)
        b.submit_many([np.zeros((8, 8, 3), np.uint8)] * 3)
        assert p.warm == {1, 4} and not b._cold(3)
    finally:
        b.close()


def test_warmed_predictor_reports_ladder_compiled(predictor):
    """The real predictor's bucket tracking: cold at construction, warm
    after warmup(max_batch); a plain predict() records its own bucket."""
    import copy

    p = copy.copy(predictor)
    p._warm_buckets = set()
    assert not p.buckets_compiled_up_to(8) and not p.bucket_warm(1)
    p.warmup(8)
    assert p.buckets_compiled_up_to(8)
    assert all(p.bucket_warm(n) for n in range(1, 9))
    assert not p.buckets_compiled_up_to(64) and not p.bucket_warm(9)
    p2 = copy.copy(predictor)
    p2._warm_buckets = set()
    p2.predict(np.zeros((2, 32, 32, 3), np.uint8))
    assert p2.bucket_warm(2) and not p2.bucket_warm(1)
    assert not p2.buckets_compiled_up_to(2)
    p2.predict(np.zeros((1, 32, 32, 3), np.uint8))
    assert p2.buckets_compiled_up_to(2)


def test_request_timeout_zero_waits_forever():
    class Slow:
        def predict(self, images, return_features=False):
            time.sleep(0.3)
            return _answer(len(images))

    b = DynamicBatcher(Slow(), max_batch=4, window_ms=0.0,
                       request_timeout_s=0)
    try:
        assert b.request_timeout is None and b._effective_timeout() is None
        assert b.submit_many([np.zeros((8, 8, 3), np.uint8)])[0][0] == 0
    finally:
        b.close()


# -- the three faults of the JAX daemon, repaired -------------------------------

def _poison(batcher):
    def gather(batch):
        raise RuntimeError("poisoned _gather")

    batcher._gather = gather


def test_dead_batcher_thread_is_seen_and_fails_fast(predictor):
    """(a) An exception outside a batch's own handling ends the batcher
    thread.  The JAX daemon kept answering 200 and let every request wait
    out its whole budget; here the request in hand fails at once, healthz
    answers 503 ``dead`` and later submits fail at once."""
    predictor.warmup(8)  # no cold-bucket grace: a 5 s budget
    srv = PredictionServer(("127.0.0.1", 0), predictor, max_batch=8,
                           window_ms=0.0, request_timeout_s=5.0).start()
    try:
        _poison(srv.batcher)
        img = np.zeros((SIZE, SIZE, 3), np.uint8)
        t0 = time.monotonic()
        with pytest.raises(BatcherDead, match="poisoned"):
            srv.batcher.submit_many([img, img])
        assert time.monotonic() - t0 < 1.0
        srv.batcher._thread.join(5)
        assert not srv.batcher._thread.is_alive()
        code, info = _healthz(srv)
        assert code == 503 and info["status"] == "dead"
        assert info["batcher"]["alive"] is False
        assert info["batcher"]["wedged"] is True
        t0 = time.monotonic()
        with pytest.raises(BatcherDead):
            srv.batcher.submit_many([img])
        req = urllib.request.Request(
            _url(srv, "/v1/predict"), data=_jpeg_bytes(0), method="POST",
            headers={"Content-Type": "image/jpeg"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 503
        assert time.monotonic() - t0 < 2.0
    finally:
        srv.close()


def test_stalled_queue_marks_the_daemon_wedged():
    """(a) A batcher thread that is alive but takes no work: a request
    waiting past its budget with no forward in flight marks it wedged
    (the JAX probe looked only at a forward in flight)."""
    p = _Buckets(warm={1})
    b = DynamicBatcher(p, max_batch=4, window_ms=0.0, request_timeout_s=0.3)
    stall = threading.Event()
    try:
        def stalled(batch):
            stall.wait(30)
            return DynamicBatcher._gather(b, batch)

        b._gather = stalled
        first, second = (serve_mod._Pending(np.zeros((8, 8, 3), np.uint8))
                         for _ in range(2))
        b._q.put(first)
        deadline = time.monotonic() + 5
        while b.queue_depth() and time.monotonic() < deadline:
            time.sleep(0.01)  # the thread took it and stalls
        b._q.put(second)
        assert b.health()["wedged"] is False
        while not b.health()["wedged"] and time.monotonic() < deadline:
            time.sleep(0.05)
        health = b.health()
        assert health["wedged"] is True and health["alive"] is True
        assert health["inflight_forward_s"] is None
        assert health["oldest_wait_s"] > 0.3
        stall.set()
        assert first.event.wait(10) and second.event.wait(10)
        assert first.result[0] == second.result[0] == 0
        assert b.health()["wedged"] is False
    finally:
        stall.set()
        b.close()


def test_close_waits_out_a_cold_buckets_grace(monkeypatch):
    """(b) close() bounds its join by the effective timeout: a cold
    bucket's slow first forward (longer than request_timeout + margin,
    shorter than the grace) finishes and the thread ends.  The JAX join
    (request_timeout + margin) abandoned it."""
    monkeypatch.setattr(DynamicBatcher, "FIRST_FORWARD_GRACE_S", 5.0)
    monkeypatch.setattr(DynamicBatcher, "CLOSE_MARGIN_S", 0.2)
    p = _Buckets(sleep=1.0)
    b = DynamicBatcher(p, max_batch=4, window_ms=0.0, request_timeout_s=0.1)
    box = {}
    waiter = threading.Thread(target=lambda: box.update(
        out=b.submit_many([np.zeros((8, 8, 3), np.uint8)])))
    waiter.start()
    assert p.started.wait(5)
    b.close()
    assert not b._thread.is_alive()
    waiter.join(5)
    assert box["out"][0][0] == 0


def test_compile_grace_is_per_bucket_not_per_ladder():
    """(c) A slow forward of a warm bucket is a wedge even while a larger
    bucket of the ladder is cold.  The JAX daemon asked whether every
    bucket up to max_batch was warm, so it granted the 600 s grace here
    and reported healthy."""
    hung = _Hung()
    p = _Buckets(warm={1})
    p.predict = hung.predict
    hung.calls = 1  # every forward hangs until released
    b = DynamicBatcher(p, max_batch=64, window_ms=0.0, request_timeout_s=0.3)
    try:
        assert not p.buckets_compiled_up_to(64)
        assert b._effective_timeout() == 0.3
        t0 = time.monotonic()
        with pytest.raises(PredictionTimeout):
            b.submit_many([np.zeros((8, 8, 3), np.uint8)])
        assert time.monotonic() - t0 < 5.0
        time.sleep(0.1)
        health = b.health()
        assert health["wedged"] is True and health["alive"] is True
        assert health["inflight_forward_s"] > 0.3
    finally:
        hung.release.set()
        b.close()


# -- the JAX daemon beside the port's -------------------------------------------

def test_daemon_matches_jax_daemon_in_float32(trained, monkeypatch):
    """The same ``.pth`` and JPEG bytes through both daemons, float32
    models: equal classes, scores within 1e-4."""
    from openset_imagenet_tpu import inference as jinference
    from openset_imagenet_tpu import serve as jserve
    from openset_imagenet_tpu import train as jengine
    from openset_imagenet_tpu_torch import inference as pinference

    jax_build, port_build = jengine.build_model, engine.build_model
    monkeypatch.setattr(jengine, "build_model", lambda cfg, n: jax_build(
        cfg, n).clone(dtype=jax.numpy.float32))
    monkeypatch.setattr(pinference, "build_model",
                        lambda cfg, n, **kw: port_build(
                            cfg, n, dtype=torch.float32, **kw))
    ours = PredictionServer(("127.0.0.1", 0), OpenSetPredictor(
        trained, image_size=SIZE, device="cpu"), max_batch=8,
        window_ms=0.0).start()
    ref = jserve.PredictionServer(("127.0.0.1", 0), jinference.
                                  OpenSetPredictor(trained, variant="tiny",
                                                   image_size=SIZE),
                                  max_batch=8, window_ms=0.0).start()
    try:
        blobs = [_jpeg_bytes(40 + i) for i in range(5)]
        body = json.dumps({"images": [base64.b64encode(b).decode()
                                      for b in blobs]}).encode()
        got = _post(ours, body, "application/json")["results"]
        want = _post(ref, body, "application/json")["results"]
        got += [_post(ours, blobs[0], "image/jpeg")]
        want += [_post(ref, blobs[0], "image/jpeg")]
        for g, w in zip(got, want):
            assert g["prediction"] == w["prediction"]
            assert g["rejected"] == w["rejected"]
            assert abs(g["score"] - w["score"]) <= 1e-4
    finally:
        ours.close()
        ref.close()


# -- the CLI --------------------------------------------------------------------

def test_serve_cli_args(tmp_path, monkeypatch):
    from openset_imagenet_tpu_torch.script.serve import get_args, main

    args = get_args(["model.pth", "auto", "--port", "0",
                     "--batch-window-ms", "5"])
    assert args.n_classes is None and args.batch_window_ms == 5.0
    assert args.device == "cuda"
    for argv in (["model.pth", "3", "--gpu", "0", "--devices", "2"],
                 ["model.pth", "3", "--threshold-at-fpr", "0.01"],
                 ["model.pth", "3", "--compile-cache", "d",
                  "--no-compile-cache"],
                 ["ck.pth", "3", "--optimize", "int8"],
                 ["ck.pth", "3", "--calibration-images", "x/"]):
        with pytest.raises(SystemExit):
            get_args(argv)
    with pytest.raises(NotImplementedError, match="item 8"):
        main(["ck.pth", "3", "--devices", "2", "--device", "cpu"])

    # The --optimize flags reach the predictor: fold_bn, and int8 with the
    # calibration paths collected from --calibration-images (the predictor
    # is replaced by a recorder that stops main before it serves).
    class Built(Exception):
        pass

    def record(*args, **kw):
        raise Built(kw)

    monkeypatch.setattr("openset_imagenet_tpu_torch.inference."
                        "OpenSetPredictor", record)
    image = tmp_path / "cal" / "im.jpg"
    image.parent.mkdir()
    image.write_bytes(b"not decoded here")
    for argv, want in (
            (["--optimize", "fold_bn"], ("fold_bn", None, None)),
            (["--optimize", "int8", "--calibration-images",
              str(image.parent), "--calibration-percentile", "99.9"],
             ("int8", [str(image)], 99.9))):
        with pytest.raises(Built) as built:
            main(["ck.pth", "3", *argv, "--device", "cpu"])
        kw = built.value.args[0]
        assert (kw["optimize"], kw["calibration"],
                kw["calibration_percentile"]) == want


def test_serve_cli_end_to_end(trained):
    """start -> healthz -> predict -> SIGTERM -> exit 0, on the CPU."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "openset_imagenet_tpu_torch.script.serve",
         str(trained), "auto", "--port", "0", "--image-size", "32",
         "--max-batch", "4", "--host", "127.0.0.1", "--device", "cpu"],
        env=env, stderr=subprocess.PIPE, text=True, cwd=REPO)
    lines = []
    try:
        url = None
        while True:
            line = proc.stderr.readline()
            if not line:
                pytest.fail("server exited before start-up:\n"
                            + "".join(lines))
            lines.append(line)
            m = re.search(r"http://127\.0\.0\.1:(\d+)", line)
            if m:
                url = f"http://127.0.0.1:{m.group(1)}"
                break
        assert any("warming up batch buckets to 4" in x for x in lines)
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        req = urllib.request.Request(
            url + "/v1/predict", data=_jpeg_bytes(3), method="POST",
            headers={"Content-Type": "image/jpeg"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["prediction"] in (0, 1, 2)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    assert proc.returncode == 0


def test_decode_to_input_matches_eval_geometry(tmp_path):
    """Served bytes decode as the evaluation reader reads the same file
    (shorter-side resize + center crop)."""
    from PIL import Image

    from openset_imagenet_tpu_torch.config import NameSpace

    rng = np.random.default_rng(7)
    path = tmp_path / "img.jpg"
    Image.fromarray(rng.integers(0, 256, (48, 40, 3), np.uint8)).save(
        path, format="JPEG", quality=95)
    reader = engine._make_reader(
        NameSpace({"data": {"reader": "auto"}, "seed": 0}), crop=32)
    if hasattr(reader, "read_batch"):
        want = reader.read_batch([str(path)], [None])[0]
    else:
        want = reader(str(path), None)
    np.testing.assert_array_equal(decode_to_input(path.read_bytes(), 32),
                                  want)
