"""Online serving daemon: HTTP API + dynamic batching over the predictor.

Counterpart of :mod:`openset_imagenet_tpu.serve`.  Design, as there:

* **One device thread.**  Every forward runs on the batcher thread; HTTP
  handler threads only decode and wait.
* **Dynamic batching.**  Requests arriving within ``window_ms`` of each
  other share one padded forward (the predictor's power-of-two buckets);
  a full batch goes at once, and a lone request waits at most the window.
* **stdlib only.**  ``http.server.ThreadingHTTPServer`` + ``json`` +
  ``base64``.

API (JSON responses): ``GET /healthz`` (liveness and the model's geometry
and operating point; 503 when the batcher is wedged or dead), ``GET
/stats`` (request, image, batch and error counters), ``POST /v1/predict``
(or ``/predict``) with a raw image body -> one result, or with a JSON body
``{"images": ["<base64>", ...]}`` -> ``{"results": [...]}``; a result is
``{"prediction", "score", "rejected"}`` (+ ``"features"`` with
``?features=1``), rejected samples carrying ``-1``.

Request bytes decode through the evaluation geometry (native fused JPEG
decode, PIL for what it rejects): :func:`decode_many_to_input`, called by
:meth:`PredictionServer.decode`, the one place that turns bodies into
pixels.

Three faults of the JAX daemon are repaired here:

* a batcher thread that ends on an exception outside a batch's own
  handling (JAX ``serve.py:402-405``) is seen: every waiting request
  fails at once, later submits fail at once, and ``/healthz`` answers 503
  ``dead``; a request that waited past its budget while no forward ran
  also marks the daemon wedged;
* ``close()`` bounds its join by the effective timeout, cold-bucket grace
  included, plus a margin (JAX ``serve.py:353`` used the plain timeout);
* the grace applies while the bucket of the batch in flight, or of the
  batch the queue would form, is cold (JAX ``serve.py:296`` asked about
  every bucket up to ``max_batch``).
"""

from __future__ import annotations

import base64
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

import numpy as np

MAX_BODY_BYTES = 128 * 1024 * 1024  # reject absurd uploads before reading
# Decoded images wait in host memory for the forward; one JSON batch may
# carry at most this many (1024 x 224x224x3 uint8 ~= 154 MB).
MAX_IMAGES_PER_REQUEST = 1024


def decode_many_to_input(blobs, image_size: int,
                         resize: Optional[int] = None) -> list:
    """Decode a request's blobs: one native batch call on the library's
    thread pool (GIL released), PIL replaying only the blobs the native
    decoder rejects, so every image equals :func:`decode_to_input`'s.
    Raises ``ValueError`` for a blob no decoder takes."""
    from .native.jpeg import decode_batch_mem
    from .train import _resize_for_crop

    if resize is None:
        resize = _resize_for_crop(image_size)
    if len(blobs) > 1:
        images, ok = decode_batch_mem(blobs, resize, image_size)
        if images is not None:
            return [images[i] if ok[i]
                    else decode_to_input(blobs[i], image_size, resize)
                    for i in range(len(blobs))]
    return [decode_to_input(b, image_size, resize) for b in blobs]


def decode_to_input(data: bytes, image_size: int,
                    resize: Optional[int] = None) -> np.ndarray:
    """Request bytes -> the model's ``uint8 [S, S, 3]`` eval input:
    shorter-side resize (``train._resize_for_crop``), then center crop;
    the native fused JPEG path first, PIL for the rest (PNG, CMYK,
    damaged files).  Raises ``ValueError`` on bytes no decoder takes."""
    from .native.jpeg import decode_resize_crop, pil_replay
    from .train import _resize_for_crop

    if resize is None:
        resize = _resize_for_crop(image_size)
    out = decode_resize_crop(data, resize, image_size)
    if out is not None:
        return out
    try:
        return pil_replay(data, resize, image_size)
    except Exception as exc:
        raise ValueError(f"undecodable image: {exc}") from exc


class ServerStats:
    """Lock-protected serving counters (read back via ``GET /stats``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.images = 0
        self.batches = 0
        self.errors = 0
        self.max_batch = 0

    def count_request(self, images: int = 1) -> None:
        with self._lock:
            self.requests += 1
            self.images += images

    def count_batch(self, size: int) -> None:
        with self._lock:
            self.batches += 1
            self.max_batch = max(self.max_batch, size)

    def count_error(self) -> None:
        with self._lock:
            self.errors += 1

    def reset(self) -> None:
        """Zero every counter (between warm-up and a measured load)."""
        with self._lock:
            self.requests = self.images = 0
            self.batches = self.errors = self.max_batch = 0

    def snapshot(self) -> dict:
        with self._lock:
            batches = self.batches
            return {
                "requests": self.requests,
                "images": self.images,
                "batches": batches,
                "errors": self.errors,
                "max_batch": self.max_batch,
                "mean_batch": (self.images / batches) if batches else 0.0,
            }


class PredictionTimeout(RuntimeError):
    """A request waited longer than the server's bounded-wait budget
    (HTTP 503): a wedged device thread degrades to fast failures."""


class BatcherDead(RuntimeError):
    """The batcher thread has ended on an error: nothing will be served
    (HTTP 503)."""


class _Pending:
    __slots__ = ("image", "event", "result", "error", "since")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.since = time.monotonic()


class DynamicBatcher:
    """Coalesce concurrent prediction requests into padded device batches.

    ``submit_many`` enqueues decoded images and blocks until the batcher
    thread has run them; images of different requests landing within
    ``window_ms`` share one forward.  ``window_ms=0`` never waits: it
    drains what is already queued.
    """

    _SHUTDOWN = object()

    # While the bucket a forward runs (or the queue would form) has never
    # completed a forward, waits and the wedge check use this floor in
    # place of request_timeout: a cold bucket's first forward pays for
    # cuDNN's algorithm choice and for allocation (an XLA compile in the
    # JAX package), and timing it out would 503 the request and mark the
    # daemon wedged.  A warmed daemon (the default) has no cold bucket.
    FIRST_FORWARD_GRACE_S = 600.0
    # close() waits this much past the effective timeout for the thread.
    CLOSE_MARGIN_S = 5.0

    def __init__(self, predictor, max_batch: int = 64,
                 window_ms: float = 2.0,
                 request_timeout_s: Optional[float] = 30.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._predictor = predictor
        self.max_batch = int(max_batch)
        self.window = max(0.0, float(window_ms)) / 1000.0
        # None/0 = wait forever (opt-in).
        self.request_timeout = (float(request_timeout_s)
                                if request_timeout_s else None)
        self.stats = ServerStats()
        self._q: "queue.Queue" = queue.Queue()
        self._closed = threading.Event()
        # Liveness (read by /healthz), written by the batcher thread under
        # _health_lock: when the forward in flight started and its size,
        # when the last one completed, and when the thread last took an
        # item or ended a forward.
        self._health_lock = threading.Lock()
        self._forward_started: Optional[float] = None
        self._inflight = 0
        self._last_forward_done: Optional[float] = None
        self._last_progress = time.monotonic()
        # Set (under _submit_lock) when the batcher thread ends on an error.
        self._dead: Optional[BaseException] = None
        # Serialises enqueues against close() and the thread's death: the
        # shutdown sentinel lands after every accepted request, and no
        # request is enqueued after the thread failed the queue.
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="osi-serve-batcher")
        self._thread.start()

    # -- client side --------------------------------------------------------
    def submit_many(self, images) -> list:
        """Blocking: returns ``[(prediction, score, features), ...]``.

        Waits at most the effective timeout (wall clock, across the whole
        request), then raises :class:`PredictionTimeout`; the device thread
        is not interrupted.  Raises :class:`BatcherDead` at once when the
        batcher thread has ended.
        """
        pendings = [_Pending(np.asarray(img, np.uint8)) for img in images]
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("server is shutting down")
            if self._dead is not None or not self._thread.is_alive():
                raise BatcherDead(f"the batcher thread has ended: "
                                  f"{self._dead!r}")
            for p in pendings:
                self._q.put(p)
        budget = self._effective_timeout()
        deadline = time.monotonic() + budget if budget else None
        results = []
        for p in pendings:
            if deadline is None:
                p.event.wait()
            elif not p.event.wait(max(0.0, deadline - time.monotonic())):
                raise PredictionTimeout(
                    f"prediction did not complete within {budget:.0f}s "
                    f"(device thread "
                    f"{'wedged mid-forward' if self.forward_age() is not None else 'backlogged'}; "
                    f"queue depth {self.queue_depth()})")
            if p.error is not None:
                raise p.error
            results.append(p.result)
        return results

    def _cold(self, n: int) -> bool:
        """Could a forward of ``n`` images be the first of its bucket?
        The predictor's ``bucket_warm`` knows; without it, until the first
        successful forward."""
        if n <= 0:
            return False
        warm = getattr(self._predictor, "bucket_warm", None)
        if warm is not None:
            return not warm(n)
        return self.last_forward_age() is None

    def _queued_batch(self) -> int:
        """Size of the batch the queue would form next (at least 1)."""
        return min(max(self.queue_depth(), 1), self.max_batch)

    def _maybe_compiling(self) -> bool:
        """Is the bucket of the batch in flight, or of the batch the queue
        would form, cold?"""
        with self._health_lock:
            inflight = self._inflight
        return self._cold(inflight) or self._cold(self._queued_batch())

    def _timeout(self, cold: bool) -> Optional[float]:
        if not self.request_timeout:
            return None
        if cold:
            return max(self.request_timeout, self.FIRST_FORWARD_GRACE_S)
        return self.request_timeout

    def _effective_timeout(self) -> Optional[float]:
        """request_timeout, floored to the grace while a bucket in use is
        cold (:meth:`_maybe_compiling`)."""
        return self._timeout(self._maybe_compiling())

    # -- liveness (read by /healthz) ----------------------------------------
    def queue_depth(self) -> int:
        """Images waiting in the queue (excludes the batch in flight)."""
        return self._q.qsize()

    def forward_age(self) -> Optional[float]:
        """Seconds the current forward has been running; None when idle."""
        with self._health_lock:
            if self._forward_started is None:
                return None
            return time.monotonic() - self._forward_started

    def last_forward_age(self) -> Optional[float]:
        """Seconds since the last successful forward; None before any."""
        with self._health_lock:
            if self._last_forward_done is None:
                return None
            return time.monotonic() - self._last_forward_done

    def _oldest_wait(self, now: float) -> Optional[float]:
        """Seconds the queue's head has waited with no progress of the
        batcher thread since; None with an empty queue."""
        with self._q.mutex:
            head = self._q.queue[0] if self._q.queue else None
        if head is None:
            return None
        with self._health_lock:
            progress = self._last_progress
        return now - max(getattr(head, "since", now), progress)

    def health(self) -> dict:
        """Batcher liveness snapshot.  ``wedged`` goes true when the thread
        has ended (``alive`` false), when one forward has run longer than
        its budget (its bucket's grace if cold), or when a request has
        waited longer than its budget with no forward in flight and no
        progress of the thread.  An idle daemon is healthy."""
        now = time.monotonic()
        with self._health_lock:
            started, inflight = self._forward_started, self._inflight
            last = self._last_forward_done
        fwd = None if started is None else now - started
        waited = None if fwd is not None else self._oldest_wait(now)
        alive = self._dead is None and self._thread.is_alive()
        stuck = False
        if fwd is not None:
            budget = self._timeout(self._cold(inflight))
            stuck = bool(budget and fwd > budget)
        elif waited is not None:
            budget = self._timeout(self._cold(self._queued_batch()))
            stuck = bool(budget and waited > budget)
        return {"queue_depth": self.queue_depth(),
                "inflight_forward_s": round(fwd, 3) if fwd is not None
                else None,
                "last_forward_age_s": round(now - last, 3)
                if last is not None else None,
                "oldest_wait_s": round(waited, 3) if waited is not None
                else None,
                "alive": alive,
                "wedged": stuck or not alive}

    def close(self) -> None:
        with self._submit_lock:
            if self._closed.is_set():
                return
            self._closed.set()
            self._q.put(self._SHUTDOWN)
        # A wedged forward would hold the (daemonic) thread forever: bound
        # the join by the budget a forward in flight has, cold-bucket
        # grace included, so a cold bucket's slow first forward ends.
        grace = (self._effective_timeout() or 30.0) + self.CLOSE_MARGIN_S
        self._thread.join(timeout=grace)
        if self._thread.is_alive():
            logging.getLogger(__name__).warning(
                "batcher thread still running %.0fs after shutdown "
                "(wedged forward?); abandoning it -- daemon threads die "
                "with the process", grace)
        # Fail anything still queued, so no handler waits on it forever.
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is self._SHUTDOWN:
                # An abandoned (slow, not dead) thread that finishes its
                # forward later still needs the sentinel to exit.
                self._q.put(item)
                break
            if isinstance(item, _Pending):
                item.error = RuntimeError("server is shutting down")
                item.event.set()

    # -- device side --------------------------------------------------------
    def _gather(self, batch: list) -> bool:
        """Fill ``batch`` (holding the first queue item) up to
        ``max_batch`` within the window; False on the shutdown sentinel."""
        if batch[0] is self._SHUTDOWN:
            return False
        deadline = time.monotonic() + self.window
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            try:
                item = (self._q.get_nowait() if timeout <= 0
                        else self._q.get(timeout=timeout))
            except queue.Empty:
                break
            if item is self._SHUTDOWN:
                # Serve what we have; the sentinel comes round again.
                self._q.put(self._SHUTDOWN)
                break
            batch.append(item)
        return True

    def _serve(self, batch: list) -> None:
        """One forward for ``batch``; every pending gets a result or the
        error."""
        try:
            images = np.stack([p.image for p in batch])
            with self._health_lock:
                self._forward_started = time.monotonic()
                self._inflight = len(batch)
            preds, scores, feats = self._predictor.predict(
                images, return_features=True)
            for i, p in enumerate(batch):
                p.result = (int(preds[i]), float(scores[i]),
                            np.asarray(feats[i]))
        except BaseException as exc:
            for p in batch:
                p.error = exc
            if not isinstance(exc, Exception):
                raise
        else:
            self.stats.count_batch(len(batch))
            # Success only: a batch that failed fast proves no warm bucket.
            with self._health_lock:
                self._last_forward_done = time.monotonic()
        finally:
            with self._health_lock:
                self._forward_started = None
                self._inflight = 0
                self._last_progress = time.monotonic()
            for p in batch:
                p.event.set()

    def _run(self) -> None:
        batch = []
        try:
            while True:
                batch = [self._q.get()]
                with self._health_lock:
                    self._last_progress = time.monotonic()
                if not self._gather(batch):
                    return
                self._serve(batch)
                batch = []
        except BaseException as exc:
            self._die(exc, batch)
            raise

    def _die(self, exc: BaseException, batch: list) -> None:
        """The thread is ending on ``exc``: fail the batch in hand and every
        queued request, and refuse new ones."""
        logging.getLogger(__name__).error(
            "batcher thread died: %r; failing %d queued requests", exc,
            self.queue_depth() + len(batch))
        error = BatcherDead(f"the batcher thread died: {exc!r}")
        with self._submit_lock:
            self._dead = exc
            items = list(batch)
            while True:
                try:
                    items.append(self._q.get_nowait())
                except queue.Empty:
                    break
            for item in items:
                if isinstance(item, _Pending) and not item.event.is_set():
                    item.error = error
                    item.event.set()


class _Handler(BaseHTTPRequestHandler):
    server_version = "osi-serve/1.0"
    protocol_version = "HTTP/1.1"
    # A response is two writes (headers, body): with Nagle's algorithm the
    # body waits for the client's delayed ACK of the headers (~40 ms on
    # Linux) on every keep-alive request.
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # noqa: A002 - stdlib signature
        self.server.log.debug("%s %s" % (self.address_string(),
                                         fmt % args))

    # -- plumbing -----------------------------------------------------------
    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str) -> None:
        self.server.batcher.stats.count_error()
        self._send_json(code, {"error": message})

    # -- routes -------------------------------------------------------------
    def do_GET(self):  # noqa: N802 - stdlib casing
        path = urlsplit(self.path).path
        if path == "/healthz":
            p = self.server.predictor
            health = self.server.batcher.health()
            # Liveness, not just readiness: a dead or wedged batcher flips
            # the probe non-200, so an orchestrator restarts the daemon.
            status = ("dead" if not health["alive"] else
                      "wedged" if health["wedged"] else "ok")
            self._send_json(200 if status == "ok" else 503, {
                "status": status,
                "n_classes": p.n_classes,
                "image_size": p.image_size,
                "threshold": p.threshold,
                "mode": p.mode,
                "has_background": p.has_background,
                "batcher": health,
            })
        elif path == "/stats":
            self._send_json(200, self.server.batcher.stats.snapshot())
        else:
            self._error(404, f"no such route: {path}")

    def do_POST(self):  # noqa: N802 - stdlib casing
        url = urlsplit(self.path)
        if url.path not in ("/v1/predict", "/predict"):
            self._error(404, f"no such route: {url.path}")
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            # Unread body bytes would be parsed as the next request on a
            # keep-alive socket: drop the connection on every error before
            # the body is read.
            self.close_connection = True
            self._error(400, "bad Content-Length")
            return
        if length <= 0:
            self.close_connection = True
            self._error(400, "empty request body")
            return
        if length > MAX_BODY_BYTES:
            self.close_connection = True
            self._error(413, f"body exceeds {MAX_BODY_BYTES} bytes")
            return
        body = self.rfile.read(length)
        query = parse_qs(url.query)
        want_features = query.get("features", ["0"])[-1].lower() in (
            "1", "true", "yes")
        ctype = self.headers.get("Content-Type", "").split(";")[0].strip()

        batched = ctype == "application/json"
        if batched:
            try:
                payload = json.loads(body)
                blobs = [base64.b64decode(b, validate=True)
                         for b in payload["images"]]
            except Exception as exc:
                self._error(400, f"bad JSON request: {exc}")
                return
            if len(blobs) > MAX_IMAGES_PER_REQUEST:
                self._error(413, f"request carries {len(blobs)} images; "
                                 f"limit is {MAX_IMAGES_PER_REQUEST}")
                return
        else:
            blobs = [body]
        try:
            images = self.server.decode(blobs)
        except ValueError as exc:
            self._error(400, str(exc))
            return

        self.server.batcher.stats.count_request(len(images))
        try:
            results = self.server.batcher.submit_many(images)
        except PredictionTimeout as exc:
            self._error(503, f"prediction timed out: {exc}")
            return
        except BatcherDead as exc:
            self._error(503, str(exc))
            return
        except Exception as exc:
            self._error(500, f"prediction failed: {exc}")
            return
        out = []
        for pred, score, feats in results:
            row = {"prediction": pred, "score": score,
                   "rejected": pred == -1}
            if want_features:
                row["features"] = [float(v) for v in feats]
            out.append(row)
        self._send_json(200, {"results": out} if batched else out[0])


class PredictionServer(ThreadingHTTPServer):
    """HTTP serving daemon around an :class:`~.inference.OpenSetPredictor`.

    ``srv = PredictionServer(("127.0.0.1", 0), predictor).start()`` --
    ``srv.server_address`` carries the bound port; drive traffic, then
    ``srv.close()``.  Handler threads are daemonic: a hung client never
    blocks shutdown.
    """

    daemon_threads = True
    # socketserver's default listen backlog is 5: a burst of simultaneous
    # connects would be reset before the accept loop saw them.
    request_queue_size = 128

    def __init__(self, address, predictor, max_batch: int = 64,
                 window_ms: float = 2.0,
                 request_timeout_s: Optional[float] = 30.0):
        from .logger import configure_logger
        from .train import _resize_for_crop

        self.predictor = predictor
        self.resize = _resize_for_crop(predictor.image_size)
        self.log = configure_logger()
        self._serve_thread: Optional[threading.Thread] = None
        # Bind first: a port-in-use failure must not leak a batcher thread.
        super().__init__(address, _Handler)
        self.batcher = DynamicBatcher(predictor, max_batch=max_batch,
                                      window_ms=window_ms,
                                      request_timeout_s=request_timeout_s)

    def decode(self, blobs) -> list:
        """A request's bodies -> the model's ``uint8 [S, S, 3]`` inputs
        (:func:`decode_many_to_input`); raises ``ValueError`` (HTTP 400)."""
        return decode_many_to_input(blobs, self.predictor.image_size,
                                    self.resize)

    def start(self) -> "PredictionServer":
        """Serve in a background thread; the caller's thread stays free."""
        self._serve_thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="osi-serve-http")
        self._serve_thread.start()
        return self

    def close(self) -> None:
        """Stop accepting, drain the batcher, release the socket.
        ``shutdown()`` is issued only when :meth:`start` ran a loop, so a
        server never started closes without deadlock."""
        if self._serve_thread is not None and self._serve_thread.is_alive():
            self.shutdown()
            self._serve_thread.join()
        if getattr(self, "batcher", None) is not None:  # init may have raised
            self.batcher.close()
        self.server_close()
