"""Online serving traffic: the daemon (``serve.PredictionServer`` ->
``DynamicBatcher`` -> ``OpenSetPredictor.predict``) under an open loop of
single-image requests from a client in another process
(:mod:`.serve_client`).

Set-up writes the seeded weights as a ``.pth`` (as the prediction traffic
does), builds the predictor, warms its buckets up to ``max_batch`` and
starts the daemon with ``max_batch`` and ``window_ms``.  The daemon is
the program's, with one change of the benchmark's: ``decode`` takes raw
``size x size x 3`` bodies, since the card's host has no JPEG decoder.
The window is the client's schedule: Poisson arrivals at ``rate`` for
``seconds``, after ``lead_seconds`` of the same load (set-up: the first
seconds of a load read slower, as handler threads start and queues
settle).  ``serve_p95_ms`` is the 95th percentile (nearest rank) over
every request due in the window, each timed from when it was due to its
response; one that failed or never came counts as the longest wait the
run allows (``seconds + grace``).  With ``--trace 1`` the schedule runs
on past the window, and the profiler covers ``trace_seconds`` of it once
it has started.

Check: ``check_rows`` completed requests of the window drawn from the
seed, each answer against the reference's eval-mode logits of its image;
``missing`` counts the requests of the window without an answer.
"""

from __future__ import annotations

import http.client
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

from . import data, harness, profile
from .drive_predict import check_answers, write_checkpoint

CLIENT = pathlib.Path(__file__).resolve().parent / "serve_client.py"
PROFILER_START_S = 5.0


def raw_server_class(spans):
    """``PredictionServer`` whose ``decode`` takes raw pixel bodies, under
    an ``http`` span."""
    from openset_imagenet_tpu_torch.serve import PredictionServer

    class RawServer(PredictionServer):
        def decode(self, blobs):
            with spans.span("http"):
                size = self.predictor.image_size
                if any(len(b) != size * size * 3 for b in blobs):
                    raise ValueError(f"a body is not {size}x{size}x3 raw "
                                     "bytes")
                return [np.frombuffer(b, np.uint8).reshape(size, size, 3)
                        for b in blobs]

    return RawServer


def start(ctx: harness.Ctx, images: data.Images):
    """The warmed predictor and the started daemon; returns ``(server,
    weights)``."""
    from openset_imagenet_tpu_torch.inference import OpenSetPredictor

    tr, spans = ctx.traffic, ctx.spans
    ckpt = ctx.out_dir / f"{ctx.cell['name']}.pth"
    with spans.span("setup.checkpoint"):
        weights = write_checkpoint(ctx, images, ckpt)
    with spans.span("setup.predictor"):
        predictor = OpenSetPredictor(ckpt, device=ctx.device,
                                     image_size=int(ctx.config["image_size"]),
                                     optimize=tr.get("optimize"))
        predictor.warmup(int(tr["max_batch"]))
    predict = predictor.predict

    def spanned(*args, **kwargs):
        with spans.span("batcher"):
            return predict(*args, **kwargs)

    predictor.predict = spanned
    server = raw_server_class(spans)(
        ("127.0.0.1", 0), predictor, max_batch=int(tr["max_batch"]),
        window_ms=float(tr["window_ms"])).start()
    return server, weights


def stats(server) -> dict:
    """The daemon's ``GET /stats``, straight to its socket."""
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                      timeout=30)
    try:
        conn.request("GET", "/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def load(ctx: harness.Ctx, server, rate: float, seconds: float,
         extra_s: float = 0.0, during=None) -> dict:
    """Run the client at ``rate`` for ``seconds`` (+ ``extra_s``).

    Returns the client's rows and, read at the window's two ends, the
    daemon's ``/stats``; ``during(t0)`` runs once the window has closed
    (the traced stretch).  ``setup_s`` is read when the client starts its
    schedule.
    """
    tr = ctx.traffic
    grace = float(tr.get("grace_s", 60.0))
    cmd = [sys.executable, str(CLIENT), "--port",
           str(server.server_address[1]), "--seed", str(ctx.seed),
           "--rate", str(rate), "--seconds", str(seconds),
           "--lead", str(float(tr.get("lead_seconds", 0.0))),
           "--extra", str(extra_s),
           "--distinct", str(int(tr["distinct_images"])), "--size",
           str(int(ctx.config["image_size"])), "--connections",
           str(int(tr["connections"])), "--grace", str(grace)]
    err = open(ctx.out_dir / f"{ctx.cell['name']}.client.err", "w")
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        if proc.stdout.readline().strip() != "ready":
            raise RuntimeError("the load client did not start")
        proc.stdin.write("go\n")
        proc.stdin.flush()
        t0 = float(proc.stdout.readline().split()[1])
        time.sleep(max(0.0, t0 - time.monotonic()))
        setup = harness.setup_seconds(ctx)
        s0 = stats(server)
        time.sleep(max(0.0, t0 + seconds - time.monotonic()))
        s1 = stats(server)
        extra = during(t0) if during is not None else None
        out, _ = proc.communicate(timeout=seconds + extra_s + grace + 60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    if proc.returncode != 0:
        raise RuntimeError(f"the load client exited {proc.returncode}")
    rows = json.loads(out.strip().splitlines()[-1])["rows"]
    return {"rows": rows, "stats0": s0, "stats1": s1, "setup": setup,
            "extra": extra, "grace": grace}


def summarize_rows(rows, seconds: float, grace: float) -> dict:
    """Latency and lag of the requests due in the window, in ms."""
    win = [r for r in rows if 0.0 <= r[0] < seconds]
    worst = (seconds + grace) * 1e3
    lat = sorted((r[2] - r[0]) * 1e3 if r[3] == 200 and r[2] is not None
                 else worst for r in win)
    lag = sorted((r[1] - r[0]) * 1e3 for r in win if r[1] is not None)

    def p95(v):
        return v[max(0, math.ceil(0.95 * len(v)) - 1)] if v else math.nan

    ok = [r for r in win if r[3] == 200 and r[2] is not None]
    last_done = max((r[2] for r in ok), default=0.0)
    return {"window": win, "ok": ok, "p95_ms": p95(lat),
            "p50_ms": lat[len(lat) // 2] if lat else math.nan,
            "lag_p95_ms": p95(lag), "failed": len(win) - len(ok),
            "completed_per_s": len(ok) / max(seconds, last_done, 1e-9)}


def run(ctx: harness.Ctx) -> harness.Result:
    cfg, tr, dev, spans = ctx.config, ctx.traffic, ctx.device, ctx.spans
    images = data.Images(ctx.seed, int(tr["distinct_images"]),
                         int(cfg["image_size"]))
    server, weights = start(ctx, images)
    trace_s = float(tr.get("trace_seconds", 2.0)) if ctx.trace else 0.0

    def traced(t0):
        trace = profile.Trace(dev, all_threads=True).start()
        time.sleep(trace_s)
        trace.stop()
        return trace

    # The schedule runs on past the traced stretch by the time the
    # profiler may take to start.
    extra = trace_s + PROFILER_START_S if ctx.trace else 0.0
    try:
        got = load(ctx, server, float(tr["rate"]), ctx.seconds, extra,
                   traced if ctx.trace else None)
    finally:
        server.close()
    summary = (got["extra"].summary(spans, 0)
               if got["extra"] is not None else None)
    memory = harness.peak_memory(dev)
    predictor = server.predictor
    del server, predictor
    harness.release(dev)

    rep = summarize_rows(got["rows"], ctx.seconds, got["grace"])
    ok = rep["ok"]
    pick = np.sort(data.rng(ctx.seed, 4).choice(
        len(ok), min(int(tr["check_rows"]), len(ok)), replace=False))
    numbers = check_answers(ctx, weights, images, [ok[i][4] for i in pick],
                            [ok[i][5] for i in pick],
                            [ok[i][6] for i in pick])
    numbers["missing"] = rep["failed"]
    s0, s1 = got["stats0"], got["stats1"]
    return harness.Result(
        kind="serve", config=cfg,
        e2e={"serve_p95_ms": rep["p95_ms"], "setup_s": got["setup"]},
        counters={"window_s": ctx.seconds, "requests": len(rep["window"]),
                  "gen_lag_p95_ms": rep["lag_p95_ms"],
                  "p50_ms": rep["p50_ms"],
                  "completed_per_s": rep["completed_per_s"],
                  "stats_images": s1["images"] - s0["images"],
                  "stats_batches": s1["batches"] - s0["batches"],
                  "trace_s": trace_s or None},
        numbers=numbers, attempted=len(rep["window"]), failed=rep["failed"],
        memory_peak_bytes=memory, spans=spans, profile=summary)
