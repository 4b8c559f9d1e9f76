"""Open-loop load generator for the daemon, run as its own process.

    python serve_client.py --port P --seed S --rate R --seconds T
                           [--lead L] [--extra E] --distinct N --size 224
                           --connections C

Single-image requests (``POST /v1/predict`` with a raw ``size x size x
3`` body: seeded image ``j`` of :class:`data.Images`) are due at the
Poisson times of :func:`data.arrivals` over ``T`` seconds, after ``L``
seconds of the same load that warm the daemon up and are not counted, and
before ``E`` seconds more (the traced stretch), each sent on one of ``C``
keep-alive connections opened beforehand; a request that finds every
connection busy waits for one, and that wait counts in its latency.
Protocol on the pipes: the client prints ``ready`` once connected, waits
for a line on its standard input, prints ``t0 <time.monotonic()>`` of the
window's start (``L`` seconds on), runs the schedule, waits at most
``--grace`` seconds for what is in flight, and prints one JSON object:
per request ``[due, woke, done, status, image, prediction, score]``
(seconds from t0, negative in the lead-in; ``done`` null and ``status`` 0
for one that never completed).  It imports numpy only.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import data  # noqa: E402
import numpy as np  # noqa: E402


async def _read_response(reader):
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    length = 0
    for line in lines[1:]:
        if line.lower().startswith("content-length:"):
            length = int(line.split(":", 1)[1])
    body = await reader.readexactly(length)
    return status, body


async def _main(args) -> dict:
    loop = asyncio.get_running_loop()
    images = data.Images(args.seed, args.distinct, args.size)
    parts = [data.arrivals(args.seed, args.rate, args.seconds)]
    if args.lead > 0:
        parts.insert(0, data.arrivals(args.seed, args.rate, args.lead)
                     - args.lead)
    if args.extra > 0:
        parts.append(args.seconds + data.arrivals(args.seed, args.rate,
                                                  args.extra))
    due = np.concatenate(parts)
    which = data.rng(args.seed, 3).integers(0, args.distinct, len(due))
    head = (f"POST /v1/predict HTTP/1.1\r\nHost: 127.0.0.1\r\n"
            f"Content-Type: application/octet-stream\r\n"
            f"Content-Length: {args.size * args.size * 3}\r\n\r\n").encode()
    pool: asyncio.Queue = asyncio.Queue()
    for _ in range(args.connections):
        pool.put_nowait(await asyncio.open_connection("127.0.0.1",
                                                      args.port))
    print("ready", flush=True)
    await loop.run_in_executor(None, sys.stdin.readline)
    t0 = loop.time() + args.lead
    print(f"t0 {time.monotonic() + args.lead!r}", flush=True)
    rows = [[float(d), None, None, 0, int(j), None, None]
            for d, j in zip(due, which)]

    async def one(i):
        row = rows[i]
        await asyncio.sleep(max(0.0, t0 + row[0] - loop.time()))
        row[1] = loop.time() - t0
        reader, writer = await pool.get()
        try:
            writer.write(head + images[row[4]].tobytes())
            await writer.drain()
            status, body = await _read_response(reader)
        except (OSError, asyncio.IncompleteReadError, ValueError):
            writer.close()
            pool.put_nowait(await asyncio.open_connection("127.0.0.1",
                                                          args.port))
            row[3] = -1
            return
        pool.put_nowait((reader, writer))
        row[2], row[3] = loop.time() - t0, status
        if status == 200:
            out = json.loads(body)
            row[5], row[6] = int(out["prediction"]), float(out["score"])

    tasks = [asyncio.ensure_future(one(i)) for i in range(len(rows))]
    finished, pending = await asyncio.wait(
        tasks, timeout=args.lead + args.seconds + args.extra + args.grace)
    for t in pending:
        t.cancel()
    for t in finished:
        if t.exception() is not None:
            print(f"request failed: {t.exception()!r}", file=sys.stderr)
    while not pool.empty():
        _, writer = pool.get_nowait()
        writer.close()
    return {"t0": t0, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rate", type=float, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--lead", type=float, default=0.0)
    ap.add_argument("--extra", type=float, default=0.0)
    ap.add_argument("--distinct", type=int, required=True)
    ap.add_argument("--size", type=int, required=True)
    ap.add_argument("--connections", type=int, default=64)
    ap.add_argument("--grace", type=float, default=60.0)
    args = ap.parse_args(argv)
    out = asyncio.run(_main(args))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
