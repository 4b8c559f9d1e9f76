"""Find the daemon's knee: the highest offered rate it keeps up with.

    python benchmark_torch/sweep_serve.py --workload serve.resnet50.open
        --rates 200 300 400 ... [--seconds 10] [--seed 1]

One daemon, set up as the cell's run sets it up, then the cell's open
loop at each rate in turn for ``--seconds``.  One JSON line a rate: the
offered and completed rates, p50 and p95 latency over the window and
over its first and second halves (a p95 that grows from the first half to
the second means a growing backlog), the generator's lag and the failed
requests.  A rate is kept up with where the completed rate is within 3 %
of the offered one and the second half's p95 is within 1.5x the first
half's.  Needs a CUDA card.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmark_torch"))

import run as bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    bench._caches()
    import torch

    from benchmark_torch.lib import data, drive_serve, harness

    if not torch.cuda.is_available():
        print("sweep_serve.py: no CUDA card", file=sys.stderr)
        return 3
    cell, config, traffic = bench.cell_files(
        bench._load_json(ROOT / "BENCHMARK.json"), args.workload)
    bench.OUT.mkdir(parents=True, exist_ok=True)
    ctx = harness.Ctx(cell=cell, config=config, traffic=traffic,
                      seed=args.seed, seconds=args.seconds, trace=False,
                      device=torch.device("cuda", 0), t_process=time.time(),
                      out_dir=bench.OUT)
    images = data.Images(args.seed, int(traffic["distinct_images"]),
                         int(config["image_size"]))
    server, _ = drive_serve.start(ctx, images)
    try:
        for rate in args.rates:
            got = drive_serve.load(ctx, server, rate, args.seconds)
            rows, half = got["rows"], args.seconds / 2
            rep = drive_serve.summarize_rows(rows, args.seconds, got["grace"])
            first = drive_serve.summarize_rows(
                [r for r in rows if 0.0 <= r[0] < half], half, got["grace"])
            second = drive_serve.summarize_rows(
                [[r[0] - half, r[1] - half, r[2] and r[2] - half, *r[3:]]
                 for r in rows
                 if half <= r[0] < args.seconds], half, got["grace"])
            d_img = got["stats1"]["images"] - got["stats0"]["images"]
            d_bat = got["stats1"]["batches"] - got["stats0"]["batches"]
            keeps = (rep["completed_per_s"] >= 0.97 * rate
                     and second["p95_ms"] <= 1.5 * first["p95_ms"]
                     and rep["failed"] == 0)
            print(json.dumps({
                "rate": rate, "requests": len(rep["window"]),
                "completed_per_s": rep["completed_per_s"],
                "p50_ms": rep["p50_ms"], "p95_ms": rep["p95_ms"],
                "p95_first_half_ms": first["p95_ms"],
                "p95_second_half_ms": second["p95_ms"],
                "gen_lag_p95_ms": rep["lag_p95_ms"],
                "failed": rep["failed"],
                "mean_batch": d_img / d_bat if d_bat else None,
                "keeps_up": keeps}), flush=True)
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
