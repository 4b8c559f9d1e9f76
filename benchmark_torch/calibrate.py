"""Readings that the limits of ``correct`` are set from, for one cell.

    python benchmark_torch/calibrate.py --workload <cell> --seeds 1 2 ...
        [--control-seeds 101 102 103] [--seconds 2]

In one process on the card: for each of ``--seeds``, a whole run of the
cell (a short window, then the check), printing the compared numbers (the
lower readings: sound runs of the program); for each of
``--control-seeds``, the control (the reference itself in float8 in the
program's place, against the float32 reference on the same inputs: the
upper readings; the configuration's family names that precision as its
``control_quant``) and, for a training cell, the fault "half of the
batch left out, the mean taken over the rest" (the reference on each
batch's first half).  One
JSON line each, then the largest program reading and the smallest
control reading of every number.  Needs a CUDA card.
"""

import argparse
import importlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmark_torch"))

import run as bench  # noqa: E402
from benchmark_torch.lib import families  # noqa: E402


def control_train(ctx, compare, data):
    cfg = ctx.config
    family = families.of(cfg)
    b = int(cfg["batch"])
    images = data.Images(ctx.seed, 3 * b, int(cfg["image_size"]))
    labels = data.labels(ctx.seed, 3 * b, int(cfg["n_classes"]),
                         float(cfg["negative_share"]))
    batches = [(images.batch(range(i * b, (i + 1) * b)),
                labels[i * b:(i + 1) * b]) for i in range(3)]
    w0 = family.make_weights(cfg, ctx.seed, ctx.device)
    ref = family.train_steps(w0, batches, cfg)
    ctrl = family.train_steps(w0, batches, cfg, quant=family.control_quant)
    out = {"control": compare.train_numbers(ctrl, ref)[0]}
    half = [(im[:b // 2], lab[:b // 2]) for im, lab in batches]
    fault = family.train_steps(w0, half, cfg)
    # The forward of the half batch is the full one's first half (the
    # batch-norm window lies inside it); only the loss lost rows.
    ref_half = (ref[0], ref[1][:b // 2], ref[2], ref[3])
    out["half_batch"] = compare.train_numbers(fault, ref_half)[0]
    return out


def control_answers(ctx, compare, data):
    import torch

    cfg, tr = ctx.config, ctx.traffic
    family = families.of(cfg)
    images = data.Images(ctx.seed, int(tr["distinct_images"]),
                         int(cfg["image_size"]))
    w = family.make_weights(cfg, ctx.seed, ctx.device)
    w = family.calibrate_running_stats(
        w, images.batch(range(int(tr.get("calibration_images", 32)))), cfg)
    idx = data.rng(ctx.seed, 4).choice(images.n, int(tr["check_rows"]),
                                       replace=False)
    batch = images.batch(idx)
    ref = family.eval_logits(w, batch, cfg).cpu().numpy()
    ctrl = family.eval_logits(w, batch, cfg, quant=family.control_quant)
    p = torch.softmax(ctrl, dim=-1).cpu().numpy()
    return {"control": compare.answer_numbers(p.argmax(1), p.max(1), ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    bench._caches()
    import torch

    from benchmark_torch.lib import compare, data, harness

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 3
    cell, config, traffic = bench.cell_files(
        bench._load_json(ROOT / "BENCHMARK.json"), args.workload)
    bench.OUT.mkdir(parents=True, exist_ok=True)
    generator = importlib.import_module(
        f"benchmark_torch.lib.drive_{traffic['kind']}")
    worst, least = {}, {}

    def ctx_for(seed):
        return harness.Ctx(cell=cell, config=config, traffic=traffic,
                           seed=seed, seconds=args.seconds, trace=False,
                           device=torch.device("cuda", 0),
                           t_process=time.time(), out_dir=bench.OUT)

    for seed in args.seeds:
        ctx = ctx_for(seed)
        res = generator.run(ctx)
        ok, _ = compare.judge(res.numbers, harness.limits_of(ctx))
        print(json.dumps({"seed": seed, "program": res.numbers,
                          "correct": ok, "e2e": res.e2e,
                          "where": res.counters.get("worst_leaf")}),
              flush=True)
        for k, v in res.numbers.items():
            worst[k] = max(worst.get(k, 0.0), float(v))
    for seed in args.control_seeds:
        ctx = ctx_for(seed)
        fn = control_train if traffic["kind"] == "train" else control_answers
        readings = fn(ctx, compare, data)
        harness.release(ctx.device)
        print(json.dumps({"seed": seed, **readings}), flush=True)
        for what, nums in readings.items():
            for k, v in nums.items():
                key = f"{what}.{k}"
                least[key] = min(least.get(key, float("inf")), float(v))
    print(json.dumps({"workload": args.workload, "program_max": worst,
                      "control_min": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
