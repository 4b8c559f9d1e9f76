"""Benchmark of the PyTorch port on NVIDIA GPUs.

    python benchmark_torch/run.py --workload <cell> --seed <n>
                                  --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: its
configuration (``benchmark_torch/configs/<config>.json``) under its
traffic mix (``benchmark_torch/traffic/<traffic>.json``, whose ``kind``
picks the generator ``benchmark_torch/lib/drive_<kind>.py``).  With
``--trace 0`` the result line carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, each read by
``benchmark_torch/metrics/<metric>.py`` (``read(result) -> float | None``;
None leaves the metric out) from a traced stretch after the window.
Every run checks what the timed path produced against the plain float32
reference of the configuration's family (``lib/families.py``; the ResNet's
is ``lib/reference.py``) and prints each compared number beside
its limit, last on standard error and last in the result line, which is
the last line of standard output.  Without a CUDA card, or with fewer
cards than the cell asks for, it exits 3 and prints no result; with JAX,
jaxlib, flax or the JAX package loaded once the window has closed, it
names them and exits 4 without a result.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark_torch"
OUT = HERE / "out"
sys.path.insert(0, str(ROOT))
JAX_NAMES = {"jax", "jaxlib", "flax", "openset_imagenet_tpu"}


def _caches() -> None:
    """Every build and kernel cache of the program in fixed directories of
    the checkout, so that only a cell's first run there compiles."""
    cache = OUT / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
        (cache / sub).mkdir(parents=True, exist_ok=True)


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, name: str):
    """``(cell, configuration, traffic)`` of workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; choose "
                         f"from {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _load_json(ROOT / entry["file"])
    traffic = _load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def jax_loaded() -> list:
    """JAX, its libraries or the JAX package among the loaded modules, by
    whole top-level name (the port's name begins with the package's)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & JAX_NAMES)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_metric(name: str, result):
    """Value of per-layer metric ``name`` from its reader file, or None."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(result)


def result_line(bench: dict, cell: dict, res, trace: bool, device: dict,
                checks: dict, correct: bool) -> dict:
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            # A device metric is taken on a card alone.
            if _applies(m, cell["name"]) and m["name"] in res.e2e:
                metrics[m["name"]] = {"value": float(res.e2e[m["name"]]),
                                      "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if _applies(m, cell["name"]):
                value = read_metric(m["name"], res)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": int(res.attempted),
            "failed": int(res.failed), "metrics": metrics, "device": device}
    if trace:
        from benchmark_torch.lib import profile

        line["breakdown"] = profile.breakdown(res.profile)
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = _load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = cell_files(bench, args.workload)
    _caches()
    import torch

    torch.cuda.is_available()
    t_torch = time.time() - T_PROCESS

    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: the cell needs {chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 3

    from benchmark_torch.lib import card, compare, harness

    OUT.mkdir(parents=True, exist_ok=True)
    ctx = harness.Ctx(cell=cell, config=config, traffic=traffic,
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0),
                      t_process=T_PROCESS, out_dir=OUT)
    generator = importlib.import_module(
        f"benchmark_torch.lib.drive_{traffic['kind']}")
    res = generator.run(ctx)
    if args.trace and res.profile is None:
        raise RuntimeError("the traced window holds no device operation")
    correct, checks = compare.judge(res.numbers, harness.limits_of(ctx))
    line_card = card.card_line()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res.memory_peak_bytes,
              "power_limit_w": card.power_limit_w(line_card)}
    if args.trace:
        device["busy_s"] = res.profile["busy_s"]
        device["window_s"] = res.profile["window_s"]
    line = result_line(bench, cell, res, bool(args.trace), device, checks,
                       correct)
    found = jax_loaded()
    if found:
        print(f"run.py: {', '.join(found)} loaded: the benchmark runs the "
              "port alone", file=sys.stderr)
        return 4
    record = OUT / f"{cell['name']}.seed{args.seed}.trace{args.trace}.json"
    with open(record, "w") as f:
        json.dump({"counters": res.counters, "e2e": res.e2e,
                   "profile": res.profile, "card": line_card}, f,
                  default=str)
    phases = {n: sum(res.spans.durations(n)) for n in res.spans.names()
              if n.startswith("setup.")}
    print(f"setup {res.e2e['setup_s']:.3f} s: torch and the card "
          f"{t_torch:.3f} s, " + ", ".join(f"{n[6:]} {v:.3f} s"
                                           for n, v in sorted(phases.items())),
          file=sys.stderr)
    c = res.counters
    if c.get("window_s"):
        print(f"window {c['window_images']} images in {c['window_s']:.4f} s"
              f" ({c['window_images'] / c['window_s']:.1f} imgs/s"
              + (", profiled" if not args.trace else "") + ")",
              file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
