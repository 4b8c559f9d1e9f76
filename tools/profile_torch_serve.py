#!/usr/bin/env python3
"""Where the PyTorch port's serving forward (or train step) spends its
time on the GPU.

    python tools/profile_torch_serve.py [--batch 64 256] [--train [--fused]]
                                        [--trace-dir chiprun_out]

Builds a full-width two-head resnet50 (116 classes, random weights from
seed 0) exactly as ``OpenSetPredictor`` holds it (bf16 compute,
channels_last, CUDA), and runs the forward step (``train.
make_forward_step``) on uint8 ``[B, 224, 224, 3]`` batches already on the
card.  With ``--train`` it runs the train step instead (``train.
make_train_step``: ghost batch-norm over 64 rows, the entropic loss
through the Triton kernels, Adam at lr 1e-3); ``--fused`` adds
``model.fused_blocks`` and ``model.boundary_mask``, so every pointwise
backward site of the bottlenecks runs through K5 (the fused step of
PERF.md; its kernels form the ``K5`` category).  For each batch size it
prints the step's median milliseconds (CUDA events), then one
``torch.profiler`` window of five steps: device-busy time, the idle share
of the window, kernel launches per step, device time by kernel category
and by kernel (every K5 kernel apart), and the loss kernels' launches
per step (K1 and K2 on the train step, where the entropic loss launches
nothing else).  A Chrome trace per batch size goes
to ``--trace-dir``.  Needs a CUDA device.
"""

import argparse
import collections
import pathlib
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

REPS = 5
TOP = 12

# Kernel-name fragments -> category, first match wins.
CATEGORIES = (
    ("K5", ("site_fused", "site_rows", "site_dw", "site_gate",
            "reduce_partials")),
    ("loss (Triton)", ("entropic_", "ce_fwd", "ce_bwd")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("pool", ("pool",)),
    ("conv", ("fprop", "conv", "implicit", "xmma", "dgrad", "nchw", "nhwc")),
    ("gemm", ("gemm", "cutlass", "cublas")),
    ("reduce/softmax", ("reduce", "softmax")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy", ("copy", "memcpy", "memset")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the forward")
    ap.add_argument("--fused", action="store_true",
                    help="with --train: model.fused_blocks + boundary_mask "
                         "(K5 at every pointwise backward site)")
    ap.add_argument("--trace-dir", default="chiprun_out")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace
    from openset_imagenet_tpu_torch.models.resnet import build_resnet

    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    print(f"device {torch.cuda.get_device_name(0)}")
    if args.fused and not args.train:
        ap.error("--fused profiles the train step: add --train")
    model = build_resnet("resnet50", fc_layer_dim=116, out_features=116,
                         bn_stats_rows=64 if args.train else 0,
                         fused_blocks=args.fused, boundary_mask=args.fused,
                         generator=torch.Generator().manual_seed(0))
    model = model.cuda().to(memory_format=torch.channels_last)
    what = ("fused train step" if args.fused else
            "train step" if args.train else "forward")
    if args.train:
        state = engine.create_state(model, engine.build_optimizer(
            NameSpace({"type": "adam", "lr": 1e-3}), 1))
        train_step = engine.make_train_step(
            engine.make_loss_fn("entropic", fused="auto"))
    else:
        forward = engine.make_forward_step()
    trace_dir = pathlib.Path(args.trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)

    for b in args.batch:
        rng = np.random.default_rng(b)
        images = torch.from_numpy(rng.integers(
            0, 256, (b, 224, 224, 3), np.uint8)).cuda()
        labels = torch.from_numpy(rng.integers(-1, 116, b).astype(
            np.int32)).cuda()
        mask = torch.ones(b, device="cuda")

        def run():
            if args.train:
                train_step(state, images, labels, mask)
            else:
                forward(model, images)

        times = []
        for i in range(REPS + 3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
        fwd_ms = statistics.median(times)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(REPS):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        name = ("torch_train_fused" if args.fused else
                "torch_train" if args.train else "torch_serve")
        prof.export_chrome_trace(str(trace_dir / f"{name}_b{b}.json"))

        by_kernel = collections.Counter()
        launches = collections.Counter()
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                us = evt.time_range.elapsed_us()
                by_kernel[evt.name] += us
                launches[evt.name] += 1
        busy_ms = sum(by_kernel.values()) / 1e3
        by_cat = collections.Counter()
        for name, us in by_kernel.items():
            by_cat[category(name)] += us
        print(f"\nbatch {b}: {what} {fwd_ms:.3f} ms median of {len(times)}"
              f" = {b / fwd_ms * 1e3:.1f} imgs/s")
        print(f"  profiled window: {REPS} steps, wall {wall_ms:.3f}"
              f" ms, device busy {busy_ms:.3f} ms, idle share "
              f"{max(0.0, 1 - busy_ms / wall_ms):.3f}, kernel launches per "
              f"step {sum(launches.values()) / REPS:.0f}")
        if not by_kernel:
            print("  the profiler recorded no device time")
            continue
        for cat, us in by_cat.most_common():
            print(f"  {cat:15s} {us / 1e3 / REPS:9.3f} ms/step "
                  f"{us / 1e3 / busy_ms:6.1%}")
        loss = {n: k for n, k in launches.items()
                if category(n) == "loss (Triton)"}
        print(f"  loss kernel launches per step "
              f"{sum(loss.values()) / REPS:.0f}: " + ", ".join(
                  f"{n[:40]} {k / REPS:.0f}" for n, k in sorted(loss.items())))
        print(f"  top {TOP} kernels (ms/step, launches/step):")
        for name, us in by_kernel.most_common(TOP):
            print(f"    {us / 1e3 / REPS:8.3f}  "
                  f"{launches[name] / REPS:5.0f}  {name[:110]}")
        k5 = [(n, us) for n, us in by_kernel.most_common()
              if category(n) == "K5"]
        if k5:
            print("  K5 kernels (ms/step, launches/step):")
            for name, us in k5:
                print(f"    {us / 1e3 / REPS:8.3f}  "
                      f"{launches[name] / REPS:5.0f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
