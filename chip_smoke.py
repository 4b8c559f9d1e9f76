#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's serving slice, on one NVIDIA card.

    python3 chip_smoke.py

Drives ``openset_imagenet_tpu_torch`` through the entry points a user
calls, at full width (resnet50, 224 px, 116 known classes, random weights
from a seed), and checks what comes out:

1. the card: name and power limit from ``nvidia-smi``;
2. the Triton loss kernels (``entropic_fwd``, ``ce_fwd``) against their
   plain PyTorch versions on the card at the validation step's shapes and
   at ragged, masked, all-negative and all-masked batches (rtol 1e-5 on
   the sums, counts exact, same bits on a second launch), with their times;
3. serving: a reference ``.pth`` -> ``OpenSetPredictor(device="cuda")``,
   ``warmup(64)``, requests of 1, 3, 17 and 64 images; shapes, finiteness,
   scores that do not depend on the padding bucket, rejection, agreement
   with a float32 CPU forward on two images, and forward imgs/s;
4. validation: ``make_eval_step`` + ``validate`` over four batches of 64
   (the last one masked) for the entropic, softmax and garbage losses,
   through the kernels, against the same step with ``fused=False``.

The launch counts are zeroed just before phase 3 and read after phase 4:
the main path must have launched every kernel.  Float32 matmuls and
convolutions run without TF32 (both backend flags off), so float32
comparisons on the card are exact float32.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and no result line is printed.  Without a CUDA device the
script exits non-zero at once.  Build outputs (Triton's cache, the
checkpoint) go to ``build/`` in the checkout.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
SEED = 0
N_CLASSES = 116           # protocol-1 knowns (entropic / softmax)
IMAGE = 224
BATCH = 64


def check(ok, message):
    if not ok:
        raise RuntimeError(f"check failed: {message}")


def time_ms(fn, reps=30, warmup=5):
    """Median milliseconds of one call, bracketed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls=20, reps=20):
    """Median device milliseconds of one call, replayed from a CUDA graph
    of ``calls`` calls (no host launch overhead in the interval)."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return time_ms(graph.replay, reps=reps, warmup=2) / calls


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 2: kernels against their plain versions ---------------------------

def kernel_checks(torch, fl):
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def batch(b, c, low=-1, valid=None, masked=False):
        logits = torch.from_numpy((rng.normal(size=(b, c)) * 3).astype(
            np.float32)).to(dev)
        labels = torch.from_numpy(rng.integers(low, c, b).astype(
            np.int32)).to(dev)
        mask = np.ones(b, np.float32)
        if valid is not None:
            mask[valid:] = 0
        if masked:
            mask[:] = 0
        return logits, labels, torch.from_numpy(mask).to(dev)

    cases = [  # name, b, c, label low, valid rows, all masked, all negative
        ("p1", 64, 116, -1, None, False, False),
        ("p1", 256, 116, -1, None, False, False),
        ("garbage", 64, 117, 0, None, False, False),
        ("garbage", 256, 117, 0, None, False, False),
        ("ragged", 1000, 1000, -1, None, False, False),
        ("tail", 64, 116, -1, 37, False, False),
        ("negatives", 64, 116, -1, None, False, True),
        ("masked", 64, 116, -1, None, True, False),
    ]
    max_err = {"entropic_fwd": 0.0, "ce_fwd": 0.0}
    rows = []
    for name, b, c, low, valid, masked, negative in cases:
        logits, labels, mask = batch(b, c, low, valid, masked)
        if negative:
            labels = -torch.ones_like(labels)
        class_w = torch.from_numpy(rng.uniform(0.2, 2.0, c).astype(
            np.float32)).to(dev)
        ce_rows = (class_w[labels.long().clamp(0, c - 1)] * mask
                   if name == "garbage" else (labels >= 0).float() * mask)
        runs = {
            "entropic_fwd": (
                lambda: fl.entropic_sums(logits, labels, mask, 0.5),
                lambda: fl.entropic_sums_plain(logits, labels, mask, 0.5)),
            "ce_fwd": (lambda: fl.ce_sums(logits, labels, ce_rows),
                       lambda: fl.ce_sums_plain(logits, labels, ce_rows)),
        }
        for kname, (kernel, plain) in runs.items():
            got = torch.stack(kernel())
            again = torch.stack(kernel())
            torch.cuda.synchronize()
            ref = torch.stack(plain())
            check(torch.equal(got, again), f"{kname} {name} [{b},{c}]: "
                  "two launches differ")
            g, r = got.double().cpu().numpy(), ref.double().cpu().numpy()
            err = float(np.abs(g - r).max())
            check(abs(g[0] - r[0]) <= 1e-5 * abs(r[0]) + 1e-6,
                  f"{kname} {name} [{b},{c}]: sum {g[0]} vs plain {r[0]}")
            if kname == "entropic_fwd" or name != "garbage":
                check(g[1] == r[1], f"{kname} {name}: count {g[1]} vs {r[1]}")
            else:
                check(abs(g[1] - r[1]) <= 1e-6 * abs(r[1]),
                      f"{kname} {name}: weight sum {g[1]} vs {r[1]}")
            max_err[kname] = max(max_err[kname], err)
            rows.append((kname, name, b, c, err, time_ms(kernel),
                         time_ms(plain), graph_ms(kernel), graph_ms(plain)))
    print("kernel      case       shape        max_abs_err   call_ms  "
          "plain_call_ms  dev_ms   plain_dev_ms")
    for kname, name, b, c, err, ms, pms, dms, pdms in rows:
        print(f"{kname:11s} {name:10s} [{b},{c}]".ljust(36) +
              f"{err:.3e}   {ms:.5f}  {pms:.5f}        {dms:.5f}  {pdms:.5f}")
    main_shape = {"entropic_fwd": ("p1", 64, 116),
                  "ce_fwd": ("garbage", 64, 117)}
    timing = {}
    for kname, name, b, c, err, ms, pms, dms, pdms in rows:
        if main_shape[kname] == (name, b, c):
            timing[kname] = (dms, pdms)
    return max_err, timing


# -- phase 3: serving ---------------------------------------------------------

def randomize_norms(torch, model, generator):
    """Non-trivial batch-norm parameters and running statistics, and heads
    scaled so the logits span a few units (softmax far from uniform)."""
    from openset_imagenet_tpu_torch.models.norm import BatchNorm

    with torch.no_grad():
        model.resnet_base.fc.weight.mul_(10.0)
        model.logits.weight.mul_(5.0)
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                draw = lambda: torch.rand(n, generator=generator)
                m.weight.copy_(0.5 + 0.5 * draw())
                m.bias.copy_(0.2 * (draw() - 0.5))
                m.running_mean.copy_(0.2 * (draw() - 0.5))
                m.running_var.copy_(0.5 + 1.5 * draw())
    return model


def make_model(torch, n_classes, seed, dtype=None):
    from openset_imagenet_tpu_torch.models.resnet import build_resnet

    g = torch.Generator().manual_seed(seed)
    model = build_resnet("resnet50", fc_layer_dim=n_classes,
                         out_features=n_classes,
                         dtype=dtype or torch.bfloat16, generator=g)
    return randomize_norms(torch, model, g)


def serve(torch, out_dir):
    from openset_imagenet_tpu_torch.checkpoint import save_checkpoint
    from openset_imagenet_tpu_torch.inference import OpenSetPredictor

    model = make_model(torch, N_CLASSES, SEED)
    path = out_dir / "resnet50_p1_entropic.pth"
    save_checkpoint(path, model, epoch=0, best_score=0.0)
    pred = OpenSetPredictor(path, device="cuda")
    check(pred.n_classes == N_CLASSES, f"n_classes {pred.n_classes}")
    pred.warmup(BATCH)
    check(pred.buckets_compiled_up_to(BATCH), "warm ladder")

    images = np.random.default_rng(SEED + 1).integers(
        0, 256, (BATCH, IMAGE, IMAGE, 3), np.uint8)
    answers = {}
    for n in (1, 3, 17, 64):
        cls, measure, feats, scores = pred.predict(images[:n],
                                                   return_arrays=True)
        check(cls.shape == measure.shape == (n,), f"request {n}: shapes")
        check(feats.shape == (n, N_CLASSES) and scores.shape ==
              (n, N_CLASSES), f"request {n}: array shapes")
        check(np.isfinite(feats).all() and np.isfinite(scores).all(),
              f"request {n}: non-finite output")
        check(np.allclose(scores.sum(-1), 1.0, atol=1e-3),
              f"request {n}: softmax rows do not sum to 1")
        answers[n] = (cls, measure, feats, scores)
    # Rows padded into bucket 4 and bucket 64 get the same answers up to
    # bf16 rounding: cuDNN picks its algorithm per batch size, so the sums
    # round differently through 50 bf16 layers.  Tolerance as the JAX
    # package's cross-graph checks (tests/test_optimize.py): 0.05 on
    # scores, and a class may change only at a near-tie.
    few, many = answers[3], [a[:3] for a in answers[64]]
    d_scores = np.abs(few[3] - many[3]).max()
    d_feats = np.abs(few[2] - many[2]).max()
    feat_scale = np.abs(many[2]).max()
    print(f"bucket independence: max |d score| {d_scores:.3e}, "
          f"max |d feature| {d_feats:.3e} (max |feature| {feat_scale:.3e})")
    check(d_scores <= 5e-2 and d_feats <= 5e-2 * feat_scale,
          "scores depend on the padding bucket")
    top2 = np.sort(many[3], -1)[:, -2:]
    for i in np.nonzero(few[0] != many[0])[0]:
        check(top2[i, 1] - top2[i, 0] < 5e-2,
              f"row {i}: class depends on the padding bucket")
    top = np.sort(answers[64][3], -1)[:, -1]
    print(f"max softmax over 64 requests: min {top.min():.4f} "
          f"median {np.median(top):.4f} max {top.max():.4f}")

    for mode in ("softmax", "objectosphere"):
        pred.mode, pred.threshold = mode, 0.0
        _, measure = pred.predict(images)
        pred.threshold = float(np.median(measure))
        cls, measure = pred.predict(images)
        check(np.array_equal(cls == -1, measure < pred.threshold),
              f"{mode} rejection disagrees with its measure")
        check(0 < (cls == -1).sum() < BATCH, f"{mode}: rejected "
              f"{(cls == -1).sum()} of {BATCH}")
    pred.mode, pred.threshold = "softmax", 0.0

    # A float32 CPU forward of the same weights on two images.
    ref_model = make_model(torch, N_CLASSES, SEED, dtype=torch.float32)
    with torch.inference_mode():
        ref_logits, _ = ref_model(torch.from_numpy(images[:2]).float()
                                  / 255.0)
    ref_scores = torch.softmax(ref_logits, -1).numpy()
    d_ref = np.abs(answers[64][3][:2] - ref_scores).max()
    print(f"bf16 GPU vs float32 CPU scores (2 images): max |d| {d_ref:.3e}")
    check(d_ref <= 2e-2, "GPU scores disagree with the float32 reference")

    rates = {}
    for b in (64, 256):
        batch_imgs = np.random.default_rng(b).integers(
            0, 256, (b, IMAGE, IMAGE, 3), np.uint8)
        on_device = torch.from_numpy(batch_imgs).cuda()
        fwd = time_ms(lambda: pred._forward(pred.model, on_device), reps=20)
        t0 = time.perf_counter()
        for _ in range(10):
            pred.predict(batch_imgs)
        e2e = (time.perf_counter() - t0) / 10 * 1e3
        rates[b] = (b / fwd * 1e3, b / e2e * 1e3)
        print(f"batch {b}: forward (device-resident uint8) {fwd:.3f} ms = "
              f"{rates[b][0]:.1f} imgs/s; predict() from host numpy "
              f"{e2e:.3f} ms = {rates[b][1]:.1f} imgs/s")
    return pred


# -- phase 4: validation ------------------------------------------------------

class _Pipeline:
    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch):
        yield from self.batches


def validation_batches(n_classes, loss):
    import types

    rng = np.random.default_rng(SEED + 2)
    out = []
    for i in range(4):
        # A third of the rows are unknowns: label -1, or the background
        # class C-1 of the garbage regime.
        unknown = -1 if loss != "garbage" else n_classes - 1
        n_known = n_classes - 1 if loss == "garbage" else n_classes
        labels = np.where(rng.random(BATCH) < 1 / 3, unknown,
                          rng.integers(0, n_known, BATCH)).astype(np.int32)
        mask = np.ones(BATCH, np.float32)
        if i == 3:
            mask[37:] = 0
        out.append(types.SimpleNamespace(
            images=rng.integers(0, 256, (BATCH, IMAGE, IMAGE, 3), np.uint8),
            labels=labels, mask=mask))
    return _Pipeline(out)


def validate_all(torch, models):
    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.ops.losses import AverageMeter

    results = {}
    weights = np.random.default_rng(SEED + 3).uniform(
        0.3, 3.0, N_CLASSES + 1).astype(np.float32)
    for loss in ("entropic", "softmax", "garbage"):
        model = models[loss]
        n = N_CLASSES + 1 if loss == "garbage" else N_CLASSES
        pipeline = validation_batches(n, loss)
        for fused in ("auto", False):
            trackers = {k: AverageMeter() for k in ("j", "conf_kn",
                                                    "conf_unk")}
            step = engine.make_eval_step(
                engine.make_loss_fn(loss, 1.0, weights if loss == "garbage"
                                    else None, fused=fused), loss, n)
            engine.validate(model, pipeline, 0, step, trackers)
            results[(loss, fused)] = trackers
    return results


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from openset_imagenet_tpu_torch.ops import fused_loss as fl

    out_dir = REPO / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    max_err, timing = kernel_checks(torch, fl)
    print(f"phase kernels: ok ({time.perf_counter() - t0:.1f} s incl. "
          "Triton builds)")

    for k in fl.LAUNCHES:
        fl.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    pred = serve(torch, out_dir)
    print(f"phase serve: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    garbage_model = make_model(torch, N_CLASSES + 1, SEED + 1).cuda()
    garbage_model = garbage_model.to(memory_format=torch.channels_last)
    results = validate_all(torch, {"entropic": pred.model,
                                   "softmax": pred.model,
                                   "garbage": garbage_model})
    launches = dict(fl.LAUNCHES)
    print(f"launches on the main path: {launches}")
    for loss in ("entropic", "softmax", "garbage"):
        k, p = results[(loss, "auto")], results[(loss, False)]
        gamma = k["conf_kn"].avg + k["conf_unk"].avg
        print(f"validate {loss}: j {k['j'].avg:.6f} (plain {p['j'].avg:.6f})"
              f" conf_kn {k['conf_kn'].avg:.6f} conf_unk "
              f"{k['conf_unk'].avg:.6f} gamma {gamma:.6f} rows "
              f"{k['j'].count:.0f}")
        check(np.isfinite(k["j"].avg) and k["j"].count == 3 * BATCH + 37,
              f"{loss}: loss {k['j'].avg} over {k['j'].count} rows")
        check(abs(k["j"].avg - p["j"].avg) <= 1e-5 * abs(p["j"].avg),
              f"{loss}: kernel loss {k['j'].avg} vs plain {p['j'].avg}")
        for name in ("conf_kn", "conf_unk"):
            check(k[name].count == p[name].count and
                  abs(k[name].avg - p[name].avg) <= 1e-6,
                  f"{loss}: {name} differs between fused and plain")
    check(launches["entropic_fwd"] >= 4 and launches["ce_fwd"] >= 8,
          f"main path did not go through both kernels: {launches}")
    print(f"phase validate: ok ({time.perf_counter() - t0:.1f} s)")

    kernels = [
        {"name": "entropic_fwd", "route": "triton",
         "source": "openset_imagenet_tpu_torch/ops/triton_fused_loss.py",
         "replaces": "openset_imagenet_tpu/ops/fused_loss.py:39",
         "launches": launches["entropic_fwd"],
         "max_abs_err": max_err["entropic_fwd"],
         "ms": timing["entropic_fwd"][0],
         "plain_ms": timing["entropic_fwd"][1]},
        {"name": "ce_fwd", "route": "triton",
         "source": "openset_imagenet_tpu_torch/ops/triton_fused_loss.py",
         "replaces": "openset_imagenet_tpu/ops/fused_loss.py:172",
         "launches": launches["ce_fwd"],
         "max_abs_err": max_err["ce_fwd"],
         "ms": timing["ce_fwd"][0], "plain_ms": timing["ce_fwd"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
