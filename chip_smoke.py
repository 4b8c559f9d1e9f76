#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port, on one NVIDIA card.

    python3 chip_smoke.py

Drives ``openset_imagenet_tpu_torch`` through the entry points a user
calls, at full width (resnet50, 224 px, 116 known classes, random weights
from a seed), and checks what comes out:

1. the card: name and power limit from ``nvidia-smi``;
2. the Triton loss kernels against their plain PyTorch versions on the
   card, at the train and validation steps' shapes and at ragged, masked,
   all-negative and all-masked batches, with their times: the forwards
   (``entropic_fwd``, ``ce_fwd``; rtol 1e-5 on the sums, counts exact) and
   the backwards (``entropic_bwd``, ``ce_bwd``; gradients within rtol
   1e-5, atol 1e-8, masked rows exactly 0, autograd through the public
   losses equal to the plain backward); same bits on a second launch;
3. serving: a reference ``.pth`` -> ``OpenSetPredictor(device="cuda")``,
   ``warmup(64)``, requests of 1, 3, 17 and 64 images; shapes, finiteness,
   scores that do not depend on the padding bucket, rejection, agreement
   with a float32 CPU forward on two images, and forward imgs/s;
4. validation: ``make_eval_step`` + ``validate`` over four batches of 64
   (the last one masked) for the entropic, softmax and garbage losses,
   through the kernels, against the same step with ``fused=False``;
5. training: a CSV index -> ``ImagenetDataset`` -> ``pipeline_from_
   dataset`` (synthetic reader, pinned batches) -> ``train_epoch`` with
   ``make_train_step`` and the ragged-tail step, Adam: the entropic loss
   at batch 256 with ghost batch-norm over 64 rows (two full batches and
   a tail of 48 rows, so the tail-specific step runs), then softmax and
   garbage at batch 64 with full-batch statistics, three steps each.
   Checks: finite losses, running statistics that moved, the loss falling
   over eight steps on one batch, and from one state (cuDNN
   deterministic) two steps through the kernels, bitwise equal, against
   one with ``fused=False``: the logits gradient within rtol 1e-5, and
   every parameter's gradient within 2e-2 relative in norm.  The logits
   gradients differ by ~1e-10, but the bf16 backward rounds differently
   once its input differs by an ulp, and the flips add up towards the
   stem: the stem's batch-norm and conv gradients moved by up to 1.234e-2
   on the H100.  Prints train-step imgs/s at batch 256 with the kernels
   and with ``fused=False`` and the peak device memory.

The launch counts are zeroed just before phase 3 and read after phase 4
(the serving path), and zeroed again before phase 5's epochs and read
after them (the train path): each path must have launched its kernels.
Float32 matmuls and convolutions run without TF32 (both backend flags
off), so float32 comparisons on the card are exact float32.

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


def grad_kernel_checks(torch, fl):
    """K2 and K4 against their plain versions; returns (max_err, timing)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 7)
    cases = [  # name, b, c, label low, valid rows, all masked, all negative
        ("train", 256, 116, -1, None, False, False),
        ("softmax", 64, 116, -1, None, False, False),
        ("garbage", 64, 117, 0, None, False, False),
        ("garbage", 256, 117, 0, None, False, False),
        ("ragged", 1000, 1000, -1, None, False, False),
        ("tail", 64, 116, -1, 37, False, False),
        ("negatives", 64, 116, -1, None, False, True),
        ("masked", 64, 116, -1, None, True, False),
    ]
    max_err = {"entropic_bwd": 0.0, "ce_bwd": 0.0}
    rows = []
    for name, b, c, low, valid, masked, negative in cases:
        logits = torch.from_numpy((rng.normal(size=(b, c)) * 3).astype(
            np.float32)).to(dev)
        labels = torch.from_numpy(rng.integers(low, c, b).astype(
            np.int32)).to(dev)
        if negative:
            labels = -torch.ones_like(labels)
        mask = np.ones(b, np.float32)
        if valid is not None:
            mask[valid:] = 0
        if masked:
            mask[:] = 0
        mask = torch.from_numpy(mask).to(dev)
        class_w = torch.from_numpy(rng.uniform(0.2, 2.0, c).astype(
            np.float32)).to(dev)
        ce_rows = (class_w[labels.long().clamp(0, c - 1)] * mask
                   if name == "garbage" else (labels >= 0).float() * mask)
        scale = torch.tensor(0.37 / b, dtype=torch.float32, device=dev)
        runs = {
            "entropic_bwd": (
                lambda: fl.entropic_grad(logits, labels, mask, scale, 0.5),
                lambda: fl.entropic_grad_plain(logits, labels, mask, scale,
                                               0.5), mask),
            "ce_bwd": (
                lambda: fl.ce_grad(logits, labels, ce_rows, scale),
                lambda: fl.ce_grad_plain(logits, labels, ce_rows, scale),
                ce_rows),
        }
        for kname, (kernel, plain, rows_w) in runs.items():
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            ref = plain()
            where = f"{kname} {name} [{b},{c}]"
            check(got.dtype == logits.dtype and got.shape == logits.shape,
                  f"{where}: gradient {got.dtype} {tuple(got.shape)}")
            check(torch.equal(got, again), f"{where}: two launches differ")
            check(torch.allclose(got, ref, rtol=1e-5, atol=1e-8),
                  f"{where}: gradient differs from the plain version")
            check(bool((got[rows_w == 0] == 0).all()),
                  f"{where}: masked rows not exactly 0")
            err = float((got - ref).abs().max())
            max_err[kname] = max(max_err[kname], err)
            rows.append((kname, name, b, c, err, time_ms(kernel),
                         time_ms(plain), graph_ms(kernel), graph_ms(plain)))
    # autograd through the public losses: the kernels' backward equals the
    # plain backward at the train and validation shapes.
    for name, b, c, low in (("entropic", 256, 116, -1),
                            ("softmax", 64, 116, -1),
                            ("garbage", 64, 117, 0)):
        lg = torch.from_numpy((rng.normal(size=(b, c)) * 3).astype(
            np.float32)).to(dev).requires_grad_()
        labels = torch.from_numpy(rng.integers(low, c, b).astype(
            np.int32)).to(dev)
        mask = torch.from_numpy((rng.random(b) > 0.2).astype(
            np.float32)).to(dev)
        class_w = torch.from_numpy(rng.uniform(0.2, 2.0, c).astype(
            np.float32)).to(dev)
        if name == "entropic":
            mean, count = fl.entropic_openset_loss_fused(lg, labels, mask,
                                                         0.5)
            ref = fl.entropic_grad_plain(lg.detach(), labels, mask,
                                         1.0 / count.clamp(min=1.0), 0.5)
        else:
            fn = (fl.softmax_loss_fused if name == "softmax" else
                  lambda *a: fl.garbage_loss_fused(a[0], a[1], class_w,
                                                   a[2]))
            mean, wsum = fn(lg, labels, mask)
            r = ((labels >= 0).float() * mask if name == "softmax" else
                 class_w[labels.long().clamp(0, c - 1)] * mask)
            ref = fl.ce_grad_plain(lg.detach(), labels, r,
                                   1.0 / wsum.clamp(min=1e-12))
        (got,) = torch.autograd.grad(mean, lg)
        check(torch.allclose(got, ref, rtol=1e-5, atol=1e-8),
              f"autograd through {name} loss differs from the plain backward")
    print("kernel      case       shape        max_abs_err   call_ms  "
          "plain_call_ms  dev_ms   plain_dev_ms")
    for kname, name, b, c, err, ms, pms, dms, pdms in rows:
        print(f"{kname:11s} {name:10s} [{b},{c}]".ljust(36) +
              f"{err:.3e}   {ms:.5f}  {pms:.5f}        {dms:.5f}  {pdms:.5f}")
    main_shape = {"entropic_bwd": ("train", 256, 116),
                  "ce_bwd": ("garbage", 64, 117)}
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


# -- phase 5: training --------------------------------------------------------

VARIANT = "resnet50"
TRAIN_ROWS = 560          # 2 batches of 256 and a ragged tail of 48 rows
TRAIN_BATCH = 256
GHOST = 64


def write_index(out_dir):
    """A protocol CSV: every known class four times, the rest label -1."""
    rng = np.random.default_rng(SEED + 5)
    labels = np.concatenate([np.repeat(np.arange(N_CLASSES), 4),
                             -np.ones(TRAIN_ROWS - 4 * N_CLASSES, int)])
    rng.shuffle(labels)
    path = out_dir / "p1_train.csv"
    with open(path, "w") as f:
        for i, label in enumerate(labels):
            f.write(f"n{max(label, 0):08d}/train_{i:05d}.JPEG,{label}\n")
    return path


class Run:
    """One training configuration: dataset, pipeline, model, steps."""

    def __init__(self, torch, csv, loss, batch, ghost, seed):
        from openset_imagenet_tpu_torch import train as engine
        from openset_imagenet_tpu_torch.config import NameSpace
        from openset_imagenet_tpu_torch.dataset import ImagenetDataset
        from openset_imagenet_tpu_torch.pipeline import (
            SyntheticReader, pipeline_from_dataset)

        ds = ImagenetDataset(csv, csv.parent / "imagenet")
        if loss == "garbage":
            ds.replace_negative_label()
        elif loss == "softmax":
            ds.remove_negative_label()
        self.n_classes = (ds.label_count - 1 if loss == "entropic"
                          else ds.label_count)
        weights = ds.calculate_class_weights() if loss == "garbage" else None
        self.pipeline = pipeline_from_dataset(
            ds, batch, is_training=True, seed=seed, num_workers=8,
            reader=SyntheticReader(crop=IMAGE, seed=seed), pin_memory=True)
        cfg = NameSpace({"model": {"variant": VARIANT,
                                   "bn_stats_rows": ghost}})
        model = engine.build_model(cfg, self.n_classes)  # weights: seed 0
        self.model = model.cuda().to(memory_format=torch.channels_last)
        tx = engine.build_optimizer(NameSpace({"type": "adam", "lr": 1e-3}),
                                    steps_per_epoch=len(self.pipeline))
        self.state = engine.create_state(self.model, tx)
        self.loss_fns = {fused: engine.make_loss_fn(loss, 1.0, weights,
                                                    fused=fused)
                         for fused in ("auto", False)}
        self.steps = {fused: engine.make_train_step(fn)
                      for fused, fn in self.loss_fns.items()}
        self.n_tail = len(ds) % batch
        self.tail_step = engine.make_tail_step(
            self.loss_fns["auto"], self.model, self.n_tail,
            self.steps["auto"])

    def epoch(self, torch, max_steps=None):
        from collections import defaultdict

        from openset_imagenet_tpu_torch import train as engine
        from openset_imagenet_tpu_torch.ops.losses import AverageMeter

        trackers = defaultdict(AverageMeter)
        hook = (None if max_steps is None else
                lambda state, done: done >= max_steps)
        engine.train_epoch(self.state, self.pipeline, 0, self.steps["auto"],
                           trackers, tail_step=self.tail_step,
                           step_hook=hook)
        return trackers


def train_all(torch, fl, out_dir):
    """Phase 5's main path: returns the runs and their launch counts."""
    csv = write_index(out_dir)
    ghost = Run(torch, csv, "entropic", TRAIN_BATCH, GHOST, SEED + 11)
    check(ghost.n_classes == N_CLASSES and
          ghost.n_tail == TRAIN_ROWS % TRAIN_BATCH < GHOST and
          ghost.tail_step is not None and
          ghost.tail_step is not ghost.steps["auto"],
          f"entropic run: {ghost.n_classes} classes, tail {ghost.n_tail}")
    small = {loss: Run(torch, csv, loss, BATCH, 0, SEED + 12)
             for loss in ("softmax", "garbage")}
    stats = {name: m.running_mean.clone()
             for name, m in ghost.model.named_modules()
             if name.endswith("layer4.2.bn3")}

    for k in fl.LAUNCHES:
        fl.LAUNCHES[k] = 0
    trackers = {"entropic": ghost.epoch(torch)}
    for loss, run in small.items():
        trackers[loss] = run.epoch(torch, max_steps=3)
    launches = dict(fl.LAUNCHES)
    print(f"launches on the train path: {launches}")

    check(ghost.state.step == 3 and all(
        r.state.step == 3 for r in small.values()), "steps taken")
    for loss, t in trackers.items():
        print(f"train {loss}: j {t['j'].avg:.6f} over {t['j'].count:.0f} "
              f"rows, {t['imgs/s'].avg:.1f} imgs/s (epoch, host clock)")
        check(np.isfinite(t["j"].avg) and t["j"].count > 0,
              f"{loss}: loss {t['j'].avg}")
    check(trackers["entropic"]["j"].count == TRAIN_ROWS,
          "entropic epoch did not cover every row")
    for name, before in stats.items():
        after = dict(ghost.model.named_modules())[name].running_mean
        check(not torch.equal(before, after), f"{name}: running mean did "
              "not move")
    check(launches["entropic_fwd"] >= 3 and launches["entropic_bwd"] >= 3
          and launches["ce_fwd"] >= 6 and launches["ce_bwd"] >= 6,
          f"train path did not go through all four kernels: {launches}")
    return ghost, launches


def train_checks(torch, ghost):
    """Loss falls on one batch; kernel vs plain step; rates and memory."""
    import copy

    batch = next(iter(ghost.pipeline.epoch(1)))
    images = torch.from_numpy(batch.images).cuda()
    labels = torch.from_numpy(batch.labels).cuda()
    mask = torch.from_numpy(batch.mask).cuda()
    state = ghost.state

    losses = []
    for _ in range(8):
        _, m = ghost.steps["auto"](state, images, labels, mask)
        losses.append(m["loss_sum"] / m["count"])
    losses = torch.stack(losses).cpu().numpy()
    print("loss over 8 steps on one batch: " +
          " ".join(f"{v:.4f}" for v in losses))
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          "loss did not fall on a repeated batch")

    # One state, one step through the kernels and one with fused=False.
    model_sd = copy.deepcopy(state.model.state_dict())
    opt_sd = copy.deepcopy(state.optimizer.state_dict())
    step0 = state.step
    captured = {}

    def capture(module, inputs, outputs):
        outputs[0].register_hook(
            lambda g: captured.__setitem__("logits", g.clone()))

    handle = state.model.register_forward_hook(capture)
    torch.backends.cudnn.deterministic = True
    grads = []
    for fused in ("auto", False, "auto"):
        state.model.load_state_dict(model_sd)
        state.optimizer.load_state_dict(opt_sd)
        state.step = step0
        ghost.steps[fused](state, images, labels, mask)
        torch.cuda.synchronize()
        grads.append((captured.pop("logits"),
                      [p.grad.clone() for p in state.model.parameters()]))
    torch.backends.cudnn.deterministic = False
    handle.remove()
    (gk, pk), (gp, pp), (gk2, pk2) = grads
    check(torch.equal(gk, gk2) and all(map(torch.equal, pk, pk2)),
          "two kernel steps from one state differ")
    check(torch.allclose(gk, gp, rtol=1e-5, atol=1e-8),
          "logits gradient: kernels vs fused=False")
    worst, worst_name = 0.0, None
    for (name, _), a, b in zip(state.model.named_parameters(), pk, pp):
        ref = float(b.float().norm())
        diff = float((a.float() - b.float()).norm())
        if (diff / ref if ref else diff) > worst:
            worst, worst_name = diff / ref if ref else diff, name
    print(f"logits gradient kernels vs plain: max |d| "
          f"{float((gk - gp).abs().max()):.3e}; parameter gradients: max "
          f"relative norm difference {worst:.3e} ({worst_name})")
    check(worst <= 2e-2, "parameter gradients: kernels vs fused=False")

    # Train-step rate at batch 256, device-resident batch, in turns.
    def rate(fused, n=5):
        for _ in range(2):
            ghost.steps[fused](state, images, labels, mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            ghost.steps[fused](state, images, labels, mask)
        torch.cuda.synchronize()
        return TRAIN_BATCH * n / (time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    rates = {"auto": [], False: []}
    for fused in ("auto", False, False, "auto"):
        rates[fused].append(rate(fused))
    peak = torch.cuda.max_memory_allocated()
    for fused, label in (("auto", "kernels"), (False, "fused=False")):
        print(f"train step batch {TRAIN_BATCH} ghost-{GHOST} ({label}): "
              + " / ".join(f"{r:.1f}" for r in rates[fused]) + " imgs/s")
    print(f"peak device memory, batch {TRAIN_BATCH} train steps: "
          f"{peak / 2**30:.3f} GiB ({peak} bytes)")


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
    grad_err, grad_timing = grad_kernel_checks(torch, fl)
    max_err.update(grad_err)
    timing.update(grad_timing)
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
    del pred, garbage_model, results

    t0 = time.perf_counter()
    ghost, train_launches = train_all(torch, fl, out_dir)
    train_checks(torch, ghost)
    print(f"phase train: ok ({time.perf_counter() - t0:.1f} s)")

    replaces = {"entropic_fwd": 39, "entropic_bwd": 69, "ce_fwd": 172,
                "ce_bwd": 191}
    kernels = [
        {"name": name, "route": "triton",
         "source": "openset_imagenet_tpu_torch/ops/triton_fused_loss.py",
         "replaces": f"openset_imagenet_tpu/ops/fused_loss.py:{line}",
         "launches": launches[name] + train_launches[name],
         "max_abs_err": max_err[name], "ms": timing[name][0],
         "plain_ms": timing[name][1]}
        for name, line in replaces.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
