#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port, on one NVIDIA card.

    python3 chip_smoke.py

Drives ``openset_imagenet_tpu_torch`` through the entry points a user
calls, at full width (resnet50, 224 px, 116 known classes, random weights
from a seed), and checks what comes out and that each path launched its
kernels.  Before that it holds each kernel once against its plain version
at the main path's shapes; the card tests (``python -m pytest --noconftest
-m cuda tests/test_torch_cuda.py``) hold them over the shapes whose launch
plans differ, and both take their checks from ``tests/cuda_checks.py``.
A kernel's time on the card comes from ``tools/ab_torch_kernels.py`` (K1-K6
and ``int8_conv``, of two checkouts, in turns), the bench tools (K6, K7)
and the cells' per-layer metrics (the loss, batch-norm and
window-attention kernels).

1. the card: name and power limit from ``nvidia-smi``; then ``nvcc``
   builds K5, K6 and ``int8_conv`` side by side (``ops/_build.py``), so
   that the tools' processes and the later phases find them built;
2. each kernel of the ``kernels`` line against its plain version, once at
   the main path's shapes (``tests/cuda_checks.py``'s ``MAIN_PATH``, whose
   checks and bounds the card tests share): K1 and K2 at [256, 116], K3
   and K4 at [64, 117], K5 and K6 at resnet50's stage-1 tail at batch 256,
   K7 at [8, 3136, 256], ``int8_conv`` at the stage-1 3x3 conv at batch
   256, the batch-norm kernels at a [256, 256, 56, 56] map with a window of
   64 images, the window attention at Swin-B's four stages at batch 256,
   the LayerNorm fused with its junction at Swin-B's stages 1 and 3 and
   alone at patch merging's 2,048 channels, at batch 256; the phase's
   table must name each kernel of that line;
2e. the two ported bench tools as the entry points they are, each in its
   own process with few iterations (``python -m openset_imagenet_tpu_torch.
   tools.bench_split_site --iters 2``, ``...bench_stream --iters 3``): their
   JSON lines' cases, finite numbers, the card, K6's four kernels in the
   split case's profile, and that their kernel cases launched K5, K6 and
   K7 (each tool reports the launches of its cases; a fresh process
   starts from zero counts);
3. serving: a reference ``.pth`` -> ``OpenSetPredictor(device="cuda")``,
   ``warmup(64)``, requests of 1, 3, 17 and 64 images; shapes, finiteness,
   scores that do not depend on the padding bucket, rejection, agreement
   with a float32 CPU forward on two images;
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
   on the H100;
6. fused-block training: the same index through a ``drop_remainder=True``
   pipeline (two full batches of 256) -> ``train_epoch`` of a resnet50
   with ``model.fused_blocks`` and ``model.boundary_mask`` (ghost-64,
   entropic through K1/K2, Adam), every pointwise backward site through
   K5, then ``validate`` of that model in eval mode, within 1e-2 of the
   unfused model on the same weights (its batch-norms written out, as
   the fused block's ghost pre-pass is, in every fused-against-unfused
   check of the phase; in the float32 checks the fused model's stem
   batch-norm too).  Checks: finite losses, running
   statistics that moved, >= 32 K5 launches per step, the loss falling
   over eight steps on one batch; from one state (cuDNN deterministic)
   two kernel steps bitwise equal, the kernel against the plain site
   (``use_kernel=False``: parameter gradients within 2e-2 in norm), the
   fused model against the unfused one (bf16: loss within 1e-2, gradients
   within 5e-2 in norm, the two backwards rounding in other places;
   float32 at batch 64, ghost-16, no TF32: gradients within 1e-3).
   Prints train-step imgs/s of both forms in turns and their peak memory;
7. the worker: ``train.worker(cfg)`` from an in-code config (synthetic
   reader, 8 decode threads, cuDNN deterministic), each run in a fresh
   output directory, over phase 5's 560-row index and a 320-row
   validation index with 88 negatives: (a) entropic, batch 256, ghost-64,
   Adam lr 1e-3, 2 epochs, checkpoints written in the background --
   ``_curr``, ``_best``, the log file and five scalars for each epoch, 116
   classes, the 48-row tail through the tail step, K1 on every train and
   eval step and K2 on every train step; (b) the same run cut by
   ``max_steps: 4`` after batch 1 of epoch 1 (``extra.progress``), then
   resumed to 2 epochs: its ``_curr`` (weights, buffers, optimizer state,
   counters) bit-equal to (a)'s; (c) the same with ``fused_blocks`` +
   ``boundary_mask``, 1 epoch: the tail dropped (2 steps), >= 32 K5 site
   calls a step, γ written; (d) softmax and garbage at batch 64, 1 epoch,
   garbage with ``opt: {ema: 0.999, accumulate_steps: 2}``: 116 and 117
   classes, the softmax run on the known rows only, K3 and K4 on every
   step, garbage's ``_best`` holding the EMA shadow, not ``_curr``'s
   weights.  Prints each run's ``info``, j, γ, epoch and validation
   seconds, the checkpoint writes' seconds on the writer thread against
   the training thread's seconds in ``save()`` (host clock), and the
   phase's seconds.  The checkpoints of (a) and (d) stay for phase 8;
8. evaluation: a 2,111-row test index beside phase 7's validation index
   (every known class ten times, 475 rows -1, 476 rows -2; eight batches
   of 256 and a ragged tail of 63), then ``script.evaluate.main``
   in-process (``--device cuda --reader synthetic``, batch 256, without
   ``--model-variant``: the architecture comes from the checkpoint) on
   (a)'s entropic ``_curr`` and ``_best`` and (d)'s softmax and garbage
   ``_curr``.  Checks: 116 columns (117 for garbage), ``gt`` float32 with
   -1 and -2 (no label surgery) and one row per CSV row, finite values,
   scores rows summing to 1 within 1e-5, and the first test batch's
   logits bit-equal to ``make_forward_step`` on the same file loaded by
   ``OpenSetPredictor`` (cuDNN deterministic).  Then ``plot_all.
   load_scores`` with ``--force`` (one child ``python -m ...script.
   evaluate -g 0`` per loss, at its default batch 64; the entropic test
   scores within 1e-4 of batch 256's, the logits within 1e-2 of their
   largest) and ``conf_and_ccr_table`` (no PDF:
   the GPU host has no matplotlib); and ``calculate_oscr_torch`` on the
   card at 50,000 x 117 (bf16-rounded scores, so ties) against numpy
   ``calculate_oscr``: every numpy threshold's ccr and fpr within 1e-6
   of the device's at the same threshold, for all thresholds and for
   1,000.  Prints the OSCR device ms beside numpy's, with the card's name
   and power limit.  The phase launches no kernel of the port (a forward and a
   float32 softmax, as the JAX extraction step).  It keeps (a)'s
   ``_best`` and its val arrays for phase 9;
9. prediction paths and the daemon, from phase 7's (a) entropic ``_best``
   and phase 8's val arrays of it, on the card with cuDNN deterministic:
   ``calibrate_threshold`` at FPR 0.1 in both modes equal to
   ``threshold_at_fpr`` of the same measure; ``script.predict.main``
   in-process over a listing of 600 placeholder paths (``--reader
   synthetic``, batch 256: chunks of 256, 256 and 88), streamed and
   ``--no-stream``, with ``--features-output``: the CSVs byte-equal, the
   archives' arrays byte-equal (the zip's timestamps differ), every row
   bit-equal to ``OpenSetPredictor.predict`` on the same pixels at the
   same chunks; ``--threshold-at-fpr 0.1``: a row is -1 exactly when its
   measure is below the threshold.  Then
   ``PredictionServer`` in-process (``max_batch`` 64, window 2 ms) whose
   ``decode`` takes raw 224x224x3 bodies (the GPU host has neither
   libjpeg nor PIL; the line says what ``native_available()`` gave):
   healthz, a single request and a JSON batch of 5 bit-equal to
   ``predict`` at their buckets, ``?features=1``, 404, 400 and 413;
   closed-loop clients at concurrency 1, 4, 16 and 64 over 512 requests
   (imgs/s, p50 / p99 ms, ``mean_batch`` > 1 at 16, no error, answers
   within phase 3's bucket rule against bucket 64); a poisoned
   ``_gather``: the request in hand and the next fail at once and healthz
   answers 503 ``dead`` within a second; ``close()``.  The first forward
   of each cold bucket 1 ... 64 beside its warm time comes from a fresh
   process (``chip_smoke.py --cold-buckets CKPT``).  Last, ``python -m
   openset_imagenet_tpu_torch.script.serve CKPT auto --port 0
   --max-batch 64`` as a process: its ``http://`` line (time to ready,
   warm-up included), healthz 200, ``/stats``, SIGTERM -> exit 0 within
   60 s.  Launch counts are zeroed and read around the phase: it runs
   none of the eight kernels;
10. inference optimization, from the same ``_best`` on the card with
   cuDNN deterministic: ``OpenSetPredictor`` in four modes -- unoptimized,
   ``optimize="fold_bn"``, ``"int8"`` self-calibrated (abs-max) on the
   first 256 of phase 9's synthetic paths and ``"int8"`` at percentile
   99.9 -- each with its forward ms at batch 64 and 256 (CUDA events, on
   device-resident uint8), its ``int8_conv`` launches in one forward (52
   for int8, 0 otherwise), its classes and softmax over phase 9's 600
   paths against the unoptimized predictor's (``fold_bn``'s softmax
   within 1e-4, a class flipping only where the top two scores lie
   within twice that drift: (a) answers every image with one
   near-uniform row; the int8 modes print their agreement and largest
   softmax drift) and an empty calibration cache after the pass; then
   ``fold_bn``'s classes on a model whose answers depend on the image,
   (a)'s ``_best`` trained on until each distinct image of the paths is
   a class of its own by a logit margin of 2 in eval mode, against the
   unoptimized predictor of that model by the JAX tests' rule (at most
   one flip, at a near-tie, scores within rtol 0.1, atol 0.05); then
   ``script.predict.main`` with ``--optimize fold_bn`` and with
   ``--optimize int8`` (self-calibrated, ``--reader synthetic``): every
   row's class that of the same mode's predictor; then the raw-body
   daemon on the ``fold_bn`` predictor at 16 closed-loop clients within
   phase 3's bucket rule.  Launch counts are zeroed and read around the
   phase: ``int8_conv`` and no other kernel.
11. the Swin: ``worker(cfg)`` on ``model: {arch: swin, variant: swin_b}``
   (published widths) at batch 64 over phase 7's index, cut by
   ``max_steps: 4``: four train steps through the loss kernels, the
   window-attention kernels' ``LAUNCHES`` (one forward and one backward
   a block of 24: 96 each), the LayerNorm kernels' (a step: 8 alone and
   45 fused with their junction, each way), the attention and LayerNorm
   kernels that ran in one traced step (profiler names:
   ``osi_win_flash_fwd``, ``osi_win_flash_bwd``, ``osi_layer_norm_fwd``
   and ``osi_layer_norm_bwd`` alone, and no roll kernel), the ``_curr``
   checkpoint's ``extra.arch``, and ``OpenSetPredictor`` rebuilding a
   Swin from it on the card (finite scores on 64 images).

The launch counts are zeroed just before phase 3 and read after phase 4
(the serving path: the batch-norm's apply kernel and not its
statistics), zeroed again before phase 5's epochs and read after
them (the train path), again around phase 6's epoch and validation
(the fused train path), around each of phase 7's worker runs and
around phase 10 (the optimized serving path, ``int8_conv``): each path
must have launched its kernels.  Phase 8's and phase 9's counts are
zeroed and read too, and printed: their paths run none of them.
Float32 matmuls and convolutions run without TF32 (both backend flags
off), so float32 comparisons on the card are exact float32.

The second-to-last line is ``{"kernels": [...]}``: for each of the
fourteen kernels, its ``name``, ``route`` (``triton`` or ``cuda``),
``source``, what it ``replaces`` (the TPU kernel's file and line in the
JAX package, or what the port ran before it where there is none) and its
``launches`` on its path (the loss kernels over phases 3-7, K5 over
phases 6-7, K6 and K7 in phase 2e's tool processes, ``int8_conv`` in
phase 10, the batch-norm kernels over phases 3-5, the window attention and
the LayerNorm in phase 11); every kernel must have launched.  The last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and no result line is printed. Without a CUDA device
the script exits non-zero at once. Build outputs (Triton's cache, the K5,
K6 and int8_conv libraries, the checkpoint) go to ``build/`` in the
checkout.
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
    from openset_imagenet_tpu_torch.tools import _card

    return _card.event_ms(fn, reps=reps, warmup=warmup)


# -- phase 2: each kernel against its plain version --------------------------

def kernel_table(torch):
    """One check of each kernel at the main path's shapes; the kernels
    checked."""
    sys.path.insert(0, str(REPO / "tests"))   # as pytest finds it
    import cuda_checks

    device = torch.device("cuda")
    for name, fn, args in cuda_checks.MAIN_PATH:
        t0 = time.perf_counter()
        try:
            fn(device, *args)
        except AssertionError as err:
            raise RuntimeError(f"check failed: {name} {args} against its "
                               f"plain version: {err}") from err
        print(f"{name} {args}: matches its plain version "
              f"({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
    return {name for name, _, _ in cuda_checks.MAIN_PATH}


# -- phase 2e: the bench tools as entry points --------------------------------

def run_tool(module, *args):
    """Run ``python -m module args`` from the checkout; its JSON lines."""
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"{module} exited {out.returncode}:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    lines = [json.loads(line) for line in out.stdout.splitlines()
             if line.startswith("{")]
    for line in lines:
        print(json.dumps(line))
    return lines


def tool_runs():
    """Both ported bench tools in their own processes; returns the launches
    of each kernel that their cases reported."""
    launches = {}
    split = run_tool("openset_imagenet_tpu_torch.tools.bench_split_site",
                     "--iters", "2")
    stream = run_tool("openset_imagenet_tpu_torch.tools.bench_stream",
                      "--iters", "3")
    check([r["case"] for r in split] == ["torch_plain", "cuda_unified",
                                         "cuda_split"], "split tool cases")
    check([r["case"] for r in stream] == ["torch_axpy", "torch_relu_mask",
                                          "triton_axpy", "triton_relu_mask"],
          "stream tool cases")
    for r in split + stream:
        numbers = [v for v in r.values() if isinstance(v, float)]
        check(all(np.isfinite(numbers)) and r["device"] ==
              r["card"].split(",")[0], f"tool line {r['case']}: {r}")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    stages = split[2]["kernel_ms_per_site"]
    check(split[2]["route"] == "tensor_cores" and
          all(any(k.startswith(s) for k in stages)
              for s in ("k1_gate<", "k2_dxa_tc<", "k3_dx<", "k4_dw_tc<",
                        "reduce_sets")) and
          sorted(split[2]["stage_share"]) == ["k1_gate", "k2_dxa", "k3_dx",
                                             "k4_dw"],
          f"the split case's profile lacks a K6 kernel: {stages}")
    check(split[0]["launches"] == {"fused_block_bwd": 0, "split_site": 0}
          and split[1]["launches"]["fused_block_bwd"] > 0
          and split[2]["launches"]["split_site"] > 0
          and stream[2]["launches"]["stream_axpy"] > 0
          and stream[3]["launches"]["stream_relu_mask"] > 0,
          f"the tools' kernel cases did not launch their kernels: {launches}")
    return launches


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

    def __init__(self, torch, csv, loss, batch, ghost, seed, fused=False):
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
        # A fused_blocks model drops the ragged tail, as the JAX worker.
        self.pipeline = pipeline_from_dataset(
            ds, batch, is_training=True, seed=seed, num_workers=8,
            reader=SyntheticReader(crop=IMAGE, seed=seed), pin_memory=True,
            drop_remainder=fused)
        cfg = NameSpace({"model": {"variant": VARIANT, "bn_stats_rows": ghost,
                                   "fused_blocks": fused,
                                   "boundary_mask": fused}})
        model = engine.build_model(cfg, self.n_classes)  # weights: seed 0
        self.model = model.to(memory_format=torch.channels_last)
        tx = engine.build_optimizer(NameSpace({"type": "adam", "lr": 1e-3}),
                                    steps_per_epoch=len(self.pipeline))
        self.state = engine.create_state(self.model, tx)
        self.loss_fns = {fused: engine.make_loss_fn(loss, 1.0, weights,
                                                    fused=fused)
                         for fused in ("auto", False)}
        self.steps = {fused: engine.make_train_step(fn)
                      for fused, fn in self.loss_fns.items()}
        self.n_tail = 0 if fused else len(ds) % batch
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
              "rows")
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
    """Loss falls on one batch; kernel vs plain step."""
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


def rates_in_turns(torch, forms, images, labels, mask, n=5):
    """Train-step imgs/s on a device-resident batch for two forms
    ``{label: (state, step)}``, in turns a, b, b, a (two warm-up steps
    before each turn), and each form's peak device memory."""
    rates = {label: [] for label in forms}
    peaks = dict.fromkeys(forms, 0)
    a, b = forms
    for label in (a, b, b, a):
        state, step = forms[label]
        for _ in range(2):
            step(state, images, labels, mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, images, labels, mask)
        torch.cuda.synchronize()
        rates[label].append(len(images) * n / (time.perf_counter() - t0))
        peaks[label] = max(peaks[label], torch.cuda.max_memory_allocated())
    for label in forms:
        print(f"train step batch {len(images)} ghost-{GHOST} ({label}): "
              + " / ".join(f"{r:.1f}" for r in rates[label]) +
              f" imgs/s; peak device memory {peaks[label] / 2**30:.3f} GiB "
              f"({peaks[label]} bytes)")


# -- phase 6: fused-block training -------------------------------------------

def worst_rel(names, grads, refs):
    """Worst relative norm difference of ``grads`` against ``refs``."""
    worst, worst_name = 0.0, None
    for name, a, b in zip(names, grads, refs):
        ref = float(b.float().norm())
        diff = float((a.float() - b.float()).norm())
        rel = diff / ref if ref else diff
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name


def report(label, names, grads, refs):
    """Print the worst parameters and the whole gradient's relative norm
    difference; return (worst parameter's, whole gradient's)."""
    import torch

    rels = sorted((worst_rel([n], [a], [b])[0], n)
                  for n, a, b in zip(names, grads, refs))
    flat = lambda ts: torch.cat([t.float().reshape(-1) for t in ts])
    whole = worst_rel(["all"], [flat(grads)], [flat(refs)])[0]
    print(f"{label}: parameter gradients, relative norm difference: worst "
          + ", ".join(f"{n} {r:.3e}" for r, n in rels[::-1][:5]) +
          f"; median {rels[len(rels) // 2][0]:.3e}; all parameters as one "
          f"vector {whole:.3e}")
    return rels[-1][0], whole


def param_grads(model):
    names, grads = zip(*[(n, p.grad) for n, p in model.named_parameters()])
    return list(names), list(grads)


def set_use_kernel(model, use_kernel):
    from openset_imagenet_tpu_torch.models.resnet import Bottleneck

    for m in model.modules():
        if isinstance(m, Bottleneck):
            m.use_kernel = use_kernel


def grads_of(torch, model, loss_fn, images, labels, mask):
    """One train-mode forward and backward from the model's current state
    (the statistics it updates are restored); returns the loss."""
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    model.train()
    model.zero_grad(set_to_none=True)
    logits, _ = model(images.float() * (1.0 / 255.0))
    loss, _ = loss_fn(logits, labels, mask)
    loss.backward()
    with torch.no_grad():
        for k, v in model.named_buffers():
            v.copy_(buffers[k])
    return float(loss.detach())


def written_out_norms(model):
    """Run every batch-norm module of ``model`` written out
    (``use_kernel=False``), as the fused block's ghost pre-pass and fold
    are: then a fused model and its unfused twin differ by the fused
    backward alone (the card tests hold the batch-norm kernels to the
    written-out path)."""
    from openset_imagenet_tpu_torch.models.norm import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.use_kernel = False
    return model


def unfused_twin(torch, fused_model, n_classes, ghost, dtype):
    """The unfused model on the fused one's weights, its batch-norms
    written out."""
    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace

    model = engine.build_model(NameSpace({"model": {
        "variant": VARIANT, "bn_stats_rows": ghost}}), n_classes, dtype=dtype)
    model.load_state_dict(fused_model.state_dict())
    return written_out_norms(model).to(memory_format=torch.channels_last)


def train_fused(torch, fl, fbb, csv):
    """Phase 6's main path: a fused_blocks epoch and its validation."""
    from collections import defaultdict

    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.ops.losses import AverageMeter

    run = Run(torch, csv, "entropic", TRAIN_BATCH, GHOST, SEED + 13,
              fused=True)
    check(run.tail_step is None and len(run.pipeline) == 2,
          f"fused run: {len(run.pipeline)} batches, tail step "
          f"{run.tail_step}")
    stats = {name: m.running_mean.clone()
             for name, m in run.model.named_modules()
             if name.endswith(("layer1.0.bn1", "layer4.2.bn3"))}
    for k in fl.LAUNCHES:
        fl.LAUNCHES[k] = 0
    fbb.LAUNCHES["fused_block_bwd"] = 0
    trackers = run.epoch(torch)
    val = defaultdict(AverageMeter)
    eval_step = engine.make_eval_step(run.loss_fns["auto"], "entropic",
                                      N_CLASSES)
    engine.validate(run.model, validation_batches(N_CLASSES, "entropic"), 0,
                    eval_step, val)
    launches = {**fl.LAUNCHES, **fbb.LAUNCHES}
    print(f"launches on the fused train path: {launches}")
    t = trackers
    print(f"train fused: j {t['j'].avg:.6f} over {t['j'].count:.0f} rows, "
          f"{t['imgs/s'].avg:.1f} imgs/s (epoch, host clock); validate: j "
          f"{val['j'].avg:.6f} conf_kn {val['conf_kn'].avg:.6f} conf_unk "
          f"{val['conf_unk'].avg:.6f} over {val['j'].count:.0f} rows")
    check(run.state.step == 2 and t["j"].count == 2 * TRAIN_BATCH and
          np.isfinite(t["j"].avg), f"fused epoch: {run.state.step} steps, "
          f"{t['j'].count} rows, j {t['j'].avg}")
    check(np.isfinite(val["j"].avg) and val["j"].count == 3 * BATCH + 37,
          f"fused validate: j {val['j'].avg} over {val['j'].count} rows")
    for name, before in stats.items():
        after = dict(run.model.named_modules())[name].running_mean
        check(not torch.equal(before, after), f"fused {name}: running mean "
              "did not move")
    check(launches["fused_block_bwd"] >= 32 * run.state.step,
          f"fused train path: {launches['fused_block_bwd']} K5 launches "
          f"for {run.state.step} steps")
    check(launches["entropic_fwd"] >= 2 and launches["entropic_bwd"] >= 2,
          f"fused train path skipped the loss kernels: {launches}")

    # The same weights, unfused, in eval mode: the validation agrees.
    twin = unfused_twin(torch, run.model, N_CLASSES, GHOST, torch.bfloat16)
    twin_val = defaultdict(AverageMeter)
    engine.validate(twin, validation_batches(N_CLASSES, "entropic"), 0,
                    eval_step, twin_val)
    print(f"validate unfused twin: j {twin_val['j'].avg:.6f}")
    check(abs(val["j"].avg - twin_val["j"].avg) <= 1e-2 *
          abs(twin_val["j"].avg), "fused vs unfused validation loss")
    return run, twin, launches


def fused_checks(torch, run, twin, ghost):
    """Loss falls; kernel repeat, kernel vs plain site, fused vs unfused;
    the f32 check; rates and peak memory."""
    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace

    batch = next(iter(run.pipeline.epoch(1)))
    images = torch.from_numpy(batch.images).cuda()
    labels = torch.from_numpy(batch.labels).cuda()
    mask = torch.from_numpy(batch.mask).cuda()
    state = run.state
    losses = []
    for _ in range(8):
        _, m = run.steps["auto"](state, images, labels, mask)
        losses.append(m["loss_sum"] / m["count"])
    losses = torch.stack(losses).cpu().numpy()
    print("fused: loss over 8 steps on one batch: " +
          " ".join(f"{v:.4f}" for v in losses))
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          "fused: loss did not fall on a repeated batch")

    loss_fn = run.loss_fns["auto"]
    model = state.model
    twin.load_state_dict(model.state_dict())
    torch.backends.cudnn.deterministic = True
    first = grads_of(torch, model, loss_fn, images, labels, mask)
    kernel_grads = [p.grad.clone() for p in model.parameters()]
    second = grads_of(torch, model, loss_fn, images, labels, mask)
    check(first == second and all(
        torch.equal(a, p.grad) for a, p in zip(kernel_grads,
                                               model.parameters())),
          "fused: two kernel steps from one state differ")
    set_use_kernel(model, False)
    grads_of(torch, model, loss_fn, images, labels, mask)
    set_use_kernel(model, None)
    names, plain_grads = param_grads(model)
    # Gradient checks run after every number is printed.  "In norm": the
    # difference of all parameter gradients as one vector, relative to
    # that vector's norm; the worst single parameter is printed beside it.
    late = []
    _, whole = report("fused: kernel vs plain site (bf16)", names,
                      kernel_grads, plain_grads)
    late.append((whole <= 2e-2, "fused: kernel vs plain site gradients"))
    twin_loss = grads_of(torch, twin, loss_fn, images, labels, mask)
    print(f"fused vs unfused (bf16, batch {TRAIN_BATCH}, ghost-{ghost}): loss "
          f"{first:.6f} vs {twin_loss:.6f}")
    _, whole = report("fused vs unfused (bf16)", names, kernel_grads,
                      param_grads(twin)[1])
    late.append((abs(first - twin_loss) <= 1e-2 * abs(twin_loss),
                 "fused vs unfused loss"))
    late.append((whole <= 5e-2, "fused vs unfused parameter gradients "
                 "(bf16)"))

    # float32, batch 64, TF32 off: ghost-16, then a window of the whole
    # batch (the pre-pass conv then has the main conv's shape, so no ReLU
    # gate can flip between the two models: every parameter must agree).
    # Both models' batch-norm modules run written out (the fused model's
    # stem), so that their forwards agree bit for bit outside the blocks.
    sl = slice(0, BATCH)
    for rows in (16, BATCH):
        f32 = engine.build_model(NameSpace({"model": {
            "variant": VARIANT, "bn_stats_rows": rows, "fused_blocks": True,
            "boundary_mask": True}}), N_CLASSES, dtype=torch.float32)
        f32 = written_out_norms(f32).to(memory_format=torch.channels_last)
        f32.load_state_dict(model.state_dict())
        f32_twin = unfused_twin(torch, f32, N_CLASSES, rows, torch.float32)
        loss_a = grads_of(torch, f32, loss_fn, images[sl], labels[sl],
                          mask[sl])
        f32_kernel = [p.grad.clone() for p in f32.parameters()]
        loss_b = grads_of(torch, f32_twin, loss_fn, images[sl], labels[sl],
                          mask[sl])
        label = f"fused vs unfused (f32, batch {BATCH}, ghost-{rows})"
        print(f"{label}: loss {loss_a:.7f} vs {loss_b:.7f}")
        worst, whole = report(label, names, f32_kernel,
                              param_grads(f32_twin)[1])
        late.append((whole <= 1e-3 if rows < BATCH else worst <= 1e-3,
                     f"{label}: parameter gradients"))
        if rows < BATCH:
            set_use_kernel(f32, False)
            grads_of(torch, f32, loss_fn, images[sl], labels[sl], mask[sl])
            worst, _ = report("fused: kernel vs plain site (f32)", names,
                              f32_kernel, param_grads(f32)[1])
            late.append((worst <= 1e-3, "fused: kernel vs plain site "
                         "gradients (f32), every parameter"))
        del f32, f32_twin
    torch.backends.cudnn.deterministic = False

    twin_state = engine.create_state(twin, engine.build_optimizer(
        NameSpace({"type": "adam", "lr": 1e-3}), steps_per_epoch=2))
    rates_in_turns(torch, {"fused_blocks (K5)": (state, run.steps["auto"]),
                           "unfused": (twin_state, run.steps["auto"])},
                   images, labels, mask)
    for ok, message in late:
        check(ok, message)


# -- phase 7: the worker ------------------------------------------------------

VAL_ROWS = 320            # 116 known classes twice, 88 negatives


def write_val_index(out_dir):
    """The validation CSV of the worker runs: every known class twice and
    the rest label -1 (two batches of 256, five of 64)."""
    rng = np.random.default_rng(SEED + 7)
    labels = np.concatenate([np.repeat(np.arange(N_CLASSES), 2),
                             -np.ones(VAL_ROWS - 2 * N_CLASSES, int)])
    rng.shuffle(labels)
    path = out_dir / "p1_val.csv"
    with open(path, "w") as f:
        for i, label in enumerate(labels):
            f.write(f"n{max(label, 0):08d}/val_{i:05d}.JPEG,{label}\n")
    return path


def worker_cfg(out_dir, run, loss="entropic", batch=TRAIN_BATCH, epochs=2,
               model=None, opt=None, **over):
    """An in-code config of one ``worker`` run (no YAML on the GPU host)."""
    from openset_imagenet_tpu_torch.config import NameSpace

    return NameSpace({
        "name": loss, "checkpoint": None, "log_name": "training.log",
        "train_mode": "train",
        "data": {"imagenet_path": str(out_dir / "imagenet"),
                 "train_file": str(out_dir / "p{}_train.csv"),
                 "val_file": str(out_dir / "p{}_val.csv"),
                 "reader": "synthetic", "image_size": IMAGE},
        "seed": SEED + 21, "batch_size": batch, "epochs": epochs,
        "workers": 8, "patience": 0, "loss": {"type": loss, "w": 1.0},
        "opt": opt or {"type": "adam", "lr": 1e-3},
        "model": model or {"variant": VARIANT, "bn_stats_rows": GHOST},
        "async_checkpoint": True, "protocol": 1,
        "output_directory": out_dir / "worker" / run, **over})


class WorkerProbe:
    """Host-clock times of one ``worker`` run's epochs, validations and
    checkpoint writes, and the calls of its tail step, by wrapping the
    module functions the worker calls; the kernels' launch counts start
    at 0 with it."""

    def __init__(self, torch, fl, fbb):
        from openset_imagenet_tpu_torch import checkpoint as ckpt
        from openset_imagenet_tpu_torch import train as engine

        self.torch, self.fl, self.fbb = torch, fl, fbb
        self.engine, self.ckpt = engine, ckpt
        self.times = {"epoch": [], "validate": [], "write": [], "save": []}
        self.tail_rows = []

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.times[name].append(time.perf_counter() - t0)
        return call

    def _tail(self, make):
        def make_tail_step(loss_fn, model, n_tail, train_step):
            step = make(loss_fn, model, n_tail, train_step)
            if step is None or step is train_step:
                return step

            def tail(*args):
                state, m = step(*args)
                self.tail_rows.append(float(m["count"]))
                return state, m
            return tail
        return make_tail_step

    def run(self, cfg):
        engine, ckpt = self.engine, self.ckpt
        saved = (engine.train_epoch, engine.validate, engine.make_tail_step,
                 ckpt._write, ckpt.AsyncCheckpointer.save)
        engine.train_epoch = self._timed("epoch", engine.train_epoch)
        engine.validate = self._timed("validate", engine.validate)
        engine.make_tail_step = self._tail(engine.make_tail_step)
        ckpt._write = self._timed("write", ckpt._write)
        ckpt.AsyncCheckpointer.save = self._timed(
            "save", ckpt.AsyncCheckpointer.save)
        for k in self.fl.LAUNCHES:
            self.fl.LAUNCHES[k] = 0
        self.fbb.LAUNCHES["fused_block_bwd"] = 0
        t0 = time.perf_counter()
        try:
            info = engine.worker(cfg)
        finally:
            (engine.train_epoch, engine.validate, engine.make_tail_step,
             ckpt._write, ckpt.AsyncCheckpointer.save) = saved
        self.seconds = time.perf_counter() - t0
        self.launches = {**self.fl.LAUNCHES, **self.fbb.LAUNCHES}
        return info

    def report(self, label, cfg, info):
        from openset_imagenet_tpu_torch.events import read_scalars

        scalars = read_scalars(cfg.output_directory)
        last = {tag: values[-1][1] for tag, values in scalars.items()}
        gamma = last.get("val/conf_kn", 0.0) + last.get("val/conf_unk", 0.0)
        t = {k: [round(x, 3) for x in v] for k, v in self.times.items()}
        print(f"worker {label}: info {info}; j {last.get('train/loss')} "
              f"val j {last.get('val/loss')} gamma {gamma}; epoch s "
              f"{t['epoch']}, validate s {t['validate']}, checkpoint writes "
              f"s {t['write']} (writer thread) against save() s {t['save']} "
              f"(training thread); run {self.seconds:.2f} s (host clock); "
              f"launches {self.launches}")
        return scalars


def same_checkpoints(torch, a, b):
    """Two ``_curr`` files hold bit-equal weights, buffers, optimizer
    state and counters; returns the number of tensors compared."""
    pa = torch.load(a, map_location="cpu", weights_only=True)
    pb = torch.load(b, map_location="cpu", weights_only=True)
    check(pa["step"] == pb["step"] and pa["updates"] == pb["updates"] and
          pa["epoch"] == pb["epoch"], f"counters differ: {a} {b}")
    n = 0
    for k, v in pa["model_state_dict"].items():
        check(torch.equal(v, pb["model_state_dict"][k]), f"{k} differs")
        n += 1
    oa, ob = pa["opt_state_dict"], pb["opt_state_dict"]
    check(oa["param_groups"] == ob["param_groups"], "param groups differ")
    for i, st in oa["state"].items():
        for name, value in st.items():
            check(torch.equal(value, ob["state"][i][name]),
                  f"optimizer state {i}/{name} differs")
            n += 1
    return n


def worker_phase(torch, fl, fbb, out_dir):
    """Phase 7: ``worker(cfg)`` runs (a)-(d) on the card; returns the
    launches of the kernels over the four runs.  The checkpoints of (a)
    and (d) stay for phase 8."""
    import shutil

    from openset_imagenet_tpu_torch.checkpoint import read_metadata

    write_val_index(out_dir)
    shutil.rmtree(out_dir / "worker", ignore_errors=True)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    total = {}

    def count(probe):
        for k, v in probe.launches.items():
            total[k] = total.get(k, 0) + v

    try:
        # (a) entropic, batch 256, ghost-64, Adam, 2 epochs, async writes.
        cfg_a = worker_cfg(out_dir, "a")
        probe = WorkerProbe(torch, fl, fbb)
        info = probe.run(cfg_a)
        scalars = probe.report("(a) entropic", cfg_a, info)
        count(probe)
        out = cfg_a.output_directory
        check(all((out / f).exists() for f in (
            "entropic_curr.pth", "entropic_best.pth", "training.log")),
            "(a): a file is missing")
        check(len(scalars) == 5 and all(len(v) == 2 for v in
                                        scalars.values()),
              f"(a): scalars {sorted(scalars)}")
        check(info["n_classes"] == N_CLASSES and info["last_epoch"] == 1 and
              info["stopped_mid_epoch"] is None, f"(a): {info}")
        check(probe.tail_rows == [TRAIN_ROWS % TRAIN_BATCH] * 2,
              f"(a): tail-step rows {probe.tail_rows}")
        steps = 2 * len(range(0, TRAIN_ROWS, TRAIN_BATCH))
        evals = 2 * len(range(0, VAL_ROWS, TRAIN_BATCH))
        check(probe.launches["entropic_fwd"] == steps + evals and
              probe.launches["entropic_bwd"] == steps,
              f"(a): K1/K2 not on every step: {probe.launches}")
        check(read_metadata(out / "entropic_curr.pth")["step"] == steps,
              "(a): steps")

        # (b) the same run cut by max_steps inside epoch 1, then resumed.
        cfg_b = worker_cfg(out_dir, "b", max_steps=4)
        probe = WorkerProbe(torch, fl, fbb)
        info = probe.run(cfg_b)
        probe.report("(b) cut", cfg_b, info)
        count(probe)
        curr_b = cfg_b.output_directory / "entropic_curr.pth"
        meta = read_metadata(curr_b)
        check(info["stopped_mid_epoch"] == 1 and info["last_epoch"] == 1 and
              meta["extra"].get("progress") == {"epoch": 1,
                                                "next_batch": 1},
              f"(b): {info} {meta}")
        cfg_b2 = worker_cfg(out_dir, "b", checkpoint=str(curr_b))
        probe = WorkerProbe(torch, fl, fbb)
        info = probe.run(cfg_b2)
        probe.report("(b) resumed", cfg_b2, info)
        count(probe)
        n = same_checkpoints(torch, out / "entropic_curr.pth", curr_b)
        print(f"worker (b): the resumed _curr is bit-equal to (a)'s "
              f"({n} tensors, step {read_metadata(curr_b)['step']})")
        shutil.rmtree(cfg_b.output_directory)

        # (c) fused blocks + boundary mask, 1 epoch: the tail is dropped.
        cfg_c = worker_cfg(out_dir, "c", epochs=1, model={
            "variant": VARIANT, "bn_stats_rows": GHOST,
            "fused_blocks": True, "boundary_mask": True})
        probe = WorkerProbe(torch, fl, fbb)
        info = probe.run(cfg_c)
        scalars = probe.report("(c) fused", cfg_c, info)
        count(probe)
        step_c = read_metadata(cfg_c.output_directory /
                               "entropic_curr.pth")["step"]
        check(step_c == TRAIN_ROWS // TRAIN_BATCH and not probe.tail_rows,
              f"(c): {step_c} steps, tail {probe.tail_rows}")
        check(probe.launches["fused_block_bwd"] >= 32 * step_c,
              f"(c): K5 launches {probe.launches}")
        check(len(scalars.get("val/conf_kn", [])) == 1 and
              len(scalars.get("val/conf_unk", [])) == 1, "(c): no gamma")
        shutil.rmtree(cfg_c.output_directory)

        # (d) softmax, and garbage with EMA and accumulation, batch 64.
        for loss, opt, n_classes, rows in (
                ("softmax", None, N_CLASSES, 4 * N_CLASSES),
                ("garbage", {"type": "adam", "lr": 1e-3, "ema": 0.999,
                             "accumulate_steps": 2}, N_CLASSES + 1,
                 TRAIN_ROWS)):
            cfg_d = worker_cfg(out_dir, "d_" + loss, loss=loss, batch=BATCH,
                               epochs=1, opt=opt,
                               model={"variant": VARIANT})
            probe = WorkerProbe(torch, fl, fbb)
            info = probe.run(cfg_d)
            probe.report(f"(d) {loss}", cfg_d, info)
            count(probe)
            steps = len(range(0, rows, BATCH))
            curr = cfg_d.output_directory / f"{loss}_curr.pth"
            check(info["n_classes"] == n_classes and
                  read_metadata(curr)["step"] == steps,
                  f"(d) {loss}: {info}, {read_metadata(curr)}")
            check(probe.launches["ce_fwd"] >= steps and
                  probe.launches["ce_bwd"] == steps,
                  f"(d) {loss}: K3/K4 launches {probe.launches}")
            if loss == "garbage":
                c = torch.load(curr, map_location="cpu", weights_only=True)
                b = torch.load(cfg_d.output_directory / "garbage_best.pth",
                               map_location="cpu", weights_only=True)
                check(c["accumulation"]["mini_step"] == steps % 2 and
                      c["updates"] == steps // 2, "(d): accumulation")
                for name, shadow in c["ema_state_dict"].items():
                    check(torch.equal(b["model_state_dict"][name], shadow),
                          f"(d): _best {name} is not the EMA shadow")
                check(not torch.equal(
                    b["model_state_dict"]["logits.weight"],
                    c["model_state_dict"]["logits.weight"]),
                    "(d): _best weights equal _curr's")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return total


# -- phase 8: evaluation ------------------------------------------------------

TEST_ROWS = 2111          # 8 batches of 256 and a ragged tail of 63 rows
OSCR_ROWS = 50_000


def write_test_index(out_dir):
    """The test CSV beside phase 7's val index: every known class ten
    times, 475 negatives (-1) and 476 unknowns (-2)."""
    rng = np.random.default_rng(SEED + 8)
    n_neg = (TEST_ROWS - 10 * N_CLASSES) // 2
    labels = np.concatenate([
        np.repeat(np.arange(N_CLASSES), 10), -np.ones(n_neg, int),
        -2 * np.ones(TEST_ROWS - 10 * N_CLASSES - n_neg, int)])
    rng.shuffle(labels)
    path = out_dir / "p1_test.csv"
    with open(path, "w") as f:
        for i, label in enumerate(labels):
            f.write(f"n{max(label, 0):08d}/test_{i:05d}.JPEG,{label}\n")
    return labels


def device_ms_by_kernel(torch, fn):
    """``{kernel: device ms}`` of one warm call of ``fn`` (torch.profiler),
    largest first.  The window opens with a marker kernel
    (``torch.cuda._sleep``, left out of the names): a window can miss its
    first launch."""
    fn()
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t > 0 and "spin_kernel" not in e.key:
            ms[e.key[:48]] = round(t / 1e3, 4)
    return dict(sorted(ms.items(), key=lambda kv: -kv[1]))


def oscr_checks(torch, card):
    """``calculate_oscr_torch`` on the card against numpy ``calculate_oscr``
    at ``OSCR_ROWS`` x 117 (knowns, -1 and -2; scores rounded through bf16,
    so scores and argmax tie): at every numpy threshold the device ccr and
    fpr within 1e-6, for 0 and 1,000 thresholds.  Returns
    ``{num_thresholds: (device ms, numpy ms)}``."""
    from openset_imagenet_tpu_torch.ops import oscr

    n, c = OSCR_ROWS, N_CLASSES + 1
    rng = np.random.default_rng(SEED + 9)
    gt = rng.integers(-2, c - 1, n)
    scores = torch.from_numpy(rng.dirichlet(np.ones(c) * 0.2, n).astype(
        np.float32)).bfloat16().float()
    host = scores.numpy()
    gt_dev, scores_dev = torch.from_numpy(gt).cuda(), scores.cuda()
    t0 = time.perf_counter()
    ccr_np, fpr_np = oscr.calculate_oscr(gt, host, unk_label=-1)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    kn = gt >= 0
    ref_taus = np.unique(host[kn, gt[kn]])[:-1]
    check(len(ref_taus) > 1000 and len(np.unique(host[kn, gt[kn]]))
          < kn.sum(), "the OSCR input has no ties")
    out = {}
    for k in (0, 1000):
        def run():
            return oscr.calculate_oscr_torch(gt_dev, scores_dev,
                                             unk_label=-1, num_thresholds=k)
        ccr, fpr, taus = (t.cpu().numpy() for t in run())
        check(ccr.shape == fpr.shape == taus.shape == ((k or n),),
              f"OSCR k={k}: shapes {ccr.shape}")
        if k == 0:
            check(np.array_equal(taus[:kn.sum()], np.sort(host[kn, gt[kn]]))
                  and np.isinf(taus[kn.sum():]).all(), "OSCR: threshold set")
        found = np.isin(taus, ref_taus)
        check(found.sum() >= (len(ref_taus) if k == 0 else k - 2),
              f"OSCR k={k}: {found.sum()} thresholds found")
        idx = np.searchsorted(ref_taus, taus[found])
        err = max(np.abs(ccr[found] - ccr_np[idx]).max(),
                  np.abs(fpr[found] - fpr_np[idx]).max())
        check(err <= 1e-6, f"OSCR k={k}: |device - numpy| {err}")
        if k == 0:
            every = np.searchsorted(taus, ref_taus, side="right") - 1
            check(np.array_equal(taus[every], ref_taus) and max(
                np.abs(ccr[every] - ccr_np).max(),
                np.abs(fpr[every] - fpr_np).max()) <= 1e-6,
                "OSCR: a numpy threshold differs on the device")
        ms = time_ms(run, reps=20, warmup=3)
        if k == 0:
            print(f"OSCR device time by kernel (profiler, one call): "
                  f"{device_ms_by_kernel(torch, run)}")
        out[k] = (ms, numpy_ms)
        print(f"OSCR {n} x {c}, {k or 'all'} thresholds: device {ms:.4f} ms "
              f"(CUDA events, median of 20), numpy calculate_oscr "
              f"{numpy_ms:.1f} ms (host clock); max |device - numpy| "
              f"{err:.3g} over {found.sum()} thresholds ({card})")
    return out


def evaluate_phase(torch, fl, fbb, out_dir):
    """Phase 8: ``script.evaluate.main`` in-process on phase 7's run (a)
    entropic ``_curr`` and ``_best`` and run (d)'s softmax and garbage
    ``_curr``, without ``--model-variant``; the archives' checks; the
    first test batch's logits bit-equal to ``make_forward_step`` on a
    model loaded apart; ``plot_all.load_scores(--force)`` (a child
    evaluate per loss, on the card) and ``conf_and_ccr_table``; OSCR on
    the card against numpy.  Returns the launch counts of the phase, and
    the paths of (a)'s ``_best`` and of its val arrays, kept for phase 9."""
    import os
    import shutil

    from openset_imagenet_tpu_torch.dataset import ImagenetDataset
    from openset_imagenet_tpu_torch.inference import OpenSetPredictor
    from openset_imagenet_tpu_torch.pipeline import (SyntheticReader,
                                                     pipeline_from_dataset)
    from openset_imagenet_tpu_torch.script import evaluate, plot_all
    from openset_imagenet_tpu_torch.train import make_forward_step
    from openset_imagenet_tpu_torch.tools import _card

    card = _card.card_line()
    batch = TRAIN_BATCH
    test_labels = write_test_index(out_dir)
    val_rows = len((out_dir / "p1_val.csv").read_text().splitlines())
    exp = out_dir / "eval" / "Protocol_1"
    shutil.rmtree(exp.parent, ignore_errors=True)
    exp.mkdir(parents=True)
    worker = out_dir / "worker"
    for src in ("a/entropic_curr.pth", "a/entropic_best.pth",
                "d_softmax/softmax_curr.pth", "d_garbage/garbage_curr.pth"):
        os.replace(worker / src, exp / pathlib.Path(src).name)
    common = ["--imagenet-directory", str(out_dir / "imagenet"),
              "--protocol-directory", str(out_dir),
              "--reader", "synthetic", "--workers", "8",
              "--image-size", str(IMAGE)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for k in fl.LAUNCHES:
        fl.LAUNCHES[k] = 0
    fbb.LAUNCHES["fused_block_bwd"] = 0
    try:
        for loss, suffix in (("entropic", "_curr"), ("entropic", "_best"),
                             ("softmax", "_curr"), ("garbage", "_curr")):
            written = evaluate.main(
                [loss, "1", "-o", str(exp), "--batch-size", str(batch),
                 "--device", "cuda", *common]
                + (["--use-best"] if suffix == "_best" else []))
            n_out = N_CLASSES + (loss == "garbage")
            for split, rows in (("val", val_rows), ("test", TEST_ROWS)):
                w = written[split]
                arr = np.load(w["path"])
                gt, scores = arr["gt"], arr["scores"]
                check(gt.dtype == np.float32 and gt.shape == (rows,) and
                      arr["logits"].shape == scores.shape == (rows, n_out)
                      and arr["features"].shape == (rows, n_out),
                      f"evaluate {loss}{suffix} {split}: {gt.dtype} "
                      f"{gt.shape} {scores.shape}")
                check((gt == -1).any() and ((gt == -2).any() or
                                            split == "val"),
                      f"evaluate {loss}{suffix} {split}: label surgery")
                check(all(np.isfinite(arr[key]).all() for key in arr.files)
                      and np.abs(scores.sum(1) - 1).max() <= 1e-5,
                      f"evaluate {loss}{suffix} {split}: scores")
                if split == "test":
                    check(np.array_equal(gt, test_labels.astype(np.float32)),
                          f"evaluate {loss}{suffix}: test labels")
            # The first test batch against a model loaded apart.
            pred = OpenSetPredictor(exp / f"{loss}{suffix}.pth",
                                    image_size=IMAGE, device="cuda")
            check(pred.n_classes == n_out, f"{loss}: predictor n_classes")
            pipe = pipeline_from_dataset(
                ImagenetDataset(out_dir / "p1_test.csv",
                                out_dir / "imagenet"), batch,
                is_training=False, seed=42, num_workers=8,
                reader=SyntheticReader(crop=IMAGE, seed=42))
            try:
                first = next(iter(pipe.epoch(0)))
            finally:
                pipe.close()
            logits, _, _ = make_forward_step()(pred.model, first.images)
            archived = np.load(written["test"]["path"])["logits"][:batch]
            check(np.array_equal(logits.cpu().numpy(), archived),
                  f"{loss}{suffix}: the first batch's logits differ from "
                  "make_forward_step on a model loaded apart")
            del pred
        print("evaluate: the first test batch's logits bit-equal to "
              "make_forward_step on a model loaded apart, each file")

        # plot_all: one child evaluate per loss on the card, then the
        # table (no PDF: matplotlib is not on the GPU host).
        before = dict(np.load(exp / "entropic_test_arr_curr.npz"))
        args = plot_all.get_args(
            ["--protocols", "1", "--loss-functions", "entropic", "softmax",
             "garbage", "--labels", "EOS", "S", "BG", "--force",
             "--output-directory", str(exp.parent), "--imagenet-directory",
             str(out_dir / "imagenet"), "--protocol-directory", str(out_dir),
             "--reader", "synthetic", "--device", "cuda", "-g", "0",
             "--table", str(exp.parent / "Results_last.tex")])
        t0 = time.perf_counter()
        scores, epochs = plot_all.load_scores(args)
        child_s = time.perf_counter() - t0
        after = scores[1]["entropic"]["test"]
        check(np.array_equal(after["gt"], test_labels.astype(np.float32)),
              "plot_all: the child's test labels")
        # The child runs at evaluate's default batch 64, so cuDNN may take
        # other algorithms than at batch 256: the bf16 logits round apart
        # by an ulp here and there (scores 1.0e-05 apart on an H100).
        # Another file or forward moves them by orders of magnitude more.
        diff = float(np.abs(after["scores"] - before["scores"]).max())
        logit_diff = float(np.abs(after["logits"] - before["logits"]).max()
                           / np.abs(before["logits"]).max())
        check(diff <= 1e-4, f"plot_all: the child's scores (batch 64) "
              f"differ by {diff} from batch {batch}'s")
        check(logit_diff <= 1e-2, f"plot_all: the child's logits (batch 64) "
              f"differ by {logit_diff} of their largest from batch {batch}'s")
        plot_all.conf_and_ccr_table(args, scores, epochs)
        table = (exp.parent / "Results_last.tex").read_text()
        rows = table.splitlines()
        check(len(rows) == 3 and all(
            row.startswith(f"$P_1$ - {label} & ") and row.endswith("\\\\")
            for row, label in zip(rows, ("EOS", "S", "BG"))),
            f"plot_all table: {table!r}")
        print(f"plot_all: load_scores(--force) ran 3 child evaluates in "
              f"{child_s:.1f} s (host clock; {card}); entropic test scores "
              f"at batch 64 within {diff:.3g} of batch {batch}'s, logits "
              f"within {logit_diff:.3g} of their largest")
        print("plot_all table:\n" + table.rstrip())
        launches = {**fl.LAUNCHES, **fbb.LAUNCHES}
        oscr_checks(torch, card)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # (a)'s entropic _best and its val arrays stay for phase 9.
    kept = out_dir / "serve"
    shutil.rmtree(kept, ignore_errors=True)
    kept.mkdir()
    for name in ("entropic_best.pth", "entropic_val_arr_best.npz"):
        os.replace(exp / name, kept / name)
    shutil.rmtree(worker, ignore_errors=True)
    shutil.rmtree(exp.parent, ignore_errors=True)
    return launches, kept / "entropic_best.pth", \
        kept / "entropic_val_arr_best.npz"


# -- phase 9: prediction paths and the daemon ---------------------------------

PREDICT_PATHS = 600       # two chunks of 256 and a ragged 88
PREDICT_BATCH = 256
SERVE_BATCH = 64
SERVE_IMAGES = 512
CONCURRENCY = (1, 4, 16, 64)


def cold_buckets(ckpt):
    """``python3 chip_smoke.py --cold-buckets CKPT``: in a fresh process, a
    predictor on the card without warm-up; prints one JSON line with the
    first forward of each bucket 1 ... 64 and its warm median, in ms
    (host clock, each call ending in the scores' copy to the host)."""
    import torch

    from openset_imagenet_tpu_torch.inference import OpenSetPredictor

    if not torch.cuda.is_available():
        return 1
    pred = OpenSetPredictor(ckpt, device="cuda")
    out = {}
    b = 1
    while b <= SERVE_BATCH:
        images = np.zeros((b, IMAGE, IMAGE, 3), np.uint8)
        t0 = time.perf_counter()
        pred.predict(images)
        first = (time.perf_counter() - t0) * 1e3
        warm = []
        for _ in range(5):
            t0 = time.perf_counter()
            pred.predict(images)
            warm.append((time.perf_counter() - t0) * 1e3)
        out[b] = [first, statistics.median(warm)]
        b *= 2
    print(json.dumps({"cold_buckets_ms": out}))
    return 0


def bucket_rule(label, got_cls, got_measure, ref_cls, ref_scores):
    """Phase 3's bucket-independence rule against the reference bucket's
    softmax rows: the measure (max softmax) within 5e-2, a class changed
    only at a near-tie of the reference's top two.  Returns the largest
    difference."""
    d = float(np.abs(np.asarray(got_measure) - ref_scores.max(-1)).max())
    check(d <= 5e-2, f"{label}: scores {d} from the reference bucket's")
    top2 = np.sort(ref_scores, -1)[:, -2:]
    for i in np.nonzero(np.asarray(got_cls) != ref_cls)[0]:
        check(top2[i, 1] - top2[i, 0] < 5e-2,
              f"{label}: row {i} changed class away from a near-tie")
    return d


def predict_cli_phase(inference, best, val_arr):
    """Phase 9, item 2: ``script.predict.main`` in-process on 600
    placeholder paths with the synthetic reader, streamed and serial,
    then with ``--threshold-at-fpr``."""
    from openset_imagenet_tpu_torch.pipeline import SyntheticReader
    from openset_imagenet_tpu_torch.script import predict

    root = best.parent / "placeholders"
    root.mkdir(exist_ok=True)
    names = [f"img_{i:05d}.JPEG" for i in range(PREDICT_PATHS)]
    for name in names:
        (root / name).touch()
    listing = best.parent / "listing.txt"
    listing.write_text("".join(f"{n},0\n" for n in names))
    paths = [str(root / n) for n in names]

    def run(tag, *extra):
        out = best.parent / f"{tag}.csv"
        npz = best.parent / f"{tag}.npz"
        rc = predict.main(
            [str(best), "auto", str(listing), "--imagenet-directory",
             str(root), "--reader", "synthetic", "--device", "cuda",
             "--image-size", str(IMAGE),
             "--batch-size", str(PREDICT_BATCH), "--features-output",
             str(npz), "-o", str(out), *extra])
        check(rc == 0, f"predict {tag}: exit code {rc}")
        return out, np.load(npz)

    streamed, s_npz = run("streamed")
    serial, n_npz = run("serial", "--no-stream")
    check(streamed.read_bytes() == serial.read_bytes(),
          "predict: the streamed and serial CSVs differ")
    check(sorted(s_npz.files) == sorted(n_npz.files) ==
          ["features", "paths", "scores"] and all(
              s_npz[k].dtype == n_npz[k].dtype and s_npz[k].shape ==
              n_npz[k].shape and s_npz[k].tobytes() == n_npz[k].tobytes()
              for k in s_npz.files),
          "predict: the streamed and serial archives' arrays differ")
    rows = [r.split(",") for r in streamed.read_text().splitlines()[1:]]
    check([r[0] for r in rows] == paths, "predict: the CSV's paths")
    check(s_npz["scores"].shape == (PREDICT_PATHS, N_CLASSES) and
          np.isfinite(s_npz["scores"]).all(), "predict: the archive")

    # Every row against predict() on the same pixels at the same chunks.
    pred = inference.OpenSetPredictor(best, device="cuda")
    reader = SyntheticReader(crop=IMAGE, seed=0)
    for i in range(0, PREDICT_PATHS, PREDICT_BATCH):
        chunk = paths[i:i + PREDICT_BATCH]
        cls, score, feats, scores = pred.predict(
            np.stack([reader(p, None) for p in chunk]), return_arrays=True)
        check([r[1:] for r in rows[i:i + PREDICT_BATCH]] ==
              [[str(int(c)), f"{float(v):.6f}"] for c, v in zip(cls, score)]
              and np.array_equal(s_npz["scores"][i:i + len(chunk)], scores)
              and np.array_equal(s_npz["features"][i:i + len(chunk)],
                                 feats),
              f"predict: rows {i}... differ from predict() on the same "
              "pixels")
    print(f"predict CLI, resnet50 {IMAGE} px, {PREDICT_PATHS} paths at "
          f"batch {PREDICT_BATCH}, synthetic reader, streamed and serial: "
          "CSVs byte-equal, archives' arrays byte-equal, every row "
          "bit-equal to predict()")

    fpr, f_npz = run("calibrated", "--threshold-at-fpr", "0.1",
                        "--calibrate", str(val_arr))
    threshold = inference.calibrate_threshold(val_arr, 0.1, "softmax",
                                              False)
    crows = [r.split(",") for r in fpr.read_text().splitlines()[1:]]
    rejected = np.array([int(r[1]) == -1 for r in crows])
    measure = f_npz["scores"].max(-1)  # the softmax mode's measure
    check(len(crows) == PREDICT_PATHS and np.array_equal(
        rejected, measure < threshold) and np.array_equal(
        f_npz["scores"], s_npz["scores"]),
        "predict --threshold-at-fpr: a row is -1 iff its score < threshold")
    print(f"predict --threshold-at-fpr 0.1: threshold {threshold:.6g}, "
          f"{sum(rejected)} of {PREDICT_PATHS} rows rejected")
    del pred


def serve_load(server_url, images, clients):
    """Closed-loop clients over keep-alive connections, ``SERVE_IMAGES``
    requests of one raw image in all; returns (seconds, latencies ms,
    {request index: (image index, response)})."""
    import http.client
    import threading
    from urllib.parse import urlsplit

    host, port = urlsplit(server_url).hostname, urlsplit(server_url).port
    lock = threading.Lock()
    counter = iter(range(SERVE_IMAGES))
    latencies, answers, errors = [], {}, []

    def client():
        conn = http.client.HTTPConnection(host, port, timeout=120)
        try:
            while True:
                with lock:
                    k = next(counter, None)
                if k is None:
                    return
                img = k % len(images)
                t0 = time.perf_counter()
                conn.request("POST", "/v1/predict", body=images[img].tobytes(),
                             headers={"Content-Type":
                                      "application/octet-stream"})
                resp = conn.getresponse()
                body = resp.read()
                ms = (time.perf_counter() - t0) * 1e3
                if resp.status != 200:
                    errors.append((resp.status, body[:200]))
                    return
                with lock:
                    latencies.append(ms)
                    answers[k] = (img, json.loads(body))
        except Exception as exc:  # reported by the check below
            errors.append(repr(exc))
        finally:
            conn.close()

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    seconds = time.perf_counter() - t0
    check(not errors and len(answers) == SERVE_IMAGES,
          f"{clients} clients: {len(answers)} answers, errors {errors[:3]}")
    return seconds, latencies, answers


def raw_server(serve):
    """A ``PredictionServer`` whose bodies are S*S*3 raw bytes -> uint8
    [S, S, 3] (the card's host has no JPEG decoder)."""

    class RawServer(serve.PredictionServer):
        def decode(self, blobs):
            size = self.predictor.image_size
            if any(len(b) != size * size * 3 for b in blobs):
                raise ValueError(f"a body is not {size}x{size}x3 raw bytes")
            return [np.frombuffer(b, np.uint8).reshape(size, size, 3)
                    for b in blobs]

    return RawServer


def daemon_phase(inference, serve, best, card):
    """Phase 9, item 3: ``PredictionServer`` in-process with a decode of
    raw pixel bodies (the host has no JPEG decoder)."""
    import base64
    import urllib.error
    import urllib.request

    from openset_imagenet_tpu_torch.native.jpeg import native_available

    RawServer = raw_server(serve)
    print(f"daemon decode: raw {IMAGE}x{IMAGE}x3 uint8 bodies through "
          f"PredictionServer.decode (the card's host has no JPEG decoder; "
          f"native_available() = {native_available()})")
    pred = inference.OpenSetPredictor(best, device="cuda")
    pred.warmup(SERVE_BATCH)
    srv = RawServer(("127.0.0.1", 0), pred, max_batch=SERVE_BATCH,
                    window_ms=2.0).start()
    host, port = srv.server_address[:2]
    url = f"http://{host}:{port}"

    def request(path, body=None, ctype="application/octet-stream"):
        req = urllib.request.Request(url + path, data=body,
                                     method="GET" if body is None
                                     else "POST",
                                     headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    images = np.random.default_rng(SEED + 9).integers(
        0, 256, (SERVE_BATCH, IMAGE, IMAGE, 3), np.uint8)
    try:
        code, info = request("/healthz")
        check(code == 200 and info["status"] == "ok" and
              info["n_classes"] == N_CLASSES and info["image_size"] == IMAGE
              and info["batcher"]["alive"], f"healthz: {code} {info}")
        one = request("/v1/predict", images[0].tobytes())[1]
        batch = request("/v1/predict", json.dumps({"images": [
            base64.b64encode(im.tobytes()).decode() for im in images[:5]]}
        ).encode(), "application/json")[1]["results"]
        cls1, score1 = pred.predict(images[:1])
        cls5, score5 = pred.predict(images[:5])
        check(one["prediction"] == int(cls1[0]) and
              one["score"] == float(score1[0]),
              f"daemon: a single request {one} against predict() "
              f"{cls1[0]} {score1[0]}")
        check([r["prediction"] for r in batch] == [int(c) for c in cls5] and
              [r["score"] for r in batch] == [float(v) for v in score5],
              "daemon: the JSON batch of 5 differs from predict() at "
              "bucket 8")
        code, feats = request("/v1/predict?features=1", images[1].tobytes())
        check(code == 200 and len(feats["features"]) == N_CLASSES and
              all(np.isfinite(feats["features"])), "daemon: ?features=1")
        check(request("/nope")[0] == 404 and
              request("/nope", b"x")[0] == 404, "daemon: 404")
        check(request("/v1/predict", b"not raw pixels")[0] == 400,
              "daemon: 400 on a body of another size")
        limit = serve.MAX_IMAGES_PER_REQUEST
        serve.MAX_IMAGES_PER_REQUEST = 4
        try:
            code, err = request("/v1/predict", json.dumps({"images": [
                base64.b64encode(images[0].tobytes()).decode()] * 5}
            ).encode(), "application/json")
        finally:
            serve.MAX_IMAGES_PER_REQUEST = limit
        check(code == 413 and "limit is 4" in err["error"], "daemon: 413")
        print("daemon: healthz, a single request and a JSON batch of 5 "
              "bit-equal to predict() at their buckets, features, 404, 400 "
              "and 413: ok")

        # Closed-loop load; the answers against predict() at bucket 64.
        ref_cls, _, _, ref_scores = pred.predict(images, return_arrays=True)
        for clients in CONCURRENCY:
            srv.batcher.stats.reset()
            seconds, lat, answers = serve_load(url, images, clients)
            stats = request("/stats")[1]
            idx = [answers[k][0] for k in range(SERVE_IMAGES)]
            got_cls = [answers[k][1]["prediction"] for k in
                       range(SERVE_IMAGES)]
            got = np.array([answers[k][1]["score"] for k in
                            range(SERVE_IMAGES)])
            d = bucket_rule(f"{clients} clients", got_cls,
                            got, ref_cls[idx], ref_scores[idx])
            p50, p99 = np.percentile(lat, [50, 99])
            check(stats["errors"] == 0 and stats["images"] == SERVE_IMAGES,
                  f"{clients} clients: stats {stats}")
            if clients == 16:
                check(stats["mean_batch"] > 1, f"16 clients did not "
                      f"coalesce: mean_batch {stats['mean_batch']}")
            print(f"daemon, {clients} closed-loop clients, {SERVE_IMAGES} "
                  f"raw {IMAGE} px images: {SERVE_IMAGES / seconds:.1f} "
                  f"imgs/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms, mean_batch "
                  f"{stats['mean_batch']:.2f}, max_batch "
                  f"{stats['max_batch']}, max |d score| vs bucket 64 "
                  f"{d:.3g} (host clock; {card})")

        # A dead batcher thread: healthz non-200 within a second, and
        # requests fail at once.
        def poisoned(batch):
            raise RuntimeError("poisoned _gather")

        srv.batcher._gather = poisoned
        t0 = time.perf_counter()
        code, err = request("/v1/predict", images[0].tobytes())
        first_s = time.perf_counter() - t0
        check(code == 503 and "poisoned" in err["error"] and first_s < 1.0,
              f"daemon: the request in hand at the death: {code} {err} "
              f"after {first_s:.3f} s")
        deadline = time.perf_counter() + 1.0
        while True:
            code, info = request("/healthz")
            if code != 200 or time.perf_counter() > deadline:
                break
        probe_s = time.perf_counter() - t0
        check(code == 503 and info["status"] == "dead",
              f"daemon: healthz {code} {info} {probe_s:.3f} s after the "
              "death")
        t1 = time.perf_counter()
        code, _ = request("/v1/predict", images[1].tobytes())
        after_s = time.perf_counter() - t1
        check(code == 503 and after_s < 1.0,
              f"daemon: a request after the death: {code} in {after_s} s")
        print(f"daemon, poisoned _gather: the request in hand failed in "
              f"{first_s * 1e3:.1f} ms, healthz 503 dead within "
              f"{probe_s * 1e3:.1f} ms, the next request 503 in "
              f"{after_s * 1e3:.1f} ms (host clock; {card})")
    finally:
        t0 = time.perf_counter()
        srv.close()
    print(f"daemon: close() returned in {time.perf_counter() - t0:.3f} s "
          f"(host clock; {card})")
    del pred


def serve_cli_phase(best, card):
    """Phase 9, item 4: ``script.serve`` as a process: ready (warm-up
    included), healthz 200, stats, SIGTERM -> exit 0 within 60 s."""
    import re
    import signal
    import urllib.request

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "openset_imagenet_tpu_torch.script.serve",
         str(best), "auto", "--port", "0", "--max-batch", str(SERVE_BATCH)],
        cwd=REPO, stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        url = None
        for line in proc.stderr:
            lines.append(line)
            m = re.search(r"http://([\d.]+):(\d+)", line)
            if m:
                url = f"http://{m.group(1)}:{m.group(2)}"
                break
        check(url is not None, "serve CLI: no http:// line:\n"
              + "".join(lines)[-3000:])
        ready = time.perf_counter() - t0
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            info = json.loads(r.read())
            check(r.status == 200 and info["status"] == "ok" and
                  info["n_classes"] == N_CLASSES, f"serve CLI: {info}")
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
            check(r.status == 200 and stats["requests"] == 0,
                  f"serve CLI stats: {stats}")
    finally:
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        stop_s = time.perf_counter() - t1
        proc.stderr.close()
    check(proc.returncode == 0, f"serve CLI: exit code {proc.returncode}")
    print(f"serve CLI: ready in {ready:.1f} s (process start, model load, "
          f"warm-up to {SERVE_BATCH}), SIGTERM -> exit 0 in {stop_s:.2f} s "
          f"(host clock; {card})")


def serving_phase(torch, best, val_arr):
    """Phase 9: the prediction paths and the daemon on the card."""
    from openset_imagenet_tpu_torch import inference, serve
    from openset_imagenet_tpu_torch.ops import oscr
    from openset_imagenet_tpu_torch.tools import _card

    card = _card.card_line()
    arr = np.load(val_arr)
    unk = arr["gt"] < 0
    for mode in ("softmax", "objectosphere"):
        measure = arr["scores"].max(-1)
        if mode == "objectosphere":
            measure = measure * np.linalg.norm(arr["features"], axis=-1)
        want = oscr.threshold_at_fpr(measure[unk], 0.1)
        got = inference.calibrate_threshold(val_arr, 0.1, mode, False)
        check(got == want, f"calibrate_threshold {mode}: {got} vs {want}")
        print(f"calibrate_threshold {mode} at FPR 0.1 over {unk.sum()} "
              f"unknowns: {got:.6g}, equal to threshold_at_fpr")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        predict_cli_phase(inference, best, val_arr)
        daemon_phase(inference, serve, best, card)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                          "--cold-buckets", str(best)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cold buckets: {out.stderr[-3000:]}")
    cold = json.loads(out.stdout.strip().splitlines()[-1])["cold_buckets_ms"]
    print("first forward of each cold bucket / warm median, ms, predict() "
          "of zeros in a fresh process (host clock; " + card + "): "
          + ", ".join(f"{b}: {v[0]:.1f} / {v[1]:.2f}"
                      for b, v in cold.items()))
    serve_cli_phase(best, card)


# -- phase 10: inference optimization ----------------------------------------

I8_CONVS = 52             # QuantConvs in one resnet50 forward
# fold_bn's largest |softmax - unoptimized softmax| on phase 9's paths: the
# H100 readings were 6.2e-6 and 7.8e-6 (PERF.md §6, PR 12); a wrong fold
# scale or bias moves the scores by far more.
FOLD_DRIFT = 1e-4
# The model of fold_bn's class agreement: (a)'s _best trained on, on the
# distinct images of phase 9's paths, each its own class, until every
# eval-mode logit beats the next by SEPARATED_MARGIN (fold_bn moved phase
# 7's logits by ~6e-4: 5e-6 of a softmax near 1/116), in at most
# SEPARATED_STEPS full-batch Adam steps.
SEPARATED_MARGIN = 2.0
SEPARATED_STEPS = 300
OPT_MODES = {"none": {}, "fold_bn": {"optimize": "fold_bn"},
             "int8": {"optimize": "int8"},
             "int8_p99.9": {"optimize": "int8",
                            "calibration_percentile": 99.9}}


def agree_with_tie_slack(c0, s0, c1, s1, flips):
    """The JAX tests' rule (tests/test_optimize.py:134-144): at most
    ``flips`` class flips, each at a near-tie (its score within 0.05),
    and the scores within rtol 0.1, atol 0.05."""
    flipped = np.nonzero(np.asarray(c0) != np.asarray(c1))[0]
    check(len(flipped) <= flips, f"{len(flipped)} flips, at most {flips}")
    for i in flipped:
        check(abs(float(s0[i]) - float(s1[i])) < 0.05,
              f"row {i} flipped away from a near-tie: {s0[i]} {s1[i]}")
    check(np.allclose(s1, s0, rtol=0.1, atol=0.05), "scores drifted")


def int8_forward_is_plain(torch, ic, pred, images, got, mode):
    """The int8 predictor's forward on ``images`` gives the bits ``got`` of
    the same forward with every ``QuantConv`` through the plain version
    (whose calls launch nothing)."""
    from openset_imagenet_tpu_torch.models import quant

    quant.int8_conv = ic.int8_conv_plain
    try:
        want = pred._forward(pred.model, images)
    finally:
        quant.int8_conv = ic.int8_conv
    for a, b in zip(got, want):
        check(torch.equal(a, b), f"{mode}: the batch-{images.shape[0]} "
              "forward differs from its plain-conv twin: max |d| "
              f"{(a.float() - b.float()).abs().max().item()}")
    print(f"  {mode}: the batch-{images.shape[0]} forward is bit-equal to "
          "the same model with every QuantConv through int8_conv_plain")


def separated_checkpoint(torch, inference, best, paths, reader):
    """``best`` trained on until each distinct image among ``paths`` is a
    class of its own by an eval-mode logit margin of
    ``SEPARATED_MARGIN``; written beside ``best``.  Phase 7's runs learn
    labels that their images do not determine, so (a)'s answers are one
    near-uniform row for every image: most rows' top-2 logits lie a
    bfloat16 step apart, and its class agreement counts ties, not the
    fold."""
    import hashlib

    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.checkpoint import (read_metadata,
                                                       save_checkpoint)

    distinct = {}
    for p in paths:
        img = reader(p, None)
        distinct.setdefault(hashlib.sha1(img.tobytes()).digest(), img)
    images = engine._to_float(torch.from_numpy(
        np.stack(list(distinct.values()))).cuda())
    labels = torch.arange(len(distinct), device="cuda")
    model = inference.OpenSetPredictor(best, device="cuda",
                                       reader=reader).model
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    t0 = time.perf_counter()
    for step in range(1, SEPARATED_STEPS + 1):
        model.train()
        logits, _ = model(images)
        loss = torch.nn.functional.cross_entropy(logits, labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if step % 10:
            continue
        model.eval()
        with torch.no_grad():
            top = model(images)[0].topk(2, dim=-1)
        margin = float((top.values[:, 0] - top.values[:, 1]).min())
        hits = int((top.indices[:, 0] == labels).sum())
        if hits == len(distinct) and margin >= SEPARATED_MARGIN:
            break
    check(hits == len(distinct) and margin >= SEPARATED_MARGIN,
          f"separated model: {hits} of {len(distinct)} images their class, "
          f"least margin {margin} after {step} steps")
    path = best.parent / "separated.pth"
    save_checkpoint(path, model, epoch=0, best_score=0.0,
                    extra=read_metadata(best)["extra"])
    print(f"  separated model: (a)'s _best trained {step} full-batch steps "
          f"on the {len(distinct)} distinct images, each its own class: "
          f"least eval-mode top-2 logit margin {margin:.3f}, loss "
          f"{float(loss):.4f} ({time.perf_counter() - t0:.1f} s)")
    del model, opt
    torch.cuda.empty_cache()
    return path


def predict_paths(pred, paths):
    """Classes and softmax rows of ``paths``, in chunks of
    ``PREDICT_BATCH``."""
    cls, scores = [], []
    for i in range(0, len(paths), PREDICT_BATCH):
        c, _, _, sc = pred.predict(paths[i:i + PREDICT_BATCH],
                                   return_arrays=True)
        cls.append(c)
        scores.append(sc)
    return np.concatenate(cls), np.concatenate(scores)


def top2_margins(scores):
    top2 = np.sort(scores, -1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def optimize_phase(torch, inference, serve, ic, best, card):
    """Phase 10, items 2-4: the full-width resnet50 predictor in four modes
    on phase 9's 600 paths, the predict CLI with ``--optimize``, and the
    daemon on a ``fold_bn`` predictor."""
    from openset_imagenet_tpu_torch.pipeline import SyntheticReader
    from openset_imagenet_tpu_torch.script import predict

    root = best.parent / "placeholders"
    paths = [str(root / f"img_{i:05d}.JPEG") for i in range(PREDICT_PATHS)]
    reader = SyntheticReader(crop=IMAGE, seed=0)
    timed = {b: torch.from_numpy(np.random.default_rng(b).integers(
        0, 256, (b, IMAGE, IMAGE, 3), np.uint8)).cuda() for b in (64, 256)}
    results, preds = {}, {}
    for mode, kw in OPT_MODES.items():
        if kw.get("optimize") == "int8":
            kw = {**kw, "calibration": paths[:256]}  # as the CLI's
        t0 = time.perf_counter()
        pred = inference.OpenSetPredictor(best, device="cuda",
                                          reader=reader, **kw)
        build_s = time.perf_counter() - t0
        before = ic.LAUNCHES["int8_conv"]
        got = pred._forward(pred.model, timed[64])
        torch.cuda.synchronize()
        per_forward = ic.LAUNCHES["int8_conv"] - before
        check(per_forward == (I8_CONVS if mode.startswith("int8") else 0),
              f"{mode}: {per_forward} int8_conv launches a forward")
        if per_forward:
            int8_forward_is_plain(torch, ic, pred, timed[64], got, mode)
        fwd = {b: time_ms(lambda: pred._forward(pred.model, timed[b]),
                          reps=20) for b in (64, 256)}
        cls, scores = predict_paths(pred, paths)
        check(not pred._decoded_cache, f"{mode}: calibration pixels left "
              "in the cache after the pass over their paths")
        if mode == "none":
            # The same paths with the batch-norm written out: the eval
            # kernel is bit-equal to it, so every later comparison holds
            # the optimized graphs to the written-out model's answers.
            written_out_norms(pred.model)
            c2, s2 = predict_paths(pred, paths)
            check(np.array_equal(cls, c2) and np.array_equal(scores, s2),
                  "unoptimized: the batch-norm kernels' answers differ "
                  "from the written-out batch-norm's")
            print("  none: classes and scores bit-equal with the batch-norm "
                  f"written out over the {PREDICT_PATHS} paths")
        results[mode] = (cls, scores, fwd, build_s, per_forward)
        preds[mode] = pred if mode in ("fold_bn", "int8") else None
        del pred
    c0, s0 = results["none"][:2]
    print(f"optimized serving, resnet50 {IMAGE} px bf16, phase 7 (a)'s "
          f"_best, {PREDICT_PATHS} synthetic paths ({card}):")
    for mode, (c1, s1, fwd, build_s, per_forward) in results.items():
        agree = float(np.mean(c1 == c0))
        drift = float(np.abs(s1 - s0).max())
        if mode == "fold_bn":
            margin = top2_margins(s0)
            flipped = np.nonzero(c1 != c0)[0]
            print(f"  fold_bn: {len(flipped)} classes flipped, their "
                  f"unoptimized top-2 margins {margin[flipped].tolist()}; "
                  f"{int((margin <= drift).sum())} of {len(margin)} rows have "
                  f"a margin under the softmax drift {drift:.3e}; top score "
                  f"median {float(np.median(s0.max(-1))):.4f}")
            # On this near-uniform model the fold is held by its softmax
            # drift, and a class may flip only where that drift can cross
            # the top two scores; the flip count is held on the separated
            # model below.
            check(drift <= FOLD_DRIFT, f"fold_bn: softmax drift {drift} "
                  f"over {FOLD_DRIFT}")
            check((margin[flipped] <= 2 * drift).all(),
                  f"fold_bn: a class flipped at a top-2 margin over twice "
                  f"the softmax drift {drift}: {margin[flipped].tolist()}")
        check(np.isfinite(s1).all(), f"{mode}: non-finite scores")
        print(f"  {mode}: forward (device-resident uint8, CUDA events) "
              f"{fwd[64]:.3f} ms at batch 64 = {64 / fwd[64] * 1e3:.1f} "
              f"imgs/s, {fwd[256]:.3f} ms at 256 = "
              f"{256 / fwd[256] * 1e3:.1f} imgs/s; class agreement with "
              f"the unoptimized predictor {agree:.4f} "
              f"({int((c1 != c0).sum())} of {PREDICT_PATHS} differ), max "
              f"softmax drift {drift:.3e}; int8_conv launches a forward "
              f"{per_forward}; construction {build_s:.2f} s (host clock)")

    # fold_bn's class agreement, on a model whose answers depend on the
    # image: the JAX tests' rule, at most one flip, at a near-tie.
    separated = separated_checkpoint(torch, inference, best, paths, reader)
    (c0, s0), (c1, s1) = (predict_paths(inference.OpenSetPredictor(
        separated, device="cuda", reader=reader, **OPT_MODES[mode]), paths)
        for mode in ("none", "fold_bn"))
    margin = top2_margins(s0)
    print(f"  fold_bn on the separated model: class agreement "
          f"{float(np.mean(c1 == c0)):.4f} ({int((c1 != c0).sum())} of "
          f"{PREDICT_PATHS} differ), max softmax drift "
          f"{float(np.abs(s1 - s0).max()):.3e}, least unoptimized top-2 "
          f"softmax margin {float(margin.min()):.4f}, top score median "
          f"{float(np.median(s0.max(-1))):.4f}")
    agree_with_tie_slack(c0, s0.max(-1), c1, s1.max(-1), flips=1)

    # The predict CLI: every row equals the same mode's predictor.
    listing = best.parent / "listing.txt"
    for mode in ("fold_bn", "int8"):
        out = best.parent / f"optimize_{mode}.csv"
        t0 = time.perf_counter()
        rc = predict.main(
            [str(best), "auto", str(listing), "--imagenet-directory",
             str(root), "--reader", "synthetic", "--device", "cuda",
             "--image-size", str(IMAGE), "--batch-size", str(PREDICT_BATCH),
             "-o", str(out), "--optimize", mode])
        seconds = time.perf_counter() - t0
        check(rc == 0, f"predict --optimize {mode}: exit code {rc}")
        rows = [r.split(",") for r in out.read_text().splitlines()[1:]]
        c1 = results[mode][0]
        check([r[0] for r in rows] == paths and [int(r[1]) for r in rows]
              == [int(c) for c in c1],
              f"predict --optimize {mode}: rows differ from the predictor")
        print(f"predict --optimize {mode}"
              + (" (self-calibrated on the first 256 inputs)"
                 if mode == "int8" else "")
              + f": {PREDICT_PATHS} rows equal to the {mode} predictor's "
              f"classes, {PREDICT_PATHS / seconds:.1f} imgs/s with the model "
              f"load{' and calibration' if mode == 'int8' else ''} (host "
              f"clock; {card})")

    # The daemon on the fold_bn predictor, 16 closed-loop clients.
    pred = preds["fold_bn"]
    pred.warmup(SERVE_BATCH)
    srv = raw_server(serve)(("127.0.0.1", 0), pred, max_batch=SERVE_BATCH,
                            window_ms=2.0).start()
    try:
        host, port = srv.server_address[:2]
        images = np.random.default_rng(SEED + 10).integers(
            0, 256, (SERVE_BATCH, IMAGE, IMAGE, 3), np.uint8)
        ref_cls, _, _, ref_scores = pred.predict(images, return_arrays=True)
        seconds, lat, answers = serve_load(f"http://{host}:{port}", images,
                                           16)
        idx = [answers[k][0] for k in range(SERVE_IMAGES)]
        d = bucket_rule("fold_bn daemon", [answers[k][1]["prediction"]
                                           for k in range(SERVE_IMAGES)],
                        np.array([answers[k][1]["score"]
                                  for k in range(SERVE_IMAGES)]),
                        ref_cls[idx], ref_scores[idx])
        p50, p99 = np.percentile(lat, [50, 99])
        print(f"daemon on the fold_bn predictor, 16 closed-loop clients, "
              f"{SERVE_IMAGES} raw images: {SERVE_IMAGES / seconds:.1f} "
              f"imgs/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms, max |d score| "
              f"vs bucket 64 {d:.3g} (host clock; {card})")
    finally:
        srv.close()


# -- phase 11: the Swin through the worker ------------------------------------

def swin_phase(torch, fl, out_dir):
    """Phase 11: four swin_b train steps through ``worker(cfg)``, the
    attention kernels' launches and names, the checkpoint rebuilt as a
    Swin by the predictor."""
    import shutil

    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.checkpoint import read_metadata
    from openset_imagenet_tpu_torch.inference import OpenSetPredictor
    from openset_imagenet_tpu_torch.models import swin
    from openset_imagenet_tpu_torch.ops import layer_norm as lnk
    from openset_imagenet_tpu_torch.ops import window_attention as wak

    write_index(out_dir)
    write_val_index(out_dir)
    shutil.rmtree(out_dir / "worker" / "swin", ignore_errors=True)
    arch = {"arch": "swin", "variant": "swin_b"}
    cfg = worker_cfg(out_dir, "swin", batch=BATCH, epochs=1, model=arch,
                     max_steps=4)
    for counts in (fl.LAUNCHES, wak.LAUNCHES, lnk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    info = engine.worker(cfg)
    seconds = time.perf_counter() - t0
    launches = dict(wak.LAUNCHES)
    ln_launches = dict(lnk.LAUNCHES)
    print(f"swin worker: info {info}, {seconds:.2f} s (host clock, with "
          f"set-up), peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"at batch {BATCH}, launches {dict(fl.LAUNCHES)}, window "
          f"attention {launches}, LayerNorm {ln_launches}")
    check(info["stopped_mid_epoch"] == 4, f"swin: {info}")
    # One forward and one backward a block of Swin-B's 24, a step.
    check(launches == {"win_attn_fwd": 4 * 24, "win_attn_bwd": 4 * 24},
          f"swin: window-attention launches {launches}")
    # Swin-B's 53 LayerNorms a step: 8 alone, 45 fused with their junction.
    check(ln_launches == {"ln_fwd": 4 * 8, "ln_add_fwd": 4 * 45,
                          "ln_bwd": 4 * 8, "ln_add_bwd": 4 * 45},
          f"swin: LayerNorm launches {ln_launches}")
    check(fl.LAUNCHES["entropic_fwd"] == 4 and fl.LAUNCHES["entropic_bwd"]
          == 4, f"swin: K1/K2 not on every step: {dict(fl.LAUNCHES)}")
    curr = cfg.output_directory / "entropic_curr.pth"
    check(read_metadata(curr)["extra"]["arch"] == arch,
          f"swin: arch {read_metadata(curr)['extra']}")
    predictor = OpenSetPredictor(curr, device="cuda")
    check(isinstance(predictor.model, swin.Swin), "swin: not rebuilt")
    images = np.random.default_rng(SEED + 11).integers(
        0, 256, (BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)
    classes, scores = predictor.predict(images)
    check(np.isfinite(scores).all() and len(classes) == BATCH,
          "swin: predictor scores")
    # The attention kernels of one traced forward and backward.
    model = predictor.model.train()
    x = torch.from_numpy(images).cuda().float() / 255.0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        model(x)[0].float().sum().backward()
        torch.cuda.synchronize()
    kernels = {e.name for e in prof.events()}
    names = sorted({k[:120] for k in kernels if any(
        f in k.lower() for f in ("fmha", "flash", "attention", "sdpa"))})
    print(f"swin attention kernels: {names}")
    check(names == ["osi_win_flash_bwd", "osi_win_flash_fwd"],
          f"swin: attention kernels {names}")
    names = sorted({k[:120] for k in kernels if any(
        f in k.lower() for f in ("layer_norm", "layernorm", "gammabeta"))})
    print(f"swin LayerNorm kernels: {names}")
    check(names == ["osi_layer_norm_bwd", "osi_layer_norm_fwd"],
          f"swin: LayerNorm kernels {names}")
    check(not any("roll_cuda_kernel" in k for k in kernels),
          "swin: torch.roll's kernel ran")
    del predictor, model
    torch.cuda.empty_cache()
    return launches, ln_launches


def main():
    import concurrent.futures

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--cold-buckets"]:
        return cold_buckets(sys.argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from openset_imagenet_tpu_torch.experimental import split_site as ss
    from openset_imagenet_tpu_torch.ops import _build
    from openset_imagenet_tpu_torch.ops import batch_norm as bnk
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb
    from openset_imagenet_tpu_torch.ops import fused_loss as fl
    from openset_imagenet_tpu_torch.ops import int8_conv as ic
    from openset_imagenet_tpu_torch.ops import stream_probe as sp
    from openset_imagenet_tpu_torch.tools import _card

    out_dir = REPO / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    print(_card.card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    # nvcc builds K5, K6 and int8_conv side by side; the tools' processes
    # and the later phases then find them built (the build is keyed by
    # the source).
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for build in [pool.submit(_build.build, m.SOURCE, name)
                      for m, name in ((fbb, "fused_block_bwd"),
                                      (ss, "split_site"),
                                      (ic, "int8_conv"))]:
            build.result()
    fbb._library()
    ss._library()
    ic._library()
    print(f"K5, K6 and int8_conv built by nvcc, in parallel, in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    checked = kernel_table(torch)
    print(f"phase kernels: ok ({time.perf_counter() - t0:.1f} s incl. "
          "Triton builds)")
    t0 = time.perf_counter()
    tool_launches = tool_runs()
    print(f"launches on the tools' path: {tool_launches}")
    print(f"phase tools: ok ({time.perf_counter() - t0:.1f} s)")

    for counts in (fl.LAUNCHES, bnk.LAUNCHES):
        for k in counts:
            counts[k] = 0
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
    check(bnk.LAUNCHES["bn_apply"] > 0 and not bnk.LAUNCHES["bn_stats"],
          f"serving and validation: batch-norm launches {bnk.LAUNCHES}")
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
    bn_launches = dict(bnk.LAUNCHES)
    print(f"batch-norm launches on the serve, validate and train paths: "
          f"{bn_launches}")
    check(all(bn_launches.values()), f"a batch-norm kernel was not "
          f"launched on the train path: {bn_launches}")
    print(f"phase train: ok ({time.perf_counter() - t0:.1f} s)")
    del ghost
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    run, twin, fused_launches = train_fused(torch, fl, fbb,
                                            out_dir / "p1_train.csv")
    fused_checks(torch, run, twin, GHOST)
    print(f"phase fused train: ok ({time.perf_counter() - t0:.1f} s)")
    del run, twin
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    worker_launches = worker_phase(torch, fl, fbb, out_dir)
    print(f"launches on the worker path: {worker_launches}")
    print(f"phase worker: ok ({time.perf_counter() - t0:.1f} s)")

    # Phase 8 runs no kernel of the port: the forward and the softmax.
    t0 = time.perf_counter()
    eval_launches, best, val_arr = evaluate_phase(torch, fl, fbb, out_dir)
    print(f"launches on the evaluate path: {eval_launches}")
    print(f"phase evaluate: ok ({time.perf_counter() - t0:.1f} s)")

    # Phase 9 runs no kernel of the port either.
    for counts in (fl.LAUNCHES, fbb.LAUNCHES, ss.LAUNCHES, sp.LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    serving_phase(torch, best, val_arr)
    serve_launches = {**fl.LAUNCHES, **fbb.LAUNCHES, **ss.LAUNCHES,
                      **sp.LAUNCHES}
    print(f"launches on the prediction and daemon path: {serve_launches}")
    print(f"phase predict and serve: ok ({time.perf_counter() - t0:.1f} s)")

    # Phase 10, the optimized serving path: int8_conv in every int8
    # forward, no other kernel of the port.
    from openset_imagenet_tpu_torch import inference, serve as serve_mod

    all_counts = (fl.LAUNCHES, fbb.LAUNCHES, ss.LAUNCHES, sp.LAUNCHES,
                  ic.LAUNCHES)
    for counts in all_counts:
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        optimize_phase(torch, inference, serve_mod, ic, best,
                       _card.card_line())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    opt_launches = {k: v for counts in all_counts for k, v in counts.items()}
    print(f"launches on the optimized serving path: {opt_launches}")
    check(opt_launches["int8_conv"] > 0 and not any(
        v for k, v in opt_launches.items() if k != "int8_conv"),
        f"the optimized serving path's launches: {opt_launches}")
    print(f"phase optimize: ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    swin_launches, ln_launches = swin_phase(torch, fl, out_dir)
    print(f"phase swin: ok ({time.perf_counter() - t0:.1f} s)")

    # Each kernel's source, what it replaces, and its launches on its path.
    pkg = "openset_imagenet_tpu_torch"
    loss_launches = {k: launches[k] + train_launches[k] + fused_launches[k]
                     + worker_launches[k] for k in fl.LAUNCHES}
    bn = ("triton", f"{pkg}/ops/triton_batch_norm.py",
          f"none: the written-out batch-norm of {pkg}/models/norm.py")
    rows = [
        *((name, "triton", f"{pkg}/ops/triton_fused_loss.py",
           f"openset_imagenet_tpu/ops/fused_loss.py:{line}",
           loss_launches[name])
          for name, line in (("entropic_fwd", 39), ("entropic_bwd", 69),
                             ("ce_fwd", 172), ("ce_bwd", 191))),
        ("fused_block_bwd", "cuda", f"{pkg}/csrc/fused_block_bwd.cu",
         "openset_imagenet_tpu/experimental/fused_block.py:111",
         fused_launches["fused_block_bwd"]
         + worker_launches["fused_block_bwd"]),
        ("split_site", "cuda", f"{pkg}/csrc/split_site.cu",
         "openset_imagenet_tpu/experimental/split_site.py:73",
         tool_launches["split_site"]),
        *((name, "triton", f"{pkg}/ops/triton_stream_probe.py",
           f"tools/bench_pallas_stream.py:{line}", tool_launches[name])
          for name, line in (("stream_axpy", 69), ("stream_relu_mask", 96))),
        ("int8_conv", "cuda", f"{pkg}/csrc/int8_conv.cu",
         "openset_imagenet_tpu/models/quant.py:86",
         opt_launches["int8_conv"]),
        ("bn_stats", *bn, bn_launches["bn_stats"]),
        ("bn_apply", *bn, bn_launches["bn_apply"]),
        ("bn_backward", *bn, bn_launches["bn_bwd"]),
        ("window_attention", "triton",
         f"{pkg}/ops/triton_window_attention.py",
         "none: F.scaled_dot_product_attention and the roll, partition, "
         "mask and merge copies of the Swin's written-out window attention",
         sum(swin_launches.values())),
        ("layer_norm", "triton", f"{pkg}/ops/triton_layer_norm.py",
         "none: torch's LayerNorm kernels, the bias and residual adds and "
         "the gradient sums of the Swin's written-out residual junctions",
         sum(ln_launches.values())),
    ]
    kernels = [dict(zip(("name", "route", "source", "replaces",
                         "launches"), row)) for row in rows]
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was not launched on its path: {kernels}")
    check(checked == {k["name"] for k in kernels},
          f"phase 2 checked {sorted(checked)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
