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
   K1 (``entropic_fwd``) and K3 (``ce_fwd``) are one kernel launch per
   call (profiler), bit-equal over 50 launches and over a CUDA-graph
   replay of 20 calls at [64, C], [256, C], [1000, 1000] and [4099, 3];
   K3 is timed beside ``F.cross_entropy`` and in its two other grids (one
   program, or 2048-element tiles and a ticket); K1's mean has the bits
   of ``sum / count.clamp(min=1)`` and K3's those of ``sum /
   wsum.clamp(min=1e-12)``; K2 given ``(g, count)`` has the bits of K2
   given torch's ``g / count.clamp(min=1)``, and K4 given ``(g, wsum)``
   those of K4 given ``g / wsum.clamp(min=1e-12)``; K2 and K4 are timed
   in both of their grids (two-row programs of one warp, 2048-element
   tiles of four); the public entropic loss launches K1 and K2 and
   nothing else for a forward and a backward, and K1 alone for an eval
   forward; the softmax and garbage losses launch their row weights'
   elementwise kernels, then K3 and K4 and nothing else (K3 alone in
   eval), with the time of forward + backward and of K3 + K4 alone;
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
   and with ``fused=False`` and the peak device memory;
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
   1,000.  Prints each split's extraction rate (imgs/s, host clock) and
   the OSCR device ms beside numpy's, each with the card's name and power
   limit.  The phase launches no kernel of the port (a forward and a
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
   measure is below the threshold; ``predict_stream`` and serial
   ``predict()`` with pinned and pageable host staging, in turns.  Then
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
   attention path's ``COUNTS`` (24 calls a forward, 234 windows an
   image), the window-attention kernels' ``LAUNCHES`` (one forward and
   one backward a block: 96 each), the attention kernels that ran in one
   traced step (profiler names: ``osi_win_flash_fwd`` and
   ``osi_win_flash_bwd`` alone, and no roll kernel), the ``_curr``
   checkpoint's ``extra.arch``, and ``OpenSetPredictor`` rebuilding a
   Swin from it on the card (finite scores on 64 images).

Phase 2b holds K5 (``ops/fused_block_bwd.py``, CUDA C++ built by ``nvcc``
at first use) against its plain version at every distinct resnet50 site
shape at batch 256 (tails: int8 mask, input activation, gp out; heads
with and without the skip gradient; the fused route at M = 802,816, the
tiled one below), at a ragged M and ragged channels, in bf16 (and f32 at
stage 4 and the ragged shapes): gp exact, dW and the channel sums within
1e-4 relative in norm, dx within rtol 2e-2, atol 1e-2 (bf16) or 1e-5
(f32), the same bits on a second launch.  It prints each resnet50 site's
route, device time, bytes and operations bound and share of that bound,
and the plain version's time at the stage-1 tail and head and the
stage-4 tail.  K5 and K6 are built by two ``nvcc`` processes at once,
while phase 2 builds the Triton kernels and holds them against their
plain versions; phase 2's launch counts (profiler) come after the builds.
``int8_conv`` (``ops/int8_conv.py``, CUDA C++) is built by a third
``nvcc`` beside them.

Phase 2c holds K6, the split tail site (``experimental/split_site.py``,
CUDA C++), against its plain version at every resnet50 tail-site shape
(stages 1-4 at batch 256), a ragged M and ragged channel counts, in bf16
(and f32 at stage 4 and the ragged shapes): the same bits on a second
launch, gp exact, dW and the four channel sums within 1e-4 relative in
norm (the input-side sums add dxa after its rounding to bf16; each
side's distance to a float64 product is printed), dx within rtol 2e-2,
atol 1e-2 (bf16) or 1e-5 (f32); against K5 on the same inputs, gp exact
and the rest within 8e-2 (bf16) or 1e-5 (f32), dx elementwise and the
others in norm.  Times at the stage-1 and stage-4 tails, K5's beside.
Phase 2d holds K7, the Triton streaming probes (``ops/stream_probe.py``),
bit for bit against their plain versions and against the library call
that computes the same function (``torch.add(x, b)`` for axpy, whose
bf16 multiply by 1.0009765625 is the identity; ``threshold_backward(g,
m, 0)`` for relu_mask off the NaNs of a mask strewn with NaN, +-0, +-inf
and subnormals, the kernel giving 0 on those NaNs as JAX does) at bf16
[8, 3136, 256], a ragged row count, 4097 elements and a view at storage
offset 1; it prints each kernel's launch configuration, and times kernel
and library call in turns in the bench tool's cold harness (an operand
pair and an output for each call of the graph, the L2 flushed first,
so that no byte comes from the L2), and in the earlier four-pair harness
beside it.  Phase 2e
runs the two ported bench tools as the entry points they are, each in its own
process with few iterations (``python -m openset_imagenet_tpu_torch.
tools.bench_split_site --iters 2``, ``...bench_stream --iters 3``), and
checks their JSON lines: the cases, finite numbers, the card, K6's four
kernels in the split case's profile, and that their kernel cases
launched K5, K6 and K7 (each tool reports the launches of its cases; a
fresh process starts from zero counts).  Phase 2f holds ``int8_conv``
bit for bit against its plain version (a float64 ``F.conv2d`` of the
int8 values, then the epilogue as eager ops) at every resnet50 QuantConv
shape at batch 4, at ragged shapes, at the grouped convs of
resnext50_32x4d (the SIMT route) and on extreme operands (+-127
everywhere, zero channels), in bf16 and float32 out; ``torch._int_mm``
over an explicit im2col gives the plain version's int32 sums at every
resnet50 shape; it prints what ``F.conv2d`` does with int8 CUDA tensors,
and at batch 256 each resnet50 shape's device µs (CUDA-graph replays)
beside its bound, ``torch._int_mm`` alone and with the im2col, and
cuDNN's bf16 conv at the same shape, and the sums over one forward's 52
convs.  Phase 2g holds the batch-norm kernels (``ops/batch_norm.py``,
Triton) at each of the 53 resnet50 batch-norm shapes at batch 256 (bf16,
channels-last, a statistics window of 64 images): the apply bit-equal to
its plain version in the ghost form (given the plain statistics) and in
the eval form (given running statistics), the statistics within rtol
1e-5, the backward's dx bit-equal outside the window and within 1e-3 in
norm inside it, dweight and dbias within 1e-5, every launch twice with
the same bits; then, cold (the L2 flushed before each call) and in turns,
each kernel beside its bytes bound, its plain version and the library
call computing the same function (``torch.batch_norm_stats`` of the
window, ``torch.batch_norm_elemt`` for the ghost apply,
``torch.batch_norm`` in eval for the eval apply,
``native_batch_norm_backward`` for the backward, ``torch.batch_norm`` in
training beside statistics + apply), per shape and summed over a step.
Phase 2h holds the Swin's window-attention kernels
(``ops/window_attention.py``, Triton) at Swin-B's four stage shapes at
batch 256 (bf16, windows of 7; unshifted and shifted by 3 at stages 1-3,
unshifted at stage 4, whose map is one window): the output, the qkv
gradient and the bias table's gradient against the plain version
(relative in norm: 1e-3, 1e-2, 1e-5; the card tests give the reasons),
the same bits on a second run; then, at stages 1 and 3 shifted by 3,
cold and in turns, the forward and the forward + backward of the
kernels, of the plain version and of the path they replace (roll, partition, mask, ``F.scaled_dot_product_attention``,
merge, reverse roll: the ``library_ms`` yardstick, which the port never
calls), and the backward alone, each beside its bytes bound.

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

The second-to-last line is ``{"kernels": [...]}``: for each of the eight
ported kernels, the window attention (forward + backward at Swin-B's
stage-1 shape, batch 256; ``replaces`` none, its launches phase 11's,
its ``library_ms`` the SDPA path of phase 2h), ``int8_conv`` (which replaces no TPU kernel: its
``replaces`` names the XLA convolution of the JAX ``QuantConv``, and its
numbers are the stage-1 3x3 conv at batch 256) and the three batch-norm
kernels ``bn_stats``, ``bn_apply`` (its eval form) and ``bn_backward``
(with its window fix-up; none replaces a TPU kernel, and their numbers
are sums over the 53 batch-norms of a resnet50 step at batch 256, their
launches those of phases 3-5) its launches on its
path, max |err| against the plain
version, device ms of the kernel and of the plain version, the least time
the card could take at the same shape (``bound_ms``, set by ``bytes`` or
``operations``: NVIDIA's H100 peaks, ``openset_imagenet_tpu_torch/tools/
_card.py``) and the time of one PyTorch call computing the same function
where there is one (``library_ms``: ``F.cross_entropy`` against the
target matrix for K1 at unk_weight 1 (checked within rtol 1e-5 of K1's
mean; printed at [256, 116] and [64, 116]), ``F.cross_entropy`` with
class weights for K3, ``torch.add(x, b)`` for K7's axpy (checked bit
for bit), ``torch.ops.aten.threshold_backward`` for K7's relu-mask
(checked bit for bit off NaN masks), and for ``int8_conv`` the explicit
im2col plus ``torch._int_mm`` (checked on the int32 sums); else null). The last line is
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


def graph_ms(fn, calls=20, reps=20):
    """Median device milliseconds of one call, replayed from a CUDA graph
    of ``calls`` calls (no host launch overhead in the interval), captured
    on a warmed stream: K1's and K3's ticket counters exist."""
    from openset_imagenet_tpu_torch.tools import _card

    return _card.graph_ms(fn, calls=calls, reps=reps)


# -- phase 2: kernels against their plain versions ---------------------------

def kernel_checks(torch, fl):
    import torch.nn.functional as F

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
    library = {}
    for name, b, c, low, valid, masked, negative in cases:
        logits, labels, mask = batch(b, c, low, valid, masked)
        if negative:
            labels = -torch.ones_like(labels)
        class_w = torch.from_numpy(rng.uniform(0.2, 2.0, c).astype(
            np.float32)).to(dev)
        ce_rows = (class_w[labels.long().clamp(0, c - 1)] * mask
                   if name == "garbage" else (labels >= 0).float() * mask)
        if (name, b, c) == ("garbage", 64, 117):
            # One library call computes K3's sum on an unmasked batch.
            labels64 = labels.long()
            library["ce_fwd"] = graph_ms(lambda: F.cross_entropy(
                logits, labels64, weight=class_w, reduction="sum"))
        if name == "p1":
            # One library call computes K1's mean on an unmasked batch at
            # unk_weight 1: the cross-entropy against the target matrix
            # (one-hot for a known row, 1/C for a negative), formed once.
            targets = torch.where(
                labels[:, None] >= 0,
                F.one_hot(labels.long().clamp(min=0), c).float(),
                torch.full((b, c), 1.0 / c, device=dev))
            ce = F.cross_entropy(logits, targets)
            k1 = fl.entropic_fwd(logits, labels, mask, 1.0)[2]
            check(torch.allclose(ce, k1, rtol=1e-5, atol=0),
                  f"K1 [{b},{c}] at unk_weight 1: mean {float(k1)} vs "
                  f"F.cross_entropy {float(ce)}")
            library[("entropic_fwd", b)] = graph_ms(
                lambda: F.cross_entropy(logits, targets))
        runs = {
            "entropic_fwd": (
                lambda: fl.entropic_fwd(logits, labels, mask, 0.5),
                lambda: fl.entropic_fwd_plain(logits, labels, mask, 0.5)),
            "ce_fwd": (lambda: fl.ce_fwd(logits, labels, ce_rows),
                       lambda: fl.ce_fwd_plain(logits, labels, ce_rows)),
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
            floor = 1.0 if kname == "entropic_fwd" else 1e-12
            check(torch.equal(got[2], got[0] / got[1].clamp(min=floor)),
                  f"{kname} {name} [{b},{c}]: the mean is not sum / "
                  f"clamp(min={floor}) bit for bit")
            check(abs(g[2] - r[2]) <= 1e-5 * abs(r[2]) + 1e-6,
                  f"{kname} {name} [{b},{c}]: mean {g[2]} vs plain {r[2]}")
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
    main_shape = {"entropic_fwd": ("p1", 256, 116),
                  "ce_fwd": ("garbage", 64, 117)}
    timing = {}
    for kname, name, b, c, err, ms, pms, dms, pdms in rows:
        if main_shape[kname] == (name, b, c):
            timing[kname] = (dms, pdms)
        if kname == "entropic_fwd" and name == "p1":
            print(f"K1 entropic_fwd [{b},{c}]: dev_ms {dms:.5f}, library "
                  f"F.cross_entropy(logits, targets) "
                  f"{library[('entropic_fwd', b)]:.5f}")
    library["entropic_fwd"] = library[("entropic_fwd", 256)]
    return max_err, timing, library


def kernels_of(torch, fn, calls):
    """Names of the kernels ``calls`` calls of ``fn`` launch, from
    ``torch.profiler``.  A window can miss its first launch, so each opens
    with a marker kernel (``torch.cuda._sleep``, left out of the names);
    and a window can come back empty, so the fullest of three counts, or
    of up to six while all are empty (three in a row were, once, on the
    H100); a window never holds a kernel that did not run."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    for window_no in range(6):
        if window_no >= 3 and names:
            break
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        window = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.name]
        names = max(names, window, key=len)
    return names


def one_launch_checks(torch, fl):
    """K1 and K3 as one launch: one kernel per call (profiler), the same
    bits over 50 launches and over a CUDA-graph replay of 20 calls, at
    [64, C], [256, C], [1000, 1000] and [4099, 3] (many programs); at the
    main path's shapes their device times, K3's beside ``F.cross_entropy``
    and beside its two other grids.  Then the public entropic loss: K1 and
    K2 alone for a forward and a backward, K1 alone for an eval forward."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED + 6)
    for kname, c_main in (("entropic_fwd", 116), ("ce_fwd", 117)):
        for b, c in ((64, c_main), (256, c_main), (1000, 1000), (4099, 3)):
            logits = torch.from_numpy((rng.normal(size=(b, c)) * 3).astype(
                np.float32)).cuda()
            labels = torch.from_numpy(rng.integers(
                -1 if kname == "entropic_fwd" else 0, c, b).astype(np.int32)
                ).cuda()
            class_w = torch.from_numpy(rng.uniform(0.2, 2.0, c).astype(
                np.float32)).cuda()
            rows = (torch.ones(b, device="cuda") if kname == "entropic_fwd"
                    else class_w[labels.long()])
            if kname == "entropic_fwd":
                fn = lambda: fl.entropic_fwd(logits, labels, rows, 0.5)
            else:
                fn = lambda: fl.ce_sums(logits, labels, rows)
            call = lambda: torch.stack(fn())
            first = call()
            where = f"{kname} [{b},{c}]"
            check(all(torch.equal(call(), first) for _ in range(50)),
                  f"{where}: 50 launches differ")
            names = kernels_of(torch, fn, calls=10)
            check(len(names) == 10 and all(f"{kname}_once" in n
                                           for n in names),
                  f"{where}: 10 calls launched {names}")
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                call()
            graph, outs = torch.cuda.CUDAGraph(), []
            with torch.cuda.graph(graph, stream=side):
                for _ in range(20):
                    outs.append(call())
            graph.replay()
            torch.cuda.synchronize()
            check(all(torch.equal(o, first) for o in outs),
                  f"{where}: a graph replay differs from the eager call")
            grid = fl._grid(b, c, fl._TILE_ELEMS[kname])[3]
            line = (f"{where}: one launch per call ({names[0]}), {grid} "
                    "programs, bit-equal over 50 launches and a 20-call "
                    "replay")
            if c == c_main:
                line += f"; dev_us {graph_ms(fn) * 1e3:.3f}"
            if c == 117:
                labels64 = labels.long()
                library_ms = graph_ms(lambda: F.cross_entropy(
                    logits, labels64, weight=class_w, reduction="sum"))
                line += f", F.cross_entropy {library_ms * 1e3:.3f}"
                # The other grids the kernel takes: programs of
                # 2048-element tiles and a ticket, and one program holding
                # every row.
                keep = fl._TILE_ELEMS["ce_fwd"]
                for label, elems in (("2048-element tiles", 2048),
                                     ("one program", None)):
                    fl._TILE_ELEMS["ce_fwd"] = elems
                    try:
                        ms = graph_ms(fn)
                        check(torch.allclose(call(), first, rtol=1e-5),
                              f"{where}: {label}")
                    finally:
                        fl._TILE_ELEMS["ce_fwd"] = keep
                    line += f", {label} {ms * 1e3:.3f}"
            print(line)
    check(all(int(t.item()) == 0 for t in fl._TICKETS.values()),
          "a ticket counter was left above 0")

    # The entropic loss at the train step's shape: two kernels each way.
    lg = torch.from_numpy((rng.normal(size=(256, 116)) * 3).astype(
        np.float32)).cuda().requires_grad_()
    labels = torch.from_numpy(rng.integers(-1, 116, 256).astype(np.int32)
                              ).cuda()
    mask = torch.from_numpy((rng.random(256) > 0.2).astype(np.float32)
                            ).cuda()
    cotangent = torch.tensor(0.37, device="cuda")

    def train():
        mean, _ = fl.entropic_openset_loss_fused(lg, labels, mask, 0.5)
        torch.autograd.grad(mean, lg, cotangent)

    def evaluate():
        with torch.inference_mode():
            fl.entropic_openset_loss_fused(lg, labels, mask, 0.5)

    names = kernels_of(torch, train, calls=1)
    check(len(names) == 2 and "entropic_fwd_once" in names[0] and
          "entropic_bwd" in names[1],
          f"entropic loss forward + backward launched {names}")
    eval_names = kernels_of(torch, evaluate, calls=1)
    check(len(eval_names) == 1 and "entropic_fwd_once" in eval_names[0],
          f"entropic loss eval forward launched {eval_names}")
    print(f"entropic loss [256,116]: forward + backward launch "
          f"{len(names)} kernels ({', '.join(n[:24] for n in names)}); "
          f"eval forward {len(eval_names)}")

    # The softmax and garbage losses at their train steps' shape: K3 and
    # K4 each way, after the row weights' own elementwise kernels (formed
    # before the loss, as the JAX package forms them).
    for loss, c in (("softmax", 116), ("garbage", 117)):
        lg = torch.from_numpy((rng.normal(size=(64, c)) * 3).astype(
            np.float32)).cuda().requires_grad_()
        labels = torch.from_numpy(rng.integers(
            -1 if loss == "softmax" else 0, c, 64).astype(np.int32)).cuda()
        mask = torch.from_numpy((rng.random(64) > 0.2).astype(np.float32)
                                ).cuda()
        class_w = torch.from_numpy(rng.uniform(0.2, 2.0, c).astype(
            np.float32)).cuda()
        fn = ((lambda: fl.softmax_loss_fused(lg, labels, mask))
              if loss == "softmax" else
              (lambda: fl.garbage_loss_fused(lg, labels, class_w, mask)))

        def train():
            mean, _ = fn()
            torch.autograd.grad(mean, lg, cotangent)

        def evaluate():
            with torch.inference_mode():
                fn()

        names = kernels_of(torch, train, calls=1)
        eval_names = kernels_of(torch, evaluate, calls=1)
        ce = [n for n in names if "ce_fwd_once" in n or "ce_bwd" in n]
        check(len(ce) == 2 and "ce_fwd_once" in ce[0] and "ce_bwd" in ce[1]
              and names[names.index(ce[0]) + 1:] == ce[1:],
              f"{loss} loss forward + backward launched {names}")
        check("ce_fwd_once" in eval_names[-1] and
              sum("ce_" in n for n in eval_names) == 1 and
              len(names) - 2 == len(eval_names) - 1,
              f"{loss} loss eval forward launched {eval_names}")
        # The loss's own two kernels, on row weights formed once.
        rows = ((labels >= 0).float() * mask if loss == "softmax" else
                class_w[labels.long()] * mask)

        def loss_kernels():
            _, wsum, _ = fl.ce_fwd(lg.detach(), labels, rows)
            fl.ce_grad(lg.detach(), labels, rows, cotangent, wsum)

        print(f"{loss} loss [64,{c}]: forward + backward launch K3 and K4 "
              f"alone after {len(names) - 2} row-weight kernels "
              f"({', '.join(n[:20] for n in names[:-2])}); eval forward "
              f"{len(eval_names)}; dev_us forward + backward "
              f"{graph_ms(train) * 1e3:.3f}, K3 + K4 alone "
              f"{graph_ms(loss_kernels) * 1e3:.3f}")


def grad_kernel_checks(torch, fl):
    """K2 and K4 against their plain versions, K2 given ``(g, count)`` and
    K4 given ``(g, wsum)`` bit-equal to each given torch's scale, and the
    two grids of K2 and of K4 timed side by side; returns (max_err,
    timing)."""
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
        # K2 as the backward calls it: the cotangent and the count.
        g = torch.tensor(0.37, dtype=torch.float32, device=dev)
        count = mask.sum()
        given = fl.entropic_grad(logits, labels, mask,
                                 g / count.clamp(min=1.0),
                                 torch.ones((), device=dev), 0.5)
        check(torch.equal(fl.entropic_grad(logits, labels, mask, g, count,
                                           0.5), given),
              f"K2 {name} [{b},{c}]: the in-kernel scale differs from "
              "torch's g / count.clamp(min=1)")
        # K4 likewise, from the cotangent and the weight sum.
        wsum = ce_rows.sum()
        one = torch.ones((), device=dev)
        check(torch.equal(fl.ce_grad(logits, labels, ce_rows, g, wsum),
                          fl.ce_grad(logits, labels, ce_rows,
                                     g / wsum.clamp(min=1e-12), one)),
              f"K4 {name} [{b},{c}]: the in-kernel scale differs from "
              "torch's g / wsum.clamp(min=1e-12)")
        runs = {
            "entropic_bwd": (
                lambda: fl.entropic_grad(logits, labels, mask, g, count,
                                         0.5),
                lambda: fl.entropic_grad_plain(logits, labels, mask, g,
                                               count, 0.5), mask),
            "ce_bwd": (
                lambda: fl.ce_grad(logits, labels, ce_rows, g, wsum),
                lambda: fl.ce_grad_plain(logits, labels, ce_rows, g, wsum),
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
                                         torch.ones((), device=dev), count,
                                         0.5)
        else:
            fn = (fl.softmax_loss_fused if name == "softmax" else
                  lambda *a: fl.garbage_loss_fused(a[0], a[1], class_w,
                                                   a[2]))
            mean, wsum = fn(lg, labels, mask)
            r = ((labels >= 0).float() * mask if name == "softmax" else
                 class_w[labels.long().clamp(0, c - 1)] * mask)
            ref = fl.ce_grad_plain(lg.detach(), labels, r,
                                   torch.ones((), device=dev), wsum)
        (got,) = torch.autograd.grad(mean, lg)
        check(torch.allclose(got, ref, rtol=1e-5, atol=1e-8),
              f"autograd through {name} loss differs from the plain backward")
    # The two grids of K2 and of K4: two-row programs of one warp, and
    # 2048-element tiles (16 rows at C = 116 or 117) of four warps.
    for kname, b, c in (("entropic_bwd", 256, 116), ("entropic_bwd", 64, 116),
                        ("ce_bwd", 64, 117), ("ce_bwd", 256, 117)):
        logits = torch.from_numpy((rng.normal(size=(b, c)) * 3).astype(
            np.float32)).to(dev)
        labels = torch.from_numpy(rng.integers(
            -1 if kname == "entropic_bwd" else 0, c, b).astype(np.int32)
            ).to(dev)
        mask = torch.ones(b, device=dev)
        g, count = torch.tensor(0.37, device=dev), mask.sum()
        if kname == "entropic_bwd":
            fn = lambda: fl.entropic_grad(logits, labels, mask, g, count,
                                          0.5)
        else:
            fn = lambda: fl.ce_grad(logits, labels, mask, g, count)
        keep = fl._TILE_ELEMS[kname]
        ref, times = fn(), {}
        for elems in (256, 2048):
            fl._TILE_ELEMS[kname] = elems
            try:
                times[elems] = graph_ms(fn)
                check(torch.allclose(fn(), ref, rtol=1e-5, atol=1e-8),
                      f"{kname} [{b},{c}], {elems}-element tiles")
            finally:
                fl._TILE_ELEMS[kname] = keep
        print(f"{kname} [{b},{c}] dev_us: two-row programs of one warp "
              f"{times[256] * 1e3:.3f}, 2048-element tiles of four warps "
              f"{times[2048] * 1e3:.3f} (the port takes {keep}-element "
              "tiles)")
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


# -- phase 2b: K5 against its plain version -----------------------------------

K5_FORMS = {"tail": (True, True, False, True),      # in_act, mask, ds, gp
            "head_ds": (False, False, True, False),
            "head": (False, False, False, False)}
# name, M, ci, co, form, dtypes: every distinct resnet50 site shape at 224
# px, batch 256 (the stride sits on the 3x3 conv, so a block-1 head site
# runs at the input resolution), then a ragged M and ragged channels.
K5_CASES = [
    ("stage1 tail", 802816, 64, 256, "tail", ("bf16",)),
    ("stage1 head b1", 802816, 64, 64, "head", ("bf16",)),
    ("stage1 head", 802816, 256, 64, "head_ds", ("bf16",)),
    ("stage2 head b1", 802816, 256, 128, "head", ("bf16",)),
    ("stage2 tail", 200704, 128, 512, "tail", ("bf16",)),
    ("stage2 head", 200704, 512, 128, "head_ds", ("bf16",)),
    ("stage3 head b1", 200704, 512, 256, "head", ("bf16",)),
    ("stage3 tail", 50176, 256, 1024, "tail", ("bf16",)),
    ("stage3 head", 50176, 1024, 256, "head_ds", ("bf16",)),
    ("stage4 head b1", 50176, 1024, 512, "head", ("bf16", "f32")),
    ("stage4 tail", 12544, 512, 2048, "tail", ("bf16", "f32")),
    ("stage4 head", 12544, 2048, 512, "head_ds", ("bf16", "f32")),
    ("ragged tail", 12544 + 77, 512, 2048, "tail", ("bf16", "f32")),
    ("ragged s1 tail", 4096 + 3, 64, 256, "tail", ("bf16", "f32")),
    ("ragged head", 1000 + 3, 72, 40, "head_ds", ("bf16", "f32")),
]
K5_SITES = 12             # the first twelve cases: the resnet50 sites
K5_PLAIN_TIMED = ("stage1 tail", "stage1 head", "stage4 tail")


def k5_inputs(torch, m, ci, co, form, dtype, seed):
    in_act, has_mask, has_ds, emit_gp = K5_FORMS[form]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape, dt=dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dt)

    mask = (torch.randint(0, 2, (m, co), generator=gen, device="cuda")
            .to(torch.int8) if has_mask else None)
    args = [draw(m, co), draw(m, co), mask, draw(m, ci),
            draw(m, ci) if has_ds else None, draw(ci, co, scale=0.05),
            draw(co, dt=torch.float32), draw(co, dt=torch.float32),
            draw(ci, dt=torch.float32) if in_act else None,
            draw(ci, dt=torch.float32) if in_act else None]
    return args, dict(in_act=in_act, emit_gp=emit_gp)


def k5_checks(torch, fbb):
    """K5 against ``bwd_site_plain`` on the card; returns (max_err, (kernel,
    plain) device ms at the stage-1 tail)."""
    from openset_imagenet_tpu_torch.tools import _card

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    max_err, rows, sites = 0.0, [], []
    for seed, (name, m, ci, co, form, names) in enumerate(K5_CASES):
        for dname in names:
            dtype = dtypes[dname]
            args, kw = k5_inputs(torch, m, ci, co, form, dtype, SEED + seed)
            kernel = lambda: fbb.bwd_site(*args, **kw)
            plain = lambda: fbb.bwd_site_plain(*args, **kw)
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            ref = plain()
            where = f"K5 {name} [M={m}, ci={ci}, co={co}] {dname}"
            flat = lambda o: [o[0], o[1], o[2], *o[3], *o[4]]
            for a, b in zip(flat(got), flat(again)):
                check(a is None or torch.equal(a, b),
                      f"{where}: two launches differ")
            dx, gp, dw, so, si = got
            rdx, rgp, rdw, rso, rsi = ref
            check(dx.dtype == dtype and dw.dtype == torch.float32,
                  f"{where}: output dtypes")
            check((gp is None) == (rgp is None) and
                  (gp is None or torch.equal(gp, rgp)), f"{where}: gp")
            for label, a, b in [("dW", dw, rdw), *zip(
                    ("s_mul_o", "s_add_o", "s_mul_i", "s_add_i"),
                    (*so, *si), (*rso, *rsi))]:
                if b is None:
                    continue
                rel = float((a - b).norm() / b.norm().clamp(min=1e-30))
                check(rel <= 1e-4, f"{where}: {label} {rel:.3e} rel in norm")
                max_err = max(max_err, float((a - b).abs().max()))
            tol = (2e-2, 1e-2) if dtype == torch.bfloat16 else (1e-5, 1e-5)
            check(torch.allclose(dx.float(), rdx.float(), rtol=tol[0],
                                 atol=tol[1]), f"{where}: dx")
            max_err = max(max_err, float((dx.float() - rdx.float()).abs()
                                         .max()))
            del got, again, ref, dx, gp, dw, rdx, rgp, rdw
            if seed < K5_SITES and dname == "bf16":
                in_act, has_mask, has_ds, emit_gp = K5_FORMS[form]
                nbytes, flops = fbb.traffic(
                    m, ci, co, in_act=in_act, has_mask=has_mask,
                    has_ds=has_ds, emit_gp=emit_gp)
                route = fbb._plan(m, ci, co, dtype, in_act, has_mask, has_ds,
                                  True, fbb._sm_count(0))[0]
                # Where the fused route takes a site, the tiled route's
                # time beside it: the measured side of the threshold.
                tiled_ms = None if route != "fused" else graph_ms(
                    lambda: fbb._kernel_site(*args, **kw, route="tiled"),
                    calls=5, reps=5)
                sites.append((name, m, ci, co, route,
                              graph_ms(kernel, calls=5, reps=5),
                              nbytes / _card.BYTES_PER_S * 1e3,
                              flops / _card.BF16_FLOP_PER_S * 1e3, tiled_ms))
            if name in K5_PLAIN_TIMED and dname == "bf16":
                rows.append((name, m, ci, co, time_ms(kernel, reps=10),
                             time_ms(plain, reps=10),
                             graph_ms(kernel, calls=5, reps=5),
                             graph_ms(plain, calls=5, reps=5)))
            del args
            torch.cuda.empty_cache()
    print("K5 site          shape                  call_ms   plain_call_ms"
          "  dev_ms    plain_dev_ms")
    for name, m, ci, co, ms, pms, dms, pdms in rows:
        print(f"{name:16s} [{m},{ci}]x[{ci},{co}]".ljust(40) +
              f"{ms:.4f}   {pms:.4f}        {dms:.4f}   {pdms:.4f}")
    print("K5 site          shape                 route   dev_ms    "
          "bytes_ms  ops_ms    share_of_bound  tiled_route_ms")
    for name, m, ci, co, route, dms, bms, oms, tms in sites:
        print(f"{name:16s} [{m};{ci}->{co}]".ljust(38) + f"{route:7s} "
              f"{dms:.4f}    {bms:.4f}    {oms:.4f}    "
              f"{max(bms, oms) / dms:.3f}           " +
              ("-" if tms is None else f"{tms:.4f}"))
    print(f"K5: every check passed over {sum(len(c[5]) for c in K5_CASES)} "
          f"cases; max |err| {max_err:.3e}; the {len(sites)} resnet50 sites "
          f"{sum(s[5] for s in sites):.4f} ms in all, bound "
          f"{sum(max(s[6], s[7]) for s in sites):.4f} ms")
    return max_err, (rows[0][6], rows[0][7])


# -- phase 2c: K6 against its plain version and K5 ---------------------------

# name, M, ci, co, dtypes: every resnet50 tail site at 224 px, batch 256,
# a ragged M, and ragged channel counts (the scalar-load path).
K6_CASES = [
    ("stage1 tail", 802816, 64, 256, ("bf16",)),
    ("stage2 tail", 200704, 128, 512, ("bf16",)),
    ("stage3 tail", 50176, 256, 1024, ("bf16",)),
    ("stage4 tail", 12544, 512, 2048, ("bf16", "f32")),
    ("ragged M", 12544 + 77, 512, 2048, ("bf16", "f32")),
    ("ragged channels", 1000 + 3, 37, 21, ("bf16", "f32")),
]
K6_TIMED = ("stage1 tail", "stage4 tail")


def rel_norm(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def k6_checks(torch, ss, fbb):
    """K6 against ``tail_site_split_plain`` and K5's unified site; returns
    (max_err, (kernel, plain, K5) device ms at the stage-1 tail).  At the
    timed tails, each K6 kernel's device ms (profiler) beside its own
    stage bound, and the site's ms beside the split's floor and the site's
    bound.  The tolerance checks run after every number is printed."""
    from openset_imagenet_tpu_torch.tools import _card
    from openset_imagenet_tpu_torch.tools import bench_split_site as tool

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    labels = ("dW", "s_mul_o", "s_add_o", "s_mul_i", "s_add_i")
    flat = lambda o: [o[0], o[1], o[2], *o[3], *o[4]]
    max_err, rows, worst, late, stages = 0.0, [], {}, [], []
    for seed, (name, m, ci, co, names) in enumerate(K6_CASES):
        for dname in names:
            dtype = dtypes[dname]
            k5_args, k5_kw = k5_inputs(torch, m, ci, co, "tail", dtype,
                                       SEED + 100 + seed)
            route = ss._plan(m, ci, co, dtype, True, fbb._sm_count(0)).route
            g, z, mask, x, _, w, mul_o, _, mul_i, add_i = k5_args
            args = (g, z, mask, x, w, mul_o, mul_i, add_i)
            kernel = lambda: ss.tail_site_split(*args)
            plain = lambda: ss.tail_site_split_plain(*args)
            unified = lambda: fbb.bwd_site(*k5_args, **k5_kw)
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            where = f"K6 {name} [M={m}, ci={ci}, co={co}] {dname}"
            for a, b in zip(flat(got), flat(again)):
                check(torch.equal(a, b), f"{where}: two launches differ")
            del again
            check(got[0].dtype == got[1].dtype == dtype and
                  got[2].dtype == torch.float32, f"{where}: dtypes")
            for ref_name, reference in (("plain", plain), ("K5", unified)):
                ref = reference()
                check(torch.equal(got[1], ref[1]), f"{where}: gp vs "
                      f"{ref_name}")
                if ref_name == "plain":
                    tol, dx_tol = 1e-4, ((2e-2, 1e-2) if dtype ==
                                         torch.bfloat16 else (1e-5, 1e-5))
                else:
                    tol = 8e-2 if dtype == torch.bfloat16 else 1e-5
                    dx_tol = (tol, tol)
                for label, a, b in zip(labels, flat(got)[2:], flat(ref)[2:]):
                    rel = rel_norm(a, b)
                    key = (ref_name, dname, label)
                    worst[key] = max(worst.get(key, 0.0), rel)
                    late.append((rel <= tol, f"{where}: {label} {rel:.3e} "
                                 f"rel in norm vs {ref_name}"))
                    if ref_name == "plain":
                        max_err = max(max_err, float((a - b).abs().max()))
                late.append((torch.allclose(
                    got[0].float(), ref[0].float(), rtol=dx_tol[0],
                    atol=dx_tol[1]), f"{where}: dx vs {ref_name}"))
                if ref_name == "plain":
                    max_err = max(max_err, float(
                        (got[0].float() - ref[0].float()).abs().max()))
                if ref_name == "plain" and dtype == torch.bfloat16 and \
                        name in K6_TIMED:
                    # The input-side sums add dxa after its rounding to
                    # bf16; how far each side is from the same dataflow
                    # with a float64 product.
                    dz = (ref[1].float() * mul_o).to(dtype)
                    dxa = (dz.double() @ w.double().t()).to(dtype)
                    xa = torch.relu(x * mul_i.to(dtype) + add_i.to(dtype))
                    gin = torch.where(xa.float() > 0, dxa.double(), 0.0)
                    s64 = ((gin * x.double()).sum(0), gin.sum(0))
                    print(f"{where}: s_mul_i, s_add_i vs a float64 product, "
                          "rel in norm: kernel " + ", ".join(
                              f"{rel_norm(a.double(), b):.3e}"
                              for a, b in zip(got[4], s64)) + "; plain " +
                          ", ".join(f"{rel_norm(a.double(), b):.3e}"
                                    for a, b in zip(ref[4], s64)))
                    del dz, dxa, xa, gin
                del ref
            del got
            if name in K6_TIMED and dname == "bf16":
                rows.append((name, m, ci, co, time_ms(kernel, reps=10),
                             time_ms(plain, reps=10),
                             graph_ms(kernel, calls=5, reps=5),
                             graph_ms(plain, calls=5, reps=5),
                             graph_ms(unified, calls=5, reps=5)))
                per_kernel = tool.kernel_ms(
                    lambda: [kernel() for _ in range(tool.CHAIN)])
                bounds = {k: _card.bound_ms(b)[0] for k, b in
                          tool.stage_bytes(m, ci, co).items()}
                stages.append((name, route, per_kernel, bounds,
                               _card.bound_ms(tool.function_bytes(m, ci, co),
                                              tool.function_flops(m, ci, co)
                                              )[0], rows[-1][6]))
            del args, k5_args
            torch.cuda.empty_cache()
    for ref_name in ("plain", "K5"):
        print(f"K6 vs {ref_name}, worst rel in norm: " + ", ".join(
            f"{d} {lab} {v:.3e}" for (r, d, lab), v in sorted(worst.items())
            if r == ref_name))
    print("K6 site          shape                  call_ms   plain_call_ms"
          "  dev_ms    plain_dev_ms  K5_dev_ms")
    for name, m, ci, co, ms, pms, dms, pdms, udms in rows:
        print(f"{name:16s} [{m},{ci}]x[{ci},{co}]".ljust(40) +
              f"{ms:.4f}   {pms:.4f}        {dms:.4f}   {pdms:.4f}"
              f"       {udms:.4f}")
    for name, route, per_kernel, bounds, site_bound, ms in stages:
        print(f"K6 {name} ({route}) by kernel, dev_ms / own stage bound "
              "(share): " + ", ".join(
                  f"{k} {v:.4f}" + (
                      f" / {bounds[tool.stage_of(k)]:.4f} "
                      f"({bounds[tool.stage_of(k)] / v:.3f})"
                      if tool.stage_of(k) else "")
                  for k, v in sorted(per_kernel.items())))
        floor = sum(bounds.values())
        print(f"K6 {name}: {ms:.4f} ms, the split's floor {floor:.4f} ms "
              f"({floor / ms:.3f}), the site's bound {site_bound:.4f} ms "
              f"({site_bound / ms:.3f})")
    for ok, message in late:
        check(ok, message)
    print(f"K6: every check passed over {sum(len(c[4]) for c in K6_CASES)} "
          f"cases; max |err| {max_err:.3e}")
    return max_err, rows[0][6:9]


# -- phase 2d: K7 against its plain versions ----------------------------------

K7_SHAPES = ((8, 3136, 256), (8, 3001, 256))


def _with_specials(torch, t):
    """``t`` with NaNs of both signs, +-0, +-inf and subnormals of both
    signs strewn over it (every 7th element, cycling)."""
    special = torch.tensor([0x7FC0, 0xFFC0, 0x7F81, 0x0000, 0x8000, 0x7F80,
                            0xFF80, 0x0001, 0x8001, 0x007F, 0x807F],
                           dtype=torch.int32).to(torch.int16)
    flat = t.clone().view(torch.int16).view(-1)
    picks = torch.arange(0, flat.numel(), 7, device=t.device)
    flat[picks] = special.to(t.device)[torch.arange(
        picks.numel(), device=t.device) % special.numel()]
    return flat.view(torch.bfloat16).view(t.shape)


def k7_checks(torch, sp):
    """K7 against its plain versions and the library calls that compute
    the same function, bit for bit; returns (max_err, {name: (kernel,
    plain, library) device ms at [8, 3136, 256]})."""
    from openset_imagenet_tpu_torch.tools import bench_stream as tool

    max_err, timing = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 200)
    draw = lambda shape: (torch.randn(*shape, generator=gen, device="cuda")
                          .to(torch.bfloat16))
    same_bits = lambda a, b: a.dtype == b.dtype and torch.equal(
        a.view(torch.int16), b.view(torch.int16))
    runs = {"stream_axpy": (sp.axpy, sp.axpy_plain, torch.add),
            "stream_relu_mask": (
                sp.relu_mask, sp.relu_mask_plain,
                lambda g, m: torch.ops.aten.threshold_backward(g, m, 0))}
    for name, key in (("stream_axpy", "axpy"),
                      ("stream_relu_mask", "relu_mask")):
        tile, programs, warps = sp._plan(
            int(np.prod(K7_SHAPES[0])), sp.LAUNCH[key],
            sp.sm_count(torch.device("cuda")))
        print(f"K7 {name} launch: {sp.LAUNCH[key]._asdict()} -> tile "
              f"{tile}, {programs} programs of {warps} warps at "
              f"{list(K7_SHAPES[0])}")
    # Both shapes, an odd element count and a view at storage offset 1
    # (its data pointer 2 bytes past a 16-byte boundary).  relu_mask's
    # mask carries the special values.
    cases = []
    for label, shape in [(f"{list(s)}", s) for s in K7_SHAPES] + [
            ("n=4097", (4097,)), ("offset 1", ((1 << 16) + 1,))]:
        a, b = draw(shape), draw(shape)
        m = _with_specials(torch, b)
        if label == "offset 1":
            a, b, m = a[1:], b[1:], m[1:]
            check(a.data_ptr() % 16 == 2 and m.data_ptr() % 16 == 2,
                  "the offset views are aligned")
        cases.append((label, {"stream_axpy": (a, b),
                              "stream_relu_mask": (a, m)}))
    for label, operands in cases:
        for name, (kernel, plain, library) in runs.items():
            a, b = operands[name]
            got, again = kernel(a, b), kernel(a, b)
            torch.cuda.synchronize()
            ref = plain(a, b)
            check(same_bits(got, again), f"{name} {label}: two launches "
                  "differ")
            check(same_bits(got, ref),
                  f"{name} {label}: not bit-equal to the plain version")
            lib = library(a, b)
            if name == "stream_relu_mask":
                # threshold_backward passes g through where the mask is
                # NaN; the kernel, as JAX, gives 0 there.
                ok = ~torch.isnan(b)
                check(same_bits(got[ok], lib[ok]), f"{name} {label}: "
                      "threshold_backward's bits differ off the NaNs")
                check(bool((got[~ok] == 0).all()), f"{name} {label}: a "
                      "NaN mask did not give 0")
            else:
                check(same_bits(got, lib),
                      f"{name} {label}: torch.add's bits differ")
            max_err[name] = max(max_err.get(name, 0.0), float(
                (got.float() - ref.float()).abs().max()))
    # Timed in the bench tool's cold harness (a pair and an output for each
    # call of a 20-call graph, 770 MB a replay, the L2 flushed first), so
    # no byte comes from the L2; kernel and library in turns (kernel,
    # library, library, kernel), the plain version after.  The warm
    # harness used before (four rotating pairs, one output buffer) is
    # printed beside it.
    cold = tool.operand_pairs(K7_SHAPES[0], cold=True, seed=SEED + 201)
    warm = tool.operand_pairs(K7_SHAPES[0], cold=False, seed=SEED + 202)
    for name, (kernel, plain, library) in runs.items():
        t = tool.in_turns(kernel, library, cold, cold=True)
        w = tool.in_turns(kernel, library, warm, cold=False)
        timing[name] = (t["us"] / 1e3,
                        tool.device_us(plain, cold, cold=True) / 1e3,
                        t["library_us"] / 1e3)
        print(f"K7 {name} [8,3136,256] bf16, device us in turns, cold: "
              f"kernel {t['us_turns'][0]:.3f} {t['us_turns'][1]:.3f}, "
              f"library {t['library_turns'][0]:.3f} "
              f"{t['library_turns'][1]:.3f}, plain "
              f"{timing[name][1] * 1e3:.3f}; warm4: kernel "
              f"{w['us_turns'][0]:.3f} {w['us_turns'][1]:.3f}, library "
              f"{w['library_turns'][0]:.3f} {w['library_turns'][1]:.3f}")
    return max_err, timing


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


# -- phase 2g: the batch-norm kernels against their plain versions ----------

def resnet50_bn_shapes(batch=256, image=IMAGE):
    """``[(N, C, H, W), ...]`` of the 53 batch-norms of a resnet50 forward,
    in order (the stem's, then each bottleneck's bn1, bn2, bn3 and the
    first block's downsample)."""
    hw = image // 2
    shapes = [(batch, 64, hw, hw)]
    hw //= 2
    for stage, blocks in enumerate((3, 4, 6, 3)):
        width = 64 * 2 ** stage
        for j in range(blocks):
            out = hw // 2 if stage > 0 and j == 0 else hw
            shapes += [(batch, width, hw, hw), (batch, width, out, out),
                       (batch, 4 * width, out, out)]
            if j == 0:
                shapes.append((batch, 4 * width, out, out))
            hw = out
    check(len(shapes) == 53, f"{len(shapes)} resnet50 batch-norms")
    return shapes


def bn_checks(torch, bnk):
    """The batch-norm kernels at every resnet50 shape at batch 256 (bf16,
    channels-last, the train cells' window of 64 images): the apply
    bit-equal to its plain version in both forms, the statistics within
    rtol 1e-5 and the backward against bn_grad_plain, each launch twice
    with the same bits; then each kernel, its plain version and the
    library call beside it timed cold and in turns.  Returns the times,
    each summed over the 53 batch-norms of a step, and each kernel's
    largest |kernel - plain version| (the apply's over both forms)."""
    from openset_imagenet_tpu_torch.tools import _card

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 300)
    same = lambda a, b: torch.equal(a.view(torch.int16), b.view(torch.int16))
    rel = lambda a, b: float((a.float() - b.float()).norm()
                             / max(float(b.float().norm()), 1e-30))
    shapes = resnet50_bn_shapes()
    counts = {s: shapes.count(s) for s in shapes}
    names = ("stats", "apply", "eval", "backward", "train_fwd")
    total = {k: {"kernel": 0.0, "plain": 0.0, "library": 0.0, "bound": 0.0}
             for k in names}
    max_err = {"bn_stats": 0.0, "bn_apply": 0.0, "bn_backward": 0.0}
    for shape, count in counts.items():
        n, c, h, w = shape
        m, r = n * h * w, GHOST * h * w
        draw = lambda scale, shift: (torch.randn(
            *shape, generator=gen, device=dev) * scale + shift).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        x, g = draw(2.0, 0.5), draw(1.0, 0.0)
        wgt = torch.rand(c, generator=gen, device=dev) + 0.5
        bias = torch.randn(c, generator=gen, device=dev) * 0.1
        rm = torch.randn(c, generator=gen, device=dev) * 0.1
        rv = torch.rand(c, generator=gen, device=dev) + 0.5
        stats = bnk.bn_stats(x, GHOST, rm.clone(), rv.clone(), 0.9)
        ref = bnk.bn_stats_plain(x, GHOST, rm.clone(), rv.clone(), 0.9)
        check(torch.equal(stats, bnk.bn_stats(x, GHOST, rm.clone(),
                                               rv.clone(), 0.9)),
              f"bn_stats {shape}: two launches differ")
        err = float(((stats[:2] - ref[:2]).abs()
                     / ref[:2].abs().clamp(min=1e-6)).max())
        check(err <= 1e-5, f"bn_stats {shape}: rel err {err}")
        max_err["bn_stats"] = max(max_err["bn_stats"], float(
            (stats[:2] - ref[:2]).abs().max()))
        for ghost, (mean, var) in ((True, (ref[0], ref[1])),
                                   (False, (rm, rv))):
            y = bnk.bn_apply(x, mean, var, wgt, bias, 1e-5, ghost)
            want = bnk.bn_apply_plain(x, mean, var, wgt, bias, 1e-5, ghost)
            max_err["bn_apply"] = max(max_err["bn_apply"], float(
                (y.float() - want.float()).abs().max()))
            check(same(y, want),
                  f"bn_apply {shape} ghost={ghost}: not bit-equal to plain")
            check(same(y, bnk.bn_apply(x, mean, var, wgt, bias, 1e-5,
                                       ghost)),
                  f"bn_apply {shape}: two launches differ")
        ref = ref.contiguous()
        got = bnk.bn_backward(g, x, wgt, ref, GHOST, True, 1e-5)
        want = bnk.bn_grad_plain(g, x, wgt, ref, GHOST, True, 1e-5)
        again = bnk.bn_backward(g, x, wgt, ref, GHOST, True, 1e-5)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"bn_backward {shape}: two launches differ")
        check(same(got[0][GHOST:], want[0][GHOST:]),
              f"bn_backward {shape}: dx outside the window differs")
        errs = (rel(got[0][:GHOST], want[0][:GHOST]), rel(got[1], want[1]),
                rel(got[2], want[2]))
        check(errs[0] <= 1e-3 and max(errs[1:]) <= 1e-5,
              f"bn_backward {shape}: rel errs {errs}")
        max_err["bn_backward"] = max(max_err["bn_backward"], float(
            (got[0].float() - want[0].float()).abs().max()))
        # Cold, in turns: kernel, plain version, library call.
        mean, invstd = torch.batch_norm_stats(x, 1e-5)
        lib_bwd = lambda: torch.ops.aten.native_batch_norm_backward(
            g, x, wgt, rm, rv, mean, invstd, True, 1e-5, [True, True, True])
        runs = {
            ("stats", "kernel"): lambda: bnk.bn_stats(x, GHOST, rm, rv, 0.9),
            ("stats", "plain"): lambda: bnk.bn_stats_plain(x, GHOST, rm, rv,
                                                           0.9),
            ("stats", "library"): lambda: torch.batch_norm_stats(x[:GHOST],
                                                                 1e-5),
            ("apply", "kernel"): lambda: bnk.bn_apply(
                x, stats[0], stats[1], wgt, bias, 1e-5, True),
            ("apply", "plain"): lambda: bnk.bn_apply_plain(
                x, stats[0], stats[1], wgt, bias, 1e-5, True),
            ("apply", "library"): lambda: torch.batch_norm_elemt(
                x, wgt, bias, mean, invstd, 1e-5),
            ("eval", "kernel"): lambda: bnk.bn_apply(x, rm, rv, wgt, bias,
                                                     1e-5, False),
            ("eval", "plain"): lambda: bnk.bn_apply_plain(x, rm, rv, wgt,
                                                          bias, 1e-5, False),
            ("eval", "library"): lambda: torch.batch_norm(
                x, wgt, bias, rm, rv, False, 0.1, 1e-5, True),
            ("backward", "kernel"): lambda: bnk.bn_backward(
                g, x, wgt, ref, GHOST, True, 1e-5),
            ("backward", "plain"): lambda: bnk.bn_grad_plain(
                g, x, wgt, ref, GHOST, True, 1e-5),
            ("backward", "library"): lib_bwd,
            ("train_fwd", "kernel"): lambda: bnk.bn_apply(
                x, *bnk.bn_stats(x, GHOST, rm, rv, 0.9)[:2], wgt, bias, 1e-5,
                True),
            ("train_fwd", "library"): lambda: torch.batch_norm(
                x, wgt, bias, rm.clone(), rv.clone(), True, 0.1, 1e-5, True),
        }
        ms = _card.cold_in_turns(runs, reps=5)
        bounds = {"stats": 2 * r * c, "apply": 4 * m * c, "eval": 4 * m * c,
                  "backward": 6 * m * c + 6 * r * c,
                  "train_fwd": 2 * r * c + 4 * m * c}
        for name in names:
            bound = _card.bound_ms(bounds[name])[0]
            total[name]["bound"] += count * bound
            for who in ("kernel", "plain", "library"):
                total[name][who] += count * ms.get((name, who), 0.0)
        share = {name: 100 * _card.bound_ms(bounds[name])[0]
                 / ms[(name, "kernel")] for name in names}
        print(f"bn {list(shape)} x{count}: " + ", ".join(
            f"{name} {ms[(name, 'kernel')] * 1e3:.1f} us "
            f"({share[name]:.0f}% of bound; plain "
            f"{ms.get((name, 'plain'), 0) * 1e3:.1f}, library "
            f"{ms[(name, 'library')] * 1e3:.1f})" for name in names))
        del x, g, runs, got, want, again
    for name in names:
        t = total[name]
        print(f"bn {name}, the 53 batch-norms of a batch-256 step: kernel "
              f"{t['kernel']:.3f} ms, bound {t['bound']:.3f} ms "
              f"({100 * t['bound'] / t['kernel']:.1f}%), plain "
              f"{t['plain']:.3f} ms, library {t['library']:.3f} ms")
    torch.cuda.empty_cache()
    return total, max_err


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

    rates_in_turns(torch, {"kernels": (state, ghost.steps["auto"]),
                           "fused=False": (state, ghost.steps[False])},
                   images, labels, mask)


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
    backward alone (the batch-norm kernels are held to the written-out
    path in phase 2g and the card tests)."""
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
    largest first; the window opens with a marker kernel, as in
    :func:`kernels_of`."""
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
                print(f"evaluate {loss}{suffix} {split}: {rows} rows in "
                      f"{w['seconds']:.3f} s, {rows / w['seconds']:.1f} "
                      f"imgs/s (host clock, get_arrays at batch {batch}; "
                      f"{card})")
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


def predict_cli_phase(inference, best, val_arr, card):
    """Phase 9, item 2: ``script.predict.main`` in-process on 600
    placeholder paths with the synthetic reader, streamed and serial,
    then with ``--threshold-at-fpr``; the pinned staging against pageable
    host buffers, in turns."""
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
        t0 = time.perf_counter()
        rc = predict.main(
            [str(best), "auto", str(listing), "--imagenet-directory",
             str(root), "--reader", "synthetic", "--device", "cuda",
             "--image-size", str(IMAGE),
             "--batch-size", str(PREDICT_BATCH), "--features-output",
             str(npz), "-o", str(out), *extra])
        seconds = time.perf_counter() - t0
        check(rc == 0, f"predict {tag}: exit code {rc}")
        return out, np.load(npz), seconds

    streamed, s_npz, s_sec = run("streamed")
    serial, n_npz, n_sec = run("serial", "--no-stream")
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
          f"batch {PREDICT_BATCH}, synthetic reader: streamed "
          f"{PREDICT_PATHS / s_sec:.1f} imgs/s ({s_sec:.3f} s), serial "
          f"{PREDICT_PATHS / n_sec:.1f} imgs/s ({n_sec:.3f} s), the model "
          f"load included (host clock; {card}); CSVs byte-equal, archives' "
          "arrays byte-equal, every row bit-equal to predict()")

    fpr, f_npz, _ = run("calibrated", "--threshold-at-fpr", "0.1",
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

    # The pinned staging buffer against a pageable one, in turns.
    pageable = lambda shape, device: np.empty(shape, np.uint8)
    pinned = inference._host_buffer
    turns = []
    try:
        for name, buffer in (("pinned", pinned), ("pageable", pageable),
                             ("pageable", pageable), ("pinned", pinned)):
            inference._host_buffer = buffer
            pred._reader = reader
            t0 = time.perf_counter()
            for _ in pred.predict_stream(paths, batch_size=PREDICT_BATCH):
                pass
            stream_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(0, PREDICT_PATHS, PREDICT_BATCH):
                pred.predict(paths[i:i + PREDICT_BATCH])
            serial_s = time.perf_counter() - t0
            turns.append(f"{name} {PREDICT_PATHS / stream_s:.1f} / "
                         f"{PREDICT_PATHS / serial_s:.1f}")
    finally:
        inference._host_buffer = pinned
    print(f"predict_stream / serial predict(), imgs/s at batch "
          f"{PREDICT_BATCH}, host staging in turns: {'; '.join(turns)} "
          f"(host clock; {card})")
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
        predict_cli_phase(inference, best, val_arr, card)
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

I8_CHECK_BATCH = 4        # the per-shape checks against the plain version
I8_TIMED_BATCH = 256      # the per-shape times
I8_LINE_SHAPE = (56, 64, 64, 3, 1)   # the kernels line: stage-1 3x3 conv
I8_CONVS = 52             # QuantConvs in one resnet50 forward
# Shapes beside resnet50's: (batch, H, cin, cout, kernel, stride, groups):
# ragged M and channel counts, and the grouped convs of resnext50_32x4d's
# four stages (4, 8, 16 and 32 channels a group: the SIMT route).
I8_EXTRA = [(3, 13, 64, 64, 3, 1, 1), (5, 9, 64, 256, 3, 2, 1),
            (1, 7, 128, 72, 1, 1, 1), (2, 11, 96, 40, 1, 1, 1),
            (2, 56, 128, 128, 3, 1, 32), (2, 56, 256, 256, 3, 2, 32),
            (2, 28, 256, 256, 3, 1, 32), (2, 28, 512, 512, 3, 2, 32),
            (2, 14, 512, 512, 3, 1, 32), (2, 14, 1024, 1024, 3, 2, 32),
            (2, 7, 1024, 1024, 3, 1, 32)]
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


def i8_operands(torch, b, h, cin, cout, k, groups, seed, extreme=False):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (b, h, h, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (cout, k, k, cin // groups)).astype(np.int8)
    if extreme:  # the largest sums, and channels that are all zero
        q[...] = 127
        w[...] = -127
        q[..., ::5] = 0
        w[::3] = 0
    scale = (rng.random(cout) * 1e-4 + 1e-6).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (q, w, scale, bias)]


def im2col(torch, q, k, stride, padding):
    """``[M, k*k*C]`` rows of an NHWC int8 tensor, in the kernel's (tap,
    channel) order: a view for a 1x1 stride-1 conv, else a copy."""
    if k == 1 and stride == 1:
        return q.view(-1, q.shape[-1])
    qp = torch.nn.functional.pad(q, (0, 0, padding, padding, padding,
                                     padding))
    cols = qp.unfold(1, k, stride).unfold(2, k, stride)
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(-1, k * k * q.shape[-1])


def int_mm(torch, cols, w):
    """cuBLASLt's int8 GEMM of the im2col rows and the weight, [M, Cout]
    int32.  The weight goes in as its transposed view (no copy): the
    ``[Cout, K]`` rows are the column-major ``[K, Cout]`` operand."""
    return torch._int_mm(cols, w.view(w.shape[0], -1).t())


def int8_checks(torch, ic):
    """Phase 10, item 1: ``int8_conv`` against its plain version bit for
    bit, and timed with its yardsticks.  Returns the kernels line's
    numbers."""
    from openset_imagenet_tpu_torch.tools import _card

    card = _card.card_line()
    shapes = ic.resnet50_shapes(IMAGE)
    check(sum(shapes.values()) == 52, f"resnet50 QuantConvs: {shapes}")
    cases = [(I8_CHECK_BATCH, *shape, 1) for shape in sorted(shapes)]
    cases += I8_EXTRA
    n = 0
    for i, (b, h, cin, cout, k, s, g) in enumerate(cases):
        for extreme in (False, True):
            q, w, scale, bias = i8_operands(torch, b, h, cin, cout, k, g,
                                            seed=i, extreme=extreme)
            pad = 1 if k == 3 else 0
            for dtype in (torch.bfloat16, torch.float32):
                got = ic.int8_conv(q, w, scale, bias, s, pad, g, dtype)
                want = ic.int8_conv_plain(q, w, scale, bias, s, pad, g,
                                          dtype)
                check(torch.equal(got, want),
                      f"int8_conv {(b, h, cin, cout, k, s, g)} {dtype} "
                      f"extreme={extreme}: max |d| "
                      f"{(got.float() - want.float()).abs().max()}")
                n += 1
            if g == 1 and not extreme:
                acc = ic.int8_conv_acc_plain(q, w, s, pad, g)
                mm = int_mm(torch, im2col(torch, q, k, s, pad), w)
                check(torch.equal(mm, acc.view(-1, cout)),
                      f"torch._int_mm over im2col {(h, cin, cout, k, s)}: "
                      "int32 sums differ from the plain version's")
    print(f"int8_conv: {n} cases bit-equal to the plain version (every "
          f"resnet50 QuantConv shape at batch {I8_CHECK_BATCH}, ragged and "
          "grouped shapes, extreme operands, bf16 and float32 out); "
          "torch._int_mm over an im2col gives the plain version's int32 "
          "sums at every resnet50 shape")
    q, w, _, _ = i8_operands(torch, 1, 4, 8, 8, 1, 1, seed=0)
    try:
        y = torch.nn.functional.conv2d(q.permute(0, 3, 1, 2),
                                       w.permute(0, 3, 1, 2))
        print(f"F.conv2d on int8 CUDA tensors returns {y.dtype}")
    except RuntimeError as err:
        print(f"F.conv2d on int8 CUDA tensors raises: {str(err)[:160]}")

    print(f"int8_conv per resnet50 QuantConv shape at batch "
          f"{I8_TIMED_BATCH}, device µs a call from CUDA-graph replays "
          f"({card}): kernel / bound (by) / torch._int_mm GEMM alone / "
          "im2col + _int_mm / cuDNN bf16 conv, channels_last")
    line = {}
    forward = {"kernel": 0.0, "bound": 0.0, "gemm": 0.0, "im2col_gemm": 0.0,
               "cudnn": 0.0}
    for shape in sorted(shapes, key=lambda t: (-t[0], t[1], t[2])):
        h, cin, cout, k, s = shape
        pad = 1 if k == 3 else 0
        q, w, scale, bias = i8_operands(torch, I8_TIMED_BATCH, h, cin, cout,
                                        k, 1, seed=h + cin)
        route = ic._plan(cin, cout, 1, True)
        ms = graph_ms(lambda: ic.int8_conv(q, w, scale, bias, s, pad),
                      calls=10, reps=10)
        # The timed operands, held to the plain version bit for bit.
        got = ic.int8_conv(q, w, scale, bias, s, pad)
        want = ic.int8_conv_plain(q, w, scale, bias, s, pad)
        err = (got.float() - want.float()).abs().max().item()
        check(torch.equal(got, want),
              f"int8_conv {shape} at batch {I8_TIMED_BATCH}: max |d| {err}")
        del got, want
        nbytes, ops = ic.traffic(I8_TIMED_BATCH, h, h, cin, cout, k, s, pad,
                                 1)
        bound, bound_by = _card.bound_ms(nbytes, ops, _card.INT8_OP_PER_S)
        cols = im2col(torch, q, k, s, pad)
        gemm = graph_ms(lambda: int_mm(torch, cols, w), calls=10, reps=10)
        both = graph_ms(lambda: int_mm(torch, im2col(torch, q, k, s, pad),
                                       w), calls=10, reps=10)
        del cols
        x = torch.randn(I8_TIMED_BATCH, cin, h, h, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wb = torch.randn(cout, cin, k, k, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        cudnn = graph_ms(lambda: torch.nn.functional.conv2d(
            x, wb, None, s, pad), calls=10, reps=10)
        del x, wb
        count = shapes[shape]
        for key, v in (("kernel", ms), ("bound", bound), ("gemm", gemm),
                       ("im2col_gemm", both), ("cudnn", cudnn)):
            forward[key] += count * v
        print(f"  H {h} {cin}->{cout} {k}x{k}/{s} ({count} a forward, "
              f"{route}): {ms * 1e3:.1f} / {bound * 1e3:.1f} ({bound_by}, "
              f"{ops / ms / 1e9:.0f} TOP/s, {bound / ms:.2f} of bound) / "
              f"{gemm * 1e3:.1f} / {both * 1e3:.1f} / {cudnn * 1e3:.1f}")
        if shape == I8_LINE_SHAPE:
            line = {"ms": ms, "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": both, "gemm_ms": gemm, "max_abs_err": err}
            line["plain_ms"] = graph_ms(
                lambda: ic.int8_conv_plain(q, w, scale, bias, s, pad),
                calls=2, reps=3)
            print(f"  plain version (float64 F.conv2d + eager epilogue) at "
                  f"this shape: {line['plain_ms'] * 1e3:.1f} µs")
        del q, w
    print("  the 52 convs of one forward at batch "
          f"{I8_TIMED_BATCH}, ms: kernel {forward['kernel']:.3f}, bound "
          f"{forward['bound']:.3f}, _int_mm {forward['gemm']:.3f}, im2col "
          f"+ _int_mm {forward['im2col_gemm']:.3f}, cuDNN bf16 "
          f"{forward['cudnn']:.3f}")
    print(f"  each timed call's output at batch {I8_TIMED_BATCH} is "
          "bit-equal to the plain version's on the same operands")
    torch.cuda.empty_cache()
    return line


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


def loss_bound(name, b, c):
    """Least device ms of a loss kernel on [b, c] float32 logits: the
    logits, labels and row mask or weights read once, and the scalars
    (K2: g and the count; K4: g and the weight sum), the outputs written
    once (K1, K3: two sums and the mean; K2, K4: the gradient), against about
    six float32 operations an element outside the tensor cores."""
    from openset_imagenet_tpu_torch.tools import _card

    scalars = {"entropic_fwd": 12, "ce_fwd": 12, "entropic_bwd": 8,
               "ce_bwd": 8}[name]
    logits = 4 * b * c if name.endswith("fwd") else 8 * b * c
    return _card.bound_ms(logits + 8 * b + scalars, 6 * b * c,
                          _card.F32_FLOP_PER_S)


# -- phase 2h: the Swin's window attention ----------------------------------

def sdpa_window_path(torch, qkv, table, ws, shift, heads):
    """The library yardstick: the written-out Swin attention around
    ``F.scaled_dot_product_attention`` (roll, window partition, the bias
    and region mask as one additive bf16 mask padded to a multiple of 8,
    the memory-efficient kernel, the transposes, merge and reverse roll).
    Timed here only; the port never calls it."""
    import torch.nn.functional as F

    from openset_imagenet_tpu_torch.models import swin

    b, h, w, c3 = qkv.shape
    c, n = c3 // 3, ws * ws
    y = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    y = swin.window_partition(y, ws)
    bw = y.shape[0]
    q, k, v = y.view(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1,
                                                           4).unbind(0)
    index = swin.relative_position_index(ws, ws).to(qkv.device)
    bias = table[index].view(n, n, heads).permute(2, 0, 1)
    if shift:
        region = swin.region_mask(h, w, ws, shift).to(qkv.device)
        nw = region.shape[0]
        mask = (region[:, None] + bias[None]).to(qkv.dtype)
        mask = F.pad(mask, (0, -n % 8)).expand(
            bw // nw, -1, -1, -1, -1).reshape(bw, heads, n, -1)[..., :n]
    else:
        mask = F.pad(bias.to(qkv.dtype), (0, -n % 8))[..., :n].unsqueeze(0)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         scale=(c // heads) ** -0.5)
    out = swin.window_reverse(out.transpose(1, 2).reshape(bw, n, c), ws, h,
                              w)
    return torch.roll(out, (shift, shift), (1, 2)) if shift else out


# Swin-B's four stages at batch 256: (map side, channels, heads, the shifts
# its blocks take); stage 4's map is one window, so its blocks never shift.
WA_STAGES = {"stage1": (56, 128, 4, (0, 3)), "stage2": (28, 256, 8, (0, 3)),
             "stage3": (14, 512, 16, (0, 3)), "stage4": (7, 1024, 32, (0,))}
WA_TIMED = ("stage1", "stage3")   # timed shifted by 3


def window_attention_checks(torch, wak):
    """Phase 2h: the window-attention kernels at Swin-B's four stage
    shapes, batch 256, bf16, with every shift the main path gives each
    stage (0 and 3; stage 4 only 0): output, qkv gradient and table
    gradient against the plain version (the card tests' tolerances), the
    backward twice with the same bits.  Then, at stages 1 and 3 shifted
    by 3, cold and in turns, the forward and the forward + backward of the
    kernels, of the plain version and of the SDPA path they replace,
    beside the bytes bound (q, k, v read and the output written forward;
    q, k, v and the output's gradient read and dq, dk, dv written
    backward; the log-sum-exp both ways).  Returns the timed lines and,
    under ``max_abs_err``, the largest absolute error of every check."""
    from openset_imagenet_tpu_torch.tools import _card

    gen = torch.Generator(device="cuda").manual_seed(SEED + 400)
    rel = lambda a, b: float((a.float() - b.float()).norm()
                             / max(float(b.float().norm()), 1e-30))
    lines, max_err = {}, 0.0
    for label, (side, c, heads, shifts) in WA_STAGES.items():
        b, ws = 256, 7
        qkv = torch.randn(b, side, side, 3 * c, generator=gen,
                          device="cuda").to(torch.bfloat16)
        table = torch.randn(169, heads, generator=gen, device="cuda") * 0.5
        grad = torch.randn(b, side, side, c, generator=gen,
                           device="cuda").to(torch.bfloat16)

        def run(fn, shift, backward=True):
            x = qkv.detach().requires_grad_(backward)
            t = table.detach().requires_grad_(backward)
            out = fn(x, t, ws, shift)
            if not backward:
                return out, None, None
            out.backward(grad)
            return out.detach(), x.grad, t.grad

        sdpa = lambda x, t, w_, s_: sdpa_window_path(torch, x, t, w_, s_,
                                                     heads)
        for shift in shifts:
            case = f"{label} shift {shift}"
            got = run(wak.window_attention, shift)
            again = run(wak.window_attention, shift)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"window attention {case}: two runs differ")
            want = run(wak.window_attention_plain, shift)
            errs = [rel(a, b) for a, b in zip(got, want)]
            check(errs[0] <= 1e-3 and errs[1] <= 1e-2 and errs[2] <= 1e-5,
                  f"window attention {case}: rel errs {errs}")
            lib_errs = [rel(a, b) for a, b in zip(run(sdpa, shift), want)]
            print(f"window attention {case} [{b}, {side}, {side}, {3 * c}] "
                  f"heads {heads}: rel err against plain out {errs[0]:.2e}, "
                  f"dqkv {errs[1]:.2e}, dtable {errs[2]:.2e}; the SDPA "
                  f"path's {lib_errs[0]:.2e}, {lib_errs[1]:.2e}, "
                  f"{lib_errs[2]:.2e}")
            max_err = max([max_err] + [float((a.float() - b.float()).abs()
                                             .max()) for a, b in zip(got,
                                                                     want)])
            del got, again, want
            torch.cuda.empty_cache()
        if label not in WA_TIMED:
            del qkv, table, grad
            torch.cuda.empty_cache()
            continue
        shift = 3
        g = wak._geometry(qkv, table, ws, shift)
        _, lse = wak._forward(qkv, table, g, ws, shift)
        with torch.no_grad():
            fwd = {"kernel": lambda: wak._forward(qkv, table, g, ws, shift),
                   "plain": lambda: run(wak.window_attention_plain, shift,
                                        False),
                   "library": lambda: run(sdpa, shift, False)}
            ms_fwd = _card.cold_in_turns(fwd, reps=5)
        both = {"kernel": lambda: run(wak.window_attention, shift),
                "plain": lambda: run(wak.window_attention_plain, shift),
                "library": lambda: run(sdpa, shift)}
        ms_both = _card.cold_in_turns(both, reps=5)
        ms_bwd = _card.cold_in_turns({"kernel": lambda: wak._backward(
            grad, qkv, table, lse, g, ws, shift)}, reps=5)["kernel"]
        tokens, lse_bytes = b * side * side, lse.numel() * 4
        bound_fwd = _card.bound_ms(tokens * c * 4 * 2 + lse_bytes)[0]
        bound_bwd = _card.bound_ms(tokens * c * 7 * 2 + lse_bytes)[0]
        print(f"window attention {label}: forward kernel "
              f"{ms_fwd['kernel'] * 1e3:.1f} us (bound {bound_fwd * 1e3:.1f},"
              f" {100 * bound_fwd / ms_fwd['kernel']:.0f}%), plain "
              f"{ms_fwd['plain'] * 1e3:.1f}, SDPA path "
              f"{ms_fwd['library'] * 1e3:.1f}; backward kernel "
              f"{ms_bwd * 1e3:.1f} us (bound {bound_bwd * 1e3:.1f}, "
              f"{100 * bound_bwd / ms_bwd:.0f}%); forward + backward kernels "
              f"{ms_both['kernel'] * 1e3:.1f} us, plain "
              f"{ms_both['plain'] * 1e3:.1f}, SDPA path "
              f"{ms_both['library'] * 1e3:.1f} (cold, in turns, "
              f"{_card.card_line()})")
        lines[label] = {"ms": ms_both["kernel"], "plain_ms": ms_both["plain"],
                        "bound_ms": bound_fwd + bound_bwd,
                        "library_ms": ms_both["library"]}
        del qkv, table, grad, lse, fwd, both
        torch.cuda.empty_cache()
    lines["max_abs_err"] = max_err
    return lines


# -- phase 11: the Swin through the worker ------------------------------------

SWIN_WINDOWS = 2 * 64 + 2 * 16 + 18 * 4 + 2 * 1  # an image's, a swin_b forward


def swin_phase(torch, fl, out_dir):
    """Phase 11: four swin_b train steps through ``worker(cfg)``, the
    attention path's counts and kernels, the checkpoint rebuilt as a Swin
    by the predictor."""
    import shutil

    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.checkpoint import read_metadata
    from openset_imagenet_tpu_torch.inference import OpenSetPredictor
    from openset_imagenet_tpu_torch.models import swin
    from openset_imagenet_tpu_torch.ops import window_attention as wak

    write_index(out_dir)
    write_val_index(out_dir)
    shutil.rmtree(out_dir / "worker" / "swin", ignore_errors=True)
    arch = {"arch": "swin", "variant": "swin_b"}
    cfg = worker_cfg(out_dir, "swin", batch=BATCH, epochs=1, model=arch,
                     max_steps=4)
    for counts in (fl.LAUNCHES, swin.COUNTS, wak.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    info = engine.worker(cfg)
    seconds = time.perf_counter() - t0
    counts = dict(swin.COUNTS)
    launches = dict(wak.LAUNCHES)
    print(f"swin worker: info {info}, {seconds:.2f} s (host clock, with "
          f"set-up), peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"at batch {BATCH}, counts {counts}, launches {dict(fl.LAUNCHES)}"
          f", window attention {launches}")
    check(info["stopped_mid_epoch"] == 4, f"swin: {info}")
    check(counts == {"attention_calls": 4 * 24,
                     "windows": 4 * BATCH * SWIN_WINDOWS},
          f"swin: attention counts {counts}")
    check(launches == {"win_attn_fwd": 4 * 24, "win_attn_bwd": 4 * 24},
          f"swin: window-attention launches {launches}")
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
    check(not any("roll_cuda_kernel" in k for k in kernels),
          "swin: torch.roll's kernel ran")
    del predictor, model
    torch.cuda.empty_cache()
    return launches


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
    from openset_imagenet_tpu_torch.ops import window_attention as wak
    from openset_imagenet_tpu_torch.tools import _card
    from openset_imagenet_tpu_torch.tools.bench_split_site import (
        function_bytes, function_flops)

    out_dir = REPO / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    print(_card.card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    # nvcc builds K5, K6 and int8_conv side by side while Triton builds
    # K1-K4 for their checks against the plain versions.  The checks that
    # count launches with the profiler come after the builds and the
    # libraries' loading: run beside them, a profiler window lost an event.
    t_build = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(_build.build, m.SOURCE, name)
                  for m, name in ((fbb, "fused_block_bwd"),
                                  (ss, "split_site"), (ic, "int8_conv"))]
        t0 = time.perf_counter()
        max_err, timing, library = kernel_checks(torch, fl)
        for build in builds:
            build.result()
    fbb._library()
    ss._library()
    ic._library()
    print(f"K5, K6 and int8_conv built by nvcc, in parallel, within "
          f"{time.perf_counter() - t_build:.1f} s")
    one_launch_checks(torch, fl)
    grad_err, grad_timing = grad_kernel_checks(torch, fl)
    max_err.update(grad_err)
    timing.update(grad_timing)
    print(f"phase kernels: ok ({time.perf_counter() - t0:.1f} s incl. "
          "Triton builds)")
    t0 = time.perf_counter()
    k5_err, k5_timing = k5_checks(torch, fbb)
    print(f"phase K5: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    k6_err, k6_timing = k6_checks(torch, ss, fbb)
    print(f"phase K6: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    k7_err, k7_timing = k7_checks(torch, sp)
    print(f"phase K7: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    i8_line = int8_checks(torch, ic)
    print(f"phase int8_conv: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    bn_total, bn_err = bn_checks(torch, bnk)
    print(f"phase batch-norm: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    wa_lines = window_attention_checks(torch, wak)
    print(f"phase window attention: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    tool_launches = tool_runs()
    print(f"launches on the tools' path: {tool_launches}")
    print(f"phase tools: ok ({time.perf_counter() - t0:.1f} s)")
    # Every graph_ms call warms up on a stream of its own, and cuBLAS keeps
    # a workspace for each stream it ran on (32 MiB on this card): free
    # those the timed plain versions left, so the peak memory that phases
    # 5 and 6 report is the train path's.
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()

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
    swin_launches = swin_phase(torch, fl, out_dir)
    print(f"phase swin: ok ({time.perf_counter() - t0:.1f} s)")

    # Bounds at the shapes the times were taken at.
    replaces = {"entropic_fwd": (39, 256, 116),
                "entropic_bwd": (69, 256, 116),
                "ce_fwd": (172, 64, 117), "ce_bwd": (191, 64, 117)}
    kernels = []
    for name, (line, b, c) in replaces.items():
        bound, bound_by = loss_bound(name, b, c)
        kernels.append({
            "name": name, "route": "triton",
            "source": "openset_imagenet_tpu_torch/ops/triton_fused_loss.py",
            "replaces": f"openset_imagenet_tpu/ops/fused_loss.py:{line}",
            "launches": (launches[name] + train_launches[name]
                         + fused_launches[name] + worker_launches[name]),
            "max_abs_err": max_err[name], "ms": timing[name][0],
            "plain_ms": timing[name][1], "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library.get(name)})
    # K5 and K6 at the resnet50 stage-1 tail site (the tools' shape).
    site_bound, site_by = _card.bound_ms(function_bytes(802816, 64, 256),
                                         function_flops(802816, 64, 256))
    kernels.append({
        "name": "fused_block_bwd", "route": "cuda",
        "source": "openset_imagenet_tpu_torch/csrc/fused_block_bwd.cu",
        "replaces": "openset_imagenet_tpu/experimental/fused_block.py:111",
        "launches": (fused_launches["fused_block_bwd"]
                     + worker_launches["fused_block_bwd"]),
        "max_abs_err": k5_err,
        "ms": k5_timing[0], "plain_ms": k5_timing[1], "bound_ms": site_bound,
        "bound_by": site_by, "library_ms": None})
    kernels.append({
        "name": "split_site", "route": "cuda",
        "source": "openset_imagenet_tpu_torch/csrc/split_site.cu",
        "replaces": "openset_imagenet_tpu/experimental/split_site.py:73",
        "launches": tool_launches["split_site"], "max_abs_err": k6_err,
        "ms": k6_timing[0], "plain_ms": k6_timing[1], "bound_ms": site_bound,
        "bound_by": site_by, "library_ms": None})
    stream_bound, stream_by = _card.bound_ms(3 * 8 * 3136 * 256 * 2)
    for name, line in (("stream_axpy", 69), ("stream_relu_mask", 96)):
        kernels.append({
            "name": name, "route": "triton",
            "source": "openset_imagenet_tpu_torch/ops/triton_stream_probe.py",
            "replaces": f"tools/bench_pallas_stream.py:{line}",
            "launches": tool_launches[name], "max_abs_err": k7_err[name],
            "ms": k7_timing[name][0], "plain_ms": k7_timing[name][1],
            "bound_ms": stream_bound, "bound_by": stream_by,
            "library_ms": k7_timing[name][2]})
    kernels.append({
        "name": "int8_conv", "route": "cuda",
        "source": "openset_imagenet_tpu_torch/csrc/int8_conv.cu",
        "replaces": "openset_imagenet_tpu/models/quant.py:86",
        "launches": opt_launches["int8_conv"],
        "max_abs_err": i8_line["max_abs_err"], "ms": i8_line["ms"],
        "plain_ms": i8_line["plain_ms"], "bound_ms": i8_line["bound_ms"],
        "bound_by": i8_line["bound_by"],
        "library_ms": i8_line["library_ms"]})
    # The batch-norm kernels, each summed over a resnet50 step's 53
    # shapes at batch 256 (phase 2g): bn_apply timed in its eval form,
    # its error over both forms.
    for name, key, launches_of in (("bn_stats", "stats", "bn_stats"),
                                   ("bn_apply", "eval", "bn_apply"),
                                   ("bn_backward", "backward", "bn_bwd")):
        t = bn_total[key]
        kernels.append({
            "name": name, "route": "triton",
            "source": "openset_imagenet_tpu_torch/ops/triton_batch_norm.py",
            "replaces": "none: the written-out batch-norm of "
                        "openset_imagenet_tpu_torch/models/norm.py",
            "launches": bn_launches[launches_of],
            "max_abs_err": bn_err[name], "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": t["bound"],
            "bound_by": "bytes", "library_ms": t["library"]})
    # The window attention, forward and backward, timed at Swin-B's
    # stage-1 shape at batch 256, its error the largest of phase 2h's
    # checks at the four stages; launches those of phase 11's worker.
    wa = wa_lines["stage1"]
    kernels.append({
        "name": "window_attention", "route": "triton",
        "source": "openset_imagenet_tpu_torch/ops/triton_window_attention.py",
        "replaces": "none: F.scaled_dot_product_attention and the roll, "
                    "partition, mask and merge copies of the Swin's "
                    "written-out window attention",
        "launches": sum(swin_launches.values()),
        "max_abs_err": wa_lines["max_abs_err"], "ms": wa["ms"],
        "plain_ms": wa["plain_ms"], "bound_ms": wa["bound_ms"],
        "bound_by": "bytes", "library_ms": wa["library_ms"]})
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was not launched on its path: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
