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
   unfused model on the same weights.  Checks: finite losses, running
   statistics that moved, >= 32 K5 launches per step, the loss falling
   over eight steps on one batch; from one state (cuDNN deterministic)
   two kernel steps bitwise equal, the kernel against the plain site
   (``use_kernel=False``: parameter gradients within 2e-2 in norm), the
   fused model against the unfused one (bf16: loss within 1e-2, gradients
   within 5e-2 in norm, the two backwards rounding in other places;
   float32 at batch 64, ghost-16, no TF32: gradients within 1e-3).
   Prints train-step imgs/s of both forms in turns and their peak memory.

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
bit for bit against their plain versions at bf16 [8, 3136, 256] and a
ragged row count, with their times and ``torch.add``'s, taken over four
operand pairs in turn so that the 50 MB L2 holds none of them.  Phase 2e
runs the two ported bench tools as the entry points they are, each in its own
process with few iterations (``python -m openset_imagenet_tpu_torch.
tools.bench_split_site --iters 2``, ``...bench_stream --iters 3``), and
checks their JSON lines: the cases, finite numbers, the card, K6's four
kernels in the split case's profile, and that their kernel cases
launched K5, K6 and K7 (each tool reports the launches of its cases; a
fresh process starts from zero counts).

The launch counts are zeroed just before phase 3 and read after phase 4
(the serving path), zeroed again before phase 5's epochs and read after
them (the train path), and again around phase 6's epoch and validation
(the fused train path): each path must have launched its kernels.
Float32 matmuls and convolutions run without TF32 (both backend flags
off), so float32 comparisons on the card are exact float32.

The second-to-last line is ``{"kernels": [...]}``: for each of the eight
ported kernels its launches on its path, max |err| against the plain
version, device ms of the kernel and of the plain version, the least time
the card could take at the same shape (``bound_ms``, set by ``bytes`` or
``operations``: NVIDIA's H100 peaks, ``openset_imagenet_tpu_torch/tools/
_card.py``) and the time of one PyTorch call computing the same function
where there is one (``library_ms``: ``F.cross_entropy`` for K3,
``torch.add`` for K7's axpy; else null).  The last line is ``{"ok": true,
"device": {...}}``.  Any failed check raises, so the exit code is non-zero
and no result line is printed.  Without a CUDA device the script exits
non-zero at once.  Build outputs (Triton's cache, the K5 and K6
libraries, the checkpoint) go to ``build/`` in the checkout.
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
    # Captured on the warmed stream: K1's and K3's ticket counters exist.
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return time_ms(graph.replay, reps=reps, warmup=2) / calls


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
    return max_err, timing, library


def kernels_of(torch, fn, calls):
    """Names of the kernels ``calls`` calls of ``fn`` launch, from
    ``torch.profiler``.  A window can miss its first launch, so each opens
    with a marker kernel (``torch.cuda._sleep``, left out of the names);
    and a window can come back empty, so the fullest of three counts (a
    window never holds a kernel that did not run)."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    for _ in range(3):
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


def k7_checks(torch, sp):
    """K7 against its plain versions, bit for bit; returns (max_err,
    {name: (kernel, plain, library or None) device ms at [8, 3136, 256]})."""
    import itertools

    max_err, timing = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 200)
    draw = lambda shape: (torch.randn(*shape, generator=gen, device="cuda")
                          .to(torch.bfloat16))
    runs = {"stream_axpy": (sp.axpy, sp.axpy_plain,
                            lambda x, b: torch.add(b, x, alpha=sp.AXPY_A)),
            "stream_relu_mask": (sp.relu_mask, sp.relu_mask_plain, None)}
    for shape in K7_SHAPES:
        a, b = draw(shape), draw(shape)
        for name, (kernel, plain, library) in runs.items():
            got, again = kernel(a, b), kernel(a, b)
            torch.cuda.synchronize()
            ref = plain(a, b)
            check(torch.equal(got, again), f"{name} {shape}: two launches "
                  "differ")
            check(got.dtype == torch.bfloat16 and torch.equal(got, ref),
                  f"{name} {shape}: not bit-equal to the plain version")
            max_err[name] = max(max_err.get(name, 0.0), float(
                (got.float() - ref.float()).abs().max()))
    # Timed over four operand pairs in turn (103 MB, twice the L2), so each
    # call reads its operands from device memory.
    pairs = [(draw(K7_SHAPES[0]), draw(K7_SHAPES[0])) for _ in range(4)]
    for name, fns in runs.items():
        turns = [itertools.cycle(pairs) for _ in fns]
        timing[name] = tuple(
            graph_ms(lambda fn=fn, t=t: fn(*next(t))) if fn else None
            for fn, t in zip(fns, turns))
    for name, (k, p, lib) in timing.items():
        print(f"K7 {name} [8,3136,256] bf16: dev_ms {k:.5f} plain {p:.5f} "
              f"library {'-' if lib is None else f'{lib:.5f}'}")
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


def unfused_twin(torch, fused_model, n_classes, ghost, dtype):
    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace

    model = engine.build_model(NameSpace({"model": {
        "variant": VARIANT, "bn_stats_rows": ghost}}), n_classes, dtype=dtype)
    model.load_state_dict(fused_model.state_dict())
    return model.to(memory_format=torch.channels_last)


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
    sl = slice(0, BATCH)
    for rows in (16, BATCH):
        f32 = engine.build_model(NameSpace({"model": {
            "variant": VARIANT, "bn_stats_rows": rows, "fused_blocks": True,
            "boundary_mask": True}}), N_CLASSES, dtype=torch.float32)
        f32 = f32.to(memory_format=torch.channels_last)
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


def main():
    import concurrent.futures

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from openset_imagenet_tpu_torch.experimental import split_site as ss
    from openset_imagenet_tpu_torch.ops import _build
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb
    from openset_imagenet_tpu_torch.ops import fused_loss as fl
    from openset_imagenet_tpu_torch.ops import stream_probe as sp
    from openset_imagenet_tpu_torch.tools import _card
    from openset_imagenet_tpu_torch.tools.bench_split_site import (
        function_bytes, function_flops)

    out_dir = REPO / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    print(_card.card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    # nvcc builds K5 and K6 side by side while Triton builds K1-K4 for
    # their checks against the plain versions.  The checks that count
    # launches with the profiler come after the builds and the libraries'
    # loading: run beside them, a profiler window lost an event.
    t_build = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(_build.build, m.SOURCE, name)
                  for m, name in ((fbb, "fused_block_bwd"),
                                  (ss, "split_site"))]
        t0 = time.perf_counter()
        max_err, timing, library = kernel_checks(torch, fl)
        for build in builds:
            build.result()
    fbb._library()
    ss._library()
    print(f"K5 and K6 built by nvcc, in parallel, within "
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
    del ghost
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    run, twin, fused_launches = train_fused(torch, fl, fbb,
                                            out_dir / "p1_train.csv")
    fused_checks(torch, run, twin, GHOST)
    print(f"phase fused train: ok ({time.perf_counter() - t0:.1f} s)")

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
                         + fused_launches[name]),
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
        "launches": fused_launches["fused_block_bwd"], "max_abs_err": k5_err,
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
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was not launched on its path: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
