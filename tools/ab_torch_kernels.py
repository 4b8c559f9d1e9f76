#!/usr/bin/env python3
"""The loss kernels, K5, K6, int8_conv, the LayerNorm junction and the train
step of two checkouts of the PyTorch port, in turns.

    python tools/ab_torch_kernels.py --parent build/parent [--steps 10] \
        [--only layer_norm,k5]

``--parent`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive <commit> | tar -x -C build/parent``;
``build/`` is git-ignored).  The script runs one process per turn, in the
order parent, change, change, parent (the change is this checkout), each
importing ``openset_imagenet_tpu_torch`` from its own tree and building
its kernels there, so both versions run on one card in one call.  Each
turn measures, on the card:

* K3 (``ops.fused_loss.ce_sums``) at [64, 117] and [256, 117], float32
  logits: device µs per call from a CUDA-graph replay of 20 calls, beside
  ``F.cross_entropy(weight=..., reduction="sum")`` on the same inputs;
* the entropic loss, float32 logits, labels from -1: K1 (``entropic_sums``)
  at [64, 116] and [256, 116]; K2 (``entropic_grad``) at [256, 116], given
  the cotangent and the count where the checkout's K2 takes them and the
  scale torch computes from them where it takes a scale; and
  ``entropic_openset_loss_fused`` forward + ``torch.autograd.grad`` at
  [256, 116], the loss's whole train-step work: device µs per call from
  graph replays of 20 calls, and the kernels one eager call launches
  (``torch.profiler``);
* the weighted CE behind the softmax and garbage losses, float32 logits,
  labels from 0, class weights: K4 (``ce_grad``) at [64, 117] and [256,
  117], given the cotangent and the weight sum where the checkout's K4
  takes them and the scale torch computes from them where it takes a
  scale; and ``garbage_loss_fused`` forward + ``torch.autograd.grad`` at
  [64, 117], device µs per call from graph replays of 20 calls, and the
  kernels one eager call launches;
* K5 (``ops.fused_block_bwd.bwd_site``) in bfloat16 at every pointwise
  site of resnet50 at 224 px and batch 256: device ms per call from a
  graph replay of 5 calls, inputs drawn on the card from a fixed seed;
* K6 (``experimental.split_site.tail_site_split``) in bfloat16 at the
  resnet50 stage-1 and stage-4 tails at batch 256: device ms per call
  from a graph replay of 5 calls, inputs drawn on the card from a fixed
  seed;
* ``int8_conv`` (``ops.int8_conv.int8_conv``, bfloat16 out) at each
  distinct convolution shape of resnet50 at 224 px and batch 256: device µs
  per call from a graph replay of 10 calls, int8 operands drawn on the card
  from a fixed seed, beside the card's bound for its bytes and int8
  operations (``tools._card.bound_ms`` at ``INT8_OP_PER_S``); and the 52
  convolutions of one forward, each shape times its count, in both;
* the Swin's residual junction fused with its LayerNorm
  (``ops.layer_norm``) in bfloat16 at Swin-B's stage 1 ([802816, 128])
  and stage 3 ([50176, 512]) at batch 256: device µs per call of the
  forward (``add_layer_norm``) and of the backward kernel (given the
  gradients of ``n`` and ``h``) from graph replays of 20 calls, beside
  the bound of their bytes (read ``x`` and ``y``, write ``h`` and ``n``;
  read the two gradients and ``h``, write ``dh``; the statistics) and
  beside the written-out path the port ran before (the bias and residual
  adds with ``F.layer_norm``; ``native_layer_norm_backward``, the
  gradients' sum, the bias gradient's sum and the casts back to float32),
  which the port no longer calls; nothing in a checkout without
  ``ops.layer_norm``;
* the train step of a full-width resnet50 (116 classes, random weights
  from seed 0, ghost batch-norm over 64 rows, entropic loss, Adam at lr
  1e-3, bfloat16, channels_last, batch 256 of device-resident uint8), in
  the unfused form and with ``model.fused_blocks`` + ``boundary_mask``:
  imgs/s over ``--steps`` steps by the host clock after three warm-up
  steps, then ``torch.profiler`` over three steps for the device-busy ms
  per step and, in the fused form, K5's device ms per step (its kernels:
  ``site_*`` and ``reduce_partials``) and its launches of each kernel.

``--only`` names the groups a turn measures (``k3``, ``entropic``,
``weighted_ce``, ``k5``, ``k6``, ``int8``, ``layer_norm``, ``train``; all by
default).  Each turn prints one JSON line (``{"turn": ..., "root": ...,
...}``); the last lines are a table of every number by turn.  Without a
CUDA device it exits non-zero.
"""

import argparse
import collections
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
# Every pointwise site of resnet50 at 224 px, batch 256: name, M, ci, co,
# form (in_act, mask, ds, gp).
SITES = [
    ("stage1 tail", 802816, 64, 256, "tail"),
    ("stage1 head b1", 802816, 64, 64, "head"),
    ("stage1 head", 802816, 256, 64, "head_ds"),
    ("stage2 head b1", 802816, 256, 128, "head"),
    ("stage2 tail", 200704, 128, 512, "tail"),
    ("stage2 head", 200704, 512, 128, "head_ds"),
    ("stage3 head b1", 200704, 512, 256, "head"),
    ("stage3 tail", 50176, 256, 1024, "tail"),
    ("stage3 head", 50176, 1024, 256, "head_ds"),
    ("stage4 head b1", 50176, 1024, 512, "head"),
    ("stage4 tail", 12544, 512, 2048, "tail"),
    ("stage4 head", 12544, 2048, 512, "head_ds"),
]
FORMS = {"tail": (True, True, False, True), "head_ds": (False, False, True,
                                                         False),
         "head": (False, False, False, False)}
K5_NAME = re.compile(r"site_\w+|reduce_partials")
BATCH = 256


def graph_ms(torch, fn, calls, reps=10):
    """Median device ms of one call, from a CUDA graph of ``calls``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # Captured on the warmed stream: the forwards' ticket counters exist.
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def launches(torch, fn):
    """Kernels one call of ``fn`` launches (``torch.profiler``), after an
    eager call that makes what a first call on this stream makes (the
    forwards' ticket counter).  A window can miss its first launch, so
    each opens with a marker kernel (``torch.cuda._sleep``, not counted);
    and a window can come back empty, so the fullest of three counts."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    count = 0
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        count = max(count, sum(
            1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.name))
    return count


def k3(torch, fl):
    import numpy as np
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    out = {}
    for b, c in ((64, 117), (256, 117)):
        logits = torch.from_numpy((rng.normal(size=(b, c)) * 3).astype(
            np.float32)).cuda()
        labels = torch.from_numpy(rng.integers(0, c, b).astype(np.int32)
                                  ).cuda()
        class_w = torch.from_numpy(rng.uniform(0.2, 2.0, c).astype(
            np.float32)).cuda()
        rows, labels64 = class_w[labels.long()], labels.long()
        out[f"k3_us[{b},{c}]"] = 1e3 * graph_ms(
            torch, lambda: fl.ce_sums(logits, labels, rows), 20)
        out[f"cross_entropy_us[{b},{c}]"] = 1e3 * graph_ms(
            torch, lambda: F.cross_entropy(logits, labels64, weight=class_w,
                                           reduction="sum"), 20)
    return out


def entropic(torch, fl):
    import inspect

    import numpy as np

    rng = np.random.default_rng(1)
    out = {}
    for b in (64, 256):
        logits = torch.from_numpy((rng.normal(size=(b, 116)) * 3).astype(
            np.float32)).cuda()
        labels = torch.from_numpy(rng.integers(-1, 116, b).astype(np.int32)
                                  ).cuda()
        mask = torch.from_numpy((rng.random(b) > 0.2).astype(np.float32)
                                ).cuda()
        out[f"k1_us[{b},116]"] = 1e3 * graph_ms(
            torch, lambda: fl.entropic_sums(logits, labels, mask, 0.5), 20)
    g = torch.tensor(0.37, device="cuda")
    count = mask.sum()
    if "count" in inspect.signature(fl.entropic_grad).parameters:
        args = (g, count)
    else:   # a K2 that takes the scale torch computes
        args = (g / count.clamp(min=1.0),)
    out["k2_us[256,116]"] = 1e3 * graph_ms(
        torch, lambda: fl.entropic_grad(logits, labels, mask, *args, 0.5),
        20)
    logits.requires_grad_()

    def loss():
        mean, _ = fl.entropic_openset_loss_fused(logits, labels, mask, 0.5)
        return torch.autograd.grad(mean, logits, g)

    out["entropic_loss_us[256,116]"] = 1e3 * graph_ms(torch, loss, 20)
    out["entropic_loss_launches"] = float(launches(torch, loss))
    return out


def weighted_ce(torch, fl):
    import inspect

    import numpy as np

    rng = np.random.default_rng(2)
    out = {}
    g = torch.tensor(0.37, device="cuda")
    takes_wsum = "wsum" in inspect.signature(fl.ce_grad).parameters
    for b in (256, 64):
        logits = torch.from_numpy((rng.normal(size=(b, 117)) * 3).astype(
            np.float32)).cuda()
        labels = torch.from_numpy(rng.integers(0, 117, b).astype(np.int32)
                                  ).cuda()
        mask = torch.from_numpy((rng.random(b) > 0.2).astype(np.float32)
                                ).cuda()
        class_w = torch.from_numpy(rng.uniform(0.2, 2.0, 117).astype(
            np.float32)).cuda()
        rows = class_w[labels.long()] * mask
        wsum = rows.sum()
        args = ((g, wsum) if takes_wsum else   # a K4 that takes the scale
                (g / wsum.clamp(min=1e-12),))
        out[f"k4_us[{b},117]"] = 1e3 * graph_ms(
            torch, lambda: fl.ce_grad(logits, labels, rows, *args), 20)
    logits.requires_grad_()

    def loss():
        mean, _ = fl.garbage_loss_fused(logits, labels, class_w, mask)
        return torch.autograd.grad(mean, logits, g)

    out["garbage_loss_us[64,117]"] = 1e3 * graph_ms(torch, loss, 20)
    out["garbage_loss_launches"] = float(launches(torch, loss))
    return out


def k5(torch, fbb):
    out = {}
    for seed, (name, m, ci, co, form) in enumerate(SITES):
        in_act, has_mask, has_ds, emit_gp = FORMS[form]
        gen = torch.Generator(device="cuda").manual_seed(seed)
        draw = lambda *s, dt=torch.bfloat16, scale=1.0: (torch.randn(
            *s, generator=gen, device="cuda") * scale).to(dt)
        mask = (torch.randint(0, 2, (m, co), generator=gen, device="cuda")
                .to(torch.int8) if has_mask else None)
        args = [draw(m, co), draw(m, co), mask, draw(m, ci),
                draw(m, ci) if has_ds else None, draw(ci, co, scale=0.05),
                draw(co, dt=torch.float32), draw(co, dt=torch.float32),
                draw(ci, dt=torch.float32) if in_act else None,
                draw(ci, dt=torch.float32) if in_act else None]
        out[f"k5_ms[{name}]"] = graph_ms(
            torch, lambda: fbb.bwd_site(*args, in_act=in_act,
                                        emit_gp=emit_gp), 5)
        del args, mask
        torch.cuda.empty_cache()
    return out


def k6(torch, ss):
    out = {}
    for seed, (name, m, ci, co) in enumerate((
            ("stage1 tail", 802816, 64, 256), ("stage4 tail", 12544, 512,
                                                2048))):
        gen = torch.Generator(device="cuda").manual_seed(100 + seed)
        draw = lambda *s, dt=torch.bfloat16, scale=1.0: (torch.randn(
            *s, generator=gen, device="cuda") * scale).to(dt)
        mask = torch.randint(0, 2, (m, co), generator=gen,
                             device="cuda").to(torch.int8)
        args = [draw(m, co), draw(m, co), mask, draw(m, ci),
                draw(ci, co, scale=0.05), draw(co, dt=torch.float32),
                draw(ci, dt=torch.float32), draw(ci, dt=torch.float32)]
        out[f"k6_ms[{name}]"] = graph_ms(
            torch, lambda: ss.tail_site_split(*args), 5)
        del args, mask
        torch.cuda.empty_cache()
    return out


def int8(torch, ic):
    from openset_imagenet_tpu_torch.tools import _card

    out, forward, bound = {}, 0.0, 0.0
    shapes = ic.resnet50_shapes(224)
    for (h, cin, cout, k, s), count in sorted(shapes.items()):
        pad = 1 if k == 3 else 0
        gen = torch.Generator(device="cuda").manual_seed(h + cin + cout)
        draw = lambda *shape: torch.randint(
            -127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        q, w = draw(BATCH, h, h, cin), draw(cout, k, k, cin)
        scale = torch.rand(cout, generator=gen, device="cuda") * 1e-4 + 1e-6
        bias = torch.randn(cout, generator=gen, device="cuda")
        key = f"[{h} {cin}->{cout} {k}x{k}/{s}]"
        out[f"int8_us{key}"] = 1e3 * graph_ms(
            torch, lambda: ic.int8_conv(q, w, scale, bias, s, pad), 10)
        out[f"int8_bound_us{key}"] = 1e3 * _card.bound_ms(
            *ic.traffic(BATCH, h, h, cin, cout, k, s, pad, 1),
            _card.INT8_OP_PER_S)[0]
        forward += count * out[f"int8_us{key}"]
        bound += count * out[f"int8_bound_us{key}"]
        del q, w
    out["int8_forward_us"], out["int8_forward_bound_us"] = forward, bound
    torch.cuda.empty_cache()
    return out


def layer_norm(torch):
    import importlib.util

    import torch.nn.functional as F

    from openset_imagenet_tpu_torch.tools import _card

    if importlib.util.find_spec("openset_imagenet_tpu_torch.ops.layer_norm") \
            is None:
        return {}
    from openset_imagenet_tpu_torch.ops import layer_norm as lnk

    out, dt, eps = {}, torch.bfloat16, 1e-5
    for name, rows, c in (("stage1", 802816, 128), ("stage3", 50176, 512)):
        gen = torch.Generator(device="cuda").manual_seed(rows + c)
        draw = lambda *s: torch.randn(*s, generator=gen, device="cuda")
        x, y, gn, gh = (draw(rows, c).to(dt) for _ in range(4))
        b, w, beta = draw(c) * 0.1, draw(c) * 0.3 + 1.0, draw(c) * 0.1
        unit = rows * c * dt.itemsize
        h, n, mean, rstd = lnk._forward(x, w, beta, eps, y, b)
        key = f"[{name} {rows}x{c}]"
        out[f"ln_fwd_us{key}"] = 1e3 * graph_ms(
            torch, lambda: lnk.add_layer_norm(x, y, b, w, beta, eps), 20)
        out[f"ln_bwd_us{key}"] = 1e3 * graph_ms(
            torch, lambda: lnk._backward(gn, gh, h, mean, rstd, w, True), 20)
        for way in ("fwd", "bwd"):
            out[f"ln_{way}_bound_us{key}"] = 1e3 * _card.bound_ms(
                4 * unit + 8 * rows)[0]
        w_dt, beta_dt = w.to(dt), beta.to(dt)

        def written_fwd():
            hh = x + (y + b.to(dt))
            return F.layer_norm(hh, (c,), w.to(dt), beta.to(dt), eps)

        _, tmean, trstd = torch.native_layer_norm(h, (c,), w_dt, beta_dt,
                                                  eps)

        def written_bwd():
            dx, dw, db = torch.ops.aten.native_layer_norm_backward(
                gn, h, (c,), tmean, trstd, w_dt, beta_dt,
                [True, True, True])
            dh = gh + dx
            return dh, dh.sum(0).float(), dw.float(), db.float()

        out[f"written_fwd_us{key}"] = 1e3 * graph_ms(torch, written_fwd, 20)
        out[f"written_bwd_us{key}"] = 1e3 * graph_ms(torch, written_bwd, 20)
        del x, y, gn, gh, h, n
        torch.cuda.empty_cache()
    return out


def train(torch, fused, steps):
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace
    from openset_imagenet_tpu_torch.models.resnet import build_resnet

    model = build_resnet("resnet50", fc_layer_dim=116, out_features=116,
                         bn_stats_rows=64, fused_blocks=fused,
                         boundary_mask=fused,
                         generator=torch.Generator().manual_seed(0))
    model = model.cuda().to(memory_format=torch.channels_last)
    state = engine.create_state(model, engine.build_optimizer(
        NameSpace({"type": "adam", "lr": 1e-3}), 1))
    step = engine.make_train_step(engine.make_loss_fn("entropic",
                                                      fused="auto"))
    rng = np.random.default_rng(BATCH)
    images = torch.from_numpy(rng.integers(0, 256, (BATCH, 224, 224, 3),
                                           np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(-1, 116, BATCH).astype(np.int32)
                              ).cuda()
    mask = torch.ones(BATCH, device="cuda")
    for _ in range(3):
        step(state, images, labels, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, images, labels, mask)
    torch.cuda.synchronize()
    rate = BATCH * steps / (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(state, images, labels, mask)
        torch.cuda.synchronize()
    busy, k5_us, k5_launches = 0.0, 0.0, collections.Counter()
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        busy += us
        name = K5_NAME.search(evt.name)
        if name:
            k5_us += us
            k5_launches[name.group(0)] += 1
    form = "fused" if fused else "unfused"
    out = {f"{form}_imgs_s": rate, f"{form}_busy_ms": busy / 3e3}
    if fused:
        out["k5_ms_per_step"] = k5_us / 3e3
        out["k5_launches_per_step"] = {k: v / 3 for k, v in
                                       sorted(k5_launches.items())}
    del model, state
    torch.cuda.empty_cache()
    return out


GROUPS = ("k3", "entropic", "weighted_ce", "k5", "k6", "int8", "layer_norm",
          "train")


def one_turn(turn, root, steps, only):
    sys.path.insert(0, str(root))
    import torch

    import openset_imagenet_tpu_torch as port

    if not torch.cuda.is_available():
        print("ab_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    here = pathlib.Path(port.__file__).resolve()
    if root.resolve() not in here.parents:
        raise RuntimeError(f"imported {here}, not the port under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from openset_imagenet_tpu_torch.experimental import split_site as ss
    from openset_imagenet_tpu_torch.ops import fused_block_bwd as fbb
    from openset_imagenet_tpu_torch.ops import fused_loss as fl
    from openset_imagenet_tpu_torch.ops import int8_conv as ic

    result = {"turn": turn, "root": str(root),
              "device": torch.cuda.get_device_name(0)}
    groups = {"k3": lambda: k3(torch, fl),
              "entropic": lambda: entropic(torch, fl),
              "weighted_ce": lambda: weighted_ce(torch, fl),
              "k5": lambda: k5(torch, fbb), "k6": lambda: k6(torch, ss),
              "int8": lambda: int8(torch, ic),
              "layer_norm": lambda: layer_norm(torch),
              "train": lambda: {**train(torch, False, steps),
                                **train(torch, True, steps)}}
    for group in only:
        result.update(groups[group]())
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the other checkout (its repository root)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups to measure (default: all)")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = args.only.split(",")
    if set(only) - set(GROUPS):
        ap.error(f"--only takes groups of {GROUPS}, got {args.only}")
    if args.turn:
        return one_turn(args.turn, pathlib.Path(args.root), args.steps, only)

    parent = pathlib.Path(args.parent).resolve()
    if not (parent / "openset_imagenet_tpu_torch").is_dir():
        ap.error(f"{parent} holds no openset_imagenet_tpu_torch package")
    import torch

    if not torch.cuda.is_available():
        print("ab_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    print(card.stdout.strip(), flush=True)
    turns = []
    for turn, root in (("parent", parent), ("change", REPO),
                       ("change", REPO), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--parent", str(parent), "--steps", str(args.steps),
             "--only", args.only, "--turn", turn, "--root", str(root)],
            cwd=root, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode or 1
        turns.append(json.loads(lines[-1]))
        print(lines[-1], flush=True)
    keys = list(dict.fromkeys(k for t in turns for k in t
                              if k not in ("turn", "root", "device")))
    print("metric".ljust(34) + "".join(t["turn"].rjust(14) for t in turns))
    for key in keys:
        cells = []
        for t in turns:
            v = t.get(key)
            cells.append((f"{v:.4f}" if isinstance(v, float) else
                          "-" if v is None else "dict").rjust(14))
        print(key.ljust(34) + "".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
