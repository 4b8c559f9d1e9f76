"""Training traffic: ``train.train_epoch`` over ``pipeline.InputPipeline``,
closed loop, as ``train.worker`` runs them.

Set-up builds one training state (the model from the configuration with
the seeded weights of its family, :mod:`.families`; channels_last on the
card; the entropic loss through
``make_loss_fn(fused="auto")``; Adam), one pipeline over seeded images and
labels (``is_training`` and pinned batches as the worker builds it;
``num_workers`` and ``prefetch`` at the pipeline's defaults) and runs
``warm_steps`` steps through the window's own ``train_epoch`` call. The
window opens after them, at a step boundary, and closes at the first step
boundary ``seconds`` later (both ends after a device sync). With
``--trace 0`` the profiler (device activity only) covers the window on the
card: ``train_gpu_us_per_img`` is the device's busy time in it over every
image trained in it. With ``--trace 1`` the window runs without it, the
reader ``train.imgs_per_s`` takes every image trained in it over its
seconds, and ``trace_steps`` further steps run under the profiler after
the window has closed.

The first three steps are the ones the reference follows: the first
step's logits (a forward hook on the model, removed at once), the norm of
the gradient each leaf's Adam state holds after step 1, each leaf's
change after step 3, each step's loss, and the three batches as
delivered.

Traffic parameters: ``warm_steps`` (at least 4), ``trace_steps``,
``max_imgs_per_s`` (sizes the epoch so the window never waits for a new
one; more epochs follow if it does) and, optionally, ``model`` (options
merged into the configuration's model, such as ``fused_blocks``).
"""

from __future__ import annotations

import math

import numpy as np

from . import compare, data, families, harness, profile

CHECKED_STEPS = 3


class _Feed:
    """The pipeline as ``train_epoch`` sees it, with a ``pipeline.next``
    span around each batch it waits for and copies of the first
    batches."""

    def __init__(self, pipe, spans, keep: int):
        self.pipe, self.spans, self.keep = pipe, spans, keep
        self.kept = []

    def __len__(self):
        return len(self.pipe)

    def epoch(self, epoch: int = 0, start_batch: int = 0):
        it = self.pipe.epoch(epoch, start_batch=start_batch)
        try:
            while True:
                with self.spans.span("pipeline.next"):
                    batch = next(it, None)
                if batch is None:
                    return
                if len(self.kept) < self.keep:
                    self.kept.append(tuple(np.array(a) for a in batch))
                yield batch
        finally:
            it.close()


def run(ctx: harness.Ctx) -> harness.Result:
    import torch

    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.config import NameSpace
    from openset_imagenet_tpu_torch.ops.losses import AverageMeter
    from openset_imagenet_tpu_torch.pipeline import InputPipeline

    cfg, tr, dev, spans = ctx.config, ctx.traffic, ctx.device, ctx.spans
    batch = int(cfg["batch"])
    warm = max(int(tr["warm_steps"]), CHECKED_STEPS + 1)
    trace_steps = int(tr.get("trace_steps", 3)) if ctx.trace else 0
    steps_cap = warm + trace_steps + math.ceil(
        ctx.seconds * float(tr["max_imgs_per_s"]) / batch)
    n = steps_cap * batch
    with spans.span("setup.data"):
        images = data.Images(ctx.seed, n, int(cfg["image_size"]))
        labels = data.labels(ctx.seed, n, int(cfg["n_classes"]),
                             float(cfg["negative_share"]))

    family = families.of(cfg)
    model_opts = {**family.model_options(cfg), **tr.get("model", {})}
    with spans.span("setup.model"):
        model = engine.build_model(NameSpace({"model": model_opts}),
                                   int(cfg["n_classes"]), device="meta")
        model.to_empty(device=dev)
        w0 = family.make_weights(cfg, ctx.seed, dev)
        model.load_state_dict(w0, strict=True)
        if dev.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
    named = list(model.named_parameters())
    first_logits = []

    def keep_logits(module, inputs, output):
        first_logits.append(output[0].detach().float().cpu())
        hook_handle.remove()

    hook_handle = model.register_forward_hook(keep_logits)
    loss_fn = engine.make_loss_fn(cfg["loss"], fused="auto")
    pipe = InputPipeline([str(j) for j in range(n)], labels, batch,
                         is_training=True, seed=ctx.seed,
                         reader=data.Reader(images),
                         pin_memory=dev.type == "cuda")
    tx = engine.build_optimizer(
        NameSpace({"type": cfg["optimizer"], "lr": float(cfg["lr"])}),
        steps_per_epoch=len(pipe))
    state = engine.create_state(model, tx)
    train_step = engine.make_train_step(loss_fn)
    tail_step = engine.make_tail_step(loss_fn, model, n % batch, train_step)
    feed = _Feed(pipe, spans, CHECKED_STEPS)
    trackers = {"j": AverageMeter(), "imgs/s": AverageMeter()}
    beta1 = state.optimizer.param_groups[0].get("betas", (0.9, 0.999))[0]

    run_state = {"done": 0, "t0": None, "t1": None, "setup": None,
                 "window_steps": 0, "trace": None, "until": None,
                 "finished": False, "trace_s": None, "window_trace": None}
    losses, prog_g1, prog_change = [], {}, {}

    def step(state, images_, labels_, mask_):
        with spans.span("train_step"):
            state, m = train_step(state, images_, labels_, mask_)
        if len(losses) < CHECKED_STEPS:
            losses.append((m["loss_sum"].detach().float()
                           / m["count"]).clone())
        run_state["done"] += 1
        return state, m

    def hook(state, _):
        rs = run_state
        done = rs["done"]
        if done == 1:
            # A leaf the optimizer holds no state for has not moved.
            opt_state = state.optimizer.state
            for k, p in named:
                m = opt_state.get(p, {}).get("exp_avg")
                prog_g1[k] = (torch.zeros_like(p) if m is None
                              else m / (1 - beta1)).norm()
            prog_g1.update(zip(prog_g1, torch.stack(
                list(prog_g1.values())).cpu().tolist()))
        if done == CHECKED_STEPS:
            with torch.no_grad():
                norms = torch.stack([(p - w0[k]).norm()
                                     for k, p in named]).cpu().tolist()
            prog_change.update(zip((k for k, _ in named), norms))
        if done == warm:
            with spans.span("sync"):
                harness.sync(dev)
            rs["setup"] = harness.setup_seconds(ctx)
            if not ctx.trace and profile.on_card(dev):
                rs["window_trace"] = profile.Trace(dev).start()
            rs["t0"] = harness.now()
            return False
        if rs["t0"] is None:
            return False
        if rs["t1"] is None:
            if harness.now() - rs["t0"] < ctx.seconds:
                return False
            with spans.span("sync"):
                harness.sync(dev)
            rs["t1"] = harness.now()
            rs["window_steps"] = done - warm
            if rs["window_trace"] is not None:
                rs["window_trace"].stop()
            if not trace_steps:
                rs["finished"] = True
                return True
            rs["trace"] = profile.Trace(dev).start()
            rs["until"] = done + trace_steps
            return False
        if done >= rs["until"]:
            with spans.span("sync"):
                rs["trace"].stop()
            rs["trace_s"] = harness.now() - rs["trace"].t_mark
            rs["finished"] = True
            return True
        return False

    epoch = 0
    try:
        while not run_state["finished"]:
            state = engine.train_epoch(state, feed, epoch, step, trackers,
                                       tail_step=tail_step, step_hook=hook)
            epoch += 1
    finally:
        pipe.close()
    del w0
    trace = run_state["trace"]
    summary = trace.summary(spans, trace_steps) if trace is not None else None
    memory = harness.peak_memory(dev)
    window_s = run_state["t1"] - run_state["t0"]
    window_images = run_state["window_steps"] * batch
    e2e = {"setup_s": run_state["setup"]}
    if run_state["window_trace"] is not None:
        busy = run_state["window_trace"].busy_s()
        if busy is None:
            raise RuntimeError("the window's trace holds no device operation")
        e2e["train_gpu_us_per_img"] = 1e6 * busy / window_images
    t0, t1 = run_state["t0"], run_state["t1"]
    waits = spans.durations("pipeline.next", t0, t1)
    prog_losses = [float(x) for x in losses]
    kept = feed.kept
    del state, model, named, train_step, tail_step, loss_fn, tx, feed, step
    harness.release(dev)

    # -- the check: the feed, then the reference's first three steps -------
    feed_errors, seen, batches = 0, set(), []
    for imgs, labs, mask in kept:
        idx = [images.identify(im) for im in imgs]
        for j, lab, mk in zip(idx, labs, mask):
            if j < 0 or j in seen or labels[j] != lab or mk != 1.0:
                feed_errors += 1
            seen.add(j)
        batches.append((imgs, labs))
    w_ref = family.make_weights(cfg, ctx.seed, dev)
    ref = family.train_steps(w_ref, batches, cfg, steps=CHECKED_STEPS)
    numbers, where = compare.train_numbers(
        (prog_losses, first_logits[0], prog_g1, prog_change), ref)
    numbers["feed_errors"] = feed_errors
    harness.release(dev)
    counters = {"window_s": window_s, "window_images": window_images,
                "window_steps": run_state["window_steps"],
                "data_wait_s": waits, "batch": batch,
                "trace_s": run_state["trace_s"], "worst_leaf": where,
                "losses": prog_losses, "ref_losses": ref[0]}
    return harness.Result(
        kind="train", config=cfg,
        e2e=e2e, counters=counters, numbers=numbers,
        attempted=run_state["window_steps"] * batch, failed=0,
        memory_peak_bytes=memory, spans=spans, profile=summary)
