"""Bulk prediction traffic: ``OpenSetPredictor.predict_stream`` over image
paths, as a user scores a test set.

Set-up draws the seeded weights of the configuration's family
(:mod:`.families`; running statistics taken from ``calibration_images``
seeded images), writes them as a ``.pth`` through the program's
``save_checkpoint`` (the predictor loads only from a path), builds the
predictor on it with the traffic's ``optimize`` mode and the benchmark's
reader (``reader=``; the paths name seeded images), and streams
``batch``-image chunks with ``prefetch`` staged ahead. ``distinct_images``
seeded images are repeated in an order drawn from the seed. The window
opens after ``warm_chunks`` chunks have been yielded and closes at the
first yield ``seconds`` later. With ``--trace 0`` the profiler (device
activity only) covers the window on the card, from a device sync at its
start to one after its close: ``predict_gpu_us_per_img`` is the device's
busy time in it over every image whose result was yielded in the window
(the chunk in flight at the start ends before the trace does, the one in
flight at the close inside it, so the trace holds as many chunks as the
window yields). With ``--trace 1`` the window runs without it, the reader
``predict.imgs_per_s`` takes every image yielded in it over its seconds,
and ``trace_chunks`` further chunks run under the profiler after the
window.

Check: ``check_rows`` answers of the window drawn from the seed against
the reference's eval-mode logits of the same images; every chunk of the
window must carry one answer a path.
"""

from __future__ import annotations

import math

import numpy as np

from . import compare, data, families, harness, profile


def write_checkpoint(ctx: harness.Ctx, images: data.Images, path):
    """Seeded weights with calibrated running statistics, written as the
    program's ``.pth``; returns the weights, kept on the host for the
    reference."""
    import torch

    from openset_imagenet_tpu_torch import train as engine
    from openset_imagenet_tpu_torch.checkpoint import save_checkpoint
    from openset_imagenet_tpu_torch.config import NameSpace

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    family = families.of(cfg)
    w = family.make_weights(cfg, ctx.seed, dev)
    calib = int(tr.get("calibration_images", 32))
    w = family.calibrate_running_stats(w, images.batch(range(calib)), cfg)
    arch = family.model_options(cfg)
    model = engine.build_model(NameSpace({"model": arch}),
                               int(cfg["n_classes"]), device="meta")
    model.to_empty(device=dev)
    model.load_state_dict(w, strict=True)
    save_checkpoint(path, model, epoch=0, best_score=0.0,
                    extra={"arch": arch})
    host = {k: v.detach().cpu() for k, v in w.items()}
    del model, w
    harness.release(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    return host


def check_answers(ctx: harness.Ctx, weights: dict, images: data.Images,
                  idx, classes, scores) -> dict:
    """``score_gap`` of the answers for images ``idx`` against the
    reference on the card."""
    dev = ctx.device
    w = {k: v.to(dev) for k, v in weights.items()}
    ref = families.of(ctx.config).eval_logits(w, images.batch(idx),
                                              ctx.config)
    out = compare.answer_numbers(classes, scores, ref.cpu().numpy())
    del w, ref
    harness.release(dev)
    return out


def run(ctx: harness.Ctx) -> harness.Result:
    from openset_imagenet_tpu_torch.inference import OpenSetPredictor

    cfg, tr, dev, spans = ctx.config, ctx.traffic, ctx.device, ctx.spans
    batch, warm = int(tr["batch"]), int(tr["warm_chunks"])
    trace_chunks = int(tr.get("trace_chunks", 3)) if ctx.trace else 0
    distinct = int(tr["distinct_images"])
    images = data.Images(ctx.seed, distinct, int(cfg["image_size"]))
    chunks = warm + trace_chunks + math.ceil(
        ctx.seconds * float(tr["max_imgs_per_s"]) / batch)
    order = np.concatenate([data.rng(ctx.seed, 3).permutation(distinct)
                            for _ in range(-(-chunks * batch // distinct))])
    paths = [str(j) for j in order[:chunks * batch]]
    ckpt = ctx.out_dir / f"{ctx.cell['name']}.pth"
    with spans.span("setup.checkpoint"):
        weights = write_checkpoint(ctx, images, ckpt)
    with spans.span("setup.predictor"):
        predictor = OpenSetPredictor(ckpt, device=dev,
                                     image_size=int(cfg["image_size"]),
                                     optimize=tr.get("optimize"),
                                     reader=data.Reader(images))
    stream = predictor.predict_stream(paths, batch_size=batch,
                                      prefetch=int(tr["prefetch"]))
    answers, k = [], 0
    t0 = t1 = trace = trace_s = setup = window_trace = None
    try:
        while True:
            with spans.span("predict_stream.next"):
                item = next(stream, None)
            if item is None:
                break
            k += 1
            if k == warm:
                setup = harness.setup_seconds(ctx)
                if not ctx.trace and profile.on_card(dev):
                    window_trace = profile.Trace(dev).start()
                t0 = harness.now()
            elif t0 is not None and t1 is None:
                answers.append(item)
                if harness.now() - t0 >= ctx.seconds:
                    t1 = harness.now()
                    if window_trace is not None:
                        window_trace.stop()
                    if not trace_chunks:
                        break
                    trace = profile.Trace(dev).start()
                    until = k + trace_chunks
            elif t1 is not None and k >= until:
                trace.stop()
                trace_s = harness.now() - trace.t_mark
                break
    finally:
        stream.close()
    if t1 is None:
        raise RuntimeError(f"the stream of {len(paths)} paths ended before "
                           "the window closed: raise max_imgs_per_s")
    summary = (trace.summary(spans, trace_chunks) if trace is not None
               else None)
    busy = window_trace.busy_s() if window_trace is not None else None
    if window_trace is not None and busy is None:
        raise RuntimeError("the window's trace holds no device operation")
    memory = harness.peak_memory(dev)
    del predictor, stream
    harness.release(dev)

    missing = sum(max(0, len(c) - len(p)) + int(np.sum(~np.isfinite(
        np.asarray(s, dtype=np.float64)))) for c, p, s in answers)
    flat_paths = [p for c, _, _ in answers for p in c]
    flat_cls = np.concatenate([p for _, p, _ in answers])
    flat_score = np.concatenate([s for _, _, s in answers])
    n = min(len(flat_paths), len(flat_cls), len(flat_score))
    pick = np.sort(data.rng(ctx.seed, 4).choice(
        n, min(int(tr["check_rows"]), n), replace=False))
    numbers = check_answers(ctx, weights, images,
                            [int(flat_paths[i]) for i in pick],
                            flat_cls[pick], flat_score[pick])
    numbers["missing"] = missing
    window_s = t1 - t0
    done = int(sum(len(p) for _, p, _ in answers))
    e2e = {"setup_s": setup}
    if busy is not None:
        e2e["predict_gpu_us_per_img"] = 1e6 * busy / done
    return harness.Result(
        kind="predict", config=cfg, e2e=e2e,
        counters={"window_s": window_s, "window_images": done,
                  "window_chunks": len(answers), "batch": batch,
                  "trace_s": trace_s},
        numbers=numbers, attempted=int(sum(len(c) for c, _, _ in answers)),
        failed=missing, memory_peak_bytes=memory, spans=spans,
        profile=summary)
