"""Serving-side inference: reference ``.pth`` -> open-set predictions.

Counterpart of :class:`openset_imagenet_tpu.inference.OpenSetPredictor`
for checkpoints: load the two-head ResNet once onto an explicit device,
decode image paths by the serving policy (or take uint8 arrays), pad each
request to a power-of-two bucket, run the forward step and classify with
open-set rejection -- by softmax threshold or by the objectosphere
``||feature|| * score`` rule (reference ``metrics.py:45-62``).  Rejected
samples are labelled ``-1``.  :meth:`OpenSetPredictor.predict_stream`
overlaps the decode of the next chunk, the forward of this one and the
postprocessing of the last; :func:`calibrate_threshold` sets the
threshold from evaluation arrays.

``optimize="fold_bn"`` serves the folded graph and ``optimize="int8"``
its int8 form, calibrated on ``calibration=`` (:mod:`.optimize`).  When
the calibration is image paths, their decoded pixels are kept until the
prediction pass serves them (self-calibration on the first inputs): a
chunk that hits every cached path is served from the cache, and a chunk
that hits some of them decodes as a whole and drops the cached ones too,
so no decoded pixels outlive the first pass over their paths (the JAX
predictor keeps them on a partial hit).

The JAX predictor's refusals are kept with its messages
(``ValueError``): a TF SavedModel bundle, an unknown ``optimize`` mode,
``int8`` without ``calibration=``, and ``calibration=`` or
``calibration_percentile=`` without ``int8``.  Not ported yet, each
raising ``NotImplementedError`` with its ROADMAP Queue 1 item: exported
``.stablehlo`` artifacts (item 7) and ``mesh=`` (item 8).
"""

from __future__ import annotations

import pathlib
from typing import Iterable

import numpy as np
import torch

from . import tracing
from .checkpoint import infer_n_classes, load_checkpoint, resolve_model_cfg
from .config import NameSpace
from .optimize import optimized_inference
from .train import build_model, decode_serving_paths, make_forward_step

# The suffix of the JAX package's exported StableHLO bundles
# (``export.ARTIFACT_SUFFIX`` there).
ARTIFACT_SUFFIX = ".stablehlo"


def calibrate_threshold(arr_path, fpr_target: float, mode: str,
                        has_background: bool) -> float:
    """The rejection threshold from evaluation arrays (JAX
    ``inference.py:22-50``).

    Computes the measure the predictor applies (``_finish``: max softmax
    over the known-class region, times the feature norm in objectosphere
    mode) on the rows with ``gt < 0`` and returns the smallest threshold
    that accepts at most ``fpr_target`` of them
    (:func:`~.ops.oscr.threshold_at_fpr`).
    """
    from .ops.oscr import threshold_at_fpr

    with np.load(arr_path) as arr:
        gt = arr["gt"]
        scores = arr["scores"]
        features = arr["features"] if mode == "objectosphere" else None
    unk = gt < 0
    if not unk.any():
        raise ValueError(f"{arr_path}: no negative/unknown rows (gt < 0) "
                         "to calibrate on")
    class_scores = scores[:, :-1] if has_background else scores
    measure = np.max(class_scores, axis=-1)
    if mode == "objectosphere":
        measure = measure * np.linalg.norm(features, axis=-1)
    return threshold_at_fpr(measure[unk], fpr_target)


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item})")


def _host_buffer(shape, device: torch.device) -> np.ndarray:
    """A host array for a batch bound for ``device``: page-locked memory
    for a CUDA device, so the copy to the card is asynchronous."""
    if device.type != "cuda":
        return np.empty(shape, np.uint8)
    return torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy()


class OpenSetPredictor:
    """Batched open-set classifier around a trained two-head ResNet."""

    def __init__(self, checkpoint, n_classes: int | None = None,
                 variant: str | None = None, image_size: int | None = None,
                 threshold: float | None = None, mode: str | None = None,
                 has_background: bool | None = None, mesh=None,
                 optimize: str | None = None, calibration=None,
                 calibration_percentile: float | None = None,
                 device="cuda", reader=None):
        """Args:
            checkpoint: reference-layout ``.pth`` from training.
            n_classes: logits width; ``None`` reads it from the logits head.
            variant: ResNet variant; ``None`` -> the arch stored in the
                checkpoint (``extra.arch`` of the port's ``.pth``), else
                resnet50 (a reference ``.pth`` carries none).
            image_size: crop size the model expects (default 224).
            threshold: rejection threshold; 0 disables rejection.
            mode: ``'softmax'`` (reject if max softmax < threshold) or
                ``'objectosphere'`` (reject if ``||feat|| * max softmax <
                threshold``).
            has_background: garbage-regime model -- the background column
                is excluded from the class decision.
            optimize: ``"fold_bn"`` (batch-norm folded into the convs),
                ``"int8"`` (also the block convs in int8; needs
                ``calibration``) or None (the training graph).
            calibration: for ``"int8"``: a uint8 ``[N, H, W, 3]`` array
                or image paths (decoded like ``predict`` inputs) that set
                the activation scales.
            calibration_percentile: clip each activation scale to this
                percentile of |activation| instead of the abs-max.
            mesh: multi-device serving, not ported (``NotImplementedError``);
                the argument combinations the JAX predictor refuses raise
                its ``ValueError``.
            device: where the weights live and the forward runs.
            reader: decodes image paths (a pipeline reader: ``reader(path,
                None)`` or ``read_batch``); ``None`` takes the serving
                policy (:func:`~.train.decode_serving_paths`) at first use.

        ``threshold`` / ``mode`` / ``has_background`` left ``None`` resolve
        to 0.0 / ``'softmax'`` / False (``self.meta`` is ``{}`` for a
        checkpoint: no serving sidecar).
        """
        # The JAX predictor's refusals first, with its messages; then what
        # is valid there and not ported here.
        if (pathlib.Path(checkpoint) / "saved_model.pb").exists():
            raise ValueError(
                f"{checkpoint} is a TF SavedModel bundle "
                "(export_imagenet --format savedmodel); it runs on the "
                "TF runtime (tf_export.load_savedmodel / TF-Serving). "
                "This predictor serves checkpoints or StableHLO "
                f"bundles ({ARTIFACT_SUFFIX}).")
        if optimize not in (None, "fold_bn", "int8"):
            raise ValueError(f"unknown optimize mode {optimize!r}; choose "
                             "'fold_bn' or 'int8' (or None for the "
                             "training graph)")
        if optimize == "int8" and calibration is None:
            raise ValueError(
                "optimize='int8' needs calibration= (a uint8 image array "
                "or image paths) to set the activation scales")
        if calibration is not None and optimize != "int8":
            raise ValueError("calibration= only applies to optimize='int8'")
        if calibration_percentile is not None and optimize != "int8":
            raise ValueError("calibration_percentile= only applies to "
                             "optimize='int8'")
        if str(checkpoint).endswith(ARTIFACT_SUFFIX):
            if optimize is not None:
                raise ValueError(
                    "optimize= needs a checkpoint, not an exported "
                    "artifact (the artifact's graph was baked at export "
                    "time; re-export from the .pth instead)")
            raise _not_ported(f"serving an exported {ARTIFACT_SUFFIX} "
                              "artifact", 7)
        if mesh is not None:
            raise _not_ported("mesh= (multi-device serving)", 8)
        self.meta = {}  # a checkpoint has no serving sidecar
        mode = "softmax" if mode is None else mode
        if mode not in ("softmax", "objectosphere"):
            raise ValueError(f"unknown rejection mode {mode!r}; choose "
                             "'softmax' or 'objectosphere'")
        if n_classes is None:
            n_classes = infer_n_classes(checkpoint)
        self.n_classes = int(n_classes)
        self.image_size = 224 if image_size is None else int(image_size)
        self.threshold = float(threshold or 0.0)
        self.mode = mode
        self.has_background = bool(has_background)
        self.device = torch.device(device)
        self._reader = reader
        # Decoded calibration pixels by path, until predicted (int8 on paths).
        self._decoded_cache: dict = {}
        cfg = NameSpace({"model": resolve_model_cfg(checkpoint, variant)})
        model = build_model(cfg, self.n_classes, device="meta")
        model.to_empty(device=self.device)
        load_checkpoint(checkpoint, model)
        if optimize is not None:
            model = optimized_inference(
                model.eval(), optimize, calibration=calibration,
                image_size=self.image_size,
                load_images=self._calibration_loader,
                percentile=calibration_percentile)
        self.model = model.eval().to(memory_format=torch.channels_last)
        self._forward = make_forward_step()
        # Buckets whose forward has completed at least once.
        self._warm_buckets: set = set()

    # -- image loading -------------------------------------------------------
    def _calibration_loader(self, paths) -> np.ndarray:
        """Decode int8 calibration paths and keep their pixels, so that
        predicting the same files (self-calibration) decodes them once."""
        paths = list(paths)
        batch = self._load_images(paths)
        self._decoded_cache = dict(zip(paths, batch))
        return batch

    def _load_images(self, inputs, out=None) -> np.ndarray:
        """A uint8 ``[N, S, S, 3]`` array as given, or image paths decoded
        by the reader (kept across calls); with ``out`` (a uint8 ``[N, S,
        S, 3]`` array) written into it.  Paths cached by the int8
        calibration are served from the cache when the whole chunk hits
        it; either way a hit path leaves the cache."""
        if isinstance(inputs, np.ndarray):
            if inputs.dtype != np.uint8 or inputs.ndim != 4 or \
                    inputs.shape[1:] != (self.image_size, self.image_size, 3):
                raise ValueError(f"expected uint8 [N, {self.image_size}, "
                                 f"{self.image_size}, 3], got {inputs.dtype}"
                                 f" {inputs.shape}")
            batch = inputs
        else:
            paths, batch = list(inputs), None
            if paths and self._decoded_cache:
                hits = [self._decoded_cache.get(p) for p in paths]
                for p in paths:
                    self._decoded_cache.pop(p, None)
                if all(h is not None for h in hits):
                    batch = np.stack(hits, out=out)
            if batch is None:
                batch, self._reader = decode_serving_paths(
                    paths, self.image_size, reader=self._reader, out=out)
        if out is None or batch is out:
            return batch
        out[...] = batch
        return out

    def _bucket(self, n: int) -> int:
        """Padded batch size for an ``n``-image request: the next power of
        two, so a deployment runs a handful of batch shapes.  BN runs on
        running statistics, so the padded rows do not affect real ones."""
        return 1 << max(0, n - 1).bit_length()

    def bucket_warm(self, n: int) -> bool:
        """True once the bucket of an ``n``-image batch has completed a
        forward (its kernel selection and allocation are behind it)."""
        return self._bucket(n) in self._warm_buckets

    def buckets_compiled_up_to(self, max_batch: int) -> bool:
        """True once every bucket of the ladder up to ``max_batch`` has
        completed a forward."""
        b = self._bucket(1)
        while True:
            if b not in self._warm_buckets:
                return False
            if b >= max_batch:
                return True
            b = self._bucket(b + 1)

    def warmup(self, max_batch: int = 256) -> "OpenSetPredictor":
        """Run every bucketed batch shape up to ``max_batch`` once, so the
        first requests do not pay for kernel selection and allocation."""
        b = self._bucket(1)
        while True:
            images = np.zeros((b, self.image_size, self.image_size, 3),
                              np.uint8)
            _, _, scores = self._forward(self.model, images)
            float(scores[0, 0])  # synchronise
            self._warm_buckets.add(b)
            if b >= max_batch:
                return self
            b = self._bucket(b + 1)

    # -- prediction -----------------------------------------------------------
    def _stage(self, inputs, key=None):
        """``(n, batch)``: the ``n`` images of ``inputs`` (paths, decoded
        by the reader, or a uint8 array) padded with zero rows to their
        bucket, in a host buffer for the predictor's device; paths are
        decoded straight into it.  ``key`` is the chunk index its spans
        carry."""
        if not isinstance(inputs, np.ndarray):
            inputs = list(inputs)
        n = len(inputs)
        bucket = self._bucket(n)
        with tracing.span("predict.load", key=key):
            if self.device.type != "cuda" and bucket == n:
                staged = self._load_images(inputs)
            else:
                staged = _host_buffer(
                    (bucket, self.image_size, self.image_size, 3),
                    self.device)
                self._load_images(inputs, out=staged[:n])
        with tracing.span("predict.stage", key=key):
            if n < bucket:   # never a write to the caller's own array
                staged[n:] = 0
        return n, staged

    def _finish(self, n: int, outputs, return_features: bool,
                return_arrays: bool = False, key=None):
        """Fetch + postprocess a dispatched forward (waits for the device);
        ``key`` is the chunk index its spans carry."""
        _, features, scores = outputs
        with tracing.span("predict.fetch", key=key):
            scores = scores[:n].cpu().numpy()
            features = features[:n].cpu().numpy()
        with tracing.span("predict.post", key=key):
            self._warm_buckets.add(self._bucket(n))
            class_scores = scores[:, :-1] if self.has_background else scores
            pred = np.argmax(class_scores, axis=-1)
            conf = np.max(class_scores, axis=-1)
            # The returned score is the rejection measure of the mode, so
            # re-applying the threshold to it reproduces the decisions here.
            if self.mode == "objectosphere":
                measure = np.linalg.norm(features, axis=-1) * conf
            else:
                measure = conf
            if self.threshold > 0:
                pred = np.where(measure < self.threshold, -1, pred)
            if return_arrays:
                return pred, measure, features, scores
            if return_features:
                return pred, measure, features
            return pred, measure

    def predict(self, inputs: Iterable, return_features: bool = False,
                return_arrays: bool = False):
        """Classify images: paths, or a uint8 ``[N, H, W, 3]`` array.

        Returns ``(pred_class, pred_score)`` (+ features with
        ``return_features``; + features and the full softmax matrix with
        ``return_arrays``); rejected samples get class ``-1``.
        """
        n, staged = self._stage(inputs)
        return self._finish(n, self._forward(self.model, staged),
                            return_features, return_arrays)

    def predict_stream(self, paths, batch_size: int = 64, prefetch: int = 2,
                       return_features: bool = False,
                       return_arrays: bool = False):
        """Pipelined bulk prediction: yields ``(chunk_paths, *results)``.

        A producer thread decodes chunk k+1 straight into its staging
        buffer (page-locked on CUDA, padded to its bucket) while the
        device runs the forward of chunk k (dispatched asynchronously) and
        the caller's thread postprocesses chunk k-1 (JAX ``inference.py:
        433-512``).  Chunks are ``batch_size`` rows but the last, results
        come in input order and are bitwise equal to per-chunk
        :meth:`predict`.  A decode error is raised after the chunk already
        on the device is yielded; closing the generator stops the producer.
        """
        import itertools
        import queue
        import threading

        paths = list(paths)
        if not paths:
            return
        out_q: "queue.Queue" = queue.Queue(maxsize=max(1, int(prefetch)))
        stop = threading.Event()

        def produce():
            try:
                for k, i in enumerate(range(0, len(paths), batch_size)):
                    if stop.is_set():
                        return
                    chunk = paths[i:i + batch_size]
                    out_q.put((chunk, *self._stage(chunk, key=k)))
                out_q.put(None)
            except BaseException as exc:  # surfaced in order, re-raised below
                out_q.put(exc)

        producer = threading.Thread(target=produce, daemon=True,
                                    name="osi-predict-decode")
        producer.start()
        pending = None  # (chunk index, chunk_paths, n, device outputs)
        try:
            for k in itertools.count():
                with tracing.span("predict.get", key=k):
                    item = out_q.get()
                if isinstance(item, BaseException):
                    # The chunk already dispatched is valid work: yield it
                    # first, so a caller flushing per chunk keeps every row
                    # before the bad input.
                    if pending is not None:
                        pk, pchunk, pn, pout = pending
                        pending = None
                        yield (pchunk, *self._finish(
                            pn, pout, return_features, return_arrays, pk))
                    raise item
                if item is None:
                    break
                chunk, n, staged = item
                with tracing.span("predict.dispatch", key=k,
                                  device=self.device):
                    outputs = self._forward(self.model, staged)
                if pending is not None:
                    pk, pchunk, pn, pout = pending
                    yield (pchunk, *self._finish(pn, pout, return_features,
                                                 return_arrays, pk))
                pending = (k, chunk, n, outputs)
            if pending is not None:
                pk, pchunk, pn, pout = pending
                yield (pchunk, *self._finish(pn, pout, return_features,
                                             return_arrays, pk))
        finally:
            stop.set()
            # Unblock a producer waiting on a full queue, then let it end.
            while producer.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    producer.join(timeout=0.1)
