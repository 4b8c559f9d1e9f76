"""Serving-side inference: reference ``.pth`` -> open-set predictions.

Counterpart of :class:`openset_imagenet_tpu.inference.OpenSetPredictor`
for checkpoints: load the two-head ResNet once onto an explicit device,
pad each request to a power-of-two bucket, run the forward step and
classify with open-set rejection -- by softmax threshold or by the
objectosphere ``||feature|| * score`` rule (reference
``metrics.py:45-62``).  Rejected samples are labelled ``-1``.

Not ported yet (ROADMAP Queue 1 items 4, 6 and 7): image paths and JPEG
decoding, ``predict_stream``, exported artifacts, ``optimize=`` and
multi-device serving.  ``predict`` takes uint8 ``[N, H, W, 3]`` arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .checkpoint import infer_n_classes, load_checkpoint, resolve_model_cfg
from .config import NameSpace
from .train import build_model, make_forward_step


class OpenSetPredictor:
    """Batched open-set classifier around a trained two-head ResNet."""

    def __init__(self, checkpoint, n_classes: int | None = None,
                 variant: str | None = None, image_size: int | None = None,
                 threshold: float = 0.0, mode: str = "softmax",
                 has_background: bool = False, device="cuda"):
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
            device: where the weights live and the forward runs.
        """
        if mode not in ("softmax", "objectosphere"):
            raise ValueError(f"unknown rejection mode {mode!r}; choose "
                             "'softmax' or 'objectosphere'")
        if n_classes is None:
            n_classes = infer_n_classes(checkpoint)
        self.n_classes = int(n_classes)
        self.image_size = 224 if image_size is None else int(image_size)
        self.threshold = float(threshold)
        self.mode = mode
        self.has_background = bool(has_background)
        self.device = torch.device(device)
        cfg = NameSpace({"model": resolve_model_cfg(checkpoint, variant)})
        model = build_model(cfg, self.n_classes, device="meta")
        model.to_empty(device=self.device)
        load_checkpoint(checkpoint, model)
        self.model = model.eval().to(memory_format=torch.channels_last)
        self._forward = make_forward_step()
        # Buckets whose forward has completed at least once.
        self._warm_buckets: set = set()

    def _bucket(self, n: int) -> int:
        """Padded batch size for an ``n``-image request: the next power of
        two, so a deployment runs a handful of batch shapes.  BN runs on
        running statistics, so the padded rows do not affect real ones."""
        return 1 << max(0, n - 1).bit_length()

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

    def _dispatch(self, images: np.ndarray):
        """Pad to the bucket and launch the forward (asynchronous on CUDA)."""
        n = images.shape[0]
        bucket = self._bucket(n)
        if bucket != n:
            pad = np.zeros((bucket - n, *images.shape[1:]), images.dtype)
            images = np.concatenate([images, pad])
        return n, self._forward(self.model, images)

    def _finish(self, n: int, outputs, return_features: bool,
                return_arrays: bool = False):
        """Fetch + postprocess a dispatched forward (waits for the device)."""
        _, features, scores = outputs
        scores = scores[:n].cpu().numpy()
        features = features[:n].cpu().numpy()
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

    def predict(self, images: np.ndarray, return_features: bool = False,
                return_arrays: bool = False):
        """Classify a uint8 ``[N, H, W, 3]`` array.

        Returns ``(pred_class, pred_score)`` (+ features with
        ``return_features``; + features and the full softmax matrix with
        ``return_arrays``); rejected samples get class ``-1``.
        """
        if not isinstance(images, np.ndarray):
            raise TypeError("predict takes a uint8 [N, H, W, 3] numpy array; "
                            "image paths are not ported yet (ROADMAP Queue 1 "
                            "item 4)")
        if images.dtype != np.uint8 or images.ndim != 4 \
                or images.shape[1:] != (self.image_size, self.image_size, 3):
            raise ValueError(f"expected uint8 [N, {self.image_size}, "
                             f"{self.image_size}, 3], got {images.dtype} "
                             f"{images.shape}")
        n, outputs = self._dispatch(images)
        return self._finish(n, outputs, return_features, return_arrays)
