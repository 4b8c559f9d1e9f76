"""Engine subset of the serving slice: model, loss wiring, eval steps.

Counterpart of the forward half of :mod:`openset_imagenet_tpu.train`:
:func:`build_model`, :func:`make_loss_fn`, :func:`make_eval_step`,
:func:`make_forward_step` and :func:`validate`.  PyTorch runs eagerly, so
the "steps" are plain functions under ``torch.inference_mode()``; they
take the model (in eval mode) where the JAX steps take the train state,
and numpy or tensor batches, which they move to the model's device.
The train step, the worker and the input pipeline come next (ROADMAP
Queue 1 item 2).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .models.resnet import ResNet50, build_resnet
from .ops.losses import entropic_openset_loss, garbage_loss, softmax_loss
from .ops.metrics import confidence_sums, loss_regime_params

Tensor = torch.Tensor


def build_model(cfg, n_classes: int, dtype: torch.dtype = torch.bfloat16,
                device=None) -> ResNet50:
    """Two-head ResNet from ``cfg.model`` (variant default ``resnet50``).

    ``fc_layer_dim == out_features == n_classes`` and no logit bias, as
    the reference trains it (reference ``train.py:350-353``).
    """
    model_cfg = getattr(cfg, "model", None)

    def opt(name, default):
        value = getattr(model_cfg, name, default) if model_cfg is not None \
            else default
        return default if value is None else value

    return build_resnet(
        opt("variant", "resnet50"), fc_layer_dim=n_classes,
        out_features=n_classes, logit_bias=False, dtype=dtype,
        bn_stats_rows=int(opt("bn_stats_rows", 0)),
        space_to_depth=bool(opt("space_to_depth", False)),
        remat=opt("remat", False),
        fused_blocks=bool(opt("fused_blocks", False)),
        boundary_mask=bool(opt("boundary_mask", False)),
        device=device)


def make_loss_fn(loss_type: str, unk_weight: float = 1.0,
                 class_weights: Optional[np.ndarray] = None,
                 fused=False) -> Callable:
    """Return ``loss_fn(logits, labels, mask=None) -> (mean, count)``.

    ``fused`` is ``loss.fused`` from the config: ``True`` or ``"auto"``
    selects :mod:`.ops.fused_loss`, whose wrappers launch the Hopper
    kernels on CUDA tensors and run their plain versions on CPU tensors;
    ``False`` is the explicit unfused choice (:mod:`.ops.losses`).
    """
    if fused not in (True, False, "auto"):
        raise ValueError(f"loss.fused must be true, false or auto, got "
                         f"{fused!r}")
    if loss_type not in ("entropic", "softmax", "garbage"):
        raise ValueError(f"unknown loss type {loss_type!r}")
    if loss_type == "garbage" and class_weights is None:
        raise ValueError("garbage loss requires class_weights")
    if fused:
        from .ops import fused_loss as fl

    def weights_on(logits):
        return torch.as_tensor(class_weights, dtype=torch.float32,
                               device=logits.device)

    def loss_fn(logits, labels, mask=None):
        if loss_type == "entropic":
            if not fused:
                return entropic_openset_loss(logits, labels, unk_weight, mask)
            if mask is None:
                mask = torch.ones(labels.shape, dtype=torch.float32,
                                  device=labels.device)
            return fl.entropic_openset_loss_fused(logits, labels, mask,
                                                  unk_weight)
        if loss_type == "softmax":
            return (fl.softmax_loss_fused if fused else softmax_loss)(
                logits, labels, mask)
        return (fl.garbage_loss_fused if fused else garbage_loss)(
            logits, labels, weights_on(logits), mask)

    return loss_fn


def _to_float(images_u8: Tensor) -> Tensor:
    """uint8 [0, 255] -> float32 [0, 1] on the device (ToTensor parity)."""
    return images_u8.float() * (1.0 / 255.0)


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _on(device, x) -> Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, non_blocking=True)


def make_forward_step() -> Callable:
    """``step(model, images_u8) -> (logits, features, scores)``."""
    @torch.inference_mode()
    def step(model, images):
        logits, features = model(_to_float(_on(_device_of(model), images)))
        return logits, features, torch.softmax(logits.float(), dim=-1)

    return step


def make_eval_step(loss_fn: Callable, loss_type: str,
                   n_classes: int) -> Callable:
    """``step(model, images, labels, mask) -> dict`` of device scalars:
    the row-weighted loss sum and the streaming confidence sums."""
    regime = loss_regime_params(loss_type, n_classes)

    @torch.inference_mode()
    def step(model, images, labels, mask):
        device = _device_of(model)
        labels, mask = _on(device, labels), _on(device, mask).float()
        logits, _ = model(_to_float(_on(device, images)))
        scores = torch.softmax(logits.float(), dim=-1)
        loss, _ = loss_fn(logits, labels, mask)
        kn_sum, kn_cnt, neg_sum, neg_cnt = confidence_sums(
            scores, labels, sample_mask=mask, **regime)
        rows = mask.sum()
        # Tracker weighting by batch rows (reference train.py:180-181).
        return {"loss_sum": loss * rows, "rows": rows,
                "kn_sum": kn_sum, "kn_count": kn_cnt,
                "neg_sum": neg_sum, "neg_count": neg_cnt}

    return step


def validate(model, pipeline, epoch: int, eval_step: Callable,
             trackers) -> None:
    """Validation pass; updates ``trackers`` ``j``/``conf_kn``/``conf_unk``.

    ``pipeline.epoch(epoch)`` yields batches with numpy ``images``,
    ``labels`` and ``mask`` (like the JAX package's ``pipeline.Batch``).
    Sums accumulate on the device and are fetched once at the end.
    """
    for m in trackers.values():
        m.reset()
    sums = None
    for batch in pipeline.epoch(epoch):
        m = eval_step(model, batch.images, batch.labels, batch.mask)
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    if sums is None:
        return
    names = list(sums)
    values = torch.stack([sums[k].float() for k in names]).cpu().tolist()
    sums = dict(zip(names, values))
    if sums["rows"]:
        trackers["j"].update(sums["loss_sum"] / sums["rows"], sums["rows"])
    if sums["kn_count"]:
        trackers["conf_kn"].update(sums["kn_sum"] / sums["kn_count"],
                                   sums["kn_count"])
    if sums["neg_count"]:
        trackers["conf_unk"].update(sums["neg_sum"] / sums["neg_count"],
                                    sums["neg_count"])
