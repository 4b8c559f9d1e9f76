"""Training engine: model, loss wiring, optimizer, train/eval steps, loops.

Counterpart of :mod:`openset_imagenet_tpu.train` below the worker:
:func:`build_model`, :func:`make_loss_fn`, :func:`build_lr_schedule`,
:func:`build_optimizer`, :class:`TrainState` / :func:`create_state`,
:func:`make_train_step` with the ragged-tail rule (:func:`make_tail_step`),
:func:`train_epoch`, :func:`make_eval_step`, :func:`make_forward_step` and
:func:`validate`.  PyTorch runs eagerly, so the "steps" are plain
functions: the train step updates the :class:`TrainState` in place (and
returns it, as the JAX step returns the new state); the eval and forward
steps run under ``torch.inference_mode()`` and take the model.  Each step
puts the model in the mode it needs (the JAX ``train=`` argument).  Steps
take numpy or tensor batches and move them to the model's device; a step
never syncs the host, and the loops fetch their sums once at the end.
The worker (``train.worker``: label surgery, checkpoints, gamma
selection, preemption) comes next (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .models.resnet import ResNet50, build_resnet
from .ops.losses import entropic_openset_loss, garbage_loss, softmax_loss
from .ops.metrics import confidence_sums, loss_regime_params

Tensor = torch.Tensor


def build_model(cfg, n_classes: int, dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> ResNet50:
    """Two-head ResNet from ``cfg.model`` (variant default ``resnet50``).

    ``fc_layer_dim == out_features == n_classes`` and no logit bias, as
    the reference trains it (reference ``train.py:350-353``).  Built on
    the card unless the caller names another ``device`` (``"cpu"``);
    without a card the default raises torch's own error.
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
    weights = {}  # class weights, copied once per device

    def weights_on(logits):
        w = weights.get(logits.device)
        if w is None:
            w = weights[logits.device] = torch.as_tensor(
                class_weights, dtype=torch.float32, device=logits.device)
        return w

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
    """Host numpy or tensor -> tensor on ``device``, without a host sync.

    A numpy view of a whole torch tensor (the pipeline's pinned buffers)
    is copied from that tensor, so the asynchronous copy is tracked by
    the pinned allocator and the buffer is not reused while in flight.
    """
    if isinstance(x, np.ndarray):
        base = x.base
        if (isinstance(base, torch.Tensor) and tuple(base.shape) == x.shape
                and base.data_ptr() == x.ctypes.data):
            x = base
        else:
            x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, non_blocking=True)


def _set_mode(model: torch.nn.Module, train: bool) -> None:
    if model.training != train:
        model.train(train)


# -- optimizer (train.py:136-281) --------------------------------------------

def build_lr_schedule(opt_cfg, steps_per_epoch: int, epochs: int = 0
                      ) -> Callable[[int], float]:
    """Per-update learning-rate schedule ``count -> lr``.

    The JAX package's three forms (``train.py:136-192``): StepLR
    ``lr * gamma ** ((count // spe) // decay)`` (the default, reference
    parity); ``opt.schedule: cosine`` from ``lr`` down to ``lr *
    opt.min_lr_ratio`` over the post-warmup part of ``epochs``; and
    ``opt.warmup_epochs`` of linear warmup ``lr * (count + 1) / warmup``
    in front of either.  ``count`` is the number of updates already made,
    so the first update uses ``schedule(0)``, as in optax.
    """
    lr = float(opt_cfg.lr)
    decay = int(getattr(opt_cfg, "decay", 0) or 0)
    gamma = float(getattr(opt_cfg, "gamma", 1.0) or 1.0)
    kind = getattr(opt_cfg, "schedule", "step") or "step"
    spe = max(int(steps_per_epoch), 1)
    warmup = int(getattr(opt_cfg, "warmup_epochs", 0) or 0) * spe
    if kind == "cosine":
        if epochs <= 0:
            raise ValueError("opt.schedule: cosine needs the total epoch "
                             "count (cfg.epochs) to place the decay")
        floor = lr * float(getattr(opt_cfg, "min_lr_ratio", 0.0) or 0.0)
        total = max(epochs * spe - warmup, 1)

        def base(count):
            frac = min(max((count - warmup) / total, 0.0), 1.0)
            return floor + (lr - floor) * 0.5 * (1 + math.cos(math.pi * frac))
    elif kind == "step":
        def base(count):
            return lr * gamma ** ((count // spe) // decay) if decay > 0 \
                else lr
    else:
        raise ValueError(f"unknown opt.schedule {kind!r}; "
                         "choose 'step' or 'cosine'")
    if warmup <= 0:
        return base

    def schedule(count):
        return lr * ((count + 1) / warmup) if count < warmup \
            else base(count)

    return schedule


class Transform(NamedTuple):
    """What :func:`build_optimizer` returns (the port's
    ``optax.GradientTransformation``): ``make(params)`` builds the torch
    optimizer, and ``schedule(count)`` is its learning rate per update."""

    make: Callable
    schedule: Callable[[int], float]


def build_optimizer(opt_cfg, steps_per_epoch: int, epochs: int = 0
                    ) -> Transform:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) or SGD(momentum=0.9) over
    :func:`build_lr_schedule` (reference ``train.py:356-369``).

    ``opt.accumulate_steps > 1`` and ``opt.ema`` are not ported yet.
    """
    if int(getattr(opt_cfg, "accumulate_steps", 1) or 1) > 1 or \
            float(getattr(opt_cfg, "ema", 0.0) or 0.0):
        raise NotImplementedError(
            "opt.accumulate_steps > 1 and opt.ema are not ported yet "
            "(ROADMAP Queue 1 item 2, worker slice)")
    schedule = build_lr_schedule(opt_cfg, steps_per_epoch, epochs=epochs)
    if getattr(opt_cfg, "type", "adam") == "sgd":
        def make(params):
            return torch.optim.SGD(params, lr=schedule(0), momentum=0.9)
    else:
        def make(params):
            return torch.optim.Adam(params, lr=schedule(0),
                                    betas=(0.9, 0.999), eps=1e-8)
    return Transform(make, schedule)


class TrainState:
    """Model, optimizer and update count (the JAX ``TrainState``).

    ``step`` is a host integer: the learning rate of each update is set
    from it before ``optimizer.step()``, so no scheduler sits between the
    count and the rate and nothing is read back from the device.
    """

    def __init__(self, model: ResNet50, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = int(step)

    def apply_gradients(self) -> None:
        """One optimizer update at ``schedule(step)``; then ``step += 1``."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_state(model: ResNet50, tx: Transform) -> TrainState:
    """Wrap an initialised model and a fresh optimizer over its
    parameters."""
    return TrainState(model, tx.make(model.parameters()), tx.schedule)


# -- steps ----------------------------------------------------------------

def make_train_step(loss_fn: Callable,
                    bn_stats_rows: Optional[int] = None) -> Callable:
    """``step(state, images, labels, mask) -> (state, metrics)``.

    uint8 images are scaled by 1/255 on the device; forward in training
    mode (batch statistics, running statistics updated), loss, backward,
    one optimizer update.  ``metrics`` holds device scalars
    ``{"loss_sum": loss * rows, "count": rows}`` with ``rows = mask.sum()``
    (tracker weighting by batch rows, reference ``train.py:126,135``).

    ``bn_stats_rows`` runs the model with that batch-norm window instead
    of its own (:meth:`ResNet50.stats_window`): the ragged-tail step.
    """
    def step(state: TrainState, images, labels, mask):
        model = state.model
        device = _device_of(model)
        imgs = _to_float(_on(device, images))
        labels, mask = _on(device, labels), _on(device, mask).float()
        _set_mode(model, True)
        window = (contextlib.nullcontext() if bn_stats_rows is None
                  else model.stats_window(bn_stats_rows))
        with window:
            logits, _ = model(imgs)
        loss, _ = loss_fn(logits, labels, mask)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        rows = mask.sum()
        return state, {"loss_sum": loss.detach() * rows, "count": rows}

    return step


def make_tail_step(loss_fn: Callable, model: ResNet50, n_tail: int,
                   train_step: Callable) -> Optional[Callable]:
    """The step for an epoch's ragged last batch (``train.py:987-1005``).

    Tail batches arrive padded with the padding last (``pipeline.
    InputPipeline._local_slice``), so a window of exactly ``n_tail``
    leading rows sees only valid samples.  A ghost window ``0 < G <=
    n_tail`` already does, and then the regular step serves.  ``None``
    when there is no ragged tail.  A ``fused_blocks`` model trains no
    ragged tail, as the JAX worker drops it (``train.py:905-909``): build
    its pipeline with ``drop_remainder=True`` (``n_tail`` 0).
    """
    if not n_tail:
        return None
    if model.fused_blocks:
        raise ValueError(
            f"a fused_blocks model trains no ragged tail batch ({n_tail} "
            "rows): build the pipeline with drop_remainder=True, as the JAX "
            "worker drops that batch")
    if 0 < model.bn_stats_rows <= n_tail:
        return train_step
    return make_train_step(loss_fn, bn_stats_rows=n_tail)


def make_forward_step() -> Callable:
    """``step(model, images_u8) -> (logits, features, scores)``."""
    @torch.inference_mode()
    def step(model, images):
        _set_mode(model, False)
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
        _set_mode(model, False)
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


def train_epoch(state: TrainState, pipeline, epoch: int,
                train_step: Callable, trackers,
                tail_step: Optional[Callable] = None, start_batch: int = 0,
                step_hook: Optional[Callable] = None) -> TrainState:
    """One pass over the training set; updates ``trackers['j']`` and
    ``trackers['imgs/s']`` (``train.py:559-617``).

    ``tail_step`` takes the epoch's last batch (see
    :func:`make_tail_step`); ``start_batch`` resumes the epoch at batch k
    (the pipeline's order is keyed by ``(seed, epoch)``, so the suffix is
    the one an uninterrupted epoch sees); ``step_hook(state, done)`` runs
    after every step and ends the epoch early by returning True.  The
    sums stay on the device and are fetched once, at the end.
    """
    for m in trackers.values():
        m.reset()
    sums = None
    t0 = time.time()
    nb = len(pipeline)
    batches = pipeline.epoch(epoch, start_batch=start_batch)
    for i, batch in enumerate(batches, start=start_batch):
        step = (tail_step if tail_step is not None and i == nb - 1
                else train_step)
        state, m = step(state, batch.images, batch.labels, batch.mask)
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
        if step_hook is not None and step_hook(state, i + 1):
            break
    if sums is not None:
        count, loss_sum = torch.stack(
            [sums["count"], sums["loss_sum"].float()]).cpu().tolist()
        elapsed = time.time() - t0
        if count:
            trackers["j"].update(loss_sum / count, count)
            trackers["imgs/s"].update(count / max(elapsed, 1e-9), 1)
    return state


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
