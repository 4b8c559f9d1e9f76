"""Training engine: the worker, model, losses, optimizer, steps, loops.

Counterpart of :mod:`openset_imagenet_tpu.train`: :func:`worker` (one
``(protocol, loss)`` run end to end: label surgery, the tail policy,
checkpoints, resume, preemption, γ selection), :func:`build_model`,
:func:`make_loss_fn`, :func:`build_lr_schedule`, :func:`build_optimizer`
(with ``opt.ema`` and ``opt.accumulate_steps``), :class:`TrainState` /
:func:`create_state`, :func:`make_train_step` with the ragged-tail rule
(:func:`make_tail_step`), :func:`train_epoch`, :func:`make_eval_step`,
:func:`make_forward_step` and :func:`validate`.  PyTorch runs eagerly, so
the "steps" are plain functions: the train step updates the
:class:`TrainState` in place (and returns it, as the JAX step returns the
new state); the eval and forward steps run under
``torch.inference_mode()`` and take the model.  Each step puts the model
in the mode it needs (the JAX ``train=`` argument).  Steps take numpy or
tensor batches and move them to the model's device; a step never syncs
the host, and the loops fetch their sums once at the end.
"""

from __future__ import annotations

import contextlib
import math
import os
import pathlib
import random
import signal
import time
from collections import defaultdict
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import tracing
from .checkpoint import (AsyncCheckpointer, load_checkpoint,
                         load_weights_any_format, save_checkpoint)
from .config import _to_dumpable
from .dataset import ImagenetDataset
from .events import SummaryWriter
from .logger import configure_logger
from .models.resnet import build_resnet
from .models.swin import build_swin
from .ops.losses import (AverageMeter, EarlyStopping, entropic_openset_loss,
                         garbage_loss, softmax_loss)
from .ops.metrics import confidence_sums, loss_regime_params
from .pipeline import PILReader, SyntheticReader, pipeline_from_dataset

Tensor = torch.Tensor


def build_model(cfg, n_classes: int, dtype: torch.dtype = torch.bfloat16,
                device="cuda",
                generator: Optional[torch.Generator] = None
                ) -> torch.nn.Module:
    """Two-head model from ``cfg.model``: ``arch`` ``"resnet"`` (the
    default; variant default ``resnet50``) or ``"swin"`` (variant default
    ``swin_b``, :mod:`.models.swin`).

    ``fc_layer_dim == out_features == n_classes`` and no logit bias, as
    the reference trains it (reference ``train.py:350-353``).  Built on
    the card unless the caller names another ``device`` (``"cpu"``);
    without a card the default raises torch's own error.  The initial
    weights are drawn from ``generator`` (:func:`set_seeds`; seed 0 when
    None).  A Swin takes none of the ResNet's options (``bn_stats_rows``,
    ``space_to_depth``, ``remat``, ``fused_blocks``, ``boundary_mask``).
    """
    model_cfg = getattr(cfg, "model", None)

    def opt(name, default):
        value = getattr(model_cfg, name, default) if model_cfg is not None \
            else default
        return default if value is None else value

    arch = opt("arch", "resnet")
    if arch == "swin":
        given = [k for k in _RESNET_OPTIONS if opt(k, False)]
        if given:
            raise ValueError(f"model options {given} apply to ResNets "
                             "only; a Swin has no batch-norm or stem conv "
                             "to change")
        return build_swin(opt("variant", "swin_b"), fc_layer_dim=n_classes,
                          out_features=n_classes, logit_bias=False,
                          dtype=dtype, device=device, generator=generator)
    if arch != "resnet":
        raise ValueError(f"unknown model arch {arch!r}; choose 'resnet' or "
                         "'swin'")
    return build_resnet(
        opt("variant", "resnet50"), fc_layer_dim=n_classes,
        out_features=n_classes, logit_bias=False, dtype=dtype,
        bn_stats_rows=int(opt("bn_stats_rows", 0)),
        space_to_depth=bool(opt("space_to_depth", False)),
        remat=opt("remat", False),
        fused_blocks=bool(opt("fused_blocks", False)),
        boundary_mask=bool(opt("boundary_mask", False)),
        device=device, generator=generator)


_RESNET_OPTIONS = ("bn_stats_rows", "space_to_depth", "remat",
                   "fused_blocks", "boundary_mask")


def _arch_metadata(cfg) -> dict:
    """What a checkpoint stores under ``extra.arch`` to be rebuilt
    (:func:`..checkpoint.resolve_model_cfg`): a ResNet's ``variant`` and
    ``space_to_depth``, as the JAX worker writes them; for another
    architecture its ``arch`` and ``variant``."""
    model_cfg = getattr(cfg, "model", None)
    arch = getattr(model_cfg, "arch", None) or "resnet"
    if arch != "resnet":
        return {"arch": arch, "variant": getattr(model_cfg, "variant", None)
                or "swin_b"}
    return {"variant": getattr(model_cfg, "variant", None) or "resnet50",
            "space_to_depth": bool(getattr(model_cfg, "space_to_depth",
                                           False))}


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
    optimizer, ``schedule(count)`` is its learning rate per update,
    ``accumulate_steps`` the micro-steps per update and ``ema`` the decay
    of the parameters' shadow (0: none)."""

    make: Callable
    schedule: Callable[[int], float]
    accumulate_steps: int = 1
    ema: float = 0.0


def build_optimizer(opt_cfg, steps_per_epoch: int, epochs: int = 0
                    ) -> Transform:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) or SGD(momentum=0.9) over
    :func:`build_lr_schedule` (reference ``train.py:356-369``).

    ``opt.accumulate_steps: k`` averages the gradients of k micro-batches
    and updates every k-th call (optax ``MultiSteps``); the schedule
    counts updates, so ``steps_per_epoch`` is divided by k.  ``opt.ema:
    d`` keeps ``d * e + (1 - d) * p`` of the parameters after each update
    (JAX ``train.py:195-281``).  :class:`TrainState` applies both.
    ``opt.zero1`` partitions the optimizer state over devices and waits
    for the multi-GPU slice.
    """
    if getattr(opt_cfg, "zero1", False):
        raise NotImplementedError(
            "opt.zero1 is not ported yet (ROADMAP Queue 1 item 8, "
            "multi-GPU)")
    accum = int(getattr(opt_cfg, "accumulate_steps", 1) or 1)
    spe = max(int(steps_per_epoch), 1)
    if accum > 1:
        spe = max(spe // accum, 1)
    schedule = build_lr_schedule(opt_cfg, spe, epochs=epochs)
    ema = float(getattr(opt_cfg, "ema", 0.0) or 0.0)
    if ema and not 0.0 < ema < 1.0:
        raise ValueError(f"opt.ema must be in (0, 1), got {ema}")
    if getattr(opt_cfg, "type", "adam") == "sgd":
        def make(params):
            return torch.optim.SGD(params, lr=schedule(0), momentum=0.9)
    else:
        def make(params):
            return torch.optim.Adam(params, lr=schedule(0),
                                    betas=(0.9, 0.999), eps=1e-8)
    return Transform(make, schedule, max(accum, 1), ema)


class TrainState:
    """Model, optimizer and counters (the JAX ``TrainState`` with its
    optax state).

    ``step`` counts micro-steps (every :meth:`apply_gradients` call, as
    the JAX ``TrainState.step``; a checkpoint's ``step``); ``updates``
    counts optimizer updates and is the count the learning-rate schedule
    reads.  Both are host integers: the rate of each update is set before
    ``optimizer.step()``, and nothing is read back from the device.

    With ``accumulate_steps = k > 1`` the gradients collect in
    ``acc_grads`` as the running mean ``acc + (g - acc) / (n + 1)``
    (``mini_step`` = n) and every k-th call updates with their mean
    (optax 0.2.6 ``MultiSteps``).  With ``ema_decay`` the float32 shadow
    ``ema`` of the parameters (not the batch-norm buffers) moves after
    each update; :meth:`eval_weights` puts it in the model.
    """

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], step: int = 0,
                 accumulate_steps: int = 1, ema_decay: float = 0.0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = int(step)
        self.updates = int(step) // int(accumulate_steps)
        self.accumulate_steps = int(accumulate_steps)
        self.ema_decay = float(ema_decay)
        self.mini_step = 0
        self.acc_grads = ([torch.zeros_like(p) for p in self.params()]
                          if self.accumulate_steps > 1 else None)
        self.ema = ([p.detach().float().clone() for p in self.params()]
                    if self.ema_decay else None)

    def params(self) -> list:
        """The optimizer's parameters, in ``model.parameters()`` order."""
        return [p for group in self.optimizer.param_groups
                for p in group["params"]]

    def apply_gradients(self) -> None:
        """One micro-step over the parameters' ``.grad``: accumulate, or
        update at ``schedule(updates)``; ``step += 1``."""
        self.step += 1
        params = self.params()
        if self.acc_grads is not None:
            n = self.mini_step
            delta = torch._foreach_sub([p.grad for p in params],
                                       self.acc_grads)
            torch._foreach_div_(delta, n + 1)
            torch._foreach_add_(self.acc_grads, delta)
            self.mini_step = (n + 1) % self.accumulate_steps
            if self.mini_step:
                return
            for p, acc in zip(params, self.acc_grads):
                p.grad = acc
        lr = self.schedule(self.updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.updates += 1
        if self.acc_grads is not None:
            torch._foreach_zero_(self.acc_grads)
        if self.ema is not None:
            # decay * e + (1 - decay) * p, rounded as the JAX expression.
            d = self.ema_decay
            torch._foreach_mul_(self.ema, d)
            torch._foreach_add_(self.ema, torch._foreach_mul(
                [p.detach().float() for p in params], 1.0 - d))

    @contextlib.contextmanager
    def eval_weights(self):
        """Inside, the model's parameters are the EMA shadow (``opt.ema``;
        the batch-norm buffers stay the live ones); else the live ones."""
        if self.ema is None:
            yield self.model
            return
        params = self.params()
        live = [p.data for p in params]
        for p, e in zip(params, self.ema):
            p.data = e
        try:
            yield self.model
        finally:
            for p, x in zip(params, live):
                p.data = x


def create_state(model: torch.nn.Module, tx: Transform) -> TrainState:
    """Wrap an initialised model and a fresh optimizer over its
    parameters (and the EMA shadow of their current values)."""
    return TrainState(model, tx.make(model.parameters()), tx.schedule,
                      accumulate_steps=tx.accumulate_steps, ema_decay=tx.ema)


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
        with tracing.span("train.forward", device=device):
            imgs = _to_float(_on(device, images))
            labels, mask = _on(device, labels), _on(device, mask).float()
            _set_mode(model, True)
            window = (contextlib.nullcontext() if bn_stats_rows is None
                      else model.stats_window(bn_stats_rows))
            with window:
                logits, _ = model(imgs)
            loss, _ = loss_fn(logits, labels, mask)
        with tracing.span("train.backward", device=device):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with tracing.span("train.optimizer", device=device):
            state.apply_gradients()
        rows = mask.sum()
        return state, {"loss_sum": loss.detach() * rows, "count": rows}

    return step


def make_tail_step(loss_fn: Callable, model: torch.nn.Module, n_tail: int,
                   train_step: Callable) -> Optional[Callable]:
    """The step for an epoch's ragged last batch (``train.py:987-1005``).

    Tail batches arrive padded with the padding last (``pipeline.
    InputPipeline._local_slice``), so a window of exactly ``n_tail``
    leading rows sees only valid samples.  A ghost window ``0 < G <=
    n_tail`` already does, and then the regular step serves, as it does
    for a model without batch-norm (no ``stats_window``: the Swin), whose
    rows never meet.  ``None`` when there is no ragged tail.  A
    ``fused_blocks`` model trains no ragged tail, as the JAX worker drops
    it (``train.py:905-909``): build its pipeline with
    ``drop_remainder=True`` (``n_tail`` 0).
    """
    if not n_tail:
        return None
    if getattr(model, "stats_window", None) is None:
        return train_step
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
    batches = iter(pipeline.epoch(epoch, start_batch=start_batch))
    i = start_batch
    while True:
        with tracing.span("train.wait", key=i):
            batch = next(batches, None)
        if batch is None:
            break
        step = (tail_step if tail_step is not None and i == nb - 1
                else train_step)
        with tracing.span("train.step", key=i):
            state, m = step(state, batch.images, batch.labels, batch.mask)
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
        i += 1
        if step_hook is not None and step_hook(state, i):
            break
    if sums is not None:
        with tracing.span("train.fetch"):
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


def get_arrays(model, pipeline, forward_step: Optional[Callable] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(targets, logits, features, scores)`` of a whole split, numpy.

    The JAX ``get_arrays`` (``train.py:652-690``, reference ``train.py:
    200-234``): the same tuple in the same order, ``targets`` float32 (a
    reference quirk), padded rows dropped by the batch mask.  The kept
    rows stay on the device, selected by indices made from the host mask
    (no wait per batch), and are copied to the host once at the end.  An
    empty split gives ``(0,)``, ``(0, C)``, ``(0, F)`` and ``(0, C)``
    float32 arrays sized from the ``logits`` and ``fc`` heads.  A process
    of a multi-process launch raises (Queue 1 item 8).
    """
    _check_one_process("multi-process extraction (get_arrays)")
    if forward_step is None:
        forward_step = make_forward_step()
    device = _device_of(model)
    parts = []
    for batch in pipeline.epoch(0):
        logits, features, scores = forward_step(model, batch.images)
        mask = np.asarray(batch.mask) > 0
        labels = _on(device, np.asarray(batch.labels))
        rows = (labels, logits, features, scores)
        if not mask.all():
            keep = _on(device, np.flatnonzero(mask))
            rows = tuple(t.index_select(0, keep) for t in rows)
        parts.append(rows)
    if not parts:
        n_out = model.logits.weight.shape[0]
        fc = model.fc if hasattr(model, "fc") else model.resnet_base.fc
        n_feat = fc.weight.shape[0]
        return (np.zeros((0,), np.float32),
                np.zeros((0, n_out), np.float32),
                np.zeros((0, n_feat), np.float32),
                np.zeros((0, n_out), np.float32))
    labels, logits, features, scores = (
        torch.cat(column).cpu().numpy() for column in zip(*parts))
    return labels.astype(np.float32), logits, features, scores


# -- worker: one (protocol, loss) run (train.py:69-112, 706-737, 807-1303) --

def set_seeds(seed: int) -> torch.Generator:
    """Seed the host RNGs; return the CPU generator the initial weights
    are drawn from (the JAX ``set_seeds`` returns the root PRNG key)."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(int(seed))


class GracefulShutdown:
    """Preemption handling: SIGTERM/SIGUSR1 request a clean stop.

    The signal lets the current epoch (or, in ``preempt_mode: step``, the
    current step) finish and its checkpoint land, and the run exits
    cleanly, so a resume loses no completed work.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGUSR1)):
        self.requested = False
        self._previous = {}
        self._signals = signals

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for sig in self._signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        return False


def _resize_for_crop(crop: int) -> int:
    """Shorter-side resize for a crop: the reference's Resize(256) ->
    Crop(224) for every crop <= 256, scaled by 256/224 beyond it."""
    return 256 if crop <= 256 else round(crop * 256 / 224)


def _make_reader(cfg, crop: int = 224):
    """Reader per ``cfg.data.reader``: ``auto`` (default) | ``native`` |
    ``native_batch`` | ``pil`` | ``synthetic``.  ``auto`` takes the
    native batch reader where its library builds, else PIL."""
    kind = getattr(cfg.data, "reader", "auto") or "auto"
    resize = _resize_for_crop(crop)
    if kind == "synthetic":
        return SyntheticReader(crop=crop, seed=int(cfg.seed))
    if kind in ("auto", "native", "native_batch"):
        from .native.jpeg import (NativeBatchReader, NativeReader,
                                  native_available)
        if native_available():
            if kind in ("auto", "native_batch"):
                workers = int(getattr(cfg, "workers", 4) or 4)
                return NativeBatchReader(crop=crop, resize=resize,
                                         threads=workers)
            return NativeReader(crop=crop, resize=resize)
        if kind != "auto":
            raise RuntimeError("native reader requested but the osijpeg "
                               "library could not be built")
    import importlib.util
    if importlib.util.find_spec("PIL") is None:
        raise RuntimeError(
            f"data.reader: {kind} needs the native JPEG library or PIL, and "
            "neither is available here; set data.reader: synthetic")
    return PILReader(crop=crop, resize=resize)


def decode_serving_paths(paths, image_size: int, reader=None, out=None):
    """Image paths -> one ``uint8 [N, image_size, image_size, 3]`` batch
    by the serving decode policy (JAX ``train.py:740-765``): the ``auto``
    reader (the native batch reader, else PIL), shorter-side resize, then
    center crop, the eval transform.

    Returns ``(batch, reader)``, so that callers keep the reader (the
    native batch reader owns a thread pool) across calls.  With ``out``
    (a ``uint8 [N, image_size, image_size, 3]`` array) a reader of one
    path at a time writes its images into it and ``out`` is returned; a
    batch reader returns its own array.
    """
    if reader is None:
        from .config import NameSpace
        reader = _make_reader(NameSpace({"data": {"reader": "auto"},
                                         "seed": 0}), crop=image_size)
    paths = list(paths)
    if not paths:
        return np.zeros((0, image_size, image_size, 3), np.uint8), reader
    if hasattr(reader, "read_batch"):
        return reader.read_batch(paths, [None] * len(paths)), reader
    return np.stack([reader(p, None) for p in paths], out=out), reader


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               "item 8, multi-GPU)")


def _check_one_process(what: str) -> None:
    """A process started by a multi-process launch raises: multi-GPU runs
    wait for Queue 1 item 8."""
    launch = ("OSI_COORDINATOR", "OSI_DISTRIBUTED")
    if any(os.environ.get(k) for k in launch) or max(
            int(os.environ.get(k, "1") or 1)
            for k in ("WORLD_SIZE", "OSI_NUM_PROCESSES")) > 1:
        raise _not_ported(what)


def _check_single_process(cfg) -> None:
    """The multi-process, shard_map and ZeRO-1 modes wait for Queue 1
    item 8."""
    _check_one_process("a multi-process run")
    if (getattr(cfg, "parallel_mode", "gspmd") or "gspmd") == "shard_map":
        raise _not_ported("parallel_mode: shard_map")
    if getattr(cfg.opt, "zero1", False):
        raise _not_ported("opt.zero1")


def worker(cfg, device=None) -> dict:
    """Train one (protocol, loss) run end to end; returns summary info.

    A port of JAX ``train.py:807-1303``: label surgery and the n_classes
    rule, the ragged-tail policy, resume (at an epoch or, from a mid-epoch
    save's ``extra.progress``, at a batch) and finetune, preemption and
    step budgets, validation (on the EMA shadow with ``opt.ema``), γ =
    conf_kn + conf_unk selection with ``_curr`` / ``_best`` checkpoints
    (written by :class:`~.checkpoint.AsyncCheckpointer` unless
    ``async_checkpoint: false``), early stopping, five scalars an epoch
    and the log file.  Runs on the card (``cuda``, or ``cuda:{cfg.gpu}``)
    unless ``device`` names another; without a card the default raises
    torch's own error.  Returns ``{"best_score", "last_epoch",
    "n_classes", "stopped_mid_epoch", "device_ids"}`` (``device_ids``:
    the CUDA index, ``[]`` on the CPU).
    """
    _check_single_process(cfg)
    generator = set_seeds(cfg.seed)
    if device is None:
        gpu = getattr(cfg, "gpu", None)
        device = "cuda" if gpu is None else f"cuda:{int(gpu)}"
    device = torch.device(device)

    best_score = 0.0
    start_epoch = 0
    start_batch = 0  # mid-epoch resume offset (checkpoint extra.progress)

    out_dir = pathlib.Path(cfg.output_directory)
    out_dir.mkdir(parents=True, exist_ok=True)
    log = configure_logger(logfile=out_dir / cfg.log_name)
    log.info(f"config: {_to_dumpable(cfg.dict())}")
    if getattr(cfg, "compilation_cache", None):
        log.info("compilation_cache is an XLA compile cache: it has no "
                 "effect on this port")

    # -- datasets + label surgery (reference train.py:270-293) -------------
    train_file = pathlib.Path(str(cfg.data.train_file).format(cfg.protocol))
    val_file = pathlib.Path(str(cfg.data.val_file).format(cfg.protocol))
    if not (train_file.exists() and val_file.exists()):
        raise FileNotFoundError("train/validation file does not exist")
    train_ds = ImagenetDataset(train_file, cfg.data.imagenet_path)
    val_ds = ImagenetDataset(val_file, cfg.data.imagenet_path)
    if cfg.loss.type == "garbage":
        train_ds.replace_negative_label()
        val_ds.replace_negative_label()
    elif cfg.loss.type == "softmax":
        train_ds.remove_negative_label()  # train only (train.py:291-293)

    # -- n_classes rule (reference train.py:330-336) ------------------------
    if cfg.loss.type == "entropic":
        n_classes = train_ds.label_count - 1
    else:
        n_classes = train_ds.label_count
    class_weights = (train_ds.calculate_class_weights()
                     if cfg.loss.type == "garbage" else None)
    # loss.fused: true | false | auto (auto: the kernels on the card).
    loss_fn = make_loss_fn(cfg.loss.type,
                           unk_weight=float(getattr(cfg.loss, "w", 1.0)),
                           class_weights=class_weights,
                           fused=getattr(cfg.loss, "fused", "auto"))

    # -- model + input pipelines ----------------------------------------------
    image_size = int(getattr(cfg.data, "image_size", 224) or 224)
    workers = int(getattr(cfg, "workers", 4) or 4)
    batch_size = int(cfg.batch_size)
    reader = _make_reader(cfg, crop=image_size)
    # Ragged-tail policy (train.py:882-911): masked (default) trains the
    # tail through a step whose batch-norm window covers exactly its valid
    # rows; drop skips it.  Fused blocks train no ragged tail.
    tail_mode = getattr(cfg, "train_tail", None) or "masked"
    if tail_mode not in ("masked", "drop"):
        raise ValueError(f"train_tail must be 'masked' or 'drop', "
                         f"got {tail_mode!r}")
    preempt_mode = getattr(cfg, "preempt_mode", "epoch") or "epoch"
    if preempt_mode not in ("epoch", "step"):
        raise ValueError(f"preempt_mode must be 'epoch' or 'step', "
                         f"got {preempt_mode!r}")
    model = build_model(cfg, n_classes, device=device, generator=generator)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    n_tail = len(train_ds) % batch_size
    if tail_mode == "masked" and n_tail and getattr(model, "fused_blocks",
                                                     False):
        log.info("train_tail=masked is unsupported with fused blocks; "
                 "dropping the ragged tail batch instead")
        tail_mode = "drop"
    drop_remainder = tail_mode == "drop" and len(train_ds) >= batch_size
    pin = device.type == "cuda"
    train_pipe = pipeline_from_dataset(
        train_ds, batch_size, is_training=True, seed=cfg.seed,
        num_workers=workers, reader=reader, drop_remainder=drop_remainder,
        pin_memory=pin)
    val_pipe = pipeline_from_dataset(
        val_ds, batch_size, is_training=False, seed=cfg.seed,
        num_workers=workers, reader=reader, pin_memory=pin)

    # -- optimizer / state, resume / finetune (reference train.py:350-388) --
    try:
        tx = build_optimizer(cfg.opt,
                             steps_per_epoch=max(len(train_pipe), 1),
                             epochs=int(getattr(cfg, "epochs", 0) or 0))
        checkpoint = getattr(cfg, "checkpoint", None)
        finetune = getattr(cfg, "train_mode", "train") == "finetune"
        if checkpoint and finetune:
            # Weights only, from a port or reference .pth; training starts
            # at the file's epoch with a fresh optimizer (and an EMA
            # shadow of the loaded weights) and best 0.
            start_epoch, _ = load_weights_any_format(checkpoint, model)
        state = create_state(model, tx)
        if checkpoint and not finetune:
            _, start_epoch, best_score, extra_meta = load_checkpoint(
                checkpoint, state, restore_opt=True, return_extra=True)
            progress_meta = extra_meta.get("progress")
            if progress_meta:
                start_epoch = int(progress_meta["epoch"])
                start_batch = int(progress_meta["next_batch"])
                if not 0 <= start_batch < len(train_pipe):
                    raise ValueError(
                        f"mid-epoch checkpoint resumes at batch "
                        f"{start_batch} but the training set now has "
                        f"{len(train_pipe)} batches/epoch — the dataset "
                        "or batch_size changed since the checkpoint was "
                        "saved")
    except Exception:
        # The try/finally below does not guard these; release the
        # pipelines' decode threads before raising.
        train_pipe.close()
        val_pipe.close()
        raise
    if checkpoint:
        log.info(f"Best score of loaded model: {best_score:.3f}. "
                 "0 is for fine tuning")
        log.info(f"Loaded {checkpoint} at epoch {start_epoch}"
                 + (f", batch {start_batch}" if start_batch else ""))

    train_step = make_train_step(loss_fn)
    tail_step = None
    if n_tail and not drop_remainder and tail_mode == "masked":
        tail_step = make_tail_step(loss_fn, model, n_tail, train_step)
    eval_step = make_eval_step(loss_fn, cfg.loss.type, n_classes)

    patience = int(getattr(cfg, "patience", 0) or 0)
    early_stopping = (EarlyStopping(patience=patience)
                      if patience > 0 else None)
    t_metrics = defaultdict(AverageMeter)
    v_metrics = defaultdict(AverageMeter)

    log.info("============ Data ============")
    log.info(f"train_len:{len(train_ds)}, labels:{train_ds.label_count}")
    log.info(f"val_len:{len(val_ds)}, labels:{val_ds.label_count}")
    log.info("========== Training ==========")
    log.info(f"Initial epoch: {start_epoch}")
    log.info(f"Last epoch: {cfg.epochs}")
    log.info(f"Batch size: {cfg.batch_size}")
    log.info(f"workers: {workers}")
    log.info(f"Loss: {cfg.loss.type}")
    log.info(f"optimizer: {cfg.opt.type}")
    log.info(f"Learning rate: {cfg.opt.lr}")
    log.info(f"Device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                    if device.type == "cuda" else ""))
    log.info("Training...")
    writer = SummaryWriter(log_dir=out_dir,
                           filename_suffix="-" + str(cfg.log_name))

    # profile.{dir, epochs}: a torch.profiler trace of those epochs.
    profile_cfg = getattr(cfg, "profile", None)
    profile_dir = getattr(profile_cfg, "dir", None) if profile_cfg else None
    profile_epochs = set(
        (getattr(profile_cfg, "epochs", None) or [start_epoch])
        if profile_cfg else [])

    # The epoch loop snapshots the state on the device and goes on while a
    # thread writes; the finally below drains the queue, so _curr is on
    # disk when worker() returns.
    ckpt_writer = (AsyncCheckpointer()
                   if getattr(cfg, "async_checkpoint", True) else None)
    arch = _arch_metadata(cfg)

    def _save(f_name, ep, score, progress=None):
        extra = {"arch": arch}
        if progress:
            extra["progress"] = progress
        if ckpt_writer is not None:
            ckpt_writer.save(f_name, state, ep, score, extra=extra)
        else:
            save_checkpoint(f_name, state, ep, score, extra=extra)

    # Step-granular preemption and budget (train.py:1085-1173):
    #   preempt_mode: epoch (default) finishes the epoch on SIGTERM; step
    #     saves a mid-epoch _curr (extra.progress) at the next check and
    #     exits, and a resume retraces the run bitwise;
    #   checkpoint_every_steps: N > 0 also writes a mid-epoch _curr every
    #     N steps; preempt_check_steps: the signal-check cadence;
    #   max_steps: stop after this many training steps (micro-steps).
    ckpt_every = int(getattr(cfg, "checkpoint_every_steps", 0) or 0)
    check_every = max(int(getattr(cfg, "preempt_check_steps", 16) or 16), 1)
    max_steps = int(getattr(cfg, "max_steps", 0) or 0)
    nb_train = len(train_pipe)
    interrupted = {"at": None}   # batch count the epoch stopped after
    budget_done = {"hit": False}
    hooks_on = bool(ckpt_every or max_steps or preempt_mode == "step")
    curr_name = str(out_dir / cfg.name) + "_curr.pth"

    # A resumed run whose budget is spent trains nothing and leaves the
    # checkpoint it resumed from as it is.
    budget_spent = bool(max_steps
                        and start_epoch * nb_train + start_batch >= max_steps)

    def make_step_hook(ep):
        def hook(st, done):
            total = ep * nb_train + done
            stop = False
            if preempt_mode == "step" and done % check_every == 0:
                stop = shutdown.requested
            if max_steps and total >= max_steps:
                if done >= nb_train:
                    budget_done["hit"] = True  # the boundary path saves
                else:
                    stop = True
            if done >= nb_train:
                return False
            if stop or (ckpt_every and done % ckpt_every == 0):
                # Epoch ep is not finished: store ep - 1 as the completed
                # epochs; progress holds the exact point.
                _save(curr_name, ep - 1, best_score,
                      progress={"epoch": ep, "next_batch": done})
            if stop:
                interrupted["at"] = done
            return stop

        return hook

    epoch = start_epoch - 1
    if budget_spent:
        log.info(f"max_steps={max_steps} already reached at resume "
                 f"(epoch {start_epoch}, batch {start_batch}); nothing to "
                 "train")
        if start_batch:
            epoch = start_epoch
            interrupted["at"] = start_batch
    shutdown = GracefulShutdown()
    shutdown.__enter__()
    try:
        for epoch in range(start_epoch,
                           start_epoch if budget_spent else cfg.epochs):
            epoch_time = time.time()
            profiler = None
            if profile_dir is not None and epoch in profile_epochs:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            try:
                train_epoch(state, train_pipe, epoch, train_step, t_metrics,
                            tail_step=tail_step,
                            start_batch=(start_batch if epoch == start_epoch
                                         else 0),
                            step_hook=(make_step_hook(epoch) if hooks_on
                                       else None))
            finally:
                if profiler is not None:
                    profiler.stop()
                    trace = pathlib.Path(profile_dir) / \
                        f"{cfg.name}_epoch{epoch}.trace.json"
                    trace.parent.mkdir(parents=True, exist_ok=True)
                    profiler.export_chrome_trace(str(trace))
                    log.info(f"Profiler trace for epoch {epoch} written "
                             f"to {trace}")
            train_time = time.time() - epoch_time

            if interrupted["at"] is not None:
                log.info(
                    f"stopped mid-epoch at epoch {epoch} after batch "
                    f"{interrupted['at']}/{nb_train} "
                    f"(resume from {cfg.name}_curr.pth retraces the run "
                    "bitwise)")
                break

            # opt.ema: validation, γ selection and _best use the shadow;
            # _curr keeps the raw parameters, so a resume stays bitwise.
            with state.eval_weights():
                validate(model, val_pipe, epoch, eval_step, v_metrics)
            curr_score = v_metrics["conf_kn"].avg + v_metrics["conf_unk"].avg

            writer.add_scalar("train/loss", t_metrics["j"].avg, epoch)
            writer.add_scalar("val/loss", v_metrics["j"].avg, epoch)
            writer.add_scalar("val/conf_kn", v_metrics["conf_kn"].avg, epoch)
            writer.add_scalar("val/conf_unk", v_metrics["conf_unk"].avg,
                              epoch)
            writer.add_scalar("train/imgs_per_sec", t_metrics["imgs/s"].avg,
                              epoch)
            writer.flush()

            val_time = time.time() - train_time - epoch_time
            log.info(
                f"loss:{cfg.loss.type} protocol:{cfg.protocol} ep:{epoch} "
                f"train:{dict(t_metrics)} val:{dict(v_metrics)} "
                f"t:{train_time:.1f}s v:{val_time:.1f}s")

            _save(curr_name, epoch, curr_score)
            if curr_score > best_score:
                best_score = curr_score
                ckpt_name = str(out_dir / cfg.name) + "_best.pth"
                log.info(f"Saving best model {ckpt_name} at epoch: {epoch}")
                with state.eval_weights():
                    _save(ckpt_name, epoch, best_score)

            if early_stopping is not None:
                early_stopping(metrics=curr_score, loss=False)
                if early_stopping.early_stop:
                    log.info("early stop")
                    break
            if shutdown.requested:
                log.info(f"shutdown requested; stopped cleanly after epoch "
                         f"{epoch} (resume from {cfg.name}_curr.pth)")
                break
            if budget_done["hit"]:
                log.info(f"max_steps={max_steps} reached at the epoch "
                         f"{epoch} boundary")
                break
    finally:
        # Restore the signal handlers, release the pipelines' threads,
        # flush the scalar record and drain the checkpoint queue (raising a
        # write error, chained onto any error in flight).
        shutdown.__exit__()
        train_pipe.close()
        val_pipe.close()
        writer.close()
        if ckpt_writer is not None:
            ckpt_writer.close()
    log.info("Training finished")
    if device.type == "cuda":
        device_ids = [device.index if device.index is not None
                      else torch.cuda.current_device()]
    else:
        device_ids = []
    return {"best_score": best_score, "last_epoch": epoch,
            "n_classes": n_classes,
            "stopped_mid_epoch": interrupted["at"],
            "device_ids": device_ids}
