"""Checkpoints in the reference ``.pth`` contract, written atomically.

Counterpart of :mod:`openset_imagenet_tpu.checkpoint` for the files the
port writes: a ``torch.save`` dict ``{'model_state_dict', 'epoch',
'step', 'best_score', 'opt_state_dict'}`` whose state-dict keys follow
the reference layout (see :mod:`.convert`), so the reference reads it.
``epoch`` is stored as ``epoch + 1``, the epoch to resume at, as the JAX
package and the reference store it; ``step`` counts micro-steps (the JAX
``TrainState.step``); ``opt_state_dict`` is the torch optimizer's
``state_dict()`` (empty for a weights-only save).  The rest of the
:class:`~.train.TrainState` rides in further plain keys: ``updates`` (the
schedule's count), ``ema_state_dict`` (``opt.ema``'s shadow) and
``accumulation`` (``{'mini_step', 'grads'}`` of ``opt.accumulate_steps``),
and ``extra``, the worker's metadata map (``{'arch': {'variant',
'space_to_depth'}}``, and ``{'progress': {'epoch', 'next_batch'}}`` on a
mid-epoch save).  Every file is written to ``<file>.tmp`` and then
renamed over ``<file>``, so a crash never leaves a torn ``_curr.pth``;
files are read with ``weights_only=True``.  Reading the JAX package's
native msgpack checkpoints is not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import pickle
import queue
import threading
import zipfile
from pathlib import Path
from typing import Optional, Tuple

import torch

from .convert import load_into, strip_module_prefix


# torch.save's legacy (pre-zip) format starts with a protocol-2 pickle of
# its magic number.
_LEGACY_HEAD = b"\x80\x02\x8a\x0a"


def _read(path, mmap: bool = False) -> dict:
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"Checkpoint file '{path}' not found")
    is_zip = zipfile.is_zipfile(path)
    if not is_zip:
        with open(path, "rb") as f:
            if f.read(len(_LEGACY_HEAD)) != _LEGACY_HEAD:
                raise ValueError(
                    f"{path} is not a torch .pth file (the JAX package's "
                    "native msgpack checkpoints are not read yet, ROADMAP "
                    "Queue 1 item 7)")
    # Only the zip format can be memory-mapped.
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=mmap and is_zip)


def _named(model, tensors) -> dict:
    return {name: t for (name, _), t in zip(model.named_parameters(),
                                            tensors)}


def _snapshot(state, epoch: int, best_score: float,
              extra: Optional[dict] = None) -> dict:
    """The payload of a checkpoint, every tensor cloned on its device.

    ``state`` is a :class:`~.train.TrainState` or a bare model (weights
    only).  The clones are what the write reads, so the optimizer's and
    the batch-norm's in-place updates after this call do not reach the
    file (the counterpart of the JAX copy of donated buffers).
    """
    model = getattr(state, "model", state)
    payload = {"epoch": int(epoch) + 1,
               "step": int(getattr(state, "step", 0)),
               "best_score": float(best_score)}
    if extra:
        payload["extra"] = extra
    payload["model_state_dict"] = _clone(model.state_dict())
    optimizer = getattr(state, "optimizer", None)
    payload["opt_state_dict"] = ({} if optimizer is None else
                                 _clone(optimizer.state_dict()))
    if optimizer is not None:
        payload["updates"] = int(state.updates)
        if state.ema is not None:
            payload["ema_state_dict"] = _named(model, _clone(state.ema))
        if state.acc_grads is not None:
            payload["accumulation"] = {
                "mini_step": int(state.mini_step),
                "grads": _named(model, _clone(state.acc_grads))}
    return payload


def _tree_map(fn, tree):
    """``fn`` on every tensor of nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _clone(tree):
    return _tree_map(lambda t: t.detach().clone(), tree)


def _write(path, payload: dict) -> None:
    """Host copy of a snapshot, then ``<path>.tmp`` and an atomic rename.

    ``torch.save`` goes to an open file, so the archive's inner name (and
    with it every byte) does not depend on the file's name.
    """
    payload = _tree_map(torch.Tensor.cpu, payload)
    payload["model_state_dict"] = {
        k: v.contiguous() for k, v in payload["model_state_dict"].items()}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        torch.save(payload, f)
    tmp.replace(path)  # atomic: a crash never corrupts _curr.pth


def save_checkpoint(path, state, epoch: int, best_score: float,
                    extra: Optional[dict] = None) -> None:
    """Write ``state`` (a :class:`~.train.TrainState`, or a bare model for a
    weights-only file) as a reference ``.pth``.

    ``epoch`` is the epoch that just finished and is stored as ``epoch +
    1`` (JAX ``checkpoint.py:45-83``); ``extra`` is the worker's metadata
    map.
    """
    _write(path, _snapshot(state, epoch, best_score, extra))


class AsyncCheckpointer:
    """Overlap checkpoint writes with the next epoch's compute.

    ``save()`` snapshots the state on its device (:func:`_snapshot`:
    clones, queued on the device without a host sync) and hands the host
    copy and the atomic write to one writer thread; files are written in
    submission order, so ``_curr`` lands before ``_best`` (JAX
    ``checkpoint.py:86-162``).  The queue holds two snapshots (one
    epoch's ``_curr`` and ``_best``): a writer slower than the loop makes
    ``save()`` block instead of piling copies of the state up in device
    memory.  A write error is raised by the next ``save()`` or ``wait()``;
    ``close()`` drains the queue; ``save()`` after ``close()`` raises.
    The bytes are those of :func:`save_checkpoint`.
    """

    def __init__(self) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._error: Optional[BaseException] = None
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="osi-ckpt-writer")
        self._worker.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                path, payload, ready = item
                if ready is not None:
                    ready.synchronize()
                _write(path, payload)
            except BaseException as e:  # raised by the next save()/wait()
                self._error = e
            finally:
                self._q.task_done()

    def _check(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def save(self, path, state, epoch: int, best_score: float,
             extra: Optional[dict] = None) -> None:
        """Snapshot ``state`` and queue its write (blocks while two writes
        are pending)."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._check()
        payload = _snapshot(state, epoch, best_score, extra)
        ready = None
        model = getattr(state, "model", state)
        if next(model.parameters()).is_cuda:
            # The writer thread's copies wait for the clones of this
            # thread's stream.
            ready = torch.cuda.Event()
            ready.record()
        self._q.put((path, payload, ready))

    def wait(self) -> None:
        """Block until every queued checkpoint is on disk."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._q.join()
        self._check()

    def close(self) -> None:
        self.wait()
        self._closed = True
        self._q.put(None)
        self._worker.join()


class CheckpointShapeError(ValueError):
    """Checkpoint tensor shapes disagree with the model being restored."""


def _load_weights(model, state_dict, path) -> None:
    """``load_into`` after a check of every shape, so that a wrong
    ``n_classes`` or variant names its keys (JAX ``checkpoint.py:
    172-197``)."""
    source = strip_module_prefix(state_dict)
    mismatched = [
        f"{k}: checkpoint {tuple(source[k].shape)} vs model "
        f"{tuple(v.shape)}"
        for k, v in model.state_dict().items()
        if k in source and tuple(source[k].shape) != tuple(v.shape)]
    if mismatched:
        shown = "; ".join(mismatched[:5])
        if len(mismatched) > 5:
            shown += f"; ... ({len(mismatched) - 5} more)"
        raise CheckpointShapeError(
            f"{path}: checkpoint shapes do not match the model being "
            f"restored (wrong n_classes / fc_layer_dim / model variant?): "
            f"{shown}")
    load_into(model, source)


def _copy_named(model, targets, source: dict, what: str, path) -> None:
    names = [name for name, _ in model.named_parameters()]
    if sorted(names) != sorted(source):
        raise ValueError(f"{path}: {what} does not cover the model's "
                         "parameters")
    with torch.no_grad():
        for name, t in zip(names, targets):
            t.copy_(source[name])


def load_checkpoint(path, state, restore_opt: bool = True,
                    return_extra: bool = False) -> Tuple:
    """Load a ``.pth`` into ``state`` in place; returns ``(state, epoch,
    best_score)`` and, with ``return_extra``, the ``extra`` map (``{}``
    when absent).  JAX ``checkpoint.py:200-236``.

    ``state`` is a :class:`~.train.TrainState` or a bare model.  For a
    TrainState, ``restore_opt=True`` restores the optimizer, the counters
    and the EMA and accumulation buffers (resume); ``restore_opt=False``
    restores the weights only and reports a best score of 0 (finetune).
    ``epoch`` is the stored ``epoch + 1``, the epoch to resume at.  A
    missing file raises ``FileNotFoundError``, shapes that disagree
    :class:`CheckpointShapeError`, a missing key ``KeyError``, and a file
    without the optimizer state a resume needs ``ValueError``.
    """
    payload = _read(path)
    model = getattr(state, "model", state)
    _load_weights(model, payload["model_state_dict"], path)
    best = float(payload.get("best_score", 0.0))
    optimizer = getattr(state, "optimizer", None)
    if optimizer is not None:
        if restore_opt:
            _restore_train_state(state, payload, path)
        else:
            best = 0.0
    out = (state, int(payload.get("epoch", 0)), best)
    if return_extra:
        return out + (payload.get("extra") or {},)
    return out


def _restore_train_state(state, payload: dict, path) -> None:
    if not payload.get("opt_state_dict"):
        raise ValueError(f"{path} holds no optimizer state")
    state.optimizer.load_state_dict(payload["opt_state_dict"])
    state.step = int(payload.get("step", 0))
    state.updates = int(payload.get("updates", state.step))
    if state.ema is not None:
        if "ema_state_dict" not in payload:
            raise ValueError(f"{path} holds no EMA shadow (opt.ema)")
        _copy_named(state.model, state.ema, payload["ema_state_dict"],
                    "ema_state_dict", path)
    if state.acc_grads is not None:
        acc = payload.get("accumulation")
        if acc is None:
            raise ValueError(f"{path} holds no accumulated gradients "
                             "(opt.accumulate_steps)")
        _copy_named(state.model, state.acc_grads, acc["grads"],
                    "accumulation", path)
        state.mini_step = int(acc["mini_step"])


def load_weights_any_format(path, model) -> Tuple[int, float]:
    """Load weights only (parameters and batch-norm buffers) from a port
    or reference ``.pth`` into ``model``; returns ``(epoch, best_score)``
    as stored (JAX ``checkpoint.py:239-270``; the finetune path).  A
    native msgpack file of the JAX package raises ``ValueError`` (ROADMAP
    Queue 1 item 7)."""
    _, epoch, best = load_checkpoint(path, model)
    return epoch, best


def read_metadata(path) -> dict:
    """``{epoch, step, best_score}`` and ``extra`` when present, read
    without loading the weights (memory-mapped)."""
    payload = _read(path, mmap=True)
    meta = {"epoch": int(payload.get("epoch", 0)),
            "step": int(payload.get("step", 0)),
            "best_score": float(payload.get("best_score", 0.0))}
    if "extra" in payload:
        meta["extra"] = payload["extra"]
    return meta


def infer_n_classes(checkpoint) -> int:
    """Logits-head width (``logits.weight`` is ``[n_classes, fc_dim]``)."""
    payload = _read(checkpoint)
    sd = strip_module_prefix(payload.get("model_state_dict", payload))
    if "logits.weight" not in sd:
        raise ValueError(f"{checkpoint}: no logits head (logits.weight) in "
                         "the reference torch layout; pass n_classes "
                         "explicitly")
    return int(sd["logits.weight"].shape[0])


def infer_arch(checkpoint) -> dict:
    """Architecture metadata a checkpoint was saved with.

    The ``extra.arch`` the port's worker writes into every ``.pth``: a
    ResNet's ``{"variant": str, "space_to_depth": bool}`` (as the JAX
    worker writes it), another architecture's ``{"arch": str, "variant":
    str}``; ``{}`` for a reference ``.pth`` (no ``extra``), a missing or
    unreadable file (JAX ``checkpoint.py:372-393``).  Read memory-mapped,
    without loading the weights.
    """
    try:
        meta = read_metadata(checkpoint)
    except (OSError, ValueError, RuntimeError, pickle.UnpicklingError):
        return {}
    arch = (meta.get("extra") or {}).get("arch") or {}
    return dict(arch) if isinstance(arch, dict) else {}


def resolve_model_cfg(checkpoint, variant: Optional[str] = None) -> dict:
    """Model geometry for rebuilding a checkpoint's architecture.

    ``{"variant": str, "space_to_depth": bool}``, and ``"arch"`` where the
    checkpoint names one (:func:`infer_arch`; none: a ResNet, the default
    of :func:`~.train.build_model`): an explicit ``variant`` wins, then the
    stored one, then the reference's resnet50 without space-to-depth --
    the rule of JAX ``checkpoint.py:396-407``, shared by
    ``script/evaluate.py`` and :class:`~.inference.OpenSetPredictor`.
    """
    arch = infer_arch(checkpoint)
    cfg = {"variant": variant or arch.get("variant", "resnet50"),
           "space_to_depth": bool(arch.get("space_to_depth", False))}
    if "arch" in arch:
        cfg["arch"] = arch["arch"]
    return cfg
