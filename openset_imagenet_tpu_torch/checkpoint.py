"""Checkpoints in the reference ``.pth`` contract.

Counterpart of the reference-format parts of
:mod:`openset_imagenet_tpu.checkpoint` and ``convert.py:157-221``: a
``torch.save`` dict ``{'model_state_dict', 'epoch', 'step', 'best_score',
'opt_state_dict'}`` whose state-dict keys follow the reference layout
(see :mod:`.convert`).  ``epoch`` is stored as ``epoch + 1``, the epoch to
resume at, as the JAX package and the reference store it;
``opt_state_dict`` is the torch optimizer's ``state_dict()`` (empty for a
weights-only save) and ``step`` the update count that the learning-rate
schedule reads.  Files are always read with ``weights_only=True``.
Reading the JAX package's native msgpack checkpoints is not ported yet
(ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .convert import load_into, strip_module_prefix


def _read(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(path, model, epoch: int, best_score: float,
                    optimizer=None, step: int = 0) -> None:
    """Write ``model`` (and ``optimizer``'s state) as a reference ``.pth``.

    ``epoch`` is the epoch that just finished and is stored as ``epoch +
    1`` (JAX ``checkpoint.py:53-76``); ``step`` is the update count.
    Without an optimizer ``opt_state_dict`` is empty (weights only).
    """
    state = {k: v.detach().cpu().contiguous()
             for k, v in model.state_dict().items()}
    opt_state = {} if optimizer is None else optimizer.state_dict()
    torch.save({"model_state_dict": state, "epoch": int(epoch) + 1,
                "step": int(step), "best_score": float(best_score),
                "opt_state_dict": opt_state}, path)


def load_checkpoint(path, model, optimizer=None) -> Tuple[int, float, int]:
    """Load a reference ``.pth`` into ``model`` (and its optimizer state
    into ``optimizer``); returns ``(epoch, best_score, step)``.

    ``epoch`` is the stored ``epoch + 1``, the epoch to resume at.
    Missing keys raise ``KeyError``, shape mismatches ``ValueError``; an
    optimizer given for a weights-only file raises ``ValueError``.
    """
    payload = _read(path)
    load_into(model, payload["model_state_dict"])
    if optimizer is not None:
        if not payload.get("opt_state_dict"):
            raise ValueError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(payload["opt_state_dict"])
    return (int(payload.get("epoch", 0)),
            float(payload.get("best_score", 0.0)),
            int(payload.get("step", 0)))


def infer_n_classes(checkpoint) -> int:
    """Logits-head width (``logits.weight`` is ``[n_classes, fc_dim]``)."""
    payload = _read(checkpoint)
    sd = strip_module_prefix(payload.get("model_state_dict", payload))
    if "logits.weight" not in sd:
        raise ValueError(f"{checkpoint}: no logits head (logits.weight) in "
                         "the reference torch layout; pass n_classes "
                         "explicitly")
    return int(sd["logits.weight"].shape[0])


def resolve_model_cfg(variant: Optional[str] = None) -> dict:
    """Model geometry for rebuilding a checkpoint's architecture.

    A reference ``.pth`` carries no architecture metadata, so an explicit
    ``variant`` wins and the default is the reference's resnet50 -- the
    rule the JAX package applies to the same files (``checkpoint.py:
    396-407``).
    """
    return {"variant": variant or "resnet50", "space_to_depth": False}
