"""Open-set classification losses on logits, in plain PyTorch.

Counterpart of :mod:`openset_imagenet_tpu.ops.losses` with the same
``(mean, count)`` contract: each loss returns the batch mean exactly as
the reference torch criterion would, plus the participating row count (or
summed row weight for the garbage loss) for streaming epoch averages.  A
``sample_mask`` (0/1 per row) drops padded rows from both.

These are the unfused versions (``loss.fused: false``); the kernels of
:mod:`.fused_loss` compute the same values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _log_softmax(logits: Tensor) -> Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def _resolve_mask(labels: Tensor, sample_mask: Optional[Tensor]) -> Tensor:
    if sample_mask is None:
        return torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    return sample_mask.float()


def _nll(log_p: Tensor, labels: Tensor) -> Tensor:
    safe = labels.long().clamp(0, log_p.shape[-1] - 1)
    return -torch.gather(log_p, 1, safe[:, None])[:, 0]


def entropic_openset_loss(logits: Tensor, labels: Tensor,
                          unk_weight: float = 1.0,
                          sample_mask: Optional[Tensor] = None
                          ) -> Tuple[Tensor, Tensor]:
    """Soft-target cross-entropy: one-hot for ``label >= 0``, uniform
    ``unk_weight / C`` for negative rows.  Returns ``(mean, count)``."""
    num_classes = logits.shape[-1]
    log_p = _log_softmax(logits)
    known = labels >= 0
    one_hot = torch.nn.functional.one_hot(
        labels.long().clamp(0, num_classes - 1), num_classes).float()
    targets = torch.where(known[:, None], one_hot,
                          torch.full_like(one_hot, unk_weight / num_classes))
    per_row = -(targets * log_p).sum(-1)
    mask = _resolve_mask(labels, sample_mask)
    count = mask.sum()
    return (per_row * mask).sum() / count.clamp(min=1.0), count


def softmax_loss(logits: Tensor, labels: Tensor,
                 sample_mask: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
    """Cross-entropy ignoring rows with a negative label
    (``CrossEntropyLoss(ignore_index=-1)``).  Returns ``(mean, count)``."""
    valid = (labels >= 0).float() * _resolve_mask(labels, sample_mask)
    nll = _nll(_log_softmax(logits), labels)
    count = valid.sum()
    return (nll * valid).sum() / count.clamp(min=1.0), count


def garbage_loss(logits: Tensor, labels: Tensor, class_weights: Tensor,
                 sample_mask: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
    """Class-weighted cross-entropy (``CrossEntropyLoss(weight=w)``).

    Returns ``(weighted_mean, summed_row_weights)``.
    """
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    nll = _nll(_log_softmax(logits), labels)
    row_w = class_weights.float()[safe] * _resolve_mask(labels, sample_mask)
    wsum = row_w.sum()
    return (nll * row_w).sum() / wsum.clamp(min=1e-12), wsum


class AverageMeter:
    """Running weighted average (reference ``losses.py:32-60``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, count=1):
        val = float(val)
        count = float(count)
        self.val = val
        self.sum += val * count
        self.count += count
        self.avg = self.sum / self.count if self.count else 0

    def __repr__(self):
        return f"{self.avg:3.3f}"


class EarlyStopping:
    """Stop training when a monitored metric stops improving.

    Reference ``losses.py:65-94``: ``delta`` threshold, ``patience``
    epochs, the score negated when monitoring a loss.
    """

    def __init__(self, patience: int = 100, delta: float = 0.0):
        self.patience = patience
        self.delta = delta
        self.counter = 0
        self.best_score = None
        self.early_stop = False

    def __call__(self, metrics: float, loss: bool = True):
        score = -metrics if loss else metrics
        if self.best_score is None:
            self.best_score = score
        elif score < self.best_score + self.delta:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self.counter = 0
