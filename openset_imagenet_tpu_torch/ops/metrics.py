"""Confidence metrics and objectosphere prediction in PyTorch.

Counterpart of :mod:`openset_imagenet_tpu.ops.metrics`:
:func:`confidence_sums` is the streaming per-batch form the validation step
accumulates on the device; :func:`confidence` is the reference's
whole-array signature (reference ``metrics.py:8-42``).  The regime
parameters come from :func:`loss_regime_params` (reference
``train.py:156-163``).  :func:`auc_score_binary` and
:func:`auc_score_multiclass` are host-side sklearn (reference
``metrics.py:65-106``), imported when called.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def confidence_sums(scores: Tensor, target_labels: Tensor,
                    offset: float = 0.0, unknown_class: int = -1,
                    last_valid_class: Optional[int] = None,
                    sample_mask: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``(kn_sum, kn_count, neg_sum, neg_count)`` for one batch.

    Known rows (``label >= 0`` and not ``unknown_class``) add the score of
    their true class; rows labelled ``unknown_class`` add ``1 + offset -
    max(scores[:, :last_valid_class])``.  Padded rows are dropped by
    ``sample_mask``.
    """
    scores = scores.float()
    mask = (torch.ones(target_labels.shape, dtype=torch.float32,
                       device=scores.device)
            if sample_mask is None else sample_mask.float())
    unknown = target_labels == unknown_class
    known = (target_labels >= 0) & ~unknown
    kn_f = known.float() * mask
    neg_f = unknown.float() * mask
    safe = target_labels.long().clamp(0, scores.shape[-1] - 1)
    true_score = torch.gather(scores, 1, safe[:, None])[:, 0]
    region = scores if last_valid_class is None \
        else scores[:, :last_valid_class]
    neg_val = 1.0 + offset - region.max(dim=-1).values
    return ((true_score * kn_f).sum(), kn_f.sum(),
            (neg_val * neg_f).sum(), neg_f.sum())


def confidence(scores, target_labels, offset: float = 0.0,
               unknown_class: int = -1,
               last_valid_class: Optional[int] = None
               ) -> Tuple[float, int, float, int]:
    """``(kn_conf, kn_count, neg_conf, neg_count)``; a confidence is 0.0
    when its count is zero.  Accepts tensors or array-likes."""
    kn_sum, kn_count, neg_sum, neg_count = confidence_sums(
        torch.as_tensor(scores), torch.as_tensor(target_labels),
        offset=offset, unknown_class=unknown_class,
        last_valid_class=last_valid_class)
    kn_n, neg_n = int(kn_count), int(neg_count)
    kn_conf = float(kn_sum) / kn_n if kn_n else 0.0
    neg_conf = float(neg_sum) / neg_n if neg_n else 0.0
    return kn_conf, kn_n, neg_conf, neg_n


def predict_objectosphere(logits, features, threshold: float) -> Tensor:
    """``[B, 2]`` of ``(pred_class, pred_score)``; class ``-1`` where
    ``||features|| * max softmax < threshold`` (reference
    ``metrics.py:45-62``)."""
    scores = torch.softmax(torch.as_tensor(logits).float(), dim=-1)
    pred_score, pred_class = scores.max(dim=-1)
    norms = torch.linalg.vector_norm(torch.as_tensor(features).float(),
                                     dim=-1)
    pred_class = torch.where(norms * pred_score < threshold, -1.0,
                             pred_class.float())
    return torch.stack((pred_class, pred_score), dim=1)


def auc_score_binary(target_labels, pred_scores, unk_class: int = -1):
    """Binary AUC of known (+1) vs unknown (-1) on the max score
    (reference ``metrics.py:65-92``)."""
    import sklearn.metrics

    target_labels = np.asarray(target_labels).copy()
    pred_scores = np.asarray(pred_scores)
    max_scores = np.max(pred_scores, axis=1)
    known = target_labels != unk_class
    target_labels[known] = 1
    target_labels[~known] = -1
    return sklearn.metrics.roc_auc_score(target_labels, max_scores)


def auc_score_multiclass(target_labels, pred_scores):
    """One-vs-rest multiclass AUC (reference ``metrics.py:95-106``)."""
    import sklearn.metrics

    target_labels = np.asarray(target_labels)
    pred_scores = np.asarray(pred_scores)
    return sklearn.metrics.roc_auc_score(target_labels, pred_scores,
                                         multi_class="ovr")


def loss_regime_params(loss_type: str, n_classes: int) -> dict:
    """Validation-confidence parameters per loss type: garbage uses
    ``offset=0, unknown_class=C-1, last_valid_class=-1``; entropic and
    softmax use ``offset=1/C, unknown_class=-1, last_valid_class=None``."""
    if loss_type == "garbage":
        return dict(offset=0.0, unknown_class=n_classes - 1,
                    last_valid_class=-1)
    return dict(offset=1.0 / n_classes, unknown_class=-1,
                last_valid_class=None)
