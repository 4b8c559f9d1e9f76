"""API-parity alias: ``openset_imagenet_tpu_torch.metrics`` mirrors the
JAX package's ``openset_imagenet_tpu.metrics`` (reference
``openset_imagenet.metrics``, ``metrics.py:8-106``) over
:mod:`.ops.metrics`."""

from .ops.metrics import (  # noqa: F401
    auc_score_binary,
    auc_score_multiclass,
    confidence,
    confidence_sums,
    loss_regime_params,
    predict_objectosphere,
)
