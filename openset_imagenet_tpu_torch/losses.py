"""API-parity alias: ``openset_imagenet_tpu_torch.losses`` mirrors the JAX
package's ``openset_imagenet_tpu.losses`` (reference
``openset_imagenet.losses``, ``losses.py:7-94``) over :mod:`.ops.losses`."""

import torch

from .ops.losses import (  # noqa: F401
    AverageMeter,
    EarlyStopping,
    entropic_openset_loss,
    garbage_loss,
    softmax_loss,
)


class EntropicOpensetLoss:
    """Class-form entropic loss, reference API parity (``losses.py:7-29``).

    ``EntropicOpensetLoss(num_of_classes, unk_weight)(logits, target)`` is
    the batch mean of :func:`entropic_openset_loss`.  ``num_of_classes``
    must match ``logits.shape[-1]`` (the reference builds an eye matrix of
    that size; here the logits' own width is the single source of truth
    and a mismatch raises).  Array-likes are taken as tensors.
    """

    def __init__(self, num_of_classes, unk_weight: float = 1.0):
        self.class_count = int(num_of_classes)
        self.unk_weight = float(unk_weight)

    def __call__(self, logits, target):
        logits, target = torch.as_tensor(logits), torch.as_tensor(target)
        if logits.shape[-1] != self.class_count:
            raise ValueError(
                f"logits have {logits.shape[-1]} classes, loss was built "
                f"for {self.class_count}")
        mean, _ = entropic_openset_loss(logits, target,
                                        unk_weight=self.unk_weight)
        return mean
