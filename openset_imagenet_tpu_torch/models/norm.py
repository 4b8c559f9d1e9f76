"""Eval-mode batch-norm in the two rounding forms of the JAX model.

Counterpart of :mod:`openset_imagenet_tpu.models.norm`.  At inference a
batch-norm is the per-channel affine map of its running statistics, but
the JAX model rounds it to the compute dtype in two different places
depending on which flax module built it:

* :class:`BatchNorm` -- flax ``nn.BatchNorm`` (``model.bn_stats_rows == 0``,
  the default and every predictor): ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias`` in float32, rounded once to the compute dtype.
* :class:`SubsetBatchNorm` -- ``bn_stats_rows > 0``: ``mul`` and ``add``
  are rounded to the compute dtype first and ``x * mul + add`` is computed
  in that dtype (``norm.py:129-134`` of the JAX package).

``F.batch_norm`` matches neither in bfloat16, so the affine map is written
out here.  Train-mode statistics (full-batch and ghost) land with the
train step (ROADMAP Queue 1 item 2); until then a module in training mode
raises.

Parameters and buffers keep the reference torch names (``weight``,
``bias``, ``running_mean``, ``running_var``) so ``state_dict`` keys match
the reference checkpoints.  ``momentum`` is the flax convention (weight of
the old running value, 0.9 == torch's 0.1); eval does not read it.
"""

from __future__ import annotations

import torch
from torch import nn

BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` eval form over the channel dim of NCHW."""

    def __init__(self, features: int, *, eps: float = BN_EPSILON,
                 momentum: float = BN_MOMENTUM, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def _check_eval(self):
        if self.training:
            raise NotImplementedError(
                "train-mode batch-norm statistics land with the train step "
                "(ROADMAP Queue 1 item 2); call .eval() to run on the "
                "running statistics")

    @staticmethod
    def _channel(t: torch.Tensor) -> torch.Tensor:
        return t.view(1, -1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_eval()
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = x.float() - self._channel(self.running_mean)
        y = y * self._channel(mul) + self._channel(self.bias)
        return y.to(x.dtype)


class SubsetBatchNorm(BatchNorm):
    """``SubsetBatchNorm`` eval form: fold, round, then affine in x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_eval()
        inv = torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        mul = (inv * self.weight).to(x.dtype)
        add = (self.bias - self.running_mean * inv * self.weight).to(x.dtype)
        return x * self._channel(mul) + self._channel(add)
