"""Batch-norm in the two rounding forms of the JAX model, eval and train.

Counterpart of :mod:`openset_imagenet_tpu.models.norm` and of flax
``nn.BatchNorm``.  The JAX model builds one of two flax modules depending
on ``bn_stats_rows`` (``models/resnet.py:462-471`` of the JAX package),
and they round to the compute dtype in different places:

* ``stats_rows == 0`` -- flax ``nn.BatchNorm`` (the default and every
  predictor): ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
  float32, rounded once to the compute dtype.
* ``stats_rows > 0`` -- ``SubsetBatchNorm``: ``mul`` and ``add`` are
  rounded to the compute dtype first and ``x * mul + add`` is computed in
  that dtype (``norm.py:129-134`` of the JAX package).

:class:`BatchNorm` holds both and picks the form from ``stats_rows``, so a
model switches form and statistics window together (the ragged-tail step,
:meth:`..resnet.ResNet50.stats_window`).

In training mode the statistics come from the batch -- all rows, or only
the first ``stats_rows`` rows (ghost batch-norm) -- promoted to float32,
with the fast variance ``max(E[x^2] - E[x]^2, 0)`` as flax computes it.
Gradients flow through the statistics (autograd of the written-out math),
so only the rows inside the window get the statistics' share.  Each
train-mode forward also updates the running statistics, outside autograd,
as ``momentum * old + (1 - momentum) * new`` with the *biased* variance.
``F.batch_norm(training=True)`` writes the unbiased variance and matches
neither rounding form in bfloat16, so the math is written out here.

Parameters and buffers keep the reference torch names (``weight``,
``bias``, ``running_mean``, ``running_var``) so ``state_dict`` keys match
the reference checkpoints.  ``momentum`` is the flax convention (weight of
the old running value, 0.9 == torch's 0.1).
"""

from __future__ import annotations

import torch
from torch import nn

BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` / ``SubsetBatchNorm`` over the channels of NCHW."""

    def __init__(self, features: int, *, stats_rows: int = 0,
                 eps: float = BN_EPSILON, momentum: float = BN_MOMENTUM,
                 device=None):
        super().__init__()
        self.stats_rows = int(stats_rows)
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    @staticmethod
    def _channel(t: torch.Tensor) -> torch.Tensor:
        return t.view(1, -1, 1, 1)

    def _batch_stats(self, x: torch.Tensor):
        """Mean and biased fast variance of the window; updates the
        running statistics."""
        xs = x if self.stats_rows <= 0 else x[:self.stats_rows]
        xs = xs.float()
        mean = xs.mean(dim=(0, 2, 3))
        mean2 = xs.square().mean(dim=(0, 2, 3))
        var = torch.maximum(mean2 - mean.square(), mean2.new_zeros(()))
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = self._batch_stats(x)
        else:
            mean, var = self.running_mean, self.running_var
        c = self._channel
        if self.stats_rows > 0:
            inv = torch.reciprocal(torch.sqrt(var + self.eps))
            mul = (inv * self.weight).to(x.dtype)
            add = (self.bias - mean * inv * self.weight).to(x.dtype)
            return x * c(mul) + c(add)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = x.float() - c(mean)
        return (y * c(mul) + c(self.bias)).to(x.dtype)
