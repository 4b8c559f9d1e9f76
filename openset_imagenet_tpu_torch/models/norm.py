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

:meth:`BatchNorm.fold` returns the float32 ``(mul, add)`` of the ghost
form's affine map from given statistics (training: it also updates the
running statistics) or from the running statistics (eval): the JAX
``BNAffine`` that the fused-backward bottleneck uses.

On CUDA tensors the forward runs through the hand-written kernels of
:mod:`..ops.batch_norm` (statistics, affine map and backward, two kernel
launches each way, bit-equal to the written-out map given the same
statistics); on CPU tensors it is the written-out math below.
``use_kernel = False`` runs the written-out math on CUDA tensors too.

Parameters and buffers keep the reference torch names (``weight``,
``bias``, ``running_mean``, ``running_var``) so ``state_dict`` keys match
the reference checkpoints.  ``momentum`` is the flax convention (weight of
the old running value, 0.9 == torch's 0.1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.batch_norm import batch_norm

BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5


def ghost_stats(xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 mean and biased fast variance ``max(E[x^2] - E[x]^2, 0)``
    over every dimension but the channels (dim 1 of NCHW)."""
    xs = xs.float()
    mean = xs.mean(dim=(0, 2, 3))
    mean2 = xs.square().mean(dim=(0, 2, 3))
    return mean, torch.maximum(mean2 - mean.square(), mean2.new_zeros(()))


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
        self.use_kernel = True   # False: the written-out math on CUDA

    @staticmethod
    def _channel(t: torch.Tensor) -> torch.Tensor:
        return t.view(1, -1, 1, 1)

    def _batch_stats(self, x: torch.Tensor):
        """Mean and biased fast variance of the window; updates the
        running statistics."""
        mean, var = ghost_stats(
            x if self.stats_rows <= 0 else x[:self.stats_rows])
        self._update_running(mean, var)
        return mean, var

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

    def _fold(self, mean: torch.Tensor, var: torch.Tensor):
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        return inv * self.weight, self.bias - mean * inv * self.weight

    def fold(self, mean: Optional[torch.Tensor] = None,
             var: Optional[torch.Tensor] = None):
        """Float32 ``(mul, add)`` of the affine map, the JAX ``BNAffine``.

        In training mode the batch statistics ``(mean, var)`` are given
        (the fused bottleneck's ghost pre-pass computes them) and update
        the running statistics; in eval mode the running statistics are
        folded.  ``mul = scale / sqrt(var + eps)``, ``add = bias - mean *
        mul``, written as ``models/norm.py:77-80`` of the JAX package.
        """
        if self.training:
            if mean is None or var is None:
                raise ValueError("BatchNorm.fold in training mode needs the "
                                 "batch statistics (mean, var)")
            self._update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        return self._fold(mean, var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_kernel and x.is_cuda:
            return batch_norm(x, self.weight, self.bias, self.running_mean,
                              self.running_var, training=self.training,
                              stats_rows=self.stats_rows, eps=self.eps,
                              momentum=self.momentum)
        if self.training:
            mean, var = self._batch_stats(x)
        else:
            mean, var = self.running_mean, self.running_var
        c = self._channel
        if self.stats_rows > 0:
            mul, add = self._fold(mean, var)
            return x * c(mul.to(x.dtype)) + c(add.to(x.dtype))
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = x.float() - c(mean)
        return (y * c(mul) + c(self.bias)).to(x.dtype)
