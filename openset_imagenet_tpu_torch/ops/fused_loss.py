"""Fused losses: Triton kernels on CUDA tensors, plain torch on CPU.

Counterpart of :mod:`openset_imagenet_tpu.ops.fused_loss`.  Four kernels,
written by hand for Hopper in :mod:`.triton_fused_loss`:

* ``entropic_fwd`` replaces the Pallas ``_fwd_kernel`` (K1): the entropic
  open-set loss sums ``(sum_i (T_i * lse_i - t_dot_i) * mask_i, sum mask)``;
* ``entropic_bwd`` replaces ``_bwd_kernel`` (K2): its logits gradient
  ``(T * softmax - targets) * mask * scale``;
* ``ce_fwd`` replaces ``_ce_fwd_kernel`` (K3): the weighted hard-target
  cross-entropy sums ``(sum_i r_i * (lse_i - l_{i,y}), sum r)`` behind both
  the softmax and the garbage loss;
* ``ce_bwd`` replaces ``_ce_bwd_kernel`` (K4): ``r * (softmax - onehot) *
  scale``.

The public losses are ``torch.autograd.Function``s in place of the JAX
custom VJPs: the forward runs K1 or K3, the backward K2 or K4 with
``scale = g / max(count, 1)`` (entropic) or ``g / max(sum r, 1e-12)``
(weighted CE), and nothing flows to the count, the labels, the mask or the
class weights.

Routing is by the device of the tensors and nothing else: a CPU tensor
goes to the plain version beside each kernel (``*_plain``, written out
from the formulas); a CUDA tensor launches the kernel or raises -- a
missing Triton, a failed build or launch, or an argument the kernel does
not take is an error, never a silent switch to the plain version.

``LAUNCHES`` counts kernel launches (one per call of a wrapper that
launched, the two-stage sum included), so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import os
import pathlib
from typing import Optional, Tuple

import torch

from .losses import _resolve_mask

Tensor = torch.Tensor

LAUNCHES = {"entropic_fwd": 0, "entropic_bwd": 0, "ce_fwd": 0,
            "ce_bwd": 0}

# Triton compiles at first use; its cache goes into the checkout's build/.
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
# Widest row the one-pass kernels hold in registers.
MAX_CLASSES = 8192
# Elements of one [rows, BLOCK_C] tile; bounds registers per thread.
_TILE_ELEMS = 2048
# Programs of the first stage; a program loops over row tiles beyond this.
_MAX_PROGRAMS = 1024
_SUM_BLOCK = 512


# -- plain versions (CPU path; the reference the kernels are held to) --------

def _promote(logits: Tensor) -> Tensor:
    """At least float32 (float64 stays, for gradcheck)."""
    return logits.to(torch.promote_types(logits.dtype, torch.float32))


def entropic_sums_plain(logits: Tensor, labels: Tensor, mask: Tensor,
                        unk_weight: float) -> Tuple[Tensor, Tensor]:
    """``(sum of masked entropic row losses, sum of mask)``."""
    lg = _promote(logits)
    c = lg.shape[-1]
    lse = torch.logsumexp(lg, dim=-1)
    known = labels >= 0
    l_y = torch.gather(lg, 1, labels.long().clamp(0, c - 1)[:, None])[:, 0]
    t_dot = torch.where(known, l_y, (unk_weight / c) * lg.sum(-1))
    t_sum = torch.where(known, 1.0, float(unk_weight))
    mask = mask.float()
    return ((t_sum * lse - t_dot) * mask).sum(), mask.sum()


def ce_sums_plain(logits: Tensor, labels: Tensor, row_weights: Tensor
                  ) -> Tuple[Tensor, Tensor]:
    """``(sum_i r_i * (lse_i - l_{i,y}), sum r)``; labels clipped to
    ``[0, C-1]``."""
    lg = _promote(logits)
    c = lg.shape[-1]
    lse = torch.logsumexp(lg, dim=-1)
    l_y = torch.gather(lg, 1, labels.long().clamp(0, c - 1)[:, None])[:, 0]
    r = row_weights.float()
    return (r * (lse - l_y)).sum(), r.sum()


def _onehot(labels: Tensor, c: int, like: Tensor) -> Tensor:
    cols = torch.arange(c, device=labels.device)
    return (cols[None, :] == labels.long()[:, None]).to(like.dtype)


def entropic_grad_plain(logits: Tensor, labels: Tensor, mask: Tensor,
                        scale: Tensor, unk_weight: float) -> Tensor:
    """``(T * softmax(l) - targets) * mask * scale`` in the logits dtype:
    one-hot targets and ``T = 1`` for ``label >= 0``, uniform ``w/C`` and
    ``T = w`` for negative rows."""
    lg = _promote(logits)
    c = lg.shape[-1]
    p = torch.softmax(lg, dim=-1)
    known = (labels >= 0)[:, None]
    targets = torch.where(known, _onehot(labels, c, p), unk_weight / c)
    t_sum = torch.where(known, 1.0, float(unk_weight))
    grad = (t_sum * p - targets) * (mask.float() * scale)[:, None]
    return grad.to(logits.dtype)


def ce_grad_plain(logits: Tensor, labels: Tensor, row_weights: Tensor,
                  scale: Tensor) -> Tensor:
    """``r * (softmax(l) - onehot) * scale`` in the logits dtype; labels
    clipped to ``[0, C-1]``."""
    lg = _promote(logits)
    c = lg.shape[-1]
    p = torch.softmax(lg, dim=-1)
    onehot = _onehot(labels.long().clamp(0, c - 1), c, p)
    grad = (p - onehot) * (row_weights.float() * scale)[:, None]
    return grad.to(logits.dtype)


# -- kernel wrappers ----------------------------------------------------------

def _kernels():
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR))
    from . import triton_fused_loss

    return triton_fused_loss


def _use_kernel(logits: Tensor, labels: Tensor, rows: Tensor) -> bool:
    """False for CPU tensors (plain version); True after the checks pass."""
    if logits.device.type == "cpu":
        return False
    if logits.device.type != "cuda":
        raise ValueError(f"fused loss runs on CPU or CUDA tensors, not "
                         f"{logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    if rows.dtype != torch.float32:
        raise TypeError(f"row mask/weights must be float32, got {rows.dtype}")
    if logits.dim() != 2 or logits.shape[0] == 0:
        raise ValueError(f"logits must be a non-empty [B, C] matrix, got "
                         f"{tuple(logits.shape)}")
    b, c = logits.shape
    if tuple(labels.shape) != (b,) or tuple(rows.shape) != (b,):
        raise ValueError(f"labels {tuple(labels.shape)} and row mask/weights "
                         f"{tuple(rows.shape)} must be [{b}]")
    if c > MAX_CLASSES:
        raise ValueError(f"{c} classes exceed the kernels' {MAX_CLASSES}")
    for name, t in (("logits", logits), ("labels", labels), ("rows", rows)):
        if t.device != logits.device:
            raise ValueError(f"{name} is on {t.device}, logits on "
                             f"{logits.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return True


def _check_scale(scale: Tensor, logits: Tensor) -> None:
    if scale.dtype != torch.float32 or scale.numel() != 1 or \
            scale.device != logits.device:
        raise ValueError(f"scale must be a 1-element float32 tensor on "
                         f"{logits.device}, got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")


def _tiling(c: int) -> Tuple[int, int]:
    """(BLOCK_C, rows per tile): C padded to a power of two, and rows so a
    tile holds at most ``_TILE_ELEMS`` elements."""
    block_c = max(16, 1 << (c - 1).bit_length())
    return block_c, max(1, min(128, _TILE_ELEMS // block_c))


def _launch(kernel: str, logits: Tensor, labels: Tensor, rows: Tensor,
            *scalars) -> Tensor:
    """First stage over row tiles, then the one-program fixed-order sum.

    Returns a float32 ``[2]`` tensor ``(sum, weight)`` on the device.
    """
    k = _kernels()
    b, c = logits.shape
    block_c, tile_rows = _tiling(c)
    n_tiles = -(-b // tile_rows)
    tiles = -(-n_tiles // _MAX_PROGRAMS)   # row tiles per program
    grid = -(-n_tiles // tiles)
    partials = torch.empty((grid, 2), dtype=torch.float32,
                           device=logits.device)
    out = torch.empty(2, dtype=torch.float32, device=logits.device)
    getattr(k, kernel)[(grid,)](
        logits, labels, rows, partials, b, c, logits.stride(0), tiles,
        *scalars, ROWS=tile_rows, BLOCK_C=block_c,
        num_warps=4 if tile_rows * block_c <= _TILE_ELEMS else 8)
    k.sum_partials[(1,)](partials, out, grid, BLOCK=_SUM_BLOCK, num_warps=4)
    return out


def entropic_sums(logits: Tensor, labels: Tensor, mask: Tensor,
                  unk_weight: float) -> Tuple[Tensor, Tensor]:
    """K1: ``(loss_sum, count)``; the kernel on CUDA, plain on CPU."""
    if not _use_kernel(logits, labels, mask):
        return entropic_sums_plain(logits, labels, mask, unk_weight)
    out = _launch("entropic_fwd_partials", logits, labels, mask,
                  float(unk_weight))
    LAUNCHES["entropic_fwd"] += 1
    return out[0], out[1]


def ce_sums(logits: Tensor, labels: Tensor, row_weights: Tensor
            ) -> Tuple[Tensor, Tensor]:
    """K3: ``(weighted nll sum, weight sum)``; the kernel on CUDA, plain
    on CPU."""
    if not _use_kernel(logits, labels, row_weights):
        return ce_sums_plain(logits, labels, row_weights)
    out = _launch("ce_fwd_partials", logits, labels, row_weights)
    LAUNCHES["ce_fwd"] += 1
    return out[0], out[1]


def _launch_grad(kernel: str, logits: Tensor, labels: Tensor, rows: Tensor,
                 scale: Tensor, *scalars) -> Tensor:
    """One program per row tile; returns the ``[B, C]`` gradient."""
    _check_scale(scale, logits)
    k = _kernels()
    b, c = logits.shape
    block_c, tile_rows = _tiling(c)
    grad = torch.empty_like(logits)
    getattr(k, kernel)[(-(-b // tile_rows),)](
        logits, labels, rows, scale, grad, b, c, logits.stride(0), *scalars,
        ROWS=tile_rows, BLOCK_C=block_c,
        num_warps=4 if tile_rows * block_c <= _TILE_ELEMS else 8)
    return grad


def entropic_grad(logits: Tensor, labels: Tensor, mask: Tensor,
                  scale: Tensor, unk_weight: float) -> Tensor:
    """K2: the entropic logits gradient; the kernel on CUDA, plain on
    CPU."""
    if not _use_kernel(logits, labels, mask):
        return entropic_grad_plain(logits, labels, mask, scale, unk_weight)
    grad = _launch_grad("entropic_bwd", logits, labels, mask, scale,
                        float(unk_weight),
                        float(unk_weight) / logits.shape[1])
    LAUNCHES["entropic_bwd"] += 1
    return grad


def ce_grad(logits: Tensor, labels: Tensor, row_weights: Tensor,
            scale: Tensor) -> Tensor:
    """K4: the weighted-CE logits gradient; the kernel on CUDA, plain on
    CPU."""
    if not _use_kernel(logits, labels, row_weights):
        return ce_grad_plain(logits, labels, row_weights, scale)
    grad = _launch_grad("ce_bwd", logits, labels, row_weights, scale)
    LAUNCHES["ce_bwd"] += 1
    return grad


# -- autograd (the JAX custom VJPs, fused_loss.py:269-341) -------------------

class _EntropicFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mask, unk_weight):
        loss_sum, count = entropic_sums(logits, labels, mask, unk_weight)
        ctx.save_for_backward(logits, labels, mask, count)
        ctx.unk_weight = unk_weight
        ctx.mark_non_differentiable(count)
        return loss_sum / count.clamp(min=1.0), count

    @staticmethod
    def backward(ctx, g_mean, _g_count):
        logits, labels, mask, count = ctx.saved_tensors
        scale = g_mean / count.clamp(min=1.0)
        return (entropic_grad(logits, labels, mask, scale, ctx.unk_weight),
                None, None, None)


class _WeightedCEFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, row_weights):
        loss_sum, wsum = ce_sums(logits, labels, row_weights)
        ctx.save_for_backward(logits, labels, row_weights, wsum)
        ctx.mark_non_differentiable(wsum)
        return loss_sum / wsum.clamp(min=1e-12), wsum

    @staticmethod
    def backward(ctx, g_mean, _g_wsum):
        logits, labels, row_weights, wsum = ctx.saved_tensors
        scale = g_mean / wsum.clamp(min=1e-12)
        return ce_grad(logits, labels, row_weights, scale), None, None


# -- public losses (same (mean, count) contract as ops.losses) ---------------

def entropic_openset_loss_fused(logits: Tensor, labels: Tensor,
                                sample_mask: Tensor, unk_weight: float = 1.0
                                ) -> Tuple[Tensor, Tensor]:
    """Entropic open-set loss ``(mean, count)`` through K1 (backward K2);
    mask required."""
    return _EntropicFused.apply(logits, labels, sample_mask.float(),
                                float(unk_weight))


def _weighted_ce(logits: Tensor, labels: Tensor, row_weights: Tensor):
    return _WeightedCEFused.apply(logits, labels, row_weights)


def softmax_loss_fused(logits: Tensor, labels: Tensor,
                       sample_mask: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor]:
    """CE ignoring ``label < 0`` through K3 (backward K4); mean over the
    valid rows."""
    row_w = (labels >= 0).float() * _resolve_mask(labels, sample_mask)
    return _weighted_ce(logits, labels, row_w)


def garbage_loss_fused(logits: Tensor, labels: Tensor, class_weights: Tensor,
                       sample_mask: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor]:
    """Class-weighted CE through K3 (backward K4): ``(weighted mean, weight
    sum)``."""
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    row_w = (class_weights.float()[safe]
             * _resolve_mask(labels, sample_mask))
    return _weighted_ce(logits, labels, row_w)
