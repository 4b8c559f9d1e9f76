"""Fused loss forwards: Triton kernels on CUDA tensors, plain torch on CPU.

Counterpart of :mod:`openset_imagenet_tpu.ops.fused_loss` (forward only).
Two kernels, written by hand for Hopper in :mod:`.triton_fused_loss`:

* ``entropic_fwd`` replaces the Pallas ``_fwd_kernel`` (K1): the entropic
  open-set loss sums ``(sum_i (T_i * lse_i - t_dot_i) * mask_i, sum mask)``;
* ``ce_fwd`` replaces ``_ce_fwd_kernel`` (K3): the weighted hard-target
  cross-entropy sums ``(sum_i r_i * (lse_i - l_{i,y}), sum r)`` behind both
  the softmax and the garbage loss.

Routing is by the device of the tensors and nothing else: a CPU tensor
goes to the plain version beside each kernel (:func:`entropic_sums_plain`,
:func:`ce_sums_plain`); a CUDA tensor launches the kernel or raises -- a
missing Triton, a failed build or launch, or an argument the kernel does
not take is an error, never a silent switch to the plain version.
Backward kernels (K2, K4) land with the train step, so a CUDA tensor that
requires grad raises ``NotImplementedError``.

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

LAUNCHES = {"entropic_fwd": 0, "ce_fwd": 0}

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

def entropic_sums_plain(logits: Tensor, labels: Tensor, mask: Tensor,
                        unk_weight: float) -> Tuple[Tensor, Tensor]:
    """``(sum of masked entropic row losses, sum of mask)``."""
    lg = logits.float()
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
    lg = logits.float()
    c = lg.shape[-1]
    lse = torch.logsumexp(lg, dim=-1)
    l_y = torch.gather(lg, 1, labels.long().clamp(0, c - 1)[:, None])[:, 0]
    r = row_weights.float()
    return (r * (lse - l_y)).sum(), r.sum()


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
    if logits.requires_grad:
        raise NotImplementedError(
            "fused loss backward kernels land with the train step (ROADMAP "
            "Queue 1 item 2); use loss.fused: false to train")
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


def _launch(kernel: str, logits: Tensor, labels: Tensor, rows: Tensor,
            *scalars) -> Tensor:
    """First stage over row tiles, then the one-program fixed-order sum.

    Returns a float32 ``[2]`` tensor ``(sum, weight)`` on the device.
    """
    k = _kernels()
    b, c = logits.shape
    block_c = max(16, 1 << (c - 1).bit_length())
    tile_rows = max(1, min(128, _TILE_ELEMS // block_c))
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


# -- public losses (same (mean, count) contract as ops.losses) ---------------

def entropic_openset_loss_fused(logits: Tensor, labels: Tensor,
                                sample_mask: Tensor, unk_weight: float = 1.0
                                ) -> Tuple[Tensor, Tensor]:
    """Entropic open-set loss ``(mean, count)`` through K1; mask required."""
    loss_sum, count = entropic_sums(logits, labels, sample_mask.float(),
                                    unk_weight)
    return loss_sum / count.clamp(min=1.0), count


def _weighted_ce(logits: Tensor, labels: Tensor, row_weights: Tensor):
    loss_sum, wsum = ce_sums(logits, labels, row_weights)
    return loss_sum / wsum.clamp(min=1e-12), wsum


def softmax_loss_fused(logits: Tensor, labels: Tensor,
                       sample_mask: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor]:
    """CE ignoring ``label < 0`` through K3; mean over the valid rows."""
    row_w = (labels >= 0).float() * _resolve_mask(labels, sample_mask)
    return _weighted_ce(logits, labels, row_w)


def garbage_loss_fused(logits: Tensor, labels: Tensor, class_weights: Tensor,
                       sample_mask: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor]:
    """Class-weighted CE through K3: ``(weighted mean, weight sum)``."""
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    row_w = (class_weights.float()[safe]
             * _resolve_mask(labels, sample_mask))
    return _weighted_ce(logits, labels, row_w)
