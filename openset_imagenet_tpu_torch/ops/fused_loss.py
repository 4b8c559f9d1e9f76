"""Fused losses: Triton kernels on CUDA tensors, plain torch on CPU.

Counterpart of :mod:`openset_imagenet_tpu.ops.fused_loss`.  Four kernels,
written by hand for Hopper in :mod:`.triton_fused_loss`:

* ``entropic_fwd`` replaces the Pallas ``_fwd_kernel`` (K1): the entropic
  open-set loss sums ``(sum_i (T_i * lse_i - t_dot_i) * mask_i, sum mask)``
  and their mean ``loss_sum / max(count, 1)``;
* ``entropic_bwd`` replaces ``_bwd_kernel`` (K2): its logits gradient
  ``(T * softmax - targets) * mask * g / max(count, 1)``;
* ``ce_fwd`` replaces ``_ce_fwd_kernel`` (K3): the weighted hard-target
  cross-entropy sums ``(sum_i r_i * (lse_i - l_{i,y}), sum r)`` behind both
  the softmax and the garbage loss, and their mean ``loss_sum / max(sum r,
  1e-12)``;
* ``ce_bwd`` replaces ``_ce_bwd_kernel`` (K4): ``r * (softmax - onehot) *
  g / max(sum r, 1e-12)``.

The public losses are ``torch.autograd.Function``s in place of the JAX
custom VJPs, and nothing flows to the count, the labels, the mask or the
class weights.  Both losses are one launch each way: K1 and K3 write the
mean beside the sums, and K2 and K4 form ``g / max(count, 1)`` and ``g /
max(sum r, 1e-12)`` from the cotangent and the saved count or weight sum
(every division correctly rounded, so the bits are those of torch's
``/``).  The row weights of the softmax and garbage losses (``(labels >=
0) * mask``, ``class_weights[label] * mask``) are formed in torch before
the Function, as the JAX package forms them.

Routing is by the device of the tensors and nothing else: a CPU tensor
goes to the plain version beside each kernel (``*_plain``, written out
from the formulas); a CUDA tensor launches the kernel or raises -- a
missing Triton, a failed build or launch, or an argument the kernel does
not take is an error, never a silent switch to the plain version.

``LAUNCHES`` counts kernel launches (one per call of a wrapper that
launched), so a run can show that its main path went through the kernels.
K1 and K3 are one launch per call: their programs take tickets from the
int32 counter of the device's current stream (:func:`._triton.ticket`,
which the batch-norm and window-attention kernels share: every launch
leaves its counters at 0, and one stream orders the launches), and the
last one adds the partials.  Every kernel launches through
:func:`._triton.run`.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ._triton import run, ticket
from .losses import _resolve_mask

Tensor = torch.Tensor

LAUNCHES = {"entropic_fwd": 0, "entropic_bwd": 0, "ce_fwd": 0,
            "ce_bwd": 0}

# Widest row the one-pass kernels hold in registers.
MAX_CLASSES = 8192
# Elements of one program's [rows, BLOCK_C] row tile, by kernel.  At
# C <= 128, 256 elements are two rows and one warp a program.  On an
# NVIDIA H100 80GB HBM3 at 700 W such small programs took less time than
# 2048-element tiles, for K3 at [64, 117] and [256, 117] (and than one
# program holding every row) and for K2 at [256, 116] and [64, 116].  To
# time other tiles, edit this table in a second checkout and run
# tools/ab_torch_kernels.py, which times two checkouts' kernels in turns.
# K1 takes K3's grid, K4 K2's.
_TILE_ELEMS = {"entropic_fwd": 256, "ce_fwd": 256, "entropic_bwd": 256,
              "ce_bwd": 256}
# Programs of a forward; a program loops over row tiles beyond this.
_MAX_PROGRAMS = 1024
# Partials the last program of a forward adds at a time.
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


def entropic_fwd_plain(logits: Tensor, labels: Tensor, mask: Tensor,
                       unk_weight: float) -> Tuple[Tensor, Tensor, Tensor]:
    """``(loss_sum, count, loss_sum / max(count, 1))``."""
    loss_sum, count = entropic_sums_plain(logits, labels, mask, unk_weight)
    return loss_sum, count, loss_sum / count.clamp(min=1.0)


def ce_fwd_plain(logits: Tensor, labels: Tensor, row_weights: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(loss_sum, wsum, loss_sum / max(wsum, 1e-12))``."""
    loss_sum, wsum = ce_sums_plain(logits, labels, row_weights)
    return loss_sum, wsum, loss_sum / wsum.clamp(min=1e-12)


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
                        g: Tensor, count: Tensor, unk_weight: float
                        ) -> Tensor:
    """``(T * softmax(l) - targets) * mask * g / max(count, 1)`` in the
    logits dtype: one-hot targets and ``T = 1`` for ``label >= 0``, uniform
    ``w/C`` and ``T = w`` for negative rows."""
    scale = g / count.clamp(min=1.0)
    lg = _promote(logits)
    c = lg.shape[-1]
    p = torch.softmax(lg, dim=-1)
    known = (labels >= 0)[:, None]
    targets = torch.where(known, _onehot(labels, c, p), unk_weight / c)
    t_sum = torch.where(known, 1.0, float(unk_weight))
    grad = (t_sum * p - targets) * (mask.float() * scale)[:, None]
    return grad.to(logits.dtype)


def ce_grad_plain(logits: Tensor, labels: Tensor, row_weights: Tensor,
                  g: Tensor, wsum: Tensor) -> Tensor:
    """``r * (softmax(l) - onehot) * g / max(wsum, 1e-12)`` in the logits
    dtype; labels clipped to ``[0, C-1]``."""
    scale = g / wsum.clamp(min=1e-12)
    lg = _promote(logits)
    c = lg.shape[-1]
    p = torch.softmax(lg, dim=-1)
    onehot = _onehot(labels.long().clamp(0, c - 1), c, p)
    grad = (p - onehot) * (row_weights.float() * scale)[:, None]
    return grad.to(logits.dtype)


# -- kernel wrappers ----------------------------------------------------------

_run = functools.partial(run, "triton_fused_loss")


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


def _check_scalar(name: str, t: Tensor, logits: Tensor) -> None:
    if t.dtype != torch.float32 or t.numel() != 1 or \
            t.device != logits.device:
        raise ValueError(f"{name} must be a 1-element float32 tensor on "
                         f"{logits.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _tiling(c: int, tile_elems: int) -> Tuple[int, int]:
    """(BLOCK_C, rows per tile): C padded to a power of two, and rows so a
    tile holds at most ``tile_elems`` elements (one row at least)."""
    block_c = max(16, 1 << (c - 1).bit_length())
    return block_c, max(1, min(128, tile_elems // block_c))


def _warps(elems: int) -> int:
    """Warps of a program holding a tile of ``elems`` elements."""
    return 1 if elems <= 256 else 4 if elems <= 2048 else 8


def _grid(b: int, c: int, tile_elems: int) -> Tuple[int, int, int, int]:
    """``(BLOCK_C, rows per tile, row tiles per program, programs)`` of a
    forward over ``[b, c]``: up to ``_MAX_PROGRAMS`` programs, each taking
    the same count of consecutive tiles of at most ``tile_elems`` elements
    (the last may run past ``b``, masked).
    """
    block_c, tile_rows = _tiling(c, tile_elems)
    n_tiles = -(-b // tile_rows)
    tiles = -(-n_tiles // _MAX_PROGRAMS)
    return block_c, tile_rows, tiles, -(-n_tiles // tiles)


def _fwd_launch(name: str, logits: Tensor, labels: Tensor, rows: Tensor,
                n_out: int, *scalars) -> Tensor:
    """K1 or K3 in one launch; returns its float32 ``[n_out]`` output."""
    b, c = logits.shape
    block_c, tile_rows, tiles, grid = _grid(b, c, _TILE_ELEMS[name])
    out = torch.empty(n_out, dtype=torch.float32, device=logits.device)
    partials = out if grid == 1 else torch.empty(
        (grid, 2), dtype=torch.float32, device=logits.device)
    # Only the kernel touches the counter, and its last program resets it:
    # a launch that raises here never ran, so the counter stays at 0.
    _run(f"{name}_once", logits.device, (grid,),
         logits, labels, rows, partials, out, ticket(logits.device, 1), b, c,
         logits.stride(0), tiles, grid - 1, *scalars, ROWS=tile_rows,
         BLOCK_C=block_c, SUM_BLOCK=_SUM_BLOCK,
         num_warps=_warps(tile_rows * block_c))
    LAUNCHES[name] += 1
    return out


def entropic_fwd(logits: Tensor, labels: Tensor, mask: Tensor,
                 unk_weight: float) -> Tuple[Tensor, Tensor, Tensor]:
    """K1: ``(loss_sum, count, loss_sum / max(count, 1))``; one kernel
    launch on CUDA, plain on CPU."""
    if not _use_kernel(logits, labels, mask):
        return entropic_fwd_plain(logits, labels, mask, unk_weight)
    out = _fwd_launch("entropic_fwd", logits, labels, mask, 3,
                      float(unk_weight))
    return out[0], out[1], out[2]


def entropic_sums(logits: Tensor, labels: Tensor, mask: Tensor,
                  unk_weight: float) -> Tuple[Tensor, Tensor]:
    """K1: ``(loss_sum, count)``; the kernel on CUDA, plain on CPU."""
    return entropic_fwd(logits, labels, mask, unk_weight)[:2]


def ce_fwd(logits: Tensor, labels: Tensor, row_weights: Tensor
           ) -> Tuple[Tensor, Tensor, Tensor]:
    """K3: ``(loss_sum, wsum, loss_sum / max(wsum, 1e-12))``; one kernel
    launch on CUDA, plain on CPU."""
    if not _use_kernel(logits, labels, row_weights):
        return ce_fwd_plain(logits, labels, row_weights)
    out = _fwd_launch("ce_fwd", logits, labels, row_weights, 3)
    return out[0], out[1], out[2]


def ce_sums(logits: Tensor, labels: Tensor, row_weights: Tensor
            ) -> Tuple[Tensor, Tensor]:
    """K3: ``(weighted nll sum, weight sum)``; the kernel on CUDA, plain
    on CPU."""
    return ce_fwd(logits, labels, row_weights)[:2]


def _launch_grad(name: str, logits: Tensor, labels: Tensor, rows: Tensor,
                 scalars: Dict[str, Tensor], *consts) -> Tensor:
    """One program per row tile of ``_TILE_ELEMS[name]`` elements; returns
    the ``[B, C]`` gradient.  ``scalars`` are the 1-element device tensors
    the kernel reads, in its argument order."""
    for arg, t in scalars.items():
        _check_scalar(arg, t, logits)
    b, c = logits.shape
    block_c, tile_rows = _tiling(c, _TILE_ELEMS[name])
    grad = torch.empty_like(logits)
    _run(name, logits.device, (-(-b // tile_rows),),
         logits, labels, rows, *scalars.values(), grad, b, c,
         logits.stride(0), *consts, ROWS=tile_rows, BLOCK_C=block_c,
         num_warps=_warps(tile_rows * block_c))
    LAUNCHES[name] += 1
    return grad


def entropic_grad(logits: Tensor, labels: Tensor, mask: Tensor, g: Tensor,
                  count: Tensor, unk_weight: float) -> Tensor:
    """K2: the entropic logits gradient at ``g / max(count, 1)``; one
    kernel launch on CUDA, plain on CPU.  A caller with a ready scale
    passes it as ``g`` and a count of 1."""
    if not _use_kernel(logits, labels, mask):
        return entropic_grad_plain(logits, labels, mask, g, count,
                                   unk_weight)
    return _launch_grad("entropic_bwd", logits, labels, mask,
                        {"g": g, "count": count}, float(unk_weight),
                        float(unk_weight) / logits.shape[1])


def ce_grad(logits: Tensor, labels: Tensor, row_weights: Tensor, g: Tensor,
            wsum: Tensor) -> Tensor:
    """K4: the weighted-CE logits gradient at ``g / max(wsum, 1e-12)``; one
    kernel launch on CUDA, plain on CPU.  A caller with a ready scale
    passes it as ``g`` and a weight sum of 1."""
    if not _use_kernel(logits, labels, row_weights):
        return ce_grad_plain(logits, labels, row_weights, g, wsum)
    return _launch_grad("ce_bwd", logits, labels, row_weights,
                        {"g": g, "wsum": wsum})


# -- autograd (the JAX custom VJPs, fused_loss.py:269-341) -------------------

class _EntropicFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mask, unk_weight):
        _, count, mean = entropic_fwd(logits, labels, mask, unk_weight)
        ctx.save_for_backward(logits, labels, mask, count)
        ctx.unk_weight = unk_weight
        ctx.mark_non_differentiable(count)
        # No zeros for the count's unused gradient: that is a fill launch.
        ctx.set_materialize_grads(False)
        return mean, count

    @staticmethod
    def backward(ctx, g_mean, _g_count):
        if g_mean is None:   # an undefined cotangent: no gradient
            return None, None, None, None
        logits, labels, mask, count = ctx.saved_tensors
        return (entropic_grad(logits, labels, mask, g_mean, count,
                              ctx.unk_weight), None, None, None)


class _WeightedCEFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, row_weights):
        _, wsum, mean = ce_fwd(logits, labels, row_weights)
        ctx.save_for_backward(logits, labels, row_weights, wsum)
        ctx.mark_non_differentiable(wsum)
        # No zeros for the weight sum's unused gradient: that is a fill.
        ctx.set_materialize_grads(False)
        return mean, wsum

    @staticmethod
    def backward(ctx, g_mean, _g_wsum):
        if g_mean is None:   # an undefined cotangent: no gradient
            return None, None, None
        logits, labels, row_weights, wsum = ctx.saved_tensors
        return (ce_grad(logits, labels, row_weights, g_mean, wsum), None,
                None)


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
