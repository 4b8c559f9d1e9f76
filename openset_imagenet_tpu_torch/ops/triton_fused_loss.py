"""Triton kernels for the fused losses, forward and backward (Hopper).

Imported only by :mod:`.fused_loss` when it launches on a CUDA tensor, so
the package imports where Triton is absent.  The launch code (grid, scratch
allocation, launch counts) lives in :mod:`.fused_loss`.

Replaces (``openset_imagenet_tpu/ops/fused_loss.py``):

* :func:`entropic_fwd_partials` -- ``_fwd_kernel`` via ``_fused_sums``.
  Per row: max, log-sum-exp, the target dot (``l_y`` for known rows,
  ``(w/C) * sum(l)`` for negative rows) and ``(T * lse - t_dot) * mask``.
* :func:`ce_fwd_partials` -- ``_ce_fwd_kernel`` via ``_ce_sums``.  Per row:
  ``r * (lse - l_y)`` with the label clipped to ``[0, C-1]``.
* :func:`entropic_bwd` -- ``_bwd_kernel`` via ``_fused_grad``:
  ``(T * softmax(l) - targets) * mask * scale``, targets one-hot for
  ``label >= 0`` and uniform ``w/C`` otherwise (``T = 1`` or ``w``).
* :func:`ce_bwd` -- ``_ce_bwd_kernel`` via ``_ce_grad``:
  ``r * (softmax(l) - onehot) * scale`` with the label clipped.

Forwards.  Bound on the card: bytes.  Each kernel reads the ``[B, C]`` float32 logits
once (``4 * B * C`` bytes) plus 8-12 bytes a row, and writes two floats per
program; there is no tensor-core work.  Design: one pass over each row
block with C padded to the next power of two (masked lanes load ``-inf``
for the max and count 0 in the sums), no ``[B, C]`` intermediate in device
memory, and a deterministic two-stage sum -- each program writes its
partial ``(sum, weight)`` pair and :func:`sum_partials`, one program, adds
them in a fixed order.  No float atomics, so two launches on the same
input give the same bits, as the TPU's sequential grid does.  The row loop
inside a program stands in for that sequential grid.  The TPU kernel's
padding of B to 256-row blocks is not carried over: the ragged edge is
masked in the kernel.

Backwards.  Each reads the ``[B, C]`` logits and writes the ``[B, C]``
gradient once (``8 * B * C`` bytes, 240 KB at the train step's [256, 116])
plus a few bytes a row: at these shapes the launch, not the bytes, bounds
them.  Design: one program per row tile, no cross-program state, so there
is no second pass and two launches give the same bits.  Each program
recomputes its rows' softmax from the logits (max, exp, row sum), as the
TPU kernel does, instead of reading a saved log-sum-exp.  ``scale``
(``g / count``, or ``g / sum r``) is read through a pointer to the
1-element device tensor that autograd hands the backward, where the TPU
kernel reads it from SMEM: a Python float would sync the host every step.
The gradient is stored in the logits' dtype; the ragged last tile and the
padded columns are masked on store.
"""

import triton
import triton.language as tl


@triton.jit
def _row_tile(logits_ptr, rows, n_rows, n_cols, row_stride,
              BLOCK_C: tl.constexpr):
    """Load a ``[ROWS, BLOCK_C]`` tile; return (row lse, tile with 0 pads)."""
    cols = tl.arange(0, BLOCK_C)
    row_ok = rows < n_rows
    ok = row_ok[:, None] & (cols[None, :] < n_cols)
    ptrs = logits_ptr + rows[:, None].to(tl.int64) * row_stride + cols[None, :]
    lg = tl.load(ptrs, mask=ok, other=float("-inf"))
    m = tl.where(row_ok, tl.max(lg, axis=1), 0.0)
    lse = m + tl.log(tl.sum(tl.exp(lg - m[:, None]), axis=1))
    return lse, tl.where(ok, lg, 0.0)


@triton.jit
def entropic_fwd_partials(logits_ptr, labels_ptr, mask_ptr, part_ptr,
                          n_rows, n_cols, row_stride, tiles, unk_weight,
                          ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_C)
    loss_acc = tl.zeros([ROWS], dtype=tl.float32)
    mask_acc = tl.zeros([ROWS], dtype=tl.float32)
    for t in range(0, tiles):
        rows = (pid * tiles + t) * ROWS + tl.arange(0, ROWS)
        row_ok = rows < n_rows
        lse, lz = _row_tile(logits_ptr, rows, n_rows, n_cols, row_stride,
                            BLOCK_C)
        labels = tl.load(labels_ptr + rows, mask=row_ok, other=0)
        mask = tl.load(mask_ptr + rows, mask=row_ok, other=0.0)
        l_y = tl.sum(tl.where(cols[None, :] == labels[:, None], lz, 0.0),
                     axis=1)
        uniform_dot = (unk_weight / n_cols) * tl.sum(lz, axis=1)
        known = labels >= 0
        t_sum = tl.where(known, 1.0, unk_weight)
        t_dot = tl.where(known, l_y, uniform_dot)
        loss_acc += tl.where(row_ok, (t_sum * lse - t_dot) * mask, 0.0)
        mask_acc += mask
    tl.store(part_ptr + pid * 2, tl.sum(loss_acc, axis=0))
    tl.store(part_ptr + pid * 2 + 1, tl.sum(mask_acc, axis=0))


@triton.jit
def ce_fwd_partials(logits_ptr, labels_ptr, weight_ptr, part_ptr,
                    n_rows, n_cols, row_stride, tiles,
                    ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_C)
    loss_acc = tl.zeros([ROWS], dtype=tl.float32)
    w_acc = tl.zeros([ROWS], dtype=tl.float32)
    for t in range(0, tiles):
        rows = (pid * tiles + t) * ROWS + tl.arange(0, ROWS)
        row_ok = rows < n_rows
        lse, lz = _row_tile(logits_ptr, rows, n_rows, n_cols, row_stride,
                            BLOCK_C)
        labels = tl.load(labels_ptr + rows, mask=row_ok, other=0)
        labels = tl.minimum(tl.maximum(labels, 0), n_cols - 1)
        r = tl.load(weight_ptr + rows, mask=row_ok, other=0.0)
        l_y = tl.sum(tl.where(cols[None, :] == labels[:, None], lz, 0.0),
                     axis=1)
        loss_acc += tl.where(row_ok, r * (lse - l_y), 0.0)
        w_acc += r
    tl.store(part_ptr + pid * 2, tl.sum(loss_acc, axis=0))
    tl.store(part_ptr + pid * 2 + 1, tl.sum(w_acc, axis=0))


@triton.jit
def sum_partials(part_ptr, out_ptr, n_parts, BLOCK: tl.constexpr):
    """One program: fixed-order sum of ``[n_parts, 2]`` partials."""
    offs = tl.arange(0, BLOCK)
    acc0 = tl.zeros([BLOCK], dtype=tl.float32)
    acc1 = tl.zeros([BLOCK], dtype=tl.float32)
    for start in range(0, n_parts, BLOCK):
        idx = start + offs
        ok = idx < n_parts
        acc0 += tl.load(part_ptr + idx * 2, mask=ok, other=0.0)
        acc1 += tl.load(part_ptr + idx * 2 + 1, mask=ok, other=0.0)
    tl.store(out_ptr, tl.sum(acc0, axis=0))
    tl.store(out_ptr + 1, tl.sum(acc1, axis=0))


@triton.jit
def _softmax_tile(logits_ptr, rows, n_rows, n_cols, row_stride,
                  BLOCK_C: tl.constexpr):
    """Softmax of a ``[ROWS, BLOCK_C]`` tile (0 on padded columns)."""
    cols = tl.arange(0, BLOCK_C)
    row_ok = rows < n_rows
    ok = row_ok[:, None] & (cols[None, :] < n_cols)
    ptrs = logits_ptr + rows[:, None].to(tl.int64) * row_stride + cols[None, :]
    lg = tl.load(ptrs, mask=ok, other=float("-inf")).to(tl.float32)
    m = tl.where(row_ok, tl.max(lg, axis=1), 0.0)
    e = tl.exp(lg - m[:, None])
    return e / tl.sum(e, axis=1)[:, None], ok


@triton.jit
def entropic_bwd(logits_ptr, labels_ptr, mask_ptr, scale_ptr, grad_ptr,
                 n_rows, n_cols, row_stride, unk_weight, uniform,
                 ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_C)
    row_ok = rows < n_rows
    p, ok = _softmax_tile(logits_ptr, rows, n_rows, n_cols, row_stride,
                          BLOCK_C)
    labels = tl.load(labels_ptr + rows, mask=row_ok, other=0)
    mask = tl.load(mask_ptr + rows, mask=row_ok, other=0.0)
    scale = tl.load(scale_ptr)
    known = labels >= 0
    onehot = (cols[None, :] == labels[:, None]).to(tl.float32)
    targets = tl.where(known[:, None], onehot, uniform)
    t_sum = tl.where(known, 1.0, unk_weight)
    grad = (t_sum[:, None] * p - targets) * (mask * scale)[:, None]
    ptrs = grad_ptr + rows[:, None].to(tl.int64) * n_cols + cols[None, :]
    tl.store(ptrs, grad.to(grad_ptr.dtype.element_ty), mask=ok)


@triton.jit
def ce_bwd(logits_ptr, labels_ptr, weight_ptr, scale_ptr, grad_ptr,
           n_rows, n_cols, row_stride,
           ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_C)
    row_ok = rows < n_rows
    p, ok = _softmax_tile(logits_ptr, rows, n_rows, n_cols, row_stride,
                          BLOCK_C)
    labels = tl.load(labels_ptr + rows, mask=row_ok, other=0)
    labels = tl.minimum(tl.maximum(labels, 0), n_cols - 1)
    r = tl.load(weight_ptr + rows, mask=row_ok, other=0.0)
    scale = tl.load(scale_ptr)
    onehot = (cols[None, :] == labels[:, None]).to(tl.float32)
    grad = (p - onehot) * (r * scale)[:, None]
    ptrs = grad_ptr + rows[:, None].to(tl.int64) * n_cols + cols[None, :]
    tl.store(ptrs, grad.to(grad_ptr.dtype.element_ty), mask=ok)
