"""Triton kernels for the fused losses, forward and backward (Hopper).

Imported only by :mod:`.fused_loss` when it launches on a CUDA tensor, so
the package imports where Triton is absent.  The launch code (grid, scratch
allocation, launch counts) lives in :mod:`.fused_loss`.

Replaces (``openset_imagenet_tpu/ops/fused_loss.py``):

* :func:`entropic_fwd_once` -- ``_fwd_kernel`` via ``_fused_sums``, and
  the division of the custom VJP's forward.  Per row: max, log-sum-exp,
  the target dot (``l_y`` for known rows, ``(w/C) * sum(l)`` for negative
  rows) and ``(T * lse - t_dot) * mask``; writes ``(loss_sum, count,
  loss_sum / max(count, 1))``.
* :func:`ce_fwd_once` -- ``_ce_fwd_kernel`` via ``_ce_sums``, and the
  division of the custom VJP's forward.  Per row: ``r * (lse - l_y)`` with
  the label clipped to ``[0, C-1]``; writes ``(loss_sum, wsum, loss_sum /
  max(wsum, 1e-12))``.
* :func:`entropic_bwd` -- ``_bwd_kernel`` via ``_fused_grad``, and the
  division of the custom VJP's backward: ``(T * softmax(l) - targets) *
  mask * g / max(count, 1)``, targets one-hot for ``label >= 0`` and
  uniform ``w/C`` otherwise (``T = 1`` or ``w``).
* :func:`ce_bwd` -- ``_ce_bwd_kernel`` via ``_ce_grad``, and the division
  of the custom VJP's backward: ``r * (softmax(l) - onehot) * g / max(wsum,
  1e-12)`` with the label clipped.

Forwards.  Bound on the card: bytes.  Each kernel reads the ``[B, C]``
float32 logits once (``4 * B * C`` bytes) plus 8-12 bytes a row, and
writes two floats per program; there is no tensor-core work.  At the
train step's shapes on the H100 the bytes take nanoseconds and a launch
microseconds, so each call is one launch.  Design: small programs (two
rows and one warp at C <= 128), one pass over each row tile with C padded
to the next power of two (masked lanes load ``-inf`` for the max and
count 0 in the sums), no ``[B, C]`` intermediate in device memory; each
program writes its partial ``(sum, weight)`` pair, and the last program
to finish adds them in index order in the same launch (:func:`_finish`).
The last program also divides (K1 by ``max(count, 1)``, K3 by
``max(wsum, 1e-12)``), so neither loss's mean needs a further launch.  No
float atomics, so two launches on the same input give the same bits, as
the TPU's sequential grid does.  The row loop inside a
program stands in for that sequential grid.  The TPU kernel's padding of
B to 256-row blocks is not carried over: the ragged edge is masked in the
kernel.

Backwards.  Each reads the ``[B, C]`` logits and writes the ``[B, C]``
gradient once (``8 * B * C`` bytes, 240 KB at the train step's [256, 116])
plus a few bytes a row: at these shapes the launch, not the bytes, bounds
them.  Design: one program per row tile, no cross-program state, so there
is no second pass and two launches give the same bits.  Each program
recomputes its rows' softmax from the logits (max, exp, row sum), as the
TPU kernel does, instead of reading a saved log-sum-exp.  K2 and K4 read
the cotangent ``g`` and the count (K4: the weight sum) through pointers to
the 1-element device tensors autograd holds and form ``g / max(count, 1)``
(K4: ``g / max(wsum, 1e-12)``) themselves, so each backward is one
launch.  The TPU kernels read
the scale from SMEM; a Python float would sync the host every step.
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
def _store_sums(out_ptr, loss, weight, FLOOR: tl.constexpr):
    """``out = (loss, weight, loss / max(weight, FLOOR))``, divided with
    IEEE rounding as torch's ``/`` divides."""
    tl.store(out_ptr, loss)
    tl.store(out_ptr + 1, weight)
    tl.store(out_ptr + 2, tl.math.div_rn(loss, tl.maximum(weight, FLOOR)))


@triton.jit
def _finish(loss, weight, pid, part_ptr, out_ptr, ticket_ptr, last,
            SUM_BLOCK: tl.constexpr, FLOOR: tl.constexpr):
    """Add every program's ``(loss, weight)`` in one launch.

    ``last`` is the grid size less one.  A grid of one program writes its
    sums to ``out`` and takes no ticket.  Otherwise each program stores its
    pair, passes a block barrier (every thread's store is issued before
    the ticket), and takes a ticket from the int32 counter with an
    acq_rel atomic at GPU scope.  The program that draws ``last`` reads
    the partials through L2 (``.cg``: no stale L1 line), adds them in
    index order, writes ``out`` and resets the counter to 0 for the next
    launch or graph replay.  No float atomics: the same bits at any
    program count and on every launch.
    """
    if last == 0:
        _store_sums(out_ptr, loss, weight, FLOOR)
    else:
        tl.store(part_ptr + pid * 2, loss)
        tl.store(part_ptr + pid * 2 + 1, weight)
        tl.debug_barrier()
        ticket = tl.atomic_add(ticket_ptr, 1, sem="acq_rel", scope="gpu")
        if ticket == last:
            offs = tl.arange(0, SUM_BLOCK)
            acc0 = tl.zeros([SUM_BLOCK], dtype=tl.float32)
            acc1 = tl.zeros([SUM_BLOCK], dtype=tl.float32)
            for start in range(0, last + 1, SUM_BLOCK):
                idx = start + offs
                ok = idx <= last
                acc0 += tl.load(part_ptr + idx * 2, mask=ok, other=0.0,
                                cache_modifier=".cg")
                acc1 += tl.load(part_ptr + idx * 2 + 1, mask=ok, other=0.0,
                                cache_modifier=".cg")
            _store_sums(out_ptr, tl.sum(acc0, axis=0), tl.sum(acc1, axis=0),
                        FLOOR)
            tl.store(ticket_ptr, 0)


@triton.jit
def entropic_fwd_once(logits_ptr, labels_ptr, mask_ptr, part_ptr, out_ptr,
                      ticket_ptr, n_rows, n_cols, row_stride, tiles, last,
                      unk_weight, ROWS: tl.constexpr, BLOCK_C: tl.constexpr,
                      SUM_BLOCK: tl.constexpr):
    """K1 in one launch: one partial ``(sum (T * lse - t_dot) * mask, sum
    mask)`` per program; the last program to finish writes ``(loss_sum,
    count, loss_sum / max(count, 1))`` (:func:`_finish`)."""
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
    _finish(tl.sum(loss_acc, axis=0), tl.sum(mask_acc, axis=0), pid,
            part_ptr, out_ptr, ticket_ptr, last, SUM_BLOCK, 1.0)


@triton.jit
def ce_fwd_once(logits_ptr, labels_ptr, weight_ptr, part_ptr, out_ptr,
                ticket_ptr, n_rows, n_cols, row_stride, tiles, last,
                ROWS: tl.constexpr, BLOCK_C: tl.constexpr,
                SUM_BLOCK: tl.constexpr):
    """K3 in one launch: one partial ``(sum r * (lse - l_y), sum r)`` per
    program; the last program to finish writes ``(loss_sum, wsum, loss_sum
    / max(wsum, 1e-12))`` (:func:`_finish`)."""
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
    _finish(tl.sum(loss_acc, axis=0), tl.sum(w_acc, axis=0), pid, part_ptr,
            out_ptr, ticket_ptr, last, SUM_BLOCK, 1e-12)


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
def entropic_bwd(logits_ptr, labels_ptr, mask_ptr, g_ptr, count_ptr,
                 grad_ptr, n_rows, n_cols, row_stride, unk_weight, uniform,
                 ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
    """K2 at ``scale = g / max(count, 1)``, divided with IEEE rounding as
    torch's ``/`` divides, so the gradient has the bits of one given that
    scale from torch."""
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_C)
    row_ok = rows < n_rows
    p, ok = _softmax_tile(logits_ptr, rows, n_rows, n_cols, row_stride,
                          BLOCK_C)
    labels = tl.load(labels_ptr + rows, mask=row_ok, other=0)
    mask = tl.load(mask_ptr + rows, mask=row_ok, other=0.0)
    scale = tl.math.div_rn(tl.load(g_ptr), tl.maximum(tl.load(count_ptr), 1.0))
    known = labels >= 0
    onehot = (cols[None, :] == labels[:, None]).to(tl.float32)
    targets = tl.where(known[:, None], onehot, uniform)
    t_sum = tl.where(known, 1.0, unk_weight)
    grad = (t_sum[:, None] * p - targets) * (mask * scale)[:, None]
    ptrs = grad_ptr + rows[:, None].to(tl.int64) * n_cols + cols[None, :]
    tl.store(ptrs, grad.to(grad_ptr.dtype.element_ty), mask=ok)


@triton.jit
def ce_bwd(logits_ptr, labels_ptr, weight_ptr, g_ptr, wsum_ptr, grad_ptr,
           n_rows, n_cols, row_stride,
           ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
    """K4 at ``scale = g / max(wsum, 1e-12)``, divided with IEEE rounding
    as torch's ``/`` divides, so the gradient has the bits of one given
    that scale from torch."""
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_C)
    row_ok = rows < n_rows
    p, ok = _softmax_tile(logits_ptr, rows, n_rows, n_cols, row_stride,
                          BLOCK_C)
    labels = tl.load(labels_ptr + rows, mask=row_ok, other=0)
    labels = tl.minimum(tl.maximum(labels, 0), n_cols - 1)
    r = tl.load(weight_ptr + rows, mask=row_ok, other=0.0)
    scale = tl.math.div_rn(tl.load(g_ptr),
                           tl.maximum(tl.load(wsum_ptr), 1e-12))
    onehot = (cols[None, :] == labels[:, None]).to(tl.float32)
    grad = (p - onehot) * (r * scale)[:, None]
    ptrs = grad_ptr + rows[:, None].to(tl.int64) * n_cols + cols[None, :]
    tl.store(ptrs, grad.to(grad_ptr.dtype.element_ty), mask=ok)
