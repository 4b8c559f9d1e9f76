"""Triton kernels of the port's batch-norm, forward and backward (Hopper).

Imported only by :mod:`.batch_norm` when it launches on a CUDA tensor, so
the package imports where Triton is absent.  The launch code (the plan of
tiles and grids, scratch, launch counts) lives in :mod:`.batch_norm`.

Replaces no TPU kernel: the JAX package leaves batch-norm to XLA, which
fuses the statistics, the affine map and their gradients into the
convolutions' neighbours.  Eager PyTorch runs the written-out math of
:mod:`..models.norm` as ~27 kernels forward and ~35 backward for each
batch-norm, each a full pass over the activation.  These four take one
pass each:

* :func:`osi_bn_stats` -- per-channel float32 ``sum x`` and ``sum x^2``
  over the statistics window (the first ``n_rows`` rows); the last
  program of each channel tile adds the partials in index order and
  writes ``mean``, the fast variance ``max(E[x^2] - E[x]^2, 0)`` and its
  argument ``d = E[x^2] - E[x]^2``, and updates the running statistics as
  ``m * old + (1 - m) * new``;
* :func:`osi_bn_apply` -- one read of ``x`` and one write of ``y`` in the
  rounding form of the model: ghost (``GHOST``) ``round(round(x * mul_b) +
  add_b)`` with ``mul``, ``add`` rounded to the compute dtype first; flax
  ``round((x - mean) * mul + bias)`` in float32;
* :func:`osi_bn_bwd` -- one pass over ``g`` and ``x`` (every row):
  ``dx = round(g * mul)`` as the form rounds it (unless the window covers
  every row, when :func:`osi_bn_fix` writes it) and per-channel partials
  of ``sum g`` and ``sum g * (x - mean)``; the last program of each
  channel tile adds them and writes ``dweight``, ``dbias`` and the two
  coefficients of the statistics' share of ``dx``;
* :func:`osi_bn_fix` -- over the window rows only: ``dx = round(dx +
  round(a + b * (x - mean)))``, the statistics' share added as autograd
  accumulates it.

Bound on the card: bytes.  A few float32 operations an element against
2-6 bytes moved; there is no tensor-core work.  Design: a tile of
``[BLOCK_M, BLOCK_C]`` elements, rows of the ``[N*H*W, C]`` view and
channels, addressed through the tensor's strides (``n * s_n + p * s_p +
c * s_c``, ``p`` the pixel within the image), so both dense layouts run:
channels-last with channels innermost (16-byte accesses along them) and
contiguous NCHW.  Per-channel values are loaded and formed once per
program, which walks ``tiles`` consecutive row tiles.  The reductions keep
one float32 accumulator per element of the tile and reduce it once; the
programs' partials go to scratch, and the last program of a channel tile
(a ticket, as K1 and K3 take them) adds them in index order, so repeat
runs give the same bits and no float atomic is used.

No operation is contracted: the wrapper launches with
``enable_fp_fusion=False``, so every product and sum rounds where the
written-out math rounds it, and ``sqrt``, ``1 / v`` are the IEEE ones
(``sqrt_rn``, ``div_rn``) that torch's ``sqrt`` and ``reciprocal`` give.
The flax form's ``rsqrt`` is the card's, as torch's ``rsqrt`` is.
"""

import triton
import triton.language as tl

_SIZES = ["n_rows", "hw", "tiles", "last"]


@triton.jit
def _offsets(rows, cols, hw, s_n, s_p, s_c):
    """Element offsets of a ``[rows, cols]`` tile: row ``m`` is pixel
    ``m % hw`` of image ``m // hw``."""
    n = rows // hw
    p = rows - n * hw
    row = n.to(tl.int64) * s_n + p.to(tl.int64) * s_p
    return row[:, None] + (cols * s_c)[None, :]


@triton.jit
def _inv_std(var, eps, GHOST: tl.constexpr):
    """``1 / sqrt(var + eps)`` as each form writes it: ghost
    ``reciprocal(sqrt(.))``, flax ``rsqrt(.)``."""
    if GHOST:
        inv = tl.math.div_rn(1.0, tl.math.sqrt_rn(var + eps))
    else:
        inv = tl.math.rsqrt(var + eps)
    return inv


@triton.jit
def _round(v, out_ptr):
    """``v`` rounded to the compute dtype (``out_ptr``'s), back in
    float32."""
    return v.to(out_ptr.dtype.element_ty).to(tl.float32)


@triton.jit
def _dx_mul(var, w, eps, out_ptr, GHOST: tl.constexpr):
    """The per-channel factor of ``dx = g * mul``: ghost ``mul`` rounded
    to the compute dtype, flax in float32."""
    mul = _inv_std(var, eps, GHOST) * w
    if GHOST:
        mul = _round(mul, out_ptr)
    return mul


@triton.jit
def _ticket_sums(s1, s2, pid_m, cols, col_ok, n_ch, part_ptr, ticket_ptr,
                 pid_c, last, SUM_BLOCK: tl.constexpr,
                 BLOCK_C: tl.constexpr):
    """Add every row program's two partials of this channel tile.

    ``last`` is the row programs less one; with one row program its own
    sums are the totals.  Otherwise each program stores its partials
    ``[2, C]`` at ``part + pid_m * 2C``, passes a block barrier (every
    thread's store is issued before the ticket) and takes a ticket of its
    channel tile's int32 counter (acq_rel, GPU scope).  Returns
    ``(is_last, sum1, sum2)``: the program that draws ``last`` reads the
    partials through L2 (``.cg``), adds them in index order and resets
    the counter to 0 for the next launch or graph replay.
    """
    done = last == 0
    if last != 0:
        base = part_ptr + pid_m.to(tl.int64) * 2 * n_ch
        tl.store(base + cols, s1, mask=col_ok)
        tl.store(base + n_ch + cols, s2, mask=col_ok)
        tl.debug_barrier()
        ticket = tl.atomic_add(ticket_ptr + pid_c, 1, sem="acq_rel",
                               scope="gpu")
        done = ticket == last
        if done:
            offs = tl.arange(0, SUM_BLOCK)
            acc1 = tl.zeros([SUM_BLOCK, BLOCK_C], dtype=tl.float32)
            acc2 = tl.zeros([SUM_BLOCK, BLOCK_C], dtype=tl.float32)
            for start in range(0, last + 1, SUM_BLOCK):
                idx = start + offs
                ok = (idx <= last)[:, None] & col_ok[None, :]
                ptr = (part_ptr + idx.to(tl.int64)[:, None] * 2 * n_ch
                       + cols[None, :])
                acc1 += tl.load(ptr, mask=ok, other=0.0,
                                cache_modifier=".cg")
                acc2 += tl.load(ptr + n_ch, mask=ok, other=0.0,
                                cache_modifier=".cg")
            s1 = tl.sum(acc1, axis=0)
            s2 = tl.sum(acc2, axis=0)
            tl.store(ticket_ptr + pid_c, 0)
    return done, s1, s2


@triton.jit(do_not_specialize=_SIZES)
def osi_bn_stats(x_ptr, part_ptr, stats_ptr, rmean_ptr, rvar_ptr,
                 ticket_ptr, n_rows, n_ch, hw, s_n, s_p, s_c, tiles, last,
                 count, momentum, keep, BLOCK_M: tl.constexpr,
                 BLOCK_C: tl.constexpr, SUM_BLOCK: tl.constexpr):
    """Statistics of the first ``n_rows`` rows; writes ``stats[0:3, C]``
    = (mean, var, d) and updates the running statistics in place."""
    pid_m = tl.program_id(0)
    pid_c = tl.program_id(1)
    cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
    col_ok = cols < n_ch
    acc1 = tl.zeros([BLOCK_M, BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_M, BLOCK_C], dtype=tl.float32)
    for t in range(0, tiles):
        rows = (pid_m * tiles + t) * BLOCK_M + tl.arange(0, BLOCK_M)
        ok = (rows < n_rows)[:, None] & col_ok[None, :]
        x = tl.load(x_ptr + _offsets(rows, cols, hw, s_n, s_p, s_c),
                    mask=ok, other=0.0).to(tl.float32)
        acc1 += x
        acc2 += x * x
    done, s1, s2 = _ticket_sums(tl.sum(acc1, axis=0), tl.sum(acc2, axis=0),
                                pid_m, cols, col_ok, n_ch, part_ptr,
                                ticket_ptr, pid_c, last, SUM_BLOCK, BLOCK_C)
    if done:
        mean = tl.math.div_rn(s1, count)
        mean2 = tl.math.div_rn(s2, count)
        d = mean2 - mean * mean
        var = tl.maximum(d, 0.0)
        tl.store(stats_ptr + cols, mean, mask=col_ok)
        tl.store(stats_ptr + n_ch + cols, var, mask=col_ok)
        tl.store(stats_ptr + 2 * n_ch + cols, d, mask=col_ok)
        rm = tl.load(rmean_ptr + cols, mask=col_ok, other=0.0)
        rv = tl.load(rvar_ptr + cols, mask=col_ok, other=0.0)
        tl.store(rmean_ptr + cols, momentum * rm + keep * mean, mask=col_ok)
        tl.store(rvar_ptr + cols, momentum * rv + keep * var, mask=col_ok)


@triton.jit(do_not_specialize=_SIZES)
def osi_bn_apply(x_ptr, y_ptr, mean_ptr, var_ptr, w_ptr, b_ptr, n_rows,
                 n_ch, hw, s_n, s_p, s_c, tiles, eps, GHOST: tl.constexpr,
                 BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
    """``y`` from ``x`` given the statistics, in the form's rounding."""
    pid_m = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    col_ok = cols < n_ch
    mean = tl.load(mean_ptr + cols, mask=col_ok, other=0.0)
    var = tl.load(var_ptr + cols, mask=col_ok, other=1.0)
    w = tl.load(w_ptr + cols, mask=col_ok, other=0.0)
    b = tl.load(b_ptr + cols, mask=col_ok, other=0.0)
    inv = _inv_std(var, eps, GHOST)
    mul = inv * w
    if GHOST:
        add = _round(b - mean * inv * w, y_ptr)
        mul = _round(mul, y_ptr)
    for t in range(0, tiles):
        rows = (pid_m * tiles + t) * BLOCK_M + tl.arange(0, BLOCK_M)
        ok = (rows < n_rows)[:, None] & col_ok[None, :]
        offs = _offsets(rows, cols, hw, s_n, s_p, s_c)
        x = tl.load(x_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        if GHOST:
            y = _round(x * mul[None, :], y_ptr) + add[None, :]
        else:
            y = (x - mean[None, :]) * mul[None, :] + b[None, :]
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=ok)


@triton.jit(do_not_specialize=_SIZES)
def osi_bn_bwd(g_ptr, x_ptr, dx_ptr, stats_ptr, w_ptr, part_ptr, dw_ptr,
               db_ptr, coef_ptr, ticket_ptr, n_rows, n_ch, hw, g_n, g_p,
               g_c, s_n, s_p, s_c, tiles, last, count, eps,
               GHOST: tl.constexpr, WRITE_DX: tl.constexpr,
               BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr,
               SUM_BLOCK: tl.constexpr):
    """Pass over every row: ``dx = round(g * mul)`` (``WRITE_DX``), and
    ``sum g``, ``sum g * (x - mean)``; the last program of a channel tile
    writes ``dweight``, ``dbias`` and, with a window (``count > 0``), the
    share ``(a, b)`` of the statistics in ``coef[0:2, C]``."""
    pid_m = tl.program_id(0)
    pid_c = tl.program_id(1)
    cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
    col_ok = cols < n_ch
    mean = tl.load(stats_ptr + cols, mask=col_ok, other=0.0)
    var = tl.load(stats_ptr + n_ch + cols, mask=col_ok, other=1.0)
    w = tl.load(w_ptr + cols, mask=col_ok, other=0.0)
    mul = _dx_mul(var, w, eps, dx_ptr, GHOST)
    acc1 = tl.zeros([BLOCK_M, BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_M, BLOCK_C], dtype=tl.float32)
    for t in range(0, tiles):
        rows = (pid_m * tiles + t) * BLOCK_M + tl.arange(0, BLOCK_M)
        ok = (rows < n_rows)[:, None] & col_ok[None, :]
        offs = _offsets(rows, cols, hw, s_n, s_p, s_c)
        g = tl.load(g_ptr + _offsets(rows, cols, hw, g_n, g_p, g_c),
                    mask=ok, other=0.0).to(tl.float32)
        x = tl.load(x_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        acc1 += g
        acc2 += g * (x - mean[None, :])
        if WRITE_DX:
            dx = g * mul[None, :]
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=ok)
    done, s1, s2 = _ticket_sums(tl.sum(acc1, axis=0), tl.sum(acc2, axis=0),
                                pid_m, cols, col_ok, n_ch, part_ptr,
                                ticket_ptr, pid_c, last, SUM_BLOCK, BLOCK_C)
    if done:
        inv = _inv_std(var, eps, GHOST)
        tl.store(dw_ptr + cols, s2 * inv, mask=col_ok)
        tl.store(db_ptr + cols, s1, mask=col_ok)
        if count > 0:
            d = tl.load(stats_ptr + 2 * n_ch + cols, mask=col_ok, other=0.0)
            # d(var)/d(d) as torch.maximum(d, 0) passes it: 1 above the
            # clamp, 1/2 on it, 0 below.
            clamp = tl.where(d > 0, 1.0, tl.where(d == 0, 0.5, 0.0))
            dvar = -0.5 * (w * s2) * (inv * inv * inv) * clamp
            a = tl.math.div_rn(-(s1 * inv * w), count)
            b = tl.math.div_rn(2.0 * dvar, count)
            tl.store(coef_ptr + cols, a, mask=col_ok)
            tl.store(coef_ptr + n_ch + cols, b, mask=col_ok)


@triton.jit(do_not_specialize=_SIZES)
def osi_bn_fix(g_ptr, x_ptr, dx_ptr, stats_ptr, w_ptr, coef_ptr, n_rows,
               n_ch, hw, g_n, g_p, g_c, s_n, s_p, s_c, tiles, eps,
               GHOST: tl.constexpr, FROM_G: tl.constexpr,
               BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
    """Over the window rows: ``dx = round(direct + round(a + b * (x -
    mean)))``, ``direct`` read from ``dx`` or, with ``FROM_G`` (the window
    covers every row, so :func:`osi_bn_bwd` wrote none), formed from
    ``g`` as that kernel forms it."""
    pid_m = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    col_ok = cols < n_ch
    mean = tl.load(stats_ptr + cols, mask=col_ok, other=0.0)
    a = tl.load(coef_ptr + cols, mask=col_ok, other=0.0)
    b = tl.load(coef_ptr + n_ch + cols, mask=col_ok, other=0.0)
    if FROM_G:
        var = tl.load(stats_ptr + n_ch + cols, mask=col_ok, other=1.0)
        w = tl.load(w_ptr + cols, mask=col_ok, other=0.0)
        mul = _dx_mul(var, w, eps, dx_ptr, GHOST)
    for t in range(0, tiles):
        rows = (pid_m * tiles + t) * BLOCK_M + tl.arange(0, BLOCK_M)
        ok = (rows < n_rows)[:, None] & col_ok[None, :]
        offs = _offsets(rows, cols, hw, s_n, s_p, s_c)
        x = tl.load(x_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        if FROM_G:
            g = tl.load(g_ptr + _offsets(rows, cols, hw, g_n, g_p, g_c),
                        mask=ok, other=0.0).to(tl.float32)
            direct = _round(g * mul[None, :], dx_ptr)
        else:
            direct = tl.load(dx_ptr + offs, mask=ok,
                             other=0.0).to(tl.float32)
        share = _round(a[None, :] + b[None, :] * (x - mean[None, :]),
                       dx_ptr)
        dx = direct + share
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=ok)
