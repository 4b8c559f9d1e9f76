"""Triton kernels of the Swin's LayerNorm and residual junction (Hopper).

Imported only by :mod:`.layer_norm` when it launches on a CUDA tensor, so
the package imports where Triton is absent.  The launch code (the plan of
tiles and grids, scratch, launch counts) and the note on what the kernels
replace and what bounds them live there.

Layout: the input is ``[rows, C]`` (every dimension but the last folded
into rows), rows ``C`` elements apart, channels innermost.  A tile is
``[BLOCK_M, BLOCK_C]``: ``BLOCK_M`` whole rows, ``BLOCK_C`` the channels
rounded up to a power of two, so each row's statistics are a reduction
inside the program.  A program walks ``tiles`` consecutive row tiles;
the per-channel vectors are loaded once a program.  ``n_ch`` is left to
Triton's specialisation: its divisibility by 16 lets the compiler prove
that every row starts 16-byte aligned, and so load and store it in
16-byte vectors.

* :func:`osi_layer_norm_fwd` -- with ``ADD``: ``h = round(x + round(y +
  round(b)))`` written, else ``h = x``; float32 ``mean`` and ``rstd =
  rsqrt(var + eps)`` of ``h`` (two passes over the tile in registers),
  written ``[rows]``; ``n = round((h - mean) * rstd * round(w) +
  round(beta))``.
* :func:`osi_layer_norm_bwd` -- ``xhat = (h - mean) * rstd``, ``g =
  grad_n * round(w)``; ``dh = round(rstd * (g - mean(g) - xhat *
  mean(g * xhat)))``, with ``GRAD_H`` then ``round(grad_h + dh)``;
  float32 per-channel partials of ``grad_n * xhat`` (the scale's
  gradient), ``grad_n`` (the shift's) and, with ``ADD``, ``dh`` (the
  bias's).  Each program writes its partials; the last program of each
  group of ``GROUP`` programs (a ticket) adds its group's in index order,
  and the last of those adds the groups' in index order, so two runs give
  the same bits, no float atomic is used and no one program reads every
  program's partials.
"""

import triton
import triton.language as tl

_SIZES = ["n_rows", "tiles", "last"]


@triton.jit
def _round(v, out_ptr):
    """``v`` rounded to the compute dtype (``out_ptr``'s), back in
    float32."""
    return v.to(out_ptr.dtype.element_ty).to(tl.float32)


@triton.jit
def _tile(pid, t, tiles, n_rows, n_ch, cols, col_ok,
          BLOCK_M: tl.constexpr):
    """``(rows, row_ok, ok, offs)`` of a program's ``t``-th row tile."""
    rows = (pid * tiles + t) * BLOCK_M + tl.arange(0, BLOCK_M)
    row_ok = rows < n_rows
    ok = row_ok[:, None] & col_ok[None, :]
    offs = rows.to(tl.int64)[:, None] * n_ch + cols[None, :]
    return rows, row_ok, ok, offs


@triton.jit(do_not_specialize=_SIZES)
def osi_layer_norm_fwd(x_ptr, y_ptr, b_ptr, w_ptr, beta_ptr, h_ptr, n_ptr,
                       mean_ptr, rstd_ptr, n_rows, n_ch, tiles, width, eps,
                       ADD: tl.constexpr, BLOCK_M: tl.constexpr,
                       BLOCK_C: tl.constexpr):
    """``h`` (with ``ADD``), ``n``, ``mean`` and ``rstd`` of a program's
    row tiles."""
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_C)
    col_ok = cols < n_ch
    w = _round(tl.load(w_ptr + cols, mask=col_ok, other=0.0), n_ptr)
    beta = _round(tl.load(beta_ptr + cols, mask=col_ok, other=0.0), n_ptr)
    if ADD:
        b = _round(tl.load(b_ptr + cols, mask=col_ok, other=0.0), n_ptr)
    for t in range(0, tiles):
        rows, row_ok, ok, offs = _tile(pid, t, tiles, n_rows, n_ch, cols,
                                       col_ok, BLOCK_M)
        h = tl.load(x_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        if ADD:
            y = tl.load(y_ptr + offs, mask=ok, other=0.0).to(tl.float32)
            h = _round(h + _round(y + b[None, :], n_ptr), n_ptr)
            tl.store(h_ptr + offs, h.to(h_ptr.dtype.element_ty), mask=ok)
        mean = tl.math.div_rn(tl.sum(h, axis=1), width)
        d = tl.where(ok, h - mean[:, None], 0.0)
        var = tl.math.div_rn(tl.sum(d * d, axis=1), width)
        rstd = tl.math.rsqrt(var + eps)
        n = d * rstd[:, None] * w[None, :] + beta[None, :]
        tl.store(n_ptr + offs, n.to(n_ptr.dtype.element_ty), mask=ok)
        tl.store(mean_ptr + rows, mean, mask=row_ok)
        tl.store(rstd_ptr + rows, rstd, mask=row_ok)


@triton.jit
def _store3(base, s_w, s_beta, s_b, cols, col_ok, n_ch,
            ADD: tl.constexpr):
    """A row of a ``[*, 3, C]`` float32 array from ``base``: the three
    sums (the third with ``ADD`` only)."""
    tl.store(base + cols, s_w, mask=col_ok)
    tl.store(base + n_ch + cols, s_beta, mask=col_ok)
    if ADD:
        tl.store(base + 2 * n_ch + cols, s_b, mask=col_ok)


@triton.jit
def _sum3(ptr, first, count, cols, col_ok, n_ch, ADD: tl.constexpr,
          SUM_BLOCK: tl.constexpr, BLOCK_C: tl.constexpr):
    """The sums of rows ``first .. first + count - 1`` of a ``[*, 3, C]``
    float32 array, read through L2 (``.cg``) in a fixed order."""
    offs = tl.arange(0, SUM_BLOCK)
    acc_w = tl.zeros([SUM_BLOCK, BLOCK_C], dtype=tl.float32)
    acc_beta = tl.zeros([SUM_BLOCK, BLOCK_C], dtype=tl.float32)
    acc_b = tl.zeros([SUM_BLOCK, BLOCK_C], dtype=tl.float32)
    for start in range(0, count, SUM_BLOCK):
        idx = start + offs
        ok = (idx < count)[:, None] & col_ok[None, :]
        ptr_t = (ptr + (first + idx).to(tl.int64)[:, None] * 3 * n_ch
                 + cols[None, :])
        acc_w += tl.load(ptr_t, mask=ok, other=0.0, cache_modifier=".cg")
        acc_beta += tl.load(ptr_t + n_ch, mask=ok, other=0.0,
                            cache_modifier=".cg")
        if ADD:
            acc_b += tl.load(ptr_t + 2 * n_ch, mask=ok, other=0.0,
                             cache_modifier=".cg")
    return (tl.sum(acc_w, axis=0), tl.sum(acc_beta, axis=0),
            tl.sum(acc_b, axis=0))


@triton.jit(do_not_specialize=_SIZES)
def osi_layer_norm_bwd(gn_ptr, gh_ptr, h_ptr, mean_ptr, rstd_ptr, w_ptr,
                       dh_ptr, part_ptr, out_ptr, ticket_ptr, n_rows, n_ch,
                       tiles, last, width, ADD: tl.constexpr,
                       GRAD_H: tl.constexpr, GROUP: tl.constexpr,
                       STAGES: tl.constexpr, SUM_BLOCK: tl.constexpr,
                       BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
    """``dh`` of a program's row tiles; the last program writes
    ``out[0:3, C]`` = (dweight, dbeta, dbias) (dbias with ``ADD``).

    The row loop is software-pipelined over ``STAGES`` tiles (the loads
    of the next tiles are in flight while one is reduced).  ``last`` is
    the programs less one.  ``part`` holds a row of three
    partials for every program, then one for every group of ``GROUP``
    programs; ``ticket`` a counter for every group, then one for the
    groups.  Each finishing program resets the counter it drew from to 0
    for the next launch or graph replay."""
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_C)
    col_ok = cols < n_ch
    w = _round(tl.load(w_ptr + cols, mask=col_ok, other=0.0), dh_ptr)
    acc_w = tl.zeros([BLOCK_M, BLOCK_C], dtype=tl.float32)
    acc_beta = tl.zeros([BLOCK_M, BLOCK_C], dtype=tl.float32)
    acc_b = tl.zeros([BLOCK_M, BLOCK_C], dtype=tl.float32)
    for t in tl.range(0, tiles, num_stages=STAGES):
        rows, row_ok, ok, offs = _tile(pid, t, tiles, n_rows, n_ch, cols,
                                       col_ok, BLOCK_M)
        gn = tl.load(gn_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        h = tl.load(h_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        mean = tl.load(mean_ptr + rows, mask=row_ok, other=0.0)
        rstd = tl.load(rstd_ptr + rows, mask=row_ok, other=0.0)
        xhat = tl.where(ok, (h - mean[:, None]) * rstd[:, None], 0.0)
        g = gn * w[None, :]
        c1 = tl.math.div_rn(tl.sum(g * xhat, axis=1), width)
        c2 = tl.math.div_rn(tl.sum(g, axis=1), width)
        dh = _round((g - c2[:, None] - xhat * c1[:, None]) * rstd[:, None],
                    dh_ptr)
        if GRAD_H:
            gh = tl.load(gh_ptr + offs, mask=ok, other=0.0).to(tl.float32)
            dh = _round(gh + dh, dh_ptr)
        tl.store(dh_ptr + offs, dh.to(dh_ptr.dtype.element_ty), mask=ok)
        acc_w += gn * xhat
        acc_beta += gn
        if ADD:
            acc_b += tl.where(ok, dh, 0.0)
    s_w = tl.sum(acc_w, axis=0)
    s_beta = tl.sum(acc_beta, axis=0)
    s_b = tl.sum(acc_b, axis=0)
    if last == 0:
        _store3(out_ptr, s_w, s_beta, s_b, cols, col_ok, n_ch, ADD)
    else:
        _store3(part_ptr + pid * 3 * n_ch, s_w, s_beta, s_b, cols, col_ok,
                n_ch, ADD)
        tl.debug_barrier()
        group = pid // GROUP
        first = group * GROUP
        size = tl.minimum(GROUP, last + 1 - first)
        ticket = tl.atomic_add(ticket_ptr + group, 1, sem="acq_rel",
                               scope="gpu")
        if ticket == size - 1:
            s_w, s_beta, s_b = _sum3(part_ptr, first, size, cols, col_ok,
                                     n_ch, ADD, SUM_BLOCK, BLOCK_C)
            tl.store(ticket_ptr + group, 0)
            groups = last // GROUP + 1
            _store3(part_ptr + (last + 1 + group) * 3 * n_ch, s_w, s_beta,
                    s_b, cols, col_ok, n_ch, ADD)
            tl.debug_barrier()
            ticket = tl.atomic_add(ticket_ptr + groups, 1, sem="acq_rel",
                                   scope="gpu")
            if ticket == groups - 1:
                s_w, s_beta, s_b = _sum3(part_ptr, last + 1, groups, cols,
                                         col_ok, n_ch, ADD, SUM_BLOCK,
                                         BLOCK_C)
                tl.store(ticket_ptr + groups, 0)
                _store3(out_ptr, s_w, s_beta, s_b, cols, col_ok, n_ch, ADD)
