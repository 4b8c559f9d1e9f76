"""Triton kernels of the Swin's shifted-window attention (Hopper).

Imported only by :mod:`.window_attention` when it launches on a CUDA
tensor, so the package imports where Triton is absent.  The launch code
(the plan of runs and grids, scratch, launch counts) and the note on
what the kernels replace and what bounds them live there.

Addressing: a program ``(head, g)`` walks windows ``w0 .. w1 - 1``.
Window ``w`` is image ``w // nw``, window row ``wy`` and column ``wx`` of
the shifted map; its token ``t`` (row ``t // ws``, column ``t % ws``)
lies at ``(r, c) = (wy * ws + t // ws, wx * ws + t % ws)`` of the shifted
map and at ``((r + shift) % H, (c + shift) % W)`` of the map, whose
``[B, H, W, 3C]`` rows hold q, k and v of every head (``s * C + head *
HD + d``).  The output and the gradient of the output are ``[B, H, W,
C]`` at the same places.  A token's region (``SHIFTED``) is ``3 * rh +
rw`` with ``rh = [r >= H - ws] + [r >= H - shift]``, ``rw`` alike; tokens
of different regions get -100.  A window is one tile of ``BN`` tokens
(``ws * ws`` padded to a power of two): scores ``[BN, BN]`` in float32,
products by ``tl.dot`` (float32 operands in IEEE float32: ``PREC``).
"""

import triton
import triton.language as tl

# Sizes that take any value without a new compile.  ``channels`` is left
# to Triton's specialisation: its divisibility by 16 lets the compiler
# prove that every gathered row of a head starts 16-byte aligned, and so
# load and store it in 16-byte vectors.
_SIZES = ["n_win", "per", "height", "width", "nwx", "nw", "ws", "shift",
          "table_ws"]


@triton.jit
def _window(w, tok, height, width, nwx, nw, ws, shift,
            SHIFTED: tl.constexpr):
    """``(pos, region, edge)`` of window ``w``'s tokens: the int64 place
    ``(b * H + oh) * W + ow`` in the map, the region id (0 unshifted) and
    whether the window lies in the last window row or column, the only
    windows of a shifted map that hold more than one region."""
    b = w // nw
    wr = w - b * nw
    wy = wr // nwx
    wx = wr - wy * nwx
    edge = (wy == nw // nwx - 1) | (wx == nwx - 1)
    r = wy * ws + tok // ws
    c = wx * ws + tok % ws
    if SHIFTED:
        oh = r + shift
        oh = tl.where(oh >= height, oh - height, oh)
        ow = c + shift
        ow = tl.where(ow >= width, ow - width, ow)
        rh = (r >= height - ws).to(tl.int32) + (r >= height - shift).to(
            tl.int32)
        rw = (c >= width - ws).to(tl.int32) + (c >= width - shift).to(
            tl.int32)
        region = rh * 3 + rw
    else:
        oh = r
        ow = c
        region = tok * 0
    pos = (b.to(tl.int64) * height + oh) * width + ow
    return pos, region, edge


@triton.jit
def _bias_tile(table_ptr, tok, tok_ok, ws, table_ws, head, heads):
    """The ``[BN, BN]`` float32 bias of one head, gathered from the table
    by the official index; -inf on the padding keys, so that they take no
    weight."""
    ti = tok // ws
    tj = tok - ti * ws
    row = ((ti[:, None] - ti[None, :] + table_ws - 1) * (2 * table_ws - 1)
           + tj[:, None] - tj[None, :] + table_ws - 1)
    bias = tl.load(table_ptr + row * heads + head,
                   mask=tok_ok[:, None] & tok_ok[None, :], other=0.0)
    return tl.where(tok_ok[None, :], bias, float("-inf"))


@triton.jit
def _scores(q, k, bias, region, edge, scale, SHIFTED: tl.constexpr,
            PREC: tl.constexpr):
    """``q k^T * scale + bias``, and -100 across regions in a shifted
    map's edge windows."""
    s = tl.dot(q, tl.trans(k), input_precision=PREC) * scale + bias
    if SHIFTED:
        if edge:
            s += tl.where(region[:, None] == region[None, :], 0.0, -100.0)
    return s


@triton.jit(do_not_specialize=_SIZES)
def osi_win_flash_fwd(qkv_ptr, table_ptr, out_ptr, lse_ptr, n_win, per,
                      height, width, nwx, nw, ws, shift, table_ws, channels,
                      scale, HD: tl.constexpr, BN: tl.constexpr,
                      SHIFTED: tl.constexpr, PREC: tl.constexpr):
    """The output ``[B, H, W, C]`` and the log-sum-exp ``[windows, heads,
    N]`` of this program's windows and head."""
    head = tl.program_id(0)
    heads = tl.num_programs(0)
    w0 = tl.program_id(1) * per
    w1 = tl.minimum(w0 + per, n_win)
    n = ws * ws
    tok = tl.arange(0, BN)
    tok_ok = tok < n
    col = head * HD + tl.arange(0, HD)
    bias = _bias_tile(table_ptr, tok, tok_ok, ws, table_ws, head, heads)
    for w in range(w0, w1):
        pos, region, edge = _window(w, tok, height, width, nwx, nw, ws,
                                    shift, SHIFTED)
        src = qkv_ptr + (pos * (3 * channels))[:, None] + col[None, :]
        q = tl.load(src, mask=tok_ok[:, None], other=0.0)
        k = tl.load(src + channels, mask=tok_ok[:, None], other=0.0)
        v = tl.load(src + 2 * channels, mask=tok_ok[:, None], other=0.0)
        s = _scores(q, k, bias, region, edge, scale, SHIFTED, PREC)
        m = tl.max(s, 1)
        e = tl.exp(s - m[:, None])
        total = tl.sum(e, 1)
        lse = m + tl.log(total)
        p = e * (1.0 / total)[:, None]
        o = tl.dot(p.to(v.dtype), v, input_precision=PREC)
        tl.store(out_ptr + (pos * channels)[:, None] + col[None, :],
                 o.to(out_ptr.dtype.element_ty), mask=tok_ok[:, None])
        tl.store(lse_ptr + (w.to(tl.int64) * heads + head) * n + tok, lse,
                 mask=tok_ok)


@triton.jit(do_not_specialize=_SIZES + ["last"])
def osi_win_flash_bwd(qkv_ptr, grad_ptr, table_ptr, lse_ptr, dqkv_ptr,
                      dense_ptr, part_ptr, dtable_ptr, ticket_ptr, n_win,
                      per, height, width, nwx, nw, ws, shift, table_ws,
                      channels, scale, last, HD: tl.constexpr,
                      BN: tl.constexpr, BR: tl.constexpr,
                      SHIFTED: tl.constexpr, PREC: tl.constexpr,
                      SUM_BLOCK: tl.constexpr):
    """dq, dk and dv of this program's windows and head into ``dqkv``;
    the table's gradient of the head from the last program of the head.

    The program's float32 sum of ``dS`` over its windows goes to its
    ``[N, N]`` scratch (``dense``) and is folded into table rows: row
    ``(di, dj)`` takes ``sum_t1 dS[t1, t1 - (di, dj)]``, query tokens in
    order.  With one program along the windows (``last == 0``) those rows
    are the gradient; otherwise each program stores them at ``part +
    (g * heads + head) * BR``, passes a block barrier and takes a ticket
    of its head's int32 counter (acq_rel, GPU scope); the program that
    draws ``last`` adds the ``last + 1`` rows in index order through L2
    (``.cg``), writes the head's column of ``dtable`` and resets the
    counter to 0.
    """
    head = tl.program_id(0)
    heads = tl.num_programs(0)
    g = tl.program_id(1)
    w0 = g * per
    w1 = tl.minimum(w0 + per, n_win)
    n = ws * ws
    tok = tl.arange(0, BN)
    tok_ok = tok < n
    col = head * HD + tl.arange(0, HD)
    bias = _bias_tile(table_ptr, tok, tok_ok, ws, table_ws, head, heads)
    acc = tl.zeros([BN, BN], dtype=tl.float32)
    for w in range(w0, w1):
        pos, region, edge = _window(w, tok, height, width, nwx, nw, ws,
                                    shift, SHIFTED)
        at = (pos * (3 * channels))[:, None] + col[None, :]
        q = tl.load(qkv_ptr + at, mask=tok_ok[:, None], other=0.0)
        k = tl.load(qkv_ptr + at + channels, mask=tok_ok[:, None], other=0.0)
        v = tl.load(qkv_ptr + at + 2 * channels, mask=tok_ok[:, None],
                    other=0.0)
        go = tl.load(grad_ptr + (pos * channels)[:, None] + col[None, :],
                     mask=tok_ok[:, None], other=0.0)
        lse = tl.load(lse_ptr + (w.to(tl.int64) * heads + head) * n + tok,
                      mask=tok_ok, other=0.0)
        s = _scores(q, k, bias, region, edge, scale, SHIFTED, PREC)
        p = tl.where(tok_ok[:, None], tl.exp(s - lse[:, None]), 0.0)
        dv = tl.dot(tl.trans(p.to(v.dtype)), go, input_precision=PREC)
        dp = tl.dot(go, tl.trans(v), input_precision=PREC)
        ds = p * (dp - tl.sum(p * dp, 1)[:, None])
        acc += ds
        dsr = ds.to(q.dtype)
        dq = tl.dot(dsr, k, input_precision=PREC) * scale
        dk = tl.dot(tl.trans(dsr), q, input_precision=PREC) * scale
        dst = dqkv_ptr + at
        ty = dqkv_ptr.dtype.element_ty
        tl.store(dst, dq.to(ty), mask=tok_ok[:, None])
        tl.store(dst + channels, dk.to(ty), mask=tok_ok[:, None])
        tl.store(dst + 2 * channels, dv.to(ty), mask=tok_ok[:, None])

    # The table's rows of this program's sums.
    prog = g.to(tl.int64) * heads + head
    dense = dense_ptr + prog * n * n
    tl.store(dense + tok[:, None] * n + tok[None, :], acc,
             mask=tok_ok[:, None] & tok_ok[None, :])
    tl.debug_barrier()
    span = 2 * table_ws - 1
    r = tl.arange(0, BR)
    r_ok = r < span * span
    di = r // span - (table_ws - 1)
    dj = r % span - (table_ws - 1)
    t = tl.arange(0, SUM_BLOCK)
    rows = tl.zeros([BR], dtype=tl.float32)
    for t0 in range(0, n, SUM_BLOCK):
        t1 = t0 + t
        i2 = (t1 // ws)[:, None] - di[None, :]
        j2 = (t1 % ws)[:, None] - dj[None, :]
        ok = ((t1 < n)[:, None] & r_ok[None, :] & (i2 >= 0) & (i2 < ws)
              & (j2 >= 0) & (j2 < ws))
        rows += tl.sum(tl.load(dense + t1[:, None] * n + i2 * ws + j2,
                               mask=ok, other=0.0, cache_modifier=".cg"), 0)
    if last == 0:
        tl.store(dtable_ptr + r * heads + head, rows, mask=r_ok)
    else:
        tl.store(part_ptr + prog * BR + r, rows, mask=r_ok)
        tl.debug_barrier()
        ticket = tl.atomic_add(ticket_ptr + head, 1, sem="acq_rel",
                               scope="gpu")
        if ticket == last:
            gi = tl.arange(0, SUM_BLOCK)
            total = tl.zeros([SUM_BLOCK, BR], dtype=tl.float32)
            for start in range(0, last + 1, SUM_BLOCK):
                idx = start + gi
                src = (part_ptr + (idx.to(tl.int64) * heads + head)[:, None]
                       * BR + r[None, :])
                total += tl.load(src, mask=(idx <= last)[:, None]
                                 & r_ok[None, :], other=0.0,
                                 cache_modifier=".cg")
            tl.store(dtable_ptr + r * heads + head, tl.sum(total, 0),
                     mask=r_ok)
            tl.store(ticket_ptr + head, 0)
