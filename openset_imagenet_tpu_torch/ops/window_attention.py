"""The Swin's shifted-window attention as hand-written kernels on CUDA
tensors, plain torch on CPU.

:func:`window_attention` takes the output of a block's ``qkv`` Dense in
the token map's own ``[B, H, W, 3C]`` order, the block's float32
relative-position bias table ``[(2 * table_ws - 1)**2, heads]`` and the
geometry (window ``ws``, cyclic ``shift``), and returns the attention's
``[B, H, W, C]`` output in the map's order, which the ``proj`` Dense
reads as it is.  It computes what the official code writes out as a roll
by ``-shift``, a window partition, per-window multi-head attention with
the gathered bias and, after a shift, the region mask (-100 between
tokens of different regions of the shifted map), the window merge and
the reverse roll.

It replaces ``F.scaled_dot_product_attention`` and the ~10 passes over
memory around it (roll, partition, the mask built at ``[windows, heads,
N, N]``, the transposes, merge and reverse roll, their backwards, the
stack of dq, dk and dv); no TPU kernel (the JAX package has no Swin).
Bound on the card: bytes.  A window of 49 tokens at head size 32 does
~200 K multiply-adds of products against 12 bytes a token and channel
moved over forward and backward, far under the card's ~295 operations a
byte.  So the design moves each byte once: a token's q, k and v are read
at their place in the map (a token of the shifted map at ``(r, c)`` lies
at ``((r + shift) % H, (c + shift) % W)``), the bias comes from the table
by index and the region from the token's coordinate, and nothing of size
``[windows, heads, N, N]`` exists in device memory, forward or backward.
Two Triton kernels (:mod:`.triton_window_attention`):

* ``osi_win_flash_fwd`` -- a program takes one head and a run of
  windows, the bias tile gathered once: scores in float32, the softmax's
  log-sum-exp (``[windows, heads, N]``, float32, saved for the
  backward), ``P = exp(S - max) / sum`` (``exp(S - lse)`` up to float32
  rounding) rounded to the compute dtype for the PV product, the output
  rounded once and written at the tokens' places;
* ``osi_win_flash_bwd`` -- recomputes ``P``; ``dV = P^T dO``, ``dP = dO
  V^T``, ``dS = P (dP - rowsum(P dP))`` in float32, ``dQ``, ``dK`` from
  ``dS`` rounded to the compute dtype; writes dq, dk and dv into one
  ``[B, H, W, 3C]`` gradient of ``qkv``.  The table's gradient: each
  program sums its windows' ``dS`` in float32, folds the ``N x N`` sums
  into table rows, and the last program of each head (a ticket, as
  ``osi_bn_stats`` takes them) adds the programs' rows in index order,
  so two runs give the same bits and no float atomic is used.

Numbers: q, k, v and P in the compute dtype, scores, softmax and every
sum in float32; the bias enters in float32.  In float32 the products run
in IEEE float32, never TF32.  :func:`window_attention_plain` computes the
same function with the same rounding points in torch; the CPU tests hold
it against the written-out path it replaces.

The wrapper routes by device: CPU tensors go to the plain version; CUDA
tensors launch the kernels or raise -- a dtype other than bfloat16,
float16 or float32, more than 64 tokens a window, a head size that is not
a power of two from 16 to 128, or a missing Triton is an error, never a
switch to the plain version.  :func:`_plan` lays out every launch from the
shape alone; ``LAUNCHES`` counts launches by kernel.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from ._triton import DTYPES, SMS, run
from ._triton import ticket as _ticket

Tensor = torch.Tensor

LAUNCHES = {"win_attn_fwd": 0, "win_attn_bwd": 0}
MASKED = -100.0           # the official region mask's value
MAX_TOKENS = 64           # a window's tokens: one tile of the kernels
# Launch settings, chosen by a sweep on the card at Swin-B's four stage
# shapes at batch 256: about two programs an SM, each walking a long run
# of windows with its bias tile formed once and (backward) its sums
# folded into the table's rows once, beat 4-32 shorter ones an SM by
# 5-40 %; four warps beat eight; three or four pipeline stages beat one
# or two (PERF.md §6).
_FWD_PROGRAMS = 2 * SMS
_BWD_PROGRAMS = 2 * SMS
_WARPS = 4
_FWD_STAGES = 4
_BWD_STAGES = 3
_SUM_BLOCK = 8            # partial rows the last program adds at a time


class Plan(NamedTuple):
    """The launches of one window attention: tiles of ``block_n`` tokens
    and ``block_r`` table rows; each kernel's programs ``(head, g)`` walk
    windows ``g * per ... g * per + per - 1`` (the last run clipped)."""

    block_n: int
    block_r: int
    fwd_per: int
    fwd_grid: int
    bwd_per: int
    bwd_grid: int


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _runs(n_win: int, heads: int, programs: int) -> Tuple[int, int]:
    """``(windows a program, programs along the windows)`` for about
    ``programs`` programs over ``heads`` heads."""
    grid = min(n_win, max(1, programs // heads))
    per = -(-n_win // grid)
    return per, -(-n_win // per)


@functools.lru_cache(maxsize=None)
def _plan(n_win: int, heads: int, n: int, table_ws: int) -> Plan:
    """The launches of a window attention over ``n_win`` windows of ``n``
    tokens and ``heads`` heads with a table of window ``table_ws``; a pure
    function of the shape."""
    return Plan(max(16, _pow2(n)), max(16, _pow2((2 * table_ws - 1) ** 2)),
                *_runs(n_win, heads, _FWD_PROGRAMS),
                *_runs(n_win, heads, _BWD_PROGRAMS))


# -- geometry -----------------------------------------------------------------

def _shifted_coords(h: int, w: int, ws: int) -> Tuple[Tensor, Tensor]:
    """``(r, c)``, each ``[nW, ws * ws]``: the coordinate in the shifted
    map of every token of every window (windows row-major, tokens
    row-major within a window)."""
    t = torch.arange(ws * ws)
    win = torch.arange((h // ws) * (w // ws))
    wy, wx = win // (w // ws), win % (w // ws)
    return wy[:, None] * ws + t // ws, wx[:, None] * ws + t % ws


def token_index(h: int, w: int, ws: int, shift: int) -> Tensor:
    """``[nW, ws * ws]`` int64: the position ``oh * W + ow`` in the map of
    every window token of the map rolled by ``-shift``, as the kernels
    address it: ``((r + shift) % H, (c + shift) % W)``."""
    r, c = _shifted_coords(h, w, ws)
    return ((r + shift) % h) * w + (c + shift) % w


def region_ids(h: int, w: int, ws: int, shift: int) -> Tensor:
    """``[nW, ws * ws]``: the region of every window token of the shifted
    map, from its coordinate and the three cuts ``[0, H - ws)``, ``[H -
    ws, H - shift)``, ``[H - shift, H)`` (the same in W), the official
    mask's rule."""
    r, c = _shifted_coords(h, w, ws)
    rh = (r >= h - ws).long() + (r >= h - shift).long()
    rw = (c >= w - ws).long() + (c >= w - shift).long()
    return rh * 3 + rw


def bias_index(ws: int, table_ws: int) -> Tensor:
    """``[ws * ws, ws * ws]``: the table row of every (query, key) pair,
    ``(i1 - i2 + table_ws - 1) * (2 * table_ws - 1) + j1 - j2 + table_ws -
    1`` (the official index)."""
    t = torch.arange(ws * ws)
    i, j = t // ws, t % ws
    return ((i[:, None] - i[None, :] + table_ws - 1) * (2 * table_ws - 1)
            + j[:, None] - j[None, :] + table_ws - 1)


class Geometry(NamedTuple):
    b: int
    h: int
    w: int
    c: int
    heads: int
    head_dim: int
    table_ws: int


def _geometry(qkv: Tensor, table: Tensor, ws: int, shift: int) -> Geometry:
    """The shapes of a call, or raise where they do not fit together."""
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"window attention takes a [B, H, W, 3C] qkv "
                         f"tensor, got {tuple(qkv.shape)}")
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    rows = table.shape[0] if table.dim() == 2 else 0
    table_ws = (math.isqrt(rows) + 1) // 2
    if table.dim() != 2 or rows != (2 * table_ws - 1) ** 2 or rows == 0:
        raise ValueError(f"the bias table must be [(2 * ws - 1)**2, heads], "
                         f"got {tuple(table.shape)}")
    heads = table.shape[1]
    if heads == 0 or c % heads:
        raise ValueError(f"{c} channels do not split into {heads} heads")
    if ws < 1 or h % ws or w % ws or not 0 <= shift < ws or ws > table_ws:
        raise ValueError(f"a {h}x{w} map in {ws}x{ws} windows shifted by "
                         f"{shift} with a table of window {table_ws}")
    return Geometry(b, h, w, c, heads, c // heads, table_ws)


# -- plain version (CPU path; the reference the kernels are held to) ----------

def window_attention_plain(qkv: Tensor, table: Tensor, ws: int,
                           shift: int) -> Tensor:
    """:func:`window_attention` in torch, differentiable by autograd:
    the tokens gathered by :func:`token_index`, scores ``q k^T * scale +
    bias (+ region)`` and the softmax in at least float32, ``P = exp(S -
    lse)`` rounded to ``qkv``'s dtype before the PV product (its gradient
    ``dP`` in float32), the output rounded once and put back at the
    tokens' places.  The kernels' backward also rounds ``dS`` to the
    dtype for the dq and dk products, which autograd here does not."""
    g = _geometry(qkv, table, ws, shift)
    n = ws * ws
    index = token_index(g.h, g.w, ws, shift).to(qkv.device)
    nw = index.shape[0]
    f32 = torch.promote_types(qkv.dtype, torch.float32)
    t = qkv.reshape(g.b, g.h * g.w, 3, g.heads, g.head_dim)[:, index.view(-1)]
    q, k, v = t.view(g.b, nw, n, 3, g.heads, g.head_dim).permute(
        3, 0, 1, 4, 2, 5).to(f32).unbind(0)
    bias = table[bias_index(ws, g.table_ws).view(-1).to(table.device)]
    s = (q @ k.transpose(-1, -2)) * g.head_dim ** -0.5 + bias.view(
        n, n, g.heads).permute(2, 0, 1).to(f32)
    if shift:
        ids = region_ids(g.h, g.w, ws, shift).to(qkv.device)
        region = torch.where(ids[:, :, None] != ids[:, None, :], MASKED, 0.0)
        s = s + region[:, None].to(f32)
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    # P rounded for the product, its gradient kept in float32 (as the
    # kernels keep dP): autograd of the casts would round dP to the dtype.
    p = p + (p.to(qkv.dtype).to(f32) - p).detach()
    out = (p @ v).to(qkv.dtype)
    out = out.permute(0, 1, 3, 2, 4).reshape(g.b, nw * n, g.c)
    return out[:, torch.argsort(index.view(-1))].view(g.b, g.h, g.w, g.c)


# -- kernel wrappers ----------------------------------------------------------

# Launch a kernel of :mod:`.triton_window_attention` on the current stream.
_run = functools.partial(run, "triton_window_attention")


def _check_kernel(qkv: Tensor, table: Tensor, g: Geometry, ws: int) -> None:
    """What the kernels take, on CUDA tensors; raise otherwise."""
    if qkv.dtype not in DTYPES:
        raise TypeError(f"window-attention kernels take bfloat16, float16 "
                        f"or float32 qkv, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError(f"window-attention kernels take a contiguous qkv, "
                         f"got strides {qkv.stride()}")
    if (table.dtype != torch.float32 or not table.is_contiguous()
            or table.device != qkv.device):
        raise ValueError(f"the bias table must be a contiguous float32 "
                         f"tensor on {qkv.device}, got {table.dtype} on "
                         f"{table.device}")
    if ws * ws > MAX_TOKENS:
        raise ValueError(f"window-attention kernels take at most "
                         f"{MAX_TOKENS} tokens a window, got {ws * ws}")
    if g.head_dim not in (16, 32, 64, 128):
        raise ValueError(f"window-attention kernels take a head size that "
                         f"is a power of two from 16 to 128, got "
                         f"{g.head_dim}")


def _sizes(g: Geometry, ws: int, shift: int, per: int, n_win: int):
    """The kernels' integer arguments after the pointers."""
    return (n_win, per, g.h, g.w, g.w // ws, (g.h // ws) * (g.w // ws), ws,
            shift, g.table_ws, g.c)


def _consts(qkv: Tensor, g: Geometry, plan: Plan, shift: int,
            stages: int) -> dict:
    return dict(HD=g.head_dim, BN=plan.block_n, SHIFTED=bool(shift),
                PREC="ieee" if qkv.dtype == torch.float32 else "tf32",
                num_warps=_WARPS, num_stages=stages)


def _forward(qkv: Tensor, table: Tensor, g: Geometry, ws: int,
             shift: int) -> Tuple[Tensor, Tensor]:
    """``osi_win_flash_fwd`` on checked operands: ``(out, lse)``."""
    n_win = g.b * (g.h // ws) * (g.w // ws)
    plan = _plan(n_win, g.heads, ws * ws, g.table_ws)
    out = torch.empty((g.b, g.h, g.w, g.c), dtype=qkv.dtype,
                      device=qkv.device)
    lse = torch.empty((n_win, g.heads, ws * ws), dtype=torch.float32,
                      device=qkv.device)
    _run("osi_win_flash_fwd", qkv.device, (g.heads, plan.fwd_grid), qkv,
         table, out, lse, *_sizes(g, ws, shift, plan.fwd_per, n_win),
         float(g.head_dim ** -0.5),
         **_consts(qkv, g, plan, shift, _FWD_STAGES))
    LAUNCHES["win_attn_fwd"] += 1
    return out, lse


def _backward(grad: Tensor, qkv: Tensor, table: Tensor, lse: Tensor,
              g: Geometry, ws: int, shift: int) -> Tuple[Tensor, Tensor]:
    """``osi_win_flash_bwd`` on checked operands: ``(dqkv, dtable)``."""
    n_win = g.b * (g.h // ws) * (g.w // ws)
    n = ws * ws
    plan = _plan(n_win, g.heads, n, g.table_ws)
    programs = plan.bwd_grid * g.heads
    dqkv = torch.empty_like(qkv)
    dtable = torch.empty_like(table)
    dense = torch.empty((programs, n, n), dtype=torch.float32,
                        device=qkv.device)
    part = (dtable if plan.bwd_grid == 1 else torch.empty(
        (programs, plan.block_r), dtype=torch.float32, device=qkv.device))
    _run("osi_win_flash_bwd", qkv.device, (g.heads, plan.bwd_grid), qkv,
         grad, table, lse, dqkv, dense, part, dtable,
         _ticket(qkv.device, g.heads),
         *_sizes(g, ws, shift, plan.bwd_per, n_win),
         float(g.head_dim ** -0.5), plan.bwd_grid - 1,
         BR=plan.block_r, SUM_BLOCK=_SUM_BLOCK,
         **_consts(qkv, g, plan, shift, _BWD_STAGES))
    LAUNCHES["win_attn_bwd"] += 1
    return dqkv, dtable


class _WindowAttention(torch.autograd.Function):
    """The window attention of checked CUDA operands."""

    @staticmethod
    def forward(ctx, qkv, table, ws, shift, g):
        out, lse = _forward(qkv, table, g, ws, shift)
        ctx.save_for_backward(qkv, table, lse)
        ctx.ws, ctx.shift, ctx.g = ws, shift, g
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, grad):
        if grad is None:   # an undefined cotangent: no gradient
            return (None,) * 5
        qkv, table, lse = ctx.saved_tensors
        if grad.shape != (ctx.g.b, ctx.g.h, ctx.g.w, ctx.g.c) or \
                grad.dtype != qkv.dtype:
            raise ValueError(f"the output gradient {grad.dtype} "
                             f"{tuple(grad.shape)} does not match the "
                             f"output of a {qkv.dtype} window attention")
        dqkv, dtable = _backward(grad.contiguous(), qkv, table, lse, ctx.g,
                                 ctx.ws, ctx.shift)
        return dqkv, dtable, None, None, None


def window_attention(qkv: Tensor, table: Tensor, ws: int,
                     shift: int) -> Tensor:
    """``[B, H, W, C]``: multi-head attention inside the ``ws x ws``
    windows of the map rolled by ``-shift``, with the relative-position
    bias of ``table`` (``[(2 * table_ws - 1)**2, heads]``, float32) and,
    where ``shift``, the region mask, merged and rolled back; ``qkv`` is
    ``[B, H, W, 3C]`` in the map's order (q, k, v, then heads, then the
    head's channels).  Two kernel launches on CUDA (one without a
    gradient to take), the plain version on CPU."""
    ws, shift = int(ws), int(shift)
    g = _geometry(qkv, table, ws, shift)
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, table, ws, shift)
    if qkv.device.type != "cuda":
        raise ValueError(f"window attention runs on CPU or CUDA tensors, "
                         f"not {qkv.device}")
    _check_kernel(qkv, table, g, ws)
    if torch.is_grad_enabled() and (qkv.requires_grad or
                                    table.requires_grad):
        return _WindowAttention.apply(qkv, table, ws, shift, g)
    return _forward(qkv, table, g, ws, shift)[0]
