"""Batch-norm as hand-written kernels on CUDA tensors, plain torch on CPU.

The model's :class:`..models.norm.BatchNorm` computes, in each of its two
rounding forms (ghost, ``stats_rows > 0``: ``mul`` and ``add`` rounded to
the compute dtype and ``x * mul + add`` in that dtype; flax, ``stats_rows
== 0``: ``(x - mean) * mul + bias`` in float32, rounded once), the
statistics of a window of leading images, the affine map and, through
autograd, their gradients.  Written out in torch that is ~27 kernels
forward and ~35 backward, each a pass over the activation.  On CUDA
tensors :func:`batch_norm` runs it as one ``torch.autograd.Function``
over four Triton kernels (:mod:`.triton_batch_norm`), two each way:

* :func:`bn_stats` (training) -- the window's float32 mean and fast
  variance ``max(E[x^2] - E[x]^2, 0)`` (and its argument ``d``) in one
  launch, the running statistics updated in it;
* :func:`bn_apply` -- the affine map given the statistics, one read and
  one write of the activation, bit-equal to :func:`bn_apply_plain`;
* :func:`bn_backward` -- one pass over ``g`` and ``x`` that writes ``dx =
  g * mul`` as the form rounds it and, from float32 sums of ``g`` and ``g
  * (x - mean)``, ``dweight``, ``dbias`` and the statistics' share of
  ``dx``; then a fix-up over the window's rows that adds that share
  (``dx = round(dx + round(share))``, as autograd accumulates it).

What is saved for the backward is ``x``, the weight and the ``[3, C]``
statistics, not the float32 copy of the window that autograd keeps for
the written-out math.  The backward sums in float32 where autograd of the
ghost form sums bfloat16 products into bfloat16: :func:`bn_grad_plain`
is the formula the kernels compute, and the CPU tests hold it against
autograd of the written-out math.

The wrappers route by device: CPU tensors go to the plain versions beside
each kernel (``*_plain``); CUDA tensors launch the kernels or raise -- a
dtype other than bfloat16, float16 or float32, a layout other than
channels-last or contiguous NCHW, or a missing Triton is an error, never a
switch to the plain versions.  :func:`batch_norm` takes CUDA tensors
alone: the module runs the written-out math on the CPU.  :func:`_plan` lays out every launch from
the shape alone; ``LAUNCHES`` counts launches by kernel.
"""

from __future__ import annotations

import functools
from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from ._triton import DTYPES, SMS, run
from ._triton import ticket as _ticket

Tensor = torch.Tensor

LAUNCHES = {"bn_stats": 0, "bn_apply": 0, "bn_bwd": 0, "bn_fix": 0}
LAYOUTS = ("channels_last", "contiguous")
# Elements of a tile: 16 KB of a bfloat16 or float16 activation (8 KB in
# float32) for the streaming passes, 4096 for the reductions (two float32
# accumulators an element, 32 registers a thread at 8 warps).
_STREAM_BYTES = 16384
_REDUCE_ELEMS = 4096
# Programs of a launch: the streaming passes keep about eight programs of
# eight warps on each SM and walk the rest in a loop; the reductions four,
# so that the last program of a channel tile adds few partials.
_STREAM_PROGRAMS = 8 * SMS
_REDUCE_PROGRAMS = 4 * SMS
# Widest channel tile by layout: channels innermost (channels-last) takes
# 128 (256 bytes of bfloat16 a row); NCHW, whose channels lie a plane
# apart, 32.
_MAX_BLOCK_C = {"channels_last": 128, "contiguous": 32}
_WARPS = 8


class Launch(NamedTuple):
    """One kernel's launch: program ``(pm, pc)`` walks the row tiles
    ``pm * tiles ... pm * tiles + tiles - 1`` of ``block_m`` rows of
    channel tile ``pc`` of ``block_c`` channels."""

    block_m: int
    block_c: int
    tiles: int
    grid_m: int
    grid_c: int
    warps: int


class Plan(NamedTuple):
    """The launches of one batch-norm; ``stats`` and ``fix`` are None
    without a statistics window (eval)."""

    stats: Optional[Launch]
    apply: Launch
    bwd: Launch
    fix: Optional[Launch]


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _launch(rows: int, c: int, block_c: int, elems: int,
            programs: int) -> Launch:
    """Tiles of ``elems`` elements over ``rows`` rows and ``c`` channels,
    at most about ``programs`` programs (each at least one tile)."""
    block_m = max(1, elems // block_c)
    grid_c = -(-c // block_c)
    n_tiles = max(1, -(-rows // block_m))
    tiles = -(-n_tiles // max(1, programs // grid_c))
    return Launch(block_m, block_c, tiles, -(-n_tiles // tiles), grid_c,
                  _WARPS)


@functools.lru_cache(maxsize=None)
def _plan(m: int, c: int, r: int, dtype: torch.dtype,
          layout: str) -> Plan:
    """The launches of a batch-norm over ``m`` rows (``N*H*W``) of ``c``
    channels whose statistics window is the first ``r`` rows (0: none).

    A pure function of the shape: the channel tile is ``c`` rounded up to
    a power of two (at least 16), at most the layout's widest; a tile
    holds ``_STREAM_BYTES`` of the activation in the streaming passes
    (apply, fix) and ``_REDUCE_ELEMS`` elements in the reductions (stats,
    bwd); each launch caps its programs and loops over the rest.
    """
    if layout not in _MAX_BLOCK_C:
        raise ValueError(f"unknown layout {layout!r}")
    block_c = min(max(16, _pow2(c)), _MAX_BLOCK_C[layout])
    stream = _STREAM_BYTES // (torch.finfo(dtype).bits // 8)
    return Plan(
        stats=(_launch(r, c, block_c, _REDUCE_ELEMS, _REDUCE_PROGRAMS)
               if r > 0 else None),
        apply=_launch(m, c, block_c, stream, _STREAM_PROGRAMS),
        bwd=_launch(m, c, block_c, _REDUCE_ELEMS, _REDUCE_PROGRAMS),
        fix=(_launch(r, c, block_c, stream, _STREAM_PROGRAMS)
             if r > 0 else None))


def _tiles(launch: Launch, rows: int, c: int
           ) -> Iterator[Tuple[int, int, int, int, int, int]]:
    """``(pm, pc, row0, row1, col0, col1)`` of every tile a launch's
    programs touch, clipped to ``rows`` x ``c`` as the kernels mask."""
    for pc in range(launch.grid_c):
        col0 = pc * launch.block_c
        col1 = min(col0 + launch.block_c, c)
        for pm in range(launch.grid_m):
            for t in range(launch.tiles):
                row0 = (pm * launch.tiles + t) * launch.block_m
                if row0 < rows and col0 < c:
                    yield (pm, pc, row0, min(row0 + launch.block_m, rows),
                           col0, col1)


# -- plain versions (CPU path; the reference the kernels are held to) --------

def _promote(t: Tensor) -> Tensor:
    """At least float32 (float64 stays, for the backward's tests)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _channel(t: Tensor) -> Tensor:
    return t.view(1, -1, 1, 1)


def bn_stats_plain(x: Tensor, rows: int, running_mean: Tensor,
                   running_var: Tensor, momentum: float) -> Tensor:
    """``[3, C]`` (mean, var, d) of the first ``rows`` images: float32
    mean and fast variance ``var = max(d, 0)``, ``d = E[x^2] - E[x]^2``,
    as the written-out batch-norm computes them; updates the running
    statistics as ``m * old + (1 - m) * new``."""
    xs = _promote(x[:rows])
    mean = xs.mean(dim=(0, 2, 3))
    mean2 = xs.square().mean(dim=(0, 2, 3))
    d = mean2 - mean.square()
    var = torch.maximum(d, mean2.new_zeros(()))
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean + (1.0 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1.0 - momentum) * var)
    return torch.stack([mean, var, d])


def _inv_std(var: Tensor, eps: float, ghost: bool) -> Tensor:
    """``1 / sqrt(var + eps)`` as each form writes it."""
    if ghost:
        return torch.reciprocal(torch.sqrt(var + eps))
    return torch.rsqrt(var + eps)


def bn_apply_plain(x: Tensor, mean: Tensor, var: Tensor, weight: Tensor,
                   bias: Tensor, eps: float, ghost: bool) -> Tensor:
    """The affine map given the statistics, in the form's rounding."""
    c = _channel
    inv = _inv_std(var, eps, ghost)
    if ghost:
        mul, add = inv * weight, bias - mean * inv * weight
        return x * c(mul.to(x.dtype)) + c(add.to(x.dtype))
    y = _promote(x) - c(mean)
    return (y * c(inv * weight) + c(bias)).to(x.dtype)


def bn_grad_plain(g: Tensor, x: Tensor, weight: Tensor, stats: Tensor,
                  rows: int, ghost: bool, eps: float
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(dx, dweight, dbias)`` of the form's map, by the formula the
    kernels compute.

    ``stats`` holds (mean, var[, d]); ``rows`` is the statistics window in
    images (0: the statistics are constants, as in eval).  With ``s1 =
    sum g`` and ``s2 = sum g * (x - mean)`` over every row, in at least
    float32, and ``inv = 1 / sqrt(var + eps)``: ``dweight = s2 * inv``,
    ``dbias = s1`` and ``dx = round(g * mul)`` (ghost: ``mul`` rounded to
    the dtype first).  Through the window's mean and variance (``var =
    max(d, 0)``, whose gradient is 1, 1/2 or 0 as ``d`` is above, on or
    below 0): ``dvar = -s2 * weight * inv^3 / 2``, and the window's rows
    get ``round(a + b * (x - mean))`` with ``a = -s1 * inv * weight / n``,
    ``b = 2 * dvar / n`` over its ``n`` elements, added to their ``dx``
    and rounded again.
    """
    c = _channel
    mean, var = _promote(stats[0]), _promote(stats[1])
    w = _promote(weight)
    g32, x32 = _promote(g), _promote(x)
    s1 = g32.sum(dim=(0, 2, 3))
    s2 = (g32 * (x32 - c(mean))).sum(dim=(0, 2, 3))
    inv = _inv_std(var, eps, ghost)
    mul = inv * w
    if ghost:
        mul = _promote(mul.to(x.dtype))
    dx = (g32 * c(mul)).to(x.dtype)
    if rows > 0:
        d = stats[2]
        clamp = torch.where(d > 0, 1.0, torch.where(d == 0, 0.5, 0.0))
        dvar = -0.5 * (w * s2) * (inv * inv * inv) * _promote(clamp)
        n = rows * x.shape[2] * x.shape[3]
        a = -(s1 * inv * w) / n
        b = 2.0 * dvar / n
        share = (c(a) + c(b) * (x32[:rows] - c(mean))).to(x.dtype)
        dx[:rows] = (_promote(dx[:rows]) + _promote(share)).to(x.dtype)
    return dx, s2 * inv, s1


# -- kernel wrappers ----------------------------------------------------------

# Launch a kernel of :mod:`.triton_batch_norm` on the current stream.
_run = functools.partial(run, "triton_batch_norm")


def _layout(x: Tensor) -> str:
    """The dense layout of a 4-d activation, or raise."""
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"batch-norm takes a non-empty [N, C, H, W] "
                         f"tensor, got {tuple(x.shape)}")
    if x.is_contiguous(memory_format=torch.channels_last):
        return "channels_last"
    if x.is_contiguous():
        return "contiguous"
    raise ValueError(f"batch-norm kernels take channels-last or contiguous "
                     f"NCHW tensors, got strides {x.stride()} for shape "
                     f"{tuple(x.shape)}")


def _strides(t: Tensor) -> Tuple[int, int, int]:
    """``(s_n, s_p, s_c)``: the strides of image, pixel (``h * W + w``)
    and channel, or raise where H and W do not flatten into one stride."""
    _, _, h, w = t.shape
    sn, sc, sh, sw = t.stride()
    if h == 1 or w == 1:
        return sn, (sw if h == 1 else sh), sc
    if sh != w * sw:
        raise ValueError(f"batch-norm kernels need H and W of one stride, "
                         f"got strides {t.stride()} for shape "
                         f"{tuple(t.shape)}")
    return sn, sw, sc


def _check_vector(name: str, t: Tensor, c: int, like: Tensor) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != (c,)
            or t.device != like.device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 [{c}] "
                         f"tensor on {like.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _use_kernel(x: Tensor, **vectors: Tensor) -> Optional[str]:
    """None for CPU tensors (plain versions); the layout after the checks
    pass on CUDA tensors."""
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise ValueError(f"batch-norm runs on CPU or CUDA tensors, not "
                         f"{x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"batch-norm kernels take bfloat16, float16 or "
                        f"float32 activations, got {x.dtype}")
    layout = _layout(x)
    for name, t in vectors.items():
        _check_vector(name, t, x.shape[1], x)
    return layout


def _consts(launch: Launch, **constexprs) -> dict:
    return dict(constexprs, BLOCK_M=launch.block_m, BLOCK_C=launch.block_c,
                num_warps=launch.warps, enable_fp_fusion=False)


def _rows(x: Tensor) -> Tuple[int, int, int]:
    """``(N*H*W, C, H*W)``."""
    n, c, h, w = x.shape
    return n * h * w, c, h * w


def _stats(x: Tensor, layout: str, rows: int, running_mean: Tensor,
           running_var: Tensor, momentum: float) -> Tensor:
    """:func:`bn_stats`'s launch on checked operands."""
    m, c, hw = _rows(x)
    rows = min(rows, x.shape[0])
    if rows <= 0:
        raise ValueError(f"a statistics window of {rows} images")
    launch = _plan(m, c, rows * hw, x.dtype, layout).stats
    stats = torch.empty((3, c), dtype=torch.float32, device=x.device)
    part = (stats if launch.grid_m == 1 else torch.empty(
        (launch.grid_m, 2, c), dtype=torch.float32, device=x.device))
    _run("osi_bn_stats", x.device, (launch.grid_m, launch.grid_c), x, part,
         stats, running_mean, running_var, _ticket(x.device, launch.grid_c),
         rows * hw, c, hw, *_strides(x), launch.tiles, launch.grid_m - 1,
         float(rows * hw), float(momentum), float(1.0 - momentum),
         **_consts(launch, SUM_BLOCK=launch.block_m))
    LAUNCHES["bn_stats"] += 1
    return stats


def _apply(x: Tensor, layout: str, mean: Tensor, var: Tensor,
           weight: Tensor, bias: Tensor, eps: float, ghost: bool) -> Tensor:
    """:func:`bn_apply`'s launch on checked operands."""
    m, c, hw = _rows(x)
    launch = _plan(m, c, 0, x.dtype, layout).apply
    y = torch.empty_like(x)
    _run("osi_bn_apply", x.device, (launch.grid_m, launch.grid_c), x, y,
         mean, var, weight, bias, m, c, hw, *_strides(x), launch.tiles,
         float(eps), **_consts(launch, GHOST=bool(ghost)))
    LAUNCHES["bn_apply"] += 1
    return y


def _backward(g: Tensor, x: Tensor, layout: str, weight: Tensor,
              stats: Tensor, rows: int, ghost: bool, eps: float,
              need_dx: bool) -> Tuple[Optional[Tensor], Tensor, Tensor]:
    """:func:`bn_backward`'s launches on checked operands."""
    m, c, hw = _rows(x)
    window = rows * hw if need_dx else 0
    plan = _plan(m, c, window, x.dtype, layout)
    from_g = window == m
    dx = torch.empty_like(x) if need_dx else x
    out = torch.empty((4, c), dtype=torch.float32, device=x.device)
    dw, db, coef = out[0], out[1], out[2:]
    launch = plan.bwd
    part = (out if launch.grid_m == 1 else torch.empty(
        (launch.grid_m, 2, c), dtype=torch.float32, device=x.device))
    strides_g, strides_x = _strides(g), _strides(x)
    _run("osi_bn_bwd", x.device, (launch.grid_m, launch.grid_c), g, x, dx,
         stats, weight, part, dw, db, coef, _ticket(x.device, launch.grid_c),
         m, c, hw, *strides_g, *strides_x, launch.tiles, launch.grid_m - 1,
         float(window and rows * hw), float(eps),
         **_consts(launch, GHOST=bool(ghost),
                   WRITE_DX=need_dx and not from_g,
                   SUM_BLOCK=launch.block_m))
    LAUNCHES["bn_bwd"] += 1
    if window:
        launch = plan.fix
        _run("osi_bn_fix", x.device, (launch.grid_m, launch.grid_c), g, x,
             dx, stats, weight, coef, window, c, hw, *strides_g, *strides_x,
             launch.tiles, float(eps),
             **_consts(launch, GHOST=bool(ghost), FROM_G=from_g))
        LAUNCHES["bn_fix"] += 1
    return (dx if need_dx else None), dw, db


def bn_stats(x: Tensor, rows: int, running_mean: Tensor,
             running_var: Tensor, momentum: float) -> Tensor:
    """``[3, C]`` float32 (mean, var, d) of the first ``rows`` images, the
    running statistics updated; one kernel launch on CUDA, plain on
    CPU."""
    layout = _use_kernel(x, running_mean=running_mean,
                         running_var=running_var)
    if layout is None:
        return bn_stats_plain(x, rows, running_mean, running_var, momentum)
    return _stats(x, layout, int(rows), running_mean, running_var,
                  momentum)


def bn_apply(x: Tensor, mean: Tensor, var: Tensor, weight: Tensor,
             bias: Tensor, eps: float, ghost: bool) -> Tensor:
    """The affine map given the statistics, in the form's rounding; one
    kernel launch on CUDA (bit-equal to :func:`bn_apply_plain`), plain on
    CPU."""
    layout = _use_kernel(x, mean=mean, var=var, weight=weight, bias=bias)
    if layout is None:
        return bn_apply_plain(x, mean, var, weight, bias, eps, ghost)
    return _apply(x, layout, mean, var, weight, bias, eps, ghost)


def _check_grad(g: Tensor, x: Tensor, stats: Tensor, rows: int) -> None:
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"the output gradient {g.dtype} "
                         f"{tuple(g.shape)} on {g.device} does not match "
                         f"the input {x.dtype} {tuple(x.shape)}")
    _strides(g)
    want = (3 if rows > 0 else 2, x.shape[1])
    if stats.dtype != torch.float32 or tuple(stats.shape) != want or \
            not stats.is_contiguous() or stats.device != x.device:
        raise ValueError(f"stats must be a contiguous float32 {list(want)} "
                         f"tensor on {x.device}, got {stats.dtype} "
                         f"{tuple(stats.shape)} on {stats.device}")


def bn_backward(g: Tensor, x: Tensor, weight: Tensor, stats: Tensor,
                rows: int, ghost: bool, eps: float, need_dx: bool = True
                ) -> Tuple[Optional[Tensor], Tensor, Tensor]:
    """``(dx, dweight, dbias)`` as :func:`bn_grad_plain` defines them
    (``dx`` None unless ``need_dx``); two kernel launches on CUDA (one
    without a window or without ``dx``), plain on CPU."""
    layout = _use_kernel(x, weight=weight)
    rows = min(int(rows), x.shape[0])
    if layout is None:
        dx, dw, db = bn_grad_plain(g, x, weight, stats, rows, ghost, eps)
        return (dx if need_dx else None), dw, db
    _check_grad(g, x, stats, rows)
    return _backward(g, x, layout, weight, stats, rows, ghost, eps, need_dx)


# -- autograd -----------------------------------------------------------------

class _BatchNorm(torch.autograd.Function):
    """The batch-norm of checked CUDA operands in ``layout``."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, training,
                stats_rows, eps, momentum, layout):
        ghost = stats_rows > 0
        if training:
            rows = min(stats_rows, x.shape[0]) if ghost else x.shape[0]
            stats = _stats(x, layout, rows, running_mean, running_var,
                           momentum)
        else:
            rows = 0
            stats = torch.stack([running_mean, running_var])
        y = _apply(x, layout, stats[0], stats[1], weight, bias, eps, ghost)
        ctx.save_for_backward(x, weight, stats)
        ctx.rows, ctx.ghost, ctx.eps, ctx.layout = rows, ghost, eps, layout
        ctx.set_materialize_grads(False)
        return y

    @staticmethod
    def backward(ctx, g):
        if g is None:   # an undefined cotangent: no gradient
            return (None,) * 10
        x, weight, stats = ctx.saved_tensors
        _check_grad(g, x, stats, ctx.rows)
        dx, dw, db = _backward(g, x, ctx.layout, weight, stats, ctx.rows,
                               ctx.ghost, ctx.eps, ctx.needs_input_grad[0])
        return (dx if ctx.needs_input_grad[0] else None,
                dw.to(weight.dtype), db.to(weight.dtype), None, None, None,
                None, None, None, None)


def batch_norm(x: Tensor, weight: Tensor, bias: Tensor, running_mean: Tensor,
               running_var: Tensor, *, training: bool, stats_rows: int,
               eps: float, momentum: float) -> Tensor:
    """:class:`..models.norm.BatchNorm`'s forward through the kernels, on
    CUDA tensors: in training the statistics of the first ``stats_rows``
    images (all when 0), the running statistics updated; in eval the
    running statistics.  ``stats_rows > 0`` picks the ghost rounding
    form.  Differentiable in ``x``, ``weight`` and ``bias`` through the
    window's statistics; without a gradient to take, the kernels run
    without the autograd node.  CPU tensors raise."""
    layout = _use_kernel(x, weight=weight, bias=bias,
                         running_mean=running_mean, running_var=running_var)
    if layout is None:
        raise ValueError("batch_norm runs the kernels on CUDA tensors; on "
                         "the CPU models/norm.py runs the written-out math")
    stats_rows = int(stats_rows)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _BatchNorm.apply(x, weight, bias, running_mean, running_var,
                                bool(training), stats_rows, float(eps),
                                float(momentum), layout)
    ghost = stats_rows > 0
    if training:
        rows = min(stats_rows, x.shape[0]) if ghost else x.shape[0]
        stats = _stats(x, layout, rows, running_mean, running_var, momentum)
        mean, var = stats[0], stats[1]
    else:
        mean, var = running_mean, running_var
    return _apply(x, layout, mean, var, weight, bias, eps, ghost)
