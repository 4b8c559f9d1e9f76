"""The Swin's LayerNorm, alone or fused with the residual junction before
it, as hand-written kernels on CUDA tensors, plain torch on CPU.

A Swin block's residual junction is ``h = x + round(y + b)`` then ``n =
LayerNorm(h)``: ``y`` the rounded product of the ``proj`` or ``fc2``
Dense, ``b`` that Dense's float32 bias, ``x`` the residual stream, ``n``
what the next Dense reads.  :func:`add_layer_norm` computes ``(h, n)``;
:func:`layer_norm` the LayerNorm of its input alone (the patch
embedding's, each stage's first, patch merging's).  Both take the float32
LayerNorm ``weight`` and ``bias`` (and ``b``) and round them to the
compute dtype inside, as the written-out ``.to(dtype)`` casts did; the
statistics are float32 over the rounded ``h``, and ``n`` is rounded once.

They replace, at each junction, the broadcast bias add, the residual
add, torch's LayerNorm forward (``vectorized_layer_norm_kernel``), its
input and weight gradients (``layer_norm_grad_input_kernel``,
``GammaBetaBackward``), autograd's accumulation of the two gradients of
``h`` and the bias gradient's sum (``reduce_kernel``), with the casts of
the three vectors and of their gradients; no TPU kernel (the JAX package
has no Swin).  Bound on the card: bytes.  A few float32 operations an
element against 2 bytes an element moved; written out, a junction moves
its ``[rows, C]`` tensor about 16 times, fused 8: the forward reads ``x``
and ``y`` and writes ``h`` and ``n``, the backward reads ``grad_n``,
``grad_h`` and ``h`` and writes ``dh``.  Two Triton kernels
(:mod:`.triton_layer_norm`):

* ``osi_layer_norm_fwd`` -- one read of ``x`` (and ``y``), one write of
  ``h`` (with the add) and ``n``, and float32 ``mean`` and ``rstd``
  ``[rows]`` for the backward;
* ``osi_layer_norm_bwd`` -- ``dh = round(grad_h + round(LN'(grad_n)))``,
  the rounding autograd gave the written-out path; ``dh`` is the gradient
  of both ``x`` and ``y`` (autograd adds and copies nothing), and float32
  column sums give the gradients of the weight, the bias and ``b``: each
  program's partials, added in a fixed order after tickets, so two runs
  give the same bits and no float atomic is used.  Written out, those
  three were bfloat16 sums cast back to float32.

The wrappers route by device: CPU tensors go to the plain versions
(:func:`layer_norm_plain`, :func:`layer_norm_grad_plain`: the forward
through ``F.layer_norm``, the backward by the kernel's formula, which the
CPU tests hold against autograd of the written-out path); CUDA tensors
launch the kernels or raise -- a dtype other than bfloat16, float16 or
float32, a tensor that is not contiguous, more than
:data:`MAX_CHANNELS` channels, a vector that is not a contiguous float32
``[C]``, or a missing Triton is an error, never a switch to the plain
versions.  Without a gradient to take (``torch.no_grad``,
``torch.inference_mode``) the forward runs without the autograd node and
saves nothing.  :func:`_plan` lays out every launch from the shape alone;
``LAUNCHES`` counts launches by form.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ._triton import DTYPES, SMS, run
from ._triton import ticket as _ticket

Tensor = torch.Tensor

LAUNCHES = {"ln_fwd": 0, "ln_add_fwd": 0, "ln_bwd": 0, "ln_add_bwd": 0}
MAX_CHANNELS = 2048       # a row is whole in one tile: 4 KB of bfloat16
# Launch settings, chosen by a sweep on the card at Swin-B's six largest
# shapes at batch 256 (PERF.md §6).  Each thread holds 16 elements
# of a tile: the forward's tiles are 4,096 elements and 8 warps, about
# eight programs an SM (4-16 programs, 2,048-8,192 elements, 4 or 8 warps
# and a pipelined loop all read within 3 %); the backward's 2,048 and 4
# warps, two programs an SM (its partials stay few; one an SM lost about a
# third, four up to 14 %), its row loop pipelined over four tiles (1.4x
# faster than none), its last programs adding two partial rows at a time,
# in groups of 16 programs (8 and 32 read within 1 %).
_FWD = dict(elems=4096, warps=8, programs=8 * SMS)
_BWD = dict(elems=2048, warps=4, programs=2 * SMS)
_BWD_STAGES = 4
_GROUP = 16


class Launch(NamedTuple):
    """One kernel's launch: program ``p`` walks the row tiles ``p * tiles
    ... p * tiles + tiles - 1`` of ``block_m`` rows, each a tile of
    ``block_c`` channels."""

    block_m: int
    block_c: int
    tiles: int
    grid: int
    warps: int


class Plan(NamedTuple):
    fwd: Launch
    bwd: Launch


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _launch(rows: int, c: int, elems: int, warps: int,
            programs: int) -> Launch:
    """Tiles of whole rows, about ``elems`` elements each, over ``rows``
    rows of ``c`` channels, at most about ``programs`` programs (each at
    least one tile)."""
    block_c = max(16, _pow2(c))
    block_m = max(1, elems // block_c)
    n_tiles = -(-rows // block_m)
    tiles = -(-n_tiles // min(n_tiles, programs))
    return Launch(block_m, block_c, tiles, -(-n_tiles // tiles), warps)


@functools.lru_cache(maxsize=None)
def _plan(rows: int, c: int) -> Plan:
    """The launches of a LayerNorm over ``rows`` rows of ``c`` channels; a
    pure function of the shape (one Triton build for each ``c``)."""
    return Plan(_launch(rows, c, **_FWD), _launch(rows, c, **_BWD))


# -- plain versions (CPU path; the reference the kernels are held to) --------

def _f32(t: Tensor) -> torch.dtype:
    """At least float32 (float64 stays, for the backward's tests)."""
    return torch.promote_types(t.dtype, torch.float32)


def layer_norm_plain(x: Tensor, weight: Tensor, bias: Tensor, eps: float,
                     y: Optional[Tensor] = None,
                     y_bias: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``(h, n, mean, rstd)``: ``h = x + (y + y_bias.to(dtype))`` written
    out (``x`` itself without ``y``), ``n = F.layer_norm(h)`` with the
    weight and bias cast to the dtype, and the float32 mean and ``rstd =
    rsqrt(var + eps)`` of ``h`` over its last dimension."""
    h = x if y is None else x + (y + y_bias.to(y.dtype))
    c = h.shape[-1]
    n = F.layer_norm(h, (c,), weight.to(h.dtype), bias.to(h.dtype), eps)
    var, mean = torch.var_mean(h.to(_f32(h)), dim=-1, unbiased=False)
    return h, n, mean, torch.rsqrt(var + eps)


def layer_norm_grad_plain(grad_n: Tensor, grad_h: Optional[Tensor],
                          h: Tensor, mean: Tensor, rstd: Tensor,
                          weight: Tensor, add: bool
                          ) -> Tuple[Tensor, Tensor, Tensor,
                                     Optional[Tensor]]:
    """``(dh, dweight, dbias, dy_bias)`` by the formula the kernel computes.

    In at least float32, with ``xhat = (h - mean) * rstd`` and ``g =
    grad_n * weight`` (the weight rounded to the dtype): ``dh = round(rstd
    * (g - mean(g) - xhat * mean(g * xhat)))`` over each row, then
    ``round(grad_h + dh)`` where ``grad_h`` is given; ``dweight = sum
    grad_n * xhat``, ``dbias = sum grad_n`` and, with ``add``, ``dy_bias =
    sum dh`` over every row, float32 sums (None without ``add``)."""
    f = _f32(h)
    xhat = (h.to(f) - mean[..., None]) * rstd[..., None]
    gn = grad_n.to(f)
    g = gn * weight.to(h.dtype).to(f)
    c1 = (g * xhat).mean(dim=-1, keepdim=True)
    c2 = g.mean(dim=-1, keepdim=True)
    dh = ((g - c2 - xhat * c1) * rstd[..., None]).to(h.dtype)
    if grad_h is not None:
        dh = (grad_h.to(f) + dh.to(f)).to(h.dtype)
    rows = tuple(range(h.dim() - 1))
    dy_bias = dh.to(f).sum(dim=rows) if add else None
    return dh, (gn * xhat).sum(dim=rows), gn.sum(dim=rows), dy_bias


# -- kernel wrappers ----------------------------------------------------------

# Launch a kernel of :mod:`.triton_layer_norm` on the current stream.
_run = functools.partial(run, "triton_layer_norm")


def _check(x: Tensor, y: Optional[Tensor], **vectors: Tensor) -> bool:
    """False for CPU tensors (plain versions); True after the kernels'
    checks pass on CUDA tensors; raise otherwise."""
    if x.dim() == 0 or x.numel() == 0:
        raise ValueError(f"LayerNorm takes a non-empty [..., C] tensor, got "
                         f"{tuple(x.shape)}")
    if y is not None and (y.shape != x.shape or y.dtype != x.dtype
                          or y.device != x.device):
        raise ValueError(f"the residual {x.dtype} {tuple(x.shape)} and the "
                         f"product {y.dtype} {tuple(y.shape)} differ")
    c = x.shape[-1]
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"LayerNorm runs on CPU or CUDA tensors, not "
                         f"{x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"LayerNorm kernels take bfloat16, float16 or "
                        f"float32 tensors, got {x.dtype}")
    if not x.is_contiguous() or (y is not None and not y.is_contiguous()):
        raise ValueError("LayerNorm kernels take contiguous tensors")
    if c > MAX_CHANNELS:
        raise ValueError(f"LayerNorm kernels take at most {MAX_CHANNELS} "
                         f"channels, got {c}")
    for name, t in vectors.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [{c}] "
                             f"tensor on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return True


def _forward(x: Tensor, weight: Tensor, bias: Tensor, eps: float,
             y: Optional[Tensor] = None, y_bias: Optional[Tensor] = None
             ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``osi_layer_norm_fwd`` on checked operands: ``(h, n, mean, rstd)``
    as :func:`layer_norm_plain` defines them."""
    c = x.shape[-1]
    rows = x.numel() // c
    add = y is not None
    launch = _plan(rows, c).fwd
    h = torch.empty_like(x) if add else x
    n = torch.empty_like(x)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    _run("osi_layer_norm_fwd", x.device, (launch.grid,), x,
         y if add else x, y_bias if add else weight, weight, bias, h, n,
         mean, rstd, rows, c, launch.tiles, float(c), float(eps), ADD=add,
         BLOCK_M=launch.block_m, BLOCK_C=launch.block_c,
         num_warps=launch.warps)
    LAUNCHES["ln_add_fwd" if add else "ln_fwd"] += 1
    return h, n, mean, rstd


def _backward(grad_n: Tensor, grad_h: Optional[Tensor], h: Tensor,
              mean: Tensor, rstd: Tensor, weight: Tensor, add: bool
              ) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    """``osi_layer_norm_bwd`` on checked operands: ``(dh, dweight, dbias,
    dy_bias)`` as :func:`layer_norm_grad_plain` defines them."""
    c = h.shape[-1]
    rows = h.numel() // c
    launch = _plan(rows, c).bwd
    groups = -(-launch.grid // _GROUP)
    dh = torch.empty_like(h)
    out = torch.empty((3, c), dtype=torch.float32, device=h.device)
    part = (out if launch.grid == 1 else torch.empty(
        (launch.grid + groups, 3, c), dtype=torch.float32, device=h.device))
    _run("osi_layer_norm_bwd", h.device, (launch.grid,), grad_n,
         grad_n if grad_h is None else grad_h, h, mean, rstd, weight, dh,
         part, out, _ticket(h.device, groups + 1), rows, c, launch.tiles,
         launch.grid - 1, float(c), ADD=add, GRAD_H=grad_h is not None,
         GROUP=_GROUP, STAGES=_BWD_STAGES, SUM_BLOCK=2 * launch.block_m,
         BLOCK_M=launch.block_m, BLOCK_C=launch.block_c,
         num_warps=launch.warps)
    LAUNCHES["ln_add_bwd" if add else "ln_bwd"] += 1
    return dh, out[0], out[1], (out[2] if add else None)


def _grad(g: Optional[Tensor], h: Tensor) -> Optional[Tensor]:
    """An output gradient as the kernel takes it: ``h``'s dtype and shape,
    contiguous."""
    if g is None:
        return None
    if g.shape != h.shape or g.dtype != h.dtype:
        raise ValueError(f"the output gradient {g.dtype} {tuple(g.shape)} "
                         f"does not match the {h.dtype} {tuple(h.shape)} "
                         f"LayerNorm")
    return g.contiguous()


# -- autograd -----------------------------------------------------------------

class _LayerNorm(torch.autograd.Function):
    """A LayerNorm (``y`` None) or a junction of checked operands, through
    the kernels (``kernel``) or the plain versions."""

    @staticmethod
    def forward(ctx, x, y, y_bias, weight, bias, eps, kernel):
        forward = _forward if kernel else layer_norm_plain
        h, n, mean, rstd = forward(x, weight, bias, eps, y, y_bias)
        ctx.save_for_backward(h, mean, rstd, weight)
        ctx.add, ctx.kernel = y is not None, kernel
        ctx.set_materialize_grads(False)
        return (h, n) if ctx.add else n

    @staticmethod
    def backward(ctx, *grads):
        grad_h, grad_n = grads if ctx.add else (None, grads[0])
        h, mean, rstd, weight = ctx.saved_tensors
        if grad_n is None:   # n unused: its gradient is zero
            if grad_h is None:
                return (None,) * 7
            grad_n = torch.zeros_like(h)
        backward = _backward if ctx.kernel else layer_norm_grad_plain
        dh, dw, db, dyb = backward(_grad(grad_n, h), _grad(grad_h, h), h,
                                   mean, rstd, weight, ctx.add)
        need = ctx.needs_input_grad
        return (dh if need[0] else None, dh if need[1] else None,
                dyb if need[2] else None, dw if need[3] else None,
                db if need[4] else None, None, None)


def _needs_grad(*tensors: Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor,
               eps: float) -> Tensor:
    """LayerNorm of ``x`` over its last dimension, the float32 ``weight``
    and ``bias`` rounded to ``x``'s dtype, statistics in float32, the
    output rounded once.  One kernel launch each way on CUDA, the plain
    versions on CPU."""
    kernel = _check(x, None, weight=weight, bias=bias)
    if _needs_grad(x, weight, bias):
        return _LayerNorm.apply(x, None, None, weight, bias, float(eps),
                                kernel)
    forward = _forward if kernel else layer_norm_plain
    return forward(x, weight, bias, float(eps))[1]


def add_layer_norm(x: Tensor, y: Tensor, y_bias: Tensor, weight: Tensor,
                   bias: Tensor, eps: float) -> Tuple[Tensor, Tensor]:
    """The residual junction ``(h, n)``: ``h = x + round(y + y_bias)`` in
    ``x``'s dtype (``y`` a product of that dtype, ``y_bias`` its float32
    bias rounded to it) and ``n`` = :func:`layer_norm` of ``h``.  One
    kernel launch each way on CUDA, the plain versions on CPU."""
    kernel = _check(x, y, weight=weight, bias=bias, y_bias=y_bias)
    if _needs_grad(x, y, y_bias, weight, bias):
        return _LayerNorm.apply(x, y, y_bias, weight, bias, float(eps),
                                kernel)
    forward = _forward if kernel else layer_norm_plain
    return forward(x, weight, bias, float(eps), y, y_bias)[:2]
