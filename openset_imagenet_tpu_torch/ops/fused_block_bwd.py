"""K5: one pointwise-conv backward site of the fused bottleneck.

Counterpart of the Pallas ``_bwd_kernel`` (``experimental/fused_block.py:
111`` of the JAX package, reached through ``_bwd_pallas``).  For a site
``z_out = xa @ W`` over M = N*H*W rows it computes, per row ``m`` and
channel ``c``:

* ``gp = g * gate``, the gate a saved int8 mask or recomputed as
  ``z * mul_o + add_o > 0`` in the activation dtype;
* ``sums_o = [sum gp*z, sum gp]`` (the batch-norm ``mul``/``add``
  gradients of the output side);
* ``dz = gp * mul_o`` rounded to the activation dtype, ``dxa = dz @ W^T``
  in float32, plus the skip gradient ``ds``;
* with ``in_act``: ``xa = relu(x * mul_i + add_i)`` in the activation
  dtype, ``gin = dxa * (xa > 0)``, ``dx = gin * mul_i`` and ``sums_i =
  [sum gin*x, sum gin]``; else ``xa = x`` and ``dx = dxa``;
* ``dW = xa^T @ dz`` in float32; ``gp`` itself on request.

Every tensor is a row matrix ``[M, C]``: the model's NCHW activations in
``channels_last`` memory are exactly that in storage, so the caller
passes ``t.permute(0, 2, 3, 1).reshape(-1, C)`` views and nothing is
copied.  ``w`` is ``[ci, co]`` in the activation dtype.

:func:`bwd_site` routes by device: CPU tensors go to
:func:`bwd_site_plain` (written from the JAX ``_bwd_ref``), CUDA tensors
to the CUDA C++ kernel in ``csrc/fused_block_bwd.cu``, or raise.  The
kernel is built with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` of the checkout (a shared library named by a hash of
the source and its headers) and bound with ``ctypes``, by :mod:`._build`;
nothing GPU-only is imported or built when this module is imported.
``LAUNCHES["fused_block_bwd"]`` counts the site calls that launched the
kernel.

The kernel takes one of three routes (:func:`_plan`, from the shape, the
dtype and the alignment alone): ``fused`` -- a persistent block per SM
walking its own range of 64-row tiles (:func:`_row_ranges`), W resident
in shared memory, both products on ``wgmma``, dz never in device memory;
``tiled`` -- the gate writes dz once and two ``wgmma`` kernels read it
back; ``generic`` -- the SIMT stages (float32, and channel counts that
are not multiples of 64).
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Optional, Tuple

import torch

from . import _build

Tensor = torch.Tensor

LAUNCHES = {"fused_block_bwd": 0}

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / \
    "fused_block_bwd.cu"
# Blocks the weight-gradient stage aims for (four per SM of an H100); the
# M-splits follow from it and the shape alone, so a shape always reduces
# in the same order.
_TARGET_BLOCKS = 528
_DW_TILES = (64, 128)     # ci x co tile of the weight-gradient stage
_DW_ROWS = 32             # least rows per step of the weight-gradient stage
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"generic": 0, "tiled": 1, "fused": 2}
# (ci, co, in_act) the fused route is compiled for (csrc launch_fused_any):
# the resnet50 stage-1 tail, heads and block-1 head, the stage-2 block-1
# head, and the same widths in the other forms.
_FUSED = {(64, 256, True), (64, 64, True), (64, 256, False), (64, 64, False),
          (256, 64, False), (256, 128, False)}
_TILE_ROWS = 64           # rows of a fused tile (one wgmma M)
_SMEM_LIMIT = 232448 - 64 # dynamic shared memory of one H100 block
_TILED_TILE = 128         # ci x co tile of the tiled weight gradient
_TILED_PER_SM = 2         # tiled blocks resident on one SM (csrc TSTAGES)
_STEP_US = 0.5            # estimated µs of one 64-row step of a dW block


# -- plain version (CPU path; the reference the kernel is held to) ----------

def _dot_f32(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` in float32 on the (already rounded) operands:
    ``preferred_element_type=f32``."""
    return a.float() @ b.float()


def bwd_site_plain(g: Tensor, z: Tensor, mask: Optional[Tensor], x: Tensor,
                   ds: Optional[Tensor], w: Tensor, mul_o: Tensor,
                   add_o: Tensor, mul_i: Optional[Tensor] = None,
                   add_i: Optional[Tensor] = None, *, in_act: bool,
                   emit_gp: bool):
    """The JAX ``_bwd_ref`` (``fused_block.py:211-250``) on ``[M, C]``
    rows: ``(dx, gp or None, dW, (s_mul_o, s_add_o), (s_mul_i, s_add_i))``.
    """
    dt = g.dtype
    if mask is not None:
        gp = g * mask.to(dt)
    else:
        gp = torch.where(z * mul_o.to(dt) + add_o.to(dt) > 0, g, 0)
    gp32 = gp.float()
    s_mul_o = (gp32 * z.float()).sum(0)
    s_add_o = gp32.sum(0)
    dz = (gp32 * mul_o).to(dt)
    dxa = _dot_f32(dz, w.t())
    if ds is not None:
        dxa = dxa + ds.float()
    if in_act:
        xa = torch.relu(x * mul_i.to(dt) + add_i.to(dt))
        gin = torch.where(xa > 0, dxa, 0.0)
        dx = (gin * mul_i).to(dt)
        sums_i = ((gin * x.float()).sum(0), gin.sum(0))
    else:
        xa = x
        dx = dxa.to(dt)
        sums_i = (None, None)
    dw = _dot_f32(xa.t(), dz)
    return dx, gp if emit_gp else None, dw, (s_mul_o, s_add_o), sums_i


# -- the kernel ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.load(SOURCE, "fused_block_bwd", {
        "fbb_workspace_floats": ([i, ll, i, i, i], ll),
        "fbb_site": ([i, i] + [p] * 10 + [p] * 5 +
                     [ll, i, i, i, i, i, p], i)})


def _splits(m: int, ci: int, co: int) -> int:
    """M-splits of the weight-gradient stage: enough blocks to fill the
    card, each split a whole number of row steps."""
    tiles = -(-ci // _DW_TILES[0]) * -(-co // _DW_TILES[1])
    return max(1, min(-(-m // _DW_ROWS), -(-_TARGET_BLOCKS // tiles)))


def _fused_smem(ci: int, co: int, in_act: bool, has_mask: bool,
                has_ds: bool) -> int:
    """Bytes of dynamic shared memory the fused route takes (csrc
    ``FusedLayout``): W, two slots of g, z, x (ds, mask), and xa."""
    rows = _TILE_ROWS
    slot = rows * 2 * (2 * co + ci * (1 + has_ds)) + rows * co * has_mask
    return ci * co * 2 + 2 * slot + rows * 2 * ci * in_act + 1024


def _row_ranges(m: int, blocks: int):
    """The rows ``[begin, end)`` each fused block walks: a contiguous range
    of 64-row tiles, a function of M and the block count alone."""
    tiles = -(-m // _TILE_ROWS)
    return [(b * tiles // blocks * _TILE_ROWS,
             min(m, (b + 1) * tiles // blocks * _TILE_ROWS))
            for b in range(blocks)]


@functools.lru_cache(maxsize=None)
def _tiled_splits(m: int, ci: int, co: int, sms: int) -> int:
    """M-splits of the tiled weight gradient, each a whole number of
    64-row steps: the count that takes the least estimated time, the
    waves of 128 x 128 tiles (two blocks resident per SM) times the steps
    of one block at ``_STEP_US`` each, plus the ordered reduction reading
    every float32 partial at 3.35 TB/s; the fewest splits among equals."""
    tiles = -(-ci // _TILED_TILE) * -(-co // _TILED_TILE)
    steps, slots = -(-m // 64), _TILED_PER_SM * sms
    best = (None, 1)
    for want in range(1, min(steps, 4 * slots) + 1):
        per = -(-steps // want)
        splits = -(-steps // per)
        cost = (-(-tiles * splits // slots) * per * _STEP_US +
                splits * ci * co * 4 / 3.35e6)
        if best[0] is None or cost < best[0]:
            best = (cost, splits)
    return best[1]


def _plan(m: int, ci: int, co: int, dtype: torch.dtype, in_act: bool,
          has_mask: bool, has_ds: bool, aligned: bool, sms: int):
    """``(route, parts)`` of one site: the fused route and its block count
    where the shape was compiled for it and its tiles fit in shared memory;
    else the tiled route and its M-splits for bfloat16 channel counts that
    are multiples of 64 on 16-byte aligned tensors; else the generic route
    and its M-splits."""
    if dtype == torch.bfloat16 and aligned and ci % 64 == 0 and \
            co % 64 == 0:
        if (ci, co, in_act) in _FUSED and _fused_smem(
                ci, co, in_act, has_mask, has_ds) <= _SMEM_LIMIT:
            return "fused", min(sms, -(-m // _TILE_ROWS))
        return "tiled", _tiled_splits(m, ci, co, sms)
    return "generic", _splits(m, ci, co)


def traffic(m: int, ci: int, co: int, *, in_act: bool, has_mask: bool,
            has_ds: bool, emit_gp: bool, itemsize: int = 2):
    """``(bytes, operations)`` one site needs: g, z, the int8 mask, x, ds,
    W and the float32 vectors read once; dx, gp, the float32 dW and sums
    written once; the two products' ``4 * M * ci * co`` operations."""
    reads = (m * co * (2 * itemsize + has_mask) +
             m * ci * itemsize * (1 + has_ds) + ci * co * itemsize +
             8 * co + 8 * ci * in_act)
    writes = (m * ci * itemsize + m * co * itemsize * emit_gp +
              4 * ci * co + 8 * co + 8 * ci * in_act)
    return reads + writes, 4 * m * ci * co


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name: str, t: Optional[Tensor], shape, dtype, device) -> None:
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, g on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be a row-major [M, C] matrix (the "
                         "rows of a channels_last activation)")


def _kernel_site(g, z, mask, x, ds, w, mul_o, add_o, mul_i, add_i, *,
                 in_act, emit_gp, route=None):
    dev, dt = g.device, g.dtype
    if dt not in _DTYPES:
        raise TypeError(f"activations must be float32 or bfloat16, got {dt}")
    if g.dim() != 2 or x.dim() != 2 or g.shape[0] == 0:
        raise ValueError(f"g and x must be non-empty [M, C] matrices, got "
                         f"{tuple(g.shape)} and {tuple(x.shape)}")
    m, co = g.shape
    ci = x.shape[1]
    if in_act and (mul_i is None or add_i is None):
        raise ValueError("in_act needs mul_i and add_i")
    for name, t, shape, dtype in (
            ("g", g, (m, co), dt), ("z", z, (m, co), dt),
            ("mask", mask, (m, co), torch.int8), ("x", x, (m, ci), dt),
            ("ds", ds, (m, ci), dt), ("w", w, (ci, co), dt),
            ("mul_o", mul_o, (co,), torch.float32),
            ("add_o", add_o, (co,), torch.float32),
            ("mul_i", mul_i if in_act else None, (ci,), torch.float32),
            ("add_i", add_i if in_act else None, (ci,), torch.float32)):
        _check(name, t, shape, dtype, dev)
    lib = _library()
    dx = torch.empty((m, ci), dtype=dt, device=dev)
    gp = torch.empty((m, co), dtype=dt, device=dev) if emit_gp else None
    # 16-byte loads where every row starts on a 16-byte boundary.
    vec = co % 8 == 0 and ci % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (g, z, mask, x, ds, w, dx, gp)
        if t is not None)
    planned, parts = _plan(m, ci, co, dt, in_act, mask is not None,
                           ds is not None, vec, _sm_count(dev.index))
    # ``route`` (measurements only) forces a slower route that also takes
    # the site: tiled in place of fused, or generic.
    route = route or planned
    if route == "generic":
        parts = _splits(m, ci, co)
    elif route == "tiled" and planned == "fused":
        parts = _tiled_splits(m, ci, co, _sm_count(dev.index))
    elif route != planned:
        raise ValueError(f"route {route!r} does not take this site "
                         f"(M={m}, ci={ci}, co={co}, {dt}): {planned!r}")
    out = torch.empty(ci * co + 2 * co + 2 * ci, dtype=torch.float32,
                      device=dev)
    # dz [M, co]; the tiled route with in_act keeps xa [M, ci] behind it.
    dz = (None if route == "fused" else torch.empty(
        m * (co + ci * (route == "tiled" and in_act)), dtype=dt, device=dev))
    work = torch.empty(lib.fbb_workspace_floats(_ROUTES[route], m, ci, co,
                                                parts),
                       dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fbb_site(
            _DTYPES[dt], _ROUTES[route], ptr(g), ptr(z), ptr(mask), ptr(x),
            ptr(ds), ptr(w), ptr(mul_o), ptr(add_o),
            ptr(mul_i if in_act else None), ptr(add_i if in_act else None),
            ptr(dx), ptr(gp), ptr(out), ptr(dz), ptr(work), m, ci, co,
            int(in_act), parts, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"fused_block_bwd launch failed: CUDA error {err} "
                           f"(M={m}, ci={ci}, co={co}, {dt}, {route})")
    LAUNCHES["fused_block_bwd"] += 1
    dw = out[:ci * co].view(ci, co)
    sums_o = out[ci * co:ci * co + 2 * co].view(2, co)
    sums_i = out[ci * co + 2 * co:].view(2, ci)
    si = (sums_i[0], sums_i[1]) if in_act else (None, None)
    return dx, gp, dw, (sums_o[0], sums_o[1]), si


def bwd_site(g: Tensor, z: Tensor, mask: Optional[Tensor], x: Tensor,
             ds: Optional[Tensor], w: Tensor, mul_o: Tensor, add_o: Tensor,
             mul_i: Optional[Tensor] = None, add_i: Optional[Tensor] = None,
             *, in_act: bool, emit_gp: bool) -> Tuple:
    """K5 on ``[M, C]`` rows: the kernel on CUDA tensors, plain on CPU.

    Returns ``(dx, gp or None, dW, (s_mul_o, s_add_o), (s_mul_i,
    s_add_i))`` as :func:`bwd_site_plain`.
    """
    if g.device.type == "cpu":
        return bwd_site_plain(g, z, mask, x, ds, w, mul_o, add_o, mul_i,
                              add_i, in_act=in_act, emit_gp=emit_gp)
    if g.device.type != "cuda":
        raise ValueError(f"fused_block_bwd runs on CPU or CUDA tensors, not "
                         f"{g.device}")
    return _kernel_site(g, z, mask, x, ds, w, mul_o, add_o, mul_i, add_i,
                        in_act=in_act, emit_gp=emit_gp)
