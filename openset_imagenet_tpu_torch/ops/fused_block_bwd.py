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
the source) and bound with ``ctypes``, by :mod:`._build`; nothing
GPU-only is imported or built when this module is imported.
``LAUNCHES["fused_block_bwd"]`` counts the site calls that launched the
kernel.
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
        "fbb_workspace_floats": ([ll, i, i, i], ll),
        "fbb_site": ([i] + [p] * 10 + [p] * 5 + [p, p] +
                     [ll, i, i, i, i, i, p], i)})


def _splits(m: int, ci: int, co: int) -> int:
    """M-splits of the weight-gradient stage: enough blocks to fill the
    card, each split a whole number of row steps."""
    tiles = -(-ci // _DW_TILES[0]) * -(-co // _DW_TILES[1])
    return max(1, min(-(-m // _DW_ROWS), -(-_TARGET_BLOCKS // tiles)))


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
                 in_act, emit_gp):
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
    splits = _splits(m, ci, co)
    dx = torch.empty((m, ci), dtype=dt, device=dev)
    gp = torch.empty((m, co), dtype=dt, device=dev) if emit_gp else None
    dw = torch.empty((ci, co), dtype=torch.float32, device=dev)
    sums_o = torch.empty((2, co), dtype=torch.float32, device=dev)
    sums_i = (torch.empty((2, ci), dtype=torch.float32, device=dev)
              if in_act else None)
    dz = torch.empty((m, co), dtype=dt, device=dev)
    work = torch.empty(lib.fbb_workspace_floats(m, ci, co, splits),
                       dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    # 16-byte loads where every row starts on a 16-byte boundary.
    vec = int(co % 8 == 0 and ci % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (g, z, mask, x, ds, w, dx, gp)
        if t is not None))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fbb_site(
            _DTYPES[dt], ptr(g), ptr(z), ptr(mask), ptr(x), ptr(ds), ptr(w),
            ptr(mul_o), ptr(add_o), ptr(mul_i if in_act else None),
            ptr(add_i if in_act else None), ptr(dx), ptr(gp), ptr(dw),
            ptr(sums_o), ptr(sums_i), ptr(dz), ptr(work), m, ci, co,
            int(in_act), splits, vec, stream)
    if err != 0:
        raise RuntimeError(f"fused_block_bwd launch failed: CUDA error {err} "
                           f"(M={m}, ci={ci}, co={co}, {dt})")
    LAUNCHES["fused_block_bwd"] += 1
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
