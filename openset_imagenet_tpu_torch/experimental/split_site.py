"""K6: the tail-site backward as four streaming kernels (the split form).

Counterpart of :mod:`openset_imagenet_tpu.experimental.split_site`.  The
tail site of a fused bottleneck (the saved int8 boundary gate, an input
activation, gp emitted) computes, over M = N*H*W rows:

    gp     = g * mask                   sums_o = [sum gp*z, sum gp]
    dz     = gp * mul_o                 dxa    = dz @ W^T
    xa     = relu(x*mul_i + add_i)      gin    = dxa * (xa > 0)
    dx     = gin * mul_i                sums_i = [sum gin*x, sum gin]
    dW     = xa^T @ dz

K5 (:mod:`..ops.fused_block_bwd`) does this in one unified site.  The split
form does it in four kernels, each with at most two large reads and one
large write, and ``dxa`` round-trips through device memory in the
activation dtype: the one place where its numbers differ from K5's.  The
JAX package keeps the form as an experiment measured by
``tools/bench_split_site.py``; the port's counterpart of that tool is
:mod:`openset_imagenet_tpu_torch.tools.bench_split_site`.  Nothing in the
model calls it.

:func:`tail_site_split` routes by device: CPU tensors go to
:func:`tail_site_split_plain` (the split's own dataflow, as the JAX test's
emulator ``_split_ref`` writes it), CUDA tensors to the CUDA C++ kernels
in ``csrc/split_site.cu`` (built for ``sm_90a`` at first use by
:mod:`..ops._build`), or raise.  Every tensor is a row-major ``[M, C]``
matrix, ``w`` is ``[ci, co]``.  ``LAUNCHES["split_site"]`` counts the
calls that launched the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Optional, Tuple

import torch

from ..ops import _build
from ..ops.fused_block_bwd import _DTYPES, _check, _splits

Tensor = torch.Tensor

__all__ = ["tail_site_split", "tail_site_split_plain", "LAUNCHES"]

LAUNCHES = {"split_site": 0}

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / \
    "split_site.cu"


def tail_site_split_plain(g: Tensor, z: Tensor, mask: Tensor, x: Tensor,
                          w: Tensor, mul_o: Tensor, mul_i: Tensor,
                          add_i: Tensor, *,
                          out_dtype: Optional[torch.dtype] = None) -> Tuple:
    """The split's dataflow in plain torch: ``(dx, gp, dW, (s_mul_o,
    s_add_o), (s_mul_i, s_add_i))``, with ``dxa`` rounded to ``out_dtype``
    before the gate (``tests/test_split_site.py:22-41`` of the JAX
    package)."""
    out_dtype = out_dtype or g.dtype
    gp = g * mask.to(g.dtype)
    gp32 = gp.float()
    s_add_o = gp32.sum(0)
    s_mul_o = (gp32 * z.float()).sum(0)
    dz = (gp32 * mul_o).to(out_dtype)
    dxa = (dz.float() @ w.float().t()).to(out_dtype)
    xa = torch.relu(x * mul_i.to(x.dtype) + add_i.to(x.dtype))
    gin = torch.where(xa.float() > 0, dxa.float(), 0.0)
    dx = (gin * mul_i).to(out_dtype)
    s_mul_i = (gin * x.float()).sum(0)
    s_add_i = gin.sum(0)
    dw = xa.to(out_dtype).float().t() @ dz.float()
    return dx, gp, dw, (s_mul_o, s_add_o), (s_mul_i, s_add_i)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.load(SOURCE, "split_site", {
        "ss_workspace_floats": ([ll, i, i, i], ll),
        "ss_tail_site": ([i] + [p] * 8 + [p] * 7 + [ll, i, i, i, i, p], i)})


def _check_site(g, z, mask, x, w, mul_o, mul_i, add_i, out_dtype):
    """Raise on arguments the kernels do not take; return (M, ci, co)."""
    dev, dt = g.device, g.dtype
    if dt not in _DTYPES:
        raise TypeError(f"activations must be float32 or bfloat16, got {dt}")
    if out_dtype not in (None, dt):
        raise TypeError(f"the kernels write the activation dtype {dt}, not "
                        f"out_dtype {out_dtype}")
    if g.dim() != 2 or x.dim() != 2 or g.shape[0] == 0:
        raise ValueError(f"g and x must be non-empty [M, C] matrices, got "
                         f"{tuple(g.shape)} and {tuple(x.shape)}")
    if mask is None:
        raise ValueError("the tail site needs its int8 mask")
    m, co = g.shape
    ci = x.shape[1]
    for name, t, shape, dtype in (
            ("g", g, (m, co), dt), ("z", z, (m, co), dt),
            ("mask", mask, (m, co), torch.int8), ("x", x, (m, ci), dt),
            ("w", w, (ci, co), dt), ("mul_o", mul_o, (co,), torch.float32),
            ("mul_i", mul_i, (ci,), torch.float32),
            ("add_i", add_i, (ci,), torch.float32)):
        _check(name, t, shape, dtype, dev)
    return m, ci, co


def _kernel_split(g, z, mask, x, w, mul_o, mul_i, add_i, out_dtype):
    m, ci, co = _check_site(g, z, mask, x, w, mul_o, mul_i, add_i, out_dtype)
    dev, dt = g.device, g.dtype
    lib = _library()
    splits = _splits(m, ci, co)
    dx = torch.empty((m, ci), dtype=dt, device=dev)
    gp = torch.empty((m, co), dtype=dt, device=dev)
    dxa = torch.empty((m, ci), dtype=dt, device=dev)
    dw = torch.empty((ci, co), dtype=torch.float32, device=dev)
    sums_o = torch.empty((2, co), dtype=torch.float32, device=dev)
    sums_i = torch.empty((2, ci), dtype=torch.float32, device=dev)
    work = torch.empty(lib.ss_workspace_floats(m, ci, co, splits),
                       dtype=torch.float32, device=dev)
    # 16-byte loads where every row starts on a 16-byte boundary.
    vec = int(co % 8 == 0 and ci % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (g, z, mask, x, w, dx, gp, dxa)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ss_tail_site(
            _DTYPES[dt], g.data_ptr(), z.data_ptr(), mask.data_ptr(),
            x.data_ptr(), w.data_ptr(), mul_o.data_ptr(), mul_i.data_ptr(),
            add_i.data_ptr(), dx.data_ptr(), gp.data_ptr(), dxa.data_ptr(),
            dw.data_ptr(), sums_o.data_ptr(), sums_i.data_ptr(),
            work.data_ptr(), m, ci, co, splits, vec, stream)
    if err != 0:
        raise RuntimeError(f"split_site launch failed: CUDA error {err} "
                           f"(M={m}, ci={ci}, co={co}, {dt})")
    LAUNCHES["split_site"] += 1
    return dx, gp, dw, (sums_o[0], sums_o[1]), (sums_i[0], sums_i[1])


def tail_site_split(g: Tensor, z: Tensor, mask: Tensor, x: Tensor,
                    w: Tensor, mul_o: Tensor, mul_i: Tensor, add_i: Tensor,
                    *, out_dtype: Optional[torch.dtype] = None) -> Tuple:
    """K6 on ``[M, C]`` rows: the kernels on CUDA tensors, plain on CPU.

    Arguments as the JAX ``tail_site_split`` (no ``add_o``: the int8 mask
    is the boundary gate).  Returns ``(dx, gp, dW, (s_mul_o, s_add_o),
    (s_mul_i, s_add_i))`` as :func:`tail_site_split_plain`.
    """
    if g.device.type == "cpu":
        return tail_site_split_plain(g, z, mask, x, w, mul_o, mul_i, add_i,
                                     out_dtype=out_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"split_site runs on CPU or CUDA tensors, not "
                         f"{g.device}")
    return _kernel_split(g, z, mask, x, w, mul_o, mul_i, add_i, out_dtype)
