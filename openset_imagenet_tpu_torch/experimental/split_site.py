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

The kernels take one of two routes (:func:`_plan`, from the shape, the
dtype and the alignment alone): ``tensor_cores`` -- k2 and k4 on
``wgmma`` over a TMA ring, for bfloat16 sites whose channel counts are
multiples of 64 (every resnet50 tail); ``generic`` -- the SIMT product
loops (float32, and other channel counts).  k1 and k3, the elementwise
kernels, and the one launch that adds the partials are the same on both.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import _build
from ..ops.fused_block_bwd import _DTYPES, _check, _sm_count, _splits

Tensor = torch.Tensor

__all__ = ["tail_site_split", "tail_site_split_plain", "LAUNCHES"]

LAUNCHES = {"split_site": 0}

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / \
    "split_site.cu"
_ROUTES = {"generic": 0, "tensor_cores": 1}
_THREADS = 256            # threads of a k1 / k3 block
_RPT = 8                  # rows a k1 / k3 thread takes from each row tile
_STREAM_BLOCKS = 1056     # k1 / k3 blocks to aim for: eight per SM of an H100
_RM = 128                 # rows of a generic k2 block
_TR = 64                  # rows of a tensor-core ring step
_ATOM = _TR * 128         # bytes of one swizzled [64][64] bf16 tile
_STAGES = 3               # slots of the tensor-core ring
_K4_CO = 256              # co columns of a tensor-core k4 tile
_SMEM_LIMIT = 232448      # dynamic shared memory of one H100 block


class Plan(NamedTuple):
    """How one site runs: the route, the blocks of k1 (``g1``) and k3
    (``g3``) and of k2 along M (``p2``), the M-splits of k4, and on the
    tensor-core route k2's column tile (``bn``) and k4's ci tile
    (``bi``); 0 where the route has none."""
    route: str
    g1: int
    g3: int
    p2: int
    splits: int
    bn: int
    bi: int


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
        "ss_workspace_floats": ([i] * 6, ll),
        "ss_tail_site": ([i, i] + [p] * 8 + [p] * 7 + [ll] + [i] * 9 + [p],
                         i)})


def _lanes(channels: int) -> int:
    """Lanes across a row's 8-channel chunks in k1 / k3 (csrc ``lanes``)."""
    chunks, t = -(-channels // 8), 1
    while t < chunks and t < 32:
        t *= 2
    return t


def stream_tiles(m: int, channels: int) -> int:
    """Row tiles of k1 / k3 over ``channels`` (csrc ``stream_tiles``)."""
    return -(-m // (_THREADS // _lanes(channels) * _RPT))


def _stream_blocks(m: int, channels: int) -> int:
    """Blocks of k1 / k3 along M: about eight per SM in all, each walking
    a contiguous range of row tiles, never more blocks than tiles."""
    column_blocks = -(-(-(-channels // 8)) // _lanes(channels))
    return max(1, min(stream_tiles(m, channels),
                      _STREAM_BLOCKS // column_blocks))


def row_ranges(tiles: int, blocks: int):
    """The tiles ``[begin, end)`` block b of a persistent kernel walks
    (csrc ``t_begin``, ``t_end``): a function of the counts alone."""
    return [(b * tiles // blocks, (b + 1) * tiles // blocks)
            for b in range(blocks)]


def _k2_smem(bn: int, co: int) -> int:
    """Bytes of dynamic shared memory of the tensor-core k2 (csrc
    ``K2Layout``): the ring (gp, z, W), the staged dxa tile, the block's
    sums over co and two steps of warp sums."""
    return _STAGES * (2 * _ATOM + bn * 128) + bn * 128 + 4 * co + \
        2 * 8 * 64 * 4 + 1024


def _k4_smem(bi: int) -> int:
    """Bytes of dynamic shared memory of the tensor-core k4 (csrc
    ``K4Layout``): the ring (x, gp) and three float vectors."""
    return _STAGES * (bi + _K4_CO) // 64 * _ATOM + \
        (2 * bi + _K4_CO) * 4 + 1024


def _plan(m: int, ci: int, co: int, dtype: torch.dtype, aligned: bool,
          sms: int) -> Plan:
    """The route and block counts of one site, from the shape, the dtype
    and the alignment alone.

    ``tensor_cores`` takes bfloat16 sites on 16-byte aligned rows whose
    channel counts are multiples of 64 and whose k2 fits in shared
    memory: k2 column tiles of 256 channels of ci (128 or 64 where ci is
    smaller), so gp is read ``ceil(ci / 256)`` times; k2 blocks along M
    so the grid fills the card once (one block an SM, two where two fit);
    k4 tiles of 128 (64 at ci = 64) x 256 channels, with the M-splits that
    make one wave of one block an SM.  Every split and every block's range
    is whole 64-row steps.  ``generic`` takes the rest, with the SIMT k2's
    128-row blocks and K5's generic M-splits.
    """
    g1, g3 = _stream_blocks(m, co), _stream_blocks(m, ci)
    bn = 256 if ci >= 256 else 128 if ci >= 128 else 64
    if (dtype == torch.bfloat16 and aligned and ci % 64 == 0 and
            co % 64 == 0 and m < 2 ** 31 and
            _k2_smem(bn, co) <= _SMEM_LIMIT):
        bi = 128 if ci >= 128 else 64
        tiles = -(-m // _TR)
        per_sm = 2 if 2 * _k2_smem(bn, co) <= _SMEM_LIMIT else 1
        p2 = max(1, min(tiles, sms * per_sm // -(-ci // bn)))
        k4_tiles = -(-ci // bi) * -(-co // _K4_CO)
        want = max(1, sms // k4_tiles)
        per = -(-tiles // want)
        return Plan("tensor_cores", g1, g3, p2, -(-tiles // per), bn, bi)
    return Plan("generic", g1, g3, -(-m // _RM), _splits(m, ci, co), 0, 0)


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
    dx = torch.empty((m, ci), dtype=dt, device=dev)
    gp = torch.empty((m, co), dtype=dt, device=dev)
    dxa = torch.empty((m, ci), dtype=dt, device=dev)
    dw = torch.empty((ci, co), dtype=torch.float32, device=dev)
    sums_o = torch.empty((2, co), dtype=torch.float32, device=dev)
    sums_i = torch.empty((2, ci), dtype=torch.float32, device=dev)
    # 16-byte loads where every row starts on a 16-byte boundary.
    vec = co % 8 == 0 and ci % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (g, z, mask, x, w, dx, gp, dxa))
    plan = _plan(m, ci, co, dt, vec, _sm_count(dev.index))
    work = torch.empty(lib.ss_workspace_floats(ci, co, plan.g1, plan.g3,
                                               plan.p2, plan.splits),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ss_tail_site(
            _DTYPES[dt], _ROUTES[plan.route], g.data_ptr(), z.data_ptr(),
            mask.data_ptr(), x.data_ptr(), w.data_ptr(), mul_o.data_ptr(),
            mul_i.data_ptr(), add_i.data_ptr(), dx.data_ptr(), gp.data_ptr(),
            dxa.data_ptr(), dw.data_ptr(), sums_o.data_ptr(),
            sums_i.data_ptr(), work.data_ptr(), m, ci, co, plan.g1, plan.g3,
            plan.p2, plan.splits, plan.bn, plan.bi, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"split_site launch failed: CUDA error {err} "
                           f"(M={m}, ci={ci}, co={co}, {dt}, {plan.route})")
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
