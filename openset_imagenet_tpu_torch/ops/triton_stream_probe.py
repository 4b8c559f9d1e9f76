"""Triton kernels of the streaming probes (K7, Hopper).

Imported only by :mod:`.stream_probe` when it launches on a CUDA tensor,
so the package imports where Triton is absent.

Replaces the Pallas kernels of ``tools/bench_pallas_stream.py`` in the JAX
package: :func:`axpy` the one of ``make_pallas_axpy`` (:69), and
:func:`relu_mask` the one of ``make_pallas_relu_mask`` (:96).  Bound on
the card: bytes (two reads and one write of the operand; 38.5 MB at bf16
[8, 3136, 256], 11.5 us at 3.35 TB/s), two or three operations an
element.  Design:

* the grid is laid out by ``stream_probe._plan``: one program per
  ``TILE`` elements, or a persistent grid of a few programs per SM that
  walk the tiles in a grid-stride loop (``stream_probe.LAUNCH`` holds
  the launch chosen on the card);
* full tiles load and store unmasked; only the one ragged tile, taken by
  one program after its loop, is masked;
* both operands' loads of a tile are issued before any arithmetic;
* ``HINT`` picks the cache hints of the full tiles' loads and stores
  (0 none, 1 ``evict_first``, 2 ``.cg`` loads and ``.cs`` stores);
* axpy rounds to bf16 after the multiply and again after the add, as the
  Pallas kernel does; relu_mask compares the mask's 16 bits as int16
  (``0 < bits <= 0x7F80``: ``m > 0`` for every bf16 mask, NaN refused),
  with no conversion.

The TPU kernel's row blocks (and its refusal of a row count that they do
not divide) are not carried over.  ``n`` is not specialised, so one
compiled kernel serves every size.
"""

import triton
import triton.language as tl


@triton.jit
def _load(ptrs, HINT: tl.constexpr):
    if HINT == 1:
        v = tl.load(ptrs, eviction_policy="evict_first")
    elif HINT == 2:
        v = tl.load(ptrs, cache_modifier=".cg")
    else:
        v = tl.load(ptrs)
    return v


@triton.jit
def _store(ptrs, v, HINT: tl.constexpr):
    if HINT == 1:
        tl.store(ptrs, v, eviction_policy="evict_first")
    elif HINT == 2:
        tl.store(ptrs, v, cache_modifier=".cs")
    else:
        tl.store(ptrs, v)


@triton.jit
def _axpy(x, b, a):
    xa = (x.to(tl.float32) * a).to(x.dtype)
    return (xa.to(tl.float32) + b.to(tl.float32)).to(x.dtype)


@triton.jit
def _relu_mask(g, m):
    bits = m.to(tl.int16, bitcast=True)
    keep = (bits > 0) & (bits <= 0x7F80)
    return tl.where(keep, g, tl.zeros_like(g))


@triton.jit(do_not_specialize=["n"])
def axpy(x_ptr, b_ptr, out_ptr, n, a, TILE: tl.constexpr,
         HINT: tl.constexpr):
    pid = tl.program_id(0)
    programs = tl.num_programs(0)
    full = n // TILE
    lane = tl.arange(0, TILE)
    for t in range(pid, full, programs):
        offs = t.to(tl.int64) * TILE + lane
        x = _load(x_ptr + offs, HINT)
        b = _load(b_ptr + offs, HINT)
        _store(out_ptr + offs, _axpy(x, b, a), HINT)
    if pid == full % programs:
        offs = full.to(tl.int64) * TILE + lane
        ok = offs < n
        x = tl.load(x_ptr + offs, mask=ok, other=0.0)
        b = tl.load(b_ptr + offs, mask=ok, other=0.0)
        tl.store(out_ptr + offs, _axpy(x, b, a), mask=ok)


@triton.jit(do_not_specialize=["n"])
def relu_mask(g_ptr, m_ptr, out_ptr, n, TILE: tl.constexpr,
              HINT: tl.constexpr):
    pid = tl.program_id(0)
    programs = tl.num_programs(0)
    full = n // TILE
    lane = tl.arange(0, TILE)
    for t in range(pid, full, programs):
        offs = t.to(tl.int64) * TILE + lane
        g = _load(g_ptr + offs, HINT)
        m = _load(m_ptr + offs, HINT)
        _store(out_ptr + offs, _relu_mask(g, m), HINT)
    if pid == full % programs:
        offs = full.to(tl.int64) * TILE + lane
        ok = offs < n
        g = tl.load(g_ptr + offs, mask=ok, other=0.0)
        m = tl.load(m_ptr + offs, mask=ok, other=0.0)
        tl.store(out_ptr + offs, _relu_mask(g, m), mask=ok)
