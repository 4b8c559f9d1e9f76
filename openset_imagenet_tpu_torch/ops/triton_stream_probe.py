"""Triton kernels of the streaming probes (K7, Hopper).

Imported only by :mod:`.stream_probe` when it launches on a CUDA tensor,
so the package imports where Triton is absent.

Replaces the Pallas kernels of ``tools/bench_pallas_stream.py`` in the JAX
package: :func:`axpy` the one of ``make_pallas_axpy`` (:69), and
:func:`relu_mask` the one of ``make_pallas_relu_mask`` (:96).  Bound on
the card: bytes (two reads and one write of the operand; 38.5 MB at bf16
[8, 3136, 256], 11.5 us at 3.35 TB/s), two or three operations an
element.  Design: one flat pass, a program per ``BLOCK`` elements, 16
elements a thread so each operand moves in 16-byte loads and stores, the
ragged end masked; the TPU kernel's row blocks (and its refusal of a row
count that they do not divide) are not carried over.  axpy rounds to the
operand dtype after the multiply and again after the add, as the Pallas
kernel does in bf16; relu_mask compares the mask in float32.
"""

import triton
import triton.language as tl


@triton.jit
def axpy(x_ptr, b_ptr, out_ptr, n, a, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    ok = offs < n
    x = tl.load(x_ptr + offs, mask=ok, other=0.0)
    b = tl.load(b_ptr + offs, mask=ok, other=0.0)
    ty = out_ptr.dtype.element_ty
    xa = (x.to(tl.float32) * a).to(ty)
    y = xa.to(tl.float32) + b.to(tl.float32)
    tl.store(out_ptr + offs, y.to(ty), mask=ok)


@triton.jit
def relu_mask(g_ptr, m_ptr, out_ptr, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    ok = offs < n
    g = tl.load(g_ptr + offs, mask=ok, other=0.0)
    m = tl.load(m_ptr + offs, mask=ok, other=0.0)
    y = tl.where(m.to(tl.float32) > 0, g, tl.zeros_like(g))
    tl.store(out_ptr + offs, y, mask=ok)
