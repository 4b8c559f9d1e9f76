"""K7: the streaming probes, Triton on CUDA tensors, plain torch on CPU.

Counterpart of the two Pallas kernels of the JAX package's
``tools/bench_pallas_stream.py``: ``make_pallas_axpy`` (:69) and
``make_pallas_relu_mask`` (:96).  Each is one elementwise pass with two
reads and one write (bf16 ``[8, rows, 256]`` in the bench tool), so its
time measures how fast the card streams device memory, the yardstick for
the site backward kernels (K5, K6):

* :func:`axpy` -- ``x * 1.0009765625 + b`` in the inputs' dtype, rounded
  after the multiply and after the add, as the Pallas kernel computes it
  (in bf16 the multiply rounds back to ``x``: the increment is below half
  an ulp);
* :func:`relu_mask` -- ``where(float(m) > 0, g, 0)``, the mask compared
  in float32.

Routing is by device only: CPU tensors go to the plain versions
(``*_plain``), CUDA tensors launch the Triton kernels of
:mod:`.triton_stream_probe` (imported, and built, at the first launch) or
raise.  ``LAUNCHES`` counts the calls that launched a kernel.  The
kernels see the operands as flat arrays, so every shape runs and the
ragged end is masked.
"""

from __future__ import annotations

import os

import torch

from ._build import BUILD_DIR

Tensor = torch.Tensor

AXPY_A = 1.0009765625
LAUNCHES = {"stream_axpy": 0, "stream_relu_mask": 0}
# Elements per program: 16 a thread at 8 warps (two 16-byte loads of bf16
# per operand).
_BLOCK = 4096
_WARPS = 8


def axpy_plain(x: Tensor, b: Tensor) -> Tensor:
    return x * AXPY_A + b


def relu_mask_plain(g: Tensor, m: Tensor) -> Tensor:
    return torch.where(m.float() > 0, g, 0)


def _kernels():
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR))
    from . import triton_stream_probe

    return triton_stream_probe


def _use_kernel(name: str, a: Tensor, b: Tensor) -> bool:
    """False for CPU tensors (plain version); True after the checks pass."""
    if a.device.type == "cpu":
        return False
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not "
                         f"{a.device}")
    _check_operands(name, a, b)
    return True


def _check_operands(name: str, a: Tensor, b: Tensor) -> None:
    """Raise on operands the kernels do not take."""
    if b.device != a.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"{name} streams bfloat16, got {a.dtype} and "
                        f"{b.dtype}")
    if a.shape != b.shape or a.numel() == 0:
        raise ValueError(f"{name} needs two non-empty operands of one "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} needs contiguous operands")


def _launch(kernel: str, a: Tensor, b: Tensor, *scalars) -> Tensor:
    k = _kernels()
    out = torch.empty_like(a)
    n = a.numel()
    with torch.cuda.device(a.device):
        getattr(k, kernel)[(-(-n // _BLOCK),)](a, b, out, n, *scalars,
                                               BLOCK=_BLOCK,
                                               num_warps=_WARPS)
    return out


def axpy(x: Tensor, b: Tensor) -> Tensor:
    """``x * 1.0009765625 + b``: the kernel on CUDA tensors."""
    if not _use_kernel("axpy", x, b):
        return axpy_plain(x, b)
    out = _launch("axpy", x, b, AXPY_A)
    LAUNCHES["stream_axpy"] += 1
    return out


def relu_mask(g: Tensor, m: Tensor) -> Tensor:
    """``where(float(m) > 0, g, 0)``: the kernel on CUDA tensors."""
    if not _use_kernel("relu_mask", g, m):
        return relu_mask_plain(g, m)
    out = _launch("relu_mask", g, m)
    LAUNCHES["stream_relu_mask"] += 1
    return out
