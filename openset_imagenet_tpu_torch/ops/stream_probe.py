"""K7: the streaming probes, Triton on CUDA tensors, plain torch on CPU.

Counterpart of the two Pallas kernels of the JAX package's
``tools/bench_pallas_stream.py``: ``make_pallas_axpy`` (:69) and
``make_pallas_relu_mask`` (:96).  Each is one elementwise pass with two
reads and one write (bf16 ``[8, rows, 256]`` in the bench tool), so its
time measures how fast the card streams device memory, the yardstick for
the site backward kernels (K5, K6):

* :func:`axpy` -- ``x * 1.0009765625 + b`` in the inputs' dtype, rounded
  after the multiply and after the add, as the Pallas kernel computes it.
  In bf16, the only dtype the kernel takes, the multiply rounds back to
  ``x`` (the increment, 2**-10 relative, is below half an ulp), so axpy
  is ``round(x + b)``: ``torch.add(x, b)`` bit for bit;
* :func:`relu_mask` -- ``where(m > 0, g, 0)``: a NaN mask gives 0, as in
  JAX.  The kernel compares the mask's 16 bits (``0 < bits <= 0x7F80``:
  positive values, subnormals included, and +inf); ``threshold_backward``'s
  rule (``m <= 0 ? 0 : g``) would pass ``g`` through on a NaN mask.  XLA
  on the CPU compares with denormals as zero, so JAX gives 0 on the 127
  positive subnormal masks, where the plain version and the kernel keep
  ``g`` (IEEE, as torch).

Routing is by device only: CPU tensors go to the plain versions
(``*_plain``), CUDA tensors launch the Triton kernels of
:mod:`.triton_stream_probe` through :func:`._triton.run` (imported, and
built, at the first launch) or raise.  ``LAUNCHES`` counts the calls
that launched a kernel.  The kernels see the operands as flat arrays, so
every shape runs: full tiles unmasked, the one ragged tile masked.
:func:`_plan` lays out the launch (:data:`LAUNCH`, one configuration per
kernel, chosen by ``tools/bench_stream.py --launch-sweep`` on an H100)
and :func:`_schedule` mirrors the tiles each program of the kernels
walks.
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from ._triton import run

Tensor = torch.Tensor

AXPY_A = 1.0009765625
LAUNCHES = {"stream_axpy": 0, "stream_relu_mask": 0}
SMS = 132                 # streaming multiprocessors of an H100 SXM
# Cache hints of the kernels' loads and stores (``HINT`` of the kernels).
HINTS = {"none": 0, "evict_first": 1, "stream": 2}


class Launch(NamedTuple):
    """One launch configuration of a probe kernel."""

    tile: int     # elements a program handles at a time (a power of two)
    warps: int
    waves: int    # 0: one program per tile; k: a persistent grid, SMs * k
    hint: str     # a key of HINTS


# The configuration of each kernel on CUDA tensors, from
# ``tools/bench_stream.py --launch-sweep`` at bf16 [8, 3136, 256] on an
# H100: 3,136 programs of 512 threads (5.9 waves of 528), the fastest
# tile and grid for both kernels in the cold harness (no byte from the
# L2).  There the streaming hints (``.cg`` loads, ``.cs`` stores) time
# as the hint-free launch does; where operands are read again (the warm
# harness), they keep them in the L2 and the hint-free launch falls
# behind the library call.
LAUNCH: Dict[str, Launch] = {
    "axpy": Launch(2048, 16, 0, "stream"),
    "relu_mask": Launch(2048, 16, 0, "stream"),
}


def axpy_plain(x: Tensor, b: Tensor) -> Tensor:
    return x * AXPY_A + b


def relu_mask_plain(g: Tensor, m: Tensor) -> Tensor:
    return torch.where(m.float() > 0, g, 0)


def _plan(n: int, launch: Launch, sms: int = SMS) -> Tuple[int, int, int]:
    """``(tile, programs, warps)`` of a launch over ``n`` elements."""
    tiles = -(-n // launch.tile)
    programs = tiles if launch.waves == 0 else min(tiles, sms * launch.waves)
    return launch.tile, programs, launch.warps


def _schedule(n: int, tile: int, programs: int
              ) -> Iterator[Tuple[int, int, int, bool]]:
    """``(program, start, stop, masked)`` of every tile the kernels touch,
    in their order: program ``p`` walks the full tiles ``p, p + programs,
    ...``, and program ``(n // tile) % programs`` then takes the ragged
    tile, masked."""
    full = n // tile
    for p in range(programs):
        for t in range(p, full, programs):
            yield p, t * tile, (t + 1) * tile, False
        if p == full % programs and full * tile < n:
            yield p, full * tile, n, True


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


_SMS: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (cached)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def _launch(kernel: str, a: Tensor, b: Tensor, launch: Launch,
            *scalars) -> Tensor:
    out = torch.empty_like(a)
    tile, programs, warps = _plan(a.numel(), launch, sm_count(a.device))
    run("triton_stream_probe", kernel, a.device, (programs,), a, b, out,
        a.numel(), *scalars, TILE=tile, HINT=HINTS[launch.hint],
        num_warps=warps)
    return out


def axpy(x: Tensor, b: Tensor, launch: Optional[Launch] = None) -> Tensor:
    """``x * 1.0009765625 + b``: the kernel on CUDA tensors (``launch``
    overrides ``LAUNCH["axpy"]``, for the sweep)."""
    if not _use_kernel("axpy", x, b):
        return axpy_plain(x, b)
    out = _launch("axpy", x, b, launch or LAUNCH["axpy"], AXPY_A)
    LAUNCHES["stream_axpy"] += 1
    return out


def relu_mask(g: Tensor, m: Tensor, launch: Optional[Launch] = None
              ) -> Tensor:
    """``where(m > 0, g, 0)``: the kernel on CUDA tensors (``launch``
    overrides ``LAUNCH["relu_mask"]``, for the sweep)."""
    if not _use_kernel("relu_mask", g, m):
        return relu_mask_plain(g, m)
    out = _launch("relu_mask", g, m, launch or LAUNCH["relu_mask"])
    LAUNCHES["stream_relu_mask"] += 1
    return out
