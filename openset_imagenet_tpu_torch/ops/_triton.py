"""What the port's Triton ops share: the card's SM count, the dtypes their
kernels take, the launch of a kernel of a Triton module on a device's
current stream, and the ticket counters of the kernels whose last program
adds the other programs' partials in index order (the loss forwards K1
and K3, the batch-norm's statistics and backward, the window attention's
backward).  Every Triton op of the package launches through :func:`run`.

A Triton module is imported at its first launch, never when this module
or an op's module is imported; its build cache is ``build/kernels/`` of
the checkout unless ``TRITON_CACHE_DIR`` names another.
"""

from __future__ import annotations

import functools
import importlib
import os
from typing import Dict, Tuple

import torch

from ._build import BUILD_DIR

Tensor = torch.Tensor

SMS = 132                 # streaming multiprocessors of an H100 SXM
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
# The ticket counters (int32), one array per (device index, stream); every
# launch leaves the counters it used at 0.
_TICKETS: Dict[Tuple[int, int], Tensor] = {}


@functools.lru_cache(maxsize=None)
def _module(module: str):
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR))
    return importlib.import_module(f".{module}", __package__)


def run(module: str, name: str, device: torch.device,
        grid: Tuple[int, ...], *args, **consts) -> None:
    """Launch kernel ``name`` of the Triton module ``module`` of this
    package on the current stream of ``device``."""
    kernel = getattr(_module(module), name)[grid]
    if device.index == torch.cuda.current_device():
        kernel(*args, **consts)
    else:
        with torch.cuda.device(device):
            kernel(*args, **consts)


def ticket(device: torch.device, n: int) -> Tensor:
    """At least ``n`` int32 ticket counters of the current stream on
    ``device``, made with ``torch.zeros``.  A stream being captured into a
    CUDA graph must have run each kernel that takes tickets at its widest
    grid before the capture, so that no allocation lands in the graph."""
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    counter = _TICKETS.get(key)
    if counter is None or counter.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "a kernel in a CUDA-graph capture needs its ticket counters "
                "made before the capture: run it once on the capture "
                "stream first")
        counter = _TICKETS[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                              device=device)
    return counter
