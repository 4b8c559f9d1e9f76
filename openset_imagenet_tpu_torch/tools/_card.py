"""The card a measurement ran on, how long a run took on it, and the
least time its work could take.

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet (dense, at the full
700 W power limit): 3.35 TB/s of device memory, 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s float32 outside them.  A bound is the larger of
the bytes over the memory rate and the operations over the peak of their
type; the caller counts each input read once and each output written
once.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Tuple

import torch

BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12


def bound_ms(nbytes: float, flops: float = 0.0,
             flop_per_s: float = BF16_FLOP_PER_S) -> Tuple[float, str]:
    """``(least milliseconds, "bytes" or "operations")``."""
    by_bytes = nbytes / BYTES_PER_S * 1e3
    by_ops = flops / flop_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ms_per_run(run: Callable, iters: int, device: torch.device,
               warmup: int) -> Tuple[float, object]:
    """``(milliseconds of one run, its last output)`` after ``warmup``
    eager runs: on the card, of the run captured once in a CUDA graph and
    replayed ``iters`` times between CUDA events (the device's time,
    without the host's launch overhead); on the CPU, of ``iters`` eager
    runs by the host clock."""
    for _ in range(warmup):
        out = run()
    if device.type == "cuda":
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run()
    return (time.perf_counter() - t0) * 1e3 / iters, out
