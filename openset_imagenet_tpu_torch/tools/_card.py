"""The card a measurement ran on, how long a run took on it, and the
least time its work could take.

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet (dense, at the full
700 W power limit): 3.35 TB/s of device memory, 989 TFLOP/s bf16 and
1,979 TOP/s int8 on the tensor cores, 67 TFLOP/s float32 outside them.  A
bound is the larger of the bytes over the memory rate and the operations
over the peak of their type; the caller counts each input read once and
each output written once.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Optional, Tuple

import torch

BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
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


def event_ms(fn: Callable, reps: int = 30, warmup: int = 5,
             before: Optional[Callable] = None) -> float:
    """Median milliseconds of one call of ``fn`` on the card, each call
    bracketed by CUDA events, after ``warmup`` calls (and then
    ``before()``, if given)."""
    for _ in range(warmup):
        fn()
    if before is not None:
        before()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn: Callable, calls: int = 20, reps: int = 20,
             before: Optional[Callable] = None) -> float:
    """Median device milliseconds of one call of ``fn``, replayed from a
    CUDA graph of ``calls`` calls (no host launch overhead in the
    interval).  ``fn`` runs three times on the capture stream first, so a
    kernel that keeps state made on its first call (the loss kernels'
    ticket counters) has it before the capture.  ``before()`` runs after
    the warm-up replays, just before the timed ones."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return event_ms(graph.replay, reps=reps, warmup=2, before=before) / calls


_FLUSH: dict = {}


def flush_l2(nbytes: int = 256 << 20) -> None:
    """Rewrite ``nbytes`` (five times the H100's 50 MB L2) of a buffer of
    its own on the card, so that the lines the L2 holds at normal
    priority are that buffer's, not a timed kernel's operands: a kernel
    whose loads are hinted ``evict_first`` never displaces them, and
    would otherwise keep hitting whatever the call timed before it left
    there."""
    buf = _FLUSH.get(nbytes)
    if buf is None:
        buf = _FLUSH[nbytes] = torch.zeros(nbytes, dtype=torch.uint8,
                                           device="cuda")
    buf.add_(1)


def cold_in_turns(fns: dict, reps: int = 5,
                  lead_cycles: int = 1 << 20) -> dict:
    """Median device milliseconds of one call of each of ``fns`` (name ->
    callable), called in turns ``reps`` times after one warm call each.
    Before each call the L2 is flushed (:func:`flush_l2`) and a spin
    kernel of ``lead_cycles`` clock cycles runs, during which the host
    enqueues the call, so the CUDA events around it bracket the device's
    work and not the host's launches."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            flush_l2()
            torch.cuda._sleep(lead_cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}
