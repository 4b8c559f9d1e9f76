"""Peaks of the card and the least time a piece of work could take there.

A copy of ``openset_imagenet_tpu_torch/tools/_card.py`` (``BYTES_PER_S``,
``BF16_FLOP_PER_S``, ``INT8_OP_PER_S``, ``F32_FLOP_PER_S``, ``bound_ms``,
``card_line``), kept here so that a change to the program does not move
the benchmark's yardstick.

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet (dense, at the full
700 W power limit): 3.35 TB/s of device memory, 989 TFLOP/s bf16 and
1,979 TOP/s int8 on the tensor cores, 67 TFLOP/s float32 outside them.  A
bound is the larger of the bytes over the memory rate and the operations
over the peak of their type; the caller counts each input read once and
each output written once.
"""

from __future__ import annotations

import subprocess
from typing import Tuple

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
    """``name, power.limit`` of the first card, as nvidia-smi gives them
    (empty when nvidia-smi cannot be run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else ""


def power_limit_w(line: str):
    """The power limit in watts from :func:`card_line`'s ``name, 700.00
    W``, or None."""
    try:
        return float(line.rsplit(",", 1)[1].strip().split()[0])
    except (IndexError, ValueError):
        return None
