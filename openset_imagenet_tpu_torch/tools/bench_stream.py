"""Streaming bandwidth probe of one NVIDIA card: torch vs Triton (K7).

Port of the JAX package's ``tools/bench_pallas_stream.py``.  Two
elementwise passes of two reads and one write each, on bf16
``[8, rows, 256]`` (rows = 3136: the resnet50 stage-1 activations of 8
images, 12.8 MB an operand):

* ``torch_axpy``, ``triton_axpy`` -- ``y = x * 1.0009765625 + b``;
* ``torch_relu_mask``, ``triton_relu_mask`` -- ``y = where(m > 0, g, 0)``;

the ``torch_*`` cases through the plain versions of
:mod:`..ops.stream_probe`, the ``triton_*`` cases through its kernels.
Each run chains ``CHAIN`` calls, ``y = f(y, other)``, so every call
streams its operands (at the default size the 12.8 MB operands can stay
in the card's 50 MB L2; ``--sweep`` goes to 205 MB); on the card a run is
captured once in a CUDA graph and its replays are timed with CUDA events
(after three warm-up runs), so the time is the device's, without the
host's launch overhead.  Prints one JSON line per case: ms per call,
the bytes moved (``3 * elements * 2``) over that time in GB/s, its share
of the card's 3.35 TB/s, the least time (``bound_ms``), the launches of
each kernel during the case, and the card's name and power limit.  A case
that fails ends the tool with an error.

    python -m openset_imagenet_tpu_torch.tools.bench_stream \\
        [--sweep] [--rows 3136] [--iters 10] [--device cuda]

``--sweep`` runs ``[8, 3136]``, ``[8, 12544]`` and ``[32, 12544]`` x 256
(12.8 MB to 205 MB an operand).  ``--device cpu`` runs the plain versions
on the host (for a check of the tool; its times are the host's).
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Callable, List, Optional, Sequence

import torch

from ..ops import stream_probe as sp
from . import _card

CHAIN = 32
SWEEP = ((8, 3136), (8, 12544), (32, 12544))


def stream_bytes(shape: Sequence[int], itemsize: int = 2) -> int:
    """Bytes of one call: two reads and one write of the operand."""
    return 3 * math.prod(shape) * itemsize


def chained(fn: Callable) -> Callable:
    def run(y, other):
        for _ in range(CHAIN):
            y = fn(y, other)
        return y

    return run


def run_shape(shape: Sequence[int], iters: int, device: torch.device,
              card: Optional[str], name: str) -> None:
    gen = torch.Generator(device=device).manual_seed(0)
    x, b, m = (torch.randn(*shape, generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    nbytes = stream_bytes(shape)
    bound, bound_by = _card.bound_ms(nbytes)
    for case, fn, other in (
            ("torch_axpy", sp.axpy_plain, b),
            ("torch_relu_mask", sp.relu_mask_plain, m),
            ("triton_axpy", sp.axpy, b),
            ("triton_relu_mask", sp.relu_mask, m)):
        before = dict(sp.LAUNCHES)
        run = chained(fn)
        ms, out = _card.ms_per_run(lambda: run(x, other), iters, device,
                                   warmup=3)
        if not bool(torch.isfinite(out.float()).all()):
            raise RuntimeError(f"{case}: non-finite output")
        ms /= CHAIN
        gbs = nbytes / (ms / 1e3) / 1e9
        print(json.dumps({
            "case": case, "shape": list(shape), "dtype": "bf16", "ms": ms,
            "gb_per_s": gbs,
            "share_of_peak": (gbs * 1e9 / _card.BYTES_PER_S if card
                              else None),
            "bound_ms": bound, "bound_by": bound_by, "chain": CHAIN,
            "iters": iters,
            "launches": {k: v - before[k] for k, v in sp.LAUNCHES.items()},
            "device": name, "card": card}), flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=3136)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sweep", action="store_true",
                    help="sweep operand sizes 12.8 MB -> 205 MB")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_stream: no CUDA device (--device cpu runs "
                         "the plain versions on the host)")
    card = _card.card_line() if device.type == "cuda" else None
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    shapes = SWEEP if args.sweep else ((8, args.rows),)
    for batch, rows in shapes:
        run_shape((batch, rows, 256), args.iters, device, card, name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
