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

``--launch-sweep`` (card only) times every launch configuration of the
two kernels that :data:`LAUNCH_SWEEP` spans (tile, warps, grid, cache
hints) at bf16 ``[8, 3136, 256]`` against the one library call that
computes the same function bit for bit (``torch.add(x, b)`` for axpy,
``threshold_backward(g, m, 0)`` for relu_mask on a mask without NaN),
each checked bit-equal to it first.  Each time is device µs from a CUDA
graph of 20 calls, replayed, in two harnesses: ``warm4``, the first
timings' method (four rotating operand pairs, 103 MB, and one output
buffer rewritten every call), and ``cold`` (a pair and an output
for each call of the graph, 770 MB a replay, timed after the L2 is
flushed, so no byte a call moves is still in the L2 from an earlier
call).  Kernel and library are timed in turns (kernel,
library, library, kernel).  One JSON line per configuration, then for
each kernel a line that times in turns, over ``--rounds`` rounds and in
both harnesses, its configuration in use (``LAUNCH``), the sweep's
fastest in the cold harness, the earlier launch (4096 elements, 8
warps, one program per tile) and the library call, and, with
``--against ROOT``, the same kernel of another checkout of the repo
(its package loaded under another name), so that two versions are
compared within one process:

    python -m openset_imagenet_tpu_torch.tools.bench_stream \\
        --launch-sweep [--against /path/to/parent/checkout] [--rounds 5]
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import itertools
import json
import math
import pathlib
import statistics
import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..ops import stream_probe as sp
from . import _card

CHAIN = 32
SWEEP = ((8, 3136), (8, 12544), (32, 12544))
# The launch sweep: tile x warps x grid (0: one program per tile, k: a
# persistent grid of SMs * k programs) x cache hints.
LAUNCH_SWEEP = {"tile": (2048, 4096, 8192, 16384), "warps": (4, 8, 16),
                "waves": (0, 1, 2, 4, 8),
                "hint": ("none", "evict_first", "stream")}
TODAY = sp.Launch(4096, 8, 0, "none")    # the launch before the sweep
SWEEP_SHAPE = (8, 3136, 256)
GRAPH_CALLS = 20


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


def sweep_launches() -> List[sp.Launch]:
    """Every configuration of the launch sweep."""
    return [sp.Launch(*c) for c in itertools.product(
        *(LAUNCH_SWEEP[k] for k in sp.Launch._fields))]


def rotating(fn: Callable, pairs, keep: Optional[list] = None) -> Callable:
    """A call of ``fn`` on the next operand pair, in turn.  With ``keep``
    (a list), every output is kept alive, so that each call captured in
    a graph writes a buffer of its own."""
    cycle = itertools.cycle(pairs)

    def call():
        out = fn(*next(cycle))
        if keep is not None:
            keep.append(out)
        return out

    return call


def operand_pairs(shape: Sequence[int], cold: bool, seed: int = 0):
    """bf16 operand pairs drawn on the card: four (103 MB at [8, 3136,
    256], twice the L2) or, ``cold``, one for each call of a graph."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draw = lambda: torch.randn(*shape, generator=gen,
                               device="cuda").to(torch.bfloat16)
    return [(draw(), draw()) for _ in range(GRAPH_CALLS if cold else 4)]


def device_us(fn: Callable, pairs, cold: bool) -> float:
    """Device µs of one call of ``fn``: a CUDA graph of ``GRAPH_CALLS``
    calls over the rotating ``pairs``, replayed.  ``cold``: every call of
    the graph reads a pair and writes an output that no other call of it
    touches (770 MB a replay at [8, 3136, 256]), after the L2 was
    flushed (:func:`~._card.flush_l2`), so no byte a call moves is still
    in the L2 from an earlier call; the four warm pairs are re-read every
    fourth call and the output buffer rewritten every call."""
    if not cold:
        return _card.graph_ms(rotating(fn, pairs), calls=GRAPH_CALLS) * 1e3
    return _card.graph_ms(rotating(fn, pairs, []), calls=GRAPH_CALLS,
                          before=_card.flush_l2) * 1e3


def _load_other(root: str):
    """The ``ops.stream_probe`` of the port in another checkout, imported
    as package ``_against_port`` (its Triton kernels compile apart)."""
    pkg = pathlib.Path(root).resolve() / "openset_imagenet_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "_against_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["_against_port"] = module
    spec.loader.exec_module(module)
    return importlib.import_module("_against_port.ops.stream_probe")


def in_turns(kernel: Callable, library: Callable, pairs,
              cold: bool) -> Dict:
    """Kernel, library, library, kernel: the µs of each turn and the
    means."""
    k1, l1, l2, k2 = (device_us(fn, pairs, cold)
                      for fn in (kernel, library, library, kernel))
    return {"us": (k1 + k2) / 2, "us_turns": [k1, k2],
            "library_us": (l1 + l2) / 2, "library_turns": [l1, l2]}


def _rounds(fns: Dict[str, Callable], pairs, cold: bool,
            rounds: int) -> Dict:
    """Median µs of each function, timed in turns: the names in order,
    then reversed, ``rounds`` times."""
    times = {k: [] for k in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            times[name].append(device_us(fns[name], pairs, cold))
    return {k: {"us": statistics.median(v), "turns": v}
            for k, v in times.items()}


def launch_sweep(card: str, rounds: int, against: Optional[str]) -> None:
    """Every launch of :func:`sweep_launches` for both kernels, each
    checked bit-equal to its library call and timed in turns with it in
    both harnesses; the fastest by the cold harness is ``sweep_best``."""
    harness = {"warm4": operand_pairs(SWEEP_SHAPE, cold=False),
               "cold": operand_pairs(SWEEP_SHAPE, cold=True, seed=1)}
    bound, _ = _card.bound_ms(stream_bytes(SWEEP_SHAPE))
    other = _load_other(against) if against else None
    library = {"axpy": torch.add,
               "relu_mask": lambda g, m: torch.ops.aten.threshold_backward(
                   g, m, 0)}
    for probe, lib in library.items():
        kernel = getattr(sp, probe)
        first = harness["warm4"][0]
        want = lib(*first)
        best = None
        for launch in sweep_launches():
            run = lambda a, b, launch=launch: kernel(a, b, launch=launch)
            if not torch.equal(run(*first).view(torch.int16),
                               want.view(torch.int16)):
                raise RuntimeError(f"{probe} {launch}: bits differ from "
                                   "the library call")
            _, programs, _ = sp._plan(want.numel(), launch,
                                      sp.sm_count(want.device))
            timed = {name: in_turns(run, lib, pairs, name == "cold")
                     for name, pairs in harness.items()}
            for t in timed.values():
                t["vs_library"] = t["us"] / t["library_us"]
                t["share_of_bound"] = bound * 1e3 / t["us"]
            print(json.dumps({"launch_sweep": probe, **launch._asdict(),
                              "programs": programs, **timed,
                              "card": card}), flush=True)
            if best is None or timed["cold"]["us"] < best[0]:
                best = (timed["cold"]["us"], launch)
        fns = {"in_use": lambda a, b: kernel(a, b),
               "sweep_best": lambda a, b: kernel(a, b, launch=best[1]),
               "today": lambda a, b: kernel(a, b, launch=TODAY),
               "library": lib}
        if other is not None:
            fns["against"] = getattr(other, probe)
            if not torch.equal(fns["against"](*first), want):
                raise RuntimeError(f"{probe}: --against's bits differ")
        print(json.dumps({
            "launch_turns": probe, "in_use": sp.LAUNCH[probe]._asdict(),
            "sweep_best": best[1]._asdict(), "today": TODAY._asdict(),
            "against": against, "rounds": rounds, "bound_us": bound * 1e3,
            **{name: _rounds(fns, pairs, name == "cold", rounds)
               for name, pairs in harness.items()},
            "card": card}), flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=3136)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sweep", action="store_true",
                    help="sweep operand sizes 12.8 MB -> 205 MB")
    ap.add_argument("--launch-sweep", action="store_true",
                    help="sweep the kernels' launch configurations "
                         "against the library calls (card only)")
    ap.add_argument("--against", metavar="ROOT",
                    help="with --launch-sweep: also time the kernels of "
                         "the checkout at ROOT, in turns")
    ap.add_argument("--rounds", type=int, default=3,
                    help="with --launch-sweep: rounds of the final turns")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_stream: no CUDA device (--device cpu runs "
                         "the plain versions on the host)")
    if args.launch_sweep and device.type != "cuda":
        raise SystemExit("bench_stream: --launch-sweep times the kernels "
                         "on the card")
    card = _card.card_line() if device.type == "cuda" else None
    if args.launch_sweep:
        launch_sweep(card, args.rounds, args.against)
        return 0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    shapes = SWEEP if args.sweep else ((8, args.rows),)
    for batch, rows in shapes:
        run_shape((batch, rows, 256), args.iters, device, card, name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
