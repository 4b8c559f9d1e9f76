"""What a run carries from the entry point through its generator to the
metric readers, and the few steps every generator shares."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

from .spans import Spans


@dataclasses.dataclass
class Ctx:
    """One run: the cell and its configuration and traffic (parsed JSON),
    the seed, the window's seconds, whether to trace, the device, the
    process's start on the host clock (``time.time``) and the directory
    for the run's own files."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_process: float
    out_dir: object
    spans: Spans = dataclasses.field(default_factory=Spans)


@dataclasses.dataclass
class Result:
    """What a generator measured and checked.

    ``e2e``: end-to-end metric name -> value (``setup_s`` included);
    ``counters``: the window's counts and times for the readers;
    ``profile``: :func:`.profile.summarize` of the traced window, or None;
    ``numbers``: compared number -> value, each judged against its limit;
    ``attempted`` / ``failed``: units of work offered in the window and
    those that failed or never completed.
    """

    kind: str
    config: dict
    e2e: dict
    counters: dict
    numbers: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    spans: Spans
    profile: Optional[dict] = None


def sync(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def setup_seconds(ctx: Ctx) -> float:
    """Seconds from the process's start to now (the window's start)."""
    return time.time() - ctx.t_process


def peak_memory(device) -> int:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def release(device) -> None:
    """Give the program's freed device memory back before the reference
    runs."""
    import torch

    gc.collect()
    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def limits_of(ctx: Ctx) -> dict:
    """The compared numbers' limits: the configuration's, by the traffic's
    kind, then the traffic's own ``limits`` over them."""
    limits = dict(ctx.config.get("limits", {}).get(ctx.traffic["kind"], {}))
    limits.update(ctx.traffic.get("limits", {}))
    return limits
