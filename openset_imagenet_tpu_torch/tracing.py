"""Spans at the port's layer boundaries, recorded while a profiler records.

``with span("train.forward", device=dev): ...`` records the block's start
and end on ``time.perf_counter`` (the clock of the benchmark's own spans
and of its trace marker), the span open on the same thread (``parent``),
a ``key`` (the step, batch or chunk index; a span without one takes its
parent's, so the spans of one step share it) and the thread's name.  With
a CUDA ``device`` it also records a timing event on that device's current
stream at entry and at exit; :func:`snapshot` resolves the pair to device
milliseconds.

The recorder is on only while a ``torch.profiler`` records: the
benchmark's traced stretches and the worker's ``profile.{dir, epochs}``
epochs.  The check reads the process-wide flag the profiler sets (the
thread-local one is off on threads the profiler was not started from,
such as the producers of the input pipeline and of ``predict_stream``).
Off, :func:`span` reads that flag and returns one shared null context.
On, each span also opens a profiler range of its name (what
``torch.profiler.record_function`` opens), so an exported Chrome trace
shows the program's phases over its kernels.

Records stay in memory, the newest :data:`MAX_RECORDS` of them; older
ones are dropped and counted in ``RECORDER.dropped``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

MAX_RECORDS = 200_000

# What span() returns while no profiler records.
OFF = contextlib.nullcontext()


class Record(NamedTuple):
    """One span.  ``t0`` / ``t1``: host seconds on ``time.perf_counter``.
    ``device_ms``: between the span's two CUDA events (None without
    them); ``device_t0`` / ``device_t1``: those events in milliseconds
    after the start event of the snapshot's earliest device span on the
    same device."""

    name: str
    t0: float
    t1: float
    parent: Optional[str]
    key: Optional[int]
    thread: str
    device_ms: Optional[float] = None
    device_t0: Optional[float] = None
    device_t1: Optional[float] = None


class _Span:
    __slots__ = ("rec", "name", "key", "device", "parent", "t0", "ev0",
                 "stream", "range")

    def __init__(self, rec: "Recorder", name: str, key, device):
        self.rec, self.name, self.key = rec, name, key
        self.device = None
        if device and torch.device(device).type == "cuda":
            self.device = device

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = None
        if stack:
            self.parent, parent_key = stack[-1]
            if self.key is None:
                self.key = parent_key
        stack.append((self.name, self.key))
        # The profiler's own fast range: record_function() is an operator
        # call that releases the interpreter lock, and taking the lock
        # back from a busy producer thread costs up to a switch interval.
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.ev0 = None
        if self.device is not None:
            self.stream = torch.cuda.current_stream(self.device)
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(self.stream)
        # Host ends inside the events, whose records release the lock too.
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        ev1 = on = None
        if self.ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record(self.stream)
            on = self.stream.device
        self.range.__exit__(*exc)
        self.rec._stack().pop()
        self.rec._append((self.name, self.t0, t1, self.parent, self.key,
                          threading.current_thread().name, on, self.ev0,
                          ev1))
        return False


class Recorder:
    """A bounded in-memory store of spans, from any thread."""

    def __init__(self, maxlen: int = MAX_RECORDS):
        self._lock = threading.Lock()
        self._records: collections.deque = collections.deque(maxlen=maxlen)
        self._local = threading.local()
        self.dropped = 0

    def span(self, name: str, key: Optional[int] = None, device=False):
        """A context manager recording ``name`` while a profiler records;
        ``device``: a CUDA device whose current stream the span times
        too (anything else times the host alone)."""
        if not _profiler._is_profiler_enabled:
            return OFF
        return _Span(self, name, key, device)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, raw: tuple) -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
            self._records.append(raw)

    def snapshot(self) -> list:
        """The records in the order their spans ended, as :class:`Record`;
        waits for the device events it resolves."""
        with self._lock:
            raws = list(self._records)
        origins = {}
        for raw in sorted((r for r in raws if r[7] is not None),
                          key=lambda r: r[1]):
            if raw[6] not in origins:
                origins[raw[6]] = raw[7]
                raw[7].synchronize()
        out = []
        for name, t0, t1, parent, key, thread, device, ev0, ev1 in raws:
            if ev0 is None:
                out.append(Record(name, t0, t1, parent, key, thread))
                continue
            ev1.synchronize()
            origin = origins[device]
            out.append(Record(name, t0, t1, parent, key, thread,
                              ev0.elapsed_time(ev1),
                              origin.elapsed_time(ev0),
                              origin.elapsed_time(ev1)))
        return out

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0


# The process's recorder, which the port's layers record into.
RECORDER = Recorder()
span = RECORDER.span
snapshot = RECORDER.snapshot
clear = RECORDER.clear
