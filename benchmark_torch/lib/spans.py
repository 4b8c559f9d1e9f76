"""The harness's span recorder.

Spans are taken from the benchmark's own files, around its calls into the
program's layers (``pipeline.next``, ``train_step``, ``sync``, ``http``,
``batcher``), and kept in memory; ``run.py`` writes the run's record
once, at the end.  The traced window lays them over the device's idle gaps
(:func:`.profile.summarize`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional


class Spans:
    """``with spans.span(name): ...`` records ``(name, start, end)`` on
    ``time.perf_counter``, from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.records: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.records.append((name, t0, t1))

    def durations(self, name: str, since: float = float("-inf"),
                  until: Optional[float] = None) -> list:
        """Seconds of every ``name`` span that started in ``[since,
        until)``."""
        with self._lock:
            return [e - s for n, s, e in self.records
                    if n == name and s >= since
                    and (until is None or s < until)]

    def snapshot(self) -> list:
        with self._lock:
            return list(self.records)

    def names(self) -> set:
        with self._lock:
            return {n for n, _, _ in self.records}
