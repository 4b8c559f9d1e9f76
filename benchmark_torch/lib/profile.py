"""The traced window: ``torch.profiler`` over a stretch of steady work,
reduced to device time by kernel and by category, busy and idle time, and
the idle gaps by the host span that was open.

``CATEGORIES`` and :func:`category` are a copy of the table in
``tools/profile_torch_serve.py`` (kernel-name fragments, first match
wins), kept here so that a change to the program does not move the
yardstick; ``nvjet`` (cuBLASLt's Hopper kernels, which run many of
cuDNN's 1x1 convolutions) is added to ``gemm``.  A kernel of the port's
loss (K1, K2) falls in ``loss (Triton)``, cuDNN's convolutions in
``conv``, torch's pointwise kernels in ``elementwise``.
"""

from __future__ import annotations

import collections
import time
from typing import Iterable, Optional

import numpy as np

# Kernel-name fragments -> category, first match wins.
CATEGORIES = (
    ("K5", ("site_fused", "site_rows", "site_dw", "site_gate",
            "reduce_partials")),
    ("int8_conv", ("conv_tc<", "conv_simt")),
    ("loss (Triton)", ("entropic_", "ce_fwd", "ce_bwd")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("pool", ("pool",)),
    ("conv", ("fprop", "conv", "implicit", "xmma", "dgrad", "nchw", "nhwc")),
    ("gemm", ("gemm", "cutlass", "cublas", "nvjet")),
    ("reduce/softmax", ("reduce", "softmax")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy", ("copy", "memcpy", "memset")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: the window's start


def on_card(device) -> bool:
    return getattr(device, "type", str(device)) == "cuda"


class Trace:
    """The profiler over a stretch of work on the card: ``start()`` starts
    it, waits for the card and launches a marker kernel at a noted host
    time; ``stop()`` waits for the card and stops it.  The marker ties the
    host's clock to the trace's, so that the harness's host spans can be
    laid over the device's idle gaps.

    It records device activity only (recording every host operation as
    well doubles a train step's host time, and so the device's idle
    share), unless ``all_threads``: kernels launched from threads other
    than the one that started the profiler (the daemon's batcher) are
    kept only while every thread's host operations are recorded too."""

    def __init__(self, device, all_threads: bool = False):
        self.device = device
        self.all_threads = all_threads
        self.prof = None
        self.t_mark = None

    def start(self) -> "Trace":
        import torch
        from torch.profiler import ProfilerActivity, profile

        on_card = getattr(self.device, "type", str(self.device)) == "cuda"
        if self.all_threads or not on_card:
            self.prof = profile(
                activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if on_card else []),
                experimental_config=torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True))
        else:
            self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        if on_card:
            torch.cuda.synchronize(self.device)
        self.t_mark = time.perf_counter()
        if on_card:
            torch.cuda._sleep(1000)
        return self

    def stop(self) -> None:
        import torch

        if getattr(self.device, "type", str(self.device)) == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()

    def summary(self, spans, steps: int) -> Optional[dict]:
        return summarize(self.prof.events(), spans.snapshot(), steps,
                         self.t_mark)

    def busy_s(self) -> Optional[float]:
        """Seconds in which an operation ran on the device (:func:`summarize`'s
        ``busy_s``), or None when the trace holds none.  Read from the
        profiler's raw results where it has them: ``prof.events()`` builds
        an object an event, some 25 s for a 10 s window of a train cell."""
        results = getattr(getattr(self.prof, "profiler", None),
                          "kineto_results", None)
        if results is not None:
            return device_busy_s(results.events())
        s = summarize(self.prof.events(), (), 0, self.t_mark)
        return None if s is None else s["busy_s"]


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Union of ``[start, end]`` rows, sorted, as disjoint rows."""
    if not len(intervals):
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.float64)


def device_busy_s(raw_events: Iterable) -> Optional[float]:
    """The union of the device's operations, in seconds, over the
    profiler's raw events (``_KinetoEvent``: ``name()``, ``device_type()``,
    ``start_ns()``, ``end_ns()``), taking the operations that
    :func:`summarize` takes: CUDA events that are no host range's
    annotation and no :data:`MARKER`.  None when there are none."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    iv = []
    for evt in raw_events:
        if (evt.device_type() != cuda or evt.is_user_annotation()
                or getattr(evt, "is_hidden_event", lambda: False)()
                or MARKER in evt.name()):
            continue
        iv.append((evt.start_ns(), evt.end_ns()))
    if not iv:
        return None
    ns = np.asarray(iv, dtype=np.int64)
    merged = _merge(ns - ns[:, 0].min())
    return float((merged[:, 1] - merged[:, 0]).sum()) / 1e9


def summarize(events: Iterable, host_spans, steps: int,
              t_mark: float) -> Optional[dict]:
    """Reduce the profiler's events of one traced stretch.

    ``events`` are ``prof.events()``; the device's operations are those
    with ``device_type`` CUDA that are no host range's annotation.  The
    window runs from the :data:`MARKER` kernel's start (else the first
    operation's) to the last operation's end, in the trace's microseconds;
    ``host_spans`` (``(name, start, end)`` on ``time.perf_counter``) are
    moved onto that clock by the marker, launched at host time ``t_mark``.
    Returns None when the trace holds no device operation, else
    ``window_s``, ``busy_s`` (the union of the operations), ``steps``,
    ``by_kernel`` (name -> [seconds, launches]), ``by_cat`` (category ->
    seconds) and ``idle_by_span`` (the host spans open during each idle
    gap, ``+``-joined, or ``none`` -> idle seconds).
    """
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels, marker = [], None
    for evt in events:
        if evt.device_type != cuda or getattr(evt, "is_user_annotation",
                                              False):
            continue
        tr = evt.time_range
        if MARKER in evt.name:
            marker = tr.start if marker is None else min(marker, tr.start)
        else:
            kernels.append((evt.name, tr.start, tr.end))
    if not kernels:
        return None
    lo = marker if marker is not None else min(s for _, s, _ in kernels)
    hi = max(e for _, _, e in kernels)
    offset = lo - t_mark * 1e6
    by_kernel: dict = {}
    iv = []
    for name, s, e in kernels:
        rec = by_kernel.setdefault(name, [0.0, 0])
        rec[0] += (e - s) / 1e6
        rec[1] += 1
        iv.append((s, e))
    merged = _merge(np.asarray(iv, dtype=np.float64))
    busy = float((merged[:, 1] - merged[:, 0]).sum())
    by_cat = collections.Counter()
    for name, (sec, _) in by_kernel.items():
        by_cat[category(name)] += sec
    hosts = collections.defaultdict(list)
    for name, s, e in host_spans:
        hosts[name].append((s * 1e6 + offset, e * 1e6 + offset))
    # Idle gaps: before the first, between, and after the last busy run.
    edges = np.concatenate([[lo], merged.ravel(), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    idle = collections.Counter()
    if len(gaps):
        mid = gaps.mean(axis=1)
        length = (gaps[:, 1] - gaps[:, 0]) / 1e6
        open_by = []
        for name in sorted(hosts):
            arr = np.asarray(hosts[name], dtype=np.float64)
            starts, ends = np.sort(arr[:, 0]), np.sort(arr[:, 1])
            covering = (np.searchsorted(starts, mid, side="right")
                        - np.searchsorted(ends, mid, side="right"))
            open_by.append((name, covering > 0))
        for i in range(len(gaps)):
            key = "+".join(n for n, hit in open_by if hit[i]) or "none"
            idle[key] += float(length[i])
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "steps": int(steps), "by_kernel": by_kernel,
            "by_cat": dict(by_cat), "idle_by_span": dict(idle)}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the ``top`` device operations by
    time and the idle time by open host span, each ``[[name, seconds]]``."""
    ops = sorted(summary["by_kernel"].items(), key=lambda kv: -kv[1][0])
    gaps = sorted(summary["idle_by_span"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], s] for n, (s, _) in ops[:top]],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}
