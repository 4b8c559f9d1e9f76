"""Durable per-epoch scalar record: tensorboard events + CSV sidecar.

The reference logs scalars through torch's ``SummaryWriter(log_dir=outdir,
filename_suffix="-"+log_name)`` (reference ``train.py:408,440-444``) and the
plotting layer later **reads those event files back** as the data source for
the confidence-propagation figure (reference ``script/plot_all.py:219-232``).

Counterpart of :mod:`openset_imagenet_tpu.events`, the same contract:
events are written with the ``tensorboard`` package's ``EventFileWriter``
(same wire format, same ``events.out.tfevents.*-{suffix}`` discovery
pattern) where that package imports, and every scalar is always mirrored
into a plain ``scalars-{suffix}.csv`` sidecar, so the plot layer (and
humans) can read the record without tensorboard at all.
``torch.utils.tensorboard`` is not used: the two packages write the same
record.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Optional


class SummaryWriter:
    """Scalar-only tensorboard writer + CSV mirror.

    API subset parity with ``torch.utils.tensorboard.SummaryWriter``:
    ``add_scalar(tag, value, step)``, ``flush()``, ``close()``.
    """

    def __init__(self, log_dir, filename_suffix: str = ""):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.filename_suffix = filename_suffix
        self._ev_writer = None
        try:
            from tensorboard.summary.writer.event_file_writer import (
                EventFileWriter)
            self._ev_writer = EventFileWriter(
                str(self.log_dir), filename_suffix=filename_suffix)
        except Exception:  # tensorboard absent: CSV sidecar still works
            self._ev_writer = None
        csv_name = f"scalars{filename_suffix or ''}.csv"
        self._csv_path = self.log_dir / csv_name
        self._csv_file = open(self._csv_path, "a", newline="")
        self._csv = csv.writer(self._csv_file)
        if self._csv_file.tell() == 0:
            self._csv.writerow(["wall_time", "step", "tag", "value"])

    def add_scalar(self, tag: str, value, step: int,
                   wall_time: Optional[float] = None):
        wall_time = time.time() if wall_time is None else wall_time
        value = float(value)
        if self._ev_writer is not None:
            from tensorboard.compat.proto import event_pb2, summary_pb2
            ev = event_pb2.Event(
                wall_time=wall_time, step=int(step),
                summary=summary_pb2.Summary(value=[
                    summary_pb2.Summary.Value(tag=tag, simple_value=value)]))
            self._ev_writer.add_event(ev)
        self._csv.writerow([f"{wall_time:.3f}", int(step), tag, value])

    def flush(self):
        if self._ev_writer is not None:
            self._ev_writer.flush()
        self._csv_file.flush()

    def close(self):
        self.flush()
        if self._ev_writer is not None:
            self._ev_writer.close()
        self._csv_file.close()


def read_scalars(log_dir, suffix_filter: str = "") -> dict:
    """Read scalars back as ``{tag: [(step, value), ...]}``.

    Prefers tensorboard event files (matching the reference plot layer's
    ``event*`` glob + ``-{log_name}`` suffix filter, reference
    ``script/plot_all.py:196-206``); falls back to the CSV sidecar.
    """
    log_dir = Path(log_dir)
    # Last-write-wins per (tag, step): a crash-resumed run re-emits the
    # resume epoch, and the re-run value must replace the stale one (the
    # reference dedups the same way via a step-keyed dict,
    # script/plot_all.py:219-232).
    out: dict = {}

    def record(tag, step, value):
        out.setdefault(tag, {})[int(step)] = float(value)

    found_events = False
    event_files = sorted(p for p in log_dir.glob("events*")
                         if str(p).endswith(suffix_filter))
    if event_files:
        try:
            from tensorboard.backend.event_processing.event_accumulator \
                import EventAccumulator
            for path in event_files:
                # scalars: 0 = unlimited history (reference
                # script/plot_all.py passes the same size_guidance; the
                # default caps at 10k points/tag and reservoir-subsamples).
                acc = EventAccumulator(str(path),
                                       size_guidance={"scalars": 0})
                acc.Reload()
                for tag in acc.Tags().get("scalars", []):
                    for e in acc.Scalars(tag):
                        record(tag, e.step, e.value)
            found_events = bool(out)
        except Exception:
            out = {}
    if not found_events:
        for csv_path in sorted(log_dir.glob("scalars*.csv")):
            if suffix_filter and suffix_filter not in csv_path.name:
                continue
            with open(csv_path, newline="") as f:
                for row in csv.DictReader(f):
                    record(row["tag"], row["step"], row["value"])
    return {t: sorted(v.items()) for t, v in out.items()}
