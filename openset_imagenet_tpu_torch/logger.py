"""Minimal structured logger with the reference's loguru log format.

Counterpart of :mod:`openset_imagenet_tpu.logger` (same line format and
sinks; the default logger name is this package's).  The reference
configures loguru with format ``"{time:DD_MM_HH:mm} {name} {level}:
{message}"`` writing to stderr plus a per-run logfile (reference
``train.py:248-256``).  loguru is not a dependency, so this module
provides an equivalent on top of the stdlib ``logging`` package: same
line format, same dual sink behaviour.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path
from typing import Optional


class _RefFormatter(logging.Formatter):
    """Formats records as ``DD_MM_HH:mm name LEVEL: message``."""

    def format(self, record: logging.LogRecord) -> str:
        stamp = time.strftime("%d_%m_%H:%M", time.localtime(record.created))
        msg = f"{stamp} {record.name} {record.levelname}: " \
              f"{record.getMessage()}"
        # Unlike the loguru format string this emulates, exceptions must be
        # appended explicitly — log.exception() during a long training run
        # would otherwise lose the traceback from both sinks.
        if record.exc_info:
            msg += "\n" + self.formatException(record.exc_info)
        if record.stack_info:
            msg += "\n" + self.formatStack(record.stack_info)
        return msg


def configure_logger(
    name: str = "openset_imagenet_tpu_torch",
    logfile: Optional[Path] = None,
    level: int = logging.INFO,
    stderr: bool = True,
) -> logging.Logger:
    """Create/reset a logger with a stderr sink and optional file sink.

    Mirrors reference ``train.py:248-256`` (stderr handler + per-run logfile
    opened in ``'w'`` mode).
    """
    log = logging.getLogger(name)
    log.setLevel(level)
    log.propagate = False
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()
    fmt = _RefFormatter()
    if stderr:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        log.addHandler(sh)
    if logfile is not None:
        Path(logfile).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(logfile, mode="w")
        fh.setFormatter(fmt)
        log.addHandler(fh)
    return log


def get_logger(name: str = "openset_imagenet_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)
