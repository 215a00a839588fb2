"""Structured process logging.

The port's copy of ray_tpu/core/logging.py (the reference's counterpart of
upstream ray's RAY_LOG setup and its per-session log directory): each
process logs to stderr and to a per-process file under the session log
dir, with component and worker context prefixed so a tail-aggregator can
attribute lines. The loggers are named `ray_tpu_torch.<component>`, so the
two packages never share a handler in one process, and the session
directory sits under the process's temporary directory (`TMPDIR`) unless
RAY_TPU_TMPDIR names another.

Log-trace correlation: a record emitted while a trace span is active on
the emitting thread carries ` trace_id=<id>` in its prefix. Every line is
also mirrored into the flight recorder (util/flight_recorder).
"""

from __future__ import annotations

import logging
import os
import sys
import tempfile
import time
from typing import Optional

_SESSION_DIR: Optional[str] = None
_FMT = "[%(asctime)s %(levelname).1s %(process)d %(name)s%(trace_ctx)s] %(message)s"


def session_dir() -> str:
    """Session directory (<tmp>/ray_tpu_torch/session_<ts> with a `latest`
    symlink)."""
    global _SESSION_DIR
    if _SESSION_DIR is None:
        base = os.environ.get("RAY_TPU_TMPDIR",
                              os.path.join(tempfile.gettempdir(), "ray_tpu_torch"))
        stamp = time.strftime("session_%Y%m%d_%H%M%S") + f"_{os.getpid()}"
        path = os.path.join(base, stamp)
        os.makedirs(os.path.join(path, "logs"), exist_ok=True)
        latest = os.path.join(base, "session_latest")
        try:
            if os.path.islink(latest) or os.path.exists(latest):
                os.remove(latest)
            os.symlink(path, latest)
        except OSError:
            pass
        _SESSION_DIR = path
    return _SESSION_DIR


def log_dir() -> str:
    return os.path.join(session_dir(), "logs")


class _TraceContextFilter(logging.Filter):
    """Stamps `record.trace_ctx` from the thread's active span (lazy
    tracing import: logging is imported everywhere, tracing must stay
    optional at this layer)."""

    _current_span = None  # resolved once, cached on the class

    def filter(self, record: logging.LogRecord) -> bool:
        fn = _TraceContextFilter._current_span
        if fn is None:
            try:
                from ..util.tracing import current_span as fn
            except Exception:
                fn = lambda: None  # noqa: E731
            _TraceContextFilter._current_span = fn
        span = fn()
        record.trace_ctx = f" trace_id={span.trace_id}" if span is not None else ""
        return True


class _FlightHandler(logging.Handler):
    """Mirrors every formatted line into the flight-recorder ring."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            from ..util import flight_recorder
            flight_recorder.on_log(self.format(record))
        except Exception:
            pass  # crash forensics must never break logging


def get_logger(component: str, to_file: bool = True) -> logging.Logger:
    logger = logging.getLogger(f"ray_tpu_torch.{component}")
    if getattr(logger, "_ray_tpu_configured", False):
        return logger
    logger.setLevel(os.environ.get("RAY_TPU_LOG_LEVEL", "INFO").upper())
    formatter = logging.Formatter(_FMT)
    logger.addFilter(_TraceContextFilter())
    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(formatter)
    logger.addHandler(stream)
    if to_file:
        try:
            path = os.path.join(log_dir(), f"{component}_{os.getpid()}.log")
            fh = logging.FileHandler(path)
            fh.setFormatter(formatter)
            logger.addHandler(fh)
        except OSError:
            pass
    flight = _FlightHandler()
    flight.setFormatter(formatter)
    logger.addHandler(flight)
    logger.propagate = False
    logger._ray_tpu_configured = True  # type: ignore[attr-defined]
    return logger
