"""Task-event timeline: chrome-trace export + torch profiler integration.

Reference analogue: `src/ray/gcs/gcs_task_manager.cc` (task event buffer)
surfaced by `ray timeline` (`python/ray/scripts`), which dumps a
chrome://tracing JSON of task lifetimes. Here the runtime records
submit/start/finish transitions into a bounded ring buffer, application
code can add named spans (the trainer marks each train step), and
``ray_tpu_torch.timeline("out.json")`` writes a Perfetto-loadable trace with
both planes: runtime tasks (one track per node) and app spans.

The port's copy of ray_tpu/util/timeline.py. For the device plane,
``trace_torch(logdir)`` is the counterpart of the reference's
``trace_jax``: it wraps ``torch.profiler`` (CPU activity, and the card's
kernels where one is present) and writes a chrome trace into ``logdir``
that loads in the same Perfetto UI.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..core.config import config

_lock = threading.Lock()
_events: "deque[Dict[str, Any]]" = deque(maxlen=10_000)
_total = 0  # events ever recorded (monotone; the ring may have dropped some)
_t0_us = time.time() * 1e6 - time.perf_counter() * 1e6


def _now_us() -> float:
    return _t0_us + time.perf_counter() * 1e6


def configure() -> None:
    """Resize the ring to the configured bound (called lazily on record)."""
    global _events
    cap = int(config.task_events_max_buffer)
    if _events.maxlen != cap:
        with _lock:
            _events = deque(_events, maxlen=cap)


def record(
    name: str,
    ph: str,
    cat: str = "task",
    ts_us: Optional[float] = None,
    dur_us: Optional[float] = None,
    pid: str = "runtime",
    tid: str = "0",
    args: Optional[Dict[str, Any]] = None,
) -> None:
    """Append one chrome-trace event. ph: 'X' complete, 'i' instant."""
    configure()
    ev: Dict[str, Any] = {
        "name": name,
        "cat": cat,
        "ph": ph,
        "ts": ts_us if ts_us is not None else _now_us(),
        "pid": pid,
        "tid": tid,
    }
    if dur_us is not None:
        ev["dur"] = dur_us
    if args:
        ev["args"] = args
    global _total
    with _lock:
        _events.append(ev)
        _total += 1


def drain_since(cursor: int) -> Tuple[int, List[Dict[str, Any]]]:
    """Events recorded after `cursor` (a value this function previously
    returned; start at 0) plus the new cursor. Read-only: the caller owns
    the cursor, so a failed telemetry flush retries with the old one."""
    with _lock:
        dropped = _total - len(_events)
        start = max(0, cursor - dropped)
        return _total, [dict(ev) for ev in list(_events)[start:]]


def ingest(events: List[Dict[str, Any]], lane: str) -> int:
    """Merge events flushed from another process into this buffer (head
    side of telemetry federation). Each event's pid becomes
    '<lane>/<orig pid>' so the merged chrome-trace shows one process
    group per source node. Returns the number added."""
    if not events:
        return 0
    configure()
    global _total
    with _lock:
        for ev in events:
            ev = dict(ev)
            ev["pid"] = f"{lane}/{ev.get('pid', '?')}"
            _events.append(ev)
            _total += 1
    return len(events)


@contextlib.contextmanager
def span(name: str, cat: str = "app", pid: str = "app", tid: str = "0",
         args: Optional[Dict[str, Any]] = None):
    """Record a named span around a code block (e.g. one train step)."""
    t0 = _now_us()
    try:
        yield
    finally:
        record(name, "X", cat=cat, ts_us=t0, dur_us=_now_us() - t0,
               pid=pid, tid=tid, args=args)


def clear() -> None:
    with _lock:
        _events.clear()


def export(path: str) -> int:
    """Write the buffered events as chrome://tracing / Perfetto JSON.
    Returns the number of events written."""
    with _lock:
        events = list(_events)
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"tool": "ray_tpu_torch.timeline", "exported_at": time.time()},
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events)


@contextlib.contextmanager
def trace_torch(logdir: str):
    """Capture a device trace alongside the task timeline: torch.profiler
    over the block, with the card's kernels when CUDA is available, written
    on exit as chrome-trace JSON to `<logdir>/trace_<pid>_<ms>.json`.
    Yields the profiler (its `key_averages()` reads the same run)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
