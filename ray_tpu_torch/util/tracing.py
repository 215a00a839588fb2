"""Request tracing: spans with W3C-style ids in a per-process buffer.

The port's copy of the in-process span API of ray_tpu/util/tracing.py
(the reference's counterpart of upstream ray's OpenTelemetry tracing
helper, without the OTel dependency): a thread-local current span,
`start_span` to open one, `span_if_traced` to open one only under an
active trace (the serving engine wraps `generate` in "engine.generate"
this way), `maybe_begin` / `activate` for spans that outlive one call,
`get_spans` / `get_trace` to read the buffer as records or as a tree, and
`drain_since` / `ingest` to move records between processes, and
`export_to_timeline` to mirror the buffer into the chrome-trace timeline
(util/timeline.py). Task submission stamps the submitter's context on the
task (`current_context`), and the executing node agent opens its
`execute:<task>` span under it.

Usage:

    from ray_tpu_torch.util import tracing

    with tracing.start_span("handle_request", {"route": "/chat"}) as root:
        engine.generate(prompt)       # records an "engine.generate" span
    tree = tracing.get_trace(root.trace_id)

A span bound manually — `maybe_begin(...)` / `Span(...)` instead of the
`start_span` context manager — must reach `finish()` on every path, in a
`finally` or through an owner that finishes it later; `finish()` is
idempotent.

Spans are recorded only while one is active — zero overhead otherwise.
Serve entry points additionally open root spans for a
`config.trace_sample_rate` fraction of requests (default 0: off, the
zero-overhead fast path)."""

from __future__ import annotations

import os
import random
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from ..core.config import config

_local = threading.local()
_lock = threading.Lock()
_spans: List[Dict[str, Any]] = []
_total = 0  # spans ever buffered (monotone; _spans may have been trimmed)
_MAX_SPANS = 10_000


def _now_us() -> float:
    return time.time() * 1e6


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs",
                 "start_us", "end_us")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id or uuid.uuid4().hex
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.name = name
        self.attrs = dict(attrs or {})
        self.start_us = _now_us()
        self.end_us: Optional[float] = None

    def context(self) -> Dict[str, str]:
        """The wire form (W3C traceparent shape, dict-framed)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def finish(self) -> None:
        if self.end_us is not None:
            return  # idempotent: stream teardown paths may race
        self.end_us = _now_us()
        rec = {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "attrs": self.attrs, "start_us": self.start_us,
            "end_us": self.end_us, "pid": os.getpid(),
        }
        global _total
        with _lock:
            _spans.append(rec)
            _total += 1
            if len(_spans) > _MAX_SPANS:
                del _spans[: len(_spans) - _MAX_SPANS]


class _RemoteParent:
    """A remote span context installed as this thread's parent without
    recording a span (see `activate`): just enough surface for
    `start_span` / `current_context` to chain under it."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def context(self) -> Dict[str, str]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}


def current_span() -> Optional[Span]:
    return getattr(_local, "span", None)


def current_context() -> Optional[Dict[str, str]]:
    """ctx dict to stamp into an outgoing TaskSpec (None when tracing is
    inactive on this thread — the common, zero-overhead case)."""
    span = current_span()
    return span.context() if span is not None else None


def should_sample() -> bool:
    """Head-based sampling decision for a NEW request root
    (config.trace_sample_rate). The rate-0 default short-circuits before
    touching the RNG — the provably-zero-overhead path."""
    rate = float(config.trace_sample_rate)
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return random.random() < rate


def maybe_begin(name: str, attrs: Optional[Dict[str, Any]] = None
                ) -> Optional[Span]:
    """Request-entry hook for serve surfaces: returns an OPEN span (not
    thread-current, not auto-finished — the caller owns `finish()`, via
    `activate()` for the synchronous part and a finally for streams)
    when this thread is already traced or the sampler fires; None on the
    untraced fast path."""
    parent = current_span()
    if parent is not None:
        return Span(name, trace_id=parent.trace_id,
                    parent_id=parent.span_id, attrs=attrs)
    if should_sample():
        return Span(name, attrs=attrs)
    return None


@contextmanager
def start_span(name: str, attrs: Optional[Dict[str, Any]] = None,
               context: Optional[Dict[str, str]] = None):
    """Open a span. `context` parents it under a REMOTE span (extracted
    from an incoming TaskSpec or serve request dict); otherwise it nests
    under this thread's current span (or starts a fresh trace)."""
    parent = current_span()
    if context is not None:
        span = Span(name, trace_id=context["trace_id"],
                    parent_id=context["span_id"], attrs=attrs)
    elif parent is not None:
        span = Span(name, trace_id=parent.trace_id,
                    parent_id=parent.span_id, attrs=attrs)
    else:
        span = Span(name, attrs=attrs)
    prev = parent
    _local.span = span
    try:
        yield span
    finally:
        span.finish()
        _local.span = prev


@contextmanager
def span_if_traced(name: str, attrs: Optional[Dict[str, Any]] = None,
                   context: Optional[Dict[str, str]] = None):
    """`start_span`, but only when a trace is already active — an
    explicit remote `context` or a thread-current span. The untraced
    path yields None without touching the buffer or the RNG, so hot
    paths (object pulls, channel sends, disagg legs) can instrument
    unconditionally at zero cost."""
    if context is None and getattr(_local, "span", None) is None:
        yield None
        return
    with start_span(name, attrs, context=context) as s:
        yield s


@contextmanager
def activate(span_or_ctx):
    """Make an already-open span (or a bare remote context dict) current
    on this thread WITHOUT finishing it on exit — re-entry for request
    work that resumes on other threads (stream generators, get() pool
    workers). Accepts None as a no-op so callers can write
    `with tracing.activate(maybe_begin(...)):` unconditionally."""
    if span_or_ctx is None:
        yield None
        return
    if isinstance(span_or_ctx, dict):
        span_or_ctx = _RemoteParent(span_or_ctx["trace_id"],
                                    span_or_ctx["span_id"])
    prev = current_span()
    _local.span = span_or_ctx
    try:
        yield span_or_ctx
    finally:
        _local.span = prev


def get_spans(trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    with _lock:
        out = list(_spans)
    if trace_id is not None:
        out = [s for s in out if s["trace_id"] == trace_id]
    return out


def get_trace(trace_id: str) -> List[Dict[str, Any]]:
    """The trace as a TREE: root span records (those whose parent is
    absent from the buffer) each carrying a recursively-nested
    `children` list; every level sorted by start time. `trace_id` may be
    a unique prefix (the OpenAI `X-Request-Id` embeds the full id, but
    dashboards may hold a truncation)."""
    with _lock:
        recs = [dict(s) for s in _spans
                if s["trace_id"] == trace_id
                or s["trace_id"].startswith(trace_id)]
    by_id = {s["span_id"]: s for s in recs}
    roots: List[Dict[str, Any]] = []
    for s in recs:
        s.setdefault("children", [])
    for s in recs:
        parent = by_id.get(s["parent_id"]) if s["parent_id"] else None
        if parent is not None and parent is not s:
            parent["children"].append(s)
        else:
            roots.append(s)

    def _sort(nodes: List[Dict[str, Any]]) -> None:
        nodes.sort(key=lambda n: n["start_us"])
        for n in nodes:
            _sort(n["children"])

    _sort(roots)
    return roots


def drain_since(cursor: int) -> Tuple[int, List[Dict[str, Any]]]:
    """Span records buffered after `cursor` (a value this function
    previously returned; start at 0) plus the new cursor. Read-only —
    the caller owns the cursor, so a failed flush can simply retry with
    the old one (ingest() dedupes by span_id)."""
    with _lock:
        dropped = _total - len(_spans)
        start = max(0, cursor - dropped)
        return _total, list(_spans[start:])


def ingest(records: List[Dict[str, Any]]) -> int:
    """Merge span records flushed from another process into this
    buffer (head side of telemetry federation). Deduped by span_id so a
    retried flush is harmless. Returns the number actually added."""
    if not records:
        return 0
    global _total
    added = 0
    with _lock:
        seen = {s["span_id"] for s in _spans}
        for rec in records:
            sid = rec.get("span_id")
            if sid is None or sid in seen:
                continue
            seen.add(sid)
            _spans.append(dict(rec))
            _total += 1
            added += 1
        if len(_spans) > _MAX_SPANS:
            del _spans[: len(_spans) - _MAX_SPANS]
    return added


def clear() -> None:
    with _lock:
        _spans.clear()


def export_to_timeline() -> int:
    """Mirror buffered spans into the chrome-trace timeline (one lane
    per SOURCE process: pid 'trace/<ospid>', tid = trace id prefix) so
    the timeline renders request causality next to task/profiling
    spans — federated spans land in their origin process's lane."""
    from . import timeline

    n = 0
    for s in get_spans():
        timeline.record(
            s["name"], "X", cat="trace", ts_us=s["start_us"],
            dur_us=(s["end_us"] or s["start_us"]) - s["start_us"],
            pid=f"trace/{s['pid']}", tid=s["trace_id"][:8],
            args={"span": s["span_id"], "parent": s["parent_id"],
                  **{k: v for k, v in s["attrs"].items()
                     if isinstance(v, (int, float, str))}},
        )
        n += 1
    return n
