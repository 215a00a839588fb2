"""Per-process flight recorder → crash postmortems.

A bounded ring of this process's most recent activity — finished trace
spans (via a sink hook in util/tracing), log lines (via a bridge handler
in core/logging), and explicit events (`record()`) — mirrored to an
append-only JSONL file in the session dir. SIGKILL gives a worker no
chance to flush anything, so the mirror is written per entry (line-
buffered, no fsync): whatever the child managed to do in its last few
seconds is already on disk when the parent reaps it.

Reap paths (`process_pool._lane` worker death, `actor_process` crash
detection) call `write_postmortem(pid, cause, ...)`, which folds the
dead worker's mirror ring together with the tail of its redirected
stdout/stderr file into one artifact under `<session>/postmortems/`, so
every `util/chaos.py` kill leaves an inspectable "last 5 seconds"
record. `drain_postmortems` queues fresh artifacts for the head (in the
reference, worker hosts ship them with heartbeat telemetry and the
dashboard serves them at `/api/v0/postmortems`; both wait for ROADMAP
A5c's network and dashboard slices).

Enablement: the in-memory ring and `record()` are always live (a deque
append). `attach()` — called in worker-process entrypoints — adds the
tracing sink and the on-disk mirror; unattached processes pay nothing on
the tracing hot path.

The port's copy of ray_tpu/util/flight_recorder.py.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "record", "attach", "snapshot", "write_postmortem", "write_auto_dump",
    "drain_postmortems", "requeue_postmortems", "list_postmortems",
    "load_postmortem", "mirror_path_for",
]

_lock = threading.Lock()
_ring: deque = deque(maxlen=256)
_mirror_path: Optional[str] = None
_mirror_file = None
_mirror_bytes = 0
_mirror_cap = 262_144
_pending: List[Dict[str, Any]] = []   # artifacts not yet shipped to the head
_reaped: set = set()                  # pids already postmortem'd (dedup)


def _entry(kind: str, data: Dict[str, Any]) -> Dict[str, Any]:
    return {"ts": time.time(), "pid": os.getpid(), "kind": kind, **data}


def record(kind: str, **data: Any) -> None:
    """Append one event to the ring (and the mirror, when attached)."""
    e = _entry(kind, data)
    _ring.append(e)
    if _mirror_file is not None:
        _mirror_write(e)


def _mirror_write(e: Dict[str, Any]) -> None:
    global _mirror_bytes
    try:
        line = json.dumps(e, default=repr) + "\n"
    except Exception:
        return
    with _lock:
        f = _mirror_file
        if f is None:
            return
        try:
            if _mirror_bytes + len(line) > _mirror_cap:
                # rewrite from the ring: the file stays a bounded, current
                # window instead of growing or losing its newest entries
                f.seek(0)
                f.truncate()
                _mirror_bytes = 0
                for old in list(_ring):
                    ol = json.dumps(old, default=repr) + "\n"
                    f.write(ol)
                    _mirror_bytes += len(ol)
            else:
                f.write(line)
                _mirror_bytes += len(line)
            f.flush()
        except (OSError, ValueError):
            pass


def _span_sink(rec: Dict[str, Any]) -> None:
    record("span", name=rec.get("name"), trace_id=rec.get("trace_id"),
           span_id=rec.get("span_id"), start_us=rec.get("start_us"),
           end_us=rec.get("end_us"), attrs=rec.get("attrs"))


def on_log(line: str) -> None:
    """Bridge target for core/logging's flight handler."""
    record("log", line=line)


def mirror_path_for(pid: int, session: Optional[str] = None) -> str:
    if session is None:
        from ..core.logging import session_dir
        session = session_dir()
    return os.path.join(session, "flight", f"flight-{pid}.jsonl")


def attach(log_dir: str = "", component: str = "") -> None:
    """Enable the tracing sink and the on-disk mirror for this process.

    Called from worker-process entrypoints with the parent's log dir (the
    same one stdout/stderr redirect into), so parent and child agree on
    the session root without any extra protocol."""
    global _mirror_path, _mirror_file, _mirror_bytes, _mirror_cap, _ring
    try:
        from ..core.config import config
        _ring = deque(_ring, maxlen=int(config.get("flight_recorder_entries")))
        _mirror_cap = int(config.get("flight_recorder_bytes"))
    except Exception:
        pass
    from . import tracing
    tracing._flight_sink = _span_sink
    if log_dir:
        session = os.path.dirname(os.path.abspath(log_dir))
    else:
        from ..core.logging import session_dir
        session = session_dir()
    path = mirror_path_for(os.getpid(), session)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with _lock:
            _mirror_file = open(path, "w")
            _mirror_path = path
            _mirror_bytes = 0
    except OSError:
        return
    record("attach", component=component)


def snapshot() -> List[Dict[str, Any]]:
    return list(_ring)


# -- reaper side ------------------------------------------------------------

def _tail_lines(path: str, n: int = 50, max_bytes: int = 65_536) -> List[str]:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            data = f.read().decode("utf-8", "replace")
    except OSError:
        return []
    return data.splitlines()[-n:]


def write_postmortem(pid: int, cause: str, exitcode: Optional[int] = None,
                     session: Optional[str] = None,
                     stdout_hint: str = "") -> Optional[str]:
    """Fold a dead worker's flight mirror + stdout tail into one artifact.

    `stdout_hint` names the redirect file the worker wrote ("actor" or
    "worker" prefix); both are probed when empty. Returns the artifact
    path (None if this pid was already reaped — crash detection can fire
    from more than one thread)."""
    with _lock:
        if pid in _reaped:
            return None
        _reaped.add(pid)
    if session is None:
        from ..core.logging import session_dir
        session = session_dir()
    entries: List[Dict[str, Any]] = []
    mirror = mirror_path_for(pid, session)
    for raw in _tail_lines(mirror, n=512):
        try:
            entries.append(json.loads(raw))
        except ValueError:
            continue
    stdout_tail: List[str] = []
    prefixes = [stdout_hint] if stdout_hint else ["actor", "worker"]
    for prefix in prefixes:
        out = os.path.join(session, "logs", f"{prefix}-{pid}.out")
        if os.path.exists(out):
            stdout_tail = _tail_lines(out)
            break
    # final stack dump: util/profiler registers faulthandler in worker
    # children (fatal-signal dumps + SIGUSR2 on demand), appending to
    # <session>/flight/stack-<pid>.txt — whatever it last wrote is the
    # dead worker's final all-threads traceback
    stack_dump: List[str] = []
    try:
        from . import profiler
        stack_dump = _tail_lines(profiler.stack_path_for(pid, session), n=120)
    except Exception:  # noqa: BLE001 — reaping must not fail on the extras
        pass
    art = {
        "pid": pid,
        "cause": cause,
        "exitcode": exitcode,
        "written_at": time.time(),
        "spans": [e for e in entries if e.get("kind") == "span"],
        "logs": [e.get("line", "") for e in entries if e.get("kind") == "log"],
        "events": [e for e in entries if e.get("kind") not in ("span", "log")],
        "stdout_tail": stdout_tail,
        "stack_dump": stack_dump,
    }
    pm_dir = os.path.join(session, "postmortems")
    path = os.path.join(pm_dir, f"postmortem-{pid}-{int(art['written_at'])}.json")
    try:
        os.makedirs(pm_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(art, f, default=repr)
    except OSError:
        path = ""
    with _lock:
        _pending.append(art)
        del _pending[:-20]  # a reap storm must not bloat heartbeats
    try:
        from . import timeline
        timeline.record(f"postmortem:{cause}", ph="i", cat="postmortem",
                        args={"pid": pid, "exitcode": exitcode, "path": path})
    except Exception:
        pass
    return path or None


def write_auto_dump(alert: Dict[str, Any], stack_text: str,
                    session: Optional[str] = None) -> Optional[str]:
    """Persist a health-alert-triggered stack dump of THIS process as a
    postmortem-stream artifact (util/profiler.install_auto_dump is the
    caller). Unlike write_postmortem the process is alive — no reap dedup;
    the artifact rides the same `_pending` queue so it federates to the
    head and shows at /api/v0/postmortems like any crash record."""
    if session is None:
        from ..core.logging import session_dir
        session = session_dir()
    pid = os.getpid()
    art = {
        "pid": pid,
        "cause": f"auto_dump:{alert.get('rule', 'alert')}",
        "exitcode": None,
        "written_at": time.time(),
        "alert": {k: alert.get(k) for k in ("rule", "state", "labels",
                                            "value", "node")},
        "stack_dump": (stack_text or "").splitlines()[-200:],
    }
    pm_dir = os.path.join(session, "postmortems")
    path = os.path.join(pm_dir, f"autodump-{pid}-{int(art['written_at'])}.json")
    try:
        os.makedirs(pm_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(art, f, default=repr)
    except OSError:
        path = ""
    with _lock:
        _pending.append(art)
        del _pending[:-20]
    return path or None


def drain_postmortems() -> List[Dict[str, Any]]:
    """Artifacts written by this process since the last drain (shipped to
    the head with heartbeat telemetry; a failed flush requeues them via
    `requeue_postmortems`)."""
    with _lock:
        out, _pending[:] = list(_pending), []
    return out


def requeue_postmortems(arts: List[Dict[str, Any]]) -> None:
    """Put drained artifacts back after a failed telemetry flush."""
    if not arts:
        return
    with _lock:
        _pending[:0] = arts
        del _pending[:-20]


def list_postmortems(session: Optional[str] = None) -> List[str]:
    if session is None:
        from ..core.logging import session_dir
        session = session_dir()
    pm_dir = os.path.join(session, "postmortems")
    try:
        names = sorted(os.listdir(pm_dir))
    except OSError:
        return []
    return [os.path.join(pm_dir, n) for n in names if n.endswith(".json")]


def load_postmortem(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
