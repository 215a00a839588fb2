"""Log aggregation: tail per-process session logs to the driver + pubsub.

Reference: `python/ray/_private/log_monitor.py` — a per-node process tails
every worker's log files and publishes lines to the driver, prefixed
`(pid=…, ip=…)`. Same shape here: one LogMonitor thread per session tails
`<session>/logs/*` (runtime components and pool workers), emits each line
to a sink (driver stderr by default) with a `(file pid=…)` prefix, and
optionally publishes to the control plane's "logs" pubsub channel (the
reference's remote CLI, `ray-tpu logs --follow --address …`, streams them
over RPC; the CLI waits for ROADMAP A5c's third slice).

The port's copy of ray_tpu/core/log_monitor.py: pool workers write
`worker-<pid>.out` and actor processes `actor-<pid>.out` into the session
log dir (process_pool._redirect_stdio), which is what it tails.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .logging import get_logger, log_dir

logger = get_logger("log_monitor")

LOG_CHANNEL = "logs"

# files the monitor tails; everything a session writes lands in one of these
_SUFFIXES = (".log", ".out", ".err")


def _pid_of(filename: str) -> Optional[str]:
    # convention: <component>-<pid>.log / worker-<pid>.out
    stem = filename.rsplit(".", 1)[0]
    tail = stem.rsplit("-", 1)[-1]
    return tail if tail.isdigit() else None


class LogMonitor:
    """Tails the session log dir; fans lines out to sinks.

    Each record is a dict {"file", "pid", "line"}; the default sink prints
    `(file pid=…) line` to stderr, matching the reference's driver echo."""

    def __init__(
        self,
        directory: Optional[str] = None,
        sink: Optional[Callable[[Dict[str, str]], None]] = None,
        pubsub=None,
        poll_interval: float = 0.25,
        from_start: bool = False,
    ):
        self.directory = directory or log_dir()
        self.sink = sink if sink is not None else self._default_sink
        self.pubsub = pubsub
        self.poll_interval = poll_interval
        self.from_start = from_start
        self._offsets: Dict[str, int] = {}
        self._partial: Dict[str, bytes] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _default_sink(record: Dict[str, str]) -> None:
        import sys

        pid = f" pid={record['pid']}" if record.get("pid") else ""
        print(f"({record['file']}{pid}) {record['line']}",
              file=sys.stderr, flush=True)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "LogMonitor":
        if self._thread is not None:
            return self
        if not self.from_start:
            # start tailing at current EOF: a monitor attached mid-session
            # reports new lines, not history (reference behavior)
            for name, path in self._files():
                try:
                    self._offsets[name] = os.path.getsize(path)
                except OSError:
                    pass
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="log-monitor"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- tailing -------------------------------------------------------------

    def _files(self) -> List[Tuple[str, str]]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return [
            (n, os.path.join(self.directory, n))
            for n in sorted(names)
            if n.endswith(_SUFFIXES)
        ]

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.poll_interval)

    def poll_once(self) -> int:
        """One scan pass; returns the number of lines emitted."""
        emitted = 0
        for name, path in self._files():
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            offset = self._offsets.get(name, 0)
            if size < offset:  # rotated/truncated: restart
                offset = 0
                self._partial.pop(name, None)
            if size == offset:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    data = f.read(size - offset)
            except OSError:
                continue
            self._offsets[name] = size
            data = self._partial.pop(name, b"") + data
            lines = data.split(b"\n")
            if lines and lines[-1]:  # trailing partial line: hold it back
                self._partial[name] = lines[-1]
            for raw in lines[:-1]:
                line = raw.decode("utf-8", errors="replace").rstrip("\r")
                if not line:
                    continue
                record = {"file": name, "pid": _pid_of(name) or "", "line": line}
                try:
                    self.sink(record)
                except Exception:  # noqa: BLE001 — a bad sink must not stop tailing
                    logger.warning("log sink raised", exc_info=True)
                if self.pubsub is not None:
                    try:
                        self.pubsub.publish(LOG_CHANNEL, record)
                    except Exception:  # noqa: BLE001
                        pass
                emitted += 1
        return emitted


def list_log_files(directory: Optional[str] = None) -> List[Dict[str, object]]:
    """Session log inventory for `ray-tpu logs` (name, bytes, mtime)."""
    directory = directory or _latest_log_dir()
    out: List[Dict[str, object]] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for n in names:
        p = os.path.join(directory, n)
        try:
            st = os.stat(p)
        except OSError:
            continue
        out.append({"file": n, "bytes": st.st_size,
                    "mtime": time.strftime("%H:%M:%S", time.localtime(st.st_mtime))})
    return out


def tail_log_file(name: str, n: int = 100,
                  directory: Optional[str] = None) -> List[str]:
    directory = directory or _latest_log_dir()
    path = os.path.join(directory, name)
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(max(0, size - (n + 1) * 512))
        lines = f.read().decode("utf-8", errors="replace").splitlines()
    return lines[-n:]


def _latest_log_dir() -> str:
    base = os.environ.get("RAY_TPU_TMPDIR",
                          os.path.join(tempfile.gettempdir(), "ray_tpu_torch"))
    return os.path.join(base, "session_latest", "logs")
