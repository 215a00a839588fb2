"""Node memory monitor: kill the newest retriable task under pressure.

Reference analogue: `src/ray/raylet/worker_killing_policy.cc` +
`memory_monitor.cc` — when host memory crosses a threshold, the raylet
kills the most recently started retriable task's worker so the node
survives and the task resubmits through the normal worker-crash retry
path. Same policy here: the monitor samples host (or cgroup) memory and
calls the pool's ``kill_newest_worker``; the killed task surfaces as
WorkerCrashedError and retries under ``max_retries``.

This guards the HOST side only (pool workers doing decode, data
preprocessing, rollouts). Card memory belongs to the process that owns the
card and its caching allocator; there is no worker to kill there.

The port's copy of ray_tpu/core/memory_monitor.py. The reference also
writes a flight-recorder event before each kill; the flight recorder
waits for ROADMAP A5c, so the port announces the kill on the health plane
alone.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from .config import config, declare
from .logging import get_logger
from .metrics import Counter, Gauge

logger = get_logger("memory_monitor")

declare(
    "memory_monitor_threshold", 0.95,
    "Host memory-used fraction above which the newest pool task is "
    "killed (retries via the worker-crash path). 0 disables the monitor.",
)
declare("memory_monitor_interval_ms", 1000,
        "Milliseconds between memory-monitor samples.")

_m_killed = Counter(
    "memory_monitor_tasks_killed",
    "Pool tasks killed by the memory monitor under host memory pressure.",
)
_m_used_fraction = Gauge(
    "host_memory_used_fraction",
    "Host (or cgroup) memory-used fraction, sampled by the memory "
    "monitor — the health plane's memory_pressure rule reads this.",
)


def system_memory_fraction() -> float:
    """Fraction of memory in use, preferring the cgroup (container) limit
    over the host figure — inside a container /proc/meminfo shows the
    machine, but the OOM killer enforces the cgroup."""
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            limit = f.read().strip()
        if limit != "max":
            with open("/sys/fs/cgroup/memory.current") as f:
                current = int(f.read().strip())
            # memory.current includes page cache the kernel reclaims for
            # free; counting it would OOM-kill healthy IO-heavy workloads
            # (streaming parquet fills the cgroup with cache). Subtract
            # inactive_file, as the reference memory_monitor.cc does.
            inactive_file = 0
            try:
                with open("/sys/fs/cgroup/memory.stat") as f:
                    for line in f:
                        if line.startswith("inactive_file "):
                            inactive_file = int(line.split()[1])
                            break
            except OSError:
                pass
            return max(0, current - inactive_file) / max(1, int(limit))
    except OSError:
        pass
    try:
        total = available = None
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    available = int(line.split()[1])
                if total is not None and available is not None:
                    break
        if total:
            return 1.0 - (available or 0) / total
    except OSError:
        pass
    return 0.0  # no probe available: never trigger


class MemoryMonitor:
    """Samples memory every interval; above threshold calls ``kill_fn``
    (expected: ProcessPool.kill_newest_worker). One kill per sample at
    most — the next sample observes the reclaim before killing again."""

    def __init__(self, kill_fn: Callable[[], Optional[int]],
                 threshold: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 probe: Callable[[], float] = system_memory_fraction):
        self.threshold = (config.memory_monitor_threshold
                          if threshold is None else threshold)
        self.interval_s = (config.memory_monitor_interval_ms / 1000.0
                           if interval_s is None else interval_s)
        self._kill_fn = kill_fn
        self._probe = probe
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="memory-monitor")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                used = self._probe()
            except Exception:  # noqa: BLE001 — a broken probe must not spin
                logger.warning("memory probe failed; monitor disabled",
                               exc_info=True)
                return
            _m_used_fraction.set(used)
            if used < self.threshold:
                continue
            # announce the pressure kill as a health alert BEFORE pulling
            # the trigger: the alert stream should show why the worker died
            try:
                from .health import get_health_plane
                plane = get_health_plane(create=False)
                if plane is not None:
                    plane.inject(
                        "memory_pressure", {"source": "memory_monitor"},
                        used, severity="critical")
            except Exception:  # noqa: BLE001 — alerting must not block the kill
                pass
            pid = self._kill_fn()
            if pid is not None:
                _m_killed.inc()
                logger.warning(
                    "host memory %.0f%% >= %.0f%%: killed newest pool "
                    "task's worker (pid %d); it retries via the "
                    "worker-crash path", used * 100, self.threshold * 100,
                    pid,
                )
            else:
                logger.warning(
                    "host memory %.0f%% >= %.0f%% but no pool task is "
                    "in flight to kill", used * 100, self.threshold * 100,
                )

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
