"""Runtime concurrency sanitizer: instrumented locks + thread hygiene.

The port's copy of ray_tpu/util/sanitizer.py (the correctness-tooling
plane's runtime layer; the reference's static linter, tools/raylint.py,
waits for ROADMAP A5c). Env-gated — `RAY_TPU_SANITIZE=1` makes
`ray_tpu_torch` swap `threading.Lock`/`threading.RLock` for tracked
wrappers at import time (`maybe_install()`), so every lock the framework
creates afterwards feeds two detectors:

* **Lock-order graph.** Each acquisition while other locks are held adds
  a held→acquired edge to a per-process directed graph. A new edge that
  closes a cycle means two code paths take the same locks in opposite
  orders — a potential deadlock, reported the first time the cycle is
  observed even if the interleaving never actually deadlocks.
* **Hold-time budget.** Releasing a lock held longer than
  `config.sanitize_hold_ms` (blocking work under a lock, caught
  dynamically) records a violation with the lock's
  creation site and the measured hold.

Reports go to the flight recorder (`kind="sanitizer"`, so they land in
crash postmortems), the `sanitizer_reports_total` counter, the logger,
and a bounded in-memory list (`reports()`) that tests assert against.

Off (the default) nothing is patched and the stock primitives are used:
zero overhead. The wrappers keep the `Condition` protocol
(`_is_owned`/`_acquire_restore`/`_release_save`) so `threading.Condition`,
`Event`, `Semaphore`, and `queue.Queue` built on patched primitives keep
working, and `_at_fork_reinit` so a lock held across the forkserver's fork
is reset in the child.

Thread hygiene (`thread_snapshot`/`check_thread_leaks`) backs the
conftest fixture that fails tests leaking non-daemon threads or showing
runaway daemon-thread growth.
"""

from __future__ import annotations

import _thread
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from ..core.config import config
from ..core.logging import get_logger
from ..core.metrics import Counter
from . import flight_recorder

__all__ = [
    "install", "uninstall", "maybe_install", "installed", "reports",
    "clear_reports", "thread_snapshot", "check_thread_leaks",
]

logger = get_logger("sanitizer")

# saved at import time, before any patching
_real_allocate = _thread.allocate_lock
_real_Lock = threading.Lock
_real_RLock = threading.RLock

_reports_total = Counter(
    "sanitizer_reports_total",
    "Concurrency-sanitizer violations observed in this process, by kind",
)

# All mutable sanitizer state is guarded by a REAL lock (never a tracked
# one — the bookkeeping must not feed itself).
_state_lock = _real_allocate()
_graph: Dict[int, set] = {}            # lock id -> lock ids acquired after it
_edges_seen: set = set()               # (before_id, after_id) already recorded
_sites: Dict[int, str] = {}            # lock id -> creation site "file:line"
_cycles_reported: set = set()          # frozenset of lock ids per cycle
_reports: List[Dict[str, Any]] = []
_MAX_REPORTS = 256
_hold_budget_s = 0.1
_installed = False

_tls = threading.local()               # .held: [(lock, t_acquired)], .rdepth: {id: n}


def _caller_site() -> str:
    # the frame that called Lock()/RLock(), skipping this module's own
    for frame in reversed(traceback.extract_stack()[:-1]):
        if frame.filename != __file__:
            return f"{frame.filename}:{frame.lineno}"
    return "<unknown>"


def _held_stack() -> List[Tuple[Any, float]]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _report(kind: str, **data: Any) -> None:
    entry = {"violation": kind, "thread": threading.current_thread().name, **data}
    with _state_lock:
        if len(_reports) < _MAX_REPORTS:
            _reports.append(entry)
    flight_recorder.record("sanitizer", **entry)
    _reports_total.inc(tags={"kind": kind})
    logger.warning("sanitizer %s: %s", kind, data)


def _find_path(src: int, dst: int) -> Optional[List[int]]:
    """DFS path src -> dst in the lock-order graph (caller holds _state_lock)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _graph.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_acquired(lock: Any) -> None:
    held = _held_stack()
    if held:
        lid = lock._san_id
        cycles: List[Dict[str, Any]] = []
        with _state_lock:
            for h, _t in held:
                hid = h._san_id
                if hid == lid or (hid, lid) in _edges_seen:
                    continue
                _edges_seen.add((hid, lid))
                _graph.setdefault(hid, set()).add(lid)
                # the new hid->lid edge closes a cycle iff lid already
                # reaches hid through previously observed orderings
                path = _find_path(lid, hid)
                if path is not None and frozenset(path) not in _cycles_reported:
                    _cycles_reported.add(frozenset(path))
                    sites = [_sites.get(n, "?") for n in path]
                    cycles.append({
                        "cycle": sites + [sites[0]],
                        "new_edge": [_sites.get(hid, "?"), _sites.get(lid, "?")],
                    })
        for c in cycles:  # report AFTER dropping _state_lock (_report re-takes it)
            _report("lock_order_cycle", **c)
    held.append((lock, time.monotonic()))


def _note_released(lock: Any) -> None:
    held = getattr(_tls, "held", None)
    if not held:
        return
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lock:
            _, t0 = held.pop(i)
            dur = time.monotonic() - t0
            if dur > _hold_budget_s:
                _report("lock_hold", site=lock._san_site,
                        held_ms=round(dur * 1000.0, 2),
                        budget_ms=round(_hold_budget_s * 1000.0, 2))
            return


class _TrackedLock:
    """threading.Lock stand-in feeding the lock-order/hold detectors."""

    def __init__(self) -> None:
        self._inner = _real_allocate()
        self._san_id = id(self)
        self._san_site = _caller_site()
        with _state_lock:
            _sites[self._san_id] = self._san_site

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquired(self)
        return ok

    def release(self) -> None:
        _note_released(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # os.register_at_fork consumers (concurrent.futures.thread grabs
        # this attribute at import time) force-reset the lock in the child
        self._inner._at_fork_reinit()
        held = getattr(_tls, "held", None)
        if held:
            held[:] = [(l, t) for l, t in held if l is not self]

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedLock {self._san_site} locked={self.locked()}>"


class _TrackedRLock:
    """threading.RLock stand-in; only the outermost acquire/release of a
    reentrant series is fed to the detectors."""

    def __init__(self) -> None:
        self._inner = _real_RLock()
        self._san_id = id(self)
        self._san_site = _caller_site()
        with _state_lock:
            _sites[self._san_id] = self._san_site

    def _depths(self) -> Dict[int, int]:
        d = getattr(_tls, "rdepth", None)
        if d is None:
            d = _tls.rdepth = {}
        return d

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            d = self._depths()
            n = d.get(self._san_id, 0) + 1
            d[self._san_id] = n
            if n == 1:
                _note_acquired(self)
        return ok

    def release(self) -> None:
        d = self._depths()
        n = d.get(self._san_id, 0) - 1
        if n <= 0:
            d.pop(self._san_id, None)
            _note_released(self)
        else:
            d[self._san_id] = n
        self._inner.release()

    def _at_fork_reinit(self) -> None:
        self._inner._at_fork_reinit()
        self._depths().pop(self._san_id, None)
        held = getattr(_tls, "held", None)
        if held:
            held[:] = [(l, t) for l, t in held if l is not self]

    # Condition protocol (wait() fully releases, then restores)
    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self) -> Any:
        self._depths().pop(self._san_id, None)
        _note_released(self)
        return self._inner._release_save()

    def _acquire_restore(self, state: Any) -> None:
        self._inner._acquire_restore(state)
        self._depths()[self._san_id] = 1
        _note_acquired(self)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedRLock {self._san_site}>"


# ---------------------------------------------------------------------------
# install / inspect
# ---------------------------------------------------------------------------

def install(hold_ms: Optional[float] = None) -> None:
    """Patch threading.Lock/RLock with the tracked wrappers. Locks created
    BEFORE install (interpreter internals, already-built subsystems) stay
    stock — the sanitizer watches what the process builds from here on."""
    global _installed, _hold_budget_s
    _hold_budget_s = float(hold_ms if hold_ms is not None
                           else config.sanitize_hold_ms) / 1000.0
    if _installed:
        return
    threading.Lock = _TrackedLock
    threading.RLock = _TrackedRLock
    _installed = True
    logger.info("concurrency sanitizer installed (hold budget %.0f ms)",
                _hold_budget_s * 1000.0)


def uninstall() -> None:
    global _installed
    threading.Lock = _real_Lock
    threading.RLock = _real_RLock
    _installed = False


def maybe_install() -> bool:
    """Install iff config.sanitize (RAY_TPU_SANITIZE=1). Called from
    ray_tpu_torch/__init__ so the env flag alone arms every process."""
    try:
        enabled = bool(config.sanitize)
    except Exception:
        return False
    if enabled:
        install()
    return _installed


def installed() -> bool:
    return _installed


def reports() -> List[Dict[str, Any]]:
    with _state_lock:
        return list(_reports)


def clear_reports() -> None:
    """Reset report/graph state (tests); installed wrappers stay active."""
    with _state_lock:
        _reports.clear()
        _graph.clear()
        _edges_seen.clear()
        _cycles_reported.clear()


# ---------------------------------------------------------------------------
# thread hygiene (conftest fixture backend)
# ---------------------------------------------------------------------------

def thread_snapshot() -> Dict[str, Any]:
    """Names of live non-daemon threads (minus main) + daemon count."""
    threads = [t for t in threading.enumerate() if t.is_alive()]
    return {
        "nondaemon": sorted(
            t.name for t in threads
            if not t.daemon and t is not threading.main_thread()),
        "daemons": sum(1 for t in threads if t.daemon),
    }


def check_thread_leaks(before: Dict[str, Any],
                       grace_s: float = 1.5,
                       daemon_growth_max: int = 64) -> List[str]:
    """Compare the current thread population against a `before` snapshot.

    New non-daemon threads get `grace_s` to finish (teardown races are
    normal); whatever survives is a leak — the process cannot exit while
    it runs. Daemon growth beyond `daemon_growth_max` flags an unbounded
    spawn pattern (daemons die with the process, but a per-test net gain
    that large means something spawns without reuse or cleanup).
    """
    problems: List[str] = []
    baseline = set(before.get("nondaemon", ()))
    deadline = time.monotonic() + grace_s
    while True:
        now = thread_snapshot()
        leaked = [n for n in now["nondaemon"] if n not in baseline]
        if not leaked or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    if leaked:
        problems.append(
            f"leaked non-daemon thread(s) {leaked}: the process cannot exit "
            f"while they run — join them in teardown or mark them daemon "
            f"with a stop path")
    growth = now["daemons"] - before.get("daemons", 0)
    if growth > daemon_growth_max:
        problems.append(
            f"daemon thread population grew by {growth} (> {daemon_growth_max}) "
            f"during one test: unbounded spawn pattern")
    return problems
