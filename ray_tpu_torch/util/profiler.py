"""Cluster profiling plane: live stack dumps, sampling CPU profiles,
device-memory accounting, and the goodput ledger.

The port's copy of ray_tpu/util/profiler.py. One deliberate difference:
``device_memory_snapshot()`` reads the CUDA caching allocator where the
reference reads ``jax.live_arrays()`` (see its docstring).

Reference analogue: upstream Ray's dashboard reporter agent (py-spy /
memray endpoints, SURVEY §5.1) — the layer that answers "what is this
worker doing right now?". Pure stdlib by design (the zero-egress image
ships no py-spy): live dumps come from ``sys._current_frames()``,
sampling profiles from a background thread folding those frames into
collapsed-stack (flamegraph) form, and *hung* subprocess workers are
dumped via a ``faulthandler``-registered signal that writes an
all-threads dump into the session's flight directory, where the parent
(the node agent, or the flight recorder's postmortem writer) reads it —
a worker stuck in C or a deadlocked lock cannot answer a mailbox
request, but the kernel still delivers the signal.

Four planes in one module:

- **Stack dumps**: ``dump_stacks()`` / ``format_stacks()`` for the
  calling process; ``install_child_handlers()`` + ``dump_child()`` for
  subprocess gang/actor workers (SIGUSR2 → ``stack-<pid>.txt``).
- **Sampling CPU profiles**: ``SamplingProfiler`` accumulates
  ``func;func;func count`` collapsed stacks at ``profiler_sample_hz``;
  ``merge_collapsed()`` folds per-process profiles into one cluster
  flamegraph. Children toggle theirs via SIGUSR1 (start / stop+write
  ``profile-<pid>.txt``). Control rides the node agent's
  ``profile_start`` / ``profile_fetch`` (the RPC route, the dashboard's
  ``/api/v0/profile/<node>/<pid>`` and ``ray-tpu profile`` wait for
  ROADMAP A5c's network and dashboard slices).
- **Device-memory accounting**: ``device_memory_snapshot()`` reads the
  CUDA caching allocator (``torch.cuda.memory_stats`` / ``mem_get_info``)
  into gauges that federate with heartbeat telemetry (never starts
  CUDA).
- **Goodput ledger**: ``goodput_ledger()`` / ``ledger_from_samples()``
  decompose wall time into compute / data-stall / channel-wait / bubble
  / migration from the metrics the subsystems already export, surfaced
  in the health payload.

The health plane closes the loop: ``install_auto_dump()`` subscribes a
handler that turns a firing ``heartbeat_gap`` / ``data_stall_rising``
alert into a stack dump in the flight recorder and the postmortem
stream.
"""

from __future__ import annotations

import faulthandler
import os
import signal
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from ..core.config import config, declare
from ..core.metrics import Gauge

__all__ = [
    "dump_stacks", "format_stacks", "SamplingProfiler", "merge_collapsed",
    "parse_collapsed", "install_child_handlers", "dump_child",
    "toggle_child_profile", "read_child_profile", "stack_path_for",
    "profile_path_for", "device_memory_snapshot", "update_resource_gauges",
    "goodput_ledger", "ledger_from_samples", "install_auto_dump",
    "start_profile", "fetch_profile", "LEDGER_COMPONENTS",
    "rl_ledger", "rl_ledger_from_samples", "RL_COMPONENTS",
]

declare(
    "profiler_sample_hz", 50.0,
    "Sampling rate (frames/s) of the in-process CPU profiler "
    "(util/profiler.py SamplingProfiler). The sampler only runs while a "
    "profile_start window is open, so idle cost is zero; the bench "
    "profile suite gates the active cost at <=2% serve req/s.",
)
declare(
    "profiler_max_seconds", 60.0,
    "Hard cap on one sampling-profile window; a profile_start with a "
    "longer (or omitted) duration is clamped here so a forgotten "
    "profiler cannot run forever.",
)
declare(
    "profiler_auto_dump", True,
    "Auto-trigger a live stack dump into the flight recorder + "
    "postmortem stream when a sustained stall or heartbeat-gap alert "
    "fires on the health plane (heartbeat_gap, data_stall_rising).",
)
declare(
    "profiler_device_memory", True,
    "Refresh device-memory gauges (the CUDA caching allocator's "
    "bytes-in-use) on each telemetry flush. Never starts CUDA: "
    "processes that have not touched the card pay nothing.",
)

# Federated with heartbeat telemetry (cross_host ships the full registry
# snapshot), so every per-process set lands tagged node_id/role at the head.
_g_cpu = Gauge("host_cpu_used_fraction",
               "Host-wide CPU utilization fraction (busy/total jiffies "
               "delta from /proc/stat between telemetry flushes)")
_g_rss = Gauge("process_rss_bytes",
               "Resident set size of this process (/proc/self/status VmRSS)")
_g_dev_bytes = Gauge("device_memory_bytes_in_use",
                     "Bytes the CUDA caching allocator has handed out per "
                     "local device (torch.cuda.memory_stats), tagged device=")
_g_live_arrays = Gauge("device_live_array_count",
                       "Number of active CUDA allocator blocks held by this "
                       "process")
_g_live_bytes = Gauge("device_live_array_bytes",
                      "Total bytes of active CUDA allocator blocks held by "
                      "this process")
_g_profiler_on = Gauge("profiler_sampling_active",
                       "1 while this process's sampling CPU profiler is "
                       "collecting (profile_start window open)")

# Signals for subprocess workers: USR2 = one-shot all-threads stack dump
# (faulthandler: async-signal-safe, fires even when every Python thread is
# wedged), USR1 = toggle the sampling profiler (start / stop+persist).
_DUMP_SIGNAL = getattr(signal, "SIGUSR2", None)
_PROFILE_SIGNAL = getattr(signal, "SIGUSR1", None)


# ---------------------------------------------------------------------------
# Live stack dumps (in-process)
# ---------------------------------------------------------------------------

def dump_stacks() -> Dict[str, Any]:
    """Snapshot every thread's Python stack in THIS process. Callable from
    any thread (the dispatch handler dumps while task threads hang)."""
    frames = sys._current_frames()
    known = {t.ident: t for t in threading.enumerate()}
    threads: List[Dict[str, Any]] = []
    for ident, frame in frames.items():
        t = known.get(ident)
        stack = traceback.extract_stack(frame)
        threads.append({
            "thread_id": ident,
            "name": t.name if t is not None else f"thread-{ident}",
            "daemon": bool(t.daemon) if t is not None else False,
            "frames": [
                {"file": f.filename, "line": f.lineno, "func": f.name}
                for f in stack
            ],
        })
    threads.sort(key=lambda th: th["name"])
    return {"pid": os.getpid(), "at": time.time(), "threads": threads}


def format_stacks(dump: Dict[str, Any]) -> str:
    """Render a dump_stacks() record the way faulthandler does (newest
    frame last), one block per thread."""
    lines = [f"pid {dump['pid']} at {time.strftime('%H:%M:%S', time.localtime(dump['at']))} "
             f"({len(dump['threads'])} threads)"]
    for th in dump["threads"]:
        daemon = " daemon" if th["daemon"] else ""
        lines.append(f"Thread {th['thread_id']} ({th['name']}{daemon}):")
        for fr in th["frames"]:
            lines.append(f'  File "{fr["file"]}", line {fr["line"]}, '
                         f'in {fr["func"]}')
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Sampling CPU profiler (collapsed-stack / flamegraph form)
# ---------------------------------------------------------------------------

def _frame_label(frame) -> str:
    code = frame.f_code
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


class SamplingProfiler:
    """Wall-clock sampler: a daemon thread snapshots every OTHER thread's
    stack `hz` times per second and folds each into a root-first
    ``file:func;file:func;... -> count`` collapsed entry (the flamegraph
    wire format). Zero cost while stopped."""

    def __init__(self, hz: Optional[float] = None):
        self.hz = float(hz or config.profiler_sample_hz)
        self._collapsed: Dict[str, int] = {}
        self._samples = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_at = 0.0
        self._deadline = 0.0

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self, duration_s: Optional[float] = None) -> None:
        if self.running:
            return
        cap = float(config.profiler_max_seconds)
        dur = min(float(duration_s), cap) if duration_s else cap
        self._stop.clear()
        self._started_at = time.monotonic()
        self._deadline = self._started_at + dur
        self._thread = threading.Thread(
            target=self._loop, name="ray-tpu-profiler", daemon=True)
        self._thread.start()
        _g_profiler_on.set(1)

    def _loop(self) -> None:
        period = 1.0 / max(self.hz, 1.0)
        me = threading.get_ident()
        while not self._stop.is_set() and time.monotonic() < self._deadline:
            frames = sys._current_frames()
            with self._lock:
                self._samples += 1
                for ident, frame in frames.items():
                    if ident == me:
                        continue
                    parts: List[str] = []
                    f = frame
                    while f is not None:
                        parts.append(_frame_label(f))
                        f = f.f_back
                    parts.reverse()
                    key = ";".join(parts)
                    self._collapsed[key] = self._collapsed.get(key, 0) + 1
            self._stop.wait(period)
        _g_profiler_on.set(0)

    def stop(self) -> Dict[str, int]:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        _g_profiler_on.set(0)
        return self.collapsed()

    def collapsed(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._collapsed)

    @property
    def sample_count(self) -> int:
        with self._lock:
            return self._samples

    def collapsed_text(self) -> str:
        """The `flamegraph.pl` wire form: one `stack count` line each."""
        with self._lock:
            items = sorted(self._collapsed.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        return "\n".join(f"{stack} {count}" for stack, count in items)


def parse_collapsed(text: str) -> Dict[str, int]:
    """Inverse of collapsed_text(): `stack count` lines -> dict."""
    out: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, count = line.rpartition(" ")
        if not stack:
            continue
        try:
            out[stack] = out.get(stack, 0) + int(count)
        except ValueError:
            continue
    return out


def merge_collapsed(*profiles: Dict[str, int]) -> Dict[str, int]:
    """Fold per-process collapsed profiles into one cluster flamegraph —
    identical stacks from different processes simply add, which is the
    point of the shared collapsed form."""
    out: Dict[str, int] = {}
    for p in profiles:
        for stack, count in (p or {}).items():
            out[stack] = out.get(stack, 0) + int(count)
    return out


# Per-process singleton the profile_start/profile_fetch RPCs drive. One
# window at a time: a second start while running is a no-op (idempotent
# retries must not reset the accumulation).
_proc_profiler: Optional[SamplingProfiler] = None
_proc_lock = threading.Lock()


def start_profile(duration_s: Optional[float] = None,
                  hz: Optional[float] = None) -> Dict[str, Any]:
    global _proc_profiler
    with _proc_lock:
        if _proc_profiler is None or not _proc_profiler.running:
            _proc_profiler = SamplingProfiler(hz=hz)
            _proc_profiler.start(duration_s)
        p = _proc_profiler
    return {"pid": os.getpid(), "hz": p.hz, "running": True}


def fetch_profile(stop: bool = True) -> Dict[str, Any]:
    with _proc_lock:
        p = _proc_profiler
    if p is None:
        return {"pid": os.getpid(), "samples": 0, "collapsed": "",
                "running": False}
    if stop:
        p.stop()
    return {"pid": os.getpid(), "samples": p.sample_count,
            "collapsed": p.collapsed_text(), "running": p.running}


# ---------------------------------------------------------------------------
# Subprocess workers: signal-driven dumps + profile toggle
# ---------------------------------------------------------------------------

def stack_path_for(pid: int, session: str) -> str:
    return os.path.join(session, "flight", f"stack-{pid}.txt")


def profile_path_for(pid: int, session: str) -> str:
    return os.path.join(session, "flight", f"profile-{pid}.txt")


_child_stack_file = None          # keep the fd alive: faulthandler needs it
_child_profile_path: Optional[str] = None
_child_profiler: Optional[SamplingProfiler] = None


def install_child_handlers(log_dir: str) -> Optional[str]:
    """Called at subprocess-worker startup (actor_process._child_main /
    process_pool._worker_main), right after flight_recorder.attach:

    - ``faulthandler.enable`` on ``<session>/flight/stack-<pid>.txt`` so
      fatal crashes (SIGSEGV/SIGABRT) leave an all-threads dump the
      postmortem writer can fold in,
    - ``faulthandler.register(SIGUSR2)`` on the same file so the parent
      can dump a LIVE (or hung) worker on demand,
    - a SIGUSR1 toggle for the sampling profiler (start on first signal,
      stop + persist ``profile-<pid>.txt`` on the second).

    Returns the stack-file path, or None when unsupported (no signals on
    the platform, or not the main thread)."""
    global _child_stack_file, _child_profile_path
    if _DUMP_SIGNAL is None or _PROFILE_SIGNAL is None:
        return None
    if threading.current_thread() is not threading.main_thread():
        return None
    try:
        session = os.path.dirname(os.path.abspath(log_dir))
        flight_dir = os.path.join(session, "flight")
        os.makedirs(flight_dir, exist_ok=True)
        path = stack_path_for(os.getpid(), session)
        _child_stack_file = open(path, "w", buffering=1)
        faulthandler.enable(file=_child_stack_file)
        faulthandler.register(_DUMP_SIGNAL, file=_child_stack_file,
                              all_threads=True)
        _child_profile_path = profile_path_for(os.getpid(), session)
        signal.signal(_PROFILE_SIGNAL, _on_profile_signal)
        return path
    except Exception:
        return None


def _on_profile_signal(signum, frame) -> None:
    """SIGUSR1 in a child: toggle the sampler. Runs on the main thread
    between bytecodes — it only flips a thread on/off and writes one
    small file, so it is safe even mid-task."""
    global _child_profiler
    try:
        p = _child_profiler
        if p is None or not p.running:
            _child_profiler = SamplingProfiler()
            _child_profiler.start()
        else:
            p.stop()
            if _child_profile_path:
                tmp = _child_profile_path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(f"# pid={os.getpid()} samples={p.sample_count}\n")
                    f.write(p.collapsed_text() + "\n")
                os.replace(tmp, _child_profile_path)
    except Exception:
        pass  # a broken profiler must never kill the worker


def _wait_for_growth(path: str, size0: int, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if os.path.getsize(path) > size0:
                # one more beat so the writer finishes the block
                time.sleep(0.05)
                return True
        except OSError:
            pass
        time.sleep(0.05)
    return False


def dump_child(pid: int, session: str, timeout_s: float = 5.0) -> str:
    """Stack-dump a subprocess worker from the parent: signal it, then
    read what faulthandler appended to its stack file. Works on a hung
    worker — faulthandler's handler is C code, no GIL needed."""
    if _DUMP_SIGNAL is None:
        raise RuntimeError("stack-dump signal unsupported on this platform")
    path = stack_path_for(pid, session)
    try:
        size0 = os.path.getsize(path)
    except OSError:
        size0 = 0
    os.kill(pid, _DUMP_SIGNAL)
    if not _wait_for_growth(path, size0, timeout_s):
        raise TimeoutError(
            f"pid {pid} wrote no stack dump within {timeout_s}s "
            f"(handlers not installed, or the process is gone)")
    with open(path, "rb") as f:
        f.seek(size0)
        return f.read().decode(errors="replace")


def toggle_child_profile(pid: int) -> None:
    if _PROFILE_SIGNAL is None:
        raise RuntimeError("profile signal unsupported on this platform")
    os.kill(pid, _PROFILE_SIGNAL)


def read_child_profile(pid: int, session: str,
                       timeout_s: float = 5.0) -> str:
    """Stop a child's sampler (second toggle) and read the collapsed
    profile it persists."""
    path = profile_path_for(pid, session)
    try:
        mtime0 = os.path.getmtime(path)
    except OSError:
        mtime0 = 0.0
    toggle_child_profile(pid)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if os.path.getmtime(path) > mtime0 or (
                    mtime0 == 0.0 and os.path.exists(path)):
                with open(path) as f:
                    return f.read()
        except OSError:
            pass
        time.sleep(0.05)
    raise TimeoutError(f"pid {pid} wrote no profile within {timeout_s}s")


# ---------------------------------------------------------------------------
# Device-memory accounting + host CPU/RSS gauges
# ---------------------------------------------------------------------------

def device_memory_snapshot() -> Dict[str, Any]:
    """Per-process device-memory view, gauge-published for telemetry
    federation, from the CUDA caching allocator (the reference reads
    ``jax.live_arrays()`` and each device's ``memory_stats()``).

    ``bytes_in_use`` is the allocator's ``allocated_bytes.all.current``
    (what ``torch.cuda.memory_allocated`` returns), ``peak_bytes_in_use``
    its peak, ``bytes_reserved`` what the cache holds from the driver and
    ``bytes_limit`` the card's total memory; ``live_arrays`` /
    ``live_bytes`` are the allocator's active blocks and their bytes,
    summed over the devices. Never starts CUDA: a process in which
    ``torch.cuda.is_initialized()`` is false (every pool worker and actor
    process) reports zeros at zero cost and opens no device file."""
    out: Dict[str, Any] = {"pid": os.getpid(), "backend": None,
                           "live_arrays": 0, "live_bytes": 0,
                           "devices": []}
    torch = sys.modules.get("torch")
    cuda = getattr(torch, "cuda", None)
    if cuda is None or not cuda.is_initialized():
        _g_live_arrays.set(0)
        _g_live_bytes.set(0)
        return out
    try:
        out["backend"] = "cuda"
        current = cuda.current_device()
        for d in range(cuda.device_count()):
            stats = cuda.memory_stats(d) or {}
            in_use = int(stats.get("allocated_bytes.all.current", 0))
            if d == current:
                limit = int(cuda.mem_get_info(d)[1])
            else:
                # mem_get_info would open a context on a device this
                # process has not used; the properties do not
                limit = int(cuda.get_device_properties(d).total_memory)
            out["devices"].append({
                "device": f"cuda:{d}",
                "bytes_in_use": in_use,
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
                "bytes_limit": limit,
            })
            out["live_arrays"] += int(stats.get("active.all.current", 0))
            out["live_bytes"] += int(stats.get("active_bytes.all.current", 0))
            _g_dev_bytes.set(in_use, {"device": f"cuda:{d}"})
    except Exception:
        pass
    _g_live_arrays.set(out["live_arrays"])
    _g_live_bytes.set(out["live_bytes"])
    return out


def _read_rss_bytes() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


_cpu_prev: Optional[Dict[str, int]] = None
_cpu_lock = threading.Lock()


def _read_proc_stat() -> Optional[Dict[str, int]]:
    try:
        with open("/proc/stat") as f:
            first = f.readline().split()
    except OSError:
        return None
    if not first or first[0] != "cpu":
        return None
    vals = [int(x) for x in first[1:]]
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0)  # idle + iowait
    return {"total": sum(vals), "idle": idle}


def host_cpu_fraction() -> float:
    """Host-wide CPU utilization since the previous call (busy/total
    jiffies delta from /proc/stat). First call establishes the baseline
    and returns 0."""
    global _cpu_prev
    cur = _read_proc_stat()
    if cur is None:
        return 0.0
    with _cpu_lock:
        prev, _cpu_prev = _cpu_prev, cur
    if prev is None:
        return 0.0
    d_total = cur["total"] - prev["total"]
    d_idle = cur["idle"] - prev["idle"]
    if d_total <= 0:
        return 0.0
    return max(0.0, min(1.0, 1.0 - d_idle / d_total))


def update_resource_gauges() -> Dict[str, float]:
    """Refresh the CPU/RSS (and optionally device-memory) gauges. Called
    on every telemetry flush in workers and on head summary renders —
    a handful of /proc reads, cheap enough for the heartbeat path."""
    cpu = host_cpu_fraction()
    rss = _read_rss_bytes()
    _g_cpu.set(cpu)
    _g_rss.set(rss)
    if bool(config.profiler_device_memory):
        device_memory_snapshot()
    return {"host_cpu_used_fraction": cpu, "process_rss_bytes": float(rss)}


# ---------------------------------------------------------------------------
# Goodput / MFU ledger
# ---------------------------------------------------------------------------

LEDGER_COMPONENTS = ("compute", "data_stall", "channel_wait", "bubble",
                     "migration")


def goodput_ledger(wall_s: float, data_stall_s: float = 0.0,
                   channel_wait_s: float = 0.0,
                   bubble_fraction: float = 0.0,
                   migration_s: float = 0.0) -> Dict[str, float]:
    """Decompose `wall_s` of job time into the goodput components. The
    non-compute parts are measured; compute is the remainder (clamped at
    zero — overlapping stalls can over-count, and the ledger says so via
    overcommit_s). Components ALWAYS sum to wall_s exactly."""
    wall_s = max(float(wall_s), 0.0)
    bubble_s = max(0.0, min(1.0, float(bubble_fraction))) * wall_s
    parts = {
        "data_stall": max(float(data_stall_s), 0.0),
        "channel_wait": max(float(channel_wait_s), 0.0),
        "bubble": bubble_s,
        "migration": max(float(migration_s), 0.0),
    }
    overhead = sum(parts.values())
    overcommit = max(0.0, overhead - wall_s)
    if overcommit > 0.0 and overhead > 0.0:
        # stalls measured on concurrent threads can exceed wall time;
        # scale them down proportionally so the ledger stays a partition
        scale = wall_s / overhead
        parts = {k: v * scale for k, v in parts.items()}
        overhead = wall_s
    compute = wall_s - overhead
    ledger = {"wall_seconds": wall_s, "compute": compute, **parts,
              "overcommit_seconds": overcommit,
              "goodput_fraction": (compute / wall_s) if wall_s > 0 else 0.0}
    return ledger


RL_COMPONENTS = ("rollout", "reward", "train", "weight_sync")


def rl_ledger(wall_s: float, rollout_s: float = 0.0, reward_s: float = 0.0,
              train_s: float = 0.0,
              weight_sync_s: float = 0.0) -> Dict[str, float]:
    """Online-RL decomposition of one loop iteration's wall time into
    the RL_COMPONENTS (+ 'other' — coordination the four phases don't
    cover), an exact partition like goodput_ledger: the <5% sync-stall
    claim reads sync_stall_fraction straight off this, measured, not
    asserted. Phases timed on concurrent threads can over-count; they
    are scaled down proportionally (overcommit reported) so the ledger
    stays a partition."""
    wall_s = max(float(wall_s), 0.0)
    parts = {
        "rollout": max(float(rollout_s), 0.0),
        "reward": max(float(reward_s), 0.0),
        "train": max(float(train_s), 0.0),
        "weight_sync": max(float(weight_sync_s), 0.0),
    }
    spent = sum(parts.values())
    overcommit = max(0.0, spent - wall_s)
    if overcommit > 0.0 and spent > 0.0:
        scale = wall_s / spent
        parts = {k: v * scale for k, v in parts.items()}
        spent = wall_s
    return {"wall_seconds": wall_s, **parts,
            "other": wall_s - spent,
            "overcommit_seconds": overcommit,
            "sync_stall_fraction": (parts["weight_sync"] / wall_s
                                    if wall_s > 0 else 0.0)}


def _family_sums(families: List[Dict[str, Any]]) -> Dict[str, float]:
    """Fold a metrics snapshot (registry.snapshot() families, possibly
    merged across nodes) into {family_name: summed value}; histograms
    contribute their _sum series."""
    out: Dict[str, float] = {}
    for fam in families or []:
        name = fam.get("name", "")
        for sname, _tags, value in fam.get("samples", []):
            if sname == name or sname == f"{name}_sum":
                out[name] = out.get(name, 0.0) + float(value)
    return out


def rl_ledger_from_samples(families: List[Dict[str, Any]],
                           wall_s: Optional[float] = None
                           ) -> Dict[str, float]:
    """Build the rl ledger from the rl_phase_seconds{phase=...} family
    rl/online.py exports. Wall defaults to the phases' sum (the loop is
    sequential per iteration); pass the measured wall for a loop that
    overlaps rollout with training."""
    phase: Dict[str, float] = {}
    for fam in families or []:
        if fam.get("name") != "rl_phase_seconds":
            continue
        for sname, tags, value in fam.get("samples", []):
            if sname in ("rl_phase_seconds", "rl_phase_seconds_sum"):
                p = dict(tags or {}).get("phase", "")
                phase[p] = phase.get(p, 0.0) + float(value)
    if wall_s is None:
        wall_s = sum(phase.get(p, 0.0) for p in RL_COMPONENTS)
    return rl_ledger(
        wall_s,
        rollout_s=phase.get("rollout", 0.0),
        reward_s=phase.get("reward", 0.0),
        train_s=phase.get("train", 0.0),
        weight_sync_s=phase.get("weight_sync", 0.0),
    )


def _family_max(families: List[Dict[str, Any]], name: str) -> float:
    best = 0.0
    for fam in families or []:
        if fam.get("name") != name:
            continue
        for sname, _tags, value in fam.get("samples", []):
            if sname in (name, f"{name}_sum"):
                best = max(best, float(value))
    return best


def ledger_from_samples(families: List[Dict[str, Any]],
                        wall_s: Optional[float] = None) -> Dict[str, float]:
    """Build the goodput ledger from the metric families the subsystems
    already export. Wall time defaults to the busiest stage's
    accumulated step time (stages run concurrently, so max — not sum —
    approximates the job's wall clock); bubble uses the pipeline's own
    measured fraction, decomposed per kind (bubble_warmup, bubble_drain,
    bubble_channel_wait, bubble_grad_exchange) from the
    train_pipeline_bubble_seconds counter when the pipeline exported it."""
    sums = _family_sums(families)
    if wall_s is None:
        wall_s = _family_max(families, "train_stage_step_seconds")
    bubble = 0.0
    bubble_kinds: Dict[str, float] = {}
    for fam in families or []:
        if fam.get("name") == "train_pipeline_bubble_fraction":
            vals = [float(v) for _s, _t, v in fam.get("samples", [])]
            if vals:
                bubble = sum(vals) / len(vals)
        elif fam.get("name") == "train_pipeline_bubble_seconds":
            for _s, tags, value in fam.get("samples", []):
                # registry.snapshot() carries tags as [[k, v], ...] pairs;
                # remote telemetry payloads carry dicts — accept both.
                if tags and not isinstance(tags, dict):
                    tags = dict(tags)
                kind = (tags or {}).get("kind", "other")
                key = f"bubble_{kind}"
                bubble_kinds[key] = bubble_kinds.get(key, 0.0) + float(value)
    ledger = goodput_ledger(
        wall_s,
        data_stall_s=sums.get("data_stage_stall_seconds", 0.0),
        channel_wait_s=sums.get("channel_recv_wait_seconds", 0.0),
        bubble_fraction=bubble,
        migration_s=sums.get("serve_kv_migration_seconds", 0.0),
    )
    ledger.update(bubble_kinds)
    return ledger


# ---------------------------------------------------------------------------
# Health-plane loop closure: auto stack dump on stall / heartbeat alerts
# ---------------------------------------------------------------------------

AUTO_DUMP_RULES = frozenset({"heartbeat_gap", "data_stall_rising"})


def install_auto_dump(plane) -> bool:
    """Subscribe a handler on a HealthPlane: a FIRING stall/heartbeat
    alert triggers a live stack dump that lands in the flight-recorder
    ring AND the postmortem stream (flight_recorder.write_auto_dump), so
    the postmortem for a wedged node carries what it was doing. Returns
    whether the handler was installed (profiler_auto_dump gates it)."""
    if not bool(config.profiler_auto_dump):
        return False

    from . import flight_recorder

    def _on_alert(alert: Dict[str, Any]) -> None:
        try:
            if alert.get("state") != "firing":
                return
            if alert.get("rule") not in AUTO_DUMP_RULES:
                return
            dump = dump_stacks()
            text = format_stacks(dump)
            flight_recorder.record(
                "stack_dump", rule=alert.get("rule"),
                labels=dict(alert.get("labels") or {}),
                threads=len(dump["threads"]))
            flight_recorder.write_auto_dump(alert, text)
        except Exception:
            pass  # observability must never break the health loop

    plane.subscribe(_on_alert)
    return True
