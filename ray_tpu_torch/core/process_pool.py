"""Cross-process worker pool: CPU tasks in forked processes, shm object plane.

The role of the reference's per-node worker processes (upstream ray
`src/ray/raylet/worker_pool.cc :: WorkerPool` + plasma `client.cc`): user
code runs OUTSIDE the runtime's address space, so a segfaulting or leaking
task kills one worker process — not the node. The device split (node_agent.py
docstring): device tasks stay on threads inside the process that owns the
card; CPU-only tasks route here when `worker_processes` > 0.

Data plane: function+args and returns are pickled with protocol 5;
out-of-band buffers (numpy arrays) travel as separate sealed objects in the
C++ shared-memory store (shm_store.py), so large arrays cross the process
boundary zero-copy. Payloads that exceed the arena fall back to the control
pipe. Functions are serialized with cloudpickle (closures, lambdas).

Crash semantics: a worker that dies mid-task fails ONLY that task
(WorkerCrashedError -> normal retry path); the pool respawns the worker.

The port's copy of ray_tpu/core/process_pool.py. Workers fork from the
multiprocessing forkserver only: nothing may fork the process that owns
the card, and the forkserver itself runs no torch op. CUDA never starts in
a worker: a payload that holds a tensor off the CPU cannot cross
(TaskNotSerializableError), so the node agent runs that task in its own
process and counts it as a fallback. Refs and actor handles cross when the
head serves its control plane over RPC: each task carries the head's
address (RAY_TPU_HEAD_ADDRESS), and the worker resolves them through the
back-channel (api._pool_worker_client, core/worker_api.py); without one
they keep their task in-process. Each worker attaches the flight recorder and
the profiler's signal handlers at start, and a worker that dies while
running a task leaves a postmortem (util/flight_recorder).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import queue
import signal
import sys
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import multiprocessing as mp

import cloudpickle

from .logging import get_logger

logger = get_logger("process_pool")

_POOL_ARENA_BYTES = 256 << 20
_ID_SIZE = 20
_PRELOAD = "ray_tpu_torch.core._pdeathsig"


class WorkerProcessCrash(RuntimeError):
    """The worker process executing the task died."""


class TaskNotSerializableError(RuntimeError):
    """The task (fn/args) cannot cross the process boundary; callers may
    fall back to in-process execution."""


# Runtime-handle types (ObjectRef, ActorHandle) pickle by id and would
# resolve against a NEW runtime inside a worker process — silently wrong
# without an RPC back-channel. Registered by the node agent; their presence
# anywhere in a task payload forces in-process execution.
_INLINE_ONLY_TYPES: tuple = ()


def register_inline_only_types(*types: type) -> None:
    global _INLINE_ONLY_TYPES
    _INLINE_ONLY_TYPES = tuple(set(_INLINE_ONLY_TYPES + types))


def _off_cpu(obj) -> bool:
    """True for a torch tensor or storage that lives off the CPU (CUDA; the
    `meta` device stands in for it in the tests). Unpickling one in a
    worker would start CUDA there, so it never crosses."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    if isinstance(obj, torch.TypedStorage):
        obj = obj._untyped_storage
    if isinstance(obj, (torch.Tensor, torch.UntypedStorage)):
        return obj.device.type != "cpu"
    return False


class _TaskPickler(cloudpickle.CloudPickler):
    def reducer_override(self, obj):
        if _INLINE_ONLY_TYPES and isinstance(obj, _INLINE_ONLY_TYPES):
            # With a head back-channel (worker_api), refs and handles ARE
            # resolvable inside worker/actor processes — let them cross.
            # Without one they would re-resolve against a meaningless
            # private runtime: keep the strict inline-only contract.
            if not os.environ.get("RAY_TPU_HEAD_ADDRESS"):
                raise TaskNotSerializableError(
                    f"{type(obj).__name__} cannot cross the process boundary "
                    "(no head back-channel; start the head with "
                    "system_config={'control_plane_rpc_port': 0})")
        if _off_cpu(obj):
            raise TaskNotSerializableError(
                f"a {type(obj).__name__} on {obj.device} cannot cross the process "
                "boundary: CUDA never starts in a worker process")
        return super().reducer_override(obj)


def _cloudpickle_dumps(obj: Any, protocol: int = 5, buffer_callback=None) -> bytes:
    import io

    buf = io.BytesIO()
    _TaskPickler(buf, protocol=protocol, buffer_callback=buffer_callback).dump(obj)
    return buf.getvalue()


def _oid(tag: bytes) -> bytes:
    return (tag + uuid.uuid4().bytes)[:_ID_SIZE].ljust(_ID_SIZE, b"\0")


# ---------------------------------------------------------------------------
# shm-backed pickle transport
# ---------------------------------------------------------------------------


def _dump(store, obj: Any, *, use_cloudpickle: bool) -> Tuple[bytes, List[bytes], Optional[bytes]]:
    """-> (payload_or_empty, buffer_ids, inline_payload).

    Pickles with protocol 5; each out-of-band buffer is sealed as its own shm
    object. If the store can't take a buffer (arena full / too big), fall
    back to fully-inline pickling (buffers in-band through the pipe)."""
    buffers: List[pickle.PickleBuffer] = []
    dumps = _cloudpickle_dumps if use_cloudpickle else pickle.dumps

    def inline(o):
        # pickling-phase failures (any exception type — reducers can raise
        # ValueError, NotImplementedError, ...) classify as not-serializable
        # so callers may fall back in-process; infra errors stay distinct.
        try:
            return dumps(o, protocol=5)
        except TaskNotSerializableError:
            raise
        except Exception as e:
            raise TaskNotSerializableError(repr(e)) from e

    try:
        payload = dumps(obj, protocol=5, buffer_callback=buffers.append)
    except TaskNotSerializableError:
        raise  # inline retry would serialize everything again just to re-raise
    except Exception:
        # some object rejects out-of-band buffering; go fully inline
        return b"", [], inline(obj)
    buffer_ids: List[bytes] = []
    try:
        for buf in buffers:
            bid = _oid(b"b")
            store.put(bid, buf.raw())  # raw(): flat C-contiguous byte view
            buffer_ids.append(bid)
    except Exception:
        for bid in buffer_ids:
            try:
                store.delete(bid)
            except Exception:
                pass
        return b"", [], inline(obj)
    return payload, buffer_ids, None


def _copy_out(store, buffer_ids: List[bytes]) -> List[bytes]:
    """Copy each sealed buffer out of the arena while it is pinned; the
    copies outlive the pins (the lane deletes the buffers right after)."""
    pinned: List[bytes] = []
    try:
        bufs = []
        for bid in buffer_ids:
            view = store.get_view(bid)
            if view is None:
                raise WorkerProcessCrash(f"shm buffer {bid.hex()[:8]} missing")
            pinned.append(bid)
            bufs.append(bytes(view))
        return bufs
    finally:
        for bid in pinned:
            store.release(bid)


def _load(store, payload: bytes, buffer_ids: List[bytes], inline: Optional[bytes]) -> Any:
    if inline is not None:
        return pickle.loads(inline)
    return pickle.loads(payload, buffers=_copy_out(store, buffer_ids))


def _load_sealed(store, payload: bytes, buffer_ids: List[bytes],
                 inline: Optional[bytes]):
    """Like _load, but hands back a store-ready SealedBytes instead of
    deserializing: the object store gives each consumer a private copy at
    get() time, so deserializing here would only add a redundant
    pickle round-trip. Out-of-band shm buffers are copied out once."""
    from .object_store import SealedBytes

    if inline is not None:
        return SealedBytes(inline)
    return SealedBytes(payload, _copy_out(store, buffer_ids))


def _cleanup_buffers(store, buffer_ids: List[bytes]) -> None:
    for bid in buffer_ids:
        try:
            store.delete(bid)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------


_main_guard = threading.Lock()


def _mp_context():
    """forkserver: the server forks each worker from a clean process that
    never saw driver state or the card (nothing forks the process that owns
    it), and unlike spawn it does not re-import the driver's __main__ in
    every worker. Shared by the task pool and actor processes. There is no
    fallback to another start method."""
    ctx = mp.get_context("forkserver")
    # the preload import arms the parent-death watchdog inside the
    # forkserver: a SIGKILLed runtime must not orphan the server +
    # resource-tracker daemons
    ctx.set_forkserver_preload([_PRELOAD])
    return ctx


@contextlib.contextmanager
def _suppress_main_reimport():
    """Stop multiprocessing from re-running the driver's __main__ in workers.

    mp's spawn/forkserver preparation re-executes the parent's main module in
    every child — which crashes outright when the driver is <stdin>/REPL and
    re-runs script side effects otherwise (a script that drives the card
    would run again in each worker). Workers here never need driver
    state: functions arrive by value via cloudpickle (main-module functions
    included).

    Mechanism: swap a BLANK module in as sys.modules['__main__'] while
    start() computes the preparation data (it reads main via sys.modules).
    Crucially this does NOT mutate the real main module: driver code that is
    concurrently executing resolves `__file__`/globals through its own frame
    globals (the real module's dict), so background worker prestart cannot
    race the driver's top-level code."""
    main = sys.modules.get("__main__")
    if main is None:
        yield
        return
    import types

    with _main_guard:
        blank = types.ModuleType("__main__")
        blank.__spec__ = None  # no spec + no file => child skips main fixup
        sys.modules["__main__"] = blank
        try:
            yield
        finally:
            sys.modules["__main__"] = main


def _redirect_stdio(log_dir: str, kind: str) -> None:
    """Send the child's stdout and stderr to the PARENT's session log dir
    (<kind>-<pid>.out); the dir is passed in because session_dir() in the
    child would mint a fresh session. Best-effort."""
    if not log_dir:
        return
    try:
        path = os.path.join(log_dir, f"{kind}-{os.getpid()}.out")
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        os.close(fd)
        sys.stdout = os.fdopen(1, "w", buffering=1, closefd=False)
        sys.stderr = os.fdopen(2, "w", buffering=1, closefd=False)
    except OSError:
        pass


def _worker_main(store_name: str, req_q, resp_q, log_dir: str = "") -> None:
    """Entry point of a forked worker."""
    from ._pdeathsig import set_pdeathsig
    from .shm_store import ShmObjectStore

    set_pdeathsig()  # die with the forkserver/runtime, never orphan

    # Runtime API calls inside a pool worker would _auto_init a PRIVATE
    # runtime whose refs/handles are meaningless to the parent; api.py
    # checks this flag and raises a clear error instead.
    os.environ["RAY_TPU_IN_POOL_WORKER"] = "1"
    _redirect_stdio(log_dir, "worker")
    try:
        # flight recorder: mirror recent spans/logs/events to disk so a
        # SIGKILL (chaos, memory monitor) still leaves a postmortem
        from ..util import flight_recorder

        flight_recorder.attach(log_dir, "worker")
    except Exception:  # noqa: BLE001 — observability must not block startup
        pass
    try:
        # profiling plane: SIGUSR2 → all-threads stack dump (faulthandler —
        # fires even when this loop is wedged in user code), SIGUSR1 →
        # toggle the sampling profiler (util/profiler)
        from ..util import profiler

        profiler.install_child_handlers(log_dir)
    except Exception:  # noqa: BLE001 — observability must not block startup
        pass
    store = ShmObjectStore(store_name, create=False)
    while True:
        item = req_q.get()
        if item is None:
            return
        task_tag, payload, buffer_ids, inline = item
        try:
            fn, args, kwargs, renv, head_addr = _load(
                store, payload, buffer_ids, inline)
            # per-TASK, not per-fork: the forkserver snapshots the
            # environment at ITS start, so a fork-time address would be
            # stale (or absent) whenever runtimes cycle in one parent —
            # the back-channel (api._pool_worker_client) needs the address
            # of the head that submitted THIS task
            if head_addr:
                os.environ["RAY_TPU_HEAD_ADDRESS"] = head_addr
            else:
                os.environ.pop("RAY_TPU_HEAD_ADDRESS", None)
            from .runtime_env import applied

            with applied(renv):
                out = fn(*args, **kwargs)
            r_payload, r_bufs, r_inline = _dump(store, out, use_cloudpickle=False)
            resp_q.put((task_tag, True, r_payload, r_bufs, r_inline))
        except BaseException as e:  # noqa: BLE001 — user task may raise anything
            try:
                err = cloudpickle.dumps(e)
            except Exception:
                err = cloudpickle.dumps(RuntimeError(repr(e)))
            resp_q.put((task_tag, False, err, [], None))


@dataclass
class _Worker:
    proc: mp.process.BaseProcess
    req_q: Any
    resp_q: Any


class ProcessPool:
    """N forked worker processes sharing one shm arena with the parent."""

    def __init__(self, num_workers: int, store_name: Optional[str] = None):
        from .shm_store import ShmObjectStore

        self.num_workers = max(1, num_workers)
        self.store_name = store_name or f"/rtt_pool_{os.getpid()}_{uuid.uuid4().hex[:6]}"
        self.store = ShmObjectStore(
            self.store_name, capacity=_POOL_ARENA_BYTES, max_objects=8192
        )
        self._ctx = _mp_context()
        self._tasks: "queue.Queue[Optional[Tuple]]" = queue.Queue()
        self._closed = threading.Event()
        self._submit_lock = threading.Lock()
        self._inflight: dict = {}  # lane index -> (worker pid, start time)
        self._inflight_lock = threading.Lock()
        self._lane_pids: dict = {}  # lane index -> last spawned worker pid
        self._mem_monitor = None
        self._threads: List[threading.Thread] = []
        for i in range(self.num_workers):
            t = threading.Thread(
                target=self._lane, args=(i,), daemon=True, name=f"pool-lane-{i}"
            )
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------------------ api

    def run(self, fn: Callable, args: tuple, kwargs: dict,
            timeout: Optional[float] = None, sealed: bool = False,
            runtime_env: Optional[dict] = None) -> Any:
        """Execute fn(*args, **kwargs) in a worker process; blocks the calling
        thread. Raises WorkerProcessCrash if the worker dies, or the task's
        own exception. sealed=True returns the worker's pickled result as a
        store-ready SealedBytes without deserializing it in this process
        (the caller's store hands each consumer a private copy on get)."""
        done = threading.Event()
        box: List[Any] = [None, None]  # (ok, value_or_error)

        def complete(ok: bool, value: Any) -> None:
            box[0], box[1] = ok, value
            done.set()

        # submit under the close lock: a task can never be enqueued after
        # close() drained the queue (it would strand this caller forever).
        # WorkerProcessCrash (not RuntimeError) so callers keep the normal
        # system-failure retry path when a node stop races a submission.
        with self._submit_lock:
            if self._closed.is_set():
                raise WorkerProcessCrash("process pool is closed")
            self._tasks.put((fn, args, kwargs, complete, sealed, runtime_env))
        if not done.wait(timeout):
            raise TimeoutError("process-pool task timed out")
        if box[0]:
            return box[1]
        raise box[1]

    def kill_newest_worker(self) -> Optional[int]:
        """Kill the worker process running the NEWEST in-flight task (the
        memory monitor's victim policy, matching the reference: newest =
        least progress lost, and its task retries via the normal
        worker-crash path). Returns the killed pid, or None when no task
        is in flight."""
        with self._inflight_lock:
            if not self._inflight:
                return None
            lane, (pid, t0) = max(self._inflight.items(),
                                  key=lambda kv: kv[1][1])
        # The victim may finish (and its lane restart a new worker — or the
        # OS may even reuse the pid) between choosing it and signalling:
        # re-verify the SAME (pid, start time) still holds the lane right
        # before SIGKILL, under the lock so _lane can't swap it mid-check.
        with self._inflight_lock:
            if self._inflight.get(lane) != (pid, t0):
                return None
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                return None
        return pid

    def ensure_memory_monitor(self) -> None:
        """Start the node memory monitor once per pool (idempotent); it
        kills the newest pool task under host memory pressure. Stopped by
        close()."""
        with self._submit_lock:
            if self._mem_monitor is None and not self._closed.is_set():
                from .memory_monitor import MemoryMonitor

                monitor = MemoryMonitor(self.kill_newest_worker)
                if monitor.enabled:
                    monitor.start()
                    self._mem_monitor = monitor

    def close(self) -> None:
        if self._mem_monitor is not None:
            self._mem_monitor.stop()
            self._mem_monitor = None
        with self._submit_lock:
            if self._closed.is_set():
                return
            self._closed.set()
            for _ in self._threads:
                self._tasks.put(None)
        all_joined = True
        for t in self._threads:
            t.join(timeout=5)
            all_joined = all_joined and not t.is_alive()
        # lanes exit at the top-of-loop closed check without draining: fail
        # anything still queued so no caller blocks in done.wait() forever
        while True:
            try:
                item = self._tasks.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[3](False, WorkerProcessCrash("process pool closed"))
        # a lane that outlived the join (task >5s) still holds the store;
        # leak the mapping rather than hand it a dead handle, but unlink
        # its name so the segment goes with the last mapping
        if all_joined:
            try:
                self.store.close()
            except Exception:
                pass
        else:
            self.store.unlink_name()

    # ------------------------------------------------------------ internals

    def _spawn(self) -> _Worker:
        req_q = self._ctx.Queue()
        resp_q = self._ctx.Queue()
        from .logging import log_dir

        proc = self._ctx.Process(
            target=_worker_main,
            args=(self.store_name, req_q, resp_q, log_dir()),
            daemon=True,
        )
        with _suppress_main_reimport():
            proc.start()
        return _Worker(proc, req_q, resp_q)

    def worker_pids(self) -> List[int]:
        """Pids of the pool's live worker processes. Dead lanes' stale pids
        are filtered with a 0-signal probe."""
        with self._inflight_lock:
            pids = list(self._lane_pids.values())
        alive = []
        for pid in pids:
            try:
                os.kill(pid, 0)
                alive.append(pid)
            except OSError:
                pass
        return alive

    def _lane(self, index: int) -> None:
        """One parent thread drives one worker process: ship task, await
        response or death. Worker death fails only the in-flight task."""
        # prestart (reference: worker_pool.cc prestarts workers): spawning
        # here, before the first task arrives, moves the forkserver cost
        # off the first submission's critical path
        worker: Optional[_Worker] = None
        try:
            worker = self._spawn()
        except Exception:  # noqa: BLE001 — retried lazily per task below
            worker = None
        if worker is not None:
            with self._inflight_lock:
                self._lane_pids[index] = worker.proc.pid
        while not self._closed.is_set():
            item = self._tasks.get()
            if item is None:
                break
            fn, args, kwargs, complete, sealed, renv = item
            if worker is None or not worker.proc.is_alive():
                try:
                    worker = self._spawn()
                except Exception as e:  # noqa: BLE001 — surfaced to the caller
                    worker = None
                    complete(False, WorkerProcessCrash(f"cannot start a worker: {e!r}"))
                    continue
                with self._inflight_lock:
                    self._lane_pids[index] = worker.proc.pid
            tag = uuid.uuid4().hex
            try:
                payload, buffer_ids, inline = _dump(
                    self.store,
                    (fn, args, kwargs, renv,
                     os.environ.get("RAY_TPU_HEAD_ADDRESS", "")),
                    use_cloudpickle=True)
            except TaskNotSerializableError as e:
                # genuinely unpicklable task (see _dump's phase-based
                # classification): callers may fall back in-process
                complete(False, TaskNotSerializableError(repr(e)))
                continue
            except Exception as e:
                # store/infrastructure failure — NOT a serialization problem;
                # surface it so pool degradation is visible
                logger.warning("pool transport failure: %r", e)
                complete(False, WorkerProcessCrash(f"pool transport failure: {e!r}"))
                continue
            with self._inflight_lock:
                self._inflight[index] = (worker.proc.pid, time.monotonic())
            worker.req_q.put((tag, payload, buffer_ids, inline))
            resp = None
            while resp is None:
                try:
                    resp = worker.resp_q.get(timeout=0.05)
                except queue.Empty:
                    if not worker.proc.is_alive():
                        break
                    if self._closed.is_set():
                        break
            with self._inflight_lock:
                self._inflight.pop(index, None)
            _cleanup_buffers(self.store, buffer_ids)
            if resp is None:
                code = worker.proc.exitcode
                if not self._closed.is_set():
                    # reap the crash into a postmortem artifact (flight
                    # mirror + stdout tail); pool teardown is not a crash
                    try:
                        from ..util import flight_recorder

                        flight_recorder.write_postmortem(
                            worker.proc.pid,
                            "worker process died while running task",
                            exitcode=code, stdout_hint="worker")
                    except Exception:  # noqa: BLE001 — must not mask the crash
                        pass
                # the payload may sit unread in the dead worker's queue:
                # its feeder must not be joined at interpreter exit
                worker.req_q.cancel_join_thread()
                worker = None  # respawn lazily for the next task
                complete(
                    False,
                    WorkerProcessCrash(
                        f"worker process died (exitcode {code}) while running task"
                    ),
                )
                continue
            rtag, ok, r_payload, r_bufs, r_inline = resp
            if rtag != tag:  # stale response from a previous crash window
                complete(False, WorkerProcessCrash("worker desynchronized"))
                worker.req_q.cancel_join_thread()
                worker.proc.terminate()
                worker = None
                continue
            try:
                if ok and sealed:
                    complete(True, _load_sealed(self.store, r_payload, r_bufs, r_inline))
                elif ok:
                    complete(True, _load(self.store, r_payload, r_bufs, r_inline))
                else:
                    complete(False, pickle.loads(r_payload))
            except Exception as e:
                complete(False, e)
            finally:
                _cleanup_buffers(self.store, r_bufs)
        if worker is not None and worker.proc.is_alive():
            try:
                worker.req_q.put(None)
                worker.proc.join(timeout=2)
                if worker.proc.is_alive():
                    worker.req_q.cancel_join_thread()
                    worker.proc.terminate()
                    worker.proc.join(timeout=2)
                if worker.proc.is_alive():
                    worker.proc.kill()
                    worker.proc.join(timeout=2)
            except Exception:
                pass


# ---------------------------------------------------------------------------
# process-wide shared pool
# ---------------------------------------------------------------------------
# Virtual nodes share one OS process, so per-agent pools would multiply
# worker processes and /dev/shm arenas for no isolation gain. Agents acquire
# a refcounted singleton instead; the last release closes it.

_shared_lock = threading.Lock()
_shared_pool: Optional[ProcessPool] = None
_shared_refs = 0


def acquire_shared_pool(num_workers: int) -> ProcessPool:
    global _shared_pool, _shared_refs
    with _shared_lock:
        if _shared_pool is None:
            _shared_pool = ProcessPool(num_workers)
            _shared_refs = 0
        _shared_refs += 1
        return _shared_pool


def release_shared_pool() -> None:
    global _shared_pool, _shared_refs
    with _shared_lock:
        if _shared_pool is None:
            return
        _shared_refs -= 1
        if _shared_refs > 0:
            return
        pool, _shared_pool = _shared_pool, None
    pool.close()


# ---------------------------------------------------------------------------
# the forkserver and the resource tracker
# ---------------------------------------------------------------------------


def _live_children(pid: int) -> List[int]:
    """Pids of `pid`'s children that are not zombies (read from /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(entry))
    return out


def stop_forkserver(wait_s: float = 2.0) -> bool:
    """Stop the forkserver once no process forked from it lives on
    (waiting up to `wait_s` for the ones just ended to be reaped). A server
    that still has children serves someone else (the reference package in
    the same interpreter) and stays. api.shutdown() calls this after the
    pool and the actor processes have ended, so no process of the runtime
    outlives it but multiprocessing's resource tracker, which is one per
    interpreter and unlinks the semaphores of queues still referenced if
    stopped early. -> True when a running server was stopped."""
    from multiprocessing import forkserver

    server = forkserver._forkserver
    pid = getattr(server, "_forkserver_pid", None)
    if pid is None:
        return False
    deadline = time.monotonic() + wait_s
    while _live_children(pid):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    server._stop()
    return True
