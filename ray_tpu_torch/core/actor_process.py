"""Dedicated worker processes for actors: crash isolation with a mailbox RPC.

Reference analogue: every reference actor IS a worker process — the raylet
leases a worker (`src/ray/raylet/worker_pool.cc`), the actor instance lives
in it, and method calls arrive over gRPC (`core_worker/transport/
task_receiver.cc` in-order delivery). Here the same contract for CPU
actors: the instance is constructed in a forked child; the parent holds an
`_InstanceProxy` whose attribute access returns shipping stubs, so the node
agent's existing mailbox/`_run_actor_task` machinery is oblivious — a
method call pickles (args, kwargs) to the child, executes there, and the
result (or the user exception) pickles back. A dead child surfaces as
`ActorProcessCrash` → the agent's normal actor-death path (restarts,
`RayActorError` to callers).

The port's copy of ray_tpu/core/actor_process.py. Device actors (a "GPU"
demand) are exempt by explicit contract (node_agent._should_isolate): the
card belongs to the process that owns it. The children fork from the same
forkserver as the task pool (process_pool._mp_context), and a creation or
call payload that holds a tensor off the CPU cannot cross, so CUDA never
starts in an actor process. In-process execution also remains the fallback
whenever the creation payload cannot cross a process boundary. Each child
attaches the flight recorder and the profiler's signal handlers at start,
and a child that dies unexpectedly leaves a postmortem
(util/flight_recorder.write_postmortem).
"""

from __future__ import annotations

import os
import pickle
import threading
import uuid
from typing import Any, Dict, Optional, Tuple

import cloudpickle


class ActorProcessCrash(RuntimeError):
    """The actor's dedicated worker process died."""


class ActorNotSerializableError(RuntimeError):
    """Creation payload can't cross the process boundary."""


def _child_main(req_q, resp_q, log_dir: str = "") -> None:
    """Actor worker entry: construct the instance, then serve method calls.

    Runs max_concurrency threads over one request queue so blocking methods
    (queues, batchers) don't wedge the whole actor; per-call tags route
    responses. Imports stay minimal — user code decides what else loads."""
    from ._pdeathsig import set_pdeathsig
    from .process_pool import _redirect_stdio

    set_pdeathsig()  # die with the runtime, never orphan
    os.environ["RAY_TPU_IN_POOL_WORKER"] = "1"  # api.py guards private inits
    _redirect_stdio(log_dir, "actor")
    try:
        # flight recorder: mirror this child's recent spans/logs/events to
        # disk so a SIGKILL still leaves a postmortem (util/flight_recorder)
        from ..util import flight_recorder

        flight_recorder.attach(log_dir, "actor")
    except Exception:  # noqa: BLE001 — observability must not block startup
        pass
    try:
        # profiling plane: SIGUSR2 → all-threads stack dump (works even when
        # every serve thread is wedged — faulthandler is C, no GIL needed),
        # SIGUSR1 → toggle the sampling profiler (util/profiler)
        from ..util import profiler

        profiler.install_child_handlers(log_dir)
    except Exception:  # noqa: BLE001 — observability must not block startup
        pass

    kind, payload = req_q.get()
    if kind != "init":
        return
    try:
        cls, args, kwargs, concurrency, renv, head_addr = pickle.loads(payload)
        # the back-channel address travels in the payload, not the fork
        # env: the forkserver snapshots env at ITS start (see
        # process_pool._worker_main), so inheritance is unreliable; no
        # address clears a stale snapshot value, so an actor without a
        # back-channel gets the clear error, not a dead or reused port
        if head_addr:
            os.environ["RAY_TPU_HEAD_ADDRESS"] = head_addr
        else:
            os.environ.pop("RAY_TPU_HEAD_ADDRESS", None)
        from .runtime_env import applied

        ctx = applied(renv)
        ctx.__enter__()  # actor-scoped: env stays applied for its lifetime
        instance = cls(*args, **kwargs)
    except BaseException as e:  # noqa: BLE001 — reported, not raised
        try:
            err = cloudpickle.dumps(e)
        except Exception:
            err = cloudpickle.dumps(RuntimeError(repr(e)))
        resp_q.put(("init", False, err))
        return
    resp_q.put(("init", True, b""))

    send_lock = threading.Lock()

    # spans recorded in this child ride back on call replies (there is no
    # heartbeat loop here): one cursor shared by the serve threads
    tele_lock = threading.Lock()
    tele_cursor = [0]

    def serve_loop():
        from ..util import tracing

        while True:
            item = req_q.get()
            if item is None or item[0] == "stop":
                # one sentinel per thread: re-post for siblings then exit
                req_q.put(("stop",))
                return
            _, tag, method, call_payload = item
            try:
                args, kwargs, trace_ctx = pickle.loads(call_payload)
                if trace_ctx is not None:
                    with tracing.start_span(
                            f"actor_exec:{method}", context=trace_ctx):
                        out = getattr(instance, method)(*args, **kwargs)
                else:
                    out = getattr(instance, method)(*args, **kwargs)
                # ship anything newly buffered: the execute span above,
                # but also roots the method opened itself (sampled serve
                # requests). The untraced path stays lock-free.
                spans = []
                if tracing._total != tele_cursor[0]:
                    with tele_lock:
                        tele_cursor[0], spans = tracing.drain_since(
                            tele_cursor[0])
                body = cloudpickle.dumps((True, out, spans))
            except BaseException as e:  # noqa: BLE001 — user methods raise anything
                try:
                    body = cloudpickle.dumps((False, e, []))
                except Exception:
                    body = cloudpickle.dumps((False, RuntimeError(repr(e)), []))
            with send_lock:
                resp_q.put(("done", tag, body))

    threads = [
        threading.Thread(target=serve_loop, daemon=True, name=f"serve-{i}")
        for i in range(max(1, concurrency))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


class ActorProcess:
    """Parent-side handle on one actor's dedicated worker process."""

    def __init__(self, cls, args, kwargs, *, max_concurrency: int = 1,
                 runtime_env: Optional[dict] = None):
        # creation payload must cross the boundary NOW (fail fast into the
        # in-process fallback, before a process is started); the pool's
        # pickler rejects tensors off the CPU, and inline-only types
        # (ObjectRef/ActorHandle) unless the head serves a back-channel
        from .process_pool import _cloudpickle_dumps

        try:
            payload = _cloudpickle_dumps(
                (cls, tuple(args), dict(kwargs or {}), max(1, max_concurrency),
                 runtime_env, os.environ.get("RAY_TPU_HEAD_ADDRESS", ""))
            )
        except Exception as e:
            raise ActorNotSerializableError(repr(e)) from e

        from .logging import log_dir
        from .process_pool import _mp_context, _suppress_main_reimport

        # all teardown-visible state exists BEFORE anything can fail, so
        # terminate() on the init-error path below never masks the actor's
        # real __init__ exception with an AttributeError
        self._lock = threading.Lock()
        self._waiters: Dict[str, Tuple[threading.Event, list]] = {}
        self._dead = threading.Event()
        self._reader: Optional[threading.Thread] = None

        ctx = _mp_context()
        self._req_q = ctx.Queue()
        self._resp_q = ctx.Queue()
        self._proc = ctx.Process(
            target=_child_main,
            args=(self._req_q, self._resp_q, log_dir()),
            daemon=True,
        )
        with _suppress_main_reimport():
            self._proc.start()
        self._req_q.put(("init", payload))
        kind, ok, body = self._get_resp(timeout=300.0)
        if not ok:
            err = cloudpickle.loads(body)
            self.terminate()
            raise err
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"actor-proc-{self._proc.pid}",
        )
        self._reader.start()

    # -- plumbing -----------------------------------------------------------

    def _get_resp(self, timeout: float):
        """Blocking read used only during init (before the reader starts)."""
        import queue as _q

        deadline = timeout
        while True:
            try:
                return self._resp_q.get(timeout=min(0.1, deadline))
            except _q.Empty:
                deadline -= 0.1
                if not self._proc.is_alive():
                    self._note_crash("actor process died during init")
                    raise ActorProcessCrash(
                        f"actor process died during init "
                        f"(exitcode {self._proc.exitcode})"
                    )
                if deadline <= 0:
                    self.terminate()
                    raise ActorProcessCrash("actor init timed out")

    def _read_loop(self) -> None:
        import queue as _q

        while not self._dead.is_set():
            try:
                item = self._resp_q.get(timeout=0.1)
            except _q.Empty:
                if not self._proc.is_alive():
                    if not self._dead.is_set():
                        self._note_crash("actor process died")
                    self._fail_all_waiters()
                    return
                continue
            if item[0] != "done":
                continue
            _, tag, body = item
            with self._lock:
                waiter = self._waiters.pop(tag, None)
            if waiter is not None:
                event, box = waiter
                box.append(body)
                event.set()

    def _note_crash(self, cause: str) -> None:
        """Reap an UNEXPECTED child death into a postmortem artifact (the
        child's flight mirror + stdout tail; see util/flight_recorder).
        terminate() never calls this — normal teardown is not a crash.
        write_postmortem dedups by pid, so racing detection sites are safe."""
        try:
            from ..util import flight_recorder

            flight_recorder.write_postmortem(
                self._proc.pid, cause, exitcode=self._proc.exitcode,
                stdout_hint="actor")
        except Exception:  # noqa: BLE001 — reaping must not mask the crash
            pass

    def _fail_all_waiters(self) -> None:
        self._dead.set()
        # a call's payload past the pipe's buffer may still be in the dead
        # child's request queue: its feeder thread can never finish, and
        # joining it at interpreter exit would hang the process
        self._req_q.cancel_join_thread()
        with self._lock:
            waiters = list(self._waiters.values())
            self._waiters.clear()
        for event, box in waiters:
            box.append(None)  # None body => crashed
            event.set()

    # -- api ----------------------------------------------------------------

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid

    def alive(self) -> bool:
        return not self._dead.is_set() and self._proc.is_alive()

    def call(self, method: str, args: tuple, kwargs: dict,
             timeout: Optional[float] = None) -> Any:
        if self._dead.is_set():
            raise ActorProcessCrash("actor process is dead")
        from ..util import tracing
        from .process_pool import _cloudpickle_dumps

        try:
            # the caller's span context (the agent-side execute span) rides
            # along so the child's actor_exec span joins the same trace
            payload = _cloudpickle_dumps(
                (tuple(args), dict(kwargs or {}), tracing.current_context()))
        except Exception as e:
            raise ActorNotSerializableError(
                f"args of {method}() can't cross to the actor process: {e!r}"
            ) from e
        tag = uuid.uuid4().hex
        event = threading.Event()
        box: list = []
        with self._lock:
            self._waiters[tag] = (event, box)
        # _fail_all_waiters may have snapshotted BEFORE our registration
        # (child died concurrently): re-check so this call fails instead of
        # waiting on an event no reader thread will ever set
        if self._dead.is_set():
            with self._lock:
                self._waiters.pop(tag, None)
            raise ActorProcessCrash("actor process is dead")
        self._req_q.put(("call", tag, method, payload))
        if not event.wait(timeout=timeout):
            with self._lock:
                self._waiters.pop(tag, None)
            raise TimeoutError(f"actor call {method}() timed out")
        body = box[0]
        if body is None:
            self._note_crash(f"actor process died executing {method}()")
            raise ActorProcessCrash(
                f"actor process died executing {method}() "
                f"(exitcode {self._proc.exitcode})"
            )
        ok, value, spans = cloudpickle.loads(body)
        if spans:
            # child-process spans land in this (agent) process's buffer,
            # keeping their origin pid
            tracing.ingest(spans)
        if not ok:
            raise value
        return value

    def terminate(self) -> None:
        """End the child: SIGTERM, then SIGKILL after 5 s; reaped here."""
        self._dead.set()
        try:
            self._proc.terminate()
            self._proc.join(timeout=5.0)
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join(timeout=5.0)
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass
        self._fail_all_waiters()
        if self._reader is not None and self._reader is not threading.current_thread():
            self._reader.join(timeout=1.0)
        for q in (self._req_q, self._resp_q):
            q.close()


class _InstanceProxy:
    """Drop-in for `_ActorRunner.instance`: attribute access returns stubs
    that ship the call to the actor's worker process. The node agent's
    `getattr(instance, method)(*args)` path works unchanged."""

    def __init__(self, proc: ActorProcess, class_name: str):
        object.__setattr__(self, "_proc", proc)
        object.__setattr__(self, "_class_name", class_name)

    def __getattr__(self, name: str):
        proc: ActorProcess = object.__getattribute__(self, "_proc")

        def stub(*args, **kwargs):
            return proc.call(name, args, kwargs)

        stub.__name__ = name
        return stub

    def __repr__(self):
        cls = object.__getattribute__(self, "_class_name")
        proc: ActorProcess = object.__getattribute__(self, "_proc")
        return f"<{cls} in worker process {proc.pid}>"
