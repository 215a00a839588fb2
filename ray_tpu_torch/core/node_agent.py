"""Per-node agent: worker pool, local dispatch, resource accounting, actors.

Equivalent of the reference's raylet (upstream ray `src/ray/raylet/
node_manager.cc :: NodeManager`, `worker_pool.cc`, `local_task_manager.cc`,
`dependency_manager.cc`): grants execution to tasks once their dependencies
are local and resources are acquired, runs them on its worker pool, seals
returns into the node object store and reports completion to the owner.

The port's copy of ray_tpu/core/node_agent.py. As in the reference, the
device is owned by ONE process: device tasks and device actors, the ones
that demand "GPU", execute on the agent's *threads* inside the process that
owns the card. They share its CUDA context and, unless they pick another,
its current stream, so a device-side assert in one of them ends the context
for all (recorded, not isolated: a forked child cannot take CUDA work
either). PyTorch's CUDA calls release the GIL, so threads give parallelism
where it matters. A separate *process* pool (process_pool.py) runs CPU-only
tasks, and CPU actors get processes of their own (actor_process.py), as the
reference's worker processes do, with the shared-memory store as the object
plane; every such process forks from the forkserver and never starts CUDA.
A task whose payload cannot cross (a tensor off the CPU, a ref, an
unpicklable closure) runs on these threads instead and is counted. Where the
pool cannot be created (no C++ compiler, too little /dev/shm) a CPU task
raises, naming the cause: a deliberate difference, the reference logs and
stays on threads. The profiling plane (`profile_start` / `profile_fetch`,
util/profiler.py) samples this process or signals a child; its device trace
is `kind="torch"`, a torch.profiler capture (util.timeline.trace_torch),
where the reference's is `kind="jax"`.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import memory_monitor  # noqa: F401 — declares its config flags
from .actor_process import ActorProcessCrash
from .config import config
from .control_plane import ControlPlane, NodeInfo
from .ids import ActorID, NodeID, ObjectID, TaskID, WorkerID
from .logging import get_logger
from .metrics import Counter, Gauge
from .object_store import MemoryObjectStore, ObjectLostError, seal_value
from .task_spec import TaskKind, TaskSpec

logger = get_logger("node_agent")

_tasks_counter = Counter("ray_tpu_tasks_finished", "Tasks finished by outcome")
_running_gauge = Gauge("ray_tpu_tasks_running", "Tasks currently executing")
_actors_isolated_counter = Counter(
    "ray_tpu_actors_isolated",
    "Actor creations by isolation outcome (process / in_process / fallback).",
)
_pool_fallback_counter = Counter(
    "ray_tpu_pool_fallbacks",
    "CPU tasks that bypassed process isolation (unpicklable args/closure)",
)


class WorkerCrashedError(RuntimeError):
    """The worker executing the task died (killed, OOM, node failure)."""


class TaskCancelledError(RuntimeError):
    pass


@dataclass
class TaskResult:
    task_id: TaskID
    ok: bool
    values: Optional[List[Any]] = None  # one per return id
    error: Optional[BaseException] = None
    is_application_error: bool = False  # user exception vs system failure


DoneCallback = Callable[[TaskResult], None]


def _preboot_forkserver() -> None:
    """Boot the multiprocessing forkserver without spawning any worker:
    the server process launches via `-c` and never reads the driver's
    __main__, so this is safe to run concurrently with driver code. The
    first real worker spawn then skips the server boot."""
    try:
        from multiprocessing import forkserver

        from .process_pool import _mp_context

        _mp_context()
        forkserver.ensure_running()
    except Exception:  # noqa: BLE001 — warmup is best-effort
        logger.debug("forkserver preboot failed", exc_info=True)


def admits(total: Dict[str, float], available: Dict[str, float],
           demand: Dict[str, float], spread_threshold: float) -> bool:
    """The bottom-up local-admission rule (shared by NodeAgent.try_admit
    and the scale harness's simulated agents): feasible against totals,
    available right now, and current utilization under the spread
    threshold — exactly ClusterScheduler._hybrid's local-first gate, so a
    local admission matches the global policy's choice."""
    if not all(total.get(k, 0.0) >= v for k, v in demand.items()):
        return False
    if not all(available.get(k, 0.0) >= v - 1e-9 for k, v in demand.items()):
        return False
    util = max((1.0 - available.get(k, 0.0) / t
                for k, t in total.items() if t > 0), default=0.0)
    return util < spread_threshold


class ResourceTracker:
    """Node-local resource ledger with blocking acquire semantics."""

    def __init__(self, total: Dict[str, float]):
        self.total = dict(total)
        self._available = dict(total)
        self._lock = threading.Lock()

    def try_acquire(self, demand: Dict[str, float]) -> bool:
        with self._lock:
            if all(self._available.get(k, 0.0) >= v - 1e-9 for k, v in demand.items()):
                for k, v in demand.items():
                    self._available[k] = self._available.get(k, 0.0) - v
                return True
            return False

    def release(self, demand: Dict[str, float]) -> None:
        with self._lock:
            for k, v in demand.items():
                self._available[k] = min(
                    self.total.get(k, 0.0), self._available.get(k, 0.0) + v
                )

    def available(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._available)


def _is_async_actor(cls) -> bool:
    """An actor class with ANY async method runs on an asyncio event loop
    (reference: async actors in `core_worker.cc` / `actor.py` — the
    presence of coroutine methods selects the event-loop execution mode).
    getmembers walks the MRO, so inherited async methods count too."""
    import inspect

    if not inspect.isclass(cls):
        return False
    return any(
        inspect.iscoroutinefunction(m)
        for _, m in inspect.getmembers(cls, callable)
    )


def _release_instance(runner: "_ActorRunner") -> None:
    """Drop a dead actor's instance once none of its lanes runs: the
    record stays (for has_actor and the actor's death cause), what the
    instance held (an engine's weights and pools on the card) goes with
    the last reference. kill_actor calls this after a bounded join, and a
    lane still running then calls it again as it ends (_lane_ended). A
    deliberate difference: the reference's agent keeps a killed actor's
    instance for as long as the node lives."""
    me = threading.current_thread()
    if not any(t.is_alive() for t in runner.threads if t is not me):
        runner.instance = None


def _lane_ended(runner: "_ActorRunner") -> None:
    """A lane of `runner` ends: the last lane of a dead actor drops its
    instance (a lane that outlived kill_actor's join, such as an async
    actor's loop waiting for a long call in its executor)."""
    if runner.dead:
        _release_instance(runner)


class _ActorRunner:
    """Dedicated execution lane for one actor: FIFO mailbox + instance state.

    Reference analogue: the actor worker's task queue with in-order execution
    (`src/ray/core_worker/transport/task_receiver.cc` ordered scheduling).
    """

    def __init__(self, actor_id: ActorID, max_concurrency: int = 1):
        self.actor_id = actor_id
        self.instance: Any = None
        self.process = None  # ActorProcess when isolated (actor_process.py)
        self.held_resources: Dict[str, float] = {}
        self.mailbox: "queue.Queue[Optional[Tuple[TaskSpec, Callable[[], None]]]]" = queue.Queue()
        self.dead = False
        self.death_cause: Optional[BaseException] = None
        self.threads: List[threading.Thread] = []
        self.max_concurrency = max(1, max_concurrency)
        # task ids whose done callbacks are registered but not yet claimed
        # by a runner lane — swept on kill so no caller hangs
        self.pending_ids: set = set()

    def start(self, run_one: Callable[["_ActorRunner", TaskSpec, Callable[[], None]], None]) -> None:
        for i in range(self.max_concurrency):
            t = threading.Thread(
                target=self._loop, args=(run_one,), daemon=True,
                name=f"actor-{self.actor_id.hex()[:8]}-{i}",
            )
            t.start()
            self.threads.append(t)

    def _loop(self, run_one):
        while True:
            item = self.mailbox.get()
            if item is None:
                _lane_ended(self)
                return
            if item[0] == "__direct__":
                # compiled-graph fast path (ray_tpu.dag): a pre-bound
                # closure runs on the actor's lane with its instance,
                # skipping spec/scheduling/store — actor-serial semantics
                # are preserved because it's the same mailbox.
                try:
                    item[1](self.instance)
                except Exception:  # noqa: BLE001 — closure handles user errors
                    logger.exception("direct actor submit failed")
                continue
            spec, release = item
            run_one(self, spec, release)

    def stop(self) -> None:
        for _ in self.threads:
            self.mailbox.put(None)


# how long a stopped async actor's lane waits for its executor threads: a
# thread still running a call past this is left to finish on its own
EXECUTOR_JOIN_S = 10.0


class _AsyncActorRunner(_ActorRunner):
    """Event-loop lane for an async actor: tasks run as coroutines on ONE
    asyncio loop; max_concurrency bounds concurrent AWAITS (a semaphore),
    so a replica overlaps slow requests wherever they await instead of
    burning a thread per slot (reference: the async actor event loop in
    `core_worker.cc`; concurrency groups collapse to the semaphore)."""

    def start(self, run_one) -> None:
        import asyncio

        self.loop = asyncio.new_event_loop()
        self._run_one = run_one

        def loop_main():
            asyncio.set_event_loop(self.loop)
            self.loop.run_forever()
            # stopped (stop()): let the cancelled tasks unwind, then end the
            # default executor's threads (asyncio.to_thread), which would
            # otherwise idle on for the life of the process
            self.loop.run_until_complete(
                self.loop.shutdown_default_executor(timeout=EXECUTOR_JOIN_S))
            self.loop.close()
            _lane_ended(self)

        loop_thread = threading.Thread(
            target=loop_main, daemon=True,
            name=f"actor-loop-{self.actor_id.hex()[:8]}",
        )
        loop_thread.start()
        # the semaphore must be created ON the loop
        fut = asyncio.run_coroutine_threadsafe(self._make_sem(), self.loop)
        fut.result(timeout=10)
        dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name=f"actor-dispatch-{self.actor_id.hex()[:8]}",
        )
        dispatcher.start()
        self.threads = [loop_thread, dispatcher]

    async def _make_sem(self):
        import asyncio

        self._sem = asyncio.Semaphore(self.max_concurrency)

    def _dispatch_loop(self) -> None:
        import asyncio

        while True:
            item = self.mailbox.get()
            if item is None:
                # cancel in-flight awaits so callers get actor-death errors
                # instead of hanging, then stop the loop
                def _cancel_and_stop():
                    for t in asyncio.all_tasks(self.loop):
                        t.cancel()
                    self.loop.call_soon(self.loop.stop)

                self.loop.call_soon_threadsafe(_cancel_and_stop)
                return
            asyncio.run_coroutine_threadsafe(self._handle(item), self.loop)

    async def _handle(self, item) -> None:
        import inspect

        async with self._sem:
            if item[0] == "__direct__":
                try:
                    res = item[1](self.instance)
                    if inspect.isawaitable(res):
                        await res
                except Exception:  # noqa: BLE001
                    logger.exception("direct async actor submit failed")
                return
            spec, _release = item
            await self._run_one(self, spec)


class NodeAgent:
    """One per (virtual or real) node."""

    def __init__(
        self,
        info: NodeInfo,
        control_plane: ControlPlane,
        object_directory: "ObjectDirectory",
        num_task_threads: Optional[int] = None,
    ):
        self.info = info
        self.node_id = info.node_id
        self._cp = control_plane
        self._directory = object_directory
        self.store = MemoryObjectStore()
        self.store.ledger_node = info.node_id.hex()
        # an object leaving this store must leave the directory too, or a
        # pull-through replica's advertisement outlives the replica and
        # sends pullers to a holder that no longer has the bytes
        self.store.on_evict = (
            lambda oid: object_directory.remove_location(oid, info.node_id))
        self.resources = ResourceTracker(info.resources_total)
        self._actors: Dict[ActorID, _ActorRunner] = {}
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        # CPU-task process pool (config.worker_processes > 0): created lazily
        # on the first eligible task so thread-mode runtimes pay nothing —
        # but the forkserver itself pre-boots in the background at agent
        # creation (the reference PRESTARTS workers, worker_pool.cc), so
        # most of the spawn cost overlaps driver setup. Only the server
        # boots here: actually spawning workers would run the __main__
        # suppression window concurrently with arbitrary driver top-level
        # code (see process_pool._suppress_main_reimport) — worker spawns
        # stay inside explicit submission calls.
        self._pool = None
        self._pool_lock = threading.Lock()
        self._torch_trace: Optional[Dict[str, Any]] = None  # the last device trace
        self._warmup: Optional[threading.Thread] = None
        if config.worker_processes > 0 and config.prestart_worker_processes:
            self._warmup = threading.Thread(
                target=_preboot_forkserver, daemon=True, name="pool-warmup")
            self._warmup.start()
        n_threads = num_task_threads or max(2, int(info.resources_total.get("CPU", 2)))
        self._task_queue: "queue.Queue[Optional[Tuple[TaskSpec, DoneCallback]]]" = queue.Queue()
        self._threads = [
            threading.Thread(target=self._worker_loop, daemon=True, name=f"worker-{i}")
            for i in range(n_threads)
        ]
        for t in self._threads:
            t.start()
        # tasks currently running, for cancellation/failure injection
        self._running: Dict[TaskID, threading.Event] = {}
        self._pending_actor_dones: Dict[TaskID, DoneCallback] = {}
        # per-item callbacks for streaming tasks, keyed by task id
        self._stream_cbs: Dict[TaskID, Callable[[int, ObjectID], None]] = {}
        # test hook: simulate a hung host (stops heartbeating, keeps running)
        self.suspend_heartbeat = False
        # remote control plane: bound each monitor-sweep heartbeat tightly
        # instead of the default call deadline (see _sync_load)
        from .rpc import RemoteControlPlane, ShardedControlPlane

        self._hb_kwargs: Dict[str, Any] = (
            {"_deadline_s": max(2.0, config.health_check_period_ms / 1000.0)}
            if isinstance(control_plane, (RemoteControlPlane, ShardedControlPlane))
            else {}
        )

    # ------------------------------------------------------------------ api
    def try_admit(self, demand: Dict[str, float],
                  spread_threshold: Optional[float] = None) -> bool:
        """Bottom-up scheduling probe (reference: Ray's two-level local-
        first scheduler, arXiv:1712.05889 §4.2): would this node admit the
        demand right now, judged against the agent's OWN resource tracker
        — fresher than the control plane's eventually-consistent view.
        Mirrors ClusterScheduler._hybrid's local-first rule (feasible +
        available + utilization under the spread threshold), so a local
        admission is exactly the placement the global policy would have
        picked; anything else overflows to the ClusterScheduler. View-only:
        resources are still acquired by the executing worker, the same
        admission-vs-execution race the global path has."""
        if self._stopped.is_set():
            return False
        if spread_threshold is None:
            spread_threshold = float(config.scheduler_spread_threshold)
        return admits(self.resources.total, self.resources.available(),
                      demand, spread_threshold)

    def submit(self, spec: TaskSpec, done: DoneCallback,
               stream: Optional[Callable[[int, ObjectID], None]] = None) -> None:
        """Dispatch once dependencies are local. Resources are acquired by the
        executing worker thread (dependency-first, like the reference's
        dispatch order: args ready -> acquire -> pop worker).

        stream: per-item callback for num_returns="streaming" tasks,
        invoked as each yielded value seals into the store."""
        if self._stopped.is_set():
            done(TaskResult(spec.task_id, ok=False, error=WorkerCrashedError("node stopped")))
            return
        if stream is not None:
            with self._lock:
                self._stream_cbs[spec.task_id] = stream
        missing = [d for d in spec.dependencies if not self.store.contains(d)]
        if not missing:
            self._enqueue(spec, done)
            return
        remaining = {"n": len(missing), "failed": False}
        lock = threading.Lock()

        def on_dep_ready() -> None:
            with lock:
                remaining["n"] -= 1
                if remaining["n"] != 0 or remaining["failed"]:
                    return
            self._enqueue(spec, done)

        def on_dep_failed(error: BaseException) -> None:
            # an argument's task failed for good: this task fails with its
            # error, once (ROADMAP C19)
            with lock:
                if remaining["failed"]:
                    return
                remaining["failed"] = True
            done(TaskResult(spec.task_id, ok=False, error=error,
                            is_application_error=True))

        for dep in missing:
            self._fetch_async(dep, on_dep_ready, on_dep_failed)

    def _enqueue(self, spec: TaskSpec, done: DoneCallback) -> None:
        if spec.kind is TaskKind.ACTOR_TASK:
            self._submit_actor_task(spec, done)
        else:
            self._task_queue.put((spec, done))

    # --------------------------------------------------------- normal tasks
    def _worker_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                item = self._task_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                return
            spec, done = item
            demand = {} if spec.skip_node_resources else spec.options.resource_demand()
            # Block-wait for resources on this worker lane; the cluster
            # scheduler already sized placement to the node's view.
            while not self.resources.try_acquire(demand):
                if self._stopped.is_set():
                    done(TaskResult(spec.task_id, ok=False,
                                    error=WorkerCrashedError("node stopped")))
                    return
                threading.Event().wait(0.002)
            self._sync_load()
            try:
                result = self._execute(spec)
            finally:
                # Actor placement resources stay held for the actor's lifetime
                # (released by kill_actor / node stop), like a leased worker.
                hold = (
                    spec.kind is TaskKind.ACTOR_CREATION
                    and self.has_actor(spec.actor_id)
                )
                if hold:
                    with self._lock:
                        self._actors[spec.actor_id].held_resources = demand
                else:
                    self.resources.release(demand)
                self._sync_load()
            done(result)

    def _execute(self, spec: TaskSpec) -> TaskResult:
        if spec.kind is TaskKind.ACTOR_CREATION:
            return self._execute_actor_creation(spec)
        if spec.options.num_returns == "streaming":
            return self._execute_streaming(spec)
        kill_event = threading.Event()
        with self._lock:
            self._running[spec.task_id] = kill_event
        _running_gauge.add(1, {"node": self.node_id.hex()[:8]})
        try:
            args, kwargs = self._materialize_args(spec)
            values = self._call_user_function(spec, None, args, kwargs, kill_event)
            self._seal_returns(spec, values)
            _tasks_counter.inc(tags={"outcome": "ok"})
            return TaskResult(spec.task_id, ok=True, values=values)
        except WorkerCrashedError as e:
            _tasks_counter.inc(tags={"outcome": "crashed"})
            return TaskResult(spec.task_id, ok=False, error=e)
        except BaseException as e:  # noqa: BLE001 - user code may raise anything
            _tasks_counter.inc(tags={"outcome": "error"})
            return TaskResult(
                spec.task_id, ok=False, error=e, is_application_error=True
            )
        finally:
            _running_gauge.add(-1, {"node": self.node_id.hex()[:8]})
            with self._lock:
                self._running.pop(spec.task_id, None)

    def _execute_streaming(self, spec: TaskSpec) -> TaskResult:
        """Generator task: each yielded value seals into the store under
        ObjectID.for_task_return(task_id, i) and the owner's stream
        callback fires immediately — the consumer iterates while this
        loop still runs. Runs in-process (never on the worker-process
        pool: a generator cannot cross that boundary incrementally).
        On a mid-stream exception the already-sealed prefix stays valid;
        the owner surfaces the error after it."""
        kill_event = threading.Event()
        with self._lock:
            self._running[spec.task_id] = kill_event
            stream_cb = self._stream_cbs.pop(spec.task_id, None)
        _running_gauge.add(1, {"node": self.node_id.hex()[:8]})
        try:
            from .runtime_env import applied, resolve, validate

            renv = resolve(validate(spec.options.runtime_env), self._cp)
            args, kwargs = self._materialize_args(spec)
            # Streaming runs in-process (a generator can't cross the
            # worker-pool boundary incrementally), so the env applies to
            # this process for the stream's duration — same contract as
            # the pool worker, scoped to the generator's lifetime.
            with applied(renv):
                gen = spec.func(*args, **kwargs)
                if not hasattr(gen, "__next__"):
                    raise TypeError(
                        f"num_returns='streaming' task {spec.name} must be a "
                        f"generator; got {type(gen).__name__}"
                    )
                for i, value in enumerate(gen):
                    if kill_event.is_set():
                        raise WorkerCrashedError(
                            "worker killed during streaming")
                    oid = ObjectID.for_task_return(spec.task_id, i)
                    self.store.put(oid, seal_value(value, spec.name))
                    self.store.annotate(oid, creator_task=spec.name)
                    self._directory.add_location(oid, self.node_id)
                    if stream_cb is not None:
                        stream_cb(i, oid)
            _tasks_counter.inc(tags={"outcome": "ok"})
            return TaskResult(spec.task_id, ok=True, values=None)
        except WorkerCrashedError as e:
            _tasks_counter.inc(tags={"outcome": "crashed"})
            return TaskResult(spec.task_id, ok=False, error=e)
        except BaseException as e:  # noqa: BLE001 — user generators raise anything
            _tasks_counter.inc(tags={"outcome": "error"})
            return TaskResult(spec.task_id, ok=False, error=e,
                              is_application_error=True)
        finally:
            _running_gauge.add(-1, {"node": self.node_id.hex()[:8]})
            with self._lock:
                self._running.pop(spec.task_id, None)

    def _call_user_function(self, spec, instance, args, kwargs, kill_event):
        if kill_event.is_set():
            raise WorkerCrashedError("worker killed before execution")
        if spec.kind is TaskKind.ACTOR_TASK:
            func = getattr(instance, spec.method_name)
        else:
            func = spec.func
        ctx = getattr(spec, "trace_ctx", None)
        if ctx:
            # distributed tracing (util/tracing; reference:
            # tracing_helper's execute-side span): the execute span
            # parents under the submitter's span, and while it is
            # current, tasks THIS task submits chain into the same trace
            from ..util import tracing

            with tracing.start_span(
                f"execute:{spec.name}",
                {"task_id": spec.task_id.hex()[:16],
                 "node": self.node_id.hex()[:8],
                 "kind": spec.kind.value,
                 "attempt": spec.attempt},
                context=ctx,
            ):
                out = self._invoke(spec, func, args, kwargs)
        else:
            out = self._invoke(spec, func, args, kwargs)
        if kill_event.is_set():
            raise WorkerCrashedError("worker killed during execution")
        return self._shape_returns(spec, out)

    def _invoke(self, spec: TaskSpec, func, args, kwargs):
        """Route execution: stateless CPU-only tasks go to the worker-process
        pool when enabled (crash isolation, the reference's worker-process
        model); device tasks (those that demand "GPU") and actors stay on
        threads in the device-owning process (node_agent docstring). Tasks
        that can't cross the process boundary (unpicklable closures, refs,
        tensors off the CPU) fall back to in-process execution."""
        from .runtime_env import resolve, validate

        renv = validate(spec.options.runtime_env)
        # kv:// working_dir (shipped by a possibly-remote driver) becomes a
        # local cached extraction before the worker sees it
        renv = resolve(renv, self._cp)
        if (
            spec.kind is TaskKind.NORMAL
            and config.worker_processes > 0
            and spec.options.resource_demand().get("GPU", 0.0) <= 0.0
        ):
            from .process_pool import (
                TaskNotSerializableError,
                WorkerProcessCrash,
            )

            pool = self._ensure_pool()
            if pool is not None:
                try:
                    # sealed=True hands back the worker's pickled payload as
                    # SealedBytes without deserializing in this process —
                    # _seal_returns stores it as-is (single-return tasks;
                    # multi-return needs the tuple split, so it deserializes)
                    return pool.run(
                        func, tuple(args), dict(kwargs),
                        sealed=spec.options.num_returns == 1,
                        runtime_env=renv,
                    )
                except TaskNotSerializableError:
                    if renv:
                        # isolation was REQUESTED: never silently run without
                        raise
                    _pool_fallback_counter.inc(tags={"task": spec.name[:40]})
                    logger.debug(
                        "task %s not serializable; executing in-process",
                        spec.name,
                    )
                except WorkerProcessCrash as e:
                    raise WorkerCrashedError(str(e)) from e
        if renv:
            from .runtime_env import RuntimeEnvError

            raise RuntimeEnvError(
                f"task {spec.name} has a runtime_env but would execute "
                "in-process (device task, actor, or worker_processes=0): "
                "env isolation requires a worker process. Use job-level "
                "runtime_env for device work, or drop the constraint."
            )
        return func(*args, **kwargs)

    def _ensure_pool(self):
        """The shared process pool, acquired at the first CPU task. A pool
        that cannot be created raises, naming the cause: no CPU task runs
        on a thread in its stead (a deliberate difference, the reference
        logs and stays on threads)."""
        with self._pool_lock:
            if self._pool is None and not self._stopped.is_set():
                from .process_pool import (
                    acquire_shared_pool,
                    register_inline_only_types,
                )

                from ..api import ActorHandle
                from .core_worker import ObjectRef

                register_inline_only_types(ObjectRef, ActorHandle)
                # refcounted process-wide singleton: virtual nodes share
                # one OS process, so one pool serves them all
                self._pool = acquire_shared_pool(config.worker_processes)
                try:
                    # host-OOM guard (reference memory_monitor.cc): kills
                    # the newest pool task under memory pressure; it
                    # retries via the worker-crash path. The monitor is
                    # OPTIONAL — its failure must not disable the pool (or
                    # leak the acquire ref above).
                    self._pool.ensure_memory_monitor()
                except Exception:  # noqa: BLE001
                    logger.warning("memory monitor unavailable",
                                   exc_info=True)
            return self._pool or None

    def _materialize_args(self, spec: TaskSpec) -> Tuple[tuple, dict]:
        from .core_worker import ObjectRef  # cycle: resolved at call time

        def resolve(v: Any) -> Any:
            if isinstance(v, ObjectRef):
                return self.store.get(v.object_id, timeout=30.0)
            return v

        args = tuple(resolve(a) for a in spec.args)
        kwargs = {k: resolve(v) for k, v in spec.kwargs.items()}
        return args, kwargs

    def _seal_returns(self, spec: TaskSpec, values: List[Any]) -> None:
        """Publish return values to the object plane, sealed.

        seal_value pickles host objects (SealedBytes) so the stored form can
        never alias live state the producer keeps mutating, and every get()
        deserializes a private copy — the serialization boundary the
        reference gets by construction from worker processes + plasma.
        Trees of device tensors pass through by reference
        (object_store docstring)."""
        for oid, value in zip(spec.return_ids, values):
            self.store.put(oid, seal_value(value, spec.name))
            self.store.annotate(oid, creator_task=spec.name)
            self._directory.add_location(oid, self.node_id)

    # ---------------------------------------------------------------- actors
    def _should_isolate(self, spec: TaskSpec) -> bool:
        """Actor-isolation policy (reference: every actor IS a worker
        process). CPU actors with serial mailboxes isolate; device actors
        are exempt by contract (a forked child cannot take CUDA work, and
        the card belongs to this process), and high-concurrency actors
        (serve replicas, trial runners — streaming returns, shared
        batchers) stay in-process."""
        if _is_async_actor(spec.func):
            # the event loop and its coroutines cannot cross an
            # ActorProcess boundary; async actors are in-process by mode
            return False
        gpu = spec.options.resource_demand().get("GPU", 0.0) > 0.0
        if spec.options.in_process is False and gpu:
            # a deliberate difference: the reference lets in_process=False
            # override its device exemption; here the card belongs to this
            # process, and CUDA never starts in a child
            raise ValueError(
                f"actor {spec.name} demands a GPU and in_process=False: a "
                "device actor runs in the process that owns the card")
        if spec.options.in_process is not None:
            return not spec.options.in_process
        return (
            config.actor_processes
            and spec.options.resource_demand().get("GPU", 0.0) <= 0.0
            and spec.options.max_concurrency <= 1
        )

    def _build_actor_instance(self, spec: TaskSpec, args, kwargs):
        """-> (instance, actor_process_or_None), honoring the isolation
        policy with in-process fallback for unpicklable state."""
        if self._should_isolate(spec):
            from .actor_process import (
                ActorNotSerializableError,
                ActorProcess,
                _InstanceProxy,
            )
            from .runtime_env import resolve, validate

            try:
                proc = ActorProcess(
                    spec.func, args, kwargs,
                    max_concurrency=spec.options.max_concurrency,
                    runtime_env=resolve(
                        validate(spec.options.runtime_env), self._cp),
                )
                _actors_isolated_counter.inc(tags={"mode": "process"})
                return _InstanceProxy(
                    proc, getattr(spec.func, "__name__", "Actor")
                ), proc
            except ActorNotSerializableError as e:
                if spec.options.runtime_env or spec.options.in_process is False:
                    # isolation was explicitly REQUIRED (env isolation, or
                    # in_process=False for crash containment): silently
                    # running in the driver would defeat the request
                    raise
                _actors_isolated_counter.inc(tags={"mode": "fallback"})
                logger.debug(
                    "actor %s state can't cross a process boundary (%s); "
                    "running in-process", spec.name, e,
                )
        else:
            if spec.options.runtime_env:
                from .runtime_env import RuntimeEnvError

                # same strictness as the task path (node_agent._invoke):
                # an env that cannot be applied must not be silently dropped
                raise RuntimeEnvError(
                    f"actor {spec.name} has a runtime_env but would run "
                    "in-process (device actor / max_concurrency>1 / "
                    "in_process=True) where env isolation is impossible"
                )
            _actors_isolated_counter.inc(tags={"mode": "in_process"})
        return spec.func(*args, **kwargs), None

    def _execute_actor_creation(self, spec: TaskSpec) -> TaskResult:
        kill_event = threading.Event()
        with self._lock:
            self._running[spec.task_id] = kill_event
        try:
            args, kwargs = self._materialize_args(spec)
            if _is_async_actor(spec.func):
                runner = _AsyncActorRunner(
                    spec.actor_id, spec.options.max_concurrency)
                run_one = self._run_actor_task_async
            else:
                runner = _ActorRunner(spec.actor_id, spec.options.max_concurrency)
                run_one = self._run_actor_task
            runner.instance, runner.process = self._build_actor_instance(
                spec, args, kwargs
            )
            # the node may have died while __init__ ran: report the crash so
            # the owner reschedules instead of marking the actor ALIVE here
            if kill_event.is_set() or self._stopped.is_set():
                if runner.process is not None:
                    runner.process.terminate()
                raise WorkerCrashedError("node died during actor creation")
            runner.start(run_one)
            with self._lock:
                old = self._actors.get(spec.actor_id)
                self._actors[spec.actor_id] = runner
            if old is not None and old.dead:
                # a restart replaces a crashed runner: its lanes end once
                # they have failed what is left in its mailbox
                old.stop()
            self._seal_returns(spec, [None])
            _tasks_counter.inc(tags={"outcome": "ok"})
            return TaskResult(spec.task_id, ok=True, values=[None])
        except (WorkerCrashedError, ActorProcessCrash) as e:
            _tasks_counter.inc(tags={"outcome": "crashed"})
            return TaskResult(spec.task_id, ok=False,
                              error=WorkerCrashedError(str(e)))
        except BaseException as e:  # noqa: BLE001
            _tasks_counter.inc(tags={"outcome": "error"})
            return TaskResult(spec.task_id, ok=False, error=e, is_application_error=True)
        finally:
            with self._lock:
                self._running.pop(spec.task_id, None)

    def _submit_actor_task(self, spec: TaskSpec, done: DoneCallback) -> None:
        # dead-check and registration are ONE critical section against
        # kill_actor's sweep: checking dead outside it would let a kill
        # land between the check and the registration, leaving a done
        # callback nothing will ever claim (caller hangs)
        with self._lock:
            runner = self._actors.get(spec.actor_id)
            dead = runner is None or runner.dead
            if not dead:
                # actor tasks do not re-acquire placement resources
                self._pending_actor_dones[spec.task_id] = done
                runner.pending_ids.add(spec.task_id)
        if dead:
            cause = runner.death_cause if runner else None
            done(TaskResult(spec.task_id, ok=False,
                            error=WorkerCrashedError(f"actor is dead: {cause}")))
            return
        runner.mailbox.put((spec, lambda: None))

    def _run_actor_task(self, runner: _ActorRunner, spec: TaskSpec, release: Callable[[], None]) -> None:
        done = self._pending_actor_dones.pop(spec.task_id, None)
        runner.pending_ids.discard(spec.task_id)
        if done is None:
            return
        if runner.dead:
            done(TaskResult(spec.task_id, ok=False,
                            error=WorkerCrashedError(f"actor is dead: {runner.death_cause}")))
            return
        kill_event = threading.Event()
        with self._lock:
            self._running[spec.task_id] = kill_event
        try:
            args, kwargs = self._materialize_args(spec)
            values = self._call_user_function(
                spec, runner.instance, args, kwargs, kill_event
            )
            self._seal_returns(spec, values)
            _tasks_counter.inc(tags={"outcome": "ok"})
            done(TaskResult(spec.task_id, ok=True, values=values))
        except (WorkerCrashedError, ActorProcessCrash) as e:
            runner.dead = True
            runner.death_cause = e
            if runner.process is not None:
                runner.process.terminate()  # reap the dead child, drop its queues
            _tasks_counter.inc(tags={"outcome": "crashed"})
            done(TaskResult(spec.task_id, ok=False,
                            error=WorkerCrashedError(str(e))))
        except BaseException as e:  # noqa: BLE001
            _tasks_counter.inc(tags={"outcome": "error"})
            done(TaskResult(spec.task_id, ok=False, error=e, is_application_error=True))
        finally:
            with self._lock:
                self._running.pop(spec.task_id, None)

    @staticmethod
    def _shape_returns(spec: TaskSpec, out: Any) -> List[Any]:
        """num_returns shaping shared by the thread and event-loop lanes."""
        n = spec.options.num_returns
        if n == 1:
            return [out]
        if out is None and n == 0:
            return []
        if not isinstance(out, tuple) or len(out) != n:
            raise ValueError(f"task {spec.name} declared num_returns={n} but "
                             f"returned {type(out).__name__}")
        return list(out)

    async def _run_actor_task_async(self, runner: "_AsyncActorRunner",
                                    spec: TaskSpec) -> None:
        """Async-actor variant of _run_actor_task: the method's coroutine is
        awaited on the actor's event loop, so overlapping requests
        interleave at their await points. Arg materialization and return
        sealing (pickling) run in a thread — a large payload must not
        freeze every other in-flight request on the loop. Cancellation
        (actor kill) surfaces as an actor-death error, never a hang."""
        import asyncio
        import inspect

        done = self._pending_actor_dones.pop(spec.task_id, None)
        runner.pending_ids.discard(spec.task_id)
        if done is None:
            return
        if runner.dead:
            done(TaskResult(spec.task_id, ok=False,
                            error=WorkerCrashedError(f"actor is dead: {runner.death_cause}")))
            return
        kill_event = threading.Event()
        with self._lock:
            self._running[spec.task_id] = kill_event
        try:
            args, kwargs = await asyncio.to_thread(self._materialize_args, spec)
            func = getattr(runner.instance, spec.method_name)
            out = func(*args, **kwargs)
            if inspect.isawaitable(out):
                out = await out
            if kill_event.is_set():
                raise WorkerCrashedError("worker killed during execution")
            values = self._shape_returns(spec, out)
            await asyncio.to_thread(self._seal_returns, spec, values)
            _tasks_counter.inc(tags={"outcome": "ok"})
            done(TaskResult(spec.task_id, ok=True, values=values))
        except asyncio.CancelledError:
            _tasks_counter.inc(tags={"outcome": "crashed"})
            done(TaskResult(spec.task_id, ok=False,
                            error=WorkerCrashedError(
                                f"actor stopped: {runner.death_cause}")))
        except (WorkerCrashedError, ActorProcessCrash) as e:
            runner.dead = True
            runner.death_cause = e
            _tasks_counter.inc(tags={"outcome": "crashed"})
            done(TaskResult(spec.task_id, ok=False,
                            error=WorkerCrashedError(str(e))))
        except BaseException as e:  # noqa: BLE001
            _tasks_counter.inc(tags={"outcome": "error"})
            done(TaskResult(spec.task_id, ok=False, error=e,
                            is_application_error=True))
        finally:
            with self._lock:
                self._running.pop(spec.task_id, None)

    def submit_direct(self, actor_id: ActorID, fn: Callable[[Any], None]) -> None:
        """Enqueue fn(instance) on the actor's mailbox (compiled-graph path).
        Raises if the actor is not alive here."""
        with self._lock:
            runner = self._actors.get(actor_id)
        if runner is None or runner.dead:
            raise WorkerCrashedError(f"actor {actor_id} is not alive on this node")
        runner.mailbox.put(("__direct__", fn))

    def kill_actor(self, actor_id: ActorID, cause: str = "killed") -> bool:
        with self._lock:
            runner = self._actors.get(actor_id)
            if runner is None:
                return False
            # dead flips INSIDE the lock: paired with _submit_actor_task's
            # locked check-and-register, so no registration can slip
            # between this and the sweep below
            runner.dead = True
            runner.death_cause = WorkerCrashedError(cause)
        runner.stop()
        if runner.process is not None:
            runner.process.terminate()
        if runner.held_resources:
            self.resources.release(runner.held_resources)
            runner.held_resources = {}
            self._sync_load()
        self._sweep_actor_pending(runner)
        # the lanes end at their stop sentinel (an async lane once its
        # executor's threads have ended): wait a bounded while, so a killed
        # actor leaves no thread behind; a lane still inside a long method
        # is left to finish on its own
        deadline = time.monotonic() + 2.0
        for t in runner.threads:
            if t is not threading.current_thread():
                t.join(timeout=max(0.0, deadline - time.monotonic()))
        _release_instance(runner)
        return True

    def _sweep_actor_pending(self, runner: _ActorRunner) -> None:
        """Fail any task whose done callback is still registered for a
        stopped runner — a callback a dead lane will never claim (e.g. a
        coroutine cancelled before its first step) must not hang its
        caller. Callbacks collected under the lock, invoked outside it
        (done callbacks re-enter the agent, e.g. kill on creation)."""
        to_fail = []
        with self._lock:
            for task_id in list(runner.pending_ids):
                runner.pending_ids.discard(task_id)
                done = self._pending_actor_dones.pop(task_id, None)
                if done is not None:
                    to_fail.append((task_id, done))
        for task_id, done in to_fail:
            done(TaskResult(task_id, ok=False, error=WorkerCrashedError(
                f"actor is dead: {runner.death_cause}")))

    def has_actor(self, actor_id: ActorID) -> bool:
        with self._lock:
            return actor_id in self._actors and not self._actors[actor_id].dead

    # ------------------------------------------------------- object transfer
    def _fetch_async(self, object_id: ObjectID, on_ready: Callable[[], None],
                     on_failed: Optional[Callable[[BaseException], None]] = None) -> None:
        """Pull an object from a remote node's store (the PullManager path,
        `src/ray/object_manager/pull_manager.cc`). In-process 'nodes' share an
        address space so the pull is a store-to-store handoff with byte
        accounting; multi-process nodes go through the shm/rpc plane."""

        def attempt() -> None:
            if self.store.contains(object_id):
                on_ready()
                return
            error = self._directory.failure(object_id)
            if error is not None and on_failed is not None:
                on_failed(error)
                return
            holder = self._directory.locate(object_id, exclude=self.node_id)
            if holder is not None:
                try:
                    # raw: a SealedBytes stays sealed across the hop, so the
                    # fresh-copy-per-get guarantee survives multi-node paths
                    value = holder.store.get_raw(object_id, timeout=5.0)
                    self.store.put(object_id, value)
                    self._directory.add_location(object_id, self.node_id)
                    on_ready()
                    return
                except (TimeoutError, ObjectLostError):
                    pass
            # not yet anywhere: wait for a seal notification via the directory
            self._directory.subscribe_once(object_id, attempt)

        attempt()

    # ------------------------------------------------------------- lifecycle
    def _sync_load(self) -> None:
        if self.suspend_heartbeat:
            return
        try:
            # short deadline when the control plane is remote: the head
            # monitor loop pumps every agent serially, so one unreachable
            # head must not stall the sweep for the full call deadline
            self._cp.heartbeat(self.node_id, self.resources.available(),
                               **self._hb_kwargs)
        except (ConnectionError, RuntimeError):
            pass  # head restarting; the next sweep retries

    def kill_running_tasks(self) -> None:
        """Failure injection: crash every task currently executing here."""
        with self._lock:
            events = list(self._running.values())
        for e in events:
            e.set()

    # ------------------------------------------------------ profiling plane
    # The node-local half of profile_start/profile_fetch: the agent's own
    # process is profiled in-process (util/profiler) — that is where CPU
    # tasks and device actors run; a subprocess child (actor process /
    # pool worker, see profilable_pids) is driven by the signal handlers
    # util/profiler.install_child_handlers registered at its startup — so
    # a HUNG child can still be stack-dumped (faulthandler needs no GIL).

    def _session(self) -> str:
        from .logging import session_dir

        return session_dir()

    def profilable_pids(self) -> Dict[str, Any]:
        """Every pid profiling can target on this node: the agent process
        plus live subprocess actor/pool workers."""
        import os

        actors: Dict[str, int] = {}
        with self._lock:
            runners = list(self._actors.items())
        for actor_id, runner in runners:
            proc = getattr(runner, "process", None)
            pid = getattr(proc, "pid", None) if proc is not None else None
            if pid:
                actors[actor_id.hex()] = int(pid)
        pool_pids: List[int] = []
        with self._pool_lock:
            pool = self._pool
        if pool:
            try:
                pool_pids = pool.worker_pids()
            except Exception:
                pool_pids = []
        return {"agent": os.getpid(), "actors": actors, "pool": pool_pids}

    def profile_start(self, pid: int = 0, duration_s: float = 5.0,
                      hz: Optional[float] = None, kind: str = "cpu",
                      logdir: str = "") -> Dict[str, Any]:
        """Open a profiling window. kind="cpu" starts the sampling
        profiler (in-process, or SIGUSR1-toggled in a child);
        kind="torch" captures a torch.profiler device trace (chrome-trace
        JSON) into `logdir` for `duration_s` — the counterpart of the
        reference's kind="jax" xplane capture, which the port refuses."""
        import os

        from ..util import profiler

        pid = int(pid or 0)
        if kind == "jax":
            raise ValueError(
                'profile_start(kind="jax"): the port\'s device trace is '
                'kind="torch" (a torch.profiler capture)')
        if kind == "torch":
            logdir = logdir or os.path.join(self._session(), "torch_trace")
            self._start_torch_trace(logdir, float(duration_s or 5.0))
            return {"pid": os.getpid(), "kind": "torch", "logdir": logdir}
        if pid in (0, os.getpid()):
            out = profiler.start_profile(duration_s=duration_s, hz=hz)
            return {**out, "kind": "cpu"}
        profiler.toggle_child_profile(pid)
        return {"pid": pid, "kind": "cpu", "running": True}

    def profile_fetch(self, pid: int = 0, kind: str = "cpu") -> Dict[str, Any]:
        """Collect: kind="stack" returns a live all-threads dump (works
        on a hung child via the faulthandler signal); kind="cpu" stops
        the sampling window and returns the collapsed-stack profile;
        kind="torch" waits for the device trace to be written and returns
        its files."""
        import os

        from ..util import profiler

        pid = int(pid or 0)
        if kind == "pids":
            return self.profilable_pids()
        if kind == "torch":
            return self._fetch_torch_trace()
        if kind == "stack":
            if pid in (0, os.getpid()):
                dump = profiler.dump_stacks()
                return {"pid": os.getpid(), "kind": "stack",
                        "threads": len(dump["threads"]),
                        "text": profiler.format_stacks(dump), "dump": dump}
            text = profiler.dump_child(pid, self._session())
            return {"pid": pid, "kind": "stack", "text": text}
        if pid in (0, os.getpid()):
            out = profiler.fetch_profile()
            return {"pid": out["pid"], "kind": "cpu",
                    "samples": out["samples"], "collapsed": out["collapsed"]}
        text = profiler.read_child_profile(pid, self._session())
        return {"pid": pid, "kind": "cpu", "collapsed": text}

    def _start_torch_trace(self, logdir: str, duration_s: float) -> None:
        """On-demand torch.profiler capture on this node, bounded and one
        at a time (the profiler cannot nest). Returns once the profiler
        records, so work started after the call is in the trace."""
        with self._lock:
            if self._torch_trace is not None and self._torch_trace["thread"].is_alive():
                raise RuntimeError("a torch trace capture is already running")
            state: Dict[str, Any] = {"logdir": logdir, "files": [], "error": None,
                                     "open": threading.Event()}
            self._torch_trace = state

        def _capture():
            import os

            try:
                from ..util import timeline

                before = set(os.listdir(logdir)) if os.path.isdir(logdir) else set()
                with timeline.trace_torch(logdir):
                    state["open"].set()
                    self._stopped.wait(max(0.1, duration_s))
                state["files"] = sorted(
                    os.path.join(logdir, n) for n in os.listdir(logdir)
                    if n not in before)
            except Exception as e:
                state["error"] = repr(e)
                logger.warning("torch trace capture failed: %r", e)
            finally:
                state["open"].set()

        state["thread"] = threading.Thread(target=_capture, daemon=True,
                                           name="torch-trace-capture")
        state["thread"].start()
        state["open"].wait(timeout=60.0)

    def _fetch_torch_trace(self, timeout_s: float = 120.0) -> Dict[str, Any]:
        """Wait for the open (or last) capture to be written."""
        with self._lock:
            state = self._torch_trace
        if state is None:
            return {"kind": "torch", "running": False, "files": []}
        state["thread"].join(timeout=timeout_s)
        running = state["thread"].is_alive()
        if state["error"] is not None:
            raise RuntimeError(f"torch trace capture failed: {state['error']}")
        return {"kind": "torch", "running": running, "logdir": state["logdir"],
                "files": list(state["files"])}

    def stop(self, notify: bool = True) -> None:
        # notify is part of the RemoteNodeAgent duck surface (suppresses
        # the remote stop frame); a local agent has no one to notify
        del notify
        self._stopped.set()
        if self._warmup is not None:  # a boot in flight ends before the stop
            self._warmup.join(timeout=30)
        with self._pool_lock:
            pool, self._pool = self._pool, False
        if pool:
            from .process_pool import release_shared_pool

            release_shared_pool()
        with self._lock:
            actors = list(self._actors.values())
        for runner in actors:
            runner.dead = True
            runner.death_cause = WorkerCrashedError("node stopped")
            runner.stop()
            if runner.process is not None:
                runner.process.terminate()
        self.kill_running_tasks()
        # fail everything still queued so owners see the crash, not a hang
        while True:
            try:
                item = self._task_queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                spec, done = item
                done(TaskResult(spec.task_id, ok=False,
                                error=WorkerCrashedError("node stopped")))
        with self._lock:
            pending = list(self._pending_actor_dones.items())
            self._pending_actor_dones.clear()
            self._stream_cbs.clear()
        for task_id, done in pending:
            done(TaskResult(task_id, ok=False,
                            error=WorkerCrashedError("node stopped")))
        # the worker lanes see _stopped within one queue poll (0.1 s) and the
        # actor lanes end at their stop sentinel: wait a bounded while for
        # them, so a stopped node leaves no thread behind (a lane still
        # inside a long task or method is left to finish on its own)
        deadline = time.monotonic() + 1.0
        lanes = list(self._threads) + [t for r in actors for t in r.threads]
        for t in lanes:
            if t is not threading.current_thread():
                t.join(timeout=max(0.0, deadline - time.monotonic()))
        for runner in actors:
            _release_instance(runner)


# failed objects a directory remembers (their errors hold tracebacks)
_FAILED_KEPT = 4096


class ObjectDirectory:
    """Cluster-wide object location registry.

    The reference's directory is ownership-based
    (`src/ray/object_manager/ownership_object_directory.cc`); a centralized
    map is equivalent for correctness at single-controller scale and keeps the
    pull path simple. Locations are node agents (for in-process pulls).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._locations: Dict[ObjectID, List[NodeID]] = {}
        # relay pullers mid-transfer: node -> bytes committed so far.
        # Partial holders never satisfy locate()/locations()/waiters —
        # they exist so the broadcast planner and the ledger can see
        # in-flight replicas, and so hygiene code can purge them.
        self._partials: Dict[ObjectID, Dict[NodeID, int]] = {}
        self._agents: Dict[NodeID, NodeAgent] = {}
        self._waiters: Dict[ObjectID, List[Callable[[], None]]] = {}
        # objects whose producing task failed for good: their error, so a
        # task waiting on one as an argument fails instead of waiting on
        # forever (ROADMAP C19; the reference's dependents hang)
        self._failed: Dict[ObjectID, BaseException] = {}
        # cross-host hook: every add_location also notifies joined worker
        # hosts via pubsub (set by cross_host.enable_cross_host)
        self.on_add: Optional[Callable[[ObjectID, NodeID], None]] = None
        # ...and every mark_failed, so a joined host's waiter re-checks
        self.on_failed: Optional[Callable[[ObjectID], None]] = None
        # liveness hook (set by Runtime): locate() skips holders on nodes
        # the control plane no longer reports ALIVE, closing the window
        # between a DEAD mark and the directory purge
        self.alive_check: Optional[Callable[[NodeID], bool]] = None

    def register_agent(self, agent: NodeAgent) -> None:
        with self._lock:
            self._agents[agent.node_id] = agent

    def unregister_agent(self, node_id: NodeID) -> None:
        with self._lock:
            self._agents.pop(node_id, None)
            for oid in list(self._locations):
                locs = [n for n in self._locations[oid] if n != node_id]
                if locs:
                    self._locations[oid] = locs
                else:
                    del self._locations[oid]
            for oid in list(self._partials):
                self._partials[oid].pop(node_id, None)
                if not self._partials[oid]:
                    del self._partials[oid]

    def add_location(self, object_id: ObjectID, node_id: NodeID,
                     bytes_available: Optional[int] = None) -> None:
        """Register a holder. With bytes_available, the node is a PARTIAL
        holder (a relay mid-transfer): recorded for observability but
        invisible to locate()/locations()/waiters until the full add
        arrives, which promotes it (drops the partial entry)."""
        if bytes_available is not None:
            with self._lock:
                self._partials.setdefault(object_id, {})[node_id] = int(bytes_available)
            return
        with self._lock:
            self._failed.pop(object_id, None)  # reconstructed after all
            locs = self._locations.setdefault(object_id, [])
            if node_id not in locs:
                locs.append(node_id)
            partials = self._partials.get(object_id)
            if partials is not None:
                partials.pop(node_id, None)
                if not partials:
                    del self._partials[object_id]
            callbacks = self._waiters.pop(object_id, [])
        for cb in callbacks:
            cb()
        if self.on_add is not None:
            self.on_add(object_id, node_id)

    def mark_failed(self, object_id: ObjectID, error: BaseException) -> None:
        """The object's producing task failed for good: record the error
        and wake the tasks waiting on the object, which then fail with it."""
        with self._lock:
            self._failed[object_id] = error
            while len(self._failed) > _FAILED_KEPT:  # the oldest go first
                del self._failed[next(iter(self._failed))]
            callbacks = self._waiters.pop(object_id, [])
        for cb in callbacks:
            cb()
        if self.on_failed is not None:
            self.on_failed(object_id)

    def failure(self, object_id: ObjectID) -> Optional[BaseException]:
        with self._lock:
            return self._failed.get(object_id)

    def remove_location(self, object_id: ObjectID, node_id: NodeID) -> None:
        with self._lock:
            locs = self._locations.get(object_id)
            if locs and node_id in locs:
                locs.remove(node_id)
                if not locs:
                    del self._locations[object_id]
            partials = self._partials.get(object_id)
            if partials is not None:
                partials.pop(node_id, None)
                if not partials:
                    del self._partials[object_id]

    def partial_locations(self, object_id: ObjectID) -> Dict[NodeID, int]:
        """Snapshot of in-flight relay holders: node -> bytes committed."""
        with self._lock:
            return dict(self._partials.get(object_id, {}))

    def locations(self, object_id: ObjectID) -> List[NodeID]:
        with self._lock:
            return list(self._locations.get(object_id, []))

    def items(self) -> Dict[ObjectID, List[NodeID]]:
        """Full location-table snapshot (object_ledger's dead-node sweep)."""
        with self._lock:
            return {oid: list(locs) for oid, locs in self._locations.items()}

    def locate(self, object_id: ObjectID, exclude: Optional[NodeID] = None,
               prefer_local: bool = False) -> Optional[NodeAgent]:
        """First live holder, in registration order. With prefer_local,
        holders rank local-shm < local-memory < remote (is_remote
        cross-host proxies): a same-host shm replica is a zero-copy map,
        a same-host memory replica is an in-process reference, and only
        when neither exists does the pull go over a socket."""
        alive_check = self.alive_check
        with self._lock:
            best = None
            best_tier = 3
            for node_id in self._locations.get(object_id, []):
                if node_id == exclude:
                    continue
                agent = self._agents.get(node_id)
                if agent is None or agent._stopped.is_set():
                    continue
                if alive_check is not None and not alive_check(node_id):
                    continue
                if not prefer_local:
                    return agent
                if getattr(agent, "is_remote", False):
                    tier = 2
                elif getattr(agent.store, "kind", "memory") == "shm":
                    tier = 0
                else:
                    tier = 1
                if tier == 0:
                    return agent
                if tier < best_tier:
                    best, best_tier = agent, tier
            return best

    def subscribe_once(self, object_id: ObjectID, callback: Callable[[], None]) -> None:
        with self._lock:
            if object_id in self._locations:
                fire = True
            else:
                fire = False
                self._waiters.setdefault(object_id, []).append(callback)
        if fire:
            callback()

    def drop_everywhere(self, object_id: ObjectID) -> None:
        with self._lock:
            node_ids = list(self._locations.pop(object_id, []))
            agents = [self._agents[n] for n in node_ids if n in self._agents]
        for agent in agents:
            agent.store.delete(object_id)
