"""Owner-side runtime: ObjectRefs, task manager (retries + lineage), actors.

Equivalent of the reference's CoreWorker (upstream ray
`src/ray/core_worker/core_worker.cc :: CoreWorker`, `task_manager.cc ::
TaskManager` for retries/lineage, `reference_count.cc :: ReferenceCounter`,
`object_recovery_manager.cc`): the driver (and each worker) owns the objects
and tasks it creates; retries on worker/node death are resubmitted from the
stored spec; lost objects are reconstructed from lineage.

The ``Runtime`` singleton composes the whole single-controller deployment:
control plane + object directory + cluster scheduler + node agents. Virtual
multi-node clusters (tests) add several agents; a real deployment runs one
agent per host with the same code.

The port's copy of ray_tpu/core/core_worker.py: ownership, lineage, retries,
actor restarts, the health monitor and the object ledger's sweep. The
control-plane RPC server, its snapshot writer, federation and the
cross-host transfer server (ROADMAP A5c) are not built in the port, so
shutdown has none to stop.
"""

from __future__ import annotations

import collections
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import object_ledger
from .config import config
from .control_plane import ActorInfo, ActorState, ControlPlane, NodeInfo
from .ids import ActorID, JobID, NodeID, ObjectID, TaskID
from .logging import get_logger
from .node_agent import (
    NodeAgent,
    ObjectDirectory,
    TaskResult,
    WorkerCrashedError,
)
from .object_store import ObjectLostError, SealedBytes
from .object_transfer import _cache_hits, _cache_misses
from .scheduler import ClusterScheduler
from .metrics import Counter as _MetricCounter
from .task_spec import (
    PlacementGroupSchedulingStrategy,
    SchedulingStrategy,
    TaskKind,
    TaskOptions,
    TaskSpec,
)

logger = get_logger("core_worker")

_m_local_admits = _MetricCounter(
    "scheduler_local_admits_total",
    "Tasks admitted by the local node agent's bottom-up fast path "
    "(no ClusterScheduler view walk)")


def _timeline_now_us() -> float:
    from ..util import timeline

    return timeline._now_us()


def release_frames(error: Optional[BaseException]) -> None:
    """Drop the local variables of every finished frame in the tracebacks
    of `error` and the exceptions chained to it (the file, function and
    line of each frame stay, so the traceback still prints). A kept error
    then pins none of what its frames held: a failed training loop's state
    on the card, for one. A deliberate difference: the reference's errors
    keep their frames' locals."""
    seen = set()
    while error is not None and id(error) not in seen:
        seen.add(id(error))
        traceback.clear_frames(error.__traceback__)
        error = error.__cause__ or error.__context__


class RayTaskError(Exception):
    """Wraps an application exception raised inside a task; re-raised on get."""

    def __init__(self, task_name: str, cause: BaseException):
        super().__init__(f"task {task_name} failed: {cause!r}")
        self.task_name = task_name
        self.cause = cause
        release_frames(cause)

    def __reduce__(self):
        # default Exception pickling replays only the formatted message —
        # the two-arg constructor then fails at LOAD time and the error
        # degrades to a generic RuntimeError on the far side of the wire
        return (RayTaskError, (self.task_name, self.cause))


class RayActorError(Exception):
    pass


class GetTimeoutError(TimeoutError):
    pass


class ObjectRef:
    """Handle to a (future) object. Comparable/hashable by ObjectID."""

    __slots__ = ("object_id", "_runtime", "__weakref__")

    def __init__(self, object_id: ObjectID, runtime: "Runtime | None" = None):
        self.object_id = object_id
        self._runtime = runtime
        if runtime is not None:
            runtime.reference_counter.add_ref(object_id)

    def hex(self) -> str:
        return self.object_id.hex()

    def __reduce__(self):
        # Crossing into a task: the receiving side resolves by id. Ownership
        # transfer bookkeeping is handled at submission time (deps list).
        runtime = self._runtime
        if runtime is not None:
            note = getattr(runtime, "note_escaped", None)
            if note is not None:
                # proxy-client refs (worker_api): an id leaving this
                # process may be deserialized long after our local count
                # hits zero — exempt it from auto-free
                note(self.object_id)
        return (_deserialize_ref, (self.object_id.binary(),))

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.object_id == self.object_id

    def __hash__(self):
        return hash(self.object_id)

    def __repr__(self):
        return f"ObjectRef({self.object_id.hex()[:16]})"

    def __del__(self):
        runtime = self._runtime
        if runtime is not None:
            try:
                runtime.reference_counter.remove_ref(self.object_id)
            except Exception:
                pass


def _deserialize_ref(binary: bytes) -> "ObjectRef":
    from . import core_worker as _self

    rt = _global_runtime
    return ObjectRef(ObjectID(binary), rt)


class ReferenceCounter:
    """Driver-side distributed refcount (simplified single-owner model).
    Escaped refs — ids that were pickled out of this process or into a
    task result/argument (see ``ObjectRef.__reduce__``) — are exempt from
    auto-free: a serialized copy may be deserialized long after every
    local Python handle has been collected."""

    def __init__(self, runtime: "Runtime"):
        self._runtime = runtime
        self._lock = threading.Lock()
        self._counts: Dict[ObjectID, int] = {}
        self._escaped: set = set()
        self.gc_enabled = True
        # releases queued by ObjectRef.__del__ (remove_ref), applied by
        # release_dropped
        self._released: "collections.deque[ObjectID]" = collections.deque()

    def add_ref(self, object_id: ObjectID) -> None:
        with self._lock:
            self._counts[object_id] = self._counts.get(object_id, 0) + 1

    def note_escaped(self, object_id: ObjectID) -> None:
        with self._lock:
            self._escaped.add(object_id)

    def remove_ref(self, object_id: ObjectID) -> None:
        """ObjectRef.__del__'s call. The garbage collector runs finalizers
        wherever an allocation triggers it, inside any critical section of
        the thread it interrupts (this counter's own, the store's, the
        runtime's), so this takes no lock and frees nothing: it queues the
        release (a deque append) for release_dropped. The reference counts
        down and frees here, under a lock that is not reentrant, and a
        collection inside add_ref deadlocks the thread on it."""
        self._released.append(object_id)

    def release_dropped(self) -> None:
        """Count down the queued releases and free each object whose last
        handle is gone. Called where the calling thread holds no runtime
        lock: at every API entry (api._auto_init) and on each pass of the
        runtime's monitor loop."""
        to_free = []
        with self._lock:
            while self._released:
                object_id = self._released.popleft()
                n = self._counts.get(object_id, 0) - 1
                if n > 0:
                    self._counts[object_id] = n
                    continue
                self._counts.pop(object_id, None)
                if self.gc_enabled and object_id not in self._escaped:
                    to_free.append(object_id)
        if not self._runtime.is_shutdown:
            for object_id in to_free:
                self._runtime.free_object(object_id)

    def count(self, object_id: ObjectID) -> int:
        with self._lock:
            return self._counts.get(object_id, 0)

    def is_escaped(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._escaped


@dataclass
class _PendingTask:
    spec: TaskSpec
    retries_left: int
    retry_exceptions: bool
    submitted_at: float = field(default_factory=time.monotonic)
    target_node: Optional[NodeID] = None
    pg_lease: Optional[Tuple[Any, int, Dict[str, float]]] = None
    # streaming tasks: per-item callback (index, ObjectID) threaded down to
    # the executing agent (None for ordinary tasks)
    stream: Optional[Callable[[int, ObjectID], None]] = None


class _StreamRecord:
    """Owner-side state of one streaming task's output sequence."""

    __slots__ = ("cv", "refs", "done", "error")

    def __init__(self):
        self.cv = threading.Condition()
        self.refs: List["ObjectRef"] = []
        self.done = False
        self.error: Optional[BaseException] = None


class ObjectRefGenerator:
    """Iterator over a streaming task's return refs, yielding each as soon
    as the producer seals it — the consumer runs concurrently with the
    still-executing task (reference: ObjectRefGenerator /
    num_returns="streaming"). A producer error raises HERE, after every
    item produced before the failure has been yielded."""

    # try_next() sentinel: the stream is exhausted (distinct from None =
    # "nothing sealed yet"); a sentinel rather than StopIteration so
    # callers inside generator bodies don't trip PEP 479
    DONE = object()

    def __init__(self, runtime: "Runtime", task_id: TaskID, record: _StreamRecord):
        self._runtime = runtime
        self.task_id = task_id
        self._record = record
        self._idx = 0

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> "ObjectRef":
        rec = self._record
        with rec.cv:
            while True:
                if self._idx < len(rec.refs):
                    ref = rec.refs[self._idx]
                    self._idx += 1
                    return ref
                if rec.done:
                    if rec.error is not None:
                        raise rec.error
                    raise StopIteration
                rec.cv.wait(timeout=1.0)

    def try_next(self):
        """Non-blocking poll: the next sealed ref, None while the producer
        is still working on the next one, or ObjectRefGenerator.DONE once
        the stream is exhausted (raising the producer's error first, after
        every ref sealed before the failure has been handed out). Lets a
        multiplexing consumer drain whichever of several streams has data
        without parking on any single one."""
        rec = self._record
        with rec.cv:
            if self._idx < len(rec.refs):
                ref = rec.refs[self._idx]
                self._idx += 1
                return ref
            if rec.done:
                if rec.error is not None:
                    raise rec.error
                return ObjectRefGenerator.DONE
            return None

    def completed(self) -> bool:
        return self._record.done


class _Future:
    """Completion latch. wait()/get() park on the event as before;
    Runtime.wait registers per-future callbacks so N waiters over M refs
    cost one notification each instead of a 1ms busy-poll O(M) rescan."""

    __slots__ = ("event", "error", "_lock", "_waiters", "_next_token")

    def __init__(self):
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._waiters: Dict[int, Callable[[], None]] = {}
        self._next_token = 0

    def finish(self, error: Optional[BaseException] = None) -> None:
        """Complete the future and fire registered waiters exactly once
        (idempotent — concurrent producers race benignly)."""
        with self._lock:
            if error is not None and self.error is None:
                self.error = error
            if self.event.is_set():
                return
            self.event.set()
            waiters = list(self._waiters.values())
            self._waiters.clear()
        for cb in waiters:
            try:
                cb()
            except Exception:  # noqa: BLE001 — a waiter never blocks completion
                pass

    def add_waiter(self, callback: Callable[[], None]) -> Optional[int]:
        """Register a completion callback; fires immediately (returning
        None) if already complete, else returns a token for remove_waiter."""
        with self._lock:
            if not self.event.is_set():
                self._next_token += 1
                token = self._next_token
                self._waiters[token] = callback
                return token
        callback()
        return None

    def remove_waiter(self, token: Optional[int]) -> None:
        if token is None:
            return
        with self._lock:
            self._waiters.pop(token, None)


class Runtime:
    """The composed deployment. One per process (see init/shutdown in api)."""

    def __init__(self, job_id: Optional[JobID] = None):
        self.job_id = job_id or JobID.next()
        self.control_plane = ControlPlane()
        self.directory = ObjectDirectory()
        # locate() consults this so it never hands a puller a holder on a
        # node the control plane already marked DEAD (satellite fix; the
        # DEAD-mark -> directory-purge window used to leak through)
        self.directory.alive_check = self._node_is_alive
        self.scheduler = ClusterScheduler(
            self.control_plane, config.scheduler_spread_threshold
        )
        self.reference_counter = ReferenceCounter(self)
        self.agents: Dict[NodeID, NodeAgent] = {}
        self.head_node_id: Optional[NodeID] = None
        self.is_shutdown = False
        # With an autoscaler attached, currently-infeasible demands stay
        # pending (they ARE the scale-up signal) instead of failing fast.
        self.autoscaling_enabled = False
        self._lock = threading.RLock()
        self._futures: Dict[ObjectID, _Future] = {}
        self._task_table: Dict[TaskID, Dict[str, Any]] = {}
        self._pending: List[_PendingTask] = []
        self._pending_cv = threading.Condition()
        self._lineage: Dict[ObjectID, TaskSpec] = {}
        self._actor_specs: Dict[ActorID, TaskSpec] = {}
        self._put_index = 0
        # batched-get fan-out pool (lazy; config.get_concurrency workers)
        self._get_pool = None
        self._get_pool_lock = threading.Lock()
        # object ids this runtime pulled through from a remote holder and
        # sealed locally — distinguishes cache hits from plain local gets
        self._pulled_through: set = set()
        self._cache_lock = threading.Lock()
        # lost-object recovery coalescing: concurrent waiters on one lost
        # object share a single reconstruction (parallel get makes the
        # many-waiters race the common case, not the corner case)
        self._reconstruct_inflight: Dict[ObjectID, Dict[str, Any]] = {}
        self._reconstruct_lock = threading.Lock()
        self._driver_task_id = TaskID.of()
        self._sched_thread = threading.Thread(
            target=self._scheduling_loop, daemon=True, name="cluster-scheduler"
        )
        self._sched_thread.start()
        self._last_gossip_sweep = time.monotonic()  # TTL sweep throttle
        # set by shutdown: wakes the monitor's wait between sweeps, so the
        # thread ends with the runtime instead of a period later
        self._stop_event = threading.Event()
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, daemon=True, name="health-monitor"
        )
        self._monitor_thread.start()
        self.control_plane.register_job(self.job_id)
        # placement group table: (pg_id, bundle_index) -> NodeID
        self.pg_table: Dict[Tuple, NodeID] = {}
        from ..sched.placement_group import PlacementGroupManager  # lazy: cycle

        self.pg_manager = PlacementGroupManager(self)
        self._actor_pg: Dict[ActorID, Tuple[Any, int, Dict[str, float]]] = {}
        # ICI slice registry: slice_id -> SliceInfo (topology + packer +
        # host->node map) consumed by topology-aware gang placement.
        self.slices: Dict[Any, Any] = {}

    def register_slice(self, slice_info) -> None:
        """Register a physical slice's topology so placement groups can
        reserve contiguous sub-boxes on it (sched/topology.py::SliceInfo)."""
        with self._lock:
            self.slices[slice_info.slice_id] = slice_info
        # new capacity: gangs queued for topology must get a pass now, not
        # when some unrelated group happens to be removed (upstream:
        # gcs_placement_group_manager pending-queue retry on node add)
        self.pg_manager._retry_queued()

    def unregister_slice(self, slice_id) -> None:
        with self._lock:
            self.slices.pop(slice_id, None)

    # ------------------------------------------------------------- topology
    def add_node(
        self,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        is_head: bool = False,
        **node_kwargs,
    ) -> NodeAgent:
        resources = dict(resources or {"CPU": 8.0})
        info = NodeInfo(
            node_id=NodeID.generate(),
            address=f"local:{len(self.agents)}",
            resources_total=resources,
            labels=labels or {},
            **node_kwargs,
        )
        agent = NodeAgent(info, self.control_plane, self.directory)
        self.directory.register_agent(agent)
        self.control_plane.register_node(info)
        with self._lock:
            self.agents[info.node_id] = agent
            if is_head or self.head_node_id is None:
                self.head_node_id = info.node_id
                # re-stamp every cycle: after shutdown()+init() this
                # process's identity is the NEW head node, and flow dst
                # labels must follow it
                object_ledger.set_local_node(info.node_id.hex())
        # node join = new capacity: kick queued placement groups too
        self.pg_manager._retry_queued()
        self._kick_scheduler()
        return agent

    def remove_node(self, node_id: NodeID, notify: bool = False) -> None:
        """Drop a node: tasks crash, objects are lost.

        notify=False (default, crash/reap semantics): a reaped REMOTE host
        may only be partitioned — the stop frame would kill a survivor that
        is about to rejoin. Clean worker exits still happen via
        Runtime.shutdown's stop(), and local (in-process) agents ignore the
        flag. notify=True is for DELIBERATE removal (autoscaler scale-down):
        the stop frame tells the worker to exit instead of rejoining."""
        with self._lock:
            agent = self.agents.pop(node_id, None)
            if agent is not None and self.head_node_id == node_id:
                # re-home the driver to any surviving node
                self.head_node_id = next(iter(self.agents), None)
        if agent is None:
            return
        # stop before mark_node_dead: a notified worker must learn it was
        # deliberately removed BEFORE its heartbeat sees the DEAD state, or
        # it would race a rejoin against its own shutdown
        agent.stop(notify=notify)
        self.control_plane.mark_node_dead(node_id, "removed")
        self.directory.unregister_agent(node_id)
        # actors on that node die; restart-eligible ones are rescheduled
        for actor in self.control_plane.list_actors():
            if actor.node_id == node_id and actor.state is ActorState.ALIVE:
                self._on_actor_death(actor, WorkerCrashedError("node died"))
        self._kick_scheduler()

    def _node_is_alive(self, node_id: NodeID) -> bool:
        from .control_plane import NodeState

        info = self.control_plane.get_node(node_id)
        # unknown to the control plane = not ours to veto (directory-only
        # holders, e.g. duck-typed stores); filter only tracked-and-DEAD
        return info is None or info.state is NodeState.ALIVE

    @property
    def driver_agent(self) -> NodeAgent:
        with self._lock:
            if self.head_node_id is None or self.head_node_id not in self.agents:
                raise RuntimeError("no alive node to host driver objects")
            return self.agents[self.head_node_id]

    # ------------------------------------------------------------ submission
    def _prepare_runtime_env(self, spec: TaskSpec) -> None:
        """Ship working_dir through the control-plane KV at submission, so
        the spec carries a content-addressed uri any executing node — a
        joined host included — can resolve (runtime_env.package_working_dir
        / resolve; reference: GCS package upload in working_dir.py)."""
        renv = spec.options.runtime_env
        if not renv or not renv.get("working_dir"):
            return
        import dataclasses

        from . import runtime_env

        wd = renv["working_dir"]
        cache = getattr(self, "_wd_uri_cache", None)
        if cache is None:
            cache = self._wd_uri_cache = {}
        uri = cache.get(wd)
        if uri is not None:
            # once per distinct dir, not per task: content-addressed uri
            # reused (snapshot-at-first-submission semantics, like the
            # reference's once-per-job package upload)
            packaged = dict(renv)
            packaged.pop("working_dir")
            packaged["working_dir_uri"] = uri
        else:
            packaged = runtime_env.package_working_dir(renv, self.control_plane)
            cache[wd] = packaged["working_dir_uri"]
        # replace, never mutate: options objects are shared across calls
        spec.options = dataclasses.replace(spec.options, runtime_env=packaged)

    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        self._prepare_runtime_env(spec)
        refs = [ObjectRef(oid, self) for oid in spec.return_ids]
        retries = (
            spec.options.max_retries
            if spec.options.max_retries is not None
            else config.task_max_retries
        )
        with self._lock:
            for oid in spec.return_ids:
                self._futures[oid] = _Future()
                self._lineage[oid] = spec
            self._task_table[spec.task_id] = {
                "name": spec.name,
                "state": "PENDING",
                "kind": spec.kind.value,
                "attempt": spec.attempt,
                "ts_submit": _timeline_now_us(),
            }
        pending = _PendingTask(
            spec, retries_left=retries, retry_exceptions=spec.options.retry_exceptions
        )
        self._enqueue_pending(pending)
        return refs

    def submit_streaming_task(self, spec: TaskSpec) -> ObjectRefGenerator:
        """Submit a generator task; returns the ref generator immediately.

        Crash retries apply only while the stream is EMPTY (a worker dying
        before the first yield replays transparently, matching ordinary
        read-task resilience); once any item has sealed, a partial stream
        cannot replay and the failure surfaces after the yielded prefix.
        No lineage reconstruction for streamed objects."""
        self._prepare_runtime_env(spec)
        record = _StreamRecord()

        def on_item(index: int, oid: ObjectID) -> None:
            ref = ObjectRef(oid, self)
            with record.cv:
                # index is authoritative: items may arrive batched but
                # never out of order (single producer)
                record.refs.append(ref)
                record.cv.notify_all()

        with self._lock:
            self._task_table[spec.task_id] = {
                "name": spec.name,
                "state": "PENDING",
                "kind": spec.kind.value,
                "attempt": 0,
                "ts_submit": _timeline_now_us(),
            }
            self._streams = getattr(self, "_streams", {})
            self._streams[spec.task_id] = record
        retries = (
            spec.options.max_retries
            if spec.options.max_retries is not None
            else config.task_max_retries
        )
        self._enqueue_pending(_PendingTask(
            spec, retries_left=retries, retry_exceptions=False, stream=on_item,
        ))
        return ObjectRefGenerator(self, spec.task_id, record)

    def create_actor(self, cls, args, kwargs, options: TaskOptions) -> "ActorInfo":
        actor_id = ActorID.of(self.job_id)
        task_id = TaskID.of(actor_id)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            kind=TaskKind.ACTOR_CREATION,
            func=cls,
            args=args,
            kwargs=kwargs,
            options=options,
            return_ids=[ObjectID.for_task_return(task_id, 0)],
            actor_id=actor_id,
            dependencies=_collect_deps(args, kwargs),
        )
        self._prepare_runtime_env(spec)
        info = ActorInfo(
            actor_id=actor_id,
            name=options.name,
            class_name=getattr(cls, "__name__", "Actor"),
            max_restarts=options.max_restarts,
        )
        self.control_plane.register_actor(info)
        with self._lock:
            self._actor_specs[actor_id] = spec
            self._futures[spec.return_ids[0]] = _Future()
            self._task_table[task_id] = {
                "name": f"{getattr(cls, '__name__', 'Actor')}.__init__",
                "state": "PENDING",
                "kind": spec.kind.value,
                "attempt": 0,
                "ts_submit": _timeline_now_us(),
            }
        self._enqueue_pending(_PendingTask(spec, retries_left=0, retry_exceptions=False))
        return info

    def submit_actor_task(
        self, actor_id: ActorID, method_name: str, args, kwargs, options: TaskOptions,
        trace_ctx: Optional[Dict[str, str]] = None,
    ) -> List[ObjectRef]:
        if trace_ctx is None:
            from ..util import tracing

            trace_ctx = tracing.current_context()
        task_id = TaskID.of(actor_id)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            kind=TaskKind.ACTOR_TASK,
            func=None,
            args=args,
            kwargs=kwargs,
            options=options,
            return_ids=[
                ObjectID.for_task_return(task_id, i)
                for i in range(max(1, options.num_returns))
            ],
            actor_id=actor_id,
            method_name=method_name,
            dependencies=_collect_deps(args, kwargs),
            trace_ctx=trace_ctx,
        )
        refs = [ObjectRef(oid, self) for oid in spec.return_ids]
        with self._lock:
            for oid in spec.return_ids:
                self._futures[oid] = _Future()
                self._lineage[oid] = spec
            self._task_table[spec.task_id] = {
                "name": f"{method_name}",
                "state": "PENDING",
                "kind": spec.kind.value,
                "attempt": 0,
                "ts_submit": _timeline_now_us(),
            }
        retries = options.max_task_retries
        self._enqueue_pending(_PendingTask(spec, retries_left=retries, retry_exceptions=False))
        return refs

    # -------------------------------------------------------------- get/put
    def put(self, value: Any) -> ObjectRef:
        with self._lock:
            self._put_index += 1
            oid = ObjectID.for_put(self._driver_task_id, self._put_index)
        agent = self.driver_agent
        from .object_store import seal_value

        # aliasing-safe: the caller may keep mutating `value` after put()
        agent.store.put(oid, seal_value(value))
        agent.store.annotate(oid, pin_reason=object_ledger.PIN_USER_PUT,
                             creator_task="driver")
        self.directory.add_location(oid, agent.node_id)
        fut = _Future()
        fut.finish()
        with self._lock:
            self._futures[oid] = fut
        return ObjectRef(oid, self)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        """Resolve a batch of refs. Distinct object ids are deduped (each
        resolves once, every requesting slot shares the value) and fanned
        out over a bounded pool, so pulls from different holders overlap
        and the batch completes in ~max of the individual pull times. All
        refs share ONE deadline derived from `timeout`, instead of each
        ref re-budgeting whatever time the previous ones left."""
        refs = list(refs)
        if not refs:
            return []
        deadline = None if timeout is None else time.monotonic() + timeout
        distinct: "Dict[ObjectID, List[int]]" = {}
        for idx, ref in enumerate(refs):
            distinct.setdefault(ref.object_id, []).append(idx)
        uniques = [refs[slots[0]] for slots in distinct.values()]
        if len(uniques) == 1 or config.get_concurrency <= 1:
            results = [self._get_one(ref, deadline) for ref in uniques]
        else:
            # pool threads don't inherit this thread's trace context —
            # re-activate it around each pull so object_pull spans still
            # parent under the caller's span (None ctx: activate no-ops)
            from ..util import tracing

            ctx = tracing.current_context()

            def _traced_get_one(ref):
                with tracing.activate(ctx):
                    return self._get_one(ref, deadline)

            pool = self._get_executor()
            futures = [pool.submit(_traced_get_one, ref)
                       for ref in uniques]
            results, first_error = [], None
            for f in futures:
                try:
                    results.append(f.result())
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    results.append(None)
                    if first_error is None:
                        first_error = e
            if first_error is not None:
                # deterministic: the earliest failing ref wins, matching
                # what the serial loop would have raised first
                raise first_error
        out: List[Any] = [None] * len(refs)
        for value, slots in zip(results, distinct.values()):
            for idx in slots:
                out[idx] = value
        return out

    def _get_executor(self):
        with self._get_pool_lock:
            if self._get_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._get_pool = ThreadPoolExecutor(
                    max_workers=max(1, int(config.get_concurrency)),
                    thread_name_prefix="object-get",
                )
            return self._get_pool

    def _get_one(self, ref: ObjectRef, deadline: Optional[float]) -> Any:
        oid = ref.object_id
        fut = self._future_for(oid)
        remaining = (None if deadline is None
                     else max(0.0, deadline - time.monotonic()))
        if not fut.event.wait(remaining):
            raise GetTimeoutError(f"get() timed out on {ref}")
        if fut.error is not None:
            raise fut.error
        holder = self.directory.locate(oid, prefer_local=True)
        if holder is None:
            # object lost (e.g. node died) — attempt lineage reconstruction
            if self._reconstruct_once(oid, deadline):
                return self._get_one(ref, deadline)
            raise ObjectLostError(oid)
        try:
            if not getattr(holder, "is_remote", False):
                with self._cache_lock:
                    if oid in self._pulled_through:
                        _cache_hits.inc()
                return holder.store.get(oid, timeout=10.0)
            if config.object_pull_through_cache:
                return self._pull_through(oid, holder)
            return holder.store.get(oid, timeout=10.0)
        except (TimeoutError, ObjectLostError):
            # holder died between locate and pull (remote store proxies
            # surface this as ObjectLostError) — one coalesced
            # reconstruction attempt, retried against the REMAINING time
            # to the shared deadline, not the original timeout
            self.directory.remove_location(oid, holder.node_id)
            if self._reconstruct_once(oid, deadline):
                return self._get_one(ref, deadline)
            raise ObjectLostError(oid)

    def _pull_through(self, oid: ObjectID, holder) -> Any:
        """Remote get with pull-through caching: fetch the SEALED payload,
        seal it into the local driver store, and register the new location
        — repeat gets become local hits and later pullers anywhere in the
        cluster can fetch from us instead of the origin (broadcast fans
        out instead of hammering one holder). Objects are immutable once
        sealed, so the replica can never go stale. Caching is best-effort:
        any failure degrades to returning the pulled value."""
        _cache_misses.inc()
        raw = holder.store.get_raw(oid, timeout=10.0)
        try:
            agent = self.driver_agent
            if not getattr(agent, "is_remote", False):
                agent.store.put(oid, raw)
                agent.store.annotate(oid, pin_reason=object_ledger.PIN_CACHE)
                self.directory.add_location(oid, agent.node_id)
                with self._cache_lock:
                    self._pulled_through.add(oid)
                return agent.store.get(oid, timeout=0.0)
        except Exception:  # noqa: BLE001 — caching never fails the get
            logger.debug("pull-through cache of %s failed", oid, exc_info=True)
        return raw.load() if isinstance(raw, SealedBytes) else raw

    def _reconstruct_once(self, oid: ObjectID,
                          deadline: Optional[float]) -> bool:
        """Lineage recovery, coalesced: the first waiter to notice the loss
        leads the reconstruction; concurrent waiters for the same object
        block on its outcome instead of re-running the producing task once
        per waiter."""
        with self._reconstruct_lock:
            rec = self._reconstruct_inflight.get(oid)
            leader = rec is None
            if leader:
                rec = {"event": threading.Event(), "ok": False}
                self._reconstruct_inflight[oid] = rec
        if leader:
            try:
                rec["ok"] = self._try_reconstruct(oid)
            finally:
                with self._reconstruct_lock:
                    self._reconstruct_inflight.pop(oid, None)
                rec["event"].set()
            return bool(rec["ok"])
        remaining = (60.0 if deadline is None
                     else max(0.0, deadline - time.monotonic()))
        rec["event"].wait(remaining)
        return bool(rec["ok"])

    def broadcast(self, ref: ObjectRef,
                  nodes: Optional[Sequence[NodeID]] = None,
                  timeout: float = 120.0) -> Dict[str, Any]:
        """Disseminate one sealed object to every node (or the `nodes`
        subset) ahead of demand. In-process agents get a zero-copy store
        reference; remote hosts are dispatched `prefetch_object` in
        topology-ordered waves sized to the current replica count times
        `config.object_broadcast_fanout`, so concurrent pullers in a wave
        self-organize into the pipelined relay tree (each serves its
        committed prefix onward) and each completed wave multiplies the
        sources for the next. Returns {"object_id", "warmed", "failed"};
        per-node failures are recorded, never raised."""
        from .object_transfer import HOST_PREFIX, purge_relay_claims

        oid = ref.object_id
        fut = self._future_for(oid)
        if not fut.event.wait(timeout):
            raise GetTimeoutError(f"broadcast() timed out waiting on {ref}")
        if fut.error is not None:
            raise fut.error
        holders = set(self.directory.locations(oid))
        if not holders:
            if not self._reconstruct_once(oid, None):
                raise ObjectLostError(oid)
            holders = set(self.directory.locations(oid))
        with self._lock:
            agents = dict(self.agents)
        wanted = None if nodes is None else set(nodes)
        targets = [
            a for nid, a in agents.items()
            if nid not in holders
            and (wanted is None or nid in wanted)
            and not a._stopped.is_set()
            and self._node_is_alive(nid)
        ]
        warmed: List[str] = []
        failed: List[Tuple[str, str]] = []
        local = [a for a in targets if not getattr(a, "is_remote", False)]
        remote = [a for a in targets if getattr(a, "is_remote", False)]
        if local:
            src = self.directory.locate(oid, prefer_local=True)
            if src is not None:
                raw = src.store.get_raw(oid, timeout=30.0)
                for a in local:
                    try:
                        a.store.put(oid, raw)
                        a.store.annotate(
                            oid, pin_reason=object_ledger.PIN_CACHE)
                        self.directory.add_location(oid, a.node_id)
                        warmed.append(a.node_id.hex())
                    except Exception as e:  # noqa: BLE001 — per-node report
                        failed.append((a.node_id.hex(), repr(e)))

        def _host_of(a) -> str:
            try:
                tok = self.control_plane.kv_get(HOST_PREFIX + a.node_id.hex())
                return tok or ""
            except Exception:  # noqa: BLE001 — ordering is advisory
                return ""

        # same-host nodes adjacent in dispatch order -> adjacent relay
        # slots -> intra-host tree edges ride shm/loopback, not the fabric
        remote.sort(key=lambda a: (_host_of(a), a.node_id.hex()))
        fanout = max(1, int(config.object_broadcast_fanout))
        capacity = max(1, len(holders))
        deadline = time.monotonic() + timeout
        i = 0
        while i < len(remote):
            wave = remote[i:i + capacity * fanout]
            i += len(wave)
            results: Dict[NodeID, Any] = {}

            def _pull(a):
                left = max(1.0, deadline - time.monotonic())
                try:
                    a.prefetch_object(oid.hex(), timeout=left)
                    results[a.node_id] = True
                except Exception as e:  # noqa: BLE001 — per-node report
                    results[a.node_id] = e

            threads = [threading.Thread(target=_pull, args=(a,), daemon=True,
                                        name="broadcast-wave")
                       for a in wave]
            for t in threads:
                t.start()
            for t in threads:
                t.join(max(1.0, deadline - time.monotonic()))
            for a in wave:
                got = results.get(a.node_id)
                if got is True:
                    warmed.append(a.node_id.hex())
                    capacity += 1
                else:
                    failed.append((a.node_id.hex(),
                                   repr(got) if got else "timed out"))
        purge_relay_claims(oid.hex(), self.control_plane)
        return {"object_id": oid.hex(), "warmed": warmed, "failed": failed}

    def wait(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int = 1,
        timeout: Optional[float] = None,
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        """Block until num_returns refs complete. Completion-driven: each
        future notifies a shared condition variable, so the wait costs one
        wakeup per completion instead of a 1ms busy-poll that rescans all
        refs (which burned a core at high fan-in)."""
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds number of refs")
        refs = list(refs)
        if num_returns <= 0:
            return [], refs
        deadline = None if timeout is None else time.monotonic() + timeout
        cv = threading.Condition()
        done_indices: List[int] = []

        def _on_done(idx: int) -> None:
            with cv:
                done_indices.append(idx)
                cv.notify_all()

        registrations: List[Tuple[_Future, Optional[int]]] = []
        try:
            for idx, ref in enumerate(refs):
                fut = self._future_for(ref.object_id)
                registrations.append(
                    (fut, fut.add_waiter(lambda i=idx: _on_done(i))))
            with cv:
                while len(done_indices) < num_returns:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        break
                    cv.wait(remaining)
                chosen = set(sorted(done_indices)[:num_returns])
        finally:
            # always deregister: leaked waiters would accumulate on
            # long-lived futures across repeated wait() calls
            for fut, token in registrations:
                fut.remove_waiter(token)
        ready = [ref for i, ref in enumerate(refs) if i in chosen]
        pending = [ref for i, ref in enumerate(refs) if i not in chosen]
        return ready, pending

    def _future_for(self, oid: ObjectID) -> _Future:
        with self._lock:
            fut = self._futures.get(oid)
            if fut is None:
                # ref arrived from another process / was reconstructed
                fut = _Future()
                if self.directory.locations(oid):
                    fut.finish()
                else:
                    self.directory.subscribe_once(oid, fut.finish)
                self._futures[oid] = fut
            return fut

    def note_escaped(self, object_id: ObjectID) -> None:
        """Called from ObjectRef.__reduce__: this id was serialized (task
        result, nested argument, cross-process send) — exempt it from
        refcount-zero auto-free so the deserialized copy still resolves."""
        self.reference_counter.note_escaped(object_id)
        # stamp the pin reason wherever the object lives locally, so the
        # ledger can answer WHY the entry outlives its python handles
        with self._lock:
            agents = list(self.agents.values())
        for agent in agents:
            if getattr(agent, "is_remote", False):
                continue
            store = getattr(agent, "store", None)
            if store is not None and store.contains(object_id):
                store.annotate(object_id,
                               pin_reason=object_ledger.PIN_ESCAPED)

    def free_object(self, object_id: ObjectID) -> None:
        with self._lock:
            self._futures.pop(object_id, None)
            self._lineage.pop(object_id, None)
        with self._cache_lock:
            self._pulled_through.discard(object_id)
        self.directory.drop_everywhere(object_id)

    # ---------------------------------------------------------- health check
    def _monitor_loop(self) -> None:
        """Pump agent heartbeats and reap nodes whose heartbeat went stale
        (reference: `gcs_health_check_manager.cc` periodic ping)."""
        period = config.health_check_period_ms / 1000.0
        timeout = config.health_check_timeout_ms / 1000.0
        while not self.is_shutdown:
            if self._stop_event.wait(period):
                return
            with self._lock:
                agents = list(self.agents.values())
            for agent in agents:
                if not agent._stopped.is_set():
                    agent._sync_load()
            self.reference_counter.release_dropped()
            for node_id in self.control_plane.check_health(timeout):
                logger.warning("health check: reaping node %s", node_id.hex()[:8])
                self.remove_node(node_id)
            try:
                # throttles itself to config.object_sweep_period_s
                object_ledger.sweep(self)
            except Exception:  # noqa: BLE001 — sweep never kills the monitor
                logger.debug("object leak sweep failed", exc_info=True)
            now = time.monotonic()
            ttl = float(config.control_plane_gossip_ttl_s)
            if now - self._last_gossip_sweep > max(ttl / 4.0, period):
                self._last_gossip_sweep = now
                try:
                    self.control_plane.sweep_gossip()
                except Exception:  # noqa: BLE001
                    logger.debug("gossip TTL sweep failed", exc_info=True)

    def pending_resource_demand(self) -> List[Dict[str, float]]:
        """Resource shapes of queued-but-unplaced tasks — the autoscaler's
        demand signal (reference: resource load reported to GCS)."""
        with self._pending_cv:
            batch = list(self._pending)
        return [item.spec.options.resource_demand() for item in batch]

    # ------------------------------------------------------------ scheduling
    def _enqueue_pending(self, pending: _PendingTask) -> None:
        with self._pending_cv:
            self._pending.append(pending)
            self._pending_cv.notify_all()

    def _kick_scheduler(self) -> None:
        with self._pending_cv:
            self._pending_cv.notify_all()

    def _scheduling_loop(self) -> None:
        while not self.is_shutdown:
            with self._pending_cv:
                if not self._pending:
                    self._pending_cv.wait(timeout=0.05)
                batch = list(self._pending)
                self._pending.clear()
            leftover: List[_PendingTask] = []
            # an actor's calls run in submission order: once one of them is
            # left over (its actor still starting), its later calls in this
            # batch wait behind it, and the leftovers go back AHEAD of what
            # was submitted meanwhile (the reference appends them behind,
            # so a call made during this pass can overtake them: C7)
            held = set()
            for item in batch:
                actor_id = (item.spec.actor_id
                            if item.spec.kind is TaskKind.ACTOR_TASK else None)
                if actor_id is not None and actor_id in held:
                    leftover.append(item)
                elif not self._try_place(item):
                    leftover.append(item)
                    if actor_id is not None:
                        held.add(actor_id)
            if leftover:
                with self._pending_cv:
                    self._pending[:0] = leftover
                time.sleep(0.002)

    def _usable_agent(self, node_id: Optional[NodeID]):
        """Agent for node_id, or None if absent or stopped. A stopped
        agent (e.g. a remote proxy whose connection dropped before the
        health check reaps the node) must read as 'unavailable now' —
        submitting to it would fail instantly and burn the task's whole
        retry budget in milliseconds instead of failing over."""
        if node_id is None:
            return None
        agent = self.agents.get(node_id)
        if agent is None or agent._stopped.is_set():
            return None
        return agent

    def _local_admit(self, spec: TaskSpec, strategy) -> Optional[NodeID]:
        """Bottom-up fast path: defer to NodeAgent.try_admit on the head's
        own agent for plain default-strategy tasks. Returns the node to
        place on, or None = take the global path (which also preserves
        fail-fast ValueError and the autoscaler's pending-demand signal)."""
        if not config.scheduler_local_admit:
            return None
        if type(strategy) is not SchedulingStrategy:
            return None  # affinity/spread/label/PG need the cluster view
        agent = self._usable_agent(self.head_node_id)
        if agent is None or not hasattr(agent, "try_admit"):
            return None  # remote/proxied agent: no local view to consult
        if agent.try_admit(spec.options.resource_demand()):
            _m_local_admits.inc()
            return self.head_node_id
        return None

    def _try_place(self, item: _PendingTask) -> bool:
        spec = item.spec
        strategy = spec.options.scheduling_strategy
        if spec.kind is not TaskKind.ACTOR_TASK and isinstance(
            strategy, PlacementGroupSchedulingStrategy
        ):
            return self._try_place_in_pg(item, strategy)
        if spec.kind is TaskKind.ACTOR_TASK:
            actor = self.control_plane.get_actor(spec.actor_id)
            if actor is None or actor.state is ActorState.DEAD:
                self._fail_task(item, RayActorError(
                    f"actor {spec.actor_id.hex()[:8]} is dead: "
                    f"{actor.death_cause if actor else 'unknown'}"))
                return True
            if actor.state is not ActorState.ALIVE or actor.node_id is None:
                return False  # wait for (re)start
            agent = self._usable_agent(actor.node_id)
            if agent is None:
                return False
            self._mark_task(spec.task_id, "RUNNING")
            agent.submit(spec, lambda result: self._on_task_done(item, result),
                         stream=item.stream)
            return True

        # bottom-up fast path: the local node agent admits against its own
        # resource view (fresher than the control plane's) when the demand
        # fits under the spread threshold — exactly the node _hybrid's
        # local-first rule would pick, without walking the cluster view.
        # Overflow (and every non-default strategy) delegates to the
        # ClusterScheduler, preserving fail-fast and autoscaler demand.
        node_id = self._local_admit(spec, strategy)
        if node_id is None:
            try:
                node_id = self.scheduler.select_node(
                    spec, preferred_node=self.head_node_id, pg_table=self.pg_table
                )
            except ValueError as e:
                if self.autoscaling_enabled:
                    return False  # keep pending: this demand drives scale-up
                self._fail_task(item, e)
                return True
        if node_id is None:
            return False
        agent = self._usable_agent(node_id)
        if agent is None:
            return False
        item.target_node = node_id
        if spec.kind is TaskKind.ACTOR_CREATION:
            self.control_plane.update_actor(spec.actor_id, ActorState.STARTING, node_id)
        self._mark_task(spec.task_id, "RUNNING")
        agent.submit(spec, lambda result: self._on_task_done(item, result),
                         stream=item.stream)
        return True

    def _try_place_in_pg(self, item: _PendingTask, strategy) -> bool:
        """Place a task into a placement-group bundle: consume bundle capacity
        (not node capacity) and run on the bundle's reserved node."""
        spec = item.spec
        pg = self.pg_manager.get(strategy.placement_group_id)
        if pg is None or not pg.created:
            return False  # group still materializing
        demand = spec.options.resource_demand()
        indices = (
            [strategy.bundle_index]
            if strategy.bundle_index >= 0
            else list(range(len(pg.bundles)))
        )
        # fail fast if no eligible bundle could EVER satisfy the demand
        # (e.g. num_cpus=1 into a GPU-only bundle) instead of queueing forever
        if not any(
            all(pg.bundles[i].get(k, 0.0) >= v - 1e-9 for k, v in demand.items())
            for i in indices
            if 0 <= i < len(pg.bundles)
        ):
            self._fail_task(item, ValueError(
                f"task {spec.name} demand {demand} exceeds placement-group "
                f"bundle capacity {[pg.bundles[i] for i in indices if 0 <= i < len(pg.bundles)]}; "
                "request only resources reserved by the bundle (hint: num_cpus=0 "
                "for GPU-bundle tasks)"
            ))
            return True
        for idx in indices:
            if not pg.try_acquire(idx, demand):
                continue
            node_id = pg.bundle_node(idx)
            agent = self._usable_agent(node_id)
            if agent is None:
                pg.release(idx, demand)
                continue
            spec.skip_node_resources = True
            item.target_node = node_id
            item.pg_lease = (pg, idx, demand)
            if spec.kind is TaskKind.ACTOR_CREATION:
                self.control_plane.update_actor(spec.actor_id, ActorState.STARTING, node_id)
            self._mark_task(spec.task_id, "RUNNING")
            agent.submit(spec, lambda result: self._on_task_done(item, result),
                         stream=item.stream)
            return True
        return False

    # ------------------------------------------------------------ completion
    def _on_task_done(self, item: _PendingTask, result: TaskResult) -> None:
        spec = item.spec
        # was the actor killed while its __init__ was still running?
        killed_during_init = False
        if spec.kind is TaskKind.ACTOR_CREATION and result.ok:
            actor = self.control_plane.get_actor(spec.actor_id)
            killed_during_init = actor is None or actor.state is ActorState.DEAD
        if item.pg_lease is not None:
            pg, idx, demand = item.pg_lease
            if spec.kind is TaskKind.ACTOR_CREATION and result.ok and not killed_during_init:
                # actor keeps its bundle share until death
                with self._lock:
                    self._actor_pg[spec.actor_id] = item.pg_lease
            else:
                pg.release(idx, demand)
            item.pg_lease = None
            spec.skip_node_resources = False
        if result.ok:
            self._mark_task(spec.task_id, "FINISHED")
            self._finish_stream(spec.task_id, None)
            if spec.kind is TaskKind.ACTOR_CREATION:
                if killed_during_init:
                    # tear the fresh runner back down; DEAD stays DEAD
                    agent = self.agents.get(item.target_node) if item.target_node else None
                    if agent is not None:
                        agent.kill_actor(spec.actor_id, cause="killed during creation")
                else:
                    self.control_plane.update_actor(
                        spec.actor_id, ActorState.ALIVE, item.target_node
                    )
                self._kick_scheduler()  # pending method calls can now route
            with self._lock:
                futures = [self._futures.get(oid) for oid in spec.return_ids]
            for fut in futures:
                if fut is not None:
                    fut.finish()
            return

        # Actor-death detection must precede the retry decision: a crashed
        # actor task with retries left would otherwise re-enqueue, find the
        # dead runner, and burn its retries before anyone schedules the
        # restart (the retried task then routes once the new incarnation
        # is ALIVE).
        if spec.kind is TaskKind.ACTOR_TASK and not result.is_application_error:
            actor = self.control_plane.get_actor(spec.actor_id)
            if actor is not None and actor.state is ActorState.ALIVE:
                self._on_actor_death(actor, result.error)

        if item.stream is not None:
            record = getattr(self, "_streams", {}).get(spec.task_id)
            if record is not None and record.refs:
                # items already streamed to the consumer: a replay would
                # duplicate them — no retry past the first yield
                item.retries_left = 0
        retriable = not result.is_application_error or item.retry_exceptions
        if retriable and item.retries_left > 0:
            item.retries_left -= 1
            spec.attempt += 1
            self._mark_task(spec.task_id, "RETRYING")
            logger.info(
                "retrying task %s (attempt %d) after: %r",
                spec.name, spec.attempt, result.error,
            )
            self._enqueue_pending(item)
            return

        if spec.kind is TaskKind.ACTOR_CREATION:
            actor = self.control_plane.get_actor(spec.actor_id)
            if (
                not result.is_application_error
                and actor is not None
                and actor.num_restarts < actor.max_restarts
            ):
                # creation crashed with the node — reschedule like a death
                self._on_actor_death(actor, result.error)
                return
            self.control_plane.update_actor(
                spec.actor_id, ActorState.DEAD,
                death_cause=repr(result.error),
            )
        error: BaseException
        if result.is_application_error:
            error = RayTaskError(spec.name, result.error)  # type: ignore[arg-type]
        elif spec.kind is TaskKind.ACTOR_TASK:
            error = RayActorError(f"actor task {spec.name} failed: {result.error!r}")
        else:
            error = RayTaskError(spec.name, result.error)  # type: ignore[arg-type]
        self._fail_task(item, error)

    def _on_actor_death(self, actor: ActorInfo, cause: Optional[BaseException]) -> None:
        with self._lock:
            lease = self._actor_pg.pop(actor.actor_id, None)
        if lease is not None:
            pg, idx, demand = lease
            pg.release(idx, demand)
        if actor.num_restarts < actor.max_restarts:
            self.control_plane.update_actor(actor.actor_id, ActorState.RESTARTING)
            with self._lock:
                spec = self._actor_specs.get(actor.actor_id)
            if spec is not None:
                spec.attempt += 1
                logger.info("restarting actor %s (restart %d)",
                            actor.actor_id.hex()[:8], actor.num_restarts)
                self._enqueue_pending(_PendingTask(spec, retries_left=0, retry_exceptions=False))
        else:
            self.control_plane.update_actor(
                actor.actor_id, ActorState.DEAD, death_cause=repr(cause)
            )
            self._kick_scheduler()

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        actor = self.control_plane.get_actor(actor_id)
        if actor is None:
            return
        if actor.node_id is not None:
            agent = self.agents.get(actor.node_id)
            if agent is not None:
                agent.kill_actor(actor_id)
        if no_restart:
            with self._lock:
                lease = self._actor_pg.pop(actor_id, None)
            if lease is not None:
                pg, idx, demand = lease
                pg.release(idx, demand)
            self.control_plane.update_actor(actor_id, ActorState.DEAD, death_cause="ray_tpu_torch.kill")
        else:
            self._on_actor_death(actor, WorkerCrashedError("killed"))

    def _finish_stream(self, task_id: TaskID, error: Optional[BaseException]) -> None:
        # pop, don't get: nothing writes a finished record again, and the
        # consumer's ObjectRefGenerator holds its own reference — keeping
        # it in the table would leak every stream's refs for the runtime's
        # lifetime
        record = getattr(self, "_streams", {}).pop(task_id, None)
        if record is None:
            return
        with record.cv:
            record.error = error
            record.done = True
            record.cv.notify_all()

    def _fail_task(self, item: _PendingTask, error: BaseException) -> None:
        self._mark_task(item.spec.task_id, "FAILED")
        self._finish_stream(item.spec.task_id, error)
        if item.spec.kind is TaskKind.ACTOR_CREATION:
            # a failed creation must kill the actor record, or pending method
            # calls wait forever for a start that will never come
            self.control_plane.update_actor(
                item.spec.actor_id, ActorState.DEAD, death_cause=repr(error)
            )
            self._kick_scheduler()
        with self._lock:
            futures = [self._futures.get(oid) for oid in item.spec.return_ids]
        for fut in futures:
            if fut is not None:
                fut.finish(error)
        # tasks waiting on these objects as arguments fail with the error
        # instead of waiting on forever (ROADMAP C19)
        for oid in item.spec.return_ids:
            self.directory.mark_failed(oid, error)

    def _mark_task(self, task_id: TaskID, state: str) -> None:
        from ..util import timeline

        emit = None
        with self._lock:
            entry = self._task_table.get(task_id)
            if entry is None:
                return
            entry["state"] = state
            now = timeline._now_us()
            if state == "RUNNING":
                entry["ts_start"] = now
            elif state in ("FINISHED", "FAILED", "RETRYING"):
                ts_start = entry.get("ts_start")
                ts_submit = entry.get("ts_submit")
                if ts_start is not None:
                    emit = (entry["name"], ts_submit, ts_start, now, state)
                if state == "RETRYING":
                    # next attempt gets its own queued/task spans
                    entry["ts_submit"] = now
                    entry["ts_start"] = None
        if emit is not None:
            name, ts_submit, ts_start, ts_end, final = emit
            if ts_submit is not None and ts_start > ts_submit:
                timeline.record(
                    f"{name} (queued)", "X", cat="queue",
                    ts_us=ts_submit, dur_us=ts_start - ts_submit,
                    pid="tasks", tid=name.split(".")[0],
                )
            timeline.record(
                name, "X", cat="task", ts_us=ts_start,
                dur_us=ts_end - ts_start, pid="tasks",
                tid=name.split(".")[0], args={"outcome": final},
            )

    # --------------------------------------------------------- reconstruction
    def _try_reconstruct(self, object_id: ObjectID) -> bool:
        """Lineage-based recovery: re-run the task that produced the object."""
        with self._lock:
            spec = self._lineage.get(object_id)
        if spec is None or spec.kind is not TaskKind.NORMAL:
            return False
        logger.info("reconstructing %s by re-executing %s", object_id, spec.name)
        done = threading.Event()
        outcome: Dict[str, Any] = {}

        def on_done(result: TaskResult) -> None:
            outcome["ok"] = result.ok
            done.set()

        spec.attempt += 1
        item = _PendingTask(spec, retries_left=1, retry_exceptions=False)
        # bypass futures (they are already set): place directly
        placed = False
        for _ in range(200):
            try:
                node_id = self.scheduler.select_node(spec, preferred_node=self.head_node_id)
            except ValueError:
                return False
            if node_id is not None and node_id in self.agents:
                self.agents[node_id].submit(spec, on_done)
                placed = True
                break
            time.sleep(0.01)
        if not placed:
            return False
        done.wait(timeout=60.0)
        return bool(outcome.get("ok"))

    # ------------------------------------------------------------- state API
    def task_table(self) -> Dict[TaskID, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._task_table.items()}

    # -------------------------------------------------------------- shutdown
    def shutdown(self) -> None:
        self.is_shutdown = True
        self._stop_event.set()
        with self._get_pool_lock:
            pool, self._get_pool = self._get_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        if config.event_log_dir:
            # durable task timeline for `ray-tpu timeline --events-dir`
            try:
                import os as _os

                from ..util import timeline as _tl

                _os.makedirs(config.event_log_dir, exist_ok=True)
                _tl.export(_os.path.join(
                    config.event_log_dir,
                    f"timeline_{_os.getpid()}_{int(time.time())}.json",
                ))
            except Exception:
                logger.debug("timeline export on shutdown failed", exc_info=True)
        writer = getattr(self, "_snapshot_writer", None)
        if writer is not None:
            writer.stop(final_write=True)
            self._snapshot_writer = None
        self._kick_scheduler()
        self.control_plane.finish_job(self.job_id)
        with self._lock:
            agents = list(self.agents.values())
        for agent in agents:
            agent.stop()
        for t in (self._sched_thread, self._monitor_thread):
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        # the agents released the shared pool and ended their actor
        # processes: end the forkserver too, once nothing forked from it
        # lives on (a runtime of another package may still use it)
        from .process_pool import stop_forkserver

        stop_forkserver()


_global_runtime: Optional[Runtime] = None


def get_runtime() -> Runtime:
    if _global_runtime is None:
        raise RuntimeError("ray_tpu_torch is not initialized; call ray_tpu_torch.init() first")
    return _global_runtime


def set_runtime(rt: Optional[Runtime]) -> None:
    global _global_runtime
    _global_runtime = rt


def runtime_initialized() -> bool:
    return _global_runtime is not None


def _collect_deps(args: tuple, kwargs: dict) -> List[ObjectID]:
    deps: List[ObjectID] = []
    for v in list(args) + list(kwargs.values()):
        if isinstance(v, ObjectRef):
            deps.append(v.object_id)
    return deps
