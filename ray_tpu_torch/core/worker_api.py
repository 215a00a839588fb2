"""Worker-side runtime API: nested submission from joined hosts.

Reference analogue: in the reference EVERY worker embeds a full CoreWorker
with its own ownership tables (`src/ray/core_worker/core_worker.h ::
CoreWorker`, `reference_count.cc :: ReferenceCounter`), so tasks spawn
tasks, replicas call handles, trials place trainers — the tree-of-tasks
pattern. Here ownership stays at the HEAD by design (single controller,
SURVEY §7.1): this module gives worker-host code a *client* to the head's
ownership tables, not a scheduler. `put/get/remote/wait/actor calls` from
code running on a joined host proxy over a dedicated control-plane
connection:

  worker host / pool worker           head
  -------------------------           ----
  WorkerAPIClient --proxy_submit_*--> HeadService -> Runtime.submit_task
       | get():  batched proxy_ref_state poll + pulls over the transfer
       |         plane (data rides the RPC socket only on the holder-died
       |         fallback, which uses its own short-lived connection)
       | errors: proxy_ref_state carries pickled task errors (failed
       |         tasks seal no object to wait on)
       | GC:     local refcount; zero -> proxy_free -> head unpins
       | liveness: the free thread doubles as a keepalive; the head reaps
       |         pins of clients that stopped beating (crash/SIGKILL)

The head PINS every proxy-submitted return ref (`HeadService._proxy_refs`)
so its own GC can't free results the remote caller still wants; the
client's local ReferenceCounter mirrors ObjectRef lifetime and releases
pins asynchronously. Refs that ESCAPE this process (pickled into a task
return or into another submission) are never auto-freed — the eventual
deserializer takes its own head-side reference at unpickle time, which can
be long after this process's last local ref dropped; pinning-until-head-
shutdown is the price of not running a borrower protocol (reference:
`reference_count.cc` borrower bookkeeping, deliberately collapsed).

A worker-host `put()` seals into the LOCAL store and registers the
location with the head directory (zero-copy on the data path); a
pool-worker `put()` (no serving store) ships the value to the head once.

The port's copy of ray_tpu/core/worker_api.py. Values and arguments that
leave this process go through `cross_host._dumps`, so a tensor off the
CPU travels as a CPU copy (object_transfer.host_dumps).
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .config import config
from .ids import ActorID, NodeID, ObjectID, TaskID
from .logging import get_logger
from .object_store import ObjectLostError, SealedBytes, seal_value
from .rpc import RemoteControlPlane
from .wire import WireError

logger = get_logger("worker_api")

KEEPALIVE_PERIOD_S = 10.0


class _ClientRefCounter:
    """Local mirror of ObjectRef liveness; zero count releases the head pin
    (reference: distributed refcounting in `reference_count.cc`, collapsed
    to borrower-notifies-owner). Escaped refs (see module docstring) are
    exempt from auto-free."""

    def __init__(self, client: "WorkerAPIClient"):
        self._client = client
        self._lock = threading.Lock()
        self._counts: Dict[ObjectID, int] = {}
        self._escaped: set = set()
        self.gc_enabled = True

    def add_ref(self, object_id: ObjectID) -> None:
        with self._lock:
            self._counts[object_id] = self._counts.get(object_id, 0) + 1

    def note_escaped(self, object_id: ObjectID) -> None:
        with self._lock:
            self._escaped.add(object_id)

    def remove_ref(self, object_id: ObjectID) -> None:
        """ObjectRef.__del__'s call: takes no lock (a collection inside
        add_ref would run it under the held lock, ROADMAP C2) and only
        queues the drop on a SimpleQueue, whose put is reentrant; the
        client's free thread counts it down (_drop)."""
        self._client._free_q.put(("drop", object_id))

    def _drop(self, object_id: ObjectID) -> bool:
        """Count one dropped handle down; True when the head pin is to be
        released."""
        with self._lock:
            n = self._counts.get(object_id, 0) - 1
            if n > 0:
                self._counts[object_id] = n
                return False
            self._counts.pop(object_id, None)
            return self.gc_enabled and object_id not in self._escaped

    def count(self, object_id: ObjectID) -> int:
        with self._lock:
            return self._counts.get(object_id, 0)

    def release_dropped(self) -> None:
        """The Runtime counter's API-entry hook (api._auto_init); releases
        here already ride the client's free thread."""


class _ActorInfoShim:
    __slots__ = ("actor_id", "name", "class_name")

    def __init__(self, actor_id: ActorID, name: str, class_name: str):
        self.actor_id = actor_id
        self.name = name
        self.class_name = class_name


class WorkerAPIClient:
    """Runtime-duck client for code running OFF the head (joined-host
    process or pool worker). Implements the subset of ``Runtime`` that
    ``ray_tpu_torch.api`` touches; everything else raises clearly."""

    is_proxy_client = True

    def __init__(
        self,
        head_address: str,
        local_store=None,
        local_node_id: Optional[NodeID] = None,
    ):
        # DEDICATED connection: get() may park seconds on it; sharing the
        # WorkerRuntime's heartbeat connection would wedge health checks
        self._cp = RemoteControlPlane(head_address)
        self.control_plane = self._cp
        self.head_address = head_address
        self.client_id = uuid.uuid4().hex
        self._local_store = local_store
        self._local_node_id = local_node_id
        self._client_task_id = TaskID.of()
        self._put_index = 0
        self._put_lock = threading.Lock()
        self._stream_lock = threading.Lock()
        self._stream_subscribed = False
        self._streams: Dict[str, "queue.Queue"] = {}
        self._stream_backlog: Dict[str, list] = {}
        self.is_shutdown = False
        try:
            self.job_id = self._cp.proxy_job_id()
        except BaseException:
            # half-built client must not leak its socket (init can fail
            # with RuntimeError from the server, not just OSError)
            self._cp.close()
            raise
        self.reference_counter = _ClientRefCounter(self)
        from .cross_host import RemoteDirectoryClient  # cycle: worker_api <- cross_host

        self._directory = RemoteDirectoryClient(
            self._cp, local_node_id or NodeID.generate())
        # frees ride a background thread: ObjectRef.__del__ must never
        # block on (or raise through) a socket. The same thread beats the
        # keepalive so the head can reap this client's pins if the process
        # dies without close(). The queue carries frees, dropped handles
        # ("drop", oid) and the None that stops the thread; a SimpleQueue,
        # so ObjectRef.__del__ may put from anywhere
        self._free_q: "queue.SimpleQueue" = queue.SimpleQueue()
        threading.Thread(
            target=self._free_loop, daemon=True, name="worker-api-free"
        ).start()

    # ------------------------------------------------------------ internals
    def _free_loop(self) -> None:
        last_beat = 0.0
        while True:
            try:
                oid = self._free_q.get(timeout=KEEPALIVE_PERIOD_S / 2)
            except queue.Empty:
                oid = False  # idle tick: keepalive only
            if oid is None:
                return
            batch = []
            if oid is not False:
                pending = [oid]
                try:
                    while len(pending) < 256:
                        nxt = self._free_q.get_nowait()
                        if nxt is None:
                            self._free_q.put(None)  # re-arm shutdown
                            break
                        pending.append(nxt)
                except queue.Empty:
                    pass
                for item in pending:
                    if isinstance(item, tuple):
                        if self.reference_counter._drop(item[1]):
                            batch.append(item[1])
                    else:
                        batch.append(item)
                if self.is_shutdown:
                    continue
            try:
                if batch:
                    # frees carry the client id: they refresh head-side
                    # liveness, so a busy-freeing client never starves
                    # its own keepalive
                    self._cp.proxy_free([o.hex() for o in batch],
                                        self.client_id)
                    last_beat = time.monotonic()
                elif time.monotonic() - last_beat >= KEEPALIVE_PERIOD_S:
                    self._cp.proxy_keepalive(self.client_id)
                    last_beat = time.monotonic()
            except (WireError, OSError, RuntimeError):
                if self.is_shutdown:
                    return
                # head restarting: drop this batch (a restarted head has no
                # pins for us anyway) and keep the thread alive so frees
                # and keepalives resume once the client reconnects
                continue

    def _enqueue_free(self, oid: ObjectID) -> None:
        if not self.is_shutdown:
            self._free_q.put(oid)

    def note_escaped(self, object_id: ObjectID) -> None:
        """Called from ObjectRef.__reduce__: this ref's id left the process
        (task return / nested submission); its head pin must outlive our
        local refcount."""
        self.reference_counter.note_escaped(object_id)

    def _make_refs(self, oid_hexes: List[str]) -> List[Any]:
        from .core_worker import ObjectRef

        return [ObjectRef(ObjectID.from_hex(h), self) for h in oid_hexes]

    # ----------------------------------------------------------- submission
    def submit_task(self, spec) -> List[Any]:
        from .cross_host import _dumps

        self._package_renv(spec)
        return self._make_refs(self._cp.proxy_submit_task(
            _dumps(spec), self.client_id))

    def submit_streaming_task(self, spec):
        """Streaming over the back-channel: the head runs the generator
        task and forwards item refs as `proxy_stream` pubsub events; this
        side yields ObjectRefs as the events land (same consume-while-
        producing contract as the head's ObjectRefGenerator)."""
        from .cross_host import _dumps

        self._package_renv(spec)
        with self._stream_lock:
            if not self._stream_subscribed:
                self._cp.subscribe("proxy_stream", self._on_stream_event)
                self._stream_subscribed = True
        stream_id = self._cp.proxy_submit_streaming(
            _dumps(spec), self.client_id)
        q: "queue.Queue" = queue.Queue()
        with self._stream_lock:
            self._streams[stream_id] = q
            # events that raced ahead of the registration replay in order
            for ev in self._stream_backlog.pop(stream_id, []):
                q.put(ev)
        return _ProxyRefStream(self, stream_id, q)

    def _on_stream_event(self, event) -> None:
        stream_id, index, oid_hex, err_blob = event
        with self._stream_lock:
            q = self._streams.get(stream_id)
            if q is None:
                # subscribe() races proxy_submit_streaming's reply: buffer
                # until the stream registers (bounded: streams register
                # within one RPC round trip)
                self._stream_backlog.setdefault(stream_id, []).append(event)
                return
        q.put(event)

    def create_actor(self, cls, args, kwargs, options) -> _ActorInfoShim:
        from .cross_host import _dumps

        spec_like = (cls, args, kwargs, options)
        actor_hex, name, class_name = self._cp.proxy_create_actor(
            _dumps(spec_like))
        return _ActorInfoShim(ActorID.from_hex(actor_hex), name, class_name)

    def submit_actor_task(
        self, actor_id: ActorID, method_name: str, args, kwargs, options,
        trace_ctx=None,
    ) -> List[Any]:
        from ..util import tracing
        from .cross_host import _dumps

        if trace_ctx is None:
            trace_ctx = tracing.current_context()
        return self._make_refs(self._cp.proxy_submit_actor_task(
            actor_id.hex(), method_name, _dumps((args, kwargs)),
            _dumps(options), self.client_id, trace_ctx))

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._cp.proxy_kill_actor(actor_id.hex(), no_restart)

    def _package_renv(self, spec) -> None:
        """working_dir must be read from THIS host's filesystem — the head
        never sees the path (mirrors Runtime._prepare_runtime_env)."""
        renv = spec.options.runtime_env
        if not renv or not renv.get("working_dir"):
            return
        import dataclasses

        from . import runtime_env

        packaged = runtime_env.package_working_dir(renv, self._cp)
        spec.options = dataclasses.replace(spec.options, runtime_env=packaged)

    # -------------------------------------------------------------- get/put
    def put(self, value: Any) -> Any:
        from .core_worker import ObjectRef
        from .cross_host import _dumps

        with self._put_lock:
            self._put_index += 1
            oid = ObjectID.for_put(self._client_task_id, self._put_index)
        if self._local_store is not None and self._local_node_id is not None:
            # worker-host process: seal locally, advertise the location —
            # consumers pull over the transfer plane (no head copy)
            self._local_store.put(oid, seal_value(value))
            self._directory.add_location(oid, self._local_node_id)
            self._cp.proxy_pin(oid.hex(), self.client_id)
        else:
            # pool worker: no serving store here — ship to the head once
            self._cp.proxy_put(oid.hex(), _dumps(value), self.client_id)
        return ObjectRef(oid, self)

    def get(self, refs: Sequence[Any], timeout: Optional[float] = None) -> List[Any]:
        """Batched resolve: ONE proxy_ref_state poll per iteration covers
        every unresolved ref (the head API takes a list for exactly this);
        pulls happen as refs turn ready. Pure poll with backoff — no
        per-ref pubsub machinery on this side of the wire."""
        from .core_worker import GetTimeoutError

        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Any] = [None] * len(refs)
        pending: Dict[str, List[int]] = {}
        for i, ref in enumerate(refs):
            pending.setdefault(ref.object_id.hex(), []).append(i)
        stale_pulls: Dict[str, int] = {}
        poll = 0.03
        while pending:
            states = self._cp.proxy_ref_state(list(pending))
            progressed = False
            for h in list(pending):
                st = states[h]
                if st["state"] == "error":
                    raise _load_error(st["error_blob"])
                if st["state"] != "ready":
                    continue
                oid = ObjectID.from_hex(h)
                value, ok = self._pull_ready(oid, h, stale_pulls, deadline)
                if not ok:
                    continue
                for i in pending.pop(h):
                    out[i] = value
                progressed = True
            if not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                missing = [h[:16] for h in pending]
                raise GetTimeoutError(f"get() timed out on {missing}")
            if not progressed:
                time.sleep(poll)
                poll = min(poll * 1.7, 0.35)
        return out

    def _pull_ready(self, oid: ObjectID, h: str, stale_pulls: Dict[str, int],
                    deadline: Optional[float]) -> Tuple[Any, bool]:
        from .object_transfer import _cache_hits, _cache_misses

        if self._local_store is not None and self._local_store.contains(oid):
            # pull-through cache hit: a prior get on this host already
            # sealed the object locally (objects are immutable, so the
            # replica is as good as the origin)
            _cache_hits.inc()
            return self._local_store.get(oid, timeout=10.0), True
        # prefer_local: a holder sharing this boot's host token serves
        # over the shm fd handoff (zero socket bytes) instead of a
        # loopback copy — ranked ahead of genuinely remote holders
        holder = self._directory.locate(oid, prefer_local=True)
        if holder is None:
            # ready but no location: sealed value lost (holder died) or
            # the dir write is in flight — give the directory two beats,
            # then let the head resolve (lineage reconstruction lives there)
            stale_pulls[h] = stale_pulls.get(h, 0) + 1
            if stale_pulls[h] >= 3:
                return self._get_via_head(oid, deadline), True
            return None, False
        try:
            if (self._local_store is not None
                    and self._local_node_id is not None
                    and config.object_pull_through_cache):
                # seal the pulled payload locally and advertise the
                # location: repeat gets stay on-host, and OTHER hosts can
                # pull from us instead of the origin. Best-effort: any
                # cache failure degrades to returning the value.
                _cache_misses.inc()
                raw = holder.store.get_raw(oid, timeout=10.0)
                try:
                    self._local_store.put(oid, raw)
                    self._directory.add_location(oid, self._local_node_id)
                except Exception:  # noqa: BLE001 — caching never fails a get
                    pass
                return (raw.load() if isinstance(raw, SealedBytes)
                        else raw), True
            return holder.store.get(oid, timeout=10.0), True
        except (TimeoutError, ObjectLostError):
            stale_pulls[h] = stale_pulls.get(h, 0) + 1
            if stale_pulls[h] >= 3:
                return self._get_via_head(oid, deadline), True
            return None, False

    def _get_via_head(self, oid: ObjectID, deadline: Optional[float]) -> Any:
        """Fallback: the head resolves (incl. reconstruction) and ships the
        value back. Runs on its OWN short-lived connection — the shared
        one serves every concurrent task on this host, and the head
        handler blocks for the duration (rpc.py is one thread per
        connection)."""
        import pickle

        rem = 30.0 if deadline is None else max(1.0, deadline - time.monotonic())
        wait_s = min(rem, 60.0)
        cp = RemoteControlPlane(self.head_address)
        try:
            # the server parks up to wait_s before replying: the call
            # deadline must outlast it or every slow resolve would abort
            # as ControlPlaneUnavailable at the config default
            blob = cp._call("proxy_get_value", oid.hex(), wait_s,
                            _deadline_s=wait_s + 10.0)
        finally:
            cp.close()
        return pickle.loads(blob)

    def wait(
        self,
        refs: Sequence[Any],
        num_returns: int = 1,
        timeout: Optional[float] = None,
    ) -> Tuple[List[Any], List[Any]]:
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds number of refs")
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[Any] = []
        pending = list(refs)
        poll = 0.02
        while len(ready) < num_returns and pending:
            states = self._cp.proxy_ref_state(
                [r.object_id.hex() for r in pending])
            for r in list(pending):
                if states[r.object_id.hex()]["state"] in ("ready", "error"):
                    ready.append(r)
                    pending.remove(r)
                    if len(ready) >= num_returns:
                        break
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(poll)
            poll = min(poll * 1.7, 0.25)
        return ready, pending

    def free_object(self, object_id: ObjectID) -> None:
        self._enqueue_free(object_id)

    @property
    def is_alive(self) -> bool:
        """False only once close()d: a dropped head connection now heals
        itself (rpc.RemoteControlPlane reconnects), so cached clients stay
        valid across a head restart."""
        return not self.is_shutdown and not self._cp._closed.is_set()

    # --------------------------------------------------------------- misc
    def task_table(self):
        raise RuntimeError("the task table lives on the head; use the state "
                           "API from the driver")

    def close(self) -> None:
        self.is_shutdown = True
        self.reference_counter.gc_enabled = False
        self._free_q.put(None)
        self._cp.close()


class _ProxyRefStream:
    """Client-side ObjectRefGenerator duck: yields ObjectRefs as the
    head's proxy_stream events arrive; raises the producer's error after
    the yielded prefix (same contract as core_worker.ObjectRefGenerator)."""

    def __init__(self, client: WorkerAPIClient, stream_id: str, q):
        self._client = client
        self._id = stream_id
        self._q = q
        self._done = False
        self._error: Optional[BaseException] = None

    def __iter__(self):
        return self

    def __next__(self):
        from .core_worker import ObjectRef
        from .ids import ObjectID

        if self._done:
            if self._error is not None:
                raise self._error
            raise StopIteration
        _sid, index, oid_hex, err_blob = self._q.get()
        if index < 0:  # terminal event
            self._done = True
            with self._client._stream_lock:
                self._client._streams.pop(self._id, None)
            if err_blob is not None:
                self._error = _load_error(err_blob)
                raise self._error
            raise StopIteration
        return ObjectRef(ObjectID.from_hex(oid_hex), self._client)

    def completed(self) -> bool:
        return self._done


def _load_error(blob: Optional[bytes]) -> BaseException:
    import pickle

    if blob is None:
        return RuntimeError("remote task failed (no error detail)")
    try:
        return pickle.loads(blob)
    except Exception as e:  # noqa: BLE001 — broken blob must not mask failure
        return RuntimeError(f"remote task failed (undeserializable: {e!r})")
