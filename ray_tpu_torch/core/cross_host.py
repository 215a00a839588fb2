"""Cross-host execution plane: remote task/actor dispatch between runtimes.

Reference analogue: the reference's whole lease/push path — a raylet on
another host grants a worker lease and the owner pushes the task to it
(`src/ray/raylet/node_manager.cc :: HandleRequestWorkerLease`,
`src/ray/core_worker/transport/actor_task_submitter.cc` /
`normal_task_submitter.cc`). The reference's shape (SURVEY §7.1): a
SINGLE CONTROLLER — the head runtime owns the cluster scheduler and PUSHES
task specs to worker hosts over the wire; workers never lease-negotiate.
This keeps every scheduling policy in one place.

Topology:

  head process                      worker host process
  ------------                      -------------------
  Runtime (scheduler, GCS)  <--RPC--  RemoteControlPlane (register,
   |  ControlPlaneServer               heartbeat, KV, dir_*, pubsub)
   |  ObjectTransferServer  <--pull--  NodeAgent._fetch_async (deps)
   |  RemoteNodeAgent  ----submit--->  WorkerNodeServer -> NodeAgent
   |       ^...........done+seal......   (executes, seals returns into
   |  ObjectDirectory  <--dir_add----     its local store)
   |  (locations)                      ObjectTransferServer (serves
   +--RemoteStoreProxy  ----pull---->     results to any puller)

The data plane stays the existing object-transfer plane (chunked TCP,
sealed payloads); this module only adds DISPATCH.

The port's copy of ray_tpu/core/cross_host.py. A device tensor never
crosses as a device tensor: whatever leaves this process for another host
(a task spec, an actor call's arguments, an error, a value pulled over the
transfer plane) is pickled by `object_transfer.host_dumps`, which sends a
tensor off the CPU as a CPU copy. The receiving host gets a CPU tensor
and never starts CUDA because of a payload, as the reference's jax arrays
cross as host bytes (a deliberate difference from pickling a CUDA tensor,
which would land on the receiver's card). Joined hosts on one machine may
each own a share of one card (`init(address=, num_gpus=)`); each host's
device work runs on its own node agent's threads, in its own process.
"""

from __future__ import annotations

import pickle
import queue
import socket
import socketserver
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import object_ledger
from .config import config
from .control_plane import NodeInfo
from .metrics import Counter as _MetricCounter
from .ids import ActorID, NodeID, ObjectID
from .logging import get_logger
from .node_agent import NodeAgent, TaskResult, WorkerCrashedError
from .object_store import ObjectLostError
from .object_transfer import (
    HOST_PREFIX,
    KV_PREFIX,
    ObjectPullError,
    ObjectTransferClient,
    ObjectTransferServer,
    _host_token,
    host_dumps,
    pull_from_any,
)
from .rpc import ControlPlaneUnavailable, RemoteControlPlane
from .wire import MSG_REQUEST, MSG_RESPONSE, WireError, recv_msg, send_msg

logger = get_logger("cross_host")

NODE_SERVICE_PREFIX = "node_service/"  # KV: node_id hex -> dispatch address

_m_tele_dropped = _MetricCounter(
    "telemetry_dropped_total",
    "Telemetry items dropped by the heartbeat byte budget "
    "(config.telemetry_max_bytes), by kind.")

_m_tele_bytes = _MetricCounter(
    "telemetry_bytes_total",
    "Approximate serialized telemetry bytes shipped to the head, by "
    "field; delta-encoding shows up as these counters going flat while "
    "the cluster is steady.")


def _cap_telemetry(metrics: List[Any], spans: List[Any], events: List[Any],
                   budget: int) -> Tuple[List[Any], List[Any]]:
    """Fit (spans, events) under `budget` bytes alongside the metrics
    snapshot, dropping OLDEST first (both lists are append-ordered). The
    metrics/digest snapshot always ships — it is replace-not-append on
    the head, so it is naturally bounded; spans/events are the burst
    risk. Cursors still advance past dropped items: the budget is a
    deliberate loss, not a retry."""
    if budget <= 0 or (not spans and not events):
        return spans, events
    used = len(_dumps(metrics))
    kept: List[List[Any]] = []
    for kind, items in (("spans", spans), ("events", events)):
        remaining = max(0, budget - used)
        sizes = [len(_dumps(it)) for it in items]
        keep_from = len(items)
        acc = 0
        for i in range(len(items) - 1, -1, -1):  # newest backwards
            if acc + sizes[i] > remaining:
                break
            acc += sizes[i]
            keep_from = i
        used += acc
        dropped = keep_from
        if dropped:
            _m_tele_dropped.inc(dropped, tags={"kind": kind})
            logger.debug("telemetry budget dropped %d oldest %s",
                         dropped, kind)
        kept.append(items[keep_from:])
    return kept[0], kept[1]


def _dumps(obj: Any) -> bytes:
    """Pickle for the wire: tensors off the CPU go as CPU copies
    (object_transfer.host_dumps); cloudpickle for what pickle refuses."""
    try:
        return host_dumps(obj)
    except Exception:
        return host_dumps(obj, cloud=True)


def _dump_exc(e: Optional[BaseException]) -> Optional[bytes]:
    if e is None:
        return None
    try:
        return _dumps(e)
    except Exception:
        return _dumps(RuntimeError(repr(e)))


def _load_exc(blob: Optional[bytes]) -> Optional[BaseException]:
    if blob is None:
        return None
    try:
        return pickle.loads(blob)
    except Exception as e:  # noqa: BLE001 — a broken exc must not mask the task error
        return RuntimeError(f"remote error (undeserializable: {e!r})")


# ---------------------------------------------------------------------------
# Head side: service surface + remote-agent proxy
# ---------------------------------------------------------------------------


class HeadService:
    """The head runtime's served surface: the ControlPlane plus directory
    methods (worker hosts publish/resolve object locations) plus the
    ``proxy_*`` ownership back-channel (code running ON a joined host
    submits nested work through the head's ownership tables —
    `worker_api.WorkerAPIClient` is the client; reference:
    `core_worker.h :: CoreWorker` ownership, collapsed to
    single-controller).

    Served by ``rpc.serve_control_plane`` in place of the bare ControlPlane
    (same duck surface — unknown attributes forward to the control plane)."""

    # pins of clients that stop beating for this long are reaped (a pool
    # worker SIGKILLed mid-task, a joined host that died without close())
    PROXY_CLIENT_STALE_S = 90.0

    def __init__(self, runtime):
        self._runtime = runtime
        self.pubsub = runtime.control_plane.pubsub
        # oid hex -> (client_id, pinned ObjectRef): results a REMOTE caller
        # owns must survive the head's own GC until the caller releases
        # them — or until the caller itself is declared dead (keepalive)
        self._proxy_refs: Dict[str, Tuple[str, Any]] = {}
        self._proxy_clients: Dict[str, float] = {}
        self._proxy_lock = threading.Lock()

    def __getattr__(self, name: str):
        return getattr(self._runtime.control_plane, name)

    # -- ownership back-channel (worker -> head) ----------------------------
    def _pin(self, refs, client_id: str) -> List[str]:
        hexes = [r.object_id.hex() for r in refs]
        now = time.monotonic()
        with self._proxy_lock:
            self._proxy_clients[client_id] = now
            for h, r in zip(hexes, refs):
                self._proxy_refs[h] = (client_id, r)
        self._reap_stale_clients(now)
        return hexes

    def _reap_stale_clients(self, now: float) -> None:
        """Lazy sweep (no dedicated thread): any proxy call pays a cheap
        staleness check. A dead client's pins drop; objects some OTHER
        holder still references survive the head's refcount — the only
        loss window is a returned ref whose consumer never deserialized
        it before the producer died, which without a borrower protocol is
        unknowable (module docstring in worker_api)."""
        with self._proxy_lock:
            stale = [c for c, ts in self._proxy_clients.items()
                     if now - ts > self.PROXY_CLIENT_STALE_S]
            if not stale:
                return
            dead = set(stale)
            for c in stale:
                self._proxy_clients.pop(c, None)
            dropped = [h for h, (c, _r) in self._proxy_refs.items() if c in dead]
            refs = [self._proxy_refs.pop(h) for h in dropped]
        if dropped:
            logger.info("reaped %d pinned objects of %d stale proxy clients",
                        len(dropped), len(dead))
        del refs

    def proxy_keepalive(self, client_id: str) -> bool:
        now = time.monotonic()
        with self._proxy_lock:
            self._proxy_clients[client_id] = now
        self._reap_stale_clients(now)
        return True

    def proxy_job_id(self):
        return self._runtime.job_id

    def proxy_submit_task(self, spec_blob: bytes, client_id: str = "") -> List[str]:
        spec = pickle.loads(spec_blob)
        return self._pin(self._runtime.submit_task(spec), client_id)

    def proxy_create_actor(self, blob: bytes) -> Tuple[str, str, str]:
        cls, args, kwargs, options = pickle.loads(blob)
        info = self._runtime.create_actor(cls, args, kwargs, options)
        return info.actor_id.hex(), info.name or "", info.class_name

    def proxy_submit_actor_task(
        self, actor_id_hex: str, method_name: str,
        payload_blob: bytes, opts_blob: bytes, client_id: str = "",
        trace_ctx=None,
    ) -> List[str]:
        args, kwargs = pickle.loads(payload_blob)
        options = pickle.loads(opts_blob)
        return self._pin(self._runtime.submit_actor_task(
            ActorID.from_hex(actor_id_hex), method_name, args, kwargs,
            options, trace_ctx=trace_ctx),
            client_id)

    PROXY_STREAM_CHANNEL = "proxy_stream"

    def proxy_submit_streaming(self, spec_blob: bytes, client_id: str = "") -> str:
        """Streaming submission from a worker-side client: the head runs
        the generator task and FORWARDS each item ref over the pubsub
        plane (`proxy_stream` events carry (stream_id, index, oid_hex));
        a terminal event carries done/error. Items pin like any other
        proxy-owned refs."""
        import uuid as _uuid

        from .core_worker import ObjectRef

        spec = pickle.loads(spec_blob)
        gen = self._runtime.submit_streaming_task(spec)
        stream_id = _uuid.uuid4().hex
        pubsub = self._runtime.control_plane.pubsub

        def pump() -> None:
            i = 0
            try:
                for ref in gen:
                    self._pin([ref], client_id)
                    pubsub.publish(self.PROXY_STREAM_CHANNEL,
                                   (stream_id, i, ref.object_id.hex(), None))
                    i += 1
                pubsub.publish(self.PROXY_STREAM_CHANNEL,
                               (stream_id, -1, None, None))  # done
            except BaseException as e:  # noqa: BLE001 — forwarded to client
                pubsub.publish(self.PROXY_STREAM_CHANNEL,
                               (stream_id, -1, None, _dump_exc(e)))

        threading.Thread(target=pump, daemon=True,
                         name=f"proxy-stream-{stream_id[:8]}").start()
        return stream_id

    def proxy_kill_actor(self, actor_id_hex: str, no_restart: bool) -> bool:
        self._runtime.kill_actor(ActorID.from_hex(actor_id_hex),
                                 no_restart=no_restart)
        return True

    def proxy_ref_state(self, oid_hexes: List[str]) -> Dict[str, dict]:
        """Nonblocking tri-state per ref: pending | ready | error(+blob).
        Failed tasks seal nothing — the error lives only in the head's
        future table, so worker-side get() must ask here."""
        out: Dict[str, dict] = {}
        rt = self._runtime
        for h in oid_hexes:
            oid = ObjectID.from_hex(h)
            with rt._lock:
                fut = rt._futures.get(oid)
            if fut is None:
                state = "ready" if rt.directory.locations(oid) else "pending"
                out[h] = {"state": state, "error_blob": None}
            elif not fut.event.is_set():
                out[h] = {"state": "pending", "error_blob": None}
            elif fut.error is not None:
                out[h] = {"state": "error", "error_blob": _dump_exc(fut.error)}
            else:
                out[h] = {"state": "ready", "error_blob": None}
        return out

    def proxy_put(self, oid_hex: str, value_blob: bytes, client_id: str = "") -> bool:
        """Pool-worker put: no serving store on that side, so the value
        lands in the head driver's store (one copy, then normal pulls)."""
        from .core_worker import ObjectRef
        from .object_store import seal_value

        oid = ObjectID.from_hex(oid_hex)
        agent = self._runtime.driver_agent
        agent.store.put(oid, seal_value(pickle.loads(value_blob)))
        self._runtime.directory.add_location(oid, agent.node_id)
        self._pin([ObjectRef(oid, self._runtime)], client_id)
        return True

    def proxy_pin(self, oid_hex: str, client_id: str = "") -> bool:
        """Pin a worker-sealed object (put() on a joined host): head-side
        consumers' ref churn must not free it while the remote owner
        still holds it."""
        from .core_worker import ObjectRef

        self._pin([ObjectRef(ObjectID.from_hex(oid_hex), self._runtime)],
                  client_id)
        return True

    def proxy_free(self, oid_hexes: List[str], client_id: str = "") -> bool:
        with self._proxy_lock:
            if client_id:
                # a free IS liveness: a client whose churn keeps the free
                # batches flowing may send no explicit keepalive for
                # minutes — it must not be reaped as stale mid-churn
                self._proxy_clients[client_id] = time.monotonic()
            refs = [self._proxy_refs.pop(h, None) for h in oid_hexes]
        # dropping the pinned refs hands the decision to the head's
        # ReferenceCounter (other head-side holders keep the object alive)
        del refs
        return True

    def proxy_get_value(self, oid_hex: str, timeout: float) -> bytes:
        """Fallback get: the head resolves (incl. lineage reconstruction)
        and ships the value back over the RPC socket. Direct transfer-plane
        pulls are the primary path; this exists for holder-died races.
        Blocks THIS connection's handler thread — clients call it on a
        dedicated short-lived connection (worker_api._get_via_head)."""
        from .core_worker import ObjectRef

        ref = ObjectRef(ObjectID.from_hex(oid_hex), self._runtime)
        value = self._runtime.get([ref], timeout=min(timeout, 60.0))[0]
        return _dumps(value)

    # -- directory ops (worker -> head) ------------------------------------
    def dir_add_location(self, oid_hex: str, node_id_hex: str,
                         bytes_available: Optional[int] = None) -> bool:
        self._runtime.directory.add_location(
            ObjectID.from_hex(oid_hex), NodeID.from_hex(node_id_hex),
            bytes_available=bytes_available,
        )
        return True

    def dir_remove_location(self, oid_hex: str, node_id_hex: str) -> bool:
        self._runtime.directory.remove_location(
            ObjectID.from_hex(oid_hex), NodeID.from_hex(node_id_hex)
        )
        return True

    def dir_locations(self, oid_hex: str) -> List[str]:
        return [
            n.hex()
            for n in self._runtime.directory.locations(ObjectID.from_hex(oid_hex))
        ]

    # -- profiling plane (rpc allowlist: profile_start / profile_fetch) -----
    def _profile_agent(self, node: str):
        """Resolve a node-id hex (any unambiguous prefix; "" = the head's
        own driver node) to the agent holding the profiling duck — a local
        NodeAgent or a RemoteNodeAgent proxying a joined host."""
        rt = self._runtime
        if not node:
            return rt.driver_agent
        with rt._lock:
            agents = dict(rt.agents)
        matches = [(nid, a) for nid, a in agents.items()
                   if nid.hex().startswith(node)]
        if len(matches) == 1:
            return matches[0][1]
        known = sorted(nid.hex()[:12] for nid in agents)
        if not matches:
            raise KeyError(f"no node matches {node!r} (known: {known})")
        raise KeyError(f"node prefix {node!r} is ambiguous (known: {known})")

    def profile_start(self, node: str = "", pid: int = 0,
                      duration_s: float = 5.0, hz=None, kind: str = "cpu",
                      logdir: str = "") -> Dict[str, Any]:
        out = dict(self._profile_agent(node).profile_start(
            pid=pid, duration_s=duration_s, hz=hz, kind=kind, logdir=logdir))
        out.setdefault("node", node)
        return out

    def profile_fetch(self, node: str = "", pid: int = 0,
                      kind: str = "cpu") -> Dict[str, Any]:
        out = dict(self._profile_agent(node).profile_fetch(pid=pid, kind=kind))
        out.setdefault("node", node)
        return out


class _AgentStoreAdapter:
    """Serves EVERY local agent's store through one transfer server, so a
    single advertised address covers all of the head's (virtual) nodes."""

    def __init__(self, runtime):
        self._runtime = runtime

    def _stores(self):
        with self._runtime._lock:
            agents = list(self._runtime.agents.values())
        return [a.store for a in agents if isinstance(a, NodeAgent)]

    def contains(self, oid) -> bool:
        return any(s.contains(oid) for s in self._stores())

    def get(self, oid, timeout=None):
        for s in self._stores():
            if s.contains(oid):
                return s.get(oid, timeout=timeout)
        raise KeyError(oid)

    def get_raw(self, oid, timeout=None):
        for s in self._stores():
            if s.contains(oid):
                return s.get_raw(oid, timeout=timeout)
        raise KeyError(oid)


class RemoteStoreProxy:
    """Duck-typed store view of a remote runtime: get/get_raw pull over the
    transfer plane, delete goes over the dispatch connection."""

    def __init__(self, owner: "RemoteNodeAgent"):
        self._owner = owner
        self._transfer = ObjectTransferClient()

    def contains(self, oid) -> bool:
        try:
            return bool(
                self._transfer._call(self._owner.transfer_addr, "contains", oid.hex())
            )
        except ObjectPullError:
            return False

    def get(self, oid, timeout=None):
        # store duck contract: callers handle TimeoutError/ObjectLostError,
        # never the transfer plane's own error type
        try:
            return self._transfer.pull(self._owner.transfer_addr, oid)
        except ObjectPullError as e:
            raise ObjectLostError(oid) from e

    def get_raw(self, oid, timeout=None):
        try:
            return self._transfer.pull(self._owner.transfer_addr, oid, raw=True)
        except ObjectPullError as e:
            raise ObjectLostError(oid) from e

    def delete(self, oid) -> None:
        try:
            self._owner._call("store_delete", oid_hex=oid.hex())
        except (WireError, OSError, RuntimeError):
            pass  # holder gone: nothing to delete

    def put(self, oid, value, nbytes=None) -> None:
        raise NotImplementedError("push-to-remote-store is not part of the plane "
                                  "(the consumer pulls; see object_transfer.py)")

    def close(self) -> None:
        self._transfer.close()


class _RemoteResources:
    """NodeAgent.resources duck for a remote node: placement-group
    reservations acquire/release on the WORKER's own ledger over the
    dispatch plane, so its heartbeats (and its local task accounting)
    see them — the head holding a shadow ledger would desync the moment
    the worker heartbeat overwrote it. (Reference: bundle resources
    live in the raylet's local resource manager,
    `cluster_resource_manager.cc`.)"""

    def __init__(self, owner: "RemoteNodeAgent"):
        self._owner = owner

    def try_acquire(self, demand: Dict[str, float]) -> bool:
        try:
            return bool(self._owner._call("try_acquire", demand=dict(demand)))
        except (WorkerCrashedError, RuntimeError):
            return False

    def release(self, demand: Dict[str, float]) -> None:
        try:
            self._owner._call("release", demand=dict(demand))
        except (WorkerCrashedError, RuntimeError):
            pass  # node gone: its ledger died with it

    def available(self) -> Dict[str, float]:
        try:
            return dict(self._owner._call("resources_available"))
        except (WorkerCrashedError, RuntimeError):
            return {}


class RemoteNodeAgent:
    """Head-side proxy with NodeAgent's duck surface, dispatching to a
    WorkerNodeServer on another host.

    submit() is asynchronous: the spec ships as one frame; the worker sends
    the TaskResult frame whenever the task finishes (responses interleave,
    matched by id). Return VALUES never ride the dispatch plane — the worker
    seals them into its own store and registers locations with the head
    directory before acking, so a subsequent get() pulls them over the
    transfer plane exactly like any other remote object."""

    is_remote = True

    def __init__(self, info: NodeInfo, node_service_addr: str, transfer_addr: str):
        self.info = info
        self.node_id = info.node_id
        self.node_service_addr = node_service_addr
        self.transfer_addr = transfer_addr
        object_ledger.note_peer(transfer_addr, info.node_id.hex())
        self._stopped = threading.Event()
        self.store = RemoteStoreProxy(self)
        self.resources = _RemoteResources(self)
        host, _, port = node_service_addr.rpartition(":")
        self._sock = socket.create_connection((host, int(port)), timeout=10.0)
        # connect timeout only — the dispatch connection is long-lived and
        # idle between tasks; a lingering socket timeout would kill the
        # read loop after 10 quiet seconds
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = threading.Lock()
        # callback-map mutations get their OWN mutex, never held across a
        # socket op: the read loop must not park behind _send_lock (held
        # across a blocking send_msg) or a full-buffer send could deadlock
        # the whole dispatch plane four ways (head write <-> worker write)
        self._cb_lock = threading.Lock()
        self._next_id = 0
        self._done_cbs: Dict[int, Callable[[TaskResult], None]] = {}
        self._stream_cbs: Dict[int, Callable] = {}
        self._replies: Dict[int, dict] = {}
        self._reply_cv = threading.Condition()
        # Completions run OFF the read loop: _on_task_done may call back
        # into this agent (e.g. kill_actor on killed-during-init), which
        # needs the read loop free to deliver the reply.
        self._completions: "queue.Queue[Optional[Tuple[Callable, TaskResult]]]" = queue.Queue()
        self._completion_thread = threading.Thread(
            target=self._completion_loop, daemon=True,
            name=f"remote-agent-done-{info.node_id.hex()[:8]}",
        )
        self._completion_thread.start()
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"remote-agent-{info.node_id.hex()[:8]}",
        )
        self._reader.start()

    def _completion_loop(self) -> None:
        while True:
            item = self._completions.get()
            if item is None:
                return
            cb, result = item
            try:
                cb(result)
            except Exception:  # noqa: BLE001
                logger.exception("task-done callback failed")

    # -- plumbing -----------------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while not self._stopped.is_set():
                msg_type, payload = recv_msg(self._sock)
                if msg_type != MSG_RESPONSE:
                    continue
                req_id = payload.get("id")
                if "stream_item" in payload:
                    with self._cb_lock:
                        if self._stopped.is_set():
                            continue
                        scb = self._stream_cbs.get(req_id)
                        if scb is not None:
                            # enqueued UNDER the lock: the failure sweep
                            # enqueues its sentinel under the same lock, so
                            # no item can land after the sentinel and be
                            # silently dropped by the completion loop
                            self._completions.put((
                                lambda _r, _s=scb, _p=payload: _s(
                                    _p["stream_item"],
                                    ObjectID.from_hex(_p["oid_hex"])),
                                None,
                            ))
                    continue
                # pop AND enqueue under _cb_lock, mirroring
                # _fail_outstanding: a reply racing stop()/connection-drop
                # must land in exactly one of (this delivery, the failure
                # sweep) — never both, never neither (an enqueue outside
                # the lock could land after the sweep's stop sentinel and
                # never run)
                delivered = False
                with self._cb_lock:
                    if self._stopped.is_set():
                        continue
                    cb = self._done_cbs.pop(req_id, None)
                    self._stream_cbs.pop(req_id, None)
                    if cb is not None:
                        self._completions.put(
                            (cb, self._to_task_result(payload)))
                        delivered = True
                if not delivered:
                    with self._reply_cv:
                        self._replies[req_id] = payload
                        self._reply_cv.notify_all()
        except (WireError, OSError) as e:
            if not self._stopped.is_set():
                logger.warning("dispatch connection to node %s dropped: %r",
                               self.node_id.hex()[:8], e)
        except Exception:  # noqa: BLE001 — a cb bug must not die silently
            logger.exception("remote-agent read loop failed")
        finally:
            self._fail_outstanding(WorkerCrashedError(
                f"connection to node {self.node_id.hex()[:8]} lost"))

    def _fail_outstanding(self, error: BaseException) -> None:
        # under _cb_lock: _send registers callbacks under the same lock
        # and checks _stopped first, so a registration either lands before
        # this snapshot (and is failed here) or observes _stopped and
        # raises — no callback can be silently dropped between the two
        with self._cb_lock:
            self._stopped.set()
            cbs = list(self._done_cbs.values())
            self._done_cbs.clear()
            self._stream_cbs.clear()
            # sweep + sentinel enqueued under the SAME lock the read loop
            # enqueues deliveries under: the sentinel is provably last, so
            # the completion loop never exits with work still queued
            for cb in cbs:
                self._completions.put(
                    (cb, TaskResult(task_id=None, ok=False, error=error)))
            self._completions.put(None)  # drain, then stop the thread
        with self._reply_cv:
            self._replies[-1] = {"ok": False, "error": repr(error), "exc": None}
            self._reply_cv.notify_all()

    @staticmethod
    def _to_task_result(payload: dict) -> TaskResult:
        if payload.get("ok"):
            return TaskResult(task_id=None, ok=True, values=None)
        error = _load_exc(payload.get("exc_blob")) or WorkerCrashedError(
            payload.get("error", "remote task failed"))
        return TaskResult(
            task_id=None, ok=False, error=error,
            is_application_error=bool(payload.get("is_application_error")),
        )

    def _send(self, method: str, *, done: Optional[Callable] = None,
              stream: Optional[Callable] = None, **fields) -> int:
        with self._send_lock:
            with self._cb_lock:
                if self._stopped.is_set():
                    raise WorkerCrashedError(
                        f"connection to node {self.node_id.hex()[:8]} lost")
                self._next_id += 1
                req_id = self._next_id
                if done is not None:
                    self._done_cbs[req_id] = done
                if stream is not None:
                    # registered BEFORE the frame ships: a stream item can
                    # race back before this method returns
                    self._stream_cbs[req_id] = stream
            try:
                send_msg(self._sock, MSG_REQUEST,
                         {"id": req_id, "method": method, **fields})
            except (WireError, OSError) as e:
                with self._cb_lock:
                    had_done = self._done_cbs.pop(req_id, None) is not None
                    self._stream_cbs.pop(req_id, None)
                if done is not None and not had_done:
                    # the failure sweep raced in and already swept this
                    # callback into the completions queue: delivery is the
                    # sweep's; raising would make the caller deliver TWICE
                    return req_id
                raise WorkerCrashedError(
                    f"dispatch to node {self.node_id.hex()[:8]} failed: {e}")
        return req_id

    def _call(self, method: str, timeout: float = 30.0, **fields) -> Any:
        req_id = self._send(method, **fields)
        deadline = time.monotonic() + timeout
        with self._reply_cv:
            while req_id not in self._replies:
                if self._stopped.is_set():
                    raise WorkerCrashedError(
                        f"connection to node {self.node_id.hex()[:8]} lost")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise WorkerCrashedError(f"rpc {method} timed out")
                self._reply_cv.wait(timeout=min(1.0, remaining))
            resp = self._replies.pop(req_id)
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", f"{method} failed"))
        return resp.get("value")

    # -- NodeAgent duck surface --------------------------------------------
    def submit(self, spec, done: Callable[[TaskResult], None],
               stream: Optional[Callable] = None) -> None:
        if self._stopped.is_set():
            done(TaskResult(spec.task_id, ok=False,
                            error=WorkerCrashedError("remote node disconnected")))
            return

        def on_result(result: TaskResult) -> None:
            result.task_id = spec.task_id
            done(result)

        try:
            self._send("submit", done=on_result, stream=stream,
                       spec_blob=_dumps(spec))
        except WorkerCrashedError as e:
            done(TaskResult(spec.task_id, ok=False, error=e))

    def kill_actor(self, actor_id: ActorID, cause: str = "killed") -> bool:
        try:
            return bool(self._call("kill_actor", actor_id_hex=actor_id.hex(),
                                   cause=cause))
        except (WorkerCrashedError, RuntimeError):
            return False

    def has_actor(self, actor_id: ActorID) -> bool:
        try:
            return bool(self._call("has_actor", actor_id_hex=actor_id.hex()))
        except (WorkerCrashedError, RuntimeError):
            return False

    def prefetch_object(self, oid_hex: str, timeout: float = 120.0) -> bool:
        """Ask the worker host to pull one object into its local store
        (broadcast fan-out). Synchronous: returns once the replica is
        sealed and its location registered, raising on pull failure."""
        return bool(self._call("prefetch_object", timeout=timeout,
                               oid_hex=oid_hex))

    def submit_direct(self, actor_id: ActorID, fn) -> None:
        self.submit_direct_blob(actor_id, _dumps(fn))

    def submit_direct_blob(self, actor_id: ActorID, fn_blob: bytes) -> None:
        """Compiled-graph mailbox enqueue on a remote actor: the closure
        ships as one frame (its channels pickle as DistChannel handles,
        core/channels.py; CompiledDAG serializes each remote closure ONCE
        at compile) and the worker enqueues it INLINE on its dispatch
        loop — one connection, serial handling, so mailbox order equals
        execute() order. Fire-and-forget: an actor dying in the window
        between execute()'s liveness pre-check and the remote enqueue is
        logged here and surfaces as the ref's timeout — the documented
        stranded-envelope semantics — where the local path would raise
        synchronously. A dead CONNECTION still raises here like the
        local path's dead-actor check."""
        def on_done(result: TaskResult) -> None:
            if not result.ok:
                logger.warning("remote submit_direct failed: %r", result.error)

        self._send("submit_direct", done=on_done,
                   actor_id_hex=actor_id.hex(), fn_blob=fn_blob)

    def kill_running_tasks(self) -> None:
        try:
            self._call("kill_running_tasks", timeout=5.0)
        except (WorkerCrashedError, RuntimeError):
            pass

    # -- profiling plane (util/profiler via node_agent) ---------------------
    def profilable_pids(self) -> Dict[str, Any]:
        return dict(self._call("profilable_pids", timeout=10.0))

    def profile_start(self, pid: int = 0, duration_s: float = 5.0,
                      hz: Optional[float] = None, kind: str = "cpu",
                      logdir: str = "") -> Dict[str, Any]:
        return dict(self._call(
            "profile_start", timeout=15.0, pid=int(pid),
            duration_s=float(duration_s), hz=hz, kind=kind, logdir=logdir))

    def profile_fetch(self, pid: int = 0, kind: str = "cpu") -> Dict[str, Any]:
        return dict(self._call("profile_fetch", timeout=15.0, pid=int(pid),
                               kind=kind))

    def _sync_load(self) -> None:
        """No-op: the worker host heartbeats the control plane itself."""

    def stop(self, notify: bool = True) -> None:
        """notify=False drops the proxy without telling the worker host to
        exit: used when the head reaps a node on a stale heartbeat — the
        host may only be partitioned and will rejoin, so sending the stop
        frame would kill a survivor."""
        if self._stopped.is_set():
            return
        if notify:
            try:
                self._send("stop")
            except (WorkerCrashedError, OSError):
                pass
        self._fail_outstanding(WorkerCrashedError("node removed"))
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self.store.close()


def enable_cross_host(runtime) -> ObjectTransferServer:
    """Turn the head runtime into a joinable cluster head: serve its agents'
    stores on the transfer plane and attach a RemoteNodeAgent for every
    worker host that registers (reference: node addition through GCS node
    table + raylet connection, `gcs_node_manager.cc`)."""
    transfer = ObjectTransferServer(
        _AgentStoreAdapter(runtime),
        host=config.control_plane_rpc_host,
    )
    # the ADVERTISED address must be reachable from workers: a wildcard
    # bind (0.0.0.0) would advertise an address that resolves to the
    # WORKER's own host — substitute the head's cluster-facing node_host
    bind_host, _, bind_port = transfer.address.rpartition(":")
    if bind_host in ("0.0.0.0", "::", ""):
        advertised = f"{config.node_host}:{bind_port}"
    else:
        advertised = transfer.address

    # one address serves every local (virtual) node's store
    def _advertise_local(node_id: NodeID) -> None:
        runtime.control_plane.kv_put(KV_PREFIX + node_id.hex(), advertised)

    with runtime._lock:
        local_ids = list(runtime.agents)
    for nid in local_ids:
        _advertise_local(nid)

    def on_node_event(event: Tuple[str, NodeInfo]) -> None:
        state, info = event
        if state == "DEAD":
            # drop the proxy so a rejoining host (same ID, re-register)
            # dials fresh instead of reusing a dead socket. remove_node is
            # idempotent (agent already popped -> early return) and its
            # mark_node_dead on an already-DEAD node does not re-publish,
            # so this cannot loop.
            runtime.remove_node(info.node_id)
            return
        if state != "ALIVE":
            return
        with runtime._lock:
            known = info.node_id in runtime.agents
        if known:
            return
        svc = runtime.control_plane.kv_get(NODE_SERVICE_PREFIX + info.node_id.hex())
        taddr = runtime.control_plane.kv_get(KV_PREFIX + info.node_id.hex())
        if not svc or not taddr:
            _advertise_local(info.node_id)  # a local late-joining virtual node
            return
        svc = svc.decode() if isinstance(svc, bytes) else svc
        taddr = taddr.decode() if isinstance(taddr, bytes) else taddr
        try:
            proxy = RemoteNodeAgent(info, svc, taddr)
        except OSError as e:
            logger.warning("cannot reach joining node %s at %s: %s",
                           info.node_id.hex()[:8], svc, e)
            runtime.control_plane.mark_node_dead(info.node_id, f"unreachable: {e}")
            return
        runtime.directory.register_agent(proxy)
        with runtime._lock:
            runtime.agents[info.node_id] = proxy
        logger.info("remote node %s joined (dispatch %s, transfer %s)",
                    info.node_id.hex()[:8], svc, taddr)
        runtime.pg_manager._retry_queued()
        runtime._kick_scheduler()

    runtime.control_plane.pubsub.subscribe("node", on_node_event)
    # catch-up sweep: the RPC server starts serving BEFORE this subscribe
    # (api.init order), so a worker re-registering into a restarted head in
    # that window would be ALIVE in the table but never dialed — replay
    # registrations that raced in
    for info in runtime.control_plane.alive_nodes():
        on_node_event(("ALIVE", info))
    # workers block on object availability via this channel (obj_loc):
    # publish every directory add so RemoteDirectoryClient.subscribe_once
    # wakes without polling
    runtime.directory.on_add = lambda oid, nid: runtime.control_plane.pubsub.publish(
        "obj_loc", oid.hex()
    )
    # a producing task that failed for good wakes the same waiters, which
    # then read the failure (RemoteDirectoryClient.failure)
    runtime.directory.on_failed = lambda oid: runtime.control_plane.pubsub.publish(
        "obj_loc", oid.hex()
    )
    runtime._transfer_server = transfer
    return transfer


# ---------------------------------------------------------------------------
# Worker side: join a head, serve dispatch
# ---------------------------------------------------------------------------


class RemoteDirectoryClient:
    """Worker-side view of the head's ObjectDirectory (duck-typed for
    NodeAgent): location writes go to the head; reads resolve holders into
    pull-capable proxies via the KV-advertised transfer addresses."""

    def __init__(self, control_plane: RemoteControlPlane, self_node_id: NodeID):
        self._cp = control_plane
        self._self_id = self_node_id
        self._transfer = ObjectTransferClient()
        self._lock = threading.Lock()
        self._waiters: Dict[str, List[Callable[[], None]]] = {}
        self._subscribed = False
        # ~1s-cached ALIVE node set: locate() must not hand out holders on
        # nodes the head already marked DEAD (the mark -> KV-purge window),
        # but a per-locate alive_nodes RPC would double every pull's RTT
        self._alive_hexes: Optional[set] = None
        self._alive_at = 0.0
        # host tokens are immutable per boot: cache them forever so the
        # prefer_local ranking in locate() costs one KV round-trip per
        # holder total, not per pull
        self._host_tokens: Dict[str, str] = {}
        # waiter callbacks run OFF the control-plane read loop: they issue
        # blocking RPCs (dir_locations, kv_get) on the SAME connection whose
        # read loop delivers the replies — firing inline would deadlock the
        # whole worker (pull hangs, heartbeats wedge)
        self._fire_queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._last_fire: Dict[str, float] = {}
        threading.Thread(
            target=self._fire_loop, daemon=True, name="dir-obj-ready"
        ).start()

    def _fire_loop(self) -> None:
        while True:
            oid_hex = self._fire_queue.get()
            if oid_hex is None:
                return
            with self._lock:
                has_waiters = bool(self._waiters.get(oid_hex))
            if not has_waiters:
                # duplicate enqueue (subscribe-check + pubsub event race):
                # nothing to fire, and sleeping here would head-of-line
                # delay ready callbacks for unrelated objects
                continue
            # throttle per object: a pull that keeps failing against a
            # stale location (dead holder not yet reaped) re-subscribes and
            # immediately re-fires — unthrottled, that hammers the head
            # with dir_locations/kv_get RPCs for the whole reap window
            gap = 0.1 - (time.monotonic() - self._last_fire.get(oid_hex, 0.0))
            if gap > 0:
                time.sleep(gap)
            if len(self._last_fire) > 4096:
                self._last_fire.clear()
            self._last_fire[oid_hex] = time.monotonic()
            self._fire(oid_hex)

    def add_location(self, object_id: ObjectID, node_id: NodeID,
                     bytes_available: Optional[int] = None) -> None:
        self._cp.dir_add_location(object_id.hex(), node_id.hex(),
                                  bytes_available=bytes_available)

    def remove_location(self, object_id: ObjectID, node_id: NodeID) -> None:
        self._cp.dir_remove_location(object_id.hex(), node_id.hex())

    def locations(self, object_id: ObjectID) -> List[NodeID]:
        return [NodeID.from_hex(h) for h in self._cp.dir_locations(object_id.hex())]

    def failure(self, object_id: ObjectID) -> Optional[BaseException]:
        """The error of the object's producing task when it failed for good
        (the head's future table, through proxy_ref_state), else None: a
        task on this host whose argument failed fails with it, as one on
        the head does (ObjectDirectory.mark_failed). The head publishes
        the object on obj_loc when it fails, so a waiter re-checks."""
        try:
            st = self._cp.proxy_ref_state([object_id.hex()])[object_id.hex()]
        except Exception:  # noqa: BLE001 — unknown: keep waiting
            return None
        if st["state"] != "error":
            return None
        return _load_exc(st["error_blob"])

    def _alive(self) -> Optional[set]:
        now = time.monotonic()
        if self._alive_hexes is None or now - self._alive_at > 1.0:
            try:
                self._alive_hexes = {
                    n.node_id.hex() for n in self._cp.alive_nodes()}
                self._alive_at = now
            except Exception:  # noqa: BLE001 — fall back to unfiltered
                self._alive_at = now
        return self._alive_hexes

    def _host_token_of(self, hexid: str) -> str:
        token = self._host_tokens.get(hexid)
        if token is None:
            try:
                raw = self._cp.kv_get(HOST_PREFIX + hexid)
            except Exception:  # noqa: BLE001 — tokens are advisory
                raw = None
            token = raw.decode() if isinstance(raw, bytes) else (raw or "")
            self._host_tokens[hexid] = token
        return token

    def locate(self, object_id: ObjectID, exclude: Optional[NodeID] = None,
               prefer_local: bool = False):
        """First live holder. With prefer_local, holders whose advertised
        host token matches this process rank first — a same-host pull
        short-circuits to the shm fd handoff in ObjectTransferClient.pull
        instead of copying the payload through a loopback socket."""
        alive = self._alive()
        candidates = []
        for hexid in self._cp.dir_locations(object_id.hex()):
            node_id = NodeID.from_hex(hexid)
            if node_id == exclude:
                continue
            if alive is not None and hexid not in alive:
                continue  # directory entry outlived its node
            addr = self._cp.kv_get(KV_PREFIX + hexid)
            if not addr:
                continue
            addr = addr.decode() if isinstance(addr, bytes) else addr
            if not prefer_local:
                object_ledger.note_peer(addr, hexid)
                return _PullHolder(addr, self._transfer, node_id)
            candidates.append((hexid, node_id, addr))
        if not candidates:
            return None
        local = _host_token()
        candidates.sort(key=lambda c: self._host_token_of(c[0]) != local)
        hexid, node_id, addr = candidates[0]
        object_ledger.note_peer(addr, hexid)
        return _PullHolder(addr, self._transfer, node_id)

    def subscribe_once(self, object_id: ObjectID, callback: Callable[[], None]) -> None:
        oid_hex = object_id.hex()
        with self._lock:
            if not self._subscribed:
                self._cp.subscribe("obj_loc", self._on_obj_loc)
                self._subscribed = True
            self._waiters.setdefault(oid_hex, []).append(callback)
        # subscribe-then-check closes the race with a concurrent seal; fire
        # via the queue so a failed-pull -> resubscribe cycle cannot recurse
        # on this stack
        if self._cp.dir_locations(oid_hex):
            self._fire_queue.put(oid_hex)

    def _on_obj_loc(self, oid_hex: str) -> None:
        self._fire_queue.put(oid_hex)

    def _fire(self, oid_hex: str) -> None:
        with self._lock:
            callbacks = self._waiters.pop(oid_hex, [])
        for cb in callbacks:
            try:
                cb()
            except Exception:  # noqa: BLE001
                logger.exception("object-ready callback failed")


class _PullHolder:
    """Minimal holder handle: .store.get_raw pulls sealed bytes."""

    class _Store:
        def __init__(self, addr: str, client: ObjectTransferClient):
            self._addr = addr
            self._client = client

        def get_raw(self, oid, timeout=None):
            try:
                return self._client.pull(self._addr, oid, raw=True)
            except ObjectPullError as e:
                raise ObjectLostError(oid) from e

        def get(self, oid, timeout=None):
            try:
                return self._client.pull(self._addr, oid)
            except ObjectPullError as e:
                raise ObjectLostError(oid) from e

    def __init__(self, addr: str, client: ObjectTransferClient,
                 node_id: Optional[NodeID] = None):
        self.store = self._Store(addr, client)
        self.node_id = node_id
        self._stopped = threading.Event()  # duck parity with NodeAgent


class _WorkerDispatchHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: "WorkerNodeServer" = self.server  # type: ignore[assignment]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_lock = threading.Lock()

        def reply(payload: dict) -> None:
            try:
                with send_lock:
                    send_msg(sock, MSG_RESPONSE, payload)
            except (WireError, OSError):
                pass  # head gone; worker keeps running until told otherwise

        try:
            while True:
                msg_type, req = recv_msg(sock)
                if msg_type != MSG_REQUEST:
                    raise WireError(f"unexpected message type {msg_type}")
                try:
                    self._dispatch(server, req, reply)
                except Exception as e:  # noqa: BLE001 — serialized to caller
                    reply({"id": req.get("id"), "ok": False, "error": repr(e)})
        except (WireError, OSError):
            pass

    def _dispatch(self, server: "WorkerNodeServer", req: dict, reply) -> None:
        method = req.get("method")
        req_id = req.get("id")
        agent = server.agent
        if method == "submit":
            spec = pickle.loads(req["spec_blob"])

            def done(result: TaskResult) -> None:
                if result.ok:
                    reply({"id": req_id, "ok": True})
                else:
                    reply({
                        "id": req_id, "ok": False,
                        "error": repr(result.error),
                        "exc_blob": _dump_exc(result.error),
                        "is_application_error": result.is_application_error,
                    })

            stream_cb = None
            if spec.options.num_returns == "streaming":
                def stream_cb(i, oid):
                    reply({"id": req_id, "stream_item": i, "oid_hex": oid.hex()})

            # off the read loop: submit() pulls missing dependencies inline,
            # which must not serialize behind other dispatches
            threading.Thread(
                target=agent.submit, args=(spec, done),
                kwargs={"stream": stream_cb}, daemon=True,
                name=f"dispatch-{spec.task_id.hex()[:8]}",
            ).start()
        elif method == "submit_direct":
            # INLINE, never a thread: serial handling on this connection
            # is what makes remote mailbox order match execute() order
            fn = pickle.loads(req["fn_blob"])
            agent.submit_direct(ActorID.from_hex(req["actor_id_hex"]), fn)
            reply({"id": req_id, "ok": True})
        elif method == "kill_actor":
            ok = agent.kill_actor(ActorID.from_hex(req["actor_id_hex"]),
                                  cause=req.get("cause", "killed"))
            reply({"id": req_id, "ok": True, "value": ok})
        elif method == "has_actor":
            reply({"id": req_id, "ok": True,
                   "value": agent.has_actor(ActorID.from_hex(req["actor_id_hex"]))})
        elif method == "store_delete":
            agent.store.delete(ObjectID.from_hex(req["oid_hex"]))
            reply({"id": req_id, "ok": True, "value": True})
        elif method == "prefetch_object":
            # broadcast fan-out: pull the object into THIS host's store
            # (joining the relay tree if one is forming). Off the read
            # loop — a 1GB pull must not stall unrelated dispatches.
            def _prefetch():
                try:
                    rt = getattr(server, "runtime", None)
                    if rt is None:
                        raise RuntimeError("worker runtime not attached")
                    rt.prefetch_object(req["oid_hex"])
                    reply({"id": req_id, "ok": True, "value": True})
                except Exception as e:  # noqa: BLE001 — serialized to caller
                    reply({"id": req_id, "ok": False, "error": repr(e)})

            threading.Thread(target=_prefetch, daemon=True,
                             name="dispatch-prefetch").start()
        elif method == "try_acquire":
            # placement-group bundle reservation on THIS node's ledger
            ok = agent.resources.try_acquire(req["demand"])
            agent._sync_load()
            reply({"id": req_id, "ok": True, "value": ok})
        elif method == "release":
            agent.resources.release(req["demand"])
            agent._sync_load()
            reply({"id": req_id, "ok": True, "value": True})
        elif method == "resources_available":
            reply({"id": req_id, "ok": True,
                   "value": agent.resources.available()})
        elif method == "kill_running_tasks":
            agent.kill_running_tasks()
            reply({"id": req_id, "ok": True, "value": True})
        elif method == "profilable_pids":
            reply({"id": req_id, "ok": True, "value": agent.profilable_pids()})
        elif method == "profile_start":
            reply({"id": req_id, "ok": True, "value": agent.profile_start(
                pid=req.get("pid", 0),
                duration_s=req.get("duration_s", 5.0),
                hz=req.get("hz"), kind=req.get("kind", "cpu"),
                logdir=req.get("logdir", ""))})
        elif method == "profile_fetch":
            # dump_child blocks on the signalled child writing its file:
            # off the read loop so a slow dump can't stall other dispatches
            def _fetch():
                try:
                    value = agent.profile_fetch(
                        pid=req.get("pid", 0), kind=req.get("kind", "cpu"))
                    reply({"id": req_id, "ok": True, "value": value})
                except Exception as e:  # noqa: BLE001 — serialized to caller
                    reply({"id": req_id, "ok": False, "error": repr(e)})

            threading.Thread(target=_fetch, daemon=True,
                             name="dispatch-profile-fetch").start()
        elif method == "ping":
            reply({"id": req_id, "ok": True, "value": True})
        elif method == "stop":
            reply({"id": req_id, "ok": True, "value": True})
            server.owner_requested_stop.set()
        else:
            reply({"id": req_id, "ok": False, "error": f"unknown method {method!r}"})


class WorkerNodeServer(socketserver.ThreadingTCPServer):
    """Serves one worker host's NodeAgent for head dispatch."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, agent: NodeAgent, host: str = "127.0.0.1", port: int = 0):
        super().__init__((host, port), _WorkerDispatchHandler)
        self.agent = agent
        # back-reference set by WorkerRuntime: prefetch_object needs the
        # runtime's transfer client/server, not just the agent
        self.runtime: Optional["WorkerRuntime"] = None
        self.owner_requested_stop = threading.Event()
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="worker-dispatch"
        )
        self._thread.start()
        logger.info("worker dispatch on %s:%d", *self.server_address)

    @property
    def address(self) -> str:
        host, port = self.server_address
        return f"{host}:{port}"

    def stop(self) -> None:
        self.shutdown()
        self.server_close()


class WorkerRuntime:
    """A worker host joined to a head: one NodeAgent + the servers that make
    it reachable. Created by ``ray_tpu_torch.init(address=...)``.

    This process is a WORKER, not a driver: the head owns scheduling and
    object futures (single-controller, SURVEY §7.1). The task-submission
    API still works here — it proxies to the head's ownership tables over
    the back-channel (``api_client()`` / `worker_api.WorkerAPIClient`),
    mirroring the reference's every-worker-is-a-CoreWorker pattern without
    giving up the single scheduler."""

    def __init__(
        self,
        address: str,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        node_host: Optional[str] = None,
    ):
        from ..api import default_node_resources

        if node_host is None:
            node_host = config.node_host

        self.head_address = address
        self._node_host = node_host
        self.control_plane = RemoteControlPlane(address, role="worker")
        # federated head? adopt shard routing for KV/pubsub so this host's
        # gossip never rides the head connection (dir_* stays head-routed:
        # the head's ObjectDirectory is the transfer plane's authority)
        shard_map = self._probe_shard_map(self.control_plane)
        if shard_map:
            from .rpc import ShardedControlPlane

            self.control_plane = ShardedControlPlane(
                self.control_plane, shard_map["addresses"], role="worker")
            logger.info("joined a federated control plane (%d shards)",
                        len(shard_map["addresses"]))
        node_resources = default_node_resources(num_cpus, num_gpus, resources)
        self.info = NodeInfo(
            node_id=NodeID.generate(),
            address=f"{node_host}",
            resources_total=node_resources,
            labels=labels or {},
        )
        self.node_id = self.info.node_id
        object_ledger.set_local_node(self.node_id.hex())
        self.directory = RemoteDirectoryClient(self.control_plane, self.node_id)
        self.agent = NodeAgent(self.info, self.control_plane, self.directory)
        self.dispatch_server = WorkerNodeServer(self.agent, host=node_host)
        self.dispatch_server.runtime = self
        self.transfer_server = ObjectTransferServer(self.agent.store, host=node_host)
        self._stopped = threading.Event()
        # advertise BEFORE registering: the head resolves both addresses
        # inside the node-ALIVE pubsub handler (ordering guaranteed: one
        # socket, serialized requests)
        self.control_plane.kv_put(
            NODE_SERVICE_PREFIX + self.node_id.hex(), self.dispatch_server.address)
        self.control_plane.kv_put(
            KV_PREFIX + self.node_id.hex(), self.transfer_server.address)
        self.control_plane.kv_put(
            HOST_PREFIX + self.node_id.hex(), _host_token())
        # compiled-graph channels homed here (consumer-side queues) are
        # reachable through this process's channel service
        from .channels import KV_CHANNEL_PREFIX, ensure_service

        self.control_plane.kv_put(
            KV_CHANNEL_PREFIX + self.node_id.hex(), ensure_service(node_host))
        self.control_plane.register_node(self.info)
        # head restart: the reconnected client has resubscribed pubsub, but
        # the head's node table and object directory are not persisted —
        # push our registration and held-object locations back
        self.control_plane.add_reconnect_listener(self._rejoin)
        self._api_client = None
        self._api_client_lock = threading.Lock()
        # pool-worker children inherit this and build their own back-channel
        # client lazily on first API touch (api._auto_init)
        import os as _os

        _os.environ["RAY_TPU_HEAD_ADDRESS"] = address
        # telemetry flush cursors (advanced only after a successful report,
        # so a failed flush retries the same tail next beat)
        self._telemetry_span_cursor = 0
        self._telemetry_event_cursor = 0
        self._last_telemetry = 0.0
        # per-field wire-form hashes of the last CONFIRMED report
        # (delta-encoding: unchanged fields ship as None = keep-previous)
        self._telemetry_sent_hash: Dict[str, int] = {}
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="worker-heartbeat"
        )
        self._hb_thread.start()
        logger.info("joined cluster at %s as node %s (%s)",
                    address, self.node_id.hex()[:8], node_resources)

    def api_client(self):
        """The ownership back-channel for code running in THIS process
        (in-process tasks/actors on a joined host): a Runtime-duck client
        proxying submissions to the head (see `worker_api`). Lazy — the
        dedicated connection only exists if the API is actually used."""
        with self._api_client_lock:
            if self._api_client is None:
                if self._stopped.is_set():
                    raise RuntimeError("worker runtime is shut down")
                from .worker_api import WorkerAPIClient

                self._api_client = WorkerAPIClient(
                    self.head_address,
                    local_store=self.agent.store,
                    local_node_id=self.node_id,
                )
            return self._api_client

    def prefetch_object(self, oid_hex: str) -> bool:
        """Pull one object into this host's store (broadcast fan-out
        target). Joins the collective relay tree when one is forming:
        this host serves its committed prefix to later pullers while its
        own pull is still streaming. Raises ObjectPullError if no holder
        can serve the object."""
        oid = ObjectID.from_hex(oid_hex)
        if self.agent.store.contains(oid):
            return True
        nid = self.node_id.hex()
        pull_from_any(
            self.control_plane, oid,
            client=self.directory._transfer,
            cache_store=self.agent.store,
            on_cached=lambda o: self.control_plane.dir_add_location(
                o.hex(), nid),
            relay_server=self.transfer_server,
            node_hex=nid,
        )
        return True

    @staticmethod
    def _probe_shard_map(cp) -> Optional[Dict[str, Any]]:
        """Read the head's shard-map advertisement (shard.SHARD_MAP_KEY);
        None on a single-head cluster or any decode trouble (the plain
        head connection always works, so adoption is best-effort)."""
        import json as _json

        try:
            raw = cp.kv_get("control_plane/shard_map")
            if not raw:
                return None
            if isinstance(raw, bytes):
                raw = raw.decode("utf-8")
            parsed = _json.loads(raw)
            if parsed.get("addresses"):
                return parsed
        except Exception:  # noqa: BLE001 — fall back to the head connection
            logger.debug("shard-map probe failed", exc_info=True)
        return None

    def _rejoin(self) -> None:
        """Re-introduce this host to a restarted head: the snapshot restores
        KV/jobs/named actors but deliberately NOT the node table or object
        directory (restored liveness would be a lie — see persistence.py),
        so the survivors rebuild both. Re-put the advertised addresses,
        re-advertise every locally-held object, then register_node LAST —
        the head's node-ALIVE handler resolves the KV addresses when it
        dials back. Also the recovery path for a false reap (heartbeat
        returned False): same sequence, same ordering constraint."""
        if self._stopped.is_set():
            return
        from .channels import KV_CHANNEL_PREFIX, ensure_service

        # a head that forgot us has no previous telemetry to keep: drop
        # the delta-encoding hashes so the next flush ships every field
        self._telemetry_sent_hash.clear()
        try:
            nid = self.node_id.hex()
            self.control_plane.kv_put(
                NODE_SERVICE_PREFIX + nid, self.dispatch_server.address)
            self.control_plane.kv_put(
                KV_PREFIX + nid, self.transfer_server.address)
            self.control_plane.kv_put(HOST_PREFIX + nid, _host_token())
            self.control_plane.kv_put(
                KV_CHANNEL_PREFIX + nid, ensure_service(self._node_host))
            held = self.agent.store.list_objects()
            for oid, _nbytes in held:
                self.control_plane.dir_add_location(oid.hex(), nid)
            self.control_plane.register_node(self.info)
            logger.info("re-registered with head at %s (%d objects "
                        "re-advertised)", self.head_address, len(held))
        except (ConnectionError, RuntimeError) as e:
            # head flapped again mid-rejoin: the next reconnect (or the
            # heartbeat loop seeing False) retries the whole sequence
            logger.warning("rejoin attempt failed (%s); will retry", e)

    def _heartbeat_loop(self) -> None:
        period = config.health_check_period_ms / 1000.0
        while not self._stopped.is_set():
            # a stop request beats everything, including an unreachable
            # head: the owner asked us to exit
            if self.dispatch_server.owner_requested_stop.is_set():
                logger.info("head requested stop; shutting worker down")
                self.shutdown()
                return
            try:
                alive = self.control_plane.heartbeat(
                    self.node_id, self.agent.resources.available(),
                    _deadline_s=max(2.0, period))
            except ControlPlaneUnavailable:
                # head down or restarting: ride it out — the client is
                # already reconnecting with backoff, and _rejoin fires on
                # the reconnect listener
                logger.warning("head unreachable; worker riding out the "
                               "outage (reconnect in progress)")
                self._stopped.wait(period)
                continue
            except (WireError, OSError, RuntimeError):
                if self._stopped.is_set():
                    return
                self._stopped.wait(period)
                continue
            if alive is False:
                # the head reaped us (partition outlived the health timeout)
                # or restarted without our registration: re-register instead
                # of zombie-ing on or dying — tasks we hold results for may
                # still be wanted
                logger.warning("head does not know this node; re-registering")
                self._rejoin()
            elif alive:
                self._maybe_report_telemetry()
            self._stopped.wait(period)

    def _maybe_report_telemetry(self) -> None:
        """Flush this process's metrics snapshot, SLO digests, trace
        spans, timeline events, and any fresh crash postmortems to the
        head, at most every config.telemetry_report_period_s (piggybacked
        on the heartbeat so a partition pauses telemetry along with
        liveness). Lossy-tolerant: cursors only advance on a confirmed
        report, and failures wait for the next beat rather than retrying
        inline. The whole payload is capped at config.telemetry_max_bytes
        (oldest spans/events dropped first, counted in
        telemetry_dropped_total{kind}) so a span burst cannot bloat a
        heartbeat into a megabyte RPC."""
        now = time.monotonic()
        if now - self._last_telemetry < float(config.telemetry_report_period_s):
            return
        from ..util import flight_recorder, profiler, slo, timeline, tracing
        from .metrics import registry as metrics_registry

        try:
            # refresh host CPU / RSS / device-memory gauges so every
            # telemetry flush federates them (no new protocol fields:
            # they ride the metrics snapshot like any other gauge)
            profiler.update_resource_gauges()
        except Exception:  # noqa: BLE001 — accounting must not block the beat
            pass
        span_cur, spans = tracing.drain_since(self._telemetry_span_cursor)
        event_cur, events = timeline.drain_since(self._telemetry_event_cursor)
        objects: List[Dict[str, Any]] = []
        channels: Dict[str, float] = {}
        try:
            # publish window-bandwidth gauges + the bounded ledger snapshot
            # so the head's object/flow matrices include this node
            object_ledger.refresh_flow_gauges()
            if object_ledger.enabled():
                objects = object_ledger.local_snapshots(
                    {self.node_id: self.agent})
            from .channels import channel_stats

            channels = channel_stats()
        except Exception:  # noqa: BLE001 — ledger must not block the beat
            pass
        metrics = metrics_registry.snapshot()
        spans, events = _cap_telemetry(
            metrics, spans, events, int(config.telemetry_max_bytes))
        digests = slo.snapshot()
        postmortems = flight_recorder.drain_postmortems()
        # delta-encoding: report_telemetry is replace-not-append with
        # None = keep-previous per field, so an unchanged snapshot need
        # not re-ship — hash the wire form and send None on a match
        # (reported_at still refreshes head-side, so stale-eviction is
        # unaffected). Steady-state heartbeats shrink to near-empty
        # payloads BEFORE pod aggregation even starts.
        payload: Dict[str, Any] = {"metrics": metrics, "digests": digests,
                                   "objects": objects, "channels": channels}
        sent_hashes: Dict[str, int] = {}
        for field, value in payload.items():
            # hash the metrics field with telemetry_bytes_total itself
            # filtered out: shipping the snapshot increments that counter,
            # which would change the NEXT snapshot and keep the field
            # re-shipping forever
            hashed = value
            if field == "metrics":
                hashed = [m for m in value
                          if m.get("name") != "telemetry_bytes_total"]
            blob = _dumps(hashed)
            digest = hash(blob)
            if self._telemetry_sent_hash.get(field) == digest:
                payload[field] = None
            else:
                sent_hashes[field] = digest
                _m_tele_bytes.inc(len(blob), {"field": field})
        try:
            self.control_plane.report_telemetry(
                self.node_id.hex(),
                role="worker",
                metrics=payload["metrics"],
                spans=spans,
                events=events,
                event_cursor=event_cur,
                digests=payload["digests"],
                postmortems=postmortems,
                objects=payload["objects"],
                channels=payload["channels"],
                _deadline_s=5.0,
            )
        except (ControlPlaneUnavailable, WireError, OSError, RuntimeError) as e:
            logger.debug("telemetry flush failed (%s); retrying next beat", e)
            flight_recorder.requeue_postmortems(postmortems)
            return
        # hashes advance only on a confirmed report (like the cursors): a
        # failed flush re-ships the field next beat
        self._telemetry_sent_hash.update(sent_hashes)
        self._telemetry_span_cursor = span_cur
        self._telemetry_event_cursor = event_cur
        self._last_telemetry = now

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the worker shuts down (head death or stop request)."""
        return self._stopped.wait(timeout)

    @property
    def is_running(self) -> bool:
        return not self._stopped.is_set()

    def shutdown(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        import os as _os

        if _os.environ.get("RAY_TPU_HEAD_ADDRESS") == self.head_address:
            _os.environ.pop("RAY_TPU_HEAD_ADDRESS", None)
        with self._api_client_lock:
            if self._api_client is not None:
                self._api_client.close()
                self._api_client = None
        try:
            # short deadlines: when the head is gone this is best-effort
            # cleanup, not worth stalling shutdown for the full default
            self.control_plane._call(
                "kv_del", NODE_SERVICE_PREFIX + self.node_id.hex(),
                _deadline_s=2.0)
            self.control_plane._call(
                "kv_del", KV_PREFIX + self.node_id.hex(), _deadline_s=2.0)
            self.control_plane._call(
                "mark_node_dead", self.node_id, "worker shutdown",
                _deadline_s=2.0)
        except (WireError, OSError, RuntimeError):
            pass
        self.dispatch_server.stop()
        self.transfer_server.stop()
        self.agent.stop()
        self.control_plane.close()


def join_cluster(address: str, **kwargs) -> WorkerRuntime:
    """Join an existing cluster as a worker host (push-dispatch target)."""
    return WorkerRuntime(address, **kwargs)
