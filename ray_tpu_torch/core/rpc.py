"""Control-plane RPC: the single-authority tables served over TCP.

Reference analogue: `src/ray/rpc/gcs_server/` (GcsRpcServer) and
`gcs_client/` — every daemon talks to the GCS over gRPC. Here the same
shape: `serve_control_plane` exposes a ControlPlane's public methods on a
socket, `RemoteControlPlane` is a drop-in client with the same duck-typed
surface, so a Runtime on another host (or another OS process on the same
host) can share one authority. Pubsub crosses the wire as pushed EVENT
frames feeding the client's local Pubsub — subscribers are oblivious.

Fault tolerance (reference: GCS-FT — Redis-backed tables plus client-side
accessor resubscribe): the client survives head death. Connection loss
triggers bounded exponential-backoff reconnect (config
`control_plane_reconnect_max_s`); every call runs under a deadline
(`control_plane_call_deadline_s`); idempotent methods retry transparently
across reconnects, non-idempotent ones surface the retryable
`ControlPlaneUnavailable`. On reconnect every channel in `_subscribed`
re-registers server-side, so pubsub survives a head restart invisibly.
Request/reply state is PER CONNECTION (`_Conn`): a straggler response from
connection N can never satisfy a request issued on connection N+1, even
though request ids restart at 1 on each connection.

Threading model: one handler thread per connection (control-plane call
rates are low; no need for an event loop), one push thread per subscribed
client. The client proxy serializes request/response pairs over one
socket with a lock; pushed events are queued by the per-connection reader
thread and delivered to the local Pubsub from a dedicated dispatcher
thread — subscriber callbacks may therefore issue RPCs on this same
client (a callback running ON the reader would deadlock: the reply it
waits for can only be decoded by the reader it is blocking). A
short-lived reconnect thread re-dials after a loss and exits once a
connection is installed.

Registry invariant (tests/test_torch_rpc.py checks it for every registry
here and in core/shard.py): `_IDEMPOTENT_METHODS` must be a subset of
`_ALLOWED_METHODS` — a transparently retried method that isn't served
would loop into 'method not served' rejections. New control-plane methods
must be added to `_ALLOWED_METHODS` and, deliberately, to
`_IDEMPOTENT_METHODS` only when a blind resend after an ambiguous
connection loss is safe.

The port's copy of ray_tpu/core/rpc.py, over the port's core/wire.py. It
imports no torch: a shard process (core/shard.py) loads it alone.
"""

from __future__ import annotations

import queue
import random
import socket
import socketserver
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Set

from .config import config
from .logging import get_logger
from .metrics import Counter
from .wire import MSG_EVENT, MSG_REQUEST, MSG_RESPONSE, WireError, recv_msg, send_msg

logger = get_logger("rpc")

_reconnects_total = Counter(
    "control_plane_reconnects_total",
    "Control-plane client connections re-established after a loss, by role",
)
_redials_throttled = Counter(
    "control_plane_redials_throttled_total",
    "Reconnect dial attempts delayed by the process-wide dial-rate cap",
)

# the served surface (N1's public API): anything else is rejected
_ALLOWED_METHODS: Set[str] = {
    "register_node", "mark_node_dead", "heartbeat", "heartbeat_bulk",
    "alive_nodes", "get_node", "all_nodes",
    "report_telemetry", "telemetry_snapshots", "postmortems",
    # profiling plane (util/profiler.py via cross_host.HeadService):
    # stack dumps / sampling profiles / xplane captures on any node
    "profile_start", "profile_fetch",
    "register_actor", "update_actor", "get_actor", "get_named_actor",
    "list_actors",
    "register_job", "finish_job", "list_jobs",
    "kv_put", "kv_get", "kv_del", "kv_keys",
    # object-directory ops for joined worker hosts (cross_host.HeadService)
    "dir_add_location", "dir_remove_location", "dir_locations",
    # ownership back-channel: nested submission from joined-host code
    # (cross_host.HeadService proxy_*, worker_api.WorkerAPIClient)
    "proxy_job_id", "proxy_submit_task", "proxy_create_actor",
    "proxy_submit_actor_task", "proxy_kill_actor", "proxy_ref_state",
    "proxy_put", "proxy_pin", "proxy_free", "proxy_get_value",
    "proxy_keepalive", "proxy_submit_streaming",
    # pubsub registration: dispatched before the allowlist check in the
    # handler (it mutates per-connection push state), but it belongs here
    # so the registry invariant (idempotent ⊆ allowed) holds
    "subscribe",
}

# Methods safe to resend after an ambiguous connection loss (the reply may
# have been lost AFTER the head applied the request): reads, liveness
# refreshes, and set-semantics writes. Everything else (register_actor,
# proxy_submit_*, ...) surfaces ControlPlaneUnavailable instead — a blind
# resend could duplicate the mutation, so the caller decides.
_IDEMPOTENT_METHODS: Set[str] = {
    "heartbeat", "heartbeat_bulk", "alive_nodes", "get_node", "all_nodes",
    # telemetry: metrics replace the prior snapshot, spans dedupe by id,
    # timeline events are cursor-guarded — a resend is absorbed
    "report_telemetry", "telemetry_snapshots", "postmortems",
    # profile_start is a no-op while a window is already open and
    # profile_fetch re-reads the same accumulation — resends absorb
    "profile_start", "profile_fetch",
    "get_actor", "get_named_actor", "list_actors", "list_jobs",
    "kv_put", "kv_get", "kv_del", "kv_keys",
    "dir_add_location", "dir_remove_location", "dir_locations",
    "subscribe",
    "proxy_job_id", "proxy_ref_state", "proxy_keepalive", "proxy_free",
    "proxy_pin", "proxy_get_value",
}


def shard_for_key(key: str, nshards: int) -> int:
    """Consistent key→shard routing for the federated control plane.

    Stable across processes and Python runs (crc32, not hash()): every
    client and every shard service must agree on ownership, including a
    client that reconnects after a shard failover. Keys hash as raw
    strings — no namespace stripping — so a key's owner never depends on
    how callers spell prefixes."""
    if nshards <= 1:
        return 0
    return zlib.crc32(key.encode("utf-8", "surrogatepass")) % nshards


class _DialGate:
    """Process-wide reconnect dial-rate cap (token bucket).

    128 agents that all lost the same shard must not thundering-herd the
    restarted/promoted listener with simultaneous SYNs + resubscribe
    bursts: every reconnect dial in this process first takes a token
    here (config ``control_plane_redial_rate`` tokens/s, burst of one
    second's worth). First dials at construction are NOT gated — join
    latency is user-visible; only the storm-prone redial path is."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tokens = 0.0
        self._stamp = time.monotonic()

    def acquire(self, cancel: threading.Event) -> None:
        rate = float(config.control_plane_redial_rate)
        if rate <= 0:
            return  # cap disabled
        throttled = False
        while not cancel.is_set():
            with self._lock:
                now = time.monotonic()
                self._tokens = min(rate, self._tokens + (now - self._stamp) * rate)
                self._stamp = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / rate
            if not throttled:
                throttled = True
                _redials_throttled.inc()
            cancel.wait(min(wait, 0.5))


_dial_gate = _DialGate()


class ControlPlaneUnavailable(ConnectionError):
    """Retryable: the control plane is unreachable (head down or
    restarting) or the call's deadline elapsed before a reply landed.
    Idempotent methods never raise this while the deadline allows a
    retry; for non-idempotent methods the caller owns the retry decision
    (the request MAY have been applied)."""


class _ConnLost(Exception):
    """Internal: the connection died before this call's reply arrived."""


class _DeadlineExceeded(Exception):
    """Internal: the per-call deadline elapsed while waiting for a reply."""


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: "ControlPlaneServer" = self.server  # type: ignore[assignment]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_lock = threading.Lock()
        unsubscribes = []
        server._track(sock)
        try:
            while True:
                msg_type, req = recv_msg(sock)
                if msg_type != MSG_REQUEST:
                    raise WireError(f"unexpected message type {msg_type}")
                method = req.get("method", "")
                if method == "subscribe":
                    # push this channel's events to the client as EVENT
                    # frames; on the first push failure the subscription is
                    # dropped immediately — a client that reconnects many
                    # times must not accumulate dead sinks head-side until
                    # the next request on this (gone) handler
                    channel = req["args"][0]
                    unsub_cell: List[Callable[[], None]] = []

                    def push(message, _ch=channel, _cell=unsub_cell):
                        try:
                            with send_lock:
                                send_msg(sock, MSG_EVENT,
                                         {"channel": _ch, "message": message})
                        except OSError:
                            if _cell:
                                _cell[0]()

                    unsub = server.control_plane.pubsub.subscribe(channel, push)
                    unsub_cell.append(unsub)
                    unsubscribes.append(unsub)
                    resp = {"id": req["id"], "ok": True, "value": True}
                elif method not in server.allowed_methods:
                    resp = {"id": req["id"], "ok": False,
                            "error": f"method {method!r} not served", "exc": None}
                else:
                    try:
                        value = getattr(server.control_plane, method)(
                            *req.get("args", ()), **req.get("kwargs", {})
                        )
                        resp = {"id": req["id"], "ok": True, "value": value}
                    except Exception as e:  # noqa: BLE001 — serialized to caller
                        resp = {"id": req["id"], "ok": False,
                                "error": repr(e), "exc": e}
                try:
                    with send_lock:
                        send_msg(sock, MSG_RESPONSE, resp)
                except (TypeError, ValueError, AttributeError) as e:
                    # unpicklable value/exception: degrade to a string error
                    # rather than tearing down the connection
                    with send_lock:
                        send_msg(sock, MSG_RESPONSE, {
                            "id": req["id"], "ok": False,
                            "error": f"unserializable response: {e!r}",
                            "exc": None,
                        })
        except (WireError, OSError):
            pass  # client disconnected
        finally:
            server._untrack(sock)
            for unsub in unsubscribes:
                try:
                    unsub()
                except Exception:
                    pass


class ControlPlaneServer(socketserver.ThreadingTCPServer):
    """Serves one ControlPlane on host:port (0 = ephemeral)."""

    daemon_threads = True
    allow_reuse_address = True
    # handler threads are daemons blocked in recv: joining them on close
    # would hang until every client disconnects — stop() severs them instead
    block_on_close = False

    def __init__(self, control_plane, host: str = "127.0.0.1", port: int = 0,
                 allowed_methods: Optional[Set[str]] = None):
        super().__init__((host, port), _Handler)
        self.control_plane = control_plane
        # per-service registry: shard services reuse this server with
        # their own literal allowlists (subset-checked in the tests)
        self.allowed_methods = (allowed_methods if allowed_methods is not None
                                else _ALLOWED_METHODS)
        self._conn_lock = threading.Lock()
        self._conns: Set[socket.socket] = set()
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="cp-rpc-server"
        )
        self._thread.start()
        logger.info("control-plane RPC on %s:%d", *self.server_address)

    def _track(self, sock: socket.socket) -> None:
        with self._conn_lock:
            self._conns.add(sock)

    def _untrack(self, sock: socket.socket) -> None:
        with self._conn_lock:
            self._conns.discard(sock)

    @property
    def address(self) -> str:
        host, port = self.server_address
        return f"{host}:{port}"

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        # sever established connections: a stopped head must look exactly
        # like a dead one to its clients (their read loops wake with a
        # WireError and begin reconnecting), and the handler threads exit
        with self._conn_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def serve_control_plane(control_plane, host: str = "127.0.0.1",
                        port: int = 0) -> ControlPlaneServer:
    """host: bind address — 127.0.0.1 for same-host attach (default),
    0.0.0.0 (config control_plane_rpc_host) for cross-host."""
    return ControlPlaneServer(control_plane, host, port)


class _Conn:
    """One TCP connection's request/reply state. Replies land in THIS
    connection's map only, so a stale response delivered after a reconnect
    cannot be confused with a reply to a request on the new connection
    (request ids restart at 1 per connection by design)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.send_lock = threading.Lock()
        self.next_id = 0
        self.replies: Dict[int, Any] = {}
        self.cv = threading.Condition()
        self.dead = threading.Event()

    def fail(self) -> None:
        with self.cv:
            self.dead.set()
            self.cv.notify_all()

    def close(self) -> None:
        self.fail()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class RemoteControlPlane:
    """Client proxy with ControlPlane's duck-typed surface.

    Method calls serialize over one socket; `subscribe(channel, cb)`
    transparently registers a server-side push and dispatches EVENT frames
    from a reader thread into a local Pubsub. The connection self-heals
    (see module docstring); callers observe at most a retryable
    ControlPlaneUnavailable, bounded by the per-call deadline."""

    def __init__(self, address: str, connect_timeout: float = 10.0,
                 role: str = "client",
                 allowed: Optional[Set[str]] = None,
                 idempotent: Optional[Set[str]] = None):
        from .control_plane import Pubsub

        self._address = address
        self._connect_timeout = connect_timeout
        self._role = role
        # per-service registries (default: the head surface) — shard
        # clients pass their own literal sets
        self._allowed = allowed if allowed is not None else _ALLOWED_METHODS
        self._idempotent = (idempotent if idempotent is not None
                            else _IDEMPOTENT_METHODS)
        self.pubsub = Pubsub()
        self._subscribed: Set[str] = set()
        self._sub_lock = threading.Lock()
        # events are delivered off-reader (see module docstring): the
        # dispatcher thread starts lazily with the first pushed event
        self._event_q: "queue.SimpleQueue[Optional[tuple]]" = queue.SimpleQueue()
        self._event_thread: Optional[threading.Thread] = None
        self._event_lock = threading.Lock()
        self._closed = threading.Event()
        self._conn_cv = threading.Condition()
        self._conn: Optional[_Conn] = None
        self._reconnect_listeners: List[Callable[[], None]] = []
        self.reconnect_count = 0
        # the first dial is synchronous: an unreachable head at construction
        # surfaces to the caller (join-time errors must not become silent
        # background retries)
        conn = self._dial()
        with self._conn_cv:
            self._conn = conn
            self._conn_cv.notify_all()

    # -- connection lifecycle ------------------------------------------------
    def _dial(self) -> _Conn:
        host, _, port = self._address.rpartition(":")
        sock = socket.create_connection((host, int(port)), self._connect_timeout)
        # create_connection leaves its timeout on the socket: clear it, or
        # an idle read loop dies with TimeoutError after connect_timeout
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(sock)
        threading.Thread(
            target=self._read_loop, args=(conn,), daemon=True,
            name="cp-rpc-client",
        ).start()
        return conn

    def _read_loop(self, conn: _Conn) -> None:
        try:
            while True:
                msg_type, payload = recv_msg(conn.sock)
                if msg_type == MSG_EVENT:
                    self._enqueue_event(payload["channel"], payload["message"])
                elif msg_type == MSG_RESPONSE:
                    with conn.cv:
                        conn.replies[payload["id"]] = payload
                        conn.cv.notify_all()
        except Exception:  # noqa: BLE001 — ANY reader death must wake waiters
            pass
        finally:
            conn.close()
            self._on_conn_lost(conn)

    def _enqueue_event(self, channel: str, message: Any) -> None:
        self._event_q.put((channel, message))
        t = self._event_thread
        if t is not None and t.is_alive():
            return
        with self._event_lock:
            t = self._event_thread
            if (t is None or not t.is_alive()) and not self._closed.is_set():
                t = threading.Thread(target=self._event_loop, daemon=True,
                                     name="cp-rpc-events")
                self._event_thread = t
                t.start()

    def _event_loop(self) -> None:
        while True:
            item = self._event_q.get()
            if item is None or self._closed.is_set():
                return
            self.pubsub.publish(*item)

    def _on_conn_lost(self, conn: _Conn) -> None:
        with self._conn_cv:
            if self._conn is not conn:
                return  # stale connection; the current one is healthy
            self._conn = None
            self._conn_cv.notify_all()
        if self._closed.is_set():
            return
        logger.warning("control-plane connection to %s lost; reconnecting",
                       self._address)
        threading.Thread(
            target=self._reconnect_loop, daemon=True, name="cp-rpc-reconnect"
        ).start()

    def _reconnect_loop(self) -> None:
        # Decorrelated jitter (not pure doubling): N clients that lost the
        # same shard at the same instant must desynchronize, or every
        # backoff round re-delivers the whole herd at once. Each sleep is
        # drawn from [base, 3*previous], capped at the config maximum; the
        # process-wide _DialGate then rate-limits the dials themselves.
        cap = max(0.05, config.control_plane_reconnect_max_s)
        backoff = random.uniform(0.05, 0.15)
        while not self._closed.is_set():
            _dial_gate.acquire(self._closed)
            if self._closed.is_set():
                return
            try:
                conn = self._dial()
            except OSError:
                self._closed.wait(backoff)
                backoff = min(cap, random.uniform(0.05, backoff * 3))
                continue
            # re-register every subscribed channel BEFORE installing the
            # connection, so pubsub resumes atomically with the reconnect
            with self._sub_lock:
                channels = list(self._subscribed)
            try:
                deadline = time.monotonic() + max(5.0, self._connect_timeout)
                for ch in channels:
                    self._roundtrip(conn, "subscribe", (ch,), {}, deadline)
            except Exception:  # noqa: BLE001 — died mid-resubscribe: redial
                conn.close()
                self._closed.wait(backoff)
                backoff = min(cap, random.uniform(0.05, backoff * 3))
                continue
            with self._conn_cv:
                if self._closed.is_set():
                    conn.close()
                    return
                if conn.dead.is_set():
                    # the reader died BEFORE install, so its _on_conn_lost
                    # saw a non-current conn and spawned nothing: installing
                    # this corpse would strand the client with no reconnect
                    # thread — retry the dial instead
                    continue
                self._conn = conn
                self.reconnect_count += 1
                self._conn_cv.notify_all()
            _reconnects_total.inc(tags={"role": self._role})
            logger.info(
                "control-plane connection to %s re-established "
                "(%d channels resubscribed)", self._address, len(channels))
            for cb in list(self._reconnect_listeners):
                try:
                    cb()
                except Exception:  # noqa: BLE001 — listeners are best-effort
                    logger.warning("reconnect listener failed", exc_info=True)
            return

    def add_reconnect_listener(self, cb: Callable[[], None]) -> Callable[[], None]:
        """Run cb after every re-established connection (on the reconnect
        thread) — the hook worker hosts use to re-register their NodeInfo
        and re-advertise held objects. Returns a remover."""
        self._reconnect_listeners.append(cb)

        def remove() -> None:
            try:
                self._reconnect_listeners.remove(cb)
            except ValueError:
                pass

        return remove

    # -- plumbing -----------------------------------------------------------
    def _wait_conn(self, deadline: float, method: str) -> _Conn:
        with self._conn_cv:
            while True:
                if self._closed.is_set():
                    raise WireError("control-plane client closed")
                conn = self._conn
                if conn is not None and not conn.dead.is_set():
                    return conn
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ControlPlaneUnavailable(
                        f"control plane at {self._address} unreachable: "
                        f"{method!r} deadline exceeded")
                self._conn_cv.wait(min(0.5, remaining))

    def _roundtrip(self, conn: _Conn, method: str, args, kwargs,
                   deadline: float) -> Any:
        with conn.send_lock:
            if conn.dead.is_set():
                raise _ConnLost()
            conn.next_id += 1
            req_id = conn.next_id
            try:
                send_msg(conn.sock, MSG_REQUEST,
                         {"id": req_id, "method": method,
                          "args": args, "kwargs": kwargs})
            except (WireError, OSError):
                # close so the blocked reader wakes and triggers reconnect
                # even when only the send path is broken (e.g. chaos drop)
                conn.close()
                raise _ConnLost() from None
        with conn.cv:
            while req_id not in conn.replies:
                if conn.dead.is_set():
                    raise _ConnLost()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise _DeadlineExceeded()
                conn.cv.wait(min(0.5, remaining))
            return conn.replies.pop(req_id)

    def _call(self, method: str, *args, _deadline_s: Optional[float] = None,
              **kwargs) -> Any:
        """One RPC under a deadline. `_deadline_s` overrides the config
        default (it is consumed here — never forwarded to the server)."""
        if _deadline_s is None:
            _deadline_s = config.control_plane_call_deadline_s
        deadline = time.monotonic() + _deadline_s
        retryable = method in self._idempotent
        while True:
            conn = self._wait_conn(deadline, method)
            try:
                resp = self._roundtrip(conn, method, args, kwargs, deadline)
            except _ConnLost:
                if retryable:
                    continue  # _wait_conn enforces the deadline
                raise ControlPlaneUnavailable(
                    f"control-plane connection lost during non-idempotent "
                    f"{method!r}; the request may or may not have been "
                    f"applied — the caller owns the retry") from None
            except _DeadlineExceeded:
                raise ControlPlaneUnavailable(
                    f"control-plane call {method!r} exceeded its "
                    f"{_deadline_s:.1f}s deadline") from None
            if resp["ok"]:
                return resp["value"]
            if resp.get("exc") is not None:
                raise resp["exc"]
            raise RuntimeError(resp["error"])

    def subscribe(self, channel: str, callback) -> Any:
        """Subscribe via the local pubsub, lazily registering the remote
        push for this channel. The channel is recorded FIRST: if the head
        is unreachable right now, the reconnect path registers it as soon
        as a connection lands, so the subscription still takes effect."""
        with self._sub_lock:
            first = channel not in self._subscribed
            self._subscribed.add(channel)
        if first:
            try:
                # short deadline: if the head is down, don't park the caller
                # for the full default — the reconnect path registers the
                # channel anyway
                self._call("subscribe", channel, _deadline_s=5.0)
            except ControlPlaneUnavailable:
                logger.warning(
                    "subscribe(%r) deferred: head unreachable (will "
                    "register on reconnect)", channel)
        return self.pubsub.subscribe(channel, callback)

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        with self._conn_cv:
            conn, self._conn = self._conn, None
            self._conn_cv.notify_all()
        if conn is not None:
            conn.close()
        self._event_q.put(None)  # unblock the dispatcher so it exits
        t = self._event_thread
        if t is not None and t is not threading.current_thread():
            # in-flight callbacks fail fast post-close (_wait_conn raises),
            # so this join is a bounded courtesy for the leak guard
            t.join(timeout=5.0)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._allowed:
            raise AttributeError(f"{name!r} is not part of the served surface")

        def call(*args, **kwargs):
            return self._call(name, *args, **kwargs)

        call.__name__ = name
        return call


# methods whose first positional argument is the routing key (a KV key or a
# pubsub channel): these go to the owning shard, the rest of the surface
# rides the head connection
_SHARD_ROUTED_METHODS: Set[str] = {
    "kv_put", "kv_get", "kv_del",
    "publish", "subscribe",
}

# object-location gossip routes to the shards only when the client opts in
# (route_directory=True — the scale harness / pure-gossip fleets). Real
# worker hosts keep dir_* on the head connection: the head's in-process
# ObjectDirectory is the authority its scheduler, lineage reconstruction
# and pull planner read, so splitting writes away from it would fork the
# directory view.
_SHARD_DIR_METHODS: Set[str] = {
    "dir_add_location", "dir_remove_location", "dir_locations",
}


class ShardedControlPlane:
    """Client for a federated control plane: one head connection for the
    node/actor/job/telemetry tables, K shard connections for the KV store,
    pubsub fan-out, and (opt-in) object-directory gossip (consistent
    routing via `shard_for_key`). Duck-compatible with RemoteControlPlane —
    a worker runtime swaps it in without caring. Every underlying
    connection keeps its own reconnect loop, so a shard failover is
    ridden out per-connection while head traffic continues untouched."""

    def __init__(self, head_address, shard_addresses: List[str],
                 connect_timeout: float = 10.0, role: str = "client",
                 route_directory: bool = False):
        from .shard import _SHARD_ALLOWED_METHODS, _SHARD_IDEMPOTENT_METHODS

        # an already-connected head client may be handed over (the worker
        # join path probes the shard map on its head connection first)
        self._head = (head_address
                      if isinstance(head_address, RemoteControlPlane)
                      else RemoteControlPlane(
                          head_address, connect_timeout=connect_timeout,
                          role=role))
        self._routed = (_SHARD_ROUTED_METHODS | _SHARD_DIR_METHODS
                        if route_directory else _SHARD_ROUTED_METHODS)
        self._shards = [
            RemoteControlPlane(
                addr, connect_timeout=connect_timeout,
                role=f"{role}-shard{i}",
                allowed=_SHARD_ALLOWED_METHODS,
                idempotent=_SHARD_IDEMPOTENT_METHODS)
            for i, addr in enumerate(shard_addresses)
        ]
        self.pubsub = self._head.pubsub  # head-channel events land here

    # -- routing -------------------------------------------------------------
    @property
    def head(self) -> RemoteControlPlane:
        return self._head

    @property
    def shards(self) -> List[RemoteControlPlane]:
        return list(self._shards)

    def _shard_client(self, key: str) -> RemoteControlPlane:
        return self._shards[shard_for_key(key, len(self._shards))]

    def _call(self, method: str, *args, **kwargs) -> Any:
        if method in self._routed and self._shards and args:
            return self._shard_client(args[0])._call(method, *args, **kwargs)
        if method == "kv_keys":
            return self.kv_keys(*args, **kwargs)
        return self._head._call(method, *args, **kwargs)

    def kv_keys(self, prefix: str = "", **kwargs) -> List[str]:
        """Prefix listing fans out: a prefix does not pin a shard (keys
        route on their FULL string), so the union across shards is the
        authoritative listing."""
        out: List[str] = []
        for client in self._shards:
            out.extend(client._call("kv_keys", prefix, **kwargs))
        return out

    def subscribe(self, channel: str, callback) -> Any:
        return self._shard_client(channel).subscribe(channel, callback)

    def add_reconnect_listener(self, cb: Callable[[], None]) -> Callable[[], None]:
        """Fires after ANY underlying connection re-establishes: rejoin
        logic re-puts KV (shard-owned) and re-registers the node (head-
        owned), and the whole sequence is idempotent, so re-running it on
        either kind of reconnect is safe and always sufficient."""
        removers = [self._head.add_reconnect_listener(cb)]
        removers += [s.add_reconnect_listener(cb) for s in self._shards]

        def remove() -> None:
            for r in removers:
                r()

        return remove

    @property
    def reconnect_count(self) -> int:
        return self._head.reconnect_count + sum(
            s.reconnect_count for s in self._shards)

    def close(self) -> None:
        self._head.close()
        for s in self._shards:
            s.close()

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._routed and self._shards:

            def routed(*args, **kwargs):
                return self._call(name, *args, **kwargs)

            routed.__name__ = name
            return routed
        return getattr(self._head, name)
