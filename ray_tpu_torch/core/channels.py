"""Distributed SPSC channels for compiled graphs and KV migration.

The port's copy of ray_tpu/core/channels.py. A channel is HOMED in its
consumer's process as a plain bounded queue (the hot read path is a local
dequeue, no syscall); remote producers push frames over a persistent TCP
connection to the owner process's ChannelService. The consumer blocks in
get() at pipeline cadence and never pays a round trip; the producer's
put() pays the hop, and its blocking-put backpressure travels as a delayed
reply, so a full downstream queue stalls exactly the producer lane that
feeds it.

A `DistChannel` pickles as (owner_addr, chan_id, maxsize) and
reconstructs anywhere: in the owner process it resolves to the local
registry queue; elsewhere to a pooled writer connection. Values that are
tensors on the card cross an in-process channel by reference; over TCP
they are pickled like any other value.

One difference from the reference: the service ends with the runtime.
`shutdown_service()` (called by `api.shutdown()` and `serve.shutdown()`)
stops the TCP thread, severs its connections, closes the pooled writers
and runs the hooks registered with `on_shutdown` (serve/disagg.py's KV
senders). A channel homed here before a restart stays local after it: the
registry is the process's own, whatever port the next service binds.
"""

from __future__ import annotations

import pickle
import queue
import socket
import socketserver
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from . import object_ledger
from .logging import get_logger
from .metrics import MICRO_BUCKETS, Counter, Histogram
from .wire import MSG_REQUEST, MSG_RESPONSE, WireError, recv_msg, send_msg

logger = get_logger("channels")

KV_CHANNEL_PREFIX = "channel_service/"  # node_id hex -> service address

_PUT_TIMEOUT_S = 300.0

# Backpressure observability: bytes pushed per path, how long consumers
# sit in get(), and how often a put found the queue already at capacity —
# the "backpressure engaged" signal.
_send_bytes = Counter(
    "channel_send_bytes",
    "Bytes pushed into DistChannels (path=local: same-process enqueue, "
    "estimated size; path=remote: pickled frame bytes on the wire).",
)
_recv_wait = Histogram(
    "channel_recv_wait_seconds",
    "Time a consumer spent blocked in DistChannel.get().",
    buckets=MICRO_BUCKETS,
)
_capacity_reached = Counter(
    "channel_capacity_reached_total",
    "Puts that found the channel at capacity (local/service: queue full at "
    "arrival; remote: put refused after the owner-side timeout).",
)


def _approx_nbytes(value: Any) -> int:
    """Cheap size estimate for the local put fast path, which never
    serializes: sum nbytes of array/bytes leaves in (nested) tuples,
    lists, and dicts; other leaves count 0 rather than paying a pickle."""
    n = getattr(value, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    if isinstance(value, dict):
        return sum(_approx_nbytes(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return sum(_approx_nbytes(v) for v in value)
    return 0


def channel_stats() -> Dict[str, float]:
    """This process's channel-metric totals (summed over tag sets)."""
    with _registry._lock:
        depth = sum(q.qsize() for q in _registry._chans.values())
        channels = len(_registry._chans)
    return {
        "send_bytes": sum(v for _, _, v in _send_bytes.samples()),
        "recv_count": sum(
            v for name, _, v in _recv_wait.samples() if name.endswith("_count")
        ),
        "recv_wait_seconds": sum(
            v for name, _, v in _recv_wait.samples() if name.endswith("_sum")
        ),
        "capacity_reached": sum(v for _, _, v in _capacity_reached.samples()),
        "channels": float(channels),
        "depth": float(depth),
    }


class _Registry:
    """Per-process channel table: chan_id -> bounded queue. Channels
    materialize lazily on first touch (producer frame or consumer get),
    so creation order between the two sides never matters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._chans: Dict[str, queue.Queue] = {}

    def get_or_create(self, chan_id: str, maxsize: int) -> queue.Queue:
        with self._lock:
            q = self._chans.get(chan_id)
            if q is None:
                q = self._chans[chan_id] = queue.Queue(maxsize)
            return q

    def drop(self, chan_id: str) -> None:
        with self._lock:
            self._chans.pop(chan_id, None)


class _ServiceHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: "ChannelService" = self.server  # type: ignore[assignment]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        server._track(sock)
        try:
            while True:
                msg_type, req = recv_msg(sock)
                if msg_type != MSG_REQUEST:
                    raise WireError(f"unexpected message type {msg_type}")
                op = req.get("op")
                if op in ("put", "put_many"):
                    q = server.registry.get_or_create(
                        req["chan"], req.get("maxsize", 8))
                    if q.full():
                        _capacity_reached.inc(tags={"path": "service"})
                    items = pickle.loads(req["blob"])
                    # put_many: one wire frame, N enqueues, so the consumer
                    # still sees individual items; each blocking put's
                    # delayed ok IS the backpressure signal to the producer
                    try:
                        for item in (items if op == "put_many" else [items]):
                            q.put(item,
                                  timeout=req.get("timeout", _PUT_TIMEOUT_S))
                        resp = {"ok": True}
                    except queue.Full:
                        resp = {"ok": False, "error": "channel full"}
                elif op == "ping":
                    resp = {"ok": True}
                else:
                    resp = {"ok": False, "error": f"unknown op {op!r}"}
                send_msg(sock, MSG_RESPONSE, resp)
        except (WireError, OSError):
            pass  # producer disconnected
        finally:
            server._untrack(sock)


class ChannelService(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, registry: _Registry, host: str = "127.0.0.1",
                 port: int = 0):
        super().__init__((host, port), _ServiceHandler)
        self.registry = registry
        # established producer connections, severed on stop() so a stopped
        # service looks DEAD to pooled writers
        self._conn_lock = threading.Lock()
        self._conns: set = set()
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="channel-service"
        )
        self._thread.start()

    def _track(self, sock) -> None:
        with self._conn_lock:
            self._conns.add(sock)

    def _untrack(self, sock) -> None:
        with self._conn_lock:
            self._conns.discard(sock)

    @property
    def address(self) -> str:
        host, port = self.server_address
        return f"{host}:{port}"

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        self._thread.join(timeout=5.0)
        # closing the listener leaves established handler conns alive:
        # sever them too, or a producer's pooled writer keeps a half-open
        # socket whose next put blocks instead of failing fast
        with self._conn_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


# --------------------------------------------------------------------------
# process-global service + writer pool
# --------------------------------------------------------------------------

_state_lock = threading.Lock()
_registry = _Registry()
_service: Optional[ChannelService] = None
_served: Set[str] = set()  # every address this process's service has had
_writers: Dict[Tuple[str, str], "_Writer"] = {}  # (addr, chan_id) -> writer
_shutdown_hooks: List[Callable[[], None]] = []


def ensure_service(host: str = "127.0.0.1") -> str:
    """Start (once) and return this process's channel-service address."""
    global _service
    with _state_lock:
        if _service is None:
            _service = ChannelService(_registry, host=host)
            _served.add(_service.address)
            logger.info("channel service on %s", _service.address)
        return _service.address


def service_address() -> Optional[str]:
    with _state_lock:
        return _service.address if _service is not None else None


def on_shutdown(hook: Callable[[], None]) -> None:
    """Run `hook` at every shutdown_service() (once registered, kept)."""
    with _state_lock:
        if hook not in _shutdown_hooks:
            _shutdown_hooks.append(hook)


def shutdown_service() -> None:
    """Stop this process's service thread, sever its connections, close
    every pooled writer and run the shutdown hooks. The registry's queues
    stay: a consumer still holding its channel reads what was put."""
    global _service
    with _state_lock:
        svc, _service = _service, None
        writers = list(_writers.values())
        _writers.clear()
        hooks = list(_shutdown_hooks)
    for hook in hooks:
        try:
            hook()
        except Exception:  # noqa: BLE001 — shutdown runs every hook
            logger.exception("channel shutdown hook failed")
    for w in writers:
        w.close()
    if svc is not None:
        svc.stop()


class _Writer:
    """One persistent producer connection PER CHANNEL: a wedged lane
    (downstream full, server blocking in put) stalls only its own
    connection — never another edge's puts to the same host."""

    def __init__(self, addr: str):
        self.addr = addr
        self._sock = self._dial()
        self._lock = threading.Lock()

    def _dial(self) -> socket.socket:
        host, _, port = self.addr.rpartition(":")
        sock = socket.create_connection((host, int(port)), timeout=10.0)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _send(self, op: str, chan_id: str, blob: bytes, maxsize: int,
              timeout: float) -> None:
        """Transport-vs-app split: a dead pooled socket (owner restarted,
        transient drop) reconnects ONCE in place and replays the frame; a
        second transport failure propagates. An application-level refusal
        ("channel full") is the backpressure signal: it never retries and
        raises queue.Full."""
        _send_bytes.inc(len(blob), tags={"path": "remote"})
        object_ledger.record_flow(object_ledger.local_node(),
                                  object_ledger.peer_node(self.addr),
                                  "channel", len(blob), transfers=1)
        frame = {"op": op, "chan": chan_id, "blob": blob,
                 "maxsize": maxsize, "timeout": timeout}
        # The lock IS the request/reply framing: replies carry no ids and
        # match by position on this one socket, so send+recv must be one
        # critical section. Contention = serialized puts, by design.
        with self._lock:
            try:
                send_msg(self._sock, MSG_REQUEST, frame)
                _msg_type, resp = recv_msg(self._sock)
            except (WireError, OSError):
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = self._dial()  # raises if the owner is gone
                send_msg(self._sock, MSG_REQUEST, frame)
                _msg_type, resp = recv_msg(self._sock)
        if not resp.get("ok"):
            _capacity_reached.inc(tags={"path": "remote"})
            raise queue.Full(resp.get("error", "remote channel put failed"))

    def put(self, chan_id: str, value: Any, maxsize: int,
            timeout: float) -> None:
        self._send("put", chan_id, _dumps(value), maxsize, timeout)

    def put_many(self, chan_id: str, values: list, maxsize: int,
                 timeout: float) -> None:
        """Coalesced put: N values in ONE wire frame (and one ledger flow
        record), unrolled into N queue items owner-side."""
        self._send("put_many", chan_id, _dumps(list(values)), maxsize,
                   timeout)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _writer_for(addr: str, chan_id: str, fresh: bool = False) -> _Writer:
    """Connect OUTSIDE the global lock (a slow/unreachable owner must not
    freeze unrelated channels); fresh=True evicts a dead cached writer."""
    key = (addr, chan_id)
    with _state_lock:
        w = _writers.get(key)
        if w is not None and not fresh:
            return w
        if w is not None:
            _writers.pop(key, None)
    neww = _Writer(addr)
    with _state_lock:
        race = _writers.get(key)
        if race is not None and not fresh:
            neww.close()
            return race
        if w is not None:
            w.close()
        _writers[key] = neww
    return neww


def _dumps(obj: Any) -> bytes:
    try:
        return pickle.dumps(obj, protocol=5)
    except Exception:
        import cloudpickle

        return cloudpickle.dumps(obj, protocol=5)


# --------------------------------------------------------------------------
# the channel handle
# --------------------------------------------------------------------------


class DistChannel:
    """Bounded SPSC channel homed at `owner_addr`'s process. get() only in
    the owner process (local dequeue); put() from anywhere."""

    def __init__(self, owner_addr: str, chan_id: Optional[str] = None,
                 maxsize: int = 8):
        self.owner_addr = owner_addr
        self.chan_id = chan_id or uuid.uuid4().hex
        self.maxsize = maxsize

    def _local(self) -> Optional[queue.Queue]:
        with _state_lock:
            local = self.owner_addr in _served
        if local:
            return _registry.get_or_create(self.chan_id, self.maxsize)
        return None

    def put(self, value: Any, timeout: Optional[float] = None) -> None:
        from ..util import tracing

        t = _PUT_TIMEOUT_S if timeout is None else timeout
        with tracing.span_if_traced(
                "channel_send", {"channel": self.chan_id[:8]}):
            q = self._local()
            if q is not None:
                if q.full():
                    _capacity_reached.inc(tags={"path": "local"})
                q.put(value, timeout=t)
                _send_bytes.inc(_approx_nbytes(value), tags={"path": "local"})
                return
            # _Writer.put self-heals a stale socket (one reconnect +
            # replay), so no fresh-writer fallback is needed here
            _writer_for(self.owner_addr, self.chan_id).put(
                self.chan_id, value, self.maxsize, t)

    def put_many(self, values: list, timeout: Optional[float] = None) -> None:
        """Batched put: locally a plain loop of enqueues; remotely ONE
        wire frame unrolled owner-side — the coalescing primitive the
        streamed KV sender batches small frames with."""
        from ..util import tracing

        if not values:
            return
        t = _PUT_TIMEOUT_S if timeout is None else timeout
        with tracing.span_if_traced(
                "channel_send", {"channel": self.chan_id[:8],
                                 "batch": len(values)}):
            q = self._local()
            if q is not None:
                for value in values:
                    if q.full():
                        _capacity_reached.inc(tags={"path": "local"})
                    q.put(value, timeout=t)
                    _send_bytes.inc(_approx_nbytes(value),
                                    tags={"path": "local"})
                return
            _writer_for(self.owner_addr, self.chan_id).put_many(
                self.chan_id, list(values), self.maxsize, t)

    def get(self, timeout: Optional[float] = None) -> Any:
        from ..util import tracing

        q = self._local()
        if q is None:
            raise RuntimeError(
                "DistChannel.get() outside the owner process (SPSC: the "
                f"consumer owns {self.chan_id[:8]} at {self.owner_addr})"
            )
        with tracing.span_if_traced(
                "channel_recv", {"channel": self.chan_id[:8]}):
            t0 = time.perf_counter()
            try:
                return q.get(timeout=timeout)
            finally:
                # waits are recorded even when the get times out — an
                # Empty after a full timeout IS the stall being measured
                _recv_wait.observe(time.perf_counter() - t0)

    def close(self) -> None:
        """Owner side: drop the registry queue (one-shot result channels
        call this after their single read, or executions would leak one
        queue each)."""
        if self._local() is not None:
            _registry.drop(self.chan_id)
        with _state_lock:
            w = _writers.pop((self.owner_addr, self.chan_id), None)
        if w is not None:
            w.close()

    def __reduce__(self):
        return (DistChannel, (self.owner_addr, self.chan_id, self.maxsize))
