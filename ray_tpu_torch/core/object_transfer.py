"""Object transfer plane: chunked pull of sealed objects between runtimes.

Reference analogue: `src/ray/object_manager/` — `PullManager`/`PushManager`
move plasma objects between nodes as ~1MB chunks over a dedicated gRPC
service (`object_manager.proto :: ObjectManagerService`). Same shape here:
each runtime can serve its object store on a TCP port; a remote runtime
locates the holder (control-plane KV carries `object_transfer/{node}` →
address) and pulls the object as fixed-size chunks, reassembling and
sealing it into its own store. Pull-based (the receiver drives), like the
reference — admission control stays with the consumer.

Device tensors never cross this plane: this is the HOST object plane (CPU
tensors, rollouts, checkpoint shards, pickled results) between
loosely-coupled runtimes.

The port's copy of ray_tpu/core/object_transfer.py, with the native fast
path (_shm/transfer.cc through shm_store.py: a staged blob streams
arena-to-arena) and the same-host shm handoff (the puller maps the
holder's staging arena). Objects past three quarters of STAGING_BYTES, and
every pull where the native plane is not up yet, take the chunked path
over the socket (striped across holders, or down a relay tree).
"""

from __future__ import annotations

import hashlib
import io
import itertools
import os
import pickle
import socket
import socketserver
import struct
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from . import object_ledger
from .config import config
from .ids import ObjectID
from .logging import get_logger
from .metrics import MICRO_BUCKETS, Counter, Gauge, Histogram
from .object_store import SealedBytes
from .wire import (MSG_BLOB, MSG_REQUEST, MSG_RESPONSE, WireError,
                   recv_frame_into, recv_msg, send_blob, send_msg)

logger = get_logger("object_transfer")

DEFAULT_CHUNK_BYTES = 1 << 20  # ~1MB, the reference's chunk size

KV_PREFIX = "object_transfer/"  # control-plane KV key prefix for addresses
# holder-side outstanding-pull load, gossiped so pullers can rank holders
LOAD_PREFIX = "object_transfer_load/"
# per-node host identity token (hostname + boot id), advertised so pullers
# can recognize a same-host holder and rank it first / attach its arena
HOST_PREFIX = "object_transfer_host/"
# relay-tree slot claims: object_transfer_relay/{oid_hex}/{slot:06d} ->
# "address|flow_label|node_hex". Claimed atomically (kv_put overwrite=False)
# by pullers joining a broadcast; slot k's parent is slot (k-fanout)//fanout
RELAY_PREFIX = "object_transfer_relay/"

# Native fast path (_shm/transfer.cc): the holder stages the serialized
# blob in a shm arena once, a C++ thread streams it zero-copy, and the
# puller lands it straight in its own arena — Python never allocates or
# copies on the data path. Sized by this env knob; objects larger than
# the staging arena ride the chunked Python path below.
STAGING_BYTES = int(os.environ.get("RAY_TPU_TRANSFER_STAGING_BYTES",
                                   str(256 << 20)))


_staging_seq = itertools.count()  # unique arena names (id() can be reused)


def _staging_name(tag: str) -> str:
    return f"/rtt_{tag}_{os.getpid()}_{next(_staging_seq)}"


def _stage_id(oid: bytes, raw: bool) -> bytes:
    """Staging-arena id for (object, raw-flag): sha1 maps the 28-byte
    ObjectID onto the store's 20-byte ids, deterministically on both ends
    of the pull. raw=True serves the SEALED payload — a different blob
    for the same object — so it hashes to a distinct staging id."""
    return hashlib.sha1(oid + (b"r" if raw else b"")).digest()

_pulled_chunks = Counter(
    "object_transfer_chunks_pulled", "Chunks pulled from remote runtimes."
)
_pulled_bytes = Counter(
    "object_transfer_bytes_pulled", "Bytes pulled from remote runtimes."
)
_pull_seconds = Histogram(
    "object_pull_seconds",
    "Wall seconds per completed remote pull, tagged by data path.",
    buckets=MICRO_BUCKETS,
)
_pull_bytes = Counter(
    "object_pull_bytes", "Bytes that crossed the network on remote pulls."
)
_pull_inflight = Gauge(
    "object_pull_inflight", "Remote pulls currently in flight on this side."
)
# pull-through cache outcomes (incremented by the get paths in
# core_worker/worker_api; defined here because the cache IS the object
# plane's replica mechanism)
_cache_hits = Counter(
    "object_cache_hits",
    "Gets served from the local store for objects a prior get pulled "
    "through from a remote holder.",
)
_cache_misses = Counter(
    "object_cache_misses",
    "Gets that had to pull the object from a remote holder.",
)


class ObjectPullError(RuntimeError):
    pass


class ObjectPullConnectionError(ObjectPullError):
    """Transport-class pull failure (connection lost / garbled response):
    the CONNECTION is suspect, not the holder's answer. Retrying the same
    holder on a fresh socket makes sense; an application-level refusal
    (plain ObjectPullError — e.g. the object is not there) does not."""


_NATIVE_MISS = object()  # sentinel: native path unavailable, use chunks
_SHM_MISS = object()  # sentinel: same-host arena handoff unavailable
_RELAY_MISS = object()  # sentinel: relay tree not joined, flat pull


def _make_client_native():
    from .shm_store import NativeTransferClient, ShmObjectStore

    staging = ShmObjectStore(
        _staging_name("xc"), capacity=STAGING_BYTES, max_objects=1024,
    )
    try:
        native = NativeTransferClient()
    except Exception:
        staging.close()
        raise
    return staging, native, lambda n: n.close()


def _raw_alloc(n: int):
    """Uninitialized receive buffer. bytearray(n) zero-fills — a full
    extra memory pass that roughly doubles the cost of landing a large
    blob; np.empty is a bare malloc. Every byte is overwritten by
    recv_into before anything reads it."""
    try:
        import numpy as np

        return np.empty(n, dtype=np.uint8)
    except Exception:  # noqa: BLE001 — numpy-less install
        return bytearray(n)


class _BufferPool:
    """Recycles large transfer receive buffers across pulls.

    glibc mmaps every allocation above its threshold cap (32MB), so a
    fresh multi-MB buffer pays a full page-fault pass per pull and is
    munmapped on free — the kernel-side cost dominates large transfers.
    The pool keeps recent buffers mapped and hands one back only when
    nothing outside the pool references it (sys.getrefcount: zero-copy
    decode hands out memoryviews that hold refs, so an in-use buffer can
    never be recycled under its consumers). Total retained bytes are
    bounded by object_transfer_buffer_pool_bytes, evicting idle-largest
    first; 0 disables pooling entirely."""

    def __init__(self):
        self._lock = threading.Lock()
        self._bufs: List[Any] = []  # LRU order: oldest first

    def take(self, n: int):
        import sys

        cap = int(config.object_transfer_buffer_pool_bytes)
        if cap <= 0 or n > cap:
            return _raw_alloc(n)
        with self._lock:
            for i in range(len(self._bufs)):
                a = self._bufs[i]
                # 3 == the pool's list slot + loop local + getrefcount arg
                if len(a) == n and sys.getrefcount(a) == 3:
                    del self._bufs[i]
                    self._bufs.append(a)  # most-recently-used
                    return a
            buf = _raw_alloc(n)
            self._bufs.append(buf)
            total = sum(len(a) for a in self._bufs)
            while total > cap and len(self._bufs) > 1:
                # drop the oldest pool ref: an idle buffer unmaps now, an
                # in-use one when its consumers drop — either way it stops
                # counting against the retained bound
                total -= len(self._bufs.pop(0))
            return buf


_buffer_pool = _BufferPool()


def _alloc_buf(n: int):
    return _buffer_pool.take(n)


_host_token_cache: Optional[str] = None


def _host_token() -> str:
    """Stable identity of THIS host across processes: hostname + boot id.
    Two runtimes with equal tokens share /dev/shm, so a pull between them
    can attach the holder's staging arena instead of copying over a
    socket. The boot id guards against recycled hostnames in containers
    that still don't share a shm namespace-worth of trust — equal boot
    ids on one kernel are the practical same-machine signal."""
    global _host_token_cache
    if _host_token_cache is None:
        boot = ""
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                boot = f.read().strip()
        except OSError:
            pass
        _host_token_cache = f"{socket.gethostname()}|{boot}"
    return _host_token_cache


# v2 wire blob: out-of-band buffers ride as raw trailing bytes so the
# receiving side can reconstruct the value ZERO-COPY over its receive
# buffer (pickle protocol 5 `buffers=`), instead of paying a full-blob
# pickle.loads memcpy per puller. The magic cannot collide with a plain
# pickle (protocol>=2 starts b"\x80"); unmagiced blobs decode as v1.
_BLOB_MAGIC = b"\x93RTB"
_U32 = struct.Struct(">I")


def _to_host(t):
    """A CPU copy of a tensor off the CPU, outside autograd."""
    return t.detach().to("cpu")


def _host_reduce(obj: Any) -> Any:
    """The reduction of a torch tensor that lives off the CPU: a CPU copy
    of it (a Parameter stays a Parameter, requires_grad is kept), so the
    process that unpickles it receives a CPU tensor and never starts CUDA
    because of a payload, as the reference's jax arrays cross as host
    bytes. None for anything else."""
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(obj, torch.Tensor) or obj.device.type == "cpu":
        return None
    out = _to_host(obj)
    if isinstance(obj, torch.nn.Parameter):
        out = torch.nn.Parameter(out, requires_grad=obj.requires_grad)
    elif obj.requires_grad:
        out.requires_grad_(True)
    return out.__reduce_ex__(5)


class _HostPickler(pickle.Pickler):
    def reducer_override(self, obj):
        reduced = _host_reduce(obj)
        return NotImplemented if reduced is None else reduced


class _CloudHostPickler(cloudpickle.CloudPickler):
    def reducer_override(self, obj):
        reduced = _host_reduce(obj)
        return super().reducer_override(obj) if reduced is None else reduced


def host_dumps(value: Any, buffer_callback=None, cloud: bool = False) -> bytes:
    """Pickle (protocol 5) a value that leaves this process for another
    host or process: tensors off the CPU go as CPU copies (_host_reduce).
    cloud=True pickles with cloudpickle (closures, classes defined in
    __main__), under the same rule."""
    buf = io.BytesIO()
    pickler = _CloudHostPickler if cloud else _HostPickler
    pickler(buf, protocol=5, buffer_callback=buffer_callback).dump(value)
    return buf.getvalue()


def _encode_blob(value: Any) -> bytes:
    """[magic][u32 meta_len][meta][head][raw buffers...]; meta = pickled
    (head_len, [buffer lengths]). Falls back to an unmagiced flat pickle
    whenever out-of-band extraction can't work (exotic buffers,
    cloudpickle-only values). A tensor off the CPU (a device tree the
    store holds by reference) goes as a CPU copy (host_dumps)."""
    bufs: List[pickle.PickleBuffer] = []
    try:
        head = host_dumps(value, buffer_callback=bufs.append)
        raws = [b.raw() for b in bufs]
    except Exception:  # noqa: BLE001 — non-contiguous buffer / closure
        return host_dumps(value, cloud=True)
    meta = pickle.dumps((len(head), [len(r) for r in raws]), protocol=2)
    return b"".join([_BLOB_MAGIC, _U32.pack(len(meta)), meta, head, *raws])


def _decode_blob(blob, zero_copy: bool = True) -> Any:
    """Inverse of _encode_blob. zero_copy=True reconstructs buffer-backed
    leaves as read-only views over `blob` (the views keep it alive) — use
    when the caller owns the bytes. zero_copy=False materializes copies —
    required when `blob` is a borrowed mapping (shm arena view) that may
    be released/unmapped after decode."""
    mv = memoryview(blob)
    if mv.nbytes < 8 or bytes(mv[:4]) != _BLOB_MAGIC:
        return pickle.loads(mv)  # v1 flat pickle
    (meta_len,) = _U32.unpack(mv[4:8])
    off = 8 + meta_len
    head_len, buf_lens = pickle.loads(mv[8:off])
    head = mv[off:off + head_len]
    off += head_len
    buffers = []
    for n in buf_lens:
        b = mv[off:off + n]
        off += n
        buffers.append(b.toreadonly() if zero_copy else bytes(b))
    return pickle.loads(head, buffers=buffers)


class _TransferHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: "ObjectTransferServer" = self.server  # type: ignore[assignment]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                msg_type, req = recv_msg(sock)
                if msg_type != MSG_REQUEST:
                    raise WireError(f"unexpected message type {msg_type}")
                if req.get("method") == "chunk_stream":
                    # zero-copy lane: ONE request streams a whole byte
                    # range as MSG_BLOB frames (header + memoryview
                    # scatter-gather per chunk, no per-chunk pickling on
                    # either side), then a RESPONSE closes the stream.
                    # An app-level error mid-stream also arrives as a
                    # RESPONSE — the connection stays in sync either way
                    server._load_add(1)
                    try:
                        resp = self._stream_chunks(server, sock, req)
                    finally:
                        server._load_add(-1)
                    send_msg(sock, MSG_RESPONSE, resp)
                    continue
                server._load_add(1)
                try:
                    resp = self._dispatch(server, req)
                except Exception as e:  # noqa: BLE001 — serialized to caller
                    resp = {"id": req.get("id"), "ok": False, "error": repr(e)}
                finally:
                    server._load_add(-1)
                send_msg(sock, MSG_RESPONSE, resp)
        except (WireError, OSError):
            pass  # puller disconnected

    def _stream_chunks(self, server: "ObjectTransferServer",
                       sock: socket.socket, req: dict) -> dict:
        """Push blob frames for [start, end) in `step`-sized chunks. On a
        relay node each _read_range parks until its range commits, so the
        stream is naturally paced by the upstream pull (chunk-pipelined
        dissemination). Returns the closing response; transport errors
        propagate and kill the connection (the puller sees them as a
        connection failure and retries elsewhere)."""
        try:
            oid_hex, start, end, step, *rest = req["args"]
            raw = bool(rest and rest[0])
            off = int(start)
            end = int(end)
            step = max(1, int(step))
            while off < end:
                n = min(step, end - off)
                view = server._read_range(oid_hex, raw, off, n)
                send_blob(sock, req["id"], off, view)
                off += n
        except (WireError, OSError):
            raise
        except Exception as e:  # noqa: BLE001 — serialized to caller
            return {"id": req.get("id"), "ok": False, "error": repr(e)}
        return {"id": req["id"], "ok": True, "value": None}

    def _dispatch(self, server: "ObjectTransferServer", req: dict) -> dict:
        method = req.get("method")
        # args may carry a trailing raw flag: raw=True ships the SEALED
        # payload (SealedBytes pickled as-is) so sealing survives the hop
        # (store.get_raw parity for cross-runtime pulls)
        if method == "meta":
            oid_hex, *rest = req["args"]
            raw = bool(rest and rest[0])
            partial = server._partial_for(oid_hex, raw)
            size = partial.total if partial is not None else \
                len(server._blob_for(oid_hex, raw=raw))
            return {"id": req["id"], "ok": True, "value": size}
        if method == "stage":
            oid_hex, raw = req["args"]
            size, native_port, shm = server._stage(oid_hex, bool(raw))
            return {"id": req["id"], "ok": True,
                    "value": {"size": size, "native_port": native_port,
                              "shm": shm}}
        if method == "chunk":
            oid_hex, offset, length, *rest = req["args"]
            view = server._read_range(oid_hex, bool(rest and rest[0]),
                                      int(offset), int(length))
            return {"id": req["id"], "ok": True, "value": bytes(view)}
        if method == "contains":
            (oid_hex,) = req["args"]
            oid = ObjectID.from_hex(oid_hex)
            return {"id": req["id"], "ok": True,
                    "value": bool(server._store.contains(oid))}
        if method == "load":
            # holders serve their own outstanding-pull count so pullers
            # can rank them directly (the KV gossip is the cached form)
            return {"id": req["id"], "ok": True, "value": server.outstanding}
        raise WireError(f"unknown method {method!r}")


class _NativePlane:
    """Owns one side's native-path pair (staging arena + C++ endpoint)
    with the init/commit/teardown choreography the server and client
    share. `make()` runs on a background thread (a cold environment may
    have to COMPILE the shm library — no request or pull ever waits on
    that); `acquire()/release()` hold a use count so `teardown()` never
    munmaps the arena under an in-flight, GIL-released native call."""

    def __init__(self, name: str, make):
        self._name = name
        self._make = make  # () -> (staging, native, stop_native)
        self.staging = None
        self.native = None
        self._stop_native = None
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._started = False
        self._users = 0

    def start_async(self) -> None:
        with self._lock:
            if self._started or self._closed:
                return
            self._started = True
        threading.Thread(target=self._init, daemon=True,
                         name=self._name).start()

    def _init(self) -> None:
        try:
            staging, native, stop_native = self._make()
        except Exception:  # noqa: BLE001 — the chunked path remains
            logger.warning("%s unavailable", self._name, exc_info=True)
            return
        with self._lock:
            if not self._closed:
                self.staging = staging
                self.native = native
                self._stop_native = stop_native
                return
        stop_native(native)  # teardown() won the race
        staging.close()

    def acquire(self):
        """-> (native, staging) with a use hold, or (None, None). A
        non-None acquire MUST be paired with release()."""
        with self._lock:
            if self._closed or self.native is None:
                return None, None
            self._users += 1
            return self.native, self.staging

    def release(self) -> None:
        with self._lock:
            self._users -= 1
            if self._users == 0:
                self._cond.notify_all()

    def teardown(self, wait_s: float = 5.0) -> None:
        with self._lock:
            self._closed = True
            native, staging = self.native, self.staging
            stop_native = self._stop_native
            self.native = self.staging = self._stop_native = None
            deadline = time.monotonic() + wait_s
            while self._users > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    # leaking the MAPPING beats munmapping it under a live
                    # native call (use-after-unmap in the C recv/send) —
                    # but the /dev/shm NAME must still go, or the segment
                    # outlives the process and fills /dev/shm on restarts
                    logger.warning("%s busy at teardown; leaking arena "
                                   "mapping (name unlinked)", self._name)
                    if staging is not None:
                        staging.unlink_name()
                    native = staging = None
                    break
                self._cond.wait(left)
        if native is not None:
            stop_native(native)
        if staging is not None:
            staging.close()


class _Partial:
    """A blob mid-arrival on a relay node: the receive buffer doubles as
    the serving source. The puller commits each landed chunk (a strictly
    growing byte prefix); downstream chunk requests for a not-yet-landed
    range park on `cond` until the range commits, the upstream pull fails,
    or the relay timeout expires."""

    __slots__ = ("buf", "total", "committed", "cond", "failed", "done")

    def __init__(self, total: int):
        self.buf = _alloc_buf(total)
        self.total = total
        self.committed = 0
        self.cond = threading.Condition()
        self.failed: Optional[str] = None
        self.done = False

    def commit(self, upto: int) -> None:
        with self.cond:
            if upto > self.committed:
                self.committed = upto
                self.cond.notify_all()


class ObjectTransferServer(socketserver.ThreadingTCPServer):
    """Serves one runtime's object store for remote pulls.

    The serialized blob for an object is cached per object id while any
    pull is in flight (pulls are chunked across many requests), and
    dropped once the store drops the object. A relay pull additionally
    registers a _Partial here, so the node serves committed byte ranges
    to downstream pullers while its own pull is still in flight."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, store, host: str = "127.0.0.1", port: int = 0):
        super().__init__((host, port), _TransferHandler)
        self._store = store
        self._blob_cache: Dict[Tuple[str, bool], bytes] = {}
        self._partials: Dict[Tuple[str, bool], _Partial] = {}
        self._cache_lock = threading.Lock()
        # outstanding-pull load: requests currently being served. Gossiped
        # to the control-plane KV (start_load_gossip) so pullers rank
        # lightly-loaded holders first.
        self._load = 0
        self._load_lock = threading.Lock()
        self._gossip_stop = threading.Event()
        self._plane = _NativePlane("native-transfer-server",
                                   self._make_native)
        self._plane.start_async()
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="object-transfer"
        )
        self._thread.start()
        logger.info("object transfer plane on %s:%d", *self.server_address)

    def _load_add(self, delta: int) -> None:
        with self._load_lock:
            self._load += delta

    @property
    def outstanding(self) -> int:
        with self._load_lock:
            return self._load

    def start_load_gossip(self, control_plane, node_hex: str,
                          period_s: float = 0.25) -> None:
        """Publish this holder's outstanding-pull count to the control
        plane KV (`object_transfer_load/{node}`) on change; pull_from_any
        ranks holders by it. Best-effort: a stale or missing value only
        degrades ranking, never correctness."""

        def loop() -> None:
            last: Optional[int] = None
            while not self._gossip_stop.wait(period_s):
                load = self.outstanding
                if load == last:
                    continue
                try:
                    control_plane.kv_put(LOAD_PREFIX + node_hex, str(load))
                    last = load
                except Exception:  # noqa: BLE001 — control plane gone
                    return

        threading.Thread(target=loop, daemon=True,
                         name="transfer-load-gossip").start()

    def _make_native(self):
        from .shm_store import NativeTransferServer, ShmObjectStore

        staging = ShmObjectStore(
            _staging_name("xs"), capacity=STAGING_BYTES, max_objects=1024,
        )
        try:
            native = NativeTransferServer(staging,
                                          host=self.server_address[0])
        except Exception:
            staging.close()
            raise
        logger.info("native transfer plane on port %d", native.port)
        return staging, native, lambda n: n.stop()

    def _stage(self, oid_hex: str, raw: bool) \
            -> Tuple[int, Optional[int], Optional[dict]]:
        """Ensure the blob for (oid, raw) sits in the staging arena; ->
        (size, native_port, shm). native_port None = use the chunked
        path. `shm` carries the arena name + host token once the blob is
        staged, so a same-host puller can map it directly (zero-copy
        handoff) instead of copying over any socket."""
        partial = self._partial_for(oid_hex, raw)
        if partial is not None and not partial.done:
            # mid-relay: serve the committed prefix over the chunk lane
            return partial.total, None, None
        try:
            sid = _stage_id(ObjectID.from_hex(oid_hex).binary(), raw)
        except (ValueError, TypeError):
            sid = None  # non-ObjectID key: chunked path only
        native, staging = self._plane.acquire() if sid is not None \
            else (None, None)
        if native is None:
            return len(self._blob_for(oid_hex, raw=raw)), None, None
        shm_info = {"arena": staging.name, "token": _host_token()}
        try:
            view = staging.get_view(sid)
            if view is not None:  # already staged: size from the arena,
                try:              # no re-pickle of the value
                    return len(view), native.port, shm_info
                finally:
                    staging.release(sid)
            blob = self._blob_for(oid_hex, raw=raw)
            if len(blob) > (STAGING_BYTES * 3) // 4:
                return len(blob), None, None
            try:
                staging.put(sid, blob)
            except Exception:  # noqa: BLE001 — races/arena pressure
                if not staging.contains(sid):
                    return len(blob), None, None  # cannot stage: chunked
            # the arena copy now serves all pulls; dropping the byte-cache
            # entry halves holder-side residency for large objects
            with self._cache_lock:
                self._blob_cache.pop((oid_hex, raw), None)
            return len(blob), native.port, shm_info
        finally:
            self._plane.release()

    # -- relay partials -----------------------------------------------------

    def _partial_for(self, oid_hex: str, raw: bool) -> Optional[_Partial]:
        with self._cache_lock:
            return self._partials.get((oid_hex, raw))

    def begin_partial(self, oid_hex: str, raw: bool,
                      total: int) -> Optional[_Partial]:
        """Register a partial for an inbound relay pull. The returned
        _Partial's buf IS the receive buffer: commit() after each landed
        chunk publishes the prefix to downstream pullers. Returns None if
        a partial already exists — exactly one pull per node feeds it."""
        with self._cache_lock:
            if (oid_hex, raw) in self._partials:
                return None
            p = _Partial(total)
            self._partials[(oid_hex, raw)] = p
            return p

    def finish_partial(self, oid_hex: str, raw: bool) -> None:
        """Promote a completed partial into the blob cache. The filled
        bytearray moves as-is — late chunk requests see byte-identical
        data whether they hit the partial or the cache."""
        with self._cache_lock:
            p = self._partials.pop((oid_hex, raw), None)
            if p is None:
                return
            if len(self._blob_cache) >= 64:
                self._blob_cache.pop(next(iter(self._blob_cache)))
            self._blob_cache[(oid_hex, raw)] = p.buf
        with p.cond:
            p.committed = p.total
            p.done = True
            p.cond.notify_all()

    def fail_partial(self, oid_hex: str, raw: bool, error: str) -> None:
        """The inbound relay pull died: wake every parked reader with an
        application-level error so downstream pullers fall back to a
        surviving holder instead of hanging."""
        with self._cache_lock:
            p = self._partials.pop((oid_hex, raw), None)
        if p is None:
            return
        with p.cond:
            p.failed = error or "relay source failed"
            p.cond.notify_all()

    def drop_cached(self, oid_hex: str) -> None:
        """Drop any cached wire blobs and partials for an object (both raw
        flavors); benches/teardown use it to bound holder residency."""
        for raw in (False, True):
            with self._cache_lock:
                self._blob_cache.pop((oid_hex, raw), None)
                p = self._partials.pop((oid_hex, raw), None)
            if p is not None:
                with p.cond:
                    p.failed = "partial dropped"
                    p.cond.notify_all()

    def _read_range(self, oid_hex: str, raw: bool, offset: int,
                    length: int) -> memoryview:
        """Byte range [offset, offset+length) of the wire blob, as a view
        (no copy). On a relay node with the blob mid-arrival, the read
        parks until the range commits; a dead upstream or an expired
        object_relay_timeout_s surfaces as an app-level error (KeyError),
        which tells the puller to fall back to another holder."""
        p = self._partial_for(oid_hex, raw)
        if p is None:
            blob = self._blob_for(oid_hex, raw=raw)
            return memoryview(blob)[offset:offset + length]
        end = min(offset + length, p.total)
        deadline = time.monotonic() + float(config.object_relay_timeout_s)
        with p.cond:
            while p.committed < end and p.failed is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise KeyError(
                        f"relay range [{offset}, {end}) of {oid_hex[:16]} "
                        f"not committed within "
                        f"{config.object_relay_timeout_s}s "
                        f"(have {p.committed}/{p.total})")
                p.cond.wait(min(left, 0.5))  # raylint: disable=R2 — parked reader wakes on commit/fail notify; the timeout re-check bounds the wait
            if p.committed >= end:
                # p.buf stays valid after finish_partial (the bytearray
                # itself is promoted into the blob cache, never copied)
                return memoryview(p.buf)[offset:end]
            raise KeyError(f"relay source for {oid_hex[:16]} failed: "
                           f"{p.failed}")

    @property
    def address(self) -> str:
        host, port = self.server_address
        return f"{host}:{port}"

    def _blob_for(self, oid_hex: str, raw: bool = False) -> bytes:
        key = (oid_hex, raw)
        with self._cache_lock:
            blob = self._blob_cache.get(key)
            if blob is not None:
                return blob
        oid = ObjectID.from_hex(oid_hex)
        if not self._store.contains(oid):
            raise KeyError(f"object {oid_hex} not in local store")
        if raw:
            value = self._store.get_raw(oid, timeout=0.0)
        else:
            value = self._store.get(oid, timeout=0.0)
        blob = _encode_blob(value)
        with self._cache_lock:
            # bound the cache: drop the oldest entries past 64
            if len(self._blob_cache) >= 64:
                self._blob_cache.pop(next(iter(self._blob_cache)))
            self._blob_cache[key] = blob
        return blob

    def stop(self) -> None:
        self._gossip_stop.set()
        with self._cache_lock:
            partials = list(self._partials.values())
            self._partials.clear()
        for p in partials:  # wake parked relay readers before the sockets go
            with p.cond:
                p.failed = "transfer server stopped"
                p.cond.notify_all()
        self.shutdown()
        self.server_close()
        self._plane.teardown()


class _PoolSlot:
    """One pooled connection. The socket stays tracked here from dial to
    close, so _ConnPool.close() can reach every fd it ever created —
    including ones checked out by in-flight pulls."""

    __slots__ = ("sock", "busy", "dead")

    def __init__(self):
        self.sock: Optional[socket.socket] = None
        self.busy = True  # born checked-out by the dialing thread
        self.dead = False


def _close_sock(sock: Optional[socket.socket]) -> None:
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class _ConnPool:
    """Bounded per-address connection pool. Concurrent pulls from one
    holder each get their own socket (up to max_conns) instead of
    serializing on a single connection lock; a checked-out socket is
    exclusively held, which is what makes client-side request pipelining
    on it safe."""

    def __init__(self, address: str, max_conns: int):
        self.address = address
        self.max_conns = max(1, int(max_conns))
        self._cv = threading.Condition()
        self._slots: List[_PoolSlot] = []
        self._closed = False

    def checkout(self, timeout: float = 30.0) -> _PoolSlot:
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if self._closed:
                    raise ObjectPullConnectionError(
                        f"transfer client closed ({self.address})")
                slot = next((s for s in self._slots
                             if not s.busy and not s.dead), None)
                if slot is not None:
                    slot.busy = True
                    return slot
                # idle dead slots free their capacity for a fresh dial
                self._slots = [s for s in self._slots if s.busy or not s.dead]
                if len(self._slots) < self.max_conns:
                    slot = _PoolSlot()
                    self._slots.append(slot)
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ObjectPullConnectionError(
                        f"no transfer connection to {self.address} "
                        f"within {timeout}s")
                self._cv.wait(min(remaining, 1.0))
        # dial OUTSIDE the lock (slow); the slot reserves our seat
        try:
            host, _, port = self.address.rpartition(":")
            sock = socket.create_connection((host, int(port)), timeout=30.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError as e:
            with self._cv:
                if slot in self._slots:
                    self._slots.remove(slot)
                self._cv.notify_all()
            raise ObjectPullConnectionError(
                f"cannot connect to {self.address}: {e}")
        with self._cv:
            if self._closed:
                if slot in self._slots:
                    self._slots.remove(slot)
                self._cv.notify_all()
                _close_sock(sock)
                raise ObjectPullConnectionError(
                    f"transfer client closed ({self.address})")
            slot.sock = sock
        return slot

    def checkin(self, slot: _PoolSlot, dead: bool = False) -> None:
        sock = None
        with self._cv:
            slot.busy = False
            if dead or self._closed or slot.dead:
                slot.dead = True
                sock, slot.sock = slot.sock, None
                if slot in self._slots:
                    self._slots.remove(slot)
            self._cv.notify_all()
        _close_sock(sock)

    def idle_count(self) -> int:
        with self._cv:
            return sum(1 for s in self._slots if not s.busy and not s.dead)

    def close(self) -> None:
        """Close EVERY tracked socket, including checked-out ones: an
        in-flight pull fails fast with a connection error instead of
        holding a leaked fd. Busy slots fully retire at their checkin."""
        with self._cv:
            self._closed = True
            socks = [s.sock for s in self._slots if s.sock is not None]
            for s in self._slots:
                s.dead = True
                if not s.busy:
                    s.sock = None
            self._slots = [s for s in self._slots if s.busy]
            self._cv.notify_all()
        for sock in socks:
            _close_sock(sock)


class ObjectTransferClient:
    """Chunked puller with a small per-address connection pool (the
    reference pools object-manager RPC channels likewise; here the pool
    additionally lets concurrent pulls from one holder overlap)."""

    def __init__(self, chunk_bytes: Optional[int] = None,
                 pool_conns: Optional[int] = None,
                 chunk_window: Optional[int] = None):
        self.chunk_bytes = int(chunk_bytes if chunk_bytes is not None
                               else config.object_transfer_chunk_bytes)
        self.pool_conns = int(pool_conns if pool_conns is not None
                              else config.object_transfer_pool_conns)
        self.chunk_window = max(1, int(
            chunk_window if chunk_window is not None
            else config.object_transfer_chunk_window))
        self._pools: Dict[str, _ConnPool] = {}
        self._global_lock = threading.Lock()
        self._next_id = 0
        self._closed = False
        self._plane = _NativePlane("native-transfer-client",
                                   _make_client_native)
        self._inflight: set = set()  # sids being pulled by THIS client
        self._inflight_lock = threading.Lock()
        # same-host staging arenas attached by name (zero-copy handoff);
        # None marks an arena that failed to attach, so we don't re-dial it
        self._arenas: Dict[str, Any] = {}
        self._arena_lock = threading.Lock()
        # flow-accounting identity of the pulling side; empty means the
        # process-wide node id (set per-client in tests/benches that run
        # several logical pullers in one process)
        self.local_node = ""

    def _flow_dst(self) -> str:
        return self.local_node or object_ledger.local_node()

    def _pool(self, address: str) -> _ConnPool:
        with self._global_lock:
            if self._closed:
                raise ObjectPullConnectionError("transfer client closed")
            pool = self._pools.get(address)
            if pool is None:
                pool = self._pools[address] = _ConnPool(
                    address, self.pool_conns)
            return pool

    def _new_id(self) -> int:
        with self._global_lock:
            self._next_id += 1
            return self._next_id

    def _request_on(self, sock: socket.socket, address: str,
                    method: str, *args) -> Any:
        """One request/response round trip on an exclusively-held socket."""
        req_id = self._new_id()
        try:
            send_msg(sock, MSG_REQUEST,
                     {"id": req_id, "method": method, "args": args})
            msg_type, resp = recv_msg(sock)
        except (WireError, OSError) as e:
            raise ObjectPullConnectionError(
                f"transfer connection to {address} lost: {e}")
        if msg_type != MSG_RESPONSE or resp.get("id") != req_id:
            raise ObjectPullConnectionError(
                f"bad transfer response from {address}")
        if not resp.get("ok"):
            raise ObjectPullError(resp.get("error", "pull failed"))
        return resp["value"]

    def _call(self, address: str, method: str, *args) -> Any:
        slot = self._pool(address).checkout()
        dead = True
        try:
            value = self._request_on(slot.sock, address, method, *args)
            dead = False
            return value
        except ObjectPullError as e:
            # app-level refusal: the connection itself is fine
            dead = isinstance(e, ObjectPullConnectionError)
            raise
        finally:
            self._pool(address).checkin(slot, dead=dead)

    def _drop(self, address: str) -> None:
        """Retire every pooled connection for an address (holder restarted
        or unreachable); the next call dials fresh."""
        with self._global_lock:
            pool = self._pools.pop(address, None)
        if pool is not None:
            pool.close()

    def pull(self, address: str, object_id, raw: bool = False,
             peers: Sequence[str] = (), src_node: str = "") -> Any:
        """Pull one object from the holder at `address`; returns the value
        (raw=True: the sealed payload, store.get_raw parity).

        Fast path: one "stage" round trip on the control connection, then
        the C++ plane streams the blob arena-to-arena (_shm/transfer.cc)
        and the value unpickles from a zero-copy view. Fallback: ~1MB
        chunks, pipelined `chunk_window` requests deep per connection;
        large fallback pulls stripe byte ranges across `peers` that also
        hold the object (pull_from_any passes the ranked remainder)."""
        oid_hex = object_id.hex() if hasattr(object_id, "hex") else str(object_id)
        src_node = src_node or object_ledger.peer_node(address)
        t0 = time.monotonic()
        with _pull_inflight.track():
            shm = None
            try:
                staged = self._call(address, "stage", oid_hex, raw)
                total, native_port = staged["size"], staged["native_port"]
                shm = staged.get("shm")
            except ObjectPullError as e:
                if "unknown method" not in str(e):
                    raise
                # holder predates the staged protocol: chunked via "meta"
                total, native_port = self._call(address, "meta", oid_hex,
                                                raw), None
            if (shm is not None and config.object_transfer_shm_handoff
                    and shm.get("token") == _host_token()):
                # same host: map the holder's staging arena and decode in
                # place — zero socket bytes, so none of the transfer
                # counters/flow edges move (the flow matrix showing no
                # self-edge traffic is the regression-tested contract)
                value = self._pull_shm(shm.get("arena"), oid_hex, raw)
                if value is not _SHM_MISS:
                    _pull_seconds.observe(time.monotonic() - t0,
                                          {"path": "shm"})
                    return value
            if native_port is not None:
                value = self._pull_native(address, native_port, oid_hex, raw,
                                          total, src_node)
                if value is not _NATIVE_MISS:
                    _pull_seconds.observe(time.monotonic() - t0,
                                          {"path": "native"})
                    return value
            blob = None
            if (peers and total >= config.object_transfer_stripe_min_bytes):
                blob = self._pull_striped(address, peers, oid_hex, raw, total,
                                          src_node)
            if blob is None:
                blob = self._pull_chunked(address, oid_hex, raw, 0, total,
                                          src_node=src_node)
            _pull_seconds.observe(time.monotonic() - t0, {"path": "chunked"})
            return _decode_blob(blob)

    def _attach_arena(self, name: str):
        """Attach (once) a same-host holder's staging arena by name."""
        from .shm_store import ShmObjectStore

        with self._arena_lock:
            if name in self._arenas:
                return self._arenas[name]
        try:
            store = ShmObjectStore(name, create=False)
        except Exception:  # noqa: BLE001 — arena gone/renamed: socket path
            store = None
        with self._arena_lock:
            return self._arenas.setdefault(name, store)

    def _pull_shm(self, arena_name: Optional[str], oid_hex: str,
                  raw: bool) -> Any:
        """Zero-socket same-host pull: read the staged blob straight out
        of the holder's shm arena. Buffers are copied out of the mapping
        during decode (the arena may evict the entry after release), but
        no byte ever crosses a socket. Returns _SHM_MISS when the arena
        or the staged entry is unavailable."""
        if not arena_name:
            return _SHM_MISS
        store = self._attach_arena(arena_name)
        if store is None:
            return _SHM_MISS
        try:
            sid = _stage_id(ObjectID.from_hex(oid_hex).binary(), raw)
        except (ValueError, TypeError):
            return _SHM_MISS
        try:
            view = store.get_view(sid)
        except Exception:  # noqa: BLE001 — holder tore the arena down
            return _SHM_MISS
        if view is None:
            return _SHM_MISS
        try:
            return _decode_blob(view, zero_copy=False)
        finally:
            try:
                store.release(sid)
            except Exception:  # noqa: BLE001 — release is best-effort
                pass

    def _pull_chunked(self, address: str, oid_hex: str, raw: bool,
                      start: int, end: int, src_node: str = "",
                      flow_path: str = "chunked", sink=None, commit=None):
        """Pull bytes [start, end) as pipelined chunk requests: a window of
        chunk_window requests stays outstanding on one exclusively-held
        connection instead of one synchronous round trip per ~1MB. The
        server handles a connection's requests strictly in order, so
        responses return in request order and match by id.

        Chunks ride the MSG_BLOB lane: ONE chunk_stream request makes the
        server push the whole range as blob frames (header + memoryview
        scatter-gather per chunk), each payload recv_into'd straight into
        the destination buffer — no per-chunk request, pickling, or
        reassembly copy on either side; TCP flow control paces the
        stream.

        `sink=(buf, base)` lands blob offset `off` at buf[off - base];
        relay partials and stripe lanes share one caller-owned buffer
        this way (default: a fresh buffer covering [start, end)).
        `commit(upto)` fires after each landed chunk with the contiguous
        high-water offset — relay holders publish it to parked readers.
        Returns the destination buffer."""
        pool = self._pool(address)
        slot = pool.checkout()
        dead = True
        if sink is None:
            buf, base = _alloc_buf(end - start), start
        else:
            buf, base = sink
        mv = memoryview(buf)
        src_node = src_node or object_ledger.peer_node(address)
        flow_dst = self._flow_dst()
        req_id = self._new_id()
        expect = start

        def sink_for(rid: int, off: int, n: int) -> memoryview:
            if rid != req_id or off != expect or \
                    n != min(self.chunk_bytes, end - off):
                raise WireError(
                    f"blob stream out of order from {address}: frame "
                    f"(id {rid}, [{off}, {off + n})) at offset {expect}")
            return mv[off - base:off - base + n]

        # flow rows batch across chunks (flushed every flow_every bytes
        # and at stream end) — one ledger insert per ~8 chunks keeps the
        # edge-byte sums exact while pricing record_flow out of the
        # per-chunk hot path
        flow_pending = 0
        flow_every = 8 * self.chunk_bytes
        try:
            sock = slot.sock
            send_msg(sock, MSG_REQUEST,
                     {"id": req_id, "method": "chunk_stream",
                      "args": (oid_hex, start, end, self.chunk_bytes, raw)})
            while True:
                msg_type, payload = recv_frame_into(sock, sink_for)
                if msg_type == MSG_RESPONSE:
                    if payload.get("id") != req_id:
                        raise ObjectPullConnectionError(
                            f"bad transfer response from {address}")
                    if not payload.get("ok"):
                        # app-level refusal: the stream closed cleanly,
                        # the connection stays usable
                        dead = False
                        raise ObjectPullError(
                            payload.get("error", "pull failed"))
                    break
                if msg_type != MSG_BLOB:
                    raise ObjectPullConnectionError(
                        f"bad transfer response from {address}")
                _, off, n = payload
                expect = off + n
                _pulled_chunks.inc()
                _pulled_bytes.inc(n)
                _pull_bytes.inc(n)
                flow_pending += n
                if flow_pending >= flow_every:
                    object_ledger.record_flow(src_node, flow_dst,
                                              flow_path, flow_pending)
                    flow_pending = 0
                if commit is not None:
                    commit(expect)
            if expect != end:
                raise ObjectPullError(
                    f"short stream at {expect}/{end} for {oid_hex}")
            dead = False
            object_ledger.record_flow(src_node, flow_dst, flow_path,
                                      flow_pending, transfers=1)
            flow_pending = 0
        except (WireError, OSError) as e:
            raise ObjectPullConnectionError(
                f"transfer connection to {address} lost: {e}")
        finally:
            if flow_pending:
                # failed mid-stream: the landed bytes were counted, so
                # the ledger must see them too (exact conservation)
                object_ledger.record_flow(src_node, flow_dst, flow_path,
                                          flow_pending)
            pool.checkin(slot, dead=dead)
        return buf

    def _pull_striped(self, address: str, peers: Sequence[str],
                      oid_hex: str, raw: bool, total: int,
                      src_node: str = "") -> Optional[bytes]:
        """Stripe a large chunked pull across holders: confirmed peers each
        serve a contiguous byte range in parallel. Returns None when no
        peer confirms (caller falls back to the single-holder path); any
        stripe failure also falls back — striping is an optimization,
        never a correctness dependency."""
        holders = [address]
        max_stripes = max(1, int(config.object_transfer_max_stripes))
        for peer in peers:
            if len(holders) >= max_stripes:
                break  # diminishing returns past a few stripes
            try:
                if self._call(peer, "contains", oid_hex):
                    holders.append(peer)
            except ObjectPullError:
                continue
        if len(holders) < 2:
            return None
        # contiguous ranges, chunk-aligned so stripes pipeline internally
        n = len(holders)
        per = ((total // n) // self.chunk_bytes + 1) * self.chunk_bytes
        ranges = []
        off = 0
        for h in holders:
            if off >= total:
                break
            ranges.append((h, off, min(off + per, total)))
            off += per
        # every stripe recv_intos its range of ONE shared buffer — the
        # lanes never overlap, so no reassembly join afterwards
        buf = _alloc_buf(total)
        done: List[bool] = [False] * len(ranges)
        errors: List[Optional[BaseException]] = [None] * len(ranges)

        def work(i: int, holder: str, lo: int, hi: int) -> None:
            try:
                # each stripe is its own edge: bytes flow from the stripe's
                # holder, not from the primary address
                src = src_node if holder == address else \
                    object_ledger.peer_node(holder)
                self._pull_chunked(holder, oid_hex, raw, lo, hi,
                                   src_node=src, flow_path="stripe",
                                   sink=(buf, 0))
                done[i] = True
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors[i] = e

        threads = [threading.Thread(
            target=work, args=(i, h, lo, hi), daemon=True,
            name=f"stripe-{i}") for i, (h, lo, hi) in enumerate(ranges)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if not all(done):
            failed = next((e for e in errors if e is not None), None)
            logger.debug("striped pull of %s fell back to one holder: %r",
                         oid_hex[:16], failed)
            return None
        return buf

    def _pull_native(self, address: str, native_port: int, oid_hex: str,
                     raw: bool, total: int, src_node: str = "") -> Any:
        """One native arena-to-arena pull; returns _NATIVE_MISS to send the
        caller down the chunked path (never raises for availability-class
        failures — the chunked path is the answer to all of them)."""
        from .shm_store import PullRejected, ShmStoreError

        self._plane.start_async()  # idempotent; first pull rides chunks
        native, staging = self._plane.acquire()
        if native is None:
            return _NATIVE_MISS
        host = address.rpartition(":")[0]
        try:
            sid = _stage_id(ObjectID.from_hex(oid_hex).binary(), raw)
        except (ValueError, TypeError):
            self._plane.release()
            return _NATIVE_MISS
        try:
            transferred = False
            if not staging.contains(sid):
                with self._inflight_lock:
                    winner = sid not in self._inflight
                    if winner:
                        self._inflight.add(sid)
                if not winner:
                    # another thread of THIS client is pulling the same
                    # object (clients never share staging arenas, so this
                    # is the only duplicate source): wait for it to finish
                    # rather than re-downloading the same bytes
                    deadline = time.monotonic() + 30.0
                    while time.monotonic() < deadline:
                        with self._inflight_lock:
                            if sid not in self._inflight:
                                break
                        time.sleep(0.01)
                    if not staging.contains(sid):
                        return _NATIVE_MISS  # winner failed; use chunks
                else:
                    try:
                        n = native.pull_into(host, native_port, sid, staging)
                        if n is None:
                            # staged blob evicted between stage and pull:
                            # restage once (the holder re-pins it), then
                            # give up to chunks. The holder may have
                            # restarted its native plane (or resealed a
                            # different-size blob) since the first stage —
                            # retry against the RESPONSE's port/size, not
                            # the stale ones
                            restaged = self._call(address, "stage", oid_hex,
                                                  raw)
                            native_port = restaged.get("native_port")
                            total = restaged.get("size", total)
                            if native_port is None:
                                return _NATIVE_MISS
                            n = native.pull_into(host, native_port, sid,
                                                 staging)
                            if n is None:
                                return _NATIVE_MISS
                        transferred = True
                    finally:
                        with self._inflight_lock:
                            self._inflight.discard(sid)
            view = staging.get_view(sid)
            if view is None:
                return _NATIVE_MISS  # evicted locally before the read
            try:
                value = _decode_blob(view, zero_copy=False)
            finally:
                # release the pin but keep the sealed blob: concurrent and
                # repeat pulls of the same (immutable) object hit it here,
                # and the arena's LRU/slot eviction bounds total residency
                staging.release(sid)
            if transferred:  # count only bytes that crossed the network
                _pulled_chunks.inc()
                _pulled_bytes.inc(total)
                _pull_bytes.inc(total)
                object_ledger.record_flow(
                    src_node or object_ledger.peer_node(address),
                    self._flow_dst(), "native", total, transfers=1)
            return value
        except PullRejected:
            return _NATIVE_MISS  # does not fit the local arena
        except ShmStoreError as e:
            logger.warning("native pull from %s:%d failed (%s); "
                           "falling back to chunks", host, native_port, e)
            return _NATIVE_MISS
        finally:
            self._plane.release()

    def close(self) -> None:
        """Close every pooled connection (including ones held by in-flight
        pulls, which fail fast with a connection error) and tear down the
        native plane. Safe to race with concurrent pulls: each socket is
        tracked in exactly one pool slot from dial to close, so nothing
        leaks even if a pull checked its socket out before we got here."""
        with self._global_lock:
            self._closed = True
            pools = list(self._pools.values())
            self._pools.clear()
        for pool in pools:
            pool.close()
        # arena attachments: DROP the references, never close() them here.
        # A concurrent _pull_shm may be mid-read of a view into the
        # mapping; munmapping under it is a segfault. The holder owns the
        # segment — each attachment unmaps via __del__ once its last
        # in-flight reader drops the reference.
        with self._arena_lock:
            self._arenas.clear()
        self._plane.teardown()


def serve_object_transfer(runtime, host: str = "127.0.0.1",
                          port: int = 0) -> ObjectTransferServer:
    """Start the transfer plane for a Runtime's driver store and advertise
    the address in the control plane KV (`object_transfer/{node_id}`), so
    remote runtimes sharing the control plane can locate the holder."""
    store = runtime.driver_agent.store
    server = ObjectTransferServer(store, host, port)
    node_hex = runtime.driver_agent.node_id.hex()
    object_ledger.note_peer(server.address, node_hex)
    try:
        runtime.control_plane.kv_put(KV_PREFIX + node_hex, server.address)
        runtime.control_plane.kv_put(HOST_PREFIX + node_hex, _host_token())
    except Exception:  # noqa: BLE001 — advertising is best-effort
        logger.warning("could not advertise transfer address", exc_info=True)
    server.start_load_gossip(runtime.control_plane, node_hex)
    return server


_default_client: Optional[ObjectTransferClient] = None
_default_client_lock = threading.Lock()


def _shared_client() -> ObjectTransferClient:
    """Process-wide default puller. Long-lived so the native path's
    connections and staging arena amortize across calls — a per-call
    client would pay arena setup/teardown per object."""
    global _default_client
    with _default_client_lock:
        if _default_client is None:
            _default_client = ObjectTransferClient()
        return _default_client


def _holder_tier(control_plane, node_hex: str, local_token: str,
                 local_slice) -> int:
    """Locality tier of a holder: 0 same host (shm distance), 1 same
    slice/pod (ICI-adjacent hosts), 2 everything else. Missing topology
    info degrades to tier 2 — ranking is advisory, never correctness."""
    try:
        token = control_plane.kv_get(HOST_PREFIX + node_hex)
        if token and token == local_token:
            return 0
    except Exception:  # noqa: BLE001 — tokens are advisory
        pass
    if local_slice is not None:
        try:
            from .ids import NodeID

            info = control_plane.get_node(NodeID.from_hex(node_hex))
            if info is not None and info.slice_id == local_slice:
                return 1
        except Exception:  # noqa: BLE001 — topology is advisory
            pass
    return 2


def _ranked_holders(control_plane, local_token: Optional[str] = None,
                    local_slice=None) -> List[str]:
    """Advertised transfer addresses, nearest-and-least-loaded first:
    locality tier (same host < same slice < cross-pod, from the
    `object_transfer_host/*` tokens and node slice ids) then each
    holder's gossiped outstanding-request count (`object_transfer_load/*`
    KV, published by start_load_gossip); holders that never gossiped rank
    as idle, preserving the old iteration order among ties."""
    token = local_token if local_token is not None else _host_token()
    ranked: List[Tuple[int, float, int, str]] = []
    for idx, key in enumerate(control_plane.kv_keys(KV_PREFIX)):
        address = control_plane.kv_get(key)
        if not address:
            continue
        node_hex = key[len(KV_PREFIX):]
        object_ledger.note_peer(address, node_hex)
        load = 0.0
        try:
            raw = control_plane.kv_get(LOAD_PREFIX + node_hex)
            if raw:
                load = float(raw)
        except Exception:  # noqa: BLE001 — load is advisory
            pass
        tier = _holder_tier(control_plane, node_hex, token, local_slice)
        ranked.append((tier, load, idx, address))
    ranked.sort()
    return [addr for _, _, _, addr in ranked]


def _claim_relay_slot(control_plane, oid_hex: str, address: str,
                      label: str, node_hex: str,
                      max_slots: int = 4096) -> Optional[int]:
    """Atomically claim the lowest free relay-tree slot for this puller
    (kv_put overwrite=False is the compare-and-set). The claim value
    carries the puller's transfer address (children dial it), its flow
    label (children attribute the edge), and its node id (mark_node_dead
    purges a dead node's claims by this suffix)."""
    value = f"{address}|{label}|{node_hex}"
    slot = 0
    while slot < max_slots:
        key = f"{RELAY_PREFIX}{oid_hex}/{slot:06d}"
        try:
            if control_plane.kv_put(key, value, overwrite=False):
                return slot
        except TypeError:
            return None  # control plane without CAS puts: no relay
        slot += 1
    return None


def _relay_parent(control_plane, oid_hex: str, slot: int,
                  fanout: int) -> Optional[Tuple[str, str, str]]:
    """-> (address, flow_label, node_hex) of slot's tree parent, or None
    for root-tier slots (they pull from the sealed holders) and for
    purged parents (dead node: the child falls back to sealed holders)."""
    if slot < fanout:
        return None
    parent = (slot - fanout) // fanout
    try:
        val = control_plane.kv_get(f"{RELAY_PREFIX}{oid_hex}/{parent:06d}")
    except Exception:  # noqa: BLE001 — control plane hiccup: no parent
        return None
    if not val:
        return None
    address, _, rest = str(val).partition("|")
    label, _, node_hex = rest.partition("|")
    if not address:
        return None
    return address, label, node_hex


def purge_relay_claims(oid_hex: str, control_plane) -> None:
    """Best-effort removal of an object's relay-slot claims (broadcast
    epilogue / bench round teardown — claims are only needed while late
    pullers may still resolve their parent)."""
    try:
        for key in control_plane.kv_keys(f"{RELAY_PREFIX}{oid_hex}/"):
            control_plane.kv_del(key)
    except Exception:  # noqa: BLE001 — stale claims only waste KV bytes
        pass


def _relay_pull(control_plane, client, object_id, holders, relay_server,
                cache_store, on_cached, node_hex: str = "") -> Any:
    """Join the object's relay tree: claim a slot, register a _Partial on
    this node's transfer server (so downstream pullers stream our
    committed prefix mid-transfer), and pull from the claimed parent —
    falling back through the sealed holders, resuming from the committed
    offset, if the parent dies. Returns _RELAY_MISS whenever the relay
    is not worth it or not possible; the caller runs the flat path."""
    oid_hex = object_id.hex()
    if not holders:
        return _RELAY_MISS
    try:
        staged = client._call(holders[0], "stage", oid_hex, True)
        total = staged["size"]
        shm = staged.get("shm")
    except ObjectPullError:
        return _RELAY_MISS
    except (KeyError, TypeError):
        return _RELAY_MISS  # pre-staged-protocol holder
    if (shm is not None and config.object_transfer_shm_handoff
            and shm.get("token") == _host_token()):
        return _RELAY_MISS  # same host: the zero-copy handoff wins
    if total < int(config.object_relay_min_bytes):
        return _RELAY_MISS
    fanout = max(1, int(config.object_broadcast_fanout))
    label = client._flow_dst()
    # partial BEFORE claim: the instant the claim lands, children may
    # dial this node — the partial must already be there to park on
    partial = relay_server.begin_partial(oid_hex, True, total)
    if partial is None:
        return _RELAY_MISS  # another pull on this node already feeds it
    slot = _claim_relay_slot(control_plane, oid_hex, relay_server.address,
                             label, node_hex or label)
    if slot is None:
        relay_server.fail_partial(oid_hex, True, "no relay slot")
        return _RELAY_MISS
    # candidates: tree parent first (its partial streams to us chunk-by-
    # chunk as it lands), then the sealed holders nearest-first — never
    # ourselves (a self-pull would park on our own partial forever)
    candidates: List[Tuple[str, str, str]] = []
    parent = _relay_parent(control_plane, oid_hex, slot, fanout)
    if parent is not None and parent[0] != relay_server.address:
        candidates.append(("relay",) + parent[:2])
    for addr in holders:
        if addr != relay_server.address:
            candidates.append(("chunked", addr, ""))
    last_error: Optional[BaseException] = None
    for flow_path, address, src_label in candidates:
        start = partial.committed  # resume: chunks commit atomically
        try:
            client._pull_chunked(
                address, oid_hex, True, start, total,
                src_node=src_label or object_ledger.peer_node(address),
                flow_path=flow_path, sink=(partial.buf, 0),
                commit=partial.commit)
        except ObjectPullError as e:
            last_error = e
            continue
        value = _decode_blob(memoryview(partial.buf))
        relay_server.finish_partial(oid_hex, True)
        try:
            cache_store.put(object_id, value)
            if on_cached is not None:
                on_cached(object_id)
        except Exception:  # noqa: BLE001 — caching is best-effort
            logger.debug("pull-through cache of %s failed", object_id,
                         exc_info=True)
        return value.load() if isinstance(value, SealedBytes) else value
    # every candidate failed: release the slot and wake parked children
    # with an error so they fall back to surviving holders
    relay_server.fail_partial(oid_hex, True,
                              f"relay pull failed: {last_error!r}")
    try:
        control_plane.kv_del(f"{RELAY_PREFIX}{oid_hex}/{slot:06d}")
    except Exception:  # noqa: BLE001 — claim GC is best-effort
        pass
    return _RELAY_MISS


def pull_from_any(control_plane, object_id,
                  client: Optional[ObjectTransferClient] = None,
                  cache_store=None, on_cached=None,
                  relay_server: Optional[ObjectTransferServer] = None,
                  node_hex: str = "") -> Any:
    """Resolve `object_transfer/*` advertisements from the control plane
    and try holders nearest-first (same host, then same slice, then by
    ascending gossiped load) until one serves the object. The unranked
    remainder is offered to the client as striping peers for large
    chunked pulls.

    With `cache_store`, the pull fetches the sealed payload and seals it
    into that (local) store before returning the loaded value — the
    pull-through replica. `on_cached(object_id)` then fires so the caller
    can register the new location in its directory; both steps are
    best-effort and never fail the get (objects are immutable once sealed,
    so a cached replica can never go stale).

    With `relay_server` (this node's own ObjectTransferServer), large
    pulls join a collective relay tree: the puller claims a tree slot in
    the KV, streams from its parent's committed prefix, and serves its
    own partial to downstream pullers mid-transfer — N concurrent
    pullers disseminate as a pipelined tree instead of N independent
    full pulls from one sender."""
    from ..util import tracing

    client = client or _shared_client()
    want_raw = cache_store is not None
    holders = _ranked_holders(control_plane)
    with tracing.span_if_traced("object_pull",
                                {"object_id": object_id.hex()[:16],
                                 "holders": len(holders)}):
        if (relay_server is not None and want_raw
                and config.object_broadcast_relay):
            value = _relay_pull(control_plane, client, object_id, holders,
                                relay_server, cache_store, on_cached,
                                node_hex=node_hex)
            if value is not _RELAY_MISS:
                return value
        return _pull_from_holders(client, object_id, want_raw, holders,
                                  cache_store, on_cached)


def _pull_from_holders(client, object_id, want_raw, holders,
                       cache_store, on_cached) -> Any:
    errors = []
    for pos, address in enumerate(holders):
        peers = holders[pos + 1:] + holders[:pos]
        # two attempts per holder, but ONLY for transport-class failures:
        # the shared client pools connections, so the first failure after
        # a holder restart (or an idle conn being dropped) is just the
        # stale socket — the client drops it and the retry dials fresh. An
        # application-level refusal ("object not here") is the holder's
        # real answer; re-asking the same holder just doubles pull latency
        # across a large fleet.
        for attempt in (0, 1):
            try:
                value = client.pull(address, object_id, raw=want_raw,
                                    peers=peers)
            except ObjectPullConnectionError as e:
                if attempt == 1:
                    errors.append((address, str(e)))
                continue
            except ObjectPullError as e:
                errors.append((address, str(e)))
                break
            if not want_raw:
                return value
            try:
                cache_store.put(object_id, value)
                if on_cached is not None:
                    on_cached(object_id)
            except Exception:  # noqa: BLE001 — caching is best-effort
                logger.debug("pull-through cache of %s failed", object_id,
                             exc_info=True)
            return value.load() if isinstance(value, SealedBytes) else value
    raise ObjectPullError(
        f"no advertised holder served {object_id}: {errors}"
    )
