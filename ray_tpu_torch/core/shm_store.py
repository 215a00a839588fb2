"""ctypes binding for the C++ shared-memory object store (_shm/shm_store.cc).

The native path for the host object plane: multi-process workers map one
/dev/shm arena and exchange sealed immutable buffers zero-copy. The
pure-Python in-process store stays the store of the node agents; this one
carries the worker-process pool's task payloads (process_pool.py) and the
transfer plane's staging arenas (object_transfer.py).

The port's copy of ray_tpu/core/shm_store.py. The library builds at first
use with the host C++ compiler from ray_tpu_torch/core/_shm into
ray_tpu_torch/_build/<hash of the sources and flags>/libshm_store.so (the
reference runs `make` in its source tree instead). A store is a sparse
segment sized with ftruncate, so a write past the free space of /dev/shm
would raise SIGBUS, not an error: creating a store checks the free space
against its capacity first and raises ShmStoreError when it is short.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import socket
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import Optional

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "_shm"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libshm_store.so"
SOURCES = ("shm_store.cc", "transfer.cc")
CXX_FLAGS = ("-O2", "-fPIC", "-Wall", "-std=c++17", "-shared")
LINK_FLAGS = ("-lpthread", "-lrt")
SHM_DIR = "/dev/shm"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

ID_SIZE = 20
_ENTRY_BYTES = 64  # an upper bound on sizeof(Entry) in shm_store.cc


class ShmStoreError(RuntimeError):
    pass


class PullRejected(ShmStoreError):
    """Native pull could not land in the destination store (too large for
    the arena); the caller should fall back to the buffered path."""


def build_dir() -> Path:
    """Build directory keyed by a hash of the sources and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_ROOT / f"shm-{h.hexdigest()[:16]}"


def build() -> Path:
    """Compile _shm/*.cc into the library unless this exact source set is
    already built; returns the library's path."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise ShmStoreError("no C++ compiler (g++) found: the shm store "
                            "builds at first use from ray_tpu_torch/core/_shm")
    tmp = out_dir.with_name(f"{out_dir.name}.tmp{os.getpid()}.{threading.get_ident()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    t0 = time.monotonic()
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp / LIB_NAME),
         *[str(SRC_DIR / n) for n in SOURCES], *LINK_FLAGS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300)
    (tmp / "build.log").write_text(
        f"{' '.join(proc.args)}\nexit {proc.returncode} in "
        f"{time.monotonic() - t0:.2f}s\n{proc.stdout}")
    if proc.returncode != 0:
        log = proc.stdout
        shutil.rmtree(tmp, ignore_errors=True)
        raise ShmStoreError(f"cannot build {LIB_NAME}:\n{log}")
    try:
        tmp.rename(out_dir)  # atomic publish; a concurrent builder may win
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.shm_store_create.restype = ctypes.c_void_p
    lib.shm_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
    lib.shm_store_open.restype = ctypes.c_void_p
    lib.shm_store_open.argtypes = [ctypes.c_char_p]
    lib.shm_obj_create.restype = ctypes.c_void_p
    lib.shm_obj_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.shm_obj_seal.restype = ctypes.c_int
    lib.shm_obj_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.shm_obj_get.restype = ctypes.c_void_p
    lib.shm_obj_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)
    ]
    for fn in ("shm_obj_release", "shm_obj_delete", "shm_obj_contains"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.shm_store_live_bytes.restype = ctypes.c_uint64
    lib.shm_store_live_bytes.argtypes = [ctypes.c_void_p]
    lib.shm_store_capacity.restype = ctypes.c_uint64
    lib.shm_store_capacity.argtypes = [ctypes.c_void_p]
    lib.shm_store_close.restype = None
    lib.shm_store_close.argtypes = [ctypes.c_void_p]
    # native transfer plane (_shm/transfer.cc)
    lib.shm_transfer_server_start.restype = ctypes.c_void_p
    lib.shm_transfer_server_start.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)
    ]
    lib.shm_transfer_server_port.restype = ctypes.c_int
    lib.shm_transfer_server_port.argtypes = [ctypes.c_void_p]
    lib.shm_transfer_server_stop.restype = None
    lib.shm_transfer_server_stop.argtypes = [ctypes.c_void_p]
    lib.shm_transfer_connect.restype = ctypes.c_int
    lib.shm_transfer_connect.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int
    ]
    lib.shm_transfer_pull_buf.restype = ctypes.c_int64
    lib.shm_transfer_pull_buf.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64
    ]
    lib.shm_transfer_pull_store.restype = ctypes.c_int64
    lib.shm_transfer_pull_store.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p
    ]
    lib.shm_transfer_close_fd.restype = None
    lib.shm_transfer_close_fd.argtypes = [ctypes.c_int]


def shm_free_bytes() -> int:
    """Bytes free on the /dev/shm filesystem (0 where it is absent)."""
    try:
        st = os.statvfs(SHM_DIR)
    except OSError:
        return 0
    return st.f_bavail * st.f_frsize


def _check_id(object_id: bytes) -> bytes:
    if len(object_id) != ID_SIZE:
        raise ValueError(f"object id must be {ID_SIZE} bytes, got {len(object_id)}")
    return object_id


class ShmObjectStore:
    """One mapped store handle (create for the node owner, open for clients)."""

    kind = "shm"

    def __init__(self, name: str, capacity: int = 1 << 30, max_objects: int = 4096,
                 create: bool = True):
        self._h = None
        self.name = name if name.startswith("/") else f"/{name}"
        if create:
            need = int(capacity) + int(max_objects) * _ENTRY_BYTES
            free = shm_free_bytes()
            if free < need:
                raise ShmStoreError(
                    f"cannot create shm store {self.name}: {SHM_DIR} has "
                    f"{free} bytes free, the store needs {need} (its segment "
                    "is sparse, so a write past the free space would raise "
                    "SIGBUS); give the machine a larger /dev/shm")
        self._lib = _load()
        if create:
            self._h = self._lib.shm_store_create(
                self.name.encode(), capacity, max_objects
            )
        else:
            self._h = self._lib.shm_store_open(self.name.encode())
        if not self._h:
            raise ShmStoreError(
                f"cannot {'create' if create else 'open'} shm store {self.name}"
            )
        # parity with MemoryObjectStore.on_evict: fires on explicit delete
        # so directory locations can be deregistered. C-side LRU eviction
        # inside the arena is NOT observable from Python, so hook users
        # must tolerate stale advertisements (pullers fall through the
        # ranked holder list on a miss).
        self.on_evict = None
        # object-plane ledger (core/object_ledger.py): Python-side metadata
        # for entries THIS handle sealed or pulled (the C arena has no
        # enumeration API, so other processes' objects are invisible here —
        # each process's handle reports its own, and the head merges them).
        self.ledger_node = ""
        self._meta_lock = threading.Lock()
        self._meta: dict = {}  # object_id bytes -> ledger meta dict
        self._evictions = 0

    # -- raw byte API --------------------------------------------------------

    def _handle(self):
        """The C functions do no null check: calling through a closed handle
        is a segfault, not an error. Every entry point goes through here."""
        h = self._h
        if not h:
            raise ShmStoreError(f"shm store {self.name} is closed")
        return h

    def _create_write_seal(self, object_id: bytes, total: int, write) -> None:
        """Allocate, fill via write(ptr), seal. A failure after create must
        reclaim the slot: the creator pin (pins=1 until seal) blocks delete,
        so release it first — otherwise the unsealed entry is a permanent
        compaction barrier the LRU can never evict."""
        h = self._handle()
        ptr = self._lib.shm_obj_create(h, object_id, total)
        if not ptr:
            raise ShmStoreError(
                f"create failed for {object_id.hex()[:8]} ({total}B): "
                f"duplicate, table full, or arena exhausted"
            )
        try:
            write(ptr)
            if self._lib.shm_obj_seal(h, object_id) != 0:
                raise ShmStoreError("seal failed")
        except Exception:
            self._lib.shm_obj_release(h, object_id)  # drop creator pin
            self._lib.shm_obj_delete(h, object_id)
            raise
        self._note_put(object_id, total)

    def _note_put(self, object_id: bytes, nbytes: int,
                  pin_reason: str = "") -> None:
        """Record ledger metadata for an object this handle landed."""
        now = time.monotonic()
        with self._meta_lock:
            if len(self._meta) > 65536:  # runaway guard for long-lived handles
                self._meta.clear()
            self._meta[bytes(object_id)] = {
                "size_bytes": int(nbytes),
                "created_at": now,
                "last_access": now,
                "pin_reason": pin_reason,
                "creator_node": self.ledger_node,
                "creator_pid": os.getpid(),
                "creator_task": "",
            }

    def annotate(self, object_id: bytes, pin_reason: Optional[str] = None,
                 creator_task: Optional[str] = None,
                 creator_node: Optional[str] = None) -> None:
        """Ledger-metadata parity with MemoryObjectStore.annotate (the
        serialized_escape reason is sticky there too)."""
        with self._meta_lock:
            meta = self._meta.get(bytes(object_id))
            if meta is None:
                return
            if (pin_reason is not None
                    and meta["pin_reason"] != "serialized_escape"):
                meta["pin_reason"] = pin_reason
            if creator_task is not None:
                meta["creator_task"] = creator_task
            if creator_node is not None:
                meta["creator_node"] = creator_node

    def put(self, object_id: bytes, data) -> None:
        """data: bytes or any C-contiguous buffer (memoryview, pickle5 raw)."""
        _check_id(object_id)
        if not isinstance(data, (bytes, bytearray)):
            data = np.frombuffer(data, np.uint8)  # zero-copy address handle
        n = data.nbytes if isinstance(data, np.ndarray) else len(data)
        src = data.ctypes.data if isinstance(data, np.ndarray) else bytes(data)
        self._create_write_seal(object_id, n, lambda ptr: ctypes.memmove(ptr, src, n))

    def get_view(self, object_id: bytes) -> Optional[memoryview]:
        """Zero-copy pinned view; call release(id) when done."""
        _check_id(object_id)
        size = ctypes.c_uint64()
        h = self._h
        if not h:  # closed mid-flight: report missing, don't segfault
            return None
        ptr = self._lib.shm_obj_get(h, object_id, ctypes.byref(size))
        if not ptr:
            return None
        with self._meta_lock:
            meta = self._meta.get(bytes(object_id))
            if meta is not None:
                meta["last_access"] = time.monotonic()
        arr = (ctypes.c_uint8 * size.value).from_address(ptr)
        return memoryview(arr)

    def get_bytes(self, object_id: bytes) -> Optional[bytes]:
        view = self.get_view(object_id)
        if view is None:
            return None
        try:
            return bytes(view)
        finally:
            self.release(object_id)

    def release(self, object_id: bytes) -> None:
        if not self._h:  # store already closed (e.g. interpreter shutdown)
            return
        self._lib.shm_obj_release(self._h, _check_id(object_id))

    def delete(self, object_id: bytes) -> bool:
        h = self._h
        if not h:
            return False
        deleted = self._lib.shm_obj_delete(h, _check_id(object_id)) == 0
        if deleted:
            with self._meta_lock:
                self._meta.pop(bytes(object_id), None)
                self._evictions += 1
        on_evict = self.on_evict
        if deleted and on_evict is not None:
            try:
                on_evict(object_id)
            except Exception:  # noqa: BLE001 — hooks never fail a delete
                pass
        return deleted

    def contains(self, object_id: bytes) -> bool:
        h = self._h
        if not h:
            return False
        return self._lib.shm_obj_contains(h, _check_id(object_id)) == 1

    # -- numpy zero-copy -----------------------------------------------------

    def put_array(self, object_id: bytes, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        header = f"{arr.dtype.str}|{','.join(map(str, arr.shape))}|".encode()
        total = len(header) + arr.nbytes

        def write(ptr):
            ctypes.memmove(ptr, header, len(header))
            ctypes.memmove(ptr + len(header), arr.ctypes.data, arr.nbytes)

        self._create_write_seal(_check_id(object_id), total, write)

    def get_array(self, object_id: bytes) -> Optional[np.ndarray]:
        """Zero-copy read: the returned array aliases shared memory. The pin
        is released when the last numpy view dies (finalizer on the buffer
        owner every view chains to); do NOT also call release(id)."""
        view = self.get_view(object_id)
        if view is None:
            return None
        # view.obj is the ctypes buffer at the bottom of every numpy view's
        # .base chain; when it is collected, no aliasing array remains.
        weakref.finalize(view.obj, self.release, bytes(object_id))
        raw = np.frombuffer(view, np.uint8)
        # parse tiny header: dtype|shape|. A single-byte dtype's str starts
        # with "|" itself ("|b1", "|u1"): the first separator comes after
        # it (ROADMAP C18: the reference's parse fails on these)
        first = bytes(raw[:64])
        d1 = first.index(b"|", 1)
        d2 = first.index(b"|", d1 + 1)
        dtype = np.dtype(first[:d1].decode())
        shape_s = first[d1 + 1: d2].decode()
        shape = tuple(int(x) for x in shape_s.split(",")) if shape_s else ()
        data = raw[d2 + 1:]
        return data.view(dtype).reshape(shape)

    def live_bytes(self) -> int:
        return self._lib.shm_store_live_bytes(self._handle())

    def capacity(self) -> int:
        return self._lib.shm_store_capacity(self._handle())

    def stats(self) -> dict:
        """Same dict shape as MemoryObjectStore.stats so the ledger and
        /metrics report both backends uniformly. Bytes/capacity come from
        the arena (authoritative, cross-process); the object count is
        this handle's tracked entries (the arena has no enumeration API)."""
        try:
            used, cap = self.live_bytes(), self.capacity()
        except ShmStoreError:
            used = cap = 0
        with self._meta_lock:
            n = len(self._meta)
        return {
            "num_objects": n,
            "used_bytes": used,
            "capacity_bytes": cap,
            "num_spilled": 0,  # the arena never spills; creates fail instead
            "num_evictions": self._evictions,
        }

    def list_objects(self):
        """[(object_id bytes, nbytes)] for this handle's tracked entries
        (MemoryObjectStore.list_objects parity for introspection)."""
        with self._meta_lock:
            items = list(self._meta.items())
        return [(oid, m["size_bytes"]) for oid, m in items
                if self.contains(oid)]

    def ledger_records(self) -> list:
        """Ledger rows in object_ledger wire shape; entries deleted by
        another process (or LRU-evicted in the arena) are pruned here."""
        now = time.monotonic()
        with self._meta_lock:
            items = list(self._meta.items())
        out, stale = [], []
        for oid, m in items:
            if not self.contains(oid):
                stale.append(oid)
                continue
            out.append({
                "object_id": oid.hex(),
                "size_bytes": m["size_bytes"],
                "age_s": round(now - m["created_at"], 3),
                "idle_s": round(now - m["last_access"], 3),
                "pin_count": 0,  # C-side pins are view refcounts, not holds
                "pin_reason": m["pin_reason"],
                "creator_node": m["creator_node"][:12],
                "creator_pid": m["creator_pid"],
                "creator_task": m["creator_task"],
                "spilled": False,
            })
        if stale:
            with self._meta_lock:
                for oid in stale:
                    self._meta.pop(oid, None)
        return out

    def close(self) -> None:
        if self._h:
            self._lib.shm_store_close(self._h)
            self._h = None

    def unlink_name(self) -> None:
        """Remove the /dev/shm name WITHOUT closing the mapping: live
        pointers stay valid, but no new process can open the store and
        the segment is reclaimed once the last mapping drops. For
        teardown paths that must not munmap under in-flight users but
        also must not leak the name past process exit."""
        try:
            os.unlink(os.path.join(SHM_DIR, self.name.lstrip("/")))
        except OSError:
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeTransferServer:
    """C++ serving thread streaming sealed objects from `store`'s arena
    (_shm/transfer.cc). The store must stay open for the server's life —
    the server holds a raw handle into it."""

    def __init__(self, store: ShmObjectStore, host: str = "127.0.0.1",
                 port: int = 0):
        self._h = None
        self._lib = _load()
        self._store = store  # keep the mapping alive
        host = socket.gethostbyname(host)  # the C side wants a dotted quad
        port_out = ctypes.c_int()
        self._h = self._lib.shm_transfer_server_start(
            store._handle(), host.encode(), port, ctypes.byref(port_out)
        )
        if not self._h:
            raise ShmStoreError("cannot start native transfer server")
        self.port = port_out.value

    def stop(self) -> None:
        if self._h:
            self._lib.shm_transfer_server_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class NativeTransferClient:
    """Pulls whole objects over one pooled connection per holder. The recv
    loop runs in C with the GIL released; -2 (missing) and -3 (exceeds the
    caller's buffer) are soft failures the caller can fall back from.
    Connect and every send/recv are bounded by `timeout_s` (enforced in C
    via SO_RCVTIMEO/SO_SNDTIMEO) so a blackholed holder fails fast instead
    of wedging the puller."""

    MISSING = -2
    TOO_LARGE = -3

    def __init__(self, timeout_s: float = 30.0):
        self._lib = _load()
        self._timeout_ms = max(1, int(timeout_s * 1000))
        self._fds: dict = {}
        self._lock = threading.Lock()

    def _conn(self, host: str, port: int):
        key = (host, port)
        with self._lock:
            conn = self._fds.get(key)
        if conn is not None:
            return conn
        # connect OUTSIDE the registry lock: a slow/unreachable holder
        # must not block pulls from other holders
        fd = self._lib.shm_transfer_connect(
            socket.gethostbyname(host).encode(), port, self._timeout_ms)
        if fd < 0:
            raise ShmStoreError(f"cannot connect to {host}:{port}")
        with self._lock:
            existing = self._fds.get(key)
            if existing is not None:  # lost the race: keep the first conn
                self._lib.shm_transfer_close_fd(fd)
                return existing
            conn = (fd, threading.Lock())
            self._fds[key] = conn
            return conn

    def pull(self, host: str, port: int, object_id: bytes,
             size: int) -> Optional[bytearray]:
        """Pull `object_id` (known `size` from the control path) into a
        fresh buffer. Returns None when the holder no longer has it."""
        _check_id(object_id)
        fd, fd_lock = self._conn(host, port)
        buf = bytearray(size)
        c_buf = (ctypes.c_uint8 * size).from_buffer(buf) if size else None
        with fd_lock:  # request/response pairs must not interleave on one fd
            rc = self._lib.shm_transfer_pull_buf(fd, object_id, c_buf, size)
        if rc == self.MISSING:
            return None
        if rc == self.TOO_LARGE:
            # soft failure by contract: the C side drained the payload, so
            # the pooled connection stays healthy — do NOT drop it
            raise PullRejected(
                f"object {object_id.hex()[:8]} is larger than the "
                f"{size}B buffer the control path promised"
            )
        if rc < 0 or rc != size:
            self._drop(host, port)
            raise ShmStoreError(
                f"native pull of {object_id.hex()[:8]} from {host}:{port} "
                f"failed (rc={rc}, expected {size}B)"
            )
        return buf

    def pull_into(self, host: str, port: int, object_id: bytes,
                  store: ShmObjectStore) -> Optional[int]:
        """Pull `object_id` straight into `store`'s arena (no Python-side
        allocation). Returns the size, None when the holder lacks the
        object, or raises PullRejected when the local create failed and
        the object is not already present (caller falls back)."""
        _check_id(object_id)
        fd, fd_lock = self._conn(host, port)
        with fd_lock:  # request/response pairs must not interleave on one fd
            rc = self._lib.shm_transfer_pull_store(fd, object_id,
                                                   store._handle())
        if rc == self.MISSING:
            return None
        if rc == self.TOO_LARGE:
            # create failed: either a concurrent pull landed it (reuse) or
            # it genuinely does not fit this store. get_view (not contains)
            # pins it — a concurrent delete between the two would otherwise
            # turn the reuse branch into a crash.
            view = store.get_view(object_id)
            if view is not None:
                try:
                    return len(view)
                finally:
                    store.release(object_id)
            raise PullRejected(
                f"object {object_id.hex()[:8]} does not fit store {store.name}"
            )
        if rc < 0:
            self._drop(host, port)
            raise ShmStoreError(
                f"native pull of {object_id.hex()[:8]} from {host}:{port} "
                f"failed (rc={rc})"
            )
        # the pull landed the object via C without a Python put: record it
        # in the destination handle's ledger as a pull-through replica
        store._note_put(object_id, int(rc), pin_reason="cache")
        return int(rc)

    def _drop(self, host: str, port: int) -> None:
        with self._lock:
            conn = self._fds.pop((host, port), None)
        if conn is not None:
            self._lib.shm_transfer_close_fd(conn[0])

    def close(self) -> None:
        with self._lock:
            conns = list(self._fds.values())
            self._fds.clear()
        for fd, _ in conns:
            self._lib.shm_transfer_close_fd(fd)
