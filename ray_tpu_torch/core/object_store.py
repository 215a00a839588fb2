"""Per-node object store: immutable create/seal/get semantics.

The port's copy of ray_tpu/core/object_store.py (the reference's
counterpart of upstream ray's Plasma store + LocalObjectManager,
`src/ray/object_manager/plasma/store.cc :: ObjectStore`,
`object_lifecycle_manager.cc`, spilling in `raylet/local_object_manager.cc`):
objects are sealed-once-then-immutable, pinned while referenced, LRU-evicted
to a disk spill directory under memory pressure, and restored on demand.

Two backends share one interface:
  * ``MemoryObjectStore`` — python-heap store used by in-process nodes.
  * The C++ shared-memory store (``ray_tpu_torch/core/_shm``) — mmap'd host
    shm for cross-process zero-copy, bound via ctypes (see shm_store.py);
    the worker-process pool and the transfer plane's staging arenas use
    it, and its ledger records (object_ledger.py) come from the handle's
    own metadata, since the arena has no enumeration API.

Device trees (a deliberate difference, ROADMAP C). The reference lets
jax.Array trees through unsealed: they are immutable, and pickling would
drag device buffers through the host. Torch tensors are mutable, so the
port splits the rule. A tree that holds any tensor off the CPU (CUDA; the
`meta` device in the tests) passes through BY REFERENCE: `get` returns the
very tensors `put` was given, zero-copy, and a consumer that writes into
them writes into the owner's. Such an entry counts against the card, not
the host store's capacity, and is never spilled. A tree of CPU tensors is
sealed like any host value: copied at `put`, so a later in-place change
is not seen, as with numpy in the reference.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set

from .config import config
from .ids import ObjectID
from .logging import get_logger

logger = get_logger("object_store")


class ObjectStoreFullError(RuntimeError):
    pass


class SealedBytes:
    """A pickled payload sealed into the store. Every ``get`` deserializes a
    fresh object, so no consumer can alias the producer's live object or
    another consumer's copy — the serialization boundary the reference
    enforces by construction with worker processes + plasma. Large array
    buffers ride out-of-band (pickle protocol 5): the store keeps ONE
    immutable bytes copy and each ``get`` reconstructs arrays as zero-copy
    read-only views over it — plasma's shared-read semantics."""

    __slots__ = ("payload", "buffers")

    def __init__(self, payload: bytes, buffers=()):
        self.payload = payload
        self.buffers = tuple(buffers)

    @property
    def nbytes(self) -> int:
        return len(self.payload) + sum(len(b) for b in self.buffers)

    def load(self) -> Any:
        if self.buffers:
            return pickle.loads(self.payload, buffers=self.buffers)
        return pickle.loads(self.payload)

    def __reduce_ex__(self, protocol):
        # payload/buffers may be memoryviews after a zero-copy wire decode
        # (object_transfer._decode_blob); PickleBuffer keeps them picklable
        # either way — inline when no buffer_callback is active, out-of-band
        # (no copy) when the dumper collects buffers (protocol 5).
        if protocol >= 5:
            return (
                SealedBytes,
                (pickle.PickleBuffer(self.payload),
                 tuple(pickle.PickleBuffer(b) for b in self.buffers)),
            )
        return (SealedBytes, (bytes(self.payload),
                              tuple(bytes(b) for b in self.buffers)))


def _device_leaves(value: Any) -> list:
    """The torch tensors off the CPU in the value's tree (dicts, lists,
    tuples, named tuples), checked lazily: if torch was never imported,
    there can be none."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return []
    from torch.utils import _pytree

    return [leaf for leaf in _pytree.tree_leaves(value)
            if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu"]


def _has_device_leaves(value: Any) -> bool:
    """True if the value's tree holds a tensor off the CPU."""
    try:
        return bool(_device_leaves(value))
    except Exception:
        return True  # exotic tree: don't risk serializing


def seal_value(value: Any, name: str = "<put>") -> Any:
    """Wrap a value for aliasing-safe storage (see SealedBytes).

    Already-sealed payloads and immutable scalars pass through; trees
    holding a tensor off the CPU pass through by reference (pickling would
    drag device buffers through the host; the module docstring says what
    the alias means); CPU tensors are sealed like any host value;
    unpicklable values are stored live as a documented fallback."""
    if value is None or isinstance(
        value, (bool, int, float, str, bytes, SealedBytes)
    ):
        return value
    if _has_device_leaves(value):
        return value
    import cloudpickle

    buffers: list = []
    try:
        payload = cloudpickle.dumps(
            value, protocol=5, buffer_callback=buffers.append
        )
        return SealedBytes(payload, [bytes(b.raw()) for b in buffers])
    except Exception:
        logger.debug("value from %s not picklable; stored live", name)
        return value


class ObjectLostError(RuntimeError):
    def __init__(self, object_id: ObjectID, reason: str = "object lost"):
        super().__init__(f"{reason}: {object_id}")
        self.object_id = object_id


@dataclass
class _Entry:
    value: Any
    nbytes: int
    sealed: bool = True
    pin_count: int = 0
    spilling: bool = False  # disk write in flight (value still readable)
    spilled_path: Optional[str] = None
    created_at: float = field(default_factory=time.monotonic)
    # object-plane ledger metadata (core/object_ledger.py): who made this
    # object, why it is held, and when it was last read
    last_access: float = field(default_factory=time.monotonic)
    pin_reason: str = ""
    creator_node: str = ""
    creator_pid: int = 0
    creator_task: str = ""
    # a tree of device tensors held by reference: counts against the card,
    # not `capacity`, and is never spilled
    device: bool = False


class MemoryObjectStore:
    """Single-node store with pinning, LRU eviction and disk spill."""

    kind = "memory"

    def __init__(self, capacity_bytes: Optional[int] = None, spill_dir: Optional[str] = None):
        if capacity_bytes is None:
            capacity_bytes = config.object_store_memory_bytes or 2 * 1024**3
        self.capacity = capacity_bytes
        self.spill_dir = spill_dir or config.object_store_fallback_dir
        self._lock = threading.Condition()
        self._entries: "OrderedDict[ObjectID, _Entry]" = OrderedDict()
        self._used = 0
        self._evictions = 0
        # ledger identity: the node this store serves (NodeAgent sets it);
        # stamped as creator_node on entries sealed here
        self.ledger_node = ""
        self._waiters: Dict[ObjectID, List[Callable[[], None]]] = {}
        # fires (outside the lock) when an object leaves the store for good
        # — delete, not spill (spilled objects are still gettable). The node
        # agent hooks this to deregister the directory location, so a
        # pull-through replica's advertisement dies with the replica.
        self.on_evict: Optional[Callable[[ObjectID], None]] = None

    # -- size accounting ----------------------------------------------------
    @staticmethod
    def sizeof(value: Any) -> int:
        try:
            import numpy as np

            if isinstance(value, np.ndarray):
                return int(value.nbytes)
        except ImportError:
            pass
        nbytes = getattr(value, "nbytes", None)
        if isinstance(nbytes, int):
            return nbytes
        try:
            leaves = _device_leaves(value)
        except Exception:
            leaves = []
        if leaves:  # a device tree: never pickled to be measured
            return sum(int(t.nbytes) for t in leaves)
        try:
            return len(pickle.dumps(value, protocol=5))
        except Exception:
            return 1024  # unpicklable (actor handles etc.) — nominal size

    def list_objects(self):
        """[(object_id, nbytes)] snapshot — the `ray memory` introspection."""
        with self._lock:
            return [(oid, e.nbytes) for oid, e in self._entries.items()]

    # -- primary API --------------------------------------------------------
    def put(self, object_id: ObjectID, value: Any, nbytes: Optional[int] = None) -> None:
        size = nbytes if nbytes is not None else self.sizeof(value)
        device = _has_device_leaves(value)
        if size > self.capacity and not device:
            raise ObjectStoreFullError(
                f"object of {size} bytes exceeds store capacity {self.capacity}"
            )
        while True:
            victim_id = None
            with self._lock:
                if object_id in self._entries:
                    return  # idempotent seal (retries)
                if device or self._used + size <= self.capacity:
                    self._entries[object_id] = _Entry(
                        value=value, nbytes=size, device=device,
                        creator_node=self.ledger_node, creator_pid=os.getpid())
                    if not device:
                        self._used += size
                    callbacks = self._waiters.pop(object_id, [])
                    self._lock.notify_all()
                    break
                for oid, entry in self._entries.items():  # oldest first
                    if (entry.pin_count == 0 and not entry.spilling
                            and entry.spilled_path is None and not entry.device):
                        victim_id = oid
                        entry.spilling = True
                        victim_value = entry.value
                        break
                if victim_id is None:
                    raise ObjectStoreFullError(
                        f"store full ({self._used}B used, {size}B requested) and "
                        "all objects are pinned or spilling"
                    )
            # disk write happens OUTSIDE the lock: gets/puts proceed meanwhile
            path = self._write_spill_file(victim_id, victim_value)
            with self._lock:
                entry = self._entries.get(victim_id)
                if entry is not None and entry.spilling:
                    entry.spilling = False
                    entry.spilled_path = path
                    entry.value = None
                    self._used -= entry.nbytes
                    logger.debug("spilled %s (%d bytes) to %s", victim_id, entry.nbytes, path)
                else:  # deleted concurrently — discard the file
                    try:
                        os.remove(path)
                    except OSError:
                        pass
        for cb in callbacks:
            cb()

    def nbytes_of(self, object_id: ObjectID):
        """Size of a resident object, or None (backpressure accounting)."""
        with self._lock:
            entry = self._entries.get(object_id)
            return entry.nbytes if entry is not None else None

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._entries

    def get(self, object_id: ObjectID, timeout: Optional[float] = None) -> Any:
        value = self.get_raw(object_id, timeout)
        if isinstance(value, SealedBytes):
            return value.load()  # fresh object per consumer
        return value

    def get_raw(self, object_id: ObjectID, timeout: Optional[float] = None) -> Any:
        """get() without unwrapping SealedBytes — for store-to-store
        transfer, which must preserve the sealed form so the guarantee
        survives node hops."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while object_id not in self._entries:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"timed out waiting for {object_id}")
                self._lock.wait(timeout=remaining if remaining is None else min(remaining, 0.1))
            entry = self._entries[object_id]
            self._entries.move_to_end(object_id)  # LRU touch
            entry.last_access = time.monotonic()
            value = entry.value
            path = entry.spilled_path
        if value is None and path is not None:
            # restore from disk OUTSIDE the lock
            with open(path, "rb") as f:
                value = pickle.load(f)
        return value

    def on_available(self, object_id: ObjectID, callback: Callable[[], None]) -> None:
        """Invoke callback once the object is sealed (immediately if already)."""
        with self._lock:
            if object_id in self._entries:
                ready = True
            else:
                ready = False
                self._waiters.setdefault(object_id, []).append(callback)
        if ready:
            callback()

    def pin(self, object_id: ObjectID, reason: str = "") -> None:
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is not None:
                entry.pin_count += 1
                if reason:
                    entry.pin_reason = reason

    def annotate(self, object_id: ObjectID, pin_reason: Optional[str] = None,
                 creator_task: Optional[str] = None,
                 creator_node: Optional[str] = None) -> None:
        """Attach ledger metadata to a sealed entry. `serialized_escape`
        is sticky — once a ref escaped the process, a later cache/channel
        annotation must not hide why the object cannot be auto-freed."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                return
            if pin_reason is not None and entry.pin_reason != "serialized_escape":
                entry.pin_reason = pin_reason
            if creator_task is not None:
                entry.creator_task = creator_task
            if creator_node is not None:
                entry.creator_node = creator_node

    def unpin(self, object_id: ObjectID) -> None:
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is not None and entry.pin_count > 0:
                entry.pin_count -= 1

    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            entry = self._entries.pop(object_id, None)
            path = None
            if entry is not None:
                # spilled entries already gave their bytes back at spill time
                if entry.spilled_path is None and not entry.device:
                    self._used -= entry.nbytes
                entry.spilling = False  # in-flight spill finalizer will no-op
                path = entry.spilled_path
                self._evictions += 1
        if path:
            try:
                os.remove(path)
            except OSError:
                pass
        on_evict = self.on_evict
        if entry is not None and on_evict is not None:
            try:
                on_evict(object_id)
            except Exception:  # noqa: BLE001 — eviction hooks never fail a delete
                logger.debug("on_evict hook failed for %s", object_id,
                             exc_info=True)

    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def object_ids(self) -> Set[ObjectID]:
        with self._lock:
            return set(self._entries.keys())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            spilled = sum(1 for e in self._entries.values() if e.spilled_path)
            return {
                "num_objects": len(self._entries),
                "used_bytes": self._used,
                "capacity_bytes": self.capacity,
                "num_spilled": spilled,
                "num_evictions": self._evictions,
            }

    def ledger_records(self) -> List[Dict[str, Any]]:
        """Wire-friendly ledger rows for every resident object (ages as
        local monotonic deltas — see object_ledger.snapshot_store)."""
        now = time.monotonic()
        with self._lock:
            return [{
                "object_id": oid.hex(),
                "size_bytes": e.nbytes,
                "age_s": round(now - e.created_at, 3),
                "idle_s": round(now - e.last_access, 3),
                "pin_count": e.pin_count,
                "pin_reason": e.pin_reason,
                "creator_node": e.creator_node[:12],
                "creator_pid": e.creator_pid,
                "creator_task": e.creator_task,
                "spilled": e.spilled_path is not None,
            } for oid, e in self._entries.items()]

    # -- eviction / spill ---------------------------------------------------
    def _write_spill_file(self, object_id: ObjectID, value: Any) -> str:
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, object_id.hex())
        with open(path, "wb") as f:
            pickle.dump(value, f, protocol=5)
        return path

    def notify_all(self) -> None:
        with self._lock:
            self._lock.notify_all()
