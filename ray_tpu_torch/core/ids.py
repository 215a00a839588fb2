"""Typed identifiers for jobs, tasks, actors, objects, nodes and slices.

Design follows the reference's ID family (upstream ray `src/ray/common/id.h ::
BaseID/JobID/ActorID/TaskID/ObjectID`): fixed-width binary IDs with ownership
information embedded so that, given an ObjectID, the runtime can recover the
task that produced it and the job it belongs to without a directory lookup.

Layout (bytes):
    JobID    4   random
    NodeID   16  random
    SliceID  8   random          (TPU-native addition: a gang/slice identity)
    ActorID  16  = 12 random | 4 job
    TaskID   24  = 8 random  | 16 actor (nil actor for normal tasks)
    ObjectID 28  = 24 task   | 4 big-endian put/return index

The port's copy of ray_tpu/core/ids.py.
"""

from __future__ import annotations

import os
import threading

__all__ = [
    "BaseID",
    "JobID",
    "NodeID",
    "SliceID",
    "ActorID",
    "TaskID",
    "ObjectID",
    "WorkerID",
    "PlacementGroupID",
]


class BaseID:
    """Immutable fixed-width binary identifier."""

    SIZE = 0
    __slots__ = ("_bytes", "_hash")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._bytes = binary
        self._hash = hash((type(self).__name__, binary))

    @classmethod
    def generate(cls) -> "BaseID":
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\x00" * cls.SIZE)

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other) -> bool:
        return self._bytes < other._bytes

    def __hash__(self) -> int:
        return self._hash

    def __reduce__(self):
        # Rebuild through the constructor: the cached _hash is salted by
        # THIS process's PYTHONHASHSEED and must never cross a process
        # boundary (an unpickled id with a foreign hash silently misses
        # every dict lookup against locally-built ids).
        return (type(self), (self._bytes,))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._bytes.hex()})"


class JobID(BaseID):
    SIZE = 4
    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(cls.SIZE, "big"))

    @classmethod
    def next(cls) -> "JobID":
        with cls._lock:
            cls._counter += 1
            return cls.from_int(cls._counter)

    def to_int(self) -> int:
        return int.from_bytes(self._bytes, "big")


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class SliceID(BaseID):
    """Identity of a TPU slice / gang failure domain."""

    SIZE = 8


class PlacementGroupID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = 16
    _RANDOM = 12

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(os.urandom(cls._RANDOM) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[self._RANDOM :])


class TaskID(BaseID):
    SIZE = 24
    _RANDOM = 8

    @classmethod
    def of(cls, actor_id: "ActorID | None" = None) -> "TaskID":
        actor = actor_id if actor_id is not None else ActorID.nil()
        return cls(os.urandom(cls._RANDOM) + actor.binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[self._RANDOM :])

    def is_actor_task(self) -> bool:
        return not self.actor_id().is_nil()


class ObjectID(BaseID):
    SIZE = 28
    _INDEX_BYTES = 4
    MAX_INDEX = 2**32 - 1

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        if not 0 <= index <= cls.MAX_INDEX:
            raise ValueError(f"return index out of range: {index}")
        return cls(task_id.binary() + index.to_bytes(cls._INDEX_BYTES, "big"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Puts share the index space with returns; the high bit marks a put.
        return cls.for_task_return(task_id, put_index | 0x80000000)

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def index(self) -> int:
        return int.from_bytes(self._bytes[TaskID.SIZE :], "big") & 0x7FFFFFFF

    def is_put(self) -> bool:
        return bool(self._bytes[TaskID.SIZE] & 0x80)
