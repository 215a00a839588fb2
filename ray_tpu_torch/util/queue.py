"""Distributed Queue (reference: `python/ray/util/queue.py`): a named
actor-backed FIFO usable across tasks/actors.

The port's copy of ray_tpu/util/queue.py."""

from __future__ import annotations

import queue as _q
from typing import Any, List, Optional

from .. import api


@api.remote
class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self.q: "_q.Queue" = _q.Queue(maxsize=maxsize)

    def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        try:
            self.q.put(item, timeout=timeout, block=timeout is not None)
            return True
        except _q.Full:
            return False

    def get(self, timeout: Optional[float] = None) -> Any:
        try:
            return ("ok", self.q.get(timeout=timeout, block=timeout is not None))
        except _q.Empty:
            return ("empty", None)

    def qsize(self) -> int:
        return self.q.qsize()

    def empty(self) -> bool:
        return self.q.empty()


class Empty(Exception):
    pass


class Full(Exception):
    pass


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 8)
        self._actor = _QueueActor.options(**opts).remote(maxsize)

    def put(self, item: Any, timeout: Optional[float] = 10.0) -> None:
        ok = api.get(self._actor.put.remote(item, timeout))
        if not ok:
            raise Full("queue full")

    def get(self, timeout: Optional[float] = 10.0) -> Any:
        status, item = api.get(self._actor.get.remote(timeout))
        if status == "empty":
            raise Empty("queue empty")
        return item

    def put_nowait(self, item: Any) -> None:
        self.put(item, timeout=0.001)

    def get_nowait(self) -> Any:
        return self.get(timeout=0.001)

    def qsize(self) -> int:
        return api.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        return api.get(self._actor.empty.remote())

    def shutdown(self) -> None:
        api.kill(self._actor)
