"""Dynamic request batching (reference: `python/ray/serve/batching.py ::
@serve.batch`).

Thread-based (replica actors execute requests on threads): calls block on
an event while a background batcher thread coalesces up to max_batch_size
requests (or batch_wait_timeout_s), invokes the wrapped fn once with the
list, and fans results back out. On the card this is what turns
per-request traffic into batches the matrix units can fill.

The port's copy of ray_tpu/serve/batching.py.
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import Any, Callable, List, Optional


class _Pending:
    __slots__ = ("args", "event", "result", "error")

    def __init__(self, args):
        self.args = args
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _Batcher:
    def __init__(self, fn, max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop, daemon=True)
                self._thread.start()

    def _loop(self):
        while True:
            batch: List[_Pending] = [self.q.get()]
            deadline = self.timeout
            while len(batch) < self.max_batch_size:
                try:
                    batch.append(self.q.get(timeout=deadline))
                except queue.Empty:
                    break
            try:
                results = self.fn([p.args for p in batch])
                if len(results) != len(batch):
                    raise ValueError(
                        f"batched fn returned {len(results)} results for "
                        f"{len(batch)} inputs"
                    )
                for p, r in zip(batch, results):
                    p.result = r
            except BaseException as e:
                for p in batch:
                    p.error = e
            for p in batch:
                p.event.set()

    def submit(self, args) -> Any:
        self._ensure_thread()
        p = _Pending(args)
        self.q.put(p)
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result


def batch(
    _fn: Optional[Callable] = None,
    *,
    max_batch_size: int = 8,
    batch_wait_timeout_s: float = 0.01,
):
    """Decorator: fn(list_of_inputs) -> list_of_outputs becomes callable
    per-input; calls are transparently coalesced."""

    def wrap(fn):
        batchers: dict = {}
        lock = threading.Lock()

        @functools.wraps(fn)
        def wrapper(*args):
            # methods: batch per bound instance
            if len(args) == 2 and hasattr(args[0], "__dict__"):
                inst, payload = args
                key = id(inst)
                bound = functools.partial(fn, inst)
            elif len(args) == 1:
                (payload,) = args
                key, bound = None, fn
            else:
                raise TypeError("@serve.batch functions take one argument")
            with lock:
                b = batchers.get(key)
                if b is None:
                    b = batchers[key] = _Batcher(
                        bound, max_batch_size, batch_wait_timeout_s
                    )
            return b.submit(payload)

        wrapper._is_serve_batch = True
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
