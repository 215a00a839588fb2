"""multiprocessing.Pool shim over remote tasks (reference:
`python/ray/util/multiprocessing/pool.py` — drop-in Pool so existing
`multiprocessing` code scales onto the runtime unchanged).

Each Pool method maps onto `@remote` task fan-out: the runtime's
worker-process pool supplies the actual process isolation, so this shim
is thin — argument batching, ordered/unordered result iteration, and the
context-manager/terminate lifecycle.

The port's copy of ray_tpu/util/multiprocessing.py. Its tasks run in the
runtime's forked worker processes (`worker_processes` > 0, the default);
in thread mode they share the driver's process.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

from .. import api


class AsyncResult:
    """`multiprocessing.pool.AsyncResult` shape over ObjectRefs."""

    def __init__(self, refs: List[Any], single: bool = False):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        out = api.get(self._refs, timeout=timeout)
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None) -> None:
        api.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        done, _ = api.wait(self._refs, num_returns=len(self._refs), timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        try:
            api.get(self._refs, timeout=0)
            return True
        except Exception:  # noqa: BLE001 — mirrors stdlib semantics
            return False


class Pool:
    """Drop-in for `multiprocessing.Pool` over the task runtime.

    `processes` bounds in-flight chunks for the synchronous/lazy paths
    (map/starmap/imap/imap_unordered — processes=1 is strictly serial,
    per the stdlib contract); `map_async` submits eagerly and lets the
    runtime's own scheduler bound execution. `initializer` runs in front
    of every task (tasks are stateless, so it is fused into the task
    function rather than run once per OS process)."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        api._auto_init()
        self._processes = processes or 8
        self._initializer = initializer
        self._initargs = tuple(initargs)
        self._closed = False

        init = self._initializer
        init_args = self._initargs

        @api.remote
        def _call(fn, batch):
            if init is not None:
                init(*init_args)
            return [fn(*args) for args in batch]

        @api.remote
        def _one(fn, a, kw):
            # the initializer contract holds for apply/apply_async too
            if init is not None:
                init(*init_args)
            return fn(*a, **kw)

        self._call = _call
        self._one = _one

    # -- helpers -------------------------------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise ValueError("Pool not running")

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = [(x,) for x in iterable]
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [items[i:i + chunksize] for i in range(0, len(items), chunksize)]

    def _submit_batches(self, func, batches) -> List[Any]:
        """Eager submission (map_async: results come back later anyway)."""
        return [self._call.remote(func, batch) for batch in batches]

    def _windowed_batches(self, func, batches, ordered: bool = True):
        """Yield per-batch results with at most `processes` chunks in
        flight — the stdlib contract that Pool(processes=N) bounds
        concurrency (e.g. processes=1 means strictly serial)."""
        window: List[Any] = []
        idx = 0
        if ordered:
            while idx < len(batches) or window:
                while idx < len(batches) and len(window) < self._processes:
                    window.append(self._call.remote(func, batches[idx]))
                    idx += 1
                yield api.get(window.pop(0))
        else:
            while idx < len(batches) or window:
                while idx < len(batches) and len(window) < self._processes:
                    window.append(self._call.remote(func, batches[idx]))
                    idx += 1
                done, window = api.wait(window, num_returns=1)
                yield api.get(done[0])

    # -- the multiprocessing.Pool surface ------------------------------------

    def apply(self, func: Callable, args: tuple = (), kwds: dict = None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func: Callable, args: tuple = (),
                    kwds: dict = None) -> AsyncResult:
        self._check_open()
        return AsyncResult(
            [self._one.remote(func, tuple(args), kwds or {})], single=True
        )

    def map(self, func: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        self._check_open()
        out: List[Any] = []
        for batch_result in self._windowed_batches(
            func, self._chunks(iterable, chunksize)
        ):
            out.extend(batch_result)
        return out

    def map_async(self, func: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None) -> "AsyncResult":
        self._check_open()
        refs = self._submit_batches(func, self._chunks(iterable, chunksize))

        class _Flatten(AsyncResult):
            def get(self, timeout: Optional[float] = None):
                nested = api.get(self._refs, timeout=timeout)
                return list(itertools.chain.from_iterable(nested))

        return _Flatten(refs)

    def starmap(self, func: Callable, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> List[Any]:
        self._check_open()
        items = [tuple(args) for args in iterable]
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        batches = [items[i:i + chunksize]
                   for i in range(0, len(items), chunksize)]
        out: List[Any] = []
        for batch_result in self._windowed_batches(func, batches):
            out.extend(batch_result)
        return out

    def imap(self, func: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        """Ordered lazy iteration (chunk granularity)."""
        self._check_open()
        for batch_result in self._windowed_batches(
            func, self._chunks(iterable, chunksize)
        ):
            yield from batch_result

    def imap_unordered(self, func: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        """Completion-order lazy iteration (chunk granularity)."""
        self._check_open()
        for batch_result in self._windowed_batches(
            func, self._chunks(iterable, chunksize), ordered=False
        ):
            yield from batch_result

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
