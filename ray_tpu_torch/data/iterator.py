"""DataIterator: batch iteration + threaded host prefetch + device
prefetch.

Reference: `python/ray/data/iterator.py :: DataIterator.iter_batches` /
`iter_torch_batches`. Host-side batch assembly (`api.get`, block concat,
the user transform) runs on a bounded background thread — the prefetch
stage — so it overlaps the consumer's device compute. The device part is
`iter_device_batches`: each host batch is staged in pinned memory and
copied to the card on a side stream, `prefetch` batches ahead of the
consumer, and the consumer's stream waits for a batch's copy before the
batch is handed over.

The port's copy of ray_tpu/data/iterator.py: `iter_device_batches` takes
a torch `device` where the reference takes a jax sharding.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from .. import api
from ..core.config import config
from ..ops.dispatch import resolve_device
from .block import BlockAccessor
from .executor import _m_stall


_DONE = object()


def _bounded_put(q: _queue.Queue, stop: threading.Event, item) -> bool:
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except _queue.Full:
            continue
    return False


def _prefetch_produce(make_iter, q: _queue.Queue,
                      stop: threading.Event) -> None:
    try:
        for item in make_iter():
            if not _bounded_put(q, stop, (None, item)):
                return
        _bounded_put(q, stop, (_DONE, None))
    except BaseException as e:  # noqa: BLE001 — re-raised at consumer
        _bounded_put(q, stop, (e, None))


class PrefetchIterator:
    """Iterator over a bounded background-thread producer with an
    explicit lifecycle.

    Runs `make_iter()` on a daemon thread, handing items through a queue
    bounded at `depth` (the producer runs at most `depth` items ahead).
    Producer exceptions re-raise at the consumer's next pull; consumer-
    side blocking time accumulates into
    data_stage_stall_seconds{stage=,tenant=}.

    Unlike the old generator shape, the producer thread is joinable from
    EVERY abandonment path: `close()` (idempotent), `with` blocks, and
    GC of a never-started or half-consumed iterator all set the stop
    flag, drain the queue so a parked `put()` unblocks, and join the
    thread — an abandoned iterator can no longer leak a thread parked on
    a full queue."""

    def __init__(self, make_iter: Callable[[], Iterator[Any]], depth: int,
                 stage: str = "host_prefetch", tenant: str = ""):
        self._q: _queue.Queue = _queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._closed = False
        self._stage = stage
        self._tenant = tenant
        self._make_iter = make_iter
        # the thread target closes over the queue + stop event ONLY, never
        # self: a bound-method target would keep the iterator reachable
        # for the thread's whole lifetime and the __del__ safety net could
        # never fire on an abandoned iterator
        self._thread = threading.Thread(
            target=_prefetch_produce, args=(make_iter, self._q, self._stop),
            daemon=True, name="data-host-prefetch")
        self._thread.start()

    # ------------------------------------------------------------ consumer

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> Any:
        if self._closed:
            raise StopIteration
        t0 = time.perf_counter()
        kind, item = self._q.get()
        _m_stall.inc(time.perf_counter() - t0,
                     tags={"stage": self._stage, "tenant": self._tenant})
        if kind is _DONE:
            self.close()
            raise StopIteration
        if kind is not None:
            self.close()
            raise kind
        return item

    # ----------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Stop the producer and join its thread. Idempotent; safe from
        any state (unstarted, mid-stream, exhausted)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:  # unblock a producer parked on a full queue
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass
        self._thread.join(timeout=1.0)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # GC safety net for abandoned iterators
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class DataIterator:
    """Iterates blocks from a ref-producing factory (re-iterable).

    `tenant` tags every stall sample this iterator emits (multi-tenant
    ingest demand signals). The iterator is also a context manager:
    `close()` tears down every live prefetch thread it spawned, so a
    consumer that abandons an epoch mid-stream can release the
    `data-host-prefetch` threads deterministically instead of waiting
    for GC."""

    def __init__(self, ref_stream_factory: Callable[[], Iterator[Any]],
                 tenant: str = ""):
        self._factory = ref_stream_factory
        self._tenant = tenant
        self._live: "weakref.WeakSet[PrefetchIterator]" = weakref.WeakSet()

    def _background(self, make_iter: Callable[[], Iterator[Any]],
                    depth: int) -> PrefetchIterator:
        it = PrefetchIterator(make_iter, depth, tenant=self._tenant)
        self._live.add(it)
        return it

    def close(self) -> None:
        """Join every prefetch thread spawned by this iterator's batch
        streams. Idempotent; live streams raise StopIteration after."""
        for it in list(self._live):
            it.close()

    def __enter__(self) -> "DataIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def iter_block_refs(self) -> Iterator[Any]:
        return self._factory()

    def iter_blocks(self) -> Iterator[Any]:
        for ref in self._factory():
            yield api.get(ref)

    def iter_rows(self) -> Iterator[Any]:
        for block in self.iter_blocks():
            yield from BlockAccessor(block).iter_rows()

    def iter_batches(
        self,
        batch_size: int = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
        prefetch_batches: int = 1,
    ) -> Iterator[Any]:
        """Re-chunk the block stream into exact-size batches.

        prefetch_batches > 0 moves batch assembly (`api.get`, block
        concat, re-chunking) onto a bounded background thread running
        that many batches ahead, so host assembly overlaps the caller's
        step; the batch sequence is identical either way. 0 assembles
        inline on the calling thread."""
        if prefetch_batches and prefetch_batches > 0:
            return self._background(
                lambda: self._iter_batches_inline(
                    batch_size=batch_size,
                    batch_format=batch_format,
                    drop_last=drop_last,
                    local_shuffle_buffer_size=local_shuffle_buffer_size,
                    local_shuffle_seed=local_shuffle_seed,
                ),
                prefetch_batches,
            )
        return self._iter_batches_inline(
            batch_size=batch_size,
            batch_format=batch_format,
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed,
        )

    def _iter_batches_inline(
        self,
        batch_size: int = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
    ) -> Iterator[Any]:
        rng = np.random.default_rng(local_shuffle_seed)
        buf: list = []
        buffered_rows = 0

        def emit_from(rows_blocks):
            return BlockAccessor.batch_of(BlockAccessor.concat(rows_blocks), batch_format)

        pending: list = []
        pending_rows = 0
        for block in self.iter_blocks():
            acc = BlockAccessor(block)
            if acc.num_rows() == 0:
                continue
            if local_shuffle_buffer_size:
                buf.append(block)
                buffered_rows += acc.num_rows()
                if buffered_rows >= max(local_shuffle_buffer_size, batch_size):
                    merged = BlockAccessor.concat(buf)
                    macc = BlockAccessor(merged)
                    order = rng.permutation(macc.num_rows())
                    merged = _take_order(merged, order)
                    buf, buffered_rows = [], 0
                    block, acc = merged, BlockAccessor(merged)
                else:
                    continue
            pending.append(block)
            pending_rows += acc.num_rows()
            while pending_rows >= batch_size:
                merged = BlockAccessor.concat(pending)
                macc = BlockAccessor(merged)
                yield BlockAccessor.batch_of(macc.take(batch_size), batch_format)
                rest = macc.slice(batch_size, macc.num_rows())
                pending = [rest]
                pending_rows = BlockAccessor(rest).num_rows()
        if buf:
            # drain the shuffle buffer: the tail still gets permuted
            merged = BlockAccessor.concat(buf)
            order = rng.permutation(BlockAccessor(merged).num_rows())
            pending.append(_take_order(merged, order))
            pending_rows = sum(BlockAccessor(b).num_rows() for b in pending)
            while pending_rows >= batch_size:
                merged = BlockAccessor.concat(pending)
                macc = BlockAccessor(merged)
                yield BlockAccessor.batch_of(macc.take(batch_size), batch_format)
                rest = macc.slice(batch_size, macc.num_rows())
                pending = [rest]
                pending_rows = BlockAccessor(rest).num_rows()
        if pending_rows and not drop_last:
            yield emit_from(pending)

    def iter_torch_batches(
        self,
        batch_size: int = 256,
        dtypes: Optional[Dict[str, Any]] = None,
        device: Optional[str] = None,
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
    ) -> Iterator[Any]:
        """Batches as torch tensors (reference: `iter_torch_batches`).

        Tensors on the host unless `device` names one (a plain `.to`, no
        prefetch); the prefetched path to the card is
        `iter_device_batches`. dtypes maps column -> torch dtype; device is
        a torch device string."""
        import torch

        def to_torch(col, name):
            arr = np.asarray(col)
            if arr.dtype == object:
                raise TypeError(
                    f"column {name!r} is not tensor-convertible (object "
                    "dtype); map it to numeric first"
                )
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if dtypes and name in dtypes:
                t = t.to(dtypes[name])
            if device:
                t = t.to(device)
            return t

        for batch in self.iter_batches(
            batch_size=batch_size,
            batch_format="numpy",
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed,
        ):
            if isinstance(batch, dict):
                yield {k: to_torch(v, k) for k, v in batch.items()}
            else:
                yield to_torch(batch, "<batch>")

    def iter_device_batches(
        self,
        batch_size: int,
        device: Optional[Any] = None,
        prefetch: Optional[int] = None,
        drop_last: bool = True,
        transform: Optional[Callable[[Dict[str, np.ndarray]], Any]] = None,
        host_prefetch_batches: int = 2,
    ) -> Iterator[Any]:
        """Host batches -> the card, `prefetch` batches ahead of the consumer.

        The host stage (`api.get`, block concat, the user `transform`) runs
        `host_prefetch_batches` deep on a background thread; 0 assembles
        inline. Each batch (a tree of dicts, lists and tuples of numpy
        arrays) comes back as the same tree of torch tensors on `device`:
        the card unless the caller names another (raises without a card).
        On the card each array is copied into pinned host memory and then
        to the card on a side stream, non-blocking; the consumer's current
        stream waits on that copy's event before the batch is handed over,
        and the pinned source lives until the event completes. So decode,
        batch assembly and the copy to the card all overlap the consumer's
        compute.
        """
        dev = resolve_device(device)  # at the call: no card, no iterator
        if prefetch is None:
            prefetch = config.device_prefetch_depth
        return self._device_batches(batch_size, dev, prefetch, drop_last,
                                    transform, host_prefetch_batches)

    def _device_batches(self, batch_size, dev, prefetch, drop_last, transform,
                        host_prefetch_batches) -> Iterator[Any]:
        def host_iter():
            for batch in self._iter_batches_inline(
                    batch_size=batch_size, drop_last=drop_last):
                # user transform belongs to the host stage: it runs on
                # the prefetch thread, not the consumer thread
                yield transform(batch) if transform is not None else batch

        if host_prefetch_batches and host_prefetch_batches > 0:
            host_batches: Iterator[Any] = self._background(
                host_iter, host_prefetch_batches)
        else:
            host_batches = host_iter()
        if dev.type != "cuda":
            for batch in host_batches:
                yield _tree_map(lambda a: _as_tensor(a).to(dev), batch)
            return
        copier = _DeviceCopier(dev)
        window: collections.deque = collections.deque()
        for batch in host_batches:
            window.append(copier.put(batch))  # async copy; no host block
            if len(window) > prefetch:
                yield copier.hand_over(*window.popleft())
        while window:
            yield copier.hand_over(*window.popleft())


# what jax.numpy.asarray makes of a 64-bit column without x64, as the
# reference's iter_device_batches hands it over
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
           np.dtype(np.float64): np.float32, np.dtype(np.complex128): np.complex64}


def _as_tensor(a):
    """A host tensor of one batch column, 64-bit columns narrowed to 32
    bits on the host (before any pinned copy, so the copy moves half the
    bytes), as the reference's jax.numpy.asarray does."""
    import torch

    arr = np.asarray(a)
    if arr.dtype == object:
        raise TypeError("a device batch needs numeric arrays, not object dtype")
    narrow = _NARROW.get(arr.dtype)
    if narrow is not None:
        arr = arr.astype(narrow)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class _DeviceCopier:
    """Copies host batches to one card on a side stream.

    `put` stages every array of a batch in pinned host memory (on the
    consumer's thread) and enqueues its copy to the card on the side
    stream, non-blocking, then records an event. `hand_over` makes the
    consumer's current stream (torch's current stream is per thread) wait
    on that event and marks each tensor as used by it (`record_stream`),
    so the caching allocator does not hand the memory to another tensor
    while the side stream may still write it. The pinned sources stay
    referenced until their copy's event has completed."""

    def __init__(self, device):
        import torch

        self._torch = torch
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self._staged: collections.deque = collections.deque()  # (event, pinned)

    def _release_done(self) -> None:
        while self._staged and self._staged[0][0].query():
            self._staged.popleft()

    def put(self, batch):
        torch = self._torch
        self._release_done()
        pinned = []

        def pin(a):
            host = _as_tensor(a)
            buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            buf.copy_(host)
            pinned.append(buf)
            return buf

        staged = _tree_map(pin, batch)
        with torch.cuda.stream(self.stream):
            # allocated on the side stream; hand_over's record_stream keeps
            # the allocator from reusing it before the consumer is done
            on_card = _tree_map(
                lambda t: t.to(self.device, non_blocking=True), staged)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._staged.append((event, pinned))
        return on_card, event

    def hand_over(self, on_card, event):
        consumer = self._torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        _tree_map(lambda t: t.record_stream(consumer), on_card)
        return on_card


def _take_order(block, order):
    acc = BlockAccessor(block)
    if acc.is_tabular:
        return {k: np.asarray(v)[order] for k, v in block.items()}
    return [block[i] for i in order]
