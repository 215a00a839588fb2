"""Streaming executor: pipelined, backpressured block flow over remote tasks.

Reference: `python/ray/data/_internal/execution/streaming_executor.py` +
`operators/`. Scaled to the architecture that matters: each fused stage
runs as remote tasks (one per block) with a bounded in-flight window —
downstream consumption pulls blocks through, so memory stays bounded and
CPU preprocessing overlaps device compute (the input-pipeline property the
card cares about).

The port's copy of ray_tpu/data/executor.py. Its tasks run in the
runtime's worker processes and its actor-pool workers in actor processes
when `worker_processes`/`actor_processes` are on (the defaults), on the
node agents' threads otherwise.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from .. import api
from ..core.logging import get_logger
from ..core.metrics import Counter, Gauge
from .block import Block, BlockAccessor
from .aggregate import finalize, merge_partials, partial_aggregate
from .logical import (
    Aggregate,
    InputData,
    Limit,
    LogicalPlan,
    MapBatches,
    RandomShuffle,
    Read,
    Repartition,
    Sort,
    Union,
    Zip,
    fuse,
)

logger = get_logger("data.executor")

DEFAULT_MAX_IN_FLIGHT = 16
# byte budget for READY-but-unconsumed blocks per streaming stage: a slow
# consumer halts upstream submission once this much output is parked
# (reference: execution/resource_manager.py per-op memory backpressure)
DEFAULT_MAX_IN_FLIGHT_BYTES = 256 << 20

# data-plane observability (north star: the stall must be visible on a
# scrape, not just benchable): stall seconds accumulate wherever the
# plane blocks waiting for upstream work, tagged by stage
_m_stall = Counter(
    "data_stage_stall_seconds",
    "Seconds a data-plane stage spent blocked waiting on upstream blocks.",
)
_m_in_flight = Gauge(
    "data_blocks_in_flight",
    "Submitted-but-unconsumed blocks per streaming stage.",
)
_m_parked = Gauge(
    "data_bytes_parked",
    "Bytes of completed-but-unconsumed block output per streaming stage.",
)


def _nbytes_of(rt, ref) -> Optional[int]:
    for nid in rt.directory.locations(ref.object_id):
        agent = rt.agents.get(nid)
        store = getattr(agent, "store", None)
        n = store.nbytes_of(ref.object_id) if hasattr(store, "nbytes_of") else None
        if n is not None:
            return n
    return None


class _StageWindow:
    """Submitted-but-unconsumed refs of one streaming stage.

    Owns three concerns the old per-check full re-poll conflated:

    - incremental completion tracking: each ref is polled only until it
      completes (one api.wait over the still-running subset), and its
      output size is looked up ONCE and cached — not api.wait + a
      directory/store walk over the whole pending list on every admission
      check;
    - the per-stage memory gate (reference: resource_manager.py per-op
      budgets): admits a new submission only while parked output bytes
      plus the PROJECTED bytes of still-running tasks (running average of
      completed output sizes) stay under the budget, with a capped
      warmup before any size is known;
    - completion-order pops for out-of-order yield, plus per-owner
      outstanding counts for least-outstanding actor-pool dispatch (an
      owner stays charged for work the consumer already took until that
      work actually finishes).
    """

    WARMUP_INFLIGHT = 4

    def __init__(self, budget_bytes: int, name: str = "stage"):
        self.budget = budget_bytes
        self.name = name
        self._avg: Optional[float] = None
        self._order: List[Any] = []       # submission order, popped FIFO
        self._running: List[Any] = []     # submitted, not yet known-complete
        self._ready_ids: set = set()      # complete, not yet popped
        self._ready_bytes = 0
        self._sizes: Dict[Any, int] = {}  # oid -> bytes (parked refs only)
        self._owner: Dict[Any, Any] = {}  # oid -> owner key
        self.outstanding: Dict[Any, int] = {}  # owner -> incomplete count
        # popped while still running: tracked only for owner accounting
        self._detached: List[Any] = []

    def __len__(self) -> int:
        return len(self._order)

    def add(self, ref: Any, owner: Any = None) -> None:
        self._order.append(ref)
        self._running.append(ref)
        if owner is not None:
            self._owner[ref.object_id] = owner
            self.outstanding[owner] = self.outstanding.get(owner, 0) + 1

    def _on_complete(self, ref: Any, detached: bool) -> None:
        owner = self._owner.pop(ref.object_id, None)
        if owner is not None:
            self.outstanding[owner] -= 1
        if detached:
            return
        self._ready_ids.add(ref.object_id)
        from ..core import core_worker as _cw

        try:
            n = _nbytes_of(_cw.get_runtime(), ref)
        except RuntimeError:
            n = None
        self._sizes[ref.object_id] = n or 0
        self._ready_bytes += n or 0

    def poll(self, timeout: float = 0) -> None:
        """Fold newly-completed refs into the parked set; one wait over
        only the still-running refs (plus detached ones for owner
        bookkeeping)."""
        polled = self._running + self._detached
        if polled:
            done, _ = api.wait(polled, num_returns=len(polled),
                               timeout=timeout)
            done_ids = {r.object_id for r in done}
            if done_ids:
                for ref in [r for r in self._running
                            if r.object_id in done_ids]:
                    self._running.remove(ref)
                    self._on_complete(ref, detached=False)
                for ref in [r for r in self._detached
                            if r.object_id in done_ids]:
                    self._detached.remove(ref)
                    self._on_complete(ref, detached=True)
        if self._ready_ids:
            # refresh from what is parked NOW: a frozen early average
            # (small header blocks) would under-project forever
            self._avg = self._ready_bytes / len(self._ready_ids)
        tags = {"stage": self.name}
        _m_in_flight.set(len(self._order), tags=tags)
        _m_parked.set(self._ready_bytes, tags=tags)

    def may_submit(self) -> bool:
        self.poll()
        if self._avg is None:
            return len(self._running) < self.WARMUP_INFLIGHT
        return self._ready_bytes + len(self._running) * self._avg < self.budget

    def _forget(self, ref: Any) -> Any:
        self._order.remove(ref)
        if ref.object_id in self._ready_ids:
            self._ready_ids.discard(ref.object_id)
            self._ready_bytes -= self._sizes.pop(ref.object_id, 0)
        elif ref in self._running:
            # yielded before completion (ordered head-of-line): keep
            # watching it so its owner's outstanding count stays honest
            self._running.remove(ref)
            if ref.object_id in self._owner:
                self._detached.append(ref)
        return ref

    def pop(self, ordered: bool) -> Any:
        """Next ref for the consumer: submission order when `ordered`
        (may still be running — the consumer's get blocks, exactly the old
        behavior), else whichever completed first, blocking only when
        nothing has finished yet (the stall that makes is the metric)."""
        self.poll()
        if ordered:
            return self._forget(self._order[0])
        for ref in self._order:
            if ref.object_id in self._ready_ids:
                return self._forget(ref)
        t0 = time.perf_counter()
        api.wait(self._running, num_returns=1, timeout=None)
        _m_stall.inc(time.perf_counter() - t0, tags={"stage": self.name})
        self.poll()
        for ref in self._order:
            if ref.object_id in self._ready_ids:
                return self._forget(ref)
        return self._forget(self._order[0])  # unreachable safety net


@api.remote
def _run_read(task: Callable[[], Block]) -> Block:
    return task()


@api.remote(num_returns="streaming")
def _run_read_stream(task: Callable[[], Any]):
    """Streaming read: a task producing SEVERAL blocks (generator) seals
    each into the object plane as it materializes, so downstream stages
    start on block 0 while the read still runs (reference: Data read
    tasks consumed as core-worker streaming generators). Single-block
    tasks stream their one block."""
    out = task()
    if hasattr(out, "__next__"):
        yield from out
    else:
        yield out


@api.remote
def _run_stage(stage: Callable[[Block], Block], block: Block) -> Block:
    return stage(block)


@api.remote(num_cpus=0, max_restarts=3, max_task_retries=3)
class _MapPoolWorker:
    """One stateful worker of an actor-pool map stage: a callable-class
    fn constructs ONCE here, then transforms every block this worker is
    assigned (reference: ActorPoolMapOperator's per-actor UDF init).

    A deliberate difference: the reference pins these workers in-process;
    here they follow the runtime's actor policy, so under `actor_processes`
    each is an actor process (a crash kills one worker, which restarts
    and retries its block). A transform that needs the card belongs in the
    driver's process: run it in thread mode or after the pipeline."""

    def __init__(self, op_blob: bytes):
        import dataclasses
        import inspect

        import cloudpickle

        from .logical import compile_stage

        op = cloudpickle.loads(op_blob)
        if inspect.isclass(op.fn):
            op = dataclasses.replace(op, fn=op.fn())  # per-actor state
        self._stage = compile_stage([op])

    def apply(self, block: Block) -> Block:
        return self._stage(block)

    def ping(self) -> bool:
        """FIFO barrier: completes only after all prior applies."""
        return True


@api.remote
def _concat_blocks(*blocks: Block) -> Block:
    return BlockAccessor.concat(list(blocks))


@api.remote
def _split_block(block: Block, n: int):
    acc = BlockAccessor(block)
    rows = acc.num_rows()
    cuts = [rows * i // n for i in range(n + 1)]
    return tuple(acc.slice(cuts[i], cuts[i + 1]) for i in range(n))


@api.remote
def _sort_block(block: Block, key: Optional[str], descending: bool) -> Block:
    acc = BlockAccessor(block)
    if acc.is_tabular:
        if key is None:
            key = next(iter(block))  # default: first column
        order = np.argsort(np.asarray(block[key]), kind="stable")
        if descending:
            order = order[::-1]
        return {k: np.asarray(v)[order] for k, v in block.items()}
    items = sorted(block, reverse=descending)
    return items


@api.remote
def _partial_agg(block: Block, key, fns):
    return partial_aggregate(block, key, list(fns))


@api.remote
def _combine_agg(key, fns, *partials):
    return finalize(merge_partials(list(partials), list(fns)), key, list(fns))


@api.remote
def _zip_blocks(left: Block, right: Block) -> Block:
    la, ra = BlockAccessor(left), BlockAccessor(right)
    if la.num_rows() != ra.num_rows():
        raise ValueError(
            f"zip row mismatch: {la.num_rows()} vs {ra.num_rows()}"
        )
    if not (la.is_tabular and ra.is_tabular):
        raise TypeError("zip needs tabular blocks on both sides")
    out = {k: np.asarray(v) for k, v in left.items()}
    for k, v in right.items():
        # reference disambiguation, probing for a free suffix: "x_1" can
        # itself exist on the left (or from an earlier rename)
        name, i = k, 0
        while name in out:
            i += 1
            name = f"{k}_{i}"
        out[name] = np.asarray(v)
    return out


@api.remote
def _block_meta(block: Block):
    m = BlockAccessor(block).metadata()
    return (m.num_rows, m.size_bytes, m.schema)


def _windowed_gen(read_tasks: List[Callable], max_in_flight: int,
                  preserve_order: bool = True,
                  tenant: str = "") -> Iterator[Any]:
    """Submit read tasks with a bounded window; yield block REFS. Tasks
    marked ``.streaming`` (generators of blocks) run as streaming-
    generator tasks — their refs surface while the task still executes;
    plain tasks take the ordinary path (worker-process pool, retries).

    Ordered (default): task 0's blocks, then task 1's, ... — a slow task
    0 head-of-line blocks the stream even while peers have sealed output.
    preserve_order=False yields blocks in COMPLETION order across every
    in-flight task: a sealed block from any task surfaces immediately."""
    from ..core.core_worker import ObjectRefGenerator

    def submit(t):
        if getattr(t, "streaming", False):
            return _run_read_stream.remote(t)  # ObjectRefGenerator
        return [_run_read.remote(t)]

    pending: List[Any] = []
    idx = 0
    if preserve_order:
        while idx < len(read_tasks) or pending:
            while idx < len(read_tasks) and len(pending) < max_in_flight:
                pending.append(submit(read_tasks[idx]))
                idx += 1
            yield from pending.pop(0)
        return

    # out-of-order: multiplex every in-flight source; streaming sources
    # are drained via the non-blocking try_next, plain single-ref tasks
    # surface once api.wait reports them done
    gens: List[Any] = []
    plain: List[Any] = []
    while idx < len(read_tasks) or gens or plain:
        while idx < len(read_tasks) and len(gens) + len(plain) < max_in_flight:
            src = submit(read_tasks[idx])
            idx += 1
            if isinstance(src, list):
                plain.extend(src)
            else:
                gens.append(src)
        progressed = False
        for g in list(gens):
            while True:
                ref = g.try_next()
                if ref is None:
                    break
                if ref is ObjectRefGenerator.DONE:
                    gens.remove(g)
                    break
                progressed = True
                yield ref
        if plain:
            done, plain = api.wait(plain, num_returns=len(plain), timeout=0)
            for ref in done:
                progressed = True
                yield ref
        if not progressed and (gens or plain):
            # nothing sealed anywhere: the read genuinely is the
            # bottleneck right now — account the stall, then nap briefly
            # (generator seals have no waitable handle; plain refs do)
            t0 = time.perf_counter()
            if plain:
                api.wait(plain, num_returns=1, timeout=0.02)
            else:
                time.sleep(0.002)
            _m_stall.inc(time.perf_counter() - t0,
                         tags={"stage": "read", "tenant": tenant})


class StreamingExecutor:
    """Executes a LogicalPlan, yielding block ObjectRefs.

    preserve_order=True (default) keeps the reference's strict block
    order — byte-identical streams for existing consumers. Training-
    ingest callers that only need the epoch's multiset opt into
    preserve_order=False: every streaming stage (read, task map, actor-
    pool map) then yields blocks in COMPLETION order, so one slow block
    can't head-of-line block work that already finished."""

    def __init__(self, plan: LogicalPlan, max_in_flight: int = DEFAULT_MAX_IN_FLIGHT,
                 max_in_flight_bytes: int = DEFAULT_MAX_IN_FLIGHT_BYTES,
                 preserve_order: bool = True,
                 tenant: str = "",
                 _protected: Optional[set] = None):
        self.plan = plan
        self.max_in_flight = max_in_flight
        self.max_in_flight_bytes = max_in_flight_bytes
        self.preserve_order = preserve_order
        # tenant tag carried on every stall sample this execution emits
        # (multi-tenant ingest: per-tenant demand must be scrapeable)
        self.tenant = tenant
        # ObjectIDs the PLAN owns (InputData blocks, incl. Union sub-plans):
        # re-iteration resolves them again, so eager frees (shuffle rounds)
        # must never touch them. Shared with sub-executors.
        self._protected: set = set() if _protected is None else _protected

    def execute(self) -> Iterator[Any]:
        segments = fuse(self.plan)
        source = segments[0]

        if isinstance(source, Read):
            # generator-valued read tasks stream their blocks out
            # incrementally; plain tasks go through the ordinary task
            # path (worker-process pool, retries)
            stream: Iterator[Any] = _windowed_gen(
                source.read_tasks, self.max_in_flight, self.preserve_order,
                tenant=self.tenant)
        elif isinstance(source, InputData):
            self._protected.update(r.object_id for r in source.blocks)
            stream = iter(list(source.blocks))
        elif isinstance(source, Union):
            def gen_union():
                for plan in source.plans:
                    yield from StreamingExecutor(
                        plan, self.max_in_flight,
                        self.max_in_flight_bytes,
                        preserve_order=self.preserve_order,
                        tenant=self.tenant,
                        _protected=self._protected).execute()
            stream = gen_union()
        else:
            raise TypeError(f"bad source {source}")

        for seg in segments[1:]:
            if isinstance(seg, MapBatches):  # actor-pool compute stage
                stream = self._map_stream_actors(stream, seg)
            elif callable(seg):
                stream = self._map_stream(stream, seg)
            elif isinstance(seg, RandomShuffle):
                stream = self._shuffle(stream, seg.seed)
            elif isinstance(seg, Repartition):
                stream = self._repartition(stream, seg.num_blocks)
            elif isinstance(seg, Sort):
                stream = self._sort(stream, seg)
            elif isinstance(seg, Limit):
                stream = self._limit(stream, seg.limit)
            elif isinstance(seg, Aggregate):
                stream = self._aggregate(stream, seg)
            elif isinstance(seg, Zip):
                stream = self._zip(stream, seg)
            else:
                raise TypeError(f"bad segment {seg}")
        return stream

    # -- streaming global limit ---------------------------------------------

    def _limit(self, upstream: Iterator[Any], n: int) -> Iterator[Any]:
        """Global row limit: stream blocks, truncate the boundary block, and
        stop consuming upstream (lazy generators — no further submission).
        Row-count fetches are pipelined over a bounded window so the stream
        isn't serialized on one metadata round-trip per block."""

        def gen():
            remaining = n
            window: List[Any] = []  # (block_ref, meta_ref) in submission order
            it = iter(upstream)
            exhausted = False
            while remaining > 0:
                while not exhausted and len(window) < self.max_in_flight:
                    try:
                        ref = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    window.append((ref, _block_meta.remote(ref)))
                if not window:
                    break
                ref, meta_ref = window.pop(0)
                rows = api.get(meta_ref)[0]
                if rows <= remaining:
                    remaining -= rows
                    yield ref
                else:
                    yield _run_stage.remote(_take_rows(remaining), ref)
                    break

        return gen()

    # -- pipelined 1:1 stage ------------------------------------------------

    def _map_stream(self, upstream: Iterator[Any], stage) -> Iterator[Any]:
        def gen():
            win = _StageWindow(self.max_in_flight_bytes,
                               name=getattr(stage, "__name__", "map"))
            exhausted = False
            it = iter(upstream)
            while not exhausted or len(win):
                while (
                    not exhausted
                    and len(win) < self.max_in_flight
                    # memory backpressure: parked + projected in-flight
                    # output bytes must stay under the stage budget
                    and win.may_submit()
                ):
                    try:
                        ref = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    win.add(_run_stage.remote(stage, ref))
                if len(win):
                    yield win.pop(self.preserve_order)
        return gen()

    def _map_stream_actors(self, upstream: Iterator[Any], op) -> Iterator[Any]:
        """map_batches(compute="actors"): the stage runs on a pool of
        stateful workers — a callable-class fn instantiates ONCE per
        worker (model loads amortize across its blocks). Blocks dispatch
        to the worker with the fewest incomplete applies (least-
        outstanding), so a slow worker can't accumulate a private queue
        while its peers idle; ordered output unless preserve_order=False;
        same count + byte backpressure as the task path. (reference:
        execution/operators/actor_pool_map_operator.py)"""
        import cloudpickle

        op_blob = cloudpickle.dumps(op)

        def gen():
            workers = [
                _MapPoolWorker.remote(op_blob)
                for _ in range(max(1, op.concurrency))
            ]
            win = _StageWindow(self.max_in_flight_bytes, name=op.name)
            try:
                exhausted = False
                it = iter(upstream)
                while not exhausted or len(win):
                    while (
                        not exhausted
                        and len(win) < self.max_in_flight
                        and win.may_submit()
                    ):
                        try:
                            ref = next(it)
                        except StopIteration:
                            exhausted = True
                            break
                        wi = min(range(len(workers)),
                                 key=lambda j: win.outstanding.get(j, 0))
                        win.add(workers[wi].apply.remote(ref), owner=wi)
                    if len(win):
                        yield win.pop(self.preserve_order)
            finally:
                # FIFO ping barrier: yielded-but-unfinished applies must
                # complete before their worker dies
                try:
                    api.get([w.ping.remote() for w in workers], timeout=300)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
                for w in workers:
                    try:
                        api.kill(w)
                    except Exception:  # noqa: BLE001
                        pass
        return gen()

    # -- all-to-all barriers -------------------------------------------------

    def _shuffle(self, upstream: Iterator[Any], seed: Optional[int]) -> Iterator[Any]:
        """Staged push shuffle with bounded intermediates (reference:
        `data/_internal/planner/push_based_shuffle.py` map+merge rounds).

        Rounds of W source blocks at a time: each round splits its blocks
        n-ways, MERGES the pieces into per-partition running partials, and
        then EXPLICITLY frees the round's sources and pieces (api._free —
        lineage records would otherwise pin them until the last output is
        consumed, making peak residency ~everything). Peak is therefore
        ~1x the dataset (the partials) plus one round's pieces (W * avg
        block, sized to the stage byte budget). The incremental merge
        re-copies each partition n/W times — the classic push-shuffle
        trade of copies for bounded memory."""
        refs = list(upstream)
        n = len(refs)
        rng = random.Random(seed)
        if n <= 1:
            out = refs
        else:
            partials: List[Optional[Any]] = [None] * n
            window = max(1, min(self.max_in_flight, n))
            i = 0
            avg_block: Optional[float] = None
            while i < n:
                if avg_block:
                    # size each round to the stage budget: a round's pieces
                    # total ~W blocks of source bytes
                    window = max(1, min(
                        self.max_in_flight,
                        int(self.max_in_flight_bytes // max(avg_block, 1.0)),
                    ))
                round_refs = refs[i:i + window]
                # pin sizes BEFORE the sources are freed
                sizes = [_block_meta.remote(r) for r in round_refs]
                split_refs = [
                    _split_block.options(num_returns=n).remote(r, n)
                    for r in round_refs
                ]
                old_partials: List[Any] = []
                for j in range(n):
                    pieces = [s[j] for s in split_refs]
                    rng.shuffle(pieces)
                    if partials[j] is not None:
                        old_partials.append(partials[j])
                        pieces = [partials[j], *pieces]
                    partials[j] = _concat_blocks.remote(*pieces)
                # barrier per round: merges must finish before the next
                # round's pieces land, or rounds pile up unboundedly
                api.wait([p for p in partials if p is not None],
                         num_returns=n, timeout=None)
                metas = api.get(sizes)
                # consumed for good: splits are done (sources) and merges
                # are done (pieces, superseded partials) — free now, or
                # lineage parks them until the final consumer
                api._free([s[j] for s in split_refs for j in range(n)])
                api._free(old_partials)
                # plan-owned blocks (InputData, possibly through a
                # pass-through stage like Limit) must survive re-iteration;
                # anything this execution produced is consumed for good
                api._free([r for r in round_refs
                           if r.object_id not in self._protected])
                for k in range(len(round_refs)):
                    refs[i + k] = None
                avg_block = sum(m[1] for m in metas) / max(len(metas), 1)
                i += len(round_refs)
            out = [p for p in partials if p is not None]
            rng.shuffle(out)

        def gen():
            # local row-permute each output block, seeded deterministically
            for i, ref in enumerate(out):
                s = None if seed is None else seed + i
                yield _run_stage.remote(_permute_rows(s), ref)
                out[i] = None  # consumed: the driver drops its ref
        return gen()

    def _repartition(self, upstream: Iterator[Any], num_blocks: int) -> Iterator[Any]:
        refs = list(upstream)
        if num_blocks <= 0:
            num_blocks = max(len(refs), 1)
        merged = _concat_blocks.remote(*refs)
        if num_blocks == 1:
            return iter([merged])
        parts = _split_block.options(num_returns=num_blocks).remote(merged, num_blocks)
        return iter(list(parts))

    def _sort(self, upstream: Iterator[Any], op: Sort) -> Iterator[Any]:
        refs = list(upstream)
        merged = _concat_blocks.remote(*refs)
        return iter([_sort_block.remote(merged, op.key, op.descending)])

    def _aggregate(self, upstream: Iterator[Any], op: Aggregate) -> Iterator[Any]:
        """Tree: per-block partial states (parallel) -> one combine task."""
        fns = tuple(op.fns)
        partials = [_partial_agg.remote(ref, op.key, fns) for ref in upstream]
        if not partials:
            return iter([])
        return iter([_combine_agg.remote(op.key, fns, *partials)])

    def _zip(self, upstream: Iterator[Any], op: Zip) -> Iterator[Any]:
        """Positional zip: both sides collapse to one block each, then a
        column merge (reference zips aligned block pairs; a single pair is
        the faithful degenerate case for in-memory scale)."""
        left = _concat_blocks.remote(*list(upstream))
        right_refs = list(
            StreamingExecutor(op.other, self.max_in_flight,
                              self.max_in_flight_bytes).execute()
        )
        right = _concat_blocks.remote(*right_refs)
        return iter([_zip_blocks.remote(left, right)])


def _take_rows(n: int):
    def take(block: Block) -> Block:
        return BlockAccessor(block).take(n)

    take.__name__ = f"take_{n}"
    return take


def _permute_rows(seed: Optional[int]):
    def permute(block: Block) -> Block:
        acc = BlockAccessor(block)
        n = acc.num_rows()
        rng = np.random.default_rng(seed)
        order = rng.permutation(n)
        if acc.is_tabular:
            return {k: np.asarray(v)[order] for k, v in block.items()}
        return [block[i] for i in order]

    permute.__name__ = "permute_rows"
    return permute
