"""Logical plan + optimizer (reference: `python/ray/data/_internal/logical/`).

Operators form a linear chain (reads are sources). The optimizer fuses
adjacent one-to-one operators into single stages so each block flows
through one remote task per fused stage — the reference's read+map fusion
rule generalized.

The port's copy of ray_tpu/data/logical.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

from .block import Block, BlockAccessor


@dataclasses.dataclass
class Operator:
    name: str

    def is_one_to_one(self) -> bool:
        # Limit is NOT one-to-one: fusing it would apply the limit to each
        # block independently (N blocks -> up to N*limit rows). The executor
        # treats it as a streaming barrier that truncates globally.
        return isinstance(self, (MapBatches, MapRows, Filter, FlatMap))


@dataclasses.dataclass
class Read(Operator):
    read_tasks: Sequence[Callable[[], Block]]
    num_rows_estimate: Optional[int] = None


@dataclasses.dataclass
class InputData(Operator):
    blocks: List[Any]  # ObjectRefs or materialized blocks


@dataclasses.dataclass
class MapBatches(Operator):
    fn: Callable[[Any], Any]
    batch_size: Optional[int] = None
    batch_format: str = "numpy"
    fn_kwargs: dict = dataclasses.field(default_factory=dict)
    # "tasks" (default) or "actors": actor compute runs the stage on a
    # pool of stateful workers — REQUIRED when fn is a callable class
    # (instantiated once per actor; reference: ActorPoolMapOperator)
    compute: str = "tasks"
    concurrency: int = 2


@dataclasses.dataclass
class MapRows(Operator):
    fn: Callable[[Any], Any]


@dataclasses.dataclass
class Filter(Operator):
    fn: Callable[[Any], bool]


@dataclasses.dataclass
class FlatMap(Operator):
    fn: Callable[[Any], List[Any]]


@dataclasses.dataclass
class Limit(Operator):
    limit: int


@dataclasses.dataclass
class RandomShuffle(Operator):
    seed: Optional[int] = None


@dataclasses.dataclass
class Repartition(Operator):
    num_blocks: int = 0


@dataclasses.dataclass
class Sort(Operator):
    key: Optional[str] = None
    descending: bool = False


@dataclasses.dataclass
class Aggregate(Operator):
    """Groupby/global aggregation barrier (reference: `Dataset.groupby` +
    `aggregate.py`); key=None aggregates the whole dataset to one row."""

    key: Optional[str] = None
    fns: Sequence[Any] = ()


@dataclasses.dataclass
class Union(Operator):
    """Source combinator: streams this plan's blocks, then each other
    plan's (reference: `Dataset.union`)."""

    plans: Sequence["LogicalPlan"] = ()


@dataclasses.dataclass
class Zip(Operator):
    """Barrier: column-wise join with another dataset by row position
    (reference: `Dataset.zip`)."""

    other: "LogicalPlan" = None


@dataclasses.dataclass
class LogicalPlan:
    operators: List[Operator] = dataclasses.field(default_factory=list)

    def with_op(self, op: Operator) -> "LogicalPlan":
        return LogicalPlan(self.operators + [op])

    def source(self) -> Operator:
        return self.operators[0]


# ---------------------------------------------------------------------------
# Block-level transform compilation
# ---------------------------------------------------------------------------


def _apply_map_batches(op: MapBatches, block: Block) -> Block:
    acc = BlockAccessor(block)
    n = acc.num_rows()
    bs = op.batch_size or n
    outs = []
    for start in range(0, max(n, 1), max(bs, 1)):
        if start >= n:
            break
        piece = acc.slice(start, min(start + bs, n))
        batch = BlockAccessor.batch_of(piece, op.batch_format)
        result = op.fn(batch, **op.fn_kwargs)
        outs.append(BlockAccessor.normalize(result))
    return BlockAccessor.concat(outs)


def _apply_rows(op: Operator, block: Block) -> Block:
    acc = BlockAccessor(block)
    rows = list(acc.iter_rows())
    if isinstance(op, MapRows):
        return BlockAccessor.from_rows([op.fn(r) for r in rows])
    if isinstance(op, Filter):
        return BlockAccessor.from_rows([r for r in rows if op.fn(r)])
    if isinstance(op, FlatMap):
        out: List[Any] = []
        for r in rows:
            out.extend(op.fn(r))
        return BlockAccessor.from_rows(out)
    raise TypeError(op)


def compile_stage(ops: List[Operator]) -> Callable[[Block], Block]:
    """Fuse a run of one-to-one operators into a single block transform."""

    def stage(block: Block) -> Block:
        for op in ops:
            if isinstance(op, MapBatches):
                block = _apply_map_batches(op, block)
            elif isinstance(op, (MapRows, Filter, FlatMap)):
                block = _apply_rows(op, block)
            else:
                raise TypeError(f"not a 1:1 op: {op}")
        return block

    stage.__name__ = "+".join(o.name for o in ops) or "identity"
    return stage


def fuse(plan: LogicalPlan) -> List[Any]:
    """Plan -> [source, stage_or_barrier, ...] where stages are fused
    callables and barriers are the original all-to-all operators."""
    source = plan.operators[0]
    segments: List[Any] = [source]
    run: List[Operator] = []
    for op in plan.operators[1:]:
        needs_actor_stage = isinstance(op, MapBatches) and op.compute == "actors"
        if op.is_one_to_one() and not needs_actor_stage:
            run.append(op)
        else:
            if run:
                segments.append(compile_stage(run))
                run = []
            segments.append(op)
    if run:
        segments.append(compile_stage(run))
    return segments
