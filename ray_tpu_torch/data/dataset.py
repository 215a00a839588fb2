"""Dataset: the lazy, streaming distributed dataset facade.

Reference: `python/ray/data/dataset.py :: Dataset` — same surface
(map_batches / random_shuffle / iter_batches / streaming_split / ...),
executed via the streaming executor over remote tasks.

The port's copy of ray_tpu/data/dataset.py.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from .. import api
from .block import BlockAccessor, BlockMetadata
from .executor import StreamingExecutor
from .iterator import DataIterator
from .aggregate import AggregateFn, Count, Max, Mean, Min, Std, Sum
from .logical import (
    Aggregate,
    Filter,
    FlatMap,
    InputData,
    Limit,
    LogicalPlan,
    MapBatches,
    MapRows,
    RandomShuffle,
    Read,
    Repartition,
    Sort,
    Union,
    Zip,
)


class Dataset:
    def __init__(self, plan: LogicalPlan):
        self._plan = plan

    # -- transforms (lazy) ---------------------------------------------------

    def map_batches(
        self,
        fn: Callable[[Any], Any],
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        fn_kwargs: Optional[dict] = None,
        compute: Optional[str] = None,
        concurrency: int = 2,
        **_ignored,
    ) -> "Dataset":
        """compute="actors": the transform runs on a pool of `concurrency`
        stateful workers; a callable CLASS fn is instantiated once per
        worker (per-actor state, e.g. a loaded model — reference:
        ActorPoolMapOperator). Default "tasks" runs stateless."""
        import inspect

        if compute is None:
            compute = "actors" if inspect.isclass(fn) else "tasks"
        if compute not in ("tasks", "actors"):
            raise ValueError(
                f"compute must be 'tasks' or 'actors', got {compute!r}")
        if inspect.isclass(fn) and compute != "actors":
            raise ValueError(
                "a callable-class fn needs map_batches(compute='actors')")
        return Dataset(self._plan.with_op(
            MapBatches("map_batches", fn, batch_size, batch_format,
                       fn_kwargs or {}, compute=compute,
                       concurrency=concurrency)
        ))

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        return Dataset(self._plan.with_op(MapRows("map", fn)))

    def filter(self, fn: Callable[[Any], bool]) -> "Dataset":
        return Dataset(self._plan.with_op(Filter("filter", fn)))

    def flat_map(self, fn: Callable[[Any], List[Any]]) -> "Dataset":
        return Dataset(self._plan.with_op(FlatMap("flat_map", fn)))

    def limit(self, n: int) -> "Dataset":
        return Dataset(self._plan.with_op(Limit("limit", n)))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return Dataset(self._plan.with_op(RandomShuffle("random_shuffle", seed)))

    def repartition(self, num_blocks: int) -> "Dataset":
        return Dataset(self._plan.with_op(Repartition("repartition", num_blocks)))

    def union(self, *others: "Dataset") -> "Dataset":
        """Lazy concatenation: streams this dataset's blocks, then each
        other's (reference: `Dataset.union`)."""
        plans = [self._plan] + [o._plan for o in others]
        return Dataset(LogicalPlan([Union("union", plans=plans)]))

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise positional join; duplicate columns from `other` get
        a `_1` suffix (reference: `Dataset.zip`)."""
        return Dataset(self._plan.with_op(Zip("zip", other=other._plan)))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def aggregate(self, *fns: AggregateFn) -> Dict[str, Any]:
        """Global aggregation -> {out_name: value} (reference:
        `Dataset.aggregate`)."""
        ds = Dataset(self._plan.with_op(Aggregate("aggregate", key=None, fns=fns)))
        rows = ds.take_all()
        if not rows:
            return {}
        return {k: v for k, v in rows[0].items()}

    def sum(self, on: str):
        return self.aggregate(Sum(on)).get(f"sum({on})")

    def min(self, on: str):
        return self.aggregate(Min(on)).get(f"min({on})")

    def max(self, on: str):
        return self.aggregate(Max(on)).get(f"max({on})")

    def mean(self, on: str):
        return self.aggregate(Mean(on)).get(f"mean({on})")

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(Std(on, ddof)).get(f"std({on})")

    def sort(self, key: Optional[str] = None, descending: bool = False) -> "Dataset":
        return Dataset(self._plan.with_op(Sort("sort", key, descending)))

    # -- execution -----------------------------------------------------------

    def _stream_refs(self, preserve_order: bool = True,
                     tenant: str = "") -> Iterator[Any]:
        return StreamingExecutor(
            self._plan, preserve_order=preserve_order,
            tenant=tenant).execute()

    def iterator(self, *, preserve_order: bool = True,
                 tenant: str = "") -> DataIterator:
        """preserve_order=False lets every streaming stage yield blocks in
        completion order (no head-of-line blocking on a slow block) — the
        epoch's row multiset is unchanged but the order is not
        deterministic. Default stays strictly ordered. `tenant` tags the
        execution's stall metrics for per-tenant demand accounting."""
        return DataIterator(
            lambda: self._stream_refs(preserve_order=preserve_order,
                                      tenant=tenant),
            tenant=tenant)

    def iter_batches(self, *, preserve_order: bool = True, **kw) -> Iterator[Any]:
        return self.iterator(preserve_order=preserve_order).iter_batches(**kw)

    def iter_rows(self) -> Iterator[Any]:
        return self.iterator().iter_rows()

    def iter_torch_batches(self, *, preserve_order: bool = True, **kw) -> Iterator[Any]:
        return self.iterator(
            preserve_order=preserve_order).iter_torch_batches(**kw)

    def iter_device_batches(self, *, preserve_order: bool = True, **kw) -> Iterator[Any]:
        return self.iterator(
            preserve_order=preserve_order).iter_device_batches(**kw)

    def take(self, n: int = 20) -> List[Any]:
        if n <= 0:
            return []
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    # -- whole-dataset converters (reference: Dataset.to_pandas /
    # to_arrow_refs / to_numpy_refs — driver-side materialization for
    # datasets known to fit in memory) --------------------------------

    def to_pandas(self, limit: Optional[int] = None):
        """Materialize as one pandas DataFrame (caps at `limit` rows when
        given). Small-result ergonomics, not a data path: blocks pull to
        the driver."""
        import pandas as pd

        rows = self.take(limit) if limit is not None else self.take_all()
        return pd.DataFrame(rows)

    def to_arrow(self, limit: Optional[int] = None):
        """Materialize as one pyarrow Table (via pandas for mixed rows)."""
        import pyarrow as pa

        return pa.Table.from_pandas(self.to_pandas(limit),
                                    preserve_index=False)

    def to_numpy(self, column: Optional[str] = None):
        """Materialize as {column: np.ndarray} (or one array for a single
        named column)."""
        import numpy as np

        rows = self.take_all()
        if not rows:
            return np.array([]) if column else {}
        if not isinstance(rows[0], dict):
            if column is not None:
                raise ValueError(
                    f"column={column!r} requested but rows are plain values"
                )
            return np.asarray(rows)
        cols = {k: np.asarray([r[k] for r in rows]) for k in rows[0]}
        return cols[column] if column is not None else cols

    def count(self) -> int:
        # metadata travels to the driver, blocks stay put
        from .executor import _block_meta

        refs = [_block_meta.remote(r) for r in self._stream_refs()]
        return sum(m[0] for m in api.get(refs))

    def schema(self) -> Optional[Dict[str, str]]:
        from .executor import _block_meta

        for ref in self._stream_refs():
            return api.get(_block_meta.remote(ref))[2]
        return None

    def materialize(self) -> "Dataset":
        refs = list(self._stream_refs())
        return Dataset(LogicalPlan([InputData("input", list(refs))]))

    def stats(self) -> Dict[str, Any]:
        from .executor import _block_meta

        metas = api.get([_block_meta.remote(r) for r in self._stream_refs()])
        return {
            "num_blocks": len(metas),
            "num_rows": sum(m[0] for m in metas),
            "size_bytes": sum(m[1] for m in metas),
        }

    # -- splitting (training ingest) ----------------------------------------

    def streaming_split(self, n: int, *, equal: bool = False) -> List[DataIterator]:
        """N iterators over disjoint block shards (round-robin).

        equal=True row-balances first (repartition to n row-equal blocks) so
        every SPMD rank sees the same batch count — required for gang
        training, where an uneven iterator desyncs collectives.
        """
        src = self.repartition(n) if equal else self
        materialized = src.materialize()

        def make_factory(i: int):
            def factory():
                refs = list(materialized._stream_refs())
                return iter(refs[i::n])
            return factory

        return [DataIterator(make_factory(i)) for i in range(n)]

    def split(self, n: int) -> List["Dataset"]:
        refs = list(self._stream_refs())
        return [
            Dataset(LogicalPlan([InputData("input", refs[i::n])])) for i in range(n)
        ]

    # -- writes --------------------------------------------------------------

    def write_parquet(self, path: str) -> None:
        import os

        import pyarrow as pa
        import pyarrow.parquet as pq

        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._stream_refs()):
            block = api.get(ref)
            table = BlockAccessor.batch_of(block, "pyarrow")
            pq.write_table(table, os.path.join(path, f"part-{i:05d}.parquet"))

    def write_csv(self, path: str) -> None:
        import os

        import pandas as pd  # noqa: F401

        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._stream_refs()):
            df = BlockAccessor.batch_of(api.get(ref), "pandas")
            df.to_csv(os.path.join(path, f"part-{i:05d}.csv"), index=False)

    def write_json(self, path: str) -> None:
        """JSONL, one file per block (reference: `Dataset.write_json`)."""
        import json
        import os

        os.makedirs(path, exist_ok=True)

        def plain(v):
            if isinstance(v, np.generic):
                return v.item()
            if isinstance(v, np.ndarray):
                return v.tolist()
            return v

        for i, ref in enumerate(self._stream_refs()):
            acc = BlockAccessor(api.get(ref))
            with open(os.path.join(path, f"part-{i:05d}.json"), "w") as f:
                for row in acc.iter_rows():
                    if isinstance(row, dict):
                        row = {k: plain(v) for k, v in row.items()}
                    f.write(json.dumps(row) + "\n")

    def __repr__(self):
        ops = " -> ".join(op.name for op in self._plan.operators)
        return f"Dataset({ops})"


class GroupedData:
    """Keyed aggregation surface (reference: `grouped_data.py ::
    GroupedData`). Result is a Dataset with one row per group, sorted by
    the group key."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def aggregate(self, *fns: AggregateFn) -> Dataset:
        return Dataset(
            self._ds._plan.with_op(Aggregate("groupby", key=self._key, fns=fns))
        )

    def count(self) -> Dataset:
        return self.aggregate(Count())

    def sum(self, on: str) -> Dataset:
        return self.aggregate(Sum(on))

    def min(self, on: str) -> Dataset:
        return self.aggregate(Min(on))

    def max(self, on: str) -> Dataset:
        return self.aggregate(Max(on))

    def mean(self, on: str) -> Dataset:
        return self.aggregate(Mean(on))

    def std(self, on: str, ddof: int = 1) -> Dataset:
        return self.aggregate(Std(on, ddof))

    def map_groups(self, fn: Callable[[Any], Any]) -> Dataset:
        """Apply fn to each group's batch (columnar dict) and concat the
        results (reference: `GroupedData.map_groups`). Runs after a sort
        barrier so each group is contiguous."""
        key = self._key

        def apply(batch):
            keys = np.asarray(batch[key])
            uniq = np.unique(keys)
            outs = []
            for g in uniq:
                idx = np.nonzero(keys == g)[0]
                piece = {k: np.asarray(v)[idx] for k, v in batch.items()}
                outs.append(BlockAccessor.normalize(fn(piece)))
            return BlockAccessor.concat(outs)

        sorted_ds = self._ds.sort(key)
        return sorted_ds.map_batches(apply, batch_size=None)
