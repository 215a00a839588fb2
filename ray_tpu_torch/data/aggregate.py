"""Aggregations (reference: `python/ray/data/aggregate.py` — AggregateFn,
Count/Sum/Min/Max/Mean/Std + `Dataset.groupby().aggregate()`).

Distributed combine pattern: each block produces a partial state per group
(vectorized with np.unique), partials merge associatively, finalize turns
states into output columns. Mean/Std carry (n, s, s2) moments so the merge
is exact regardless of block boundaries.

The port's copy of ray_tpu/data/aggregate.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .block import Block, BlockAccessor

_KINDS = ("count", "sum", "min", "max", "mean", "std")


@dataclasses.dataclass(frozen=True)
class AggregateFn:
    kind: str            # one of _KINDS
    on: Optional[str]    # column; None only for count
    alias: Optional[str] = None

    @property
    def out_name(self) -> str:
        if self.alias:
            return self.alias
        return "count()" if self.kind == "count" else f"{self.kind}({self.on})"


def Count() -> AggregateFn:  # noqa: N802 — reference-shaped constructors
    return AggregateFn("count", None)


def Sum(on: str) -> AggregateFn:  # noqa: N802
    return AggregateFn("sum", on)


def Min(on: str) -> AggregateFn:  # noqa: N802
    return AggregateFn("min", on)


def Max(on: str) -> AggregateFn:  # noqa: N802
    return AggregateFn("max", on)


def Mean(on: str) -> AggregateFn:  # noqa: N802
    return AggregateFn("mean", on)


def Std(on: str, ddof: int = 1) -> AggregateFn:  # noqa: N802
    fn = AggregateFn("std", on)
    object.__setattr__(fn, "_ddof", ddof)
    return fn


def _moments(vals: np.ndarray) -> Tuple[float, float, float]:
    v = np.asarray(vals, np.float64)
    return (float(len(v)), float(v.sum()), float((v * v).sum()))


def _partial_one(fn: AggregateFn, vals: np.ndarray) -> Any:
    if fn.kind == "count":
        return float(len(vals))
    if fn.kind == "sum":
        return float(np.asarray(vals, np.float64).sum())
    if fn.kind == "min":
        return float(np.min(vals))
    if fn.kind == "max":
        return float(np.max(vals))
    # mean/std share moment states
    return _moments(vals)


def _merge_one(fn: AggregateFn, a: Any, b: Any) -> Any:
    if fn.kind in ("count", "sum"):
        return a + b
    if fn.kind == "min":
        return min(a, b)
    if fn.kind == "max":
        return max(a, b)
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _finalize_one(fn: AggregateFn, state: Any) -> float:
    if fn.kind in ("count", "sum", "min", "max"):
        return state
    n, s, s2 = state
    if fn.kind == "mean":
        return s / n if n else float("nan")
    ddof = getattr(fn, "_ddof", 1)
    if n - ddof <= 0:
        return float("nan")
    var = max(0.0, (s2 - s * s / n) / (n - ddof))
    return float(np.sqrt(var))


# Partial state for a block: {group_key_or_None: [state_per_agg]}
Partial = Dict[Any, List[Any]]


def partial_aggregate(block: Block, key: Optional[str],
                      fns: List[AggregateFn]) -> Partial:
    acc = BlockAccessor(block)
    if acc.num_rows() == 0:
        return {}
    if not acc.is_tabular:
        raise TypeError("aggregate needs tabular (dict-column) blocks")
    if key is None:
        row_sets: List[Tuple[Any, np.ndarray]] = [(None, None)]
    else:
        keys = np.asarray(block[key])
        uniq, inv = np.unique(keys, return_inverse=True)
        row_sets = [(uniq[g].item() if hasattr(uniq[g], "item") else uniq[g],
                     np.nonzero(inv == g)[0]) for g in range(len(uniq))]
    out: Partial = {}
    for gkey, idx in row_sets:
        states = []
        for fn in fns:
            if fn.kind == "count":
                n = acc.num_rows() if idx is None else len(idx)
                states.append(float(n))
                continue
            col = np.asarray(block[fn.on])
            vals = col if idx is None else col[idx]
            states.append(_partial_one(fn, vals))
        out[gkey] = states
    return out


def merge_partials(parts: List[Partial], fns: List[AggregateFn]) -> Partial:
    out: Partial = {}
    for part in parts:
        for gkey, states in part.items():
            if gkey not in out:
                out[gkey] = list(states)
            else:
                out[gkey] = [
                    _merge_one(fn, a, b)
                    for fn, a, b in zip(fns, out[gkey], states)
                ]
    return out


def finalize(merged: Partial, key: Optional[str],
             fns: List[AggregateFn]) -> Block:
    """Merged states -> one output block (sorted by group key)."""
    if key is None:
        states = merged.get(None, None)
        if states is None:
            return {fn.out_name: np.asarray([]) for fn in fns}
        return {
            fn.out_name: np.asarray([_finalize_one(fn, s)])
            for fn, s in zip(fns, states)
        }
    gkeys = sorted(merged.keys())
    cols: Dict[str, np.ndarray] = {key: np.asarray(gkeys)}
    for i, fn in enumerate(fns):
        cols[fn.out_name] = np.asarray(
            [_finalize_one(fn, merged[g][i]) for g in gkeys]
        )
    return cols
