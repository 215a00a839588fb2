"""Blocks: the unit of data movement (reference: `python/ray/data/block.py`).

A block is a column dict of numpy arrays (Arrow-style columnar, zero-copy
into the object store) or a list of Python rows. BlockAccessor normalizes
access.

The port's copy of ray_tpu/data/block.py: the pandas and pyarrow imports
stay lazy, since the card's machine has neither.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

Block = Union[Dict[str, np.ndarray], List[Any]]


@dataclass
class BlockMetadata:
    num_rows: int
    size_bytes: int
    schema: Optional[Dict[str, str]] = None


class BlockAccessor:
    def __init__(self, block: Block):
        self.block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    @property
    def is_tabular(self) -> bool:
        return isinstance(self.block, dict)

    def num_rows(self) -> int:
        if self.is_tabular:
            if not self.block:
                return 0
            return len(next(iter(self.block.values())))
        return len(self.block)

    def size_bytes(self) -> int:
        if self.is_tabular:
            return int(sum(np.asarray(v).nbytes for v in self.block.values()))
        return sum(sys.getsizeof(r) for r in self.block)

    def schema(self) -> Optional[Dict[str, str]]:
        if self.is_tabular:
            return {k: str(np.asarray(v).dtype) for k, v in self.block.items()}
        return None

    def metadata(self) -> BlockMetadata:
        return BlockMetadata(self.num_rows(), self.size_bytes(), self.schema())

    def iter_rows(self) -> Iterator[Any]:
        if self.is_tabular:
            keys = list(self.block)
            for i in range(self.num_rows()):
                yield {k: self.block[k][i] for k in keys}
        else:
            yield from self.block

    def slice(self, start: int, end: int) -> Block:
        if self.is_tabular:
            return {k: v[start:end] for k, v in self.block.items()}
        return self.block[start:end]

    def take(self, n: int) -> Block:
        return self.slice(0, min(n, self.num_rows()))

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
        if not blocks:
            return []
        if isinstance(blocks[0], dict):
            keys = list(blocks[0])
            for b in blocks[1:]:
                if set(b) != set(keys):
                    raise ValueError(
                        "cannot concat blocks with differing columns: "
                        f"{sorted(keys)} vs {sorted(b)}"
                    )
            return {k: np.concatenate([np.asarray(b[k]) for b in blocks]) for k in keys}
        out: List[Any] = []
        for b in blocks:
            out.extend(b)
        return out

    @staticmethod
    def from_rows(rows: List[Any]) -> Block:
        """Rows of dicts -> columnar when possible, else row block."""
        if rows and all(isinstance(r, dict) for r in rows):
            keys = list(rows[0])
            if all(list(r) == keys for r in rows):
                try:
                    return {k: np.asarray([r[k] for r in rows]) for k in keys}
                except Exception:
                    return list(rows)
        return list(rows)

    @staticmethod
    def batch_of(block: Block, batch_format: str = "numpy") -> Any:
        acc = BlockAccessor(block)
        if batch_format in ("numpy", "default"):
            if acc.is_tabular:
                return {k: np.asarray(v) for k, v in block.items()}
            return np.asarray(block)
        if batch_format == "pandas":
            import pandas as pd

            if acc.is_tabular:
                return pd.DataFrame({k: list(v) for k, v in block.items()})
            return pd.DataFrame(block)
        if batch_format == "pyarrow":
            import pyarrow as pa

            if acc.is_tabular:
                cols = {}
                for k, v in block.items():
                    a = np.asarray(v)
                    # multi-dim columns go through list-of-lists (arrow has
                    # no native ndarray column; round-trips as list<item>)
                    cols[k] = pa.array(a.tolist() if a.ndim > 1 else a)
                return pa.table(cols)
            raise ValueError("pyarrow batches need tabular data")
        raise ValueError(f"unknown batch_format {batch_format!r}")

    @staticmethod
    def normalize(batch: Any) -> Block:
        """Whatever a user fn returned -> a Block."""
        if isinstance(batch, dict):
            return {k: np.asarray(v) for k, v in batch.items()}
        if isinstance(batch, np.ndarray):
            return {"data": batch}
        try:
            import pandas as pd

            if isinstance(batch, pd.DataFrame):
                return {c: batch[c].to_numpy() for c in batch.columns}
        except ImportError:
            pass
        try:
            import pyarrow as pa

            if isinstance(batch, pa.Table):
                return {c: batch.column(c).to_numpy(zero_copy_only=False) for c in batch.column_names}
        except ImportError:
            pass
        if isinstance(batch, list):
            return BlockAccessor.from_rows(batch)
        raise TypeError(f"cannot convert {type(batch)} to a Block")
