"""Read API (reference: `python/ray/data/read_api.py` + `datasource/`).

The port's copy of ray_tpu/data/read_api.py: pyarrow, pandas and PIL are
imported inside the readers that need them.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from .block import BlockAccessor
from .dataset import Dataset
from .logical import LogicalPlan, Read

DEFAULT_ROWS_PER_BLOCK = 4096


def _make(read_tasks, name, num_rows=None) -> Dataset:
    return Dataset(LogicalPlan([Read(name, tuple(read_tasks), num_rows)]))


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    import builtins

    if parallelism <= 0:
        parallelism = max(1, min(64, n // DEFAULT_ROWS_PER_BLOCK or 1))
    cuts = [n * i // parallelism for i in builtins.range(parallelism + 1)]

    def make_task(lo, hi):
        def task():
            return {"id": np.arange(lo, hi)}
        return task

    tasks = [make_task(cuts[i], cuts[i + 1]) for i in builtins.range(parallelism)]
    return _make(tasks, "read_range", n)


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    import builtins

    n = len(items)
    if parallelism <= 0:
        parallelism = max(1, min(16, n))
    cuts = [n * i // parallelism for i in builtins.range(parallelism + 1)]

    def make_task(lo, hi):
        def task():
            return BlockAccessor.from_rows(items[lo:hi])
        return task

    tasks = [make_task(cuts[i], cuts[i + 1]) for i in builtins.range(parallelism)]
    return _make(tasks, "from_items", n)


def from_pandas(df, *, parallelism: int = 1) -> Dataset:
    """DataFrame -> Dataset (reference: `ray.data.from_pandas`)."""
    cols = {c: df[c].to_numpy() for c in df.columns}
    return from_numpy(cols, parallelism=parallelism)


def from_arrow(table, *, parallelism: int = 1) -> Dataset:
    """pyarrow Table -> Dataset (reference: `ray.data.from_arrow`)."""
    cols = {
        name: table.column(name).to_numpy(zero_copy_only=False)
        for name in table.column_names
    }
    return from_numpy(cols, parallelism=parallelism)


def from_numpy(arrays: Dict[str, np.ndarray], *, parallelism: int = 1) -> Dataset:
    import builtins  # this module shadows `range` with the Dataset factory

    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    n = len(next(iter(arrays.values()))) if arrays else 0
    parallelism = max(1, min(parallelism, n or 1))
    cuts = [n * i // parallelism for i in builtins.range(parallelism + 1)]

    def make_task(lo, hi):
        # Slice up front: each closure ships only its partition, not the
        # whole dict K times through the task plane.
        part = {k: v[lo:hi] for k, v in arrays.items()}

        def task():
            return part
        return task

    tasks = [make_task(cuts[i], cuts[i + 1])
             for i in builtins.range(parallelism)]
    return _make(tasks, "from_numpy", num_rows=n)


def _expand_paths(paths, suffix) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = os.path.expanduser(p)
        if os.path.isdir(p):
            out.extend(sorted(_glob.glob(os.path.join(p, f"*{suffix}"))))
        elif any(c in p for c in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


def read_parquet(paths, *, columns: Optional[List[str]] = None) -> Dataset:
    files = _expand_paths(paths, ".parquet")

    def make_task(f):
        def task():
            # GENERATOR: one block per row group, streamed out of the task
            # as each materializes (executor._run_read_stream) — a consumer
            # sees the first row group while the rest of the file reads
            import builtins  # this module shadows `range` with the factory

            import pyarrow.parquet as pq

            pf = pq.ParquetFile(f)
            if pf.metadata.num_row_groups == 0:
                # empty file: one empty block so the schema survives
                # (same column selection as the row-group path)
                table = pf.schema_arrow.empty_table()
                selected = columns if columns is not None else table.column_names
                yield {
                    c: table.column(c).to_numpy(zero_copy_only=False)
                    for c in selected
                }
                return
            for rg in builtins.range(pf.num_row_groups):
                table = pf.read_row_group(rg, columns=columns)
                yield {
                    c: table.column(c).to_numpy(zero_copy_only=False)
                    for c in table.column_names
                }
        task.streaming = True
        return task

    return _make([make_task(f) for f in files], "read_parquet")


def read_csv(paths) -> Dataset:
    files = _expand_paths(paths, ".csv")

    def make_task(f):
        def task():
            import pandas as pd

            df = pd.read_csv(f)
            return {c: df[c].to_numpy() for c in df.columns}
        return task

    return _make([make_task(f) for f in files], "read_csv")


def read_json(paths) -> Dataset:
    files = _expand_paths(paths, ".json")

    def make_task(f):
        def task():
            import json

            with open(f) as fh:
                text = fh.read()
            if text.lstrip().startswith("["):
                rows = json.loads(text)
            else:  # jsonl
                rows = [json.loads(line) for line in text.splitlines() if line.strip()]
            return BlockAccessor.from_rows(rows)
        return task

    return _make([make_task(f) for f in files], "read_json")


def read_text(paths) -> Dataset:
    files = _expand_paths(paths, ".txt")

    def make_task(f):
        def task():
            with open(f) as fh:
                lines = [l.rstrip("\n") for l in fh]
            return {"text": np.asarray(lines, dtype=object)}
        return task

    return _make([make_task(f) for f in files], "read_text")


def read_numpy(paths) -> Dataset:
    files = _expand_paths(paths, ".npy")

    def make_task(f):
        def task():
            return {"data": np.load(f)}
        return task

    return _make([make_task(f) for f in files], "read_numpy")


_IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")


def read_images(
    paths,
    *,
    size: Optional[tuple] = None,
    mode: str = "RGB",
    include_paths: bool = False,
    files_per_block: int = 64,
    parallelism: int = -1,
) -> Dataset:
    """Decode image files into numpy blocks (reference:
    `data/datasource/image_datasource.py :: ImageDatasource` +
    `read_api.py :: read_images`).

    size: (H, W) resize target. With size set, each block's "image" column
    is one dense [N, H, W, C] uint8 array — ready for a device batch (the
    ViT/CLIP ingest shape, BASELINE.md workload #4). Without it, images
    keep native sizes in an object array.
    mode: PIL conversion mode ("RGB", "L", ...).
    files_per_block: decoded images per emitted BLOCK (batch granularity).
    parallelism: read tasks to split the file list across (cluster-level
    concurrency; default caps at 16). The two knobs are independent: a
    task whose shard spans several blocks streams each block out as it
    decodes, so the first batch reaches the consumer while the rest of
    the shard is still reading.
    """
    import builtins

    files: List[str] = []
    if isinstance(paths, str):
        paths = [paths]
    for p in paths:
        p = os.path.expanduser(p)
        if os.path.isdir(p):
            files.extend(sorted(
                f for f in _glob.glob(os.path.join(p, "*"))
                if f.lower().endswith(_IMAGE_SUFFIXES)))
        elif any(c in p for c in "*?["):
            files.extend(sorted(_glob.glob(p)))
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no image files matched {paths}")

    def decode(path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            im = im.convert(mode)
            if size is not None:
                im = im.resize((size[1], size[0]))  # PIL takes (W, H)
            return np.asarray(im)

    def make_task(shard: List[str]):
        def task():
            for lo in builtins.range(0, len(shard), files_per_block):
                chunk = shard[lo:lo + files_per_block]
                imgs = [decode(f) for f in chunk]
                if size is not None:
                    col = np.stack(imgs)  # [N, H, W, C] dense
                else:
                    col = np.empty(len(imgs), dtype=object)
                    for i, im in enumerate(imgs):
                        col[i] = im
                block: Dict[str, Any] = {"image": col}
                if include_paths:
                    block["path"] = np.asarray(chunk, dtype=object)
                yield block
        task.streaming = True
        return task

    # tasks parallelize across the cluster; blocks stream out of each
    # task as they decode
    n = len(files)
    if parallelism <= 0:
        parallelism = max(1, min(16, -(-n // files_per_block)))
    parallelism = min(parallelism, n)
    cuts = [n * i // parallelism for i in builtins.range(parallelism + 1)]
    shards = [files[cuts[i]:cuts[i + 1]]
              for i in builtins.range(parallelism)]
    return _make([make_task(s) for s in shards if s], "read_images",
                 num_rows=n)


def read_binary_files(paths, *, suffix: str = "") -> Dataset:
    files = _expand_paths(paths, suffix)

    def make_task(f):
        def task():
            with open(f, "rb") as fh:
                data = fh.read()
            return [{"path": f, "bytes": data}]
        return task

    return _make([make_task(f) for f in files], "read_binary_files")
