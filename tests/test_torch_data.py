"""The data library (ray_tpu_torch.data) against ray_tpu.data, on the CPU.

Each flow of tests/test_data.py is one driver program that runs under both
packages in turn, each on its own runtime in thread mode (system_config
{"worker_processes": 0, "actor_processes": False}, the port's only mode
until ROADMAP A5b), and the two results must be equal: rows and their order
where the flow is ordered, multisets where it is not, schemas, block
counts, the exact permutations of a seeded shuffle (both packages draw from
Python's and numpy's generators), aggregates within rtol 1e-12, exception
types. `iter_device_batches` runs with device="cpu" in the port, where the
reference puts jax arrays on its default device. Two flows of the
reference are flaky under the suite's parallel workers (ROADMAP C): their
counterparts here hold the port against plain numpy and pyarrow and do not
run the reference's runtime again.
"""

import builtins
import json
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu.data
import ray_tpu_torch
import ray_tpu_torch.data
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
WAIT_S = 60


class Pkg:
    def __init__(self, name):
        self.name = name
        self.api = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}[name]
        self.data = {"ray_tpu": ray_tpu.data, "ray_tpu_torch": ray_tpu_torch.data}[name]
        self.port = name == "ray_tpu_torch"

    def device_batches(self, ds, **kw):
        """iter_device_batches as numpy: the port on the CPU, the reference
        on its default device."""
        if self.port:
            kw["device"] = "cpu"
        out = []
        for b in ds.iter_device_batches(**kw):
            out.append({k: np.asarray(v.numpy() if self.port else v) for k, v in b.items()})
        return out


def run(name, flow, *args):
    p = Pkg(name)
    p.api.shutdown()
    p.api.init(num_cpus=8, system_config=dict(THREAD_MODE),
               **({"num_gpus": 0} if p.port else {"num_tpus": 0}))
    try:
        return flow(p, *args)
    finally:
        p.api.shutdown()


def both(flow, *args):
    want = run("ray_tpu", flow, *args)
    got = run("ray_tpu_torch", flow, *args)
    return got, want


def plain(x):
    """Rows, batches and values as plain Python for comparison."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return [plain(v) for v in x.tolist()] if x.dtype == object else x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def error_of(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the flow reports what was raised
        cause = getattr(e, "cause", None)
        return type(e).__name__, type(cause).__name__ if cause is not None else None
    return None


# ------------------------------------------------------------------ basics


def range_count_take(p):
    ds = p.data.range(1000, parallelism=8)
    return ds.count(), plain(ds.take(3))


def map_batches(p):
    ds = p.data.range(100, parallelism=4).map_batches(lambda b: {"id": b["id"] * 2})
    return plain(ds.take_all())


def map_filter_flatmap(p):
    ds = (p.data.from_items([{"x": i} for i in range(20)], parallelism=3)
          .map(lambda r: {"x": r["x"] + 1})
          .filter(lambda r: r["x"] % 2 == 0)
          .flat_map(lambda r: [r, r]))
    return plain(ds.take_all())


def fusion_collapses_chain(p):
    from importlib import import_module

    fuse = import_module(f"{p.name}.data.logical").fuse
    ds = (p.data.range(10).map_batches(lambda b: b).filter(lambda r: True)
          .random_shuffle().map_batches(lambda b: b))
    return [s.__name__ if callable(s) and not hasattr(s, "name") else type(s).__name__
            for s in fuse(ds._plan)]


def schema_and_stats(p):
    ds = p.data.range(100, parallelism=4)
    return ds.schema(), ds.stats()


def limit_global(p):
    r = p.data.range(100, parallelism=4)
    return [plain(r.limit(5).take_all()), len(r.limit(30).take_all()),
            len(p.data.range(10, parallelism=3).limit(50).take_all()),
            plain(r.map(lambda x: {"id": x["id"] * 2}).limit(7).take_all())]


def limit_and_sort(p):
    ds = p.data.from_items([{"v": i} for i in [5, 3, 8, 1]], parallelism=2)
    return [plain(ds.sort("v").take_all()), plain(ds.sort("v", descending=True).take_all()),
            plain(ds.sort().take_all())]


# ---------------------------------------------------------- shuffle, split


def random_shuffle_exact(p):
    ds = p.data.range(500, parallelism=5).random_shuffle(seed=7)
    return plain(ds.take_all()), plain(ds.take(10))


def repartition(p):
    ds = p.data.range(100, parallelism=10).repartition(3)
    return ds.stats(), ds.count(), plain(ds.take_all())


def streaming_split(p):
    its = p.data.range(90, parallelism=6).streaming_split(3)
    return [plain(list(it.iter_rows())) for it in its]


def streaming_split_equal(p):
    its = p.data.range(70, parallelism=7).streaming_split(2, equal=True)
    return [plain(list(it.iter_rows())) for it in its]


def split_datasets(p):
    parts = p.data.range(40, parallelism=4).split(2)
    return [part.count() for part in parts], [plain(part.take_all()) for part in parts]


def shuffle_after_staging(p):
    return plain(p.data.range(3000, parallelism=12).random_shuffle(seed=11).take_all())


# --------------------------------------------------------------- iteration


def iter_batch_sizes(p):
    ds = p.data.range(100, parallelism=7)
    return ([plain(b) for b in ds.iter_batches(batch_size=32)],
            [plain(b) for b in ds.iter_batches(batch_size=32, drop_last=True)])


def iter_batches_pandas(p):
    b = next(iter(p.data.range(10, parallelism=1).iter_batches(
        batch_size=10, batch_format="pandas")))
    return list(b.columns), b["id"].tolist()


def local_shuffle(p):
    ds = p.data.range(64, parallelism=2)
    return ([plain(b) for b in ds.iter_batches(batch_size=16, local_shuffle_buffer_size=64,
                                               local_shuffle_seed=0)],
            [plain(b) for b in ds.iter_batches(batch_size=64, local_shuffle_buffer_size=10_000,
                                               local_shuffle_seed=0)])


def device_batches(p):
    ds = p.data.range(64, parallelism=4)
    return [plain(b) for b in p.device_batches(ds, batch_size=16, prefetch=2)]


def device_batches_transform(p):
    names = []

    def tf(b):
        names.append(threading.current_thread().name)
        return {"id": b["id"], "sq": b["id"] * b["id"]}

    ds = p.data.range(64, parallelism=4)
    return [plain(b) for b in p.device_batches(ds, batch_size=16, transform=tf)], set(names)


def device_batches_narrowed(p):
    # C6: 64-bit columns reach the device as 32-bit ones, as jax.numpy.asarray
    # makes them without x64
    ds = p.data.from_numpy({"x": np.arange(12, dtype=np.int64).reshape(6, 2) - 2**20,
                            "y": np.linspace(-1.0, 1.0, 6)})
    return [{k: (str(v.dtype), v.tolist()) for k, v in b.items()}
            for b in p.device_batches(ds, batch_size=3)]


def prefetch_identical(p):
    ds = p.data.range(100, parallelism=7)
    inline = [plain(b) for b in ds.iter_batches(batch_size=32, prefetch_batches=0)]
    threaded = [plain(b) for b in ds.iter_batches(batch_size=32, prefetch_batches=2)]
    return inline == threaded, threaded


def prefetch_exception(p):
    def boom(r):
        raise ValueError("boom")

    ds = p.data.range(100, parallelism=4).map(boom)
    return error_of(lambda: list(ds.iter_batches(batch_size=10, prefetch_batches=2)))


def no_thread_leak(p):
    def alive():
        return [t for t in threading.enumerate()
                if t.name == "data-host-prefetch" and t.is_alive()]

    it = iter(p.data.range(1000, parallelism=8).iter_batches(batch_size=10, prefetch_batches=2))
    first = [plain(next(it)), plain(next(it))]
    it.close()
    deadline = time.time() + 3
    while alive() and time.time() < deadline:
        time.sleep(0.05)
    return first, len(alive())


def torch_batches(p):
    import torch

    ds = p.data.from_numpy({"x": np.arange(10, dtype=np.float64),
                            "y": np.arange(10, dtype=np.int64)})
    batches = list(ds.iter_torch_batches(batch_size=4, dtypes={"x": torch.float32}))
    obj = p.data.from_items([{"s": "a"}, {"s": "bb"}])
    return ([{k: (str(v.dtype), v.tolist()) for k, v in b.items()} for b in batches],
            error_of(lambda: list(obj.iter_torch_batches(batch_size=2))))


# -------------------------------------------------------------- aggregates


def global_aggregates(p):
    ds = p.data.from_items([{"x": float(i), "g": i % 3} for i in range(12)], parallelism=4)
    return [ds.sum("x"), ds.min("x"), ds.max("x"), ds.mean("x"), ds.std("x"),
            ds.std("x", ddof=0),
            plain(ds.aggregate(p.data.Count(), p.data.Sum("x"), p.data.Mean("x")))]


def groupby_aggregate(p):
    ds = p.data.from_items([{"x": float(i) * 1.1, "g": i % 3} for i in range(12)], parallelism=4)
    return plain(ds.groupby("g").aggregate(
        p.data.Count(), p.data.Sum("x"), p.data.Mean("x"), p.data.Min("x"),
        p.data.Max("x"), p.data.Std("x")).take_all())


def groupby_partial_merge_std(p):
    ds = p.data.from_items([{"x": v, "g": 0} for v in np.arange(40.0)], parallelism=8)
    return plain(ds.groupby("g").std("x").take_all())


def map_groups(p):
    ds = p.data.from_items([{"x": float(i), "g": i % 2} for i in range(10)], parallelism=3)
    out = ds.groupby("g").map_groups(
        lambda batch: {"g": batch["g"][:1], "n": np.array([len(batch["x"])])})
    return plain(out.take_all())


# ------------------------------------------------------------- union, zip


def union_zip(p):
    d = p.data
    a = d.range(5, parallelism=2)
    b = d.range(3, parallelism=2).map(lambda r: {"id": r["id"] + 100})
    out = [plain(a.union(b).take_all()),
           d.range(4).union(d.range(4)).map(lambda r: {"id": r["id"] * 2}).count()]
    x = d.from_numpy({"x": np.arange(6)})
    y = d.from_numpy({"y": np.arange(6) * 10})
    out.append(plain(x.zip(y).take_all()))
    out.append(plain(d.from_numpy({"x": np.arange(4)}).zip(
        d.from_numpy({"x": np.arange(4) + 1})).take_all()))
    out.append(plain(d.from_numpy({"x": np.arange(4), "x_1": np.arange(4) * 2}).zip(
        d.from_numpy({"x": np.arange(4) + 7})).take_all()))
    bad = d.from_numpy({"x": np.arange(4)}).zip(d.from_numpy({"y": np.arange(5)}))
    out.append(error_of(bad.take_all))
    return out


# ---------------------------------------------------------------------- io


def csv_json_numpy_io(p, tmp):
    d = p.data
    root = f"{tmp}/{p.name}"
    d.range(20, parallelism=1).write_csv(f"{root}/csv")
    back_csv = d.read_csv(f"{root}/csv")
    with open(f"{root}.x.json", "w") as f:
        f.write('{"a": 1}\n{"a": 2}\n')
    d.from_items([{"a": i, "v": [i, i + 1]} for i in range(6)], parallelism=2).write_json(
        f"{root}/json")
    rows = sorted(d.read_json(f"{root}/json").take_all(), key=lambda r: r["a"])
    np.save(f"{root}.n.npy", np.arange(12).reshape(4, 3))
    with open(f"{root}.t.txt", "w") as f:
        f.write("alpha\nbeta\n")
    return [back_csv.count(), plain(back_csv.take_all()), d.read_json(f"{root}.x.json").count(),
            plain(rows), plain(d.read_numpy(f"{root}.n.npy").take_all()),
            plain(d.read_text(f"{root}.t.txt").take_all()),
            d.from_numpy({"x": np.arange(10)}).count()]


def binary_files(p, tmp):
    with open(f"{tmp}/{p.name}.bin", "wb") as f:
        f.write(b"\x00\x01payload")
    rows = p.data.read_binary_files(f"{tmp}/{p.name}.bin").take_all()
    return [(r["path"].endswith(".bin"), r["bytes"]) for r in rows]


def from_pandas_arrow(p):
    import pandas as pd
    import pyarrow as pa

    d = p.data
    ds = d.from_pandas(pd.DataFrame({"a": [1, 2, 3], "b": [1.5, 2.5, 3.5]}))
    rows = d.from_arrow(pa.table({"x": [10, 20], "y": ["u", "v"]})).take_all()
    np_ds = d.from_numpy({"x": np.arange(10)}, parallelism=4)
    return [ds.count(), ds.sum("a"), plain(rows), len(list(np_ds._stream_refs())), np_ds.sum("x")]


def converters(p):
    import pandas as pd

    d = p.data
    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    out = d.from_pandas(df).to_pandas()
    ds = d.from_items([{"x": i, "y": i * 2.0} for i in range(10)])
    cols = ds.map(lambda r: {"x": r["x"], "y": r["y"] + 1}).to_numpy()
    table = d.from_items([{"a": i} for i in range(5)]).to_arrow()
    return [out.to_dict("list"), len(d.from_pandas(df).to_pandas(limit=2)), plain(cols),
            ds.to_numpy("y").shape, table.num_rows, table.column_names]


# -------------------------------------------- actor pool, out-of-order, images


class Enricher:
    def __init__(self):
        self.calls = 0

    def __call__(self, batch):
        self.calls += 1
        return {"y": np.asarray(batch["id"]) * 2,
                "worker": np.full(len(batch["id"]), id(self)),
                "call_no": np.full(len(batch["id"]), self.calls)}


def actor_pool(p):
    rows = p.data.range(400, parallelism=8).map_batches(
        Enricher, compute="actors", concurrency=2).take_all()

    class C:
        def __call__(self, b):
            return b

    err = error_of(lambda: p.data.range(10).map_batches(C, compute="tasks"))
    return (sorted(int(r["y"]) for r in rows), len({int(r["worker"]) for r in rows}),
            max(int(r["call_no"]) for r in rows) >= 2, err)


def out_of_order(p):
    ds = p.data.range(200, parallelism=8).map_batches(lambda b: {"id": b["id"]})
    ordered = [plain(b) for b in ds.iter_batches(batch_size=32)]
    explicit = [plain(b) for b in ds.iter_batches(batch_size=32, preserve_order=True)]

    def stagger(b):
        if int(b["id"][0]) < 100:
            time.sleep(0.05)
        return {"id": b["id"]}

    unordered = sorted(int(i) for b in p.data.range(200, parallelism=8).map_batches(stagger)
                       .iter_batches(batch_size=25, preserve_order=False) for i in b["id"])

    class Tripler:
        def __call__(self, batch):
            return {"y": np.asarray(batch["id"]) * 3}

    pool = sorted(int(v) for b in p.data.range(240, parallelism=8).map_batches(
        Tripler, compute="actors", concurrency=2).iter_batches(
            batch_size=30, preserve_order=False) for v in b["y"])
    return ordered, explicit == ordered, unordered, pool


def stage_metrics(p):
    from importlib import import_module

    registry = import_module(f"{p.name}.core.metrics").registry
    ds = p.data.range(64, parallelism=4).map_batches(lambda b: b)
    list(ds.iter_batches(batch_size=16, preserve_order=False))
    text = registry.render_prometheus()
    return [name in text for name in
            ("data_stage_stall_seconds", "data_blocks_in_flight", "data_bytes_parked")]


def image_dir(tmp, n=12, varied=True):
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(n):
        hw = (20 + i, 24 + i) if varied else (12, 12)
        Image.fromarray(rng.integers(0, 255, size=(*hw, 3), dtype=np.uint8)).save(
            f"{tmp}/img_{i:03d}.png")
    return tmp


def read_images(p, d):
    data = p.data
    dense = [plain(b) for b in data.read_images(d, size=(16, 16), files_per_block=4)
             .iter_batches(batch_size=6)]
    native = data.read_images(d, include_paths=True, files_per_block=5).take_all()
    norm = [plain(b) for b in data.read_images(d, size=(8, 8)).map_batches(
        lambda b: {"x": b["image"].astype(np.float32) / 255.0}).iter_batches(batch_size=4)]
    gray = next(iter(data.read_images(d, size=(10, 10), mode="L").iter_batches(batch_size=12)))
    unordered = list(data.read_images(d, size=(8, 8), files_per_block=2).iter_batches(
        batch_size=4, preserve_order=False))
    return [dense, sorted((r["image"].shape, r["path"].rsplit("/", 1)[-1]) for r in native),
            norm, plain(gray),
            sorted(int(x) for b in unordered for x in b["image"].reshape(len(b["image"]), -1).sum(1))]


# ------------------------------------------------------------------ flows

FLOWS = {f.__name__: f for f in (
    range_count_take, map_batches, map_filter_flatmap, fusion_collapses_chain,
    schema_and_stats, limit_global, limit_and_sort, random_shuffle_exact, repartition,
    streaming_split, streaming_split_equal, split_datasets, shuffle_after_staging,
    iter_batch_sizes, iter_batches_pandas, local_shuffle, device_batches,
    device_batches_transform, device_batches_narrowed, prefetch_identical, prefetch_exception, no_thread_leak,
    torch_batches, global_aggregates, groupby_aggregate, groupby_partial_merge_std,
    map_groups, union_zip, from_pandas_arrow, converters, actor_pool, out_of_order,
    stage_metrics)}
APPROX = {"global_aggregates", "groupby_aggregate", "groupby_partial_merge_std"}


def close(a, b):
    """Equal, with floats within rtol 1e-12."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        return float(b) == pytest.approx(a, rel=1e-12, abs=0.0) or (a != a and b != b)
    return a == b


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_data_flow_matches_reference(flow):
    if flow in ("iter_batches_pandas", "from_pandas_arrow", "converters"):
        pytest.importorskip("pandas")
        pytest.importorskip("pyarrow")
    got, want = both(FLOWS[flow])
    if flow in APPROX:
        assert close(got, want), (got, want)
    else:
        assert got == want


def test_data_io_matches_reference(tmp_path):
    pytest.importorskip("pandas")
    got, want = both(csv_json_numpy_io, str(tmp_path))
    assert got == want
    got, want = both(binary_files, str(tmp_path))
    assert got == want == [(True, b"\x00\x01payload")]


def test_read_images_matches_reference(tmp_path):
    pytest.importorskip("PIL")
    d = image_dir(str(tmp_path))
    got, want = both(read_images, d)
    assert got == want


def test_flows_that_shape_results_as_the_reference_does():
    # a few invariants of the compared flows, so that "equal" is not "equally empty"
    (count, first3), _ = both(range_count_take)
    assert count == 1000 and first3 == [{"id": 0}, {"id": 1}, {"id": 2}]
    shuffled, _ = both(random_shuffle_exact)
    assert sorted(r["id"] for r in shuffled[0]) == list(range(500))
    assert [r["id"] for r in shuffled[1]] != list(range(10))
    split, _ = both(streaming_split_equal)
    assert [len(s) for s in split] == [35, 35]
    batches, _ = both(device_batches)
    assert [len(b["id"]) for b in batches] == [16] * 4
    (_, names), _ = both(device_batches_transform)
    assert names == {"data-host-prefetch"}


# ------------------------------------------ the port alone, against numpy


def _port(flow, *args):
    return run("ray_tpu_torch", flow, *args)


def test_port_parquet_roundtrip_against_pyarrow(tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    def flow(p):
        ds = p.data.range(50, parallelism=2).map_batches(
            lambda b: {"id": b["id"], "sq": b["id"] ** 2})
        ds.write_parquet(str(tmp_path / "pq"))
        pq.write_table(pa.table({"a": np.arange(7), "b": np.arange(7) * 0.5}),
                       str(tmp_path / "ext.parquet"), row_group_size=3)
        back = p.data.read_parquet(str(tmp_path / "pq"))
        ext = p.data.read_parquet(str(tmp_path / "ext.parquet"))
        return (sorted(plain(back.take_all()), key=lambda r: r["id"]), plain(ext.take_all()),
                len(list(ext._stream_refs())))

    back, ext, ext_blocks = _port(flow)
    written = pq.read_table(str(tmp_path / "pq")).to_pydict()
    assert sorted(written["id"]) == list(range(50))
    assert back == [{"id": i, "sq": i * i} for i in range(50)]
    assert ext == [{"a": i, "b": i * 0.5} for i in range(7)]
    assert ext_blocks == 3  # one block per row group


def test_port_shuffle_peak_residency_bounded():
    def store_bytes(rt):
        return sum(n for a in rt.agents.values() for _oid, n in a.store.list_objects())

    def flow(p):
        from ray_tpu_torch.core import core_worker
        from ray_tpu_torch.data.executor import StreamingExecutor

        rt = core_worker.get_runtime()
        n_blocks, rows = 24, 4000
        base = store_bytes(rt)
        ds = p.data.range(n_blocks * rows, parallelism=n_blocks).random_shuffle(seed=3)
        ex = StreamingExecutor(ds._plan, max_in_flight=8, max_in_flight_bytes=4 * rows * 8)
        peak, ids = 0, []
        for ref in ex.execute():
            ids.append(p.api.get(ref, timeout=WAIT_S)["id"])
            peak = max(peak, store_bytes(rt) - base)
            del ref
        return peak, np.concatenate(ids), n_blocks * rows * 8

    peak, ids, dataset_bytes = _port(flow)
    np.testing.assert_array_equal(np.sort(ids), np.arange(len(ids)))
    assert len(ids) == 96_000 and not np.array_equal(ids, np.arange(len(ids)))
    assert peak < 1.8 * dataset_bytes, (peak, dataset_bytes)


@pytest.mark.parametrize("preserve_order", [True, False])
def test_port_slow_consumer_bounds_producer_memory(preserve_order):
    block_bytes, n_blocks, budget = 1 << 20, 24, 4 << 20

    def flow(p):
        from ray_tpu_torch.core import core_worker
        from ray_tpu_torch.data.executor import StreamingExecutor

        rt = core_worker.get_runtime()
        ds = p.data.range(n_blocks * 10, parallelism=n_blocks).map_batches(
            lambda b: {"x": np.zeros(block_bytes // 8)})
        ex = StreamingExecutor(ds._plan, max_in_flight=n_blocks, max_in_flight_bytes=budget,
                               preserve_order=preserve_order)
        peak, consumed = 0, 0
        for ref in ex.execute():
            time.sleep(0.02)
            peak = max(peak, sum(a.store._used for a in rt.agents.values()))
            consumed += len(p.api.get(ref, timeout=WAIT_S)["x"])
            del ref
        return peak, consumed

    peak, consumed = _port(flow)
    assert consumed == n_blocks * (block_bytes // 8)
    assert peak < budget + 8 * block_bytes, peak


def test_port_intermediates_freed_after_consume():
    import gc

    def flow(p):
        from ray_tpu_torch.core import core_worker

        rt = core_worker.get_runtime()
        base = sum(n for a in rt.agents.values() for _oid, n in a.store.list_objects())
        rows = p.data.range(20_000, parallelism=10).random_shuffle(seed=1).take_all()
        n = len(rows)
        del rows
        gc.collect()
        p.api.available_resources()  # an API entry releases the dropped refs
        left = sum(n for a in rt.agents.values() for _oid, n in a.store.list_objects())
        return n, left - base

    n, leaked = _port(flow)
    assert n == 20_000 and leaked < 200_000, leaked


def test_prefetch_queue_bound_holds():
    from ray_tpu_torch.data.iterator import PrefetchIterator

    produced, got = [], []

    def make():
        for i in range(50):
            produced.append(i)
            yield i

    with PrefetchIterator(make, depth=3) as it:
        for x in it:
            time.sleep(0.002)
            assert len(produced) - len(got) <= 3 + 2
            got.append(x)
    assert got == list(range(50))


def test_exports_are_the_references_but_ingest_and_tenant():
    # the name stays from before the ingest service was ported: the exports
    # are now the reference's, ingest and tenant included
    ingest = {"IngestClient", "IngestIterator", "IngestService", "get_ingest_service",
              "shutdown_ingest_service", "TenantSpec"}
    for name in sorted(ingest):
        assert hasattr(ray_tpu.data, name)
        assert getattr(ray_tpu_torch.data, name).__module__.startswith("ray_tpu_torch.data.")
    modules = {"aggregate", "block", "dataset", "executor", "ingest", "iterator", "logical",
               "read_api", "tenant"}
    ref = {n for n in vars(ray_tpu.data) if not n.startswith("_")} - modules
    port = {n for n in vars(ray_tpu_torch.data) if not n.startswith("_")} - modules
    assert port == ref and ingest <= port


def test_device_batches_need_a_device_or_a_card():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, system_config=dict(THREAD_MODE))
    try:
        ds = ray_tpu_torch.data.range(8)
        if not __import__("torch").cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ds.iter_device_batches(batch_size=4)
        out = list(ds.iter_device_batches(batch_size=4, device="cpu",
                                          transform=lambda b: (b["id"], [b["id"] + 1])))
        assert [type(b).__name__ for b in out] == ["tuple", "tuple"]
        assert out[1][1][0].tolist() == [5, 6, 7, 8]
    finally:
        ray_tpu_torch.shutdown()


def test_flow_outputs_are_json_plain():
    # the comparisons above see plain Python, never arrays compared by identity
    got, _ = both(map_batches)
    json.dumps(got)
    assert sorted(r["id"] for r in got) == [2 * i for i in builtins.range(100)]
