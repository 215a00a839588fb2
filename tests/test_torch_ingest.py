"""The shared ingest service (ray_tpu_torch.data.ingest, .tenant) against
ray_tpu.data's, on the CPU.

Every flow of tests/test_ingest.py runs under both packages in turn, each
on its own runtime in thread mode: the prefetch thread's lifecycle, the
deficit round-robin scheduler (no runtime; its decisions must be equal
outright), fair shares under a hog tenant, the repeat-epoch cache, eviction
after deregistration through the object ledger's cold-cache sweep, the TTL,
the singleton and the client. Flows whose outcome depends on thread timing
return what the reference's test asserts, and those outcomes must be equal.
The autoscale flow drives the controller's evaluation step
(`_evaluate_scaling`) directly, with the stall counter moved by hand and no
controller thread, so it has no wall-clock threshold to miss under the
suite's parallel workers. Last, the port alone: an IngestIterator hands a
tenant's batches to `iter_device_batches(device=)` as any DataIterator does.
Every service and runtime is shut down in a `finally`; blocking waits carry
timeouts.
"""

import gc
import threading
import time
import uuid

import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as jdata
import ray_tpu_torch
import ray_tpu_torch.data as tdata
from ray_tpu.core import core_worker as jcore_worker, metrics as jmetrics
from ray_tpu.core import object_ledger as jledger
from ray_tpu.data import executor as jexecutor, iterator as jiterator, tenant as jtenant
from ray_tpu.data.ingest import IngestService as JService
from ray_tpu_torch.core import core_worker as tcore_worker, metrics as tmetrics
from ray_tpu_torch.core import object_ledger as tledger
from ray_tpu_torch.data import executor as texecutor, iterator as titerator, tenant as ttenant
from ray_tpu_torch.data.ingest import IngestService as TService
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

pytestmark = pytest.mark.ingest

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
JOIN_S = 60


class Pkg:
    def __init__(self, name):
        port = name == "ray_tpu_torch"
        self.port = port
        self.api = ray_tpu_torch if port else ray_tpu
        self.data = tdata if port else jdata
        self.Service = TService if port else JService
        self.tenant = ttenant if port else jtenant
        self.iterator = titerator if port else jiterator
        self.executor = texecutor if port else jexecutor
        self.core_worker = tcore_worker if port else jcore_worker
        self.ledger = tledger if port else jledger
        self.registry = (tmetrics if port else jmetrics).registry

    def metric(self, name, **tags):
        m = self.registry.get(name)
        return m.get(tags or None) if m is not None else 0.0


def run(name, flow, *args):
    p = Pkg(name)
    p.api.shutdown()
    p.api.init(num_cpus=8, system_config=dict(THREAD_MODE),
               **({"num_gpus": 0} if p.port else {"num_tpus": 0}))
    try:
        return flow(p, *args)
    finally:
        p.data.shutdown_ingest_service()
        p.api.shutdown()


def both(flow, *args):
    return run("ray_tpu_torch", flow, *args), run("ray_tpu", flow, *args)


def drain_rows(iterator, batch_size=512, col="x"):
    return sum(len(b[col]) for b in iterator.iter_batches(batch_size=batch_size))


def drain_in_threads(named):
    """Drain each (name, iterator) on its own thread; -> {name: rows}."""
    counts = {}
    threads = [threading.Thread(target=lambda k=k, it=it: counts.__setitem__(k, drain_rows(it)),
                                name=f"drain-{k}") for k, it in named]
    for t in threads:
        t.start()
    return counts, threads


def join_all(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a drain did not finish"


def prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "data-host-prefetch" and t.is_alive()]


# --------------------------------------------------- prefetch lifecycle


def close_joins_blocked_producer(p):
    before = len(prefetch_threads())
    it = p.iterator.PrefetchIterator(lambda: iter(range(10_000)), 2)
    first = next(it)
    it.close()
    joined = not it._thread.is_alive() and len(prefetch_threads()) == before
    with pytest.raises(StopIteration):
        next(it)
    it.close()  # idempotent
    return first, joined


def exhaustion_and_errors_close(p):
    it = p.iterator.PrefetchIterator(lambda: iter(range(4)), 2)
    items = list(it)
    it._thread.join(timeout=2.0)

    def make():
        yield 1
        raise ValueError("boom")

    bad = p.iterator.PrefetchIterator(make, 2)
    first = next(bad)
    with pytest.raises(ValueError, match="boom"):
        for _ in bad:
            pass
    bad._thread.join(timeout=2.0)
    with p.iterator.PrefetchIterator(lambda: iter(range(10_000)), 2) as cm:
        next(cm)
        cm_thread = cm._thread
    gced = p.iterator.PrefetchIterator(lambda: iter(range(10_000)), 2)
    next(gced)
    gc_thread = gced._thread
    del gced
    gc.collect()
    gc_thread.join(timeout=2.0)
    return (items, not it._thread.is_alive(), first, not bad._thread.is_alive(),
            not cm_thread.is_alive(), not gc_thread.is_alive())


def data_iterator_close(p):
    before = set(prefetch_threads())
    it = p.data.range(50_000, parallelism=8).iterator()
    batches = it.iter_batches(batch_size=64, prefetch_batches=4)
    next(batches)
    mine = set(prefetch_threads()) - before
    it.close()
    closed = not any(t.is_alive() for t in mine)
    with p.data.range(50_000, parallelism=8).iterator() as it2:
        batches = it2.iter_batches(batch_size=64, prefetch_batches=4)
        next(batches)
        mine2 = set(prefetch_threads()) - before - mine
    return bool(mine), closed, bool(mine2) and not any(t.is_alive() for t in mine2)


# ----------------------------------------------------------- scheduler


def weighted_split_under_backlog(p):
    sched = p.tenant.FairShareScheduler(quantum_bytes=1000)
    sched.ensure_tenant(p.tenant.TenantSpec("heavy", weight=4.0))
    sched.ensure_tenant(p.tenant.TenantSpec("light", weight=1.0))
    for i in range(400):
        sched.enqueue("heavy", ("heavy", i))
        sched.enqueue("light", ("light", i))
    order = []
    for _ in range(100):
        nxt = sched.next()
        if nxt is None:
            order.append(None)
            continue
        tenant, item, charged = nxt
        order.append((tenant, item[1], charged))
        sched.complete(tenant, 1000, charged)
    return order, sched.shares()


def in_flight_budget_gates(p):
    sched = p.tenant.FairShareScheduler(quantum_bytes=10_000)
    sched.ensure_tenant(p.tenant.TenantSpec("t", weight=1.0, max_in_flight_bytes=2000))
    for i in range(50):
        sched.enqueue("t", i)
    grabbed = []
    while True:
        nxt = sched.next()
        if nxt is None:
            break
        grabbed.append(nxt)
    for tenant, _item, charged in grabbed:
        sched.complete(tenant, 1000, charged)
    return grabbed, sched.next(), sched.pending_total(), sched.in_flight_total()


def empty_queue_forfeits_deficit(p):
    sched = p.tenant.FairShareScheduler(quantum_bytes=1000)
    sched.ensure_tenant(p.tenant.TenantSpec("idle", weight=100.0))
    sched.ensure_tenant(p.tenant.TenantSpec("busy", weight=1.0))
    idle = [sched.next() for _ in range(20)]
    sched.enqueue("busy", "b0")
    nxt = sched.next()
    sched.cancel("busy", nxt[2])
    sched.drop_tenant("idle")
    return idle, nxt, sorted(sched.tenants())


# --------------------------------------------------------- the service


def hog_vs_light(p):
    svc = p.Service(pool_min=2, pool_max=2, autoscale=False, quantum_bytes=4096)
    try:
        def slow(b):
            time.sleep(0.004)
            return {"x": b["id"] * 1.0}

        n_blocks, rows = 36, 36 * 256
        heavy = svc.register(p.data.range(rows, parallelism=n_blocks).map_batches(slow),
                             tenant="heavy", weight=4.0)
        light = svc.register(p.data.range(rows, parallelism=n_blocks).map_batches(slow),
                             tenant="light", weight=1.0)
        counts, threads = drain_in_threads([("heavy", heavy), ("light", light)])
        deadline = time.monotonic() + JOIN_S
        while time.monotonic() < deadline:
            shares = svc.shares()
            if shares.get("heavy", {}).get("served_blocks", 0) >= n_blocks:
                break
            time.sleep(0.005)
        join_all(threads)
        h, l = shares["heavy"]["served_blocks"], shares["light"]["served_blocks"]
        return counts == {"heavy": rows, "light": rows}, l > 0, h / max(l, 1) >= 2.0
    finally:
        svc.shutdown()


def rejects_all_to_all(p):
    svc = p.Service(pool_min=1, pool_max=1, autoscale=False)
    try:
        with pytest.raises(ValueError, match="all-to-all"):
            svc.register(p.data.range(1000, parallelism=4).random_shuffle(), tenant="t")
        return True
    finally:
        svc.shutdown()


def second_epoch_hits_cache(p):
    svc = p.Service(pool_min=2, pool_max=2, autoscale=False)
    tenant = f"trainer-{uuid.uuid4().hex[:6]}"
    try:
        ds = p.data.range(4096, parallelism=8).map_batches(lambda b: {"x": b["id"] * 2.0})
        it = svc.register(ds, tenant=tenant, weight=2.0)
        rows1 = drain_rows(it)
        hits0 = p.metric("object_cache_hits")
        tasks0 = p.metric("ingest_preprocess_tasks_total", tenant=tenant)
        rows2 = drain_rows(it)
        return (rows1, rows2, p.metric("object_cache_hits") - hits0 > 0,
                p.metric("ingest_preprocess_tasks_total", tenant=tenant) - tasks0,
                p.metric("ingest_cache_hits_total", tenant=tenant),
                sorted(drain_rows_values(it)) == [2.0 * i for i in range(4096)])
    finally:
        svc.shutdown()


def drain_rows_values(it):
    return [float(v) for b in it.iter_batches(batch_size=1024) for v in b["x"]]


def dedup_across_concurrent_epochs(p):
    svc = p.Service(pool_min=2, pool_max=2, autoscale=False)
    tenant = f"t-{uuid.uuid4().hex[:6]}"
    try:
        def slowish(b):
            time.sleep(0.002)
            return {"x": b["id"] + 0.5}

        it = svc.register(p.data.range(2048, parallelism=8).map_batches(slowish),
                          tenant=tenant, weight=1.0)
        counts, threads = drain_in_threads([(0, it), (1, it)])
        join_all(threads)
        return counts, p.metric("ingest_preprocess_tasks_total", tenant=tenant) <= 8
    finally:
        svc.shutdown()


def sweep_flags_then_evict_frees(p):
    svc = p.Service(pool_min=1, pool_max=1, autoscale=False)
    try:
        it = svc.register(p.data.range(1024, parallelism=4).map_batches(
            lambda b: {"x": b["id"] * 1.0}), tenant="batch", weight=1.0)
        rows = drain_rows(it)
        it.deregister(grace_s=120.0)
        time.sleep(0.2)
        rt = p.core_worker.get_runtime()

        def flagged():
            report = p.ledger.sweep(rt, force=True)
            return [l for l in report["leaks"] if l["kind"] == "cold_cache"
                    and l["pin_reason"] == p.ledger.PIN_INGEST]

        before = len(flagged())
        freed = svc.evict(force=True)
        return rows, before >= 4, freed, len(flagged())
    finally:
        svc.shutdown()


def epoch_errors_after_deregister(p):
    svc = p.Service(pool_min=1, pool_max=1, autoscale=False)
    try:
        it = svc.register(p.data.range(512, parallelism=2).map_batches(
            lambda b: {"x": b["id"]}), tenant="t")
        rows = drain_rows(it)
        it.deregister()
        with pytest.raises(RuntimeError, match="deregister"):
            drain_rows(it)
        return rows
    finally:
        svc.shutdown()


def ttl_expiry_evicts(p):
    svc = p.Service(pool_min=1, pool_max=1, autoscale=False)
    try:
        it = svc.register(p.data.range(512, parallelism=2).map_batches(
            lambda b: {"x": b["id"]}), tenant="t")
        drain_rows(it)
        time.sleep(0.15)
        return svc.evict()
    finally:
        svc.shutdown()


def autoscale_steps(p):
    """The controller's decisions, one evaluation at a time: stall above
    the threshold with a backlog scales up (by autoscale_step_max, within
    pool_max), then the drained, idle pool scales back to pool_min after
    three quiet evaluations."""
    svc = p.Service(pool_min=1, pool_max=3, autoscale=False)
    tenant = f"hog-{uuid.uuid4().hex[:6]}"
    try:
        def slow(b):
            time.sleep(0.02)
            return {"x": b["id"] * 1.0}

        it = svc.register(p.data.range(16 * 64, parallelism=16).map_batches(slow),
                          tenant=tenant, weight=1.0)
        svc._evaluate_scaling()  # a baseline of the stall counter
        epoch = svc._epoch_stream(it.registration_id)  # enqueues the blocks
        backlog = svc._sched.pending_total() > 0
        p.executor._m_stall.inc(0.5, tags={"stage": "ingest", "tenant": tenant})
        svc._evaluate_scaling()
        up = [(e["from"], e["to"], e["dir"], tenant in e["tenants"]) for e in svc.scale_events]
        size_up = svc.pool_size()
        rows = sum(len(p.api.get(ref, timeout=JOIN_S)["x"]) for ref in epoch)
        deadline = time.monotonic() + JOIN_S
        while svc._sched.in_flight_total() and time.monotonic() < deadline:
            time.sleep(0.01)
        svc._evaluate_scaling()  # the drain's own stall resets the idle count
        sizes = []
        for _ in range(3):
            svc._evaluate_scaling()
            sizes.append(svc.pool_size())
        down = [(e["from"], e["to"], e["dir"]) for e in svc.scale_events[len(up):]]
        return backlog, up, size_up, rows, sizes, down
    finally:
        svc.shutdown()


def singleton_recreated(p):
    svc = p.data.get_ingest_service(pool_min=1, pool_max=1, autoscale=False)
    same = p.data.get_ingest_service() is svc
    p.data.shutdown_ingest_service()
    gone = p.data.get_ingest_service(create=False) is None
    svc2 = p.data.get_ingest_service(pool_min=1, pool_max=1, autoscale=False)
    try:
        return same, gone, svc2 is not svc and svc2.is_running, not svc.is_running
    finally:
        p.data.shutdown_ingest_service()


def client_round_trip(p):
    svc = p.Service(pool_min=1, pool_max=1, autoscale=False)
    try:
        client = p.data.IngestClient(svc)
        it = client.register(p.data.range(512, parallelism=2).map_batches(
            lambda b: {"x": b["id"]}), tenant="rl", weight=2.0)
        rows = drain_rows(it)
        shares = client.shares()
        client.deregister(it)
        return (rows, isinstance(it, p.data.DataIterator), client.service is svc,
                {k: {m: v for m, v in row.items() if m != "served_bytes"}
                 for k, row in shares.items()})
    finally:
        svc.shutdown()


def shutdown_frees_cache_and_threads(p):
    svc = p.Service(pool_min=2, pool_max=2, autoscale=True)
    it = svc.register(p.data.range(1024, parallelism=4).map_batches(lambda b: {"x": b["id"]}),
                      tenant="t")
    drain_rows(it)
    svc.shutdown()
    svc.shutdown()  # idempotent
    with pytest.raises(RuntimeError, match="shut down"):
        svc.register(p.data.range(8), tenant="t")
    return (not svc._admission.is_alive(),
            svc._controller is None or not svc._controller.is_alive(),
            not svc._regs and not svc._condemned, svc.pool_size())


FLOWS = {f.__name__: f for f in (
    close_joins_blocked_producer, exhaustion_and_errors_close, data_iterator_close,
    weighted_split_under_backlog, in_flight_budget_gates, empty_queue_forfeits_deficit,
    hog_vs_light, rejects_all_to_all, second_epoch_hits_cache, dedup_across_concurrent_epochs,
    sweep_flags_then_evict_frees, epoch_errors_after_deregister, ttl_expiry_evicts,
    autoscale_steps, singleton_recreated, client_round_trip, shutdown_frees_cache_and_threads)}
ENV = {"sweep_flags_then_evict_frees": {"RAY_TPU_OBJECT_LEAK_AGE_S": "0.05"},
       "ttl_expiry_evicts": {"RAY_TPU_INGEST_CACHE_TTL_S": "0.05"}}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_ingest_flow_matches_reference(flow, monkeypatch):
    for k, v in ENV.get(flow, {}).items():
        monkeypatch.setenv(k, v)
    got, want = both(FLOWS[flow])
    assert got == want


def test_flow_outcomes_are_the_reference_tests_asserts(monkeypatch):
    # what the compared flows return, so that equal is not equally wrong
    port = "ray_tpu_torch"
    assert run(port, close_joins_blocked_producer) == (0, True)
    assert run(port, exhaustion_and_errors_close) == ([0, 1, 2, 3], True, 1, True, True, True)
    assert run(port, data_iterator_close) == (True, True, True)
    order, shares = run(port, weighted_split_under_backlog)
    served = [o[0] for o in order if o is not None]
    assert 2.0 <= served.count("heavy") / served.count("light") <= 8.0
    grabbed, resumed, pending, inflight = run(port, in_flight_budget_gates)
    assert 1 <= len(grabbed) <= 2 and resumed is not None
    idle, nxt, left = run(port, empty_queue_forfeits_deficit)
    assert idle == [None] * 20 and nxt[0] == "busy" and left == ["busy"]
    assert run(port, hog_vs_light) == (True, True, True)
    rows1, rows2, hit, retasked, cache_hits, values = run(port, second_epoch_hits_cache)
    assert rows1 == rows2 == 4096 and hit and retasked == 0 and cache_hits >= 8 and values
    assert run(port, dedup_across_concurrent_epochs) == ({0: 2048, 1: 2048}, True)
    monkeypatch.setenv("RAY_TPU_OBJECT_LEAK_AGE_S", "0.05")
    rows, flagged, freed, after = run(port, sweep_flags_then_evict_frees)
    assert rows == 1024 and flagged and freed >= 4 and after == 0
    assert run(port, epoch_errors_after_deregister) == 512
    monkeypatch.setenv("RAY_TPU_INGEST_CACHE_TTL_S", "0.05")
    assert run(port, ttl_expiry_evicts) >= 2
    backlog, up, size_up, rows, sizes, down = run(port, autoscale_steps)
    assert backlog and up == [(1, 3, "up", True)] and size_up == 3 and rows == 1024
    assert sizes == [3, 3, 1] and down == [(3, 1, "down")]
    assert run(port, singleton_recreated) == (True, True, True, True)
    rows, is_iter, same, shares = run(port, client_round_trip)
    assert rows == 512 and is_iter and same and shares["rl"]["served_blocks"] == 2
    assert run(port, shutdown_frees_cache_and_threads) == (True, True, True, 0)


def test_ingest_iterator_feeds_device_batches():
    # the port's iter_device_batches(device=) on a tenant's iterator: the
    # same rows as iter_batches, each column a tensor on the device, 64-bit
    # columns narrowed as the reference's jax.numpy.asarray does. A cold
    # epoch yields its blocks in the order the pool's two workers finish
    # them, a warm one in block order (_epoch_stream), so the batch-by-batch
    # comparison is between two warm epochs; the cold one holds the same rows
    def flow(p):
        svc = p.Service(pool_min=2, pool_max=2, autoscale=False)
        try:
            rows = np.random.default_rng(0).integers(0, 1000, (64, 9)).astype(np.int64)
            it = svc.register(p.data.from_numpy({"tokens": rows}, parallelism=4),
                              tenant="trial", weight=3.0)
            cold = [b["tokens"] for b in it.iter_batches(batch_size=8)]
            host = [b["tokens"] for b in it.iter_batches(batch_size=8)]
            dev = [b["tokens"] for b in it.iter_device_batches(batch_size=8, device="cpu")]
            return rows, cold, host, dev, svc.shares()["trial"]
        finally:
            svc.shutdown()

    rows, cold, host, dev, share = run("ray_tpu_torch", flow)
    assert len(dev) == len(host) == len(cold) == 8
    np.testing.assert_array_equal(np.concatenate(host), rows)
    by_row = lambda a: a[np.lexsort(a.T)]  # noqa: E731
    np.testing.assert_array_equal(by_row(np.concatenate(cold)), by_row(rows))
    for h, d in zip(host, dev):
        assert str(d.dtype) == "torch.int32" and d.device.type == "cpu"
        np.testing.assert_array_equal(d.numpy(), h)
    assert share["served_blocks"] == 4 and share["target"] == 1.0


def test_exports_are_the_references():
    names = {"IngestClient", "IngestIterator", "IngestService", "get_ingest_service",
             "shutdown_ingest_service", "TenantSpec"}
    for name in names:
        assert getattr(tdata, name).__module__.startswith("ray_tpu_torch.data.")
    from ray_tpu.data import ingest as jingest
    from ray_tpu_torch.data import ingest as tingest

    public = {n for n in vars(jingest) if not n.startswith("_") and callable(getattr(jingest, n))
              and getattr(getattr(jingest, n), "__module__", "") == jingest.__name__}
    assert {n for n in public if hasattr(tingest, n)} == public
    assert {f.name for f in __import__("dataclasses").fields(ttenant.TenantSpec)} == {
        f.name for f in __import__("dataclasses").fields(jtenant.TenantSpec)}
