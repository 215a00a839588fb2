"""The task/actor runtime (ray_tpu_torch.api, core/, sched/, cluster_utils)
against ray_tpu's, on the CPU.

Each flow of tests/test_core_runtime.py is one driver program that runs
under both packages in turn, in thread mode (system_config
{"worker_processes": 0, "actor_processes": False}, which is the port's
only mode until ROADMAP A5b): the results, the exception types and
messages, the order in which an actor saw its messages, and
cluster_resources() must be the same. The accelerator resource is the one
deliberate difference: the reference's "TPU" (num_tpus=) is the port's
"GPU" (num_gpus=), so the flows name it through `acc` and compare
resources with the name normalised. Every runtime is started explicitly
before its first `.remote` and shut down in a `finally`, and no flag
override outlives its flow.
"""

import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu.cluster_utils
import ray_tpu_torch
import ray_tpu_torch.cluster_utils
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
PACKAGES = {"ray_tpu": (ray_tpu, ray_tpu.cluster_utils, "TPU"),
            "ray_tpu_torch": (ray_tpu_torch, ray_tpu_torch.cluster_utils, "GPU")}
WAIT_S = 20  # every get has a timeout


class Pkg:
    """One package's API as a flow sees it."""

    def __init__(self, name):
        self.api, self.cluster_utils, self.accel = PACKAGES[name]
        self.name = name

    def acc(self, n):
        """The accelerator option: num_tpus= in the reference, num_gpus= in the port."""
        return {f"num_{self.accel.lower()}s": n}

    def resources(self):
        res = self.api.cluster_resources()
        return {("ACCEL" if k == self.accel else k): v for k, v in sorted(res.items())}


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the flow reports what was raised
        cause = getattr(e, "cause", None)
        return (type(e).__name__, type(cause).__name__ if cause is not None else None)
    return None


# ------------------------------------------------------------------ tasks


def task_round_trip(p):
    @p.api.remote
    def add(a, b):
        return a + b

    return p.api.get(add.remote(1, 2), timeout=WAIT_S)


def task_refs_as_args(p):
    @p.api.remote
    def square(x):
        return x * x

    ref = square.remote(3)
    return p.api.get(square.remote(ref), timeout=WAIT_S)


def task_num_returns(p):
    @p.api.remote(num_returns=3)
    def three():
        return 1, "two", [3]

    return p.api.get(list(three.remote()), timeout=WAIT_S)


def task_application_error(p):
    @p.api.remote
    def boom():
        raise ValueError("bad")

    ref = boom.remote()
    err = _error(lambda: p.api.get(ref, timeout=WAIT_S))
    try:
        p.api.get(ref, timeout=WAIT_S)
    except p.api.RayTaskError as e:
        return err, str(e.cause)


def task_retry_exceptions(p):
    attempts = []

    @p.api.remote(retry_exceptions=True, max_retries=3)
    def flaky():
        attempts.append(1)  # thread mode: the closure is shared across attempts
        if len(attempts) < 3:
            raise RuntimeError("transient")
        return "ok"

    @p.api.remote(retry_exceptions=True, max_retries=1)
    def always():
        raise RuntimeError("permanent")

    return (p.api.get(flaky.remote(), timeout=WAIT_S), len(attempts),
            _error(lambda: p.api.get(always.remote(), timeout=WAIT_S)))


def task_put_get(p):
    arr = np.arange(100)
    ref = p.api.put(arr)
    arr[0] = -1  # a host value is sealed at put: the store keeps the old bytes
    got = p.api.get(ref, timeout=WAIT_S)
    return got.tolist(), p.api.get(p.api.put({"a": [1, 2]}), timeout=WAIT_S)


def task_put_ref_as_arg(p):
    ref = p.api.put(10)

    @p.api.remote
    def double(x):
        return x * 2

    return p.api.get(double.remote(ref), timeout=WAIT_S)


def task_wait(p):
    @p.api.remote
    def fast():
        return 1

    @p.api.remote
    def slow():
        time.sleep(1.0)
        return 2

    f, s = fast.remote(), slow.remote()
    ready, pending = p.api.wait([f, s], num_returns=1, timeout=WAIT_S)
    both, none = p.api.wait([f, s], num_returns=2, timeout=WAIT_S)
    return ready == [f], pending == [s], len(both), none


def task_get_timeout(p):
    @p.api.remote
    def slow():
        time.sleep(1.0)

    return _error(lambda: p.api.get(slow.remote(), timeout=0.1))


def task_infeasible_fails_fast(p):
    @p.api.remote(num_cpus=10_000)
    def huge():
        return 1

    t0 = time.monotonic()
    try:
        p.api.get(huge.remote(), timeout=WAIT_S)
    except ValueError as e:
        return type(e).__name__, str(e), time.monotonic() - t0 < 5.0


def task_remote_called_directly(p):
    @p.api.remote
    def f():
        return 1

    return _error(f)


# ----------------------------------------------------------------- actors


def actor_ordering(p):
    @p.api.remote
    class Log:
        def __init__(self, first):
            self.items = [first]

        def add(self, x):
            self.items.append(x)
            return len(self.items)

        def get(self):
            return self.items

    a = Log.remote("start")
    # the actor answers once before the burst: the reference can reorder
    # calls made while its actor is still starting (C7; the port's order
    # in that window is pinned by
    # test_calls_made_while_an_actor_starts_run_in_submission_order)
    p.api.get(a.get.remote(), timeout=WAIT_S)
    refs = [a.add.remote(i) for i in range(20)]
    counts = p.api.get(refs, timeout=WAIT_S)
    return counts, p.api.get(a.get.remote(), timeout=WAIT_S)


def actor_named(p):
    @p.api.remote
    class Store:
        def ping(self):
            return "pong"

    Store.options(name="kv").remote()
    handle = p.api.get_actor("kv")
    return p.api.get(handle.ping.remote(), timeout=WAIT_S), _error(
        lambda: p.api.get_actor("nobody"))


def actor_duplicate_name(p):
    @p.api.remote
    class A:
        pass

    A.options(name="dup").remote()
    try:
        A.options(name="dup").remote()
    except ValueError as e:
        return type(e).__name__, str(e)


def actor_init_failure(p):
    @p.api.remote
    class Bad:
        def __init__(self):
            raise RuntimeError("init failed")

        def m(self):
            return 1

    b = Bad.remote()
    return _error(lambda: p.api.get(b.m.remote(), timeout=WAIT_S))


def actor_kill(p):
    @p.api.remote
    class A:
        def ping(self):
            return "pong"

    a = A.remote()
    first = p.api.get(a.ping.remote(), timeout=WAIT_S)
    p.api.kill(a)
    return first, _error(lambda: p.api.get(a.ping.remote(), timeout=WAIT_S))


def actor_max_concurrency(p):
    @p.api.remote(max_concurrency=4)
    class Par:
        def __init__(self):
            self.lock = threading.Lock()
            self.now = 0
            self.peak = 0

        def slow(self):
            with self.lock:
                self.now += 1
                self.peak = max(self.peak, self.now)
            time.sleep(0.5)
            with self.lock:
                self.now -= 1
            return 1

        def peak_seen(self):
            return self.peak

    a = Par.remote()
    start = time.monotonic()
    total = sum(p.api.get([a.slow.remote() for _ in range(4)], timeout=WAIT_S))
    overlapped = time.monotonic() - start < 1.5  # serial: 2 s
    return total, overlapped, p.api.get(a.peak_seen.remote(), timeout=WAIT_S)


def actor_handle_passed_to_task(p):
    @p.api.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    @p.api.remote
    def use(handle):
        return p.api.get(handle.inc.remote(), timeout=WAIT_S)

    c = Counter.remote()
    # one task at a time: concurrent tasks would reach the actor in any order
    return [p.api.get(use.remote(c), timeout=WAIT_S) for _ in range(3)]


def actor_holds_its_resources(p):
    @p.api.remote(num_cpus=3)
    class Big:
        def ping(self):
            return "pong"

    before = p.api.available_resources()
    a = Big.remote()
    p.api.get(a.ping.remote(), timeout=WAIT_S)
    held = p.api.available_resources()
    p.api.kill(a)
    deadline = time.monotonic() + WAIT_S
    while p.api.available_resources() != before and time.monotonic() < deadline:
        time.sleep(0.01)
    return before, held, p.api.available_resources()


def trace_through_tasks(p):
    tracing = __import__(f"{p.name}.util.tracing", fromlist=["x"])

    @p.api.remote
    def leaf(x):
        return x + 1

    @p.api.remote
    def parent(x):
        return p.api.get(leaf.remote(x), timeout=WAIT_S)

    with tracing.start_span("root") as root:
        got = p.api.get(parent.remote(1), timeout=WAIT_S)
    deadline = time.monotonic() + WAIT_S
    while len(tracing.get_spans(root.trace_id)) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    spans = {s["span_id"]: s for s in tracing.get_spans(root.trace_id)}
    by_name = {s["name"].rsplit(".", 1)[-1]: s for s in spans.values()}
    chain = [(name, spans[s["parent_id"]]["name"].rsplit(".", 1)[-1]
              if s["parent_id"] in spans else None) for name, s in sorted(by_name.items())]
    return got, chain


def state_task_table(p, rt):
    @p.api.remote
    def f():
        return 1

    p.api.get([f.remote() for _ in range(3)], timeout=WAIT_S)
    table = rt.task_table()
    snap = rt.control_plane.snapshot()
    return (sorted((v["name"].rsplit(".", 1)[-1], v["state"]) for v in table.values()),
            len(snap["nodes"]), snap["nodes"][0]["state"])


# ------------------------------------------------------ the virtual cluster


def cluster_spread_across_nodes(p, cluster):
    for _ in range(3):
        cluster.add_node(resources={"CPU": 4.0})

    @p.api.remote(scheduling_strategy=p.api.SpreadSchedulingStrategy(), num_cpus=1)
    def where(i):
        time.sleep(0.01)
        return i

    return p.api.get([where.remote(i) for i in range(16)], timeout=WAIT_S), p.resources()


def cluster_custom_resource(p, cluster):
    cluster.add_node(resources={"CPU": 4.0, "special": 1.0})

    @p.api.remote(resources={"special": 1.0})
    def task():
        return "ran"

    return p.api.get(task.remote(), timeout=WAIT_S), p.resources()


def cluster_fake_slice(p, cluster):
    cluster.add_slice(num_hosts=2, chips_per_host=4)

    @p.api.remote(**p.acc(4))
    def accel_task():
        return "on-slice"

    return p.resources(), p.api.get(accel_task.remote(), timeout=WAIT_S)


def cluster_task_retry_on_node_death(p, cluster):
    victim = cluster.add_node(resources={"CPU": 4.0, "victim": 1.0})

    started = threading.Event()

    @p.api.remote(resources={"victim": 1.0}, num_cpus=0, max_retries=0)
    def waits():
        started.set()
        time.sleep(0.5)
        return "done"

    ref = waits.remote()
    assert started.wait(WAIT_S)
    cluster.remove_node(victim)  # crash mid-run; no retries -> error
    return _error(lambda: p.api.get(ref, timeout=WAIT_S)), p.resources()


def cluster_object_survives_on_other_node(p, cluster):
    cluster.add_node(resources={"CPU": 4.0, "far": 1.0})

    @p.api.remote(resources={"far": 1.0})
    def produce():
        return np.ones(10)

    @p.api.remote
    def consume(x):
        return float(x.sum())

    ref = produce.remote()
    return p.api.get(ref, timeout=WAIT_S).tolist(), p.api.get(consume.remote(ref),
                                                              timeout=WAIT_S)


def cluster_broadcast(p, cluster):
    for _ in range(3):
        cluster.add_node(resources={"CPU": 2.0})
    ref = p.api.put(np.arange(1000))
    out = p.api.broadcast(ref, timeout=WAIT_S)
    holders = sum(a.store.contains(ref.object_id) for a in cluster.runtime.agents.values())

    @p.api.remote(scheduling_strategy=p.api.SpreadSchedulingStrategy())
    def total(x):
        return int(x.sum())

    return (len(out["warmed"]), out["failed"], holders,
            p.api.get([total.remote(ref) for _ in range(4)], timeout=WAIT_S))


def cluster_lineage_reconstruction(p, cluster):
    victim = cluster.add_node(resources={"CPU": 4.0, "victim": 1.0})

    @p.api.remote(resources={"victim": 0.5}, num_cpus=0)
    def produce():
        return "precious"

    ref = produce.remote()
    first = p.api.get(ref, timeout=WAIT_S)
    cluster.add_node(resources={"CPU": 4.0, "victim": 1.0})
    cluster.remove_node(victim)  # object lost with the node
    return first, p.api.get(ref, timeout=WAIT_S)


def cluster_actor_restart_on_node_death(p, cluster):
    victim = cluster.add_node(resources={"CPU": 4.0, "actorhome": 1.0})
    cluster.add_node(resources={"CPU": 4.0, "actorhome": 1.0})

    @p.api.remote(resources={"actorhome": 0.5}, num_cpus=0, max_restarts=2)
    class Phoenix:
        def __init__(self):
            self.calls = 0

        def ping(self):
            self.calls += 1
            return self.calls

    a = Phoenix.remote()
    before = p.api.get([a.ping.remote() for _ in range(2)], timeout=WAIT_S)
    cluster.remove_node(victim)
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        try:
            return before, p.api.get(a.ping.remote(), timeout=5)
        except Exception:  # noqa: BLE001 — the restart is still on its way
            time.sleep(0.1)
    return before, "no restart"


REGULAR = [task_round_trip, task_refs_as_args, task_num_returns, task_application_error,
           task_retry_exceptions, task_put_get, task_put_ref_as_arg, task_wait,
           task_get_timeout, task_infeasible_fails_fast, task_remote_called_directly,
           actor_ordering, actor_named, actor_duplicate_name, actor_init_failure, actor_kill,
           actor_max_concurrency, actor_handle_passed_to_task, actor_holds_its_resources,
           trace_through_tasks]
CLUSTER = [cluster_spread_across_nodes, cluster_custom_resource, cluster_fake_slice,
           cluster_broadcast,
           cluster_task_retry_on_node_death, cluster_object_survives_on_other_node,
           cluster_lineage_reconstruction, cluster_actor_restart_on_node_death]


def run_regular(name, flow):
    p = Pkg(name)
    p.api.shutdown()  # no runtime another test left behind may serve this one
    rt = p.api.init(num_cpus=8, system_config=dict(THREAD_MODE), **p.acc(0))
    try:
        out = flow(p, rt) if flow is state_task_table else flow(p)
        return out, p.resources()
    finally:
        p.api.shutdown()


def run_cluster(name, flow):
    p = Pkg(name)
    p.api.shutdown()
    config = __import__(f"{name}.core.config", fromlist=["config"]).config
    config.apply_overrides(dict(THREAD_MODE))
    cluster = None
    try:
        cluster = p.cluster_utils.Cluster(initialize_head=True)
        return flow(p, cluster)
    finally:
        if cluster is not None:
            cluster.shutdown()
        config.reset()


@pytest.mark.parametrize("flow", REGULAR + [state_task_table], ids=lambda f: f.__name__)
def test_flow_matches_reference(flow):
    ref = run_regular("ray_tpu", flow)
    port = run_regular("ray_tpu_torch", flow)
    assert port == ref
    assert port[0] is not None


@pytest.mark.parametrize("flow", CLUSTER, ids=lambda f: f.__name__)
def test_cluster_flow_matches_reference(flow):
    ref = run_cluster("ray_tpu", flow)
    port = run_cluster("ray_tpu_torch", flow)
    assert port == ref
    assert "no restart" not in repr(port)


def test_runtimes_leave_no_thread_or_override_behind():
    names = ("cluster-scheduler", "health-monitor")
    rt = ray_tpu_torch.init(num_cpus=2, system_config=dict(THREAD_MODE))
    assert rt is ray_tpu_torch.init()  # a second init hands back the first
    from ray_tpu_torch.core import channels

    channels.ensure_service()  # the channel service ends with the runtime
    service = channels._service
    ray_tpu_torch.shutdown()
    assert not any(t.name in names and t.is_alive() for t in (rt._sched_thread,
                                                              rt._monitor_thread))
    assert not service._thread.is_alive() and channels.service_address() is None
    from ray_tpu_torch.core.config import config

    assert config._overrides == {} and not ray_tpu_torch.is_initialized()


def _order_with_a_call_made_during_the_pass(p):
    """An actor whose __init__ is slow gets calls 0..4; in the first pass
    of the scheduling loop that holds them back after all five are in (the
    actor still starting), a sixth call is submitted from inside the pass,
    as a caller thread's call can land there. Returns the order the actor
    ran them."""
    rt = p.api.init(num_cpus=4, system_config=dict(THREAD_MODE), **p.acc(0))
    try:
        @p.api.remote
        class Log:
            def __init__(self):
                time.sleep(0.2)
                self.items = []

            def add(self, x):
                self.items.append(x)

            def get(self):
                return self.items

        a = Log.remote()
        place, armed, late = rt._try_place, threading.Event(), []

        def try_place(item):
            placed = place(item)
            if not placed and armed.is_set() and not late:
                late.append(a.add.remote("late"))
            return placed

        rt._try_place = try_place
        done = [a.add.remote(i) for i in range(5)]
        armed.set()
        deadline = time.monotonic() + WAIT_S
        while not late and time.monotonic() < deadline:
            time.sleep(0.01)
        p.api.get(done + late, timeout=WAIT_S)
        return p.api.get(a.get.remote(), timeout=WAIT_S)
    finally:
        p.api.shutdown()


def test_calls_made_while_an_actor_starts_run_in_submission_order():
    # C7: the scheduling loop appended the calls it could not place yet
    # (their actor still in __init__) behind those submitted during its
    # pass, so a later call ran first; the port puts them back ahead and
    # holds an actor's later calls of the same pass behind them. The
    # reference's loop (ray_tpu/core/core_worker.py _scheduling_loop)
    # still reorders.
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    assert _order_with_a_call_made_during_the_pass(Pkg("ray_tpu_torch")) == [
        0, 1, 2, 3, 4, "late"]
    ref = _order_with_a_call_made_during_the_pass(Pkg("ray_tpu"))
    assert ref[0] == "late" and sorted(ref[1:]) == [0, 1, 2, 3, 4]


class _CollectingDict(dict):
    """A count table whose lookups run the garbage collector, as an
    allocation inside ReferenceCounter.add_ref's critical section can."""

    def get(self, key, default=None):
        import gc

        gc.collect()
        return super().get(key, default)


class _StubRuntime:
    """What ReferenceCounter and ObjectRef read of a runtime."""

    is_shutdown = False

    def __init__(self):
        from ray_tpu_torch.core.core_worker import ReferenceCounter

        self.reference_counter = ReferenceCounter(self)
        self.freed = []

    def free_object(self, object_id):
        self.freed.append(object_id)


def test_a_finalizer_inside_add_ref_does_not_deadlock():
    # The reference's ReferenceCounter counts down inside ObjectRef.__del__
    # under a lock that is not reentrant: a collection that runs a dropped
    # ref's finalizer while add_ref holds that lock deadlocks the thread
    # (tests/test_data.py::TestBoundedShuffle::test_peak_residency_bounded
    # hung that way under -n 6: ray_tpu/core/core_worker.py add_ref ->
    # ids.__hash__ -> ObjectRef.__del__ -> remove_ref). The port queues the
    # release and applies it where no lock is held (release_dropped).
    from ray_tpu_torch.core.core_worker import ObjectRef
    from ray_tpu_torch.core.ids import ObjectID

    rt = _StubRuntime()
    rc = rt.reference_counter
    dropped_id, kept_id = ObjectID.generate(), ObjectID.generate()
    cycle = [ObjectRef(dropped_id, rt)]
    cycle.append(cycle)  # only the collector frees it, and so runs the finalizer
    del cycle
    rc._counts = _CollectingDict(rc._counts)
    made = []
    t = threading.Thread(target=lambda: made.append(ObjectRef(kept_id, rt)), daemon=True)
    t.start()
    t.join(10)
    assert not t.is_alive(), "add_ref deadlocked on a finalizer"
    assert rc.count(dropped_id) == 1 and rt.freed == []  # queued, not applied
    rc.release_dropped()
    assert rc.count(dropped_id) == 0 and rt.freed == [dropped_id]
    assert rc.count(kept_id) == 1


def test_a_dropped_ref_is_freed_at_the_next_api_entry():
    rt = ray_tpu_torch.init(num_cpus=2, system_config=dict(THREAD_MODE))
    try:
        ref = ray_tpu_torch.put(np.arange(10))
        oid = ref.object_id
        agent = next(iter(rt.agents.values()))
        assert agent.store.contains(oid)
        del ref
        assert rt.reference_counter.count(oid) == 1  # queued by the finalizer
        ray_tpu_torch.put(0)  # an API entry applies the queued release
        assert rt.reference_counter.count(oid) == 0 and not agent.store.contains(oid)
    finally:
        ray_tpu_torch.shutdown()


class _Payload:
    """What an actor holds (an engine's weights, say), weakly referable."""


def test_a_killed_actors_instance_is_released_where_the_reference_keeps_it():
    import gc
    import weakref

    released = {}
    for name in PACKAGES:
        p = Pkg(name)
        p.api.shutdown()
        p.api.init(num_cpus=2, system_config=dict(THREAD_MODE), **p.acc(0))
        try:
            held = []

            @p.api.remote
            class Holder:
                def __init__(self):
                    self.payload = _Payload()
                    held.append(weakref.ref(self.payload))

                def ping(self):
                    return 1

            h = Holder.remote()
            assert p.api.get(h.ping.remote(), timeout=WAIT_S) == 1
            p.api.kill(h)
            deadline = time.monotonic() + 2
            while held[0]() is not None and time.monotonic() < deadline:
                gc.collect()
                time.sleep(0.05)
            released[name] = held[0]() is None
        finally:
            p.api.shutdown()
    assert released == {"ray_tpu": False, "ray_tpu_torch": True}


def test_a_killed_async_actor_busy_past_the_join_is_released_when_its_call_ends():
    # an async actor (a serve replica) killed while a call it runs on a
    # thread (asyncio.to_thread, as prepare_for_shutdown does) takes longer
    # than kill_actor's 2 s join (6 s): its instance goes once the call
    # ends, not never (C14)
    import asyncio
    import gc
    import weakref

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, system_config=dict(THREAD_MODE), num_gpus=0)
    try:
        held, started = [], threading.Event()

        @ray_tpu_torch.remote
        class Busy:
            def __init__(self):
                self.payload = _Payload()
                held.append(weakref.ref(self.payload))

            async def work(self):
                started.set()
                await asyncio.to_thread(time.sleep, 6.0)
                return 1

        b = Busy.remote()
        b.work.remote()
        assert started.wait(WAIT_S)
        t0 = time.monotonic()
        ray_tpu_torch.kill(b)
        gc.collect()
        alive_after_kill = held[0]() is not None
        while held[0]() is not None and time.monotonic() - t0 < 20:
            gc.collect()
            time.sleep(0.05)
        assert alive_after_kill and held[0]() is None
    finally:
        ray_tpu_torch.shutdown()


_RACE = """
import threading
import ray_tpu_torch as rt
from ray_tpu_torch.core import core_worker

barrier = threading.Barrier(8)
refs, runtimes = [None] * 8, set()


def first_call(i):
    barrier.wait()
    refs[i] = rt.put(i)  # the process's first API call, in eight threads
    runtimes.add(id(core_worker.get_runtime()))


threads = [threading.Thread(target=first_call, args=(i,)) for i in range(8)]
[t.start() for t in threads]
[t.join(60) for t in threads]
assert len(runtimes) == 1, runtimes
assert rt.get(refs, timeout=10) == list(range(8))
rt.shutdown()
print("ONE_RUNTIME")
"""


def test_threads_racing_into_the_first_call_share_one_runtime():
    # ROADMAP C22: the reference's init takes no lock, so threads that make
    # a process's first API call at once each start a runtime, and a ref
    # put into one is waited for in another until the get times out
    # (tests/test_torch_disagg.py's eight concurrent prefills on a fresh
    # xdist worker). The port starts one runtime under api._init_lock.
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, RAY_TPU_WORKER_PROCESSES="0", RAY_TPU_ACTOR_PROCESSES="0",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _RACE], capture_output=True, text=True,
                         timeout=120, env=env, cwd=repo)
    assert out.returncode == 0 and "ONE_RUNTIME" in out.stdout, out.stderr[-2000:]
