"""The worker-process pool (ray_tpu_torch.core.process_pool) against the
reference's, on the CPU.

Each flow of tests/test_process_pool.py runs under both packages, each on
one runtime for the module with `worker_processes=2` and actor processes on
(the reference's defaults, and the port's since it took them), and the two
results must be equal: pids out of the driver's process, numpy through the
shm arena, a user exception, a crash that fails only its task, retries, the
unserializable and actor-handle fallbacks with their counter, the four
mutation-isolation cases, `kill_newest_worker`, the memory monitor under
injected pressure and `env_vars`. Then the port's own rules: a payload with
a tensor off the CPU (`meta` stands in for CUDA) runs in the driver's
process and counts as a fallback, a pool that cannot be created raises
(the reference stays on threads), and a data pipeline of tasks and an actor
pool gives the reference's rows in process mode. Every wait is bounded; the
runtimes stop at the module's end, and no process may outlive it.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.core.core_worker as jcw
import ray_tpu.core.memory_monitor as jmm
import ray_tpu.core.node_agent as jagent
import ray_tpu.core.process_pool as jpp
import ray_tpu.data as jdata
import ray_tpu.util.multiprocessing as jmp
import ray_tpu_torch
import ray_tpu_torch.core.core_worker as tcw
import ray_tpu_torch.core.memory_monitor as tmm
import ray_tpu_torch.core.node_agent as tagent
import ray_tpu_torch.core.process_pool as tpp
import ray_tpu_torch.data as tdata
import ray_tpu_torch.util.multiprocessing as tmp_
from _torch_fixtures import (  # noqa: F401
    _fresh_metric_registries,
    boot_forkserver,
    no_process_left,
)

# get_concurrency 1: a batched get stays on the caller's thread, so the
# module's runtimes start no get pool the per-test thread-leak guard sees
PROCESS_MODE = {"worker_processes": 2, "actor_processes": True, "get_concurrency": 1}
WAIT_S = 60
PKGS = {"ray_tpu": (ray_tpu, jcw, jpp, jmm, jagent, jdata, jmp),
        "ray_tpu_torch": (ray_tpu_torch, tcw, tpp, tmm, tagent, tdata, tmp_)}


@pytest.fixture(scope="module")
def runtimes(no_process_left):
    boot_forkserver()
    for api, *_ in PKGS.values():
        api.shutdown()
        api.init(num_cpus=4, system_config=dict(PROCESS_MODE))
    try:
        yield
    finally:
        ray_tpu.shutdown()  # first: the port's shutdown ends the forkserver once idle
        ray_tpu_torch.shutdown()


class Pkg:
    def __init__(self, name):
        self.name = name
        self.api, self.cw, self.pp, self.mm, self.agent, self.data, self.mp = PKGS[name]

    def pool(self):
        return self.cw.get_runtime().driver_agent._ensure_pool()

    def fallbacks(self) -> float:
        return sum(v for _, _, v in self.agent._pool_fallback_counter.samples())


def both(flow):
    return flow(Pkg("ray_tpu_torch")), flow(Pkg("ray_tpu"))


def _getpid(*_):
    return os.getpid()


def _double(arr):
    return arr * 2


def _raise_value_error(msg):
    raise ValueError(msg)


def _die(code):
    os._exit(code)


def _sleep_for(s):
    time.sleep(s)
    return "done"


# ------------------------------------------------------------------- flows


def pool_runs_out_of_process(p):
    return p.pool().run(_getpid, (), {}) != os.getpid()


def numpy_through_shm(p):
    arr = np.random.default_rng(0).standard_normal(1 << 20).astype(np.float32)  # 4 MiB
    pool = p.pool()
    out = pool.run(_double, (arr,), {})
    deadline = time.monotonic() + 5  # the lane deletes return buffers after the caller wakes
    while pool.store.live_bytes() != 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    return out.tobytes(), pool.store.live_bytes()


def user_exception(p):
    try:
        p.pool().run(_raise_value_error, ("boom",), {})
    except ValueError as e:
        return str(e)


def crash_fails_only_its_task(p):
    try:
        p.pool().run(_die, (3,), {})
        crashed = None
    except p.pp.WorkerProcessCrash as e:
        crashed = "exitcode 3" in str(e)
    return crashed, p.pool().run(_getpid, (), {}) != os.getpid()


def closure_serializes(p):
    x = 41
    return p.pool().run(lambda: x + 1, (), {})


def unserializable_raises_typed_error(p):
    lock = threading.Lock()
    try:
        p.pool().run(lambda: lock.locked(), (), {})
    except p.pp.TaskNotSerializableError:
        return "TaskNotSerializableError"


def task_chain_and_numpy(p):
    api = p.api

    @api.remote
    def add(a, b):
        return a + b

    @api.remote
    def scale(a):
        return a * 3.0

    arr = np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32)
    return (api.get(add.remote(add.remote(1, 2), 10), timeout=WAIT_S),
            api.get(scale.remote(arr), timeout=WAIT_S).tobytes())


def worker_crash_fails_only_that_task(p):
    api = p.api

    @api.remote(max_retries=0)
    def die():
        os._exit(5)

    @api.remote
    def ok():
        return "alive"

    try:
        api.get(die.remote(), timeout=WAIT_S)
        err = None
    except Exception as e:  # noqa: BLE001 — the types are compared across packages
        err = type(e).__name__
    return err, api.get(ok.remote(), timeout=WAIT_S)


def crash_retries_then_succeeds(p, tmp_dir):
    api = p.api
    marker = os.path.join(tmp_dir, f"crashed-{p.name}")

    @api.remote(max_retries=2)
    def crash_once():
        if not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("x")
            os._exit(9)
        return "recovered"

    return api.get(crash_once.remote(), timeout=WAIT_S)


def actor_state_pinned_to_its_process(p):
    api = p.api

    @api.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n, os.getpid()

    c = Counter.remote()
    (n1, home), (n2, again) = api.get([c.incr.remote(), c.incr.remote()], timeout=WAIT_S)
    pinned = Counter.options(in_process=True).remote()
    _, driver = api.get(pinned.incr.remote(), timeout=WAIT_S)
    api.kill(c)
    api.kill(pinned)
    return n1, n2, home != os.getpid(), home == again, driver == os.getpid()


def api_inside_worker_raises(p):
    api = p.api

    @api.remote(max_retries=0)
    def bad():
        return api.put(42)

    try:
        api.get(bad.remote(), timeout=WAIT_S)
    except Exception as e:  # noqa: BLE001
        return "not available inside" in str(e)


def actor_handle_arg_falls_back(p):
    api = p.api

    @api.remote
    class KV:
        def __init__(self):
            self.v = {}

        def put(self, k, val):
            self.v[k] = val
            return "stored"

    @api.remote
    def writer(store):
        return api.get(store.put.remote("k", 1), timeout=WAIT_S), os.getpid()

    kv = KV.remote()
    before = p.fallbacks()
    got, pid = api.get(writer.remote(kv), timeout=WAIT_S)
    api.kill(kv)
    return got, pid == os.getpid(), p.fallbacks() - before


def unserializable_falls_back(p):
    api = p.api
    lock = threading.Lock()

    @api.remote
    def uses_lock():
        return ("locked", lock.locked(), os.getpid())

    before = p.fallbacks()
    tag, locked, pid = api.get(uses_lock.remote(), timeout=WAIT_S)
    return tag, locked, pid == os.getpid(), p.fallbacks() - before


def consumer_mutation(p):
    api = p.api

    @api.remote
    def make():
        return {"xs": [1, 2, 3]}

    ref = make.remote()
    api.get(ref, timeout=WAIT_S)["xs"].append(99)  # a consumer mutates its copy
    return api.get(ref, timeout=WAIT_S)


def producer_mutation(p):
    api = p.api
    lock = threading.Lock()  # unpicklable: the task runs in-process, keeping its output
    kept = {}

    @api.remote
    def produce():
        assert lock is not None
        out = {"xs": [1, 2, 3]}
        kept["out"] = out
        return out

    ref = produce.remote()
    first = api.get(ref, timeout=WAIT_S)
    kept["out"]["xs"].append(99)  # the producer mutates after the seal
    return first, api.get(ref, timeout=WAIT_S)


def put_then_mutate(p):
    value = {"xs": [1, 2, 3]}
    ref = p.api.put(value)
    value["xs"].append(99)
    return p.api.get(ref, timeout=WAIT_S)


def mutated_task_arg(p):
    api = p.api
    ref = api.put({"xs": [1, 2, 3]})

    @api.remote
    def mutate(d):
        d["xs"].append(99)
        return len(d["xs"])

    return api.get(mutate.remote(ref), timeout=WAIT_S), api.get(ref, timeout=WAIT_S)


def kill_newest_worker(p):
    pool, results = p.pool(), {}

    def run(name, dur):
        try:
            results[name] = pool.run(_sleep_for, (dur,), {})
        except p.pp.WorkerProcessCrash as e:
            results[name] = type(e).__name__

    old = threading.Thread(target=run, args=("old", 2.5))
    old.start()
    time.sleep(0.3)  # "old" starts first
    new = threading.Thread(target=run, args=("new", 2.5))
    new.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        with pool._inflight_lock:
            if len(pool._inflight) == 2:
                break
        time.sleep(0.02)
    killed = pool.kill_newest_worker()
    old.join(timeout=WAIT_S)
    new.join(timeout=WAIT_S)
    return killed is not None, results["old"], results["new"], pool.run(_getpid, (), {}) > 0


def memory_monitor_under_pressure(p):
    pool, pressure = p.pool(), {"on": True}

    def kill_and_relieve():
        pid = pool.kill_newest_worker()
        if pid is not None:
            pressure["on"] = False  # the kill "reclaimed" memory
        return pid

    monitor = p.mm.MemoryMonitor(kill_and_relieve, threshold=0.95, interval_s=0.05,
                                 probe=lambda: 0.99 if pressure["on"] else 0.1)
    before = p.mm._m_killed.get()
    monitor.start()
    try:
        pool.run(_sleep_for, (5.0,), {})
        crashed = False
    except p.pp.WorkerProcessCrash:
        crashed = True
    finally:
        monitor.stop()
    return crashed, p.mm._m_killed.get() - before, pool.run(_sleep_for, (0.01,), {})


def env_vars_isolate_a_task(p):
    api = p.api

    @api.remote(runtime_env={"env_vars": {"RTT_POOL_FLAG": "on"}})
    def read():
        return os.environ.get("RTT_POOL_FLAG"), os.getpid()

    value, pid = api.get(read.remote(), timeout=WAIT_S)
    return value, pid != os.getpid(), os.environ.get("RTT_POOL_FLAG")


def pool_map_runs_in_workers(p):
    with p.mp.Pool(processes=2) as pool:
        pids = pool.map(_getpid, range(4))
    return all(pid != os.getpid() for pid in pids)


FLOWS = [pool_runs_out_of_process, numpy_through_shm, user_exception,
         crash_fails_only_its_task, closure_serializes, unserializable_raises_typed_error,
         task_chain_and_numpy, worker_crash_fails_only_that_task,
         actor_state_pinned_to_its_process, api_inside_worker_raises,
         actor_handle_arg_falls_back, unserializable_falls_back, consumer_mutation,
         producer_mutation, put_then_mutate, mutated_task_arg, kill_newest_worker,
         memory_monitor_under_pressure, env_vars_isolate_a_task, pool_map_runs_in_workers]


@pytest.mark.parametrize("flow", FLOWS, ids=lambda f: f.__name__)
def test_flow_matches_reference(runtimes, flow):
    port, ref = both(flow)
    assert port == ref
    assert port not in (None, False)


def test_crash_retries_then_succeeds_as_in_the_reference(runtimes, tmp_path):
    port, ref = both(lambda p: crash_retries_then_succeeds(p, str(tmp_path)))
    assert port == ref == "recovered"


# ----------------------------------------------------------- the port's own


def _where(t):
    return os.getpid(), t.shape


def test_a_tensor_off_the_cpu_runs_in_the_driver_and_counts(runtimes):
    p = Pkg("ray_tpu_torch")
    task = ray_tpu_torch.remote(_where)
    before = p.fallbacks()
    pid, shape = ray_tpu_torch.get(task.remote(torch.empty(4, 8, device="meta")),
                                   timeout=WAIT_S)
    assert pid == os.getpid() and tuple(shape) == (4, 8)
    assert p.fallbacks() - before == 1
    # a CPU tensor crosses: it runs in a worker, no fallback
    pid, _ = ray_tpu_torch.get(task.remote(torch.ones(3)), timeout=WAIT_S)
    assert pid != os.getpid() and p.fallbacks() - before == 1
    with pytest.raises(tpp.TaskNotSerializableError, match="CUDA never starts"):
        tpp._cloudpickle_dumps({"w": [torch.empty(2, device="meta")]})


def test_a_pool_that_cannot_be_created_raises(runtimes, monkeypatch):
    from ray_tpu_torch.core import shm_store

    monkeypatch.setattr(shm_store, "shm_free_bytes", lambda: 0)
    with pytest.raises(shm_store.ShmStoreError, match="/dev/shm"):
        tpp.ProcessPool(1, store_name="/rtt_pool_refused")
    # through a node agent that has no pool yet: it raises, naming the
    # cause, instead of staying on threads as the reference does
    monkeypatch.setattr(tpp, "acquire_shared_pool", lambda n: tpp.ProcessPool(n))
    rt = tcw.get_runtime()
    agent = rt.add_node(resources={"CPU": 1.0})
    try:
        with pytest.raises(shm_store.ShmStoreError, match="/dev/shm"):
            agent._ensure_pool()
    finally:
        rt.remove_node(agent.node_id)


def _fails():
    raise ValueError("upstream")


def _consume(x):
    return x


class _Consumer:
    def take(self, x):
        return x


def test_a_task_whose_argument_failed_fails_with_it(runtimes):
    # ROADMAP C19: a task or actor call waiting on the result of a task that
    # failed for good fails with its error; the reference's wait forever
    up = ray_tpu_torch.remote(_fails).options(max_retries=0).remote()
    down = ray_tpu_torch.remote(_consume).remote(up)
    with pytest.raises(ray_tpu_torch.RayTaskError, match="upstream"):
        ray_tpu_torch.get(down, timeout=WAIT_S)
    actor = ray_tpu_torch.remote(_Consumer).remote()
    with pytest.raises(ray_tpu_torch.RayTaskError, match="upstream"):
        ray_tpu_torch.get(actor.take.remote(up), timeout=WAIT_S)
    assert ray_tpu_torch.get(actor.take.remote(3), timeout=WAIT_S) == 3
    ray_tpu_torch.kill(actor)


def _pack(batch):
    ids = batch["ids"]
    return {"ids": ids, "pid": np.full(len(ids), os.getpid())}


class _Shift:
    def __init__(self):
        self.pid = os.getpid()

    def __call__(self, batch):
        ids = batch["ids"]
        return {"tokens": ids[:, :-1], "targets": ids[:, 1:],
                "task_pid": batch["pid"], "actor_pid": np.full(len(ids), self.pid)}


def test_data_pipeline_rows_equal_the_reference_in_process_mode(runtimes):
    rows = np.random.default_rng(0).integers(0, 512, (24, 9)).astype(np.int32)

    def run(p):
        ds = (p.data.from_numpy({"ids": rows}, parallelism=4)
              .map_batches(_pack)
              .map_batches(_Shift, compute="actors", concurrency=2))
        return list(ds.iter_batches(batch_size=6))

    port, ref = both(run)
    for key in ("tokens", "targets"):
        np.testing.assert_array_equal(np.concatenate([b[key] for b in port]),
                                      np.concatenate([b[key] for b in ref]))
        np.testing.assert_array_equal(np.concatenate([b[key] for b in port]),
                                      rows[:, :-1] if key == "tokens" else rows[:, 1:])
    # the port's packing tasks ran in workers, its pool actors in actor processes
    assert os.getpid() not in np.concatenate([b["task_pid"] for b in port])
    assert os.getpid() not in np.concatenate([b["actor_pid"] for b in port])
