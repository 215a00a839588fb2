"""Core microbenchmarks (reference: `python/ray/_private/ray_perf.py`,
surfaced as `ray microbenchmark`): throughput canaries for the task/actor
planes, printed as one JSON line per pattern.

Patterns mirror the reference harness: single-client sync tasks, batched
task fan-out, 1:1 sync actor calls, async (pipelined) actor calls, n:n
actor round-robin, put/get round trips. Numbers are single-machine
canaries — regressions in scheduler/dispatch overhead show up here long
before they show up in end-to-end workloads.

The port's copy of ray_tpu/microbenchmark.py. The cross-host patterns
(`bench_cross_host`) join a worker OS process to an RPC-serving head.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List


def _rate(n: int, seconds: float) -> float:
    return n / seconds if seconds > 0 else float("inf")


def _timeit(fn: Callable[[], int], min_seconds: float = 2.0) -> float:
    """Run fn (returns ops done) until min_seconds elapse; -> ops/s."""
    # warmup pass pays one-time costs (pool spawn, code paths)
    fn()
    total_ops = 0
    start = time.monotonic()
    while True:
        total_ops += fn()
        elapsed = time.monotonic() - start
        if elapsed >= min_seconds:
            return _rate(total_ops, elapsed)


def bench_tasks_sync(api, batch: int = 1, min_seconds: float = 2.0) -> float:
    @api.remote
    def nop():
        return 0

    def run():
        if batch == 1:
            for _ in range(50):
                api.get(nop.remote(), timeout=60)
            return 50
        api.get([nop.remote() for _ in range(batch)])
        return batch

    return _timeit(run, min_seconds)


def bench_actor_sync(api, min_seconds: float = 2.0) -> float:
    @api.remote(in_process=True)
    class A:
        def m(self):
            return 0

    a = A.remote()

    def run():
        for _ in range(100):
            api.get(a.m.remote())
        return 100

    try:
        return _timeit(run, min_seconds)
    finally:
        api.kill(a)  # release the actor's CPU before the next pattern


def bench_actor_process_sync(api, min_seconds: float = 2.0) -> float:
    @api.remote
    class A:
        def m(self):
            return 0

    a = A.remote()

    def run():
        for _ in range(100):
            api.get(a.m.remote())
        return 100

    try:
        return _timeit(run, min_seconds)
    finally:
        api.kill(a)


def bench_actor_async(api, window: int = 64, min_seconds: float = 2.0) -> float:
    @api.remote(in_process=True)
    class A:
        def m(self):
            return 0

    a = A.remote()

    def run():
        api.get([a.m.remote() for _ in range(window)])
        return window

    try:
        return _timeit(run, min_seconds)
    finally:
        api.kill(a)


def bench_actors_nn(api, n: int = 4, window: int = 64, min_seconds: float = 2.0) -> float:
    # n actors at num_cpus=0: the pattern measures call routing, not
    # placement, and must fit single-CPU hosts
    @api.remote(in_process=True, num_cpus=0)
    class A:
        def m(self):
            return 0

    actors = [A.remote() for _ in range(n)]

    def run():
        refs = [actors[i % n].m.remote() for i in range(window)]
        api.get(refs)
        return window

    try:
        return _timeit(run, min_seconds)
    finally:
        for a in actors:
            api.kill(a)


def bench_put_get(api, nbytes: int = 1024, min_seconds: float = 2.0) -> float:
    payload = b"x" * nbytes

    def run():
        refs = [api.put(payload) for _ in range(100)]
        api.get(refs)
        return 100

    return _timeit(run, min_seconds)


def bench_cross_host(api, min_seconds: float = 2.0) -> List[tuple]:
    """Cross-host dispatch plane: RemoteNodeAgent
    submit round-trip rate/latency and transfer-plane pull MB/s against a
    REAL joined worker OS process. These are the numbers that decide
    whether 8-host orchestration overhead is noise or bottleneck
    (reference: `_private/ray_perf.py` multi-node patterns)."""
    import os
    import subprocess
    import sys
    import textwrap
    import time as _time

    api.shutdown()  # the dispatch plane needs the RPC-serving head
    rt = api.init(num_cpus=1, num_gpus=0, system_config={
        "control_plane_rpc_port": 0, "worker_processes": 0})
    addr = rt._cp_server.address
    env = dict(os.environ)
    env["RAY_TPU_WORKER_PROCESSES"] = "0"
    env.setdefault("RAY_TPU_LOG_LEVEL", "WARNING")
    # the joiner must import THIS checkout regardless of the caller's cwd
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
    code = textwrap.dedent(f"""
        import ray_tpu_torch
        w = ray_tpu_torch.init(address={addr!r}, num_cpus=4, num_gpus=0,
                               resources={{"xbench": 1.0}})
        w.wait(timeout=600)
    """)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.STDOUT)
    deadline = _time.monotonic() + 60
    joined = False
    while _time.monotonic() < deadline:
        if any("xbench" in n.resources_total
               for n in rt.control_plane.alive_nodes()):
            joined = True
            break
        if proc.poll() is not None:
            break
        _time.sleep(0.1)
    if not joined:
        proc.kill()
        raise RuntimeError(
            "cross-host bench worker never joined "
            f"(exit={proc.poll()}); cannot measure the dispatch plane")

    @api.remote(num_cpus=0, resources={"xbench": 0.01})
    def nop():
        return 0

    @api.remote(num_cpus=0, resources={"xbench": 0.01})
    def blob(n):
        return b"x" * n

    try:
        def sync_run():
            for _ in range(20):
                api.get(nop.remote(), timeout=60)
            return 20

        sync_rate = _timeit(sync_run, min_seconds)

        def batch_run():
            api.get([nop.remote() for _ in range(64)], timeout=120)
            return 64

        batch_rate = _timeit(batch_run, min_seconds)

        nbytes = 4 << 20
        ref = blob.remote(nbytes)
        api.get(ref, timeout=60)  # produced; every further get is a fresh pull

        def pull_run():
            for _ in range(4):
                api.get(ref, timeout=60)
            return 4

        pulls_per_s = _timeit(pull_run, min_seconds)
        return [
            ("xhost_task_roundtrip", sync_rate, "tasks/s"),
            ("xhost_task_rtt_ms", 1000.0 / max(sync_rate, 1e-9), "ms"),
            ("xhost_task_batch_64", batch_rate, "tasks/s"),
            ("xhost_pull_mb_s", pulls_per_s * nbytes / (1 << 20), "MB/s"),
        ]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()


def run_all(min_seconds: float = 2.0) -> List[Dict[str, Any]]:
    import ray_tpu_torch as api

    api.init()
    s = min_seconds
    rows = [
        ("tasks_sync_1client", bench_tasks_sync(api, 1, min_seconds=s), "tasks/s"),
        ("tasks_batch_64", bench_tasks_sync(api, 64, min_seconds=s), "tasks/s"),
        ("actor_calls_sync", bench_actor_sync(api, min_seconds=s), "calls/s"),
        ("actor_calls_sync_isolated", bench_actor_process_sync(api, min_seconds=s), "calls/s"),
        ("actor_calls_async_64", bench_actor_async(api, min_seconds=s), "calls/s"),
        ("actor_calls_4actors", bench_actors_nn(api, min_seconds=s), "calls/s"),
        ("put_get_1kb", bench_put_get(api, 1024, min_seconds=s), "ops/s"),
        ("put_get_1mb", bench_put_get(api, 1 << 20, min_seconds=s), "ops/s"),
    ]
    # cross-host plane LAST: it recycles the runtime (RPC-serving head)
    rows.extend(bench_cross_host(api, min_seconds=s))
    out = []
    for name, value, unit in rows:
        rec = {"metric": f"micro_{name}", "value": round(value, 1), "unit": unit}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    run_all()
