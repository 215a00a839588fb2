"""Core microbenchmarks (reference: `python/ray/_private/ray_perf.py`,
surfaced as `ray microbenchmark`): throughput canaries for the task/actor
planes, printed as one JSON line per pattern.

Patterns mirror the reference harness: single-client sync tasks, batched
task fan-out, 1:1 sync actor calls, async (pipelined) actor calls, n:n
actor round-robin, put/get round trips. Numbers are single-machine
canaries — regressions in scheduler/dispatch overhead show up here long
before they show up in end-to-end workloads.

The port's copy of ray_tpu/microbenchmark.py. The cross-host patterns
(`bench_cross_host`) wait for ROADMAP A5c and raise.
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
    """The reference's cross-host dispatch plane patterns (a joined worker
    OS process: submit round trips and transfer-plane pulls) need
    init(address=...) and the RPC-serving head, which wait for ROADMAP
    A5c (the network slice)."""
    raise NotImplementedError(
        "bench_cross_host: joining a worker host over RPC "
        "(core/cross_host.py) waits for ROADMAP A5c")


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
    # the reference appends bench_cross_host's rows here; the cross-host
    # plane waits for ROADMAP A5c, so those rows are left out
    out = []
    for name, value, unit in rows:
        rec = {"metric": f"micro_{name}", "value": round(value, 1), "unit": unit}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    run_all()
