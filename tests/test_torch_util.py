"""The port's user utilities (ray_tpu_torch.util: ActorPool, Queue, Pool)
against ray_tpu.util, on the CPU.

Each flow of tests/test_platform.py's TestUtil and TestMultiprocessingPool
(the actor pool, the queue, and Pool's map, starmap/apply/apply_async,
imap/imap_unordered, the initializer, a closed pool, processes=1 serial)
runs under both packages in turn, each on its own runtime in thread mode,
and the results must be equal. Every blocking call carries a timeout.
"""

import os
import time
import uuid

import pytest

import ray_tpu
import ray_tpu.util as jutil
import ray_tpu_torch
import ray_tpu_torch.util as tutil
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
PACKAGES = {"ray_tpu": (ray_tpu, jutil), "ray_tpu_torch": (ray_tpu_torch, tutil)}


def run(name, flow, *args):
    api, util = PACKAGES[name]
    api.shutdown()
    api.init(num_cpus=8, system_config=dict(THREAD_MODE))
    try:
        return flow(api, util, *args)
    finally:
        api.shutdown()


def both(flow, *args):
    return run("ray_tpu_torch", flow, *args), run("ray_tpu", flow, *args)


def _square(x):
    return x * x


def _add(a, b):
    return a + b


def _mark(d):
    with open(os.path.join(d, uuid.uuid4().hex), "w") as f:
        f.write("x")


def _timespan(_):
    s = time.monotonic()
    time.sleep(0.05)
    return (s, time.monotonic())


# ------------------------------------------------------------------ flows


def actor_pool(api, util):
    @api.remote
    class Worker:
        def work(self, x):
            return x * 2

    pool = util.ActorPool([Worker.remote() for _ in range(2)])
    unordered = sorted(pool.map_unordered(lambda a, v: a.work.remote(v), range(8)))
    ordered = list(pool.map(lambda a, v: a.work.remote(v), range(5)))
    pool.submit(lambda a, v: a.work.remote(v), 21)
    nxt = pool.get_next_unordered(timeout=30)
    return unordered, ordered, nxt, pool.has_next()


def queue(api, util):
    from importlib import import_module

    qmod = import_module(util.__name__ + ".queue")
    q = util.Queue(maxsize=2)
    q.put("a", timeout=10)
    q.put("b", timeout=10)
    size = q.qsize()
    with pytest.raises(qmod.Full):
        q.put_nowait("c")
    got = [q.get(timeout=10), q.get(timeout=10)]
    with pytest.raises(qmod.Empty):
        q.get_nowait()
    empty = q.empty()
    q.shutdown()
    return size, got, empty


def pool_map(api, util):
    with util.Pool(processes=4) as pool:
        return pool.map(_square, range(12)), pool.map(_square, range(5), chunksize=2)


def pool_starmap_apply(api, util):
    with util.Pool() as pool:
        res = pool.apply_async(_add, (7, 8))
        out = (pool.starmap(_add, [(1, 2), (3, 4)]), pool.apply(_add, (5, 6)),
               res.get(timeout=60))
        res.wait(timeout=60)
        return out + (res.ready(), res.successful(),
                      pool.map_async(_square, range(6)).get(timeout=60))


def pool_imap(api, util):
    with util.Pool() as pool:
        return (list(pool.imap(_square, range(8), chunksize=3)),
                sorted(pool.imap_unordered(_square, range(8), chunksize=2)))


def pool_initializer(api, util, d):
    os.makedirs(d)
    with util.Pool(initializer=_mark, initargs=(d,)) as pool:
        out = pool.map(_square, [3], chunksize=1)
    return out, len(os.listdir(d))


def pool_closed(api, util):
    pool = util.Pool()
    pool.close()
    pool.join()
    with pytest.raises(ValueError):
        pool.map(_square, [1])
    with pytest.raises(ValueError):
        pool.apply_async(_add, (1, 2))
    return True


def pool_serial(api, util):
    with util.Pool(processes=1) as pool:
        spans = sorted(pool.map(_timespan, range(4), chunksize=1))
    return all(e1 <= s2 + 1e-3 for (_, e1), (s2, _) in zip(spans, spans[1:]))


FLOWS = {f.__name__: f for f in (actor_pool, queue, pool_map, pool_starmap_apply, pool_imap,
                                 pool_closed, pool_serial)}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_util_flow_matches_reference(flow):
    got, want = both(FLOWS[flow])
    assert got == want


def test_pool_initializer_matches_reference(tmp_path):
    got = run("ray_tpu_torch", pool_initializer, str(tmp_path / "port"))
    want = run("ray_tpu", pool_initializer, str(tmp_path / "ref"))
    assert got == want and got[0] == [9] and got[1] >= 1


def test_flow_outcomes_are_the_reference_tests_asserts():
    unordered, ordered, nxt, more = run("ray_tpu_torch", actor_pool)
    assert unordered == [x * 2 for x in range(8)] and ordered == [0, 2, 4, 6, 8]
    assert nxt == 42 and more is False
    assert run("ray_tpu_torch", queue) == (2, ["a", "b"], True)
    assert run("ray_tpu_torch", pool_map)[0] == [i * i for i in range(12)]
    assert run("ray_tpu_torch", pool_starmap_apply) == ([3, 7], 11, 15, True, True,
                                                        [0, 1, 4, 9, 16, 25])
    assert run("ray_tpu_torch", pool_serial) is True


def test_exports_are_the_references():
    assert {n for n in vars(tutil) if not n.startswith("_")} >= {"ActorPool", "Pool", "Queue"}
    for name in ("ActorPool", "Pool", "Queue"):
        assert getattr(tutil, name).__module__.startswith("ray_tpu_torch.util.")
