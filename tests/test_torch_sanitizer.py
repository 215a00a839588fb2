"""The concurrency sanitizer (ray_tpu_torch/util/sanitizer.py) against the
reference's, on the CPU.

Each flow of tests/test_sanitizer.py runs under both packages, one
sanitizer installed at a time (each swaps `threading.Lock`/`RLock` for the
whole process) and always uninstalled in the fixture's `finally`: an AB/BA
inversion reported once with the same cycle, a consistent order silent, a
long hold reported to the flight recorder, Condition/Event/Queue and a
fresh ThreadPoolExecutor on tracked primitives, RLock reentrancy,
`_at_fork_reinit`, and the thread-leak checker. Then the port's own: with
RAY_TPU_SANITIZE=1 `import ray_tpu_torch` arms it, and the runtime (thread
lanes and a forkserver pool task) runs under it without a lock-order
cycle.
"""

import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

import ray_tpu.util.flight_recorder as jfr
import ray_tpu.util.sanitizer as jsan
import ray_tpu_torch.util.flight_recorder as tfr
import ray_tpu_torch.util.sanitizer as tsan
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

PKGS = {"ray_tpu": (jsan, jfr), "ray_tpu_torch": (tsan, tfr)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=list(PKGS))
def sanitized(request):
    """One package's sanitizer with a 50 ms hold budget; stock primitives
    restored whatever the test does."""
    san, fr = PKGS[request.param]
    assert threading.Lock is san._real_Lock and threading.RLock is san._real_RLock
    san.install(hold_ms=50)
    san.clear_reports()
    try:
        yield san, fr
    finally:
        san.uninstall()
        san.clear_reports()
    assert threading.Lock is san._real_Lock and threading.RLock is san._real_RLock


def _inversion():
    a, b = threading.Lock(), threading.Lock()

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    for fn in (ab, ba, ab, ba):  # the second round adds no report
        t = threading.Thread(target=fn)
        t.start()
        t.join(5)


def test_ab_ba_inversion_is_reported_once_with_the_same_cycle():
    cycles = {}
    for name, (san, _fr) in PKGS.items():
        san.install(hold_ms=50)
        san.clear_reports()
        try:
            _inversion()
            cycles[name] = [(r["cycle"], r["new_edge"]) for r in san.reports()
                            if r["violation"] == "lock_order_cycle"]
        finally:
            san.uninstall()
            san.clear_reports()
    assert len(cycles["ray_tpu"]) == 1
    assert cycles["ray_tpu_torch"] == cycles["ray_tpu"]


def test_consistent_order_is_silent(sanitized):
    san, _fr = sanitized
    a, b = threading.Lock(), threading.Lock()
    for _ in range(3):
        with a:
            with b:
                pass
    assert san.reports() == []


def test_long_hold_reaches_the_flight_recorder(sanitized):
    san, fr = sanitized
    lock = threading.Lock()
    with lock:
        time.sleep(0.08)  # raylint: disable=R2 — the violation IS the test (budget 50ms)
    with lock:
        pass
    holds = [r for r in san.reports() if r["violation"] == "lock_hold"]
    assert len(holds) == 1 and holds[0]["held_ms"] > 50 and holds[0]["budget_ms"] == 50.0
    assert holds[0]["site"].endswith(f"{os.path.basename(__file__)}:{_line_of('lock = threading.Lock()')}")
    assert any(e["kind"] == "sanitizer" and e.get("violation") == "lock_hold"
               for e in fr.snapshot())


def _line_of(text: str) -> int:
    with open(__file__) as f:
        return next(i for i, line in enumerate(f, 1) if line.strip() == text)


def test_condition_event_queue_and_executor_on_tracked_primitives(sanitized):
    import queue

    q = queue.Queue()
    q.put("x")
    assert q.get(timeout=1) == "x"
    ev = threading.Event()
    ev.set()
    assert ev.wait(0.5)
    cv = threading.Condition()
    woke = []

    def waiter():
        with cv:
            cv.wait(timeout=2)
            woke.append(1)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        cv.notify_all()
    t.join(5)
    assert woke
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if k.startswith("concurrent.futures")}
    try:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=2)
        try:
            assert pool.submit(lambda: 21 * 2).result(timeout=5) == 42
        finally:
            pool.shutdown(wait=True)
    finally:
        sys.modules.update(saved)


def test_rlock_reentrancy_and_at_fork_reinit(sanitized):
    san, _fr = sanitized
    rl = threading.RLock()
    with rl:
        with rl:
            pass
    lk = threading.Lock()
    lk.acquire()
    lk._at_fork_reinit()
    assert not lk.locked() and lk.acquire(blocking=False)
    lk.release()
    rl.acquire()
    rl._at_fork_reinit()
    assert rl.acquire(blocking=False)
    rl.release()
    assert san.reports() == []


@pytest.mark.parametrize("pkg", list(PKGS))
def test_the_thread_leak_checker_is_the_references(pkg):
    san = PKGS[pkg][0]
    assert not san.installed()
    before = san.thread_snapshot()
    release = threading.Event()
    t = threading.Thread(target=release.wait, name="deliberate-leak")
    daemons = [threading.Thread(target=release.wait, daemon=True) for _ in range(5)]
    t.start()
    for d in daemons:
        d.start()
    try:
        problems = san.check_thread_leaks(before, grace_s=0.2, daemon_growth_max=3)
        assert len(problems) == 2
        assert "deliberate-leak" in problems[0] and "daemon" in problems[1]
    finally:
        release.set()
        for th in [t, *daemons]:
            th.join(5)
    assert san.check_thread_leaks(before, grace_s=0.5) == []


def test_the_environment_arms_it_at_import_and_the_runtime_runs_without_a_cycle():
    code = textwrap.dedent("""
        import json, os, threading
        import ray_tpu_torch as rt
        from ray_tpu_torch.util import sanitizer
        assert sanitizer.installed() and threading.Lock is not sanitizer._real_Lock
        rt.init(num_cpus=2, system_config={"worker_processes": 1, "get_concurrency": 1})

        @rt.remote
        def child():
            return os.getpid()

        @rt.remote(in_process=True)
        class Counter:
            def __init__(self):
                self.n = 0
                self.lock = threading.Lock()

            def add(self, k):
                with self.lock:
                    self.n += k
                    return self.n

        c = Counter.remote()
        out = rt.get([c.add.remote(i) for i in range(20)], timeout=30)
        pid = rt.get(child.remote(), timeout=30)
        rt.shutdown()
        reports = sanitizer.reports()
        print(json.dumps({"sum": out[-1], "child": pid != os.getpid(),
                          "cycles": [r for r in reports
                                     if r["violation"] == "lock_order_cycle"]}))
    """)
    env = dict(os.environ, RAY_TPU_SANITIZE="1", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=30)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"sum": 190, "child": True, "cycles": []}
