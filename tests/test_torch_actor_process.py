"""Actor processes (ray_tpu_torch.core.actor_process) against the
reference's, on the CPU.

Each flow of tests/test_actor_process.py runs under both packages, each on
one runtime for the module with actor processes on and `worker_processes=2`
(the reference's defaults), and the results must be equal: a CPU actor's
state and calls in its own process, a user exception with its message, a
hard crash that surfaces as `ActorProcessCrash` and ends only that actor, a
restart under `max_restarts` in a fresh process, async, high-concurrency
and device actors staying in the driver's process, the unpicklable-state
fallback and its refusal under `in_process=False`, and a killed actor's
process gone. Then the port's own rules: a device actor cannot be forced
into a process, a creation argument with a tensor off the CPU keeps the
actor in-process, and (in a subprocess) every process of the runtime dies
with a SIGKILLed driver.
"""

import json
import os
import select
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.core.actor_process as jap
import ray_tpu.core.core_worker as jcw
import ray_tpu.core.node_agent as jagent
import ray_tpu_torch
import ray_tpu_torch.core.actor_process as tap
import ray_tpu_torch.core.core_worker as tcw
import ray_tpu_torch.core.node_agent as tagent
from _torch_fixtures import (  # noqa: F401
    _fresh_metric_registries,
    boot_forkserver,
    no_process_left,
)

# get_concurrency 1: a batched get stays on the caller's thread (no get pool
# for the per-test thread-leak guard to see on the module's runtimes)
PROCESS_MODE = {"worker_processes": 2, "actor_processes": True, "get_concurrency": 1}
WAIT_S = 60
# the accelerator: "TPU" in the reference, "GPU" in the port (accounting only here)
PKGS = {"ray_tpu": (ray_tpu, jcw, jap, jagent, "num_tpus"),
        "ray_tpu_torch": (ray_tpu_torch, tcw, tap, tagent, "num_gpus")}


@pytest.fixture(scope="module")
def runtimes(no_process_left):
    boot_forkserver()
    for api, _, _, _, accel in PKGS.values():
        api.shutdown()
        api.init(num_cpus=4, system_config=dict(PROCESS_MODE), **{accel: 1})
    try:
        yield
    finally:
        ray_tpu.shutdown()  # first: the port's shutdown ends the forkserver once idle
        ray_tpu_torch.shutdown()


class Pkg:
    def __init__(self, name):
        self.name = name
        self.api, self.cw, self.ap, self.agent, self.accel = PKGS[name]

    def modes(self) -> dict:
        return {dict(tags)["mode"]: v for _, tags, v in self.agent._actors_isolated_counter.samples()}


def both(flow):
    return flow(Pkg("ray_tpu_torch")), flow(Pkg("ray_tpu"))


def gone(pid: int, wait_s: float = 10.0) -> bool:
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.05)
    return False


class _Accumulator:
    def __init__(self, start):
        self.total = np.asarray(start, np.float64)

    def add(self, x):
        self.total = self.total + x
        return self.total.copy(), os.getpid()


class _Crashy:
    def boom(self):
        os._exit(13)  # segfault-equivalent: no cleanup, no excepthook

    def ok(self):
        return True


# ------------------------------------------------------------------- flows


def state_and_calls(p):
    api = p.api
    rng = np.random.default_rng(0)
    start, steps = rng.standard_normal(4), [rng.standard_normal(4) for _ in range(3)]
    a = api.remote(_Accumulator).remote(start)
    outs = [api.get(a.add.remote(x), timeout=WAIT_S) for x in steps]
    api.kill(a)
    pids = {pid for _, pid in outs}
    return [o.tobytes() for o, _ in outs], len(pids) == 1, os.getpid() not in pids


def exception_propagates(p):
    api = p.api

    @api.remote
    class Boom:
        def go(self):
            raise KeyError("kaput")

    b = Boom.remote()
    try:
        api.get(b.go.remote(), timeout=WAIT_S)
    except api.RayTaskError as e:
        return "kaput" in str(e)
    finally:
        api.kill(b)


def crash_surfaces_as_actor_process_crash(p):
    proc = p.ap.ActorProcess(_Crashy, (), {})
    try:
        assert proc.call("ok", (), {}, timeout=WAIT_S) is True
        try:
            proc.call("boom", (), {}, timeout=WAIT_S)
        except p.ap.ActorProcessCrash as e:
            crash = "exitcode 13" in str(e)
        return crash, proc.alive()
    finally:
        proc.terminate()


def hard_crash_kills_only_that_actor(p):
    api = p.api

    @api.remote
    class Bystander:
        def ping(self):
            return "alive"

    bomb, by = api.remote(_Crashy).remote(), Bystander.remote()
    out = [api.get(by.ping.remote(), timeout=WAIT_S)]
    for method in (bomb.boom, bomb.ok):  # a dead actor stays dead
        try:
            api.get(method.remote(), timeout=WAIT_S)
        except api.RayActorError:
            out.append("RayActorError")
    out.append(api.get(by.ping.remote(), timeout=WAIT_S))
    api.kill(by)
    return out


def restart_respawns_fresh_process(p, tmp_dir):
    api = p.api
    marker = os.path.join(tmp_dir, f"died-{p.name}")

    @api.remote(max_restarts=1, max_task_retries=1)
    class Phoenix:
        def pid_or_die(self, path):
            if not os.path.exists(path):
                open(path, "w").write("x")
                os._exit(7)  # the first attempt dies AFTER leaving the marker
            return os.getpid()

    ph = Phoenix.remote()
    pid = api.get(ph.pid_or_die.remote(marker), timeout=WAIT_S)
    api.kill(ph)
    return pid != os.getpid()


def in_process_kinds(p):
    api = p.api

    @api.remote
    class Async:
        async def pid(self):
            return os.getpid()

    @api.remote(max_concurrency=4)
    class Wide:
        def pid(self):
            return os.getpid()

    @api.remote(**{p.accel: 1})
    class Device:
        def pid(self):
            return os.getpid()

    actors = [Async.remote(), Wide.remote(), Device.remote()]
    pids = [api.get(a.pid.remote(), timeout=WAIT_S) for a in actors]
    for a in actors:
        api.kill(a)
    return [pid == os.getpid() for pid in pids]


def unpicklable_state_falls_back(p):
    api = p.api
    lock = threading.Lock()

    @api.remote
    class Holder:
        def __init__(self):
            self.lock = lock

        def pid(self):
            return os.getpid()

    before = p.modes().get("fallback", 0)
    h = Holder.remote()
    pid = api.get(h.pid.remote(), timeout=WAIT_S)
    api.kill(h)
    forced = Holder.options(in_process=False).remote()
    try:
        api.get(forced.pid.remote(), timeout=WAIT_S)
        refused = None
    except api.RayActorError as e:
        refused = "ActorNotSerializableError" in str(e)
    return pid == os.getpid(), p.modes().get("fallback", 0) - before, refused


def init_error_surfaces(p):
    api = p.api

    @api.remote
    class Bad:
        def __init__(self):
            raise ValueError("bad init")

        def ping(self):
            return 1

    try:
        api.get(Bad.remote().ping.remote(), timeout=WAIT_S)
    except api.RayActorError as e:
        return "bad init" in str(e)


def in_process_runtime_env_rejected(p):
    api = p.api

    @api.remote(in_process=True, runtime_env={"env_vars": {"RTT_ACTOR_FLAG": "1"}})
    class Pinned:
        def ping(self):
            return 1

    try:
        api.get(Pinned.remote().ping.remote(), timeout=WAIT_S)
    except api.RayActorError as e:
        return "runtime_env" in str(e)


def runtime_env_applies_for_its_life(p):
    api = p.api

    @api.remote(runtime_env={"env_vars": {"RTT_ACTOR_FLAG": "on"}})
    class Reader:
        def read(self):
            return os.environ.get("RTT_ACTOR_FLAG"), os.getpid()

    r = Reader.remote()
    got = [api.get(r.read.remote(), timeout=WAIT_S) for _ in range(2)]
    api.kill(r)
    return [v for v, _ in got], got[0][1] != os.getpid(), os.environ.get("RTT_ACTOR_FLAG")


def killed_actor_process_ends(p):
    api = p.api

    @api.remote
    class Victim:
        def pid(self):
            return os.getpid()

    v = Victim.remote()
    child = api.get(v.pid.remote(), timeout=WAIT_S)
    api.kill(v)
    return child != os.getpid(), gone(child)


FLOWS = [state_and_calls, exception_propagates, crash_surfaces_as_actor_process_crash,
         hard_crash_kills_only_that_actor, in_process_kinds, unpicklable_state_falls_back,
         init_error_surfaces, in_process_runtime_env_rejected,
         runtime_env_applies_for_its_life, killed_actor_process_ends]


@pytest.mark.parametrize("flow", FLOWS, ids=lambda f: f.__name__)
def test_flow_matches_reference(runtimes, flow):
    port, ref = both(flow)
    assert port == ref
    assert port not in (None, False)


def test_restart_respawns_a_fresh_process_as_in_the_reference(runtimes, tmp_path):
    port, ref = both(lambda p: restart_respawns_fresh_process(p, str(tmp_path)))
    assert port is ref is True


# ----------------------------------------------------------- the port's own


def test_device_actor_cannot_be_forced_into_a_process(runtimes):
    @ray_tpu_torch.remote(num_gpus=1, in_process=False)
    class Device:
        def ping(self):
            return 1

    with pytest.raises(ray_tpu_torch.RayActorError, match="owns the card"):
        ray_tpu_torch.get(Device.remote().ping.remote(), timeout=WAIT_S)


def test_a_tensor_off_the_cpu_keeps_the_actor_in_process(runtimes):
    p = Pkg("ray_tpu_torch")

    @ray_tpu_torch.remote
    class Holder:
        def __init__(self, w):
            self.w = w

        def where(self):
            return os.getpid(), self.w.device.type

    before = p.modes().get("fallback", 0)
    h = Holder.remote(torch.empty(3, device="meta"))
    assert ray_tpu_torch.get(h.where.remote(), timeout=WAIT_S) == (os.getpid(), "meta")
    assert p.modes().get("fallback", 0) - before == 1
    ray_tpu_torch.kill(h)


_DRIVER = """
import json, os, sys, time
import ray_tpu_torch
ray_tpu_torch.init(num_cpus=2, system_config={"worker_processes": 1})

def pid():
    return os.getpid()

@ray_tpu_torch.remote
class Where:
    def pid(self):
        return os.getpid()

a = Where.remote()
pids = [ray_tpu_torch.get(ray_tpu_torch.remote(pid).remote(), timeout=60),
        ray_tpu_torch.get(a.pid.remote(), timeout=60)]
print(json.dumps(pids), flush=True)
time.sleep(120)
"""


def test_children_die_with_a_killed_driver(tmp_path):
    script = tmp_path / "driver.py"
    script.write_text(_DRIVER)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, str(script)], stdout=subprocess.PIPE,
                            text=True, env=env)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)  # bounded wait
        assert ready, "the driver printed no pids within 120 s"
        pids = json.loads(proc.stdout.readline())
        from _torch_fixtures import descendants

        helpers = list(descendants(proc.pid))  # the forkserver and the resource tracker too
        assert set(pids) <= set(helpers) and proc.pid not in pids
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        proc.stdout.close()
        # a SIGKILLed owner never unlinks its pool arena: remove it here
        for name in os.listdir("/dev/shm"):
            if name.startswith("rtt_") and f"_{proc.pid}_" in name:
                os.unlink(os.path.join("/dev/shm", name))
    assert all(gone(pid) for pid in helpers), [p for p in helpers if not gone(p, 0.1)]
