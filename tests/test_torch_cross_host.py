"""Joined hosts (ray_tpu_torch/core/cross_host.py, core/worker_api.py)
against the reference's, on the CPU.

Each package runs one head for the module (its control plane served over
RPC, thread mode) with one worker subprocess joined through
`init(address=)`, advertising {"magic": 1}. Each flow of
tests/test_cross_host.py runs on both clusters and the results must be
equal: a task placed on the joined host by resource demand, dependencies
both ways over the transfer plane, a remote actor and its kill, a remote
application error, nested submission, a nested actor and a typed error,
and a named-actor call from code on the joined host (the back-channel), an
isolated actor in a child of the joined host, and streaming both ways.
Then a tiny-llama `LLMServer` replica served on the joined host through a
serve deployment, whose tokens must equal the reference's replica's.

In a process of their own per package, run side by side: a pool worker's
nested submission through the head back-channel, and a SIGKILLed joined
host reaped by the health check with the cluster still serving; the
port's script also checks that no `jax` and no `ray_tpu` module is loaded
in its head, its pool worker or its joined host. Every wait is bounded;
the clusters stop at the module's end.
"""

import importlib
import json
import os
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu.models as jmodels
import ray_tpu_torch
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
ACC = {"ray_tpu": "num_tpus", "ray_tpu_torch": "num_gpus"}
HEAD_CONFIG = {"control_plane_rpc_port": 0, "worker_processes": 0, "actor_processes": False}
MAGIC = {"num_cpus": 0, "resources": {"magic": 0.1}}
WAIT_S = 60


def _worker_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["RAY_TPU_WORKER_PROCESSES"] = "0"
    env.setdefault("RAY_TPU_LOG_LEVEL", "WARNING")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _spawn_worker(name, addr, resources='{"magic": 1.0}', num_cpus=4):
    code = textwrap.dedent(f"""
        import {name}
        w = {name}.init(address={addr!r}, num_cpus={num_cpus}, {ACC[name]}=0,
                        resources={resources})
        w.wait(timeout=600)
    """)
    return subprocess.Popen([sys.executable, "-c", code], env=_worker_env(),
                            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)


def _wait_nodes(rt, n, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(rt.control_plane.alive_nodes()) >= n:
            return
        time.sleep(0.1)
    raise AssertionError(f"cluster never reached {n} nodes")


@pytest.fixture(scope="module")
def clusters():
    out = {}
    try:
        for name, api in PKGS.items():
            api.shutdown()
            rt = api.init(num_cpus=2, **{ACC[name]: 0}, system_config=dict(HEAD_CONFIG))
            out[name] = SimpleNamespace(name=name, api=api, rt=rt, addr=rt._cp_server.address,
                                        proc=_spawn_worker(name, rt._cp_server.address))
        for c in out.values():
            _wait_nodes(c.rt, 2)
        yield out
    finally:
        for c in out.values():
            try:
                importlib.import_module(f"{c.name}.serve").shutdown()
            except Exception:  # noqa: BLE001 — a flow may not have served
                pass
            c.api.shutdown()
            try:
                c.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                c.proc.kill()
                c.proc.wait(timeout=10)
        os.environ.pop("RAY_TPU_HEAD_ADDRESS", None)


def both(flow, clusters):
    out = {}
    for name in ("ray_tpu_torch", "ray_tpu"):
        c = clusters[name]
        # both heads live in this process: the back-channel address a flow
        # ships must be its own head's
        os.environ["RAY_TPU_HEAD_ADDRESS"] = c.addr
        out[name] = flow(c)
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    return out["ray_tpu_torch"]


# ----------------------------------------------------------- dispatch


def placed_by_resource_demand(c):
    def remote_pid():
        return os.getpid()

    pid = c.api.get(c.api.remote(**MAGIC)(remote_pid).remote(), timeout=WAIT_S)
    return {"on_worker": pid == c.proc.pid}


def dependencies_flow_both_ways(c):
    api = c.api
    payload = api.put(list(range(10000)))  # head-owned object

    def consume(x):
        return sum(x)

    def produce():
        return {"x": list(range(500))}

    def head_consume(d):
        return len(d["x"])

    to_worker = api.get(api.remote(**MAGIC)(consume).remote(payload), timeout=WAIT_S)
    produced = api.remote(**MAGIC)(produce).remote()
    to_head = api.get(api.remote(num_cpus=0.1)(head_consume).remote(produced), timeout=WAIT_S)
    return {"to_worker": to_worker, "to_head": to_head}


def actor_on_remote_node(c):
    api = c.api

    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self, k):
            self.n += k
            return self.n

        def pid(self):
            return os.getpid()

    a = api.remote(**MAGIC, in_process=True)(Counter).remote()
    got = [api.get(a.incr.remote(2), timeout=WAIT_S), api.get(a.incr.remote(3), timeout=WAIT_S)]
    on_worker = api.get(a.pid.remote(), timeout=WAIT_S) == c.proc.pid
    api.kill(a)
    try:
        api.get(a.incr.remote(1), timeout=WAIT_S)
        after = "no-error"
    except api.RayActorError:
        after = "RayActorError"
    return {"got": got, "on_worker": on_worker, "after_kill": after}


def remote_application_error_propagates(c):
    api = c.api

    def boom():
        raise ValueError("kaboom")

    try:
        api.get(api.remote(**MAGIC, max_retries=0)(boom).remote(), timeout=WAIT_S)
        return {"error": None}
    except api.RayTaskError as e:
        return {"error": type(e).__name__, "cause": repr(e.cause)}


def nested_submission_from_joined_host(c):
    name = c.name

    def parent():
        import importlib
        import os

        r = importlib.import_module(name)

        def child(x):
            return x * 2, os.getpid()

        ref = r.put(21)
        val, child_pid = r.get(r.remote(num_cpus=0.1)(child).remote(r.get(ref, timeout=30)),
                               timeout=60)
        ready, _ = r.wait([r.put("a"), r.put("b")], num_returns=2, timeout=10)
        return {"val": val, "child_pid": child_pid, "my_pid": os.getpid(),
                "n_ready": len(ready)}

    out = c.api.get(c.api.remote(**MAGIC)(parent).remote(), timeout=120)
    # the child had no magic: the head placed it on its own node, proof the
    # submission crossed back
    return {"val": out["val"], "parent_on_worker": out["my_pid"] == c.proc.pid,
            "child_on_head": out["child_pid"] == os.getpid(), "n_ready": out["n_ready"]}


def nested_actor_and_error_from_joined_host(c):
    name = c.name

    def drive():
        import importlib

        r = importlib.import_module(name)

        class Acc:
            def __init__(self):
                self.n = 0

            def add(self, k):
                self.n += k
                return self.n

        a = r.remote(num_cpus=0.1, in_process=True)(Acc).remote()
        first = r.get(a.add.remote(5), timeout=30)
        total = r.get(a.add.remote(7), timeout=30)

        def boom():
            raise ValueError("inner")

        try:
            r.get(r.remote(num_cpus=0.1, max_retries=0)(boom).remote(), timeout=30)
            err = "no-error"
        except r.RayTaskError as e:
            err = repr(e.cause)  # the typed error crossed the wire, cause included
        return first, total, err

    return {"out": c.api.get(c.api.remote(**MAGIC)(drive).remote(), timeout=120)}


def named_actor_handle_call_from_joined_host(c):
    api, name = c.api, c.name

    class Shared:
        def __init__(self):
            self.n = 0

        def add(self, k):
            self.n += k
            return self.n

    a = api.remote(num_cpus=0.1, in_process=True, name="xh-shared")(Shared).remote()
    first = api.get(a.add.remote(1), timeout=WAIT_S)

    def use_named():
        import importlib

        r = importlib.import_module(name)
        return r.get(r.get_actor("xh-shared").add.remote(10), timeout=30)

    got = api.get(api.remote(**MAGIC)(use_named).remote(), timeout=120)
    api.kill(a)
    return {"first": first, "through_handle": got}


def isolated_actor_runs_in_child_of_worker_host(c):
    api = c.api

    class Iso:
        def __init__(self):
            self.calls = 0

        def pid(self):
            self.calls += 1
            return os.getpid(), self.calls

    a = api.remote(**MAGIC, in_process=False)(Iso).remote()
    pid, calls = api.get(a.pid.remote(), timeout=90)

    def ancestry(p):
        chain = []
        for _ in range(10):
            try:
                with open(f"/proc/{p}/stat") as f:
                    p = int(f.read().rsplit(")", 1)[1].split()[1])
            except OSError:
                break
            chain.append(p)
            if p <= 1:
                break
        return chain

    under_worker = c.proc.pid in ancestry(pid)
    pid2, calls2 = api.get(a.pid.remote(), timeout=WAIT_S)
    api.kill(a)
    return {"own_process": pid not in (os.getpid(), c.proc.pid), "under_worker": under_worker,
            "calls": [calls, calls2], "same_process": pid2 == pid}


def streaming_task_on_remote_node(c):
    api = c.api

    def produce():
        for i in range(3):
            yield {"i": i, "pid": os.getpid()}
            time.sleep(0.2)

    gen = api.remote(**MAGIC, num_returns="streaming")(produce).remote()
    first = api.get(next(gen), timeout=WAIT_S)
    running = not gen.completed()  # the producer still runs after item 0
    rest = [api.get(r, timeout=WAIT_S)["i"] for r in gen]
    return {"first": first["i"], "on_worker": first["pid"] == c.proc.pid,
            "running": running, "rest": rest}


def streaming_both_ways_through_back_channel(c):
    name = c.name

    def driver_side():
        import importlib

        r = importlib.import_module(name)

        def produce():
            for i in range(4):
                yield {"i": i}

        got = [r.get(ref, timeout=30)["i"]
               for ref in r.remote(num_cpus=0.1, num_returns="streaming")(produce).remote()]

        def flaky():
            yield 1
            raise ValueError("stream broke")

        gen = r.remote(num_cpus=0.1, num_returns="streaming", max_retries=0)(flaky).remote()
        first = r.get(next(gen), timeout=30)
        try:
            for _ in gen:
                pass
            err = "no-error"
        except Exception as e:  # noqa: BLE001 — its type is the result
            err = type(e).__name__
        return got, first, err

    got, first, err = c.api.get(c.api.remote(**MAGIC)(driver_side).remote(), timeout=120)
    return {"items": got, "first": first, "error_typed": err in ("RayTaskError", "ValueError")}


FLOWS = [placed_by_resource_demand, dependencies_flow_both_ways, actor_on_remote_node,
         remote_application_error_propagates, nested_submission_from_joined_host,
         nested_actor_and_error_from_joined_host, named_actor_handle_call_from_joined_host,
         isolated_actor_runs_in_child_of_worker_host, streaming_task_on_remote_node,
         streaming_both_ways_through_back_channel]

EXPECTED = {
    placed_by_resource_demand: {"on_worker": True},
    dependencies_flow_both_ways: {"to_worker": sum(range(10000)), "to_head": 500},
    actor_on_remote_node: {"got": [2, 5], "on_worker": True, "after_kill": "RayActorError"},
    remote_application_error_propagates: {"error": "RayTaskError",
                                          "cause": "ValueError('kaboom')"},
    nested_submission_from_joined_host: {"val": 42, "parent_on_worker": True,
                                         "child_on_head": True, "n_ready": 2},
    nested_actor_and_error_from_joined_host: {"out": (5, 12, "ValueError('inner')")},
    named_actor_handle_call_from_joined_host: {"first": 1, "through_handle": 11},
    isolated_actor_runs_in_child_of_worker_host: {"own_process": True, "under_worker": True,
                                                  "calls": [1, 2], "same_process": True},
    streaming_task_on_remote_node: {"first": 0, "on_worker": True, "running": True,
                                    "rest": [1, 2]},
    streaming_both_ways_through_back_channel: {"items": [0, 1, 2, 3], "first": 1,
                                               "error_typed": True},
}


@pytest.mark.parametrize("flow", FLOWS, ids=lambda f: f.__name__)
def test_joined_host_matches_reference(flow, clusters):
    assert both(flow, clusters) == EXPECTED[flow]


def test_a_task_whose_argument_failed_fails_on_a_joined_host(clusters):
    # ROADMAP C19 reaches joined hosts: the head publishes the failure on
    # obj_loc and the host's directory reads it (RemoteDirectoryClient.
    # failure); the reference's joined host waits on forever
    c = clusters["ray_tpu_torch"]
    os.environ["RAY_TPU_HEAD_ADDRESS"] = c.addr
    api = c.api

    def broken():
        raise RuntimeError("no value")

    def consume(x):
        return x

    bad = api.remote(num_cpus=0.1, max_retries=0)(broken).remote()
    with pytest.raises(api.RayTaskError, match="no value"):
        api.get(api.remote(**MAGIC, max_retries=0)(consume).remote(bad), timeout=WAIT_S)


def test_the_joined_host_loads_no_jax_and_no_reference(clusters):
    c = clusters["ray_tpu_torch"]
    os.environ["RAY_TPU_HEAD_ADDRESS"] = c.addr

    def loaded():
        import sys

        return sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                      or m == "ray_tpu" or m.startswith("ray_tpu."))

    assert c.api.get(c.api.remote(**MAGIC)(loaded).remote(), timeout=WAIT_S) == []


# -------------------------------------------------- a replica served there


@pytest.fixture(scope="module")
def weights():
    cfg = jmodels.get_config("tiny-llama")
    return {"jcfg": cfg, "np": jax.tree.map(np.asarray, jmodels.init_params(
        cfg, jax.random.PRNGKey(0)))}


ENGINE_KW = dict(max_batch_size=4, page_size=8, max_pages=64, max_seq_len=64,
                 prefill_buckets=(16, 32), prefill_chunk=16)


def test_an_llm_replica_on_a_joined_host_matches_reference(clusters, weights):
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, weights["jcfg"].vocab_size, size=n)]
               for n in (5, 12, 20)]
    tree, jcfg = weights["np"], weights["jcfg"]

    def serve_there(c):
        port = c.name == "ray_tpu_torch"
        engine_kw = dict(ENGINE_KW)

        class Replica:
            def __init__(self):
                if port:
                    from ray_tpu_torch import LLMServer, get_config
                    from ray_tpu_torch.models import params_from_numpy

                    cfg = get_config("tiny-llama")
                    self.server = LLMServer._target(
                        params_fn=lambda: (params_from_numpy(tree, device="cpu"), cfg),
                        engine_config=engine_kw, device="cpu")
                else:
                    from ray_tpu.serve.llm import LLMServer

                    self.server = LLMServer._target(params_fn=lambda: (tree, jcfg),
                                                    engine_config=engine_kw)

            def __call__(self, request):
                out = self.server(request)
                return {"token_ids": out["token_ids"], "pid": os.getpid()}

        serve = importlib.import_module(f"{c.name}.serve")
        dep = serve.deployment(
            num_replicas=1, ray_actor_options={**MAGIC, "in_process": True})(Replica)
        handle = serve.run(dep.bind(), name="xh-llm")
        try:
            outs = [handle.remote({"prompt_ids": p, "max_tokens": 8}).result(timeout=120)
                    for p in prompts]
        finally:
            serve.shutdown()
        return {"tokens": [o["token_ids"] for o in outs],
                "on_worker": [o["pid"] == c.proc.pid for o in outs]}

    got = both(serve_there, clusters)
    assert got["on_worker"] == [True] * 3 and all(len(t) == 8 for t in got["tokens"])


# --------------------------- the pool back-channel and a killed host


_ISOLATED = r"""
import importlib, json, os, signal, subprocess, sys, textwrap, time
name = sys.argv[1]
api = importlib.import_module(name)
acc = {"ray_tpu": "num_tpus", "ray_tpu_torch": "num_gpus"}[name]


def forbidden():
    return sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                  or m == "ray_tpu" or m.startswith("ray_tpu."))


rt = api.init(num_cpus=4, **{acc: 0}, system_config={
    "control_plane_rpc_port": 0, "worker_processes": 2, "health_check_timeout_ms": 2500})
out = {}
try:
    def parent():
        import importlib, os, sys
        r = importlib.import_module(name)

        def child(x):
            return x + 1

        v = r.get(r.remote(num_cpus=1)(child).remote(r.get(r.put(41), timeout=30)), timeout=60)
        mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                      or m == "ray_tpu" or m.startswith("ray_tpu."))
        return v, os.getpid(), bool(os.environ.get("RAY_TPU_IN_POOL_WORKER")), mods

    v, pid, in_pool, pool_mods = api.get(api.remote(num_cpus=1)(parent).remote(), timeout=120)
    out["pool"] = {"value": v, "in_pool": in_pool and pid != os.getpid()}

    code = textwrap.dedent(f'''
        import {name}
        w = {name}.init(address={rt._cp_server.address!r}, num_cpus=8, {acc}=0,
                        resources={{"magic": 1.0}})
        w.wait(timeout=300)
    ''')
    env = dict(os.environ, RAY_TPU_WORKER_PROCESSES="0", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 90
        while len(rt.control_plane.alive_nodes()) < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        worker = [n for n in rt.control_plane.alive_nodes()
                  if n.resources_total.get("CPU") == 8.0][0]
        worker_mods = api.get(api.remote(num_cpus=0, resources={"magic": 0.1})(
            forbidden).remote(), timeout=60)
        os.kill(proc.pid, signal.SIGKILL)
        killed = time.monotonic()
        while time.monotonic() < killed + 20 and len(rt.control_plane.alive_nodes()) > 1:
            time.sleep(0.1)
        alive = rt.control_plane.alive_nodes()
        out["reap"] = {"alive": len(alive), "survivor": alive[0].node_id != worker.node_id,
                       "within_20s": time.monotonic() - killed < 20}

        def anywhere():
            return os.getpid()

        served = api.get(api.remote(num_cpus=1)(anywhere).remote(), timeout=60)
        out["served"] = served != proc.pid
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=10)
    if name == "ray_tpu_torch":
        out["forbidden"] = {"head": forbidden(), "pool": pool_mods, "joined": worker_mods}
finally:
    api.shutdown()
print("RESULT", json.dumps(out))
"""


def test_pool_back_channel_and_a_killed_host_match_reference():
    env = _worker_env()
    procs = {name: subprocess.Popen([sys.executable, "-c", _ISOLATED, name], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name in PKGS}
    out = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=240)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        assert proc.returncode == 0 and "RESULT" in stdout, stderr[-3000:]
        out[name] = json.loads(stdout.split("RESULT", 1)[1])
    forbidden = out["ray_tpu_torch"].pop("forbidden")
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    assert out["ray_tpu_torch"] == {"pool": {"value": 42, "in_pool": True},
                                    "reap": {"alive": 1, "survivor": True, "within_20s": True},
                                    "served": True}
    assert forbidden == {"head": [], "pool": [], "joined": []}
