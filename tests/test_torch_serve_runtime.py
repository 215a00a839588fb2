"""The serve runtime (ray_tpu_torch.serve: deployments, controller, router,
handles, batching, multiplexing, autoscaling, the HTTP proxy) against
ray_tpu.serve's, on the CPU.

Each flow of tests/test_serve.py's TestServeCore, TestBatching,
TestAutoscaling and TestMultiplex (and of the serve API's app handles,
delete and per-host ProxyActor) is one program that runs under
both packages in turn, in thread mode (system_config {"worker_processes":
0, "actor_processes": False}, the port's only mode until ROADMAP A5b): what
the flow observes (results, exception types, replica counts, routing and
cache behaviour) and cluster_resources() must be the same. The
accelerator resource is "TPU" in the reference and "GPU" in the port, so
resources are compared with the name normalised. Every runtime is started
explicitly, and every app and runtime is stopped in a `finally`.

Also here, for the port alone: a retired replica runs its class's
shutdown(), serve.shutdown() leaves no thread of the serve runtime
behind, the A5c entry points raise, and `import ray_tpu_torch.serve`
plus `serve.run` load neither jax nor ray_tpu (a subprocess).
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

import ray_tpu
import ray_tpu.serve
import ray_tpu.serve.controller
import ray_tpu_torch
import ray_tpu_torch.serve
import ray_tpu_torch.serve.controller
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
PACKAGES = {"ray_tpu": (ray_tpu, ray_tpu.serve, ray_tpu.serve.controller, "TPU"),
            "ray_tpu_torch": (ray_tpu_torch, ray_tpu_torch.serve,
                              ray_tpu_torch.serve.controller, "GPU")}
WAIT_S = 30  # every result has a timeout
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pkg:
    """One package's runtime and serve API as a flow sees it."""

    def __init__(self, name):
        self.api, self.serve, self.controller, self.accel = PACKAGES[name]
        self.name = name

    def acc(self, n):
        """The accelerator option: num_tpus= in the reference, num_gpus= in the port."""
        return {f"num_{self.accel.lower()}s": n}

    def resources(self):
        res = self.api.cluster_resources()
        return {("ACCEL" if k == self.accel else k): v for k, v in sorted(res.items())}


def _post(port, path, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


# ------------------------------------------------------------- TestServeCore


def function_deployment(p):
    @p.serve.deployment
    def echo(request):
        return {"echo": request["x"] * 2}

    handle = p.serve.run(echo.bind(), name="echo")
    return handle.remote({"x": 21}).result(timeout=WAIT_S)


def class_deployment_with_state(p):
    @p.serve.deployment
    class Counter:
        def __init__(self, start):
            self.n = start

        def __call__(self, request):
            self.n += 1
            return self.n

    handle = p.serve.run(Counter.bind(10), name="counter")
    return [handle.remote({}).result(timeout=WAIT_S) for _ in range(3)]


def multiple_replicas_balance(p):
    @p.serve.deployment(num_replicas=2)
    class WhoAmI:
        def __init__(self):
            import uuid

            self.uid = uuid.uuid4().hex

        def __call__(self, request):
            return self.uid

    handle = p.serve.run(WhoAmI.bind(), name="who")
    uids = {handle.remote({}).result(timeout=WAIT_S) for _ in range(20)}
    return len(uids)  # both replicas served traffic


def method_routing_and_status(p):
    @p.serve.deployment
    class Multi:
        def __call__(self, request):
            return "call"

        def other(self, request):
            return "other"

    handle = p.serve.run(Multi.bind(), name="multi")
    return (handle.remote({}).result(timeout=WAIT_S),
            handle.other.remote({}).result(timeout=WAIT_S),
            p.serve.status()["Multi"])


def http_proxy(p):
    @p.serve.deployment
    def double(request):
        return {"y": request["x"] * 2}

    p.serve.run(double.bind(), name="double")
    port = p.serve.http_port()
    out = _post(port, "/double", {"x": 5})
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/-/healthz", timeout=WAIT_S) as r:
        health = json.loads(r.read())
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/-/routes", timeout=WAIT_S) as r:
        routes = json.loads(r.read())
    try:
        _post(port, "/nowhere", {})
        missing = None
    except urllib.error.HTTPError as e:
        missing = e.code
    return out, health, routes, missing


def replica_replacement_reaches_existing_handles(p):
    @p.serve.deployment
    class Stable:
        def __call__(self, request):
            return "ok"

    handle = p.serve.run(Stable.bind(), name="stable")
    first = handle.remote({}).result(timeout=WAIT_S)
    ctrl = p.controller.get_or_create_controller()
    replicas, v0 = p.api.get(ctrl.get_replicas.remote("Stable"), timeout=WAIT_S)
    p.api.kill(replicas[0])
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        try:
            if handle.remote({}).result(timeout=5) == "ok":
                reps, v1 = p.api.get(ctrl.get_replicas.remote("Stable"), timeout=WAIT_S)
                if v1 > v0:
                    return first, len(replicas), len(reps), "recovered"
        except Exception:  # noqa: BLE001 — the replacement is on its way
            pass
        time.sleep(0.3)
    return first, len(replicas), "never recovered"


def hung_replica_replaced_after_threshold(p):
    released = threading.Event()  # set at the end: the hung probe's thread ends
    @p.serve.deployment(ray_actor_options={"max_concurrency": 8},
                        health_check_period_s=0.3, health_check_timeout_s=0.3)
    class Hangable:
        def __init__(self):
            self._hang = False

        def __call__(self, request):
            if request.get("hang"):
                self._hang = True
                return "hanging"
            return "ok"

        def check_health(self):
            while self._hang and not released.is_set():
                time.sleep(0.1)

    handle = p.serve.run(Hangable.bind(), name="hangable")
    first = handle.remote({}).result(timeout=WAIT_S)
    ctrl = p.controller.get_or_create_controller()
    replicas, v0 = p.api.get(ctrl.get_replicas.remote("Hangable"), timeout=WAIT_S)
    old_id = replicas[0]._actor_id
    hanging = handle.remote({"hang": True}).result(timeout=WAIT_S)
    deadline = time.monotonic() + WAIT_S
    replaced = False
    while time.monotonic() < deadline:
        reps, v1 = p.api.get(ctrl.get_replicas.remote("Hangable"), timeout=WAIT_S)
        if reps and reps[0]._actor_id != old_id and v1 > v0:
            replaced = True
            break
        time.sleep(0.3)
    after = handle.remote({}).result(timeout=WAIT_S)
    released.set()
    return first, hanging, replaced, after


def replica_crash_recovers(p):
    @p.serve.deployment
    class Fragile:
        def __call__(self, request):
            if request.get("die"):
                raise RuntimeError("dying")
            return "alive"

    handle = p.serve.run(Fragile.bind(), name="fragile")
    before = handle.remote({}).result(timeout=WAIT_S)
    try:
        handle.remote({"die": True}).result(timeout=WAIT_S)
        raised = None
    except Exception as e:  # noqa: BLE001 — the flow reports what was raised
        raised = (type(e).__name__, type(getattr(e, "cause", None)).__name__)
    return before, raised, handle.remote({}).result(timeout=WAIT_S)


def app_handles_and_delete(p):
    @p.serve.deployment
    def echo(request):
        return {"echo": request["x"]}

    p.serve.run(echo.bind(), name="echoapp")
    by_app = p.serve.get_app_handle("echoapp").remote({"x": 1}).result(timeout=WAIT_S)
    by_name = p.serve.get_deployment_handle("echo").remote({"x": 2}).result(timeout=WAIT_S)
    port = p.serve.http_port()
    before = _post(port, "/echoapp", {"x": 3})
    p.serve.delete("echoapp")
    try:
        _post(port, "/echoapp", {"x": 4})
        after = None
    except urllib.error.HTTPError as e:
        after = e.code
    return by_app, by_name, before, after, p.serve.status()


def proxy_actor_serves_routes(p):
    """A per-host ingress (ProxyActor): apps deployed before and after it
    starts, through its own port."""
    @p.serve.deployment
    class Before:
        def __call__(self, x):
            return {"app": "before", "x": x}

    p.serve.run(Before.bind(), name="before")
    proxy, port = p.serve.start_proxy(host="127.0.0.1")
    out = [_post(port, "/before", 1)["result"]]

    @p.serve.deployment
    class After:
        def __call__(self, x):
            return {"app": "after", "x": x}

    p.serve.run(After.bind(), name="after")
    deadline = time.monotonic() + WAIT_S
    while len(out) < 2 and time.monotonic() < deadline:
        try:
            out.append(_post(port, "/after", 2)["result"])
        except urllib.error.HTTPError:
            time.sleep(0.3)  # the proxy's route poll has not ticked yet
    stopped = p.api.get(proxy.stop.remote(), timeout=WAIT_S)
    p.api.kill(proxy)
    return out, stopped, port != p.serve.http_port()


# --------------------------------------------------- batching, autoscaling


def batch_coalesces(p):
    sizes = []

    @p.serve.deployment(max_ongoing_requests=16)
    class Batched:
        @p.serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
        def __call__(self, requests):
            sizes.append(len(requests))
            return [r["x"] + 1 for r in requests]

    handle = p.serve.run(Batched.bind(), name="batched")
    responses = [handle.remote({"x": i}) for i in range(8)]
    results = [r.result(timeout=WAIT_S) for r in responses]
    return sorted(results), sum(sizes), max(sizes) > 1


def target_scales_up(p):
    @p.serve.deployment(
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 1.0, "upscale_delay_s": 0.0},
        max_ongoing_requests=2)
    class Slow:
        def __call__(self, request):
            time.sleep(1.0)
            return "ok"

    handle = p.serve.run(Slow.bind(), name="slow")
    rs = [handle.remote({}) for _ in range(8)]
    deadline = time.monotonic() + 20
    scaled = False
    while time.monotonic() < deadline:
        if p.serve.status().get("Slow", {}).get("target_replicas", 1) > 1:
            scaled = True
            break
        time.sleep(0.3)
    return scaled, [r.result(timeout=60) for r in rs]


# ---------------------------------------------------------- TestMultiplex


def multiplex_lru_load_and_evict(p):
    loads = []

    @p.serve.deployment(num_replicas=1)
    class Multi:
        @p.serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            loads.append(model_id)
            return {"id": model_id}

        def __call__(self, request):
            mid = p.serve.get_multiplexed_model_id()
            return {"served_by": self.get_model(mid)["id"], "ctx": mid}

    handle = p.serve.run(Multi.bind(), name="multi")
    out = []
    for mid in ("a", "b", "a", "c", "b"):
        out.append(handle.options(multiplexed_model_id=mid).remote({}).result(timeout=WAIT_S))
        out.append(list(loads))
    return out


def multiplex_model_affinity_routing(p):
    @p.serve.deployment(num_replicas=2)
    class Who:
        def __init__(self):
            self.me = id(self)

        @p.serve.multiplexed(max_num_models_per_replica=4)
        def get_model(self, model_id: str):
            return model_id

        def __call__(self, request):
            self.get_model(p.serve.get_multiplexed_model_id())
            return {"replica": repr(self.me)}

    handle = p.serve.run(Who.bind(), name="who")
    h_m = handle.options(multiplexed_model_id="m1")
    first = h_m.remote({}).result(timeout=WAIT_S)["replica"]
    return [h_m.remote({}).result(timeout=WAIT_S)["replica"] == first for _ in range(6)]


def multiplex_unload_hook_called(p):
    unloaded = []

    class Model:
        def __init__(self, mid):
            self.mid = mid

        def unload(self):
            unloaded.append(self.mid)

    @p.serve.deployment(num_replicas=1)
    class Multi:
        @p.serve.multiplexed(max_num_models_per_replica=1)
        def get_model(self, model_id: str):
            return Model(model_id)

        def __call__(self, request):
            return self.get_model(p.serve.get_multiplexed_model_id()).mid

    handle = p.serve.run(Multi.bind(), name="mx")
    served = [handle.options(multiplexed_model_id=m).remote({}).result(timeout=WAIT_S)
              for m in ("m1", "m2")]
    return served, unloaded


def multiplex_concurrent_same_model_loads_once(p):
    loads = []
    gate = threading.Event()

    @p.serve.deployment(num_replicas=1, max_ongoing_requests=4)
    class Slow:
        @p.serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            loads.append(model_id)
            gate.wait(timeout=10)  # hold the load so requests overlap
            return model_id

        def __call__(self, request):
            return self.get_model(p.serve.get_multiplexed_model_id())

    handle = p.serve.run(Slow.bind(), name="slowmx")
    h = handle.options(multiplexed_model_id="m1")
    responses = [h.remote({}) for _ in range(3)]
    time.sleep(0.3)  # let all three reach the cache
    gate.set()
    return [r.result(timeout=WAIT_S) for r in responses], loads


FLOWS = [function_deployment, class_deployment_with_state, multiple_replicas_balance,
         method_routing_and_status, http_proxy, replica_replacement_reaches_existing_handles,
         hung_replica_replaced_after_threshold, replica_crash_recovers, app_handles_and_delete,
         proxy_actor_serves_routes, batch_coalesces,
         target_scales_up, multiplex_lru_load_and_evict, multiplex_model_affinity_routing,
         multiplex_unload_hook_called, multiplex_concurrent_same_model_loads_once]


def run_flow(name, flow):
    p = Pkg(name)
    p.serve.shutdown()
    p.api.shutdown()  # no runtime another test left behind may serve this one
    p.api.init(num_cpus=8, system_config=dict(THREAD_MODE), **p.acc(0))
    try:
        return flow(p), p.resources()
    finally:
        try:
            p.serve.shutdown()
        finally:
            p.api.shutdown()


@pytest.mark.parametrize("flow", FLOWS, ids=lambda f: f.__name__)
def test_flow_matches_reference(flow):
    ref = run_flow("ray_tpu", flow)
    port = run_flow("ray_tpu_torch", flow)
    assert port == ref
    assert port[0] is not None


# --------------------------------------------------------------- the port


class Closable:
    shut = []

    def __init__(self, tag):
        self.tag = tag

    def __call__(self, request):
        return self.tag

    def shutdown(self):
        Closable.shut.append(self.tag)


def test_retired_replicas_run_their_shutdown_and_leave_no_thread():
    from ray_tpu_torch import serve

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, system_config=dict(THREAD_MODE))
    try:
        runtime_threads = set(threading.enumerate())
        Closable.shut = []
        dep = serve.deployment(Closable)
        handle = serve.run(dep.options(num_replicas=2).bind("v1"), name="c")
        assert {handle.remote({}).result(timeout=WAIT_S) for _ in range(10)} == {"v1"}
        # a new version: both old replicas retire through their shutdown()
        handle = serve.run(dep.options(num_replicas=1).bind("v2"), name="c")
        deadline = time.monotonic() + WAIT_S
        while len(Closable.shut) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert Closable.shut == ["v1", "v1"]
        assert handle.remote({}).result(timeout=WAIT_S) == "v2"
        port = serve.http_port()
        assert _post(port, "/c", {})["result"] == "v2"
        serve.shutdown()
        assert Closable.shut == ["v1", "v1", "v2"]
        assert serve.http_port() is None and serve.status() == {}
        left = [t.name for t in threading.enumerate()
                if t not in runtime_threads and t.is_alive()]
        assert left == []
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_shutdown_without_a_runtime_starts_none():
    from ray_tpu_torch import serve

    ray_tpu_torch.shutdown()
    serve.shutdown()
    assert not ray_tpu_torch.is_initialized()


def test_unported_entry_points_raise():
    # disaggregated serving, the health plane, the fleet and the gRPC ingress
    # are ported (tests/test_torch_disagg.py, test_torch_health.py,
    # test_torch_fleet.py, test_torch_serve_schema.py); what waits for
    # ROADMAP A5c is reading a remote head's health (status(address=): the
    # dashboard) and the `ray-tpu serve run` command (scripts.py)
    import importlib.util

    from ray_tpu_torch import serve
    from ray_tpu_torch.core import health
    from ray_tpu_torch.serve import schema

    with pytest.raises(ValueError, match="kv_transfer"):
        serve.build_openai_app(disagg={"kv_transfer": "carrier-pigeon"})
    with pytest.raises(NotImplementedError, match="A5c"):
        ray_tpu_torch.status(address="127.0.0.1:8265")
    assert "A5c" in schema.__doc__ and "serve run" in schema.__doc__
    assert importlib.util.find_spec("ray_tpu_torch.scripts") is None
    assert serve.grpc_port() is None  # no proxy until start_grpc()
    assert health.get_health_plane(create=False) is None
    for name in ("DisaggConfig", "DisaggCoordinator", "EngineWorker", "deploy_disagg",
                 "FleetConfig", "FleetController"):
        assert getattr(serve, name).__module__.startswith("ray_tpu_torch.serve.")


def test_replica_health_matches_reference():
    from ray_tpu.core.health import ReplicaHealth as JHealth
    from ray_tpu_torch.core.health import ReplicaHealth as THealth

    def drive(cls):
        now = [100.0]
        h = cls(quarantine_s=2.0, now_fn=lambda: now[0])
        out = []
        h.observe("a", 0.01)
        h.record_error("b")
        h.record_error("b")
        out.append((h.eligible(["a", "b"]), h.penalty("a"), h.penalty("b"), h.quarantined("b")))
        now[0] += 2.5  # b's probe window opens: exactly one probe passes
        out.append((h.eligible(["a", "b"]), h.eligible(["a", "b"])))
        h.record_error("b")  # the probe failed: doubled backoff
        now[0] += 2.5
        out.append((h.eligible(["a", "b"]), h.quarantined("b")))
        now[0] += 2.0
        out.append(h.eligible(["a", "b"]))
        h.observe("b", 0.02)  # the probe succeeded: restored
        h.quarantine("a", duration=1.0)
        out.append((h.eligible(["a", "b"]), h.eligible(["a"]), h.snapshot()))
        return out

    assert drive(THealth) == drive(JHealth)


def test_serve_run_loads_neither_jax_nor_ray_tpu():
    code = (
        "import sys, json, urllib.request\n"
        "from ray_tpu_torch import serve\n"
        "@serve.deployment(num_replicas=2)\n"
        "def echo(request):\n"
        "    return {'echo': request['x']}\n"
        "h = serve.run(echo.bind(), name='echo')\n"
        "assert h.remote({'x': 3}).result(timeout=30) == {'echo': 3}\n"
        "req = urllib.request.Request(f'http://127.0.0.1:{serve.http_port()}/echo',\n"
        "                             data=json.dumps({'x': 4}).encode())\n"
        "assert json.loads(urllib.request.urlopen(req, timeout=30).read())['result'] == "
        "{'echo': 4}\n"
        "serve.shutdown()\n"
        "import ray_tpu_torch\n"
        "ray_tpu_torch.shutdown()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'ray_tpu' or m.startswith('ray_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
