"""The serve fleet (ray_tpu_torch.serve.fleet: FleetConfig, FleetController)
against ray_tpu.serve.fleet, on the CPU at tiny-llama.

Every flow of tests/test_fleet.py runs under both packages: the autoscale
policy over worker doubles (convergence up and down without oscillation,
the cooldown, step_max, min_replicas, the global knobs, unknown options
refused, serve-mode actuation through set_target), graceful scale-down in
the coordinator, the adapter hot-swap with residency routing, the
remediation pipeline and its reentrancy, the controller's loop, and the
kill-resume contract with real engines (a decode replica dying mid-stream
resumes on a healthy peer token-identical to an uninterrupted run, a storm
of streams sharing one death, and the death surfacing with resume off).
Targets, the kinds of the actions taken, the stages counted, the resumes
and the tokens must be equal between the packages, the tokens also to the
reference's uninterrupted engine; the port runs on the reference's
weights (PRNGKey(0), through `params_from_numpy`) with device="cpu".

Also here, for the port alone, its differences from the reference (each
in the module docstrings of serve/fleet.py and serve/disagg.py): a
request counts in serve_disagg_queue_depth{role="prefill"} until its
prefill leg returns, so a backlog behind one prefill replica shows (the
reference's gauge reads 0); and a serve-mode remediation has the serve
controller retire the replica, so its streams resume on the replacement
and `rejoin` is counted when the replacement joins.
"""

import threading
import time

import jax
import numpy as np
import pytest

import ray_tpu.models as jmodels
import ray_tpu.serve.disagg as jdisagg
import ray_tpu.serve.fleet as jfleet
import ray_tpu_torch
import ray_tpu_torch.serve.disagg as tdisagg
import ray_tpu_torch.serve.fleet as tfleet
from ray_tpu.core import metrics as jmetrics
from ray_tpu.serve import engine as jengine
from ray_tpu_torch.core import metrics as tmetrics
from ray_tpu_torch.models import get_config, params_from_numpy
from ray_tpu_torch.serve import engine as tengine
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

pytestmark = pytest.mark.fleet

ENGINE_KW = dict(max_batch_size=4, page_size=8, max_pages=64, max_seq_len=96,
                 prefill_buckets=(16, 32))
PACKAGES = ("ray_tpu_torch", "ray_tpu")
STAGES = ("quarantine", "drain", "restart", "rejoin")
THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
WAIT_S = 120


@pytest.fixture(scope="module")
def tiny():
    jcfg = jmodels.get_config("tiny-llama")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return {"jcfg": jcfg, "jparams": jparams, "tcfg": get_config("tiny-llama"),
            "tparams": params_from_numpy(tree, device="cpu")}


class Pkg:
    """One package's fleet as a flow sees it."""

    def __init__(self, name, tiny=None):
        self.port = name == "ray_tpu_torch"
        self.fleet = tfleet if self.port else jfleet
        self.disagg = tdisagg if self.port else jdisagg
        self.engine_mod = tengine if self.port else jengine
        self.registry = (tmetrics if self.port else jmetrics).registry
        self.tiny = tiny
        self.n = 0

    def engine(self, **kw):
        t = self.tiny
        cfg, params = (t["tcfg"], t["tparams"]) if self.port else (t["jcfg"], t["jparams"])
        ecfg = self.engine_mod.EngineConfig(**dict(ENGINE_KW, **kw))
        extra = {"device": "cpu"} if self.port else {}
        return self.engine_mod.InferenceEngine(params, cfg, ecfg, **extra)

    def fake(self, load=0):
        self.n += 1
        return FakeWorker(f"fake-{self.n}", load)

    def co(self, prefill, decode, **cfg):
        return self.disagg.DisaggCoordinator(prefill, decode, dict({"small_blob_bytes": 0}, **cfg))

    def stages(self):
        rem = self.registry.get("serve_fleet_remediations")
        return {s: rem.get(tags={"stage": s}) for s in STAGES}


def both(flow, *args):
    return flow(Pkg("ray_tpu_torch", *args)), flow(Pkg("ray_tpu", *args))


# ----------------------------------------------------- policy doubles


class FakeWorker:
    def __init__(self, key, load=0):
        self.key = key
        self._load = load
        self.retired = False

    def load(self):
        return self._load

    def list_adapters(self):
        return []

    def cancel(self, request_id):
        return False


class FakePlane:
    """HealthPlane double: the flow scripts which alerts fire."""

    def __init__(self):
        self.alerts = []
        self._subs = []

    def active(self):
        return [dict(a) for a in self.alerts]

    def subscribe(self, fn):
        self._subs.append(fn)

    def fire(self, alert):
        self.alerts.append(alert)
        for fn in list(self._subs):
            fn(dict(alert))


def qd_alert(role="decode", value=9.0):
    return {"rule": "queue_depth", "expr": "injected", "state": "firing",
            "severity": "critical", "labels": {"role": role}, "value": value,
            "threshold": 4.0, "since": 0.0, "at": 0.0, "demand": {"CPU": 1.0}}


def policy_fleet(p, co, plane, spawned, retired, **cfg):
    defaults = dict(min_replicas=1, max_replicas=4, idle_periods=2, cooldown_s=0.0,
                    step_max=1, eval_period_s=0.05)
    defaults.update(cfg)

    def spawn(role):
        w = p.fake()
        spawned.append(role)
        return w

    def retire(role, w):
        w.retired = True
        retired.append(role)

    return p.fleet.FleetController(co, defaults, spawn_fn=spawn, retire_fn=retire, plane=plane)


def kinds(fleet):
    return [(a["kind"], a["role"], a.get("from"), a.get("to")) for a in fleet.actions]


# ------------------------------------------------------------ the policy


def converges_without_oscillation(p):
    plane, spawned, retired = FakePlane(), [], []
    fleet = policy_fleet(p, p.co([p.fake()], [p.fake()]), plane, spawned, retired)
    plane.alerts = [qd_alert("decode")]
    out = [fleet.evaluate_once(), len(fleet.co.workers("decode"))]
    plane.alerts = []
    out += [fleet.evaluate_once(), fleet.evaluate_once(), len(fleet.co.workers("decode"))]
    out.append([fleet.evaluate_once()["decode"] for _ in range(3)])
    return out, spawned, retired, kinds(fleet), fleet.status()["idle_periods"]


def cooldown_blocks_rescale(p):
    plane, spawned, retired = FakePlane(), [], []
    fleet = policy_fleet(p, p.co([p.fake()], [p.fake()]), plane, spawned, retired,
                         cooldown_s=60.0)
    plane.alerts = [qd_alert("decode")]
    out = [fleet.evaluate_once()["decode"] for _ in range(4)]
    fleet._last_scale_up["decode"] = float("-inf")
    out.append(fleet.evaluate_once()["decode"])
    return out, kinds(fleet)


def step_max_bounds_a_wave(p):
    plane, spawned, retired = FakePlane(), [], []
    fleet = policy_fleet(p, p.co([p.fake()], [p.fake()]), plane, spawned, retired, step_max=2)
    qd = p.registry.get("serve_disagg_queue_depth")
    qd.add(10, tags={"role": "decode"})
    try:
        out = fleet.evaluate_once()
        demand = p.registry.get("serve_fleet_demand").get(tags={"role": "decode"})
    finally:
        qd.add(-10, tags={"role": "decode"})
    return out, demand, spawned


def min_replicas_holds(p):
    plane, spawned, retired = FakePlane(), [], []
    fleet = policy_fleet(p, p.co([p.fake()], [p.fake()]), plane, spawned, retired)
    return [fleet.evaluate_once() for _ in range(10)], retired


def rebalance_between_roles(p):
    plane, spawned, retired = FakePlane(), [], []
    fleet = policy_fleet(p, p.co([p.fake(), p.fake()], [p.fake(), p.fake()]), plane, spawned,
                         retired, max_replicas=2, idle_periods=1)
    plane.alerts = [qd_alert("decode")]
    return [fleet.evaluate_once() for _ in range(3)], kinds(fleet), spawned, retired


def global_knobs(p):
    fleet = p.fleet.FleetController(p.co([p.fake()], [p.fake()]), {}, plane=FakePlane())
    return fleet._cooldown_s(), fleet._step_max(), fleet.cfg


def serve_mode_set_target(p):
    calls = []

    class Ctrl:
        def set_target(self, name, target):
            calls.append((name, target))
            return True

    plane = FakePlane()
    plane.alerts = [qd_alert("decode")]
    fleet = p.fleet.FleetController(p.co([p.fake()], [p.fake()]),
                                    {"cooldown_s": 0.0, "step_max": 1, "idle_periods": 2},
                                    controller=Ctrl(), deployments={"decode": "llm-decode"},
                                    plane=plane)
    return fleet.evaluate_once(), calls, kinds(fleet)


POLICY_FLOWS = [converges_without_oscillation, cooldown_blocks_rescale, step_max_bounds_a_wave,
                min_replicas_holds, rebalance_between_roles, global_knobs,
                serve_mode_set_target]


@pytest.mark.parametrize("flow", POLICY_FLOWS, ids=lambda f: f.__name__)
def test_policy_matches_reference(flow):
    port, ref = both(flow)
    if flow is global_knobs:  # dataclasses of two packages: compare their fields
        port, ref = port[:2] + (vars(port[2]),), ref[:2] + (vars(ref[2]),)
    assert port == ref


def test_policy_outcomes_are_the_reference_tests_asserts():
    (out, spawned, retired, _k, _i), _ = both(converges_without_oscillation)
    assert out[0]["decode"] == 2 and out[1] == 2 and spawned == ["decode"]
    assert out[3]["decode"] == 1 and out[4] == 1 and retired == ["decode"]
    assert out[5] == [1, 1, 1]
    (out, _k), _ = both(cooldown_blocks_rescale)
    assert out == [2, 2, 2, 2, 3]
    (out, _d, _s), _ = both(step_max_bounds_a_wave)
    assert out["decode"] == 3
    (out, retired), _ = both(min_replicas_holds)
    assert out[-1] == {"prefill": 1, "decode": 1} and not retired
    (out, calls, _k), _ = both(serve_mode_set_target)
    assert calls == [("llm-decode", 2)]


@pytest.mark.parametrize("value,match", [({"max_replicaz": 3}, "unknown fleet option"),
                                         ({"idle_periods": 0}, "idle_periods"),
                                         ({"min_replicas": 3, "max_replicas": 2}, "min_replicas"),
                                         ({"eval_period_s": 0}, "eval_period_s"),
                                         ({"target_queue_depth": -1}, "target_queue_depth"),
                                         ([1, 2], "fleet must be a mapping")])
def test_config_refuses_what_the_reference_refuses(value, match):
    for p in (Pkg("ray_tpu_torch"), Pkg("ray_tpu")):
        with pytest.raises(ValueError, match=match):
            p.fleet.FleetConfig.parse(value)


def test_config_parses_as_the_reference():
    value = {"min_replicas": 0, "max_replicas": 3, "eval_period_s": 0.5, "cooldown_s": 0.0,
             "idle_periods": 3, "step_max": 2, "rebalance_roles": False}
    port, ref = (vars(p.fleet.FleetConfig.parse(value)) for p in (Pkg(n) for n in PACKAGES))
    assert port == ref
    cfg = tfleet.FleetConfig.parse(value)
    assert tfleet.FleetConfig.parse(cfg) is cfg


# -------------------------------------------- scale-down and remediation


def busy_replica_drains_then_drops(p):
    busy, idle = p.fake(load=1), p.fake()
    co = p.co([p.fake()], [busy, idle], drain_grace_s=60)
    co._kv_dest_cache[busy.key] = object()
    out = [co.remove_worker("decode", key=busy.key) is busy, busy in co.workers("decode"),
           co.stats()["draining"], busy.key in co._kv_dest_cache]
    busy._load = 0
    out += [co.stats()["draining"], busy.key in co._kv_dest_cache]
    a, b = p.fake(load=3), p.fake()
    co2 = p.co([p.fake()], [a, b])
    out += [co2.remove_worker("decode") is b, co2.workers("decode") == [a]]
    return [x if not isinstance(x, list) else len(x) for x in out]


def alert_drives_the_pipeline(p):
    plane, spawned, retired = FakePlane(), [], []
    sick = p.fake()
    co = p.co([p.fake()], [sick, p.fake()])
    fleet = policy_fleet(p, co, plane, spawned, retired)
    before = p.stages()
    plane.fire({"rule": "replica_errors", "state": "firing", "severity": "critical",
                "labels": {"replica": sick.key}})
    plane.fire({"rule": "replica_errors", "state": "resolved", "labels": {"replica": "x"}})
    stages = {s: n - before[s] for s, n in p.stages().items()}
    state = (sick in co.workers("decode"), sick.retired, co.health.quarantined(sick.key),
             len(co.workers("decode")), list(spawned), stages)
    fleet._remediating.add("busy-key")
    return state + (fleet.remediate("decode", "busy-key"), [k[0] for k in kinds(fleet)])


def loop_evaluates_periodically(p):
    plane, spawned, retired = FakePlane(), [], []
    co = p.co([p.fake()], [p.fake()])
    fleet = policy_fleet(p, co, plane, spawned, retired, eval_period_s=0.02, cooldown_s=60.0)
    plane.alerts = [qd_alert("decode")]
    before = set(threading.enumerate())
    fleet.start()
    try:
        deadline = time.monotonic() + 10.0
        while len(co.workers("decode")) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        fleet.stop()
    st = fleet.status()
    left = [t for t in threading.enumerate() if t not in before and t.is_alive()]
    return st["targets"], st["live"], left


@pytest.mark.parametrize("flow", [busy_replica_drains_then_drops, alert_drives_the_pipeline,
                                  loop_evaluates_periodically], ids=lambda f: f.__name__)
def test_fleet_flow_matches_reference(flow):
    port, ref = both(flow)
    assert port == ref
    if flow is alert_drives_the_pipeline:
        assert port[:5] == (False, True, True, 2, ["decode"])
        assert port[5] == dict.fromkeys(STAGES, 1.0) and port[6] is False
    if flow is loop_evaluates_periodically:
        assert port[0]["decode"] == 2 and port[1]["decode"] == 2 and port[2] == []


# ------------------------------------------------- engines: resume, LoRA


def mortal_worker(p, engine, name):
    base = p.disagg.EngineWorker

    class Mortal(base):
        """Decode streams that raise once kill() is set: the in-process
        stand-in for a replica SIGKILLed mid-stream."""

        def __init__(self, engine, name):
            super().__init__(engine, name)
            self.killed = threading.Event()
            self.deaths = 0

        def _mortal(self, inner):
            for item in inner:
                if self.killed.is_set():
                    self.deaths += 1
                    raise RuntimeError(f"{self.name} SIGKILLed mid-stream")
                yield item

        def decode_stream(self, request):
            return self._mortal(super().decode_stream(request))

        def generate_stream(self, request):
            return self._mortal(super().generate_stream(request))

    return Mortal(engine, name)


def prompts(cfg, lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, size=n)] for n in lengths]


def kill_resume(p):
    """The only decode replica dies after three tokens; a peer joined by a
    FleetController scale-up takes the resumed stream."""
    pe, de1, de2 = p.engine(), p.engine(), p.engine(page_size=4, max_pages=96)
    mortal = mortal_worker(p, de1, "mortal0")
    co = p.co([p.disagg.EngineWorker(pe, "prefill0")], [mortal])
    plane = FakePlane()
    fleet = p.fleet.FleetController(co, {"cooldown_s": 0.0, "step_max": 1, "max_replicas": 2},
                                    spawn_fn=lambda role: p.disagg.EngineWorker(de2, "healthy0"),
                                    plane=plane)
    resumes = p.registry.get("serve_fleet_resumes")
    r0 = resumes.get()
    try:
        prompt = prompts(p.tiny["tcfg"], (9,))[0]
        ds = co.open_stream(prompt, max_tokens=12)
        it = ds.tokens()
        got = [next(it) for _ in range(3)]
        plane.alerts = [qd_alert("decode")]
        targets = fleet.evaluate_once()
        mortal.killed.set()
        got.extend(it)
        return (got, ds.finish_reason, ds.error, mortal.deaths >= 1, resumes.get() - r0,
                co.health.quarantined(mortal.key), [w.load() for w in co.workers("decode")],
                mortal.load(), targets, [k[0] for k in kinds(fleet)])
    finally:
        co.close()
        pe.stop(), de1.stop(), de2.stop()


def resume_storm(p):
    pe, de1, de2 = p.engine(), p.engine(), p.engine(max_pages=96)
    mortal = mortal_worker(p, de1, "mortal1")
    co = p.co([p.disagg.EngineWorker(pe, "prefill1")], [mortal])
    try:
        streams = [co.open_stream(q, max_tokens=10)
                   for q in prompts(p.tiny["tcfg"], (5, 9, 13), seed=11)]
        its = [ds.tokens() for ds in streams]
        heads = [[next(it)] for it in its]
        co.add_worker("decode", p.disagg.EngineWorker(de2, "healthy1"))
        mortal.killed.set()
        outs, errs = {}, {}

        def drain(i):
            try:
                outs[i] = heads[i] + list(its[i])
            except Exception as e:  # noqa: BLE001
                errs[i] = repr(e)

        ts = [threading.Thread(target=drain, args=(i,)) for i in range(len(streams))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=WAIT_S)
        return [outs.get(i) for i in range(len(streams))], errs
    finally:
        co.close()
        pe.stop(), de1.stop(), de2.stop()


def resume_off_surfaces_the_death(p):
    pe, de = p.engine(), p.engine()
    mortal = mortal_worker(p, de, "mortal2")
    co = p.co([p.disagg.EngineWorker(pe, "prefill2")], [mortal], live_resume=False)
    try:
        it = co.open_stream(prompts(p.tiny["tcfg"], (9,), seed=3)[0], max_tokens=8).tokens()
        next(it)
        mortal.killed.set()
        with pytest.raises(RuntimeError, match="SIGKILL"):
            list(it)
        return True
    finally:
        co.close()
        pe.stop(), de.stop()


def adapter_hot_swap(p, monkeypatch):
    pe, de1, de2 = p.engine(), p.engine(), p.engine()
    resident = p.disagg.EngineWorker(de1, "resident")
    bare = p.disagg.EngineWorker(de2, "bare")
    co = p.co([p.disagg.EngineWorker(pe, "prefill4")], [resident, bare], adapter_gossip_s=0.0)
    fleet = p.fleet.FleetController(co, {}, plane=FakePlane())
    broadcasts = []
    monkeypatch.setattr(p.fleet.api, "put", lambda v: {"ref": v})
    monkeypatch.setattr(p.fleet.api, "broadcast",
                        lambda ref, **kw: broadcasts.append(ref) or {"warmed": [], "failed": []})
    monkeypatch.setattr(p.disagg.api, "get", lambda ref, timeout=None: ref["ref"])
    try:
        out = fleet.distribute_adapter("ada-1", weights={"rank": 4}, roles=("decode",))
        loaded = sorted(out["loaded"]) == sorted([str(resident.key), str(bare.key)])
        residency = p.registry.get("serve_fleet_adapter_residency").get(
            tags={"adapter": "ada-1"})
        with bare._adapter_lock:
            bare._adapters.clear()
        prompt = prompts(p.tiny["tcfg"], (9,), seed=9)[0]
        got = [co.generate(prompt, max_tokens=4, adapter_id="ada-1")["token_ids"]
               for _ in range(4)]
        fleet.evaluate_once()  # the residency gauge follows the gossip
        after = p.registry.get("serve_fleet_adapter_residency").get(tags={"adapter": "ada-1"})
        with pytest.raises(ValueError, match="not resident"):
            co.generate(prompt, max_tokens=4, adapter_id="ghost")
        return (loaded, out["failed"], len(broadcasts), residency, got, after,
                co.adapter_residency()[str(resident.key)], bare.list_adapters(),
                fleet.status()["adapter_residency"] == co.adapter_residency())
    finally:
        co.close()
        pe.stop(), de1.stop(), de2.stop()


def sync_weights_flow(p, monkeypatch):
    """sync_weights of the engines' own tree as version 3 over both roles,
    the object plane stood in for (put/broadcast/get), as the adapter flow
    does."""
    pe, de = p.engine(), p.engine()
    co = p.co([p.disagg.EngineWorker(pe, "p5")], [p.disagg.EngineWorker(de, "d5")])
    fleet = p.fleet.FleetController(co, {}, plane=FakePlane())
    params = p.tiny["tparams"] if p.port else p.tiny["jparams"]
    monkeypatch.setattr(p.fleet.api, "put", lambda v: {"ref": v})
    monkeypatch.setattr(p.fleet.api, "broadcast", lambda ref, **kw: None)
    monkeypatch.setattr(p.disagg.api, "get", lambda ref, timeout=None: ref["ref"])
    try:
        prompt = prompts(p.tiny["tcfg"], (9,), seed=5)[0]
        before = co.generate(prompt, max_tokens=6)["token_ids"]
        out = fleet.sync_weights(weights=params, version=3)
        after = co.generate(prompt, max_tokens=6)
        return ([s["weights_version"] for s in out["synced"]], out["failed"], before,
                after["token_ids"], after["weights_version"],
                sorted(co.weights_versions().values()))
    finally:
        co.close()
        pe.stop(), de.stop()


@pytest.mark.parametrize("flow", [kill_resume, resume_storm, resume_off_surfaces_the_death,
                                  sync_weights_flow], ids=lambda f: f.__name__)
def test_engine_flow_matches_reference(flow, tiny, monkeypatch):
    extra = (monkeypatch,) if flow is sync_weights_flow else ()
    port = flow(Pkg("ray_tpu_torch", tiny), *extra)
    ref = flow(Pkg("ray_tpu", tiny), *extra)
    assert port == ref
    want = Pkg("ray_tpu", tiny)
    engine = want.engine()
    try:
        if flow is kill_resume:
            assert port[0] == engine.generate(prompts(tiny["tcfg"], (9,))[0],
                                              max_tokens=12)["token_ids"]
            assert port[1:] == ("length", None, True, 1.0, True, [0, 0], 0,
                                {"prefill": 1, "decode": 2}, ["scale-up"])
        if flow is resume_storm:
            assert port[1] == {}
            assert port[0] == [engine.generate(q, max_tokens=10)["token_ids"]
                               for q in prompts(tiny["tcfg"], (5, 9, 13), seed=11)]
        if flow is sync_weights_flow:
            assert port[0] == [3, 3] and port[2] == port[3] and port[4] == 3
    finally:
        engine.stop()


def test_adapter_hot_swap_matches_reference(tiny, monkeypatch):
    port = adapter_hot_swap(Pkg("ray_tpu_torch", tiny), monkeypatch)
    ref = adapter_hot_swap(Pkg("ray_tpu", tiny), monkeypatch)
    assert port == ref
    assert port[0] and port[1] == [] and port[2] == 1 and port[3] == 2.0
    assert len({tuple(g) for g in port[4]}) == 1 and port[5] == 1.0
    assert port[6] == ["ada-1"] and port[7] == [] and port[8]


# ------------------------------------------------------- the port alone


class SlowPrefill:
    """A prefill worker whose legs take `delay` seconds each."""

    def __init__(self, key, delay):
        self.key, self.delay = key, delay

    def load(self):
        return 0

    def prefill_request(self, request):
        time.sleep(self.delay)
        raise RuntimeError("the double prefills nothing")

    def cancel(self, request_id):
        return False

    def kv_dest(self, ttl_s=None):
        return None


def backlog_depth(p):
    co = p.co([SlowPrefill("slow", 0.3)], [FakeWorker("d")], kv_transfer="object")
    gauge = p.registry.get("serve_disagg_queue_depth")
    threads = [threading.Thread(target=lambda: pytest.raises(RuntimeError, co.generate,
                                                             [1, 2, 3], max_tokens=2))
               for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.15)  # all four admitted, their prefill legs running
    depth = gauge.get(tags={"role": "prefill"})
    for t in threads:
        t.join(timeout=WAIT_S)
    return depth, gauge.get(tags={"role": "prefill"})


def test_a_prefill_backlog_shows_in_the_queue_depth_where_the_reference_reads_zero():
    port, ref = both(backlog_depth)
    assert port == (4.0, 0.0)
    assert ref == (0.0, 0.0)


def test_serve_mode_remediation_resumes_streams_on_the_replacement(tiny):
    """deploy_disagg in thread mode; an alert naming the decode replica
    while two streams decode: the serve controller retires it (its streams
    fail and resume) and builds a replacement, each stage counts once, the
    streams equal the reference's uninterrupted engine, and the retired
    replica's engine threads end."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.core import health
    from ray_tpu_torch.serve.controller import get_or_create_controller

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, num_gpus=0, system_config=dict(THREAD_MODE))
    co = fleet = None
    try:
        before_threads = set(threading.enumerate())
        plane = health.HealthPlane(rules=[], metrics_fn=lambda: [], digests_fn=lambda: [])
        params, cfg = tiny["tparams"], tiny["tcfg"]
        co = tdisagg.deploy_disagg("tiny-llama", {"prefix_routing": False}, name="rm",
                                   engine_config=ENGINE_KW, params_fn=lambda: (params, cfg),
                                   device="cpu")
        fleet = tfleet.FleetController(co, {"eval_period_s": 0.05},
                                       deployments={"prefill": "rm-prefill",
                                                    "decode": "rm-decode"},
                                       plane=plane)
        before = Pkg("ray_tpu_torch").stages()
        (victim,) = co.workers("decode")
        qs = prompts(cfg, (9, 20), seed=21)
        streams = [co.open_stream(q, max_tokens=24, timeout_s=WAIT_S) for q in qs]
        its = [ds.tokens() for ds in streams]
        heads = [[next(it) for _ in range(3)] for it in its]
        plane.inject("replica_fault", {"replica": str(victim.key)}, value=1.0)
        outs = [h + list(it) for h, it in zip(heads, its)]
        deadline = time.monotonic() + WAIT_S
        while (Pkg("ray_tpu_torch").stages()["rejoin"] == before["rejoin"]
               and time.monotonic() < deadline):
            fleet.evaluate_once()
            time.sleep(0.05)
        stages = {s: n - before[s] for s, n in Pkg("ray_tpu_torch").stages().items()}
        ref = Pkg("ray_tpu", tiny).engine()
        try:
            wants = [ref.generate(q, max_tokens=24)["token_ids"] for q in qs]
        finally:
            ref.stop()
        assert outs == wants
        assert stages == dict.fromkeys(STAGES, 1.0)
        assert [k[0] for k in kinds(fleet)] == ["remediate", "rejoin"]
        replicas, _ = ray_tpu_torch.get(
            get_or_create_controller().get_replicas.remote("rm-decode"), timeout=30)
        assert len(replicas) == 1 and replicas[0]._actor_id != victim._replica._actor_id
        rt = ray_tpu_torch.api._auto_init()
        deadline = time.monotonic() + 30
        while (rt.control_plane.get_actor(victim._replica._actor_id).state.name != "DEAD"
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert rt.control_plane.get_actor(victim._replica._actor_id).state.name == "DEAD"
        co.close()
        serve.shutdown()
        left = [t.name for t in threading.enumerate()
                if t not in before_threads and t.is_alive()]
        assert left == []
    finally:
        if co is not None:
            co.close()
        serve.shutdown()
        ray_tpu_torch.shutdown()


class Starting(FakeWorker):
    """A serve replica's worker whose __init__ has not finished."""

    def ready(self):
        return False


def pick_over_a_starting_replica(p):
    """A role with a busy ready replica and an idle one still starting: the
    picks for a request each; then a role whose only replica is starting,
    and becomes ready 0.3 s on: the pick, and how long it took."""
    co = p.co([FakeWorker("ready", load=1), Starting("starting", load=0)], [p.fake()])
    picks = [co._pick("prefill", time.monotonic() + 5).key for _ in range(4)]
    late = Starting("late")
    co2 = p.co([late], [p.fake()])
    timer = threading.Timer(0.3, lambda: setattr(late, "ready", lambda: True))
    timer.daemon = True
    timer.start()
    t0 = time.monotonic()
    key = co2._pick("prefill", time.monotonic() + 5).key
    took = time.monotonic() - t0
    timer.join(timeout=5)
    return picks, key, took >= 0.25


def test_a_starting_replica_takes_no_request_where_the_reference_sends_one():
    port, ref = both(pick_over_a_starting_replica)
    assert port == (["ready"] * 4, "late", True)  # the request waited for its __init__
    # pow2 takes the idle one, though it cannot serve yet; with no other, at once
    assert ref == (["starting"] * 4, "late", False)


def holds_while_a_replica_builds(p):
    """A role at target 2 whose second replica still builds, with no
    traffic: the targets over four evaluations, then over four more once
    it is ready."""
    building = Starting("building")
    co = p.co([p.fake()], [FakeWorker("ready-decode"), building])
    fleet = p.fleet.FleetController(co, {"idle_periods": 2, "cooldown_s": 0.0},
                                    plane=FakePlane())
    fleet._targets["decode"] = 2
    before = [fleet.evaluate_once()["decode"] for _ in range(4)]
    building.ready = lambda: True
    return before, [fleet.evaluate_once()["decode"] for _ in range(4)]


def test_a_building_replica_is_not_stepped_down_where_the_reference_retires_it():
    port, ref = both(holds_while_a_replica_builds)
    assert port == ([2, 2, 2, 2], [2, 1, 1, 1])  # idle periods count once it is ready
    assert ref == ([2, 1, 1, 1], [1, 1, 1, 1])


class ServeWorker(FakeWorker):
    """A serve replica's worker double: its actor handle carries an id."""

    def __init__(self, key, actor_id):
        super().__init__(key)
        self._replica = type("Handle", (), {"_actor_id": actor_id})()


class RecordingController:
    def __init__(self, events):
        self.events = events

    def set_target(self, name, target):
        self.events.append(("set_target", name, target))
        return True

    def retire_replica(self, name, actor_id, grace_s=0.0):
        self.events.append(("retire_replica", name, actor_id, grace_s))
        return True


def test_a_serve_mode_remediation_retires_through_the_controller_or_stops_at_its_drain(
        monkeypatch):
    """Without deployments= the fleet takes the deployment's name from the
    coordinator (from_deployments) and retires the replica through the
    serve controller; where neither names it, the remediation quarantines
    and drains the replica and kills nothing."""
    kills, events = [], []
    monkeypatch.setattr(tfleet.api, "kill", kills.append)
    co = tdisagg.DisaggCoordinator([FakeWorker("p")],
                                   [ServeWorker("d1", "a1"), ServeWorker("d2", "a2")],
                                   {"small_blob_bytes": 0})
    fleet = tfleet.FleetController(co, {}, controller=RecordingController(events),
                                   plane=FakePlane())
    before = Pkg("ray_tpu_torch").stages()
    assert fleet.remediate("decode", "d1", reason="test") is True
    stages = {s: n - before[s] for s, n in Pkg("ray_tpu_torch").stages().items()}
    assert (events, kills) == ([], [])
    assert stages == {"quarantine": 1.0, "drain": 1.0, "restart": 0.0, "rejoin": 0.0}
    assert [w.key for w in co.workers("decode")] == ["d2"]
    assert co.health.quarantined("d1")

    co._deployments = {"prefill": "fx-prefill", "decode": "fx-decode"}
    assert fleet.remediate("decode", "d2", reason="test") is True
    assert events == [("retire_replica", "fx-decode", "a2", 0.0)] and kills == []
    assert Pkg("ray_tpu_torch").stages()["restart"] - before["restart"] == 1.0


def test_a_serve_mode_step_down_syncs_the_pick_set_once_the_controller_has_retired():
    """C13: the coordinator drops the replica the controller retired at the
    step-down itself, not up to a sync period later."""
    events = []
    co = tdisagg.DisaggCoordinator([FakeWorker("p")], [FakeWorker("d1"), FakeWorker("d2")],
                                   {"small_blob_bytes": 0})
    co._sync = lambda force=False: events.append(("sync", force))
    fleet = tfleet.FleetController(co, {"idle_periods": 1, "cooldown_s": 0.0},
                                   controller=RecordingController(events),
                                   deployments={"decode": "fx-decode"}, plane=FakePlane())
    fleet._targets["decode"] = 2
    assert fleet.evaluate_once()["decode"] == 1
    assert events == [("sync", False), ("set_target", "fx-decode", 1), ("sync", True)]


def test_a_resume_that_meets_a_retired_replica_opens_again_where_the_reference_ends_it(tiny):
    """C13: deploy_disagg in thread mode, two prefill and two decode
    replicas. The serve controller steps the prefill role down while the
    coordinator's next sync is held off, so its pick set still holds the
    retired, dead replica; with the surviving one quarantined every prefill
    pick lands on it. Then the decode replica of a live stream dies
    mid-stream: the stream resumes on the other decode replica, its
    continuation's prefill leg meets the dead replica and fails, and the
    coordinator syncs its pick sets and opens the continuation again. The
    stream ends with the reference's uninterrupted tokens, one resume is
    counted, and the decode peer is not quarantined for the prefill leg's
    failure. (The reference re-raises the first death at the failed
    continuation.)"""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.controller import get_or_create_controller

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, num_gpus=0, system_config=dict(THREAD_MODE))
    co = None
    try:
        params, cfg = tiny["tparams"], tiny["tcfg"]
        co = tdisagg.deploy_disagg("tiny-llama", {"prefix_routing": False,
                                                  "prefill_replicas": 2, "decode_replicas": 2},
                                   name="c13", engine_config=ENGINE_KW,
                                   params_fn=lambda: (params, cfg), device="cpu")
        killed = {}
        for w in co.workers("decode"):  # SIGKILLed mid-stream once its event is set
            killed[w.key] = threading.Event()

            def mortal(request, _inner=w.decode_stream, _ev=killed[w.key]):
                inner = _inner(request)  # the call, and its import, at once

                def gen():
                    try:
                        for item in inner:
                            if _ev.is_set():
                                raise RuntimeError("decode replica SIGKILLed mid-stream")
                            yield item
                    finally:
                        inner.close()

                return gen()

            w.decode_stream = mortal
        resumes = tmetrics.registry.get("serve_fleet_resumes")
        r0 = resumes.get()
        q = prompts(cfg, (9,), seed=31)[0]
        ds = co.open_stream(q, max_tokens=24, timeout_s=WAIT_S)
        it = ds.tokens()
        head = [next(it) for _ in range(3)]
        victim = co._live[ds.request_id][-1]
        (peer,) = [w for w in co.workers("decode") if w.key != victim.key]

        ctrl = get_or_create_controller()
        assert ray_tpu_torch.get(ctrl.set_target.remote("c13-prefill", 1), timeout=30)
        replicas, _ = ray_tpu_torch.get(ctrl.get_replicas.remote("c13-prefill"), timeout=30)
        listed = {r._actor_id for r in replicas}
        (retired,) = [w for w in co.workers("prefill") if w._replica._actor_id not in listed]
        (kept,) = [w for w in co.workers("prefill") if w._replica._actor_id in listed]
        rt = ray_tpu_torch.api._auto_init()
        deadline = time.monotonic() + 30
        while (rt.control_plane.get_actor(retired._replica._actor_id).state.name != "DEAD"
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert rt.control_plane.get_actor(retired._replica._actor_id).state.name == "DEAD"
        co._last_sync = time.monotonic() + 3600  # the race's window: no sync until forced
        co.health.quarantine(kept.key, duration=3600)

        killed[victim.key].set()
        out = head + list(it)
        ref = Pkg("ray_tpu", tiny).engine()
        try:
            want = ref.generate(q, max_tokens=24)["token_ids"]
        finally:
            ref.stop()
        assert (out, ds.error, resumes.get() - r0) == (want, None, 1.0)
        assert not co.health.quarantined(peer.key)
        assert [w.key for w in co.workers("prefill")] == [kept.key]
    finally:
        if co is not None:
            co.close()
        serve.shutdown()
        ray_tpu_torch.shutdown()


class HeldPrefill(FakeWorker):
    """A prefill worker that runs `slots` legs at once, took `build` seconds
    to build, and whose legs run until `release` is set; `ready` says
    whether it takes picks yet."""

    def __init__(self, key, slots, build=0.0, ready=True):
        super().__init__(key)
        self.slots = slots
        self.build = build
        self.release = threading.Event()
        self.is_ready = ready

    def ready(self):
        return self.is_ready

    def admits(self, role):
        return self.slots

    def build_s(self):
        return self.build

    def prefill_request(self, request):
        self.release.wait(WAIT_S)
        raise RuntimeError("the double prefills nothing")

    def kv_dest(self, ttl_s=None):
        return None


def prefill_target_under_legs(prefill, n=4, hold_s=0.0):
    """n requests at once on a coordinator whose prefill role holds
    `prefill` (a HeldPrefill, or None for no replica at all: one joins
    after the reading), under the fleet's default target_queue_depth (2 a
    replica), read `hold_s` after they are all counted: the prefill queue
    depth, the legs in service and the fleet's prefill target while they
    are held, then the queue depth and the legs in service after they
    return."""
    co = tdisagg.DisaggCoordinator([prefill] if prefill else [], [FakeWorker("d")],
                                   {"small_blob_bytes": 0, "kv_transfer": "object"})
    fleet = tfleet.FleetController(co, {"cooldown_s": 0.0}, plane=FakePlane())
    gauge = tdisagg._m_queue_depth
    threads = [threading.Thread(target=lambda: pytest.raises(RuntimeError, co.generate,
                                                             [1, 2, 3], max_tokens=2),
                                daemon=True) for _ in range(n)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + WAIT_S
        while (gauge.get(tags={"role": "prefill"}) < n
               and time.monotonic() < deadline):
            time.sleep(0.01)
        time.sleep(hold_s)
        held = (gauge.get(tags={"role": "prefill"}), len(co._legs["prefill"]),
                fleet.evaluate_once()["prefill"])
    finally:
        if prefill is None:
            prefill = HeldPrefill("joined", slots=4)
            co.add_worker("prefill", prefill)
        prefill.is_ready = True
        prefill.release.set()
        for t in threads:
            t.join(timeout=WAIT_S)
    return held, (gauge.get(tags={"role": "prefill"}), len(co._legs["prefill"]))


def test_four_prefill_legs_on_one_replica_hold_the_role_at_the_default_target_queue_depth():
    """C15 (repaired): a request counts in the prefill queue depth until its
    prefill leg returns (C11), but the fleet reads the backlog. Four legs
    on one replica that runs one prompt at once (a prefill engine at its
    default prefill_batch_size) and took 60 s to build: one runs and three
    wait, but the replica runs them long before another could be built, so
    the role holds at one replica under the default target_queue_depth of
    2 a replica (before the repair the four read 4 > 2 and built a second
    replica); on a replica that runs four at once, none waits."""
    assert prefill_target_under_legs(HeldPrefill("p", slots=1, build=60.0)) == (
        (4.0, 4, 1), (0.0, 0))
    assert prefill_target_under_legs(HeldPrefill("p", slots=4)) == ((4.0, 4, 1), (0.0, 0))


def test_prefill_legs_that_wait_scale_the_role():
    """The requests that really wait still count, and raise the target to
    2: four legs on a one-leg replica that builds at once (three wait past
    it), four legs on a one-leg replica that builds in 0.05 s once the
    oldest has run 0.3 s (a leg takes longer than a build, so none of the
    three waiting is run before a new replica could take it), and four
    requests in the pick of a role with no replica. Four requests in the
    pick while the role's replica builds wait for that build: the role
    holds at 1 (a second build beside it is what C15's flapping was)."""
    assert prefill_target_under_legs(HeldPrefill("p", slots=1)) == ((4.0, 4, 2), (0.0, 0))
    assert prefill_target_under_legs(HeldPrefill("p", slots=1, build=0.05), hold_s=0.3) == (
        (4.0, 4, 2), (0.0, 0))
    assert prefill_target_under_legs(None) == ((4.0, 0, 2), (0.0, 0))
    assert prefill_target_under_legs(HeldPrefill("p", slots=4, ready=False)) == (
        (4.0, 0, 1), (0.0, 0))


def test_an_engine_worker_reports_what_its_engine_runs_at_once_and_its_build(tiny):
    """A real engine behind EngineWorker: as a prefill replica it runs one
    prompt at once at the default prefill_batch_size (its prefill thread's
    largest tier: 32 with prefill_batch_size 4), as a decode replica its
    max_batch_size slots, and it reports the seconds its build took. Four
    legs held on it as the prefill role: three wait, and none counts as
    backlog while a leg is short of the build time; a replica that builds
    at once leaves all three in it."""
    p = Pkg("ray_tpu_torch", tiny)
    worker = tdisagg.EngineWorker(p.engine(), "p")
    batched = tdisagg.EngineWorker(p.engine(prefill_batch_size=4), "pb")
    assert [(w.admits("prefill"), w.admits("decode")) for w in (worker, batched)] == [
        (1, ENGINE_KW["max_batch_size"]), (32, ENGINE_KW["max_batch_size"])]
    assert worker.build_s() > 0.0
    co = tdisagg.DisaggCoordinator([worker], [FakeWorker("d")], {"small_blob_bytes": 0})
    legs = [object() for _ in range(4)]
    try:
        for leg in legs:
            co._pick("prefill", time.monotonic() + WAIT_S, leg=leg)
        worker.engine._init_s = 3600.0
        long_build = co.backlog("prefill")
        worker.engine._init_s, worker.engine.capture_stats = 0.0, {}
        instant_build = co.backlog("prefill")
    finally:
        for leg in legs:
            co._release_prefill_queue(leg)
    assert (long_build, instant_build, len(co._legs["prefill"])) == (0.0, 3.0, 0)
