"""The health plane (ray_tpu_torch.core.health: rules, HealthPlane, the
process-wide plane) and its callers against ray_tpu.core.health, on the CPU.

Every flow of tests/test_health.py's TestRuleParsing, TestHealthPlane and
TestStatusAndRoutes that runs in one process runs under both packages: the
rule grammar (and the malformed expressions both refuse), sustain, fire and
resolve, group_by with a `no_data` resolve, `delta`, quantile rules over
digests, `inject` that persists through its rule's sweep and expires, local
subscribers and `pending_demand`, the stock rule set under the config, the
payload and `status()` in text and as a dict, the alerts published on the
control plane's pubsub and recorded into the timeline, the ingest service's
tenant-scoped `data_stall_rising`, and the object ledger's `object_leak`
alerts. Sources are injected and every pass has an explicit `now` where the
flow allows, so alerts, values and labels must be equal between the
packages; where a flow reads the wall clock (`inject`, a tenant's stall)
the times and the stalled seconds are left out of the comparison.

Also here, for the port alone: the payload's `utilization` and `goodput`
sections are empty and `status(address=)` raises, both naming ROADMAP A5c
(util/profiler and the dashboard), and a started plane's thread ends with
`shutdown_health_plane()`.
"""

import threading
import time
from importlib import import_module

import pytest

import ray_tpu
import ray_tpu.data as jdata
import ray_tpu_torch
import ray_tpu_torch.data as tdata
from ray_tpu.core import health as jhealth, object_ledger as jledger
from ray_tpu.util import slo as jslo, timeline as jtimeline
from ray_tpu_torch.core import health as thealth
from ray_tpu_torch.core import object_ledger as tledger
from ray_tpu_torch.util import slo as tslo, timeline as ttimeline
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
TIMES = ("at", "since")


class Pkg:
    def __init__(self, name):
        port = name == "ray_tpu_torch"
        self.port = port
        self.api = ray_tpu_torch if port else ray_tpu
        self.health = thealth if port else jhealth
        self.slo = tslo if port else jslo
        self.name = name
        self.config = import_module(f"{name}.core.config").config
        self.data = tdata if port else jdata
        self.ledger = tledger if port else jledger
        self.timeline = ttimeline if port else jtimeline

    def plane(self, rules, metrics=lambda: [], digests=lambda: [], **kw):
        """A plane with injected sources and no thread."""
        return self.health.HealthPlane(rules=rules, period_s=60.0, metrics_fn=metrics,
                                       digests_fn=digests, **kw)

    def rule(self, *args, **kw):
        return self.health.Rule(*args, **kw)


def both(flow, *args):
    return flow(Pkg("ray_tpu_torch"), *args), flow(Pkg("ray_tpu"), *args)


def untimed(alerts):
    return [{k: v for k, v in a.items() if k not in TIMES} for a in alerts]


# ---------------------------------------------------------------- grammar


@pytest.mark.parametrize("expr", [
    "serve_disagg_queue_depth{role=prefill} > 64 for 2",
    "p95(serve_ttft_seconds{role=decode}) >= 0.5",
    "delta(control_plane_reconnects_total) > 2 for 3 periods",
    "node_heartbeat_age_seconds > 3 for 1",
    "value(temp) < -1.5e-3 for 1 period",
    "p50( lat{ role = decode , replica = r1 } ) <= 7",
    "p99(x.y_z{}) > 0",
])
def test_rule_grammar_matches_reference(expr):
    port, ref = (p.health.parse_rule(expr) for p in (Pkg("ray_tpu_torch"), Pkg("ray_tpu")))
    assert port == ref


@pytest.mark.parametrize("expr", ["", "foo", "foo >", "> 3", "p95(foo > 3", "foo == 3",
                                  "p42(foo) > 1", "foo > 3 for", "foo > 3 for x", "1foo > 2",
                                  "delta(foo > 2", "foo{role=a > 1", "p50(lat {role=a}) > 1"])
def test_malformed_rules_raise_in_both(expr):
    for p in (Pkg("ray_tpu_torch"), Pkg("ray_tpu")):
        with pytest.raises(ValueError, match="unparseable health rule"):
            p.health.parse_rule(expr)


# ------------------------------------------------------------ the plane


def sustain_fire_resolve(p):
    samples = []
    plane = p.plane([p.rule("hot", "temp > 10 for 2")], metrics=lambda: list(samples))
    samples[:] = [("temp", {}, 50.0)]
    out = [plane.evaluate(now=1.0), plane.evaluate(now=2.0)]
    samples[:] = [("temp", {}, 1.0)]
    out.append(plane.evaluate(now=3.0))
    return out, plane.history(), plane.active()


def group_by_no_data(p):
    samples = [("age", {"node_id": "a"}, 9.0), ("age", {"node_id": "b"}, 1.0)]
    plane = p.plane([p.rule("gap", "age > 5", group_by=("node_id",), severity="critical")],
                    metrics=lambda: list(samples))
    out = [plane.evaluate(now=1.0)]
    samples[:] = [("age", {"node_id": "b"}, 1.0)]
    out.append(plane.evaluate(now=2.0))
    return out, plane.history(), plane.scores()


def delta_rising(p):
    box = {"v": 100.0}
    plane = p.plane([p.rule("spike", "delta(reconnects{role=head}) > 2")],
                    metrics=lambda: [("reconnects", {"role": "head"}, box["v"]),
                                     ("reconnects", {"role": "worker"}, 1e6)])
    out = [plane.evaluate(now=1.0), plane.evaluate(now=2.0)]
    for v in (105.0, 105.5, 109.0):
        box["v"] = v
        out.append(plane.evaluate(now=len(out) + 1.0))
    return out, plane.history()


def quantile_over_digests(p):
    dec = p.slo.Digest("serve_ttft_seconds", tags={"role": "decode", "replica": "r1"},
                       window_s=600)
    pre = p.slo.Digest("serve_ttft_seconds", tags={"role": "prefill"}, window_s=600)
    for i in range(100):
        dec.add(0.8 if i % 10 else 0.05, now=1.0)
        pre.add(0.01, now=1.0)
    plane = p.plane(
        [p.rule("slo", "p95(serve_ttft_seconds) > 0.5", group_by=("role",),
                severity="critical"),
         p.rule("p50s", "p50(serve_ttft_seconds{role=decode}) > 0.1")],
        digests=lambda: [dec.to_snapshot(now=1.0), pre.to_snapshot(now=1.0)])
    active = plane.evaluate(now=1.0)
    payload = plane.payload()
    return active, payload["digests"], payload["scores"], payload["alerts"]


def inject_persists_and_expires(p):
    plane = p.plane([p.rule("memory_pressure", "host_mem > 0.9", group_by=("node_id",))])
    plane.period_s = 1.0
    first = plane.inject("memory_pressure", {"source": "memory_monitor"}, 0.97)
    again = plane.inject("memory_pressure", {"source": "memory_monitor"}, 0.98)
    kept = plane.evaluate(now=time.time())
    gone = plane.evaluate(now=time.time() + 10.0)
    return (untimed([first, again]), untimed(kept), gone,
            untimed(plane.history()), plane.pending_demand())


def subscribe_and_demand(p):
    seen = []
    samples = [("queue", {"role": "decode"}, 100.0), ("queue", {"role": "prefill"}, 1.0)]
    plane = p.plane([p.rule("backlog", "queue > 10", group_by=("role",),
                            demand={"CPU": 2.0})], metrics=lambda: list(samples))
    plane.subscribe(seen.append)
    plane.evaluate(now=1.0)
    demand = plane.pending_demand()
    samples[:] = []
    plane.evaluate(now=2.0)
    return seen, demand, plane.pending_demand()


def stock_rules(p, overrides):
    p.config.apply_overrides(overrides)
    try:
        plane = p.health.HealthPlane(period_s=60.0, metrics_fn=lambda: [],
                                     digests_fn=lambda: [])
        return [(r.name, r.expr, r.severity, r.group_by, r.demand, r._p) for r in plane.rules]
    finally:
        p.config.reset()


def stock_rules_fire(p):
    """The stock queue_depth and data_stall_rising rules over samples."""
    p.config.apply_overrides({"health_queue_depth_max": 4})
    try:
        rules = p.health.default_rules()
    finally:
        p.config.reset()
    depth = {"prefill": 9.0, "decode": 0.0}
    stall = {"a": 0.0, "b": 0.0}
    plane = p.plane(rules, metrics=lambda: (
        [("serve_disagg_queue_depth", {"role": r}, v) for r, v in depth.items()]
        + [("data_stage_stall_seconds", {"stage": "ingest", "tenant": t}, v)
           for t, v in stall.items()]))
    out = []
    for i, (sa, sb) in enumerate([(0.0, 0.0), (1.5, 0.1), (3.0, 0.2), (3.5, 0.3)]):
        stall.update(a=sa, b=sb)
        out.append(plane.evaluate(now=float(i)))
    return out, plane.pending_demand()


FLOWS = [sustain_fire_resolve, group_by_no_data, delta_rising, quantile_over_digests,
         inject_persists_and_expires, subscribe_and_demand, stock_rules_fire]


@pytest.mark.parametrize("flow", FLOWS, ids=lambda f: f.__name__)
def test_plane_flow_matches_reference(flow):
    port, ref = both(flow)
    assert port == ref


@pytest.mark.parametrize("overrides", [{}, {"slo_ttft_ms": 250.0, "rl_sync_stall_max_pct": 0.0},
                                       {"health_queue_depth_max": 4,
                                        "health_memory_fraction_max": 0.5,
                                        "health_check_period_ms": 200}])
def test_stock_rules_match_reference(overrides):
    port, ref = both(stock_rules, overrides)
    assert port == ref


def test_the_flows_see_what_the_reference_tests_assert():
    (fire, hist, active), _ = both(sustain_fire_resolve)
    assert fire[0] == [] and [a["rule"] for a in fire[1]] == ["hot"] and fire[2] == []
    assert [h["state"] for h in hist] == ["firing", "resolved"]
    assert hist[-1]["resolve_reason"] == "cleared" and active == []
    (out, hist, _scores), _ = both(group_by_no_data)
    assert out[0][0]["labels"] == {"node_id": "a"} and out[1] == []
    assert hist[-1]["resolve_reason"] == "no_data"
    (out, _hist), _ = both(delta_rising)
    assert [len(o) for o in out] == [0, 0, 1, 0, 1]
    (active, _d, _s, _a), _ = both(quantile_over_digests)
    assert {a["rule"]: a["labels"] for a in active} == {"slo": {"role": "decode"},
                                                      "p50s": {}}
    (first, kept, gone, hist, _d), _ = both(inject_persists_and_expires)
    assert first[0]["state"] == "firing" and len(kept) == 1 and gone == []
    assert hist[-1]["resolve_reason"] == "expired"
    (seen, demand, after), _ = both(subscribe_and_demand)
    assert [a["state"] for a in seen] == ["firing", "resolved"]
    assert demand == [{"CPU": 2.0}] and after == []
    (out, demand), _ = both(stock_rules_fire)
    assert [sorted((a["rule"], tuple(sorted(a["labels"].items()))) for a in o) for o in out][2] == [
        ("data_stall_rising", (("stage", "ingest"), ("tenant", "a"))),
        ("queue_depth", (("role", "prefill"),))]


# ------------------------------------------- status, pubsub and timeline


def status_and_bus(p):
    p.api.shutdown()
    p.api.init(num_cpus=2, system_config=dict(THREAD_MODE),
               **({"num_gpus": 0} if p.port else {"num_tpus": 0}))
    try:
        cw = import_module(f"{p.name}.core.core_worker")
        published = []
        unsubscribe = cw._global_runtime.control_plane.pubsub.subscribe("alerts",
                                                                         published.append)
        cursor, _ = p.timeline.drain_since(0)
        p.slo.clear()  # what earlier tests in this process observed
        p.slo.observe("serve_ttft_seconds", 0.05, tags={"role": "decode"})
        plane = p.health.get_health_plane(create=True)
        try:
            plane.inject("replica_fault", {"replica": "r7"}, value=1.0, severity="warning")
            payload = p.api.status(as_dict=True)
            printed = p.api.status()
            _c, events = p.timeline.drain_since(cursor)
        finally:
            p.health.shutdown_health_plane()
            unsubscribe()
        alerts = [e for e in events if e.get("cat") == "alert"]
        return (sorted(payload), untimed(payload["alerts"]), sorted(payload["digests"]),
                printed, untimed(published), [(e["name"], e["ph"], e["args"]) for e in alerts],
                [n["state"] for n in payload["nodes"]])
    finally:
        p.api.shutdown()


def test_status_pubsub_and_timeline_match_reference(capsys):
    port, ref = both(status_and_bus)
    out = capsys.readouterr().out
    assert port == ref
    assert port[3] is None  # status() prints its text
    for header in ("== ray_tpu_torch health ==", "== ray_tpu health =="):
        text = out[out.index(header):].split("\n\n")[0]
        assert "nodes: 1/1 alive" in text and "alerts firing: 1" in text
        assert "[warning ] replica_fault {'replica': 'r7'} value=1.0" in text
        assert "serve_ttft_seconds,role=decode: p50=" in text


# ------------------------------------------------- the plane's callers


def ingest_stall_fires_per_tenant(p):
    """A tenant whose blocks take 0.6 s each waits on the ingest service:
    the stock data_stall_rising rule, over the federated registry, fires
    for that tenant alone once its stall rose by more than 1 s on two
    passes running."""
    p.api.shutdown()
    p.api.init(num_cpus=4, system_config=dict(THREAD_MODE),
               **({"num_gpus": 0} if p.port else {"num_tpus": 0}))
    svc = None
    try:
        registry = import_module(f"{p.name}.core.metrics").registry
        stall = registry.get("data_stage_stall_seconds")
        rules = [r for r in p.health.default_rules() if r.name == "data_stall_rising"]
        plane = p.health.HealthPlane(rules=rules, period_s=60.0)
        ingest = import_module(f"{p.name}.data.ingest")
        svc = ingest.IngestService(pool_min=1, pool_max=1, autoscale=False)

        def slow(b):
            time.sleep(0.6)
            return {"x": b["id"] * 1.0}

        quick = svc.register(p.data.range(64, parallelism=1), tenant="quick")
        assert sum(len(b["id"]) for b in quick.iter_batches()) == 64
        starved = svc.register(p.data.range(6 * 32, parallelism=6).map_batches(slow),
                               tenant="starved")
        rows = []
        t = threading.Thread(target=lambda: rows.extend(
            len(b["x"]) for b in starved.iter_batches(batch_size=32)))

        def waited():
            return stall.get(tags={"stage": "ingest", "tenant": "starved"})

        t.start()
        deadline = time.monotonic() + 30
        while not waited() and time.monotonic() < deadline:
            time.sleep(0.005)
        active = [plane.evaluate(now=0.0)]  # the first sample: delta's base
        for i in (1, 2):
            base = waited()
            deadline = time.monotonic() + 30
            while waited() - base <= 1.05 and time.monotonic() < deadline:
                time.sleep(0.02)
            active.append(plane.evaluate(now=float(i)))
        t.join(timeout=60)
        assert not t.is_alive() and sum(rows) == 6 * 32
        return [[(a["rule"], a["labels"], a["value"] > 1.0, a["demand"]) for a in o]
                for o in active]
    finally:
        if svc is not None:
            svc.shutdown()
        p.data.shutdown_ingest_service()
        p.api.shutdown()


def test_ingest_stall_fires_per_tenant_as_in_reference():
    port, ref = both(ingest_stall_fires_per_tenant)
    assert port == ref
    assert port[-1] == [("data_stall_rising", {"stage": "ingest", "tenant": "starved"}, True,
                         {"CPU": 1.0})]


def object_leak_alerts(p):
    leaks = [{"kind": "cold_cache", "object_id": f"o{i}", "node_id": node, "size_bytes": 64,
              "age_s": 9.0, "pin_reason": "ingest_cache", "detail": "cold"}
             for i, node in enumerate(["n1", "n1", "n2"])]
    leaks.append({"kind": "owner_dead", "object_id": "o9", "node_id": "", "size_bytes": 8,
                  "age_s": 9.0, "pin_reason": "", "detail": "owner gone"})
    p.ledger._assert_alerts(leaks, {}, {})  # no plane: nothing to tell
    plane = p.health.get_health_plane(create=True)
    try:
        p.ledger._assert_alerts(leaks, {}, {})
        p.ledger._assert_alerts([], {}, {})
        return sorted(untimed(plane.active()), key=str)
    finally:
        p.health.shutdown_health_plane()


def test_object_ledger_injects_object_leak_as_reference():
    port, ref = both(object_leak_alerts)
    assert port == ref
    assert sorted((a["labels"]["kind"], a["labels"]["node_id"], a["value"]) for a in port) == [
        ("cold_cache", "n1", 2.0), ("cold_cache", "n2", 1.0), ("owner_dead", "?", 1.0)]


# ------------------------------------------------------- the port alone


def test_profiling_sections_and_remote_status_wait_for_a5c():
    # the payload's utilization and goodput sections are ported
    # (tests/test_torch_profiler.py); reading a remote head waits
    with pytest.raises(NotImplementedError, match="A5c"):
        ray_tpu_torch.status(address="127.0.0.1:8265")


def test_the_process_plane_starts_and_its_thread_ends():
    before = set(threading.enumerate())
    assert thealth.get_health_plane(create=False) is None
    plane = thealth.get_health_plane()
    try:
        assert thealth.get_health_plane(create=False) is plane
        assert any(t.name == "health-plane" and t not in before for t in threading.enumerate())
    finally:
        thealth.shutdown_health_plane()
    assert thealth.get_health_plane(create=False) is None
    assert [t for t in threading.enumerate() if t not in before and t.is_alive()] == []
