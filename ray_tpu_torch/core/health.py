"""SLO health plane: alert rules, health scores, health-aware routing.

The port's copy of ray_tpu/core/health.py. A `HealthPlane` periodically
evaluates declarative alert rules against three federated sources —
latency digests (util/slo.py), merged metric samples (this process's
registry + the control plane's per-node telemetry snapshots), and
control-plane heartbeat ages — and drives a firing/resolved alert
lifecycle that is published on pubsub channel ``"alerts"``, recorded into
the timeline (ph="i", cat="alert"), handed to local subscribers (the
disagg coordinator's quarantine, serve/fleet.py's remediation) and
rendered by `ray_tpu_torch.status()`. `ReplicaHealth` is the routing half
(serve/router.py, serve/disagg.py).

Rule syntax
===========
A rule is one comparison with an optional sustain window::

    p95(serve_ttft_seconds{role=decode}) > 0.5 for 2
    serve_disagg_queue_depth{role=prefill} > 64 for 2
    delta(control_plane_reconnects_total) > 2
    node_heartbeat_age_seconds > 3 for 1

Grammar::

    expr   := source OP number ['for' N ['periods']]
    source := FN '(' name [tags] ')'  |  name [tags]
    tags   := '{' key=value (',' key=value)* '}'
    FN     := p50 | p90 | p95 | p99   -- digest quantile (util/slo.py)
            | value                   -- metric sample sum (the default)
            | delta                   -- increase since the previous
                                         evaluation pass ("rising")
    OP     := > | >= | < | <=

Tags FILTER the matched samples; ``Rule(group_by=("node_id",))`` expands
the rule into one independent alert per distinct value of those tags
(e.g. one heartbeat alert per node, one p95 alert per replica). A firing
group whose samples disappear (node purged on mark_node_dead, replica
gone) resolves with reason ``no_data``.

Sustain: the comparison must hold for `for N` CONSECUTIVE evaluation
passes (config health_eval_period_s apart) before the alert fires; one
clear pass resolves it. ``Rule(demand={"CPU": 1})`` additionally
advertises resources while the alert is firing (`pending_demand`).

`payload()`'s `utilization` and `goodput` sections come from
util/profiler's gauges and goodput ledger, and `get_health_plane` installs
its alert-triggered stack dump (`profiler.install_auto_dump`), as in the
reference. The dashboard's /api/v0/health routes and the autoscaler's
`health_plane=` input wait for ROADMAP A5c.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..util import slo
from .logging import get_logger
from .metrics import Gauge

__all__ = ["HealthPlane", "ReplicaHealth", "Rule", "default_rules",
           "get_health_plane", "parse_rule", "shutdown_health_plane"]

logger = get_logger("health")

_m_alerts = Gauge("health_alerts_firing",
                  "Health-plane alerts currently firing, by severity.")
_m_quantile = Gauge(
    "slo_quantile_seconds",
    "Digest quantiles refreshed by the health plane, tagged "
    "{metric, q, role} (Grafana's window into util/slo.py sketches).")

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

_RULE_RE = re.compile(
    r"^\s*(?:(?P<fn>p50|p90|p95|p99|value|delta)\s*\(\s*)?"
    r"(?P<name>[A-Za-z_][\w.]*)"
    r"(?:\{(?P<tags>[^}]*)\})?"
    r"(?(fn)\s*\))\s*"
    r"(?P<op>>=|<=|>|<)\s*"
    r"(?P<thr>-?\d+(?:\.\d+)?(?:e-?\d+)?)"
    r"(?:\s+for\s+(?P<n>\d+)(?:\s+periods?)?)?\s*$"
)


def parse_rule(expr: str) -> Dict[str, Any]:
    """Parse the rule grammar above into its components (see module
    docstring). Raises ValueError on a malformed expression."""
    m = _RULE_RE.match(expr)
    if m is None:
        raise ValueError(f"unparseable health rule: {expr!r}")
    tags: Dict[str, str] = {}
    if m.group("tags"):
        for part in m.group("tags").split(","):
            if not part.strip():
                continue
            k, _, v = part.partition("=")
            tags[k.strip()] = v.strip()
    return {
        "fn": m.group("fn") or "value",
        "name": m.group("name"),
        "tags": tags,
        "op": m.group("op"),
        "threshold": float(m.group("thr")),
        "for_periods": int(m.group("n") or 1),
    }


@dataclass
class Rule:
    """One declarative alert rule (grammar in the module docstring)."""

    name: str
    expr: str
    severity: str = "warning"
    group_by: Tuple[str, ...] = ()
    demand: Optional[Dict[str, float]] = None  # autoscaler input while firing
    _p: Dict[str, Any] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._p = parse_rule(self.expr)
        self.group_by = tuple(self.group_by)


def default_rules() -> List[Rule]:
    """The stock rule set: armed from config at plane creation."""
    from .config import config

    rules = [
        Rule("queue_depth",
             f"serve_disagg_queue_depth > {int(config.get('health_queue_depth_max'))} for 2",
             group_by=("role",),
             # sustained backlog asks the autoscaler for another serving
             # node before the scheduler's pending queue ever backs up;
             # serve/fleet.py reads the same firing alert for replica
             # targets, so both actuation paths see one signal
             demand={"CPU": 1.0}),
        Rule("memory_pressure",
             f"host_memory_used_fraction > {float(config.get('health_memory_fraction_max'))} for 2",
             severity="critical", group_by=("node_id",)),
        Rule("heartbeat_gap",
             f"node_heartbeat_age_seconds > "
             f"{3.0 * float(config.get('health_check_period_ms')) / 1000.0}",
             severity="critical", group_by=("node_id",)),
        Rule("reconnect_spike",
             "delta(control_plane_reconnects_total) > 2", group_by=("role",)),
        Rule("data_stall_rising",
             "delta(data_stage_stall_seconds) > 1.0 for 2",
             # tenant-scoped: one tenant's input stall names that tenant
             # (stage + tenant labels on the firing alert) and advertises
             # CPU demand, so the ingest pool controller / autoscaler see
             # per-tenant pressure instead of a fleet-wide alarm
             group_by=("stage", "tenant"),
             demand={"CPU": 1.0}),
    ]
    stall_pct = float(config.get("rl_sync_stall_max_pct"))
    if stall_pct > 0:
        # the <5% sync-stall claim as an alert: rl/online.py publishes
        # the measured weight_sync share of each loop iteration
        rules.append(Rule(
            "rl_sync_stall",
            f"rl_sync_stall_fraction > {stall_pct / 100.0} for 2"))
    slo_ttft_ms = float(config.get("slo_ttft_ms"))
    if slo_ttft_ms > 0:
        rules.insert(0, Rule(
            "ttft_slo",
            f"p95(serve_ttft_seconds) > {slo_ttft_ms / 1000.0} for 2",
            severity="critical", group_by=("role",)))
        rules.insert(1, Rule(
            "replica_latency_slo",
            f"p95(serve_replica_latency_seconds) > {3 * slo_ttft_ms / 1000.0} for 2",
            group_by=("role", "replica")))
    return rules


def _match(sample_tags: Dict[str, str], want: Dict[str, str]) -> bool:
    return all(sample_tags.get(k) == v for k, v in want.items())


class HealthPlane:
    """Head-side rule engine (see module docstring for the data flow).

    Sources are injectable for tests: `metrics_fn` yields
    (name, tags_dict, value) samples, `digests_fn` yields digest
    snapshots in slo wire form. The defaults federate the local metrics
    registry + control-plane telemetry snapshots + heartbeat ages."""

    def __init__(self, rules: Optional[List[Rule]] = None,
                 control_plane: Any = None,
                 period_s: Optional[float] = None,
                 metrics_fn: Optional[Callable[[], List[Tuple]]] = None,
                 digests_fn: Optional[Callable[[], List[Dict]]] = None):
        from .config import config

        self.rules: List[Rule] = (list(rules) if rules is not None
                                  else default_rules())
        self._control_plane = control_plane
        self.period_s = (float(period_s) if period_s is not None
                         else float(config.get("health_eval_period_s")))
        self._metrics_fn = metrics_fn or self._federated_metrics
        self._digests_fn = digests_fn or self._federated_digests
        self._lock = threading.Lock()
        self._states: Dict[Tuple, Dict[str, Any]] = {}
        self._prev: Dict[Tuple, float] = {}       # for delta()
        self._active: Dict[Tuple, Dict[str, Any]] = {}
        self._history: deque = deque(maxlen=200)
        self._subs: List[Callable[[Dict[str, Any]], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_digests: Dict = {}

    # ---------------------------------------------------------- sources

    def _cp(self):
        if self._control_plane is not None:
            return self._control_plane
        from . import core_worker

        rt = core_worker._global_runtime
        return rt.control_plane if rt is not None else None

    def _federated_metrics(self) -> List[Tuple[str, Dict[str, str], float]]:
        from .metrics import registry

        out: List[Tuple[str, Dict[str, str], float]] = []

        def flatten(snapshot, extra: Dict[str, str]):
            for fam in snapshot:
                for sname, tag_list, value in fam.get("samples", []):
                    tags = dict(tag_list)
                    tags.update(extra)
                    out.append((sname, tags, float(value)))

        flatten(registry.snapshot(), {})
        cp = self._cp()
        if cp is not None:
            now_mono = time.monotonic()
            try:
                snaps = cp.telemetry_snapshots()
            except Exception:
                snaps = {}
            for node_hex, rec in snaps.items():
                flatten(rec.get("metrics", []),
                        {"node_id": node_hex[:12],
                         "role": rec.get("role", "worker")})
            # heartbeat ages only for nodes that federate telemetry (i.e.
            # real worker runtimes): the head's own node row never
            # heartbeats itself and must not trip heartbeat_gap
            try:
                for n in cp.all_nodes():
                    nid = (n.node_id.hex() if hasattr(n.node_id, "hex")
                           else str(n.node_id))
                    if nid in snaps and getattr(n.state, "name", "") == "ALIVE":
                        out.append(("node_heartbeat_age_seconds",
                                    {"node_id": nid[:12]},
                                    max(0.0, now_mono - n.last_heartbeat)))
            except Exception:
                pass
        return out

    def _federated_digests(self) -> List[Dict[str, Any]]:
        snaps = list(slo.snapshot())
        cp = self._cp()
        if cp is not None:
            try:
                for rec in cp.telemetry_snapshots().values():
                    snaps.extend(rec.get("digests") or [])
            except Exception:
                pass
        return snaps

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="health-plane")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.evaluate()
            except Exception:
                logger.exception("health evaluation failed")

    # -------------------------------------------------------- evaluation

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One rule-evaluation pass. Returns the active alert list."""
        if now is None:
            now = time.time()
        samples = list(self._metrics_fn())
        merged = slo.merge_snapshots(self._digests_fn())
        with self._lock:
            self._last_digests = merged
            for rule in self.rules:
                self._eval_rule(rule, samples, merged, now)
            # inject()ed alerts live outside the rule engine: they expire
            # unless the injector keeps re-asserting them (the memory
            # monitor re-injects on every over-threshold sample)
            for skey, a in list(self._active.items()):
                if a.get("injected") and now - a["at"] > 3 * self.period_s:
                    self._resolve(skey, a.get("value"), now, reason="expired")
            self._set_gauges()
            return list(self._active.values())

    def _eval_rule(self, rule: Rule, samples, merged, now: float) -> None:
        p = rule._p
        groups: Dict[Tuple, float] = {}
        counts: Dict[Tuple, int] = {}
        if p["fn"] in ("p50", "p90", "p95", "p99"):
            q = int(p["fn"][1:]) / 100.0
            for (name, tag_t), m in merged.items():
                tags = dict(tag_t)
                if name != p["name"] or not _match(tags, p["tags"]):
                    continue
                gkey = tuple((k, tags.get(k, "")) for k in rule.group_by)
                # group quantiles merge bucket-wise, not by averaging
                acc = groups.get(gkey)
                if acc is None:
                    groups[gkey] = list(m["counts"])
                else:
                    for i, c in enumerate(m["counts"]):
                        acc[i] += c
            groups = {g: v for g, v in (
                (g, slo.quantile_from_counts(c, q)) for g, c in groups.items())
                if v is not None}
        else:
            for name, tags, value in samples:
                if name != p["name"] or not _match(tags, p["tags"]):
                    continue
                gkey = tuple((k, tags.get(k, "")) for k in rule.group_by)
                groups[gkey] = groups.get(gkey, 0.0) + value
                counts[gkey] = counts.get(gkey, 0) + 1
            if p["fn"] == "delta":
                deltas = {}
                for gkey, value in groups.items():
                    pkey = (rule.name, gkey)
                    prev = self._prev.get(pkey)
                    self._prev[pkey] = value
                    if prev is not None:
                        deltas[gkey] = value - prev
                groups = deltas

        cmp = _OPS[p["op"]]
        seen = set()
        for gkey, value in groups.items():
            seen.add(gkey)
            skey = (rule.name, gkey)
            st = self._states.setdefault(skey, {"consec": 0})
            if cmp(value, p["threshold"]):
                st["consec"] += 1
                if st["consec"] >= p["for_periods"] and skey not in self._active:
                    self._fire(rule, gkey, value, now)
                elif skey in self._active:
                    self._active[skey]["value"] = value
                    self._active[skey]["at"] = now
            else:
                st["consec"] = 0
                if skey in self._active:
                    self._resolve(skey, value, now, reason="cleared")
        # groups that vanished (node purged, replica gone) resolve firing
        # alerts instead of freezing them. Only groups THIS rule could
        # have created (label keys == group_by) are swept: an inject()ed
        # alert sharing the rule name carries foreign labels and must
        # outlive the pass.
        for skey in [k for k in list(self._active) if k[0] == rule.name
                     and k[1] not in seen
                     and tuple(kk for kk, _ in k[1]) == rule.group_by]:
            self._states.get(skey, {}).update(consec=0)
            self._resolve(skey, None, now, reason="no_data")

    # ------------------------------------------------------- transitions

    def _fire(self, rule: Rule, gkey: Tuple, value: float, now: float) -> None:
        alert = {
            "rule": rule.name,
            "expr": rule.expr,
            "state": "firing",
            "severity": rule.severity,
            "labels": dict(gkey),
            "value": value,
            "threshold": rule._p["threshold"],
            "since": now,
            "at": now,
            "demand": rule.demand,
        }
        self._active[(rule.name, gkey)] = alert
        self._announce(alert)

    def _resolve(self, skey: Tuple, value, now: float, reason: str) -> None:
        alert = self._active.pop(skey, None)
        if alert is None:
            return
        alert = dict(alert, state="resolved", value=value, at=now,
                     resolve_reason=reason)
        self._announce(alert)

    def inject(self, rule_name: str, labels: Optional[Dict[str, str]] = None,
               value: float = 0.0, severity: str = "critical",
               expr: str = "injected") -> Dict[str, Any]:
        """Force-fire an alert from outside the rule engine (e.g. the
        memory monitor raising memory_pressure just before it kills a
        worker — visible before the kill, not only after)."""
        gkey = tuple(sorted((labels or {}).items()))
        with self._lock:
            skey = (rule_name, gkey)
            if skey in self._active:
                self._active[skey].update(value=value, at=time.time())
                return self._active[skey]
            rule = Rule(rule_name, "value > 0", severity=severity)
            rule.expr = expr
            self._fire(rule, gkey, value, time.time())
            self._active[skey]["injected"] = True
            self._set_gauges()
            return self._active[skey]

    def _announce(self, alert: Dict[str, Any]) -> None:
        self._history.append(dict(alert))
        state, rule = alert["state"], alert["rule"]
        logger.log(30 if state == "firing" else 20,
                   "alert %s: %s %s value=%s labels=%s",
                   state, rule, alert["expr"], alert["value"],
                   alert["labels"])
        try:
            from ..util import timeline
            timeline.record(f"alert:{rule}", ph="i", cat="alert",
                            args={k: alert[k] for k in
                                  ("state", "severity", "labels", "value")})
        except Exception:
            pass
        cp = self._cp()
        if cp is not None:
            try:
                cp.pubsub.publish("alerts", dict(alert))
            except Exception:
                pass
        for fn in list(self._subs):
            try:
                fn(dict(alert))
            except Exception:
                pass

    def subscribe(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """Local (in-process) alert subscription — routers use this to
        quarantine replicas named in firing alerts."""
        self._subs.append(fn)

    def _set_gauges(self) -> None:
        by_sev: Dict[str, int] = {}
        for a in self._active.values():
            by_sev[a["severity"]] = by_sev.get(a["severity"], 0) + 1
        for sev in ("warning", "critical"):
            _m_alerts.set(float(by_sev.get(sev, 0)), tags={"severity": sev})
        for (name, tag_t), m in self._last_digests.items():
            tags = dict(tag_t)
            if "replica" in tags:
                continue  # per-replica series would blow up the gauge set
            role = tags.get("role", "")
            for q in (0.5, 0.95):
                v = slo.quantile_from_counts(m["counts"], q)
                if v is not None:
                    _m_quantile.set(v, tags={"metric": name,
                                             "q": f"p{int(q * 100)}",
                                             "role": role})

    # ----------------------------------------------------------- queries

    def active(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(a) for a in self._active.values()]

    def history(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(a) for a in self._history]

    def pending_demand(self) -> List[Dict[str, float]]:
        """Resource bundles advertised while demand-carrying rules fire
        (the reference's `Autoscaler(health_plane=...)` reads them)."""
        with self._lock:
            return [dict(a["demand"]) for a in self._active.values()
                    if a.get("demand")]

    def scores(self) -> Dict[str, float]:
        """Coarse health scores in [0,1]: 1 = healthy. Nodes lose score
        with heartbeat age and firing alerts; replica/role series lose
        score when a matching alert fires."""
        out: Dict[str, float] = {}
        with self._lock:
            digests = dict(self._last_digests)
            active = [dict(a) for a in self._active.values()]
        for (name, tag_t) in digests:
            tags = dict(tag_t)
            rep = tags.get("replica")
            if rep:
                out.setdefault(f"replica:{rep}", 1.0)
        cp = self._cp()
        if cp is not None:
            try:
                for node_hex in cp.telemetry_snapshots():
                    out.setdefault(f"node:{node_hex[:12]}", 1.0)
            except Exception:
                pass
        for a in active:
            labels = a.get("labels", {})
            penalty = 0.0 if a["severity"] == "critical" else 0.5
            for key in (f"replica:{labels.get('replica')}",
                        f"node:{labels.get('node_id')}"):
                if key in out:
                    out[key] = min(out[key], penalty)
        return out

    def payload(self) -> Dict[str, Any]:
        """The health payload (what ray_tpu_torch.status() renders; the
        reference's /api/v0/health body)."""
        with self._lock:
            digests = {}
            for (name, tag_t), m in self._last_digests.items():
                label = name + "".join(
                    f",{k}={v}" for k, v in tag_t)
                digests[label] = {
                    "p50": slo.quantile_from_counts(m["counts"], 0.5),
                    "p95": slo.quantile_from_counts(m["counts"], 0.95),
                    "count": m["count"],
                    "max": m["max"],
                }
        nodes = []
        cp = self._cp()
        if cp is not None:
            try:
                now_mono = time.monotonic()
                snaps = cp.telemetry_snapshots()
                for n in cp.all_nodes():
                    nid = n.node_id.hex() if hasattr(n.node_id, "hex") else str(n.node_id)
                    nodes.append({
                        "node_id": nid[:12],
                        "state": getattr(n.state, "name", str(n.state)),
                        "heartbeat_age_s": round(now_mono - n.last_heartbeat, 3),
                        "role": (snaps.get(nid) or {}).get("role", ""),
                    })
            except Exception:
                pass
        utilization, goodput = self._profiling_sections(cp)
        objects: Dict[str, Any] = {}
        channels: Dict[str, Any] = {}
        try:
            from . import core_worker, object_ledger

            rt = getattr(core_worker, "_global_runtime", None)
            objects = object_ledger.objects_section(rt)
            channels = object_ledger.channels_section(rt)
        except Exception:  # noqa: BLE001 — payload must render regardless
            pass
        return {
            "generated_at": time.time(),
            "nodes": nodes,
            "alerts": self.active(),
            "digests": digests,
            "scores": self.scores(),
            "utilization": utilization,
            "goodput": goodput,
            "objects": objects,
            "channels": channels,
        }

    _UTIL_GAUGES = {"host_cpu_used_fraction": "cpu_fraction",
                    "process_rss_bytes": "rss_bytes",
                    "host_memory_used_fraction": "memory_fraction"}

    def _profiling_sections(self, cp) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Per-node CPU/RSS/memory gauges + the goodput ledger, both from
        the same federated family snapshots the rule engine reads
        (util/profiler sets the gauges; telemetry flushes federate them)."""
        utilization: Dict[str, Dict[str, float]] = {}
        goodput: Dict[str, Any] = {}
        try:
            from ..util import profiler
            from .metrics import registry

            try:
                # worker runtimes refresh on telemetry flushes; the head
                # has no flush loop, so its own row refreshes here
                profiler.update_resource_gauges()
            except Exception:
                pass
            sources: List[Tuple[str, List]] = [("head", registry.snapshot())]
            if cp is not None:
                try:
                    for node_hex, rec in cp.telemetry_snapshots().items():
                        sources.append((node_hex[:12],
                                        rec.get("metrics") or []))
                except Exception:
                    pass
            for key, fams in sources:
                row: Dict[str, float] = {}
                for fam in fams:
                    out_key = self._UTIL_GAUGES.get(fam.get("name", ""))
                    if not out_key:
                        continue
                    vals = [float(v) for _s, _t, v in fam.get("samples", [])]
                    if vals:
                        # fractions are host-wide (any sample is the
                        # host's value); byte gauges sum across processes
                        row[out_key] = (max(vals) if "fraction" in out_key
                                        else sum(vals))
                if row:
                    utilization[key] = row
            goodput = profiler.ledger_from_samples(
                [f for _k, fams in sources for f in fams])
        except Exception:  # noqa: BLE001 — payload must render regardless
            pass
        return utilization, goodput


# -- client-side routing health --------------------------------------------

class ReplicaHealth:
    """Per-replica health scorer for routers (Pow2Router, the disagg
    coordinator): tracks observed latency/outcomes per replica key,
    down-weights degraded replicas, and quarantines broken ones BEFORE
    the control plane's heartbeat timeout marks the node DEAD.

    Lifecycle: errors collapse the score multiplicatively (one transport
    crash quarantines outright); after `quarantine_s` the replica gets
    ONE probe request — success restores it, failure re-quarantines with
    doubled backoff. `eligible()` fails open when every replica is
    quarantined (degraded service beats no service)."""

    def __init__(self, quarantine_s: Optional[float] = None,
                 now_fn: Callable[[], float] = time.monotonic):
        if quarantine_s is None:
            from .config import config

            quarantine_s = float(config.get("health_quarantine_s"))
        self.quarantine_s = quarantine_s
        self._now = now_fn
        self._lock = threading.Lock()
        self._s: Dict[Any, Dict[str, Any]] = {}

    def _st(self, key) -> Dict[str, Any]:
        st = self._s.get(key)
        if st is None:
            st = self._s[key] = {"score": 1.0, "quar_until": 0.0,
                                 "backoff": self.quarantine_s,
                                 "probing": False, "errors": 0, "ok": 0,
                                 "reason": ""}
        return st

    def observe(self, key, latency_s: Optional[float] = None,
                ok: bool = True, role: str = "") -> None:
        if not ok:
            return self.record_error(key)
        with self._lock:
            st = self._st(key)
            st["ok"] += 1
            st["score"] = min(1.0, st["score"] * 0.7 + 0.3)
            if st["probing"] or st["quar_until"]:
                st["probing"] = False
                st["quar_until"] = 0.0
                st["backoff"] = self.quarantine_s
                st["reason"] = ""
        if latency_s is not None:
            tags = {"replica": str(key)}
            if role:
                tags["role"] = role
            slo.observe("serve_replica_latency_seconds", latency_s, tags=tags)

    def record_error(self, key, reason: str = "error") -> None:
        with self._lock:
            st = self._st(key)
            st["errors"] += 1
            st["score"] *= 0.25
            if st["probing"]:
                st["backoff"] = min(60.0, st["backoff"] * 2)
                st["probing"] = False
            if st["score"] < 0.3:
                st["quar_until"] = self._now() + st["backoff"]
                st["reason"] = reason

    def quarantine(self, key, reason: str = "external",
                   duration: Optional[float] = None) -> None:
        """Direct quarantine (alert subscriptions, heartbeat signals)."""
        with self._lock:
            st = self._st(key)
            st["score"] = 0.0
            st["quar_until"] = self._now() + (duration if duration is not None
                                              else st["backoff"])
            st["reason"] = reason

    def score(self, key) -> float:
        with self._lock:
            st = self._s.get(key)
            if st is None:
                return 1.0
            if st["quar_until"] and self._now() < st["quar_until"]:
                return 0.0
            return st["score"]

    def quarantined(self, key) -> bool:
        with self._lock:
            st = self._s.get(key)
            return bool(st and st["quar_until"]
                        and self._now() < st["quar_until"])

    def eligible(self, keys: List[Any]) -> List[Any]:
        """Routing candidates: quarantined replicas are excluded until
        their probe window opens (then exactly one probe passes). Fails
        open to the full list when nothing is eligible."""
        now = self._now()
        out = []
        with self._lock:
            for k in keys:
                st = self._s.get(k)
                if st is None or not st["quar_until"]:
                    out.append(k)
                    continue
                if now >= st["quar_until"] and not st["probing"]:
                    st["probing"] = True
                    st["quar_until"] = now + st["backoff"]  # next window
                    out.append(k)
        return out if out else list(keys)

    def penalty(self, key) -> int:
        """Load-units penalty for pow2 comparisons: a degraded replica
        competes as if it already had a queue."""
        s = self.score(key)
        return 0 if s >= 0.99 else int((1.0 - s) * 8)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {str(k): {"score": st["score"],
                             "quarantined": bool(
                                 st["quar_until"]
                                 and self._now() < st["quar_until"]),
                             "errors": st["errors"], "ok": st["ok"],
                             "reason": st["reason"]}
                    for k, st in self._s.items()}


# -- module singleton -------------------------------------------------------

_plane: Optional[HealthPlane] = None
_plane_lock = threading.Lock()


def get_health_plane(create: bool = True) -> Optional[HealthPlane]:
    """The process-wide plane, created lazily (by status() or a caller
    that asks) and started on creation."""
    global _plane
    if _plane is None and create:
        with _plane_lock:
            if _plane is None:
                _plane = HealthPlane()
                _plane.start()
                try:
                    # loop closure (profiling plane): sustained stall /
                    # heartbeat-gap alerts auto-capture a stack dump into
                    # the flight recorder + postmortem stream
                    from ..util import profiler
                    profiler.install_auto_dump(_plane)
                except Exception:  # noqa: BLE001 — optional plane
                    pass
    return _plane


def shutdown_health_plane() -> None:
    global _plane
    with _plane_lock:
        p, _plane = _plane, None
    if p is not None:
        p.stop()
