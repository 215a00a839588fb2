"""Fleet actuation plane: the controller that ACTS on what the process
senses — the serving side's sense→act loop.

The port's copy of ray_tpu/serve/fleet.py. `FleetController` closes the
loop between the health plane (core/health.py) and the disaggregated
coordinator (serve/disagg.py):

- **Autoscale policy** — every eval_period_s it folds the health plane's
  firing alerts (queue_depth carries a demand hint, ttft_slo is armed by
  the slo_ttft_ms knob), the live serve_disagg_queue_depth gauge, and
  per-role load into target replica counts PER ROLE — so the
  prefill/decode ratio tracks the workload shape, not just its volume.
  Actuation is hysteretic: scale-ups respect the global
  autoscale_cooldown_s / autoscale_step_max knobs (core/config.py),
  scale-downs require idle_periods consecutive quiet evaluations — one
  alert burst cannot flap the fleet.
- **Actuation backends** — a serve-mode fleet scales through
  `ServeController.set_target` (the coordinator's `_sync` picks up the
  membership change); an in-process fleet scales through injected
  `spawn_fn`/`retire_fn` callbacks plus the coordinator's
  add_worker/remove_worker graceful pick-set surgery.
- **Live request resume** rides in the coordinator (disagg.open_stream):
  a decode replica dying mid-stream re-runs the request's remaining
  tokens on a healthy peer.
- **LoRA hot-swap** — `distribute_adapter` seals adapter weights into
  the object plane, pre-seeds every host over `api.broadcast`, then pins
  them resident per replica; the coordinator's gossiped residency routing
  sends each request to a replica that already holds its adapter.
- **Auto-remediation** — a firing alert naming a replica drives
  quarantine → drain → restart → rejoin, each stage counted in
  serve_fleet_remediations{stage}.

Five differences from the reference. A role's pressure is its backlog,
not the queue depth (DisaggCoordinator.backlog; the port's queue depth
counts a request until its prefill leg returns, C11): the prefill legs the
role's ready replicas run, or will have run before another replica could
be built, are not in it, so the legs of a burst or of resumed streams do
not build a replica, and requests waiting in a pick count only while no
replica of the role is building for them (C15). A role's idle periods count only
while it holds its target of ready replicas (`_settled`; a serve-mode
fleet syncs the coordinator's membership at each evaluation), so a
replica the fleet asked for is never stepped down before it has served.
A serve-mode step-down syncs the coordinator's membership as soon as the
serve controller has retired the replica, so no pick waits for the next
sync to stop landing on it (ROADMAP C13). The other two are in a
serve-mode remediation's restart, which always goes through the serve
controller (ServeController.retire_replica): the replica leaves the
deployment's replica list at once, so no resume picks it again,
LLMServer.shutdown stops its engine and fails the requests still live,
which the coordinator resumes on a peer, the actor is killed after, and
the replacement starts in the same reconcile pass. The deployment's name
comes from `deployments=` or from the coordinator (from_deployments);
where neither names it, the remediation stops at its drain and says so.
And the replacement is counted as `rejoin` at the first evaluation that
finds the role's pick set whole again with a replica it did not hold
before; the reference counts three stages in serve mode.

Metrics: serve_fleet_target_replicas{role} vs serve_fleet_demand{role}
(the convergence evidence), serve_fleet_resumes /
serve_fleet_resume_seconds (in disagg.py), serve_fleet_adapter_residency
{adapter}, serve_fleet_remediations{stage}.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import api
from ..core.config import config
from ..core.health import get_health_plane
from ..core.logging import get_logger
from ..core.metrics import Counter, Gauge
from .disagg import _ready

logger = get_logger("serve.fleet")

ROLES = ("prefill", "decode")

_m_target = Gauge(
    "serve_fleet_target_replicas",
    "fleet policy's target replica count, by role",
)
_m_demand = Gauge(
    "serve_fleet_demand",
    "observed demand signal (queue depth + firing alerts), by role",
)
_m_residency = Gauge(
    "serve_fleet_adapter_residency",
    "replicas holding a LoRA adapter resident, by adapter",
)
_m_remediations = Counter(
    "serve_fleet_remediations",
    "auto-remediation actions, by stage (quarantine/drain/restart/rejoin)",
)

# alerts whose firing means "this role needs capacity"
_SCALE_RULES = ("queue_depth", "ttft_slo")


@dataclasses.dataclass
class FleetConfig:
    """Fleet policy knobs (per role unless noted)."""

    min_replicas: int = 1
    max_replicas: int = 4
    eval_period_s: float = 2.0
    # a role is pressured when its queue depth exceeds this many waiting
    # requests per live replica (firing queue_depth/ttft_slo alerts
    # pressure it regardless)
    target_queue_depth: float = 2.0
    # consecutive quiet evaluations before a one-step scale-down — the
    # acceptance bar: no oscillation across 3 consecutive periods
    idle_periods: int = 3
    # hysteresis overrides; None = the global autoscale_cooldown_s /
    # autoscale_step_max knobs (core/config.py)
    cooldown_s: Optional[float] = None
    step_max: Optional[int] = None
    # shift one replica of capacity between roles when one role is
    # pinned at max_replicas under pressure while the other sits idle
    # above min_replicas — the prefill/decode ratio follows the load mix
    rebalance_roles: bool = True

    def __post_init__(self) -> None:
        if not 0 <= int(self.min_replicas) <= int(self.max_replicas):
            raise ValueError(
                "need 0 <= min_replicas <= max_replicas, got "
                f"min={self.min_replicas} max={self.max_replicas}")
        if float(self.eval_period_s) <= 0:
            raise ValueError(
                f"eval_period_s must be > 0, got {self.eval_period_s}")
        if float(self.target_queue_depth) <= 0:
            raise ValueError(
                f"target_queue_depth must be > 0, "
                f"got {self.target_queue_depth}")
        if int(self.idle_periods) < 1:
            raise ValueError(
                f"idle_periods must be >= 1, got {self.idle_periods}")

    @classmethod
    def parse(cls, value) -> "FleetConfig":
        """Normalize a YAML/JSON dict (or an existing instance),
        rejecting unknown keys with a clear error instead of silently
        ignoring a typo'd knob."""
        if isinstance(value, cls):
            return value
        if not isinstance(value, dict):
            raise ValueError(
                f"fleet must be a mapping, got {type(value).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(value) - known
        if unknown:
            raise ValueError(
                f"unknown fleet option(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        return cls(**value)


class FleetController:
    """Sense→act policy engine over one DisaggCoordinator.

    Construction picks the actuation backend:
      - `deployments={"prefill": name, "decode": name}` (+ an optional
        `controller` handle) scales through ServeController.set_target;
      - `spawn_fn(role) -> worker` / `retire_fn(role, worker)` scale an
        in-process worker fleet through the coordinator's pick set.
    With neither, evaluate_once still computes targets and gauges (dry
    run) — useful for shadowing a policy before giving it hands.
    """

    def __init__(self, coordinator, config: Any = None, *,
                 controller: Any = None,
                 deployments: Optional[Dict[str, str]] = None,
                 spawn_fn: Optional[Callable[[str], Any]] = None,
                 retire_fn: Optional[Callable[[str, Any], None]] = None,
                 plane: Any = None):
        self.cfg = FleetConfig.parse(config or {})
        self.co = coordinator
        self._controller = controller
        self._deployments = dict(deployments) if deployments else None
        self._spawn = spawn_fn
        self._retire = retire_fn
        self._plane = plane if plane is not None \
            else get_health_plane(create=False)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._targets: Dict[str, int] = {
            r: max(len(coordinator.workers(r)), self.cfg.min_replicas)
            for r in ROLES
        }
        self._last_scale_up = {r: float("-inf") for r in ROLES}
        self._idle = {r: 0 for r in ROLES}
        self._pressured = {r: False for r in ROLES}
        self._remediating: set = set()
        # serve-mode restarts whose replacement has not joined yet: role ->
        # [(pick-set size before the drain, keys then), ...]
        self._rejoins: Dict[str, List[Tuple[int, set]]] = {r: [] for r in ROLES}
        # audit trail of actuations (scale / rebalance / remediate):
        # the convergence evidence
        self.actions: List[Dict[str, Any]] = []
        if self._plane is not None:
            self._plane.subscribe(self._on_alert)

    # ------------------------------------------------------------ knobs

    def _cooldown_s(self) -> float:
        if self.cfg.cooldown_s is not None:
            return float(self.cfg.cooldown_s)
        return float(config.get("autoscale_cooldown_s"))

    def _step_max(self) -> int:
        if self.cfg.step_max is not None:
            return max(1, int(self.cfg.step_max))
        return max(1, int(config.get("autoscale_step_max")))

    # ----------------------------------------------------------- sense

    def _pressure(self, role: str, alerts: List[Dict[str, Any]],
                  workers: List[Any]) -> Tuple[bool, float]:
        """-> (pressured, demand_value) for one role: firing scale rules
        naming the role, or a backlog past target_queue_depth per live
        replica. The backlog is DisaggCoordinator.backlog: the requests
        still picking, unless a replica of the role is building (one not
        ready, or a remediation's replacement not yet joined), since those
        wait for it; and the legs in service that the ready replicas will
        not have run before another replica could be built. The reference
        reads the queue depth, which there counts only the requests still
        picking (C11, C15)."""
        live = len(workers)
        building = bool(self._rejoins.get(role)) or not all(_ready(w) for w in workers)
        queue = self.co.backlog(role, building=building)
        alert_hot = any(
            a.get("state") == "firing"
            and a.get("rule") in _SCALE_RULES
            and (a.get("labels") or {}).get("role", role) == role
            for a in alerts)
        demand = queue
        if alert_hot:
            demand = max(demand, self.cfg.target_queue_depth * max(live, 1)
                         + 1.0)
        pressured = alert_hot or (
            queue > self.cfg.target_queue_depth * max(live, 1))
        return pressured, demand

    # ------------------------------------------------------------- act

    def evaluate_once(self, now: Optional[float] = None) -> Dict[str, int]:
        """One sense→act pass. Returns the per-role targets after it."""
        if now is None:
            now = time.monotonic()
        alerts = self._plane.active() if self._plane is not None else []
        cooldown = self._cooldown_s()
        step_max = self._step_max()
        with self._lock:
            if self._deployments is not None:
                self.co._sync()  # the serve controller's membership (1 s apart)
            for role in ROLES:
                workers = self.co.workers(role)
                live = len(workers)
                target = self._targets.get(role, live)
                pressured, demand = self._pressure(role, alerts, workers)
                self._pressured[role] = pressured
                _m_demand.set(demand, tags={"role": role})
                if pressured:
                    self._idle[role] = 0
                    if (target < self.cfg.max_replicas
                            and now - self._last_scale_up[role] >= cooldown):
                        # size the wave to the demand, bounded by
                        # step_max and the ceiling
                        want = int(demand
                                   // max(self.cfg.target_queue_depth, 1e-9))
                        step = max(1, min(step_max,
                                          want - target,
                                          self.cfg.max_replicas - target))
                        self._set_target(role, target + step, "scale-up",
                                         demand=demand)
                        self._last_scale_up[role] = now
                else:
                    inflight = 0
                    for w in workers:
                        try:
                            inflight += int(w.load())
                        except Exception:  # noqa: BLE001
                            pass
                    if (inflight == 0 and demand <= 0
                            and self._settled(workers, target)):
                        self._idle[role] += 1
                        if (self._idle[role] >= self.cfg.idle_periods
                                and target > self.cfg.min_replicas):
                            self._set_target(role, target - 1, "scale-down")
                            # re-arm: one step per idle window, so the
                            # ramp-down is as hysteretic as the ramp-up
                            self._idle[role] = 0
                    else:
                        self._idle[role] = 0
                _m_target.set(float(self._targets[role]),
                              tags={"role": role})
            if self.cfg.rebalance_roles:
                self._maybe_rebalance(now)
            self._reconcile_inprocess()
            self._count_rejoins()
            self._refresh_residency()
            return dict(self._targets)

    @staticmethod
    def _settled(workers: List[Any], target: int) -> bool:
        """Whether the role holds its target of ready replicas: no
        scale-up (or replacement) is still building. Idle periods count
        only then, so a role never steps down a replica it asked for
        before that replica has served; the reference's fleet counts them
        regardless, and a burst shorter than a build retires the new
        replica unbuilt."""
        return len(workers) >= target and all(_ready(w) for w in workers)

    def _maybe_rebalance(self, now: float) -> None:
        """Role-ratio actuation: a role pinned at max_replicas under
        pressure borrows one replica of capacity from the other role
        when that one has been idle a full window above min_replicas."""
        for hot, cold in (("decode", "prefill"), ("prefill", "decode")):
            if (self._pressured[hot]
                    and self._targets[hot] >= self.cfg.max_replicas
                    and not self._pressured[cold]
                    and self._idle[cold] >= self.cfg.idle_periods
                    and self._targets[cold] > self.cfg.min_replicas):
                self._set_target(cold, self._targets[cold] - 1,
                                 "rebalance", peer=hot)
                self._idle[cold] = 0
                return

    def _set_target(self, role: str, target: int, kind: str,
                    **detail: Any) -> None:
        # caller holds self._lock
        target = min(max(int(target), self.cfg.min_replicas),
                     self.cfg.max_replicas)
        prev = self._targets.get(role)
        if target == prev:
            return
        self._targets[role] = target
        self.actions.append({"kind": kind, "role": role, "from": prev,
                             "to": target, "at": time.time(), **detail})
        logger.info("fleet %s %s: %d -> %d %s",
                    kind, role, prev if prev is not None else -1, target,
                    detail or "")
        if self._deployments is not None and role in self._deployments:
            ctrl = self._controller
            if ctrl is None:
                from .controller import get_or_create_controller

                ctrl = self._controller = get_or_create_controller()
            try:
                fn = getattr(ctrl.set_target, "remote", None)
                if fn is not None:  # actor handle
                    api.get(fn(self._deployments[role], target),
                            timeout=30.0)
                else:  # in-process double
                    ctrl.set_target(self._deployments[role], target)
            except Exception:  # noqa: BLE001 — retried next period
                logger.warning("set_target(%s, %d) failed",
                               self._deployments[role], target,
                               exc_info=True)
                return
            if prev is not None and target < prev:
                # the controller has retired the replica: take it out of
                # the pick set now, not at the coordinator's next sync
                self.co._sync(force=True)

    def _reconcile_inprocess(self) -> None:
        """In-process actuation: converge the coordinator's pick sets to
        the targets through spawn_fn/retire_fn. Serve-mode fleets skip
        this — the serve controller owns replica lifecycles there."""
        if self._spawn is None:
            return
        for role in ROLES:
            target = self._targets[role]
            while len(self.co.workers(role)) < target:
                try:
                    self.co.add_worker(role, self._spawn(role))
                except Exception:  # noqa: BLE001 — retried next period
                    logger.warning("spawn_fn(%s) failed", role,
                                   exc_info=True)
                    break
            while len(self.co.workers(role)) > target:
                w = self.co.remove_worker(role)
                if w is None:
                    break
                if self._retire is not None:
                    try:
                        self._retire(role, w)
                    except Exception:  # noqa: BLE001 — best-effort
                        logger.warning("retire_fn(%s) failed", role,
                                       exc_info=True)

    # ----------------------------------------------------- remediation

    def _on_alert(self, alert: Dict[str, Any]) -> None:
        """A firing alert naming a replica drives the
        quarantine→drain→restart→rejoin pipeline."""
        if alert.get("state") != "firing":
            return
        rep = (alert.get("labels") or {}).get("replica")
        if not rep:
            return
        for role in ROLES:
            for w in self.co.workers(role):
                if str(w.key) == str(rep):
                    self.remediate(role, w.key,
                                   reason=alert.get("rule", "alert"))
                    return

    def remediate(self, role: str, key: Any, reason: str = "alert") -> bool:
        """quarantine → drain → restart → rejoin one replica, counting
        each stage in serve_fleet_remediations{stage}."""
        with self._lock:
            if key in self._remediating:
                return False
            self._remediating.add(key)
        try:
            self.co.health.quarantine(key, reason=reason)
            _m_remediations.inc(tags={"stage": "quarantine"})
            # drain: out of the pick set now; in-flight streams finish
            # under the coordinator's drain grace
            w = self.co.remove_worker(role, key)
            _m_remediations.inc(tags={"stage": "drain"})
            self.actions.append({"kind": "remediate", "role": role,
                                 "replica": str(key), "reason": reason,
                                 "at": time.time()})
            if self._spawn is not None:
                if w is not None and self._retire is not None:
                    try:
                        self._retire(role, w)
                    except Exception:  # noqa: BLE001 — it's being replaced
                        pass
                _m_remediations.inc(tags={"stage": "restart"})
                try:
                    self.co.add_worker(role, self._spawn(role))
                    _m_remediations.inc(tags={"stage": "rejoin"})
                except Exception:  # noqa: BLE001 — next eval retries
                    logger.warning("remediation respawn for %s failed",
                                   role, exc_info=True)
            elif w is not None and hasattr(w, "_replica"):
                # serve mode: the serve controller takes the replica out
                # of its deployment and stops it (its live streams fail
                # and resume on a peer), kills it and starts its
                # replacement; the coordinator's _sync picks the
                # replacement up, and evaluate_once counts its rejoin
                name = self._deployment(role)
                if name is None:
                    logger.warning(
                        "remediation of %s replica %s stops at its drain: "
                        "no deployment name to retire it through (pass "
                        "deployments= or use from_deployments)", role, key)
                    return True
                with self._lock:
                    self._rejoins[role].append(
                        (len(self.co.workers(role)) + 1,
                         {w.key} | {x.key for x in self.co.workers(role)}))
                self._restart_replica(name, w)
                _m_remediations.inc(tags={"stage": "restart"})
            logger.info("remediated %s replica %s (%s)", role, key, reason)
            return True
        finally:
            with self._lock:
                self._remediating.discard(key)

    def _deployment(self, role: str) -> Optional[str]:
        """The serve deployment that holds `role`'s replicas: from
        deployments=, else from the coordinator (from_deployments)."""
        names = self._deployments or getattr(self.co, "_deployments", None)
        return (names or {}).get(role)

    def _restart_replica(self, name: str, w: Any) -> None:
        """Serve mode: retire one replica of deployment `name` through the
        serve controller, which starts its replacement (ServeController.
        retire_replica: LLMServer.shutdown fails the streams it holds,
        then the actor is killed)."""
        ctrl = self._controller
        if ctrl is None:
            from .controller import get_or_create_controller

            ctrl = self._controller = get_or_create_controller()
        try:
            fn = getattr(ctrl.retire_replica, "remote", None)
            if fn is not None:  # actor handle
                api.get(fn(name, w._replica._actor_id, 0.0), timeout=60.0)
            else:  # in-process double
                ctrl.retire_replica(name, w._replica._actor_id, 0.0)
        except Exception:  # noqa: BLE001 — already dead
            logger.warning("restart of %s replica %s failed", name, w.key,
                           exc_info=True)

    # ------------------------------------------------------- LoRA swap

    def distribute_adapter(self, adapter_id: str, weights: Any = None,
                           ref: Any = None,
                           roles: Tuple[str, ...] = ("decode",),
                           timeout_s: float = 60.0) -> Dict[str, Any]:
        """Hot-swap distribution: seal the adapter into the object plane,
        pre-seed every host over the api.broadcast relay tree, then pin
        it resident on each replica of the given roles (residency
        bookkeeping: the engine applies no adapter, as in the reference).
        Per-replica failures are reported, never raised — a replica that
        missed the load pulls lazily via adapter_ref on its first routed
        request."""
        if ref is None:
            ref = api.put(weights)
        try:
            # relay-tree pre-seed: replicas then resolve the ref from
            # their own host's store instead of all pulling from the caller
            api.broadcast(ref, timeout=timeout_s)
        except Exception:  # noqa: BLE001 — pre-seeding is best-effort
            logger.debug("adapter broadcast pre-seed failed", exc_info=True)
        out: Dict[str, Any] = {"adapter_id": str(adapter_id), "ref": ref,
                               "loaded": [], "failed": []}
        for role in roles:
            for w in self.co.workers(role):
                try:
                    w.load_adapter({"adapter_id": str(adapter_id),
                                    "ref": ref, "timeout_s": timeout_s})
                    out["loaded"].append(str(w.key))
                except Exception as e:  # noqa: BLE001 — lazy pull later
                    out["failed"].append({"replica": str(w.key),
                                          "error": repr(e)})
        _m_residency.set(float(len(out["loaded"])),
                         tags={"adapter": str(adapter_id)})
        return out

    def sync_weights(self, weights: Any = None, ref: Any = None,
                     version: Optional[int] = None,
                     roles: Tuple[str, ...] = ROLES,
                     timeout_s: float = 60.0) -> Dict[str, Any]:
        """Live base-weight re-sync WITHOUT draining: seal the new tree
        into the object plane, pre-seed every host over the api.broadcast
        relay tree, then swap it in on each replica of the given roles
        (engine.update_params — in-flight requests keep the old weights,
        new dispatches serve the new generation). Per-replica failures
        are reported, never raised: a replica that missed the swap keeps
        serving the previous generation and its gossiped weights_version
        shows the skew. This is the online-RL trainer→fleet edge (on one
        host the object plane hands the tree over by reference, and each
        engine copies it into its live tensors)."""
        if ref is None:
            ref = api.put(weights)
        try:
            # relay-tree pre-seed: replicas then resolve the ref from
            # their own host's store instead of all pulling from the caller
            api.broadcast(ref, timeout=timeout_s)
        except Exception:  # noqa: BLE001 — pre-seeding is best-effort
            logger.debug("weights broadcast pre-seed failed", exc_info=True)
        out: Dict[str, Any] = {"ref": ref, "version": version,
                               "synced": [], "failed": []}
        for role in roles:
            for w in self.co.workers(role):
                try:
                    res = w.update_weights({"ref": ref, "version": version,
                                            "timeout_s": timeout_s})
                    out["synced"].append(
                        {"replica": str(w.key),
                         "weights_version": res.get("weights_version")})
                except Exception as e:  # noqa: BLE001 — skew is visible
                    out["failed"].append({"replica": str(w.key),
                                          "error": repr(e)})
        return out

    def _count_rejoins(self) -> None:
        """Serve mode: count `rejoin` once a restarted replica's
        replacement is in the role's pick set (caller holds self._lock)."""
        if not any(self._rejoins.values()):
            return
        try:
            self.co._sync(force=True)
        except Exception:  # noqa: BLE001 — retried next period
            return
        for role in ROLES:
            keys = {w.key for w in self.co.workers(role)}
            for entry in list(self._rejoins[role]):
                size, before = entry
                if len(keys) >= size and keys - before:
                    self._rejoins[role].remove(entry)
                    _m_remediations.inc(tags={"stage": "rejoin"})
                    self.actions.append({"kind": "rejoin", "role": role,
                                         "replica": str(sorted(
                                             keys - before, key=str)[0]),
                                         "at": time.time()})

    def _refresh_residency(self) -> None:
        counts: Dict[str, int] = {}
        try:
            for _key, adapters in self.co.adapter_residency().items():
                for a in adapters:
                    counts[a] = counts.get(a, 0) + 1
        except Exception:  # noqa: BLE001 — gossip is advisory
            return
        for adapter, n in counts.items():
            _m_residency.set(float(n), tags={"adapter": adapter})

    # ------------------------------------------------------------ loop

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="fleet-controller")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.evaluate_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.warning("fleet evaluation failed", exc_info=True)
            self._stop.wait(self.cfg.eval_period_s)

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "targets": dict(self._targets),
                "live": {r: len(self.co.workers(r)) for r in ROLES},
                "idle_periods": dict(self._idle),
                "pressured": dict(self._pressured),
                "actions": list(self.actions[-50:]),
                "adapter_residency": self.co.adapter_residency(),
            }
