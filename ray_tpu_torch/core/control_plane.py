"""Cluster control plane (GCS equivalent).

Equivalent of the reference's Global Control Service (upstream ray
`src/ray/gcs/gcs_server/gcs_server.cc :: GcsServer` with its node / actor /
job / placement-group managers, `InternalKVInterface`, pubsub and health
checks): the single authority for cluster membership, the actor directory,
cluster-wide KV, and resource views. In-process for a single host; the same
object is served over gRPC-style RPC for multi-host (the
reference's core/rpc.py). State mutations publish to channels so node agents and
drivers react to membership/actor changes without polling.

The port's copy of ray_tpu/core/control_plane.py; core/rpc.py serves it
over TCP and core/shard.py federates its gossip planes.
"""

from __future__ import annotations

import enum
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from .ids import ActorID, JobID, NodeID, PlacementGroupID, SliceID
from .logging import get_logger
from .metrics import Counter, Gauge

logger = get_logger("control_plane")

_nodes_gauge = Gauge("ray_tpu_nodes", "Cluster nodes by state")
_actors_gauge = Gauge("ray_tpu_actors", "Actors by state")
_gossip_swept = Counter(
    "control_plane_gossip_swept_total",
    "Stale gossip KV entries removed by the TTL sweep")
_heartbeat_lag = Gauge(
    "control_plane_heartbeat_lag_seconds",
    "Worst heartbeat staleness across ALIVE nodes, sampled each health sweep")

# Gossip namespaces: per-node advertisements other nodes rank/dial by.
# Keys are `<prefix><node_hex>` (relay claims differ — see sweep). A node
# that dies WITHOUT mark_node_dead (SIGKILLed host, partitioned forever,
# crashed before deregistering) leaves these behind; at fleet scale the
# tombstones accumulate, so the TTL sweep reaps any entry whose owner is
# not ALIVE and whose last write is older than the TTL. The write-stamp
# grace matters: worker hosts advertise KV BEFORE register_node, so a
# fresh key with no ALIVE owner yet is a joiner, not a corpse.
GOSSIP_NODE_PREFIXES: Tuple[str, ...] = (
    "object_transfer/",       # transfer-plane address (object_transfer.KV_PREFIX)
    "object_transfer_load/",  # pull-load ranking gossip (LOAD_PREFIX)
    "object_transfer_host/",  # same-host shm tokens (HOST_PREFIX)
    "node_service/",          # dispatch address (cross_host.NODE_SERVICE_PREFIX)
    "channel_service/",       # DistChannel service (channels.KV_CHANNEL_PREFIX)
)
# value-suffix-owned namespaces: key does not embed the node, the value
# records "...|<node_hex>" (broadcast relay CAS claims)
GOSSIP_RELAY_PREFIX = "object_transfer_relay/"


def _is_gossip_key(key: str) -> bool:
    return key.startswith(GOSSIP_NODE_PREFIXES) or key.startswith(GOSSIP_RELAY_PREFIX)


class NodeState(enum.Enum):
    ALIVE = "ALIVE"
    DEAD = "DEAD"


class ActorState(enum.Enum):
    PENDING = "PENDING"
    STARTING = "STARTING"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


@dataclass
class NodeInfo:
    node_id: NodeID
    address: str
    resources_total: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)
    slice_id: Optional[SliceID] = None
    topology_coords: Optional[Tuple[int, ...]] = None  # host position in slice torus
    state: NodeState = NodeState.ALIVE
    last_heartbeat: float = field(default_factory=time.monotonic)
    # eventually-consistent load view, updated by the resource syncer
    resources_available: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        if not self.resources_available:
            self.resources_available = dict(self.resources_total)


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: str
    class_name: str = ""
    state: ActorState = ActorState.PENDING
    node_id: Optional[NodeID] = None
    num_restarts: int = 0
    max_restarts: int = 0
    death_cause: str = ""


class Pubsub:
    """In-process pub/sub (reference: `src/ray/pubsub/ :: Publisher/Subscriber`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._subs: Dict[str, List[Callable[[Any], None]]] = {}

    def subscribe(self, channel: str, callback: Callable[[Any], None]) -> Callable[[], None]:
        with self._lock:
            self._subs.setdefault(channel, []).append(callback)

        def unsubscribe() -> None:
            with self._lock:
                try:
                    self._subs.get(channel, []).remove(callback)
                except ValueError:
                    pass

        return unsubscribe

    def publish(self, channel: str, message: Any) -> None:
        with self._lock:
            callbacks = list(self._subs.get(channel, []))
        for cb in callbacks:
            try:
                cb(message)
            except Exception:  # subscriber errors must not poison the bus
                logger.exception("pubsub subscriber error on channel %s", channel)


class ControlPlane:
    """Single-authority cluster state. All methods are thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.pubsub = Pubsub()
        self._nodes: Dict[NodeID, NodeInfo] = {}
        self._actors: Dict[ActorID, ActorInfo] = {}
        self._named_actors: Dict[str, ActorID] = {}
        self._jobs: Dict[JobID, Dict[str, Any]] = {}
        self._kv: Dict[str, bytes] = {}
        # last-write stamps for gossip-namespace keys only (sweep_gossip);
        # durable KV (function table, checkpoints, serve config) is never
        # stamped and never swept
        self._kv_stamp: Dict[str, float] = {}
        self._last_sweep = 0.0
        self._placement_groups: Dict[PlacementGroupID, Any] = {}
        # node_id hex -> latest telemetry report (metrics snapshot + role
        # + flush cursors) from that worker process; spans/timeline events
        # are ingested straight into the head's own buffers on arrival.
        self._telemetry: Dict[str, Dict[str, Any]] = {}
        # federated crash postmortems (bounded; see util/flight_recorder)
        self._postmortems: deque = deque(maxlen=50)
        self._dead = False

    # -- node table ---------------------------------------------------------
    def register_node(self, info: NodeInfo) -> None:
        with self._lock:
            # the info may have crossed a process boundary: its monotonic
            # heartbeat stamp is another clock's — restamp locally. A
            # rejoining host (falsely reaped, or head restarted) registers
            # with the SAME node id: revive it rather than zombie it.
            info.state = NodeState.ALIVE
            info.last_heartbeat = time.monotonic()
            prev = self._nodes.get(info.node_id)
            self._nodes[info.node_id] = info
        if prev is None:
            _nodes_gauge.add(1, {"state": "ALIVE"})
        elif prev.state is NodeState.DEAD:
            _nodes_gauge.add(-1, {"state": "DEAD"})
            _nodes_gauge.add(1, {"state": "ALIVE"})
        self.pubsub.publish("node", ("ALIVE", info))

    def mark_node_dead(self, node_id: NodeID, reason: str = "") -> None:
        with self._lock:
            info = self._nodes.get(node_id)
            if info is None or info.state is NodeState.DEAD:
                return
            info.state = NodeState.DEAD
            # purge the node's advertised addresses and transfer-load
            # gossip: stale object_transfer_load/* keys would keep
            # pull_from_any's least-loaded ranking preferring a corpse
            # (prefix literals: object_transfer.KV_PREFIX/LOAD_PREFIX,
            # cross_host.NODE_SERVICE_PREFIX, channels.KV_CHANNEL_PREFIX —
            # spelled out here to avoid import cycles)
            hexid = node_id.hex()
            for prefix in GOSSIP_NODE_PREFIXES:
                self._kv.pop(prefix + hexid, None)
                self._kv_stamp.pop(prefix + hexid, None)
            # relay claims record "address|flow_label|node_hex"; a dead
            # relay must not stay in any broadcast tree — children time
            # out on its partial and fall back, but new pulls ranking by
            # claim slot would keep dialing the corpse
            for key in [k for k in self._kv
                        if k.startswith("object_transfer_relay/")]:
                val = self._kv.get(key)
                if isinstance(val, str) and val.rsplit("|", 1)[-1] == hexid:
                    self._kv.pop(key, None)
                    self._kv_stamp.pop(key, None)
            # and its last telemetry snapshot: a dead node's metrics and
            # digests must not haunt the merged dashboard/health view
            self._telemetry.pop(hexid, None)
        _nodes_gauge.add(-1, {"state": "ALIVE"})
        _nodes_gauge.add(1, {"state": "DEAD"})
        logger.warning("node %s marked DEAD: %s", node_id, reason)
        self.pubsub.publish("node", ("DEAD", info))

    def heartbeat(self, node_id: NodeID, resources_available: Optional[Dict[str, float]] = None) -> bool:
        """-> True if the node is ALIVE in the table. False tells the
        sender it has been reaped (or was never known): a worker whose
        partition outlived the health timeout must learn it is DEAD and
        shut down instead of zombie-heartbeating forever (reference: a
        raylet killed on GCS death declaration)."""
        with self._lock:
            info = self._nodes.get(node_id)
            if info is None or info.state is not NodeState.ALIVE:
                return False
            info.last_heartbeat = time.monotonic()
            if resources_available is not None:
                info.resources_available = dict(resources_available)
            return True

    def heartbeat_bulk(
        self,
        beats: List[Tuple[Any, Optional[Dict[str, float]]]],
    ) -> Dict[str, bool]:
        """Pod-aggregator heartbeat: one RPC carries a whole pod's beats.
        ``beats`` is [(node_id, resources_available_or_None)]; the reply
        maps node hex -> alive verdict, same semantics as `heartbeat` per
        entry. Keeps head ingest O(pods), not O(nodes)."""
        out: Dict[str, bool] = {}
        for node_id, avail in beats:
            out[node_id.hex()] = self.heartbeat(node_id, avail)
        return out

    # -- federated telemetry ------------------------------------------------
    def report_telemetry(
        self,
        node_id_hex: str,
        role: str = "worker",
        metrics: Optional[List[Dict[str, Any]]] = None,
        spans: Optional[List[Dict[str, Any]]] = None,
        events: Optional[List[Dict[str, Any]]] = None,
        event_cursor: int = 0,
        digests: Optional[List[Dict[str, Any]]] = None,
        postmortems: Optional[List[Dict[str, Any]]] = None,
        objects: Optional[List[Dict[str, Any]]] = None,
        channels: Optional[Dict[str, float]] = None,
    ) -> bool:
        """Worker-process telemetry flush (piggybacked on the heartbeat
        loop, see cross_host.WorkerRuntime). Metrics and SLO digests
        replace the node's previous snapshot; spans merge into the head
        trace buffer (deduped by span_id, so transparent RPC retries are
        safe); timeline events append into the head ring under a
        per-node lane, guarded by `event_cursor` so a retried flush
        can't double-append; crash postmortem artifacts append to the
        head's bounded postmortem store (/api/v0/postmortems)."""
        from ..util import timeline, tracing

        with self._lock:
            prev = self._telemetry.get(node_id_hex) or {}
            seen_events = int(prev.get("event_cursor", 0))
            rec = {
                "role": role,
                "metrics": metrics if metrics is not None
                else prev.get("metrics", []),
                "digests": digests if digests is not None
                else prev.get("digests", []),
                "objects": objects if objects is not None
                else prev.get("objects", []),
                "channels": channels if channels is not None
                else prev.get("channels", {}),
                "event_cursor": max(seen_events, int(event_cursor)),
                "reported_at": time.time(),
            }
            self._telemetry[node_id_hex] = rec
            if postmortems:
                # dedup on (pid, written_at): a flush retried after a
                # requeue may carry artifacts the head already has
                seen = {(p.get("pid"), p.get("written_at"))
                        for p in self._postmortems}
                for p in postmortems:
                    if (p.get("pid"), p.get("written_at")) not in seen:
                        self._postmortems.append(
                            dict(p, node_id=node_id_hex[:12]))
        if spans:
            tracing.ingest(spans)
        if events and event_cursor > seen_events:
            timeline.ingest(events, lane=node_id_hex[:8])
        return True

    def telemetry_snapshots(self) -> Dict[str, Dict[str, Any]]:
        """node_id hex -> latest {role, metrics, digests, reported_at}
        (for the dashboard's merged /metrics and the health plane).
        Snapshots older than telemetry_stale_factor report periods are
        dropped — a node that stopped flushing (killed, partitioned)
        must not haunt the merged view with its last readings."""
        from .config import config

        try:
            horizon = time.time() - (
                float(config.telemetry_stale_factor)
                * float(config.telemetry_report_period_s))
        except Exception:
            horizon = 0.0
        with self._lock:
            stale = [k for k, v in self._telemetry.items()
                     if v.get("reported_at", 0.0) < horizon]
            for k in stale:
                del self._telemetry[k]
            return {k: dict(v) for k, v in self._telemetry.items()}

    def postmortems(self) -> List[Dict[str, Any]]:
        """Federated crash postmortems (newest last, bounded)."""
        with self._lock:
            return [dict(p) for p in self._postmortems]

    def alive_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [n for n in self._nodes.values() if n.state is NodeState.ALIVE]

    def get_node(self, node_id: NodeID) -> Optional[NodeInfo]:
        with self._lock:
            return self._nodes.get(node_id)

    def all_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return list(self._nodes.values())

    # -- actor directory ----------------------------------------------------
    def register_actor(self, info: ActorInfo) -> None:
        with self._lock:
            self._actors[info.actor_id] = info
            if info.name:
                if info.name in self._named_actors:
                    raise ValueError(f"actor name already taken: {info.name}")
                self._named_actors[info.name] = info.actor_id
        self.pubsub.publish("actor", (info.state, info))

    def update_actor(self, actor_id: ActorID, state: ActorState, node_id: Optional[NodeID] = None,
                     death_cause: str = "") -> None:
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None:
                return
            info.state = state
            if node_id is not None:
                info.node_id = node_id
            if death_cause:
                info.death_cause = death_cause
            if state is ActorState.RESTARTING:
                info.num_restarts += 1
            if state is ActorState.DEAD and info.name:
                self._named_actors.pop(info.name, None)
        self.pubsub.publish("actor", (state, info))

    def get_actor(self, actor_id: ActorID) -> Optional[ActorInfo]:
        with self._lock:
            return self._actors.get(actor_id)

    def get_named_actor(self, name: str) -> Optional[ActorInfo]:
        with self._lock:
            actor_id = self._named_actors.get(name)
            return self._actors.get(actor_id) if actor_id else None

    def list_actors(self) -> List[ActorInfo]:
        with self._lock:
            return list(self._actors.values())

    # -- job table ----------------------------------------------------------
    def register_job(self, job_id: JobID, metadata: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            self._jobs[job_id] = {"state": "RUNNING", "start_time": time.time(),
                                  **(metadata or {})}

    def finish_job(self, job_id: JobID, state: str = "SUCCEEDED") -> None:
        with self._lock:
            if job_id in self._jobs:
                self._jobs[job_id]["state"] = state
                self._jobs[job_id]["end_time"] = time.time()

    def list_jobs(self) -> Dict[JobID, Dict[str, Any]]:
        with self._lock:
            return dict(self._jobs)

    # -- internal KV (function table, serve config, checkpoints metadata) ---
    def kv_put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        with self._lock:
            if not overwrite and key in self._kv:
                return False
            self._kv[key] = value
            if _is_gossip_key(key):
                self._kv_stamp[key] = time.monotonic()
            return True

    def kv_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._kv.get(key)

    def kv_del(self, key: str) -> bool:
        with self._lock:
            self._kv_stamp.pop(key, None)
            return self._kv.pop(key, None) is not None

    def kv_keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return [k for k in self._kv if k.startswith(prefix)]

    def sweep_gossip(self, ttl_s: Optional[float] = None) -> int:
        """Reap gossip KV entries whose owner node is not ALIVE and whose
        last write is older than ``ttl_s`` (default
        config.control_plane_gossip_ttl_s). mark_node_dead already purges
        on clean deregistration; this catches nodes that died without it.
        Returns the number of keys removed."""
        if ttl_s is None:
            from .config import config

            ttl_s = float(config.control_plane_gossip_ttl_s)
        horizon = time.monotonic() - ttl_s
        swept = 0
        with self._lock:
            alive = {n.node_id.hex() for n in self._nodes.values()
                     if n.state is NodeState.ALIVE}
            doomed: List[str] = []
            for key in self._kv:
                if key.startswith(GOSSIP_NODE_PREFIXES):
                    owner = key.rsplit("/", 1)[-1]
                elif key.startswith(GOSSIP_RELAY_PREFIX):
                    val = self._kv.get(key)
                    owner = (val.rsplit("|", 1)[-1]
                             if isinstance(val, str) else "")
                else:
                    continue
                if owner in alive:
                    continue
                # stamp grace: keys written before the sweep machinery (or
                # restored from a snapshot) have no stamp — treat as old
                if self._kv_stamp.get(key, horizon - 1.0) <= horizon:
                    doomed.append(key)
            for key in doomed:
                self._kv.pop(key, None)
                self._kv_stamp.pop(key, None)
                swept += 1
        if swept:
            _gossip_swept.inc(swept)
            logger.info("gossip sweep reaped %d stale KV entries", swept)
        return swept

    # -- health checking ----------------------------------------------------
    def check_health(self, timeout_s: float) -> List[NodeID]:
        """Mark nodes dead whose heartbeat is older than timeout. Returns them."""
        now = time.monotonic()
        stale: List[NodeID] = []
        worst_lag = 0.0
        with self._lock:
            for node_id, info in self._nodes.items():
                if info.state is not NodeState.ALIVE:
                    continue
                lag = now - info.last_heartbeat
                worst_lag = max(worst_lag, lag)
                if lag > timeout_s:
                    stale.append(node_id)
        _heartbeat_lag.set(worst_lag)
        for node_id in stale:
            self.mark_node_dead(node_id, reason=f"no heartbeat for {timeout_s}s")
        return stale

    def snapshot(self) -> Dict[str, Any]:
        """State-API view of the whole cluster (reference: `ray list ...`)."""
        with self._lock:
            return {
                "nodes": [
                    {
                        "node_id": n.node_id.hex(),
                        "state": n.state.value,
                        "address": n.address,
                        "resources_total": dict(n.resources_total),
                        "resources_available": dict(n.resources_available),
                        "labels": dict(n.labels),
                    }
                    for n in self._nodes.values()
                ],
                "actors": [
                    {
                        "actor_id": a.actor_id.hex(),
                        "name": a.name,
                        "state": a.state.value,
                        "node_id": a.node_id.hex() if a.node_id else None,
                        "num_restarts": a.num_restarts,
                    }
                    for a in self._actors.values()
                ],
                "jobs": {j.hex(): dict(v) for j, v in self._jobs.items()},
            }
