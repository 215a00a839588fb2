"""Central flag registry.

The port's copy of ray_tpu/core/config.py (the reference's counterpart of
upstream ray's `ray_config_def.h :: RAY_CONFIG` X-macro list): every
runtime knob is declared once here with a type, default and doc; values
resolve with precedence  init(system_config=...)  >  env RAY_TPU_<NAME>  >
default. The names, docs and defaults are the reference's, so one
environment configures both packages. The flags of the reference's
modules that the port does not have yet (host collectives, the pipeline
trainer) are left out until their modules come.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
from typing import Any, Callable, Dict, Optional

__all__ = ["Config", "config", "declare", "describe_flags"]

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def _parse_bool(s: str) -> bool:
    low = s.strip().lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise ValueError(f"not a boolean: {s!r}")


@dataclasses.dataclass(frozen=True)
class _Field:
    name: str
    default: Any
    doc: str
    parser: Callable[[str], Any]


_REGISTRY: Dict[str, _Field] = {}


def declare(name: str, default: Any, doc: str = "") -> None:
    """Declare a config flag. Types are inferred from the default."""
    if name in _REGISTRY:
        raise ValueError(f"duplicate config flag: {name}")
    if isinstance(default, bool):
        parser: Callable[[str], Any] = _parse_bool
    elif isinstance(default, int):
        parser = int
    elif isinstance(default, float):
        parser = float
    else:
        parser = str
    _REGISTRY[name] = _Field(name, default, doc, parser)


# ---------------------------------------------------------------------------
# Flag declarations, with the reference's names, defaults and docs.
# ---------------------------------------------------------------------------

# Core / scheduling, the object store and the control plane (the runtime)
declare(
    "worker_processes", max(2, min(8, (os.cpu_count() or 2) // 2)),
    "CPU-only tasks execute in this many forked worker processes sharing a "
    "shm object arena (crash isolation, like the reference's worker pool); "
    "0 = execute on the node agent's threads. Device tasks always stay on "
    "threads in the device-owning process. Default derives from host CPUs.",
)
declare(
    "prestart_worker_processes", True,
    "Warm the worker-process pool in the background at node-agent creation "
    "(reference: worker_pool.cc prestart), so the forkserver cost overlaps "
    "driver setup instead of the first task submission.",
)
declare(
    "actor_processes", True,
    "CPU actors (num_gpus=0, max_concurrency=1) get a dedicated worker "
    "process with a mailbox RPC (crash isolation, the reference's actor "
    "model). Device actors and high-concurrency system actors stay in the "
    "device-owning process; unpicklable state falls back in-process.",
)
declare("task_max_retries", 3, "Default retries for tasks on worker/node death.")
declare("actor_max_restarts", 0, "Default actor restarts on failure.")
declare("scheduler_top_k_fraction", 0.2, "Top-k fraction for hybrid scheduling.")
declare("scheduler_spread_threshold", 0.5, "Utilization below which local wins.")
declare("health_check_period_ms", 1_000, "Control-plane health check interval.")
declare("health_check_timeout_ms", 10_000, "Misses before a node is declared dead.")
declare("object_store_memory_bytes", 0, "Host shm store capacity; 0 = 30% of RAM.")
declare(
    "object_store_fallback_dir",
    os.path.join(tempfile.gettempdir(), "ray_tpu_torch_spill"),
    "Spill directory.",
)
declare("object_transfer_chunk_bytes", 1024 * 1024, "Inter-node chunk size.")
declare(
    "get_concurrency", 8,
    "Worker threads for batched Runtime.get: distinct refs fan out over "
    "this many parallel resolvers so pulls from different holders overlap "
    "(<=1 restores the serial path).",
)
declare(
    "object_transfer_pool_conns", 2,
    "Max pooled transfer connections per remote address; concurrent pulls "
    "from one holder ride separate sockets instead of serializing on one.",
)
declare(
    "object_transfer_chunk_window", 8,
    "Outstanding chunk requests pipelined per connection on the chunked "
    "pull path (1 = one synchronous round trip per chunk).",
)
declare(
    "object_transfer_stripe_min_bytes", 8 * 1024 * 1024,
    "Chunked pulls at or above this size stripe byte ranges across "
    "multiple advertised holders when at least two hold the object.",
)
declare(
    "object_pull_through_cache", True,
    "Seal remotely-pulled objects into the local store and register the "
    "location, so repeat gets are local hits and later pullers can fetch "
    "from this runtime (objects are immutable once sealed, so replicas "
    "never go stale).",
)
declare(
    "object_transfer_buffer_pool_bytes", 512 * 1024 * 1024,
    "Retained-bytes bound for the transfer receive-buffer pool. Large "
    "receive buffers are recycled across pulls (refcount-gated, so a "
    "buffer still referenced by zero-copy views is never reused) to "
    "avoid a full page-fault pass per large transfer; 0 disables "
    "pooling.",
)
declare(
    "object_transfer_max_stripes", 4,
    "Upper bound on concurrent stripe lanes a single chunked pull spreads "
    "across distinct sealed holders (diminishing returns past a few "
    "stripes on one NIC).",
)
declare(
    "object_transfer_shm_handoff", True,
    "Same-host pulls attach the holder's staging arena by name and map "
    "the blob zero-copy over /dev/shm instead of copying bytes through a "
    "loopback socket (detected via a boot-id host token).",
)
declare(
    "object_broadcast_relay", True,
    "Pullers of the same object self-organize into a chunk-pipelined "
    "relay tree: each claims a tree slot in the KV, pulls from its "
    "parent's committed prefix mid-transfer, and serves downstream "
    "pullers from its own partial. Off = every puller hits the sealed "
    "holders directly (flat fan-out).",
)
declare(
    "object_broadcast_fanout", 2,
    "Branching factor of the relay tree (out-degree per node, including "
    "the origin). Slot k's parent is slot (k - fanout) // fanout.",
)
declare(
    "object_relay_min_bytes", 4 * 1024 * 1024,
    "Objects below this size skip relay-tree formation; tree setup "
    "(claims + partial registration) costs more than a flat pull wins.",
)
declare(
    "object_relay_timeout_s", 30.0,
    "How long a chunk request parks on a relay holder's partial waiting "
    "for the byte range to land before the server fails the read and the "
    "puller falls back to another holder.",
)
declare(
    "object_ledger", True,
    "Maintain per-object ledger metadata (creator, pin reason, last "
    "access) and per-edge transfer-flow counters, shipped as bounded "
    "snapshots on heartbeat telemetry. Off = zero bookkeeping beyond the "
    "plain store entries (the bench overhead suite toggles this).",
)
declare(
    "object_ledger_max_objects", 256,
    "Max object records in one heartbeat ledger snapshot (largest-first; "
    "the snapshot carries total object/byte counts so truncation is "
    "visible on the head).",
)
declare(
    "object_leak_age_s", 60.0,
    "Head-side leak sweep: a pinned/escaped object with zero live driver "
    "refs older than this is flagged as leaked; a pull-through cache "
    "entry never re-hit for this long is flagged as cold.",
)
declare(
    "object_sweep_period_s", 5.0,
    "How often the head's monitor loop runs the object-plane leak/"
    "staleness sweep (dead-node directory entries, pinned-no-refs, cold "
    "cache bytes) and re-asserts its health alerts.",
)
declare(
    "object_flow_window_s", 10.0,
    "Sliding window for the per-edge object_flow_window_bps bandwidth "
    "gauges (per (src_node, dst_node, path) transfer link).",
)
declare("event_log_dir", "", "Structured event-log directory; empty = session dir.")
declare("task_events_max_buffer", 10_000, "Ring-buffer size for task events.")
declare(
    "telemetry_report_period_s", 5.0,
    "How often worker runtimes flush metrics snapshots, trace spans, and "
    "timeline events to the head (piggybacked on the heartbeat loop, so "
    "the effective period is at least one health_check_period_ms).",
)
declare(
    "telemetry_max_bytes", 1_000_000,
    "Byte budget for one heartbeat telemetry flush (spans + timeline "
    "events + metrics snapshot, pickled size). Overflow drops OLDEST "
    "spans/events first and counts them in telemetry_dropped_total{kind} "
    "so a span burst cannot bloat heartbeats. 0 = unlimited.",
)
declare(
    "telemetry_stale_factor", 3.0,
    "A node's federated telemetry snapshot is dropped from the merged "
    "dashboard/health view once it is older than this many "
    "telemetry_report_period_s (and purged outright on mark_node_dead), "
    "so killed nodes stop haunting /metrics.",
)
declare(
    "control_plane_rpc_host", "127.0.0.1",
    "Bind address for the control-plane RPC server; set 0.0.0.0 (or a "
    "specific interface) for cross-host attach.",
)
declare(
    "control_plane_rpc_port", -1,
    "Serve this runtime's control plane over TCP (core/rpc.py) so other "
    "processes/hosts and the CLI can attach: -1 = off, 0 = ephemeral port "
    "(logged), >0 = fixed port.",
)
declare(
    "node_host", "127.0.0.1",
    "This host's address for cross-host serving (worker dispatch + object "
    "transfer, core/cross_host.py): both the bind interface and the "
    "address ADVERTISED to the cluster, so it must be reachable from the "
    "head — set to this machine's cluster-facing IP when joining from "
    "another host.",
)

declare(
    "control_plane_reconnect_max_s", 5.0,
    "Cap on the exponential backoff between control-plane client "
    "reconnect attempts after a lost connection (rpc.RemoteControlPlane): "
    "attempts start at 50ms and double up to this bound, so a client "
    "rides out a head restart instead of poisoning itself.",
)
declare(
    "control_plane_call_deadline_s", 30.0,
    "Default per-call deadline for RemoteControlPlane requests. Every "
    "blocking call fails with the retryable ControlPlaneUnavailable "
    "within this window; idempotent methods (heartbeat, kv_get, dir_*, "
    "...) retry transparently across reconnects inside it, non-idempotent "
    "ones surface the error to the caller.",
)

declare(
    "control_plane_redial_rate", 16.0,
    "Process-wide cap on control-plane reconnect DIAL attempts per second "
    "(token bucket shared by every RemoteControlPlane in the process). "
    "Bounds the thundering herd when many clients re-dial a restarted or "
    "failed-over head/shard at once; <= 0 disables the cap.",
)
declare(
    "control_plane_shards", 0,
    "Federate the control plane: shard the KV store, object directory and "
    "pubsub fan-out across this many ControlPlaneShard subprocesses, each "
    "with a warm standby that is promoted on primary death "
    "(core/shard.py). 0 = off (single in-process head, the default).",
)
declare(
    "control_plane_shard_dir", "",
    "Directory for shard journals + snapshots when control_plane_shards "
    "> 0; empty = a per-session tmp directory.",
)
declare(
    "control_plane_gossip_ttl_s", 600.0,
    "TTL for gossip-namespace control-plane KV entries "
    "(object_transfer*/node_service/channel_service advertisements) whose "
    "owner is no longer ALIVE — reaps tombstones left by nodes that died "
    "without mark_node_dead.",
)
declare(
    "scheduler_local_admit", True,
    "Bottom-up scheduling: the driver-local node agent admits a task "
    "against its own resource view when it fits below the spread "
    "threshold, delegating to ClusterScheduler only on overflow "
    "(reference: Ray's two-level local-first scheduler).",
)
declare(
    "control_plane_snapshot_path", "",
    "Snapshot the control-plane tables (KV/jobs/named actors/...) to this "
    "file on an interval; init(resume_from=path) rebuilds from it. "
    "Empty = persistence off.",
)

# Serving (serve/engine.py, serve/spec_decode.py, serve/disagg.py)
declare(
    "spec_overlap", True,
    "Speculative decoding: overlap the draft-model propose for round N+1 "
    "with the host-side commit/bookkeeping of round N (the prefetched "
    "drafts are validated per slot by request/position stamps, so "
    "eviction or cancellation in between degrades to a plain token, "
    "never to a wrong one). Per-engine override: "
    "SpeculationConfig.overlap.",
)
declare(
    "kv_frame_layout", "layer",
    "Streamed KV-migration frame layout: 'layer' (wire v2 — frames carry "
    "a slab of consecutive layers per token range, so the stream starts "
    "during the first layers of the device->host pull and the importer "
    "stages slabs as they land) or 'token' (wire v1 — all layers per "
    "frame). Per-request override: Request.kv_frame_layout; disagg "
    "coordinators forward DisaggConfig.kv_frame_layout.",
)

# Observability
declare("log_to_driver", True, "Tail worker logs back to the driver process.")
declare(
    "flight_recorder_entries", 256,
    "Per-process flight-recorder ring size (recent spans + log lines + "
    "events, util/flight_recorder.py) flushed into a postmortem artifact "
    "when a crashed worker is reaped.",
)
declare(
    "flight_recorder_bytes", 262_144,
    "Size cap for a worker's on-disk flight-recorder mirror file; the "
    "mirror is rewritten from the in-memory ring when it grows past "
    "this, so a chatty worker cannot fill the session dir.",
)
declare(
    "control_plane_snapshot_interval_s", 5.0,
    "Seconds between control-plane snapshots when persistence is on.",
)
declare(
    "trace_sample_rate", 0.0,
    "Fraction of serve requests that open a root trace span at the API "
    "entry point (util/tracing.py). 0 disables sampling entirely (the "
    "zero-overhead default); requests arriving under an already-active "
    "span are always traced regardless of this rate.",
)

# The health plane (core/health.py HealthPlane) and its default rules
declare(
    "slo_ttft_ms", 0.0,
    "p95-TTFT service-level objective in ms. >0 arms the default "
    "health-plane rule `p95(serve_ttft_seconds) > slo for 2 periods`; "
    "0 leaves TTFT alerting to user-supplied rules.",
)
declare(
    "health_eval_period_s", 2.0,
    "How often the head health plane (core/health.py) evaluates its "
    "alert rules against digests, federated metrics, and heartbeats.",
)
declare(
    "health_queue_depth_max", 64,
    "Default alert threshold for serve_disagg_queue_depth (sustained "
    "two evaluation periods).",
)
declare(
    "health_memory_fraction_max", 0.92,
    "Default alert threshold for host_memory_used_fraction (sustained "
    "two evaluation periods).",
)
# Online RL post-training (rl/online.py)
declare(
    "rl_staleness_max_versions", 1,
    "Online-RL staleness bound: a rollout trajectory whose stamped "
    "weights_version trails the trainer's current generation by more "
    "than this many versions is stale. What happens to it is "
    "rl_staleness_policy's call.",
)
declare(
    "rl_staleness_policy", "drop",
    "What the online-RL trainer does with stale trajectories: 'drop' "
    "discards them (counted in rl_stale_trajectories dropped), "
    "'correct' keeps them — the clipped importance ratio against the "
    "rollout-time logprobs (GRPO's logp_old) absorbs the off-policy "
    "gap.",
)
declare(
    "rl_trajectory_channel_capacity", 64,
    "Bound of the scored-trajectory DistChannel between the reward "
    "stage and the online-RL trainer: a slow trainer backpressures "
    "rollout generation instead of buffering unboundedly.",
)
declare(
    "rl_sync_stall_max_pct", 5.0,
    "Alert threshold for the rl goodput ledger's weight_sync share: the "
    "rl_sync_stall health rule fires when weight re-sync consumes more "
    "than this percent of loop wall time.",
)

# Health-aware routing (core/health.py ReplicaHealth)
declare(
    "health_quarantine_s", 5.0,
    "How long health-aware routing (core/health.py ReplicaHealth) "
    "quarantines a degraded replica before sending one probe request.",
)

# SLO digests (util/slo.py)
declare(
    "slo_digests", True,
    "Update streaming latency digests (util/slo.py: TTFT, time-between-"
    "tokens, e2e) inline in the serve hot paths. Off = zero digest work.",
)
declare(
    "slo_digest_window_s", 60.0,
    "Sliding window the per-process latency digests answer quantile "
    "queries over (rotated in slo._SLICES sub-windows).",
)

# Data plane (data/iterator.py)
declare("device_prefetch_depth", 2, "Host->HBM double buffering depth.")

# Shared ingest service (data/ingest.py, data/tenant.py)
declare(
    "ingest_default_weight", 1.0,
    "Fair-share weight assigned to an ingest tenant that registers "
    "without an explicit one. Weights are relative: a weight-3 tenant "
    "is admitted ~3x the blocks of a weight-1 tenant under contention.",
)
declare(
    "ingest_inflight_bytes", 32 * 1024 * 1024,
    "Per-tenant in-flight byte budget for the ingest admission loop: "
    "once this many estimated output bytes are dispatched-but-"
    "unconsumed for one tenant, its further blocks wait regardless of "
    "deficit, so one fast-draining tenant cannot park the whole pool's "
    "output in the object plane.",
)
declare(
    "ingest_quantum_bytes", 4 * 1024 * 1024,
    "Deficit round-robin quantum: byte credit granted per admission "
    "round per unit of tenant weight. Larger quanta batch a tenant's "
    "dispatches; smaller quanta interleave tenants more finely.",
)
declare(
    "ingest_cache_ttl_s", 300.0,
    "Ephemeral block-cache TTL: a preprocessed block (PIN_INGEST) not "
    "re-served for this long is evicted by the service janitor. "
    "Deregistered tenants' blocks are condemned immediately and "
    "collected on the next janitor pass.",
)
declare("ingest_pool_min", 1, "Ingest worker-pool floor (autoscale lower bound).")
declare("ingest_pool_max", 4, "Ingest worker-pool ceiling (autoscale upper bound).")
declare(
    "ingest_eval_period_s", 0.5,
    "How often the ingest pool controller evaluates per-tenant "
    "data_stage_stall_seconds deltas for scale-up/scale-down decisions.",
)
declare(
    "ingest_stall_scale_threshold", 0.1,
    "Per-tenant stall-seconds accumulated within one controller eval "
    "period that counts as scale-up pressure on the ingest pool.",
)

# the ingest pool's autoscaler and the serve fleet's (in the reference also
# the node autoscaler's, which waits for ROADMAP A5c)
declare(
    "autoscale_cooldown_s", 15.0,
    "Minimum gap between scale-up waves (the ingest worker pool's and "
    "serve/fleet.py replica-target bumps). Demand arriving inside the "
    "cooldown is absorbed by the in-flight wave instead of launching more "
    "capacity, so one burst cannot flap the pool or the fleet.",
)
declare(
    "autoscale_step_max", 2,
    "Cap on how many scale-up actions one evaluation pass may take "
    "(workers the ingest pool's controller adds or retires, the "
    "replica-target delta per FleetController period). Bounds the blast "
    "radius of a noisy demand signal.",
)

# Correctness tooling (util/sanitizer.py)
declare(
    "sanitize", False,
    "RAY_TPU_SANITIZE=1 swaps threading.Lock/RLock for instrumented "
    "wrappers at import time: acquisition order feeds a per-process "
    "lock-order graph (cycles = potential deadlock) and long holds are "
    "flagged, both reported through the flight recorder. Off = the "
    "stock primitives, zero overhead.",
)
declare(
    "sanitize_hold_ms", 100.0,
    "Sanitizer lock-hold budget: releasing a lock held longer than this "
    "(blocking work under a lock) records a hold-time violation.",
)


class Config:
    """Resolved configuration view. Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._overrides: Dict[str, Any] = {}

    def apply_overrides(self, system_config: Optional[Dict[str, Any]]) -> None:
        if not system_config:
            return
        with self._lock:
            for key, value in system_config.items():
                if key not in _REGISTRY:
                    raise KeyError(f"unknown config flag: {key}")
                self._overrides[key] = value

    def reset(self) -> None:
        with self._lock:
            self._overrides.clear()

    def get(self, name: str) -> Any:
        field = _REGISTRY.get(name)
        if field is None:
            raise KeyError(f"unknown config flag: {name}")
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
        env = os.environ.get(f"RAY_TPU_{name.upper()}")
        if env is not None:
            return field.parser(env)
        return field.default

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)


config = Config()


def describe_flags() -> Dict[str, Dict[str, Any]]:
    return {
        f.name: {"default": f.default, "doc": f.doc, "value": config.get(f.name)}
        for f in _REGISTRY.values()
    }
