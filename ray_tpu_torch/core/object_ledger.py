"""Object-plane observability: cluster-wide object ledger, per-edge
transfer-flow accounting, and leak/staleness detection.

Reference analogue: upstream ray's `ray memory` / object-store dashboard
(per-object reference tables over Plasma, `src/ray/core_worker/
reference_count.cc` joined with the object directory) and the Pathways
argument that a centralized view of resource state is what lets the
orchestration layer make globally good transfer decisions. Three planes,
one module:

* **Ledger** — every store entry carries creator/pin/last-access metadata
  (`object_store._Entry`, `shm_store._ShmMeta`); each store renders a
  bounded largest-first snapshot (`snapshot_store`) that worker runtimes
  ship on heartbeat telemetry (`cross_host._maybe_report_telemetry` →
  `control_plane.report_telemetry(objects=...)`). The head joins those
  snapshots with its `ReferenceCounter` counts and `ObjectDirectory`
  locations (`collect_objects`) to answer "every live object, where it
  lives, who holds it, why" cluster-wide.
* **Flow accounting** — `record_flow` tags byte/transfer counters with
  `(src, dst, path)` at exactly the sites that increment
  `object_pull_bytes` (native / chunked / stripe / relay in object_transfer.py)
  plus remote channel sends (channels.py), so the per-edge sums are
  conservative against the pull totals. Window bandwidth gauges
  (`object_flow_window_bps`) ride the same tags; everything federates
  through the ordinary metrics snapshot, and `collect_flows` folds the
  cluster's families into one matrix.
* **Leak sweep** — `sweep` (driven from the head monitor loop) flags
  pinned/escaped objects with zero live refs past `object_leak_age_s`,
  directory entries pointing at non-ALIVE nodes, and pull-through cache
  bytes never re-hit, re-asserting `object_leak` alerts through
  `core/health.py::HealthPlane.inject` each pass (injected alerts expire
  unless re-asserted) and publishing `object_leaks{kind}` gauges.

Everything here is gated on `config.object_ledger` (cached ~1s —
`reload_enabled()` after toggling mid-process, as the bench overhead
suite does).

The port's copy of ray_tpu/core/object_ledger.py. A shm store's rows come
from its handle's own metadata (`ShmObjectStore.ledger_records`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .config import config
from .logging import get_logger
from .metrics import Counter, Gauge

logger = get_logger("object_ledger")

# -- pin-reason taxonomy ----------------------------------------------------
# Why is this object held alive? (README "Object plane introspection")
PIN_USER_PUT = "user_put"            # driver ray_tpu.put(); freed by ref GC
PIN_CACHE = "cache"                  # pull-through replica on a puller node
PIN_CHANNEL = "channel"              # staged/held for a DistChannel edge
PIN_ESCAPED = "serialized_escape"    # ref pickled out; exempt from auto-free
PIN_INGEST = "ingest_cache"          # ingest-service preprocessed-block cache
PIN_REASONS = (PIN_USER_PUT, PIN_CACHE, PIN_CHANNEL, PIN_ESCAPED, PIN_INGEST)

LEAK_KINDS = ("pinned_no_refs", "dead_node_location", "cold_cache")

_flow_bytes = Counter(
    "object_flow_bytes",
    "Bytes moved per transfer edge, tagged (src, dst, path): path is "
    "native/chunked/stripe/relay for object pulls (recorded puller-side at the "
    "same sites as object_pull_bytes, so the sums reconcile) and channel "
    "for remote DistChannel sends (recorded sender-side).")
_flow_transfers = Counter(
    "object_flow_transfers",
    "Completed transfers per (src, dst, path) edge (one per pulled "
    "object / stripe / channel frame, not per chunk).")
_flow_window_bps = Gauge(
    "object_flow_window_bps",
    "Per-edge bandwidth over the last config.object_flow_window_s "
    "seconds, tagged (src, dst, path) like object_flow_bytes.")
_store_live_gauge = Gauge(
    "object_store_live_bytes",
    "Live bytes per store, tagged (node, store=memory|shm); refreshed "
    "at every ledger snapshot (telemetry flush / objects API hit).")
_leaks_gauge = Gauge(
    "object_leaks",
    "Objects flagged by the head-side leak sweep, by kind "
    "(pinned_no_refs / dead_node_location / cold_cache).")
_leaked_bytes_gauge = Gauge(
    "object_leaked_bytes",
    "Bytes held by objects the leak sweep flagged, by kind.")

# -- process-level node identity -------------------------------------------

_local_node = ""


def set_local_node(node_hex: str) -> None:
    """Record this process's node identity (dst side of pull edges, src
    side of channel edges). Head runtimes set their driver node; worker
    runtimes set theirs on join."""
    global _local_node
    _local_node = node_hex or ""


def local_node() -> str:
    return _local_node


# -- enabled flag (cached: record_flow sits on per-chunk hot paths) ---------

_enabled_cache: List[Any] = [True, 0.0]


def enabled() -> bool:
    now = time.monotonic()
    if now - _enabled_cache[1] > 1.0:
        try:
            _enabled_cache[0] = bool(config.object_ledger)
        except Exception:  # noqa: BLE001 — observability never breaks a pull
            _enabled_cache[0] = True
        _enabled_cache[1] = now
    return _enabled_cache[0]


def reload_enabled() -> None:
    """Invalidate the cached config.object_ledger value (call after
    toggling the flag mid-process, e.g. the bench overhead suite)."""
    _enabled_cache[1] = 0.0


# -- transfer-peer map (address -> node hex) --------------------------------

_peer_lock = threading.Lock()
_peer_nodes: Dict[str, str] = {}


def note_peer(addr: str, node_hex: str) -> None:
    """Learn an advertised transfer/channel address's node identity, so
    flow edges recorded by address resolve to node hexes."""
    if not addr or not node_hex:
        return
    with _peer_lock:
        if len(_peer_nodes) > 4096:
            _peer_nodes.clear()
        _peer_nodes[addr] = node_hex


def peer_node(addr: str) -> str:
    with _peer_lock:
        return _peer_nodes.get(addr, "")


# -- flow accounting --------------------------------------------------------

_flow_lock = threading.Lock()
# (src, dst, path) -> deque[(monotonic_ts, nbytes)] for the window gauges
_flow_windows: Dict[Tuple[str, str, str], deque] = {}


def _edge(src: str, dst: str, path: str) -> Tuple[str, str, str]:
    return ((src or "?")[:12], (dst or "?")[:12], path)


def record_flow(src: str, dst: str, path: str, nbytes: int,
                transfers: int = 0) -> None:
    """Account `nbytes` moved src->dst over `path`. Call at the same
    sites that count the authoritative byte totals (object_pull_bytes /
    channel_send_bytes) so the per-edge sums stay conservative."""
    if not enabled():
        return
    src, dst, path = _edge(src, dst, path)
    tags = {"src": src, "dst": dst, "path": path}
    if nbytes:
        _flow_bytes.inc(nbytes, tags=tags)
    if transfers:
        _flow_transfers.inc(transfers, tags=tags)
    if nbytes:
        with _flow_lock:
            _flow_windows.setdefault((src, dst, path), deque()).append(
                (time.monotonic(), nbytes))


def refresh_flow_gauges() -> None:
    """Prune per-edge windows and publish object_flow_window_bps. Called
    from the telemetry flush (workers) and the flows API/bench (head) —
    off the transfer hot path."""
    window = max(float(config.object_flow_window_s), 1e-3)
    now = time.monotonic()
    with _flow_lock:
        for (src, dst, path), dq in list(_flow_windows.items()):
            while dq and now - dq[0][0] > window:
                dq.popleft()
            if not dq:
                del _flow_windows[(src, dst, path)]
            _flow_window_bps.set(
                sum(n for _t, n in dq) / window,
                tags={"src": src, "dst": dst, "path": path})


# -- per-store snapshots (ships on heartbeat telemetry) ---------------------


def snapshot_store(store: Any, node_hex: str = "",
                   max_objects: Optional[int] = None) -> Dict[str, Any]:
    """Bounded wire snapshot of one store's ledger: largest records
    first, truncation made visible through total counts. Ages are
    computed locally (monotonic deltas) so cross-host clock skew never
    corrupts them."""
    if max_objects is None:
        max_objects = int(config.object_ledger_max_objects)
    node_hex = node_hex or local_node()
    try:
        records = store.ledger_records()
    except AttributeError:
        records = [{"object_id": oid.hex(), "size_bytes": size,
                    "age_s": 0.0, "idle_s": 0.0, "pin_count": 0,
                    "pin_reason": "", "creator_node": "", "creator_pid": 0,
                    "creator_task": ""}
                   for oid, size in store.list_objects()]
    kind = getattr(store, "kind", "memory")
    for r in records:
        r.setdefault("node_id", node_hex[:12])
        r.setdefault("store", kind)
    records.sort(key=lambda r: r.get("size_bytes", 0), reverse=True)
    total_bytes = sum(r.get("size_bytes", 0) for r in records)
    _store_live_gauge.set(total_bytes,
                          tags={"node": node_hex[:12], "store": kind})
    try:
        stats = dict(store.stats())
    except AttributeError:
        stats = {}
    return {
        "node_id": node_hex[:12],
        "store": kind,
        "total_objects": len(records),
        "total_bytes": total_bytes,
        "truncated": max(0, len(records) - max_objects),
        "records": records[:max_objects],
        "stats": stats,
    }


def local_snapshots(agents: Dict[Any, Any]) -> List[Dict[str, Any]]:
    """One bounded snapshot per non-remote agent store (worker runtimes
    have one agent; the head may host several virtual nodes)."""
    out = []
    for nid, agent in agents.items():
        if getattr(agent, "is_remote", False):
            continue
        store = getattr(agent, "store", None)
        if store is None:
            continue
        try:
            out.append(snapshot_store(store, nid.hex()))
        except Exception:  # noqa: BLE001 — telemetry never kills a beat
            logger.debug("ledger snapshot failed for %s", nid, exc_info=True)
    return out


# -- head-side federation ---------------------------------------------------


def _collect_rows(runtime) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Federated object rows + per-node store summaries: local agent
    stores snapshotted now, remote nodes from their latest telemetry
    ledger snapshots, each row joined with the head's refcount and the
    directory's location set."""
    from .ids import ObjectID

    snaps: List[Dict[str, Any]] = []
    with runtime._lock:
        agents = dict(runtime.agents)
    snaps.extend(local_snapshots(agents))
    try:
        telem = runtime.control_plane.telemetry_snapshots()
    except Exception:  # noqa: BLE001
        telem = {}
    for _node_hex, rec in sorted(telem.items()):
        snaps.extend(rec.get("objects") or [])

    rows: List[Dict[str, Any]] = []
    node_stats: Dict[str, Any] = {}
    for snap in snaps:
        key = f"{snap.get('node_id', '?')}/{snap.get('store', 'memory')}"
        node_stats[key] = {
            "objects": snap.get("total_objects", 0),
            "bytes": snap.get("total_bytes", 0),
            "truncated": snap.get("truncated", 0),
            **{k: v for k, v in (snap.get("stats") or {}).items()
               if k in ("num_spilled", "num_evictions", "capacity_bytes")},
        }
        rows.extend(dict(r) for r in snap.get("records", []))

    rc = getattr(runtime, "reference_counter", None)
    directory = getattr(runtime, "directory", None)
    loc_cache: Dict[str, List[str]] = {}
    for row in rows:
        oid_hex = row.get("object_id", "")
        try:
            oid = ObjectID.from_hex(oid_hex)
        except Exception:  # noqa: BLE001 — foreign id formats stay unjoined
            row.setdefault("refcount", 0)
            row.setdefault("locations", [])
            continue
        if rc is not None:
            row["refcount"] = rc.count(oid)
            row["escaped"] = rc.is_escaped(oid)
        if directory is not None:
            locs = loc_cache.get(oid_hex)
            if locs is None:
                locs = loc_cache[oid_hex] = [
                    n.hex()[:12] for n in directory.locations(oid)]
            row["locations"] = locs
    return rows, node_stats


def collect_objects(runtime, limit: int = 1000) -> Dict[str, Any]:
    """The federated /api/v0/objects body (also `ray-tpu memory`)."""
    rows, node_stats = _collect_rows(runtime)
    rows.sort(key=lambda r: r.get("size_bytes", 0), reverse=True)
    report = last_leak_report()
    return {
        "generated_at": time.time(),
        "total_objects": len(rows),
        "total_bytes": sum(r.get("size_bytes", 0) for r in rows),
        "objects": rows[:limit],
        "nodes": node_stats,
        "leaks": report.get("leaks", []),
        "leak_counts": report.get("counts", {}),
    }


_FLOW_FIELDS = {
    "object_flow_bytes": "bytes",
    "object_flow_transfers": "transfers",
    "object_flow_window_bps": "window_bps",
}


def collect_flows(runtime=None, control_plane=None) -> Dict[str, Any]:
    """The /api/v0/flows body: fold the local registry plus every node's
    federated metric snapshot into one per-edge matrix. Each edge is
    recorded by exactly one process (puller-side for pulls, sender-side
    for channels), so summing across sources never double-counts."""
    from .metrics import registry

    refresh_flow_gauges()
    cp = control_plane
    if cp is None and runtime is not None:
        cp = runtime.control_plane
    sources: List[Tuple[str, List[Dict[str, Any]]]] = [
        ("head", registry.snapshot())]
    if cp is not None:
        try:
            for node_hex, rec in sorted(cp.telemetry_snapshots().items()):
                sources.append((node_hex[:12], rec.get("metrics") or []))
        except Exception:  # noqa: BLE001
            pass
    edges: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
    for reporter, fams in sources:
        for fam in fams:
            field = _FLOW_FIELDS.get(fam.get("name", ""))
            if field is None:
                continue
            for _sname, tag_list, value in fam.get("samples", []):
                tags = dict(tag_list)
                key = (tags.get("src", "?"), tags.get("dst", "?"),
                       tags.get("path", "?"))
                edge = edges.get(key)
                if edge is None:
                    edge = edges[key] = {
                        "src": key[0], "dst": key[1], "path": key[2],
                        "bytes": 0.0, "transfers": 0.0, "window_bps": 0.0,
                        "reporters": []}
                edge[field] += float(value)
                if reporter not in edge["reporters"]:
                    edge["reporters"].append(reporter)
    rows = sorted(edges.values(), key=lambda e: e["bytes"], reverse=True)
    return {
        "generated_at": time.time(),
        "edges": rows,
        "total_bytes": sum(e["bytes"] for e in rows),
    }


# -- leak & staleness sweep (head-side) -------------------------------------

_sweep_lock = threading.Lock()
_sweep_last = 0.0
_last_leaks: Dict[str, Any] = {"generated_at": 0.0, "leaks": [], "counts": {}}


def last_leak_report() -> Dict[str, Any]:
    with _sweep_lock:
        return dict(_last_leaks)


def sweep(runtime, force: bool = False) -> Dict[str, Any]:
    """Flag held-but-unreachable objects, dead-node directory entries,
    and cold cache bytes; re-assert `object_leak` health alerts (injected
    alerts expire after ~3 periods unless re-asserted, so a sweep that
    stops seeing a leak lets its alert age out naturally)."""
    global _sweep_last
    now = time.monotonic()
    with _sweep_lock:
        if not force and now - _sweep_last < float(config.object_sweep_period_s):
            return dict(_last_leaks)
        _sweep_last = now
    if not enabled():
        return last_leak_report()
    age_thr = float(config.object_leak_age_s)
    leaks: List[Dict[str, Any]] = []
    try:
        rows, _stats = _collect_rows(runtime)
    except Exception:  # noqa: BLE001 — sweep never breaks the monitor loop
        logger.debug("leak sweep collect failed", exc_info=True)
        return last_leak_report()

    for row in rows:
        age = float(row.get("age_s", 0.0))
        idle = float(row.get("idle_s", 0.0))
        pinned = (row.get("pin_count", 0) or 0) > 0
        escaped = bool(row.get("escaped")) or row.get("pin_reason") == PIN_ESCAPED
        refs = int(row.get("refcount", 0) or 0)
        if (pinned or escaped) and refs == 0 and age > age_thr:
            leaks.append(_leak("pinned_no_refs", row,
                               f"pin_count={row.get('pin_count', 0)} "
                               f"reason={row.get('pin_reason', '') or 'pin'} "
                               f"refs=0 age={age:.0f}s"))
        elif (row.get("pin_reason") in (PIN_CACHE, PIN_INGEST)
                and age > age_thr and age - idle < 1.0):
            leaks.append(_leak("cold_cache", row,
                               f"cached {age:.0f}s ago, never re-hit"))

    # directory entries pointing at non-ALIVE nodes (the DEAD-mark ->
    # KV-purge window, or a purge that raced an add)
    directory = getattr(runtime, "directory", None)
    cp = getattr(runtime, "control_plane", None)
    if directory is not None and cp is not None:
        try:
            alive = {n.node_id.hex() for n in cp.alive_nodes()}
            for oid, node_ids in directory.items().items():
                for nid in node_ids:
                    if nid.hex() not in alive:
                        leaks.append({
                            "kind": "dead_node_location",
                            "object_id": oid.hex(),
                            "node_id": nid.hex()[:12],
                            "size_bytes": 0,
                            "age_s": 0.0,
                            "pin_reason": "",
                            "detail": f"directory lists {nid.hex()[:12]} "
                                      "but the node is not ALIVE",
                        })
        except Exception:  # noqa: BLE001
            logger.debug("dead-node directory scan failed", exc_info=True)

    counts: Dict[str, int] = {k: 0 for k in LEAK_KINDS}
    leaked_bytes: Dict[str, int] = {k: 0 for k in LEAK_KINDS}
    for l in leaks:
        counts[l["kind"]] = counts.get(l["kind"], 0) + 1
        leaked_bytes[l["kind"]] = (leaked_bytes.get(l["kind"], 0)
                                   + int(l.get("size_bytes", 0) or 0))
    for kind in counts:
        _leaks_gauge.set(counts[kind], tags={"kind": kind})
        _leaked_bytes_gauge.set(leaked_bytes[kind], tags={"kind": kind})

    _assert_alerts(leaks, counts, leaked_bytes)
    report = {"generated_at": time.time(), "leaks": leaks, "counts": counts,
              "leaked_bytes": leaked_bytes}
    with _sweep_lock:
        _last_leaks.clear()
        _last_leaks.update(report)
    return dict(report)


def _leak(kind: str, row: Dict[str, Any], detail: str) -> Dict[str, Any]:
    return {
        "kind": kind,
        "object_id": row.get("object_id", ""),
        "node_id": row.get("node_id", ""),
        "size_bytes": row.get("size_bytes", 0),
        "age_s": round(float(row.get("age_s", 0.0)), 1),
        "pin_reason": row.get("pin_reason", ""),
        "detail": detail,
    }


def _assert_alerts(leaks: List[Dict[str, Any]], counts: Dict[str, int],
                   leaked_bytes: Dict[str, int]) -> None:
    """Re-assert one `object_leak` alert per (kind, node) on the health
    plane, when one exists: injected alerts expire unless each sweep
    re-asserts them."""
    if not leaks:
        return
    try:
        from .health import get_health_plane

        plane = get_health_plane(create=False)
        if plane is None:
            return
        by_group: Dict[Tuple[str, str], int] = {}
        for l in leaks:
            key = (l["kind"], l.get("node_id", "") or "?")
            by_group[key] = by_group.get(key, 0) + 1
        for (kind, node), n in by_group.items():
            plane.inject(
                "object_leak", {"kind": kind, "node_id": node},
                value=float(n), severity="warning",
                expr=f"object ledger sweep: {n} {kind} object(s) on {node}")
    except Exception:  # noqa: BLE001 — alerting never breaks the sweep
        logger.debug("leak alert injection failed", exc_info=True)


# -- status()/health-payload sections ---------------------------------------


def objects_section(runtime) -> Dict[str, Any]:
    """Compact object-plane summary for ray_tpu.status() / the health
    payload: per-node live objects/bytes plus current leak counts."""
    if runtime is None or not enabled():
        return {}
    try:
        _rows, node_stats = _collect_rows(runtime)
        report = last_leak_report()
        return {
            "nodes": node_stats,
            "total_bytes": sum(s.get("bytes", 0) for s in node_stats.values()),
            "total_objects": sum(s.get("objects", 0)
                                 for s in node_stats.values()),
            "leak_counts": report.get("counts", {}),
        }
    except Exception:  # noqa: BLE001 — status must render regardless
        return {}


def channels_section(runtime) -> Dict[str, Dict[str, float]]:
    """Federated channel stats: the head's process-local totals plus each
    node's `channels` telemetry snapshot."""
    out: Dict[str, Dict[str, float]] = {}
    try:
        from . import channels

        local = channels.channel_stats()
        if any(local.values()):
            out["head"] = local
        if runtime is not None:
            for node_hex, rec in sorted(
                    runtime.control_plane.telemetry_snapshots().items()):
                snap = rec.get("channels")
                if snap and any(snap.values()):
                    out[node_hex[:12]] = dict(snap)
    except Exception:  # noqa: BLE001
        pass
    return out
