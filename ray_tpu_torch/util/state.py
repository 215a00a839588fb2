"""State API (reference: `python/ray/util/state/api.py` — `ray list
actors/tasks/nodes`, `ray summary`): queryable cluster state with filters,
plus a Prometheus metrics HTTP endpoint (dashboard-lite: the reference's
observability planes without the React app, per SURVEY.md §7.5).

The port's copy of ray_tpu/util/state.py."""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Tuple

from .. import api
from ..core.metrics import registry as metrics_registry

Filter = Tuple[str, str, Any]  # (key, "=" | "!=", value)


def _apply_filters(rows: List[Dict[str, Any]], filters) -> List[Dict[str, Any]]:
    for key, op, value in filters or []:
        if op == "=":
            rows = [r for r in rows if str(r.get(key)) == str(value)]
        elif op == "!=":
            rows = [r for r in rows if str(r.get(key)) != str(value)]
        else:
            raise ValueError(f"unsupported filter op {op!r}")
    return rows


def list_nodes(filters=None, limit: int = 100) -> List[Dict[str, Any]]:
    rt = api._auto_init()
    rows = []
    for n in rt.control_plane.all_nodes():
        rows.append({
            "node_id": n.node_id.hex()[:16],
            "state": n.state.name,
            "resources_total": dict(n.resources_total),
            "resources_available": dict(n.resources_available),
            "labels": dict(n.labels or {}),
        })
    return _apply_filters(rows, filters)[:limit]


def list_actors(filters=None, limit: int = 100) -> List[Dict[str, Any]]:
    rt = api._auto_init()
    rows = []
    for a in rt.control_plane.list_actors():
        rows.append({
            "actor_id": a.actor_id.hex()[:16],
            "class_name": a.class_name,
            "state": a.state.name,
            "name": a.name or "",
            "node_id": a.node_id.hex()[:16] if a.node_id else "",
            "restarts": a.num_restarts,
        })
    return _apply_filters(rows, filters)[:limit]


def list_jobs(filters=None, limit: int = 100) -> List[Dict[str, Any]]:
    rt = api._auto_init()
    rows = [
        {"job_id": j.hex()[:16], **meta}
        for j, meta in rt.control_plane.list_jobs().items()
    ]
    return _apply_filters(rows, filters)[:limit]


def list_objects(filters=None, limit: int = 100) -> List[Dict[str, Any]]:
    """Cluster-wide object rows from the federated ledger: local stores
    snapshotted now, joined hosts from their latest telemetry snapshot,
    each row carrying location set / refcount / pin reason / age."""
    rt = api._auto_init()
    from ..core import object_ledger

    rows = []
    for r in object_ledger.collect_objects(rt, limit=10_000)["objects"]:
        rows.append({
            "object_id": r.get("object_id", "")[:16],
            "node_id": r.get("node_id", "")[:16],
            "size_bytes": r.get("size_bytes", 0),
            "store": r.get("store", ""),
            "pin_reason": r.get("pin_reason", ""),
            "refcount": r.get("refcount", 0),
            "locations": ",".join(r.get("locations", [])),
            "age_s": round(float(r.get("age_s", 0.0)), 1),
            "creator_task": r.get("creator_task", ""),
        })
    return _apply_filters(rows, filters)[:limit]


def summary() -> Dict[str, Any]:
    rt = api._auto_init()
    actors = list_actors(limit=10_000)
    by_state: Dict[str, int] = {}
    for a in actors:
        by_state[a["state"]] = by_state.get(a["state"], 0) + 1
    utilization: Dict[str, Dict[str, float]] = {}
    try:
        # per-node CPU/RSS next to the memory fraction (profiling plane):
        # same source the health payload reads, so /api/v0/summary and
        # /api/v0/health agree
        from ..core.health import get_health_plane

        plane = get_health_plane(create=False)
        if plane is not None:
            utilization, _ = plane._profiling_sections(plane._cp())
        else:
            from . import profiler
            row = profiler.update_resource_gauges()
            utilization = {"head": {
                "cpu_fraction": row.get("host_cpu_used_fraction", 0.0),
                "rss_bytes": row.get("process_rss_bytes", 0.0),
            }}
    except Exception:  # noqa: BLE001 — summary must render regardless
        pass
    return {
        "nodes_alive": len(rt.control_plane.alive_nodes()),
        "nodes_total": len(rt.control_plane.all_nodes()),
        "actors_by_state": by_state,
        "cluster_resources": api.cluster_resources(),
        "available_resources": api.available_resources(),
        "utilization": utilization,
    }


# ---------------------------------------------------------------------------
# Metrics endpoint (per-node agent's /metrics in the reference)
# ---------------------------------------------------------------------------

_metrics_server = None


def start_metrics_server(host: str = "127.0.0.1", port: int = 0) -> int:
    """Serve the process metrics registry as Prometheus text. -> bound port."""
    global _metrics_server
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path not in ("/metrics", "/"):
                self.send_response(404)
                self.end_headers()
                return
            body = metrics_registry.render_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    _metrics_server = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=_metrics_server.serve_forever, daemon=True)
    t.start()
    return _metrics_server.server_address[1]


def stop_metrics_server() -> None:
    global _metrics_server
    if _metrics_server is not None:
        _metrics_server.shutdown()
        _metrics_server.server_close()
        _metrics_server = None
