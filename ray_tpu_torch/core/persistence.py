"""Control-plane snapshot/restore: crash-survivable cluster state.

Reference analogue: GCS persistence via Redis
(`src/ray/gcs/store_client/redis_store_client.cc` +
`gcs_table_storage.cc`) — the reference journals every table mutation to an
external store so a restarted GCS rebuilds its tables. TPU-native design
choice: a single-host runtime has no external store to lean on, so the
control plane snapshots its tables to a local file on an interval
(atomic tmp+rename), and ``ray_tpu_torch.init(resume_from=...)`` rebuilds
from the latest snapshot.

The port's copy of ray_tpu/core/persistence.py. A named GPU actor comes
back on the card: its creation spec holds its class and arguments (a
config, never a tensor on the card), and the restored instance builds its
state anew.

What restores, and why:
- **KV**: fully restored — it is the cluster's durable metadata plane
  (checkpoint paths, serve configs, function table).
- **Jobs**: table restored; jobs that were RUNNING are marked FAILED with
  a runtime-death cause (their processes are gone).
- **Named actors**: re-created from their pickled creation specs
  (class, args, options). Named = reachable by ``get_actor``, the proxy
  for the reference's detached actors; anonymous actors' handles died
  with the driver, so re-creating them would leak unreachable actors.
  Placement-group scheduling strategies are stripped on restore (PGs are
  ephemeral to their creating driver, as upstream non-detached PGs are).
- **Nodes / placement groups / object directory**: snapshotted for
  forensics (`snapshot["nodes"]`, ...), not restored — nodes are
  process-local constructs that re-register on init, PGs die with their
  driver, and objects live in process memory (lineage reconstruction is
  the recovery path for those, not persistence).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

import cloudpickle

from .config import config
from .logging import get_logger
from .metrics import Counter, Gauge

logger = get_logger("persistence")

SNAPSHOT_VERSION = 1

# A silently-failing snapshot loop is a durability hole that only shows up
# when the head dies: make it alertable instead of a log line.
_snapshot_age = Gauge(
    "control_plane_snapshot_age_seconds",
    "Seconds since the last successful control-plane snapshot write",
)
_snapshot_failures = Counter(
    "control_plane_snapshot_failures_total",
    "Control-plane snapshot write attempts that raised",
)


def take_snapshot(runtime) -> Dict[str, Any]:
    """Capture the control plane's tables. Each table read is atomic;
    cross-table consistency is best-effort (matching the reference's
    per-table Redis writes, which are not transactional across tables)."""
    cp = runtime.control_plane
    named = {}
    with runtime._lock:
        specs = dict(runtime._actor_specs)
    for name, actor_id in list(cp._named_actors.items()):
        info = cp.get_actor(actor_id)
        spec = specs.get(actor_id)
        if info is None or spec is None:
            continue
        try:
            payload = cloudpickle.dumps(
                (spec.func, spec.args, spec.kwargs, spec.options)
            )
        except Exception:
            logger.debug("actor %r not snapshottable (unpicklable spec)", name)
            continue
        named[name] = {
            "payload": payload,
            "class_name": info.class_name,
            "max_restarts": info.max_restarts,
        }
    return {
        "version": SNAPSHOT_VERSION,
        "time": time.time(),
        "kv": dict(cp._kv),
        "jobs": {jid.hex(): dict(meta) for jid, meta in cp.list_jobs().items()},
        "named_actors": named,
        "nodes": [
            {
                "node_id": n.node_id.hex(),
                "resources": dict(n.resources_total),
                "state": n.state.value,
                "labels": dict(n.labels),
            }
            for n in cp.all_nodes()
        ],
        "placement_groups": [
            {"id": pid.hex(), "repr": repr(pg)}
            for pid, pg in list(cp._placement_groups.items())
        ],
        "objects": [oid.hex() for oid in list(runtime.directory._locations)],
    }


def write_snapshot(runtime, path: str) -> None:
    """Atomic snapshot write: tmp + rename, so a crash mid-write leaves the
    previous snapshot intact."""
    snap = take_snapshot(runtime)
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(cloudpickle.dumps(snap))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_snapshot(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        snap = cloudpickle.loads(f.read())
    if snap.get("version") != SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot version {snap.get('version')} != {SNAPSHOT_VERSION}"
        )
    return snap


def restore_into(runtime, snap: Dict[str, Any]) -> Dict[str, int]:
    """Rebuild restorable state into a fresh runtime (see module docstring
    for the restore policy). Returns counts per restored table."""
    from .ids import JobID

    cp = runtime.control_plane
    for key, value in snap.get("kv", {}).items():
        cp.kv_put(key, value, overwrite=False)
    n_jobs = 0
    for jid_hex, meta in snap.get("jobs", {}).items():
        meta = dict(meta)
        if meta.get("state") == "RUNNING":
            meta["state"] = "FAILED"
            meta["death_cause"] = "runtime died (restored from snapshot)"
        try:
            cp._jobs[JobID(bytes.fromhex(jid_hex))] = meta
            n_jobs += 1
        except Exception:
            logger.debug("job %s not restorable", jid_hex)
    n_actors = 0
    for name, entry in snap.get("named_actors", {}).items():
        try:
            cls, args, kwargs, options = cloudpickle.loads(entry["payload"])
            from .task_spec import (
                PlacementGroupSchedulingStrategy,
                SchedulingStrategy,
            )

            if isinstance(
                getattr(options, "scheduling_strategy", None),
                PlacementGroupSchedulingStrategy,
            ):
                # PGs are ephemeral to their creating driver (upstream
                # non-detached semantics): strip only the PG constraint —
                # Spread/NodeAffinity strategies restore as-is
                import dataclasses as _dc

                options = _dc.replace(
                    options, scheduling_strategy=SchedulingStrategy()
                )
            runtime.create_actor(cls, args, kwargs, options)
            n_actors += 1
        except Exception:
            logger.warning("named actor %r failed to restore", name, exc_info=True)
    counts = {
        "kv": len(snap.get("kv", {})),
        "jobs": n_jobs,
        "named_actors": n_actors,
    }
    logger.info(
        "restored control plane from snapshot (t=%s): %s",
        time.strftime("%H:%M:%S", time.localtime(snap.get("time", 0))),
        counts,
    )
    return counts


class SnapshotWriter:
    """Background snapshotter: writes every interval and once at stop()."""

    def __init__(self, runtime, path: str, interval_s: Optional[float] = None):
        self._rt = runtime
        self._path = path
        self._interval = (
            interval_s
            if interval_s is not None
            else config.control_plane_snapshot_interval_s
        )
        self._stop = threading.Event()
        self._write_lock = threading.Lock()
        self._last_ok = time.monotonic()  # age counts from writer birth
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="cp-snapshot"
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self._write()

    def _write(self) -> None:
        with self._write_lock:  # interval vs final write share a tmp path
            try:
                write_snapshot(self._rt, self._path)
                self._last_ok = time.monotonic()
                _snapshot_age.set(0.0)
            except Exception:
                logger.warning("control-plane snapshot failed", exc_info=True)
                _snapshot_failures.inc()
                _snapshot_age.set(time.monotonic() - self._last_ok)

    def stop(self, final_write: bool = True) -> None:
        """Stop the interval loop (joining any in-flight write) and take one
        last snapshot so shutdown state is durable."""
        self._stop.set()
        self._thread.join(timeout=10.0)
        if final_write:
            self._write()
