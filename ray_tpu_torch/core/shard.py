"""Federated control plane: hash-sharded KV / directory / pubsub services.

The reference's aim ("make the head not the bottleneck and not the only
copy"), after the original Ray architecture (arXiv:1712.05889): the head keeps the
strongly-consistent tables it must own — node membership, the actor
directory, jobs, telemetry ingest — while the high-churn gossip planes
(cluster KV, object-location gossip, pubsub fan-out) shard across K
``ControlPlaneShard`` subprocesses with consistent key→shard routing
(`rpc.shard_for_key`). Each shard primary journals every mutation
(write-ahead JSONL, flushed per op) and snapshots on an interval using the
persistence idiom (atomic tmp+rename); a **warm standby** subprocess tails
the journal and is promoted onto the primary's port when the primary dies,
so a SIGKILL'd shard is a reconnect blip (the client's reconnect loop rides it out),
not an outage.

Pieces:
- ``ControlPlaneShard``      — the sharded state machine (KV + object
                               directory + pubsub) with journal/replay.
- ``StandbyControl``         — the standby's control surface: tails the
                               journal, ``promote(port)`` binds the dead
                               primary's port over the replica.
- ``ShardSupervisor``        — head-side: spawns primary+standby pairs,
                               detects primary death, drives promotion,
                               respawns standbys; chaos hooks for tests.
- ``FederatedControlPlane``  — in-process head wrapper installed by
                               ``enable_federation``: routes kv_* and
                               pubsub through the shards, everything else
                               to the inner ControlPlane. Opt-in via
                               ``config.control_plane_shards`` (0 = off,
                               the existing single-head path, untouched).

Worker-side routing lives in ``rpc.ShardedControlPlane``.

The port's copy of ray_tpu/core/shard.py. A shard process runs
``python -c _SHARD_BOOT`` rather than ``python -m``: ``-m`` would run the
package's ``__init__`` first, which imports torch and the model code, and
a shard needs only the control-plane modules (config, ids, logging,
metrics, wire, control_plane, rpc, shard), none of which imports torch.
``python -m ray_tpu_torch.core.shard`` still works, at torch's import
cost.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import cloudpickle

from .control_plane import (
    GOSSIP_NODE_PREFIXES,
    GOSSIP_RELAY_PREFIX,
    Pubsub,
    _is_gossip_key,
)
from .logging import get_logger
from .metrics import Counter, Gauge
from .rpc import (
    ControlPlaneServer,
    ControlPlaneUnavailable,
    RemoteControlPlane,
    shard_for_key,
)

logger = get_logger("shard")

SHARD_SNAPSHOT_VERSION = 1
# KV key where the head advertises the shard map to joining hosts
SHARD_MAP_KEY = "control_plane/shard_map"

_failovers_total = Counter(
    "control_plane_shard_failovers_total",
    "Shard primaries replaced by their warm standby after death",
)
_shard_health = Gauge(
    "control_plane_shard_health",
    "1 while the shard's primary is serving, 0 during failover",
)
_pubsub_dropped = Counter(
    "control_plane_pubsub_dropped_total",
    "Federated pubsub publishes dropped because the owning shard was "
    "unreachable past the publish deadline (best-effort during failover)",
)

# -- per-service RPC registries (idempotent ⊆ allowed, checked by tests) ----
# the shard's served surface: the gossip planes only — membership/actors/
# jobs/telemetry stay on the head
_SHARD_ALLOWED_METHODS: Set[str] = {
    "kv_put", "kv_get", "kv_del", "kv_keys",
    "dir_add_location", "dir_remove_location", "dir_locations",
    "publish", "subscribe",
    "shard_info", "sweep_gossip", "purge_node",
}

# everything the shard serves is safe to resend after an ambiguous
# connection loss: kv/dir ops are set-semantics, sweeps/purges are
# absorbing, and pubsub channels carry state-styled messages (a duplicate
# delivery is read as a repeated state announcement, never a double-apply)
_SHARD_IDEMPOTENT_METHODS: Set[str] = {
    "kv_put", "kv_get", "kv_del", "kv_keys",
    "dir_add_location", "dir_remove_location", "dir_locations",
    "publish", "subscribe",
    "shard_info", "sweep_gossip", "purge_node",
}

# the standby's control surface (supervisor-only)
_STANDBY_ALLOWED_METHODS: Set[str] = {
    "promote", "shard_info",
}

# promote is deliberately NOT idempotent: a resend after an ambiguous loss
# could double-bind; the supervisor handles the error and re-checks state
_STANDBY_IDEMPOTENT_METHODS: Set[str] = {
    "shard_info",
}


# -- journal ----------------------------------------------------------------
def _journal_encode(method: str, args: Tuple[Any, ...]) -> bytes:
    return base64.b64encode(cloudpickle.dumps((method, args))) + b"\n"


def _journal_decode(line: bytes) -> Tuple[str, Tuple[Any, ...]]:
    return cloudpickle.loads(base64.b64decode(line.strip()))


class ControlPlaneShard:
    """One shard of the federated gossip planes. Thread-safe; mutations are
    journaled (when a journal is attached) in apply order under the lock,
    so a tailing standby replays to an identical state."""

    def __init__(self, shard_id: int = 0, nshards: int = 1) -> None:
        self.shard_id = int(shard_id)
        self.nshards = int(nshards)
        self.role = "primary"
        self._lock = threading.RLock()
        self.pubsub = Pubsub()
        self._kv: Dict[str, Any] = {}
        self._kv_stamp: Dict[str, float] = {}
        self._dir: Dict[str, Set[str]] = {}
        self._journal = None  # append handle; set on the serving primary

    # -- journal / replay ---------------------------------------------------
    def attach_journal(self, handle) -> None:
        with self._lock:
            self._journal = handle

    def journal_offset(self) -> int:
        with self._lock:
            if self._journal is None:
                return 0
            self._journal.flush()
            return self._journal.tell()

    def _record(self, method: str, args: Tuple[Any, ...]) -> None:
        # caller holds self._lock: records land in apply order. flush (no
        # fsync) per op — a SIGKILL loses only unflushed = unacked ops,
        # which clients retry (every shard method is idempotent).
        if self._journal is not None:
            self._journal.write(_journal_encode(method, args))
            self._journal.flush()

    def apply(self, method: str, args: Tuple[Any, ...]) -> None:
        """Replay one journal record (standby tail / restart recovery)."""
        with self._lock:
            if method == "kv_put":
                key, value = args
                self._kv[key] = value
                if _is_gossip_key(key):
                    self._kv_stamp[key] = time.monotonic()
            elif method == "kv_del":
                (key,) = args
                self._kv.pop(key, None)
                self._kv_stamp.pop(key, None)
            elif method == "dir_add":
                oid_hex, node_hex = args
                self._dir.setdefault(oid_hex, set()).add(node_hex)
            elif method == "dir_rm":
                oid_hex, node_hex = args
                locs = self._dir.get(oid_hex)
                if locs is not None:
                    locs.discard(node_hex)
                    if not locs:
                        del self._dir[oid_hex]
            elif method == "purge_node":
                (node_hex,) = args
                self._purge_locked(node_hex)
            elif method == "sweep":
                (keys,) = args
                for key in keys:
                    self._kv.pop(key, None)
                    self._kv_stamp.pop(key, None)
            else:
                logger.warning("unknown journal record %r skipped", method)

    # -- KV -----------------------------------------------------------------
    def kv_put(self, key: str, value: Any, overwrite: bool = True) -> bool:
        with self._lock:
            if not overwrite and key in self._kv:
                return False
            self._kv[key] = value
            if _is_gossip_key(key):
                self._kv_stamp[key] = time.monotonic()
            self._record("kv_put", (key, value))
            return True

    def kv_get(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._kv.get(key)

    def kv_del(self, key: str) -> bool:
        with self._lock:
            self._kv_stamp.pop(key, None)
            hit = self._kv.pop(key, None) is not None
            if hit:
                self._record("kv_del", (key,))
            return hit

    def kv_keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return [k for k in self._kv if k.startswith(prefix)]

    # -- object-location gossip --------------------------------------------
    def dir_add_location(self, oid_hex: str, node_hex: str,
                         bytes_available: Optional[int] = None) -> bool:
        # bytes_available accepted for wire compatibility with the head's
        # directory surface; the shard tracks membership only
        with self._lock:
            self._dir.setdefault(oid_hex, set()).add(node_hex)
            self._record("dir_add", (oid_hex, node_hex))
            return True

    def dir_remove_location(self, oid_hex: str, node_hex: str) -> bool:
        with self._lock:
            locs = self._dir.get(oid_hex)
            if locs is None:
                return True
            locs.discard(node_hex)
            if not locs:
                del self._dir[oid_hex]
            self._record("dir_rm", (oid_hex, node_hex))
            return True

    def dir_locations(self, oid_hex: str) -> List[str]:
        with self._lock:
            return sorted(self._dir.get(oid_hex, ()))

    # -- pubsub (ephemeral: never journaled) --------------------------------
    def publish(self, channel: str, message: Any) -> bool:
        self.pubsub.publish(channel, message)
        return True

    # -- hygiene ------------------------------------------------------------
    def _purge_locked(self, node_hex: str) -> None:
        for prefix in GOSSIP_NODE_PREFIXES:
            self._kv.pop(prefix + node_hex, None)
            self._kv_stamp.pop(prefix + node_hex, None)
        for key in [k for k in self._kv if k.startswith(GOSSIP_RELAY_PREFIX)]:
            val = self._kv.get(key)
            if isinstance(val, str) and val.rsplit("|", 1)[-1] == node_hex:
                self._kv.pop(key, None)
                self._kv_stamp.pop(key, None)
        for oid_hex in [o for o, locs in self._dir.items() if node_hex in locs]:
            locs = self._dir[oid_hex]
            locs.discard(node_hex)
            if not locs:
                del self._dir[oid_hex]

    def purge_node(self, node_hex: str) -> bool:
        """mark_node_dead fan-out: drop the dead node's gossip + locations."""
        with self._lock:
            self._purge_locked(node_hex)
            self._record("purge_node", (node_hex,))
            return True

    def sweep_gossip(self, alive_hexes: List[str],
                     ttl_s: Optional[float] = None) -> int:
        """TTL sweep, head-driven: the head owns liveness, so it ships the
        alive set. Swept keys journal as explicit deletions ("sweep") —
        the standby's write stamps differ from the primary's, so replicas
        must never re-derive the sweep decision."""
        if ttl_s is None:
            from .config import config

            ttl_s = float(config.control_plane_gossip_ttl_s)
        horizon = time.monotonic() - float(ttl_s)
        alive = set(alive_hexes)
        with self._lock:
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
                if self._kv_stamp.get(key, horizon - 1.0) <= horizon:
                    doomed.append(key)
            for key in doomed:
                self._kv.pop(key, None)
                self._kv_stamp.pop(key, None)
            if doomed:
                self._record("sweep", (doomed,))
        return len(doomed)

    # -- introspection / persistence ---------------------------------------
    def shard_info(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "shard_id": self.shard_id,
                "nshards": self.nshards,
                "role": self.role,
                "kv_len": len(self._kv),
                "dir_len": len(self._dir),
                "pid": os.getpid(),
            }

    def snapshot_state(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "version": SHARD_SNAPSHOT_VERSION,
                "shard_id": self.shard_id,
                "nshards": self.nshards,
                "time": time.time(),
                "kv": dict(self._kv),
                "dir": {k: sorted(v) for k, v in self._dir.items()},
            }

    def restore_state(self, snap: Dict[str, Any]) -> None:
        if snap.get("version") != SHARD_SNAPSHOT_VERSION:
            raise ValueError(
                f"shard snapshot version {snap.get('version')} "
                f"!= {SHARD_SNAPSHOT_VERSION}")
        with self._lock:
            self._kv = dict(snap.get("kv", {}))
            self._kv_stamp = {}  # stamps are per-process; sweeps are journaled
            self._dir = {k: set(v) for k, v in snap.get("dir", {}).items()}


def write_shard_snapshot(shard: ControlPlaneShard, path: str) -> None:
    """Atomic tmp+rename (persistence.write_snapshot idiom). The journal
    byte offset is captured under the shard lock so snapshot + tail-from-
    offset reconstructs the exact primary state."""
    with shard._lock:
        state = shard.snapshot_state()
        state["journal_offset"] = shard.journal_offset()
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(cloudpickle.dumps(state))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_shard_snapshot(path: str) -> Optional[Dict[str, Any]]:
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return cloudpickle.loads(f.read())


def replay_journal(shard: ControlPlaneShard, path: str, offset: int = 0) -> int:
    """Apply journal records from ``offset`` to EOF (restart recovery).
    Returns the byte offset after the last complete record."""
    if not os.path.exists(path):
        return offset
    with open(path, "rb") as f:
        f.seek(offset)
        while True:
            pos = f.tell()
            line = f.readline()
            if not line or not line.endswith(b"\n"):
                return pos  # EOF or torn tail (unflushed ⇒ unacked)
            method, args = _journal_decode(line)
            shard.apply(method, args)


class _JournalTailer:
    """Standby-side: follows the primary's journal, applying each record."""

    def __init__(self, shard: ControlPlaneShard, path: str, offset: int = 0):
        self._shard = shard
        self._path = path
        self._offset = offset
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="shard-tail")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._offset = replay_journal(self._shard, self._path, self._offset)
            self._stop.wait(0.05)

    def stop_and_drain(self) -> int:
        """Stop tailing, then replay any remaining records to EOF. Returns
        the final offset — promotion appends from exactly here."""
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._offset = replay_journal(self._shard, self._path, self._offset)
        return self._offset


class _SnapshotLoop:
    """Primary-side interval snapshotter (persistence.SnapshotWriter idiom,
    but for one shard's state + journal offset)."""

    def __init__(self, shard: ControlPlaneShard, path: str, interval_s: float):
        self._shard = shard
        self._path = path
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="shard-snapshot")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                write_shard_snapshot(self._shard, self._path)
            except Exception:
                logger.warning("shard snapshot failed", exc_info=True)

    def stop(self) -> None:
        self._stop.set()


class StandbyControl:
    """The standby subprocess's supervisor-facing surface. ``promote(port)``
    turns the tailing replica into the serving primary on the dead
    primary's port; clients' reconnect loops find the new listener at the
    same address and ride through."""

    def __init__(self, shard: ControlPlaneShard, journal_path: str,
                 snapshot_path: str, tailer: _JournalTailer,
                 host: str = "127.0.0.1"):
        self.pubsub = Pubsub()  # handler contract: every served object has one
        self._shard = shard
        self._journal_path = journal_path
        self._snapshot_path = snapshot_path
        self._tailer = tailer
        self._host = host
        self._server: Optional[ControlPlaneServer] = None
        self._snapshots: Optional[_SnapshotLoop] = None

    def shard_info(self) -> Dict[str, Any]:
        return self._shard.shard_info()

    def promote(self, port: int) -> bool:
        from .config import config

        self._tailer.stop_and_drain()
        self._shard.attach_journal(open(self._journal_path, "ab"))
        self._shard.role = "primary"
        # the dead primary's listening socket closed with it; TIME_WAIT on
        # established conns doesn't block a SO_REUSEADDR listen, so the
        # retry loop only covers the kill/bind race
        last: Optional[Exception] = None
        for _ in range(40):
            try:
                self._server = ControlPlaneServer(
                    self._shard, host=self._host, port=int(port),
                    allowed_methods=_SHARD_ALLOWED_METHODS)
                break
            except OSError as exc:
                last = exc
                time.sleep(0.05)
        else:
            raise RuntimeError(f"promote: could not bind port {port}: {last}")
        self._snapshots = _SnapshotLoop(
            self._shard, self._snapshot_path,
            float(config.control_plane_snapshot_interval_s))
        logger.info("shard %d standby promoted on port %d",
                    self._shard.shard_id, port)
        return True


# -- subprocess entry -------------------------------------------------------
def _watch_parent(parent_pid: int) -> None:
    def loop() -> None:
        while True:
            try:
                os.kill(parent_pid, 0)
            except OSError:
                os._exit(0)  # orphaned shard must not outlive its runtime
            time.sleep(1.0)

    threading.Thread(target=loop, daemon=True, name="parent-watch").start()


# the shard process's entry: ray_tpu_torch stands in sys.modules as a bare
# namespace over its directory, so importing ray_tpu_torch.core.shard runs
# core/__init__ (a docstring) and the control-plane modules, not the
# package's __init__ (torch, models, serving)
_SHARD_BOOT = (
    "import sys, types; "
    "pkg = types.ModuleType('ray_tpu_torch'); pkg.__path__ = [sys.argv[1]]; "
    "sys.modules['ray_tpu_torch'] = pkg; "
    "from ray_tpu_torch.core.shard import main; "
    "sys.exit(main(sys.argv[2:]))"
)


def _shard_paths(data_dir: str, shard_id: int) -> Tuple[str, str]:
    return (os.path.join(data_dir, f"shard-{shard_id}.journal"),
            os.path.join(data_dir, f"shard-{shard_id}.snap"))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="control-plane shard service")
    parser.add_argument("--shard-id", type=int, required=True)
    parser.add_argument("--nshards", type=int, required=True)
    parser.add_argument("--role", choices=("primary", "standby"),
                        default="primary")
    parser.add_argument("--port", type=int, default=0,
                        help="primary serve port (0 = ephemeral)")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--parent-pid", type=int, default=0)
    args = parser.parse_args(argv)

    from .config import config

    if args.parent_pid:
        _watch_parent(args.parent_pid)
    journal_path, snapshot_path = _shard_paths(args.data_dir, args.shard_id)
    shard = ControlPlaneShard(args.shard_id, args.nshards)
    snap = load_shard_snapshot(snapshot_path)
    offset = 0
    if snap is not None:
        shard.restore_state(snap)
        offset = int(snap.get("journal_offset", 0))

    if args.role == "primary":
        offset = replay_journal(shard, journal_path, offset)
        os.makedirs(args.data_dir, exist_ok=True)
        handle = open(journal_path, "ab")
        if handle.tell() > offset:
            # torn tail from a previous primary's death: unacked bytes —
            # truncate so the journal holds exactly the applied history
            handle.truncate(offset)
            handle.seek(offset)
        shard.attach_journal(handle)
        server = ControlPlaneServer(
            shard, host=args.host, port=args.port,
            allowed_methods=_SHARD_ALLOWED_METHODS)
        _SnapshotLoop(shard, snapshot_path,
                      float(config.control_plane_snapshot_interval_s))
        print(f"SHARD-READY {server.server_address[1]}", flush=True)
    else:
        shard.role = "standby"
        tailer = _JournalTailer(shard, journal_path, offset)
        ctl = StandbyControl(shard, journal_path, snapshot_path, tailer,
                             host=args.host)
        server = ControlPlaneServer(
            ctl, host=args.host, port=0,
            allowed_methods=_STANDBY_ALLOWED_METHODS)
        print(f"SHARD-STANDBY-READY {server.server_address[1]}", flush=True)

    while True:  # serve until killed (or the parent watchdog exits us)
        time.sleep(3600)


# -- head-side supervisor ---------------------------------------------------
class _ShardSlot:
    def __init__(self, shard_id: int) -> None:
        self.shard_id = shard_id
        self.port = 0  # the shard's stable advertised port
        self.primary: Optional[subprocess.Popen] = None
        self.standby: Optional[subprocess.Popen] = None
        self.ctl: Optional[RemoteControlPlane] = None  # standby control conn


class ShardSupervisor:
    """Spawns and babysits K primary+standby shard pairs. Failover: poll
    detects a dead primary, the standby is promoted onto the same port,
    and a fresh standby is respawned behind the new primary."""

    def __init__(self, nshards: int, data_dir: Optional[str] = None,
                 host: str = "127.0.0.1", spawn_standby: bool = True,
                 poll_period_s: float = 0.1):
        self.nshards = int(nshards)
        self.data_dir = data_dir or tempfile.mkdtemp(prefix="ray_tpu_torch_shards_")
        self.host = host
        self.spawn_standby = spawn_standby
        self.failovers: List[Dict[str, float]] = []
        self._poll_period = poll_period_s
        self._slots = [_ShardSlot(i) for i in range(self.nshards)]
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._monitor: Optional[threading.Thread] = None

    # -- process plumbing ---------------------------------------------------
    def _spawn(self, shard_id: int, role: str, port: int = 0,
               timeout_s: float = 60.0) -> Tuple[subprocess.Popen, int]:
        # the package directory rides argv: the child finds the package
        # even when the parent loaded it from an uninstalled checkout via
        # sys.path (driver scripts, REPLs)
        pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        cmd = [sys.executable, "-c", _SHARD_BOOT, pkg_dir,
               "--shard-id", str(shard_id), "--nshards", str(self.nshards),
               "--role", role, "--port", str(port),
               "--data-dir", self.data_dir, "--host", self.host,
               "--parent-pid", str(os.getpid())]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
        marker = ("SHARD-READY" if role == "primary"
                  else "SHARD-STANDBY-READY")
        result: List[int] = []

        def read_ready() -> None:
            for raw in proc.stdout:
                line = raw.decode("utf-8", "replace").strip()
                if line.startswith(marker):
                    result.append(int(line.split()[-1]))
                    break

        reader = threading.Thread(target=read_ready, daemon=True)
        reader.start()
        reader.join(timeout=timeout_s)
        if not result:
            proc.kill()
            proc.wait()
            raise RuntimeError(
                f"shard {shard_id} {role} did not come ready in {timeout_s}s")
        # drain the rest of stdout so the child never blocks on a full pipe
        threading.Thread(target=proc.stdout.read, daemon=True).start()
        return proc, result[0]

    def _spawn_standby(self, slot: _ShardSlot) -> None:
        proc, ctl_port = self._spawn(slot.shard_id, "standby")
        slot.standby = proc
        slot.ctl = RemoteControlPlane(
            f"{self.host}:{ctl_port}", role=f"standby-ctl{slot.shard_id}",
            allowed=_STANDBY_ALLOWED_METHODS,
            idempotent=_STANDBY_IDEMPOTENT_METHODS)

    def start(self) -> List[str]:
        for slot in self._slots:
            slot.primary, slot.port = self._spawn(slot.shard_id, "primary")
            _shard_health.set(1.0, {"shard": str(slot.shard_id)})
            if self.spawn_standby:
                self._spawn_standby(slot)
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="shard-supervisor")
        self._monitor.start()
        return self.addresses

    @property
    def addresses(self) -> List[str]:
        return [f"{self.host}:{slot.port}" for slot in self._slots]

    def shard_map(self) -> bytes:
        return json.dumps({"nshards": self.nshards,
                           "addresses": self.addresses}).encode()

    # -- failover -----------------------------------------------------------
    def _monitor_loop(self) -> None:
        while not self._stop.wait(self._poll_period):
            for slot in self._slots:
                proc = slot.primary
                if proc is not None and proc.poll() is not None:
                    try:
                        self._failover(slot)
                    except Exception:
                        logger.exception("shard %d failover failed",
                                         slot.shard_id)

    def _failover(self, slot: _ShardSlot) -> None:
        detected = time.monotonic()
        _shard_health.set(0.0, {"shard": str(slot.shard_id)})
        logger.warning("shard %d primary died (pid %s); promoting standby",
                       slot.shard_id, slot.primary.pid)
        if slot.standby is None or slot.ctl is None:
            raise RuntimeError(f"shard {slot.shard_id} has no standby")
        slot.ctl._call("promote", slot.port, _deadline_s=30.0)
        promoted = time.monotonic()
        with self._lock:
            slot.primary, slot.standby = slot.standby, None
            ctl, slot.ctl = slot.ctl, None
            self.failovers.append({
                "shard_id": slot.shard_id,
                "detected_at": detected,
                "promoted_at": promoted,
                "promote_s": promoted - detected,
            })
        ctl.close()
        _failovers_total.inc()
        _shard_health.set(1.0, {"shard": str(slot.shard_id)})
        if self.spawn_standby:
            self._spawn_standby(slot)  # restore the warm spare

    # -- chaos hooks --------------------------------------------------------
    def kill_primary(self, shard_id: int) -> int:
        """SIGKILL a shard primary (tests/chaos). The monitor loop promotes
        the standby; returns the killed pid."""
        slot = self._slots[shard_id]
        pid = slot.primary.pid
        os.kill(pid, signal.SIGKILL)
        return pid

    def wait_healthy(self, timeout_s: float = 30.0) -> bool:
        """Block until every slot has a live primary (post-failover)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(s.primary is not None and s.primary.poll() is None
                   for s in self._slots):
                return True
            time.sleep(0.05)
        return False

    def stop(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        for slot in self._slots:
            if slot.ctl is not None:
                slot.ctl.close()
            for proc in (slot.primary, slot.standby):
                if proc is None or proc.poll() is not None:
                    continue
                proc.terminate()
        for slot in self._slots:
            for proc in (slot.primary, slot.standby):
                if proc is None:
                    continue
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()


# -- head-side federation wrapper -------------------------------------------
class FederatedPubsub:
    """Pubsub fan-out through the shards: a channel lives on the shard that
    owns its name, so subscribers anywhere in the fleet (head included)
    register with that shard and publishes route to it. Publish is
    best-effort during a failover window — the client deadline bounds the
    stall and drops count on ``control_plane_pubsub_dropped_total``."""

    def __init__(self, clients: List[RemoteControlPlane]):
        self._clients = clients

    def _client(self, channel: str) -> RemoteControlPlane:
        return self._clients[shard_for_key(channel, len(self._clients))]

    def subscribe(self, channel, callback):
        return self._client(channel).subscribe(channel, callback)

    def publish(self, channel, message) -> None:
        try:
            self._client(channel)._call(
                "publish", channel, message, _deadline_s=5.0)
        except (ControlPlaneUnavailable, OSError):
            _pubsub_dropped.inc()
            logger.warning("pubsub publish to %r dropped (shard unreachable)",
                           channel)


class FederatedControlPlane:
    """Head-side wrapper installed by ``enable_federation``: the inner
    ControlPlane keeps membership/actors/jobs/telemetry; cluster KV and
    pubsub route through the shards. K=1 is behavior-identical to the
    single-head path modulo the extra hop."""

    def __init__(self, inner, supervisor: ShardSupervisor,
                 connect_timeout: float = 10.0):
        self._inner = inner
        self._sup = supervisor
        self._clients = [
            RemoteControlPlane(
                addr, connect_timeout=connect_timeout, role=f"head-shard{i}",
                allowed=_SHARD_ALLOWED_METHODS,
                idempotent=_SHARD_IDEMPOTENT_METHODS)
            for i, addr in enumerate(supervisor.addresses)
        ]
        self.pubsub = FederatedPubsub(self._clients)
        # migrate subscribers registered on the inner bus before federation
        # came up, then swap the bus: every internal publish (node/actor
        # state changes) now fans out through the owning shard
        old = inner.pubsub
        with old._lock:
            existing = {ch: list(cbs) for ch, cbs in old._subs.items()}
        for channel, cbs in existing.items():
            for cb in cbs:
                self.pubsub.subscribe(channel, cb)
        inner.pubsub = self.pubsub

    # -- sharded planes -----------------------------------------------------
    def _shard(self, key: str) -> RemoteControlPlane:
        return self._clients[shard_for_key(key, len(self._clients))]

    def kv_put(self, key: str, value: Any, overwrite: bool = True) -> bool:
        return self._shard(key)._call("kv_put", key, value, overwrite)

    def kv_get(self, key: str) -> Optional[Any]:
        return self._shard(key)._call("kv_get", key)

    def kv_del(self, key: str) -> bool:
        return self._shard(key)._call("kv_del", key)

    def kv_keys(self, prefix: str = "") -> List[str]:
        out: List[str] = []
        for client in self._clients:
            out.extend(client._call("kv_keys", prefix))
        return out

    def mark_node_dead(self, node_id, reason: str = "") -> None:
        self._inner.mark_node_dead(node_id, reason)
        node_hex = node_id.hex()
        for client in self._clients:
            try:
                client._call("purge_node", node_hex, _deadline_s=5.0)
            except (ControlPlaneUnavailable, OSError):
                # the TTL sweep is the backstop for a purge that raced a
                # shard failover
                logger.warning("purge_node(%s) dropped on one shard",
                               node_hex[:8])

    def sweep_gossip(self, ttl_s: Optional[float] = None) -> int:
        swept = self._inner.sweep_gossip(ttl_s)
        alive = [n.node_id.hex() for n in self._inner.alive_nodes()]
        for client in self._clients:
            try:
                swept += int(client._call(
                    "sweep_gossip", alive, ttl_s, _deadline_s=10.0))
            except (ControlPlaneUnavailable, OSError):
                pass  # next sweep retries
        return swept

    def shard_infos(self) -> List[Dict[str, Any]]:
        infos = []
        for client in self._clients:
            try:
                infos.append(client._call("shard_info", _deadline_s=5.0))
            except (ControlPlaneUnavailable, OSError):
                infos.append(None)
        return infos

    def close(self) -> None:
        for client in self._clients:
            client.close()

    def __getattr__(self, name: str):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)


def enable_federation(runtime, nshards: Optional[int] = None,
                      data_dir: Optional[str] = None):
    """Shard the runtime's control plane (api.init hook, opt-in via
    ``config.control_plane_shards``). Returns the (supervisor, federated
    plane) pair, also stashed on ``runtime._federation`` for shutdown."""
    from .config import config

    nshards = int(nshards if nshards is not None
                  else config.control_plane_shards)
    if nshards <= 0:
        return None
    data_dir = data_dir or str(config.control_plane_shard_dir) or None
    sup = ShardSupervisor(nshards, data_dir=data_dir)
    sup.start()
    fed = FederatedControlPlane(runtime.control_plane, sup)
    runtime.control_plane = fed
    # advertise the shard map so joining hosts route directly
    # (rpc.ShardedControlPlane); the key itself lives on its owning shard
    fed.kv_put(SHARD_MAP_KEY, sup.shard_map())
    runtime._federation = (sup, fed)
    logger.info("control plane federated across %d shard(s): %s",
                nshards, sup.addresses)
    return sup, fed


def stop_federation(runtime) -> None:
    fed_pair = getattr(runtime, "_federation", None)
    if not fed_pair:
        return
    sup, fed = fed_pair
    runtime._federation = None
    fed.close()
    sup.stop()


if __name__ == "__main__":
    sys.exit(main())
