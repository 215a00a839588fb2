"""Client-side routing health: ReplicaHealth.

The port's copy of the routing half of ray_tpu/core/health.py
(`ReplicaHealth`, `:627-757`), which the serve router (serve/router.py)
stands on. The head-side `HealthPlane` (alert rules over federated
digests and metrics, the alert lifecycle) waits for ROADMAP A5c with the
rest of the control-plane tooling: creating or reaching one raises
NotImplementedError naming that item. Until then no plane exists, so
`get_health_plane(create=False)` returns None, as the reference's does
before one is created (the disagg coordinator asks that way).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..util import slo

__all__ = ["ReplicaHealth", "get_health_plane", "shutdown_health_plane"]

_A5C = ("the health plane (HealthPlane: alert rules, health scores, the "
        "alerts API) waits for ROADMAP A5c")


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


def get_health_plane(create: bool = True):
    """The process-wide HealthPlane: none exists before ROADMAP A5c, so
    create=False returns None and create=True raises naming that item."""
    if not create:
        return None
    raise NotImplementedError(f"get_health_plane: {_A5C}")


def shutdown_health_plane() -> None:
    raise NotImplementedError(f"shutdown_health_plane: {_A5C}")


def __getattr__(name: str):
    if name == "HealthPlane":
        raise NotImplementedError(f"HealthPlane: {_A5C}")
    raise AttributeError(name)
