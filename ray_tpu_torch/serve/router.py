"""Request router: power-of-two-choices replica scheduling.

Reference: `python/ray/serve/_private/replica_scheduler/pow_2_scheduler.py
:: PowerOfTwoChoicesReplicaScheduler`. The router samples two replicas,
compares tracked in-flight counts (local optimistic counts reconciled
against completed refs), and sends to the shorter queue — O(1) balancing
with near-optimal tail latency.

The port's copy of ray_tpu/serve/router.py; replica health comes from the
port's core/health.py.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Callable, Dict, List

from .. import api


def pow2_choice(n: int, load_fn: Callable[[int], int]) -> int:
    """Power-of-two-choices over n slots: sample two, take the shorter
    queue. Shared by Pow2Router.assign and the disagg coordinator's
    role-level replica pick."""
    if n <= 0:
        raise ValueError("pow2_choice needs at least one slot")
    if n == 1:
        return 0
    a, b = random.sample(range(n), 2)
    return a if load_fn(a) <= load_fn(b) else b


def pick_resident(candidates: List[Any], resident: List[Any],
                  load_fn: Callable[[Any], int]) -> Any:
    """Residency-preferring pick shared by multiplexed routing shapes
    (Pow2Router model affinity, disagg adapter routing): pow-2 among the
    candidates that already hold the artifact when any do, pow-2 over
    the full set otherwise — so residency wins without ever starving
    the request when nothing is warm."""
    pool = [c for c in candidates if c in resident] or list(candidates)
    return pool[pow2_choice(len(pool), lambda i: load_fn(pool[i]))]


def _replica_key(replica: Any) -> Any:
    """Stable identity for a replica across update_replicas calls.
    ActorHandles are re-created per controller sync, so object identity
    (and list position) go stale — the actor id does not."""
    key = getattr(replica, "_actor_id", None)
    return key if key is not None else id(replica)


class Pow2Router:
    def __init__(self, deployment_name: str):
        from ..core.health import ReplicaHealth

        self.deployment_name = deployment_name
        self._replicas: List[Any] = []  # ActorHandles
        self._inflight: Dict[int, List[Any]] = {}  # replica idx -> refs
        self._lock = threading.Lock()
        self._version = -1
        self._model_affinity: Dict[str, int] = {}  # model id -> replica idx
        # Health-aware weighting (core/health.py): callers feed observed
        # outcomes via note_result(); degraded replicas carry a load
        # penalty in the pow-2 comparison and quarantined ones drop out
        # of the candidate set until their probe window opens — the
        # router stops selecting a broken replica before the control
        # plane's heartbeat timeout marks its node DEAD.
        self.health = ReplicaHealth()

    def update_replicas(self, replicas: List[Any], version: int) -> None:
        with self._lock:
            if version <= self._version:
                return
            # Re-key the in-flight refs by replica identity: a version bump
            # that resizes the fleet must neither credit a surviving
            # replica's queue to whoever inherited its index nor zero it —
            # both skew the pow-2 comparison until the refs drain.
            old_inflight = {
                _replica_key(r): self._inflight.get(i, [])
                for i, r in enumerate(self._replicas)
            }
            old_keys = {i: _replica_key(r)
                        for i, r in enumerate(self._replicas)}
            self._replicas = list(replicas)
            new_index = {_replica_key(r): i for i, r in enumerate(replicas)}
            self._inflight = {
                i: old_inflight.get(_replica_key(r), [])
                for i, r in enumerate(replicas)
            }
            self._version = version
            # Affinity follows the resident replica; the pointer drops only
            # when that replica disappears on the version bump.
            self._model_affinity = {
                model: new_index[old_keys[idx]]
                for model, idx in self._model_affinity.items()
                if idx in old_keys and old_keys[idx] in new_index
            }

    def _load(self, idx: int) -> int:
        refs = self._inflight.get(idx, [])
        if refs:
            done, pending = api.wait(refs, num_returns=len(refs), timeout=0)
            self._inflight[idx] = pending
        return (len(self._inflight.get(idx, []))
                + self.health.penalty(_replica_key(self._replicas[idx])))

    def note_result(self, replica: Any, latency_s: float = None,
                    ok: bool = True) -> None:
        """Feed an observed request outcome back into replica health
        (called by whoever consumes the assigned ref — e.g. the serve
        handle layer or tests injecting latency)."""
        self.health.observe(_replica_key(replica), latency_s, ok=ok)

    def assign(self, method: str, args: tuple, kwargs: dict,
               multiplexed_model_id: str = ""):
        with self._lock:
            n = len(self._replicas)
            if n == 0:
                raise RuntimeError(
                    f"no replicas available for {self.deployment_name!r}"
                )
            idx = None
            if multiplexed_model_id:
                # model-affinity first (reference: multiplexed routing
                # prefers replicas with the model resident), unless that
                # replica is clearly the long queue
                cand = self._model_affinity.get(multiplexed_model_id)
                if cand is not None and cand < n:
                    others = [i for i in range(n) if i != cand]
                    probe = random.choice(others) if others else cand
                    if self._load(cand) <= self._load(probe) + 2:
                        idx = cand
            if idx is None:
                elig = self.health.eligible(
                    [_replica_key(r) for r in self._replicas])
                cand = [i for i in range(n)
                        if _replica_key(self._replicas[i]) in elig]
                if not cand:
                    cand = list(range(n))
                j = pow2_choice(len(cand), lambda i: self._load(cand[i]))
                idx = cand[j]
            if multiplexed_model_id:
                # Record affinity only for a first placement: a load-check
                # diversion must not abandon the replica that actually has
                # the model resident (ADVICE r3). The pointer moves only
                # when the resident replica disappears on a version bump.
                self._model_affinity.setdefault(multiplexed_model_id, idx)
            replica = self._replicas[idx]
            ref = replica.handle_request.remote(
                method, args, kwargs, multiplexed_model_id
            )
            self._inflight[idx].append(ref)
            return ref
