"""Tenant accounting + weighted fair-share admission for the shared
ingest service (data/ingest.py).

Reference: tf.data service's fair-share dispatcher (arXiv:2210.14826) —
many jobs register datasets with one disaggregated CPU pool, and the
dispatcher divides pool throughput by configured job weights. The
scheduler here is classic deficit round-robin (Shreedhar & Varghese)
over per-tenant pending-block queues, measured in estimated output
BYTES: each admission round a visited tenant earns `quantum * weight`
byte credit, spends it dispatching blocks at its running-average block
cost, and forfeits the deficit when its queue drains — so a hog tenant
with thousands of pending blocks gets exactly its weight share while
any backlogged tenant is served every round (starvation-free by
construction). A per-tenant in-flight byte budget caps how much
dispatched-but-unconsumed output one tenant may park in the object
plane regardless of deficit.

The port's copy of ray_tpu/data/tenant.py.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..core.config import config
from ..core.metrics import Gauge

# default cost estimate for a block no tenant has completed yet: the
# scheduler needs SOME byte cost before the first completion lands
_WARMUP_BLOCK_BYTES = 1 << 20

_m_pending = Gauge(
    "ingest_pending_blocks",
    "Blocks queued (admitted registrations, not yet dispatched) per "
    "ingest tenant.")
_m_inflight = Gauge(
    "ingest_inflight_bytes",
    "Estimated bytes of dispatched-but-unconsumed ingest blocks per "
    "tenant (admission stops at the per-tenant budget).")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One ingest tenant: a named client with a fair-share weight and an
    in-flight byte budget (0 = the ingest_inflight_bytes knob)."""

    name: str
    weight: float = 0.0          # 0 = config ingest_default_weight
    max_in_flight_bytes: int = 0  # 0 = config ingest_inflight_bytes

    def resolved_weight(self) -> float:
        w = float(self.weight) if self.weight else float(
            config.get("ingest_default_weight"))
        return max(w, 1e-6)

    def budget_bytes(self) -> int:
        if self.max_in_flight_bytes:
            return int(self.max_in_flight_bytes)
        return int(config.get("ingest_inflight_bytes"))


class TenantState:
    """Mutable scheduler-side state of one tenant (owned by the
    FairShareScheduler's lock)."""

    def __init__(self, spec: TenantSpec):
        self.spec = spec
        self.deficit = 0.0
        self.pending: Deque[Any] = collections.deque()
        self.in_flight_bytes = 0
        self.in_flight = 0
        self.served_bytes = 0
        self.served_blocks = 0
        self._avg: Optional[float] = None

    # -- cost model ------------------------------------------------------

    def est_cost(self) -> float:
        return self._avg if self._avg else float(_WARMUP_BLOCK_BYTES)

    def observe_block(self, nbytes: int) -> None:
        """Fold one completed block's actual size into the running cost
        average (EWMA so a dataset switch re-converges quickly)."""
        if nbytes <= 0:
            return
        self._avg = (float(nbytes) if self._avg is None
                     else 0.8 * self._avg + 0.2 * float(nbytes))

    def over_budget(self) -> bool:
        return self.in_flight_bytes >= self.spec.budget_bytes()


class FairShareScheduler:
    """Deficit round-robin over tenant queues, one dispatch per `next()`.

    The admission loop calls `next()` while it has pool capacity; the
    cursor stays on a tenant while its deficit covers further blocks
    (classic DRR serves a queue until the deficit runs out, then moves
    on), and a full no-progress round returns None. All entry points are
    thread-safe: register/enqueue happen on client threads, next()/
    complete() on the admission loop.
    """

    def __init__(self, quantum_bytes: Optional[int] = None):
        self._lock = threading.Lock()
        self._tenants: Dict[str, TenantState] = {}
        self._order: List[str] = []
        self._cursor = 0
        self._fresh_visit = True  # quantum granted once per visit
        self._quantum = quantum_bytes

    # -- membership ------------------------------------------------------

    def ensure_tenant(self, spec: TenantSpec) -> TenantState:
        with self._lock:
            st = self._tenants.get(spec.name)
            if st is None:
                st = TenantState(spec)
                self._tenants[spec.name] = st
                self._order.append(spec.name)
            elif spec.weight or spec.max_in_flight_bytes:
                # re-registration may update weight/budget live
                st.spec = dataclasses.replace(
                    st.spec,
                    weight=spec.weight or st.spec.weight,
                    max_in_flight_bytes=(spec.max_in_flight_bytes
                                         or st.spec.max_in_flight_bytes))
            return st

    def drop_tenant(self, name: str) -> None:
        with self._lock:
            if name in self._tenants:
                del self._tenants[name]
                idx = self._order.index(name)
                self._order.remove(name)
                if idx < self._cursor:
                    self._cursor -= 1
                if self._order:
                    self._cursor %= len(self._order)
                else:
                    self._cursor = 0
        _m_pending.set(0.0, tags={"tenant": name})
        _m_inflight.set(0.0, tags={"tenant": name})

    def tenants(self) -> Dict[str, TenantState]:
        with self._lock:
            return dict(self._tenants)

    # -- queueing --------------------------------------------------------

    def enqueue(self, tenant: str, item: Any) -> None:
        with self._lock:
            st = self._tenants[tenant]
            st.pending.append(item)
            _m_pending.set(float(len(st.pending)), tags={"tenant": tenant})

    def pending_total(self) -> int:
        with self._lock:
            return sum(len(st.pending) for st in self._tenants.values())

    def in_flight_total(self) -> int:
        with self._lock:
            return sum(st.in_flight for st in self._tenants.values())

    # -- DRR core --------------------------------------------------------

    def _quantum_bytes(self) -> float:
        if self._quantum:
            return float(self._quantum)
        return float(config.get("ingest_quantum_bytes"))

    def next(self) -> Optional[Tuple[str, Any, int]]:
        """One DRR dispatch decision: (tenant, queued item, charged byte
        estimate — hand it back to complete()), or None when no tenant is
        admissible (all queues empty, over budget, or out of deficit for
        this round — the NEXT call starts a fresh round)."""
        with self._lock:
            n = len(self._order)
            if n == 0:
                return None
            visited = 0
            while visited <= n:
                name = self._order[self._cursor]
                st = self._tenants[name]
                if not st.pending:
                    st.deficit = 0.0  # empty queue forfeits its credit
                    self._advance()
                    visited += 1
                    continue
                if st.over_budget():
                    # keep the accumulated deficit: the tenant is backlogged,
                    # only its consumer is slow — it resumes at full credit
                    self._advance()
                    visited += 1
                    continue
                if self._fresh_visit:
                    st.deficit += self._quantum_bytes() * st.spec.resolved_weight()
                    self._fresh_visit = False
                cost = st.est_cost()
                if st._avg is None:
                    # before any completion lands, never price a block
                    # above one quantum — a conservative warmup estimate
                    # must not stall the first dispatches for many rounds
                    cost = min(cost, self._quantum_bytes())
                if st.deficit < cost:
                    self._advance()
                    visited += 1
                    continue
                item = st.pending.popleft()
                st.deficit -= cost
                st.in_flight += 1
                st.in_flight_bytes += int(cost)
                _m_pending.set(float(len(st.pending)), tags={"tenant": name})
                _m_inflight.set(float(st.in_flight_bytes),
                                tags={"tenant": name})
                return name, item, int(cost)
            return None

    def _advance(self) -> None:
        self._cursor = (self._cursor + 1) % max(len(self._order), 1)
        self._fresh_visit = True

    def cancel(self, tenant: str, charged: int) -> None:
        """A dispatch decision was abandoned (registration dropped, block
        already cached, or the task errored): release the in-flight charge
        WITHOUT crediting served bytes — cancelled work must not count
        toward the tenant's fair share."""
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return
            st.in_flight = max(0, st.in_flight - 1)
            st.in_flight_bytes = max(0, st.in_flight_bytes - int(charged))
            _m_inflight.set(float(st.in_flight_bytes), tags={"tenant": tenant})

    def complete(self, tenant: str, nbytes: Optional[int],
                 charged: int) -> None:
        """One dispatched block finished: release exactly the in-flight
        charge taken at dispatch and account actual served bytes."""
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return
            st.in_flight = max(0, st.in_flight - 1)
            st.in_flight_bytes = max(0, st.in_flight_bytes - int(charged))
            actual = int(nbytes) if nbytes else int(charged)
            st.served_bytes += actual
            st.served_blocks += 1
            st.observe_block(actual)
            _m_inflight.set(float(st.in_flight_bytes), tags={"tenant": tenant})

    # -- accounting ------------------------------------------------------

    def shares(self) -> Dict[str, Dict[str, float]]:
        """Cumulative served share vs configured weight share per tenant
        (the ledger row the fair-share proof reads)."""
        with self._lock:
            total_b = sum(st.served_bytes for st in self._tenants.values())
            total_w = sum(st.spec.resolved_weight()
                          for st in self._tenants.values())
            out = {}
            for name, st in self._tenants.items():
                share = st.served_bytes / total_b if total_b else 0.0
                target = st.spec.resolved_weight() / total_w if total_w else 0.0
                out[name] = {
                    "served_bytes": float(st.served_bytes),
                    "served_blocks": float(st.served_blocks),
                    "share": share,
                    "target": target,
                    "ratio": share / target if target else 0.0,
                }
            return out
