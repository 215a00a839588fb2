"""Placement groups: gang resource reservation across nodes.

Equivalent of the reference's placement groups (upstream ray
`python/ray/util/placement_group.py :: placement_group()`, GCS-side
`gcs_placement_group_manager.cc` / `gcs_placement_group_scheduler.cc` with
PACK/SPREAD/STRICT_PACK/STRICT_SPREAD bundle policies): bundles of resources
are reserved atomically on chosen nodes; tasks/actors scheduled with a
``PlacementGroupSchedulingStrategy`` consume from the bundle, not the node.

The reference's addition, kept by the port: a bundle may be a
``TopologyRequest`` — the group then reserves a contiguous sub-box via
``SubSlicePacker`` on a registered slice, expands into one bundle per host
owning the box's chips (each pinned to that host, its chips counted as
"GPU"), and exposes the allocation's torus coordinates so the gang can lay
its mesh axes along physical links. A topology request that
is feasible on some registered slice but currently blocked by other groups
QUEUES (``created=False``) and materializes when capacity frees.

The port's copy of ray_tpu/sched/placement_group.py.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..core import core_worker as _cw
from ..core.ids import NodeID, PlacementGroupID
from ..core.logging import get_logger
from ..core.node_agent import ResourceTracker
from ..core.task_spec import TopologyRequest
from .topology import SliceInfo

logger = get_logger("placement_group")

Bundle = Union[Dict[str, float], TopologyRequest]

# CPU attached to each expanded per-host topology bundle so the gang's
# worker actor (one per host) can be scheduled into it.
_TOPOLOGY_BUNDLE_CPU = 1.0


class PlacementGroupError(RuntimeError):
    pass


@dataclass
class TopologyAllocation:
    """A granted sub-box: which slice, where in the torus, and which of the
    group's bundles map to which hosts/chip-coordinates."""

    slice_id: object
    origin: Tuple[int, ...]
    shape: Tuple[int, ...]
    bundle_indices: List[int] = field(default_factory=list)
    # parallel to bundle_indices: chip coords owned by that bundle's host
    coords_per_bundle: List[List[Tuple[int, ...]]] = field(default_factory=list)
    _alloc_id: int = -1


@dataclass
class PlacementGroup:
    id: PlacementGroupID
    bundles: List[Dict[str, float]]
    strategy: str
    bundle_nodes: List[NodeID] = field(default_factory=list)
    created: bool = False
    # the original request (kept for queued materialization)
    request: List[Bundle] = field(default_factory=list)
    # ICI sub-box allocations backing TopologyRequest bundles
    topology_allocations: List[TopologyAllocation] = field(default_factory=list)
    # per-bundle usage trackers (tasks consume bundle capacity, not node)
    _bundle_trackers: List[ResourceTracker] = field(default_factory=list)

    def ready(self, timeout: Optional[float] = 30.0) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.created:
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True

    def bundle_node(self, index: int) -> NodeID:
        return self.bundle_nodes[index]

    def try_acquire(self, bundle_index: int, demand: Dict[str, float]) -> bool:
        if not self.created:
            return False
        return self._bundle_trackers[bundle_index].try_acquire(demand)

    def release(self, bundle_index: int, demand: Dict[str, float]) -> None:
        if 0 <= bundle_index < len(self._bundle_trackers):
            self._bundle_trackers[bundle_index].release(demand)


class PlacementGroupManager:
    """Reserves bundles on nodes and keeps the (pg, bundle) -> node table the
    cluster scheduler consults. Lives beside the Runtime (GCS role)."""

    def __init__(self, runtime) -> None:
        self._rt = runtime
        # One reentrant lock serializes create/materialize/remove/retry:
        # materialization touches node ledgers + packers + tables, and a
        # remove() racing a queued-group retry could otherwise resurrect a
        # just-removed group with permanently-leaked reservations.
        self._lock = threading.RLock()
        self._groups: Dict[PlacementGroupID, PlacementGroup] = {}
        # topology groups waiting for packer capacity, FIFO
        self._queued: List[PlacementGroup] = []

    def create(self, bundles: Sequence[Bundle], strategy: str = "PACK") -> PlacementGroup:
        if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
            raise ValueError(f"unknown placement strategy: {strategy}")
        if not bundles:
            raise ValueError("placement group needs at least one bundle")
        pg = PlacementGroup(
            PlacementGroupID.generate(), [], strategy, request=list(bundles)
        )
        with self._lock:
            if self._materialize(pg):
                return pg
            has_topology = any(isinstance(b, TopologyRequest) for b in bundles)
            if has_topology and self._topology_feasible(bundles):
                # blocked by current occupancy, not by cluster shape: queue
                # until another group releases chips.
                self._queued.append(pg)
                self._groups[pg.id] = pg
                logger.info(
                    "placement group %s queued (topology busy)", pg.id.hex()[:8]
                )
                return pg
        raise PlacementGroupError(
            f"cannot place {len(bundles)} bundles with strategy {strategy}: "
            + ("no registered slice fits the topology request"
               if has_topology else "insufficient cluster resources")
        )

    def remove(self, pg: PlacementGroup) -> None:
        with self._lock:
            stored = self._groups.pop(pg.id, None)
            if stored in self._queued:
                self._queued.remove(stored)
                stored.created = False
                return
            if stored is None:
                return
            for bundle, node_id in zip(stored.bundles, stored.bundle_nodes):
                agent = self._rt.agents.get(node_id)
                if agent is not None:
                    agent.resources.release(bundle)
            for alloc in stored.topology_allocations:
                info = self._rt.slices.get(alloc.slice_id)
                if info is not None:
                    info.packer.release(alloc._alloc_id)
            for i in range(len(stored.bundles)):
                self._rt.pg_table.pop((pg.id, i), None)
            stored.created = False
            self._retry_queued()

    def get(self, pg_id: PlacementGroupID) -> Optional[PlacementGroup]:
        with self._lock:
            return self._groups.get(pg_id)

    # -- materialization ----------------------------------------------------

    def _materialize(self, pg: PlacementGroup) -> bool:
        """Expand the request (allocating ICI sub-boxes), place, and acquire
        atomically. On any failure everything is rolled back and the pg is
        left un-created."""
        expanded: List[Dict[str, float]] = []
        pins: List[Optional[NodeID]] = []
        allocations: List[TopologyAllocation] = []

        def rollback_allocs() -> None:
            for alloc in allocations:
                info = self._rt.slices.get(alloc.slice_id)
                if info is not None:
                    info.packer.release(alloc._alloc_id)

        for b in pg.request:
            if isinstance(b, TopologyRequest):
                got = self._allocate_topology(b)
                if got is None:
                    rollback_allocs()
                    return False
                info, alloc_id, alloc = got
                topo_alloc = TopologyAllocation(
                    slice_id=info.slice_id,
                    origin=alloc.origin,
                    shape=alloc.shape,
                    _alloc_id=alloc_id,
                )
                host_coords: Dict[int, List[Tuple[int, ...]]] = {}
                for c in alloc.coords():
                    host_coords.setdefault(info.topology.host_of(c), []).append(c)
                for h in sorted(host_coords):
                    node_id = info.hosts.get(h)
                    if node_id is None:
                        rollback_allocs()
                        info.packer.release(alloc_id)
                        return False
                    topo_alloc.bundle_indices.append(len(expanded))
                    topo_alloc.coords_per_bundle.append(sorted(host_coords[h]))
                    expanded.append({
                        "GPU": float(len(host_coords[h])),
                        "CPU": _TOPOLOGY_BUNDLE_CPU,
                    })
                    pins.append(node_id)
                allocations.append(topo_alloc)
            else:
                expanded.append(dict(b))
                pins.append(None)

        placement = self._place_bundles(expanded, pins, pg.strategy)
        if placement is None:
            rollback_allocs()
            return False
        # acquire atomically: roll back on partial failure
        acquired: List[Tuple[NodeID, Dict[str, float]]] = []
        ok = True
        for bundle, node_id in zip(expanded, placement):
            agent = self._rt.agents.get(node_id)
            if agent is None or not agent.resources.try_acquire(bundle):
                ok = False
                break
            acquired.append((node_id, bundle))
        if not ok:
            for node_id, bundle in acquired:
                agent = self._rt.agents.get(node_id)
                if agent is not None:
                    agent.resources.release(bundle)
            rollback_allocs()
            return False
        pg.bundles = expanded
        pg.bundle_nodes = list(placement)
        pg.topology_allocations = allocations
        pg._bundle_trackers = [ResourceTracker(b) for b in expanded]
        pg.created = True
        with self._lock:
            self._groups[pg.id] = pg
        for i, node_id in enumerate(placement):
            self._rt.pg_table[(pg.id, i)] = node_id
        self._rt._kick_scheduler()
        logger.info(
            "placement group %s created: %s bundles via %s%s",
            pg.id.hex()[:8], len(expanded), pg.strategy,
            f" ({len(allocations)} ICI sub-box)" if allocations else "",
        )
        return True

    def _retry_queued(self) -> None:
        with self._lock:
            for pg in list(self._queued):
                if self._materialize(pg):
                    self._queued.remove(pg)
                    logger.info(
                        "queued placement group %s materialized", pg.id.hex()[:8]
                    )

    # -- topology allocation ------------------------------------------------

    def _allocate_topology(self, req: TopologyRequest):
        """Try every registered slice (fullest-first so small gangs don't
        fragment empty slices) for a contiguous sub-box."""
        slices: List[SliceInfo] = list(self._rt.slices.values())
        slices.sort(key=lambda s: s.packer.free_chips())
        for info in slices:
            try:
                got = info.packer.try_allocate(req.shape)
            except ValueError:  # rank impossible for this slice's torus
                continue
            if got is not None:
                alloc_id, alloc = got
                return info, alloc_id, alloc
        return None

    def _topology_feasible(self, bundles: Sequence[Bundle]) -> bool:
        return all(
            any(
                info.packer.could_ever_fit(b.shape)
                for info in self._rt.slices.values()
            )
            for b in bundles
            if isinstance(b, TopologyRequest)
        )

    # -- placement ----------------------------------------------------------
    def _place_bundles(
        self,
        bundles: List[Dict[str, float]],
        pins: List[Optional[NodeID]],
        strategy: str,
    ) -> Optional[List[NodeID]]:
        nodes = [n for n in self._rt.control_plane.alive_nodes()]
        if not nodes:
            return None
        # work over a copy of each node's available view for what-if packing
        avail: Dict[NodeID, Dict[str, float]] = {}
        for n in nodes:
            agent = self._rt.agents.get(n.node_id)
            avail[n.node_id] = agent.resources.available() if agent else dict(n.resources_available)

        def fits(node_id: NodeID, bundle: Dict[str, float]) -> bool:
            a = avail.get(node_id)
            if a is None:
                return False
            return all(a.get(k, 0.0) >= v - 1e-9 for k, v in bundle.items())

        def take(node_id: NodeID, bundle: Dict[str, float]) -> None:
            a = avail[node_id]
            for k, v in bundle.items():
                a[k] = a.get(k, 0.0) - v

        # pinned bundles (topology hosts) are authoritative for any strategy
        placement: List[Optional[NodeID]] = [None] * len(bundles)
        for i, (b, pin) in enumerate(zip(bundles, pins)):
            if pin is None:
                continue
            if not fits(pin, b):
                return None
            take(pin, b)
            placement[i] = pin

        free_idx = [i for i, p in enumerate(placement) if p is None]
        if not free_idx:
            return placement  # type: ignore[return-value]
        order = [n.node_id for n in nodes]

        if strategy in ("PACK", "STRICT_PACK"):
            if strategy == "STRICT_PACK":
                for node_id in order:
                    trial = dict(avail[node_id])
                    ok = True
                    for i in free_idx:
                        b = bundles[i]
                        if not all(trial.get(k, 0.0) >= v - 1e-9 for k, v in b.items()):
                            ok = False
                            break
                        for k, v in b.items():
                            trial[k] = trial.get(k, 0.0) - v
                    if ok:
                        for i in free_idx:
                            placement[i] = node_id
                        return placement  # type: ignore[return-value]
                return None
            chosen_so_far: List[NodeID] = []
            for i in free_idx:
                b = bundles[i]
                chosen = None
                # prefer nodes already used by this group (packing)
                for node_id in list(dict.fromkeys(chosen_so_far)) + order:
                    if fits(node_id, b):
                        chosen = node_id
                        break
                if chosen is None:
                    return None
                take(chosen, b)
                placement[i] = chosen
                chosen_so_far.append(chosen)
            return placement  # type: ignore[return-value]

        # SPREAD / STRICT_SPREAD
        used: List[NodeID] = []
        for i in free_idx:
            b = bundles[i]
            chosen = None
            unused = [n for n in order if n not in used]
            for node_id in unused + ([] if strategy == "STRICT_SPREAD" else order):
                if fits(node_id, b):
                    chosen = node_id
                    break
            if chosen is None:
                return None
            take(chosen, b)
            placement[i] = chosen
            used.append(chosen)
        return placement  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def placement_group(
    bundles: Sequence[Bundle], strategy: str = "PACK"
) -> PlacementGroup:
    rt = _cw.get_runtime()
    return rt.pg_manager.create(bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    rt = _cw.get_runtime()
    rt.pg_manager.remove(pg)
