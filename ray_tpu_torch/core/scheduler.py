"""Cluster scheduling policies.

Equivalent of the reference's scheduling policy stack (upstream ray
`src/ray/raylet/scheduling/cluster_resource_scheduler.cc`,
`policy/hybrid_scheduling_policy.cc`, `spread_scheduling_policy.cc`,
`node_affinity_scheduling_policy.cc`, bundle packing in
`policy/bundle_scheduling_policy.cc`): resource-shape feasibility + node
selection over the eventually-consistent cluster view.

TPU-native difference: nodes can carry ICI topology coordinates, and demands
can be ``TopologyRequest`` shapes; sub-slice packing is delegated to
``sched/topology.py`` which understands torus geometry.

The port's copy of ray_tpu/core/scheduler.py.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from .config import config
from .control_plane import ControlPlane, NodeInfo, NodeState
from .ids import NodeID
from .task_spec import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SchedulingStrategy,
    SpreadSchedulingStrategy,
    TaskSpec,
)


def _feasible(node: NodeInfo, demand: Dict[str, float]) -> bool:
    return all(node.resources_total.get(k, 0.0) >= v for k, v in demand.items())


def _available(node: NodeInfo, demand: Dict[str, float]) -> bool:
    return all(node.resources_available.get(k, 0.0) >= v for k, v in demand.items())


def _utilization(node: NodeInfo) -> float:
    scores = []
    for key, total in node.resources_total.items():
        if total > 0:
            used = total - node.resources_available.get(key, 0.0)
            scores.append(used / total)
    return max(scores) if scores else 0.0


class ClusterScheduler:
    """Select a node for a task spec. Stateless over the control-plane view."""

    def __init__(self, control_plane: ControlPlane, spread_threshold: float = 0.5):
        self._cp = control_plane
        self._spread_threshold = spread_threshold
        self._rr_counter = 0

    def select_node(
        self,
        spec: TaskSpec,
        preferred_node: Optional[NodeID] = None,
        pg_table: Optional[Dict] = None,
    ) -> Optional[NodeID]:
        """Return a node for this task, or None if infeasible/unavailable now.

        Raises ValueError for permanently infeasible demands (no ALIVE node
        could ever satisfy the shape) so callers can fail fast instead of
        queueing forever — matching the reference's infeasible-task warning.
        Exception: a hard-label constraint NO alive node carries returns
        None (stays pending) rather than raising — a labeled node may join
        or be autoscaled moments later, and labels (unlike resource shapes)
        carry no capacity bound to prove infeasibility against. Once
        label-matching nodes exist, an oversized demand fails fast as usual.
        """
        demand = spec.options.resource_demand()
        strategy = spec.options.scheduling_strategy
        nodes = self._cp.alive_nodes()
        if not nodes:
            return None

        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            if pg_table is None:
                return None
            node_id = pg_table.get((strategy.placement_group_id, strategy.bundle_index))
            return node_id

        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            node = self._cp.get_node(strategy.node_id)
            alive = node is not None and node.state is NodeState.ALIVE
            if alive and _feasible(node, demand) and _available(node, demand):
                return node.node_id
            if strategy.soft:
                return self._hybrid(nodes, demand, preferred_node)
            if not alive:
                raise ValueError(
                    f"task {spec.name} requires node "
                    f"{strategy.node_id.hex()[:8]} which is not alive"
                )
            return None

        if isinstance(strategy, NodeLabelSchedulingStrategy):
            labeled = [
                n for n in nodes if strategy._matches(strategy.hard, n.labels)
            ]
            if not labeled:
                # Stay pending: a matching node may join (worker host,
                # autoscaled provider node carrying labels) moments later —
                # the reference keeps label-gated tasks as pending demand
                # rather than failing them.
                return None
            hard = [n for n in labeled if _feasible(n, demand)]
            if not hard:
                # labeled nodes exist but none can EVER fit the demand:
                # same fail-fast contract as the unlabeled infeasible path
                raise ValueError(
                    f"task {spec.name} demand {demand} is infeasible on "
                    f"every node matching hard labels {strategy.hard}"
                )
            preferred = [
                n for n in hard if strategy._matches(strategy.soft, n.labels)
            ]
            for pool in (preferred, hard):
                avail = [n for n in pool if _available(n, demand)]
                if avail:
                    return min(avail, key=_utilization).node_id
            return None  # feasible but busy: wait

        feasible = [n for n in nodes if _feasible(n, demand)]
        if not feasible:
            raise ValueError(
                f"task {spec.name} demand {demand} is infeasible on every alive node"
            )

        if isinstance(strategy, SpreadSchedulingStrategy):
            return self._spread(feasible, demand)
        return self._hybrid(nodes, demand, preferred_node)

    # -- policies -----------------------------------------------------------
    def _hybrid(
        self,
        nodes: List[NodeInfo],
        demand: Dict[str, float],
        preferred_node: Optional[NodeID],
    ) -> Optional[NodeID]:
        """Local-first below the utilization threshold, else best (least
        utilized) available node — the reference's hybrid policy shape."""
        if preferred_node is not None:
            local = self._cp.get_node(preferred_node)
            if (
                local is not None
                and local.state is NodeState.ALIVE
                and _feasible(local, demand)
                and _available(local, demand)
                and _utilization(local) < self._spread_threshold
            ):
                return local.node_id
        candidates = [n for n in nodes if _feasible(n, demand) and _available(n, demand)]
        if not candidates:
            return None
        candidates.sort(key=_utilization)
        # top-k random among least-utilized to avoid herd behavior
        k = max(1, int(len(candidates) * config.scheduler_top_k_fraction))
        return random.choice(candidates[:k]).node_id

    def _spread(self, feasible: List[NodeInfo], demand: Dict[str, float]) -> Optional[NodeID]:
        available = [n for n in feasible if _available(n, demand)]
        if not available:
            return None
        self._rr_counter += 1
        ordered = sorted(available, key=lambda n: (_utilization(n), n.node_id.binary()))
        return ordered[self._rr_counter % len(ordered)].node_id
