"""Virtual multi-node cluster for tests.

Equivalent of the reference's in-process fake cluster (upstream ray
`python/ray/cluster_utils.py :: Cluster` used by `ray_start_cluster`
fixtures): many node agents in one OS process sharing a control plane, so
scheduling spread, node failure, object transfer and actor restart are
testable on one machine. Nodes can advertise topology-labelled "GPU"
resources and slice coordinates.

The port's copy of ray_tpu/cluster_utils.py. Its node agents share one
worker-process pool (process_pool.acquire_shared_pool), as the
reference's do.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .core import core_worker as _cw
from .core.core_worker import Runtime
from .core.ids import NodeID, SliceID
from .core.node_agent import NodeAgent


class Cluster:
    def __init__(self, initialize_head: bool = True, head_resources: Optional[Dict[str, float]] = None):
        self.runtime = Runtime()
        if initialize_head:
            self.head = self.runtime.add_node(
                resources=head_resources or {"CPU": 8.0}, is_head=True
            )
        _cw.set_runtime(self.runtime)

    def add_node(
        self,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        slice_id: Optional[SliceID] = None,
        topology_coords: Optional[Tuple[int, ...]] = None,
    ) -> NodeAgent:
        return self.runtime.add_node(
            resources=resources,
            labels=labels,
            slice_id=slice_id,
            topology_coords=topology_coords,
        )

    def add_slice(
        self,
        num_hosts: Optional[int] = None,
        chips_per_host: int = 4,
        generation: str = "v5e",
        topology_shape: Optional[Tuple[int, ...]] = None,
        extra_resources: Optional[Dict[str, float]] = None,
    ) -> SliceID:
        """Register a fake slice: nodes sharing one SliceID, plus (when
        host ownership matches the generation's layout) an ICI topology
        registration so TopologyRequest placement groups can pack sub-boxes
        onto it.

        Give either ``num_hosts`` (chip grid shape derived near-cubic) or an
        explicit ``topology_shape`` (num_hosts derived from it).
        """
        from .sched.topology import (
            GENERATIONS,
            SliceInfo,
            SliceTopology,
            _default_shape,
        )

        gen = GENERATIONS[generation]
        if topology_shape is not None:
            shape = tuple(topology_shape)
            chips = 1
            for d in shape:
                chips *= d
            num_hosts = max(1, chips // chips_per_host)
        else:
            if num_hosts is None:
                raise ValueError("give num_hosts or topology_shape")
            shape = _default_shape(num_hosts * chips_per_host, gen.dims)

        slice_id = SliceID.generate()
        topo = SliceTopology(generation, shape)
        # Topology registration requires the generation's host layout AND a
        # uniform chip->host partition (ragged partitions from odd-dim shapes
        # would pin bundles bigger than any node advertises, leaving
        # topology requests queued forever).
        partition = topo.host_partition()
        register_topology = (
            chips_per_host == gen.chips_per_host
            and len(partition) == num_hosts
            and all(len(v) == chips_per_host for v in partition.values())
        )
        info = SliceInfo(slice_id=slice_id, topology=topo) if register_topology else None

        for h in range(num_hosts):
            resources = {"CPU": 8.0, "GPU": float(chips_per_host)}
            resources.update(extra_resources or {})
            agent = self.add_node(
                resources=resources,
                labels={"slice": slice_id.hex(), "host_index": str(h)},
                slice_id=slice_id,
                topology_coords=(h,),
            )
            if info is not None:
                info.hosts[h] = agent.node_id
        if info is not None:
            self.runtime.register_slice(info)
        return slice_id

    def remove_node(self, agent: NodeAgent) -> None:
        self.runtime.remove_node(agent.node_id)

    def shutdown(self) -> None:
        self.runtime.shutdown()
        if _cw.runtime_initialized() and _cw.get_runtime() is self.runtime:
            _cw.set_runtime(None)
