"""Topology-aware scheduling: torus model, sub-slice packing, gangs (the
port's copy of ray_tpu/sched)."""

from .placement_group import (  # noqa: F401
    PlacementGroup,
    PlacementGroupError,
    placement_group,
    remove_placement_group,
)
from .topology import (  # noqa: F401
    GENERATIONS,
    Allocation,
    SliceTopology,
    SubSlicePacker,
    TpuGeneration,
)
