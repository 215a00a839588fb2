"""Train/run config dataclasses.

Reference analogue: upstream ray `python/ray/air/config.py ::
ScalingConfig/RunConfig/FailureConfig/CheckpointConfig`.

The port's copy of ray_tpu/train/config.py. A worker asks for a "GPU"
where the reference's asks for a "TPU" (`use_gpu` for `use_tpu`). What
needs more than one device or more than one process waits: a mesh shape
or a slice topology and the multi-host bootstrap for ROADMAP A7b, actor
processes for the gang members for A5b; each raises NotImplementedError
when set.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class ScalingConfig:
    """Shape of the training gang.

    num_workers: gang members, each an actor on the node agents' threads
    in the process that owns the card.
    use_gpu: each member holds one "GPU" (and one "CPU").
    mesh_shape, topology, distributed_bootstrap=True: wait for ROADMAP A7b
    (meshes, the multi-host bootstrap); workers_in_process=False waits for
    A5b (actor processes). None leaves the members in process.
    """

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    mesh_shape: Optional[Dict[str, int]] = None
    topology: Optional[Tuple[int, ...]] = None
    distributed_bootstrap: bool = False
    workers_in_process: Optional[bool] = None

    def __post_init__(self):
        if self.mesh_shape is not None or self.topology is not None:
            raise NotImplementedError(
                "ScalingConfig mesh_shape/topology: device meshes and slice "
                "topologies wait for ROADMAP A7b; the port trains one gang member "
                "per card")
        if self.distributed_bootstrap:
            raise NotImplementedError(
                "ScalingConfig(distributed_bootstrap=True): the multi-host bootstrap "
                "(comm/bootstrap.py) waits for ROADMAP A7b")
        if self.workers_in_process is False:
            raise NotImplementedError(
                "ScalingConfig(workers_in_process=False): actor processes wait for "
                "ROADMAP A5b; gang members run on the node agents' threads")

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        return {"CPU": 1.0, "GPU": 1.0} if self.use_gpu else {"CPU": 1.0}


@dataclasses.dataclass
class FailureConfig:
    """max_failures: gang restarts to attempt (-1 = unlimited)."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # max | min


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    callbacks: List[Any] = dataclasses.field(default_factory=list)
    verbose: int = 1
