"""Task specifications and scheduling strategies.

Equivalent of the reference's TaskSpec (upstream ray
`src/ray/common/task/task_spec.h :: TaskSpecification`,
`python/ray/util/scheduling_strategies.py`): the unit handed from a submitting
worker to the scheduler. The port's copy of ray_tpu/core/task_spec.py.

The accelerator resource is "GPU" (a deliberate difference, ROADMAP C): the
reference's `num_tpus` option becomes `num_gpus`, and `resource_demand()`
fills "GPU" where the reference fills "TPU". ``TopologyRequest`` and the
scheduling strategies stay as they are; a topology's chips count as "GPU".
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID


class TaskKind(enum.Enum):
    NORMAL = "normal"
    ACTOR_CREATION = "actor_creation"
    ACTOR_TASK = "actor_task"


@dataclass(frozen=True)
class TopologyRequest:
    """A sub-slice request with a topology shape, e.g. (2, 2, 4).

    The scheduler packs these onto the torus without fragmenting it. Its
    chips count as "GPU" in the resource demand.
    """

    shape: Tuple[int, ...]

    @property
    def num_chips(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


@dataclass(frozen=True)
class SchedulingStrategy:
    """Base: DEFAULT hybrid policy."""


@dataclass(frozen=True)
class SpreadSchedulingStrategy(SchedulingStrategy):
    pass


@dataclass(frozen=True)
class NodeAffinitySchedulingStrategy(SchedulingStrategy):
    node_id: NodeID = None  # type: ignore[assignment]
    soft: bool = False


@dataclass(frozen=True)
class NodeLabelSchedulingStrategy(SchedulingStrategy):
    """Label-constrained placement (reference:
    `python/ray/util/scheduling_strategies.py :: NodeLabelSchedulingStrategy`
    + the raylet label policy). hard: every expression must match for a
    node to be eligible; soft: matching nodes preferred, any feasible
    node otherwise. Expressions: {key: ("in", [v1, v2])} or
    {key: ("not_in", [v1])} — exact string matching on NodeInfo.labels
    (e.g. accelerator generation, zone, provider id)."""

    hard: Any = None  # Dict[str, Tuple[str, List[str]]]
    soft: Any = None

    @staticmethod
    def _matches(exprs, labels: Dict[str, str]) -> bool:
        for key, (op, values) in (exprs or {}).items():
            has = labels.get(key)
            if op == "in" and has not in values:
                return False
            if op == "not_in" and has in values:
                return False
        return True


@dataclass(frozen=True)
class PlacementGroupSchedulingStrategy(SchedulingStrategy):
    placement_group_id: PlacementGroupID = None  # type: ignore[assignment]
    bundle_index: int = -1


@dataclass
class TaskOptions:
    """User-settable knobs from ``@remote(...)`` / ``.options(...)``."""

    num_cpus: float = 1.0
    num_gpus: float = 0.0
    topology: Optional[TopologyRequest] = None
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: Optional[int] = None
    retry_exceptions: bool = False
    max_restarts: int = 0  # actors only
    max_task_retries: int = 0  # actors only
    # int, or "streaming": the task is a GENERATOR whose yields seal into
    # the object plane one by one; the caller consumes an ObjectRefGenerator
    # while the task still runs (reference: num_returns="streaming",
    # core-worker streaming generator returns in task_manager.cc)
    num_returns: Any = 1
    name: str = ""
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    runtime_env: Optional[Dict[str, Any]] = None
    max_concurrency: int = 1  # actors only
    # actors only: None = policy decides (CPU actors isolate into a worker
    # process; device actors stay in-process); True forces in-process,
    # False forces a process (refused for a device actor)
    in_process: Optional[bool] = None

    def resource_demand(self) -> Dict[str, float]:
        demand = dict(self.resources)
        if self.num_cpus:
            demand["CPU"] = demand.get("CPU", 0.0) + self.num_cpus
        if self.num_gpus:
            demand["GPU"] = demand.get("GPU", 0.0) + self.num_gpus
        if self.topology is not None:
            demand["GPU"] = demand.get("GPU", 0.0) + self.topology.num_chips
        return demand


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    kind: TaskKind
    func: Optional[Callable[..., Any]]  # None for cross-process (pickled) specs
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    options: TaskOptions
    return_ids: List[ObjectID]
    actor_id: ActorID = field(default_factory=ActorID.nil)
    method_name: str = ""
    # ObjectIDs this task depends on (plasma-stored args), for the resolver.
    dependencies: List[ObjectID] = field(default_factory=list)
    attempt: int = 0
    # True when a placement-group bundle already holds the resources: the
    # node agent must not double-acquire from the node ledger.
    skip_node_resources: bool = False
    # Distributed-tracing context (util/tracing): stamped at submission
    # when the submitting thread has an active span; the executing node
    # parents its execute-span under it. None = tracing inactive.
    trace_ctx: Optional[Dict[str, str]] = None

    @property
    def name(self) -> str:
        if self.options.name:
            return self.options.name
        if self.func is not None:
            return getattr(self.func, "__qualname__", repr(self.func))
        return self.method_name or "task"
