"""Public task/actor API.

The port's copy of ray_tpu/api.py (the reference's counterpart of upstream
ray's `python/ray/_private/worker.py :: init/get/put/wait/remote`,
`python/ray/remote_function.py :: RemoteFunction`,
`python/ray/actor.py :: ActorClass/ActorHandle/ActorMethod`). CPU tasks
run in forked worker processes and CPU actors in processes of their own
(`worker_processes`, `actor_processes`, on by default as in the
reference); device tasks and actors, the ones that demand "GPU", run on
the node agents' threads in this process, which owns the card. The
accelerator resource is "GPU" (`num_gpus=`), counted from
`torch.cuda.device_count()`.

Control-plane snapshots (`control_plane_snapshot_path`) and restoring
from one (`init(resume_from=)`) run (core/persistence.py). Waiting for
ROADMAP A5c: joining a cluster (`address=`), the federated control plane
(`control_plane_shards`), the control-plane RPC head
(`control_plane_rpc_port`) and compiled-graph edges to a joined host
(dag.py). Each raises NotImplementedError naming its item. Compiled graphs
over this process's actors (`ActorMethod.bind`, ray_tpu_torch.dag) run.
"""

from __future__ import annotations

import atexit
import functools
import inspect
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .core import core_worker as _cw
from .core.config import config
from .core.control_plane import ActorState
from .core.core_worker import (
    GetTimeoutError,
    ObjectRef,
    ObjectRefGenerator,
    RayActorError,
    RayTaskError,
    Runtime,
)
from .core.ids import ActorID, NodeID, ObjectID, TaskID
from .core.logging import get_logger
from .core.task_spec import (
    TaskKind,
    TaskOptions,
    TaskSpec,
    TopologyRequest,
)

logger = get_logger("api")

__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "broadcast",
    "kill",
    "get_actor",
    "cluster_resources",
    "available_resources",
    "ObjectRef",
    "ObjectRefGenerator",
    "RayTaskError",
    "RayActorError",
    "GetTimeoutError",
]


def init(
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    system_config: Optional[Dict[str, Any]] = None,
    ignore_reinit_error: bool = True,
    resume_from: Optional[str] = None,
    address: Optional[str] = None,
) -> Runtime:
    """Start the runtime with one local node.

    The node advertises this host's CPUs and its CUDA devices as "GPU"
    resources (num_gpus overrides the count; see default_node_resources).

    resume_from: path to a control-plane snapshot (see
    ``system_config={"control_plane_snapshot_path": ...}``); restores the
    KV/job tables and re-creates named actors from their pickled specs
    (`ray_tpu_torch.core.persistence` documents the restore policy).

    address (join a cluster head as a worker host) waits for ROADMAP A5c
    and raises NotImplementedError, as do the system_config flags that
    would serve the control plane over RPC or federate it.
    """
    if address is not None:
        raise NotImplementedError(
            "init(address=...): joining a cluster as a worker host "
            "(core/cross_host.py) waits for ROADMAP A5c")
    if _cw.runtime_initialized():
        if ignore_reinit_error:
            return _cw.get_runtime()
        raise RuntimeError("ray_tpu_torch.init() called twice")
    config.apply_overrides(system_config)
    try:
        if int(config.control_plane_shards) > 0:
            raise NotImplementedError(
                "control_plane_shards: the federated control plane "
                "(core/shard.py) waits for ROADMAP A5c")
        if int(config.control_plane_rpc_port) >= 0:
            raise NotImplementedError(
                "control_plane_rpc_port: serving the control plane over RPC "
                "(core/rpc.py, core/cross_host.py) waits for ROADMAP A5c")
    except NotImplementedError:
        config.reset()  # a refused init leaves no override behind
        raise
    rt = Runtime()
    rt.add_node(resources=default_node_resources(num_cpus, num_gpus, resources),
                is_head=True)
    _cw.set_runtime(rt)
    atexit.register(shutdown)
    if resume_from:
        from .core import persistence

        try:
            persistence.restore_into(rt, persistence.load_snapshot(resume_from))
        except Exception:
            shutdown()  # no half-initialized global runtime on failed restore
            raise
    if config.control_plane_snapshot_path:
        from .core.persistence import SnapshotWriter

        rt._snapshot_writer = SnapshotWriter(
            rt, config.control_plane_snapshot_path
        )
    return rt


def default_node_resources(
    num_cpus: Optional[float],
    num_gpus: Optional[float],
    resources: Optional[Dict[str, float]],
) -> Dict[str, float]:
    """One resource-defaulting rule for every node this process hosts:
    explicit resources win, CPU falls back to the host count, GPU to the
    local CUDA device count."""
    node_resources = dict(resources or {})
    node_resources.setdefault(
        "CPU", num_cpus if num_cpus is not None else float(os.cpu_count() or 8))
    if num_gpus is None:
        num_gpus = _detect_local_gpus()
    if num_gpus:
        node_resources.setdefault("GPU", float(num_gpus))
    return node_resources


def _detect_local_gpus() -> float:
    """Count the CUDA devices this process may use (CUDA_VISIBLE_DEVICES
    applies) without creating a CUDA context: `is_available` and
    `device_count` ask the driver for a count, and neither initialises
    torch's CUDA state (reference: `_detect_local_tpu_chips`, upstream
    ray's accelerator managers)."""
    import torch

    if not torch.cuda.is_available():
        return 0.0
    return float(torch.cuda.device_count())


def shutdown() -> None:
    if _cw.runtime_initialized():
        rt = _cw.get_runtime()
        rt.shutdown()
        _cw.set_runtime(None)
        # init()-scoped system_config must not leak into the next runtime
        config.reset()
    # the channel service (and the KV senders over it) ends with the
    # runtime: no thread of it outlives shutdown
    from .core import channels

    channels.shutdown_service()


def is_initialized() -> bool:
    return _cw.runtime_initialized()


def _auto_init() -> Runtime:
    if not _cw.runtime_initialized():
        if os.environ.get("RAY_TPU_IN_POOL_WORKER"):
            # falling through to init() would start a PRIVATE runtime in a
            # worker process whose refs and handles mean nothing to the
            # driver; the reference's head back-channel waits for A5c
            raise RuntimeError(
                "the ray_tpu_torch API is not available inside worker "
                "processes (pool tasks / isolated actors): return plain "
                "values, or create an actor that must drive the runtime "
                "with @ray_tpu_torch.remote(in_process=True)")
        init()
    rt = _cw.get_runtime()
    # every API entry is a point where this thread holds no runtime lock:
    # apply the releases that dropped handles queued (ReferenceCounter)
    rt.reference_counter.release_dropped()
    return rt


# ---------------------------------------------------------------------------
# @remote
# ---------------------------------------------------------------------------


def _make_options(kwargs: Dict[str, Any]) -> TaskOptions:
    topo = kwargs.pop("topology", None)
    if topo is not None and not isinstance(topo, TopologyRequest):
        topo = TopologyRequest(tuple(topo))
    nr = kwargs.pop("num_returns", 1)
    if nr != "streaming" and not isinstance(nr, int):
        raise TypeError(f"num_returns must be an int or 'streaming', got {nr!r}")
    opts = TaskOptions(
        num_returns=nr,
        num_cpus=kwargs.pop("num_cpus", 1.0),
        num_gpus=kwargs.pop("num_gpus", 0.0),
        topology=topo,
        resources=kwargs.pop("resources", {}) or {},
        max_retries=kwargs.pop("max_retries", None),
        retry_exceptions=kwargs.pop("retry_exceptions", False),
        max_restarts=kwargs.pop("max_restarts", config.actor_max_restarts),
        max_task_retries=kwargs.pop("max_task_retries", 0),
        name=kwargs.pop("name", ""),
        scheduling_strategy=kwargs.pop("scheduling_strategy", None) or TaskOptions().scheduling_strategy,
        runtime_env=kwargs.pop("runtime_env", None),
        max_concurrency=kwargs.pop("max_concurrency", 1),
        in_process=kwargs.pop("in_process", None),
    )
    if kwargs:
        raise TypeError(f"unknown remote options: {sorted(kwargs)}")
    return opts


class RemoteFunction:
    def __init__(self, func, options: TaskOptions):
        self._func = func
        self._options = options
        functools.update_wrapper(self, func)

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        rt = _auto_init()
        task_id = TaskID.of()
        streaming = self._options.num_returns == "streaming"
        n = 0 if streaming else max(1, self._options.num_returns)
        from .util import tracing

        spec = TaskSpec(
            task_id=task_id,
            job_id=rt.job_id,
            kind=TaskKind.NORMAL,
            func=self._func,
            args=args,
            kwargs=kwargs,
            options=self._options,
            return_ids=[ObjectID.for_task_return(task_id, i) for i in range(n)],
            dependencies=_cw._collect_deps(args, kwargs),
            trace_ctx=tracing.current_context(),
        )
        if streaming:
            # generator task: refs stream back while it runs
            return rt.submit_streaming_task(spec)
        refs = rt.submit_task(spec)
        if self._options.num_returns == 1:
            return refs[0]
        return refs

    def options(self, **kwargs) -> "RemoteFunction":
        merged = _merge_options(self._options, kwargs)
        return RemoteFunction(self._func, merged)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._func.__name__} cannot be called directly; "
            f"use .remote()"
        )


def _merge_options(base: TaskOptions, kwargs: Dict[str, Any]) -> TaskOptions:
    import dataclasses

    fields = {f.name for f in dataclasses.fields(TaskOptions)}
    current = dataclasses.asdict(base)
    # asdict deep-copies; keep strategy/topology objects as-is
    current["scheduling_strategy"] = base.scheduling_strategy
    current["topology"] = base.topology
    for k, v in kwargs.items():
        if k == "topology" and v is not None and not isinstance(v, TopologyRequest):
            v = TopologyRequest(tuple(v))
        if k not in fields:
            raise TypeError(f"unknown option: {k}")
        current[k] = v
    return TaskOptions(**current)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        rt = _auto_init()
        opts = TaskOptions(
            num_cpus=0.0,
            num_returns=self._num_returns,
            max_task_retries=self._handle._max_task_retries,
            name=f"{self._handle._class_name}.{self._name}",
        )
        refs = rt.submit_actor_task(self._handle._actor_id, self._name, args, kwargs, opts)
        return refs[0] if self._num_returns == 1 else refs

    def options(self, num_returns: int = 1, **kwargs):
        if kwargs:
            raise TypeError(f"unsupported actor-method options: {sorted(kwargs)}")
        if not isinstance(num_returns, int):
            raise TypeError(
                "actor methods do not support streaming returns yet; "
                f"num_returns must be an int, got {num_returns!r}"
            )
        return ActorMethod(self._handle, self._name, num_returns)

    def bind(self, *args):
        """Bind into a compiled graph (see ray_tpu_torch.dag)."""
        from .dag import MethodNode

        return MethodNode(self._handle, self._name, args)


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str, max_task_retries: int = 0):
        self._actor_id = actor_id
        self._class_name = class_name
        self._max_task_retries = max_task_retries

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:8]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name, self._max_task_retries))


class ActorClass:
    def __init__(self, cls, options: TaskOptions):
        self._cls = cls
        self._options = options

    def remote(self, *args, **kwargs) -> ActorHandle:
        rt = _auto_init()
        info = rt.create_actor(self._cls, args, kwargs, self._options)
        return ActorHandle(
            info.actor_id, self._cls.__name__, self._options.max_task_retries
        )

    def options(self, **kwargs) -> "ActorClass":
        return ActorClass(self._cls, _merge_options(self._options, kwargs))


def remote(*args, **kwargs):
    """``@remote`` decorator for functions and classes, with options."""
    if len(args) == 1 and not kwargs and (inspect.isfunction(args[0]) or inspect.isclass(args[0])):
        target = args[0]
        opts = TaskOptions()
        if inspect.isclass(target):
            opts.num_cpus = 1.0
            return ActorClass(target, opts)
        return RemoteFunction(target, opts)

    if args:
        raise TypeError("@remote accepts only keyword options")
    opts = _make_options(dict(kwargs))

    def decorator(target):
        if inspect.isclass(target):
            return ActorClass(target, opts)
        return RemoteFunction(target, opts)

    return decorator


# ---------------------------------------------------------------------------
# get / put / wait / kill
# ---------------------------------------------------------------------------


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    rt = _auto_init()
    if isinstance(refs, ObjectRef):
        return rt.get([refs], timeout=timeout)[0]
    batch = list(refs)
    for item in batch:
        if not isinstance(item, ObjectRef):
            # fail before any resolution starts: the batched path fans
            # refs over worker threads, where a mid-batch AttributeError
            # would surface as an opaque pool failure
            raise TypeError(
                f"get() expects ObjectRef(s), got {type(item).__name__}: "
                f"{item!r}")
    return rt.get(batch, timeout=timeout)


def put(value: Any) -> ObjectRef:
    rt = _auto_init()
    return rt.put(value)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    rt = _auto_init()
    return rt.wait(refs, num_returns=num_returns, timeout=timeout)


def broadcast(ref: ObjectRef, *, nodes: Optional[Sequence[Any]] = None,
              timeout: float = 120.0) -> dict:
    """Push one object to every node (or a `nodes` subset) ahead of
    demand, through the collective relay tree: pullers in each wave
    stream from each other's committed prefixes instead of all hammering
    the origin. Use before fan-out consumption — weight deployment,
    checkpoint restore, large shared inputs. Returns a summary dict with
    "warmed" (node id hexes now holding a replica) and "failed"
    ((node_hex, reason) pairs — per-node failures never raise)."""
    rt = _auto_init()
    return rt.broadcast(ref, nodes=nodes, timeout=timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    rt = _auto_init()
    rt.kill_actor(actor._actor_id, no_restart=no_restart)


def get_actor(name: str) -> ActorHandle:
    rt = _auto_init()
    info = rt.control_plane.get_named_actor(name)
    if info is None or info.state is ActorState.DEAD:
        raise ValueError(f"no live actor named {name!r}")
    return ActorHandle(info.actor_id, info.name or "Actor")


def _free(refs: Sequence[ObjectRef]) -> None:
    """Eagerly release objects AND their lineage records (reference:
    `ray._private.internal_api.free`). For intermediates that cascade-free
    only when a distant consumer drops its ref — all-to-all shuffle rounds
    — waiting for the cascade means peak residency ~= everything; callers
    that KNOW an object is consumed free it explicitly. Unreconstructable
    afterwards; never call on refs a user may still resolve."""
    rt = _auto_init()
    for ref in refs:
        try:
            rt.free_object(ref.object_id)
        except Exception:  # noqa: BLE001 — freeing is best-effort
            pass


def cluster_resources() -> Dict[str, float]:
    rt = _auto_init()
    totals: Dict[str, float] = {}
    for node in rt.control_plane.alive_nodes():
        for k, v in node.resources_total.items():
            totals[k] = totals.get(k, 0.0) + v
    return totals


def available_resources() -> Dict[str, float]:
    rt = _auto_init()
    totals: Dict[str, float] = {}
    for node in rt.control_plane.alive_nodes():
        for k, v in node.resources_available.items():
            totals[k] = totals.get(k, 0.0) + v
    return totals
