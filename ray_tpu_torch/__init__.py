"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside the JAX package `ray_tpu`, which stays the
reference the port is held against; it imports `torch`, numpy and the
stdlib, never `jax` and nothing of `ray_tpu`. It serves the
Llama-family decoder, dense or mixture-of-experts, through the
continuous-batching engine, with speculative decoding (n-gram or
draft-model proposers), KV migration between engines, live weight
updates and the reference's metrics and SLO digests (ray_tpu_torch.core,
ray_tpu_torch.util), and trains it on one device
(`ray_tpu_torch.train`: AdamW or adafactor with the reference's optax
semantics, f32 or bf16 parameters, activation checkpointing). The kernels of both paths are
hand-written in CUDA C++ for sm_90a (ray_tpu_torch/csrc): RMSNorm, the
flash-attention forward (with the logsumexp residual) and its dq and dk/dv
backward kernels, paged decode, paged chunk and paged verify attention.
Entry points run
on the card unless the caller passes device="cpu"; on the CPU every kernel
takes its plain version.

The task/actor runtime is the reference's in thread mode (`init`,
`remote`, `get`, `put`, `wait`, actors, the object store, placement groups
and the virtual cluster of `cluster_utils`): every task and actor runs on
the node agents' threads in the process that owns the card, the
accelerator resource is "GPU", and a tree of CUDA tensors passes through
the object store by reference. A GPU actor can host an `LLMServer`. On it
stands the serve runtime (`ray_tpu_torch.serve`: deployments, the
controller, router, handles, batching, multiplexing, the HTTP proxy and
the OpenAI front), and `LLMServer` is a deployment of it. The
reference's concurrency sanitizer (`util/sanitizer.maybe_install()` at
import) waits for ROADMAP A5c, with the rest of the health and profiling
planes.
"""

from .api import (  # noqa: F401
    GetTimeoutError,
    ObjectRef,
    ObjectRefGenerator,
    RayActorError,
    RayTaskError,
    available_resources,
    broadcast,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    put,
    remote,
    shutdown,
    wait,
)
from .core.task_spec import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SchedulingStrategy,
    SpreadSchedulingStrategy,
    TopologyRequest,
)
from .models import get_config, init_params, params_from_numpy  # noqa: F401
from .serve import EngineConfig, InferenceEngine, LLMServer, SpeculationConfig  # noqa: F401
from .train import (  # noqa: F401
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    synthetic_batch,
)

__all__ = ["EngineConfig", "GetTimeoutError", "InferenceEngine", "LLMServer",
           "NodeAffinitySchedulingStrategy", "NodeLabelSchedulingStrategy", "ObjectRef",
           "ObjectRefGenerator", "PlacementGroupSchedulingStrategy", "RayActorError",
           "RayTaskError", "SchedulingStrategy", "SpeculationConfig",
           "SpreadSchedulingStrategy", "TopologyRequest", "available_resources", "broadcast",
           "cluster_resources", "get", "get_actor", "get_config", "init", "init_params",
           "init_train_state", "is_initialized", "kill", "make_eval_step", "make_optimizer",
           "make_train_step", "params_from_numpy", "put", "remote", "shutdown",
           "synthetic_batch", "timeline", "wait"]


def timeline(path: str) -> int:
    """Export the task-event timeline as chrome-trace JSON (open in
    Perfetto / chrome://tracing), with the buffered trace spans mirrored
    into it (one lane per source process). Returns the number of events
    written. See ray_tpu_torch.util.timeline for app spans (`span`) and
    device traces (`trace_torch`)."""
    from .util import timeline as _tl
    from .util import tracing as _tr

    _tr.export_to_timeline()
    return _tl.export(path)
