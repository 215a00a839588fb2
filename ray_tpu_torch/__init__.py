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

The task/actor runtime is the reference's (`init`, `remote`, `get`, `put`,
`wait`, actors, the object store, placement groups and the virtual cluster
of `cluster_utils`): CPU tasks run in forked worker processes over a
shared-memory store and CPU actors in processes of their own, while device
tasks and actors run on the node agents' threads in the process that owns
the card; the accelerator resource is "GPU", and a tree of CUDA tensors
passes through the object store by reference. A GPU actor can host an `LLMServer`. On it
stands the serve runtime (`ray_tpu_torch.serve`: deployments, the
controller, router, handles, batching, multiplexing, the HTTP and gRPC
proxies and the OpenAI front), and `LLMServer` is a deployment of it;
disaggregated prefill/decode serving and the fleet controller that scales
and remediates its replicas stand on both. `status()` renders the health
plane (core/health.py). `RAY_TPU_SANITIZE=1` arms the concurrency
sanitizer at import (util/sanitizer.py).
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
           "status", "synthetic_batch", "timeline", "wait"]

# RAY_TPU_SANITIZE=1 arms the concurrency sanitizer (instrumented
# Lock/RLock, lock-order-cycle + hold-time detection) in every process
# that imports ray_tpu_torch — workers inherit the env var, so one flag
# covers the whole runtime. No-op (stock primitives, zero overhead)
# otherwise.
from .util import sanitizer as _sanitizer  # noqa: E402

_sanitizer.maybe_install()


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


def status(address: str = "", as_dict: bool = False):
    """Cluster health at a glance, rendered from the health plane's
    payload: node liveness, firing alerts, SLO digest quantiles, and
    health scores.

    In-process: the process's own HealthPlane, created lazily and
    evaluated once so a fresh session still shows data. ``as_dict=True``
    returns the raw payload instead of text. Reading a remote head's
    dashboard (``address="host:port"``) waits for ROADMAP A5c (the
    dashboard) and raises NotImplementedError."""
    if address:
        raise NotImplementedError(
            "status(address=...): reading a remote head's /api/v0/health "
            "needs the dashboard, which waits for ROADMAP A5c")
    from .core.health import get_health_plane

    plane = get_health_plane(create=True)
    plane.evaluate()
    payload = plane.payload()
    if as_dict:
        return payload
    lines = ["== ray_tpu_torch health =="]
    nodes = payload.get("nodes", [])
    alive = sum(1 for n in nodes if n.get("state") == "ALIVE")
    lines.append(f"nodes: {alive}/{len(nodes)} alive")
    for n in nodes:
        lines.append(
            f"  {n.get('node_id', '?')} {n.get('state', '?'):5s} "
            f"role={n.get('role') or '-':8s} "
            f"heartbeat_age={n.get('heartbeat_age_s', 0):.1f}s")
    alerts = payload.get("alerts", [])
    lines.append(f"alerts firing: {len(alerts)}")
    for a in alerts:
        lines.append(
            f"  [{a.get('severity', '?'):8s}] {a.get('rule', '?')} "
            f"{a.get('labels', {})} value={a.get('value')}")
    digests = payload.get("digests", {})
    if digests:
        lines.append("latency digests (windowed):")

        def _ms(v):
            return f"{v * 1e3:.1f}ms" if v is not None else "-"

        for label in sorted(digests):
            d = digests[label]
            lines.append(f"  {label}: p50={_ms(d.get('p50'))} "
                         f"p95={_ms(d.get('p95'))} n={d.get('count', 0)}")
    utilization = payload.get("utilization", {})
    if utilization:
        lines.append("utilization:")
        for key in sorted(utilization):
            row = utilization[key]
            parts = []
            if row.get("cpu_fraction") is not None:
                parts.append(f"cpu={row['cpu_fraction'] * 100:.0f}%")
            if row.get("rss_bytes") is not None:
                parts.append(f"rss={row['rss_bytes'] / 1e6:.0f}MB")
            if row.get("memory_fraction") is not None:
                parts.append(f"mem={row['memory_fraction'] * 100:.0f}%")
            lines.append(f"  {key}: " + " ".join(parts))
    goodput = payload.get("goodput", {})
    if goodput and goodput.get("wall_seconds"):
        lines.append(
            f"goodput: {goodput.get('goodput_fraction', 0.0) * 100:.1f}% "
            f"of {goodput.get('wall_seconds', 0.0):.1f}s wall")
        for part in ("compute", "data_stall", "channel_wait", "bubble",
                     "migration"):
            v = goodput.get(part)
            if v:
                lines.append(f"  {part}: {v:.2f}s")
        kinds = {k[len("bubble_"):]: goodput[k] for k in goodput
                 if k.startswith("bubble_") and goodput[k]}
        if kinds:
            lines.append("  bubble by kind: " + " ".join(
                f"{k}={kinds[k]:.2f}s" for k in sorted(kinds)))
    objects = payload.get("objects", {})
    if objects and objects.get("nodes"):
        leak_counts = objects.get("leak_counts", {})
        n_leaks = sum(leak_counts.values()) if leak_counts else 0
        lines.append(
            f"objects: {objects.get('total_objects', 0)} live, "
            f"{objects.get('total_bytes', 0) / 1e6:.1f}MB, "
            f"leaks flagged: {n_leaks}")
        for key in sorted(objects["nodes"]):
            row = objects["nodes"][key]
            lines.append(f"  {key}: {row.get('objects', 0)} objects "
                         f"{row.get('bytes', 0) / 1e6:.1f}MB"
                         + (f" (+{row['truncated']} truncated)"
                            if row.get("truncated") else ""))
    channels = payload.get("channels", {})
    if channels:
        lines.append("channels:")
        for key in sorted(channels):
            row = channels[key]
            lines.append(
                f"  {key}: {row.get('channels', 0):.0f} open "
                f"depth={row.get('depth', 0):.0f} "
                f"sent={row.get('send_bytes', 0) / 1e6:.1f}MB "
                f"recv_wait={row.get('recv_wait_seconds', 0):.2f}s "
                f"backpressure={row.get('capacity_reached', 0):.0f}")
    scores = payload.get("scores", {})
    degraded = {k: v for k, v in scores.items() if v < 1.0}
    if degraded:
        lines.append("degraded:")
        for k in sorted(degraded):
            lines.append(f"  {k}: score={degraded[k]:.2f}")
    text = "\n".join(lines)
    print(text)
    return payload if as_dict else None
