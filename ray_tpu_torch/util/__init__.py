"""ray_tpu_torch.util — user-facing utilities (reference:
`python/ray/util/`): the actor pool, the multiprocessing Pool shim and the
distributed Queue, beside the SLO latency digests, the timeline, the
in-process span API, the flight recorder, the profiler, the concurrency
sanitizer, the state API and the chaos harness; the port's own copies of
ray_tpu/util's modules."""

from .actor_pool import ActorPool  # noqa: F401
from .multiprocessing import Pool  # noqa: F401
from .queue import Queue  # noqa: F401
