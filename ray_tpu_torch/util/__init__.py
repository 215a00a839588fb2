"""ray_tpu_torch.util — user-facing utilities (reference:
`python/ray/util/`): the actor pool, the multiprocessing Pool shim and the
distributed Queue, beside the SLO latency digests, the timeline and the
in-process span API; the port's own copies of ray_tpu/util's modules."""

from .actor_pool import ActorPool  # noqa: F401
from .multiprocessing import Pool  # noqa: F401
from .queue import Queue  # noqa: F401
