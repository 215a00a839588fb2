"""Model multiplexing (reference: `python/ray/serve/multiplex.py ::
_ModelMultiplexWrapper` + `serve.multiplexed` / `get_multiplexed_model_id`).

Many fine-tuned models share one replica pool: the caller tags a request
with `multiplexed_model_id`, the router prefers a replica that already has
that model resident, and inside the replica an LRU cache (per decorated
loader) loads/evicts models up to `max_num_models_per_replica`.

The port's copy of ray_tpu/serve/multiplex.py.
"""

from __future__ import annotations

import collections
import contextvars
import functools
import threading
from typing import Any, Callable, Dict, Optional

from ..core.logging import get_logger

logger = get_logger("serve.multiplex")

# Set by ServeReplica around each request that carries a model id; read by
# user code via get_multiplexed_model_id() (contextvar: safe under the
# replica's worker threads).
_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_multiplexed_model_id", default=""
)


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id the current request was tagged with
    (empty string when untagged)."""
    return _current_model_id.get()


class _ModelCache:
    """Per-loader LRU of loaded models; evicts the least recently used,
    calling the model's `unload()` (if any) on the way out."""

    def __init__(self, loader: Callable[[Any, str], Any], capacity: int):
        self.loader = loader
        self.capacity = capacity
        self._models: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        self._lock = threading.Lock()
        # model_id -> Event for a load in flight: concurrent requests for
        # the same uncached id wait instead of double-loading (loads can be
        # whole checkpoints; a duplicate would also leak the loser's device
        # memory by displacing it without unload())
        self._loading: Dict[str, threading.Event] = {}

    def get(self, owner: Any, model_id: str) -> Any:
        while True:
            with self._lock:
                if model_id in self._models:
                    self._models.move_to_end(model_id)
                    return self._models[model_id]
                in_flight = self._loading.get(model_id)
                if in_flight is None:
                    self._loading[model_id] = threading.Event()
                    break
            in_flight.wait(timeout=600.0)  # loader done (or failed): recheck
        # sole loader for this id; load outside the lock (slow: checkpoints)
        try:
            model = self.loader(owner, model_id)
        except Exception:
            with self._lock:
                self._loading.pop(model_id).set()  # wake waiters to retry/fail
            raise
        with self._lock:
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            while len(self._models) > self.capacity:
                old_id, old = self._models.popitem(last=False)
                logger.info("multiplex: evicting model %r", old_id)
                unload = getattr(old, "unload", None)
                if callable(unload):
                    try:
                        unload()
                    except Exception:  # noqa: BLE001 — eviction must not fail the request
                        logger.warning("unload of %r raised", old_id, exc_info=True)
            self._loading.pop(model_id).set()
        return model

    def model_ids(self):
        with self._lock:
            return list(self._models)


def multiplexed(
    func: Optional[Callable] = None, *, max_num_models_per_replica: int = 3
):
    """Decorator for a deployment method `def get_model(self, model_id)`:
    wraps it in a per-instance LRU so repeated ids hit the cache.

        @serve.deployment
        class M:
            @serve.multiplexed(max_num_models_per_replica=4)
            def get_model(self, model_id: str): ...
            def __call__(self, req):
                model = self.get_model(serve.get_multiplexed_model_id())
    """

    def wrap(fn: Callable) -> Callable:
        attr = f"__serve_multiplex_cache_{fn.__name__}__"
        create_lock = threading.Lock()  # per decorated method

        @functools.wraps(fn)
        def wrapper(self, model_id: str):
            cache = getattr(self, attr, None)
            if cache is None:
                # double-checked: concurrent first requests on a replica
                # with many mailbox threads must share ONE cache, or the
                # single-load guarantee (and unload accounting) is void
                with create_lock:
                    cache = getattr(self, attr, None)
                    if cache is None:
                        cache = _ModelCache(fn, max_num_models_per_replica)
                        setattr(self, attr, cache)
            return cache.get(self, model_id)

        wrapper.__serve_multiplexed__ = True
        wrapper.__multiplex_cache_attr__ = attr
        return wrapper

    if func is not None:  # bare @multiplexed
        return wrap(func)
    return wrap
