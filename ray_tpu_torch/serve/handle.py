"""DeploymentHandle: the composition/call surface (reference:
`python/ray/serve/handle.py`). handle.remote(...) routes through the
pow-2 router; .result() resolves like a future.

The port's copy of ray_tpu/serve/handle.py. In thread mode a method that
returns a generator (LLMServer.stream) hands it back live through
.result(): the replica runs in this process, and the object store keeps a
value it cannot pickle as it is."""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from .. import api
from .router import Pow2Router


class DeploymentResponse:
    def __init__(self, ref):
        self._ref = ref

    def result(self, timeout: Optional[float] = None) -> Any:
        return api.get(self._ref, timeout=timeout)

    @property
    def ref(self):
        return self._ref


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller=None, method: str = "__call__",
                 multiplexed_model_id: str = ""):
        self.deployment_name = deployment_name
        self._method = method
        self._multiplexed_model_id = multiplexed_model_id
        self._controller = controller
        self._router = Pow2Router(deployment_name)
        self._last_sync = 0.0
        self._sync_period = 1.0
        self._lock = threading.Lock()

    def _controller_handle(self):
        # double-checked: two racing _sync threads must not both resolve
        # the controller (raylint R1)
        if self._controller is None:
            with self._lock:
                if self._controller is None:
                    self._controller = api.get_actor("SERVE_CONTROLLER")
        return self._controller

    def _sync(self, force: bool = False):
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_sync < self._sync_period:
                return
            self._last_sync = now
        replicas, version = api.get(
            self._controller_handle().get_replicas.remote(self.deployment_name)
        )
        self._router.update_replicas(replicas, version)

    def options(self, method_name: Optional[str] = None, *,
                multiplexed_model_id: Optional[str] = None) -> "DeploymentHandle":
        h = DeploymentHandle(
            self.deployment_name,
            self._controller,
            method_name if method_name is not None else self._method,
            multiplexed_model_id if multiplexed_model_id is not None
            else self._multiplexed_model_id,
        )
        h._router = self._router
        h._last_sync = self._last_sync
        return h

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        self._sync()
        deadline = time.monotonic() + 30.0
        while True:
            try:
                ref = self._router.assign(
                    self._method, args, kwargs, self._multiplexed_model_id
                )
                return DeploymentResponse(ref)
            except RuntimeError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
                self._sync(force=True)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(name)
