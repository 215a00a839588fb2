"""Per-host HTTP ingress (reference: `serve/_private/proxy.py ::
ProxyActor` — one proxy per node, so clients hit any host).

The TPU shape: a `ProxyActor` placed on a joined runtime (by resource
demand) runs an HTTPProxy bound to THAT host and serves the same route
table as the head's ingress — deployments land/leave through the
controller's route table, which the actor polls (the reference's
LongPoll config watch, collapsed to a poll). Requests route through
DeploymentHandles that work anywhere via the worker API back-channel,
so traffic is host-local ingress -> head-owned dispatch -> replica
(single-controller: the extra head hop is the ownership model, not an
accident — the reference's proxy talks straight to replicas because
every proxy IS a CoreWorker).

The port's copy of ray_tpu/serve/proxy_actor.py. In thread mode every
runtime lives in this process, so a ProxyActor is one more ingress in it,
on its own port; stop() also joins its route-refresh thread."""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .. import api as core_api
from ..core.logging import get_logger

logger = get_logger("serve.proxy_actor")


@core_api.remote(in_process=True, num_cpus=0)
class ProxyActor:
    """One host's ingress: runs in the joined runtime's process (it owns
    the host's network identity), port readable via .port()."""

    def __init__(self, http_port: int = 0, refresh_s: float = 1.0,
                 host: str = "0.0.0.0"):
        from .http_proxy import HTTPProxy

        self._proxy = HTTPProxy(host=host, port=http_port)
        self._proxy.start()
        self._refresh_s = refresh_s
        self._known: Dict[str, str] = {}
        self._stop = threading.Event()
        self._refresh_once()
        self._refresher = threading.Thread(target=self._refresh_loop, daemon=True,
                                           name="proxy-route-refresh")
        self._refresher.start()

    def _refresh_once(self) -> None:
        from .controller import CONTROLLER_NAME
        from .handle import DeploymentHandle

        try:
            controller = core_api.get_actor(CONTROLLER_NAME)
            routes = core_api.get(controller.get_routes.remote(), timeout=30)
        except Exception:  # noqa: BLE001 — controller mid-restart: retry next tick
            return
        for route, dep_name in routes.items():
            if self._known.get(route) != dep_name:
                self._proxy.add_route(route, DeploymentHandle(dep_name))
                self._known[route] = dep_name
        for route in list(self._known):
            if route not in routes:
                self._proxy.remove_route(route)
                self._known.pop(route, None)

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self._refresh_s):
            self._refresh_once()

    def port(self) -> int:
        return self._proxy.port

    def health_check(self) -> bool:
        return True

    def stop(self) -> bool:
        self._stop.set()
        self._refresher.join(timeout=30.0)
        self._proxy.stop()
        return True


def start_proxy(actor_options: Optional[dict] = None,
                http_port: int = 0, host: str = "0.0.0.0"):
    """Start a per-host ingress proxy; place it with actor_options
    (e.g. resources={"hostX": 0.1} to pin a specific joined runtime).
    -> (actor handle, port)."""
    opts = dict(actor_options or {})
    opts.setdefault("num_cpus", 0)
    opts["in_process"] = True  # it must own the host runtime's sockets
    actor = ProxyActor.options(**opts).remote(http_port=http_port, host=host)
    port = core_api.get(actor.port.remote(), timeout=60)
    return actor, port
