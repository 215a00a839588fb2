"""serve public API: run/shutdown/status/get_handle.

Reference: `python/ray/serve/api.py :: serve.run` + CLI surface.

The port's copy of ray_tpu/serve/api.py. `run` starts the thread-mode
runtime when none is up, as the reference's does. The gRPC ingress
(`start_grpc`, serve/grpc_proxy.py) imports `grpc` only when it starts.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from .. import api as core_api
from ..core.logging import get_logger
from .controller import CONTROLLER_NAME, get_or_create_controller
from .deployment import Application, Deployment
from .handle import DeploymentHandle
from .http_proxy import HTTPProxy

logger = get_logger("serve.api")

_state_lock = threading.Lock()
_proxy: Optional[HTTPProxy] = None
_apps: Dict[str, tuple] = {}  # app name -> (deployment name, http route)


def run(
    app: Application,
    *,
    name: str = "default",
    route_prefix: Optional[str] = None,
    http_port: int = 0,
    blocking: bool = False,
) -> DeploymentHandle:
    """Deploy an application; returns its handle. Starts the HTTP proxy on
    first use (port 0 = ephemeral)."""
    global _proxy
    core_api._auto_init()
    if not isinstance(app, Application):
        if isinstance(app, Deployment):
            app = app.bind()
        else:
            raise TypeError("serve.run expects Deployment.bind() output")
    controller = get_or_create_controller()
    dep = app.deployment
    core_api.get(controller.deploy.remote(
        dep.name, dep._target, app.init_args, app.init_kwargs, dep.config
    ))
    handle = DeploymentHandle(dep.name, controller)
    route = (route_prefix or name or dep.name).strip("/")
    with _state_lock:
        prev = _apps.get(name)
        _apps[name] = (dep.name, route)
        if _proxy is None:
            _proxy = HTTPProxy(port=http_port)
            _proxy.start()
        if prev is not None and prev[1] != route:
            # re-deploy under a NEW route: retire the old one everywhere,
            # or per-host proxies serve a stale path forever
            _proxy.remove_route(prev[1])
        _proxy.add_route(route, handle)
    if prev is not None and prev[1] != route:
        core_api.get(controller.delete_route.remote(prev[1], prev[0]))
    # controller table updated AFTER local state: a failure above leaves
    # no orphaned cluster-wide route that delete() could never clean
    # (dual store: _apps/head proxy here, controller table for per-host
    # proxies — the invariant is controller routes ⊆ _apps routes)
    core_api.get(controller.set_route.remote(route, dep.name))
    logger.info("app %r -> deployment %r at /%s (port %d)",
                name, dep.name, route, _proxy.port)
    if blocking:  # pragma: no cover
        threading.Event().wait()
    return handle


def get_app_handle(name: str = "default") -> DeploymentHandle:
    with _state_lock:
        dep_name, _ = _apps[name]
    return DeploymentHandle(dep_name)


def get_deployment_handle(deployment_name: str) -> DeploymentHandle:
    return DeploymentHandle(deployment_name)


def http_port() -> Optional[int]:
    with _state_lock:
        return _proxy.port if _proxy else None


_grpc_proxy = None


def start_grpc(port: int = 0) -> int:
    """Start the gRPC ingress (reference: the proxy's gRPC server path).
    Routes resolve live from the app table, so call this before or after
    serve.run in any order. Returns the bound port."""
    global _grpc_proxy
    from .grpc_proxy import GrpcProxy

    handle_cache: Dict[str, DeploymentHandle] = {}

    def routes():
        # handles cached per deployment: a fresh handle per request would
        # re-sync against the controller every call and discard the pow-2
        # router's replica/load state
        with _state_lock:
            out = {}
            for dep_name, route in _apps.values():
                h = handle_cache.get(dep_name)
                if h is None:
                    h = handle_cache[dep_name] = DeploymentHandle(dep_name)
                out[route] = h
            return out

    with _state_lock:
        if _grpc_proxy is None:
            _grpc_proxy = GrpcProxy(routes, port=port)
            _grpc_proxy.start()
        return _grpc_proxy.port


def grpc_port() -> Optional[int]:
    with _state_lock:
        return _grpc_proxy.port if _grpc_proxy else None


def status() -> Dict[str, Any]:
    try:
        controller = core_api.get_actor(CONTROLLER_NAME)
    except ValueError:
        return {}
    return core_api.get(controller.status.remote())


def delete(name: str = "default") -> None:
    global _proxy
    with _state_lock:
        entry = _apps.pop(name, None)
        dep_name, route = entry if entry else (None, name)
        if _proxy is not None:
            _proxy.remove_route(route)
    if dep_name is not None:
        controller = core_api.get_actor(CONTROLLER_NAME)
        # ownership-checked: another app may have re-claimed this route
        core_api.get(controller.delete_route.remote(route, dep_name))
        core_api.get(controller.delete_deployment.remote(dep_name))


def shutdown() -> None:
    """Stop the HTTP proxy (its thread joined) and the gRPC proxy (its
    drain waited out), then the controller: its reconcile loop is joined
    and every replica retires gracefully (ServeController.shutdown)
    before the controller is killed. Last, the channel service and the KV
    senders the disaggregated roles streamed through end. The runtime
    stays up."""
    global _proxy, _grpc_proxy
    with _state_lock:
        if _proxy is not None:
            _proxy.stop()
            _proxy = None
        if _grpc_proxy is not None:
            _grpc_proxy.stop()
            _grpc_proxy = None
        _apps.clear()
    try:
        _retire_controller()
    finally:
        from ..core import channels

        channels.shutdown_service()


def _retire_controller() -> None:
    if not core_api.is_initialized():
        return
    try:
        controller = core_api.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    try:
        core_api.get(controller.shutdown.remote(), timeout=120.0)
    finally:
        core_api.kill(controller)
