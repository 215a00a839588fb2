"""Declarative serve config (reference: `python/ray/serve/schema.py` —
the YAML consumed by `serve deploy` / emitted by `serve status`).

The port's copy of ray_tpu/serve/schema.py. `load` reads JSON, or YAML
when the path ends in .yaml/.yml (PyYAML is imported only then). The
`ray-tpu serve run` command that applies a file waits for the port's CLI
(scripts.py, ROADMAP A5c).

A config file describes applications by import path plus deployment
overrides; `apply()` imports each app, applies the overrides, and
`serve.run`s it. The schema is intentionally the reference's shape:

    applications:
      - name: default
        route_prefix: /            # optional
        import_path: my_pkg.app:app    # module:attr -> Application/Deployment
        deployments:               # optional per-deployment overrides
          - name: MyDeployment
            num_replicas: 2
            max_ongoing_requests: 16
            autoscaling_config:
              min_replicas: 1
              max_replicas: 4
        args: []                   # optional bind-time args (app factories)
        kwargs: {}
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Optional

from ..core.logging import get_logger
from .config import AutoscalingConfig, DisaggConfig, SpeculationConfig
from .deployment import Application, Deployment

logger = get_logger("serve.schema")


def _validate_speculation(kwargs: Dict[str, Any], app_name) -> None:
    """LLM app kwargs may carry speculative-decoding config — top-level
    `speculation:` or nested under `engine_config:`. Validate it at parse
    time so a typo'd knob fails at `serve deploy` with the app named,
    not at replica startup."""
    ecfg = kwargs.get("engine_config")
    for holder in (kwargs, ecfg if isinstance(ecfg, dict) else {}):
        if holder.get("speculation") is None:
            continue
        try:
            SpeculationConfig.parse(holder["speculation"])
        except (ValueError, TypeError) as e:
            raise ValueError(f"app {app_name!r}: {e}") from None


def _validate_disagg(kwargs: Dict[str, Any], app_name) -> None:
    """LLM app kwargs may carry a disaggregated-serving config under
    `disagg:` (prefill_replicas / decode_replicas / kv_transfer). Validate
    at parse time so a typo'd knob fails at `serve deploy` with the app
    named, not at replica startup."""
    if kwargs.get("disagg") is None:
        return
    try:
        DisaggConfig.parse(kwargs["disagg"])
    except (ValueError, TypeError) as e:
        raise ValueError(f"app {app_name!r}: {e}") from None


@dataclasses.dataclass
class DeploymentSchema:
    name: str
    num_replicas: Optional[int] = None
    max_ongoing_requests: Optional[int] = None
    autoscaling_config: Optional[Dict[str, Any]] = None
    ray_actor_options: Optional[Dict[str, Any]] = None
    user_config: Any = None


@dataclasses.dataclass
class ApplicationSchema:
    name: str
    import_path: str
    route_prefix: Optional[str] = None
    deployments: List[DeploymentSchema] = dataclasses.field(default_factory=list)
    args: List[Any] = dataclasses.field(default_factory=list)
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ServeConfigSchema:
    applications: List[ApplicationSchema] = dataclasses.field(default_factory=list)
    http_port: int = 0

    @staticmethod
    def parse(raw: Dict[str, Any]) -> "ServeConfigSchema":
        apps = []
        for app in raw.get("applications", []):
            unknown = set(app) - {"name", "import_path", "route_prefix",
                                  "deployments", "args", "kwargs"}
            if unknown:
                raise ValueError(
                    f"unknown application fields {sorted(unknown)} "
                    f"in app {app.get('name', '?')!r}"
                )
            deps = []
            for d in app.get("deployments", []):
                dunknown = set(d) - {f.name for f in
                                     dataclasses.fields(DeploymentSchema)}
                if dunknown:
                    raise ValueError(
                        f"unknown deployment fields {sorted(dunknown)} "
                        f"in {d.get('name', '?')!r}"
                    )
                deps.append(DeploymentSchema(**d))
            _validate_speculation(dict(app.get("kwargs", {})),
                                  app.get("name", "?"))
            _validate_disagg(dict(app.get("kwargs", {})),
                             app.get("name", "?"))
            apps.append(ApplicationSchema(
                name=app["name"],
                import_path=app["import_path"],
                route_prefix=app.get("route_prefix"),
                deployments=deps,
                args=list(app.get("args", [])),
                kwargs=dict(app.get("kwargs", {})),
            ))
        return ServeConfigSchema(
            applications=apps, http_port=int(raw.get("http_port", 0))
        )

    @staticmethod
    def load(path: str) -> "ServeConfigSchema":
        import json

        with open(path) as f:
            text = f.read()
        if path.endswith((".yaml", ".yml")):
            import yaml

            raw = yaml.safe_load(text)
        else:
            raw = json.loads(text)
        if not isinstance(raw, dict):
            raise ValueError(f"serve config {path} must be a mapping")
        return ServeConfigSchema.parse(raw)


def _import_target(import_path: str):
    module, _, attr = import_path.partition(":")
    if not attr:
        raise ValueError(
            f"import_path {import_path!r} must be 'module:attribute'"
        )
    return getattr(importlib.import_module(module), attr)


def _apply_overrides(app: Application,
                     schema: ApplicationSchema) -> Application:
    dep = app.deployment
    for d in schema.deployments:
        if d.name != dep.name:
            continue
        auto = d.autoscaling_config
        dep = dep.options(
            num_replicas=d.num_replicas,
            max_ongoing_requests=d.max_ongoing_requests,
            autoscaling_config=AutoscalingConfig(**auto) if auto else None,
            ray_actor_options=d.ray_actor_options,
        )
        return Application(dep, app.init_args, app.init_kwargs)
    return app


def build_app(schema: ApplicationSchema) -> Application:
    """Import one application entry and apply its overrides. The target
    may be an Application (already bound), a Deployment (bound with the
    schema's args/kwargs), or a factory callable returning either."""
    target = _import_target(schema.import_path)
    built_by_call = False
    if callable(target) and not isinstance(target, (Application, Deployment)):
        target = target(*schema.args, **schema.kwargs)
        built_by_call = True
    if isinstance(target, Deployment):
        # args/kwargs go to exactly ONE consumer: the factory call above
        # (which already received them), or bind() for a bare Deployment
        if built_by_call:
            target = target.bind()
        else:
            target = target.bind(*schema.args, **schema.kwargs)
    if not isinstance(target, Application):
        raise TypeError(
            f"{schema.import_path} resolved to {type(target).__name__}; "
            "expected an Application, Deployment, or factory"
        )
    return _apply_overrides(target, schema)


def apply(config: ServeConfigSchema) -> Dict[str, Any]:
    """Deploy every application in the config; returns serve.status()."""
    from . import api as serve_api

    for schema in config.applications:
        app = build_app(schema)
        serve_api.run(app, name=schema.name, route_prefix=schema.route_prefix,
                      http_port=config.http_port)
        logger.info("deployed app %r from %s", schema.name, schema.import_path)
    return serve_api.status()
