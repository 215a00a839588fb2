"""@serve.deployment decorator + application graph (reference:
`python/ray/serve/api.py :: @serve.deployment`, `Deployment`, `.bind`).

The port's copy of ray_tpu/serve/deployment.py. A deployment's target is
reached as `Deployment._target` (e.g. `LLMServer._target(...)` builds the
plain class, outside any replica)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from .config import AutoscalingConfig, DeploymentConfig


@dataclasses.dataclass
class Application:
    deployment: "Deployment"
    init_args: Tuple[Any, ...]
    init_kwargs: dict


class Deployment:
    def __init__(self, cls_or_fn, name: str, config: DeploymentConfig):
        self._target = cls_or_fn
        self.name = name
        self.config = config

    def options(
        self,
        *,
        name: Optional[str] = None,
        num_replicas: Optional[int] = None,
        max_ongoing_requests: Optional[int] = None,
        autoscaling_config: Optional[AutoscalingConfig] = None,
        ray_actor_options: Optional[dict] = None,
        health_check_period_s: Optional[float] = None,
        health_check_timeout_s: Optional[float] = None,
    ) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        if health_check_period_s is not None:
            cfg.health_check_period_s = health_check_period_s
        if health_check_timeout_s is not None:
            cfg.health_check_timeout_s = health_check_timeout_s
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        return Deployment(self._target, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name}, replicas={self.config.num_replicas})"


def deployment(
    _target: Optional[Callable] = None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    max_ongoing_requests: int = 8,
    autoscaling_config: Optional[Any] = None,
    ray_actor_options: Optional[dict] = None,
    health_check_period_s: float = 10.0,
    health_check_timeout_s: float = 30.0,
):
    def wrap(target):
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=ray_actor_options or {},
            health_check_period_s=health_check_period_s,
            health_check_timeout_s=health_check_timeout_s,
        )
        if autoscaling_config is not None:
            cfg.autoscaling_config = (
                AutoscalingConfig(**autoscaling_config)
                if isinstance(autoscaling_config, dict)
                else autoscaling_config
            )
        return Deployment(target, name or target.__name__, cfg)

    if _target is not None:
        return wrap(_target)
    return wrap
