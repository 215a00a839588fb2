"""Central flag registry.

The port's copy of ray_tpu/core/config.py: every runtime knob is declared
once here with a type, default and doc, and resolves with precedence
env RAY_TPU_<NAME> > default. The variables are the reference's, so one
environment configures both packages. Only the flags the port reads are
declared.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict

__all__ = ["Config", "config", "declare"]

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def _parse_bool(s: str) -> bool:
    low = s.strip().lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise ValueError(f"not a boolean: {s!r}")


@dataclasses.dataclass(frozen=True)
class _Field:
    name: str
    default: Any
    doc: str
    parser: Callable[[str], Any]


_REGISTRY: Dict[str, _Field] = {}


def declare(name: str, default: Any, doc: str = "") -> None:
    """Declare a config flag. Types are inferred from the default."""
    if name in _REGISTRY:
        raise ValueError(f"duplicate config flag: {name}")
    if isinstance(default, bool):
        parser: Callable[[str], Any] = _parse_bool
    elif isinstance(default, int):
        parser = int
    elif isinstance(default, float):
        parser = float
    else:
        parser = str
    _REGISTRY[name] = _Field(name, default, doc, parser)


# ---------------------------------------------------------------------------
# Flag declarations, with the reference's names, defaults and docs.
# ---------------------------------------------------------------------------

# Observability
declare(
    "trace_sample_rate", 0.0,
    "Fraction of serve requests that open a root trace span at the API "
    "entry point (util/tracing.py). 0 disables sampling entirely (the "
    "zero-overhead default); requests arriving under an already-active "
    "span are always traced regardless of this rate.",
)

# SLO digests (util/slo.py)
declare(
    "slo_digests", True,
    "Update streaming latency digests (util/slo.py: TTFT, time-between-"
    "tokens, e2e) inline in the serve hot paths. Off = zero digest work.",
)
declare(
    "slo_digest_window_s", 60.0,
    "Sliding window the per-process latency digests answer quantile "
    "queries over (rotated in slo._SLICES sub-windows).",
)


class Config:
    """Resolved configuration view: the environment, else the default."""

    def get(self, name: str) -> Any:
        field = _REGISTRY.get(name)
        if field is None:
            raise KeyError(f"unknown config flag: {name}")
        env = os.environ.get(f"RAY_TPU_{name.upper()}")
        if env is not None:
            return field.parser(env)
        return field.default

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)


config = Config()
