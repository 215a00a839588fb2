"""Connector pipelines (reference: `rllib/connectors/` — the new API
stack's pluggable transform chains between env, module, and learner).

The port's copy of ray_tpu/rl/connectors.py, unchanged: numpy only, so the
same seed draws the same numbers in both packages.

Three hook points, same as the reference:

- env-to-module: per-step observation transforms on the RUNNER before
  the policy forward (flatten/scale/one-hot/clip — host numpy, µs-cheap).
- module-to-env: per-step logits transforms before action selection
  (action masking, temperature). NOTE for on-policy / importance-
  sampling learners (PPO/APPO/IMPALA): the stored behavior logp comes
  from the TRANSFORMED distribution while those learners recompute
  target logp from raw module logits — a distribution-changing
  transform (masking) therefore biases their ratios. Use it with
  learners that don't recompute logp (DQN-style), or fold validity into
  the observation so the module itself learns the mask.
- learner: whole-rollout transforms on the LEARNER before the
  update — they receive the ROLLOUT DICT (obs/actions/rewards/... flat
  arrays), e.g. ClipReward or a LambdaConnector re-featurizing columns.
  (Per-step observation normalization belongs on env-to-module where
  the stream order matches what the module saw.)

A pipeline is an ordered list of callables with insert/prepend/append
surgery (the reference's ConnectorPipelineV2 ergonomics). Connectors are
plain callables `(x, ctx) -> x`; stateful ones keep attributes (they
live on the runner actor / learner process respectively)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np


class Connector:
    """Base: override __call__(x, ctx) -> x. ctx is a dict the caller
    threads through (e.g. {"phase": "env_to_module", "runner": ...})."""

    def __call__(self, x, ctx: Optional[Dict[str, Any]] = None):
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


class LambdaConnector(Connector):
    def __init__(self, fn: Callable, name: str = ""):
        self._fn = fn
        self._name = name or getattr(fn, "__name__", "lambda")

    def __call__(self, x, ctx=None):
        return self._fn(x)

    @property
    def name(self) -> str:
        return self._name


class ConnectorPipeline:
    """Ordered connector chain with the reference's surgery ergonomics."""

    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors: List[Connector] = list(connectors or [])

    def __call__(self, x, ctx: Optional[Dict[str, Any]] = None):
        for c in self.connectors:
            x = c(x, ctx)
        return x

    def append(self, c: Connector) -> "ConnectorPipeline":
        self.connectors.append(c)
        return self

    def prepend(self, c: Connector) -> "ConnectorPipeline":
        self.connectors.insert(0, c)
        return self

    def insert_after(self, name: str, c: Connector) -> "ConnectorPipeline":
        for i, existing in enumerate(self.connectors):
            if existing.name == name:
                self.connectors.insert(i + 1, c)
                return self
        raise ValueError(f"no connector named {name!r} in pipeline")

    def remove(self, name: str) -> "ConnectorPipeline":
        self.connectors = [c for c in self.connectors if c.name != name]
        return self

    def __len__(self) -> int:
        return len(self.connectors)

    def __repr__(self):
        return f"ConnectorPipeline([{', '.join(c.name for c in self.connectors)}])"


# --------------------------------------------------------------------------
# built-ins (reference: rllib/connectors/env_to_module/*, learner/*)
# --------------------------------------------------------------------------


class FlattenObs(Connector):
    """[..., any shape] observations -> flat vectors."""

    def __call__(self, obs, ctx=None):
        obs = np.asarray(obs)
        if obs.ndim <= 1:
            return obs
        return obs.reshape(obs.shape[0], -1) if ctx and ctx.get("batched") \
            else obs.reshape(-1)


class ScaleObs(Connector):
    def __init__(self, scale: float = 1.0, offset: float = 0.0):
        self.scale = scale
        self.offset = offset

    def __call__(self, obs, ctx=None):
        return (np.asarray(obs, np.float32) + self.offset) * self.scale


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, obs, ctx=None):
        return np.clip(np.asarray(obs, np.float32), self.low, self.high)


class NormalizeObs(Connector):
    """Running mean/std observation normalization (Welford). State lives
    on the runner actor; each runner tracks its own stream (the
    reference's per-EnvRunner MeanStdFilter shape)."""

    def __init__(self, eps: float = 1e-8, clip: float = 10.0):
        self.count = 0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None
        self.eps = eps
        self.clip = clip

    def __call__(self, obs, ctx=None):
        obs = np.asarray(obs, np.float32)
        flat = obs.reshape(-1, obs.shape[-1]) if obs.ndim > 1 else obs[None]
        for row in flat:
            self.count += 1
            if self.mean is None:
                self.mean = row.copy()
                self.m2 = np.zeros_like(row)
            else:
                d = row - self.mean
                self.mean += d / self.count
                self.m2 += d * (row - self.mean)
        std = np.sqrt(self.m2 / max(self.count - 1, 1)) + self.eps \
            if self.m2 is not None else 1.0
        return np.clip((obs - self.mean) / std, -self.clip, self.clip)


class ClipReward(Connector):
    """Learner connector: clip rollout rewards in place (Atari-style)."""

    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, rollout: Dict[str, np.ndarray], ctx=None):
        rollout = dict(rollout)
        rollout["rewards"] = np.clip(rollout["rewards"], self.low, self.high)
        return rollout


class MaskLogits(Connector):
    """module-to-env connector: -inf the logits of invalid actions. The
    mask comes from ctx['obs'] via mask_fn (envs that encode validity in
    the observation). Epsilon-greedy exploration respects the mask (the
    runners draw uniformly over p>0 actions). See the module docstring's
    caveat about on-policy learners recomputing logp from raw logits."""

    def __init__(self, mask_fn: Callable[[np.ndarray], np.ndarray]):
        self.mask_fn = mask_fn

    def __call__(self, logits, ctx=None):
        obs = ctx.get("obs") if ctx else None
        if obs is None:
            return logits
        mask = np.asarray(self.mask_fn(np.asarray(obs)), bool)
        out = np.array(logits, np.float32, copy=True)
        out[~mask] = -1e30
        return out


def build_pipeline(connectors) -> Optional[ConnectorPipeline]:
    """None/[] -> None; list of callables/Connectors -> pipeline."""
    if not connectors:
        return None
    out = []
    for c in connectors:
        if isinstance(c, Connector):
            out.append(c)
        elif callable(c):
            out.append(LambdaConnector(c))
        else:
            raise TypeError(f"not a connector: {c!r}")
    return ConnectorPipeline(out)
