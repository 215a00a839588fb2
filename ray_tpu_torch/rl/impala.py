"""IMPALA (reference: `rllib/algorithms/impala/` — distributed actor-
learner with V-trace off-policy correction, Espeholt et al. 2018).

The port's counterpart of ray_tpu/rl/impala.py. EnvRunner actors sample
with a BEHAVIOR policy that lags the learner (weights broadcast every
`broadcast_interval` iterations, like the reference's asynchronous weight
sync), and the learner corrects the off-policyness with V-trace: clipped
importance ratios rho/c weight the TD errors, accumulated by a reverse
loop over the rollout (the reference's backward lax.scan). The behavior
policy is a copy of the learner's tree (clone_tree), which the in-place
updates leave alone; the reference binds the same immutable tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..core.logging import get_logger
from ..ops.dispatch import resolve_device
from .env_runner import EnvRunnerGroup, fold_truncation_bootstrap
from .module import (adam, as_tensor, clone_tree, grad_step, init_mlp_module,
                     mlp_forward_np)
from .ppo import entropy_of, policy_terms

logger = get_logger("rl.impala")


@dataclasses.dataclass
class IMPALAConfig:
    env_fn: Callable[[], Any] = None
    num_env_runners: int = 2
    num_envs_per_runner: int = 1  # >1: vectorized stepping per runner
    rollout_steps_per_runner: int = 256
    broadcast_interval: int = 2  # iterations between behavior-weight syncs
    lr: float = 5e-4
    gamma: float = 0.99
    rho_bar: float = 1.0  # V-trace importance clip for the TD term
    c_bar: float = 1.0  # V-trace trace-cutting clip
    num_passes: int = 1  # SGD passes per rollout (V-trace corrects the drift)
    entropy_coef: float = 0.01
    baseline_coef: float = 0.5
    hidden: tuple = (64, 64)
    seed: int = 0
    # connector pipelines (reference: rllib/connectors):
    # env_to_module transforms observations on the runner,
    # module_to_env transforms logits before action selection,
    # learner transforms whole rollouts before the update
    env_to_module_connectors: tuple = ()
    module_to_env_connectors: tuple = ()
    learner_connectors: tuple = ()


def vtrace_targets(behavior_logp, target_logp, rewards, values,
                   bootstrap_value, dones, gamma, rho_bar, c_bar):
    """V-trace value targets + policy-gradient advantages.

    All inputs are flat [T] tensors (bootstrap_value a scalar); `dones`
    cuts episodes (terminal transitions bootstrap nothing and traces do
    not cross the boundary). No gradient flows through the result."""
    with torch.no_grad():
        ratio = torch.exp(target_logp - behavior_logp)
        rho = torch.clamp(ratio, max=rho_bar)
        c = torch.clamp(ratio, max=c_bar)
        nonterminal = 1.0 - dones.float()
        boot = torch.as_tensor(bootstrap_value, dtype=values.dtype,
                               device=values.device).reshape(1)
        next_values = torch.cat([values[1:], boot])
        # at an episode cut, the "next state" belongs to a new episode:
        # bootstrap with 0 (terminal) via the nonterminal mask
        deltas = rho * (rewards + gamma * nonterminal * next_values - values)
        # the reverse scan: acc_t = delta_t + gamma nt_t c_t acc_{t+1}
        coef = (gamma * nonterminal * c).tolist()
        d = deltas.tolist()
        acc = 0.0
        out = [0.0] * len(d)
        for t in reversed(range(len(d))):
            acc = np.float32(d[t]) + np.float32(coef[t]) * np.float32(acc)
            out[t] = float(acc)
        vs_minus_v = torch.tensor(out, dtype=values.dtype, device=values.device)
        vs = values + vs_minus_v
        next_vs = torch.cat([vs[1:], boot])
        pg_adv = rho * (rewards + gamma * nonterminal * next_vs - values)
    return vs, pg_adv


def vtrace_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A rollout's columns as tensors for the V-trace learners."""
    return {"obs": as_tensor(batch["obs"], device, torch.float32),
            "actions": as_tensor(batch["actions"], device),
            "rewards": as_tensor(batch["rewards"], device, torch.float32),
            "dones": as_tensor(batch["dones"], device),
            "behavior_logp": as_tensor(batch["behavior_logp"], device, torch.float32),
            "bootstrap_value": float(np.asarray(batch["bootstrap_value"]))}


def impala_loss(params, batch, cfg):
    logp_all, values, target_logp = policy_terms(params, batch["obs"], batch["actions"])
    vs, pg_adv = vtrace_targets(
        batch["behavior_logp"], target_logp.detach(),
        batch["rewards"], values.detach(),
        batch["bootstrap_value"], batch["dones"],
        cfg.gamma, cfg.rho_bar, cfg.c_bar,
    )
    pg_loss = -torch.mean(pg_adv * target_logp)
    baseline_loss = 0.5 * torch.mean((values - vs) ** 2)
    entropy = entropy_of(logp_all)
    total = (pg_loss + cfg.baseline_coef * baseline_loss
             - cfg.entropy_coef * entropy)
    return total, {"pg_loss": pg_loss.detach(), "baseline_loss": baseline_loss.detach(),
                   "entropy": entropy.detach()}


class IMPALA:
    def __init__(self, config: IMPALAConfig, device=None, params=None):
        assert config.env_fn is not None, "IMPALAConfig.env_fn required"
        self.config = config
        self.device = resolve_device(device)
        env = config.env_fn()
        self.params = params if params is not None else init_mlp_module(
            config.seed, env.observation_size, env.num_actions, config.hidden,
            device=self.device)
        self.behavior_params = clone_tree(self.params)
        self.optimizer = adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.runners = EnvRunnerGroup(
            config.env_fn, mlp_forward_np, config.num_env_runners,
            config.seed, num_envs_per_runner=config.num_envs_per_runner,
            connectors=config.env_to_module_connectors,
            action_connectors=config.module_to_env_connectors,
        )
        from .connectors import build_pipeline

        self._learner_conn = build_pipeline(config.learner_connectors)
        self.iteration = 0
        self._recent_returns: List[float] = []

    def _update(self, params, opt_state, batch):
        """One V-trace-corrected gradient step on one rollout's `batch`;
        params and opt_state change in place and are returned."""
        loss, aux = grad_step(self.optimizer, opt_state, params, impala_loss,
                              vtrace_batch(batch, self.device), self.config)
        aux["loss"] = loss
        return params, opt_state, aux

    def train(self) -> Dict[str, Any]:
        """One iteration: sample with the (possibly stale) behavior policy,
        one V-trace-corrected gradient step per rollout."""
        cfg = self.config
        if self.iteration % cfg.broadcast_interval == 0:
            self.behavior_params = clone_tree(self.params)  # async-style weight sync
        # ALWAYS pass the (stale) behavior params: a runner restarted after
        # a crash mid-interval starts weightless and would assert on every
        # sample until the next broadcast otherwise. Passing the same stale
        # tree preserves the intended behavior lag.
        rollouts = self.runners.sample(
            cfg.rollout_steps_per_runner, self.behavior_params
        )
        if not rollouts:
            raise RuntimeError("all env runners failed")
        metrics: Dict[str, Any] = {}
        ep_returns: List[float] = []
        timesteps = 0
        batches = []  # host->device once, reused across passes
        if self._learner_conn is not None:
            rollouts = [self._learner_conn(ro) for ro in rollouts]
        for ro in rollouts:
            timesteps += len(ro["obs"])
            ep_returns.extend(ro["episode_returns"].tolist())
            rew = fold_truncation_bootstrap(ro, cfg.gamma)
            batches.append(vtrace_batch({
                "obs": ro["obs"], "actions": ro["actions"], "rewards": rew,
                "dones": ro["dones"], "behavior_logp": ro["logp"],
                "bootstrap_value": ro["bootstrap_value"],
            }, self.device))
        for _ in range(max(1, cfg.num_passes)):
            for batch in batches:
                self.params, self.opt_state, metrics = self._update(
                    self.params, self.opt_state, batch
                )
        self.iteration += 1
        self._recent_returns.extend(ep_returns)
        self._recent_returns = self._recent_returns[-100:]
        out = {k: float(v) for k, v in metrics.items()}
        out.update({
            "training_iteration": self.iteration,
            "episodes_this_iter": len(ep_returns),
            "timesteps_this_iter": timesteps,
            "episode_return_mean": float(np.mean(self._recent_returns))
            if self._recent_returns else 0.0,
        })
        return out
