"""APPO: asynchronous PPO (reference: `rllib/algorithms/appo/` — the
reference's flagship-throughput policy-gradient algorithm).

The port's counterpart of ray_tpu/rl/appo.py. Architecture = IMPALA's
decoupled actor/learner (behavior weights lag the learner; V-trace
corrects the off-policyness) with PPO's clipped surrogate objective on
the V-trace advantages instead of the plain importance-weighted PG loss.
The asynchrony that gives APPO its throughput: ``train()`` SUBMITS the
next round of sampling before learning on the previous round's rollouts,
so env stepping on the runner actors overlaps the learner's update on
the device — a two-stage pipeline over the task plane rather than the
reference's dedicated aggregation workers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.logging import get_logger
from ..ops.dispatch import resolve_device
from .env_runner import EnvRunnerGroup, fold_truncation_bootstrap
from .impala import vtrace_batch, vtrace_targets
from .module import (adam, clone_tree, grad_step, init_mlp_module,
                     mlp_forward_np)
from .ppo import entropy_of, policy_terms

logger = get_logger("rl.appo")


@dataclasses.dataclass
class APPOConfig:
    env_fn: Callable[[], Any] = None
    num_env_runners: int = 2
    num_envs_per_runner: int = 1  # >1: vectorized stepping per runner
    rollout_steps_per_runner: int = 256
    broadcast_interval: int = 1  # APPO syncs eagerly; V-trace absorbs lag
    lr: float = 5e-4
    gamma: float = 0.99
    rho_bar: float = 1.0
    c_bar: float = 1.0
    clip_eps: float = 0.2  # the PPO surrogate clip (the APPO delta)
    num_passes: int = 2  # >1 is safe under the clip (unlike plain IMPALA)
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


def appo_loss(params, batch, cfg):
    logp_all, values, target_logp = policy_terms(params, batch["obs"], batch["actions"])
    vs, pg_adv = vtrace_targets(
        batch["behavior_logp"], target_logp.detach(),
        batch["rewards"], values.detach(),
        batch["bootstrap_value"], batch["dones"],
        cfg.gamma, cfg.rho_bar, cfg.c_bar,
    )
    # jnp.std: the population standard deviation
    adv = (pg_adv - pg_adv.mean()) / (pg_adv.std(unbiased=False) + 1e-8)
    # PPO clipped surrogate on the V-trace advantages (the APPO
    # objective; reference appo_learner's surrogate on vtrace adv)
    ratio = torch.exp(target_logp - batch["behavior_logp"])
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    pg_loss = -torch.mean(torch.minimum(unclipped, clipped))
    baseline_loss = 0.5 * torch.mean((values - vs) ** 2)
    entropy = entropy_of(logp_all)
    total = (pg_loss + cfg.baseline_coef * baseline_loss
             - cfg.entropy_coef * entropy)
    return total, {"pg_loss": pg_loss.detach(), "baseline_loss": baseline_loss.detach(),
                   "entropy": entropy.detach()}


class APPO:
    def __init__(self, config: APPOConfig, device=None, params=None):
        assert config.env_fn is not None, "APPOConfig.env_fn required"
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
        self._inflight: Optional[List[Any]] = None  # pipelined sample refs
        self.iteration = 0
        self._recent_returns: List[float] = []

    def _update(self, params, opt_state, batch):
        """One clipped V-trace step on one rollout's `batch`; params and
        opt_state change in place and are returned."""
        loss, aux = grad_step(self.optimizer, opt_state, params, appo_loss,
                              vtrace_batch(batch, self.device), self.config)
        aux["loss"] = loss
        return params, opt_state, aux

    def train(self) -> Dict[str, Any]:
        """One iteration of the two-stage pipeline: submit sampling for
        round N+1, learn on round N's rollouts while the runners step."""
        cfg = self.config
        if self.iteration % cfg.broadcast_interval == 0:
            self.behavior_params = clone_tree(self.params)
        next_refs = self.runners.sample_async(
            cfg.rollout_steps_per_runner, self.behavior_params
        )
        if self._inflight is None:
            # first call: nothing to learn on yet — collect round 0 and
            # submit round 1 so the pipeline is primed (params=None: the
            # weights were just synced; re-pushing would block behind
            # round 0's whole rollout for nothing)
            self._inflight = next_refs
            next_refs = self.runners.sample_async(
                cfg.rollout_steps_per_runner, None
            )
        gen = self.runners.generation
        rollouts = self.runners.collect(self._inflight, self.behavior_params)
        if self.runners.generation != gen:
            # a runner was replaced mid-collect: next_refs submitted before
            # the restart point at the dead actor — resubmit the round, or
            # the NEXT collect fails again and replaces the healthy
            # replacement (orphaning its in-flight sample)
            next_refs = self.runners.sample_async(
                cfg.rollout_steps_per_runner, self.behavior_params
            )
        self._inflight = next_refs
        if not rollouts:
            raise RuntimeError("all env runners failed")
        metrics: Dict[str, Any] = {}
        ep_returns: List[float] = []
        timesteps = 0
        for ro in rollouts:
            if self._learner_conn is not None:
                ro = self._learner_conn(ro)
            timesteps += len(ro["obs"])
            ep_returns.extend(ro["episode_returns"].tolist())
            rew = fold_truncation_bootstrap(ro, cfg.gamma)
            batch = vtrace_batch({
                "obs": ro["obs"], "actions": ro["actions"], "rewards": rew,
                "dones": ro["dones"], "behavior_logp": ro["logp"],
                "bootstrap_value": ro["bootstrap_value"],
            }, self.device)
            for _ in range(max(1, cfg.num_passes)):
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
