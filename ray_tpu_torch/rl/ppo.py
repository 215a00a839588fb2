"""PPO (reference: `rllib/algorithms/ppo/` on the new API stack:
EnvRunnerGroup sampling + Learner update).

The port's counterpart of ray_tpu/rl/ppo.py. The learner update is one
function on tensors (clipped surrogate + value loss + entropy bonus, GAE
on host), its gradient from autograd and its step optax.adam's (module.adam),
on `device` (the card unless the caller names another). The rollouts,
GAE and the minibatch order are the reference's numpy code.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..core.logging import get_logger
from ..ops.dispatch import resolve_device
from .env_runner import EnvRunnerGroup, fold_truncation_bootstrap
from .module import adam, as_tensor, grad_step, init_mlp_module, mlp_forward, mlp_forward_np

logger = get_logger("rl.ppo")


@dataclasses.dataclass
class PPOConfig:
    env_fn: Callable[[], Any] = None
    num_env_runners: int = 2
    rollout_steps_per_runner: int = 512
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    vf_coef: float = 0.5
    num_epochs: int = 4
    minibatch_size: int = 256
    hidden: tuple = (64, 64)
    seed: int = 0
    # connector pipelines (reference: rllib/connectors):
    # env_to_module transforms observations on the runner,
    # module_to_env transforms logits before action selection,
    # learner transforms whole rollouts before the update
    env_to_module_connectors: tuple = ()
    module_to_env_connectors: tuple = ()
    learner_connectors: tuple = ()


def compute_gae(rewards, values, dones, bootstrap_value, gamma, lam):
    """Generalized advantage estimation over a flat rollout."""
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    last = 0.0
    next_v = bootstrap_value
    for t in reversed(range(T)):
        nonterminal = 0.0 if dones[t] else 1.0
        delta = rewards[t] + gamma * next_v * nonterminal - values[t]
        last = delta + gamma * lam * nonterminal * last
        adv[t] = last
        next_v = values[t]
    returns = adv + values
    return adv, returns


def policy_terms(params, obs, actions):
    """(log-softmax [B, A], value [B], logp of `actions` [B])."""
    logits, values = mlp_forward(params, obs)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, -1, actions.long()[:, None])[:, 0]
    return logp_all, values, logp


def entropy_of(logp_all) -> torch.Tensor:
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))


def ppo_loss(params, batch, clip_eps, vf_coef, entropy_coef):
    """The clipped surrogate + value loss - entropy bonus: (total, aux)."""
    logp_all, values, logp = policy_terms(params, batch["obs"], batch["actions"])
    ratio = torch.exp(logp - batch["logp_old"])
    adv = batch["advantages"]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
    pi_loss = -torch.mean(torch.minimum(unclipped, clipped))
    vf_loss = torch.mean((values - batch["returns"]) ** 2)
    entropy = entropy_of(logp_all)
    total = pi_loss + vf_coef * vf_loss - entropy_coef * entropy
    return total, {"pi_loss": pi_loss.detach(), "vf_loss": vf_loss.detach(),
                   "entropy": entropy.detach()}


class PPO:
    """params: the initial module tree (module_from_numpy of the
    reference's, say); by default drawn from config.seed."""

    def __init__(self, config: PPOConfig, device=None, params=None):
        assert config.env_fn is not None, "PPOConfig.env_fn required"
        self.config = config
        self.device = resolve_device(device)
        env = config.env_fn()
        self.params = params if params is not None else init_mlp_module(
            config.seed, env.observation_size, env.num_actions, config.hidden,
            device=self.device)
        self.optimizer = adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.runners = EnvRunnerGroup(
            config.env_fn, mlp_forward_np, config.num_env_runners, config.seed,
            connectors=config.env_to_module_connectors,
            action_connectors=config.module_to_env_connectors,
        )
        from .connectors import build_pipeline

        self._learner_conn = build_pipeline(config.learner_connectors)
        self.iteration = 0
        self._recent_returns: List[float] = []

    def _update(self, params, opt_state, batch):
        """One gradient step on `batch` (numpy or tensor columns): params
        and opt_state change in place and are returned, with the losses."""
        cfg = self.config
        b = {"obs": as_tensor(batch["obs"], self.device, torch.float32),
             "actions": as_tensor(batch["actions"], self.device),
             "logp_old": as_tensor(batch["logp_old"], self.device, torch.float32),
             "advantages": as_tensor(batch["advantages"], self.device, torch.float32),
             "returns": as_tensor(batch["returns"], self.device, torch.float32)}
        loss, aux = grad_step(self.optimizer, opt_state, params, ppo_loss, b,
                              cfg.clip_eps, cfg.vf_coef, cfg.entropy_coef)
        aux["loss"] = loss
        return params, opt_state, aux

    def train(self) -> Dict[str, Any]:
        """One training iteration: sample -> GAE -> minibatch SGD epochs."""
        cfg = self.config
        rollouts = self.runners.sample(cfg.rollout_steps_per_runner, self.params)
        if not rollouts:
            raise RuntimeError("all env runners failed")
        obs, acts, logp, advs, rets = [], [], [], [], []
        ep_returns: List[float] = []
        if self._learner_conn is not None:
            rollouts = [self._learner_conn(ro) for ro in rollouts]
        for ro in rollouts:
            adv, ret = compute_gae(
                fold_truncation_bootstrap(ro, cfg.gamma),
                ro["values"], ro["dones"],
                ro["bootstrap_value"], cfg.gamma, cfg.gae_lambda,
            )
            obs.append(ro["obs"]); acts.append(ro["actions"])
            logp.append(ro["logp"]); advs.append(adv); rets.append(ret)
            ep_returns.extend(ro["episode_returns"].tolist())
        obs = np.concatenate(obs); acts = np.concatenate(acts)
        logp = np.concatenate(logp); advs = np.concatenate(advs)
        rets = np.concatenate(rets)
        advs = (advs - advs.mean()) / (advs.std() + 1e-8)

        n = len(obs)
        rng = np.random.default_rng(cfg.seed + self.iteration)
        metrics: Dict[str, Any] = {}
        for _ in range(cfg.num_epochs):
            order = rng.permutation(n)
            for lo in range(0, n, cfg.minibatch_size):
                idx = order[lo: lo + cfg.minibatch_size]
                batch = {"obs": obs[idx], "actions": acts[idx], "logp_old": logp[idx],
                         "advantages": advs[idx], "returns": rets[idx]}
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
            "episode_return_mean": float(np.mean(self._recent_returns))
            if self._recent_returns else 0.0,
            "timesteps_this_iter": n,
        })
        return out
