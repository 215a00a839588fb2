"""SAC, discrete-action variant (reference: `rllib/algorithms/sac/` —
soft actor-critic with twin Q networks and learned entropy temperature;
discrete formulation per Christodoulou 2019).

The port's counterpart of ray_tpu/rl/sac.py. Discrete actions make every
expectation over the policy EXACT (a sum over the action set instead of a
reparameterized sample), so the soft targets, policy loss, and entropy
all compute in closed form inside one update — no sampling noise in the
learner. Off-policy: transitions come from the shared ReplayBuffer;
collection uses the same EnvRunner actors (softmax over the policy logits
is exactly the SAC behavior policy). The target networks are copies of
the critics (clone_tree), moved toward them by polyak averaging in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..core.logging import get_logger
from ..ops.dispatch import resolve_device
from .env_runner import EnvRunnerGroup
from .module import (adam, _generator, as_tensor, clone_tree, grad_step, init_mlp_module,
                     mlp_forward, mlp_forward_np, tree_leaves)
from .replay_buffer import ReplayBuffer

logger = get_logger("rl.sac")


@dataclasses.dataclass
class SACConfig:
    env_fn: Callable[[], Any] = None
    num_env_runners: int = 1
    rollout_steps_per_runner: int = 256
    buffer_capacity: int = 50_000
    learning_starts: int = 512
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.01  # polyak coefficient for target networks
    batch_size: int = 64
    sgd_steps_per_iter: int = 64
    target_entropy_scale: float = 0.7  # fraction of max entropy log|A|
    init_alpha: float = 0.2
    hidden: tuple = (64, 64)
    seed: int = 0


def q_of(params, obs):
    q, _ = mlp_forward(params, obs)
    return q  # [B, A]


def policy(params, obs):
    logits, _ = mlp_forward(params, obs)
    logp = torch.log_softmax(logits, dim=-1)
    return torch.exp(logp), logp  # probs, log-probs [B, A]


class SAC:
    """params: {"pi", "q1", "q2"} initial trees (module_from_numpy of the
    reference's, say); by default drawn from config.seed."""

    def __init__(self, config: SACConfig, device=None, params=None):
        assert config.env_fn is not None, "SACConfig.env_fn required"
        self.config = config
        self.device = resolve_device(device)
        env = config.env_fn()
        self.num_actions = env.num_actions
        if params is None:
            g = _generator(config.seed)
            # pi head of each module = policy logits / Q values respectively
            params = {k: init_mlp_module(g, env.observation_size, env.num_actions,
                                         config.hidden, device=self.device)
                      for k in ("pi", "q1", "q2")}
        self.pi, self.q1, self.q2 = params["pi"], params["q1"], params["q2"]
        self.q1_target = clone_tree(self.q1)
        self.q2_target = clone_tree(self.q2)
        self.log_alpha = torch.tensor(np.log(config.init_alpha), dtype=torch.float32,
                                      device=self.device)
        self.opt = adam(config.lr)
        self.pi_opt = self.opt.init(self.pi)
        self.q1_opt = self.opt.init(self.q1)
        self.q2_opt = self.opt.init(self.q2)
        self.alpha_opt = self.opt.init(self.log_alpha)
        self.buffer = ReplayBuffer(config.buffer_capacity, seed=config.seed)
        self.runners = EnvRunnerGroup(
            config.env_fn, mlp_forward_np, config.num_env_runners, config.seed
        )
        self.target_entropy = (
            config.target_entropy_scale * float(np.log(env.num_actions))
        )
        self.iteration = 0
        self.grad_steps = 0
        self._recent_returns: List[float] = []

    def _update(self, pi, q1, q2, q1_t, q2_t, log_alpha,
                pi_opt, q1_opt, q2_opt, alpha_opt, batch):
        """One SAC step, as the reference's: both critics toward the exact
        soft target, then the actor against the updated critics, then the
        temperature, then polyak targets. Every tree and state changes in
        place (log_alpha too) and is returned in the reference's order,
        with the losses."""
        cfg = self.config
        d = self.device
        b = {"obs": as_tensor(batch["obs"], d, torch.float32),
             "actions": as_tensor(batch["actions"], d),
             "rewards": as_tensor(batch["rewards"], d, torch.float32),
             "dones": as_tensor(batch["dones"], d),
             "next_obs": as_tensor(batch["next_obs"], d, torch.float32)}
        with torch.no_grad():  # the exact soft state value: E_pi[min Q - alpha log pi]
            probs, logp = policy(pi, b["next_obs"])
            q_min = torch.minimum(q_of(q1_t, b["next_obs"]), q_of(q2_t, b["next_obs"]))
            v_next = torch.sum(probs * (q_min - torch.exp(log_alpha) * logp), dim=-1)
            target = b["rewards"] + cfg.gamma * (1.0 - b["dones"].float()) * v_next

        def critic_loss(q_params):
            q_a = torch.gather(q_of(q_params, b["obs"]), -1, b["actions"].long()[:, None])[:, 0]
            return torch.mean((q_a - target) ** 2), None

        q1_l, _ = grad_step(self.opt, q1_opt, q1, critic_loss)
        q2_l, _ = grad_step(self.opt, q2_opt, q2, critic_loss)

        with torch.no_grad():
            q_min = torch.minimum(q_of(q1, b["obs"]), q_of(q2, b["obs"]))
            alpha = torch.exp(log_alpha)

        def actor_loss(pi_params):
            probs, logp = policy(pi_params, b["obs"])
            loss = torch.mean(torch.sum(probs * (alpha * logp - q_min), dim=-1))
            entropy = -torch.mean(torch.sum(probs * logp, dim=-1))
            return loss, entropy.detach()

        pi_l, entropy = grad_step(self.opt, pi_opt, pi, actor_loss)

        def alpha_loss(la):
            # drive entropy toward the target; alpha rises when entropy is low
            return -la * (self.target_entropy - entropy), None

        grad_step(self.opt, alpha_opt, log_alpha, alpha_loss)

        with torch.no_grad():
            for tree_t, tree in ((q1_t, q1), (q2_t, q2)):
                for t, o in zip(tree_leaves(tree_t), tree_leaves(tree)):
                    t.copy_((1 - cfg.tau) * t + cfg.tau * o)
        aux = {"q1_loss": q1_l, "q2_loss": q2_l, "pi_loss": pi_l,
               "entropy": entropy, "alpha": torch.exp(log_alpha.detach())}
        return (pi, q1, q2, q1_t, q2_t, log_alpha,
                pi_opt, q1_opt, q2_opt, alpha_opt, aux)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        # softmax over policy logits IS the SAC behavior policy
        rollouts = self.runners.sample(cfg.rollout_steps_per_runner, self.pi)
        if not rollouts:
            raise RuntimeError("all env runners failed")
        ep_returns: List[float] = []
        for ro in rollouts:
            self.buffer.add_batch({
                "obs": ro["obs"], "actions": ro["actions"],
                # true terminals only — truncations bootstrap from
                # next_obs via the soft target
                "rewards": ro["rewards"],
                "dones": ro.get("terminateds", ro["dones"]),
                "next_obs": ro["next_obs"],
            })
            ep_returns.extend(ro["episode_returns"].tolist())

        aux: Dict[str, Any] = {}
        if len(self.buffer) >= max(cfg.learning_starts, cfg.batch_size):
            for _ in range(cfg.sgd_steps_per_iter):
                batch = self.buffer.sample(cfg.batch_size)
                (self.pi, self.q1, self.q2, self.q1_target, self.q2_target,
                 self.log_alpha, self.pi_opt, self.q1_opt, self.q2_opt,
                 self.alpha_opt, aux) = self._update(
                    self.pi, self.q1, self.q2, self.q1_target, self.q2_target,
                    self.log_alpha, self.pi_opt, self.q1_opt, self.q2_opt,
                    self.alpha_opt, batch,
                )
                self.grad_steps += 1

        self.iteration += 1
        self._recent_returns.extend(ep_returns)
        self._recent_returns = self._recent_returns[-100:]
        out = {k: float(v) for k, v in aux.items()}
        out.update({
            "training_iteration": self.iteration,
            "grad_steps": self.grad_steps,
            "buffer_size": len(self.buffer),
            "episodes_this_iter": len(ep_returns),
            "episode_return_mean": float(np.mean(self._recent_returns))
            if self._recent_returns else 0.0,
        })
        return out
