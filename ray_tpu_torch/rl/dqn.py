"""DQN (reference: `rllib/algorithms/dqn/` — double-DQN target, epsilon
-greedy collection, optional prioritized replay).

The port's counterpart of ray_tpu/rl/dqn.py. Same EnvRunnerGroup as PPO
does the sampling (epsilon-greedy over the module's logits read as
Q-values); the learner update is one function on tensors on `device`,
optax.huber_loss as F.huber_loss(delta=1.0). The target network is a copy
of the online tree (clone_tree), refreshed every target_update_freq
gradient steps; the reference binds the same immutable tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..core.logging import get_logger
from ..ops.dispatch import resolve_device
from .env_runner import EnvRunnerGroup
from .module import (adam, as_tensor, clone_tree, grad_step, init_mlp_module,
                     mlp_forward, mlp_forward_np)
from .replay_buffer import PrioritizedReplayBuffer, ReplayBuffer

logger = get_logger("rl.dqn")


@dataclasses.dataclass
class DQNConfig:
    env_fn: Callable[[], Any] = None
    num_env_runners: int = 1
    rollout_steps_per_runner: int = 256
    buffer_capacity: int = 50_000
    learning_starts: int = 512
    lr: float = 1e-3
    gamma: float = 0.99
    batch_size: int = 64
    sgd_steps_per_iter: int = 64
    target_update_freq: int = 500  # in gradient steps
    double_dqn: bool = True
    prioritized: bool = False
    prio_alpha: float = 0.6
    prio_beta: float = 0.4
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 5_000  # in env steps
    hidden: tuple = (64, 64)
    seed: int = 0


def huber(x: torch.Tensor) -> torch.Tensor:
    """optax.huber_loss(x) (delta 1.0), elementwise."""
    return F.huber_loss(x, torch.zeros_like(x), reduction="none", delta=1.0)


def gather_actions(q: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    return torch.gather(q, -1, actions.long()[:, None])[:, 0]


class DQN:
    def __init__(self, config: DQNConfig, device=None, params=None):
        assert config.env_fn is not None, "DQNConfig.env_fn required"
        self.config = config
        self.device = resolve_device(device)
        env = config.env_fn()
        self.params = params if params is not None else init_mlp_module(
            config.seed, env.observation_size, env.num_actions, config.hidden,
            device=self.device)
        self.target_params = clone_tree(self.params)
        self.optimizer = adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        if config.prioritized:
            self.buffer: ReplayBuffer = PrioritizedReplayBuffer(
                config.buffer_capacity, config.prio_alpha, config.prio_beta,
                seed=config.seed,
            )
        else:
            self.buffer = ReplayBuffer(config.buffer_capacity, seed=config.seed)
        self.runners = EnvRunnerGroup(
            config.env_fn, mlp_forward_np, config.num_env_runners, config.seed
        )
        self.iteration = 0
        self.env_steps = 0
        self.grad_steps = 0
        self._recent_returns: List[float] = []

    def _loss(self, params, target_params, batch):
        cfg = self.config
        q, _ = mlp_forward(params, batch["obs"])
        q_a = gather_actions(q, batch["actions"])
        with torch.no_grad():
            next_q_t, _ = mlp_forward(target_params, batch["next_obs"])
            if cfg.double_dqn:
                next_q_o, _ = mlp_forward(params, batch["next_obs"])
                next_v = gather_actions(next_q_t, torch.argmax(next_q_o, dim=-1))
            else:
                next_v = torch.max(next_q_t, dim=-1).values
            nonterminal = 1.0 - batch["dones"].float()
            target = batch["rewards"] + cfg.gamma * nonterminal * next_v
        td = q_a - target
        loss = torch.mean(batch["weights"] * huber(td))
        return loss, td.detach()

    def _update(self, params, target_params, opt_state, batch):
        """One gradient step on a replay `batch` (numpy or tensor columns,
        "weights" the importance weights): params and opt_state change in
        place. Returns (params, opt_state, loss, td)."""
        d = self.device
        b = {"obs": as_tensor(batch["obs"], d, torch.float32),
             "actions": as_tensor(batch["actions"], d),
             "rewards": as_tensor(batch["rewards"], d, torch.float32),
             "dones": as_tensor(batch["dones"], d),
             "next_obs": as_tensor(batch["next_obs"], d, torch.float32),
             "weights": as_tensor(batch["weights"], d, torch.float32)}
        loss, td = grad_step(self.optimizer, opt_state, params, self._loss, target_params, b)
        return params, opt_state, loss, td

    @property
    def epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def train(self) -> Dict[str, Any]:
        """One iteration: epsilon-greedy rollouts -> buffer -> SGD steps."""
        cfg = self.config
        rollouts = self.runners.sample(
            cfg.rollout_steps_per_runner, self.params, epsilon=self.epsilon
        )
        if not rollouts:
            raise RuntimeError("all env runners failed")
        ep_returns: List[float] = []
        for ro in rollouts:
            self.buffer.add_batch({
                "obs": ro["obs"], "actions": ro["actions"],
                # mask the 1-step bootstrap only on TRUE terminals: at a
                # time-limit truncation next_obs is the live pre-reset obs,
                # so the target net bootstraps from it
                "rewards": ro["rewards"],
                "dones": ro.get("terminateds", ro["dones"]),
                "next_obs": ro["next_obs"],
            })
            self.env_steps += len(ro["obs"])
            ep_returns.extend(ro["episode_returns"].tolist())

        losses = []
        if len(self.buffer) >= max(cfg.learning_starts, cfg.batch_size):
            for _ in range(cfg.sgd_steps_per_iter):
                if cfg.prioritized:
                    batch, idx, weights = self.buffer.sample(cfg.batch_size)
                else:
                    batch = self.buffer.sample(cfg.batch_size)
                    idx, weights = None, np.ones(cfg.batch_size, np.float32)
                jb = dict(batch, weights=weights)
                self.params, self.opt_state, loss, td = self._update(
                    self.params, self.target_params, self.opt_state, jb
                )
                if cfg.prioritized:
                    self.buffer.update_priorities(idx, td.cpu().numpy())
                self.grad_steps += 1
                if self.grad_steps % cfg.target_update_freq == 0:
                    self.target_params = clone_tree(self.params)
                losses.append(float(loss))

        self.iteration += 1
        self._recent_returns.extend(ep_returns)
        self._recent_returns = self._recent_returns[-100:]
        return {
            "training_iteration": self.iteration,
            "env_steps": self.env_steps,
            "grad_steps": self.grad_steps,
            "epsilon": self.epsilon,
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "buffer_size": len(self.buffer),
            "episodes_this_iter": len(ep_returns),
            "episode_return_mean": float(np.mean(self._recent_returns))
            if self._recent_returns else 0.0,
        }
