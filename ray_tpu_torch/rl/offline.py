"""Offline RL data path (reference: `rllib/offline/` — offline data via
Ray Data) + behavior cloning (`rllib/algorithms/bc/`), MARWIL and CQL.

The port's counterpart of ray_tpu/rl/offline.py. Rollouts are persisted
through `ray_tpu_torch.data` (parquet columns per transition), so offline
training streams the same Dataset machinery as any other ingest:
read_parquet -> iter_batches -> an update on tensors on `device` (the
card unless the caller names another). CQL's target network is a copy of
the online tree (clone_tree); the reference binds the same immutable
tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List

import numpy as np
import torch

from .. import data as rt_data
from ..ops.dispatch import resolve_device
from .dqn import gather_actions, huber
from .module import adam, as_tensor, clone_tree, grad_step, init_mlp_module, mlp_forward


def rollouts_to_dataset(rollouts: Iterable[Dict[str, np.ndarray]],
                        gamma: float = None):
    """Flat rollouts (EnvRunner.sample output) -> row-wise Dataset of
    {obs, action, reward, done, next_obs} transitions. With `gamma`, each
    row also carries the Monte-Carlo discounted "return" from its step to
    the end of its episode (what MARWIL's advantage estimate needs); the
    trailing PARTIAL episode of each rollout — steps after the last done,
    cut off by the rollout length, not termination — is dropped in that
    mode, because its returns would omit all post-truncation reward and
    systematically bias advantages negative at rollout boundaries."""
    rows: List[Dict[str, Any]] = []
    for ro in rollouts:
        n = len(ro["obs"])
        returns = np.zeros(n, np.float32)
        if gamma is not None:
            done_idx = np.flatnonzero(np.asarray(ro["dones"]))
            n = int(done_idx[-1]) + 1 if len(done_idx) else 0
            acc = 0.0
            for t in reversed(range(n)):
                if bool(ro["dones"][t]):
                    acc = 0.0  # episodes are concatenated in one rollout
                acc = float(ro["rewards"][t]) + gamma * acc
                returns[t] = acc
        for t in range(n):
            row = {
                "obs": np.asarray(ro["obs"][t], np.float32),
                "action": int(ro["actions"][t]),
                "reward": float(ro["rewards"][t]),
                "done": bool(ro["dones"][t]),
                "next_obs": np.asarray(ro["next_obs"][t], np.float32),
            }
            if gamma is not None:
                row["return"] = float(returns[t])
            rows.append(row)
    if gamma is not None and not rows:
        raise ValueError(
            "no completed episodes in the rollouts: every transition was "
            "truncated (no done=True anywhere), so no Monte-Carlo return "
            "can be computed — collect longer rollouts or episode-aligned "
            "ones before MARWIL training"
        )
    return rt_data.from_items(rows)


def save_rollouts(rollouts: Iterable[Dict[str, np.ndarray]], path: str) -> None:
    """Persist rollouts as parquet (obs vectors as arrow list columns)."""
    rollouts_to_dataset(rollouts).write_parquet(path)


def load_offline_dataset(path: str):
    """Read transitions back; obs columns restored to float32 arrays."""
    ds = rt_data.read_parquet(path)
    return ds.map(lambda r: {**r, "obs": np.asarray(r["obs"], np.float32),
                             "next_obs": np.asarray(r["next_obs"], np.float32)})


@dataclasses.dataclass
class BCConfig:
    obs_size: int = 4
    num_actions: int = 2
    lr: float = 1e-3
    batch_size: int = 256
    hidden: tuple = (64, 64)
    seed: int = 0


def _nll(params, obs, actions):
    logits, value = mlp_forward(params, obs)
    logp = torch.log_softmax(logits, dim=-1)
    return -gather_actions(logp, actions), value


class BC:
    """Behavior cloning: cross-entropy on (obs, action) pairs from an
    offline Dataset. params: the initial module tree (by default drawn
    from config.seed)."""

    def __init__(self, config: BCConfig, device=None, params=None):
        self.config = config
        self.device = resolve_device(device)
        self.params = params if params is not None else init_mlp_module(
            config.seed, config.obs_size, config.num_actions, config.hidden,
            device=self.device)
        self.optimizer = adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)

    @staticmethod
    def _loss(params, obs, actions):
        nll, _ = _nll(params, obs, actions)
        return torch.mean(nll), None

    def _update(self, params, opt_state, obs, actions):
        """One step; params and opt_state change in place. Returns
        (params, opt_state, loss)."""
        loss, _ = grad_step(self.optimizer, opt_state, params, self._loss,
                            as_tensor(obs, self.device, torch.float32),
                            as_tensor(actions, self.device))
        return params, opt_state, loss

    def train_epoch(self, dataset) -> Dict[str, float]:
        """One pass over the offline dataset; returns mean loss + accuracy."""
        losses: List[float] = []
        correct = 0
        total = 0
        for batch in dataset.iter_batches(batch_size=self.config.batch_size):
            obs = as_tensor(np.asarray(batch["obs"], np.float32), self.device)
            actions = as_tensor(np.asarray(batch["action"], np.int32), self.device)
            self.params, self.opt_state, loss = self._update(
                self.params, self.opt_state, obs, actions
            )
            losses.append(float(loss))
            with torch.no_grad():
                logits, _ = mlp_forward(self.params, obs)
                correct += int(torch.sum(torch.argmax(logits, -1) == actions))
            total += len(actions)
        return {"loss": float(np.mean(losses)), "accuracy": correct / max(1, total)}


@dataclasses.dataclass
class MARWILConfig:
    obs_size: int = 4
    num_actions: int = 2
    lr: float = 1e-3
    batch_size: int = 256
    hidden: tuple = (64, 64)
    beta: float = 1.0        # 0 = plain BC; >0 weights by exp(beta * adv)
    vf_coeff: float = 1.0
    max_weight: float = 20.0  # cap on the exponential advantage weight
    seed: int = 0


class MARWIL:
    """Monotonic Advantage Re-Weighted Imitation Learning (reference:
    `rllib/algorithms/marwil/`): behavior cloning where each (obs, action)
    is weighted by exp(beta * advantage / c), advantage = MC return - V(s),
    with c^2 a running mean of squared advantages (the reference's moving
    normalizer) and a jointly-trained value head. Needs the "return"
    column from `rollouts_to_dataset(..., gamma=...)`."""

    def __init__(self, config: MARWILConfig, device=None, params=None):
        self.config = config
        self.device = resolve_device(device)
        self.params = params if params is not None else init_mlp_module(
            config.seed, config.obs_size, config.num_actions, config.hidden,
            device=self.device)
        self.optimizer = adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.c2 = 1.0  # running E[adv^2] (host scalar, like the reference)

    def _loss(self, params, obs, actions, returns, c):
        cfg = self.config
        nll, value = _nll(params, obs, actions)
        adv = returns - value
        weight = torch.exp(torch.clamp(cfg.beta * adv.detach() / c,
                                       max=float(np.log(np.float32(cfg.max_weight)))))
        policy_loss = torch.mean(weight * nll)
        vf_loss = torch.mean(adv ** 2)  # doubles as E[adv^2] for the c^2 ema
        return policy_loss + cfg.vf_coeff * vf_loss, vf_loss.detach()

    def _update(self, params, opt_state, obs, actions, returns, c):
        """One step; params and opt_state change in place. Returns
        (params, opt_state, loss, E[adv^2])."""
        d = self.device
        loss, adv_sq = grad_step(self.optimizer, opt_state, params, self._loss,
                                 as_tensor(obs, d, torch.float32), as_tensor(actions, d),
                                 as_tensor(returns, d, torch.float32), float(c))
        return params, opt_state, loss, adv_sq

    def train_epoch(self, dataset) -> Dict[str, float]:
        losses: List[float] = []
        for batch in dataset.iter_batches(batch_size=self.config.batch_size):
            obs = np.asarray(batch["obs"], np.float32)
            actions = np.asarray(batch["action"], np.int32)
            returns = np.asarray(batch["return"], np.float32)
            c = float(np.sqrt(self.c2) + 1e-8)
            self.params, self.opt_state, loss, adv_sq = self._update(
                self.params, self.opt_state, obs, actions, returns, c
            )
            # moving normalizer: c^2 <- c^2 + 1e-2 (E[adv^2] - c^2)
            self.c2 += 1e-2 * (float(adv_sq) - self.c2)
            losses.append(float(loss))
        return {"loss": float(np.mean(losses)), "c2": self.c2}


@dataclasses.dataclass
class CQLConfig:
    obs_size: int = 4
    num_actions: int = 2
    lr: float = 1e-3
    batch_size: int = 256
    hidden: tuple = (64, 64)
    gamma: float = 0.99
    alpha: float = 1.0             # conservative penalty coefficient
    target_update_every: int = 100  # gradient steps between target copies
    seed: int = 0


class CQL:
    """Conservative Q-Learning, discrete CQL(H) (reference:
    `rllib/algorithms/cql/`; Kumar et al. 2020): double-DQN TD learning on
    the offline transitions plus the conservative penalty
    E[logsumexp_a Q(s,a) - Q(s, a_data)], which pushes Q down on actions
    the behavior policy never took — the reason plain DQN collapses on
    offline data and CQL does not. The pi head doubles as the Q head."""

    def __init__(self, config: CQLConfig, device=None, params=None):
        self.config = config
        self.device = resolve_device(device)
        self.params = params if params is not None else init_mlp_module(
            config.seed, config.obs_size, config.num_actions, config.hidden,
            device=self.device)
        self.target_params = clone_tree(self.params)
        self.optimizer = adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.grad_steps = 0

    def _loss(self, params, target_params, obs, actions, rewards, dones, next_obs):
        cfg = self.config
        q, _ = mlp_forward(params, obs)
        q_a = gather_actions(q, actions)
        with torch.no_grad():
            # double-DQN target: online argmax, target net evaluation
            next_q_online, _ = mlp_forward(params, next_obs)
            next_q_target, _ = mlp_forward(target_params, next_obs)
            next_v = gather_actions(next_q_target, torch.argmax(next_q_online, dim=-1))
            target = rewards + cfg.gamma * (1.0 - dones) * next_v
        td_loss = torch.mean(huber(q_a - target))
        cql_penalty = torch.mean(torch.logsumexp(q, dim=-1) - q_a)
        return td_loss + cfg.alpha * cql_penalty, (td_loss.detach(), cql_penalty.detach())

    def _update(self, params, target_params, opt_state, obs, actions, rewards,
                dones, next_obs):
        """One step; params and opt_state change in place. Returns
        (params, opt_state, loss, (td_loss, cql_penalty))."""
        d = self.device
        loss, aux = grad_step(self.optimizer, opt_state, params, self._loss, target_params,
                              as_tensor(obs, d, torch.float32), as_tensor(actions, d),
                              as_tensor(rewards, d, torch.float32),
                              as_tensor(dones, d, torch.float32),
                              as_tensor(next_obs, d, torch.float32))
        return params, opt_state, loss, aux

    def train_epoch(self, dataset) -> Dict[str, float]:
        losses, penalties = [], []
        for batch in dataset.iter_batches(batch_size=self.config.batch_size):
            self.params, self.opt_state, loss, aux = self._update(
                self.params, self.target_params, self.opt_state,
                np.asarray(batch["obs"], np.float32), np.asarray(batch["action"], np.int32),
                np.asarray(batch["reward"], np.float32), np.asarray(batch["done"], np.float32),
                np.asarray(batch["next_obs"], np.float32)
            )
            self.grad_steps += 1
            if self.grad_steps % self.config.target_update_every == 0:
                self.target_params = clone_tree(self.params)
            losses.append(float(loss))
            penalties.append(float(aux[1]))
        return {"loss": float(np.mean(losses)),
                "cql_penalty": float(np.mean(penalties))}

    @torch.no_grad()
    def act(self, obs: np.ndarray) -> int:
        q, _ = mlp_forward(self.params, as_tensor(np.asarray(obs, np.float32)[None],
                                                  self.device))
        return int(torch.argmax(q[0]))
