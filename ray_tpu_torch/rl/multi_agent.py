"""Multi-agent RL (reference: `rllib/env/multi_agent_env.py` +
multi-agent episode handling in the new API stack).

A MultiAgentEnv steps dicts keyed by agent id; a policy_mapping_fn routes
each agent to a policy id. MultiAgentEnvRunner produces per-POLICY flat
rollouts (all agents mapped to a policy share its batch), so the PPO
learner update applies per policy unchanged.

The port's counterpart of ray_tpu/rl/multi_agent.py: the env and the
runner are the reference's numpy code (the runner an actor of the port's
runtime, its weights copied to the host at set_weights), the learner
update PPO's loss on tensors on `device` (the card unless named).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import api
from ..core.logging import get_logger
from ..ops.dispatch import resolve_device
from .env import CartPole
from .module import adam, as_tensor, grad_step, init_mlp_module, mlp_forward_np, tree_to_numpy
from .ppo import ppo_loss

logger = get_logger("rl.multi_agent")


class MultiAgentEnv:
    """Dict-keyed env: obs/rewards/dones per agent id; "__all__" in the
    terminated dict ends the episode (gymnasium multi-agent convention)."""

    agent_ids: Tuple[str, ...]
    observation_size: int
    num_actions: int

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, int]):
        """-> (obs_d, reward_d, terminated_d, truncated_d, info). Keys of
        obs_d are the agents still alive; terminated_d["__all__"] ends it."""
        raise NotImplementedError


class MultiCartPole(MultiAgentEnv):
    """N independent cart-poles sharing an episode clock: an agent that
    falls stops acting; the episode ends when all have fallen (or at the
    step cap). Exists so multi-agent tests need no external envs."""

    def __init__(self, n_agents: int = 2, max_steps: int = 200):
        self.agent_ids = tuple(f"agent_{i}" for i in range(n_agents))
        self._envs = {a: CartPole(max_steps=max_steps) for a in self.agent_ids}
        self.observation_size = 4
        self.num_actions = 2
        self._alive: List[str] = []

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        self._alive = list(self.agent_ids)
        return {
            a: env.reset(None if seed is None else seed + i)
            for i, (a, env) in enumerate(self._envs.items())
        }

    def step(self, actions: Dict[str, int]):
        obs_d, rew_d, term_d, trunc_d = {}, {}, {}, {}
        for a in list(self._alive):
            obs, r, term, trunc, _ = self._envs[a].step(actions[a])
            rew_d[a] = r
            term_d[a] = term
            trunc_d[a] = trunc
            if term or trunc:
                self._alive.remove(a)
            else:
                obs_d[a] = obs
        term_d["__all__"] = not self._alive
        trunc_d["__all__"] = False
        return obs_d, rew_d, term_d, trunc_d, {}


@api.remote
class MultiAgentEnvRunner:
    """Samples a MultiAgentEnv, bucketing transitions per policy id."""

    def __init__(self, env_fn, forward_fn, policy_mapping_fn, seed: int = 0,
                 gamma: float = 0.99):
        self.env = env_fn()
        self.forward = forward_fn
        self.map_policy = policy_mapping_fn
        self.params: Dict[str, Any] = {}
        self.rng = np.random.default_rng(seed)
        self.gamma = gamma  # for the truncation-bootstrap reward fold
        self._obs = self.env.reset(seed=seed)
        self._ep_return = 0.0

    def set_weights(self, params_by_policy: Dict[str, Any]) -> bool:
        self.params = tree_to_numpy(params_by_policy)
        return True

    def sample(self, num_steps: int) -> Dict[str, Dict[str, np.ndarray]]:
        """num_steps env steps -> {policy_id: flat rollout columns}.

        Each policy's rollout carries per-transition bootstrap values
        ("last_values") instead of a scalar: agents die at different
        times, so GAE must cut per transition via dones."""
        assert self.params, "set_weights before sample"
        cols: Dict[str, Dict[str, list]] = {}
        completed: List[float] = []

        def bucket(pid):
            return cols.setdefault(pid, {
                "obs": [], "actions": [], "rewards": [], "dones": [],
                "logp": [], "values": [], "next_values": [],
            })

        for _ in range(num_steps):
            actions: Dict[str, int] = {}
            step_info: Dict[str, Tuple[str, float, float]] = {}
            for agent, obs in self._obs.items():
                pid = self.map_policy(agent)
                logits, value = self.forward(self.params[pid], obs[None])
                logits = np.asarray(logits[0], np.float64)
                p = np.exp(logits - logits.max())
                p /= p.sum()
                a = int(self.rng.choice(len(p), p=p))
                actions[agent] = a
                step_info[agent] = (pid, np.log(p[a] + 1e-12), float(value[0]))
                b = bucket(pid)
                b["obs"].append(obs)
                b["actions"].append(a)
                b["logp"].append(step_info[agent][1])
                b["values"].append(step_info[agent][2])
            prev_obs = self._obs
            obs_d, rew_d, term_d, trunc_d, _ = self.env.step(actions)
            for agent in prev_obs:
                pid, _, _ = step_info[agent]
                b = cols[pid]
                r = rew_d.get(agent, 0.0)
                self._ep_return += r
                term = term_d.get(agent, False)
                trunc = trunc_d.get(agent, False) or trunc_d.get("__all__", False)
                done = term or trunc
                # Time-limit bias fix (same as EnvRunner): a
                # truncation cuts the trace but its continuation value is
                # V(next_obs), not 0 — fold gamma*V(next_obs) into the
                # reward at the cut (the GAE mask zeroes next_values at
                # every done, so folding is the only unbiased route).
                if done and not term and agent in obs_d:
                    _, v_nxt = self.forward(
                        self.params[pid], obs_d[agent][None]
                    )
                    r = r + self.gamma * float(v_nxt[0])
                b["rewards"].append(r)
                b["dones"].append(done)
                if done:
                    b["next_values"].append(0.0)
                else:
                    nlogits, nvalue = self.forward(
                        self.params[pid], obs_d[agent][None]
                    )
                    b["next_values"].append(float(nvalue[0]))
            if term_d.get("__all__") or trunc_d.get("__all__"):
                completed.append(self._ep_return)
                self._ep_return = 0.0
                self._obs = self.env.reset()
            else:
                self._obs = obs_d
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for pid, b in cols.items():
            out[pid] = {
                "obs": np.asarray(b["obs"], np.float32),
                "actions": np.asarray(b["actions"], np.int32),
                "rewards": np.asarray(b["rewards"], np.float32),
                "dones": np.asarray(b["dones"], np.bool_),
                "logp": np.asarray(b["logp"], np.float32),
                "values": np.asarray(b["values"], np.float32),
                "next_values": np.asarray(b["next_values"], np.float32),
            }
        out["__episodes__"] = np.asarray(completed, np.float32)
        return out


@dataclasses.dataclass
class MultiAgentPPOConfig:
    env_fn: Callable[[], MultiAgentEnv] = None
    policy_ids: Tuple[str, ...] = ("shared",)
    policy_mapping_fn: Callable[[str], str] = lambda agent_id: "shared"
    num_env_runners: int = 2
    rollout_steps_per_runner: int = 256
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


class MultiAgentPPO:
    """PPO over per-policy batches from multi-agent rollouts. params:
    {policy_id: initial module tree} (by default drawn from config.seed +
    the policy's index)."""

    def __init__(self, config: MultiAgentPPOConfig, device=None, params=None):
        assert config.env_fn is not None, "env_fn required"
        self.config = config
        self.device = resolve_device(device)
        env = config.env_fn()
        self.params: Dict[str, Any] = {}
        self.opt_state: Dict[str, Any] = {}
        self.optimizer = adam(config.lr)
        for i, pid in enumerate(config.policy_ids):
            p = params[pid] if params is not None else init_mlp_module(
                config.seed + i, env.observation_size, env.num_actions, config.hidden,
                device=self.device)
            self.params[pid] = p
            self.opt_state[pid] = self.optimizer.init(p)
        self.runners = [
            MultiAgentEnvRunner.remote(
                config.env_fn, mlp_forward_np, config.policy_mapping_fn,
                config.seed + i, config.gamma,
            )
            for i in range(config.num_env_runners)
        ]
        self.iteration = 0
        self._recent_returns: List[float] = []

    def _update(self, params, opt_state, batch):
        """One PPO step of one policy; params and opt_state change in
        place. Returns (params, opt_state, loss)."""
        cfg = self.config
        d = self.device
        b = {"obs": as_tensor(batch["obs"], d, torch.float32),
             "actions": as_tensor(batch["actions"], d),
             "logp_old": as_tensor(batch["logp_old"], d, torch.float32),
             "advantages": as_tensor(batch["advantages"], d, torch.float32),
             "returns": as_tensor(batch["returns"], d, torch.float32)}
        loss, _ = grad_step(self.optimizer, opt_state, params, ppo_loss, b,
                            cfg.clip_eps, cfg.vf_coef, cfg.entropy_coef)
        return params, opt_state, loss

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        for r in self.runners:
            api.get(r.set_weights.remote(self.params))
        refs = [r.sample.remote(cfg.rollout_steps_per_runner) for r in self.runners]
        per_policy: Dict[str, List[Dict[str, np.ndarray]]] = {}
        ep_returns: List[float] = []
        for ref in refs:
            out = api.get(ref, timeout=300.0)
            ep_returns.extend(out.pop("__episodes__").tolist())
            for pid, ro in out.items():
                per_policy.setdefault(pid, []).append(ro)

        losses: Dict[str, float] = {}
        timesteps = 0
        for pid, rollouts in per_policy.items():
            obs, acts, logp, advs, rets = [], [], [], [], []
            for ro in rollouts:
                # per-transition bootstrap: GAE with lambda-returns where
                # next value comes from the recorded next_values column
                adv = np.zeros(len(ro["rewards"]), np.float32)
                last = 0.0
                for t in reversed(range(len(adv))):
                    nonterminal = 0.0 if ro["dones"][t] else 1.0
                    delta = (ro["rewards"][t]
                             + cfg.gamma * ro["next_values"][t] * nonterminal
                             - ro["values"][t])
                    last = delta + cfg.gamma * cfg.gae_lambda * nonterminal * last
                    adv[t] = last
                obs.append(ro["obs"]); acts.append(ro["actions"])
                logp.append(ro["logp"]); advs.append(adv)
                rets.append(adv + ro["values"])
            obs = np.concatenate(obs); acts = np.concatenate(acts)
            logp = np.concatenate(logp); advs = np.concatenate(advs)
            rets = np.concatenate(rets)
            advs = (advs - advs.mean()) / (advs.std() + 1e-8)
            n = len(obs)
            timesteps += n
            rng = np.random.default_rng(cfg.seed + self.iteration)
            for _ in range(cfg.num_epochs):
                order = rng.permutation(n)
                for lo in range(0, n, cfg.minibatch_size):
                    idx = order[lo: lo + cfg.minibatch_size]
                    batch = {"obs": obs[idx], "actions": acts[idx], "logp_old": logp[idx],
                             "advantages": advs[idx], "returns": rets[idx]}
                    self.params[pid], self.opt_state[pid], loss = self._update(
                        self.params[pid], self.opt_state[pid], batch
                    )
                    losses[pid] = float(loss)

        self.iteration += 1
        self._recent_returns.extend(ep_returns)
        self._recent_returns = self._recent_returns[-100:]
        return {
            "training_iteration": self.iteration,
            "episodes_this_iter": len(ep_returns),
            "episode_return_mean": float(np.mean(self._recent_returns))
            if self._recent_returns else 0.0,
            "timesteps_this_iter": timesteps,
            "loss_by_policy": losses,
        }
