"""Environment interface + built-in envs.

The port's copy of ray_tpu/rl/env.py, unchanged: numpy only, so the
same seed draws the same numbers in both packages.

Reference: RLlib consumes gymnasium envs (`rllib/env/`); the interface here
is gymnasium-shaped so real gym envs drop in via GymWrapper, while CartPole
is implemented natively (numpy) so tests need no external dependency.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


class Env:
    observation_size: int
    num_actions: int

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, bool, Dict]:
        raise NotImplementedError


class CartPole(Env):
    """Classic cart-pole, dynamics per Barto-Sutton-Anderson (the same task
    gymnasium's CartPole-v1 implements)."""

    observation_size = 4
    num_actions = 2

    def __init__(self, max_steps: int = 500):
        self.g, self.mc, self.mp, self.l = 9.8, 1.0, 0.1, 0.5
        self.force, self.dt = 10.0, 0.02
        self.x_lim, self.theta_lim = 2.4, 12 * np.pi / 180
        self.max_steps = max_steps
        self._rng = np.random.default_rng(0)
        self._state = None
        self._t = 0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._t = 0
        return self._state.astype(np.float32)

    def step(self, action: int):
        x, x_dot, th, th_dot = self._state
        f = self.force if action == 1 else -self.force
        costh, sinth = np.cos(th), np.sin(th)
        total_m = self.mc + self.mp
        temp = (f + self.mp * self.l * th_dot**2 * sinth) / total_m
        th_acc = (self.g * sinth - costh * temp) / (
            self.l * (4.0 / 3.0 - self.mp * costh**2 / total_m)
        )
        x_acc = temp - self.mp * self.l * th_acc * costh / total_m
        x += self.dt * x_dot
        x_dot += self.dt * x_acc
        th += self.dt * th_dot
        th_dot += self.dt * th_acc
        self._state = np.array([x, x_dot, th, th_dot])
        self._t += 1
        terminated = bool(abs(x) > self.x_lim or abs(th) > self.theta_lim)
        truncated = self._t >= self.max_steps
        return self._state.astype(np.float32), 1.0, terminated, truncated, {}


class GymWrapper(Env):
    """Adapt a gymnasium env instance."""

    def __init__(self, gym_env):
        self._env = gym_env
        self.observation_size = int(np.prod(gym_env.observation_space.shape))
        self.num_actions = int(gym_env.action_space.n)

    def reset(self, seed=None):
        obs, _ = self._env.reset(seed=seed)
        return np.asarray(obs, np.float32).reshape(-1)

    def step(self, action):
        obs, r, term, trunc, info = self._env.step(int(action))
        return np.asarray(obs, np.float32).reshape(-1), float(r), term, trunc, info
