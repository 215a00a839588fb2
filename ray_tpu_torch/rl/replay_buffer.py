"""Replay buffers (reference: `rllib/utils/replay_buffers/` —
`ReplayBuffer`, `PrioritizedEpisodeReplayBuffer`).

The port's copy of ray_tpu/rl/replay_buffer.py, unchanged: numpy only, so the
same seed draws the same numbers in both packages.

Transitions are stored as preallocated column arrays (struct-of-arrays),
so sampling a minibatch is one fancy-index per column — the sampled batch
feeds a learner update directly. The prioritized buffer keeps
proportional priorities in a flat sum-tree (O(log n) sample/update).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class ReplayBuffer:
    """Uniform FIFO ring buffer over flat transition columns."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._cols: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def _ensure(self, batch: Dict[str, np.ndarray]) -> None:
        if self._cols is not None:
            return
        self._cols = {}
        for k, v in batch.items():
            v = np.asarray(v)
            self._cols[k] = np.zeros((self.capacity, *v.shape[1:]), v.dtype)

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        """Append a flat rollout {col: [T, ...]}; all columns share T."""
        self._ensure(batch)
        n = len(next(iter(batch.values())))
        for k, col in self._cols.items():
            v = np.asarray(batch[k])
            assert len(v) == n, f"ragged column {k}: {len(v)} vs {n}"
            idx = (self._next + np.arange(n)) % self.capacity
            col[idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        assert self._size > 0, "empty buffer"
        idx = self._rng.integers(self._size, size=batch_size)
        return {k: col[idx] for k, col in self._cols.items()}


class SumTree:
    """Flat binary sum-tree over `capacity` leaves for proportional sampling."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        # round leaves up to a power of two so parent/child math is shifts
        self._leaf0 = 1
        while self._leaf0 < self.capacity:
            self._leaf0 *= 2
        self._tree = np.zeros(2 * self._leaf0, np.float64)

    @property
    def total(self) -> float:
        return float(self._tree[1])

    def set(self, idx: np.ndarray, value: np.ndarray) -> None:
        """Set leaf priorities and propagate sums to the root."""
        i = np.asarray(idx) + self._leaf0
        self._tree[i] = value
        i //= 2
        while np.any(i >= 1):
            np.maximum(i, 1, out=i)
            left = self._tree[2 * i]
            right = self._tree[2 * i + 1]
            self._tree[i] = left + right
            if np.all(i == 1):
                break
            i //= 2

    def get(self, idx: np.ndarray) -> np.ndarray:
        return self._tree[np.asarray(idx) + self._leaf0]

    def find(self, mass: np.ndarray) -> np.ndarray:
        """Vector descent: leaf index whose cumulative range contains mass."""
        i = np.ones(len(mass), np.int64)
        mass = np.asarray(mass, np.float64).copy()
        while np.all(i < self._leaf0):
            left = self._tree[2 * i]
            go_right = mass > left
            mass = np.where(go_right, mass - left, mass)
            i = 2 * i + go_right
        return np.minimum(i - self._leaf0, self.capacity - 1)


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (Schaul et al.): P(i) ∝ p_i^alpha,
    importance weights w_i = (N * P(i))^-beta / max w."""

    def __init__(self, capacity: int, alpha: float = 0.6, beta: float = 0.4,
                 eps: float = 1e-6, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self._tree = SumTree(capacity)
        self._max_prio = 1.0

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        start = self._next
        super().add_batch(batch)
        idx = (start + np.arange(n)) % self.capacity
        # new transitions get max priority so each is visited at least once
        self._tree.set(idx, np.full(n, self._max_prio ** self.alpha))

    def sample(
        self, batch_size: int
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
        assert self._size > 0, "empty buffer"
        mass = self._rng.uniform(0.0, self._tree.total, size=batch_size)
        idx = self._tree.find(mass)
        probs = self._tree.get(idx) / max(self._tree.total, 1e-12)
        weights = (self._size * np.maximum(probs, 1e-12)) ** (-self.beta)
        weights = (weights / weights.max()).astype(np.float32)
        batch = {k: col[idx] for k, col in self._cols.items()}
        return batch, idx, weights

    def update_priorities(self, idx: np.ndarray, td_errors: np.ndarray) -> None:
        prio = np.abs(np.asarray(td_errors, np.float64)) + self.eps
        self._max_prio = max(self._max_prio, float(prio.max()))
        self._tree.set(np.asarray(idx), prio ** self.alpha)
