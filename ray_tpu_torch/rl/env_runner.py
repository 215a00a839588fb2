"""EnvRunner: sampling actors (reference: `rllib/env/single_agent_env_runner.py`
+ `env_runner_group.py`).

The port's copy of ray_tpu/rl/env_runner.py, its runners actors of the
port's runtime (thread mode). Each runner owns env copies and a frozen
policy snapshot as numpy arrays (set_weights copies a tensor tree to the
host, so a learner's later in-place updates never reach it); sample()
returns flat rollout arrays, drawn from the same numpy generators as the
reference's. The group fans sampling across actors and tolerates runner
death (reference's `restart_failed_env_runners`)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .. import api
from ..core.logging import get_logger
from .module import tree_to_numpy

logger = get_logger("rl.env_runner")


def fold_truncation_bootstrap(ro: Dict[str, np.ndarray], gamma: float) -> np.ndarray:
    """Rewards with gamma*V(next_obs) folded in at time-limit cuts.

    A truncation cuts the advantage/return recursion like a terminal, but
    its continuation value is V(next_obs), not 0 (the time-limit bias).
    Folding the bootstrap into the reward at the cut keeps
    every done-masked consumer (GAE, V-trace) unbiased without changing
    its recursion. Tolerates rollout dicts without the column."""
    tv = ro.get("truncation_values")
    if tv is None:
        return ro["rewards"]
    return ro["rewards"] + gamma * tv


@api.remote
class EnvRunner:
    def __init__(self, env_fn: Callable[[], Any], forward_fn, seed: int = 0,
                 connectors=None, action_connectors=None):
        from .connectors import build_pipeline

        self.env = env_fn()
        # Rollout actors are host-resident: forward_fn must be a HOST
        # function (numpy in/out, e.g. module.mlp_forward_np). Per-step
        # device dispatch costs ~ms; numpy is µs.
        # The learner owns the accelerator (reference split: EnvRunner=CPU,
        # Learner=device).
        self.forward = forward_fn
        self.params = None
        self.rng = np.random.default_rng(seed)
        # env-to-module / module-to-env connector pipelines (reference:
        # rllib/connectors): each actor unpickles its OWN copy, so
        # stateful connectors (NormalizeObs) track per-runner streams
        self._c_obs = build_pipeline(connectors)
        self._c_act = build_pipeline(action_connectors)
        self._obs = self.env.reset(seed=seed)
        # transform-once cache: every raw observation passes the pipeline
        # exactly ONCE (stateful connectors must not double-count stats,
        # and next_obs[t] must equal obs[t+1] feature-for-feature)
        self._obs_t = self._transform_obs(self._obs)
        self._ep_return = 0.0
        self._ep_returns: List[float] = []

    def _transform_obs(self, raw, batched: bool = False) -> np.ndarray:
        if self._c_obs is None:
            return np.asarray(raw, np.float32)
        return np.asarray(
            self._c_obs(raw, {"batched": batched}), np.float32)

    def set_weights(self, params) -> bool:
        self.params = tree_to_numpy(params)
        return True

    def sample(
        self, num_steps: int, epsilon: Optional[float] = None
    ) -> Dict[str, np.ndarray]:
        """Roll out num_steps. Default exploration samples from
        softmax(logits) (on-policy: PPO); epsilon-greedy over the logits
        (read as Q-values) when `epsilon` is given (off-policy: DQN)."""
        assert self.params is not None, "set_weights before sample"
        obs_l, act_l, rew_l, done_l, logp_l, val_l = [], [], [], [], [], []
        next_l = []
        term_l, trunc_l, tv_l = [], [], []
        completed = []
        for _ in range(num_steps):
            # the cached TRANSFORMED obs is what the module sees — and
            # what the rollout stores, so the learner consumes the same
            # features (next_obs[t] is literally obs[t+1]'s array)
            obs_t = self._obs_t
            logits, value = self.forward(self.params, obs_t[None])
            logits = np.asarray(logits[0], np.float64)
            if self._c_act is not None:
                logits = np.asarray(
                    self._c_act(logits, {"obs": self._obs}), np.float64)
            p = np.exp(logits - logits.max())
            p /= p.sum()
            if epsilon is None:
                a = int(self.rng.choice(len(p), p=p))
            elif self.rng.random() < epsilon:
                # uniform over VALID actions only: a logits mask zeroes
                # p, and epsilon exploration must respect it
                valid = np.flatnonzero(p > 0)
                a = int(self.rng.choice(valid))
            else:
                a = int(np.argmax(logits))
            obs_l.append(obs_t)
            act_l.append(a)
            logp_l.append(np.log(p[a] + 1e-12))
            val_l.append(float(value[0]))
            nxt, r, term, trunc, _ = self.env.step(a)
            nxt_t = self._transform_obs(nxt)
            next_l.append(nxt_t)
            self._ep_return += r
            rew_l.append(r)
            done_l.append(term or trunc)
            term_l.append(bool(term))
            trunc_l.append(bool(trunc and not term))
            # Time-limit bias fix: at a truncation the episode
            # is cut for advantage/return purposes, but the value target
            # should bootstrap from V(next_obs), not 0 — only a true
            # terminal has zero continuation value. Record V(next_obs) for
            # truncated steps so on-policy learners can fold
            # gamma*V(next_obs) back into the reward at the cut.
            if trunc and not term:
                _, v_nxt = self.forward(self.params, nxt_t[None])
                tv_l.append(float(v_nxt[0]))
            else:
                tv_l.append(0.0)
            if term or trunc:
                completed.append(self._ep_return)
                self._ep_return = 0.0
                self._obs = self.env.reset()
                self._obs_t = self._transform_obs(self._obs)
            else:
                self._obs = nxt
                self._obs_t = nxt_t
        # bootstrap value for the (possibly unfinished) tail — from the
        # cache, not a fresh transform
        _, tail_v = self.forward(self.params, self._obs_t[None])
        self._ep_returns = (self._ep_returns + completed)[-100:]
        return {
            "obs": np.asarray(obs_l, np.float32),
            "actions": np.asarray(act_l, np.int32),
            "rewards": np.asarray(rew_l, np.float32),
            "dones": np.asarray(done_l, np.bool_),
            "terminateds": np.asarray(term_l, np.bool_),
            "truncateds": np.asarray(trunc_l, np.bool_),
            "truncation_values": np.asarray(tv_l, np.float32),
            "next_obs": np.asarray(next_l, np.float32),
            "logp": np.asarray(logp_l, np.float32),
            "values": np.asarray(val_l, np.float32),
            "bootstrap_value": float(tail_v[0]),
            "episode_returns": np.asarray(completed, np.float32),
        }

    def ping(self) -> bool:
        return True


@api.remote
class VectorEnvRunner:
    """N env copies stepped in lockstep with ONE batched policy forward
    per step (reference: `rllib/env/vector_env.py` / gymnasium vector
    envs inside single_agent_env_runner). The rollout keeps the flat
    [sum_T] contract every learner already consumes: env segments
    concatenate, and each env's unfinished tail closes with a TRUNCATION
    cut carrying V(tail_obs) — fold_truncation_bootstrap then keeps GAE/
    V-trace unbiased across the segment boundaries with no consumer
    changes."""

    def __init__(self, env_fn: Callable[[], Any], forward_fn, seed: int = 0,
                 num_envs: int = 2, connectors=None, action_connectors=None):
        from .connectors import build_pipeline

        self.envs = [env_fn() for _ in range(num_envs)]
        self.forward = forward_fn
        self.params = None
        self.rng = np.random.default_rng(seed)
        self._c_obs = build_pipeline(connectors)
        self._c_act = build_pipeline(action_connectors)
        self._obs = np.stack([
            np.asarray(e.reset(seed=seed + i), np.float32)
            for i, e in enumerate(self.envs)
        ])
        # transform-once cache (see EnvRunner): one pipeline pass per raw
        # observation, rows reused as the next step's module input
        self._obs_t = self._transform_rows(self._obs)
        self._ep_return = np.zeros(num_envs, np.float64)
        self._ep_returns: List[float] = []

    def _transform_row(self, raw) -> np.ndarray:
        if self._c_obs is None:
            return np.asarray(raw, np.float32)
        return np.asarray(self._c_obs(raw), np.float32)

    def _transform_rows(self, raw) -> np.ndarray:
        if self._c_obs is None:
            return np.asarray(raw, np.float32)
        return np.stack([self._transform_row(r) for r in raw])

    def set_weights(self, params) -> bool:
        self.params = tree_to_numpy(params)
        return True

    def sample(
        self, num_steps: int, epsilon: Optional[float] = None
    ) -> Dict[str, np.ndarray]:
        assert self.params is not None, "set_weights before sample"
        N = len(self.envs)
        cols: Dict[str, list] = {k: [] for k in (
            "obs", "actions", "rewards", "dones", "terminateds",
            "truncateds", "truncation_values", "next_obs", "logp", "values")}
        completed: List[float] = []
        for _ in range(num_steps):
            obs_t = self._obs_t
            logits, values = self.forward(self.params, obs_t)  # [N,A],[N]
            logits = np.asarray(logits, np.float64)
            if self._c_act is not None:
                logits = np.stack([
                    np.asarray(self._c_act(logits[i], {"obs": self._obs[i]}),
                               np.float64)
                    for i in range(N)
                ])
            p = np.exp(logits - logits.max(axis=1, keepdims=True))
            p /= p.sum(axis=1, keepdims=True)
            row = {k: [] for k in cols}
            next_obs = np.empty_like(self._obs)
            next_obs_t = np.empty_like(self._obs_t)
            for i, env in enumerate(self.envs):
                if epsilon is None:
                    a = int(self.rng.choice(p.shape[1], p=p[i]))
                elif self.rng.random() < epsilon:
                    # uniform over VALID actions (respect logits masks)
                    valid = np.flatnonzero(p[i] > 0)
                    a = int(self.rng.choice(valid))
                else:
                    a = int(np.argmax(logits[i]))
                nxt, r, term, trunc, _ = env.step(a)
                nxt = np.asarray(nxt, np.float32)
                nxt_t = self._transform_row(nxt)
                row["obs"].append(obs_t[i].copy())
                row["actions"].append(a)
                row["logp"].append(np.log(p[i, a] + 1e-12))
                row["values"].append(float(values[i]))
                row["rewards"].append(r)
                row["dones"].append(term or trunc)
                row["terminateds"].append(bool(term))
                row["truncateds"].append(bool(trunc and not term))
                row["next_obs"].append(nxt_t)
                self._ep_return[i] += r
                if trunc and not term:
                    _, v_nxt = self.forward(self.params, nxt_t[None])
                    row["truncation_values"].append(float(v_nxt[0]))
                else:
                    row["truncation_values"].append(0.0)
                if term or trunc:
                    completed.append(float(self._ep_return[i]))
                    self._ep_return[i] = 0.0
                    next_obs[i] = np.asarray(env.reset(), np.float32)
                    next_obs_t[i] = self._transform_row(next_obs[i])
                else:
                    next_obs[i] = nxt
                    next_obs_t[i] = nxt_t
            for k in cols:
                cols[k].append(row[k])
            self._obs = next_obs
            self._obs_t = next_obs_t
        # per-env tail values in one batched forward — from the cache
        _, tail_v = self.forward(self.params, self._obs_t)
        # [T, N] -> per-env segments, tail closed by a truncation cut
        out: Dict[str, list] = {k: [] for k in cols}
        arr = {k: np.asarray(v) for k, v in cols.items()}
        for i in range(N):
            for k in cols:
                seg = arr[k][:, i]
                out[k].append(seg.copy())
            last = num_steps - 1
            if not out["dones"][-1][last]:
                out["dones"][-1][last] = True
                out["truncateds"][-1][last] = True
                out["truncation_values"][-1][last] = float(tail_v[i])
        self._ep_returns = (self._ep_returns + completed)[-100:]
        flat = {k: np.concatenate(v) for k, v in out.items()}
        flat["obs"] = flat["obs"].astype(np.float32)
        flat["actions"] = flat["actions"].astype(np.int32)
        flat["rewards"] = flat["rewards"].astype(np.float32)
        flat["logp"] = flat["logp"].astype(np.float32)
        flat["values"] = flat["values"].astype(np.float32)
        flat["truncation_values"] = flat["truncation_values"].astype(np.float32)
        flat["next_obs"] = flat["next_obs"].astype(np.float32)
        # every segment ends in a cut, so the tail bootstrap is already
        # folded through truncation_values
        flat["bootstrap_value"] = 0.0
        flat["episode_returns"] = np.asarray(completed, np.float32)
        return flat

    def ping(self) -> bool:
        return True


class EnvRunnerGroup:
    def __init__(self, env_fn, forward_fn, num_runners: int = 2, seed: int = 0,
                 num_envs_per_runner: int = 1, connectors=None,
                 action_connectors=None):
        self.env_fn = env_fn
        self.forward_fn = forward_fn
        self.num_runners = num_runners
        self.seed = seed
        self.connectors = list(connectors or [])
        self.action_connectors = list(action_connectors or [])
        self.num_envs_per_runner = max(1, num_envs_per_runner)
        # monotonic, bumped on every restart: pipelined consumers (APPO)
        # use it to detect that refs they submitted before a restart now
        # point at a dead actor and must be resubmitted
        self.generation = 0
        self.runners = [self._make(seed + i) for i in range(num_runners)]

    def _make(self, seed: int):
        if self.num_envs_per_runner > 1:
            return VectorEnvRunner.remote(
                self.env_fn, self.forward_fn, seed,
                self.num_envs_per_runner, connectors=self.connectors,
                action_connectors=self.action_connectors)
        return EnvRunner.remote(self.env_fn, self.forward_fn, seed,
                                connectors=self.connectors,
                                action_connectors=self.action_connectors)

    def _restart(self, i: int, params=None) -> None:
        self.generation += 1
        self.runners[i] = self._make(self.seed + i + 1000)
        if params is not None:
            api.get(self.runners[i].set_weights.remote(params))

    def sync_weights(self, params) -> None:
        """Push weights; dead runners are restarted, not fatal. The
        timeout matches collect()'s: in the pipelined (APPO) flow a
        set_weights queues BEHIND an in-flight rollout on the actor's
        serial mailbox — a shorter budget here would misread every
        healthy-but-sampling runner as dead and restart the whole
        group each iteration."""
        for i, r in enumerate(self.runners):
            try:
                api.get(r.set_weights.remote(params), timeout=300.0)
            except (api.RayTaskError, api.RayActorError, api.GetTimeoutError) as e:
                logger.warning("env runner %d dead on sync (%s); restarting", i, e)
                self._restart(i, params)

    def sample_async(
        self, steps_per_runner: int, params=None,
        epsilon: Optional[float] = None,
    ) -> List[Any]:
        """Submit sampling on every runner; returns refs (APPO's pipeline
        overlap: the learner updates while these run)."""
        if params is not None:
            self.sync_weights(params)
        return [r.sample.remote(steps_per_runner, epsilon)
                for r in self.runners]

    def collect(self, refs: List[Any], params=None) -> List[Dict[str, np.ndarray]]:
        out: List[Dict[str, np.ndarray]] = []
        for i, ref in enumerate(refs):
            try:
                out.append(api.get(ref, timeout=300.0))
            except (api.RayTaskError, api.RayActorError, api.GetTimeoutError) as e:
                logger.warning("env runner %d failed (%s); restarting", i, e)
                self._restart(i, params)
        return out

    def sample(
        self, steps_per_runner: int, params=None, epsilon: Optional[float] = None
    ) -> List[Dict[str, np.ndarray]]:
        return self.collect(
            self.sample_async(steps_per_runner, params, epsilon), params)
