"""Online RL post-training: the serve fleet becomes the rollout fleet.

The one workload that exercises the train, serve, data,
object, and actuation planes simultaneously (RL was Ray's founding
workload, arXiv:1712.05889). The loop per iteration:

    rollout  — the disagg fleet's decode replicas generate N sampled
               completions per prompt as ordinary continuous-batched
               inference (coordinator.open_stream: prefix routing, live
               resume, the works), each with per-token sampled logprobs
               and the generation (weights) version it was sampled under
    reward   — a filter stage scores trajectories with reward_fn and
               enforces the staleness bound, then streams survivors over
               a BOUNDED DistChannel into the trainer (a slow trainer
               backpressures rollouts instead of buffering unboundedly)
    train    — one GRPO update per prompt group, reusing rl/grpo.py's
               update: the rollout-time logprobs are logp_old, so
               the clipped importance ratio is exactly what absorbs the
               off-policy gap of version-stale (or resumed) trajectories
    sync     — the new params ride the api.broadcast relay tree to every
               replica (FleetController.sync_weights) and swap in LIVE:
               no drain, in-flight requests keep the old weights, and
               unrelated serve traffic never stops

Every phase is timed into the rl goodput ledger (util/profiler.rl_ledger)
so the <5% sync-stall claim is rl_sync_stall_fraction, measured — the
rl_sync_stall health rule fires off the same gauge.

Staleness (`rl_staleness_max_versions` / `rl_staleness_policy` knobs): a
trajectory whose stamped weights_version trails the trainer by more than
the bound is dropped (counted) or kept for the importance correction to
handle. Trajectories that lost their logprobs (live-resume replays, spec
commits) have logp_old backfilled with the current policy's — ratio 1 at
those positions, a neutral on-policy fallback — rather than poisoning
the batch or dying.

The port's counterpart of ray_tpu/rl/online.py, on the port's channels,
metrics registry, FleetController.sync_weights and the coordinator's
stamped open_stream. stop() starts no more rollouts and waits for those
in flight, so no request reaches a replica after it returns (the
reference's stop leaves them running, and a request that reaches an
engine being stopped starts its threads again). The trainer (rl/grpo.py's
GRPO) owns its f32 masters
on `device` (the card unless named) and updates them in place; the fleet
sees them only at a sync, when each engine copies them into its own
(bf16 on the card) tensors, so an update never reaches a replica before
the next sync. Rollout logprobs come from the engines (bf16 on the card)
and stand as logp_old beside the trainer's f32 _seq_logp.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import channels
from ..core.config import config
from ..core.logging import get_logger
from ..core.metrics import Counter, Gauge
from ..models import ModelConfig
from .grpo import GRPO, GRPOConfig
from .module import tree_map

logger = get_logger("rl.online")

__all__ = ["Trajectory", "OnlineRLConfig", "OnlineRLLoop"]

_m_reward = Gauge(
    "rl_reward_mean",
    "mean trajectory reward of the latest online-RL iteration")
_m_rollout_tokens = Counter(
    "rl_rollout_tokens",
    "completion tokens generated by the rollout fleet")
_m_phase_s = Counter(
    "rl_phase_seconds",
    "online-RL loop time by phase (rollout/reward/train/weight_sync) — "
    "the rl goodput ledger's inputs")
_m_stall = Gauge(
    "rl_sync_stall_fraction",
    "weight_sync share of the last iteration's wall time (the <5% "
    "claim; the rl_sync_stall health rule fires off this)")
_m_skew = Gauge(
    "rl_weights_version_skew",
    "max - min gossiped weights_version across the fleet after a sync")
_m_stale = Counter(
    "rl_stale_trajectories",
    "trajectories past the staleness bound, by policy outcome "
    "(dropped/corrected)")
_m_dropped = Counter(
    "rl_dropped_trajectories",
    "trajectories the reward/filter stage discarded, by reason")
_m_inflight = Gauge(
    "rl_trajectories_inflight",
    "rollouts submitted but not yet consumed by the trainer")
_m_iterations = Counter(
    "rl_iterations", "completed online-RL iterations")
_m_backfills = Counter(
    "rl_logprob_backfills",
    "completion positions whose rollout logprob was missing (resume "
    "replays, spec commits) and was backfilled with the current "
    "policy's — ratio 1, neutral")


@dataclasses.dataclass
class Trajectory:
    """One scored rollout: a prompt, one sampled completion, the
    logprobs it was sampled with, and the weights generation that
    sampled it."""

    prompt: List[int]
    completion: List[int]
    logprobs: List[Optional[float]]
    weights_version: Optional[int]
    group: int  # index into the loop's prompt list
    reward: float = 0.0
    request_id: str = ""

    @property
    def stamped(self) -> bool:
        return self.weights_version is not None


@dataclasses.dataclass
class OnlineRLConfig:
    """Loop knobs; GRPO math knobs live in the embedded GRPOConfig.
    Staleness/channel knobs default from core/config.py (None = read the
    global flag at construction)."""

    grpo: GRPOConfig = dataclasses.field(default_factory=GRPOConfig)
    rollout_timeout_s: float = 120.0
    rollout_concurrency: int = 8
    sync_roles: Tuple[str, ...] = ("prefill", "decode")
    staleness_max_versions: Optional[int] = None
    staleness_policy: Optional[str] = None  # "drop" | "correct"
    channel_capacity: Optional[int] = None
    # minimum usable trajectories for a group update (advantage needs a
    # spread); smaller groups are skipped, not crashed on
    min_group: int = 2

    def __post_init__(self) -> None:
        if self.staleness_max_versions is None:
            self.staleness_max_versions = int(
                config.get("rl_staleness_max_versions"))
        if self.staleness_policy is None:
            self.staleness_policy = str(config.get("rl_staleness_policy"))
        if self.staleness_policy not in ("drop", "correct"):
            raise ValueError(
                "rl_staleness_policy must be 'drop' or 'correct', got "
                f"{self.staleness_policy!r}")
        if self.channel_capacity is None:
            self.channel_capacity = int(
                config.get("rl_trajectory_channel_capacity"))
        if int(self.channel_capacity) < 1:
            raise ValueError(
                f"channel capacity must be >= 1, got {self.channel_capacity}")


class OnlineRLLoop:
    """The orchestrator. `fleet` is a serve FleetController (its
    coordinator provides the rollout path, its sync_weights the
    trainer→fleet edge); pass a bare DisaggCoordinator to roll out
    against a fleet without an actuation plane (weights then sync via
    the workers' update_weights directly).

    reward_fn(prompt_ids, completion_ids) -> float, same contract as
    rl/grpo.py. params: the initial LM tree, which the trainer copies
    onto `device` (the card unless named)."""

    def __init__(
        self,
        params,
        model_cfg: ModelConfig,
        reward_fn: Callable[[List[int], List[int]], float],
        fleet: Any,
        prompts: Sequence[Sequence[int]],
        config_: Optional[OnlineRLConfig] = None,
        device=None,
    ):
        if not prompts:
            raise ValueError("online RL needs at least one prompt")
        self.cfg = config_ or OnlineRLConfig()
        self.prompts = [list(map(int, p)) for p in prompts]
        # FleetController (has .co + sync_weights) or bare coordinator
        self.fleet = fleet if hasattr(fleet, "sync_weights") else None
        self.co = fleet.co if self.fleet is not None else fleet
        # the GRPO learner: its update/_seq_logp/optimizer are the train
        # stage; its own rollout path (train_step) goes unused — the fleet
        # IS the rollout path here
        self.grpo = GRPO(params, model_cfg, reward_fn, self.cfg.grpo, device=device)
        self.reward_fn = reward_fn
        self.version = 0  # the trainer's weights generation
        self.iteration = 0
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # reward/filter stage plumbing: rollout threads feed _raw_q, the
        # reward worker scores/filters and streams survivors (or drop
        # markers, so the trainer's expected count stays exact) over the
        # bounded channel
        addr = channels.service_address() or channels.ensure_service()
        self.channel = channels.DistChannel(
            addr, maxsize=int(self.cfg.channel_capacity))
        self._raw_q: "queue.Queue" = queue.Queue()
        self._reward_s = 0.0  # accumulated scoring time, this iteration
        self._reward_thread = threading.Thread(
            target=self._reward_loop, daemon=True, name="rl-reward")
        self._reward_thread.start()
        # the rollouts' futures (stop() waits for those in flight)
        self._futures: List[Any] = []
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(self.cfg.rollout_concurrency)),
            thread_name_prefix="rl-rollout")
        self._closed = False

    def _inflight_add(self, n: float) -> bool:
        """Every rl_trajectories_inflight mutation goes through here,
        under the loop lock and gated on _closed: stop() zeroes the
        gauge once, and a run_iteration racing it (its collection loop
        or finally-unwind firing after the zero) must NOT re-apply its
        own deltas on top — that double-unwind leaves the gauge
        negative forever."""
        with self._lock:
            if self._closed:
                return False
            _m_inflight.add(float(n))
            return True

    # ------------------------------------------------------------ rollout

    def _rollout_one(self, group: int, prompt: List[int]) -> None:
        """One fleet rollout -> _raw_q. Always enqueues exactly one item
        (a Trajectory or a drop marker) so the trainer's count stays
        exact; live resume inside open_stream means a replica death here
        is a latency blip, not a lost rollout."""
        g = self.cfg.grpo
        try:
            if self._stop.is_set():
                raise RuntimeError("loop stopped")
            ds = self.co.open_stream(
                prompt, max_tokens=g.max_new_tokens,
                temperature=g.temperature,
                timeout_s=self.cfg.rollout_timeout_s)
            toks = list(ds.tokens())
            traj = Trajectory(
                prompt=prompt, completion=toks,
                logprobs=list(ds.logprobs or [None] * len(toks)),
                weights_version=ds.weights_version,
                group=group, request_id=ds.request_id)
            _m_rollout_tokens.inc(len(toks))
            self._raw_q.put(traj)
        except Exception as e:  # noqa: BLE001 — resume already retried
            if not self._stop.is_set():
                logger.warning("rollout failed: %r", e)
            self._raw_q.put({"dropped": "rollout_error"})

    # ------------------------------------------------------ reward stage

    def _reward_loop(self) -> None:
        """Score + filter, then stream over the bounded channel. Runs
        for the loop's lifetime; a None item is the shutdown poison."""
        while True:
            item = self._raw_q.get()
            if item is None:
                return
            if isinstance(item, dict):  # upstream drop marker
                self._channel_put(item)
                continue
            try:
                t0 = time.monotonic()
                item.reward = float(
                    self.reward_fn(item.prompt, item.completion))
                with self._lock:
                    self._reward_s += time.monotonic() - t0
            except Exception as e:  # noqa: BLE001 — a bad reward_fn
                logger.warning("reward_fn failed: %r", e)
                self._channel_put({"dropped": "reward_error"})
                continue
            self._channel_put(self._filter(item))

    def _filter(self, traj: Trajectory):
        """The staleness bound. Returns the trajectory (possibly just
        counted as corrected) or a drop marker."""
        if traj.stamped:
            lag = self.version - int(traj.weights_version)
            if lag > int(self.cfg.staleness_max_versions):
                if self.cfg.staleness_policy == "drop":
                    _m_stale.inc(tags={"policy": "dropped"})
                    return {"dropped": "stale"}
                _m_stale.inc(tags={"policy": "corrected"})
        return traj

    def _channel_put(self, item) -> None:
        # bounded put that stays responsive to stop(): backpressure from
        # a slow trainer must not wedge shutdown
        while not self._stop.is_set():
            try:
                self.channel.put(item, timeout=0.2)
                return
            except queue.Full:
                continue
            except Exception:  # noqa: BLE001 — channel closed under us
                return

    # -------------------------------------------------------------- train

    def _train_groups(self, groups: Dict[int, List[Trajectory]]
                      ) -> Dict[str, float]:
        """One GRPO update per prompt group with >= min_group usable
        trajectories; rollout-time logprobs are logp_old (missing ones
        backfilled with the current policy's — neutral ratio 1)."""
        losses, kls, rewards = [], [], []
        for gi, trajs in sorted(groups.items()):
            lens = {len(t.completion) for t in trajs}
            if len(lens) != 1:
                # non-uniform completions can't batch; keep the modal
                # length, drop the rest (counted)
                keep_len = max(lens, key=lambda L: sum(
                    1 for t in trajs if len(t.completion) == L))
                dropped = [t for t in trajs if len(t.completion) != keep_len]
                trajs = [t for t in trajs if len(t.completion) == keep_len]
                for _ in dropped:
                    _m_dropped.inc(tags={"reason": "length"})
            if len(trajs) < int(self.cfg.min_group):
                _m_dropped.inc(len(trajs), tags={"reason": "thin_group"})
                continue
            prompt = trajs[0].prompt
            plen = len(prompt)
            tokens = np.asarray(
                [t.prompt + t.completion for t in trajs], np.int32)
            rew = np.asarray([t.reward for t in trajs], np.float32)
            adv = (rew - rew.mean()) / (rew.std() + 1e-6)
            lp_cur, _ = self.grpo._seq_logp(self.grpo.params, tokens, plen)
            lp_ref, _ = self.grpo._seq_logp(self.grpo.ref_params, tokens,
                                            plen)
            lp_old = lp_cur.cpu().numpy().copy()
            backfills = 0
            for r, t in enumerate(trajs):
                for i, lp in enumerate(t.logprobs[:len(t.completion)]):
                    # completion token i is the target at column
                    # plen-1+i of the shifted [G, T-1] logp grid
                    if lp is not None:
                        lp_old[r, plen - 1 + i] = lp
                    else:
                        backfills += 1
            if backfills:
                _m_backfills.inc(backfills)
            batch = {
                "tokens": tokens,
                "prompt_len": plen,
                "logp_old": lp_old,
                "logp_ref": lp_ref,
                "advantages": adv,
            }
            self.grpo.params, self.grpo.opt_state, aux = self.grpo._update(
                self.grpo.params, self.grpo.opt_state, batch)
            losses.append(float(aux["loss"]))
            kls.append(float(aux["kl"]))
            rewards.extend(float(x) for x in rew)
        return {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "kl": float(np.mean(kls)) if kls else float("nan"),
            "reward_mean": (float(np.mean(rewards)) if rewards
                            else float("nan")),
            "groups_trained": float(len(losses)),
        }

    # --------------------------------------------------------- weight sync

    def _sync_weights(self) -> None:
        """Push the trainer's params to the fleet over the broadcast
        relay tree, live (no drain). Bare-coordinator mode syncs each
        worker directly."""
        self.version += 1
        # the masters' values without their autograd state; each engine
        # copies them into its own tensors
        weights = tree_map(torch.Tensor.detach, self.grpo.params)
        if self.fleet is not None:
            out = self.fleet.sync_weights(
                weights=weights, version=self.version,
                roles=self.cfg.sync_roles)
            if out["failed"]:
                logger.warning("weight sync missed %d replica(s): %s",
                               len(out["failed"]), out["failed"])
        else:
            from .. import api

            ref = api.put(weights)
            try:
                api.broadcast(ref, timeout=60.0)
            except Exception:  # noqa: BLE001 — pre-seed is best-effort
                pass
            for role in self.cfg.sync_roles:
                for w in self.co.workers(role):
                    try:
                        w.update_weights({"ref": ref,
                                          "version": self.version})
                    except Exception as e:  # noqa: BLE001 — skew visible
                        logger.warning("sync to %s failed: %r", w.key, e)
        try:
            versions = [v for v in self.co.weights_versions().values()
                        if v is not None]
            if versions:
                _m_skew.set(float(max(versions) - min(versions)))
        except Exception:  # noqa: BLE001 — gossip is advisory
            pass

    # --------------------------------------------------------------- loop

    def run_iteration(self) -> Dict[str, float]:
        """One full rollout → reward → train → sync pass. Returns the
        iteration's metrics (reward_mean, loss, the rl ledger, ...)."""
        if self._closed:
            raise RuntimeError("loop is stopped")
        from ..util.profiler import rl_ledger

        g = self.cfg.grpo
        t_iter = time.monotonic()
        with self._lock:
            self._reward_s = 0.0
        self._futures = [f for f in self._futures if not f.done()]
        submitted = 0
        t0 = time.monotonic()
        for gi, prompt in enumerate(self.prompts):
            for _ in range(g.group_size):
                self._futures.append(
                    self._pool.submit(self._rollout_one, gi, prompt))
                submitted += 1
        self._inflight_add(float(submitted))
        # collect: every submitted rollout arrives on the channel as a
        # Trajectory or a drop marker — the count is exact, so this
        # cannot hang on a lost rollout (and stop() breaks it early)
        groups: Dict[int, List[Trajectory]] = {}
        received = 0
        deadline = time.monotonic() + self.cfg.rollout_timeout_s + 30.0
        try:
            while received < submitted and not self._stop.is_set():
                try:
                    item = self.channel.get(timeout=0.2)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        logger.warning(
                            "iteration collected %d/%d rollouts before "
                            "deadline", received, submitted)
                        break
                    continue
                received += 1
                self._inflight_add(-1.0)
                if isinstance(item, Trajectory):
                    groups.setdefault(item.group, []).append(item)
                else:
                    _m_dropped.inc(tags={"reason": item.get(
                        "dropped", "unknown")})
        finally:
            if received < submitted:
                # stop()/deadline mid-iteration: the unconsumed rollouts
                # must not pin the inflight gauge
                self._inflight_add(-float(submitted - received))
        rollout_s = time.monotonic() - t0
        if self._stop.is_set():
            return {"stopped": 1.0}

        t0 = time.monotonic()
        metrics = self._train_groups(groups)
        train_s = time.monotonic() - t0

        t0 = time.monotonic()
        self._sync_weights()
        sync_s = time.monotonic() - t0

        with self._lock:
            reward_s = self._reward_s
        wall = time.monotonic() - t_iter
        # scoring runs concurrently with rollout collection — subtract
        # it from the rollout share so the ledger's partition is honest
        ledger = rl_ledger(wall, rollout_s=max(rollout_s - reward_s, 0.0),
                           reward_s=reward_s, train_s=train_s,
                           weight_sync_s=sync_s)
        for phase in ("rollout", "reward", "train", "weight_sync"):
            _m_phase_s.inc(ledger[phase], tags={"phase": phase})
        _m_stall.set(ledger["sync_stall_fraction"])
        if not np.isnan(metrics["reward_mean"]):
            _m_reward.set(metrics["reward_mean"])
        _m_iterations.inc()
        self.iteration += 1
        metrics.update({
            "training_iteration": float(self.iteration),
            "weights_version": float(self.version),
            "trajectories": float(sum(len(v) for v in groups.values())),
            "submitted": float(submitted),
            **{f"ledger_{k}": float(v) for k, v in ledger.items()},
        })
        return metrics

    def run(self, iterations: int) -> List[Dict[str, float]]:
        out = []
        for _ in range(int(iterations)):
            if self._stop.is_set():
                break
            out.append(self.run_iteration())
        return out

    def stop(self) -> None:
        """Stop mid-anything and unwind: poison the reward worker, close
        the bounded channel (drops its registry queue — no orphan pins),
        zero the inflight gauge. Idempotent."""
        with self._lock:
            if self._closed:
                return
            # closing under the lock + zeroing here (not at the end)
            # makes the gauge handoff atomic: every _inflight_add after
            # this point no-ops, so the one set(0.0) is final
            self._closed = True
            _m_inflight.set(0.0)
        self._stop.set()
        # start no more rollouts, and wait for those in flight (each
        # within rollout_timeout_s), so that no request reaches a replica
        # after stop() returns (the reference leaves them running)
        self._pool.shutdown(wait=False, cancel_futures=True)
        # (a future the shutdown cancelled never counts as done to wait())
        _done, pending = futures_wait(
            [f for f in self._futures if not f.cancelled()],
            timeout=self.cfg.rollout_timeout_s)
        if not pending:  # the workers are idle: join them
            self._pool.shutdown(wait=True)
        self._raw_q.put(None)
        self._reward_thread.join(timeout=10.0)
        # drain anything the reward stage already queued, then drop the
        # channel's registry queue — the gauge/pin hygiene contract
        try:
            while True:
                self.channel.get(timeout=0.01)
        except Exception:  # noqa: BLE001 — Empty, or service gone
            pass
        self.channel.close()

    close = stop

    def __enter__(self) -> "OnlineRLLoop":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
