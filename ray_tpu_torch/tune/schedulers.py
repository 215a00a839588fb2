"""Trial schedulers: FIFO, ASHA, PBT.

Reference: `python/ray/tune/schedulers/ :: AsyncHyperBandScheduler,
PopulationBasedTraining`. Decisions are made per reported result.

The port's copy of ray_tpu/tune/schedulers.py: PBT draws from the same
`random.Random(seed)` as the reference, so its choices match.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

from .trial import Trial

CONTINUE = "CONTINUE"
STOP = "STOP"  # early stop (scheduler killed an unpromising trial)
COMPLETE = "COMPLETE"  # time budget reached — normal completion


class FIFOScheduler:
    def on_result(self, trial: Trial, result: Dict[str, Any], all_trials: List[Trial]) -> str:
        return CONTINUE

    def exploit(self, trial: Trial, all_trials: List[Trial]):
        return None


class AsyncHyperBandScheduler:
    """ASHA: at rungs t_min * rf^k, stop trials below the top 1/rf quantile
    of completed rung results."""

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 3,
    ):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.rf = reduction_factor
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        # rung milestone -> list of recorded metric values
        self._rung_results: Dict[int, List[float]] = {r: [] for r in self.rungs}

    def on_result(self, trial: Trial, result: Dict[str, Any], all_trials) -> str:
        t = result.get(self.time_attr)
        val = result.get(self.metric)
        if t is None or val is None:
            return CONTINUE
        if t >= self.max_t:
            return COMPLETE
        for rung in reversed(self.rungs):
            if t == rung:
                recorded = self._rung_results[rung]
                recorded.append(float(val))
                if len(recorded) < self.rf:
                    return CONTINUE  # not enough evidence yet
                k = max(1, len(recorded) // self.rf)
                top = sorted(recorded, reverse=(self.mode == "max"))[:k]
                worst_top = top[-1]
                ok = val >= worst_top if self.mode == "max" else val <= worst_top
                return CONTINUE if ok else STOP
        return CONTINUE

    def exploit(self, trial, all_trials):
        return None


class MedianStoppingRule:
    """Stop a trial whose running mean falls below the median of the other
    trials' running means at the same timestep (reference:
    `schedulers/median_stopping_rule.py`; Vizier's default rule)."""

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        min_samples_required: int = 3,
    ):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        # trial_id -> list of (t, value)
        self._history: Dict[str, List[Any]] = {}

    def _running_mean_at(self, trial_id: str, t: int) -> Optional[float]:
        vals = [v for (tt, v) in self._history.get(trial_id, []) if tt <= t]
        if not vals:
            return None
        return sum(vals) / len(vals)

    def on_result(self, trial: Trial, result: Dict[str, Any], all_trials) -> str:
        t = result.get(self.time_attr)
        val = result.get(self.metric)
        if t is None or val is None:
            return CONTINUE
        self._history.setdefault(trial.trial_id, []).append((t, float(val)))
        if t < self.grace_period:
            return CONTINUE
        others = [
            m for tr in all_trials if tr.trial_id != trial.trial_id
            for m in [self._running_mean_at(tr.trial_id, t)] if m is not None
        ]
        if len(others) < self.min_samples:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        mine = self._running_mean_at(trial.trial_id, t)
        ok = mine >= median if self.mode == "max" else mine <= median
        return CONTINUE if ok else STOP

    def exploit(self, trial, all_trials):
        return None


class PopulationBasedTraining:
    """PBT (restart-based): at each perturbation interval, a bottom-quantile
    trial clones a top-quantile trial's checkpoint + config, with hyperparams
    resampled/perturbed."""

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        perturbation_interval: int = 4,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        seed: Optional[int] = None,
    ):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)

    def on_result(self, trial: Trial, result: Dict[str, Any], all_trials) -> str:
        return CONTINUE

    def exploit(self, trial: Trial, all_trials: List[Trial]):
        """-> (new_config, source_checkpoint) if this trial should exploit,
        else None. Called by the controller at perturbation milestones."""
        t = trial.metric(self.time_attr, 0)
        if t == 0 or t % self.interval != 0:
            return None
        scored = [
            tr for tr in all_trials if tr.metric(self.metric) is not None
        ]
        if len(scored) < 2:
            return None
        scored.sort(key=lambda tr: tr.metric(self.metric), reverse=(self.mode == "max"))
        k = max(1, int(len(scored) * self.quantile))
        top, bottom = scored[:k], scored[-k:]
        if trial not in bottom or trial in top:
            return None
        src = self.rng.choice(top)
        if src.checkpoint is None:
            return None
        new_config = dict(src.config)
        for key, mut in self.mutations.items():
            if callable(mut):
                new_config[key] = mut()
            elif isinstance(mut, list):
                new_config[key] = self.rng.choice(mut)
            else:  # numeric: perturb by 0.8/1.2
                new_config[key] = src.config.get(key, 1.0) * self.rng.choice([0.8, 1.2])
        return new_config, src.checkpoint
