"""Tuner + ResultGrid (reference: `python/ray/tune/tuner.py`,
`result_grid.py`).

The port's copy of ray_tpu/tune/tuner.py. `ResultGrid.dataframe` imports
pandas at the call (the card's machine has none)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from .. import api
from .search import generate_configs
from .trial import Trial, TrialStatus
from .tune_controller import TuneController


@dataclasses.dataclass
class TuneConfig:
    metric: str = "loss"
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Any = None
    search_alg: Any = None  # a Searcher (e.g. TPESearcher); None = pre-expand
    seed: Optional[int] = None
    max_retries: int = 0
    resources_per_trial: Optional[Dict[str, float]] = None


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: str, mode: str):
        self.trials = trials
        self.metric = metric
        self.mode = mode

    def get_best_result(self, metric: Optional[str] = None, mode: Optional[str] = None) -> Trial:
        metric = metric or self.metric
        mode = mode or self.mode
        scored = [t for t in self.trials if t.metric(metric) is not None]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return (max if mode == "max" else min)(scored, key=lambda t: t.metric(metric))

    @property
    def errors(self) -> List[Trial]:
        return [t for t in self.trials if t.status is TrialStatus.ERROR]

    def num_terminated(self) -> int:
        return sum(1 for t in self.trials if t.status is TrialStatus.TERMINATED)

    def dataframe(self):
        import pandas as pd

        rows = []
        for t in self.trials:
            row = {"trial_id": t.trial_id, "status": t.status.value}
            row.update({f"config/{k}": v for k, v in t.config.items()})
            row.update(t.last_result)
            rows.append(row)
        return pd.DataFrame(rows)

    def __len__(self):
        return len(self.trials)


class Tuner:
    def __init__(
        self,
        trainable: Callable[[Dict[str, Any]], Any],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
    ):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()

    def fit(self) -> ResultGrid:
        api._auto_init()
        tc = self.tune_config
        # with a sequential searcher the controller asks for configs as
        # slots free (so the searcher sees completed results); otherwise
        # the whole space is pre-expanded
        configs = [] if tc.search_alg is not None else generate_configs(
            self.param_space, tc.num_samples, tc.seed
        )
        controller = TuneController(
            self.trainable,
            configs,
            scheduler=tc.scheduler,
            max_concurrent=tc.max_concurrent_trials,
            max_retries=tc.max_retries,
            resources_per_trial=tc.resources_per_trial,
            search_alg=tc.search_alg,
        )
        trials = controller.run()
        return ResultGrid(trials, tc.metric, tc.mode)


def run(trainable, config: Optional[dict] = None, num_samples: int = 1, **kw) -> ResultGrid:
    """tune.run-style convenience wrapper."""
    tc = TuneConfig(num_samples=num_samples, **kw)
    return Tuner(trainable, param_space=config, tune_config=tc).fit()
