"""Search spaces + suggestion (reference: `python/ray/tune/search/` —
`sample.py` domains, BasicVariantGenerator, grid_search).

The port's copy of ray_tpu/tune/search.py: the same `random.Random(seed)`
draws, so one seed gives the same configs in both packages."""

from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Any, Dict, List, Optional, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclasses.dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclasses.dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclasses.dataclass
class RandInt(Domain):
    low: int
    high: int  # exclusive

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


@dataclasses.dataclass
class Choice(Domain):
    options: Sequence[Any]

    def sample(self, rng):
        return rng.choice(list(self.options))


@dataclasses.dataclass
class GridSearch:
    values: Sequence[Any]


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def randint(low, high) -> RandInt:
    return RandInt(low, high)


def choice(options) -> Choice:
    return Choice(options)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


class Searcher:
    """Sequential suggestion interface (reference: `tune/search/searcher.py
    :: Searcher` — Optuna/HyperOpt adapters implement the same pair)."""

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Dict[str, Any]) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Pre-expands the space (grid x samples) and deals configs in order."""

    def __init__(self, space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self._configs = generate_configs(space, num_samples, seed)
        self._i = 0

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._i >= len(self._configs):
            return None
        cfg = self._configs[self._i]
        self._i += 1
        return cfg


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator, simplified (the algorithm behind
    Optuna's default sampler; reference ships it via `search/optuna/`).

    After n_startup random trials: split history into good/bad by the gamma
    quantile of the objective; per numeric dimension build Gaussian KDEs
    around the good and bad observations; draw candidates from the good
    KDE and keep the candidate maximizing good-density / bad-density.
    Choices are sampled by smoothed good-frequency."""

    def __init__(
        self,
        space: Dict[str, Any],
        metric: str = "loss",
        mode: str = "min",
        num_samples: int = 16,
        n_startup: int = 5,
        gamma: float = 0.33,
        n_candidates: int = 24,
        seed: Optional[int] = None,
    ):
        self.space = space
        self.metric = metric
        self.mode = mode
        self.budget = num_samples
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._suggested = 0
        self._pending: Dict[str, Dict[str, Any]] = {}
        self._observed: List[Any] = []  # (config, score)

    # -- internals ----------------------------------------------------------

    def _numeric_keys(self):
        return [k for k, v in self.space.items()
                if isinstance(v, (Uniform, LogUniform, RandInt))]

    def _choice_keys(self):
        return [k for k, v in self.space.items() if isinstance(v, Choice)]

    def _random_config(self) -> Dict[str, Any]:
        cfg = {}
        for k, v in self.space.items():
            cfg[k] = v.sample(self.rng) if isinstance(v, Domain) else v
        return cfg

    @staticmethod
    def _kde_logpdf(x: float, points: List[float], bw: float) -> float:
        import math

        if not points:
            return -1e9
        acc = 0.0
        for p in points:
            acc += math.exp(-0.5 * ((x - p) / bw) ** 2)
        return math.log(acc / (len(points) * bw) + 1e-12)

    def _split(self):
        scored = sorted(
            self._observed, key=lambda cs: cs[1], reverse=(self.mode == "max")
        )
        k = max(1, int(len(scored) * self.gamma))
        good = [c for c, _ in scored[:k]]
        bad = [c for c, _ in scored[k:]] or good
        return good, bad

    def _tpe_config(self) -> Dict[str, Any]:
        import math

        good, bad = self._split()
        cfg: Dict[str, Any] = {}
        for k, v in self.space.items():
            if isinstance(v, (Uniform, LogUniform, RandInt)):
                is_log = isinstance(v, LogUniform)
                xform = (lambda x: math.log(x)) if is_log else float
                lo = xform(v.low)
                hi = xform(v.high if not isinstance(v, RandInt) else v.high - 1)
                gpts = [xform(c[k]) for c in good if k in c]
                bpts = [xform(c[k]) for c in bad if k in c]
                bw = max((hi - lo) / 5.0, 1e-9)
                best_x, best_score = None, -1e18
                for _ in range(self.n_candidates):
                    if gpts and self.rng.random() < 0.8:
                        x = min(hi, max(lo, self.rng.gauss(
                            self.rng.choice(gpts), bw)))
                    else:
                        x = self.rng.uniform(lo, hi)
                    score = (self._kde_logpdf(x, gpts, bw)
                             - self._kde_logpdf(x, bpts, bw))
                    if score > best_score:
                        best_x, best_score = x, score
                val = math.exp(best_x) if is_log else best_x
                cfg[k] = int(round(val)) if isinstance(v, RandInt) else val
            elif isinstance(v, Choice):
                opts = list(v.options)
                counts = {o: 1.0 for o in opts}  # +1 smoothing
                for c in good:
                    if k in c and c[k] in counts:
                        counts[c[k]] += 1.0
                total = sum(counts.values())
                r = self.rng.random() * total
                acc = 0.0
                for o in opts:
                    acc += counts[o]
                    if r <= acc:
                        cfg[k] = o
                        break
            elif isinstance(v, Domain):
                cfg[k] = v.sample(self.rng)
            else:
                cfg[k] = v
        return cfg

    # -- Searcher surface ---------------------------------------------------

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._suggested >= self.budget:
            return None
        self._suggested += 1
        if len(self._observed) < self.n_startup:
            cfg = self._random_config()
        else:
            cfg = self._tpe_config()
        self._pending[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str, result: Dict[str, Any]) -> None:
        cfg = self._pending.pop(trial_id, None)
        val = result.get(self.metric)
        if cfg is not None and val is not None:
            self._observed.append((cfg, float(val)))


def _grid_axes(space: Dict[str, Any]):
    keys = [k for k, v in space.items() if isinstance(v, GridSearch)]
    axes = [list(space[k].values) for k in keys]
    return keys, axes


def generate_configs(
    space: Dict[str, Any], num_samples: int, seed: Optional[int] = None
) -> List[Dict[str, Any]]:
    """Grid axes expand combinatorially; Domains sample; constants pass
    through. num_samples repeats the whole (sampled) space."""
    rng = random.Random(seed)
    keys, axes = _grid_axes(space)
    grid_points = list(itertools.product(*axes)) if axes else [()]
    configs = []
    for _ in range(num_samples):
        for point in grid_points:
            cfg = {}
            for k, v in space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = point[keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            configs.append(cfg)
    return configs
