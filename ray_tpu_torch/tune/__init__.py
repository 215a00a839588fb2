"""ray_tpu_torch.tune — hyperparameter search over trial actors (reference:
Ray Tune A5): search spaces, random/grid suggestion, ASHA + PBT schedulers,
session-based reporting shared with ray_tpu_torch.train.

The port's copy of ray_tpu/tune on the thread-mode runtime: trials are
actors whose lanes run in the process that owns the card, and
`resources_per_trial={"GPU": 0.25}` packs four on one card."""

from ..train.session import get_checkpoint, get_context, report  # noqa: F401
from .schedulers import (  # noqa: F401
    AsyncHyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
)
from .search import (  # noqa: F401
    BasicVariantGenerator,
    Searcher,
    TPESearcher,
    choice,
    generate_configs,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from .trial import Trial, TrialStatus  # noqa: F401
from .tuner import ResultGrid, TuneConfig, Tuner, run  # noqa: F401
