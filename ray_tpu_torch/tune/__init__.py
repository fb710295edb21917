"""ray_tpu_torch.tune: hyperparameter tuning over the port's core API (the
port of ``ray_tpu/tune``; reference: ``python/ray/tune``)."""

from ray_tpu_torch.tune.schedulers import (
    PB2,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.search import (
    Searcher,
    TPESearch,
    choice,
    grid_search,
    loguniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.tuner import (
    ResultGrid,
    TrialResult,
    TuneConfig,
    Tuner,
    get_checkpoint,
    report,
    run,
)

__all__ = [
    "AsyncHyperBandScheduler", "FIFOScheduler", "MedianStoppingRule",
    "PB2", "PopulationBasedTraining", "ResultGrid", "Searcher",
    "TPESearch", "TrialResult", "TuneConfig", "Tuner", "choice",
    "get_checkpoint", "grid_search", "loguniform", "randint", "report",
    "run", "sample_from", "uniform",
]
