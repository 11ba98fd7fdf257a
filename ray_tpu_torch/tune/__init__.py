"""ray_tpu_torch.tune — hyperparameter search over parallel trials.

Reference parity: ``ray.tune`` (``python/ray/tune/``) — a ``Tuner``
samples configs from a param space (``grid_search/choice/uniform/
loguniform/randint``), runs trials in parallel on the cluster, collects
per-iteration ``tune.report`` metrics, schedules with FIFO, ASHA
successive halving, or Population Based Training (exploit + explore
over trial checkpoints), checkpoints trial state, and returns a
``ResultGrid`` with ``get_best_result`` (SURVEY.md §1 layer 14; mount
empty).
"""

from ..train.checkpoint import Checkpoint
from .search import choice, grid_search, loguniform, randint, uniform
from .tuner import (ASHAScheduler, FIFOScheduler,
                    PopulationBasedTraining, ResultGrid, TrialResult,
                    TuneConfig, Tuner, get_checkpoint, report, run)

__all__ = ["ASHAScheduler", "Checkpoint", "FIFOScheduler",
           "PopulationBasedTraining", "ResultGrid", "TrialResult",
           "TuneConfig", "Tuner", "choice", "get_checkpoint",
           "grid_search", "loguniform", "randint", "report", "run",
           "uniform"]
