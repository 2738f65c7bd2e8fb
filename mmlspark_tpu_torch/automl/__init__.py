"""AutoML: hyperparameter tuning and model selection (reference automl/ package).

TuneHyperparameters (k-fold CV x random/grid sweep, round-robin over estimators,
parallel via thread pool — automl/TuneHyperparameters.scala:130-203),
HyperparamBuilder/ParamSpace/GridSpace (automl/ParamSpace.scala),
DefaultHyperparams per-learner ranges, FindBestModel
(automl/FindBestModel.scala:55-150), EvaluationUtils metric dispatch.

The port of ``mmlspark_tpu.automl``: host code, whose fits and scoring run
on the card (or on the device ``use_device`` asks for, in every worker
thread as in the caller's).
"""

from .params import (
    DiscreteHyperParam,
    GridSpace,
    HyperparamBuilder,
    ParamSpace,
    RangeHyperParam,
)
from .hyperparams import DefaultHyperparams
from .tuning import (
    BestModel,
    FindBestModel,
    MetricEvaluator,
    TuneHyperparameters,
    TuneHyperparametersModel,
)

__all__ = [
    "BestModel", "DefaultHyperparams", "DiscreteHyperParam", "FindBestModel",
    "GridSpace", "HyperparamBuilder", "MetricEvaluator", "ParamSpace",
    "RangeHyperParam", "TuneHyperparameters", "TuneHyperparametersModel",
]
