"""Training convenience layer (reference train/ package, SURVEY §2.4).

TrainClassifier/TrainRegressor auto-featurize and fit any estimator;
ComputeModelStatistics / ComputePerInstanceStatistics produce metric DataFrames.

The port's copy of ``mmlspark_tpu/train``: host code around the port's
estimators (the GBDT fits run K1-K4 on the card).
"""

from .stages import (
    TrainClassifier,
    TrainRegressor,
    TrainedClassifierModel,
    TrainedRegressorModel,
)
from .metrics import (
    ComputeModelStatistics,
    ComputePerInstanceStatistics,
    MetricsLogger,
)

__all__ = [
    "ComputeModelStatistics", "ComputePerInstanceStatistics", "MetricsLogger",
    "TrainClassifier", "TrainRegressor", "TrainedClassifierModel",
    "TrainedRegressorModel",
]
