"""LightGBM-equivalent GBDT (classifier, regressor, ranker) on PyTorch, with
the histogram (K1) and row-select (K2) CUDA kernels on its dense training
path and the flat sparse histogram (K4) on its sparse (CSR) one;
categorical set splits, LightGBM text interchange (``lgbm_format``) and
checkpointed training (``CheckpointConfig``)."""

from .binning import BinMapper
from .booster import Booster, TrainParams, train
from .checkpoint import CheckpointConfig
from .lgbm_format import from_lightgbm_string, to_lightgbm_string
from .predict import DeviceEnsemble, predict_ensemble
from .stages import (
    LightGBMClassificationModel,
    LightGBMClassifier,
    LightGBMRanker,
    LightGBMRankerModel,
    LightGBMRegressionModel,
    LightGBMRegressor,
)
from .tree import GrowerConfig, Tree, grow_tree

__all__ = ["BinMapper", "Booster", "CheckpointConfig", "DeviceEnsemble",
           "GrowerConfig",
           "LightGBMClassificationModel", "LightGBMClassifier",
           "LightGBMRanker", "LightGBMRankerModel",
           "LightGBMRegressionModel", "LightGBMRegressor", "TrainParams",
           "Tree", "from_lightgbm_string", "grow_tree", "predict_ensemble",
           "to_lightgbm_string", "train"]
