"""LightGBM-equivalent GBDT (classifier, regressor, ranker) on PyTorch, with
the histogram (K1) and row-select (K2) CUDA kernels on its dense training
path and the flat sparse histogram (K4) on its sparse (CSR) one."""

from .binning import BinMapper
from .booster import Booster, TrainParams, train
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

__all__ = ["BinMapper", "Booster", "DeviceEnsemble", "GrowerConfig",
           "LightGBMClassificationModel", "LightGBMClassifier",
           "LightGBMRanker", "LightGBMRankerModel",
           "LightGBMRegressionModel", "LightGBMRegressor", "TrainParams",
           "Tree", "grow_tree", "predict_ensemble", "train"]
