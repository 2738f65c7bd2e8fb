"""Online linear learning on PyTorch (the port of ``mmlspark_tpu.vw``, Vowpal
Wabbit parity):

  - feature hashing (murmur3) + namespace sparse features   -> featurizer.py
  - per-example adaptive SGD / FTRL: the native C++ pass on
    the host, or one launch of ``csrc/vw_scan.cu`` a pass
    on the card                                              -> learner.py,
                                                                scan_kernel.py
  - pipeline stages with VW-args parsing + training stats    -> stages.py

The distributed fit shards rows over a mesh's data axis (``train_linear(mesh=)``).
"""

from .featurizer import VowpalWabbitFeaturizer, VowpalWabbitInteractions
from .learner import LearnerConfig, LinearLearner, SparseDataset, train_linear
from .stages import (
    VowpalWabbitClassificationModel,
    VowpalWabbitClassifier,
    VowpalWabbitRegressionModel,
    VowpalWabbitRegressor,
    parse_readable_model,
    parse_vw_args,
)

__all__ = [
    "LearnerConfig", "LinearLearner", "SparseDataset",
    "VowpalWabbitClassificationModel", "VowpalWabbitClassifier",
    "VowpalWabbitFeaturizer", "VowpalWabbitInteractions",
    "VowpalWabbitRegressionModel", "VowpalWabbitRegressor",
    "parse_readable_model", "parse_vw_args", "train_linear",
]
