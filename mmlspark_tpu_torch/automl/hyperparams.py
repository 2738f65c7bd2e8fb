"""Default hyperparameter search ranges per learner family
(reference automl/DefaultHyperparams.scala; the port's copy of
``mmlspark_tpu/automl/hyperparams.py``)."""

from __future__ import annotations

from typing import List, Tuple

from .params import DiscreteHyperParam, Dist, RangeHyperParam


class DefaultHyperparams:
    @staticmethod
    def lightgbm_classifier() -> List[Tuple[str, Dist]]:
        return [
            ("numLeaves", DiscreteHyperParam([7, 15, 31, 63])),
            ("numIterations", DiscreteHyperParam([25, 50, 100])),
            ("learningRate", RangeHyperParam(0.05, 0.3)),
            ("minDataInLeaf", DiscreteHyperParam([5, 10, 20])),
            ("baggingFraction", RangeHyperParam(0.7, 1.0)),
        ]

    @staticmethod
    def lightgbm_regressor() -> List[Tuple[str, Dist]]:
        return DefaultHyperparams.lightgbm_classifier()

    @staticmethod
    def vw_classifier() -> List[Tuple[str, Dist]]:
        return [
            ("learningRate", RangeHyperParam(0.05, 1.0)),
            ("numPasses", DiscreteHyperParam([1, 3, 5, 10])),
            ("l2", DiscreteHyperParam([0.0, 1e-6, 1e-4])),
        ]

    @staticmethod
    def for_estimator(estimator) -> List[Tuple[str, Dist]]:
        name = type(estimator).__name__
        if "LightGBM" in name and "Regressor" in name:
            return DefaultHyperparams.lightgbm_regressor()
        if "LightGBM" in name:
            return DefaultHyperparams.lightgbm_classifier()
        if "VowpalWabbit" in name:
            return DefaultHyperparams.vw_classifier()
        return [(n, DiscreteHyperParam([p.default]))
                for n, p in estimator.params().items()
                if p.default is not None and isinstance(p.default, (int, float))
                and not isinstance(p.default, bool)][:3]
