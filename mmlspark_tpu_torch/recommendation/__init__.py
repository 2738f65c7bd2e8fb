"""Recommendation: SAR + ranking adapters/evaluation (reference recommendation/).

SAR (Smart Adaptive Recommendations): time-decayed user-item affinity x
item-item similarity, computed as device matmuls (recommendation/SAR.scala:66-120,
SARModel.scala:23-169). Ranking evaluation: NDCG@k / MAP / precision@k / recall@k
(RankingEvaluator.scala:15-152), per-user train/validation splitting
(RankingTrainValidationSplit.scala, RankingAdapter.scala).

The port of ``mmlspark_tpu.recommendation``: SAR's affinity, co-occurrence,
similarity, scores and top k run on the card (f32, TF32 off); the indexer,
the split and the evaluator are host code.
"""

from .indexer import RecommendationIndexer, RecommendationIndexerModel
from .sar import SAR, SARModel
from .ranking import (
    RankingAdapter,
    RankingAdapterModel,
    RankingEvaluator,
    RankingTrainValidationSplit,
    RankingTrainValidationSplitModel,
)

__all__ = [
    "RankingAdapter", "RankingAdapterModel", "RankingEvaluator",
    "RankingTrainValidationSplit", "RankingTrainValidationSplitModel",
    "RecommendationIndexer", "RecommendationIndexerModel", "SAR", "SARModel",
]
