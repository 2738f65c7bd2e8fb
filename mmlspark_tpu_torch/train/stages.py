"""TrainClassifier / TrainRegressor: auto-featurizing estimator wrappers.

Reference: train/TrainClassifier.scala:23-170 + train/TrainRegressor.scala —
wrap any estimator: reindex labels (classification), auto-featurize all
non-label columns into one vector, fit the inner estimator, and return a model
that scores with standardized column names (scored_labels / scores /
scored_probabilities) and can map predicted indexes back to original labels.

The port's copy of ``mmlspark_tpu/train/stages.py`` (host code around the
port's estimators and ``featurize`` stages).
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasFeaturesCol, HasLabelCol, Param
from ..core.pipeline import Estimator, Model
from ..core.schema import Schema
from ..featurize.assemble import AssembleFeatures
from ..featurize.indexers import ValueIndexer


class _TrainBase(Estimator, HasLabelCol, HasFeaturesCol):
    model = ComplexParam("model", "The inner estimator to train")
    numFeatures = Param("numFeatures", "Hash buckets for featurization", 0, ptype=int)

    def set_model(self, estimator) -> "_TrainBase":
        return self.set("model", estimator)

    def _featurize(self, df: DataFrame, label_col: str):
        feature_cols = [c for c in df.columns if c != label_col]
        if (len(feature_cols) == 1
                and df.schema[feature_cols[0]] in ("vector", "tensor")):
            # already a single vector column: pass through
            return None, feature_cols[0]
        assembler = AssembleFeatures(inputCols=feature_cols,
                                     outputCol=self.get("featuresCol"))
        if self.get("numFeatures"):
            assembler.set("numberOfFeatures", self.get("numFeatures"))
        fitted = assembler.fit(df)
        return fitted, self.get("featuresCol")


class TrainClassifier(_TrainBase):
    """Auto-featurize + label-reindex + fit a classifier
    (train/TrainClassifier.scala:23-170)."""

    reindexLabel = Param("reindexLabel", "Reindex labels to 0..K-1", True, ptype=bool)

    def fit(self, df: DataFrame) -> "TrainedClassifierModel":
        label_col = self.get_or_throw("labelCol")
        inner = self.get_or_throw("model")

        levels = None
        working = df
        if self.get("reindexLabel"):
            indexer = ValueIndexer(inputCol=label_col, outputCol=label_col).fit(df)
            levels = list(indexer.get("levels"))
            working = indexer.transform(df)

        featurizer, feat_col = self._featurize(working, label_col)
        if featurizer is not None:
            working = featurizer.transform(working)

        est = inner.copy()
        if est.has_param("featuresCol"):
            est.set("featuresCol", feat_col)
        if est.has_param("labelCol"):
            est.set("labelCol", label_col)
        fitted = est.fit(working)
        return TrainedClassifierModel(
            model=fitted, featurizer=featurizer, labelCol=label_col,
            featuresCol=feat_col, levels=levels)


class TrainedClassifierModel(Model, HasLabelCol, HasFeaturesCol):
    model = ComplexParam("model", "Fitted inner model")
    featurizer = ComplexParam("featurizer", "Fitted feature assembler (or None)")
    levels = ComplexParam("levels", "Original label values by index")

    def transform(self, df: DataFrame) -> DataFrame:
        featurizer = self.get("featurizer")
        working = featurizer.transform(df) if featurizer is not None else df
        inner = self.get_or_throw("model")
        scored = inner.transform(working)

        # standardize column names (reference SparkSchema.setLabelColumnName etc.)
        renames = {}
        if inner.has_param("predictionCol"):
            renames[inner.get("predictionCol")] = "scored_labels"
        if inner.has_param("rawPredictionCol") and \
                inner.get("rawPredictionCol") in scored.schema:
            renames[inner.get("rawPredictionCol")] = "scores"
        if inner.has_param("probabilityCol") and \
                inner.get("probabilityCol") in scored.schema:
            renames[inner.get("probabilityCol")] = "scored_probabilities"
        for old, new in renames.items():
            if old in scored.schema and old != new:
                scored = scored.with_column_renamed(old, new)

        levels = self.get("levels")
        if levels:
            def back(p):
                out = np.empty(len(p["scored_labels"]), dtype=object)
                for i, v in enumerate(p["scored_labels"]):
                    iv = int(v)
                    out[i] = levels[iv] if 0 <= iv < len(levels) else None
                return out
            scored = scored.with_column("scored_labels_original", back)
        return scored


class TrainRegressor(_TrainBase):
    """Auto-featurize + fit a regressor (train/TrainRegressor.scala)."""

    def fit(self, df: DataFrame) -> "TrainedRegressorModel":
        label_col = self.get_or_throw("labelCol")
        inner = self.get_or_throw("model")
        featurizer, feat_col = self._featurize(df, label_col)
        working = featurizer.transform(df) if featurizer is not None else df
        est = inner.copy()
        if est.has_param("featuresCol"):
            est.set("featuresCol", feat_col)
        if est.has_param("labelCol"):
            est.set("labelCol", label_col)
        fitted = est.fit(working)
        return TrainedRegressorModel(model=fitted, featurizer=featurizer,
                                     labelCol=label_col, featuresCol=feat_col)


class TrainedRegressorModel(Model, HasLabelCol, HasFeaturesCol):
    model = ComplexParam("model", "Fitted inner model")
    featurizer = ComplexParam("featurizer", "Fitted feature assembler (or None)")

    def transform(self, df: DataFrame) -> DataFrame:
        featurizer = self.get("featurizer")
        working = featurizer.transform(df) if featurizer is not None else df
        inner = self.get_or_throw("model")
        scored = inner.transform(working)
        if inner.has_param("predictionCol"):
            pc = inner.get("predictionCol")
            if pc in scored.schema and pc != "scored_labels":
                scored = scored.with_column_renamed(pc, "scored_labels")
        return scored
