"""Model-evaluation metric stages.

Reference: train/ComputeModelStatistics.scala:56-460 — classification metrics
(accuracy/precision/recall/AUC + confusion matrix, macro-averaged for
multiclass) and regression metrics (MSE/RMSE/R^2/MAE) as a metrics DataFrame;
train/ComputePerInstanceStatistics.scala — per-row loss columns;
MetricsLogger (:461-470) pushes metrics into the logging system.

The port's copy of ``mmlspark_tpu/train/metrics.py`` (host code; metrics
go to the port's ``obs/metrics`` registry).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import (
    HasEvaluationMetric,
    HasLabelCol,
    HasScoredLabelsCol,
    HasScoredProbabilitiesCol,
    HasScoresCol,
    Param,
)
from ..core.pipeline import Transformer

log = logging.getLogger("mmlspark_tpu_torch.metrics")


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, k: int) -> np.ndarray:
    cm = np.zeros((k, k), dtype=np.int64)
    np.add.at(cm, (y_true.astype(np.int64), y_pred.astype(np.int64)), 1)
    return cm


def auc_score(labels: np.ndarray, scores: np.ndarray) -> float:
    order = np.argsort(scores)
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    for v in np.unique(scores):
        m = scores == v
        if m.sum() > 1:
            ranks[m] = ranks[m].mean()
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def classification_metrics(y_true: np.ndarray, y_pred: np.ndarray,
                           scores: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Binary/multiclass metrics with the reference's macro-averaging
    (ComputeModelStatistics.scala:321-365)."""
    classes = np.unique(np.concatenate([y_true, y_pred]))
    k = int(classes.max()) + 1 if len(classes) else 1
    cm = confusion_matrix(y_true, y_pred, k)
    total = cm.sum()
    accuracy = float(np.trace(cm)) / total if total else 0.0
    per_class_prec = []
    per_class_rec = []
    for c in range(k):
        tp = cm[c, c]
        fp = cm[:, c].sum() - tp
        fn = cm[c, :].sum() - tp
        per_class_prec.append(tp / (tp + fp) if tp + fp else 0.0)
        per_class_rec.append(tp / (tp + fn) if tp + fn else 0.0)
    out = {
        "confusion_matrix": cm,
        "accuracy": accuracy,
        "precision": float(np.mean(per_class_prec)),
        "recall": float(np.mean(per_class_rec)),
    }
    if k <= 2:
        # binary: positive-class precision/recall (reference behavior)
        out["precision"] = float(per_class_prec[-1])
        out["recall"] = float(per_class_rec[-1])
        if scores is not None:
            out["AUC"] = auc_score(y_true, scores)
    return out


def regression_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    err = y_pred - y_true
    mse = float(np.mean(err ** 2))
    var = float(np.var(y_true))
    return {
        "mean_squared_error": mse,
        "root_mean_squared_error": float(np.sqrt(mse)),
        "R^2": 1.0 - mse / var if var > 0 else 0.0,
        "mean_absolute_error": float(np.mean(np.abs(err))),
    }


class ComputeModelStatistics(Transformer, HasLabelCol, HasScoredLabelsCol,
                             HasScoresCol, HasScoredProbabilitiesCol,
                             HasEvaluationMetric):
    """Scored DataFrame -> one-row metrics DataFrame."""

    def transform(self, df: DataFrame) -> DataFrame:
        data = df.collect()
        y = np.asarray(data[self.get_or_throw("labelCol")], dtype=np.float64)
        metric = self.get("evaluationMetric") or "all"

        is_classification = metric in ("classification", "all") and \
            self.get("scoredLabelsCol") in df.schema
        if metric in ("accuracy", "precision", "recall", "AUC"):
            is_classification = True

        if is_classification:
            pred = np.asarray(data[self.get("scoredLabelsCol")], dtype=np.float64)
            scores = None
            if self.get("scoresCol") in df.schema:
                raw = data[self.get("scoresCol")]
                scores = np.array([float(np.asarray(v).reshape(-1)[-1])
                                   if v is not None else 0.0 for v in raw])
            elif self.get("scoredProbabilitiesCol") in df.schema:
                raw = data[self.get("scoredProbabilitiesCol")]
                scores = np.array([float(np.asarray(v).reshape(-1)[-1])
                                   if v is not None else 0.0 for v in raw])
            m = classification_metrics(y, pred, scores)
            row = {k: (v if not isinstance(v, np.ndarray) else v)
                   for k, v in m.items()}
            if metric in ("accuracy", "precision", "recall", "AUC"):
                row = {"confusion_matrix": m["confusion_matrix"],
                       metric: m[metric]}
            MetricsLogger.log_metrics({k: v for k, v in row.items()
                                       if not isinstance(v, np.ndarray)})
            return DataFrame.from_rows([row])

        pred_col = (self.get("scoredLabelsCol")
                    if self.get("scoredLabelsCol") in df.schema else "prediction")
        pred = np.asarray(data[pred_col], dtype=np.float64)
        m = regression_metrics(y, pred)
        if metric in m:
            m = {metric: m[metric]}
        MetricsLogger.log_metrics(m)
        return DataFrame.from_rows([m])


class ComputePerInstanceStatistics(Transformer, HasLabelCol, HasScoredLabelsCol,
                                   HasScoresCol, HasScoredProbabilitiesCol,
                                   HasEvaluationMetric):
    """Append per-row loss columns (train/ComputePerInstanceStatistics.scala)."""

    def transform(self, df: DataFrame) -> DataFrame:
        label_col = self.get_or_throw("labelCol")
        if self.get("scoredProbabilitiesCol") in df.schema:
            prob_col = self.get("scoredProbabilitiesCol")

            def fn(p):
                n = len(p[label_col])
                out = np.empty(n, dtype=np.float64)
                for i in range(n):
                    y = int(p[label_col][i])
                    probs = np.asarray(p[prob_col][i], dtype=np.float64).reshape(-1)
                    pi = probs[y] if 0 <= y < len(probs) else 1e-15
                    out[i] = -np.log(max(pi, 1e-15))
                return out

            return df.with_column("log_loss", fn)

        pred_col = (self.get("scoredLabelsCol")
                    if self.get("scoredLabelsCol") in df.schema else "prediction")

        def fn(p):
            y = np.asarray(p[label_col], dtype=np.float64)
            pred = np.asarray(p[pred_col], dtype=np.float64)
            return (pred - y) ** 2

        return df.with_column("squared_error", fn)


class MetricsLogger:
    """Metric emission (ComputeModelStatistics.scala:461-470 parity, both
    halves): every metric goes to the logging system AND into an obs
    MetricsRegistry as ``mmlspark_eval_metric{metric=...}`` gauges — the
    reference pushed into Spark's metrics sink; here the registry makes
    eval results scrapeable at ``/_mmlspark/metrics``, not just a returned
    DataFrame. Non-numeric values are logged but not gauged."""

    @staticmethod
    def log_metrics(metrics: Dict[str, Any], registry=None) -> None:
        from ..obs.metrics import default_registry

        reg = registry if registry is not None else default_registry()
        gauge = reg.gauge("mmlspark_eval_metric",
                          "last ComputeModelStatistics value per metric",
                          ("metric",))
        for k, v in metrics.items():
            log.info("metric %s=%s", k, v)
            try:
                gauge.labels(metric=str(k)).set(float(v))
            except (TypeError, ValueError):
                pass
