"""Hyperparameter tuning and model selection.

Reference: automl/TuneHyperparameters.scala:130-203 — k-fold CV over sampled
param maps, round-robin across multiple estimators, futures-parallel;
automl/FindBestModel.scala:55-150 — evaluate fitted models on one dataset and
keep the best; automl/EvaluationUtils.scala — metric name -> ordering.

The port of ``mmlspark_tpu/automl/tuning.py``. With ``parallelism`` > 1
the candidates run on a thread pool, as in the reference; each worker
enters the caller's device (``runtime.on_device``: the device
``use_device`` asked for, else the card) on a CUDA stream of its own
(``core.graphs.capture_stream``), where its fits also capture their CUDA
graphs, so concurrent fits neither share a stream nor invalidate each
other's captures.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasEvaluationMetric, HasLabelCol, Param
from ..core.pipeline import Estimator, Evaluator, Model
from ..runtime import default_device, on_device
from ..train.metrics import classification_metrics, regression_metrics
from .params import GridSpace

_HIGHER_BETTER = {"accuracy", "precision", "recall", "AUC", "R^2"}
_LOWER_BETTER = {"mean_squared_error", "root_mean_squared_error",
                 "mean_absolute_error", "log_loss"}


def _trial_instruments():
    """Per-candidate trial instruments on the process-default registry
    (obs/metrics.py), created lazily INSIDE fit so the
    ``mmlspark_automl_trial_*`` families exist only once tuning has
    actually run (the absent-when-unused exposition contract). Returns
    None when obs is unavailable — tuning never depends on it."""
    try:
        from ..obs.metrics import default_registry

        reg = default_registry()
        return (
            reg.histogram(
                "mmlspark_automl_trial_seconds",
                "wall seconds per tuning candidate (k folds: fit + score)",
                ("estimator",)),
            reg.gauge(
                "mmlspark_automl_trial_metric",
                "last candidate's cross-validated eval metric",
                ("estimator", "metric")),
            reg.counter(
                "mmlspark_automl_trials_total",
                "tuning candidates evaluated", ("estimator",)),
        )
    except Exception:  # noqa: BLE001 — obs must never fail a fit
        return None


def metric_is_higher_better(metric: str) -> bool:
    if metric in _HIGHER_BETTER:
        return True
    if metric in _LOWER_BETTER:
        return False
    raise ValueError(f"Unknown metric {metric!r}")


class MetricEvaluator(Evaluator, HasLabelCol, HasEvaluationMetric):
    """Evaluate a scored DataFrame by metric name (EvaluationUtils parity).

    Understands the standardized scored columns (scored_labels /
    scored_probabilities) and plain prediction columns.
    """

    def __init__(self, metric: str = "accuracy", **kwargs):
        super().__init__(**kwargs)
        self.set("evaluationMetric", metric)

    def evaluate(self, df: DataFrame) -> float:
        metric = self.get_or_throw("evaluationMetric")
        data = df.collect()
        y = np.asarray(data[self.get_or_throw("labelCol")], dtype=np.float64)
        pred_col = "scored_labels" if "scored_labels" in df.schema else "prediction"
        if metric in ("accuracy", "precision", "recall", "AUC"):
            pred = np.asarray(data[pred_col], dtype=np.float64)
            scores = None
            for sc in ("scored_probabilities", "probability"):
                if sc in df.schema:
                    raw = data[sc]
                    scores = np.array([
                        float(np.asarray(v).reshape(-1)[-1]) if v is not None
                        and np.asarray(v).ndim > 0 else float(v)
                        for v in raw])
                    break
            m = classification_metrics(y, pred, scores)
            return float(m[metric])
        pred = np.asarray(data[pred_col], dtype=np.float64)
        return float(regression_metrics(y, pred)[metric])

    def is_larger_better(self) -> bool:
        return metric_is_higher_better(self.get_or_throw("evaluationMetric"))


class TuneHyperparameters(Estimator, HasEvaluationMetric):
    """CV-tune one or more estimators over a param space."""

    models = ComplexParam("models", "Estimators to tune (round-robin)")
    paramSpace = ComplexParam("paramSpace", "ParamSpace/GridSpace of settings")
    numFolds = Param("numFolds", "Cross-validation folds", 3,
                     lambda v: v >= 2, int)
    numRuns = Param("numRuns", "Sampled settings per estimator", 10,
                    lambda v: v > 0, int)
    parallelism = Param("parallelism", "Concurrent fits", 1, lambda v: v > 0, int)
    seed = Param("seed", "Fold-split seed", 0, ptype=int)
    labelCol = Param("labelCol", "Label column for evaluation", "label", ptype=str)

    def fit(self, df: DataFrame) -> "TuneHyperparametersModel":
        estimators = self.get_or_throw("models")
        if not isinstance(estimators, (list, tuple)):
            estimators = [estimators]
        space = self.get_or_throw("paramSpace")
        metric = self.get_or_throw("evaluationMetric")
        evaluator = MetricEvaluator(metric, labelCol=self.get("labelCol"))
        higher = evaluator.is_larger_better()
        n_folds = self.get("numFolds")
        n_runs = self.get("numRuns")

        # pre-split folds once
        folds = df.random_split([1.0] * n_folds, seed=self.get("seed"))

        settings: List[List[Tuple[Any, str, Any]]] = []
        gen = space.param_maps()
        if isinstance(space, GridSpace):
            settings = list(gen)
        else:
            for _ in range(n_runs):
                settings.append(next(gen))

        # round-robin: every estimator tries every sampled setting's values that
        # belong to it (settings may bind params to specific estimators)
        candidates: List[Tuple[Any, Dict[str, Any]]] = []
        for est in estimators:
            for setting in settings:
                pmap = {name: v for (e, name, v) in setting
                        if e is est or e is None or type(e) is type(est)}
                candidates.append((est, pmap))

        instruments = _trial_instruments()

        def run_candidate(args):
            est, pmap = args
            t0 = time.perf_counter()
            vals = []
            for i in range(n_folds):
                train_parts = [folds[j] for j in range(n_folds) if j != i]
                train_df = train_parts[0]
                for t in train_parts[1:]:
                    train_df = train_df.union(t)
                stage = est.copy(pmap)
                model = stage.fit(train_df)
                scored = model.transform(folds[i])
                vals.append(evaluator.evaluate(scored))
            result = float(np.mean(vals))
            if instruments is not None:
                # per-candidate wall seconds + eval metric (H002 families,
                # absent while automl is unused — created above, not at
                # import); instruments are thread-safe under parallelism
                try:
                    wall_h, metric_g, trials_c = instruments
                    name = type(est).__name__
                    wall_h.labels(estimator=name).observe(
                        time.perf_counter() - t0)
                    metric_g.labels(estimator=name, metric=metric).set(
                        result)
                    trials_c.labels(estimator=name).inc()
                except Exception:  # noqa: BLE001 — obs never fails a fit
                    pass
            return result

        par = self.get("parallelism")
        if par > 1:
            # a pool thread does not inherit the caller's device: resolve
            # it here and enter it in each worker, on the worker's stream
            dev = default_device()

            def in_worker(args):
                stream = None
                if dev.type == "cuda":
                    from ..core.graphs import capture_stream

                    stream = capture_stream(dev)
                with on_device(dev, stream):
                    return run_candidate(args)

            with ThreadPoolExecutor(max_workers=par) as pool:
                results = list(pool.map(in_worker, candidates))
        else:
            results = [run_candidate(c) for c in candidates]

        best_i = int(np.argmax(results) if higher else np.argmin(results))
        best_est, best_pmap = candidates[best_i]
        best_model = best_est.copy(best_pmap).fit(df)
        return TuneHyperparametersModel(
            bestModel=best_model, bestMetric=float(results[best_i]),
            bestParams=dict(best_pmap),
            allMetrics=[float(r) for r in results])


class TuneHyperparametersModel(Model):
    bestModel = ComplexParam("bestModel", "Winning fitted model")
    bestMetric = Param("bestMetric", "Winning CV metric", None, ptype=float)
    bestParams = Param("bestParams", "Winning param values", None, ptype=dict)
    allMetrics = Param("allMetrics", "Every candidate's CV metric", None, ptype=list)

    def transform(self, df: DataFrame) -> DataFrame:
        return self.get_or_throw("bestModel").transform(df)

    def get_best_model_info(self) -> str:
        return f"params={self.get('bestParams')} metric={self.get('bestMetric')}"


class BestModel(Model):
    """Product of FindBestModel (automl/FindBestModel.scala)."""

    bestModel = ComplexParam("bestModel", "Winning fitted model")
    bestScoredDataset = ComplexParam("bestScoredDataset", "Winner's scored output")
    allModelMetrics = ComplexParam("allModelMetrics", "Per-model metrics DataFrame")
    bestMetric = Param("bestMetric", "Winning metric value", None, ptype=float)

    def transform(self, df: DataFrame) -> DataFrame:
        return self.get_or_throw("bestModel").transform(df)

    def get_evaluation_results(self) -> DataFrame:
        return self.get_or_throw("allModelMetrics")


class FindBestModel(Estimator, HasEvaluationMetric):
    """Evaluate already-fitted models on one dataset; keep the best."""

    models = ComplexParam("models", "Fitted models to compare")
    labelCol = Param("labelCol", "Label column", "label", ptype=str)

    def fit(self, df: DataFrame) -> BestModel:
        models = self.get_or_throw("models")
        metric = self.get_or_throw("evaluationMetric")
        evaluator = MetricEvaluator(metric, labelCol=self.get("labelCol"))
        higher = evaluator.is_larger_better()
        rows = []
        scores = []
        scored_frames = []
        for m in models:
            scored = m.transform(df)
            val = evaluator.evaluate(scored)
            scores.append(val)
            scored_frames.append(scored)
            rows.append({"model": type(m).__name__, metric: val})
        best_i = int(np.argmax(scores) if higher else np.argmin(scores))
        return BestModel(
            bestModel=models[best_i],
            bestScoredDataset=scored_frames[best_i],
            allModelMetrics=DataFrame.from_rows(rows),
            bestMetric=float(scores[best_i]))
