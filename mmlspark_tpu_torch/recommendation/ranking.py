"""Ranking adapters, evaluation, and train/validation splitting.

Reference: recommendation/RankingAdapter.scala (wrap a recommender so transform
emits per-user (recommended items, ground-truth items) for evaluation),
recommendation/RankingEvaluator.scala:15-152 (NDCG@k, MAP, precision@k,
recall@k via AdvancedRankingMetrics), RankingTrainValidationSplit.scala:24-330
(per-user holdout split with min-ratings filtering).

The port of ``mmlspark_tpu/recommendation/ranking.py``, host code. Two
places group by user in O(N log N) where the reference scans every row
once a user (``np.where(users == u)``, O(U·N)): the split, which makes the
same ``rng.permutation`` draws for the same users in the same order, so
its rows are the reference's bit for bit, and ``RankingAdapterModel``'s
ground truth, the same arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, Param
from ..core.pipeline import Estimator, Evaluator, Model


class RankingEvaluator(Evaluator):
    k = Param("k", "Cutoff for @k metrics", 10, lambda v: v > 0, int)
    metricName = Param("metricName", "ndcgAt | map | precisionAtk | recallAtK",
                       "ndcgAt",
                       lambda v: v in ("ndcgAt", "map", "precisionAtk", "recallAtK"),
                       str)
    predictionCol = Param("predictionCol", "Recommended-items array column",
                          "recommendations", ptype=str)
    labelCol = Param("labelCol", "Ground-truth items array column", "label",
                     ptype=str)

    def evaluate(self, df: DataFrame) -> float:
        data = df.collect()
        preds = data[self.get("predictionCol")]
        truths = data[self.get("labelCol")]
        k = self.get("k")
        metric = self.get("metricName")
        # the reference's discounts 1 / log2(i + 2) and their running sums
        # (the ideal DCG at each truth size), summed in its order
        disc = [1.0 / np.log2(i + 2) for i in range(k)]
        ideals = [sum(disc[:m]) for m in range(k + 1)]
        vals = []
        for rec, truth in zip(preds, truths):
            if truth is None or len(truth) == 0:
                continue
            rec = list(np.asarray(rec).astype(np.int64)[:k]) if rec is not None else []
            truth_set = set(np.asarray(truth).astype(np.int64).tolist())
            if metric == "precisionAtk":
                vals.append(len(set(rec) & truth_set) / max(len(rec), 1))
            elif metric == "recallAtK":
                vals.append(len(set(rec) & truth_set) / len(truth_set))
            elif metric == "ndcgAt":
                dcg = sum(disc[i] for i, r in enumerate(rec)
                          if r in truth_set)
                ideal = ideals[min(len(truth_set), k)]
                vals.append(dcg / ideal if ideal > 0 else 0.0)
            elif metric == "map":
                hits, ap = 0, 0.0
                for i, r in enumerate(rec):
                    if r in truth_set:
                        hits += 1
                        ap += hits / (i + 1)
                vals.append(ap / min(len(truth_set), k) if truth_set else 0.0)
        return float(np.mean(vals)) if vals else 0.0

    def is_larger_better(self) -> bool:
        return True


class RankingAdapter(Estimator):
    """Fit a recommender; transform emits per-user (recommendations, label)
    rows ready for RankingEvaluator (RankingAdapter.scala)."""

    recommender = ComplexParam("recommender", "Inner recommender estimator")
    k = Param("k", "Recommendations per user", 10, lambda v: v > 0, int)
    userCol = Param("userCol", "User column", "user", ptype=str)
    itemCol = Param("itemCol", "Item column", "item", ptype=str)
    ratingCol = Param("ratingCol", "Rating column", "rating", ptype=str)
    minRatingsPerUser = Param("minRatingsPerUser", "Filter sparse users", 1,
                              ptype=int)

    def fit(self, df: DataFrame) -> "RankingAdapterModel":
        rec = self.get_or_throw("recommender").copy()
        for p in ("userCol", "itemCol", "ratingCol"):
            if rec.has_param(p):
                rec.set(p, self.get(p))
        model = rec.fit(df)
        return RankingAdapterModel(
            recommenderModel=model, k=self.get("k"),
            userCol=self.get("userCol"), itemCol=self.get("itemCol"))


class RankingAdapterModel(Model):
    recommenderModel = ComplexParam("recommenderModel", "Fitted recommender")
    k = Param("k", "Recommendations per user", 10, ptype=int)
    userCol = Param("userCol", "User column", "user", ptype=str)
    itemCol = Param("itemCol", "Item column", "item", ptype=str)

    def transform(self, df: DataFrame) -> DataFrame:
        """df = held-out interactions; emit per-user recs + ground truth."""
        model = self.get_or_throw("recommenderModel")
        recs = model.recommend_for_all_users(self.get("k"), remove_seen=True)
        rec_data = recs.collect()
        ucol = self.get("userCol")
        rec_of_user = {int(u): r for u, r in
                       zip(rec_data[ucol], rec_data["recommendations"])}
        data = df.collect()
        users = np.asarray(data[ucol], dtype=np.int64)
        items = np.asarray(data[self.get("itemCol")], dtype=np.int64)
        uniq, order, starts = _group_rows(users)
        rows = []
        for u, t in zip(uniq.tolist(),
                        np.split(items[order], starts[1:])):
            rows.append({
                self.get("userCol"): u,
                "recommendations": np.asarray(
                    rec_of_user.get(u, np.empty(0)), dtype=np.int64),
                "label": t,
            })
        return DataFrame.from_rows(rows)


def _group_rows(users: np.ndarray):
    """(the users in ``np.unique`` order, the row indexes grouped by user
    with each user's rows in row order, each group's start): one stable
    sort in place of an ``np.where(users == u)`` a user."""
    order = np.argsort(users, kind="stable")
    su = users[order]
    starts = np.concatenate([[0], np.flatnonzero(su[1:] != su[:-1]) + 1]) \
        .astype(np.int64) if len(su) else np.zeros(0, np.int64)
    return su[starts], order, starts


class RankingTrainValidationSplit(Estimator):
    """Per-user train/validation split + fit + evaluate
    (RankingTrainValidationSplit.scala:24-330)."""

    estimator = ComplexParam("estimator", "Recommender (or RankingAdapter)")
    evaluator = ComplexParam("evaluator", "RankingEvaluator")
    trainRatio = Param("trainRatio", "Fraction of each user's events for training",
                       0.75, lambda v: 0 < v < 1, float)
    userCol = Param("userCol", "User column", "user", ptype=str)
    itemCol = Param("itemCol", "Item column", "item", ptype=str)
    ratingCol = Param("ratingCol", "Rating column", "rating", ptype=str)
    minRatingsPerUser = Param("minRatingsPerUser", "Drop users with fewer events", 2,
                              lambda v: v >= 1, int)
    seed = Param("seed", "Split seed", 0, ptype=int)

    def split(self, df: DataFrame) -> Tuple[DataFrame, DataFrame]:
        """Stratified-by-user split (public for parity with the reference API)."""
        data = df.collect()
        ucol = self.get("userCol")
        users = np.asarray(data[ucol], dtype=np.int64)
        n = len(users)
        rng = np.random.default_rng(self.get("seed"))
        ratio = self.get("trainRatio")
        min_r = self.get("minRatingsPerUser")
        in_train = np.zeros(n, dtype=bool)
        keep = np.ones(n, dtype=bool)
        _, order, starts = _group_rows(users)
        for idx in np.split(order, starts[1:]) if n else ():
            if len(idx) < min_r:
                keep[idx] = False
                continue
            perm = rng.permutation(len(idx))
            n_train = max(1, int(round(len(idx) * ratio)))
            n_train = min(n_train, len(idx) - 1)  # always hold out >= 1
            in_train[idx[perm[:n_train]]] = True
        train = {k: v[in_train & keep] for k, v in data.items()}
        val = {k: v[~in_train & keep] for k, v in data.items()}
        return DataFrame([train]), DataFrame([val])

    def fit(self, df: DataFrame) -> "RankingTrainValidationSplitModel":
        train, val = self.split(df)
        est = self.get_or_throw("estimator")
        if not isinstance(est, RankingAdapter):
            est = RankingAdapter(recommender=est, userCol=self.get("userCol"),
                                 itemCol=self.get("itemCol"),
                                 ratingCol=self.get("ratingCol"))
        model = est.fit(train)
        evaluator = self.get("evaluator") or RankingEvaluator()
        metric = evaluator.evaluate(model.transform(val))
        return RankingTrainValidationSplitModel(
            bestModel=model, validationMetric=float(metric))


class RankingTrainValidationSplitModel(Model):
    bestModel = ComplexParam("bestModel", "Fitted ranking adapter model")
    validationMetric = Param("validationMetric", "Held-out metric", None, ptype=float)

    def transform(self, df: DataFrame) -> DataFrame:
        return self.get_or_throw("bestModel").transform(df)
