"""SAR — Smart Adaptive Recommendations, as dense products on the card.

Reference: recommendation/SAR.scala:66-120 (time-decayed user-item affinity),
item-item co-occurrence similarity (jaccard / lift / cooccurrence) via sparse
matrix multiply, SARModel.recommendForAllUsers (SARModel.scala:23-169).

The port of ``mmlspark_tpu/recommendation/sar.py``. On the card, in f32:
the affinity [U, I], summed as ``np.add.at`` sums it (repeated (user, item)
events in input order, ``affinity_matrix``); the binary matrix and the
co-occurrence C = BᵀB (``torch.matmul`` with TF32 off: exact for 0/1
inputs while the counts stay below 2^24); the similarity in the
reference's f32 elementwise order, so S is the reference's bit for bit;
the scores A @ S; and the top k of every user. The time decay stays f64
on the host, as in the reference.

One deliberate deviation: the reference ranks with
``np.argsort(-scores)``, which orders tied scores arbitrarily; the port
orders by (score descending, item ascending) (``top_k``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, Param
from ..core.pipeline import Estimator, Model
from ..gbdt.predict import _full_f32
from ..runtime import default_device

SUPPORTED_SIMILARITIES = ("cooccurrence", "jaccard", "lift")

#: users a ``top_k`` chunk ranks at once (its int64 keys: U_chunk x I x 8 B)
TOPK_CHUNK_USERS = 8192


def affinity_matrix(users: np.ndarray, items: np.ndarray, values: np.ndarray,
                    n_users: int, n_items: int, device) -> torch.Tensor:
    """``np.add.at(zeros((U, I), f32), (users, items), values)`` on
    ``device``: the events sorted stably by cell, and each cell's values
    added one pass an event, in input order, to 0 (f32 adds in the order
    ``np.add.at`` makes them, so repeated events sum to the same bits)."""
    key = torch.as_tensor(users * n_items + items, device=device)
    vals = torch.as_tensor(values, dtype=torch.float32, device=device)
    out = torch.zeros(n_users * n_items, dtype=torch.float32, device=device)
    if key.numel():
        order = torch.argsort(key, stable=True)
        cells, counts = torch.unique_consecutive(key[order],
                                                 return_counts=True)
        vals = vals[order]
        starts = torch.cumsum(counts, 0) - counts
        acc = torch.zeros(len(cells), dtype=torch.float32, device=device)
        for j in range(int(counts.max())):            # one host read
            m = counts > j
            acc[m] = acc[m] + vals[starts[m] + j]
        out[cells] = acc
    return out.view(n_users, n_items)


def cooccurrence(binary: torch.Tensor) -> torch.Tensor:
    """C = BᵀB in f32 (exact for 0/1 entries below 2^24 users)."""
    with _full_f32():
        return torch.matmul(binary.t(), binary)


def similarity(C: torch.Tensor, kind: str, threshold: float) -> torch.Tensor:
    """The reference's item similarity from C, in its f32 elementwise order
    (``sar.py:80-93``): jaccard C / (d_i + d_j - C), lift C / (d_i d_j),
    or C; cells below the support threshold (and diagonal cells whose
    count is below it) zeroed."""
    diag = torch.diagonal(C).clone()
    if kind == "cooccurrence":
        S = C.clone()
    else:
        if kind == "jaccard":
            denom = diag[:, None] + diag[None, :] - C
        else:  # lift
            denom = diag[:, None] * diag[None, :]
        S = torch.where(denom > 0, C / torch.clamp(denom, min=1e-12), 0.0)
    S = torch.where(C >= threshold, S, 0.0)
    d = torch.diagonal(S)
    d.copy_(torch.where(diag >= threshold, d, 0.0))
    return S


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's k best (items [R, k] int64, scores [R, k]) ordered by
    (score descending, item ascending): one ``topk`` over int64 keys whose
    high 32 bits order the f32 score (+0.0 for -0.0) and whose low 32 bits
    order the item backwards, so no two keys tie."""
    n_items = scores.shape[1]
    bits = (scores + 0.0).view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    item = torch.arange(n_items, device=scores.device, dtype=torch.int64)
    keys = (ordered << 32) | (n_items - 1 - item)
    top = torch.topk(keys, k, dim=1).values
    items = (n_items - 1) - (top & 0xFFFFFFFF)
    return items, torch.gather(scores, 1, items)


def _f32_on(a, dev) -> torch.Tensor:
    return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a),
                           dtype=torch.float32, device=dev)


class SAR(Estimator):
    userCol = Param("userCol", "Indexed user column", "user", ptype=str)
    itemCol = Param("itemCol", "Indexed item column", "item", ptype=str)
    ratingCol = Param("ratingCol", "Rating column", "rating", ptype=str)
    timeCol = Param("timeCol", "Event-time column (unix seconds; optional)", None,
                    ptype=str)
    supportThreshold = Param("supportThreshold",
                             "Min co-occurrence count to keep similarity", 4,
                             lambda v: v >= 0, int)
    similarityFunction = Param("similarityFunction",
                               "cooccurrence | jaccard | lift", "jaccard",
                               lambda v: v in SUPPORTED_SIMILARITIES, str)
    timeDecayCoeff = Param("timeDecayCoeff", "Half-life in days for affinity decay",
                           30, lambda v: v > 0, int)
    startTime = Param("startTime", "Reference time (unix seconds; default max)",
                      None, ptype=float)

    def fit(self, df: DataFrame) -> "SARModel":
        dev = default_device()
        data = df.collect()
        users = np.asarray(data[self.get_or_throw("userCol")], dtype=np.int64)
        items = np.asarray(data[self.get_or_throw("itemCol")], dtype=np.int64)
        ratings = (np.asarray(data[self.get("ratingCol")], dtype=np.float64)
                   if self.get("ratingCol") in df.schema
                   else np.ones(len(users)))
        n_users = int(users.max()) + 1 if len(users) else 0
        n_items = int(items.max()) + 1 if len(items) else 0

        # --- user-item affinity with time decay (SAR.scala:66-120); the
        # decay in f64 on the host, as in the reference
        if self.get("timeCol") and self.get("timeCol") in df.schema:
            t = np.asarray(data[self.get("timeCol")], dtype=np.float64)
            t_ref = self.get("startTime") or float(t.max())
            half_life_s = self.get("timeDecayCoeff") * 86400.0
            decay = np.power(2.0, -(t_ref - t) / half_life_s)
        else:
            decay = np.ones(len(users))
        affinity = affinity_matrix(users, items,
                                   (ratings * decay).astype(np.float32),
                                   n_users, n_items, dev)

        # --- item-item co-occurrence on the card: C = B^T B
        C = cooccurrence((affinity > 0).to(torch.float32))
        S = similarity(C, self.get("similarityFunction"),
                       float(self.get("supportThreshold")))
        del C
        return SARModel(
            userCol=self.get("userCol"), itemCol=self.get("itemCol"),
            ratingCol=self.get("ratingCol"),
            userAffinity=affinity, itemSimilarity=S)


class SARModel(Model):
    """``userAffinity`` [U, I] and ``itemSimilarity`` [I, I]: the fit's f32
    tensors on its device, or arrays from elsewhere (the reference's
    numpy ones), scored on the default device."""

    userCol = Param("userCol", "Indexed user column", "user", ptype=str)
    itemCol = Param("itemCol", "Indexed item column", "item", ptype=str)
    ratingCol = Param("ratingCol", "Rating column", "rating", ptype=str)
    userAffinity = ComplexParam("userAffinity", "[U,I] affinity matrix")
    itemSimilarity = ComplexParam("itemSimilarity", "[I,I] similarity matrix")

    def _matrices(self) -> Tuple[torch.Tensor, torch.Tensor]:
        A = self.get_or_throw("userAffinity")
        S = self.get_or_throw("itemSimilarity")
        dev = A.device if isinstance(A, torch.Tensor) and A.is_cuda \
            else default_device()
        return _f32_on(A, dev), _f32_on(S, dev)

    def _scores(self, remove_seen: bool = True) -> torch.Tensor:
        """A @ S in f32 on the card, seen items -inf with ``remove_seen``."""
        A, S = self._matrices()
        with _full_f32():
            scores = torch.matmul(A, S)
        if remove_seen:
            scores.masked_fill_(A > 0, float("-inf"))
        return scores

    def recommend_for_all_users(self, num_items: int = 10,
                                remove_seen: bool = True) -> DataFrame:
        """One row per user: {user, recommendations: [itemIds], ratings: [scores]}
        (SARModel.recommendForAllUsers parity; ties by item ascending)."""
        scores = self._scores(remove_seen)
        n_users, n_items_total = scores.shape
        k = min(num_items, n_items_total)
        tops, vals_ = [], []
        for lo in range(0, n_users, TOPK_CHUNK_USERS):
            items, vals = top_k(scores[lo:lo + TOPK_CHUNK_USERS], k)
            tops.append(items.cpu())
            vals_.append(vals.cpu())
        del scores
        top = torch.cat(tops).numpy() if tops else np.empty((0, k), np.int64)
        top_scores = torch.cat(vals_).numpy() if vals_ \
            else np.empty((0, k), np.float32)
        valid = np.isfinite(top_scores)
        recs = np.empty(n_users, dtype=object)
        vals = np.empty(n_users, dtype=object)
        for u in range(n_users):
            recs[u] = top[u][valid[u]].astype(np.int64)
            vals[u] = top_scores[u][valid[u]].astype(np.float64)
        return DataFrame([{
            self.get("userCol"): np.arange(n_users, dtype=np.int64),
            "recommendations": recs,
            "ratings": vals,
        }])

    def transform(self, df: DataFrame) -> DataFrame:
        """Score (user, item) pairs: predicted affinity-weighted similarity."""
        scores = self._scores(remove_seen=False)
        ucol, icol = self.get("userCol"), self.get("itemCol")

        def fn(p):
            us = np.asarray(p[ucol], dtype=np.int64)
            its = np.asarray(p[icol], dtype=np.int64)
            ok = (us >= 0) & (us < scores.shape[0]) & \
                 (its >= 0) & (its < scores.shape[1])
            out = np.zeros(len(us), dtype=np.float64)
            sel = torch.as_tensor(np.stack([us[ok], its[ok]]),
                                  device=scores.device)
            out[ok] = scores[sel[0], sel[1]].cpu().numpy()
            return out

        return df.with_column("prediction", fn)
