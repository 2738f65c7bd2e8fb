"""LIME: local interpretable model-agnostic explanations.

Reference: lime/LIME.scala — TabularLIME fits per-column statistics on a
background dataset (:164-190), TabularLIMEModel samples gaussian perturbations
per explained row, probes the inner model, and fits a per-row lasso (:191-220,
fitLasso at :158); ImageLIME does the same over superpixel on/off states
(:43-158).

The port of ``mmlspark_tpu/lime/lime.py``. The draws are the reference's:
numpy ``default_rng(seed)``, a row's draws in row order. A partition's rows
are gathered first: their probes go through the inner model's
``transform`` in one frame (each probe scored on its own row), and their
lassos are fitted in one batched call on the card
(``ops.lasso.fit_lasso_batch``; an image's superpixel states padded with
zero columns to the partition's widest, which stay at weight 0).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasInputCol, HasOutputCol, Param
from ..core.pipeline import Estimator, Model, Transformer
from ..core.schema import ColType, ImageSchema, Schema
from ..ops import lasso
from .superpixel import Superpixel, slic


class TabularLIME(Estimator, HasInputCol, HasOutputCol):
    """Fit background statistics for tabular LIME (LIME.scala:164-190)."""

    model = ComplexParam("model", "The model stage to explain")
    predictionCol = Param("predictionCol", "Column with the model's output",
                          "prediction", ptype=str)
    nSamples = Param("nSamples", "Perturbation samples per row", 1000,
                     lambda v: v > 10, int)
    regularization = Param("regularization", "Lasso L1 strength", 0.0, ptype=float)
    samplingFraction = Param("samplingFraction", "Feature keep probability", 0.3,
                             ptype=float)
    seed = Param("seed", "Sampling seed", 0, ptype=int)

    def fit(self, df: DataFrame) -> "TabularLIMEModel":
        col = df.column(self.get_or_throw("inputCol"))
        X = np.stack([np.asarray(v, dtype=np.float64).reshape(-1) for v in col
                      if v is not None])
        return TabularLIMEModel(
            model=self.get_or_throw("model"),
            inputCol=self.get("inputCol"), outputCol=self.get("outputCol"),
            predictionCol=self.get("predictionCol"),
            nSamples=self.get("nSamples"),
            regularization=self.get("regularization"),
            seed=self.get("seed"),
            columnMeans=X.mean(axis=0), columnSTDs=X.std(axis=0) + 1e-12)


class TabularLIMEModel(Model, HasInputCol, HasOutputCol):
    model = ComplexParam("model", "The model stage to explain")
    columnMeans = ComplexParam("columnMeans", "Background feature means")
    columnSTDs = ComplexParam("columnSTDs", "Background feature stds")
    predictionCol = Param("predictionCol", "Model output column", "prediction",
                          ptype=str)
    nSamples = Param("nSamples", "Perturbation samples per row", 1000, ptype=int)
    regularization = Param("regularization", "Lasso L1 strength", 0.0, ptype=float)
    seed = Param("seed", "Sampling seed", 0, ptype=int)

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        inner = self.get_or_throw("model")
        means = np.asarray(self.get_or_throw("columnMeans"), dtype=np.float64)
        stds = np.asarray(self.get_or_throw("columnSTDs"), dtype=np.float64)
        n_samples = self.get("nSamples")
        reg = self.get("regularization")
        rng = np.random.default_rng(self.get("seed"))
        d = len(means)

        def explain_rows(part):
            col = part[in_col]
            n = len(col)
            out = np.empty(n, dtype=object)
            live = [i for i in range(n) if col[i] is not None]
            if live:
                # gaussian perturbations in standardized space (LIME
                # tabular), a row's draws in row order
                Zs = [rng.normal(size=(n_samples, d)) for _ in live]
                probe_col = np.empty(len(live) * n_samples, dtype=object)
                for j, (i, Z) in enumerate(zip(live, Zs)):
                    x0 = np.asarray(col[i], dtype=np.float64).reshape(-1)
                    Xp = x0[None, :] + Z * stds[None, :]
                    for s in range(n_samples):
                        probe_col[j * n_samples + s] = Xp[s]
                ys = _score_probes(inner, in_col, probe_col,
                                   self.get("predictionCol"))
                ws, _b = lasso.fit_lasso_batch(
                    np.stack(Zs).astype(np.float32),
                    ys.reshape(len(live), n_samples).astype(np.float32),
                    np.float32(reg))
                ws = ws.cpu().numpy().astype(np.float64)
                for j, i in enumerate(live):
                    # de-standardize: effect per original unit
                    out[i] = ws[j] / stds
            part[out_col] = out
            return part

        return df.map_partitions(explain_rows)


def _inner_input(inner, default: str) -> str:
    for pname in ("featuresCol", "inputCol"):
        if inner.has_param(pname) and inner.get(pname):
            return inner.get(pname)
    return default


def _score_probes(inner, in_col: str, probe_col: np.ndarray,
                  pred_col: str) -> np.ndarray:
    """The inner model's prediction for every probe row, as a vector."""
    probe_df = DataFrame([{in_col: probe_col}])
    scored = inner.transform(
        probe_df.with_column_renamed(in_col, _inner_input(inner, in_col)))
    return _prediction_vector(scored, pred_col)


def _prediction_vector(scored: DataFrame, pred_col: str) -> np.ndarray:
    data = scored.collect()
    if pred_col not in data:
        raise KeyError(f"Prediction column {pred_col!r} missing; have "
                       f"{list(data)}")
    col = data[pred_col]
    if col.dtype == object:
        return np.array([float(np.asarray(v).reshape(-1)[-1]) for v in col])
    return col.astype(np.float64)


class ImageLIME(Transformer, HasInputCol, HasOutputCol):
    """Superpixel LIME for image models (LIME.scala:43-158)."""

    model = ComplexParam("model", "The image model stage to explain")
    predictionCol = Param("predictionCol", "Model output column", "prediction",
                          ptype=str)
    nSamples = Param("nSamples", "Mask samples per image", 100,
                     lambda v: v > 1, int)
    samplingFraction = Param("samplingFraction", "P(superpixel on)", 0.7,
                             ptype=float)
    regularization = Param("regularization", "Lasso L1 strength", 0.0, ptype=float)
    cellSize = Param("cellSize", "Superpixel spacing", 16.0, ptype=float)
    modifier = Param("modifier", "Superpixel color/space weight", 130.0, ptype=float)
    superpixelCol = Param("superpixelCol", "Output superpixel column", "superpixels",
                          ptype=str)
    seed = Param("seed", "Sampling seed", 0, ptype=int)

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        inner = self.get_or_throw("model")
        n_samples = self.get("nSamples")
        frac = self.get("samplingFraction")
        reg = self.get("regularization")
        rng = np.random.default_rng(self.get("seed"))

        def explain(part):
            col = part[in_col]
            n = len(col)
            importances = np.empty(n, dtype=object)
            spx_col = np.empty(n, dtype=object)
            live = [i for i in range(n) if col[i] is not None]
            imgs, sps, states = [], [], []
            for i in live:
                row = col[i]
                img = ImageSchema.to_array(row) if ImageSchema.is_image(row) \
                    else np.asarray(row)
                sp = Superpixel(slic(img, self.get("cellSize"),
                                     self.get("modifier")))
                st = rng.random((n_samples, sp.num_clusters)) < frac
                st[0] = True  # include the unmasked image
                imgs.append(img)
                sps.append(sp)
                states.append(st)
            if live:
                probe_col = np.empty(len(live) * n_samples, dtype=object)
                for j, (img, sp, st) in enumerate(zip(imgs, sps, states)):
                    for s in range(n_samples):
                        probe_col[j * n_samples + s] = ImageSchema.make(
                            sp.mask_image(img, st[s]).astype(img.dtype))
                ys = _score_probes(inner, in_col, probe_col,
                                   self.get("predictionCol"))
                width = max(sp.num_clusters for sp in sps)
                X = np.zeros((len(live), n_samples, width), dtype=np.float32)
                for j, st in enumerate(states):
                    X[j, :, :st.shape[1]] = st
                ws, _b = lasso.fit_lasso_batch(
                    X, ys.reshape(len(live), n_samples).astype(np.float32),
                    np.float32(reg))
                ws = ws.cpu().numpy().astype(np.float64)
                for j, (i, sp) in enumerate(zip(live, sps)):
                    importances[i] = ws[j, :sp.num_clusters]
                    spx_col[i] = {"labels": sp.labels,
                                  "numClusters": sp.num_clusters}
            part[out_col] = importances
            part[self.get("superpixelCol")] = spx_col
            return part

        return df.map_partitions(explain)
