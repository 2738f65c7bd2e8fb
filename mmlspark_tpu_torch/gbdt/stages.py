"""LightGBM-parity pipeline stages: Classifier / Regressor / Ranker (+ Models).

Counterpart of the reference's ``mmlspark_tpu/gbdt/stages.py``: the same
camelCase param surface (LightGBMParams), ``fit`` over the DataFrame into
``booster.train`` and ``transform`` through the ``DeviceEnsemble`` forest
traversal with the f64 host finalize. Both run on CUDA unless the caller
wraps them in ``runtime.use_device("cpu")``. ``fit`` splits off the rows
``validationIndicatorCol`` flags as the early-stopping holdout, and with
``numBatches`` > 1 trains batch after batch, each continuing the last.
``categoricalSlotIndexes`` / ``categoricalSlotNames`` (resolved against the
features column's ``slot_names`` metadata) flag categorical features, split
by category set on dense rows; sparse rows refuse them, as the reference
does.

Sparse-row feature columns (``{"indices", "values", "size"}``) fit through
``sparse.train_sparse`` and score through ``sparse.predict_csr``, never
densified.

Under a mesh set in ``parallel.mesh.MeshContext`` (data axis > 1) a fit is
the data-parallel one (``train(mesh=)``, ``train_sparse(mesh=)``), every
process of the mesh fitting the same frame; ``numWorkers=1`` forces one
shard, and a mesh built lazily does not count (``_resolve_mesh``).

The models join a fused pipeline (``PipelineModel.fuse()``,
``core/fusion.py``) through ``device_fn``: the forest traversal runs on the
device per batch and the f64 objective math stays in the host finalize, so
fused scores are bitwise-equal to ``transform``'s. With the executor's
``layout`` knob at ``"csr"``, sparse rows arrive as CSR triples and
``sparse_fn`` gathers the forest's used columns with K3
(``gather_kernel.csr_gather``) and traverses a forest remapped onto them.

LightGBM text-model interchange: ``save_native_model`` writes the LightGBM
``v3`` text (``lgbm_format.py``), ``load_native_model_from_string`` /
``_from_file`` read it, and ``modelString`` (LightGBM text or the Booster's
JSON) seeds a fit that continues it. A model stage persists through
``PipelineStage.save``/``load`` with its Booster as the JSON string.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import (
    ComplexParam,
    HasFeaturesCol,
    HasGroupCol,
    HasInitScoreCol,
    HasLabelCol,
    HasValidationIndicatorCol,
    HasWeightCol,
    Param,
)
from ..core.pipeline import Estimator, Model
from ..core.schema import ColType, Schema
from ..parallel.batching import is_sparse_row, sparse_width, stack_rows
from ..runtime import default_device
from .booster import Booster, TrainParams, train
from .lgbm_format import (from_lightgbm_string, parse_model_string,
                          to_lightgbm_string)
from .sparse import SparseDataset, predict_csr, rows_to_csr, train_sparse


class _LightGBMParams(HasFeaturesCol, HasLabelCol, HasWeightCol,
                      HasValidationIndicatorCol, HasInitScoreCol):
    """Shared param surface (the reference's LightGBMParams)."""

    numIterations = Param("numIterations", "Number of boosting iterations", 100,
                          lambda v: v > 0, int)
    learningRate = Param("learningRate", "Shrinkage rate", 0.1, lambda v: v > 0, float)
    numLeaves = Param("numLeaves", "Max leaves per tree", 31, lambda v: v > 1, int)
    maxBin = Param("maxBin", "Max feature bins", 255, lambda v: v > 1, int)
    maxDepth = Param("maxDepth", "Max tree depth (-1 = unlimited)", -1, ptype=int)
    numWorkers = Param("numWorkers", "Worker/shard count override (0 = auto)", 0,
                       ptype=int)
    minDataInLeaf = Param("minDataInLeaf", "Min rows per leaf", 20, lambda v: v >= 0, int)
    minSumHessianInLeaf = Param("minSumHessianInLeaf", "Min hessian per leaf", 1e-3,
                                ptype=float)
    minGainToSplit = Param("minGainToSplit", "Min gain to split", 0.0, ptype=float)
    lambdaL1 = Param("lambdaL1", "L1 regularization", 0.0, ptype=float)
    lambdaL2 = Param("lambdaL2", "L2 regularization", 0.0, ptype=float)
    baggingFraction = Param("baggingFraction", "Row subsample fraction", 1.0, ptype=float)
    baggingFreq = Param("baggingFreq", "Bagging frequency (0 = off)", 0, ptype=int)
    baggingSeed = Param("baggingSeed", "Bagging seed", 3, ptype=int)
    featureFraction = Param("featureFraction", "Feature subsample per tree", 1.0,
                            ptype=float)
    boostingType = Param("boostingType", "gbdt|rf|dart|goss", "gbdt",
                         lambda v: v in ("gbdt", "rf", "dart", "goss"), str)
    earlyStoppingRound = Param("earlyStoppingRound",
                               "Stop if no valid improvement for N rounds (0 = off)",
                               0, ptype=int)
    numBatches = Param("numBatches",
                       "Split the data into batches, each continuing the "
                       "model of the last", 0, ptype=int)
    categoricalSlotIndexes = Param("categoricalSlotIndexes",
                                   "Feature indexes treated as categorical", None,
                                   ptype=(list, tuple))
    modelString = Param("modelString", "Init model string for continued training",
                        None, ptype=str)
    verbosity = Param("verbosity", "Logging verbosity", -1, ptype=int)
    seed = Param("seed", "Master random seed", 0, ptype=int)
    objective = Param("objective", "Objective override", None, ptype=str)
    alpha = Param("alpha", "Quantile/huber parameter", 0.9, ptype=float)
    dropRate = Param("dropRate", "DART tree drop rate", 0.1, ptype=float)
    maxDrop = Param("maxDrop", "DART max dropped trees", 50, ptype=int)
    topRate = Param("topRate", "GOSS top-gradient keep rate", 0.2, ptype=float)
    otherRate = Param("otherRate", "GOSS random keep rate", 0.1, ptype=float)
    metric = Param("metric", "Eval metric override (auc, binary_logloss, l1, "
                   "l2, rmse, ndcg, ...; empty = objective default)", "",
                   ptype=str)
    isProvideTrainingMetric = Param(
        "isProvideTrainingMetric", "Log the training metric during fit",
        False, ptype=bool)
    maxDeltaStep = Param("maxDeltaStep",
                         "Clamp on |leaf output| (0 = off)", 0.0, ptype=float)
    posBaggingFraction = Param("posBaggingFraction",
                               "Positive-class bagging fraction (binary)",
                               1.0, ptype=float)
    negBaggingFraction = Param("negBaggingFraction",
                               "Negative-class bagging fraction (binary)",
                               1.0, ptype=float)
    maxBinByFeature = Param("maxBinByFeature",
                            "Per-feature bin caps overriding maxBin", None,
                            ptype=(list, tuple))
    categoricalSlotNames = Param(
        "categoricalSlotNames",
        "Feature slot names treated as categorical, resolved against the "
        "features column's slot_names metadata", None, ptype=(list, tuple))
    catSmooth = Param("catSmooth",
                      "Categorical gradient-statistic smoothing "
                      "(LightGBM cat_smooth)", 10.0, ptype=float)
    catL2 = Param("catL2", "Extra L2 for categorical set splits "
                  "(LightGBM cat_l2)", 10.0, ptype=float)
    maxCatThreshold = Param("maxCatThreshold",
                            "Max categories on the left side of a set "
                            "split (LightGBM max_cat_threshold)", 32,
                            lambda v: v > 0, int)

    def _train_params(self, objective: str, num_class: int = 1) -> TrainParams:
        return TrainParams(
            objective=self.get("objective") or objective,
            boosting_type=self.get("boostingType"),
            num_iterations=self.get("numIterations"),
            learning_rate=self.get("learningRate"),
            num_leaves=self.get("numLeaves"),
            max_bin=self.get("maxBin"),
            max_depth=self.get("maxDepth"),
            min_data_in_leaf=self.get("minDataInLeaf"),
            min_sum_hessian_in_leaf=self.get("minSumHessianInLeaf"),
            min_gain_to_split=self.get("minGainToSplit"),
            lambda_l1=self.get("lambdaL1"),
            lambda_l2=self.get("lambdaL2"),
            bagging_fraction=self.get("baggingFraction"),
            bagging_freq=self.get("baggingFreq"),
            bagging_seed=self.get("baggingSeed"),
            feature_fraction=self.get("featureFraction"),
            early_stopping_round=self.get("earlyStoppingRound"),
            num_class=num_class,
            alpha=self.get("alpha"),
            drop_rate=self.get("dropRate"),
            max_drop=self.get("maxDrop"),
            top_rate=self.get("topRate"),
            other_rate=self.get("otherRate"),
            categorical_feature=tuple(self.get("categoricalSlotIndexes") or ()),
            cat_smooth=self.get("catSmooth"),
            cat_l2=self.get("catL2"),
            max_cat_threshold=self.get("maxCatThreshold"),
            metric=self.get("metric") or "",
            max_delta_step=self.get("maxDeltaStep"),
            pos_bagging_fraction=self.get("posBaggingFraction"),
            neg_bagging_fraction=self.get("negBaggingFraction"),
            max_bin_by_feature=tuple(self.get("maxBinByFeature") or ()),
            train_metric=self.get("isProvideTrainingMetric"),
            seed=self.get("seed"),
        )

    def _resolve_mesh(self):
        """The worker topology of the dense and sparse fits: the data axis
        of the mesh ``MeshContext.set`` installed, when larger than 1; None
        (one shard) without one, and always for ``numWorkers=1``. A lazily
        built mesh does not count: tiny fits stay on one device."""
        from ..parallel.mesh import explicit_mesh

        return explicit_mesh(self.get("numWorkers"))

    def _fit_device(self, mesh):
        """The fit's device: the mesh's own under a mesh, else the one the
        caller asked for (CUDA by default)."""
        return None if mesh is not None else default_device()

    def _make_log(self):
        return logging.getLogger("mmlspark_tpu_torch.gbdt").info \
            if (self.get("verbosity") >= 0
                or self.get("isProvideTrainingMetric")) else None

    def _timed_fit(self, fit_fn) -> Booster:
        """Run one booster fit, recording wall seconds and the fit count in
        the default metrics registry under this estimator's class name."""
        from ..obs.metrics import default_registry

        t0 = time.perf_counter()
        booster = fit_fn()
        reg = default_registry()
        est = type(self).__name__
        reg.gauge("mmlspark_train_fit_seconds",
                  "wall seconds of the last booster fit",
                  ("estimator",)).labels(estimator=est).set(
            time.perf_counter() - t0)
        reg.counter("mmlspark_train_fits_total", "booster fits completed",
                    ("estimator",)).labels(estimator=est).inc()
        return booster

    def _fit_booster(self, df: DataFrame, objective: str, num_class: int = 1,
                     groups: Optional[np.ndarray] = None) -> Booster:
        data = df.collect()
        fcol = data[self.get_or_throw("featuresCol")]
        first = next((v for v in fcol if v is not None), None)
        if is_sparse_row(first):
            return self._fit_booster_sparse(data, objective, num_class, groups)
        X = stack_rows(fcol, np.float64)
        y, w, init_scores = self._label_weight_init(data)
        X, y, w, init_scores, groups, valid, valid_groups = \
            self._split_valid(data, X, y, w, init_scores, groups)
        params = self._with_slot_names(self._train_params(objective, num_class),
                                       df)
        log = self._make_log()
        mesh = self._resolve_mesh()
        dev = self._fit_device(mesh)

        def fit(sl, init):
            return train(params, X[sl], y[sl], weights=_cut(w, sl),
                         groups=_cut(groups, sl), valid=valid,
                         valid_groups=valid_groups,
                         init_scores=_cut(init_scores, sl), init_model=init,
                         log=log, mesh=mesh, device=dev)

        return self._fit_batches(len(y), fit)

    def _with_slot_names(self, params: TrainParams, df: DataFrame
                         ) -> TrainParams:
        """``categoricalSlotNames`` resolved to feature indexes through the
        features column's ``slot_names`` metadata, joined with
        ``categoricalSlotIndexes``."""
        names = self.get("categoricalSlotNames")
        if not names:
            return params
        slot_names = df.schema.metadata.get(
            self.get_or_throw("featuresCol"), {}).get("slot_names")
        if not slot_names:
            raise ValueError(
                "categoricalSlotNames requires slot_names metadata on the "
                "features column; use categoricalSlotIndexes otherwise")
        lut = {nm: i for i, nm in enumerate(slot_names)}
        missing = [nm for nm in names if nm not in lut]
        if missing:
            raise KeyError(f"categoricalSlotNames not found in slot_names "
                           f"metadata: {missing}")
        return dataclasses.replace(params, categorical_feature=tuple(sorted(
            set(params.categorical_feature) | {lut[nm] for nm in names})))

    def _init_model(self) -> Optional[Booster]:
        """The Booster ``modelString`` holds (LightGBM text or the Booster's
        JSON), which the fit continues; None without one."""
        if self.get("modelString"):
            return parse_model_string(self.get("modelString"))
        return None

    def _fit_batches(self, n: int, fit) -> Booster:
        """One fit over all ``n`` rows, or with ``numBatches`` > 1 one fit a
        batch of rows, each continuing the model of the last (the
        reference's incremental training); the first continues the
        ``modelString`` model, if any."""
        n_batches = self.get("numBatches")
        init = self._init_model()
        if not n_batches or n_batches <= 1:
            return fit(slice(0, n), init)
        booster = init
        bounds = np.linspace(0, n, n_batches + 1).astype(int)
        for b in range(n_batches):
            booster = fit(slice(bounds[b], bounds[b + 1]), booster)
        return booster

    def _split_valid(self, data, X, y, w, init_scores, groups):
        """Split off the rows ``validationIndicatorCol`` flags: returns the
        training rows' (X, y, w, init_scores, groups), the holdout (X, y) or
        None, and the holdout's groups. ``X`` may be a list of sparse rows."""
        if not self.get("validationIndicatorCol"):
            return X, y, w, init_scores, groups, None, None
        vm = np.asarray(data[self.get("validationIndicatorCol")], dtype=bool)
        keep = ~vm
        if isinstance(X, list):
            val_X = [v for v, m in zip(X, vm) if m]
            X = [v for v, m in zip(X, vm) if not m]
        else:
            val_X, X = X[vm], X[keep]
        valid = (val_X, y[vm])
        valid_groups = groups[vm] if groups is not None else None
        return (X, y[keep], _cut(w, keep), _cut(init_scores, keep),
                _cut(groups, keep), valid, valid_groups)

    def _label_weight_init(self, data):
        y = np.asarray(data[self.get_or_throw("labelCol")], dtype=np.float64)
        w = None
        if self.get("weightCol"):
            w = np.asarray(data[self.get("weightCol")], dtype=np.float64)
        init_scores = None
        if self.get("initScoreCol"):
            init_scores = np.asarray(data[self.get("initScoreCol")],
                                     dtype=np.float64)
        return y, w, init_scores

    def _fit_booster_sparse(self, data, objective: str, num_class: int,
                            groups: Optional[np.ndarray] = None) -> Booster:
        """CSR training for sparse-row features (TextFeaturizer / VW
        featurizer output): never densifies, so 2^18-wide hashed spaces
        train in O(nnz) memory (the reference's ``_fit_booster_sparse``;
        bins capped at 255 per feature as there), with validation rows and
        ``numBatches`` as on the dense path."""
        y, w, init_scores = self._label_weight_init(data)
        for unsupported in ("categoricalSlotNames", "categoricalSlotIndexes"):
            if self.get(unsupported):
                raise ValueError(
                    f"{unsupported} is not supported with sparse features — "
                    f"hashTF/count spaces are numeric; densify explicitly "
                    f"(FastVectorAssembler) for categorical slots")
        params = self._train_params(objective, num_class)
        col = list(data[self.get_or_throw("featuresCol")])
        width = sparse_width(col)
        col, y, w, init_scores, groups, valid, valid_groups = \
            self._split_valid(data, col, y, w, init_scores, groups)
        if valid is not None:
            indptr, indices, values, _ = rows_to_csr(valid[0], width)
            valid = ((indptr, indices, values), valid[1])
        max_bin = min(params.max_bin, 255)
        log = self._make_log()
        mesh = self._resolve_mesh()
        dev = self._fit_device(mesh)

        def fit(sl, init):
            ds = SparseDataset.from_rows(col[sl], num_features=width,
                                         max_bin=max_bin)
            return train_sparse(params, ds, y[sl], weights=_cut(w, sl),
                                groups=_cut(groups, sl), valid=valid,
                                valid_groups=valid_groups,
                                init_scores=_cut(init_scores, sl),
                                init_model=init, log=log, mesh=mesh,
                                device=dev)

        return self._fit_batches(len(y), fit)


def _cut(a: Optional[np.ndarray], sel) -> Optional[np.ndarray]:
    return a[sel] if a is not None else None


class _LightGBMModelBase(Model, HasFeaturesCol):
    """Shared scoring: features column -> raw scores via the device forest."""

    model = ComplexParam("model", "Trained booster (model string)")

    def __init__(self, **kwargs):
        booster = kwargs.pop("booster", None)
        super().__init__(**kwargs)
        self._booster: Optional[Booster] = booster
        # device string -> DeviceEnsemble: serving replicas on several
        # cards each score with their own card's forest tensors
        self._device_ensembles: Dict[str, Any] = {}
        if booster is not None:
            self.set("model", booster.to_string())

    @property
    def booster(self) -> Booster:
        if self._booster is None:
            self._booster = Booster.from_string(self.get_or_throw("model"))
        return self._booster

    def _ensemble(self):
        from .predict import DeviceEnsemble

        dev = default_device()
        ens = self._device_ensembles.get(str(dev))
        if ens is None:
            b = self.booster
            n_iter = b.best_iteration if b.best_iteration > 0 else len(b.trees)
            built = DeviceEnsemble(b.trees[:n_iter],
                                   max(b.params.num_class, 1), device=dev)
            # two threads building at once keep the first one stored
            ens = self._device_ensembles.setdefault(str(dev), built)
        return ens

    def _raw_scores(self, part) -> np.ndarray:
        col = part[self.get_or_throw("featuresCol")]
        first = next((v for v in col if v is not None), None)
        if is_sparse_row(first):
            # CSR predict, never densified (PredictForCSRSingle parity)
            b = self.booster
            n_iter = b.best_iteration if b.best_iteration > 0 \
                else len(b.trees)
            indptr, indices, values, _ = rows_to_csr(col, filter_zeros=False)
            raw = predict_csr(b.trees[:n_iter], indptr, indices, values,
                              max(b.params.num_class, 1),
                              device=default_device())
            return raw + b.base_score[None, :]
        X = stack_rows(col, np.float32)
        raw = self._ensemble().predict_raw(X)
        return raw + self.booster.base_score[None, :]

    # -- native model API (the reference's saveNativeModel & co) ----------
    def save_native_model(self, path: str, overwrite: bool = True) -> None:
        """Write the model as LightGBM ``v3`` text (any LightGBM runtime
        loads it)."""
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(to_lightgbm_string(self.booster))

    @classmethod
    def load_native_model_from_string(cls, text: str, **kwargs):
        """A scoring model from a LightGBM text model string."""
        return cls(booster=from_lightgbm_string(text), **kwargs)

    @classmethod
    def load_native_model_from_file(cls, path: str, **kwargs):
        """A scoring model from a LightGBM text model file."""
        with open(path) as f:
            return cls.load_native_model_from_string(f.read(), **kwargs)

    def get_feature_importances(self, importance_type: str = "split"
                                ) -> List[float]:
        return list(self.booster.feature_importances(importance_type))

    def get_model_string(self) -> str:
        return self.get_or_throw("model")

    # -- pipeline fusion ---------------------------------------------------
    def _device_scores(self):
        """(featuresCol, raw env key, fn, sparse_fn, ensemble) for fusion,
        or None for an empty forest. ``fn`` runs the SAME forest traversal
        ``predict_raw`` does, on a staged [B, F] batch.

        The traversal (``forest.gemm`` vs ``forest.gather`` kernel
        variants — both exact, see ``DeviceEnsemble.device_forward``)
        resolves from the variant registry when the program runs: the
        executor activates the chosen variant around every call, and each
        variant's program lands under its own ``variant=<id>;`` cache key."""
        from ..core import kernels as _kernels
        from ..core.device_stage import FusionUnsupported
        from . import gather_kernel

        ens = self._ensemble()
        fwd = ens.device_forward()
        if fwd is None:
            return None
        feats = self.get_or_throw("featuresCol")
        raw_key = f"__gbdt_raw__{self.uid}"

        def fn(params, env):
            var = _kernels.active("forest")
            f = ens.device_forward(var.params) if var is not None else fwd
            X = env[feats]
            if X.dim() != 2:
                raise FusionUnsupported(
                    f"features must be [N, F], got {tuple(X.shape)}")
            return {raw_key: f(X.to(torch.float32))}

        # CSR capability: when the executor's layout knob stages the
        # features column as a CSR triple, this body replaces the [N, width]
        # densify with K3's [N, U] gather of the forest's used columns and
        # traverses a position-remapped ensemble — bitwise-equal raw scores
        # to fn over the densified matrix (the gather clamps out-of-range
        # ids like the dense read, and leaf markers / GEMM pad slots stay
        # inert under the remap).
        cell: dict = {}

        def sparse_fn(params, env):
            if ens.cat_vals is not None:
                # set membership reads raw category values; the unfused
                # sparse path (predict_csr) refuses categorical models, and
                # so does this one
                raise FusionUnsupported("categorical splits need dense rows")
            if "remap" not in cell:
                used = gather_kernel.used_features(ens)
                cell["remap"] = (
                    torch.as_tensor(used.astype(np.int32), device=ens.device),
                    gather_kernel.remap_ensemble(ens, used))
            used_t, rens = cell["remap"]
            var = _kernels.active("forest")
            f = rens.device_forward(var.params if var is not None else None)
            x_used = gather_kernel.csr_gather(
                env[f"{feats}:indptr"], env[f"{feats}:indices"],
                env[f"{feats}:values"], env[f"{feats}:width"], used_t)
            return {raw_key: f(x_used)}

        return feats, raw_key, fn, sparse_fn, ens

    def _score_device_fn(self, finalize, extra_out_cols, **stitch_caps):
        """The terminal DeviceFn shared by the model subclasses: forest
        scores on the device, f64 base-score/objective math in the host
        finalize (bitwise-identical to the unfused transform).
        ``stitch_caps`` passes the optional device-finalizer fields
        (device_finalize & co — see DeviceFn) through."""
        from ..core.device_stage import DeviceFn

        base = self._device_scores()
        if base is None:
            return None
        feats, raw_key, fn, sparse_fn, ens = base
        return DeviceFn(
            # the ensemble's identity keys the cached program: the program
            # closes over it (and its device), and keeps it alive
            key=(type(self).__name__, self.uid, feats, id(ens)),
            in_cols=(feats,), out_cols=tuple(extra_out_cols), fn=fn,
            device_outputs=(raw_key,), finalize=finalize,
            **stitch_caps,
            # nulls and sparse rows take the unfused path (CSR predict),
            # identically to the per-stage chain — UNLESS the executor's
            # layout knob stages the features column as a CSR triple, which
            # this capability pair opts into
            null_policy="fallback", reject_sparse=True,
            sparse_cols=(feats,), sparse_fn=sparse_fn,
            terminal=True, heavy=True,
            # the [N, F] features may shard their feature dim over the
            # tensor axis (parallel/shardplan.py gathers full rows for the
            # forest, as the reference's compiler does)
            shard_dims={feats: 1})


class LightGBMClassifier(Estimator, _LightGBMParams):
    """Binary/multiclass GBDT classifier."""

    rawPredictionCol = Param("rawPredictionCol", "Raw scores column", "rawPrediction",
                             ptype=str)
    probabilityCol = Param("probabilityCol", "Probability vector column", "probability",
                           ptype=str)
    predictionCol = Param("predictionCol", "Predicted label column", "prediction",
                          ptype=str)

    def fit(self, df: DataFrame) -> "LightGBMClassificationModel":
        y = df.column(self.get_or_throw("labelCol"))
        classes = np.unique(np.asarray(y, dtype=np.float64))
        num_class = len(classes)
        if not np.array_equal(classes, np.arange(num_class)):
            raise ValueError(
                f"Labels must be 0..K-1 (got {classes[:10]}); use ValueIndexer first")
        objective = "binary" if num_class <= 2 else "multiclass"
        booster = self._timed_fit(lambda: self._fit_booster(
            df, objective, 1 if num_class <= 2 else num_class))
        return LightGBMClassificationModel(
            booster=booster,
            featuresCol=self.get("featuresCol"),
            rawPredictionCol=self.get("rawPredictionCol"),
            probabilityCol=self.get("probabilityCol"),
            predictionCol=self.get("predictionCol"),
        )


class LightGBMClassificationModel(_LightGBMModelBase):
    rawPredictionCol = Param("rawPredictionCol", "Raw scores column", "rawPrediction",
                             ptype=str)
    probabilityCol = Param("probabilityCol", "Probability vector column", "probability",
                           ptype=str)
    predictionCol = Param("predictionCol", "Predicted label column", "prediction",
                          ptype=str)

    def _score_columns(self, raw: np.ndarray) -> dict:
        """[N, K] f64 raw scores (base score included) -> output columns,
        with the objective math in f64 on the host."""
        if self.booster.params.objective == "binary":
            p1 = 1 / (1 + np.exp(-raw[:, 0]))
            proba = np.stack([1 - p1, p1], axis=1)
            rawcol = np.stack([-raw[:, 0], raw[:, 0]], axis=1)
        else:
            e = np.exp(raw - raw.max(axis=1, keepdims=True))
            proba = e / e.sum(axis=1, keepdims=True)
            rawcol = raw
        pred = np.argmax(proba, axis=1).astype(np.float64)
        n = len(pred)
        raw_obj = np.empty(n, dtype=object)
        proba_obj = np.empty(n, dtype=object)
        for i in range(n):
            raw_obj[i] = rawcol[i]
            proba_obj[i] = proba[i]
        return {self.get("rawPredictionCol"): raw_obj,
                self.get("probabilityCol"): proba_obj,
                self.get("predictionCol"): pred}

    def transform(self, df: DataFrame) -> DataFrame:
        def score(part):
            part.update(self._score_columns(self._raw_scores(part)))
            return part

        return df.map_partitions(score)

    def device_fn(self, schema: Schema):
        raw_key = f"__gbdt_raw__{self.uid}"
        proba_key = f"__gbdt_proba__{self.uid}"
        pred_key = f"__gbdt_pred__{self.uid}"
        binary = self.booster.params.objective == "binary"
        base = self.booster.base_score
        base32: dict = {}   # device -> [K] f32 base score

        def finalize(outs, ctx):
            raw = np.asarray(outs[raw_key], dtype=np.float64) \
                + base[None, :]
            return self._score_columns(raw)

        def device_finalize(params, env):
            # the host f64 objective math as an f32 device shim, run in the
            # fused program when the stitch knob names this stage; its
            # deviation from the f64 path is declared (finalize_tolerance)
            raw = env[raw_key]
            if raw.device not in base32:
                base32[raw.device] = torch.as_tensor(
                    base, dtype=torch.float32, device=raw.device)
            raw32 = raw + base32[raw.device][None, :]
            if binary:
                p1 = 1.0 / (1.0 + torch.exp(-raw32[:, 0]))
                proba = torch.stack([1.0 - p1, p1], dim=1)
            else:
                e = torch.exp(raw32 - raw32.max(dim=1, keepdim=True).values)
                proba = e / e.sum(dim=1, keepdim=True)
            pred = torch.argmax(proba, dim=1).to(torch.float32)
            return {proba_key: proba, pred_key: pred}

        def finalize_stitched(outs, ctx):
            # rawPrediction stays BITWISE: rebuilt from the same f64 raw
            # readback the host finalize uses; only proba/pred come from
            # the device f32 shim
            raw = np.asarray(outs[raw_key], dtype=np.float64) \
                + base[None, :]
            rawcol = (np.stack([-raw[:, 0], raw[:, 0]], axis=1)
                      if binary else raw)
            proba = np.asarray(outs[proba_key], dtype=np.float64)
            pred = np.asarray(outs[pred_key], dtype=np.float64)
            n = len(pred)
            raw_obj = np.empty(n, dtype=object)
            proba_obj = np.empty(n, dtype=object)
            for i in range(n):
                raw_obj[i] = rawcol[i]
                proba_obj[i] = proba[i]
            return {self.get("rawPredictionCol"): raw_obj,
                    self.get("probabilityCol"): proba_obj,
                    self.get("predictionCol"): pred}

        return self._score_device_fn(
            finalize, (self.get("rawPredictionCol"),
                       self.get("probabilityCol"), self.get("predictionCol")),
            stitchable=True,
            device_finalize=device_finalize,
            device_finalize_outputs=(proba_key, pred_key),
            finalize_stitched=finalize_stitched,
            finalize_tolerance=1e-5)

    def transform_schema(self, schema: Schema) -> Schema:
        out = schema.copy()
        out.types[self.get("rawPredictionCol")] = ColType.VECTOR
        out.types[self.get("probabilityCol")] = ColType.VECTOR
        out.types[self.get("predictionCol")] = ColType.FLOAT64
        return out


class LightGBMRegressor(Estimator, _LightGBMParams):
    """GBDT regressor: l2/l1/huber/quantile/poisson objectives."""

    predictionCol = Param("predictionCol", "Prediction column", "prediction", ptype=str)
    applicationName = Param("applicationName", "regression|quantile|huber|poisson",
                            "regression", ptype=str)

    def fit(self, df: DataFrame) -> "LightGBMRegressionModel":
        objective = self.get("objective") or {
            "regression": "regression", "quantile": "quantile",
            "huber": "huber", "poisson": "poisson",
        }.get(self.get("applicationName"), "regression")
        booster = self._timed_fit(lambda: self._fit_booster(df, objective))
        return LightGBMRegressionModel(
            booster=booster,
            featuresCol=self.get("featuresCol"),
            predictionCol=self.get("predictionCol"),
        )


class LightGBMRegressionModel(_LightGBMModelBase):
    predictionCol = Param("predictionCol", "Prediction column", "prediction", ptype=str)

    def _prediction_column(self, raw: np.ndarray) -> np.ndarray:
        raw = raw[:, 0]
        if self.booster.params.objective == "poisson":
            raw = np.exp(raw)
        return raw

    def transform(self, df: DataFrame) -> DataFrame:
        def score(part):
            part[self.get("predictionCol")] = \
                self._prediction_column(self._raw_scores(part))
            return part

        return df.map_partitions(score)

    def device_fn(self, schema: Schema):
        def finalize(outs, ctx):
            raw_key = next(iter(outs))
            raw = np.asarray(outs[raw_key], dtype=np.float64) \
                + self.booster.base_score[None, :]
            return {self.get("predictionCol"): self._prediction_column(raw)}

        return self._score_device_fn(finalize, (self.get("predictionCol"),))

    def transform_schema(self, schema: Schema) -> Schema:
        out = schema.copy()
        out.types[self.get("predictionCol")] = ColType.FLOAT64
        return out


class LightGBMRanker(Estimator, _LightGBMParams, HasGroupCol):
    """LambdaRank GBDT over query groups (the reference's LightGBMRanker):
    ``groupCol`` holds each row's query id, and the rows of a query must be
    contiguous."""

    predictionCol = Param("predictionCol", "Prediction column", "prediction", ptype=str)

    def fit(self, df: DataFrame) -> "LightGBMRankerModel":
        raw_groups = df.column(self.get_or_throw("groupCol"))
        _, groups = np.unique(np.asarray([str(g) for g in raw_groups]),
                              return_inverse=True)
        booster = self._timed_fit(lambda: self._fit_booster(
            df, "lambdarank", groups=groups.astype(np.int64)))
        return LightGBMRankerModel(
            booster=booster,
            featuresCol=self.get("featuresCol"),
            predictionCol=self.get("predictionCol"),
        )


class LightGBMRankerModel(_LightGBMModelBase):
    predictionCol = Param("predictionCol", "Prediction column", "prediction", ptype=str)

    def transform(self, df: DataFrame) -> DataFrame:
        def score(part):
            part[self.get("predictionCol")] = self._raw_scores(part)[:, 0]
            return part

        return df.map_partitions(score)

    def device_fn(self, schema: Schema):
        def finalize(outs, ctx):
            raw_key = next(iter(outs))
            raw = np.asarray(outs[raw_key], dtype=np.float64) \
                + self.booster.base_score[None, :]
            return {self.get("predictionCol"): raw[:, 0]}

        return self._score_device_fn(finalize, (self.get("predictionCol"),))

    def transform_schema(self, schema: Schema) -> Schema:
        out = schema.copy()
        out.types[self.get("predictionCol")] = ColType.FLOAT64
        return out
