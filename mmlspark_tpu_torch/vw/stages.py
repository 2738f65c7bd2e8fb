"""VW pipeline stages: Classifier / Regressor (+Models) with CLI-args parity
(the port of ``mmlspark_tpu/vw/stages.py``).

Reference: vw/VowpalWabbitBase.scala (args building :133-152, train :218-305),
vw/VowpalWabbitClassifier.scala, vw/VowpalWabbitBaseModel.scala:1-98. VW exposes
most knobs through its CLI string; the reference passes them via ``passThroughArgs``
plus typed params — both supported here and parsed into LearnerConfig. A fit
takes ``learner.train_linear``'s routes (the native pass, or ``vw_scan`` on
the card); a transform scores on the card (``predict_linear``). Under a mesh
set in ``parallel.mesh.MeshContext`` (data axis > 1) the fit is the
reference's mesh fit (``train_linear(mesh=)``); ``numWorkers=1`` forces one
shard.
"""

from __future__ import annotations

import shlex
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import (
    ComplexParam,
    HasFeaturesCol,
    HasLabelCol,
    HasWeightCol,
    Param,
)
from ..core.pipeline import Estimator, Model
from .learner import (
    LearnerConfig,
    SparseDataset,
    TrainingStats,
    predict_linear,
    train_linear,
)


def parse_vw_args(args: str, base: Optional[LearnerConfig] = None) -> LearnerConfig:
    """Parse the supported subset of VW CLI args into a LearnerConfig
    (VW defers defaults to native CLI parsing, VowpalWabbitBase.scala:92-94)."""
    cfg = base or LearnerConfig()
    toks = shlex.split(args or "")
    i = 0
    while i < len(toks):
        t = toks[i]

        def val():
            nonlocal i
            i += 1
            if i >= len(toks):
                raise ValueError(f"VW arg {t!r} expects a value but none was given")
            return toks[i]

        if t in ("-b", "--bit_precision"):
            cfg.num_bits = int(val())
        elif t in ("-l", "--learning_rate"):
            cfg.learning_rate = float(val())
        elif t == "--power_t":
            cfg.power_t = float(val())
        elif t == "--initial_t":
            cfg.initial_t = float(val())
        elif t == "--l1":
            cfg.l1 = float(val())
        elif t == "--l2":
            cfg.l2 = float(val())
        elif t == "--loss_function":
            cfg.loss_function = val()
        elif t == "--quantile_tau":
            cfg.quantile_tau = float(val())
        elif t == "--passes":
            cfg.num_passes = int(val())
        elif t == "--ftrl":
            cfg.ftrl = True
        elif t == "--ftrl_alpha":
            cfg.ftrl_alpha = float(val())
        elif t == "--ftrl_beta":
            cfg.ftrl_beta = float(val())
        elif t == "--adaptive":
            cfg.adaptive = True
        elif t == "--sgd":
            cfg.adaptive = False
        elif t == "--random_seed":
            cfg.seed = int(val())
        elif t in ("--quiet", "--no_stdin", "-q", "--interactions", "--holdout_off"):
            if t in ("-q", "--interactions"):
                val()  # interaction pairs handled by VowpalWabbitInteractions stage
        else:
            pass  # unknown args ignored (VW tolerates extra args in passthrough)
        i += 1
    return cfg


def parse_readable_model(text: str) -> Tuple[int, np.ndarray]:
    """Parse a ``--readable_model`` text dump back into (num_bits, weights).

    Closes the interchange loop of ``get_readable_model``: continued
    training from a text dump (the reference's initialModel semantics,
    vw/VowpalWabbitBase.scala:120-122, for the documented text surface —
    docs/vw.md). Accepts both this repo's dump (``bits:N`` header) and a
    real vw dump (``Num weight bits:N`` header, informational header lines
    before the ``index:weight`` section are skipped)."""
    num_bits = 18
    saw_bits = False
    entries = []
    for line in text.splitlines():
        line = line.strip()
        if not line or ":" not in line:
            continue
        key, _, val = line.rpartition(":")
        key = key.strip()
        if key in ("bits", "Num weight bits"):
            num_bits = int(val)
            saw_bits = True
            continue
        try:
            idx, w = int(key), float(val)
        except ValueError:
            continue  # vw header lines (Version, Min label, ...)
        entries.append((idx, w))
    if entries and not saw_bits:
        import warnings

        warnings.warn(
            "readable model has weight entries but no bits header "
            "('bits:N' / 'Num weight bits:N') — assuming the VW default of "
            "18; a dump from a different-bit model would load corrupted",
            stacklevel=2)
    size = 1 << num_bits
    oob = [i for i, _ in entries if i >= size or i < 0]
    if oob:
        # silently wrapping with `i & mask` would alias distinct weights
        # onto the same bucket — a corrupted model with no error signal
        why = "is missing" if not saw_bits else "disagrees with its entries"
        raise ValueError(
            f"readable model has {len(oob)} weight indices outside the "
            f"{num_bits}-bit feature space (max index {max(oob)} >= "
            f"{size}); the dump's bits header {why} — re-dump with the "
            f"matching numBits")
    weights = np.zeros(size, dtype=np.float64)
    for i, w in entries:
        weights[i] = w
    return num_bits, weights


class _VowpalWabbitBase(HasFeaturesCol, HasLabelCol, HasWeightCol):
    """Shared params (vw/VowpalWabbitBase.scala)."""

    passThroughArgs = Param("passThroughArgs", "VW-style CLI args", "", ptype=str)
    numBits = Param("numBits", "Feature space bits", 18, lambda v: 1 <= v <= 31, int)
    learningRate = Param("learningRate", "Learning rate", None, ptype=float)
    powerT = Param("powerT", "LR decay exponent", None, ptype=float)
    l1 = Param("l1", "L1 regularization", None, ptype=float)
    l2 = Param("l2", "L2 regularization", None, ptype=float)
    numPasses = Param("numPasses", "Passes over the data", 1, lambda v: v > 0, int)
    useBarrierExecutionMode = Param("useBarrierExecutionMode",
                                    "Parity no-op (SPMD is gang-scheduled)", False,
                                    ptype=bool)
    numWorkers = Param("numWorkers", "Worker/shard override (0=auto, 1=single)", 0,
                       ptype=int)
    initialModel = ComplexParam("initialModel", "Warm-start weights")
    additionalFeatures = Param(
        "additionalFeatures",
        "Extra sparse-feature columns merged with featuresCol per row "
        "(vw/VowpalWabbitBase.scala additionalFeatures — e.g. the output of "
        "VowpalWabbitInteractions)", None, ptype=(list, tuple))

    def _config(self, loss: str) -> LearnerConfig:
        cfg = LearnerConfig(loss_function=loss, num_bits=self.get("numBits"),
                            num_passes=self.get("numPasses"))
        if self.get("learningRate") is not None:
            cfg.learning_rate = self.get("learningRate")
        if self.get("powerT") is not None:
            cfg.power_t = self.get("powerT")
        if self.get("l1") is not None:
            cfg.l1 = self.get("l1")
        if self.get("l2") is not None:
            cfg.l2 = self.get("l2")
        return parse_vw_args(self.get("passThroughArgs"), cfg)

    def set_initial_model_readable(self, text: str) -> "_VowpalWabbitBase":
        """Warm-start from a ``--readable_model`` text dump: sets numBits
        from the dump's header and initialModel to its weights
        (initialModel continuation semantics,
        vw/VowpalWabbitBase.scala:120-122)."""
        bits, weights = parse_readable_model(text)
        self.set("numBits", bits)
        self.set("initialModel", weights)
        return self

    def _dataset(self, df: DataFrame, cfg: LearnerConfig,
                 label_transform=None) -> SparseDataset:
        data = df.collect()
        rows = data[self.get_or_throw("featuresCol")]
        rows = [_to_sparse(r) for r in rows]
        for extra_col in (self.get("additionalFeatures") or ()):
            extra = [_to_sparse(r) for r in data[extra_col]]
            rows = [_merge_sparse(a, b) for a, b in zip(rows, extra)]
        labels = np.asarray(data[self.get_or_throw("labelCol")], dtype=np.float64)
        if label_transform is not None:
            labels = label_transform(labels)
        weights = None
        if self.get("weightCol"):
            weights = np.asarray(data[self.get("weightCol")], dtype=np.float64)
        return SparseDataset.from_rows(rows, labels, weights, cfg.num_bits)

    def _mesh(self):
        """The mesh ``MeshContext.set`` installed when its data axis is
        larger than 1 (the fit is then the per-shard scans averaged between
        passes), else None; ``numWorkers == 1`` forces one shard. A mesh
        built lazily does not count: 'no mesh configured' stays one
        shard."""
        from ..parallel.mesh import explicit_mesh

        return explicit_mesh(self.get("numWorkers"))


def _to_sparse(r) -> Optional[Dict[str, np.ndarray]]:
    """Accept featurizer structs OR dense vectors (auto-densify)."""
    if r is None:
        return None
    if isinstance(r, dict):
        return r
    arr = np.asarray(r, dtype=np.float64).reshape(-1)
    nz = np.nonzero(arr)[0]
    return {"indices": nz.astype(np.int64), "values": arr[nz].astype(np.float32)}


def _merge_sparse(a, b):
    """Union two sparse rows (values summed on index collision — VW merges
    namespaces into one example the same way)."""
    if a is None:
        return b
    if b is None:
        return a
    idx = np.concatenate([np.asarray(a["indices"], dtype=np.int64),
                          np.asarray(b["indices"], dtype=np.int64)])
    val = np.concatenate([np.asarray(a["values"], dtype=np.float32),
                          np.asarray(b["values"], dtype=np.float32)])
    uniq, inv = np.unique(idx, return_inverse=True)
    merged = np.zeros(len(uniq), dtype=np.float32)
    np.add.at(merged, inv, val)
    out = {"indices": uniq, "values": merged}
    size = max(int(a.get("size", 0)), int(b.get("size", 0)))
    if size:
        out["size"] = size
    return out


class _VowpalWabbitModelBase(Model, HasFeaturesCol):
    """Scoring base for VW models.

    Model interchange surface: ``get_readable_model()`` — the vw
    ``--readable_model`` text dump (bit-exact murmur hashing makes single
    weights directly comparable to a vw run). The reference's binary VW
    blob (``getModel``, vw/VowpalWabbitBaseModel.scala:1-98) is a
    version-pinned format and a documented NON-GOAL: see docs/vw.md for
    the rationale; framework persistence round-trips the full learner
    state (weights + AdaGrad/FTRL accumulators) instead.
    """

    weights = ComplexParam("weights", "Learned weight vector")
    numBits = Param("numBits", "Feature space bits", 18, ptype=int)
    testArgs = Param("testArgs", "Extra args used at test time (parity)", "", ptype=str)
    additionalFeatures = Param("additionalFeatures",
                               "Extra sparse columns merged at scoring, same "
                               "as at training", None, ptype=(list, tuple))

    def __init__(self, **kwargs):
        self._stats: List[TrainingStats] = kwargs.pop("stats", [])
        super().__init__(**kwargs)

    def _raw(self, part) -> np.ndarray:
        rows = [_to_sparse(r) for r in part[self.get_or_throw("featuresCol")]]
        for extra_col in (self.get("additionalFeatures") or ()):
            extra = [_to_sparse(r) for r in part[extra_col]]
            rows = [_merge_sparse(a, b) for a, b in zip(rows, extra)]
        ds = SparseDataset.from_rows(rows, np.zeros(len(rows)),
                                     num_bits=self.get("numBits"))
        return predict_linear(self.get_or_throw("weights"), ds)

    def get_readable_model(self, max_entries: int = 1 << 20) -> str:
        """The vw ``--readable_model`` text dump: one ``index:weight`` line
        per nonzero weight in the hashed feature space. The binary VW blob
        (getModel, vw/VowpalWabbitBaseModel.scala:1-98) is a version-pinned
        non-goal — see docs/vw.md; this text form cross-checks individual
        weights against a vw run (the hashing is bit-exact murmur)."""
        w = np.asarray(self.get_or_throw("weights"), dtype=np.float64)
        lines = [f"bits:{self.get('numBits')}"]
        nz = np.nonzero(w)[0]
        for i in nz[:max_entries]:
            lines.append(f"{int(i)}:{w[i]:.6f}")
        return "\n".join(lines) + "\n"

    def get_performance_statistics(self) -> DataFrame:
        """Training diagnostics DataFrame (VowpalWabbitBase.scala:344-368)."""
        if not self._stats:
            return DataFrame.empty(["partitionId", "numExamples", "totalTimeNs",
                                    "learnTimeNs", "averageLoss",
                                    "weightedExampleSum"])
        return DataFrame.from_rows([{
            "partitionId": s.partition_id,
            "numExamples": s.num_examples,
            "totalTimeNs": s.total_time_ns,
            "learnTimeNs": s.learn_time_ns,
            "averageLoss": s.average_loss,
            "weightedExampleSum": s.weighted_example_sum,
        } for s in self._stats])


class VowpalWabbitClassifier(Estimator, _VowpalWabbitBase):
    """Binary linear classifier with logistic loss
    (vw/VowpalWabbitClassifier.scala). Labels 0/1 are mapped to VW's -1/+1."""

    labelConversion = Param("labelConversion", "Map 0/1 labels to -1/+1", True,
                            ptype=bool)
    rawPredictionCol = Param("rawPredictionCol", "Raw margin column", "rawPrediction",
                             ptype=str)
    probabilityCol = Param("probabilityCol", "Probability column", "probability",
                           ptype=str)
    predictionCol = Param("predictionCol", "Predicted label column", "prediction",
                          ptype=str)

    def fit(self, df: DataFrame) -> "VowpalWabbitClassificationModel":
        cfg = self._config("logistic")
        convert = ((lambda y: np.where(y > 0, 1.0, -1.0))
                   if self.get("labelConversion") else None)
        ds = self._dataset(df, cfg, convert)
        init = self.get("initialModel")
        w, stats = train_linear(cfg, ds, initial_weights=init, mesh=self._mesh())
        return VowpalWabbitClassificationModel(
            weights=w, numBits=cfg.num_bits, stats=stats,
            featuresCol=self.get("featuresCol"),
            additionalFeatures=self.get("additionalFeatures"),
            rawPredictionCol=self.get("rawPredictionCol"),
            probabilityCol=self.get("probabilityCol"),
            predictionCol=self.get("predictionCol"))


class VowpalWabbitClassificationModel(_VowpalWabbitModelBase):
    rawPredictionCol = Param("rawPredictionCol", "Raw margin column", "rawPrediction",
                             ptype=str)
    probabilityCol = Param("probabilityCol", "Probability column", "probability",
                           ptype=str)
    predictionCol = Param("predictionCol", "Predicted label column", "prediction",
                          ptype=str)

    def transform(self, df: DataFrame) -> DataFrame:
        def score(part):
            raw = self._raw(part)
            p1 = 1.0 / (1.0 + np.exp(-raw))
            part[self.get("rawPredictionCol")] = raw
            part[self.get("probabilityCol")] = p1
            part[self.get("predictionCol")] = (p1 > 0.5).astype(np.float64)
            return part

        return df.map_partitions(score)


class VowpalWabbitRegressor(Estimator, _VowpalWabbitBase):
    """Linear regressor, squared/quantile loss (vw/VowpalWabbitRegressor.scala)."""

    predictionCol = Param("predictionCol", "Prediction column", "prediction", ptype=str)

    def fit(self, df: DataFrame) -> "VowpalWabbitRegressionModel":
        cfg = self._config("squared")
        ds = self._dataset(df, cfg)
        init = self.get("initialModel")
        w, stats = train_linear(cfg, ds, initial_weights=init, mesh=self._mesh())
        return VowpalWabbitRegressionModel(
            weights=w, numBits=cfg.num_bits, stats=stats,
            featuresCol=self.get("featuresCol"),
            additionalFeatures=self.get("additionalFeatures"),
            predictionCol=self.get("predictionCol"))


class VowpalWabbitRegressionModel(_VowpalWabbitModelBase):
    predictionCol = Param("predictionCol", "Prediction column", "prediction", ptype=str)

    def transform(self, df: DataFrame) -> DataFrame:
        def score(part):
            part[self.get("predictionCol")] = self._raw(part)
            return part

        return df.map_partitions(score)
