"""Auto-featurization: heterogeneous columns -> one numeric feature vector.

Reference: featurize/Featurize.scala:25-110 + featurize/AssembleFeatures.scala —
per output column, build a sub-pipeline that casts numerics, indexes (or hashes
when high-cardinality) strings, one-hot encodes categoricals, imputes missing
values, and assembles everything into a single vector column. TrainClassifier /
TrainRegressor lean on this for their auto-featurize step, and the reference's
LightGBM featurize helper (LightGBMUtils.scala:44-57) is the same machinery.

The port's copy of ``mmlspark_tpu/featurize/assemble.py``. The two
``device_fn``s are torch functions under the port's ``DeviceFn`` contract
(``core/device_stage.py``), with the reference's ``accepts`` (f32-exact
inputs) and ``finalize`` (f64 vectors) rules, so a fused assembler ->
LightGBM pipeline scores as the unfused one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.device_stage import DeviceFn, FusionUnsupported
from ..core.params import ComplexParam, HasInputCols, HasOutputCol, Param
from ..core.pipeline import Estimator, Model, Transformer
from ..core.schema import ColType, Schema
from ..ops.hashing import hash_string
from ..parallel.batching import densify_sparse, is_sparse_row, sparse_width

#: dtypes that widen to float64 EXACTLY through a float32 device compute —
#: the precondition for a fused assembler to reproduce the host's f64
#: feature vectors bitwise (f64 inputs would narrow lossily on the wire)
_F32_EXACT_DTYPES = frozenset(
    np.dtype(t) for t in (np.float32, np.bool_, np.uint8, np.int8,
                          np.uint16, np.int16))


def _f32_exact_accepts(in_cols):
    def accepts(probes):
        for c in in_cols:
            p = probes.get(c)
            if p is None or p["dtype"] is None:
                continue
            if p["sparse"] or p["dtype"] not in _F32_EXACT_DTYPES:
                return False
        return True
    return accepts


def _vector_f64_finalize(out_col):
    """f32 device batch -> f64 per-row vectors: exact widening, matching
    the host assembler's float64 output for f32-exact inputs."""

    def finalize(outs, ctx):
        arr = np.asarray(outs[out_col], dtype=np.float64)
        obj = np.empty(len(arr), dtype=object)
        for i in range(len(arr)):
            obj[i] = arr[i]
        return {out_col: obj}

    return finalize


class FastVectorAssembler(Transformer, HasInputCols, HasOutputCol):
    """Concatenate numeric/vector columns into one dense vector per row,
    skipping per-slot metadata bookkeeping — the reference's metadata-light
    VectorAssembler replacement (org/apache/spark/ml/feature/
    FastVectorAssembler.scala:1-151). Null scalars become NaN; null vectors
    raise (their width is unknowable row-locally, same as the reference)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "features")
        super().__init__(**kwargs)

    def transform(self, df: DataFrame) -> DataFrame:
        in_cols = list(self.get_or_throw("inputCols"))
        out_col = self.get_or_throw("outputCol")
        # Vector-typed columns have row-locally-unknowable width when null,
        # so nulls there must raise (FastVectorAssembler.scala:143-144).
        vector_typed = {
            c for c in in_cols
            if df.schema.types.get(c) in (ColType.VECTOR, ColType.TENSOR)
        }

        def fn(p):
            n = len(next(iter(p.values()))) if p else 0
            # Columns not schema-marked VECTOR can still carry arrays (OBJECT
            # dtype); detect from the partition's first non-null value.
            holds_vectors = set(vector_typed)
            for c in in_cols:
                if c not in holds_vectors:
                    for v in p[c]:
                        if v is not None:
                            if isinstance(v, (np.ndarray, list, tuple)):
                                holds_vectors.add(c)
                            break
            out = np.empty(n, dtype=object)
            for i in range(n):
                parts = []
                for c in in_cols:
                    v = p[c][i]
                    if v is None:
                        if c in holds_vectors:
                            raise ValueError(
                                f"Values to assemble cannot be null: column "
                                f"'{c}' holds a null vector")
                        parts.append(np.array([np.nan]))
                    elif isinstance(v, (np.ndarray, list, tuple)):
                        arr = np.asarray(v, dtype=np.float64).ravel()
                        parts.append(arr)
                    else:
                        parts.append(np.array([float(v)], dtype=np.float64))
                out[i] = np.concatenate(parts)
            return out

        return df.with_column(out_col, fn)

    def transform_schema(self, schema: Schema) -> Schema:
        for c in self.get_or_throw("inputCols"):
            schema.require(c)
        out = schema.copy()
        out.types[self.get_or_throw("outputCol")] = ColType.VECTOR
        return out

    def device_fn(self, schema: Schema):
        """Fusion contract: concatenation is pure value movement, so the
        assembled vector computes on device in f32 and widens to the host's
        f64 exactly — gated (accepts) to f32-exact input dtypes; nulls take
        the host path (their NaN-fill semantics aren't null-propagation)."""
        in_cols = tuple(self.get_or_throw("inputCols"))
        out_col = self.get_or_throw("outputCol")

        def fn(params, env):
            parts = []
            for c in in_cols:
                v = env[c].to(torch.float32)
                parts.append(v.reshape(v.shape[0], -1))
            return {out_col: torch.cat(parts, dim=1)}

        return DeviceFn(
            key=("FastVectorAssembler", in_cols, out_col),
            in_cols=in_cols, out_cols=(out_col,), fn=fn,
            finalize=_vector_f64_finalize(out_col),
            accepts=_f32_exact_accepts(in_cols), null_policy="fallback")


class AssembleFeatures(Estimator, HasInputCols, HasOutputCol):
    """Fit per-column encoders; produce a single dense vector column."""

    oneHotEncodeCategoricals = Param("oneHotEncodeCategoricals",
                                     "One-hot low-cardinality strings", True,
                                     ptype=bool)
    numberOfFeatures = Param("numberOfFeatures",
                             "Hash bucket count for high-cardinality strings", 262144,
                             ptype=int)
    allowImages = Param("allowImages", "Allow image columns (unrolled)", False,
                        ptype=bool)
    maxCategoricalLevels = Param("maxCategoricalLevels",
                                 "Cardinality cutoff for one-hot vs hashing", 100,
                                 ptype=int)

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "features")
        super().__init__(**kwargs)

    def fit(self, df: DataFrame) -> "AssembleFeaturesModel":
        in_cols = list(self.get_or_throw("inputCols"))
        data = df.collect()
        encoders: List[Dict[str, Any]] = []
        for c in in_cols:
            col = data[c]
            kind = _column_kind(col)
            if kind == "numeric":
                vals = _as_float(col)
                mean = float(np.nanmean(vals)) if len(vals) else 0.0
                encoders.append({"col": c, "kind": "numeric", "fill": mean})
            elif kind == "vector":
                dim = 0
                for v in col:
                    if v is not None:
                        dim = len(np.asarray(v).reshape(-1))
                        break
                encoders.append({"col": c, "kind": "vector", "dim": dim})
            elif kind == "sparse":
                encoders.append({"col": c, "kind": "sparse",
                                 "dim": sparse_width(col)})
            elif kind == "string":
                levels = sorted({str(v) for v in col if v is not None})
                if (self.get("oneHotEncodeCategoricals")
                        and len(levels) <= self.get("maxCategoricalLevels")):
                    encoders.append({"col": c, "kind": "onehot", "levels": levels})
                else:
                    encoders.append({"col": c, "kind": "hash",
                                     "buckets": min(self.get("numberOfFeatures"),
                                                    1 << 18)})
            else:
                continue  # unsupported columns silently skipped (reference behavior)
        return AssembleFeaturesModel(
            inputCols=in_cols, outputCol=self.get("outputCol"), encoders=encoders)


class AssembleFeaturesModel(Model, HasInputCols, HasOutputCol):
    encoders = ComplexParam("encoders", "Per-column encoder specs")

    def transform(self, df: DataFrame) -> DataFrame:
        encoders = self.get_or_throw("encoders")
        out_col = self.get_or_throw("outputCol")

        def fn(p):
            n = len(next(iter(p.values()))) if p else 0
            pieces: List[np.ndarray] = []
            for enc in encoders:
                col = p[enc["col"]]
                kind = enc["kind"]
                if kind == "numeric":
                    vals = _as_float(col)
                    vals = np.where(np.isnan(vals), enc["fill"], vals)
                    pieces.append(vals.reshape(n, 1))
                elif kind == "vector":
                    dim = enc["dim"]
                    block = np.zeros((n, dim))
                    for i, v in enumerate(col):
                        if v is not None:
                            block[i] = np.asarray(v, dtype=np.float64).reshape(-1)[:dim]
                    pieces.append(block)
                elif kind == "sparse":
                    pieces.append(densify_sparse(col, enc["dim"]))
                elif kind == "onehot":
                    levels = enc["levels"]
                    index = {v: i for i, v in enumerate(levels)}
                    block = np.zeros((n, len(levels)))
                    for i, v in enumerate(col):
                        j = index.get(str(v)) if v is not None else None
                        if j is not None:
                            block[i, j] = 1.0
                    pieces.append(block)
                elif kind == "hash":
                    # single hashed slot per string (compact; collisions sum)
                    block = np.zeros((n, 1))
                    for i, v in enumerate(col):
                        if v is not None:
                            block[i, 0] = hash_string(str(v)) % enc["buckets"]
                    pieces.append(block)
            full = np.concatenate(pieces, axis=1) if pieces else np.zeros((n, 0))
            out = np.empty(n, dtype=object)
            for i in range(n):
                out[i] = full[i]
            return out

        res = df.with_column(out_col, fn)
        names = self.slot_names()
        if names is not None:
            res.schema.meta(out_col)["slot_names"] = names
        return res

    def slot_names(self) -> Optional[List[str]]:
        """Per-slot names of the assembled vector (the reference keeps these
        in Spark ML column metadata; consumers like categoricalSlotNames
        resolve against them). None when a block has no stable naming or the
        vector is too wide to enumerate."""
        names: List[str] = []
        for enc in self.get_or_throw("encoders"):
            c, kind = enc["col"], enc["kind"]
            if kind == "numeric":
                names.append(c)
            elif kind == "onehot":
                names.extend(f"{c}_{lv}" for lv in enc["levels"])
            elif kind == "hash":
                names.append(c)
            elif kind in ("vector", "sparse"):
                if enc["dim"] > 10_000:
                    return None
                names.extend(f"{c}_{i}" for i in range(enc["dim"]))
        return names

    def transform_schema(self, schema: Schema) -> Schema:
        out = schema.copy()
        out.types[self.get_or_throw("outputCol")] = ColType.VECTOR
        names = self.slot_names()
        if names is not None:
            out.meta(self.get_or_throw("outputCol"))["slot_names"] = names
        return out

    def device_fn(self, schema: Schema):
        """Fusion contract: numeric (NaN -> mean fill) and vector encoders
        mirror exactly on device; string one-hot/hash encoders are host-only
        (the whole stage stays host when any is present). Numeric encoders
        additionally require an f32-representable fill — the host imputes in
        f64, and a non-representable mean cannot round-trip the f32 wire."""
        encoders = self.get("encoders")
        if not encoders:
            return None
        if any(e["kind"] not in ("numeric", "vector") for e in encoders):
            return None
        for e in encoders:
            if e["kind"] == "numeric" and \
                    float(np.float32(e["fill"])) != float(e["fill"]):
                return None
        in_cols = tuple(e["col"] for e in encoders)
        out_col = self.get_or_throw("outputCol")

        def fn(params, env):
            parts = []
            for e in encoders:
                v = env[e["col"]].to(torch.float32)
                if e["kind"] == "numeric":
                    if v.ndim != 1:
                        raise FusionUnsupported("numeric encoder expects scalars")
                    v = torch.where(torch.isnan(v), float(np.float32(e["fill"])),
                                    v)
                    v = v.reshape(-1, 1)
                else:
                    if v.ndim != 2 or v.shape[1] != e["dim"]:
                        raise FusionUnsupported(
                            f"vector dim {v.shape} != fitted {e['dim']}")
                parts.append(v)
            return {out_col: torch.cat(parts, dim=1)}

        return DeviceFn(
            key=("AssembleFeaturesModel", in_cols, out_col,
                 tuple(tuple(sorted((k, v) for k, v in e.items()
                                    if not isinstance(v, (list, np.ndarray))))
                       for e in encoders)),
            in_cols=in_cols, out_cols=(out_col,), fn=fn,
            finalize=_vector_f64_finalize(out_col),
            accepts=_f32_exact_accepts(in_cols), null_policy="fallback")


class Featurize(Estimator):
    """Map of output col -> input cols, each assembled independently
    (featurize/Featurize.scala:25-110)."""

    featureColumns = Param("featureColumns", "outputCol -> [inputCols] map", None,
                           ptype=dict)
    oneHotEncodeCategoricals = Param("oneHotEncodeCategoricals", "One-hot strings",
                                     True, ptype=bool)
    numberOfFeatures = Param("numberOfFeatures", "Hash buckets", 262144, ptype=int)
    allowImages = Param("allowImages", "Allow image columns", False, ptype=bool)

    def fit(self, df: DataFrame) -> "Model":
        from ..core.pipeline import PipelineModel

        fitted = []
        for out_col, in_cols in self.get_or_throw("featureColumns").items():
            stage = AssembleFeatures(
                inputCols=list(in_cols), outputCol=out_col,
                oneHotEncodeCategoricals=self.get("oneHotEncodeCategoricals"),
                numberOfFeatures=self.get("numberOfFeatures"),
                allowImages=self.get("allowImages"))
            fitted.append(stage.fit(df))
        return PipelineModel(fitted)


def _column_kind(col: np.ndarray) -> str:
    if col.dtype.kind in "biufc":
        return "numeric"
    for v in col:
        if v is None:
            continue
        if isinstance(v, str):
            return "string"
        if is_sparse_row(v):
            return "sparse"  # TextFeaturizer/VW sparse-row struct
        if isinstance(v, (np.ndarray, list, tuple)):
            return "vector"
        if isinstance(v, (int, float, np.integer, np.floating, bool)):
            return "numeric"
        return "other"
    return "other"


def _as_float(col: np.ndarray) -> np.ndarray:
    if col.dtype == object:
        return np.array([np.nan if v is None else float(v) for v in col],
                        dtype=np.float64)
    return col.astype(np.float64)
