"""Column/row plumbing stages (reference stages/ package).

Parity targets per class are cited inline; behavior mirrors the reference, the
substrate is the partitioned columnar DataFrame.

The port's copy of ``mmlspark_tpu/stages/basic.py``. Host code, but
``UDFTransformer.deviceUdf``, a torch callable on ``[B, ...]`` tensors
under the port's ``DeviceFn`` contract (``core/device_stage.py``).
Stages that hold a callable save it by pickle, as the serializer saves a
``FunctionModel``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.dataframe import DataFrame, Partition, _partition_len
from ..core.params import (
    ComplexParam,
    HasInputCol,
    HasLabelCol,
    HasOutputCol,
    HasSeed,
    Param,
)
from ..core.pipeline import Estimator, Model, Transformer
from ..core.schema import ColType, Schema


class Lambda(Transformer):
    """Arbitrary DataFrame->DataFrame function as a stage (stages/Lambda.scala:21).

    The function is a ComplexParam (persisted by pickle), so Lambdas of module-level
    functions round-trip through save/load; closures don't (same limitation as the
    reference's UDF serialization).
    """

    transformFunc = ComplexParam("transformFunc", "DataFrame -> DataFrame function")

    def __init__(self, transform_func: Optional[Callable] = None, **kwargs):
        super().__init__(**kwargs)
        if transform_func is not None:
            self.set("transformFunc", transform_func)

    def transform(self, df: DataFrame) -> DataFrame:
        return self.get_or_throw("transformFunc")(df)


class UDFTransformer(Transformer, HasInputCol, HasOutputCol):
    """Apply a per-row (or per-partition-column) function to a column
    (stages/UDFTransformer.scala).

    ``udf`` maps one input value -> output value; ``vectorizedUdf`` maps a whole
    column array -> column array (preferred: one call per partition).
    """

    udf = ComplexParam("udf", "Per-row value function")
    vectorizedUdf = ComplexParam("vectorizedUdf", "Whole-column function")
    deviceUdf = ComplexParam(
        "deviceUdf",
        "Optional batched torch mirror of the udf: [B, ...] tensor -> "
        "[B, ...] tensor, row-independent and BITWISE-equal to the host "
        "udf on its accepted dtypes. When set, pipeline fusion "
        "(core/fusion.py) can run this stage in one device program with "
        "its neighbors; the host udf remains the fallback and the parity "
        "oracle.")
    inputCols = Param("inputCols", "Multiple input columns (udf gets one arg each)",
                      None, ptype=(list, tuple))

    def device_fn(self, schema):
        from ..core.device_stage import DeviceFn

        dev = self.get("deviceUdf")
        if dev is None or self.get("inputCols"):
            return None
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")

        def fn(params, env):
            return {out_col: dev(env[in_col])}

        return DeviceFn(
            key=("UDFTransformer", in_col, out_col, id(dev)),
            in_cols=(in_col,), out_cols=(out_col,), fn=fn)

    def transform(self, df: DataFrame) -> DataFrame:
        out_col = self.get_or_throw("outputCol")
        vec = self.get("vectorizedUdf")
        row_fn = self.get("udf")
        in_cols = self.get("inputCols")
        if vec is not None:
            in_col = self.get_or_throw("inputCol")
            return df.with_column(out_col, lambda p: vec(p[in_col]))
        if row_fn is None:
            raise ValueError("UDFTransformer needs udf or vectorizedUdf")
        if in_cols:
            def fn(p: Partition):
                n = _partition_len(p)
                return [row_fn(*(p[c][i] for c in in_cols)) for i in range(n)]
            return df.with_column(out_col, fn)
        in_col = self.get_or_throw("inputCol")
        return df.with_column(out_col, lambda p: [row_fn(v) for v in p[in_col]])


class MultiColumnAdapter(Transformer):
    """Apply a 1-in/1-out base stage across many column pairs
    (stages/MultiColumnAdapter.scala)."""

    baseStage = ComplexParam("baseStage", "Stage with inputCol/outputCol params")
    inputCols = Param("inputCols", "Input column names", None, ptype=(list, tuple))
    outputCols = Param("outputCols", "Output column names", None, ptype=(list, tuple))

    def transform(self, df: DataFrame) -> DataFrame:
        base = self.get_or_throw("baseStage")
        ins, outs = self.get_or_throw("inputCols"), self.get_or_throw("outputCols")
        if len(ins) != len(outs):
            raise ValueError("inputCols and outputCols must align")
        for i, o in zip(ins, outs):
            stage = base.copy()
            stage.set("inputCol", i).set("outputCol", o)
            df = stage.transform(df)
        return df


class Explode(Transformer, HasInputCol, HasOutputCol):
    """Expand an array column into one row per element (stages/Explode.scala)."""

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get("outputCol") or in_col

        def explode_part(p: Partition) -> Partition:
            col = p[in_col]
            reps = np.array([0 if v is None else len(np.atleast_1d(v)) for v in col])
            idx = np.repeat(np.arange(len(col)), reps)
            out: Partition = {}
            for name, vals in p.items():
                if name == in_col and name == out_col:
                    continue
                out[name] = vals[idx]
            flat = np.empty(int(reps.sum()), dtype=object)
            k = 0
            for v in col:
                if v is None:
                    continue
                for item in np.atleast_1d(v):
                    flat[k] = item
                    k += 1
            out[out_col] = flat
            return out

        return df.map_partitions(explode_part)


class Cacher(Transformer):
    """Materialization point (stages/Cacher.scala). Eager substrate => no-op marker."""

    disable = Param("disable", "Skip caching", False, ptype=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        return df if self.get("disable") else df.cache()


class Repartition(Transformer):
    """Shuffle rows into n even partitions (stages/Repartition.scala)."""

    n = Param("n", "Target partition count", None, lambda v: v > 0, int)
    disable = Param("disable", "Pass through unchanged", False, ptype=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        if self.get("disable"):
            return df
        return df.repartition(self.get_or_throw("n"))


class PartitionCoalesce(Transformer):
    """Merge adjacent partitions without a shuffle (reference uses df.coalesce)."""

    n = Param("n", "Target partition count", None, lambda v: v > 0, int)

    def transform(self, df: DataFrame) -> DataFrame:
        return df.coalesce(self.get_or_throw("n"))


class StratifiedRepartition(Transformer, HasLabelCol, HasSeed):
    """Label-balanced repartition: every partition sees every class
    (stages/StratifiedRepartition.scala:26-73 — needed so distributed GBDT
    multiclass training has all classes on all workers)."""

    mode = Param("mode", "'equal' or 'original' (preserve class ratios)", "original",
                 lambda v: v in ("equal", "original"), str)

    def transform(self, df: DataFrame) -> DataFrame:
        label = self.get_or_throw("labelCol")
        n_parts = df.num_partitions
        data = df.collect()
        labels = data[label]
        rng = np.random.default_rng(self.get("seed"))
        n = len(labels)
        part_of = np.zeros(n, dtype=np.int64)
        # round-robin rows of each class across partitions -> every partition gets
        # ~count/n_parts of each class (both modes; 'equal' additionally truncates
        # classes to the same per-partition count)
        classes, inverse = np.unique(labels.astype(str), return_inverse=True)
        keep = np.ones(n, dtype=bool)
        min_count = None
        if self.get("mode") == "equal":
            counts = np.bincount(inverse)
            min_count = counts.min()
        for ci in range(len(classes)):
            idx = np.where(inverse == ci)[0]
            idx = idx[rng.permutation(len(idx))]
            if min_count is not None:
                keep[idx[min_count:]] = False
                idx = idx[:min_count]
            part_of[idx] = np.arange(len(idx)) % n_parts
        parts = []
        for pi in range(n_parts):
            mask = (part_of == pi) & keep
            parts.append({k: v[mask] for k, v in data.items()})
        return DataFrame(parts, df.schema.copy())


class DropColumns(Transformer):
    """stages/DropColumns.scala."""

    cols = Param("cols", "Columns to drop", None, ptype=(list, tuple))

    def transform(self, df: DataFrame) -> DataFrame:
        return df.drop(*self.get_or_throw("cols"))


class SelectColumns(Transformer):
    """stages/SelectColumns.scala."""

    cols = Param("cols", "Columns to keep", None, ptype=(list, tuple))

    def transform(self, df: DataFrame) -> DataFrame:
        return df.select(*self.get_or_throw("cols"))


class RenameColumn(Transformer, HasInputCol, HasOutputCol):
    """stages/RenameColumn.scala."""

    def transform(self, df: DataFrame) -> DataFrame:
        return df.with_column_renamed(self.get_or_throw("inputCol"),
                                      self.get_or_throw("outputCol"))


class EnsembleByKey(Transformer):
    """Group rows by key column(s) and average score columns — incl. elementwise
    vector averaging (stages/EnsembleByKey.scala, VectorAvg UDAF at :155)."""

    keys = Param("keys", "Key column names", None, ptype=(list, tuple))
    cols = Param("cols", "Columns to aggregate", None, ptype=(list, tuple))
    newCols = Param("newCols", "Output column names (default: mean(col))", None,
                    ptype=(list, tuple))
    strategy = Param("strategy", "Aggregation strategy", "mean",
                     lambda v: v == "mean", str)
    collapseGroup = Param("collapseGroup", "One row per key (else broadcast back)",
                          True, ptype=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        keys = list(self.get_or_throw("keys"))
        cols = list(self.get_or_throw("cols"))
        new_cols = list(self.get("newCols") or [f"mean({c})" for c in cols])
        data = df.collect()
        n = len(next(iter(data.values()))) if data else 0
        key_tuples = [tuple(np.asarray(data[k][i]).item() if isinstance(data[k][i], np.generic)
                            else data[k][i] for k in keys) for i in range(n)]
        groups: Dict[tuple, List[int]] = {}
        for i, kt in enumerate(key_tuples):
            groups.setdefault(kt, []).append(i)

        def mean_of(col: np.ndarray, idxs: List[int]):
            vals = [col[i] for i in idxs if col[i] is not None]
            if not vals:
                return None
            arrs = [np.asarray(v, dtype=np.float64) for v in vals]
            m = np.mean(np.stack(arrs), axis=0)
            return float(m) if m.ndim == 0 else m

        def obj_col(values: List[Any]) -> np.ndarray:
            col = np.empty(len(values), dtype=object)
            for i, v in enumerate(values):
                col[i] = v
            return col

        if self.get("collapseGroup"):
            out: Partition = {k: obj_col([kt[j] for kt in groups])
                              for j, k in enumerate(keys)}
            for c, nc in zip(cols, new_cols):
                out[nc] = obj_col([mean_of(data[c], idxs) for idxs in groups.values()])
            return DataFrame([out])
        per_row: Dict[str, np.ndarray] = {}
        for c, nc in zip(cols, new_cols):
            vals = np.empty(n, dtype=object)
            for kt, idxs in groups.items():
                m = mean_of(data[c], idxs)
                for i in idxs:
                    vals[i] = m
            per_row[nc] = vals
        out_df = df
        for nc, vals in per_row.items():
            out_df = out_df.with_column(nc, vals)
        return out_df


class ClassBalancer(Estimator, HasInputCol, HasOutputCol):
    """Compute per-class weights = maxCount/count (stages/ClassBalancer.scala)."""

    broadcastJoin = Param("broadcastJoin", "Unused on this substrate (kept for parity)",
                          True, ptype=bool)

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "weight")
        super().__init__(**kwargs)

    def fit(self, df: DataFrame) -> "ClassBalancerModel":
        col = df.column(self.get_or_throw("inputCol"))
        classes, counts = np.unique(col.astype(str), return_counts=True)
        weights = counts.max() / counts.astype(np.float64)
        table = {c: float(w) for c, w in zip(classes, weights)}
        return ClassBalancerModel(inputCol=self.get("inputCol"),
                                  outputCol=self.get("outputCol"),
                                  weights=table)


class ClassBalancerModel(Model, HasInputCol, HasOutputCol):
    weights = Param("weights", "class -> weight map", None, ptype=dict)

    def transform(self, df: DataFrame) -> DataFrame:
        table = self.get_or_throw("weights")
        in_col = self.get_or_throw("inputCol")
        return df.with_column(
            self.get_or_throw("outputCol"),
            lambda p: np.array([table.get(str(v), 1.0) for v in p[in_col]],
                               dtype=np.float64))


class Timer(Estimator):
    """Time an inner stage's fit/transform, logging durations
    (stages/Timer.scala:57-110)."""

    stage = ComplexParam("stage", "The stage to time")
    logToScala = Param("logToScala", "Log via the framework logger (vs print)", True,
                       ptype=bool)
    disableMaterialization = Param("disableMaterialization",
                                   "Don't force evaluation when timing", False,
                                   ptype=bool)

    def _log(self, msg: str) -> None:
        if self.get("logToScala"):
            import logging
            logging.getLogger("mmlspark_tpu_torch").info(msg)
        else:
            print(msg)

    def fit(self, df: DataFrame) -> "TimerModel":
        stage = self.get_or_throw("stage")
        if isinstance(stage, Estimator):
            t0 = time.perf_counter()
            model = stage.fit(df)
            self._log(f"{type(stage).__name__}.fit took {time.perf_counter() - t0:.3f}s")
        else:
            model = stage
        return TimerModel(stage=model, logToScala=self.get("logToScala"))


class TimerModel(Model):
    stage = ComplexParam("stage", "The fitted/wrapped transformer")
    logToScala = Param("logToScala", "Log via the framework logger", True, ptype=bool)

    def _log(self, msg: str) -> None:
        if self.get("logToScala"):
            import logging
            logging.getLogger("mmlspark_tpu_torch").info(msg)
        else:
            print(msg)

    def transform(self, df: DataFrame) -> DataFrame:
        stage = self.get_or_throw("stage")
        t0 = time.perf_counter()
        out = stage.transform(df)
        self._log(f"{type(stage).__name__}.transform took {time.perf_counter() - t0:.3f}s")
        return out


class SummarizeData(Transformer):
    """Dataset statistics as a DataFrame: counts, missing, quantiles, basic moments
    (stages/SummarizeData.scala:100+)."""

    counts = Param("counts", "Include count stats", True, ptype=bool)
    basic = Param("basic", "Include basic moments", True, ptype=bool)
    sample = Param("sample", "Include quantiles", True, ptype=bool)
    percentiles = Param("percentiles", "Quantiles to compute",
                        [0.005, 0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99, 0.995],
                        ptype=list)
    errorThreshold = Param("errorThreshold", "Quantile error (exact here; parity)", 0.0,
                           ptype=float)

    def transform(self, df: DataFrame) -> DataFrame:
        data = df.collect()
        n = df.count()
        rows = []
        for name in df.columns:
            col = data[name]
            stats: Dict[str, Any] = {"Feature": name}
            if col.dtype == object:
                numeric = np.array([v for v in col if isinstance(v, (int, float, np.number))],
                                   dtype=np.float64)
                missing = sum(1 for v in col if v is None)
            else:
                numeric = col.astype(np.float64) if col.dtype.kind in "bifc" else np.array([])
                missing = int(np.isnan(numeric).sum()) if numeric.size else 0
                numeric = numeric[~np.isnan(numeric)] if numeric.size else numeric
            if self.get("counts"):
                stats["Count"] = float(n)
                stats["Unique Value Count"] = float(len(set(
                    str(v) for v in col)))
                stats["Missing Value Count"] = float(missing)
            if self.get("basic"):
                has = numeric.size > 0
                stats["Mean"] = float(numeric.mean()) if has else None
                stats["Standard Deviation"] = (
                    float(numeric.std(ddof=1)) if numeric.size > 1 else None)
                stats["Min"] = float(numeric.min()) if has else None
                stats["Max"] = float(numeric.max()) if has else None
            if self.get("sample"):
                for q in self.get("percentiles"):
                    stats[f"Quantile_{q}"] = (float(np.quantile(numeric, q))
                                              if numeric.size else None)
            rows.append(stats)
        return DataFrame.from_rows(rows)
