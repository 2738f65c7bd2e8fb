"""Missing-data imputation and type conversion stages.

Reference: featurize/CleanMissingData.scala (mean/median/custom impute per
column) and featurize/DataConversion.scala (cast columns across primitive types,
date rendering).

The port's copy of ``mmlspark_tpu/featurize/clean.py`` (host code).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import HasInputCols, HasOutputCols, Param
from ..core.pipeline import Estimator, Model, Transformer


class CleanMissingData(Estimator, HasInputCols, HasOutputCols):
    """Impute NaN/None in numeric columns (CleanMissingData.scala)."""

    cleaningMode = Param("cleaningMode", "Mean|Median|Custom", "Mean",
                         lambda v: v in ("Mean", "Median", "Custom"), str)
    customValue = Param("customValue", "Fill value for Custom mode", None, ptype=float)

    def fit(self, df: DataFrame) -> "CleanMissingDataModel":
        in_cols = list(self.get_or_throw("inputCols"))
        out_cols = list(self.get("outputCols") or in_cols)
        mode = self.get("cleaningMode")
        fills: Dict[str, float] = {}
        data = df.collect()
        for c in in_cols:
            col = data[c]
            if col.dtype == object:
                vals = np.array([float(v) for v in col if v is not None], dtype=np.float64)
            else:
                vals = col.astype(np.float64)
                vals = vals[~np.isnan(vals)]
            if mode == "Custom":
                fills[c] = float(self.get_or_throw("customValue"))
            elif mode == "Median":
                fills[c] = float(np.median(vals)) if len(vals) else 0.0
            else:
                fills[c] = float(vals.mean()) if len(vals) else 0.0
        return CleanMissingDataModel(inputCols=in_cols, outputCols=out_cols,
                                     fillValues=fills)


class CleanMissingDataModel(Model, HasInputCols, HasOutputCols):
    fillValues = Param("fillValues", "column -> fill value", None, ptype=dict)

    def transform(self, df: DataFrame) -> DataFrame:
        fills = self.get_or_throw("fillValues")
        in_cols = list(self.get_or_throw("inputCols"))
        out_cols = list(self.get("outputCols") or in_cols)
        out = df
        for ic, oc in zip(in_cols, out_cols):
            fill = fills[ic]

            def fn(p, _ic=ic, _fill=fill):
                col = p[_ic]
                if col.dtype == object:
                    return np.array([_fill if v is None or
                                     (isinstance(v, float) and np.isnan(v))
                                     else float(v) for v in col], dtype=np.float64)
                vals = col.astype(np.float64)
                return np.where(np.isnan(vals), _fill, vals)

            out = out.with_column(oc, fn)
        return out


_CONVERTERS = {
    "boolean": lambda col: np.array([bool(float(v)) if v is not None else None
                                     for v in col], dtype=object),
    "byte": lambda col: col.astype(np.float64).astype(np.int32),
    "short": lambda col: col.astype(np.float64).astype(np.int32),
    "integer": lambda col: col.astype(np.float64).astype(np.int32),
    "long": lambda col: col.astype(np.float64).astype(np.int64),
    "float": lambda col: col.astype(np.float32),
    "double": lambda col: col.astype(np.float64),
    "string": lambda col: np.array([None if v is None else str(v) for v in col],
                                   dtype=object),
    "toCategorical": None,   # handled via ValueIndexer semantics
    "clearCategorical": None,
    "date": None,
}


class DataConversion(Transformer):
    """Cast columns to a target type (featurize/DataConversion.scala)."""

    cols = Param("cols", "Columns to convert", None, ptype=(list, tuple))
    convertTo = Param("convertTo", "Target type", None,
                      lambda v: v in _CONVERTERS, str)
    dateTimeFormat = Param("dateTimeFormat", "Format for date conversion",
                           "yyyy-MM-dd HH:mm:ss", ptype=str)

    def transform(self, df: DataFrame) -> DataFrame:
        target = self.get_or_throw("convertTo")
        out = df
        for c in self.get_or_throw("cols"):
            if target == "date":
                out = out.with_column(c, self._to_date(c))
            elif target == "toCategorical":
                from .indexers import ValueIndexer
                out = ValueIndexer(inputCol=c, outputCol=c).fit(out).transform(out)
            elif target == "clearCategorical":
                out.schema.metadata.pop(c, None)
            else:
                conv = _CONVERTERS[target]
                out = out.with_column(c, lambda p, _c=c, _f=conv: _f(p[_c]))
        return out

    def _to_date(self, c):
        import datetime

        # translate the Java-style format the reference uses to strptime
        fmt = (self.get("dateTimeFormat")
               .replace("yyyy", "%Y").replace("MM", "%m").replace("dd", "%d")
               .replace("HH", "%H").replace("mm", "%M").replace("ss", "%S"))

        def fn(p):
            col = p[c]
            out = np.empty(len(col), dtype=object)
            for i, v in enumerate(col):
                if v is None:
                    out[i] = None
                elif isinstance(v, datetime.datetime):
                    out[i] = v
                elif isinstance(v, (int, float, np.integer, np.floating)):
                    out[i] = datetime.datetime.fromtimestamp(float(v) / 1000.0)
                else:
                    out[i] = datetime.datetime.strptime(str(v), fmt)
            return out

        return fn
