"""Typed distinct-value indexing with categorical metadata.

Reference: featurize/ValueIndexer.scala (fit collects ordered distinct values,
model maps value -> index, storing categorical levels in column metadata) and
featurize/IndexToValue.scala (inverse via that metadata).

The port's copy of ``mmlspark_tpu/featurize/indexers.py`` (host code).
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasInputCol, HasOutputCol, Param
from ..core.pipeline import Estimator, Model
from ..core.schema import ColType, Schema, get_categorical_levels, set_categorical_levels


class ValueIndexer(Estimator, HasInputCol, HasOutputCol):
    """Fit: collect sorted distinct values; nulls get the last index."""

    def fit(self, df: DataFrame) -> "ValueIndexerModel":
        col = df.column(self.get_or_throw("inputCol"))
        vals = [v for v in col if v is not None]
        try:
            levels = sorted(set(vals))
        except TypeError:
            levels = sorted(set(str(v) for v in vals))
        return ValueIndexerModel(
            inputCol=self.get("inputCol"), outputCol=self.get("outputCol"),
            levels=list(levels))


class ValueIndexerModel(Model, HasInputCol, HasOutputCol):
    levels = ComplexParam("levels", "Ordered distinct values")

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        levels = list(self.get_or_throw("levels"))
        index = {v: i for i, v in enumerate(levels)}
        null_index = len(levels)

        def fn(p):
            col = p[in_col]
            out = np.empty(len(col), dtype=np.float64)
            for i, v in enumerate(col):
                if v is None:
                    out[i] = null_index
                else:
                    out[i] = index.get(v, index.get(str(v), null_index))
            return out

        result = df.with_column(out_col, fn)
        set_categorical_levels(result.schema, out_col, levels)
        return result

    def transform_schema(self, schema: Schema) -> Schema:
        out = schema.copy()
        out.types[self.get_or_throw("outputCol")] = ColType.FLOAT64
        set_categorical_levels(out, self.get_or_throw("outputCol"),
                               list(self.get_or_throw("levels")))
        return out


class IndexToValue(Model, HasInputCol, HasOutputCol):
    """Inverse of ValueIndexerModel using categorical metadata
    (featurize/IndexToValue.scala)."""

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        levels = get_categorical_levels(df.schema, in_col)
        if levels is None:
            raise ValueError(f"Column {in_col!r} has no categorical levels metadata")

        def fn(p):
            col = p[in_col]
            out = np.empty(len(col), dtype=object)
            for i, v in enumerate(col):
                iv = int(v)
                out[i] = levels[iv] if 0 <= iv < len(levels) else None
            return out

        return df.with_column(out_col, fn)
