"""User/item id indexing for recommenders (reference
recommendation/RecommendationIndexer.scala; the port's copy of
``mmlspark_tpu/recommendation/indexer.py``, host code)."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, Param
from ..core.pipeline import Estimator, Model


class RecommendationIndexer(Estimator):
    userInputCol = Param("userInputCol", "Raw user id column", None, ptype=str)
    userOutputCol = Param("userOutputCol", "Indexed user column", None, ptype=str)
    itemInputCol = Param("itemInputCol", "Raw item id column", None, ptype=str)
    itemOutputCol = Param("itemOutputCol", "Indexed item column", None, ptype=str)
    ratingCol = Param("ratingCol", "Rating column (passthrough)", None, ptype=str)

    def fit(self, df: DataFrame) -> "RecommendationIndexerModel":
        users = sorted({str(v) for v in df.column(self.get_or_throw("userInputCol"))})
        items = sorted({str(v) for v in df.column(self.get_or_throw("itemInputCol"))})
        return RecommendationIndexerModel(
            userInputCol=self.get("userInputCol"),
            userOutputCol=self.get("userOutputCol"),
            itemInputCol=self.get("itemInputCol"),
            itemOutputCol=self.get("itemOutputCol"),
            userMap={u: i for i, u in enumerate(users)},
            itemMap={t: i for i, t in enumerate(items)})


class RecommendationIndexerModel(Model):
    userInputCol = Param("userInputCol", "Raw user id column", None, ptype=str)
    userOutputCol = Param("userOutputCol", "Indexed user column", None, ptype=str)
    itemInputCol = Param("itemInputCol", "Raw item id column", None, ptype=str)
    itemOutputCol = Param("itemOutputCol", "Indexed item column", None, ptype=str)
    userMap = ComplexParam("userMap", "user -> index")
    itemMap = ComplexParam("itemMap", "item -> index")

    def transform(self, df: DataFrame) -> DataFrame:
        umap = self.get_or_throw("userMap")
        imap = self.get_or_throw("itemMap")
        uin, uout = self.get_or_throw("userInputCol"), self.get_or_throw("userOutputCol")
        iin, iout = self.get_or_throw("itemInputCol"), self.get_or_throw("itemOutputCol")
        out = df.with_column(uout, lambda p: np.array(
            [float(umap.get(str(v), -1)) for v in p[uin]]))
        return out.with_column(iout, lambda p: np.array(
            [float(imap.get(str(v), -1)) for v in p[iin]]))

    def recover_user(self, idx: int) -> Any:
        inv = {v: k for k, v in self.get_or_throw("userMap").items()}
        return inv.get(idx)

    def recover_item(self, idx: int) -> Any:
        inv = {v: k for k, v in self.get_or_throw("itemMap").items()}
        return inv.get(idx)
