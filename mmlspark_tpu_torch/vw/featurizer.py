"""VowpalWabbitFeaturizer: hash heterogeneous columns into sparse features
(the port of ``mmlspark_tpu/vw/featurizer.py``; host code, bit for bit the
reference's indices and values).

Reference: vw/VowpalWabbitFeaturizer.scala:62-180 + vw/featurizer/*.scala (9
type-dispatched featurizer classes). Hash scheme is reference/VW-exact so feature
spaces interoperate:

  - namespaceHash = murmur(outputCol, seed)  (VowpalWabbitFeaturizer.scala:115)
  - numeric/bool  -> index = murmur(prefixName, namespaceHash), value = the number
    (zero values filtered; NumericFeaturizer/BooleanFeaturizer)
  - string        -> index = murmur(prefixName + value, namespaceHash), value 1
    (StringFeaturizer; prefixName = colName when prefixStringsWithColumnName else "")
  - string-array  -> one such feature per element (StringArrayFeaturizer)
  - map           -> index = murmur(prefixName + key, namespaceHash), value = map
    value (MapFeaturizer); string-valued maps hash key+value with value 1
    (MapStringFeaturizer)
  - vector        -> raw positional indices + values passthrough (VectorFeaturizer)

Output row = {"indices": int64[], "values": float32[]} struct (sorted, deduped by
summing — VW semantics for repeated indices), masked into ``numBits`` space.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import HasInputCols, HasOutputCol, Param
from ..core.pipeline import Transformer
from ..core.schema import ColType, Schema
from ..ops.hashing import hash_string, hash_strings


def _sort_dedup(idx, val, mask: int, sum_collisions: bool = True
                ) -> Dict[str, np.ndarray]:
    """Mask, sort, and merge duplicate indices (sum, or keep-first when
    ``sum_collisions`` is False — VW's sumCollisions semantics)."""
    size = mask + 1  # declared width: densification must not depend on rows
    if len(idx) == 0:
        return {"size": size, "indices": np.empty(0, dtype=np.int64),
                "values": np.empty(0, dtype=np.float32)}
    arr_i = np.asarray(idx, dtype=np.int64) & mask
    arr_v = np.asarray(val, dtype=np.float32)
    order = np.argsort(arr_i, kind="stable")
    arr_i, arr_v = arr_i[order], arr_v[order]
    uniq, start = np.unique(arr_i, return_index=True)
    if sum_collisions:
        merged = np.add.reduceat(arr_v, start)
    else:
        merged = arr_v[start]  # first occurrence wins
    return {"size": size, "indices": uniq, "values": merged.astype(np.float32)}


class VowpalWabbitFeaturizer(Transformer, HasInputCols, HasOutputCol):
    numBits = Param("numBits", "Feature space bits (mask = 2^bits - 1)", 30,
                    lambda v: 1 <= v <= 31, int)
    seed = Param("seed", "Murmur seed", 0, ptype=int)
    stringSplit = Param("stringSplit", "Tokenize strings on whitespace into words",
                        False, ptype=bool)
    stringSplitInputCols = Param(
        "stringSplitInputCols",
        "Columns whose strings are whitespace-tokenized (the reference's "
        "param name, VowpalWabbitFeaturizer.scala; stringSplit=True applies "
        "to every column)", None, ptype=(list, tuple))
    sumCollisions = Param("sumCollisions", "Sum values on index collision (else keep)",
                          True, ptype=bool)
    prefixStringsWithColumnName = Param("prefixStringsWithColumnName",
                                        "Prefix hashed strings with the column name",
                                        True, ptype=bool)

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "features")
        super().__init__(**kwargs)

    def transform(self, df: DataFrame) -> DataFrame:
        in_cols = list(self.get_or_throw("inputCols"))
        out_col = self.get_or_throw("outputCol")
        seed = self.get("seed")
        mask = (1 << self.get("numBits")) - 1
        split_all = self.get("stringSplit")
        split_cols = set(self.get("stringSplitInputCols") or ())
        prefix = self.get("prefixStringsWithColumnName")
        sum_coll = self.get("sumCollisions")

        # namespaceHash seeds every per-feature hash (reference :115).
        # NOTE: the reference passes prefixName to ALL featurizers (numeric/bool/map
        # included, VowpalWabbitFeaturizer.scala:65-78), so with
        # prefixStringsWithColumnName=False numeric columns share one index — odd,
        # but reference-exact; leave the flag on (default) for distinct indices.
        ns_hash = hash_string(out_col, seed)
        prefix_of = {c: (c if prefix else "") for c in in_cols}
        col_hash = {c: hash_string(prefix_of[c], ns_hash) for c in in_cols}

        def fn(p):
            n = len(next(iter(p.values()))) if p else 0
            out = np.empty(n, dtype=object)
            # two passes: collect every string needing a hash across the WHOLE
            # partition (placeholder -1 in the row), hash them in ONE batched
            # C++ murmur call, then patch the placeholders. The per-token
            # scalar-murmur loop this replaces was the hot path (~50us/hash
            # through the numpy fallback).
            rows_idx: List[List[int]] = [[] for _ in range(n)]
            rows_val: List[List[float]] = [[] for _ in range(n)]
            strs: List[str] = []
            slots: List[Tuple[int, int]] = []  # (row, position) to patch

            def add_hashed(i, text):
                slots.append((i, len(rows_idx[i])))
                rows_idx[i].append(-1)
                rows_val[i].append(1.0)
                strs.append(text)

            for i in range(n):
                idx, val = rows_idx[i], rows_val[i]
                for c in in_cols:
                    v = p[c][i]
                    pn = prefix_of[c]
                    if v is None:
                        continue
                    if isinstance(v, (bool, np.bool_)):
                        if v:  # BooleanFeaturizer: fires only when true
                            idx.append(col_hash[c])
                            val.append(1.0)
                    elif isinstance(v, (int, float, np.integer, np.floating)):
                        if v != 0:  # NumericFeaturizer filters zeros
                            idx.append(col_hash[c])
                            val.append(float(v))
                    elif isinstance(v, str):
                        split = split_all or c in split_cols
                        for t in (v.split() if split else [v]):
                            add_hashed(i, pn + t)
                    elif isinstance(v, dict):
                        for k, mv in v.items():
                            if isinstance(mv, str):  # MapStringFeaturizer
                                add_hashed(i, pn + str(k) + mv)
                            elif mv != 0:  # MapFeaturizer, zero-filtered
                                slots.append((i, len(idx)))
                                idx.append(-1)
                                val.append(float(mv))
                                strs.append(pn + str(k))
                    elif isinstance(v, (list, tuple, np.ndarray)):
                        arr = np.asarray(v)
                        if arr.dtype.kind in "OUS":
                            for t in arr:  # StringArrayFeaturizer
                                add_hashed(i, pn + str(t))
                        else:  # VectorFeaturizer: raw positional passthrough
                            idx.extend(range(arr.size))
                            val.extend(float(x) for x in arr.ravel())
                    else:
                        raise TypeError(
                            f"Unsupported value type {type(v)} in col {c!r}")

            if strs:
                hashed = hash_strings(strs, ns_hash)
                for (i, j), h in zip(slots, hashed):
                    rows_idx[i][j] = int(h)
            for i in range(n):
                out[i] = _sort_dedup(rows_idx[i], rows_val[i], mask, sum_coll)
            return out

        return df.with_column(out_col, fn)

    def transform_schema(self, schema: Schema) -> Schema:
        out = schema.copy()
        out.types[self.get_or_throw("outputCol")] = ColType.STRUCT
        return out


class VowpalWabbitInteractions(Transformer, HasInputCols, HasOutputCol):
    """Quadratic/cubic interaction features: hash-combine indices and multiply
    values across the given sparse-feature columns
    (reference vw/VowpalWabbitInteractions.scala)."""

    numBits = Param("numBits", "Feature space bits", 30, lambda v: 1 <= v <= 31, int)
    sumCollisions = Param("sumCollisions", "Sum values on collision", True, ptype=bool)

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "interactions")
        super().__init__(**kwargs)

    def transform(self, df: DataFrame) -> DataFrame:
        in_cols = list(self.get_or_throw("inputCols"))
        out_col = self.get_or_throw("outputCol")
        mask = (1 << self.get("numBits")) - 1
        sum_coll = self.get("sumCollisions")

        def fn(p):
            n = len(next(iter(p.values()))) if p else 0
            out = np.empty(n, dtype=object)
            for i in range(n):
                feats = [p[c][i] for c in in_cols]
                if any(f is None for f in feats):
                    out[i] = {"size": mask + 1,
                              "indices": np.empty(0, dtype=np.int64),
                              "values": np.empty(0, dtype=np.float32)}
                    continue
                # FNV-1 combine, 32-bit wraparound (VowpalWabbitInteractions.scala:43-57):
                # start idx=0, per column idx = (idx * 16777619) ^ idx_col
                fnv = np.uint32(16777619)
                idx = np.zeros(1, dtype=np.uint32)
                val = np.ones(1, dtype=np.float64)
                with np.errstate(over="ignore"):
                    for f in feats:
                        i2 = f["indices"].astype(np.uint32)
                        v2 = f["values"].astype(np.float64)
                        idx = ((idx[:, None] * fnv) ^ i2[None, :]).reshape(-1)
                        val = (val[:, None] * v2[None, :]).reshape(-1)
                out[i] = _sort_dedup(idx.astype(np.int64), val, mask, sum_coll)
            return out

        return df.with_column(out_col, fn)
