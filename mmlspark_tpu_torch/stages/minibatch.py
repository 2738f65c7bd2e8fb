"""Minibatching stages: rows -> array-valued batch rows and back.

Reference: stages/MiniBatchTransformer.scala:14-200 (Fixed/Dynamic/TimeInterval
variants + FlattenBatch) and stages/Batchers.scala:12-160 (the iterator machinery).
Batch rows hold per-column lists; downstream device stages (DNNModel) consume them
as padded static-shape arrays via parallel/batching.py.

The port's copy of ``mmlspark_tpu/stages/minibatch.py`` (host code).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.dataframe import DataFrame, Partition, _partition_len
from ..core.params import Param
from ..core.pipeline import Transformer


def _slice_to_batch_rows(p: Partition, bounds: List[int]) -> Partition:
    out: Partition = {}
    for name, col in p.items():
        vals = np.empty(len(bounds) - 1, dtype=object)
        for bi in range(len(bounds) - 1):
            chunk = col[bounds[bi]:bounds[bi + 1]]
            vals[bi] = list(chunk)
        out[name] = vals
    return out


class FixedMiniBatchTransformer(Transformer):
    """Group every ``batchSize`` consecutive rows into one batch row
    (FixedMiniBatchTransformer, MiniBatchTransformer.scala:29-38)."""

    batchSize = Param("batchSize", "Rows per batch", 10, lambda v: v > 0, int)
    maxBufferSize = Param("maxBufferSize", "Buffering bound (parity; eager here)",
                          2147483647, ptype=int)
    buffered = Param("buffered", "Background buffering (parity; eager here)", False,
                     ptype=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        b = self.get("batchSize")

        def fn(p: Partition) -> Partition:
            n = _partition_len(p)
            bounds = sorted(set(list(range(0, n, b)) + [n])) or [0, 0]
            return _slice_to_batch_rows(p, bounds)

        return df.map_partitions(fn)


class DynamicMiniBatchTransformer(Transformer):
    """Batch = whatever is available now (DynamicMiniBatchTransformer parity).

    In streaming, dynamic batching drains the queue; on a materialized partition the
    drain is the whole partition, capped by ``maxBatchSize``.
    """

    maxBatchSize = Param("maxBatchSize", "Upper bound on batch size", 2147483647,
                         lambda v: v > 0, int)

    def transform(self, df: DataFrame) -> DataFrame:
        cap = self.get("maxBatchSize")

        def fn(p: Partition) -> Partition:
            n = _partition_len(p)
            bounds = sorted(set(list(range(0, n, cap)) + [n])) or [0, 0]
            return _slice_to_batch_rows(p, bounds)

        return df.map_partitions(fn)


class TimeIntervalMiniBatchTransformer(Transformer):
    """Batch rows arriving within a time window (TimeIntervalMiniBatchTransformer).

    On a materialized partition all rows are 'already arrived': one batch per
    partition (capped by maxBatchSize) — matching the reference's semantics when
    the source outruns the interval.
    """

    millisToWait = Param("millisToWait", "Window length in ms", 1000,
                         lambda v: v > 0, int)
    maxBatchSize = Param("maxBatchSize", "Upper bound on batch size", 2147483647,
                         lambda v: v > 0, int)

    def transform(self, df: DataFrame) -> DataFrame:
        return DynamicMiniBatchTransformer(
            maxBatchSize=self.get("maxBatchSize")).transform(df)


class FlattenBatch(Transformer):
    """Inverse of minibatching: explode array-valued batch rows back to scalar rows
    (FlattenBatch, MiniBatchTransformer.scala:174+)."""

    def transform(self, df: DataFrame) -> DataFrame:
        def fn(p: Partition) -> Partition:
            names = list(p)
            n_batches = _partition_len(p)
            lengths = []
            for bi in range(n_batches):
                ls = {len(p[name][bi]) for name in names
                      if isinstance(p[name][bi], (list, tuple, np.ndarray))}
                lengths.append(max(ls) if ls else 1)
            total = int(sum(lengths))
            out: Partition = {}
            for name in names:
                vals = np.empty(total, dtype=object)
                k = 0
                for bi in range(n_batches):
                    v = p[name][bi]
                    if isinstance(v, (list, tuple, np.ndarray)):
                        for item in list(v)[:lengths[bi]]:
                            vals[k] = item
                            k += 1
                        k += lengths[bi] - min(lengths[bi], len(v))
                    else:  # scalar: replicate across the batch (non-batched col)
                        for _ in range(lengths[bi]):
                            vals[k] = v
                            k += 1
                out[name] = vals
            return out

        return df.map_partitions(fn)
