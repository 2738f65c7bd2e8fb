"""Row stacking and static-shape batching helpers.

Copy of ``stack_rows``, ``is_sparse_row``, ``sparse_width``,
``densify_sparse``, ``Batch``, ``next_bucket``, ``pad_batch``,
``Minibatcher``, ``_crop`` and ``concat_outputs`` from the reference's
``mmlspark_tpu/parallel/batching.py`` (the rest of that module — device
prefetchers and batchers — waits for ROADMAP A step 6, with the
SlotPool; the serving slice batches in ``serving/server.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


def next_bucket(n: int, buckets: Optional[Sequence[int]] = None,
                multiple: int = 8) -> int:
    """Smallest allowed static size >= n. Default: next power of two >=
    max(n, multiple). ``buckets`` (an ascending bucket set, the fused
    executor's ``buckets`` knob) overrides the power-of-two policy."""
    if n <= 0:
        return multiple
    if buckets:
        for b in buckets:
            if b >= n:
                return b
        return buckets[-1]
    return max(multiple, 1 << (n - 1).bit_length())


def pad_batch(arr: np.ndarray, target: int, pad_value: float = 0.0) -> np.ndarray:
    """Pad leading dim of ``arr`` up to ``target`` rows with ``pad_value``."""
    n = arr.shape[0]
    if n == target:
        return arr
    if n > target:
        raise ValueError(f"batch of {n} rows exceeds target {target}")
    pad_width = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=pad_value)


@dataclasses.dataclass
class Batch:
    """One padded, static-shape batch: host arrays + validity mask."""

    arrays: Dict[str, np.ndarray]
    mask: np.ndarray          # [B] bool, True = real row
    num_valid: int


def is_sparse_row(v) -> bool:
    """True for the framework's sparse-row struct ``{"indices", "values"
    [, "size"]}`` (shared by TextFeaturizer and the VW featurizer)."""
    return isinstance(v, dict) and "indices" in v and "values" in v


def sparse_width(col) -> int:
    """The dense width of a sparse-row column: the declared ``size`` when the
    producer carries one (widths then do NOT depend on which rows a partition
    happens to hold), else max index + 1."""
    width = 0
    for v in col:
        if v is None:
            continue
        s = int(v.get("size", 0))
        if not s:
            idx = np.asarray(v["indices"])
            s = int(idx.max()) + 1 if idx.size else 0
        width = max(width, s)
    return width


def densify_sparse(col, width: int, dtype=np.float64) -> np.ndarray:
    """Sparse-row column -> dense [N, width]. Indices >= width are dropped."""
    out = np.zeros((len(col), width), dtype=dtype)
    for i, v in enumerate(col):
        if v is None:
            continue
        idx = np.asarray(v["indices"], dtype=np.int64)
        keep = idx < width
        out[i, idx[keep]] = np.asarray(v["values"], dtype=dtype)[keep]
    return out


def stack_rows(col: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Stack a column of per-row arrays/scalars into one dense [N, ...] array.

    Sparse rows densify here (via ``sparse_width``/``densify_sparse``).
    Ragged dense rows are an error — resize/pad upstream.
    """
    if col.dtype != object:
        return np.ascontiguousarray(col, dtype=dtype)
    probe = next((v for v in col if v is not None), None)
    if is_sparse_row(probe):
        width = sparse_width(col)
        if width > (1 << 22):
            raise ValueError(
                f"sparse column width {width} is too large to densify — "
                f"use a smaller feature space")
        return densify_sparse(col, width, dtype=dtype)
    rows = [np.asarray(v, dtype=dtype) for v in col]
    shapes = {r.shape for r in rows}
    if len(shapes) > 1:
        raise ValueError(f"Ragged rows (shapes {shapes}); resize/pad before batching")
    return np.stack(rows)


class Minibatcher:
    """FixedMiniBatchTransformer-equivalent over column dicts.

    With ``bucket=True`` the final short batch is padded (with
    ``pad_value``) to a bucket size so batch shapes repeat across
    partitions; per-row outputs are later cropped by ``num_valid``.
    ``preserve_int``: integer columns keep their dtype instead of casting to
    ``dtype`` (token ids must reach the embedding as ints).
    """

    def __init__(self, batch_size: int = 32, bucket: bool = True,
                 dtype=np.float32, pad_value: float = 0.0,
                 preserve_int: bool = False):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = batch_size
        self.bucket = bucket
        self.dtype = dtype
        self.pad_value = pad_value
        self.preserve_int = preserve_int

    def _col_dtype(self, col):
        if not self.preserve_int:
            return self.dtype
        if getattr(col, "dtype", None) is not None and col.dtype != object:
            return None if np.issubdtype(col.dtype, np.integer) else self.dtype
        probe = next((v for v in col if v is not None), None)
        if probe is not None and np.issubdtype(np.asarray(probe).dtype,
                                               np.integer):
            return None
        return self.dtype

    def batches(self, part: Dict[str, np.ndarray], cols: Sequence[str]
                ) -> Iterator[Batch]:
        n = len(next(iter(part.values()))) if part else 0
        dense = {c: stack_rows(part[c], self._col_dtype(part[c]))
                 for c in cols}
        for start in range(0, n, self.batch_size):
            stop = min(start + self.batch_size, n)
            m = stop - start
            target = self.batch_size if (m == self.batch_size or not self.bucket) \
                else next_bucket(m)
            target = min(target, self.batch_size) if m < self.batch_size else target
            arrays = {c: pad_batch(dense[c][start:stop], target, self.pad_value)
                      for c in cols}
            mask = np.zeros(target, dtype=bool)
            mask[:m] = True
            yield Batch(arrays, mask, m)


def _crop(res: Any, n: int) -> Any:
    """The first ``n`` rows of every array or tensor in ``res`` (dicts and
    sequences of them): a padded batch's outputs without the padding."""
    if isinstance(res, dict):
        return {k: _crop(v, n) for k, v in res.items()}
    if isinstance(res, (list, tuple)):
        return type(res)(_crop(v, n) for v in res)
    return res[:n] if hasattr(res, "shape") else np.asarray(res)[:n]


def concat_outputs(outs: List[Any]) -> Any:
    """FlattenBatch parity: merge per-batch outputs back into full-length
    columns."""
    if not outs:
        return outs
    first = outs[0]
    if isinstance(first, dict):
        return {k: concat_outputs([o[k] for o in outs]) for k in first}
    if isinstance(first, (list, tuple)) and not isinstance(first, np.ndarray):
        return type(first)(concat_outputs([o[i] for o in outs])
                           for i in range(len(first)))
    return np.concatenate([np.asarray(o) for o in outs], axis=0)
