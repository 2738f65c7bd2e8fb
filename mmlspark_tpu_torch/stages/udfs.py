"""Column helper functions (reference stages/udfs.scala: get_value_at, to_vector).

The port's copy of ``mmlspark_tpu/stages/udfs.py`` (host code).
"""

from __future__ import annotations

import numpy as np


def get_value_at(col: np.ndarray, index: int) -> np.ndarray:
    """Extract element ``index`` from each per-row vector (udfs.scala get_value_at)."""
    if col.dtype != object:
        return np.ascontiguousarray(col[:, index])
    return np.array([None if v is None else float(np.asarray(v)[index]) for v in col])


def to_vector(col: np.ndarray) -> np.ndarray:
    """Coerce a column of lists/arrays/scalars into per-row float64 vectors
    (udfs.scala to_vector)."""
    out = np.empty(len(col), dtype=object)
    for i, v in enumerate(col):
        out[i] = None if v is None else np.asarray(v, dtype=np.float64).reshape(-1)
    return out
