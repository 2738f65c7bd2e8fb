"""Mid-fit GBDT checkpoints: stop at iteration k, resume to the same model.

Counterpart of the reference's ``mmlspark_tpu/gbdt/checkpoint.py``, in its
file format (``mmlspark_tpu.gbdt.ckpt.v1``), so a checkpoint written by
either package resumes in the other. A checkpoint holds the model so far
and the loop state the next iteration reads: the running scores (f64), the
host random generator's state (bagging, feature fraction, GOSS, DART), the
persistent bagging mask and the early-stopping bookkeeping. With all of it
restored, iterations k..N of a resumed fit repeat those of an uninterrupted
one, so the final models are identical.

On CUDA the running scores live on the device as Kahan-compensated f32
pairs (``booster._add_leaf_values``); the port adds both halves under the
optional key ``kahan`` (the reference ignores it), so a resumed card fit
restarts from the same pair and stays identical too.

A sharded fit (``train(mesh=)``) saves every row's scores and Kahan pair,
gathered over the mesh's data group (the padded ``(n, k)`` the reference
writes), and the number of data shards under the optional key
``data_shards`` (absent: one); a resume on another count raises.

Checkpoints are single JSON files written atomically and durably
(``core.faults.atomic_write_text``): a crash mid-write leaves the previous
complete checkpoint.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np

from ..core.faults import atomic_write_text

CKPT_FORMAT = "mmlspark_tpu.gbdt.ckpt.v1"


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """``train(..., checkpoint=CheckpointConfig(path))``.

    ``every_k``: checkpoint every k completed iterations (and at the end).
    ``resume``: load ``path`` if it exists and continue from its iteration
    (the params must match the checkpoint's; a mismatch raises)."""

    path: str
    every_k: int = 10
    resume: bool = True


def _arr_to_json(a: np.ndarray) -> Dict[str, Any]:
    a = np.ascontiguousarray(a)
    return {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
            "dtype": str(a.dtype), "shape": list(a.shape)}


def _arr_from_json(d: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["b64"]),
                         dtype=d["dtype"]).reshape(d["shape"]).copy()


def save_checkpoint(path: str, *, params_dict: Dict[str, Any],
                    model_string: str, iteration: int,
                    scores: np.ndarray, rng_state: Dict[str, Any],
                    bag_mask: np.ndarray, best_val: float, best_iter: int,
                    rounds_no_improve: int,
                    kahan: Optional[np.ndarray] = None,
                    data_shards: int = 1) -> None:
    """Write one checkpoint atomically. ``kahan``: the device's [2, ...]
    f32 (score, compensation) pair, when the fit keeps one; ``data_shards``:
    the row blocks of the fit that wrote it."""
    d = {
        "format": CKPT_FORMAT,
        "params": _jsonable_params(params_dict),
        "iteration": int(iteration),
        "model": model_string,
        "scores": _arr_to_json(np.asarray(scores, dtype=np.float64)),
        "rng_state": rng_state,
        "bag_mask": _arr_to_json(np.asarray(bag_mask, dtype=bool)),
        "best_val": float(best_val),
        "best_iter": int(best_iter),
        "rounds_no_improve": int(rounds_no_improve),
    }
    if kahan is not None:
        d["kahan"] = _arr_to_json(np.asarray(kahan, dtype=np.float32))
    if data_shards != 1:
        d["data_shards"] = int(data_shards)
    atomic_write_text(path, json.dumps(d))


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """The parsed checkpoint (arrays decoded), or None when absent."""
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        d = json.load(fh)
    if d.get("format") != CKPT_FORMAT:
        raise ValueError(f"bad checkpoint format {d.get('format')!r} "
                         f"in {path!r}")
    for key in ("scores", "bag_mask", "kahan"):
        if key in d:
            d[key] = _arr_from_json(d[key])
    return d


def _jsonable_params(params_dict: Dict[str, Any]) -> Dict[str, Any]:
    """TrainParams asdict with tuples as lists (stable through JSON)."""
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in params_dict.items()}


def check_params_match(saved: Dict[str, Any],
                       current: Dict[str, Any], path: str) -> None:
    """Raise unless the checkpoint was written with these train params."""
    cur = _jsonable_params(current)
    if saved != cur:
        diff = sorted(k for k in set(saved) | set(cur)
                      if saved.get(k) != cur.get(k))
        raise ValueError(
            f"checkpoint {path!r} was written with different train params "
            f"(mismatched: {diff}); refusing to resume — delete the "
            f"checkpoint or restore the original params")
