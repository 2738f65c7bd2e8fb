"""Train-state checkpointing: params, optimizer state and the step (the port
of ``mmlspark_tpu/models/checkpoint.py``).

The reference writes an Orbax checkpoint directory. The port writes its own
format, one file: a ``torch.save`` of the state's tensors copied to the CPU
(nested dicts keyed like the params tree) and the step, written atomically
(``core.faults.atomic_write_bytes``: a crash leaves the old checkpoint or
the new one, never a torn one). A reference Orbax directory is not read.
"""

from __future__ import annotations

import io
import os
from typing import Any, Dict, Optional

import torch

from ..core.faults import atomic_write_bytes
from .training import TrainState, _tree_map

FORMAT = "mmlspark_tpu_torch.train_state/1"


def save_train_state(state: TrainState, path: str) -> None:
    """Write params + opt_state + step to the file ``path`` (overwrites);
    durable once it returns."""
    def cpu(t):
        return t.detach().to("cpu", copy=True)

    blob = {"format": FORMAT, "params": _tree_map(cpu, state.params),
            "opt_state": _tree_map(cpu, state.opt_state),
            "step": int(state.step)}
    buf = io.BytesIO()
    torch.save(blob, buf)
    atomic_write_bytes(os.path.abspath(path), buf.getvalue())


def load_train_state(path: str, like: Optional[TrainState] = None
                     ) -> TrainState:
    """Restore a TrainState. With ``like`` (e.g. a fresh
    ``init_train_state``), each tensor goes to the device and dtype of
    ``like``'s tensor under the same key, and the trees must match;
    without it, tensors stay on the CPU."""
    with open(path, "rb") as fh:
        blob = torch.load(fh, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path} is not a train-state checkpoint of this "
                         f"package ({FORMAT})")
    params, opt_state = blob["params"], blob["opt_state"]
    if like is not None:
        def place(saved, ref):
            if tuple(saved.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint shape {tuple(saved.shape)} does "
                                 f"not match {tuple(ref.shape)}")
            return saved.to(device=ref.device, dtype=ref.dtype)

        params = _match(params, like.params, place)
        opt_state = _match(opt_state, like.opt_state, place)
    return TrainState(params, opt_state, int(blob["step"]))


def _match(saved: Dict[str, Any], ref: Dict[str, Any], fn) -> Dict[str, Any]:
    if set(saved) != set(ref):
        raise KeyError(f"checkpoint keys {sorted(saved)[:10]} do not match "
                       f"the state's {sorted(ref)[:10]}")
    return _tree_map(fn, saved, ref)
