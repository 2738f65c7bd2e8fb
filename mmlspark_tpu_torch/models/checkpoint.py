"""Train-state checkpointing: params, optimizer state and the step (the port
of ``mmlspark_tpu/models/checkpoint.py``).

The reference writes an Orbax checkpoint directory. The port writes its own
format, one file: a ``torch.save`` of the state's tensors copied to the CPU
(nested dicts keyed like the params tree) and the step, written atomically
(``core.faults.atomic_write_bytes``: a crash leaves the old checkpoint or
the new one, never a torn one). A reference Orbax directory is not read.

A state on a mesh (``TrainState.mesh``) is saved whole: its blocks are
gathered, rank 0 writes the file in the same format, and every rank waits
for it. A load onto a sharded ``like`` gives each rank its blocks of the
saved leaves (the reference's restore onto mesh shardings).
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
    durable once it returns. Collective for a state on a mesh: every rank
    calls it, rank 0 writes."""
    def cpu(t):
        return t.detach().to("cpu", copy=True)

    params, opt_state = state.params, state.opt_state
    mesh = state.mesh
    if mesh is not None:
        from ..parallel.mesh import barrier, gather_tree

        params = gather_tree(params, state.shardings, mesh)
        opt_state = {"trace": gather_tree(opt_state["trace"],
                                          state.shardings, mesh)}
    if mesh is None or mesh.rank == 0:
        blob = {"format": FORMAT, "params": _tree_map(cpu, params),
                "opt_state": _tree_map(cpu, opt_state),
                "step": int(state.step)}
        buf = io.BytesIO()
        torch.save(blob, buf)
        atomic_write_bytes(os.path.abspath(path), buf.getvalue())
    if mesh is not None:
        barrier(mesh)


def load_train_state(path: str, like: Optional[TrainState] = None
                     ) -> TrainState:
    """Restore a TrainState. With ``like`` (e.g. a fresh
    ``init_train_state``), each tensor goes to the device and dtype of
    ``like``'s tensor under the same key, and the trees must match;
    without it, tensors stay on the CPU. A ``like`` on a mesh takes this
    rank's block of each saved leaf (its ``shardings``)."""
    with open(path, "rb") as fh:
        blob = torch.load(fh, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path} is not a train-state checkpoint of this "
                         f"package ({FORMAT})")
    params, opt_state = blob["params"], blob["opt_state"]
    if like is None:
        return TrainState(params, opt_state, int(blob["step"]))
    if like.mesh is not None:
        from ..parallel.mesh import shard_tree

        params = shard_tree(params, like.shardings, like.mesh)
        opt_state = {"trace": shard_tree(opt_state["trace"], like.shardings,
                                         like.mesh)}

    def place(saved, ref):
        if tuple(saved.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint shape {tuple(saved.shape)} does "
                             f"not match {tuple(ref.shape)}")
        return saved.to(device=ref.device, dtype=ref.dtype)

    params = _match(params, like.params, place)
    opt_state = _match(opt_state, like.opt_state, place)
    return TrainState(params, opt_state, int(blob["step"]), mesh=like.mesh,
                      shardings=like.shardings)


def _match(saved: Dict[str, Any], ref: Dict[str, Any], fn) -> Dict[str, Any]:
    if set(saved) != set(ref):
        raise KeyError(f"checkpoint keys {sorted(saved)[:10]} do not match "
                       f"the state's {sorted(ref)[:10]}")
    return _tree_map(fn, saved, ref)
