"""Pipeline parallelism: the GPipe microbatch schedule over the ``pipe``
axis (the port of ``mmlspark_tpu/parallel/pipeline_parallel.py``).

Rank ``s`` of the ``pipe`` axis holds stage ``s`` of the layer stack (a
block of the params stacked with a leading [S] dim). Time runs for
``M + S - 1`` ticks: at tick ``t`` every stage applies its segment to its
current activation, then the activations go one hop to the next stage
(``parallel.mesh.ring_shift``, a send and a receive a rank); stage 0 feeds
microbatch ``t`` while stage ``S - 1`` emits microbatch ``t - (S - 1)``.
The bubble is the usual ``(S - 1) / (M + S - 1)``. The last stage's
outputs reach every rank by a sum over ``pipe`` (the other ranks add
zeros). The backward is autograd's: the shifts' backward sends the
gradients one hop back, the reverse schedule, as ``jax.grad`` runs it
through the reference's ``ppermute``. As in the reference, the choices
between a stage's feed and its received activation, and between an
emitted output and zeros, are selects on the rank's coordinate, so every
rank's graph has the same shifts and each rank's backward runs them all,
in the same order as its neighbours' (a shift whose result a rank left
out of its graph would never meet its partner's backward).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .mesh import PIPE_AXIS, _map_tree, all_reduce_axis, ring_shift

__all__ = ["pipeline_apply", "stack_stage_params"]


def stack_stage_params(per_stage_params):
    """[params of stage 0, params of stage 1, ...] (trees of the same keys)
    -> one tree with a leading [S] dim on every leaf."""
    return _map_tree(lambda *leaves: torch.stack([torch.as_tensor(v)
                                                  for v in leaves]),
                     *per_stage_params)


def pipeline_apply(stage_fn: Callable[[Any, Any], Any], stacked_params,
                   microbatches: torch.Tensor, mesh,
                   axis_name: str = PIPE_AXIS) -> torch.Tensor:
    """Run ``microbatches`` ([M, ...], every rank the same) through the
    stages; returns the [M, ...] outputs on every rank.

    ``stage_fn(stage_params, x) -> y`` is ONE stage; activations keep one
    shape from stage to stage. ``stacked_params``: a tree whose leaves have
    a leading dim of S (this rank takes block ``s``, its coordinate on
    ``axis_name``) or 1 (the rank's block already). Every rank of the
    ``pipe`` group calls it."""
    size = mesh.axis_size(axis_name)
    s = mesh.coord(axis_name)
    local = _map_tree(lambda a: a[s] if a.shape[0] == size else a[0],
                      stacked_params)
    m = int(microbatches.shape[0])
    ticks = m + size - 1
    dev = microbatches.device
    first = torch.tensor(s == 0, device=dev)
    last = torch.tensor(s == size - 1, device=dev)
    state = torch.zeros_like(microbatches[0])
    zero = torch.zeros_like(microbatches[0])
    outs = [zero] * m
    for t in range(ticks):
        x = torch.where(first, microbatches[min(t, m - 1)], state)
        y = stage_fn(local, x)
        done = t - (size - 1)
        if done >= 0:
            outs[done] = torch.where(last, y, torch.zeros_like(y))
        if t + 1 < ticks:            # the last tick's hop would go unused
            state = ring_shift(y, mesh, axis_name)
    return all_reduce_axis(torch.stack(outs), mesh, axis_name)
