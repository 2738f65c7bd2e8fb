"""Weights carry-over from the JAX reference's models.

``load_jax_params(model, params)`` fills a port ``FunctionModel`` from the
reference's ``FunctionModel.params``, passed as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, ref.params)``), key for key: the port's
layers register their parameters under the reference's key names and
shapes. ``Dense`` keeps the reference's ``[in, out]`` kernel layout, and so
do the attention projections; ``Conv2D`` keeps its HWIO ``kernel``,
``BatchNorm`` its ``scale``/``bias``/``mean``/``var`` and ``MoE`` its
``router``/``w1``/``w2``, so no weight is transposed. A missing key, an
extra key or a shape that differs raises; values are cast to the port
parameter's dtype.

``load_jax_train_state(model, params, trace, step)`` does the same for a
reference ``TrainState``: its params and its optax momentum trace (both as
nested dicts of numpy arrays, the trace taken from ``opt_state``) become a
port ``training.TrainState`` on the model's parameters' device.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .module import FunctionModel, _flatten, _nest
from .training import TrainState, params_of


def load_jax_params(model: FunctionModel, params: Mapping[str, Any]
                    ) -> FunctionModel:
    """Copy the reference's params (nested dicts of arrays) into ``model``'s
    parameters, in place; returns ``model``."""
    flat = _flatten(params)
    named = dict(model.module.named_parameters())
    missing = sorted(set(named) - set(flat))
    extra = sorted(set(flat) - set(named))
    if missing or extra:
        raise KeyError(f"params do not match the model: missing {missing}, "
                       f"extra {extra}")
    for name, p in named.items():
        value = np.asarray(flat[name])
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} in params, "
                             f"{tuple(p.shape)} in the model")
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(torch.from_numpy(np.array(flat[name])).to(p.dtype))
    return model


def load_jax_train_state(model: FunctionModel, params: Mapping[str, Any],
                         trace: Mapping[str, Any], step: int,
                         device=None) -> TrainState:
    """A port TrainState from the reference's params, momentum trace and
    step; ``model``'s own parameters take ``params`` (``load_jax_params``)
    and the state holds copies of them on ``device`` (default: ``cuda``
    unless the caller asked for the CPU)."""
    load_jax_params(model, params)
    state_params = params_of(model.module, device)
    flat = _flatten(trace)

    def leaf(name, p):
        value = np.asarray(flat[name])
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"trace {name}: shape {tuple(value.shape)}, "
                             f"param {tuple(p.shape)}")
        return torch.from_numpy(np.array(value)).to(p.device, p.dtype)

    named = _flatten(state_params)
    if set(flat) != set(named):
        raise KeyError(f"trace does not match the model: "
                       f"{sorted(set(flat) ^ set(named))[:10]}")
    trace_tree = _nest({n: leaf(n, p) for n, p in named.items()})
    return TrainState(state_params, {"trace": trace_tree}, int(step))
