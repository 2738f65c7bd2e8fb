"""Weights carry-over from the JAX reference's models.

``load_jax_params(model, params)`` fills a port ``FunctionModel`` from the
reference's ``FunctionModel.params``, passed as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, ref.params)``), key for key: the port's
layers register their parameters under the reference's key names and
shapes. ``Dense`` keeps the reference's ``[in, out]`` kernel layout, and so
do the attention projections, so no weight is transposed. A missing key, an
extra key or a shape that differs raises; values are cast to the port
parameter's dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .module import FunctionModel


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


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

