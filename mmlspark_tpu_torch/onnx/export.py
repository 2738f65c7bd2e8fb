"""Export the port's module trees (``models/module.py``) to ONNX (the port
of ``mmlspark_tpu/onnx/export.py``).

Walks ``Sequential``/``Residual``/``Conv2D``/``BatchNorm``/``Dense``/
``MaxPool``/``GlobalAvgPool``/``Fn`` (relu, flatten) as the reference does,
node for node and name for name, so the same weights give the reference's
bytes. Layout: the modules compute NHWC; the file keeps ONNX-standard NCHW
activations by transposing conv kernels HWIO -> OIHW, so any stock ONNX
runtime executes it unmodified. The output's shape is probed by running
the module on one zero example on the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import module as M
from ..models.module import _flatten
from . import proto


def _pad_attrs(padding) -> Dict:
    """ONNX attrs for a Conv2D/MaxPool padding spec ("SAME"/"VALID"/explicit pairs)."""
    if padding == "SAME":
        return {"auto_pad": "SAME_UPPER"}
    if padding == "VALID":
        return {}
    (t, b), (l, r) = padding  # ONNX pads order: x1_begin, x2_begin, x1_end, x2_end
    return {"pads": [int(t), int(l), int(b), int(r)]}


class _Exporter:
    def __init__(self) -> None:
        self.nodes: List[proto.Writer] = []
        self.initializers: List[proto.Writer] = []
        self._n = 0

    def tname(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def const(self, hint: str, arr) -> str:
        name = self.tname(hint)
        self.initializers.append(proto.make_tensor(name, _numpy(arr)))
        return name

    def emit(self, op: str, inputs: List[str], hint: str, **attrs) -> str:
        out = self.tname(hint)
        self.nodes.append(proto.make_node(op, inputs, [out], name=out, **attrs))
        return out

    # -- module dispatch -----------------------------------------------------
    def walk(self, mod: M.Module, params: Dict, x: str, rank: int) -> Tuple[str, int]:
        """Emit nodes for `mod`; returns (output tensor name, activation rank)."""
        if isinstance(mod, M.Sequential):
            for lname, layer in mod.layers:
                x, rank = self.walk(layer, params.get(lname, {}), x, rank)
            return x, rank
        if isinstance(mod, M.Residual):
            y, yr = self.walk(mod.body, params["body"], x, rank)
            s, _ = (self.walk(mod.shortcut, params["shortcut"], x, rank)
                    if mod.shortcut is not None else (x, rank))
            added = self.emit("Add", [y, s], "res_add")
            return self.emit("Relu", [added], "res_relu"), yr
        if isinstance(mod, M.Conv2D):
            # HWIO -> OIHW
            k = self.const("conv_w", np.transpose(_numpy(params["kernel"]),
                                                  (3, 2, 0, 1)))
            inputs = [x, k]
            if mod.use_bias:
                inputs.append(self.const("conv_b", params["bias"]))
            attrs: Dict = {"strides": list(mod.strides),
                           "kernel_shape": list(mod.kernel_size)}
            attrs.update(_pad_attrs(mod.padding))
            return self.emit("Conv", inputs, "conv", **attrs), 4
        if isinstance(mod, M.BatchNorm):
            ins = [x, self.const("bn_scale", params["scale"]),
                   self.const("bn_bias", params["bias"]),
                   self.const("bn_mean", params["mean"]),
                   self.const("bn_var", params["var"])]
            return self.emit("BatchNormalization", ins, "bn", epsilon=float(mod.eps)), rank
        if isinstance(mod, M.Dense):
            ins = [x, self.const("dense_w", params["kernel"])]
            if mod.use_bias:
                ins.append(self.const("dense_b", params["bias"]))
            return self.emit("Gemm", ins, "gemm"), 2
        if isinstance(mod, M.MaxPool):
            attrs = {"kernel_shape": list(mod.window), "strides": list(mod.strides)}
            attrs.update(_pad_attrs(mod.padding))
            return self.emit("MaxPool", [x], "maxpool", **attrs), 4
        if isinstance(mod, M.GlobalAvgPool):
            pooled = self.emit("GlobalAveragePool", [x], "gap")
            return self.emit("Flatten", [pooled], "gap_flat", axis=1), 2
        if isinstance(mod, M.Fn):
            if mod.fn is M._relu_fn:
                return self.emit("Relu", [x], "relu"), rank
            if mod.fn is M._flatten_fn:
                if rank == 4:
                    # NHWC element order: transpose NCHW act back before flattening
                    x = self.emit("Transpose", [x], "to_nhwc", perm=[0, 2, 3, 1])
                return self.emit("Flatten", [x], "flatten", axis=1), 2
            raise NotImplementedError(f"cannot export Fn wrapping {mod.fn}")
        raise NotImplementedError(f"cannot export module type {type(mod).__name__}")


def export_onnx(module: M.Module, params: Optional[Dict] = None,
                input_shape: Tuple[int, ...] = (), path: Optional[str] = None,
                name: str = "model") -> bytes:
    """Serialize (module, params) to ONNX bytes (and optionally a file).

    params: nested dicts of arrays or tensors keyed like
      ``FunctionModel.params``; None takes the module's own parameters.
    input_shape: per-example shape in the module's own convention (NHWC for
      images); the emitted graph takes standard ONNX NCHW input.
    """
    if params is None:
        params = M._nest(dict(module.named_parameters()))
    ex = _Exporter()
    if len(input_shape) == 3:
        h, w, c = input_shape
        onnx_in_shape: List[Optional[int]] = [None, c, h, w]
        rank = 4
    else:
        onnx_in_shape = [None] + [int(d) for d in input_shape]
        rank = len(onnx_in_shape)
    in_name = "input"
    out, _rank = ex.walk(module, params, in_name, rank)

    # probe the output shape by running the module on the CPU
    probe = torch.zeros((1,) + tuple(input_shape), dtype=torch.float32)
    cpu = {k: torch.as_tensor(_numpy(v)) for k, v in _flatten(params).items()}
    with torch.inference_mode():
        out_arr = torch.func.functional_call(module, cpu, (probe,))
    out_dims: List[Optional[int]] = [None] + list(out_arr.shape[1:])

    blob = proto.make_model(
        ex.nodes, ex.initializers,
        [proto.make_value_info(in_name, onnx_in_shape)],
        [proto.make_value_info(out, out_dims)],
        graph_name=name)
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)
