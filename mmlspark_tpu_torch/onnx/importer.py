"""ONNX -> GraphModule importer (the port of ``mmlspark_tpu/onnx/importer.py``).

Any ONNX checkpoint becomes a ``FunctionModel`` whose ``GraphModule`` runs
the graph with torch ops on the card:
  1. parse ModelProto (``onnx/proto.py``, no external deps),
  2. constant-fold on numpy every node whose inputs are all initializers
     (this collapses the Shape->Gather->Unsqueeze->Concat->Reshape idioms
     exporters emit for a dynamic batch),
  3. name the remaining compute nodes (anonymous ones after their op),
  4. wrap them as GraphModule + FunctionModel with auto-derived
     ``layer_names`` (so ImageFeaturizer.cutOutputLayers works) and
     ``data_format="NCHW"`` for image inputs.
Graph inputs past the first are secondary inputs, fed by dict (DNNModel's
multi-input ``feedDict``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..models.graph_module import GraphModule, GraphNode
from ..models.module import FunctionModel
from . import proto

# ops we can evaluate on host numpy during constant folding
_FOLDABLE = {
    "Shape", "Gather", "Unsqueeze", "Squeeze", "Concat", "Cast", "Slice",
    "Add", "Sub", "Mul", "Div", "Constant", "Identity", "Reshape", "Transpose",
    "ConstantOfShape", "Range", "Equal", "Where",
}


def _fold_node(node: proto.Node, inputs: List[Optional[np.ndarray]]):
    op = node.op_type
    a = inputs
    if op == "Constant":
        t = node.attrs.get("value")
        if isinstance(t, proto.Tensor):
            return t.to_numpy()
        for key, dtype in (("value_float", np.float32), ("value_int", np.int64)):
            if key in node.attrs:
                return np.asarray(node.attrs[key], dtype=dtype)
        if "value_floats" in node.attrs:
            return np.asarray(node.attrs["value_floats"], dtype=np.float32)
        if "value_ints" in node.attrs:
            return np.asarray(node.attrs["value_ints"], dtype=np.int64)
        raise ValueError(f"Constant node {node.name!r} with no value")
    if op == "Identity":
        return a[0]
    if op == "Shape":
        return np.asarray(a[0].shape, dtype=np.int64)
    if op == "Gather":
        return np.take(a[0], np.asarray(a[1]), axis=int(node.attrs.get("axis", 0)))
    if op == "Unsqueeze":
        axes = node.attrs.get("axes") or np.asarray(a[1]).tolist()
        out = a[0]
        for ax in sorted(int(x) for x in axes):
            out = np.expand_dims(out, ax)
        return out
    if op == "Squeeze":
        axes = node.attrs.get("axes") or (np.asarray(a[1]).tolist() if len(a) > 1 else None)
        return np.squeeze(a[0], axis=tuple(int(x) for x in axes) if axes else None)
    if op == "Concat":
        return np.concatenate(a, axis=int(node.attrs.get("axis", 0)))
    if op == "Cast":
        to = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_,
              10: np.float16, 11: np.float64}[int(node.attrs.get("to", 1))]
        return a[0].astype(to)
    if op == "Reshape":
        shape = [int(s) for s in np.asarray(a[1]).tolist()]
        shape = [a[0].shape[i] if s == 0 else s for i, s in enumerate(shape)]
        return a[0].reshape(shape)
    if op == "Transpose":
        return np.transpose(a[0], axes=node.attrs.get("perm"))
    if op == "Slice":
        starts = np.asarray(a[1]).tolist()
        ends = np.asarray(a[2]).tolist()
        axes = np.asarray(a[3]).tolist() if len(a) > 3 and a[3] is not None \
            else list(range(len(starts)))
        steps = np.asarray(a[4]).tolist() if len(a) > 4 and a[4] is not None \
            else [1] * len(starts)
        idx: List = [slice(None)] * a[0].ndim
        for s, e, ax, st in zip(starts, ends, axes, steps):
            idx[int(ax)] = slice(int(s), int(e), int(st))
        return a[0][tuple(idx)]
    if op == "ConstantOfShape":
        t = node.attrs.get("value")
        fill = t.to_numpy().reshape(()) if isinstance(t, proto.Tensor) else np.float32(0)
        return np.full([int(s) for s in np.asarray(a[0]).tolist()], fill)
    if op == "Range":
        return np.arange(np.asarray(a[0]).item(), np.asarray(a[1]).item(),
                         np.asarray(a[2]).item())
    if op == "Equal":
        return np.equal(a[0], a[1])
    if op == "Where":
        return np.where(a[0], a[1], a[2])
    if op in ("Add", "Sub", "Mul", "Div"):
        fn = {"Add": np.add, "Sub": np.subtract,
              "Mul": np.multiply, "Div": np.divide}[op]
        return fn(a[0], a[1])
    raise AssertionError(op)


def import_onnx(path_or_bytes, input_shape: Optional[Sequence[int]] = None,
                compute_dtype: str = "float32",
                layer_names: Optional[List[str]] = None,
                name: Optional[str] = None) -> FunctionModel:
    """Load an ONNX model file (path or bytes) into a FunctionModel
    (GraphModule + weights, on the CPU until a forward puts them on a
    device).

    input_shape: per-example shape WITHOUT the batch dim (e.g. (3, 224, 224) NCHW).
      Defaults to the graph input's declared static dims (dynamic batch dim dropped).
    layer_names: ordered tap paths (head → backbone) for ImageFeaturizer's
      cutOutputLayers; auto-derived from the tail of the graph when omitted.
    """
    model = proto.load_model(path_or_bytes)
    g = model.graph

    consts: Dict[str, np.ndarray] = {t.name: t.to_numpy() for t in g.initializers}
    init_names = set(consts)
    # old exporters list initializers as inputs too; real inputs are the rest.
    # The first is the primary (ARGUMENT_0); any others become secondary
    # inputs fed by dict (DNNModel feedDict parity for multi-input models).
    real_inputs = [vi for vi in g.inputs if vi.name not in init_names]
    if not real_inputs:
        raise ValueError("ONNX graph has no non-initializer input")
    graph_input = real_inputs[0]
    extra_input_shapes: Dict[str, tuple] = {}
    extra_input_dtypes: Dict[str, np.dtype] = {}
    for vi in real_inputs[1:]:
        # shapes/dtypes are introspection metadata (init()'s shape probe);
        # dynamic dims stay None — actual shapes arrive with the fed arrays
        tail = (vi.dims or [])[1:]
        extra_input_shapes[vi.name] = tuple(
            int(d) if d is not None else None for d in tail)
        extra_input_dtypes[vi.name] = np.dtype(
            proto._DT_TO_NP.get(vi.elem_type, np.float32))
    if input_shape is None:
        dims = graph_input.dims or []
        if len(dims) < 1:
            raise ValueError(
                f"graph input {graph_input.name!r} has no declared shape; "
                "pass input_shape=")
        tail = dims[1:]  # drop batch dim
        if any(d is None for d in tail):
            raise ValueError(
                f"graph input {graph_input.name!r} has dynamic non-batch dims {dims}; "
                "pass input_shape=")
        input_shape = tuple(int(d) for d in tail)
    input_shape = tuple(input_shape)

    # --- constant folding pass (also fixes any exporter node ordering) ------
    nodes = list(g.nodes)
    compute: List[proto.Node] = []
    pending = nodes
    # iterate to fixpoint: a fold can enable another fold; exporters emit topo order,
    # so one ordered pass folds everything reachable — loop twice for safety
    for _ in range(2):
        remaining: List[proto.Node] = []
        for node in pending:
            known = all((not i) or i in consts for i in node.inputs)
            if known and node.op_type in _FOLDABLE:
                try:
                    val = _fold_node(
                        node, [consts[i] if i else None for i in node.inputs])
                    consts[node.outputs[0]] = np.asarray(val)
                    continue
                except Exception:
                    pass  # fall through: execute at runtime
            remaining.append(node)
        if remaining == pending:
            break
        pending = remaining
    compute = pending

    # --- name + wire the runtime nodes --------------------------------------
    graph_nodes: List[GraphNode] = []
    used_names: Dict[str, int] = {}
    for i, n in enumerate(compute):
        base = n.name or f"{n.op_type.lower()}_{i}"
        if base in used_names:
            used_names[base] += 1
            base = f"{base}__{used_names[base]}"
        else:
            used_names[base] = 0
        graph_nodes.append(GraphNode(
            name=base, op_type=n.op_type, inputs=list(n.inputs),
            outputs=list(n.outputs), attrs=dict(n.attrs)))

    if not g.outputs:
        raise ValueError("ONNX graph declares no outputs")
    output_name = g.outputs[0].name

    # params = only initializers actually consumed by runtime nodes
    needed = {i for n in graph_nodes for i in n.inputs if i in consts}
    params = {k: consts[k] for k in needed}

    module = GraphModule(
        graph_nodes, params, input_name=graph_input.name, output_name=output_name,
        input_shape=input_shape, name=name or (g.name or "onnx_model"),
        compute_dtype=compute_dtype, extra_input_shapes=extra_input_shapes,
        extra_input_dtypes=extra_input_dtypes,
        input_dtype=proto._DT_TO_NP.get(graph_input.elem_type, np.float32))

    if layer_names is None:
        # taps from the head backwards: last nodes producing "cut-worthy" outputs
        interesting = [gn.name for gn in graph_nodes
                       if gn.op_type in ("Gemm", "MatMul", "GlobalAveragePool",
                                         "Flatten", "AveragePool", "Softmax")]
        layer_names = list(reversed(interesting[-4:]))

    return FunctionModel(
        module=module, input_shape=input_shape,
        layer_names=layer_names, name=module.name,
        data_format="NCHW" if len(input_shape) == 3 else "NHWC")
