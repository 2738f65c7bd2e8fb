"""GraphModule: an imported ONNX op graph run by PyTorch (the port of
``mmlspark_tpu/models/graph_module.py``).

The reference evaluates the graph's node list in topological order inside
one traced JAX function; here the same interpreter runs the nodes eagerly
as torch ops on the device of its input. ONNX semantics (NCHW convs and
pools) are kept as they are, and every node name is an addressable layer
path (``layer_paths``), so ``ImageFeaturizer.cutOutputLayers`` and
``DNNModel``'s fetch-node addressing work on imported models as on native
ones.

Where the values live:
  - floating initializers are parameters of the module (f64 ones as f32,
    as the reference computes them with JAX's 64-bit types off), so
    ``FunctionModel.device_params`` puts them on the card once;
  - integer and bool initializers (shapes, axes, indices) stay numpy arrays
    on the host, and so does what ``Shape`` returns: the shape arithmetic
    exporters emit for a dynamic batch (Shape -> Gather -> Unsqueeze ->
    Concat -> Reshape) runs on the host, with no read from the device. An
    op meeting a host array and a device tensor moves the array to the
    tensor's device;
  - ``compute_dtype`` ("float32" by default, or "bfloat16") is the dtype of
    the non-integer graph inputs and of the Conv/ConvTranspose/Gemm
    results, as in the reference; a float32 conv runs with TF32 off.

Every entry of the reference's op table is here (the functions below are in
its order); an op outside it raises ``NotImplementedError`` naming it, as in
the reference. ``LSTM`` and ``GRU`` run a time loop in the ONNX gate order
(iofc, zrh). Attention written as MatMul/Softmax nodes runs as those ops:
as in the reference, an imported graph does not reach the flash-attention
kernel.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .module import Module, full_f32


@dataclasses.dataclass
class GraphNode:
    """One op: ONNX op_type + attrs, resolved input/output tensor names."""

    name: str
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]


_COMPUTE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}
_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.float64): torch.float32,   # JAX's 64-bit types off
                np.dtype(np.int64): torch.int64,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int8): torch.int8,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.bool_): torch.bool}
#: Cast's ``to`` (TensorProto.DataType) -> dtype, on the host and the device
_CAST_NP = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_,
            10: np.float16, 11: np.float64}
_CAST_TORCH = {1: torch.float32, 6: torch.int32, 7: torch.int64,
               9: torch.bool, 10: torch.float16, 11: torch.float64}


# ---------------------------------------------------------------------------
# host arrays and device tensors
# ---------------------------------------------------------------------------


def _is_host(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


def _host(v) -> np.ndarray:
    """A value as a numpy array (a device tensor is read back)."""
    if _is_host(v):
        return np.asarray(v)
    return v.detach().cpu().numpy()


def _ints(v) -> List[int]:
    return [int(a) for a in _host(v).reshape(-1).tolist()]


def _tensor(v, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A host array as a tensor on ``like``'s device (float64 as float32)."""
    if isinstance(v, torch.Tensor):
        if like is not None and v.device != like.device:
            return v.to(like.device)
        return v
    arr = np.asarray(v)
    t = torch.from_numpy(np.array(arr, copy=True)).to(_NP_TO_TORCH.get(
        arr.dtype, torch.float32))
    return t if like is None else t.to(like.device)


def _device_of(args) -> Optional[torch.Tensor]:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
    return None


def _str_attr(node, key: str, default: str) -> str:
    v = node.attrs.get(key, default)
    return v.decode() if isinstance(v, bytes) else v


def _spatial_pads(sizes, kernel, strides, dilations, pads, auto_pad):
    """Per spatial axis (low, high): the explicit ``pads`` or XLA's "SAME"
    (the odd one of the total on the high side), which the reference uses
    for SAME_UPPER and SAME_LOWER alike."""
    n = len(kernel)
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        out = []
        for size, k, s, d in zip(sizes, kernel, strides, dilations):
            eff = (k - 1) * d + 1
            total = max((-(-size // s) - 1) * s + eff - size, 0)
            out.append((total // 2, total - total // 2))
        return out
    if pads:
        return [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    return [(0, 0)] * n


def _pad_spatial(x: torch.Tensor, pads, value: float) -> torch.Tensor:
    flat = []
    for lo, hi in reversed(pads):
        flat.extend((lo, hi))
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


class GraphModule(Module):
    """A Module whose forward interprets an op graph.

    The reference's ``params`` for it are a flat {initializer_name: array};
    here the floating initializers are the module's parameters (named
    ``named_parameters`` keys derived from the initializer names,
    ``param_names`` maps one to the other) and the rest host constants.
    ``init`` only checks the input shape and probes the output's: the
    importer fills the weights.
    """

    is_container = True

    def __init__(self, nodes: Sequence[GraphNode], initializers: Dict[str, np.ndarray],
                 input_name: str, output_name: str,
                 input_shape: Tuple[int, ...], name: str = "graph",
                 compute_dtype: str = "float32",
                 extra_input_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
                 extra_input_dtypes: Optional[Dict[str, Any]] = None,
                 input_dtype: Any = np.float32):
        super().__init__()
        if compute_dtype not in _COMPUTE:
            raise ValueError(f"compute_dtype {compute_dtype!r}: expected one "
                             f"of {sorted(_COMPUTE)}")
        self.nodes = list(nodes)
        self.input_name = input_name
        self.output_name = output_name
        self.input_shape = tuple(input_shape)  # excludes batch dim, NCHW order for images
        # secondary graph inputs (multi-input models; feedDict parity):
        # {tensor_name: per-example shape}, ordered — ARGUMENT_1.. addressing
        self.extra_input_shapes = {
            k: tuple(v) for k, v in (extra_input_shapes or {}).items()}
        self.extra_input_dtypes = {
            k: np.dtype(v) for k, v in (extra_input_dtypes or {}).items()}
        self.input_dtype = np.dtype(input_dtype)
        self.name = name
        self.compute_dtype = compute_dtype
        self.consts: Dict[str, np.ndarray] = {}
        self.param_names: Dict[str, str] = {}
        used = set()
        for key, value in initializers.items():
            arr = np.asarray(value)
            if arr.dtype.kind != "f":
                self.consts[key] = arr
                continue
            attr = "init_" + re.sub(r"\W", "_", key)
            while attr in used:
                attr += "_"
            used.add(attr)
            self.param_names[key] = attr
            self.register_parameter(attr, nn.Parameter(
                _tensor(arr), requires_grad=False))

    @property
    def input_names(self) -> List[str]:
        return [self.input_name] + list(self.extra_input_shapes)

    def extra_repr(self) -> str:
        # the architecture for FunctionModel.cache_token: the node list, the
        # addressing and the host constants (shapes, axes), not the weights
        h = hashlib.sha256(repr((
            [(n.name, n.op_type, n.inputs, n.outputs, sorted(
                (k, repr(v)) for k, v in n.attrs.items()))
             for n in self.nodes],
            self.input_names, self.output_name, self.input_shape,
            sorted(self.extra_input_shapes.items()),
            sorted((k, str(v.dtype), v.shape, v.tobytes())
                   for k, v in self.consts.items()))).encode()).hexdigest()
        return (f"name={self.name!r}, nodes={len(self.nodes)}, "
                f"compute_dtype={self.compute_dtype!r}, graph={h[:20]}")

    # -- Module contract ----------------------------------------------------
    def init(self, gen, in_shape):
        """Check ``in_shape`` against the imported one and return the
        output's shape (batch dim excluded), from a forward of one zero
        example on the CPU (the weights are the importer's)."""
        if tuple(in_shape) != self.input_shape:
            raise ValueError(
                f"GraphModule was imported for input shape {self.input_shape}, "
                f"got {tuple(in_shape)}")
        x: Any = torch.zeros((1,) + self.input_shape,
                             dtype=_NP_TO_TORCH.get(self.input_dtype,
                                                    torch.float32))
        if self.extra_input_shapes:
            # multi-input probe: dynamic (None) secondary dims probed as 1
            x = {self.input_name: x}
            for name, shape in self.extra_input_shapes.items():
                dt = self.extra_input_dtypes.get(name, np.dtype(np.float32))
                x[name] = torch.zeros(
                    (1,) + tuple(1 if d is None else d for d in shape),
                    dtype=_NP_TO_TORCH.get(dt, torch.float32))
        with torch.inference_mode():
            out = self(x)
        return tuple(out.shape[1:])

    def layer_paths(self, prefix: str = "") -> List[str]:
        return [f"{prefix}{n.name}" for n in self.nodes]

    def _cast_input(self, arr):
        if not isinstance(arr, torch.Tensor):
            arr = _tensor(arr)
        if self.compute_dtype != "float32" and arr.is_floating_point():
            arr = arr.to(_COMPUTE[self.compute_dtype])
        return arr

    def forward(self, x, train: bool = False,
                taps: Optional[Set[str]] = None,
                taps_out: Optional[Dict[str, Any]] = None,
                stats_out: Optional[Dict[str, Any]] = None, _prefix: str = ""):
        del train, stats_out  # imported graphs run inference-mode only
        env: Dict[str, Any] = dict(self.consts)
        for key, attr in self.param_names.items():
            env[key] = getattr(self, attr)
        if isinstance(x, dict):
            missing = [n for n in self.input_names if n not in x]
            if missing:
                raise KeyError(f"graph inputs {missing} not fed "
                               f"(have {sorted(x)})")
            for name, arr in x.items():
                env[name] = self._cast_input(arr)
        else:
            env[self.input_name] = self._cast_input(x)
        like = env[self.input_name]
        cdt = _COMPUTE[self.compute_dtype]
        for node in self.nodes:
            fn = _OPS.get(node.op_type)
            if fn is None:
                raise NotImplementedError(
                    f"ONNX op {node.op_type!r} (node {node.name!r}) is not supported; "
                    f"supported: {sorted(_OPS)}")
            args = [env[i] if i else None for i in node.inputs]
            res = fn(node, args, cdt)
            if not isinstance(res, tuple):
                res = (res,)
            for out_name, val in zip(node.outputs, res):
                if out_name:
                    env[out_name] = val
            path = f"{_prefix}{node.name}"
            if taps is not None and taps_out is not None and path in taps:
                taps_out[path] = _tensor(env[node.outputs[0]], like)
        out = _tensor(env[self.output_name], like)
        if not out.is_floating_point():
            return out
        return out.to(torch.float32)


# ---------------------------------------------------------------------------
# Op kernels. Each takes (node, args, compute dtype) and returns a value or a
# tuple. Semantics follow the ONNX operator spec as the reference implements
# it (opset 13 baseline; LayerNormalization per opset 17, Gelu per opset 20).
# ---------------------------------------------------------------------------


def _op_conv(node, args, cdt):
    x, w = args[0], args[1]
    b = args[2] if len(args) > 2 else None
    w = _tensor(w, x)
    group = int(node.attrs.get("group", 1))
    nspatial = w.dim() - 2
    if nspatial not in _CONV:
        raise NotImplementedError(f"Conv with {nspatial} spatial dims")
    strides = [int(s) for s in node.attrs.get("strides", [1] * nspatial)]
    dilations = [int(d) for d in node.attrs.get("dilations", [1] * nspatial)]
    pads = _spatial_pads(x.shape[2:], w.shape[2:], strides, dilations,
                         node.attrs.get("pads"),
                         _str_attr(node, "auto_pad", "NOTSET"))
    sym = all(lo == hi for lo, hi in pads)
    xc = x.to(cdt) if sym else _pad_spatial(x.to(cdt), pads, 0.0)
    with full_f32(cdt):
        y = _CONV[nspatial](xc, w.to(cdt), stride=strides,
                            padding=[lo for lo, _ in pads] if sym else 0,
                            dilation=dilations, groups=group)
    y = y.to(cdt)
    if b is not None:
        y = y + _tensor(b, x).to(y.dtype).reshape((1, -1) + (1,) * nspatial)
    return y


def _op_bn(node, args, cdt):
    x = args[0]
    scale, bias, mean, var = (_tensor(a, x) for a in args[1:5])
    eps = float(node.attrs.get("epsilon", 1e-5))
    inv = scale / torch.sqrt(var.to(torch.float32) + eps)
    shift = bias - mean * inv
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * inv.reshape(shape).to(x.dtype) + shift.reshape(shape).to(x.dtype)


def _dot_f32(a: torch.Tensor, b: torch.Tensor, cdt) -> torch.Tensor:
    """``jnp.dot(a.astype(cdt), b.astype(cdt), preferred_element_type=f32)``:
    operands rounded to ``cdt``, products and sums in f32."""
    return torch.matmul(a.to(cdt).to(torch.float32), b.to(cdt).to(torch.float32))


def _op_gemm(node, args, cdt):
    a, b = args[0], _tensor(args[1], args[0])
    c = args[2] if len(args) > 2 else None
    alpha = float(node.attrs.get("alpha", 1.0))
    beta = float(node.attrs.get("beta", 1.0))
    if int(node.attrs.get("transA", 0)):
        a = a.T
    if int(node.attrs.get("transB", 0)):
        b = b.T
    y = _dot_f32(a, b, cdt)
    if alpha != 1.0:
        y = y * alpha
    if c is not None:
        y = y + beta * _tensor(c, a)
    return y.to(cdt)


def _op_matmul(node, args, cdt):
    a, b = args[0], _tensor(args[1], args[0])
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)


def _sum_pool(x: torch.Tensor, kernel, strides) -> torch.Tensor:
    """Window sums of an already padded NC... tensor (1-3 spatial dims)."""
    n = len(kernel)
    if n == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1, kernel[0]), (1, strides[0]),
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if n == 2 else F.avg_pool3d
    return pool(x, kernel, strides, divisor_override=1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_op(node, args, cdt, is_avg: bool):
    x = args[0]
    kernel = [int(k) for k in node.attrs["kernel_shape"]]
    nspatial = len(kernel)
    strides = [int(s) for s in node.attrs.get("strides", [1] * nspatial)]
    pads = node.attrs.get("pads", [0] * 2 * nspatial)
    auto_pad = _str_attr(node, "auto_pad", "NOTSET")
    ceil_mode = int(node.attrs.get("ceil_mode", 0))
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        padding = _spatial_pads(x.shape[2:], kernel, strides, [1] * nspatial,
                                None, auto_pad)
    else:
        padding = [(int(pads[i]), int(pads[i + nspatial])) for i in range(nspatial)]
        if ceil_mode:
            # grow right/bottom pad so ceil-divided windows fit
            for i in range(nspatial):
                size = x.shape[2 + i] + padding[i][0] + padding[i][1] - kernel[i]
                if size % strides[i]:
                    padding[i] = (padding[i][0],
                                  padding[i][1] + strides[i] - size % strides[i])
    if is_avg:
        s = _sum_pool(_pad_spatial(x.to(torch.float32), padding, 0.0), kernel,
                      strides)
        if int(node.attrs.get("count_include_pad", 0)):
            return (s / float(np.prod(kernel))).to(x.dtype)
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=torch.float32,
                          device=x.device)
        cnt = _sum_pool(_pad_spatial(ones, padding, 0.0), kernel, strides)
        return (s / cnt).to(x.dtype)
    return _MAX_POOL[nspatial](_pad_spatial(x, padding, -math.inf), kernel,
                               strides)


def _op_maxpool(node, args, cdt):
    return _window_op(node, args, cdt, False)


def _op_avgpool(node, args, cdt):
    return _window_op(node, args, cdt, True)


def _op_global_avgpool(node, args, cdt):
    x = args[0]
    axes = tuple(range(2, x.dim()))
    return x.to(torch.float32).mean(dim=axes, keepdim=True).to(x.dtype)


def _op_reshape(node, args, cdt):
    x, shape = args[0], _ints(args[1])
    # ONNX: 0 means "copy dim from input"; -1 infers
    shape = [x.shape[i] if s == 0 else int(s) for i, s in enumerate(shape)]
    return x.reshape(shape)


def _op_flatten(node, args, cdt):
    x = args[0]
    axis = int(node.attrs.get("axis", 1))
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return x.reshape(lead, -1)


def _op_concat(node, args, cdt):
    axis = int(node.attrs.get("axis", 0))
    if all(_is_host(a) for a in args):
        return np.concatenate(args, axis=axis)
    like = _device_of(args)
    return torch.cat([_tensor(a, like) for a in args], dim=axis)


def _index_pad(x: torch.Tensor, widths, mode: str) -> torch.Tensor:
    """``np.pad`` reflect/edge on a tensor: a gather per axis of the indices
    numpy's own pad of an arange gives."""
    for axis, (lo, hi) in enumerate(widths):
        if lo == 0 and hi == 0:
            continue
        idx = np.pad(np.arange(x.shape[axis]), (lo, hi), mode=mode)
        x = x.index_select(axis, torch.from_numpy(idx).to(x.device))
    return x


def _op_pad(node, args, cdt):
    x = args[0]
    if len(args) > 1 and args[1] is not None:
        pads = _ints(args[1])
    else:
        pads = node.attrs.get("pads", [0] * 2 * x.dim())
    value = float(_host(args[2]).reshape(-1)[0]) \
        if len(args) > 2 and args[2] is not None \
        else float(node.attrs.get("value", 0.0))
    mode = _str_attr(node, "mode", "constant")
    n = x.dim()
    widths = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    if mode == "constant":
        flat = []
        for lo, hi in reversed(widths):
            flat.extend((lo, hi))
        return F.pad(x, flat, value=value)
    return _index_pad(x, widths, {"reflect": "reflect", "edge": "edge"}[mode])


def _op_clip(node, args, cdt):
    x = args[0]
    lo = args[1] if len(args) > 1 and args[1] is not None else node.attrs.get("min")
    hi = args[2] if len(args) > 2 and args[2] is not None else node.attrs.get("max")
    if lo is not None:
        x = torch.maximum(x, _tensor(_bound(lo), x).to(x.dtype))
    if hi is not None:
        x = torch.minimum(x, _tensor(_bound(hi), x).to(x.dtype))
    return x


def _bound(v):
    return v if isinstance(v, torch.Tensor) else np.asarray(v)


def _op_transpose(node, args, cdt):
    x = args[0]
    perm = node.attrs.get("perm")
    if perm is None:
        perm = list(reversed(range(x.ndim)))
    if _is_host(x):
        return np.transpose(x, axes=perm)
    return x.permute(*[int(p) for p in perm])


def _op_softmax(node, args, cdt):
    x = args[0]
    return torch.softmax(x.to(torch.float32),
                         dim=int(node.attrs.get("axis", -1))).to(x.dtype)


def _triangle(x):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.)
    out = np.where(x >= 1., ((np.float32(-0.5) * x + np.float32(2.5)) * x
                             - np.float32(4.)) * x + np.float32(2.), out)
    return np.where(x >= 2., np.float32(0.), out).astype(np.float32)


def _resize_weights(m: int, n: int, kernel) -> np.ndarray:
    """``jax.image``'s weight matrix [m, n] for resizing an axis of ``m``
    samples to ``n`` (antialiased when downsampling), in f32."""
    scale = np.float32(n / m)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.0) * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(m, dtype=np.float32)[:, None])
         / np.float32(kernel_scale)).astype(np.float32)
    weights = kernel(x).astype(np.float32)
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000. * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    keep = (sample_f >= -0.5) & (sample_f <= np.float32(m) - np.float32(0.5))
    return np.where(keep[None, :], weights, 0).astype(np.float32)


def _op_resize(node, args, cdt):
    """``jax.image.resize`` (the reference's Resize): nearest takes the
    sample at floor((i + 0.5) * in / out); linear and cubic (Keys, a=-0.5)
    contract each changed axis with an antialiased weight matrix."""
    x = args[0]
    # inputs: X, roi, scales, sizes (opset 11+).
    sizes = args[3] if len(args) > 3 and args[3] is not None else None
    scales = args[2] if len(args) > 2 and args[2] is not None else None
    if sizes is not None:
        out_shape = tuple(_ints(sizes))
    elif scales is not None:
        sc = _host(scales).reshape(-1).tolist()
        out_shape = tuple(int(round(d * s)) for d, s in zip(x.shape, sc))
    else:
        raise ValueError("Resize needs scales or sizes")
    mode = _str_attr(node, "mode", "nearest")
    if mode not in ("nearest", "linear", "cubic"):
        raise KeyError(mode)
    dims = [d for d in range(x.dim()) if x.shape[d] != out_shape[d]]
    if mode == "nearest":
        for d in dims:
            m, n = x.shape[d], out_shape[d]
            off = (np.arange(n, dtype=np.float32) + np.float32(0.5)) \
                * np.float32(m) / np.float32(n)
            idx = np.floor(off.astype(np.float32)).astype(np.int64)
            x = x.index_select(d, torch.from_numpy(idx).to(x.device))
        return x
    kernel = _triangle if mode == "linear" else _keys_cubic
    if not x.is_floating_point():
        x = x.to(torch.float32)
    for d in dims:
        w = torch.from_numpy(_resize_weights(x.shape[d], out_shape[d], kernel)
                             ).to(x.device, x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


def _elementwise(tfn, nfn=None):
    """A binary op on tensors, or on host arrays when both are (the shape
    arithmetic) and ``nfn`` is given."""
    def op(node, args, cdt):
        a, b = args[0], args[1]
        if nfn is not None and _is_host(a) and _is_host(b):
            return nfn(a, b)
        like = _device_of((a, b))
        return tfn(_tensor(a, like), _tensor(b, like))
    return op


def _unary(fn):
    return lambda node, args, cdt: fn(_tensor(args[0]))


def _hard_swish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _op_cast(node, args, cdt):
    to = int(node.attrs.get("to", 1))
    if _is_host(args[0]):
        return np.asarray(args[0]).astype(_CAST_NP[to])
    return args[0].to(_CAST_TORCH[to])


def _make_ops() -> Dict[str, Callable]:
    f32 = torch.float32

    def leaky(n, a, c):
        x = a[0]
        return torch.where(x > 0, x, x * float(np.float32(n.attrs.get("alpha", 0.01))))

    def hard_sigmoid(n, a, c):
        return torch.clamp(a[0] * float(np.float32(n.attrs.get("alpha", 0.2)))
                           + float(np.float32(n.attrs.get("beta", 0.5))), 0, 1)

    def elu(n, a, c):
        x = a[0]
        alpha = float(np.float32(n.attrs.get("alpha", 1.0)))
        return torch.where(x > 0, x, alpha * (torch.exp(torch.clamp_max(x, 0.0)) - 1))

    def selu(n, a, c):
        x = a[0]
        gamma = float(np.float32(n.attrs.get("gamma", 1.0507009873554805)))
        alpha = float(np.float32(n.attrs.get("alpha", 1.6732632423543772)))
        return gamma * torch.where(
            x > 0, x, alpha * (torch.exp(torch.clamp_max(x, 0.0)) - 1))

    def gelu(n, a, c):
        approx = n.attrs.get("approximate", b"none") in (b"tanh", "tanh")
        return F.gelu(a[0].to(f32), approximate="tanh" if approx else "none"
                      ).to(a[0].dtype)

    def softplus(n, a, c):
        x = a[0]
        return torch.logaddexp(x.to(f32), torch.zeros((), dtype=f32,
                                                      device=x.device)).to(x.dtype)

    def where(n, a, c):
        if all(_is_host(v) for v in a):
            return np.where(a[0], a[1], a[2])
        like = _device_of(a)
        return torch.where(_tensor(a[0], like).to(torch.bool),
                           _tensor(a[1], like), _tensor(a[2], like))

    def shape(n, a, c):
        return np.asarray(tuple(a[0].shape), dtype=np.int64)

    def gather(n, a, c):
        axis = int(n.attrs.get("axis", 0))
        data, idx = a[0], a[1]
        if _is_host(data) and _is_host(idx):
            return np.take(data, np.asarray(idx), axis=axis)
        data = _tensor(data, _device_of((data, idx)))
        idx = _tensor(idx, data).to(torch.int64)
        axis = axis % data.dim()
        size = data.shape[axis]
        flat = torch.where(idx < 0, idx + size, idx).reshape(-1)
        out = data.index_select(axis, flat)
        return out.reshape(tuple(data.shape[:axis]) + tuple(idx.shape)
                           + tuple(data.shape[axis + 1:]))

    def unsqueeze(n, a, c):
        axes = n.attrs.get("axes") or _ints(a[1])
        x = a[0]
        rank = np.ndim(x) + len(axes)
        for ax in sorted(int(v) % rank for v in axes):
            x = np.expand_dims(x, ax) if _is_host(x) else x.unsqueeze(ax)
        return x

    def squeeze(n, a, c):
        axes = n.attrs.get("axes") or (_ints(a[1]) if len(a) > 1
                                       and a[1] is not None else None)
        x = a[0]
        if _is_host(x):
            return np.squeeze(x, axis=tuple(int(v) for v in axes)
                              if axes else None)
        if not axes:
            return x.squeeze()
        rank = x.dim()
        for ax in sorted((int(v) % rank for v in axes), reverse=True):
            x = x.squeeze(ax)
        return x

    def mean(n, a, c):
        like = _device_of(a)
        return sum(_tensor(v, like) for v in a) / len(a)

    def total(n, a, c):
        like = _device_of(a)
        return sum(_tensor(v, like) for v in a)

    return {
        "Conv": _op_conv,
        "BatchNormalization": _op_bn,
        "Gemm": _op_gemm,
        "MatMul": _op_matmul,
        "MaxPool": _op_maxpool,
        "AveragePool": _op_avgpool,
        "GlobalAveragePool": _op_global_avgpool,
        "Relu": _unary(lambda x: torch.clamp_min(x, 0)),
        "LeakyRelu": leaky,
        "Sigmoid": _unary(torch.sigmoid),
        "HardSigmoid": hard_sigmoid,
        "HardSwish": _unary(_hard_swish),
        "Tanh": _unary(torch.tanh),
        "Erf": _unary(torch.erf),
        "Exp": _unary(torch.exp),
        "Sqrt": _unary(torch.sqrt),
        "Reciprocal": _unary(torch.reciprocal),
        "Neg": _unary(torch.neg),
        "Abs": _unary(torch.abs),
        "Softmax": _op_softmax,
        "Add": _elementwise(torch.add, np.add),
        "Sub": _elementwise(torch.sub, np.subtract),
        "Mul": _elementwise(torch.mul, np.multiply),
        "Div": _elementwise(torch.div, np.divide),
        "Pow": _elementwise(torch.pow),
        "Min": _elementwise(torch.minimum),
        "Max": _elementwise(torch.maximum),
        "Concat": _op_concat,
        "Reshape": _op_reshape,
        "Flatten": _op_flatten,
        "Transpose": _op_transpose,
        "Pad": _op_pad,
        "Clip": _op_clip,
        "Identity": lambda n, a, c: a[0],
        "Dropout": lambda n, a, c: a[0],  # inference mode
        "Cast": _op_cast,
        "ReduceMean": _reduce("mean"),
        "ReduceSum": _reduce("sum"),
        "ReduceMax": _reduce("max"),
        "ReduceMin": _reduce("min"),
        "ReduceProd": _reduce("prod"),
        "ArgMax": _argminmax(torch.argmax),
        "ArgMin": _argminmax(torch.argmin),
        "LayerNormalization": _op_layernorm,
        "InstanceNormalization": _op_instancenorm,
        "ConvTranspose": _op_conv_transpose,
        "GlobalMaxPool": lambda n, a, c: torch.amax(
            a[0], dim=tuple(range(2, a[0].dim())), keepdim=True),
        "Gelu": gelu,
        "Softplus": softplus,
        "Elu": elu,
        "Selu": selu,
        "PRelu": _elementwise(lambda x, s: torch.where(x > 0, x, x * s)),
        "Expand": _op_expand,
        "Tile": _op_tile,
        "Where": where,
        "Equal": _elementwise(torch.eq, np.equal),
        "Greater": _elementwise(torch.gt),
        "GreaterOrEqual": _elementwise(torch.ge),
        "Less": _elementwise(torch.lt),
        "LessOrEqual": _elementwise(torch.le),
        "Not": _unary(torch.logical_not),
        "And": _elementwise(torch.logical_and),
        "Or": _elementwise(torch.logical_or),
        "Log": _unary(torch.log),
        "Sin": _unary(torch.sin),
        "Cos": _unary(torch.cos),
        "Floor": _unary(torch.floor),
        "Ceil": _unary(torch.ceil),
        "Round": _unary(torch.round),
        "Sign": _unary(torch.sign),
        "Mean": mean,
        "Sum": total,
        "LSTM": _op_lstm,
        "GRU": _op_gru,
        "Resize": _op_resize,
        "Shape": shape,
        "Gather": gather,
        "Unsqueeze": unsqueeze,
        "Squeeze": squeeze,
        "Slice": _op_slice,
        "Split": _op_split,
    }


def _op_layernorm(node, args, cdt):
    x, scale = args[0], _tensor(args[1], args[0])
    b = _tensor(args[2], x) if len(args) > 2 and args[2] is not None else None
    axis = int(node.attrs.get("axis", -1))
    eps = float(node.attrs.get("epsilon", 1e-5))
    axes = tuple(range(axis % x.dim(), x.dim()))
    xf = x.to(torch.float32)
    mean = xf.mean(dim=axes, keepdim=True)
    var = torch.square(xf - mean).mean(dim=axes, keepdim=True)
    inv = 1.0 / torch.sqrt(var + eps)
    y = (xf - mean) * inv * scale.to(torch.float32)
    if b is not None:
        y = y + b.to(torch.float32)
    # spec outputs: Y, Mean, InvStdDev (later two rarely consumed)
    return y.to(x.dtype), mean, inv


def _op_instancenorm(node, args, cdt):
    x, scale, b = args[0], _tensor(args[1], args[0]), _tensor(args[2], args[0])
    eps = float(node.attrs.get("epsilon", 1e-5))
    axes = tuple(range(2, x.dim()))
    xf = x.to(torch.float32)
    mean = xf.mean(dim=axes, keepdim=True)
    var = torch.square(xf - mean).mean(dim=axes, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = (xf - mean) / torch.sqrt(var + eps) * scale.reshape(shape) \
        + b.reshape(shape)
    return y.to(x.dtype)


def _op_conv_transpose(node, args, cdt):
    """ONNX ConvTranspose (W ``[C_in, C_out/group, k...]``): the unpadded
    transposed conv, then each axis cropped by its (begin, end) pads and
    extended by ``output_padding``: out = (i-1)*s - pb - pe + (k-1)*d + 1
    + output_padding."""
    x, w = args[0], _tensor(args[1], args[0])
    b = args[2] if len(args) > 2 else None
    group = int(node.attrs.get("group", 1))
    nspatial = w.dim() - 2
    auto_pad = _str_attr(node, "auto_pad", "NOTSET")
    if auto_pad not in ("NOTSET", ""):
        raise NotImplementedError(f"ConvTranspose auto_pad={auto_pad!r}")
    if node.attrs.get("output_shape"):
        raise NotImplementedError("ConvTranspose output_shape attribute")
    if nspatial not in _CONV_T:
        raise NotImplementedError(f"ConvTranspose with {nspatial} spatial dims")
    strides = [int(s) for s in node.attrs.get("strides", [1] * nspatial)]
    dilations = [int(d) for d in node.attrs.get("dilations", [1] * nspatial)]
    out_pad = [int(p) for p in node.attrs.get("output_padding", [0] * nspatial)]
    pads = node.attrs.get("pads", [0] * 2 * nspatial)
    with full_f32(cdt):
        y = _CONV_T[nspatial](x.to(cdt), w.to(cdt), stride=strides,
                              dilation=dilations, groups=group)
    y = y.to(cdt)
    for i in range(nspatial):
        full = y.shape[2 + i]
        begin = int(pads[i])
        end = full - int(pads[i + nspatial]) + out_pad[i]
        if end > full:
            widths = [0, 0] * (nspatial - 1 - i) + [0, end - full]
            y = F.pad(y, widths)
        y = y.narrow(2 + i, begin, end - begin)
    if b is not None:
        y = y + _tensor(b, x).to(y.dtype).reshape((1, -1) + (1,) * nspatial)
    return y


def _reduce(kind: str):
    def op(node, args, cdt):
        axes = node.attrs.get("axes")
        if axes is None and len(args) > 1 and args[1] is not None:
            axes = _ints(args[1])
        keepdims = bool(node.attrs.get("keepdims", 1))
        x = args[0]
        if not axes and int(node.attrs.get("noop_with_empty_axes", 0)):
            return x  # spec: empty/absent axes + noop flag = identity
        dims = tuple(int(a) % x.dim() for a in axes) if axes \
            else tuple(range(x.dim()))
        if kind == "mean":
            return x.mean(dim=dims, keepdim=keepdims)
        if kind == "sum":
            return x.sum(dim=dims, keepdim=keepdims)
        if kind == "max":
            return torch.amax(x, dim=dims, keepdim=keepdims)
        if kind == "min":
            return torch.amin(x, dim=dims, keepdim=keepdims)
        for d in sorted(dims, reverse=True):
            x = x.prod(dim=d, keepdim=keepdims)
        return x
    return op


def _argminmax(fn):
    def op(node, args, cdt):
        axis = int(node.attrs.get("axis", 0))
        keepdims = bool(node.attrs.get("keepdims", 1))
        x = args[0]
        if int(node.attrs.get("select_last_index", 0)):
            # spec: ties pick the LAST index — flip, argmax, re-index
            out = x.shape[axis] - 1 - fn(torch.flip(x, (axis,)), dim=axis)
        else:
            out = fn(x, dim=axis)
        if keepdims:
            out = out.unsqueeze(axis)
        return out
    return op


def _op_expand(node, args, cdt):
    x = args[0]
    shape = _ints(args[1])
    # ONNX Expand: bidirectional broadcast; dim 1 (or missing) broadcasts
    if _is_host(x):
        return np.broadcast_to(x, np.broadcast_shapes(np.shape(x), tuple(shape)))
    want = torch.broadcast_shapes(tuple(x.shape), tuple(shape))
    return x.expand(want)


def _op_tile(node, args, cdt):
    reps = _ints(args[1])
    if _is_host(args[0]):
        return np.tile(args[0], reps)
    return torch.tile(args[0], reps)


def _lstm_gates(x_t, h, c, w, r, wb, rb):
    """One ONNX LSTM step; gate order iofc, activations sigmoid/tanh/tanh."""
    H = h.shape[-1]
    z = x_t @ w.T + h @ r.T + wb + rb            # [B, 4H]
    i = torch.sigmoid(z[:, :H])
    o = torch.sigmoid(z[:, H:2 * H])
    f = torch.sigmoid(z[:, 2 * H:3 * H])
    g = torch.tanh(z[:, 3 * H:])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def _direction(node) -> List[bool]:
    direction = _str_attr(node, "direction", "forward")
    return {"forward": [False], "reverse": [True],
            "bidirectional": [False, True]}[direction]


def _op_lstm(node, args, cdt):
    """ONNX LSTM (layout 0: X [T,B,I]) as a time loop; forward / reverse /
    bidirectional, default activations, optional B/initial_h/c.
    sequence_lens is ignored (all sequences full length)."""
    x = args[0]
    w, r = _tensor(args[1], x).to(torch.float32), _tensor(args[2], x).to(torch.float32)
    hidden = int(node.attrs["hidden_size"])
    if int(node.attrs.get("layout", 0)) != 0:
        raise NotImplementedError("LSTM layout=1")
    if len(args) > 7 and args[7] is not None:
        raise NotImplementedError("LSTM peephole weights (input P)")
    T, B, _ = x.shape
    D = w.shape[0]

    def opt(i, shape):
        if len(args) > i and args[i] is not None:
            return _tensor(args[i], x).to(torch.float32)
        return torch.zeros(shape, dtype=torch.float32, device=x.device)

    bias = opt(3, (D, 8 * hidden))
    h0 = opt(5, (D, B, hidden))
    c0 = opt(6, (D, B, hidden))
    xf = x.to(torch.float32)
    ys, hs, cs = [], [], []
    for d, rev in enumerate(_direction(node)):
        seq = torch.flip(xf, (0,)) if rev else xf
        wb, rb = bias[d, :4 * hidden], bias[d, 4 * hidden:]
        h, c = h0[d], c0[d]
        out = []
        for t in range(T):
            h, c = _lstm_gates(seq[t], h, c, w[d], r[d], wb, rb)
            out.append(h)
        y = torch.stack(out, 0)
        ys.append(torch.flip(y, (0,)) if rev else y)
        hs.append(h)
        cs.append(c)
    Y = torch.stack(ys, dim=1)                     # [T, D, B, H]
    return Y.to(x.dtype), torch.stack(hs, 0), torch.stack(cs, 0)


def _op_gru(node, args, cdt):
    """ONNX GRU (layout 0), gate order zrh; honors linear_before_reset."""
    x = args[0]
    w, r = _tensor(args[1], x).to(torch.float32), _tensor(args[2], x).to(torch.float32)
    hidden = int(node.attrs["hidden_size"])
    lbr = int(node.attrs.get("linear_before_reset", 0))
    if int(node.attrs.get("layout", 0)) != 0:
        raise NotImplementedError("GRU layout=1")
    T, B, _ = x.shape
    D = w.shape[0]
    bias = _tensor(args[3], x).to(torch.float32) \
        if len(args) > 3 and args[3] is not None \
        else torch.zeros((D, 6 * hidden), dtype=torch.float32, device=x.device)
    h0 = _tensor(args[5], x).to(torch.float32) \
        if len(args) > 5 and args[5] is not None \
        else torch.zeros((D, B, hidden), dtype=torch.float32, device=x.device)
    xf = x.to(torch.float32)
    ys, hs = [], []
    H = hidden
    for d, rev in enumerate(_direction(node)):
        seq = torch.flip(xf, (0,)) if rev else xf
        wd, rd = w[d], r[d]
        wb, rb = bias[d, :3 * H], bias[d, 3 * H:]
        h = h0[d]
        out = []
        for t in range(T):
            xz = seq[t] @ wd.T + wb                # [B, 3H]
            hz = h @ rd.T                          # [B, 3H] (no rb yet)
            z = torch.sigmoid(xz[:, :H] + hz[:, :H] + rb[:H])
            rt = torch.sigmoid(xz[:, H:2 * H] + hz[:, H:2 * H] + rb[H:2 * H])
            if lbr:
                ht = torch.tanh(xz[:, 2 * H:] + rt * (hz[:, 2 * H:] + rb[2 * H:]))
            else:
                ht = torch.tanh(xz[:, 2 * H:] + (rt * h) @ rd[2 * H:].T
                                + rb[2 * H:])
            h = (1 - z) * ht + z * h
            out.append(h)
        y = torch.stack(out, 0)
        ys.append(torch.flip(y, (0,)) if rev else y)
        hs.append(h)
    Y = torch.stack(ys, dim=1)
    return Y.to(x.dtype), torch.stack(hs, 0)


def _op_slice(node, args, cdt):
    x = args[0]
    if "starts" in node.attrs:  # opset 1-9 attribute form
        starts = node.attrs["starts"]
        ends = node.attrs["ends"]
        axes = node.attrs.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    else:
        starts = _ints(args[1])
        ends = _ints(args[2])
        axes = (_ints(args[3]) if len(args) > 3 and args[3] is not None
                else list(range(len(starts))))
        steps = (_ints(args[4]) if len(args) > 4 and args[4] is not None
                 else [1] * len(starts))
    idx: List[Any] = [slice(None)] * np.ndim(x)
    for s, e, a, st in zip(starts, ends, axes, steps):
        idx[int(a)] = slice(int(s) if s > -2**62 else None,
                            int(e) if abs(e) < 2**62 else None, int(st))
    if _is_host(x):
        return x[tuple(idx)]
    for axis, sl in enumerate(idx):
        if sl.step is not None and sl.step < 0:
            # torch slices take no negative step: gather the indices
            pick = np.ascontiguousarray(np.arange(x.shape[axis])[sl])
            x = x.index_select(axis, torch.from_numpy(pick).to(x.device))
            idx[axis] = slice(None)
    return x[tuple(idx)]


def _op_split(node, args, cdt):
    x = args[0]
    axis = int(node.attrs.get("axis", 0))
    split = node.attrs.get("split")
    if split is None and len(args) > 1 and args[1] is not None:
        split = _ints(args[1])
    if split is None:
        n_out = len(node.outputs)
        size = x.shape[axis]
        if size % n_out:
            raise ValueError(f"Split of {size} into {n_out} equal parts")
        split = [size // n_out] * n_out
    return tuple(torch.split(x, [int(s) for s in split], dim=axis))


_OPS: Dict[str, Callable] = _make_ops()
