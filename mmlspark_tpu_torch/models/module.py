"""Named-layer module system on ``torch.nn`` (the port of
``mmlspark_tpu/models/module.py``).

The reference's modules are pairs of pure functions over a params pytree;
here every layer is an ``nn.Module`` whose registered parameters carry the
pytree's key names, so ``FunctionModel.params`` and the reference's
``FunctionModel.params`` have the same nested keys and shapes
(``convert.load_jax_params`` carries one into the other). What stays:

  - ``init(gen, in_shape) -> out_shape`` builds a layer's parameters for an
    input shape (batch dim excluded) from an explicit ``torch.Generator``;
    the forward is ``module(x)``;
  - named-layer taps: ``Sequential`` records the activations of the layer
    paths asked for ("block0/attn", "layer4/2/body/relu2", ...), so one
    forward can fetch several nodes (``FunctionModel.apply_taps``);
  - bf16 products with f32 results: ``matmul_dtype()`` (a context variable,
    bf16 by default, ``matmul_precision("float32")`` for exact comparisons)
    is the operand dtype of ``Dense`` and the attention projections. The
    reference asks XLA for ``preferred_element_type=f32``; here the operands
    are rounded to bf16 and multiplied in f32, which gives the same products
    (a bf16 x bf16 product is exact in f32) summed in f32. A float32 product
    needs TF32 off, PyTorch's default for matmuls;
  - ``Conv2D`` as the reference's: NHWC activations and an HWIO ``kernel``,
    both rounded to ``matmul_dtype()``, and a result of that dtype (bf16
    activations end to end). It runs ``F.conv2d`` (cuDNN on the card; the
    reference's conv is XLA's, outside any Pallas kernel) on NCHW and OIHW
    views of the same memory, with TF32 off for a float32 conv;
  - ``BatchNorm`` (``scale``, ``bias``, ``mean``, ``var``): the moving
    statistics at inference, the batch's (f32, population variance) in
    training, which it writes into ``stats_out`` under its layer path for
    ``training._apply_bn_ema``. The containers' forward takes ``train`` and
    ``stats_out`` and hands both to it, as the reference's ``Sequential``
    does;
  - ``MaxPool`` pads with -inf and ``GlobalAvgPool`` returns the f32 mean;
    ``"SAME"`` padding splits the remainder low/high as XLA does.

On a mesh (``activation_sharding``, which ``training.compile_train_step(
mesh=)`` enters): ``Dense`` and ``Conv2D`` given a kernel whose output
columns are split over the ``tensor`` axis run column-parallel, each rank
computing its columns and gathering the output over ``tensor``, so the
activations between layers are the rank's batch rows, whole over
channels; ``BatchNorm`` in training takes its statistics from the whole
batch over the batch group, in two passes (the sum, then the sum of the
squared deviations).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib
import math
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Set, Tuple)

import torch
import torch.nn.functional as F
from torch import nn

_MATMUL_DTYPE: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "mmlspark_tpu_torch_matmul_dtype", default="bfloat16")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}


def matmul_dtype() -> str:
    """Operand dtype of the layers' products: "bfloat16" (default; products
    and sums are f32), "float32" (exact; the parity tests' setting) or
    "float64"."""
    return _MATMUL_DTYPE.get()


class matmul_precision:
    """Context manager selecting the matmul dtype for the enclosed forwards
    (context-local, so concurrent callers do not see each other's
    setting)."""

    def __init__(self, dtype: str):
        if dtype not in _DTYPES:
            raise ValueError(
                f"matmul_precision: unknown dtype {dtype!r} "
                f"(expected bfloat16/float32/float64)")
        self._value = dtype

    def __enter__(self):
        self._token = _MATMUL_DTYPE.set(self._value)
        return self

    def __exit__(self, *exc):
        _MATMUL_DTYPE.reset(self._token)
        return False


_MESH: "contextvars.ContextVar[Any]" = contextvars.ContextVar(
    "mmlspark_tpu_torch_activation_mesh", default=None)


class activation_sharding:
    """The reference's anchor of every inter-layer activation to the batch
    sharding (``training.batch_sharding(mesh)``, or the mesh itself): in the
    enclosed forwards the layers run on ``mesh`` (``current_mesh``), their
    activations this rank's batch rows, whole over channels. The reference
    needs the anchors because XLA's partitioners got conv gradients wrong
    under channel sharding without them; here the gathers are explicit, so
    they hold by construction. Context-local."""

    def __init__(self, sharding):
        from ..parallel.mesh import Mesh

        mesh = sharding if isinstance(sharding, Mesh) else \
            getattr(sharding, "mesh", None)
        if not isinstance(mesh, Mesh):
            raise ValueError("activation_sharding needs a port Mesh or a "
                             "sharding made for one")
        self._value = mesh

    def __enter__(self):
        self._token = _MESH.set(self._value)
        return self

    def __exit__(self, *exc):
        _MESH.reset(self._token)
        return False


def current_mesh():
    """The mesh of the enclosing ``activation_sharding``, or None."""
    return _MESH.get()


def _tensor_gather(y: torch.Tensor) -> torch.Tensor:
    """A column-parallel layer's output columns gathered over ``tensor``."""
    from ..parallel.mesh import TENSOR_AXIS, all_gather_axis

    mesh = current_mesh()
    if mesh is None:
        raise ValueError("a kernel split over the tensor axis runs under "
                         "activation_sharding(mesh) only")
    return all_gather_axis(y, mesh, TENSOR_AXIS, dim=-1)


def compute_dtype() -> torch.dtype:
    """``matmul_dtype()`` as a torch dtype."""
    return _DTYPES[matmul_dtype()]


def matmul(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``jnp.dot(x.astype(dt), w.astype(dt), preferred_element_type=f32)``
    (f64 for f64 operands): operands rounded to ``dt``, product and sums in
    the wider type."""
    acc = torch.float64 if dt == torch.float64 else torch.float32
    return torch.matmul(x.to(dt).to(acc), w.to(dt).to(acc))


@contextlib.contextmanager
def full_f32(dt: torch.dtype) -> Iterator[None]:
    """TF32 off for cuDNN convolutions in the enclosed block when ``dt`` is
    float32 (PyTorch allows TF32 there by default: a float32 conv would run
    on 10-bit mantissas); any other dtype leaves the flag as it is."""
    if dt != torch.float32:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t.contiguous())


class Module(nn.Module):
    """Base layer. ``init(gen, in_shape)`` creates the parameters for an
    input of ``in_shape`` (batch dim excluded) and returns the output
    shape; stateless layers keep the default."""

    is_container = False

    def init(self, gen: torch.Generator, in_shape: Tuple[int, ...]
             ) -> Tuple[int, ...]:
        return tuple(in_shape)

    def layer_paths(self, prefix: str = "") -> List[str]:
        """All addressable layer names under this module (depth-first)."""
        return [prefix or getattr(self, "name", "") or type(self).__name__.lower()]

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


class Sequential(Module):
    """Named chain of modules; the unit of layer addressing. The forward
    records the activation of every layer path in ``taps`` into
    ``taps_out``."""

    is_container = True

    def __init__(self, layers: Sequence[Tuple[str, Module]], name: str = ""):
        super().__init__()
        self.name = name
        for lname, layer in layers:
            self.add_module(lname, layer)

    @property
    def layers(self) -> List[Tuple[str, Module]]:
        return list(self._modules.items())

    def init(self, gen, in_shape):
        shape = tuple(in_shape)
        for _, layer in self.layers:
            shape = layer.init(gen, shape)
        return shape

    def forward(self, x, train: bool = False, taps: Optional[Set[str]] = None,
                taps_out: Optional[Dict[str, Any]] = None,
                stats_out: Optional[Dict[str, Any]] = None, _prefix: str = ""):
        for lname, layer in self.layers:
            path = f"{_prefix}{lname}"
            if layer.is_container:
                x = layer(x, train=train, taps=taps, taps_out=taps_out,
                          stats_out=stats_out, _prefix=path + "/")
            elif isinstance(layer, BatchNorm):
                x = layer(x, train=train, stats_out=stats_out, _path=path)
            else:
                x = layer(x)
            if taps is not None and taps_out is not None and path in taps:
                taps_out[path] = x
        return x

    def layer_paths(self, prefix: str = "") -> List[str]:
        out: List[str] = []
        for lname, layer in self.layers:
            path = f"{prefix}{lname}"
            if layer.is_container:
                out.extend(layer.layer_paths(path + "/"))
            out.append(path)
        return out

    def extra_repr(self) -> str:
        return f"name={self.name!r}"


class Fn(Module):
    """Stateless elementwise/shape op from a function."""

    def __init__(self, fn: Callable, out_shape_fn: Optional[Callable] = None):
        super().__init__()
        self.fn = fn
        self.out_shape_fn = out_shape_fn

    def init(self, gen, in_shape):
        if self.out_shape_fn is not None:
            return tuple(self.out_shape_fn(tuple(in_shape)))
        # shape probe on the meta device: nothing is computed
        probe = torch.zeros((1,) + tuple(in_shape), device="meta")
        return tuple(self.fn(probe).shape[1:])

    def forward(self, x):
        return self.fn(x)

    def extra_repr(self) -> str:
        fn = self.fn
        return f"fn={getattr(fn, '__module__', '')}.{getattr(fn, '__qualname__', fn)}"


def _relu_fn(x):
    return torch.clamp_min(x, 0)


def _identity_shape(s):
    return s


def _flatten_fn(x):
    return x.reshape(x.shape[0], -1)


def _flat_shape(s):
    return (math.prod(s),)


# module-level fns (not lambdas) so Fn modules pickle for persistence
def relu() -> Fn:
    return Fn(_relu_fn, _identity_shape)


def flatten() -> Fn:
    return Fn(_flatten_fn, _flat_shape)


def _conv_out_dim(size: int, k: int, stride: int, pad) -> int:
    """Output spatial dim for one axis; pad is 'SAME' | 'VALID' | (lo, hi)."""
    if pad == "SAME":
        return -(-size // stride)
    if pad == "VALID":
        return (size - k) // stride + 1
    lo, hi = pad
    return (size + lo + hi - k) // stride + 1


def _axis_pads(padding, n_axes: int):
    """Normalize a padding spec to per-axis entries for _conv_out_dim."""
    if isinstance(padding, str):
        return [padding] * n_axes
    return list(padding)


def _pad_pairs(padding, sizes, window, strides) -> List[Tuple[int, int]]:
    """Per spatial axis, the (low, high) pad of a padding spec: XLA's
    "SAME" puts the odd one of the total on the high side."""
    out = []
    for pad, n, k, s in zip(_axis_pads(padding, 2), sizes, window, strides):
        if pad == "SAME":
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        elif pad == "VALID":
            out.append((0, 0))
        else:
            out.append((int(pad[0]), int(pad[1])))
    return out


def _norm_padding(padding):
    return padding if isinstance(padding, str) else \
        tuple((int(a), int(b)) for a, b in padding)


def _nchw_padded(x: torch.Tensor, pads, window, value: float):
    """The NCHW view of an NHWC ``x`` and the symmetric ``padding=`` the
    torch op takes: pads it cannot express (uneven, or more than half the
    window for a pool) are applied first with ``value``, a copy."""
    v = x.permute(0, 3, 1, 2)
    (t, b), (l, r) = pads
    if t == b and l == r and t <= window[0] // 2 and l <= window[1] // 2:
        return v, (t, l)
    if t or b or l or r:
        v = F.pad(v, (l, r, t, b), value=value)
    return v, (0, 0)


class Conv2D(Module):
    """NHWC conv with an HWIO ``kernel`` (``[kh, kw, cin, cout]``), the
    reference's layout; inputs and kernel in ``matmul_dtype()``, which is
    also the result's dtype (as the reference's, which asks XLA for no wider
    result). ``padding``: "SAME" | "VALID" | explicit ((top, bottom),
    (left, right)) — the explicit form is exact for frameworks that pad
    symmetrically where SAME splits the remainder low/high (torch
    transplants, ``torch_import.py``). ``kernel_size`` is the reference's
    ``kernel`` tuple (here ``kernel`` names the parameter)."""

    #: parameters a mesh step may hand over split over ``tensor``
    tensor_parallel = ("kernel",)

    def __init__(self, features: int, kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), padding="SAME",
                 use_bias: bool = False):
        super().__init__()
        self.features = features
        self.kernel_size = tuple(kernel)
        self.strides = tuple(strides)
        self.padding = _norm_padding(padding)
        self.use_bias = use_bias

    def init(self, gen, in_shape):
        h, w, c = in_shape
        kh, kw = self.kernel_size
        std = torch.tensor(math.sqrt(2.0 / (kh * kw * c)), dtype=torch.float32)
        self.kernel = _param(torch.randn(kh, kw, c, self.features,
                                         generator=gen) * std)
        if self.use_bias:
            self.bias = _param(torch.zeros(self.features))
        ph, pw = _axis_pads(self.padding, 2)
        return (_conv_out_dim(h, kh, self.strides[0], ph),
                _conv_out_dim(w, kw, self.strides[1], pw), self.features)

    def forward(self, x):
        dt = compute_dtype()
        pads = _pad_pairs(self.padding, x.shape[1:3], self.kernel_size,
                          self.strides)
        v, sym = _nchw_padded(x.to(dt), pads, self.kernel_size, 0.0)
        # OIHW view of the kernel, laid out channels-last as the input is
        w = self.kernel.permute(3, 2, 0, 1).to(
            dt, memory_format=torch.channels_last)
        with full_f32(dt):
            y = F.conv2d(v, w, stride=self.strides, padding=sym)
        y = y.permute(0, 2, 3, 1)
        if self.kernel.shape[-1] != self.features:   # column-parallel
            y = _tensor_gather(y)
        if self.use_bias:
            y = y + self.bias.to(y.dtype)
        return y

    def extra_repr(self) -> str:
        return (f"features={self.features}, kernel={self.kernel_size}, "
                f"strides={self.strides}, padding={self.padding!r}, "
                f"use_bias={self.use_bias}")


class Dense(Module):
    """``y = x @ kernel + bias`` on the last dim. ``kernel`` keeps the
    reference's ``[in, out]`` layout (not ``nn.Linear``'s ``[out, in]``), so
    weights carry over without a transpose."""

    tensor_parallel = ("kernel",)

    def __init__(self, features: int, use_bias: bool = True):
        super().__init__()
        self.features = features
        self.use_bias = use_bias

    def init(self, gen, in_shape):
        d = in_shape[-1]
        w = torch.randn(d, self.features, generator=gen) \
            * torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
        self.kernel = _param(w)
        if self.use_bias:
            self.bias = _param(torch.zeros(self.features))
        return tuple(in_shape[:-1]) + (self.features,)

    def forward(self, x):
        dt = compute_dtype()
        y = matmul(x, self.kernel, dt)   # f32, or f64 for f64 operands
        if self.kernel.shape[-1] != self.features:   # column-parallel
            y = _tensor_gather(y)
        if self.use_bias:
            y = y + self.bias
        return y

    def extra_repr(self) -> str:
        return f"features={self.features}, use_bias={self.use_bias}"


class BatchNorm(Module):
    """BatchNorm over the last (channel) dim: the moving statistics at
    inference; in training the batch's, in f32 over every other dim
    (population variance), which it writes, detached, into
    ``stats_out[_path]`` for the train step's moving-average update.
    ``inv`` and ``shift`` are computed in f32 and rounded to ``x``'s dtype
    before ``x * inv + shift``, as the reference's."""

    def __init__(self, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps

    def init(self, gen, in_shape):
        c = in_shape[-1]
        self.scale = _param(torch.ones(c))
        self.bias = _param(torch.zeros(c))
        self.mean = _param(torch.zeros(c))
        self.var = _param(torch.ones(c))
        return tuple(in_shape)

    def forward(self, x, train: bool = False,
                stats_out: Optional[Dict[str, Any]] = None, _path: str = ""):
        if train:
            dims = tuple(range(x.dim() - 1))
            xf = x.to(torch.float32)
            mesh = current_mesh()
            if mesh is None:
                mean = xf.mean(dim=dims)
                var = ((xf - mean) ** 2).mean(dim=dims)
            else:
                mean, var = _global_moments(xf, dims, mesh)
            if stats_out is not None:
                # the statistics feed the moving averages, not the loss
                stats_out[_path] = (mean.detach(), var.detach())
        else:
            mean, var = self.mean, self.var
        inv = self.scale * torch.reciprocal(torch.sqrt(var + self.eps))
        shift = self.bias - mean * inv
        return x * inv.to(x.dtype) + shift.to(x.dtype)

    def extra_repr(self) -> str:
        return f"momentum={self.momentum}, eps={self.eps}"


def _global_moments(xf: torch.Tensor, dims, mesh):
    """Mean and population variance over ``dims`` of the whole batch, whose
    row blocks the batch group holds: the sum, then the sum of squared
    deviations from the global mean, each summed over the group."""
    from ..parallel.mesh import BATCH, all_reduce_axis

    n = xf.numel() // xf.shape[-1] * mesh.axis_size(BATCH)
    mean = all_reduce_axis(xf.sum(dim=dims), mesh, BATCH) / n
    sq = all_reduce_axis(((xf - mean) ** 2).sum(dim=dims), mesh, BATCH)
    return mean, sq / n


class MaxPool(Module):
    """Max pooling on NHWC; ``padding`` like Conv2D's. Pads are -inf (pure
    window semantics)."""

    def __init__(self, window: Tuple[int, int] = (2, 2),
                 strides: Optional[Tuple[int, int]] = None, padding="SAME"):
        super().__init__()
        self.window = tuple(window)
        self.strides = tuple(strides or window)
        self.padding = _norm_padding(padding)

    def init(self, gen, in_shape):
        h, w, c = in_shape
        ph, pw = _axis_pads(self.padding, 2)
        return (_conv_out_dim(h, self.window[0], self.strides[0], ph),
                _conv_out_dim(w, self.window[1], self.strides[1], pw), c)

    def forward(self, x):
        pads = _pad_pairs(self.padding, x.shape[1:3], self.window,
                          self.strides)
        v, sym = _nchw_padded(x, pads, self.window, -math.inf)
        return F.max_pool2d(v, self.window, self.strides,
                            padding=sym).permute(0, 2, 3, 1)

    def extra_repr(self) -> str:
        return (f"window={self.window}, strides={self.strides}, "
                f"padding={self.padding!r}")


class GlobalAvgPool(Module):
    """[B, H, W, C] -> the f32 mean over H and W, [B, C]."""

    def init(self, gen, in_shape):
        return (in_shape[-1],)

    def forward(self, x):
        return x.to(torch.float32).mean(dim=(1, 2))


class Residual(Module):
    """``y = act(body(x) + shortcut(x))``; the shortcut projects when shapes
    change. ``activation``: "relu" (ResNet convention) or None (pre-norm
    transformer blocks, where the residual stream stays linear)."""

    is_container = True

    def __init__(self, body: Sequential, shortcut: Optional[Sequential] = None,
                 activation: Optional[str] = "relu"):
        super().__init__()
        self.body = body
        self.shortcut = shortcut
        self.activation = activation

    def init(self, gen, in_shape):
        in_shape = tuple(in_shape)
        out_shape = self.body.init(gen, in_shape)
        if self.shortcut is not None:
            s_shape = self.shortcut.init(gen, in_shape)
            if s_shape != out_shape:
                raise ValueError(f"Residual shapes differ: {s_shape} vs {out_shape}")
        elif in_shape != out_shape:
            raise ValueError(
                f"Residual needs a projection shortcut: {in_shape} -> {out_shape}")
        return out_shape

    def forward(self, x, train: bool = False, taps: Optional[Set[str]] = None,
                taps_out: Optional[Dict[str, Any]] = None,
                stats_out: Optional[Dict[str, Any]] = None, _prefix: str = ""):
        y = self.body(x, train=train, taps=taps, taps_out=taps_out,
                      stats_out=stats_out, _prefix=_prefix + "body/")
        s = x
        if self.shortcut is not None:
            s = self.shortcut(x, train=train, taps=taps, taps_out=taps_out,
                              stats_out=stats_out,
                              _prefix=_prefix + "shortcut/")
        out = y + s
        if self.activation == "relu":
            out = torch.clamp_min(out, 0)
        return out

    def layer_paths(self, prefix: str = "") -> List[str]:
        out = self.body.layer_paths(prefix + "body/")
        if self.shortcut is not None:
            out.extend(self.shortcut.layer_paths(prefix + "shortcut/"))
        return out

    def extra_repr(self) -> str:
        return f"activation={self.activation!r}"


# ---------------------------------------------------------------------------
# FunctionModel: the SerializableFunction-equivalent handle
# ---------------------------------------------------------------------------


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {"a.b.c": leaf} (``named_parameters``' keys)."""
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


@dataclasses.dataclass(eq=False)
class FunctionModel:
    """A module with named inputs/outputs — the unit DNNModel evaluates.

    The reference's ``FunctionModel(module, params, input_shape, ...)``
    holds its params beside a pure module; here the module owns its
    parameters, so the constructor takes no ``params``, and ``params`` is a
    read-only nested view of them keyed like the reference's pytree.

    ``layer_names``: ordered tap paths from the head backwards
    (``OUTPUT_i`` addressing).
    """

    module: Module
    input_shape: Tuple[int, ...]
    layer_names: List[str] = dataclasses.field(default_factory=list)
    name: str = "model"
    # image-input layout: the native modules are NHWC; an imported ONNX
    # backbone is NCHW (ImageFeaturizer orients the pixels by it)
    data_format: str = "NHWC"
    # device -> (parameter identity/version key, {name: tensor on device})
    _device_params: Dict[str, Tuple[Tuple, Dict[str, torch.Tensor]]] = \
        dataclasses.field(default_factory=dict, init=False, repr=False)

    def __getstate__(self):
        # a saved stage pickles the module and its weights, never the
        # per-device copies
        state = dict(self.__dict__)
        state["_device_params"] = {}
        return state

    @property
    def params(self) -> Dict[str, Any]:
        """The parameters as nested dicts, keyed like the reference's
        params pytree (``{"block0": {"attn": {"body": ...}}}``)."""
        return _nest(dict(self.module.named_parameters()))

    def num_params(self) -> int:
        return self.module.num_params()

    def cache_token(self) -> str:
        """Stable identity of the computation for compile-cache keys: the
        architecture (the module tree's structural repr: layer classes,
        names and settings), the input/output addressing and the parameter
        names, shapes and dtypes — not the weight values."""
        spec = tuple((n, tuple(p.shape), str(p.dtype))
                     for n, p in self.module.named_parameters())
        blob = repr((repr(self.module), tuple(self.input_shape),
                     tuple(self.layer_names), self.name, self.data_format,
                     spec)).encode()
        return "m:" + hashlib.sha256(blob).hexdigest()[:20]

    def device_params(self, device) -> Dict[str, torch.Tensor]:
        """The parameters on ``device`` (the reference's ``device_put`` of
        its params): the module's own tensors where they already are there,
        else copies, kept until a parameter is replaced or changed in place
        (its version counter moves)."""
        dev = torch.device(device)
        named = dict(self.module.named_parameters())
        key = tuple((n, p.data_ptr(), p._version) for n, p in named.items())
        hit = self._device_params.get(str(dev))
        if hit is not None and hit[0] == key:
            return hit[1]
        with torch.no_grad():
            placed = {n: p.detach().to(dev) for n, p in named.items()}
        self._device_params[str(dev)] = (key, placed)
        return placed

    def argument_names(self) -> List[str]:
        """Graph input names (multi-input graphs list all of them)."""
        names = getattr(self.module, "input_names", None)
        return list(names) if names else ["ARGUMENT_0"]

    def resolve_input(self, node: str) -> str:
        """``ARGUMENT_i`` or a raw graph input name -> the input's name."""
        names = self.argument_names()
        if node.startswith("ARGUMENT_"):
            suffix = node[len("ARGUMENT_"):]
            if not suffix.isdigit() or int(suffix) >= len(names):
                raise KeyError(
                    f"{node!r}: model has {len(names)} argument(s) ({names}); "
                    f"valid indices are 0..{len(names) - 1}")
            return names[int(suffix)]
        if node in names:
            return node
        raise KeyError(f"Unknown input node {node!r}; known: {names} "
                       f"or ARGUMENT_i")

    def output_names(self) -> List[str]:
        return ["OUTPUT_0"] + list(self.layer_names)

    def resolve_output(self, node: Optional[str]) -> Optional[str]:
        """A layer path, ``OUTPUT_i`` or None -> a tap path (None = the
        final output)."""
        if node is None or node == "OUTPUT_0" or node == self.name:
            return None
        if node.startswith("OUTPUT_"):
            i = int(node.split("_", 1)[1])
            return self.layer_names[i - 1] if i > 0 else None
        paths = set(self.module.layer_paths())
        if node in paths:
            return node
        raise KeyError(f"Unknown output node {node!r}; known: OUTPUT_i, "
                       f"{sorted(paths)[:20]}...")

    def _forward(self, x, params, **kwargs):
        if params is None:
            return self.module(x, **kwargs)
        return torch.func.functional_call(self.module, params, (x,), kwargs)

    def apply(self, x, tap: Optional[str] = None, train: bool = False,
              params: Optional[Dict[str, torch.Tensor]] = None):
        """Forward pass (under ``torch.inference_mode`` unless ``train``);
        with ``tap``, that layer's activation instead of the output.
        ``params`` ({name: tensor}, e.g. ``device_params(dev)``) stand in for
        the module's own."""
        return self.apply_taps(x, [tap], train=train, params=params)[tap]

    def apply_taps(self, x, taps, train: bool = False,
                   params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[Optional[str], Any]:
        """ONE forward pass fetching several nodes (fetchDict parity).
        ``taps`` lists tap paths, None meaning the final output; returns
        {tap: activation}."""
        real = {t for t in taps if t is not None}
        taps_out: Dict[str, Any] = {}
        # containers take ``train`` (BatchNorm's batch statistics)
        kw = {"train": train} if self.module.is_container else {}
        with torch.inference_mode(not train):
            if real:
                if not self.module.is_container:
                    raise ValueError(
                        "taps need a container root (Sequential/GraphModule)")
                out = self._forward(x, params, taps=real, taps_out=taps_out,
                                    **kw)
            else:
                out = self._forward(x, params, **kw)
        missing = real - set(taps_out)
        if missing:
            raise KeyError(f"Taps {sorted(missing)} not produced; known "
                           f"{self.module.layer_paths()[:20]}")
        result: Dict[Optional[str], Any] = dict(taps_out)
        if None in list(taps):
            result[None] = out
        return result
