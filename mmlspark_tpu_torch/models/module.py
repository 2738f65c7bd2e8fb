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
    paths asked for ("block0/attn", "block0/mlp/body/fc1", ...), so one
    forward can fetch several nodes (``FunctionModel.apply_taps``);
  - bf16 products with f32 results: ``matmul_dtype()`` (a context variable,
    bf16 by default, ``matmul_precision("float32")`` for exact comparisons)
    is the operand dtype of ``Dense`` and the attention projections. The
    reference asks XLA for ``preferred_element_type=f32``; here the operands
    are rounded to bf16 and multiplied in f32, which gives the same products
    (a bf16 x bf16 product is exact in f32) summed in f32. A float32 product
    needs TF32 off, PyTorch's default.

The container layers' forward takes ``stats_out``, the reference's side
channel for BatchNorm's batch statistics in training (``training.py``); no
ported layer fills it yet.

Not ported yet: the activation-sharding hooks (``activation_sharding``
raises; mesh only, ROADMAP A9), and ``Conv2D``, ``BatchNorm``, ``MaxPool``
and ``GlobalAvgPool`` with the image half of ROADMAP A7.
"""

from __future__ import annotations

import contextvars
import dataclasses
import hashlib
import math
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Set, Tuple)

import torch
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


class activation_sharding:
    """The reference's trace-time anchor of activations to a mesh sharding
    (multi-device training): not ported, raises (ROADMAP A9)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "activation_sharding is mesh training: ROADMAP A9")


def compute_dtype() -> torch.dtype:
    """``matmul_dtype()`` as a torch dtype."""
    return _DTYPES[matmul_dtype()]


def matmul(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``jnp.dot(x.astype(dt), w.astype(dt), preferred_element_type=f32)``
    (f64 for f64 operands): operands rounded to ``dt``, product and sums in
    the wider type."""
    acc = torch.float64 if dt == torch.float64 else torch.float32
    return torch.matmul(x.to(dt).to(acc), w.to(dt).to(acc))


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

    def forward(self, x, taps: Optional[Set[str]] = None,
                taps_out: Optional[Dict[str, Any]] = None,
                stats_out: Optional[Dict[str, Any]] = None, _prefix: str = ""):
        for lname, layer in self.layers:
            path = f"{_prefix}{lname}"
            if layer.is_container:
                x = layer(x, taps=taps, taps_out=taps_out, stats_out=stats_out,
                          _prefix=path + "/")
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


class Dense(Module):
    """``y = x @ kernel + bias`` on the last dim. ``kernel`` keeps the
    reference's ``[in, out]`` layout (not ``nn.Linear``'s ``[out, in]``), so
    weights carry over without a transpose."""

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
        if self.use_bias:
            y = y + self.bias
        return y

    def extra_repr(self) -> str:
        return f"features={self.features}, use_bias={self.use_bias}"


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

    def forward(self, x, taps: Optional[Set[str]] = None,
                taps_out: Optional[Dict[str, Any]] = None,
                stats_out: Optional[Dict[str, Any]] = None, _prefix: str = ""):
        y = self.body(x, taps=taps, taps_out=taps_out, stats_out=stats_out,
                      _prefix=_prefix + "body/")
        s = x
        if self.shortcut is not None:
            s = self.shortcut(x, taps=taps, taps_out=taps_out,
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
                     tuple(self.layer_names), self.name, spec)).encode()
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
        with torch.inference_mode(not train):
            if real:
                if not self.module.is_container:
                    raise ValueError(
                        "taps need a container root (Sequential/GraphModule)")
                out = self._forward(x, params, taps=real, taps_out=taps_out)
            else:
                out = self._forward(x, params)
        missing = real - set(taps_out)
        if missing:
            raise KeyError(f"Taps {sorted(missing)} not produced; known "
                           f"{self.module.layer_paths()[:20]}")
        result: Dict[Optional[str], Any] = dict(taps_out)
        if None in list(taps):
            result[None] = out
        return result
