"""Training step, optimizer, and the train loop with checkpoint, resume and
preemption (the port of ``mmlspark_tpu/models/training.py``).

The reference's step is a pure function over a params pytree, differentiated
by ``jax.value_and_grad`` and jitted; here it is the same function in eager
PyTorch: the module runs under ``torch.func.functional_call`` with the
state's parameters, ``torch.autograd.grad`` takes the gradient, and the
optimizer returns new tensors (the state is never updated in place, so a
state handed to ``step`` stays as it was, as the reference's does).

  - ``TrainState``: ``params`` as nested dicts of tensors keyed like the
    reference's params tree (``{"block0": {"attn": {"body": ...}}}``),
    ``opt_state`` (``{"trace": <the same tree>}``, optax's momentum trace)
    and ``step`` (an int);
  - ``make_optimizer``: the reference's optax chain written out, in its
    order: ``g + wd * p`` on the leaves of two or more dims
    (``_decay_mask``), ``trace = g + momentum * trace``, ``p + (-lr) *
    trace``;
  - ``make_train_step``: the mean softmax cross-entropy of the module's
    logits (``[B, K]`` or per-token ``[B, T, K]``, with an optional mask)
    from a forward with ``train=True``, its gradient, the update, and
    BatchNorm's moving statistics folded in from ``stats_out``
    (``_apply_bn_ema``: ``BatchNorm`` fills it with its batch statistics);
  - ``run_train_loop``: the step over a batch stream with checkpoints every
    ``every_k`` steps and on preemption (``PreemptionGuard``), resume from
    a checkpoint skipping the trained prefix, the ``TRAIN_STEP`` fault
    point and the ``dnn`` series of ``obs.metrics.TrainRecorder``.

Attention in a step runs through K5, K6 and K7 where the flash gate admits
it (``attention.dense_attention``). Deterministic: the kernels use no
atomics, and the step runs under PyTorch's deterministic algorithms so that
its own accumulating backward ops (``Embed``'s row gather adds its rows
back with ``index_put_``, by parallel atomic adds on the CPU) sum in a fixed
order; a resumed run then gives the uninterrupted run's bits, on the CPU
and on the card.

On a mesh (``parallel.mesh``, one process a rank): ``param_sharding_rules``
is the reference's placement (a conv kernel's cin and a dense kernel's din
over ``fsdp``, their cout/dout over ``tensor``, where the axis divides the
dim), ``init_train_state(mesh=)`` keeps a rank's blocks of the params and
the trace, and ``compile_train_step(mesh=)`` is the sharded step
(``make_train_step(mesh=)``): the rank's row block of the batch
(``batch_sharding``: over data x fsdp), the weights gathered over ``fsdp``
before use (their gradients reduce-scattered back by the gather's
backward), ``Dense``/``Conv2D``/attention column-parallel over ``tensor``
under ``module.activation_sharding``, BatchNorm's statistics and the
loss, mask count and accuracy over the whole batch, and each gradient
summed over the ranks that hold the same block of its leaf. Every rank's
loss is its share of one sum (its rows' terms over the global count,
divided by the ranks that hold the same rows), so each collective's
backward is its plain adjoint and the step equals the single-device one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal as _signal
import threading
import time as _time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..core import faults
from ..runtime import resolve_device
from .module import (Module, Sequential, _flatten, _nest, compute_dtype,
                     full_f32)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy in f32; labels are int class ids over the
    leading dims ([B, K] logits with [B] labels, or per-token [B, T, K] with
    [B, T]); ``mask`` (the labels' shape) leaves padded rows or tokens
    out."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    idx = labels.to(torch.int32).to(torch.int64)[..., None]
    ll = torch.gather(logits, -1, idx)[..., 0] - lse
    if mask is not None:
        m = mask.to(torch.float32)
        return -(ll * m).sum() / torch.clamp_min(m.sum(), 1.0)
    return -ll.mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Share of argmax hits (masked as ``cross_entropy_loss``)."""
    hit = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
    if mask is not None:
        m = mask.to(torch.float32)
        return (hit * m).sum() / torch.clamp_min(m.sum(), 1.0)
    return hit.mean()


@dataclasses.dataclass
class TrainState:
    """``params`` and ``opt_state["trace"]``: nested dicts of tensors keyed
    like the reference's params tree; ``step``: steps taken. On a mesh,
    ``mesh`` and ``shardings`` (a ``ShardSpec`` tree like ``params``) say
    which block of each leaf the tensors are."""

    params: Dict[str, Any]
    opt_state: Dict[str, Any]
    step: int
    mesh: Any = None
    shardings: Optional[Dict[str, Any]] = None


def _tree_map(fn: Callable, tree: Dict[str, Any], *rest: Dict[str, Any]):
    """``fn`` over the leaves of nested dicts of the same keys."""
    return {k: (_tree_map(fn, v, *(r[k] for r in rest))
                if isinstance(v, dict) else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def _decay_mask(params: Dict[str, Any]) -> Dict[str, Any]:
    """Weight decay touches matmul and conv kernels only: leaves of two or
    more dims (never biases, norm scales or BatchNorm statistics)."""
    return _tree_map(lambda leaf: np.ndim(leaf) >= 2, params)


class SGD:
    """The reference's ``make_optimizer`` chain (optax's
    ``add_decayed_weights`` with ``_decay_mask``, then ``sgd`` with
    momentum) as one update, in optax's order and f32 arithmetic."""

    def __init__(self, learning_rate: float, momentum: float,
                 weight_decay: float):
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)

    def init(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return {"trace": _tree_map(torch.zeros_like, params)}

    def update(self, grads: Dict[str, Any], opt_state: Dict[str, Any],
               params: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(new params, new optimizer state); nothing is updated in place."""
        wd, mu, step = self.weight_decay, self.momentum, -self.learning_rate

        def one(g, t, p, decay):
            if wd and decay:
                g = g + wd * p
            t = g + mu * t
            return t, p + step * t

        out = _tree_map(one, grads, opt_state["trace"], params,
                        _decay_mask(params))
        trace = _tree_map(lambda pair: pair[0], out)
        return _tree_map(lambda pair: pair[1], out), {"trace": trace}


def make_optimizer(learning_rate: float = 0.1, momentum: float = 0.9,
                   weight_decay: float = 0.0) -> SGD:
    return SGD(learning_rate, momentum, weight_decay)


def _apply_bn_ema(params: Dict[str, Any], stats: Dict[str, Any],
                  momentum: float) -> Dict[str, Any]:
    """Fold batch statistics into the BatchNorm moving mean/var params.

    ``stats`` is keyed by layer path ("stem/bn", "layer1/0/body/bn1", ...);
    each path addresses a nested params dict holding {"mean", "var"}, which
    is replaced by a new dict in its parent (the step passes a copy of the
    tree's dicts, so the state it was given keeps its own)."""
    for path, (mean, var) in stats.items():
        node = params
        keys = path.split("/")
        for k in keys[:-1]:
            node = node[k]
        bn = dict(node[keys[-1]])
        bn["mean"] = momentum * bn["mean"] + (1 - momentum) * mean
        bn["var"] = momentum * bn["var"] + (1 - momentum) * var
        node[keys[-1]] = bn
    return params


def _device_of(params: Dict[str, Any]) -> torch.device:
    return next(iter(_flatten(params).values())).device


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.asarray(x)).to(device)


@contextlib.contextmanager
def _deterministic(device: torch.device):
    """PyTorch's deterministic algorithms for a step (on the card cuBLAS
    needs its workspace setting for them), restored afterwards. Without
    them ``index_put_`` with accumulation, ``Embed``'s backward, adds its
    rows in another order from call to call, on the CPU (parallel atomic
    adds) and on the card."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def loss_and_grads(module: Module, params: Dict[str, Any],
                   batch: Dict[str, Any]):
    """(metrics, stats, grads) of ``module`` under ``params`` on a batch
    (``x``, ``y``, optional ``mask``, moved to the params' device): the
    reference's ``jax.value_and_grad`` of the mean cross-entropy, with
    ``metrics`` its ``loss`` and ``accuracy`` (0-dim tensors), ``stats``
    what the layers put in ``stats_out`` and ``grads`` a tree like
    ``params``."""
    device = _device_of(params)
    x = _as_tensor(batch["x"], device)
    y = _as_tensor(batch["y"], device)
    mask = batch.get("mask")
    mask = None if mask is None else _as_tensor(mask, device)
    leaves = {n: p.detach().requires_grad_(True)
              for n, p in _flatten(params).items()}
    stats: Dict[str, Any] = {}
    kwargs: Dict[str, Any] = {}
    if module.is_container:
        kwargs["train"] = True
    if isinstance(module, Sequential):
        kwargs["stats_out"] = stats
    # the backward's convolutions run after the forward's TF32 guard: the
    # whole step sits under it
    with _deterministic(device), torch.enable_grad(), \
            full_f32(compute_dtype()):
        logits = torch.func.functional_call(module, leaves, (x,), kwargs)
        loss = cross_entropy_loss(logits, y, mask)
        # BatchNorm's moving statistics take no part in a training forward:
        # their gradient is zero, as under jax.grad
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves.values())]
    with torch.no_grad():
        metrics = {"loss": loss.detach(), "accuracy": accuracy(logits, y, mask)}
    return metrics, stats, _nest(dict(zip(leaves, grads)))


def make_train_step(module: Module, optimizer: SGD,
                    bn_momentum: float = 0.9, mesh=None) -> Callable:
    """``(state, batch) -> (state, metrics)``: the batch is a dict with
    ``x``, ``y`` and optionally ``mask`` (arrays or tensors, moved to the
    params' device); metrics are ``loss`` and ``accuracy`` (0-dim
    tensors). With ``mesh``, the sharded step (``_mesh_loss_and_grads``):
    ``state`` holds a rank's blocks (``init_train_state(mesh=)``) and
    ``batch`` is the whole batch, every rank the same; the optimizer
    updates the blocks, and weight decay follows ``_decay_mask`` on the
    leaves' ndim, which a block keeps."""

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if mesh is None:
            metrics, stats, grads = loss_and_grads(module, state.params,
                                                   batch)
        elif state.shardings is None:
            raise ValueError("a mesh step takes a state made on the mesh "
                             "(init_train_state(mesh=) or a checkpoint "
                             "loaded onto one)")
        else:
            metrics, stats, grads = _mesh_loss_and_grads(
                module, state.params, state.shardings, batch, mesh)
        with torch.no_grad():
            params, opt_state = optimizer.update(grads, state.opt_state,
                                                 state.params)
            if stats:
                params = _apply_bn_ema(_tree_map(lambda v: v, params), stats,
                                       bn_momentum)
        return dataclasses.replace(state, params=params, opt_state=opt_state,
                                   step=state.step + 1), metrics

    return step


class PreemptionGuard:
    """Turns a preemption signal (SIGTERM: what a cloud host sends before a
    maintenance event or a spot reclaim) into a flag the training loop polls
    between steps, so the loop checkpoints and exits cleanly instead of
    dying mid-step.

    ``request()`` triggers the same path programmatically. Installing the
    handler only works on the main thread; elsewhere the guard keeps the
    programmatic path only."""

    def __init__(self, signals: Tuple[int, ...] = (_signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._prev: Dict[int, Any] = {}

    def request(self) -> None:
        self._event.set()

    def requested(self) -> bool:
        return self._event.is_set()

    def __enter__(self) -> "PreemptionGuard":
        for sig in self.signals:
            try:
                self._prev[sig] = _signal.signal(
                    sig, lambda *_: self._event.set())
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev.items():
            try:
                _signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev.clear()


@dataclasses.dataclass
class TrainLoopResult:
    state: TrainState
    steps_run: int
    preempted: bool
    last_metrics: Optional[Dict[str, float]]


def _batch_rows(batch) -> Optional[int]:
    """Leading-dim row count of a step batch (tuple/dict/array trees);
    None when nothing array-like is found."""
    if isinstance(batch, (tuple, list)) and batch:
        return _batch_rows(batch[0])
    if isinstance(batch, dict) and batch:
        return _batch_rows(next(iter(batch.values())))
    shape = getattr(batch, "shape", None)
    if shape:
        return int(shape[0])
    return None


def run_train_loop(state: TrainState, step_fn: Callable, batches: Iterable,
                   *, checkpoint_path: Optional[str] = None,
                   every_k: int = 100,
                   guard: Optional[PreemptionGuard] = None,
                   resume: bool = True,
                   log: Optional[Callable[[str], None]] = None,
                   registry=None) -> TrainLoopResult:
    """Drive ``step_fn`` over ``batches`` with checkpoint/resume and a
    preemption hook (the DNN counterpart of the GBDT checkpointed fit).

    ``checkpoint_path``: the TrainState is saved there every ``every_k``
    steps and on preemption (``checkpoint.save_train_state``).
    ``resume=True`` restores it when present (onto ``state``'s devices) and
    skips the already-trained prefix of ``batches`` by the restored step
    counter, so a deterministic batch stream replays the uninterrupted
    schedule. ``guard``: a PreemptionGuard polled between steps; when it
    fires, the loop checkpoints once more and returns ``preempted=True``.

    ``registry``: obs MetricsRegistry receiving the per-step series
    (``mmlspark_train_*{engine="dnn"}``: step time, examples/s, loss,
    checkpoint latency); defaults to the process-wide registry."""
    from ..obs.metrics import TrainRecorder
    from .checkpoint import load_train_state, save_train_state

    recorder = TrainRecorder("dnn", registry=registry)

    def _save_timed(st):
        t0 = _time.perf_counter()
        save_train_state(st, checkpoint_path)
        recorder.checkpoint(_time.perf_counter() - t0)

    start_step = 0
    if checkpoint_path is not None and resume \
            and os.path.exists(checkpoint_path):
        state = load_train_state(checkpoint_path, like=state)
        start_step = int(state.step)
        if log:
            log(f"resumed from {checkpoint_path} at step {start_step}")

    steps_run = 0
    metrics_out: Optional[Dict[str, Any]] = None
    dirty = False  # steps since the last save
    preempted = False
    for i, batch in enumerate(batches):
        if i < start_step:
            continue  # replayed prefix: already folded into the checkpoint
        if guard is not None and guard.requested():
            preempted = True
            break
        faults.fire(faults.TRAIN_STEP, step=i, engine="dnn")
        t_step = _time.perf_counter()
        state, metrics = step_fn(state, batch)
        dur = _time.perf_counter() - t_step
        steps_run += 1
        dirty = True
        metrics_out = metrics
        recorder.step(dur, examples=_batch_rows(batch),
                      loss=(metrics or {}).get("loss"))
        if checkpoint_path is not None and steps_run % max(every_k, 1) == 0:
            _save_timed(state)
            dirty = False
    else:
        if guard is not None and guard.requested():
            preempted = True
    if checkpoint_path is not None and (dirty or preempted):
        _save_timed(state)
    if metrics_out is not None:
        metrics_out = {k: float(v) for k, v in metrics_out.items()}
    return TrainLoopResult(state=state, steps_run=steps_run,
                           preempted=preempted, last_metrics=metrics_out)


def params_of(module: Module, device=None) -> Dict[str, Any]:
    """The module's parameters as a nested params tree of detached copies
    on ``device`` (default: ``cuda`` unless the caller asked for the CPU)."""
    dev = resolve_device(device)
    with torch.no_grad():
        return _nest({n: p.detach().to(dev, copy=True)
                      for n, p in module.named_parameters()})


def assign_params(module: Module, params: Dict[str, Any]) -> Module:
    """Copy a params tree (a trained state's) into the module's own
    parameters, in place, e.g. to serve it through ``DNNModel``; returns
    ``module``."""
    flat = _flatten(params)
    named = dict(module.named_parameters())
    if set(flat) != set(named):
        raise KeyError(f"params do not match the module: "
                       f"{sorted(set(flat) ^ set(named))[:10]}")
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(flat[n])
    return module


def param_sharding_rules(params, mesh) -> Dict[str, Any]:
    """A ``parallel.mesh.ShardSpec`` tree like ``params``, the reference's
    rules: a conv kernel ``[kh, kw, cin, cout]`` splits cin over ``fsdp``
    and cout over ``tensor``, a dense kernel ``[din, dout]`` din over
    ``fsdp`` and dout over ``tensor``; a dim the axis does not divide stays
    whole, and so does every other leaf. Needs only ``mesh.shape``."""
    from ..parallel.mesh import FSDP_AXIS, TENSOR_AXIS, ShardSpec

    fsdp = int(mesh.shape.get(FSDP_AXIS, 1))
    tens = int(mesh.shape.get(TENSOR_AXIS, 1))

    def split(size: int, n: int, axis: str):
        return axis if n > 1 and size % n == 0 else None

    def rule(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 4:
            return ShardSpec((None, None, split(shape[2], fsdp, FSDP_AXIS),
                              split(shape[3], tens, TENSOR_AXIS)), mesh)
        if len(shape) == 2:
            return ShardSpec((split(shape[0], fsdp, FSDP_AXIS),
                              split(shape[1], tens, TENSOR_AXIS)), mesh)
        return ShardSpec((), mesh)

    return _tree_map(rule, params)


def batch_sharding(mesh):
    """The batch's placement: its rows split over (data, fsdp), data major
    (``ShardSpec.local(x)`` is this rank's row block)."""
    from ..parallel.mesh import DATA_AXIS, FSDP_AXIS, ShardSpec

    return ShardSpec(((DATA_AXIS, FSDP_AXIS),), mesh)


def init_train_state(module: Module, in_shape, optimizer: SGD, seed: int = 0,
                     mesh=None, device=None) -> TrainState:
    """Initialize the module's parameters from a ``torch.Generator`` seeded
    with ``seed`` (other numbers than the reference's ``jax.random``) and
    the optimizer state, on ``device`` (default: ``cuda`` unless the caller
    asked for the CPU; the mesh's device with ``mesh``). With ``mesh``,
    each rank keeps its blocks (``param_sharding_rules``) of the params and
    of the trace."""
    module.init(torch.Generator().manual_seed(seed), tuple(in_shape))
    if mesh is None:
        params = params_of(module, device)
        return TrainState(params, optimizer.init(params), 0)
    from ..parallel.mesh import shard_tree

    params = params_of(module, device if device is not None else mesh.device)
    shardings = param_sharding_rules(params, mesh)
    params = shard_tree(params, shardings, mesh)
    return TrainState(params, optimizer.init(params), 0, mesh=mesh,
                      shardings=shardings)


def compile_train_step(module: Module, optimizer: SGD, mesh=None) -> Callable:
    """The train step, eager (PyTorch has no counterpart of ``jax.jit``
    that the step needs). With ``mesh``, the sharded step: every rank calls
    it with a state of ``init_train_state(mesh=)`` (or a checkpoint loaded
    onto one) and the same whole batch, of which it takes its row block."""
    return make_train_step(module, optimizer, mesh=mesh)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


def _owners(module: Module) -> Dict[str, Tuple[Module, str]]:
    """Parameter name -> (the layer that holds it, its attribute)."""
    out = {}
    for prefix, sub in module.named_modules():
        for attr, _ in sub.named_parameters(recurse=False):
            out[f"{prefix}.{attr}" if prefix else attr] = (sub, attr)
    return out


def _column_parallel(owner: Module, attr: str, tensor: int) -> bool:
    """Does ``owner`` take its ``attr`` split over ``tensor`` ranks?"""
    tp = getattr(owner, "tensor_parallel", ())
    names = tp(tensor) if callable(tp) else tp
    return attr in names


def _gather_bucket(items, mesh, axis: str) -> Dict[str, torch.Tensor]:
    """Leaves gathered over ``axis`` along their dims in one collective:
    each rank's blocks flattened into one row, the rows gathered (whose
    backward reduce-scatters the gradients back), each leaf's blocks
    concatenated along its dim. ``items``: (name, block, dim)."""
    from ..parallel.mesh import all_gather_axis, axis_group

    g = axis_group(mesh, axis)
    if g is None or not items:
        return {n: t for n, t, _ in items}
    out: Dict[str, torch.Tensor] = {}
    for dtype in sorted({t.dtype for _, t, _ in items}, key=str):
        part = [(n, t, d) for n, t, d in items if t.dtype == dtype]
        row = torch.cat([t.reshape(-1) for _, t, _ in part])[None]
        full = all_gather_axis(row, mesh, axis, dim=0)      # [ranks, total]
        off = 0
        for n, t, d in part:
            k = t.numel()
            blocks = [full[i, off:off + k].reshape(t.shape)
                      for i in range(g.size)]
            out[n] = torch.cat(blocks, dim=d)
            off += k
    return out


def _forward_params(module: Module, leaves: Dict[str, torch.Tensor],
                    specs: Dict[str, Any], mesh) -> Dict[str, torch.Tensor]:
    """The tensors the forward runs on: every leaf gathered over ``fsdp``;
    over ``tensor`` too, except where its layer runs column-parallel."""
    from ..parallel.mesh import FSDP_AXIS, TENSOR_AXIS

    tensor = int(mesh.shape.get(TENSOR_AXIS, 1))
    owners = _owners(module)
    used = dict(leaves)
    fsdp = [(n, used[n], specs[n].dim_of(FSDP_AXIS)) for n in leaves
            if specs[n].dim_of(FSDP_AXIS) is not None]
    used.update(_gather_bucket(fsdp, mesh, FSDP_AXIS))
    tens = [(n, used[n], specs[n].dim_of(TENSOR_AXIS)) for n in leaves
            if specs[n].dim_of(TENSOR_AXIS) is not None
            and not _column_parallel(*owners[n], tensor)]
    used.update(_gather_bucket(tens, mesh, TENSOR_AXIS))
    return used


def _sum_grads(grads: Dict[str, torch.Tensor], specs: Dict[str, Any], mesh
               ) -> Dict[str, torch.Tensor]:
    """Each gradient summed over every axis its leaf is not split on (the
    ranks that hold the same block), one all-reduce a bucket of leaves of
    the same axes and dtype. (An ``fsdp``-split leaf's gather already
    reduce-scattered its gradient over ``fsdp``.)"""
    from ..parallel.mesh import AXES, axis_group, all_reduce_axis

    buckets: Dict[Tuple, list] = {}
    for n, g in grads.items():
        split = set(specs[n].axes())
        axes = tuple(a for a in AXES if a not in split
                     and axis_group(mesh, a) is not None)
        buckets.setdefault((axes, g.dtype), []).append(n)
    out = dict(grads)
    for (axes, _), names in buckets.items():
        if not axes:
            continue
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        for a in axes:
            flat = all_reduce_axis(flat, mesh, a)
        off = 0
        for n in names:
            k = grads[n].numel()
            out[n] = flat[off:off + k].reshape(grads[n].shape)
            off += k
    return out


def _mesh_loss_and_grads(module: Module, params: Dict[str, Any],
                         shardings: Dict[str, Any], batch: Dict[str, Any],
                         mesh):
    """``loss_and_grads`` on ``mesh``: (global metrics, global BatchNorm
    statistics, this rank's gradient blocks)."""
    from ..parallel.mesh import BATCH, WORLD, all_reduce_axis
    from .module import activation_sharding

    device = _device_of(params)
    rows = batch_sharding(mesh)
    x = rows.local(_as_tensor(batch["x"], device))
    y = rows.local(_as_tensor(batch["y"], device))
    mask = batch.get("mask")
    mask = None if mask is None else rows.local(_as_tensor(mask, device))
    leaves = {n: p.detach().requires_grad_(True)
              for n, p in _flatten(params).items()}
    specs = _flatten(shardings)
    replicas = mesh.axis_size(WORLD) // mesh.axis_size(BATCH)
    stats: Dict[str, Any] = {}
    kwargs: Dict[str, Any] = {}
    if module.is_container:
        kwargs["train"] = True
    if isinstance(module, Sequential):
        kwargs["stats_out"] = stats
    with _deterministic(device), torch.enable_grad(), \
            full_f32(compute_dtype()), activation_sharding(mesh):
        used = _forward_params(module, leaves, specs, mesh)
        logits = torch.func.functional_call(module, used, (x,), kwargs)
        lf = logits.to(torch.float32)
        ll = torch.gather(lf, -1, y.to(torch.int32).to(torch.int64)[..., None]
                          )[..., 0] - torch.logsumexp(lf, dim=-1)
        m = torch.ones_like(ll) if mask is None else mask.to(torch.float32)
        with torch.no_grad():
            count = all_reduce_axis(m.sum(), mesh, BATCH)
            den = torch.clamp_min(count, 1.0)
        num = -(ll * m).sum()
        # this rank's share of the one global loss
        grads = torch.autograd.grad(num / den / replicas,
                                    list(leaves.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(leaves.items(), grads)}
    with torch.no_grad():
        grads = _sum_grads(grads, specs, mesh)
        hit = (torch.argmax(logits, dim=-1) == y).to(torch.float32)
        sums = all_reduce_axis(torch.stack([num.detach(), (hit * m).sum()]),
                               mesh, BATCH)
        metrics = {"loss": sums[0] / den, "accuracy": sums[1] / den}
    return metrics, stats, _nest(grads)
