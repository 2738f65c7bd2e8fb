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

Not ported: the mesh (``mesh=``, ``param_sharding_rules``,
``batch_sharding``) raises ``NotImplementedError`` naming ROADMAP A9.
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

_MESH_TODO = "mesh-sharded training is multi-GPU work: ROADMAP A9"


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
    like the reference's params tree; ``step``: steps taken."""

    params: Dict[str, Any]
    opt_state: Dict[str, Any]
    step: int


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
                    bn_momentum: float = 0.9) -> Callable:
    """``(state, batch) -> (state, metrics)``: the batch is a dict with
    ``x``, ``y`` and optionally ``mask`` (arrays or tensors, moved to the
    params' device); metrics are ``loss`` and ``accuracy`` (0-dim
    tensors)."""

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        metrics, stats, grads = loss_and_grads(module, state.params, batch)
        with torch.no_grad():
            params, opt_state = optimizer.update(grads, state.opt_state,
                                                 state.params)
            if stats:
                params = _apply_bn_ema(_tree_map(lambda v: v, params), stats,
                                       bn_momentum)
        return TrainState(params, opt_state, state.step + 1), metrics

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


def param_sharding_rules(params, mesh):
    """Not ported: mesh training (ROADMAP A9)."""
    raise NotImplementedError(_MESH_TODO)


def batch_sharding(mesh):
    """Not ported: mesh training (ROADMAP A9)."""
    raise NotImplementedError(_MESH_TODO)


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


def init_train_state(module: Module, in_shape, optimizer: SGD, seed: int = 0,
                     mesh=None, device=None) -> TrainState:
    """Initialize the module's parameters from a ``torch.Generator`` seeded
    with ``seed`` (other numbers than the reference's ``jax.random``) and
    the optimizer state, on ``device`` (default: ``cuda`` unless the caller
    asked for the CPU)."""
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    module.init(torch.Generator().manual_seed(seed), tuple(in_shape))
    params = params_of(module, device)
    return TrainState(params, optimizer.init(params), 0)


def compile_train_step(module: Module, optimizer: SGD, mesh=None) -> Callable:
    """The train step, eager (PyTorch has no counterpart of ``jax.jit``
    that the step needs). ``mesh`` raises (ROADMAP A9)."""
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    return make_train_step(module, optimizer)
