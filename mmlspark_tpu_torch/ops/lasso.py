"""Lasso by ISTA: LIME's per-row local linear fit (the port of
``mmlspark_tpu.ops.lasso``).

The reference stages fit a lasso per explained row (lime/LIME.scala:158,
fitLassoUDF). Here, as in the JAX package: proximal gradient (ISTA) with a
fixed iteration count over weighted-centred inputs, step 1/trace(XᵀWX),
soft threshold; batched ``[B, n, d]`` with ``torch.bmm`` in f32 (TF32
off), so a partition's rows are fitted in one call.

On the card the 200 iterations are about 800 small launches. A shape's
first call runs them eagerly; its second captures the whole fit in a CUDA
graph (``gbdt.graphs.Replayer``, on the thread's own capture stream) and
every later call of that shape replays it. ``release_graphs()`` frees the
graphs.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from ..gbdt.predict import _full_f32
from ..runtime import DeviceLike, resolve_device


def _soft(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(x.abs() - t, min=0.0)


def _ista(X: torch.Tensor, y: torch.Tensor, sw: torch.Tensor,
          reg: torch.Tensor, iters: int, fit_intercept: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``fit_lasso`` over a batch: X [B, n, d], y [B, n],
    sw [B, n] (unnormalised), reg [B]; returns (w [B, d], b [B])."""
    sw = sw / torch.clamp(sw.sum(1, keepdim=True), min=1e-12)
    if fit_intercept:
        x_mean = (X * sw[..., None]).sum(1)                  # [B, d]
        y_mean = (y * sw).sum(1)                             # [B]
        Xc = X - x_mean[:, None, :]
        yc = y - y_mean[:, None]
    else:
        Xc, yc = X, y
    XwT = (Xc * sw[..., None]).transpose(1, 2)               # [B, d, n]
    # Lipschitz bound for the step: ||X^T W X||_2 <= trace
    L = torch.diagonal(torch.bmm(XwT, Xc), dim1=1, dim2=2).sum(1) + 1e-6
    step = (1.0 / L)[:, None]
    thresh = step * reg[:, None]
    w = torch.zeros(X.shape[0], X.shape[2], dtype=X.dtype, device=X.device)
    for _ in range(iters):
        r = torch.bmm(Xc, w[..., None])[..., 0] - yc
        grad = torch.bmm(XwT, r[..., None])[..., 0]
        w = _soft(w - step * grad, thresh)
    b = (y_mean - (x_mean * w).sum(1)) if fit_intercept \
        else torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
    return w, b


#: (device, stream, shape, iters, fit_intercept) -> (lock, Replayer)
_runs: Dict[tuple, tuple] = {}
_runs_lock = threading.Lock()


def _run(X, y, sw, reg, iters: int, fit_intercept: bool):
    if X.device.type != "cuda":
        return _ista(X, y, sw, reg, iters, fit_intercept)
    from ..gbdt.graphs import Replayer

    key = (X.device, torch.cuda.current_stream(X.device).cuda_stream,
           tuple(X.shape), iters, fit_intercept)
    with _runs_lock:
        hit = _runs.get(key)
        if hit is None:
            hit = _runs[key] = (threading.Lock(), Replayer(
                lambda *a: _ista(*a, iters, fit_intercept), True))
    lock, run = hit
    with lock:
        # copy in, replay and copy out queue in this order on the stream
        w, b = run(X, y, sw, reg)
        return w.clone(), b.clone()


def release_graphs() -> None:
    """Free every captured lasso graph."""
    with _runs_lock:
        runs = list(_runs.values())
        _runs.clear()
    for lock, run in runs:
        with lock:
            run.release()


def _as_f32(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                           else a, device=dev).to(torch.float32)


def _device_of(X, device: DeviceLike) -> torch.device:
    if device is None and isinstance(X, torch.Tensor):
        return X.device
    return resolve_device(device)


def fit_lasso_batch(Xs, ys, reg, sample_weights=None, iters: int = 200,
                    fit_intercept: bool = True, device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """min_w 0.5/n ||sqrt(W)(X w + b - y)||^2 + reg ||w||_1 for each row of
    a batch: Xs [B, n, d], ys [B, n], ``sample_weights`` [B, n] or None ->
    (ws [B, d], bs [B]) f32 on ``device`` (default: the inputs' device if
    they are tensors, else CUDA unless ``use_device`` asks otherwise)."""
    dev = _device_of(Xs, device)
    X = _as_f32(Xs, dev)
    y = _as_f32(ys, dev)
    if X.dim() != 3 or y.shape != X.shape[:2]:
        raise ValueError(f"fit_lasso_batch takes X [B, n, d] and y [B, n]; "
                         f"got {tuple(X.shape)} and {tuple(y.shape)}")
    sw = (torch.ones(y.shape, dtype=torch.float32, device=dev)
          if sample_weights is None else _as_f32(sample_weights, dev))
    r = torch.as_tensor(reg, dtype=torch.float32, device=dev).reshape(-1) \
        .expand(X.shape[0]).contiguous()
    with _full_f32():
        return _run(X, y, sw, r, iters, fit_intercept)


def fit_lasso(X, y, reg, sample_weights=None, iters: int = 200,
              fit_intercept: bool = True, device: DeviceLike = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One lasso: X [n, d], y [n] -> (w [d], b []) (``fit_lasso_batch``
    with B = 1)."""
    dev = _device_of(X, device)
    X = _as_f32(X, dev)
    sw = None if sample_weights is None \
        else _as_f32(sample_weights, dev)[None]
    w, b = fit_lasso_batch(X[None], _as_f32(y, dev)[None], reg, sw, iters,
                           fit_intercept, dev)
    return w[0], b[0]
