"""The VW learner's pass on the card (``csrc/vw_scan.cu``) and its plain
version.

Not a port of a TPU kernel: the reference runs its pass as a ``lax.scan``
(``mmlspark_tpu/vw/learner.py:92-159``, plain XLA). The pass is sequential
by nature (each example reads the weights the last one wrote), so on the
card it is one launch walking every example in order; in plain torch it
would be about ten launches an example. The source says how the kernel
keeps the reference's semantics: the two-phase duplicate-index update of
adaptive SGD, the l2 decay gated on active slots, the learning-rate clock
advancing only on an example weight > 0, FTRL's step, and XLA's index
semantics for out-of-range indices.

``scan_pass(state, idx, val, labels, wgts, cfg)`` is the wrapper: a CUDA
state launches the kernel (there is no fallback), a CPU state takes
``scan_pass_plain`` (a per-example loop of torch ops, the CPU tests' and
the card check's reference), anything else raises. ``state`` is updated in
place: ``[w, g2, t]`` (``t`` a one-element f32 tensor) for adaptive or
plain SGD, ``[z, n]`` for FTRL. It returns the pass's summed weighted
example loss as a one-element f64 tensor on the state's device.
``launches`` counts kernel launches.

Bound on the H100: bytes — idx, val, labels and weights read once, plus
per entry a 4-byte gather and a 4-byte scatter of each state array the
step touches; the kernel is latency-bound instead (one warp, a dependent
L2 round trip per phase of every example).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from .. import _kernels
from ..core import graphs

#: kernel launches since the counter was last set to 0
launches = 0
graphs.count_replays(__name__, "launches")

_LOSS_IDS = {"squared": 0, "logistic": 1, "hinge": 2, "quantile": 3}
#: the most slots an example may have (the kernel keeps 25 bytes a slot in
#: shared memory)
MAX_K = 8192


def mode_of(cfg) -> int:
    """0 plain SGD, 1 adaptive, 2 FTRL (the kernel's ``mode``)."""
    return 2 if cfg.ftrl else (1 if cfg.adaptive else 0)


class _Args(ctypes.Structure):
    """``ScanArgs`` in the source, field for field."""

    _fields_ = [("idx", ctypes.c_void_p), ("val", ctypes.c_void_p),
                ("labels", ctypes.c_void_p), ("wgts", ctypes.c_void_p),
                ("s0", ctypes.c_void_p), ("s1", ctypes.c_void_p),
                ("t_io", ctypes.c_void_p), ("loss_out", ctypes.c_void_p),
                ("n", ctypes.c_int64), ("k", ctypes.c_int32),
                ("dim", ctypes.c_int32), ("loss", ctypes.c_int32),
                ("mode", ctypes.c_int32), ("tau", ctypes.c_float),
                ("lr", ctypes.c_float), ("power_t", ctypes.c_float),
                ("initial_t", ctypes.c_float), ("l1", ctypes.c_float),
                ("l2", ctypes.c_float), ("alpha", ctypes.c_float),
                ("beta", ctypes.c_float)]


def _check(state: Sequence[torch.Tensor], idx, val, labels, wgts, cfg) -> None:
    if cfg.loss_function not in _LOSS_IDS:
        raise ValueError(f"Unknown loss {cfg.loss_function!r}")
    want = 2 if cfg.ftrl else 3
    if len(state) != want:
        raise ValueError(f"state must hold {want} tensors, got {len(state)}")
    dev = state[0].device
    n = idx.shape[0] if idx.dim() == 2 else -1
    for name, t, dt, shape in (("idx", idx, torch.int32, None),
                               ("val", val, torch.float32, tuple(idx.shape)),
                               ("labels", labels, torch.float32, (n,)),
                               ("weights", wgts, torch.float32, (n,))):
        if t.dtype != dt or (shape is not None and tuple(t.shape) != shape):
            raise TypeError(f"{name} must be {dt} {shape or '[N, K]'}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    dim = state[0].shape[0]
    for s in state[:2]:
        if s.dtype != torch.float32 or tuple(s.shape) != (dim,) \
                or not s.is_contiguous() or s.device != dev:
            raise TypeError("state arrays must be contiguous f32 [dim] on "
                            "one device")
    if not cfg.ftrl and (state[2].dtype != torch.float32
                         or state[2].numel() != 1 or state[2].device != dev):
        raise TypeError("t must be a one-element f32 tensor on the state's "
                        "device")


def _xla_index(idx: torch.Tensor, dim: int):
    """(gather indices, scatter mask): a negative index wraps once, a gather
    clamps into [0, dim), a scatter outside it drops (XLA's semantics)."""
    norm = torch.where(idx < 0, idx + dim, idx)
    return norm.clamp(0, dim - 1), (norm >= 0) & (norm < dim)


def scan_pass_plain(state: List[torch.Tensor], idx: torch.Tensor,
                    val: torch.Tensor, labels: torch.Tensor,
                    wgts: torch.Tensor, cfg) -> torch.Tensor:
    """The pass as a per-example loop of torch ops (the reference's scan
    step, op for op; scatters are ``index_add_``, which on the CPU adds
    duplicate indices one after the other, and on the card in an order of
    its own)."""
    _check(state, idx, val, labels, wgts, cfg)
    loss, tau = cfg.loss_function, cfg.quantile_tau
    dim = state[0].shape[0]
    gidx, keep = _xla_index(idx.to(torch.int64), dim)
    keep = keep.to(torch.float32)
    total = torch.zeros(1, dtype=torch.float64, device=idx.device)
    for i in range(idx.shape[0]):
        # a dropped scatter adds 0 at the clamped index (no host read)
        ix, v, kp = gidx[i], val[i], keep[i]
        label, wgt = labels[i], wgts[i]
        if cfg.ftrl:
            z, n_acc = state
            zi, ni = z[ix], n_acc[ix]
            wi = torch.where(
                zi.abs() <= cfg.l1, torch.zeros_like(zi),
                -(zi - torch.sign(zi) * cfg.l1)
                / ((cfg.ftrl_beta + torch.sqrt(ni)) / cfg.ftrl_alpha + cfg.l2))
            pred = torch.sum(wi * v)
            g = _loss_grad(loss, pred, label, tau) * wgt
            gi = g * v
            sigma = (torch.sqrt(ni + gi * gi) - torch.sqrt(ni)) / cfg.ftrl_alpha
            z.index_add_(0, ix, (gi - sigma * wi) * kp)
            n_acc.index_add_(0, ix, gi * gi * kp)
        else:
            w, g2, t = state
            wi = w[ix]
            pred = torch.sum(wi * v)
            g = _loss_grad(loss, pred, label, tau) * wgt
            gi = g * v + cfg.l2 * wi * (v != 0)
            t += (wgt > 0).to(torch.float32)
            if cfg.adaptive:
                g2.index_add_(0, ix, gi * gi * kp)
                scale = _rate_pow(g2[ix] + 1e-16, cfg.power_t) + 1e-8
                w.index_add_(0, ix, -cfg.learning_rate * gi / scale * kp)
            else:
                eta = cfg.learning_rate / _rate_pow(t + cfg.initial_t,
                                                    cfg.power_t)
                w.index_add_(0, ix, -eta * gi * kp)
        total += (_example_loss(loss, pred, label, tau) * wgt).to(torch.float64)
    return total


def _rate_pow(x: torch.Tensor, p: float) -> torch.Tensor:
    return torch.sqrt(x) if p == 0.5 else torch.pow(x, p)


def _loss_grad(loss: str, pred, label, tau: float):
    """dLoss/dPred for the supported VW loss functions."""
    if loss == "squared":
        return pred - label
    if loss == "logistic":
        # labels in {-1, +1} (VW convention)
        return -label / (1.0 + torch.exp(label * pred))
    if loss == "hinge":
        return torch.where(label * pred < 1.0, -label, torch.zeros_like(pred))
    if loss == "quantile":
        return torch.where(pred > label, torch.full_like(pred, 1.0 - tau),
                           torch.full_like(pred, -tau))
    raise ValueError(f"Unknown loss {loss!r}")


def _example_loss(loss: str, pred, label, tau: float):
    if loss == "squared":
        return 0.5 * (pred - label) ** 2
    if loss == "logistic":
        return torch.logaddexp(torch.zeros_like(pred), -label * pred)
    if loss == "hinge":
        return torch.clamp_min(1.0 - label * pred, 0.0)
    if loss == "quantile":
        d = pred - label
        return torch.where(d > 0, (1 - tau) * d, -tau * d)
    raise ValueError(loss)


def _fn():
    lib = _kernels.lib("vw_scan")
    fn = lib.mmlspark_vw_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def scan_pass_cuda(state: List[torch.Tensor], idx: torch.Tensor,
                   val: torch.Tensor, labels: torch.Tensor,
                   wgts: torch.Tensor, cfg) -> torch.Tensor:
    """Launch the pass on PyTorch's current stream."""
    _check(state, idx, val, labels, wgts, cfg)
    n, k = idx.shape
    if k > MAX_K:
        raise ValueError(f"vw_scan takes at most {MAX_K} slots an example, "
                         f"got {k}")
    dev = idx.device
    loss_out = torch.empty(1, dtype=torch.float64, device=dev)
    t_io = state[2] if not cfg.ftrl else loss_out
    p = _kernels.ptr
    args = _Args(p(idx), p(val), p(labels), p(wgts), p(state[0]),
                 p(state[1]), p(t_io), p(loss_out), n, k, state[0].shape[0],
                 _LOSS_IDS[cfg.loss_function], mode_of(cfg),
                 cfg.quantile_tau, cfg.learning_rate, cfg.power_t,
                 cfg.initial_t, cfg.l1, cfg.l2, cfg.ftrl_alpha, cfg.ftrl_beta)
    if n == 0:
        loss_out.zero_()
        return loss_out
    code = _fn()(ctypes.byref(args), _kernels.stream_ptr(dev))
    graphs.note_launch(__name__, "launches")
    _kernels.check(code, "vw_scan kernel launch")
    return loss_out


def scan_pass(state: List[torch.Tensor], idx: torch.Tensor, val: torch.Tensor,
              labels: torch.Tensor, wgts: torch.Tensor, cfg) -> torch.Tensor:
    """One pass over the examples, updating ``state`` in place; returns the
    summed weighted example loss (one-element f64 tensor)."""
    dev = state[0].device
    if dev.type == "cuda":
        return scan_pass_cuda(state, idx, val, labels, wgts, cfg)
    if dev.type == "cpu":
        return scan_pass_plain(state, idx, val, labels, wgts, cfg)
    raise ValueError(f"no VW scan for device {dev}")
