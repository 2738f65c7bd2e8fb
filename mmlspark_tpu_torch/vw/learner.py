"""Online linear learner: per-example adaptive SGD / FTRL over hashed
features (the port of ``mmlspark_tpu/vw/learner.py``).

Two engines, chosen as the reference chooses them:
  - the native route: the C++ sequential pass (``native_loader.vw_train_pass``
    over ``native_src``'s ``mml_vw_train_pass``, the reference's own source)
    for adaptive/plain SGD on one shard, on the host, as VW itself runs;
    ``MMLSPARK_TPU_NATIVE_VW=0`` turns it off;
  - the scan route: FTRL, ``NATIVE_VW=0`` and out-of-range indices. On the
    card each pass is one launch of ``csrc/vw_scan.cu`` (``scan_kernel``),
    the device form of the reference's ``lax.scan``; on the CPU its plain
    version.

Sparse rows are padded to a fixed nnz per row; padded slots (index 0, value
0) are inert because both the gradient and the l2 decay are gated on value
!= 0. ``predict_linear`` is a gather-sum on the device.

The distributed fit (``train_linear(mesh=)``, VW's AllReduce spanning tree
as the reference runs it): each process of the mesh scans the block of
its data coordinate, the rows padded with inert rows (weight 0, value 0)
to a multiple of the data axis, and after every pass the state is
averaged over the data group (``all_reduce_sum`` / shards, the
reference's ``pmean``) and the loss summed; the replicas along the other
axes scan the same block. A mesh fit never takes the native pass.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import all_reduce_sum, mesh_shards, row_block
from . import scan_kernel


@dataclasses.dataclass
class LearnerConfig:
    num_bits: int = 18
    learning_rate: float = 0.5
    power_t: float = 0.5           # lr decay exponent (VW --power_t)
    initial_t: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    loss_function: str = "squared"  # squared | logistic | hinge | quantile
    quantile_tau: float = 0.5
    adaptive: bool = True           # AdaGrad per-weight scaling (VW default)
    num_passes: int = 1
    ftrl: bool = False
    ftrl_alpha: float = 0.005
    ftrl_beta: float = 0.1
    seed: int = 0


@dataclasses.dataclass
class SparseDataset:
    """Padded sparse matrix: [N, max_nnz] indices/values (+label/weight)."""

    indices: np.ndarray   # int32 [N, K]
    values: np.ndarray    # float32 [N, K]
    labels: np.ndarray    # float32 [N]
    weights: np.ndarray   # float32 [N]

    @staticmethod
    def from_rows(rows, labels, weights=None, num_bits: int = 18) -> "SparseDataset":
        mask = (1 << num_bits) - 1
        n = len(rows)
        nnz = [0 if r is None else len(r["indices"]) for r in rows]
        k = max(max(nnz, default=1), 1)
        idx = np.zeros((n, k), dtype=np.int32)
        val = np.zeros((n, k), dtype=np.float32)
        for i, r in enumerate(rows):
            if r is None or len(r["indices"]) == 0:
                continue
            m = len(r["indices"])
            idx[i, :m] = (np.asarray(r["indices"], dtype=np.int64) & mask)
            val[i, :m] = r["values"]
        return SparseDataset(
            idx, val,
            np.asarray(labels, dtype=np.float32),
            np.asarray(weights if weights is not None else np.ones(n),
                       dtype=np.float32))

    def to(self, device) -> Tuple[torch.Tensor, ...]:
        """(indices, values, labels, weights) as tensors on ``device``."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (self.indices, self.values, self.labels,
                               self.weights))


@dataclasses.dataclass
class TrainingStats:
    """Per-worker diagnostics (VowpalWabbitBase TrainingStats parity,
    vw/VowpalWabbitBase.scala:29-48)."""

    partition_id: int
    num_examples: int
    total_time_ns: int
    learn_time_ns: int
    average_loss: float
    weighted_example_sum: float


def _ftrl_weights(config: LearnerConfig, z: torch.Tensor,
                  n_acc: torch.Tensor) -> torch.Tensor:
    """Reconstruct dense weights from FTRL-proximal (z, n) state."""
    return torch.where(
        z.abs() <= config.l1, torch.zeros_like(z),
        -(z - torch.sign(z) * config.l1)
        / ((config.ftrl_beta + torch.sqrt(n_acc)) / config.ftrl_alpha
           + config.l2))


def init_state(config: LearnerConfig, device,
               initial_weights=None) -> List[torch.Tensor]:
    """The scan's state on ``device``: ``[w, g2, t]`` (adaptive / SGD) or
    ``[z, n]`` (FTRL, warm-started so the reconstructed weights equal
    ``initial_weights`` at n = 0, outside the l1 dead zone)."""
    dim = 1 << config.num_bits
    w0 = (torch.as_tensor(np.array(np.asarray(initial_weights),
                                   dtype=np.float32)).to(device)
          if initial_weights is not None
          else torch.zeros(dim, dtype=torch.float32, device=device))
    if config.ftrl:
        z0 = -w0 * (config.ftrl_beta / config.ftrl_alpha + config.l2)
        z0 = torch.where(z0 != 0, z0 + torch.sign(z0) * config.l1,
                         torch.zeros_like(z0))
        return [z0.contiguous(), torch.zeros(dim, dtype=torch.float32,
                                             device=device)]
    return [w0.contiguous(), torch.zeros(dim, dtype=torch.float32, device=device),
            torch.zeros(1, dtype=torch.float32, device=device)]


def weights_of(config: LearnerConfig, state: List[torch.Tensor]) -> torch.Tensor:
    return _ftrl_weights(config, state[0], state[1]) if config.ftrl else state[0]


def _native_pass_ok(config: LearnerConfig) -> bool:
    """Route single-shard training to the native C++ sequential learner?

    Default on: a sequential per-example update stream is latency-bound on
    an accelerator, exactly like the reference's VW (a C++ core driven
    per row). FTRL and unsupported losses stay on the scan path;
    MMLSPARK_TPU_NATIVE_VW=0 disables (tests pin the scan path with it)."""
    if os.environ.get("MMLSPARK_TPU_NATIVE_VW", "") in ("0", "false"):
        return False
    if config.ftrl:
        return False
    if config.loss_function not in ("squared", "logistic", "hinge",
                                    "quantile"):
        return False
    from .. import native_loader

    return native_loader.load() is not None


def shard_block(dataset: SparseDataset, mesh) -> SparseDataset:
    """This process's block of ``dataset``: the rows padded with inert
    rows (index 0, value 0, label 0, weight 0) to a multiple of the shards,
    then split into equal contiguous blocks (the reference's padding)."""
    n = len(dataset.labels)
    pad = (-n) % mesh_shards(mesh)

    def padded(a):
        return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) if pad else a

    blk = row_block(n + pad, mesh)
    return SparseDataset(*(padded(np.asarray(a))[blk] for a in (
        dataset.indices, dataset.values, dataset.labels, dataset.weights)))


def train_linear(config: LearnerConfig, dataset: SparseDataset,
                 initial_weights: Optional[np.ndarray] = None,
                 mesh=None, device=None) -> Tuple[np.ndarray, List[TrainingStats]]:
    """Run ``num_passes`` passes (optimizer state carries across them) and
    return the dense weights (numpy f32) and each pass's stats. The native
    route runs on the host; the scan route on ``device`` (``cuda`` unless
    the caller asks for the CPU). ``mesh``: a ``parallel.mesh.Mesh`` whose
    every process calls with the same dataset: each scans its block and the
    state is averaged between passes (the module docstring); the result is
    the same on every process. It runs on the mesh's device unless
    ``device`` names one."""
    from ..runtime import resolve_device

    shards = mesh_shards(mesh)
    dim = 1 << config.num_bits
    n = len(dataset.labels)
    w_sum = float(dataset.weights.sum())

    if (mesh is None and _native_pass_ok(config)
            and int(np.min(dataset.indices, initial=0)) >= 0
            and int(np.max(dataset.indices, initial=-1)) < dim):
        # the native C++ sequential pass (VW's own architecture: a C core
        # doing per-example updates, vw/VowpalWabbitBase.scala:218-305);
        # index bounds are checked above (the C pass indexes raw memory)
        from .. import native_loader

        # a FORCED copy: the in-place update must never train the caller's
        # initial_weights array
        w_np = (np.array(np.asarray(initial_weights), dtype=np.float32)
                if initial_weights is not None
                else np.zeros(dim, dtype=np.float32))
        g2_np = np.zeros(dim, dtype=np.float32)
        t_val = 0.0
        stats = []
        native_ok = True
        for _ in range(config.num_passes):
            t0 = time.perf_counter_ns()
            res = native_loader.vw_train_pass(
                dataset.indices, dataset.values, dataset.labels,
                dataset.weights, w_np, g2_np, t_val,
                loss=config.loss_function, tau=config.quantile_tau,
                lr=config.learning_rate, power_t=config.power_t,
                initial_t=config.initial_t, l2=config.l2,
                adaptive=config.adaptive)
            dt = time.perf_counter_ns() - t0
            if res is None:
                # the library went away since the probe: the scan route,
                # from initial_weights again
                native_ok = False
                break
            native_loader.count("vw_train_pass", "native")
            t_val, loss_sum = res
            stats.append(TrainingStats(0, n, dt, dt,
                                       loss_sum / max(w_sum, 1e-12), w_sum))
        if native_ok:
            return w_np, stats

    dev = resolve_device(device if device is not None or mesh is None
                         else mesh.device)
    state = init_state(config, dev, initial_weights)
    local = shard_block(dataset, mesh) if mesh is not None else dataset
    idx, val, labels, wgts = local.to(dev)
    stats: List[TrainingStats] = []
    for _ in range(config.num_passes):
        t0 = time.perf_counter_ns()
        loss_sum = scan_kernel.scan_pass(state, idx, val, labels, wgts, config)
        if mesh is not None:
            # between passes: the state averaged over the shards (VW's
            # AllReduce), the loss summed
            for t in state:
                all_reduce_sum(t, mesh).div_(shards)
            all_reduce_sum(loss_sum, mesh)
        # the loss read back is the sync point: time the pass, not its launch
        loss_host = float(loss_sum.item())
        dt = time.perf_counter_ns() - t0
        stats.append(TrainingStats(0, n, dt, dt,
                                   loss_host / max(w_sum, 1e-12), w_sum))
    return weights_of(config, state).cpu().numpy(), stats


def predict_device(w: torch.Tensor, idx: torch.Tensor,
                   val: torch.Tensor) -> torch.Tensor:
    """The batched sparse dot product on the device of ``w``: a gather of
    each slot's weight (XLA's clamp for an index out of range) and a sum."""
    dim = w.shape[0]
    gidx = torch.where(idx < 0, idx + dim, idx).clamp(0, dim - 1)
    return torch.sum(w[gidx.to(torch.int64)] * val, dim=1)


def predict_linear(w, dataset: SparseDataset, device=None) -> np.ndarray:
    """Batched sparse dot product on ``device`` (``cuda`` unless the caller
    asks for the CPU); returns numpy f32."""
    from ..runtime import resolve_device

    dev = resolve_device(device)
    wt = torch.as_tensor(np.asarray(w, dtype=np.float32)).to(dev) \
        if not isinstance(w, torch.Tensor) else w.to(dev, torch.float32)
    idx, val, _, _ = dataset.to(dev)
    return predict_device(wt, idx, val).cpu().numpy()


class LinearLearner:
    """Incremental face of the scan pass: ``partial_fit(rows, labels)``
    folds one mini-batch into persistent optimizer state (the serving
    lifecycle's online-adapter contract; ``train_linear`` keeps its
    whole-pass semantics and native route).

    Always the scan route (``vw_scan`` on the card), never the native
    engine, whose learning-rate clock stays inside the C pass. State
    (weights + AdaGrad/FTRL accumulators + lr clock) carries across calls:
    replaying the same example slices in the same order reproduces the
    state bitwise.
    """

    def __init__(self, config: Optional[LearnerConfig] = None, device=None):
        self.config = config if config is not None else LearnerConfig()
        self._device = device
        self._state: Optional[List[torch.Tensor]] = None
        self.examples_seen = 0

    def _ensure_state(self) -> None:
        if self._state is not None:
            return
        from ..runtime import resolve_device

        self._state = init_state(self.config, resolve_device(self._device))

    def partial_fit(self, rows, labels, weights=None) -> float:
        """One incremental step over ``rows`` (sparse dicts, the
        ``SparseDataset.from_rows`` shape); returns the summed weighted
        example loss of the batch."""
        self._ensure_state()
        ds = SparseDataset.from_rows(rows, labels, weights,
                                     num_bits=self.config.num_bits)
        idx, val, lab, wgt = ds.to(self._state[0].device)
        loss = scan_kernel.scan_pass(self._state, idx, val, lab, wgt,
                                     self.config)
        self.examples_seen += int(len(ds.labels))
        return float(loss.item())

    @property
    def weights(self) -> np.ndarray:
        """Dense weight vector reconstructed from the current state."""
        self._ensure_state()
        return weights_of(self.config, self._state).cpu().numpy()

    def predict(self, rows) -> np.ndarray:
        self._ensure_state()
        ds = SparseDataset.from_rows(rows, np.zeros(len(rows)),
                                     num_bits=self.config.num_bits)
        return predict_linear(weights_of(self.config, self._state), ds,
                              device=self._state[0].device)

    def state_dict(self) -> Dict[str, object]:
        """Exact numpy snapshot of the optimizer state (float32 arrays —
        a serialize/load round-trip continues training bitwise)."""
        self._ensure_state()
        arrs = [s.cpu().numpy() for s in self._state]
        if self.config.ftrl:
            return {"kind": "ftrl", "z": arrs[0], "n": arrs[1],
                    "examples_seen": self.examples_seen}
        return {"kind": "adaptive", "w": arrs[0], "g2": arrs[1],
                "t": float(arrs[2][0]), "examples_seen": self.examples_seen}

    def load_state_dict(self, d: Dict[str, object]) -> "LinearLearner":
        from ..runtime import resolve_device

        expected = "ftrl" if self.config.ftrl else "adaptive"
        if d.get("kind") != expected:
            raise ValueError(f"state kind {d.get('kind')!r} does not match "
                             f"config ({expected})")
        dev = resolve_device(self._device)

        def f32(a):
            return torch.as_tensor(np.array(a, dtype=np.float32)).to(dev)

        if self.config.ftrl:
            self._state = [f32(d["z"]), f32(d["n"])]
        else:
            self._state = [f32(d["w"]), f32(d["g2"]),
                           f32(np.array([d["t"]], dtype=np.float32))]
        self.examples_seen = int(d.get("examples_seen", 0))
        return self
