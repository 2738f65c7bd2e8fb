"""Boosting engine: objectives, metrics, persistence and the fit loop.

Counterpart of the reference's ``mmlspark_tpu/gbdt/booster.py``:
``TrainParams``, ``grad_hess`` (every objective, LambdaRank included),
``init_score``, ``eval_metric`` (NDCG included), ``Booster`` with
``to_string``/``from_string`` in the reference's JSON model format, and
``train()`` for every boosting type (``gbdt``, ``rf``, ``dart``, ``goss``),
bagging and feature fraction, ranking groups, categorical set splits
(``categorical_feature``), a validation set with early stopping, continued
training from an ``init_model`` and checkpointed training that resumes
after a crash (``checkpoint=CheckpointConfig(...)``, ``checkpoint.py``).

``train()`` takes one of four routes, as the reference decides them, and
records it on the Booster (``Booster.route``) and in the obs
``TrainRecorder``:

  - ``native`` (``_native_train_ok``, ``_train_native``): a fit of at most
    ``MMLSPARK_TPU_NATIVE_TRAIN_MAX`` (2e7) rows x iterations x classes, or
    any eligible fit on the CPU, runs on the C++ grower on one host core
    before any device work (``native_loader``): below that size launch
    overhead exceeds the work. ``MMLSPARK_TPU_NATIVE_TRAIN=0`` turns it
    off, ``=1`` forces it;
  - ``scan`` (``_scan_train_ok``, ``_train_scan``): every boosting
    iteration with no host read, the trees fetched once at the end; on the
    card one CUDA graph replay an iteration. The default on the card for
    gbdt, rf and goss without validation, logging, a training metric or a
    checkpoint; ``MMLSPARK_TPU_SCAN_TRAIN=1`` forces it on the CPU;
  - ``fused``: the per-iteration host loop over the device-resident tree
    grower (``tree.FusedGrower``: one read a tree), the default on the card
    for the rest (dart, lambdarank, validation, checkpoints);
  - ``host``: the same loop over the per-split host grower, the default on
    the CPU.

Three places are mirrored exactly, because tree parity depends on them:

  - rows are padded to a multiple of 512 (NaN features, zero label/weight,
    group id -1, excluded by ``pad_mask``); the padded row count sets the
    grower's tier capacities;
  - scores: on CUDA the running scores stay on the device as Kahan-
    compensated f32 (``_add_leaf_values``; the scan adds device-f32 leaf
    values, the loop host-f64 ones rounded to f32); on the CPU, and for
    ``dart`` on any device (it rewrites scores when it drops and re-adds
    trees), the loop keeps exact f64 scores on the host and re-uploads them
    as f32 every iteration;
  - the host's random draws (bagging, feature fraction, GOSS's sample, DART's
    drops) come from one ``np.random.Generator`` in the reference's order
    (the scan draws every iteration's masks up front, in the same order),
    and the loop's GOSS ranks rows with the reference's ``np.argsort`` over
    the same f32 gradients. The scan's GOSS selects on the device as the
    reference's scan does: the exact top rows by |g| and the exact top rows
    by a uniform draw of the reference's Threefry keys
    (``sparse._exact_topk_mask``, ``core/threefry.py``).

LambdaRank runs as plain torch ops on the device: groups bucketed by
power-of-two size, each bucket's ``[m, G, G]`` pairwise tensors taken in
chunks of at most ``_LAMBDARANK_PAIR_BUDGET`` elements; its sums reduce in
torch's order, so g and h agree with the reference's within ulps.

With a ``mesh`` (``parallel.mesh.make_mesh``: one process per shard, each
calling ``train`` with the same full inputs) the fit is the reference's
data-parallel one: rows padded to a multiple of 512 x shards, each process
bins and holds its own contiguous block (the rows of the reference's shard
of its index) and grows every tree on the fused or per-split route with
its histograms summed in f64 across the processes (``tree``), so every
process builds the same trees as a single process would. The loop's state
is per block (scores, gradients); the host's draws run over all rows from
the same generator on every process; GOSS ranks the gathered gradients
and the training metric the gathered scores (``parallel.mesh.all_gather``).
A sharded fit never takes the native route or the scan (the reference
excludes them). The blocks follow the data axis alone, as the reference's
do: the ranks that share a data coordinate (the replicas along the other
axes) hold the same block and grow the same trees. LambdaRank's queries
may straddle a block edge: a rank gathers the scores of the queries that
cross its edges and computes their whole gradients (``ShardQueries``). A
checkpoint holds every row's scores (and the card's Kahan pair), gathered
over the data group and written by the mesh's first rank; a resume keeps
its block and refuses another shard count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import faults as _faults
from ..parallel.mesh import (all_gather, barrier, data_index, fetch_global,
                             mesh_shards, row_block)
from ..runtime import (DeviceLike, device_work, resolve_device,
                       sync_debug_mode)
from .binning import BinMapper
from . import select_kernel
from .checkpoint import check_params_match, load_checkpoint, save_checkpoint
from .histogram import xla_sum
from .tree import (FusedGrower, GrowerConfig, Tree, _fused_tree_enabled,
                   _grow_tree_device_body, device_tier_caps, grow_tree,
                   leaf_values, pack_tables, tree_from_packed)

MODEL_FORMAT = "mmlspark_tpu.gbdt.v1"

#: row padding multiple (the reference's histogram CHUNK)
ROW_MULTIPLE = 512


@dataclasses.dataclass
class TrainParams:
    """Native-param-string equivalent (the reference's TrainParams)."""

    # regression|regression_l1|quantile|huber|poisson|binary|multiclass|
    # lambdarank
    objective: str = "regression"
    boosting_type: str = "gbdt"            # gbdt|rf|dart|goss
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_bin: int = 255
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_seed: int = 2
    early_stopping_round: int = 0
    num_class: int = 1
    alpha: float = 0.9                     # quantile / huber parameter
    drop_rate: float = 0.1                 # dart
    max_drop: int = 50                     # dart
    uniform_drop: bool = False             # dart
    top_rate: float = 0.2                  # goss
    other_rate: float = 0.1                # goss
    categorical_feature: Tuple[int, ...] = ()
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    parallelism: str = "data_parallel"
    max_delta_step: float = 0.0            # clamp |leaf value| (0 = off)
    pos_bagging_fraction: float = 1.0      # binary class-aware bagging
    neg_bagging_fraction: float = 1.0
    max_bin_by_feature: Tuple[int, ...] = ()
    train_metric: bool = False
    metric: str = ""                       # default chosen by objective
    verbosity: int = -1
    seed: int = 0

    def to_string(self) -> str:
        """LightGBM-style 'key=value key=value' param string."""
        return " ".join(f"{k}={v}" for k, v in dataclasses.asdict(self).items())


# ---------------------------------------------------------------------------
# Objectives: per-row grad/hess of the loss wrt raw scores (f32 tensors)
# ---------------------------------------------------------------------------

_EXP_LO, _EXP_HI = -88.3762626647949, 88.3762626647950
_LOG2E = 1.44269504088896341
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 5.0000001201e-1)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fused multiply-add: the product of two f32 values is exact in
    f64, so one f64 add and one rounding to f32 give fma(a, b, c) (up to a
    double-rounding tie, ~2^-29 of inputs)."""
    return (a.double() * b + c).float()


def _f32c(v: float) -> float:
    return float(np.float32(v))


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """f32 exp in the arithmetic XLA's CPU backend emits (the Cephes
    polynomial with fused multiply-adds), so the objectives' gradients are
    bit-identical to the reference's on the same scores. ``torch.exp``
    differs from it in the last bit on ~10% of inputs, which is enough to
    flip a split between two features that order the rows the same way."""
    f = _f32c
    x = torch.clamp(x, f(_EXP_LO), f(_EXP_HI))
    fx = torch.floor(_fma(x, f(_LOG2E), 0.5))
    r = _fma(fx, -f(_EXP_C1), x)
    r = _fma(fx, -f(_EXP_C2), r)
    z = r * r
    y = _fma(r, f(_EXP_P[0]), f(_EXP_P[1]))
    for p in _EXP_P[2:]:
        y = _fma(y, r, f(p))
    y = 1.0 + _fma(y, z, r)
    pow2n = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return y * pow2n


def grad_hess(objective: str, scores: torch.Tensor, labels: torch.Tensor,
              weights: Optional[torch.Tensor] = None, alpha: float = 0.9,
              groups=None, group_segments: Optional["GroupSegments"] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (grad, hess), shape [N] (or [N, K] multiclass), in the
    reference's f32 operation order. LambdaRank takes the rows' group ids
    (``groups``) or their precomputed ``group_segments``, and no weights."""
    if objective == "binary":
        p = 1.0 / (1.0 + xla_exp(-scores))
        g = p - labels
        h = torch.clamp(p * (1.0 - p), min=1e-16)
    elif objective == "multiclass":
        e = xla_exp(scores - scores.max(dim=-1, keepdim=True).values)
        # the class sum in XLA's CPU order (in sequence from class 0), the
        # same bits on every device; torch.sum's order differs on the card
        p = e / xla_sum(e, -1)[..., None]
        # one-hot by comparison (no bounds check: it would read the labels
        # on the host); a label outside [0, K) gets a zero row, as
        # jax.nn.one_hot gives
        y = (labels.to(torch.int64)[:, None] == torch.arange(
            scores.shape[-1], device=scores.device)).to(scores.dtype)
        g = p - y
        h = torch.clamp(2.0 * p * (1.0 - p), min=1e-16)
    elif objective in ("regression", "regression_l2", "l2",
                       "mean_squared_error"):
        g = scores - labels
        h = torch.ones_like(scores)
    elif objective in ("regression_l1", "l1", "mae"):
        g = torch.sign(scores - labels)
        h = torch.ones_like(scores)
    elif objective == "quantile":
        diff = scores - labels
        g = torch.where(diff >= 0, torch.full_like(diff, 1.0 - alpha),
                        torch.full_like(diff, -alpha))
        h = torch.ones_like(scores)
    elif objective == "huber":
        diff = scores - labels
        g = torch.clamp(diff, -alpha, alpha)
        h = torch.ones_like(scores)
    elif objective == "poisson":
        g = xla_exp(scores) - labels
        h = xla_exp(scores)
    elif objective == "lambdarank":
        return _lambdarank_grad_hess(scores, labels, groups,
                                     segments=group_segments)
    else:
        raise ValueError(f"Unknown objective {objective!r}")
    if weights is not None:
        w = weights if g.dim() == 1 else weights[:, None]
        g, h = g * w, h * w
    return g, h


class GroupSegments:
    """Contiguous ``group_ids`` runs, bucketed by padded (power-of-two)
    group size; computed once per dataset and reused every iteration (the
    group layout never changes)."""

    __slots__ = ("n", "buckets")

    def __init__(self, n, buckets):
        self.n = n
        # buckets: list of (Gb, rows, loc_g, loc_slot, m): see segment_groups
        self.buckets = buckets


def _group_runs(group_ids) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, counts) of the contiguous ``group_ids`` runs; raises if a
    group id appears in two non-adjacent runs."""
    gi = np.asarray(group_ids)
    n = len(gi)
    change = np.nonzero(gi[1:] != gi[:-1])[0] + 1
    starts = np.concatenate([[0], change]).astype(np.int64)
    counts = np.diff(np.concatenate([starts, [n]])).astype(np.int64)
    run_ids = gi[starts]
    if len(np.unique(run_ids)) != len(run_ids):
        raise ValueError(
            "lambdarank requires rows grouped contiguously by group id; a "
            "group id reappears after a different group — sort the dataset "
            "by the group column first")
    return starts, counts


def segment_groups(group_ids, device: DeviceLike = "cpu") -> GroupSegments:
    """Segment rows into contiguous groups and bucket the groups by size
    class; each bucket's index tensors live on ``device``.

    Raises if a group id appears in two non-adjacent runs: that silently
    breaks pairwise ranking, so the rows must be sorted by group first."""
    starts, counts = _group_runs(group_ids)
    n = len(group_ids)
    by_size: dict = {}
    for g in range(len(starts)):
        c = int(counts[g])
        gb = 1 if c <= 1 else 1 << int(np.ceil(np.log2(c)))
        by_size.setdefault(gb, []).append(g)

    dev = torch.device(device)
    buckets = []
    for gb, glist in sorted(by_size.items()):
        bcounts = counts[glist]
        rows = np.concatenate(
            [np.arange(starts[g], starts[g] + counts[g]) for g in glist])
        loc_g = np.repeat(np.arange(len(glist), dtype=np.int64), bcounts)
        loc_slot = np.concatenate(
            [np.arange(c, dtype=np.int64) for c in bcounts])
        buckets.append((gb, torch.as_tensor(rows, device=dev),
                        torch.as_tensor(loc_g, device=dev),
                        torch.as_tensor(loc_slot, device=dev), len(glist)))
    return GroupSegments(n, buckets)


# Bound on pairwise-tensor elements materialized at once (f32 [chunk, Gb, Gb];
# 2**24 elements = 64 MB per tensor, ~6 live tensors => a few hundred MB peak).
_LAMBDARANK_PAIR_BUDGET = 1 << 24


def _halving_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum along the last dim (a power of two) by halving: the first
    half plus the second, until one column is left. Elementwise adds only,
    so a row's sum is the same bits on every device and whatever rows
    share the tensor. ``torch.sum`` over a few rows picks its reduction
    order on the card from the row count (a bucket's chunk of a
    LambdaRank's queries), which a sharded fit's blocks change."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _lambdarank_bucket(s_pad: torch.Tensor, l_pad: torch.Tensor,
                       valid: torch.Tensor, sigma: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise LambdaRank lambdas for one [m, G] padded bucket of groups."""
    m, G = s_pad.shape
    dev = s_pad.device
    gains = torch.where(valid, torch.pow(2.0, l_pad) - 1.0, 0.0)
    # within-group rank by current score (invalid slots sort last: score
    # -inf); stable, as jnp.argsort: at iteration 0 every score ties
    order = torch.argsort(-s_pad, dim=1, stable=True)
    iota = torch.arange(G, dtype=torch.int32, device=dev)
    rank_of = torch.empty((m, G), dtype=torch.int32, device=dev)
    rank_of.scatter_(1, order, iota.expand(m, G).contiguous())
    disc = 1.0 / torch.log2(rank_of.to(torch.float32) + 2.0)
    # ideal DCG per group (labels sorted descending), summed in an order
    # that no other group of the bucket moves (``_halving_sum``)
    ideal_gains = torch.flip(torch.sort(gains, dim=1).values, (1,))
    idcg = _halving_sum(ideal_gains
                        / torch.log2(iota.to(torch.float32) + 2.0))[:, None]
    inv_idcg = torch.where(idcg > 0, 1.0 / idcg, 0.0)[..., None]

    pair_ok = valid[:, :, None] & valid[:, None, :]
    better = (l_pad[:, :, None] > l_pad[:, None, :]) & pair_ok
    s_diff = torch.where(pair_ok, s_pad[:, :, None] - s_pad[:, None, :], 0.0)
    rho = 1.0 / (1.0 + xla_exp(sigma * s_diff))     # P(i beats j but doesn't)
    delta = torch.abs((gains[:, :, None] - gains[:, None, :])
                      * (disc[:, :, None] - disc[:, None, :])) * inv_idcg
    lam = torch.where(better, -sigma * rho * delta, 0.0)
    h_pair = torch.where(better, sigma * sigma * rho * (1 - rho) * delta, 0.0)
    g_pad = torch.sum(lam, dim=2) - torch.sum(lam, dim=1)
    h_pad = torch.sum(h_pair, dim=2) + torch.sum(h_pair, dim=1)
    return g_pad, h_pad


def _lambdarank_grad_hess(scores: torch.Tensor, labels: torch.Tensor,
                          group_ids, sigma: float = 1.0,
                          segments: Optional[GroupSegments] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise LambdaRank with |ΔNDCG| weighting (LightGBM semantics).

    Groups (contiguous ``group_ids`` runs) are bucketed by power-of-two
    padded size, so a few singleton-heavy queries never inflate the padding
    of the rest; within a bucket the [m, G, G] pairwise tensors are taken at
    most ``_LAMBDARANK_PAIR_BUDGET`` elements at a time (a loop over group
    chunks, the reference's ``lax.map``)."""
    seg = segments if segments is not None else segment_groups(
        group_ids, scores.device)
    dev = scores.device
    g_out = torch.zeros(seg.n, dtype=torch.float32, device=dev)
    h_out = torch.full((seg.n,), 1e-16, dtype=torch.float32, device=dev)
    for gb, rows, loc_g, loc_slot, m in seg.buckets:
        if gb <= 1:
            continue  # singleton groups: no pairs, keep (0, 1e-16)
        chunk = max(1, min(m, _LAMBDARANK_PAIR_BUDGET // (gb * gb)))
        s_pad = torch.full((m, gb), float("-inf"), dtype=torch.float32,
                           device=dev)
        l_pad = torch.zeros((m, gb), dtype=torch.float32, device=dev)
        valid = torch.zeros((m, gb), dtype=torch.bool, device=dev)
        s_pad[loc_g, loc_slot] = scores[rows]
        l_pad[loc_g, loc_slot] = labels[rows]
        valid[loc_g, loc_slot] = True
        parts = [_lambdarank_bucket(s_pad[a:a + chunk], l_pad[a:a + chunk],
                                    valid[a:a + chunk], sigma)
                 for a in range(0, m, chunk)]
        g_pad = torch.cat([p[0] for p in parts])
        h_pad = torch.cat([p[1] for p in parts])
        g_out[rows] = g_pad[loc_g, loc_slot]
        h_out[rows] = torch.clamp(h_pad[loc_g, loc_slot], min=1e-16)
    return g_out, h_out


class ShardQueries:
    """LambdaRank over a sharded fit's row blocks (``bounds``: the [S + 1]
    row edges; this rank holds block ``me``). A query may straddle a block
    edge, so a rank computes the whole of every query that touches its
    block: those inside it from its own scores, and the at most two that
    cross its edges from their rows' scores gathered over the data group
    (``all_gather``: each block gives the rows of its own that lie in a
    query crossing any edge, an empty share included, so every rank of the
    group takes part). The rank segments its block and those straddlers
    once (``segment_groups``) and keeps its own rows of the gradients. A
    query's g and h do not depend on the other queries of its bucket
    (``_lambdarank_bucket``), so they are the bits the one-process fit
    computes."""

    def __init__(self, group_ids, labels: np.ndarray, bounds, me: int,
                 device: DeviceLike):
        starts, counts = _group_runs(group_ids)
        ends = starts + counts
        labels = np.asarray(labels)
        bounds = [int(b) for b in bounds]
        a, b = bounds[me], bounds[me + 1]

        def run_of(row: int) -> int:
            return int(np.searchsorted(starts, row, side="right")) - 1

        # each block's rows in a query that crosses one of its edges
        shares = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            rows = []
            if hi > lo:
                head, tail = run_of(lo), run_of(hi - 1)
                if starts[head] < lo:
                    rows.append(np.arange(lo, min(int(ends[head]), hi)))
                if ends[tail] > hi and not (head == tail and starts[head] < lo):
                    rows.append(np.arange(max(int(starts[tail]), lo), hi))
            shares.append(np.concatenate(rows) if rows
                          else np.zeros(0, np.int64))
        self.sizes = [len(r) for r in shares]
        self.lo = int(starts[run_of(a)]) if b > a else a
        self.hi = int(ends[run_of(b - 1)]) if b > a else b
        dev = torch.device(device)
        self.mine = torch.as_tensor(shares[me] - a, device=dev)
        gathered = np.concatenate(shares)
        self.before = torch.as_tensor(
            np.searchsorted(gathered, np.arange(self.lo, a)), device=dev)
        self.after = torch.as_tensor(
            np.searchsorted(gathered, np.arange(b, self.hi)), device=dev)
        self.keep = slice(a - self.lo, b - self.lo)
        self.segments = (segment_groups(
            np.asarray(group_ids)[self.lo:self.hi], dev) if b > a else None)
        self.labels = torch.as_tensor(labels[self.lo:self.hi],
                                      dtype=torch.float32, device=dev)

    @property
    def straddlers(self) -> bool:
        """Does any query cross a block edge (else no rank gathers)."""
        return sum(self.sizes) > 0

    def grad_hess(self, scores: torch.Tensor, mesh
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This block's LambdaRank (g, h) from its own f32 ``scores``: a
        collective over the data group when a query crosses an edge."""
        ext = scores
        if self.straddlers:
            got = all_gather(scores.index_select(0, self.mine), mesh,
                             self.sizes)
            ext = torch.cat([got.index_select(0, self.before), scores,
                             got.index_select(0, self.after)])
        if self.segments is None:            # an empty block
            return scores.clone(), scores.clone()
        g, h = grad_hess("lambdarank", ext, self.labels,
                         group_segments=self.segments)
        return g[self.keep], h[self.keep]


def init_score(objective: str, labels: np.ndarray, num_class: int = 1,
               alpha: float = 0.9) -> np.ndarray:
    """Base score before the first tree (BoostFromAverage parity)."""
    if objective == "binary":
        p = np.clip(labels.mean(), 1e-12, 1 - 1e-12)
        return np.full(1, np.log(p / (1 - p)), dtype=np.float64)
    if objective == "multiclass":
        out = np.zeros(num_class, dtype=np.float64)
        for k in range(num_class):
            p = np.clip((labels == k).mean(), 1e-12, 1 - 1e-12)
            out[k] = np.log(p)
        return out
    if objective in ("regression", "regression_l2", "l2", "huber",
                     "mean_squared_error"):
        return np.full(1, labels.mean(), dtype=np.float64)
    if objective in ("regression_l1", "l1", "mae"):
        return np.full(1, np.median(labels), dtype=np.float64)
    if objective == "quantile":
        return np.full(1, np.quantile(labels, alpha), dtype=np.float64)
    if objective == "poisson":
        return np.full(1, np.log(max(labels.mean(), 1e-12)), dtype=np.float64)
    return np.zeros(1, dtype=np.float64)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def eval_metric(metric: str, scores: np.ndarray, labels: np.ndarray,
                groups: Optional[np.ndarray] = None) -> float:
    eps = 1e-15
    if metric == "binary_logloss":
        p = np.clip(1 / (1 + np.exp(-scores)), eps, 1 - eps)
        return float(-np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p)))
    if metric == "binary_error":
        return float(np.mean((scores > 0) != (labels > 0.5)))
    if metric == "auc":
        order = np.argsort(scores)
        ranks = np.empty(len(scores))
        ranks[order] = np.arange(1, len(scores) + 1)
        # average ranks for ties
        for v in np.unique(scores):
            m = scores == v
            if m.sum() > 1:
                ranks[m] = ranks[m].mean()
        pos = labels > 0.5
        n_pos, n_neg = pos.sum(), (~pos).sum()
        if n_pos == 0 or n_neg == 0:
            return 0.5
        return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
    if metric == "multi_logloss":
        e = np.exp(scores - scores.max(axis=1, keepdims=True))
        p = np.clip(e / e.sum(axis=1, keepdims=True), eps, None)
        return float(-np.mean(np.log(p[np.arange(len(labels)),
                                       labels.astype(np.int64)])))
    if metric == "multi_error":
        return float(np.mean(np.argmax(scores, axis=1) != labels))
    if metric in ("l2", "mse"):
        return float(np.mean((scores - labels) ** 2))
    if metric == "rmse":
        return float(np.sqrt(np.mean((scores - labels) ** 2)))
    if metric in ("l1", "mae"):
        return float(np.mean(np.abs(scores - labels)))
    if metric == "ndcg":
        return _ndcg(scores, labels, groups)
    raise ValueError(f"Unknown metric {metric!r}")


def _ndcg(scores: np.ndarray, labels: np.ndarray,
          groups: Optional[np.ndarray], k: int = 10) -> float:
    """Mean NDCG@k over the groups, in ascending group id order (the
    reference's ``_ndcg``). Each group's rows are found through one stable
    argsort of the group ids instead of a mask per group: the same
    sub-arrays in the same row order, so the same ``np.argsort`` ties and
    the same value, in O(rows log rows)."""
    if groups is None:
        groups = np.zeros(len(scores), dtype=np.int64)
    groups = np.asarray(groups)
    perm = np.argsort(groups, kind="stable")
    gs = groups[perm]
    starts = np.concatenate([[0], np.nonzero(gs[1:] != gs[:-1])[0] + 1,
                             [len(gs)]]) if len(gs) else np.zeros(1, np.int64)
    vals = []
    for a, b in zip(starts[:-1], starts[1:]):
        rows = perm[a:b]
        s, l = scores[rows], labels[rows]
        order = np.argsort(-s)[:k]
        dcg = np.sum((2 ** l[order] - 1) / np.log2(np.arange(len(order)) + 2))
        ideal = np.argsort(-l)[:k]
        idcg = np.sum((2 ** l[ideal] - 1) / np.log2(np.arange(len(ideal)) + 2))
        vals.append(dcg / idcg if idcg > 0 else 1.0)
    return float(np.mean(vals)) if vals else 1.0


_HIGHER_BETTER = {"auc", "ndcg"}


def default_metric(objective: str) -> str:
    return {
        "binary": "binary_logloss",
        "multiclass": "multi_logloss",
        "lambdarank": "ndcg",
        "regression_l1": "l1",
        "l1": "l1",
        "mae": "l1",
        "quantile": "l1",
    }.get(objective, "l2")


# ---------------------------------------------------------------------------
# Booster
# ---------------------------------------------------------------------------


class Booster:
    """Trained model: bin mapper + tree ensemble + objective metadata."""

    def __init__(self, params: TrainParams, bin_mapper: Optional[BinMapper],
                 trees: Optional[List[List[Tree]]] = None,
                 base_score: Optional[np.ndarray] = None,
                 best_iteration: int = -1):
        self.params = params
        self.bin_mapper = bin_mapper
        # trees[i][k]: iteration i, class k (num_class=1 => k=0)
        self.trees: List[List[Tree]] = trees or []
        self.base_score = (base_score if base_score is not None
                           else np.zeros(max(params.num_class, 1)))
        self.best_iteration = best_iteration
        #: the route the fit took (native, scan, fused or host), not saved
        self.route: Optional[str] = None

    def raw_predict(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        """[N,F] raw features -> [N] or [N,K] raw scores (host, f64)."""
        from .predict import predict_ensemble

        n_iter = num_iteration if num_iteration > 0 else (
            self.best_iteration if self.best_iteration > 0 else len(self.trees))
        n_iter = min(n_iter, len(self.trees))
        k = max(self.params.num_class, 1)
        scores = np.tile(self.base_score, (X.shape[0], 1)).astype(np.float64)
        if n_iter > 0:
            scores += predict_ensemble(
                [self.trees[i] for i in range(n_iter)], X, k)
        return scores[:, 0] if k == 1 else scores

    def predict_proba(self, X: np.ndarray,
                      num_iteration: int = -1) -> np.ndarray:
        raw = self.raw_predict(X, num_iteration)
        if self.params.objective == "binary":
            p = 1 / (1 + np.exp(-raw))
            return np.stack([1 - p, p], axis=1)
        if self.params.objective == "multiclass":
            e = np.exp(raw - raw.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        return raw

    def feature_importances(self, importance_type: str = "split"
                            ) -> np.ndarray:
        """Per feature: the number of splits on it, or with ``"gain"`` their
        summed gains."""
        num_f = self.bin_mapper.num_features if self.bin_mapper else 0
        imp = np.zeros(num_f, dtype=np.float64)
        for group in self.trees:
            for tree in group:
                internal = tree.feature >= 0
                if importance_type == "gain":
                    np.add.at(imp, tree.feature[internal],
                              tree.gain[internal])
                else:
                    np.add.at(imp, tree.feature[internal], 1.0)
        return imp

    def to_string(self) -> str:
        return json.dumps({
            "format": MODEL_FORMAT,
            "params": dataclasses.asdict(self.params),
            "base_score": self.base_score.tolist(),
            "best_iteration": self.best_iteration,
            "bin_mapper": self.bin_mapper.to_json() if self.bin_mapper else None,
            "trees": [[t.to_dict() for t in group] for group in self.trees],
        })

    @staticmethod
    def from_string(s: str) -> "Booster":
        d = json.loads(s)
        if d.get("format") != MODEL_FORMAT:
            raise ValueError(f"bad model format {d.get('format')!r}; "
                             f"expected {MODEL_FORMAT!r}")
        p = dict(d["params"])
        p["categorical_feature"] = tuple(p.get("categorical_feature", ()))
        p["max_bin_by_feature"] = tuple(p.get("max_bin_by_feature", ()))
        known = {f.name for f in dataclasses.fields(TrainParams)}
        params = TrainParams(**{k: v for k, v in p.items() if k in known})
        return Booster(
            params,
            BinMapper.from_json(d["bin_mapper"]) if d["bin_mapper"] else None,
            trees=[[Tree.from_dict(t) for t in group] for group in d["trees"]],
            base_score=np.asarray(d["base_score"], dtype=np.float64),
            best_iteration=d.get("best_iteration", -1),
        )


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Host draws shared by the dense and sparse loops (the reference's order)
# ---------------------------------------------------------------------------


def dart_drops(params: TrainParams, rng: np.random.Generator,
               n_trees: int) -> List[int]:
    """The iterations DART drops before growing the next tree."""
    if params.uniform_drop:
        drop_mask = rng.random(n_trees) < params.drop_rate
        return list(np.where(drop_mask)[0][: params.max_drop])
    n_drop = min(max(1, int(n_trees * params.drop_rate)), params.max_drop)
    return list(rng.choice(n_trees, size=n_drop, replace=False))


def goss_sample(g: torch.Tensor, n_real: int, n: int, params: TrainParams,
                rng: np.random.Generator) -> Tuple[np.ndarray, torch.Tensor]:
    """GOSS: the ``top_rate`` share of the first ``n_real`` rows by |g|
    (summed over classes) plus a random ``other_rate`` share of the rest,
    whose gradients are amplified. Returns the [n] row mask and the [n] f32
    amplification on ``g``'s device. The ranking is the reference's
    ``np.argsort`` (numpy's default sort) over the f32 |g| fetched to the
    host: another sort kind or dtype breaks its ties another way."""
    g_abs = np.abs(g.cpu().numpy())
    if g_abs.ndim == 2:
        g_abs = g_abs.sum(axis=1)
    g_abs = g_abs[:n_real]
    top_n = int(n_real * params.top_rate)
    other_n = int(n_real * params.other_rate)
    order = np.argsort(-g_abs)
    row_mask = np.zeros(n, dtype=bool)
    row_mask[order[:top_n]] = True
    rest = order[top_n:]
    picked = rng.choice(len(rest), size=min(other_n, len(rest)),
                        replace=False)
    row_mask[rest[picked]] = True
    amp = np.ones(n, dtype=np.float32)
    amp[rest] = (1.0 - params.top_rate) / max(params.other_rate, 1e-12)
    return row_mask, torch.as_tensor(amp, device=g.device)


def bagging_draw(params: TrainParams, rng: np.random.Generator, n: int,
                 y: np.ndarray, it: int, is_rf: bool) -> Optional[np.ndarray]:
    """A new [n] bagging mask at this iteration (every ``bagging_freq``
    iterations; rf bags whenever a fraction is set), or None to keep the
    last one."""
    pos_neg = (params.pos_bagging_fraction < 1.0
               or params.neg_bagging_fraction < 1.0)
    if not ((params.bagging_fraction < 1.0 or pos_neg)
            and (is_rf or params.bagging_freq > 0)
            and it % max(params.bagging_freq, 1) == 0):
        return None
    if pos_neg:
        # class-aware bagging (binary): per-class keep fractions, which
        # override the uniform fraction as in LightGBM
        frac = np.where(np.asarray(y) > 0.5, params.pos_bagging_fraction,
                        params.neg_bagging_fraction)
        return rng.random(n) < frac
    return rng.random(n) < params.bagging_fraction


def feature_draw(params: TrainParams, rng: np.random.Generator,
                 num_f: int) -> Optional[np.ndarray]:
    """This iteration's [num_f] feature-fraction mask, or None."""
    if params.feature_fraction >= 1.0:
        return None
    m = np.zeros(num_f, dtype=bool)
    n_feat = max(1, int(num_f * params.feature_fraction))
    m[rng.choice(num_f, size=n_feat, replace=False)] = True
    return m


def rf_average(booster: "Booster") -> None:
    """rf: every tree's shrinkage becomes 1/T at the end of the fit."""
    if booster.trees:
        inv = 1.0 / len(booster.trees)
        for group in booster.trees:
            for t in group:
                t.shrinkage = inv


class EarlyStopping:
    """Best-so-far bookkeeping of the validation metric."""

    def __init__(self, metric: str, rounds: int):
        self.higher_better = metric in _HIGHER_BETTER
        self.rounds = rounds
        self.best_val = -np.inf if self.higher_better else np.inf
        self.best_iter = -1
        self.no_improve = 0

    def update(self, value: float, n_trees: int) -> bool:
        """Record this iteration's value; True when the fit should stop."""
        improved = (value > self.best_val if self.higher_better
                    else value < self.best_val)
        if improved:
            self.best_val, self.best_iter, self.no_improve = value, n_trees, 0
        else:
            self.no_improve += 1
        return self.rounds > 0 and self.no_improve >= self.rounds


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _add_leaf_values(score: torch.Tensor, comp: torch.Tensor,
                     values: torch.Tensor, rows: torch.Tensor,
                     kk: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-device score update: score += values[rows] (column kk if
    multiclass), Kahan-compensated: ``comp`` carries the rounding residual
    of every prior add, so small per-tree updates against a large running
    score are not lost to f32."""
    upd = values[rows.to(torch.int64)]
    if kk is not None:
        s_col, c_col = score[:, kk], comp[:, kk]
        y = upd + c_col
        t = s_col + y
        score, comp = score.clone(), comp.clone()
        score[:, kk] = t
        comp[:, kk] = y - (t - s_col)
        return score, comp
    y = upd + comp
    t = score + y
    return t, y - (t - score)


# ---------------------------------------------------------------------------
# The whole-run scan engine: every boosting iteration with no host read
# ---------------------------------------------------------------------------

# [iterations, N] bagging masks drawn up front and held on the device; above
# this many the fit takes the per-iteration loop
_SCAN_MASK_BUDGET = 1 << 28

#: per thread: ``last_scan_rows``, the rows each iteration of the thread's
#: last ``_train_scan`` grew its trees on (the real rows, the bagged rows or
#: GOSS's selection), fetched after its loop: a reading aid; and
#: ``last_scan_guarded``, whether that loop ran under
#: ``scan_loop_sync_mode`` (``runtime.sync_debug_mode``)
_scan_tls = threading.local()

#: ``torch.cuda.set_sync_debug_mode`` the scan's boosting loop runs under
#: (None leaves it as it is); with "error" a synchronizing call inside the
#: loop raises, which proves it reads nothing on the host. The mode is the
#: process's, so a loop sets it only while no other thread works
#: (``runtime.sync_debug_mode``); the loop's capture proves the same on
#: every thread (a host read fails a capture)
scan_loop_sync_mode: Optional[str] = None


def __getattr__(name: str):
    if name in ("last_scan_rows", "last_scan_guarded"):
        return getattr(_scan_tls, name, None)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _env_on(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0")


def _scan_train_ok(params: TrainParams, objective: str, valid, log,
                   checkpoint=None, device=None) -> bool:
    """May this fit take the whole-run scan? The reference's gate: not dart
    (host-side drops), lambdarank (grouped gradients), a validation set, a
    log or a training metric (host evaluation each iteration), a
    checkpoint (a host boundary each iteration) or a single leaf; on the
    CPU only under ``MMLSPARK_TPU_SCAN_TRAIN=1``; never under
    ``MMLSPARK_TPU_NO_SCAN_TRAIN=1``."""
    if _env_on("MMLSPARK_TPU_NO_SCAN_TRAIN"):
        return False
    if params.boosting_type == "dart":
        return False
    if objective == "lambdarank":
        return False
    if valid is not None or log is not None or params.train_metric:
        return False
    if checkpoint is not None:
        return False
    if 2 * params.num_leaves - 1 < 3:
        return False
    if not _env_on("MMLSPARK_TPU_SCAN_TRAIN") \
            and resolve_device(device).type == "cpu":
        return False
    return True


def _scan_precompute_masks(params: TrainParams, rng, n: int, num_f: int,
                           y: np.ndarray, is_rf: bool):
    """Every iteration's bagging mask and feature mask, drawn up front from
    the same generator in the host loop's order. Returns (row_masks
    [iters, N] or None, feat_masks [iters, F] or None, ok); not ok (and
    nothing drawn) when the row masks pass ``_SCAN_MASK_BUDGET``."""
    iters = params.num_iterations
    bag_cond = ((params.bagging_fraction < 1.0
                 or params.pos_bagging_fraction < 1.0
                 or params.neg_bagging_fraction < 1.0)
                and (is_rf or params.bagging_freq > 0)
                and params.boosting_type != "goss")
    use_feat = params.feature_fraction < 1.0
    if bag_cond and iters * n > _SCAN_MASK_BUDGET:
        return None, None, False
    row_masks = np.empty((iters, n), dtype=bool) if bag_cond else None
    feat_masks = np.empty((iters, num_f), dtype=bool) if use_feat else None
    bag = np.ones(n, dtype=bool)
    for it in range(iters):
        if bag_cond:
            drawn = bagging_draw(params, rng, n, y, it, is_rf)
            if drawn is not None:
                bag = drawn
            row_masks[it] = bag
        if use_feat:
            feat_masks[it] = feature_draw(params, rng, num_f)
    return row_masks, feat_masks, True


def _scan_leaf_values(out: dict, config: GrowerConfig) -> torch.Tensor:
    """A scan's device-f32 leaf values of a grown tree (``out``: the device
    grower's tables); an unsplit root keeps 0, as on the per-tree route."""
    val = leaf_values(out["sums"], out["feature"], config)
    return torch.cat([torch.where(out["n_nodes"] > 1, val[:1], 0.0),
                      val[1:]])


def _scan_goss(g: torch.Tensor, h: torch.Tensor, key: torch.Tensor,
               top_n: int, other_n: int, amp: float,
               exclude: Optional[torch.Tensor] = None):
    """The scans' GOSS selection on the device, the reference's: exactly
    ``top_n`` rows by |g| (summed over classes in XLA's CPU order) and
    exactly ``other_n`` of the rest by ``threefry.uniform(key, n)``
    (``sparse._exact_topk_mask``), ``exclude`` (pad rows) never taken; the
    others' g and h amplified by ``amp``. Returns (row mask, g, h)."""
    from ..core import threefry
    from .sparse import _exact_topk_mask

    n = g.shape[0]
    g_sel = g.abs() if g.dim() == 1 else xla_sum(g.abs(), 1)
    is_top = _exact_topk_mask(g_sel, top_n, n, exclude=exclude)
    u = threefry.uniform(key, n)
    excl = is_top if exclude is None else is_top | exclude
    row_mask = is_top | _exact_topk_mask(u, other_n, n, exclude=excl)
    scale = torch.where(is_top, 1.0, amp)
    if g.dim() == 2:
        scale = scale[:, None]
    return row_mask, g * scale, h * scale


def _route_full(bins_dev: torch.Tensor, out: dict) -> torch.Tensor:
    """Every row of ``bins_dev`` routed through a tree grown on a compacted
    subset: its split records replayed in node order (children have larger
    ids than their parents, so one pass is a full traversal)."""
    n = int(bins_dev.shape[1])
    nor = torch.zeros(n, dtype=torch.int32, device=bins_dev.device)
    words = out.get("cat_words")
    for j in range(int(out["feature"].shape[0])):
        f = out["feature"][j:j + 1]
        col = bins_dev.index_select(0, f.clamp(min=0).to(torch.int64))[0]
        go_left = torch.where(col == 0, out["default_left"][j:j + 1],
                              col <= out["threshold_bin"][j:j + 1])
        if words is not None:
            b = col.to(torch.int64)
            bits = (words[j][b >> 5] >> (b & 31)) & 1
            go_left = torch.where(torch.any(words[j] != 0), bits == 1,
                                  go_left)
        child = torch.where(go_left, out["left"][j:j + 1],
                            out["right"][j:j + 1])
        nor = torch.where((nor == j) & (f >= 0), child, nor)
    return nor


@contextlib.contextmanager
def _scan_loop_guard() -> Iterator[None]:
    """The scan loop's part under ``scan_loop_sync_mode``; records in
    ``last_scan_guarded`` whether the mode was set."""
    with sync_debug_mode(scan_loop_sync_mode) as held:
        _scan_tls.last_scan_guarded = held
        yield


def _train_scan(params: TrainParams, config: GrowerConfig, booster: Booster,
                mapper: BinMapper, bins_dev: torch.Tensor,
                labels: torch.Tensor, w_dev: Optional[torch.Tensor],
                scores: np.ndarray, n: int, num_f: int, num_bins: int,
                k: int, lr: float, row_masks, feat_masks,
                pad_mask: Optional[np.ndarray] = None, cat_args=None
                ) -> float:
    """Every boosting iteration with no host read, the trees fetched once
    (the reference's ``_train_scan``). Returns the loop's seconds.

    An iteration computes grad/hess from the running scores, takes its
    masks from the device-resident [iters, N] / [iters, F] tensors by a
    device index, grows each class's tree with ``_grow_tree_device_body``
    and adds device-f32 leaf values into a Kahan-compensated f32 score. With
    bagging that keeps at most 62.5% of the rows (on the card, from 100k
    real rows; ``MMLSPARK_TPU_DENSE_BAG_COMPACT=1`` forces it,
    ``MMLSPARK_TPU_NO_DENSE_BAG_COMPACT=1`` turns it off) the bagged rows
    are first compacted by K2 into ``bag_cap`` columns, and every row's
    leaf is found by replaying the tree's splits (``_route_full``). GOSS
    selects on the device, as the reference's scan does: exactly ``top_n``
    real rows by |g| (summed over classes) and exactly ``other_n`` of the
    rest by a uniform draw (``sparse._exact_topk_mask``), the draw made
    over the padded rows from this iteration's key of
    ``threefry.split(prng_key(seed or bagging_seed), iterations)``; K2
    compacts the selected rows with their amplified g/h into ``goss_cap``
    columns, and ``_route_full`` routes every row. The
    saved trees' leaf values are recomputed on the host in f64 from the
    fetched sums, the per-tree route's lineage; the running score uses the
    f32 device values, so late trees may part from the per-tree route by
    rounding, as in the reference.

    On the card iteration 0 runs eagerly (it builds and warms every
    kernel), the iteration is then captured once in a CUDA graph and
    replayed for the rest; on the CPU every iteration runs eagerly."""
    dev = bins_dev.device
    iters = params.num_iterations
    pm = pad_mask if pad_mask is not None else np.ones(n, dtype=bool)
    if row_masks is not None and not pm.all():
        row_masks = row_masks & pm[None, :]
    ones_mask = torch.as_tensor(pm, device=dev)
    rm_all = (torch.as_tensor(row_masks, device=dev)
              if row_masks is not None else None)
    fm_all = (torch.as_tensor(feat_masks, device=dev)
              if feat_masks is not None else None)
    bag_cap = 0
    if row_masks is not None and not _env_on(
            "MMLSPARK_TPU_NO_DENSE_BAG_COMPACT"):
        forced = _env_on("MMLSPARK_TPU_DENSE_BAG_COMPACT")
        nr = int(pm.sum())
        if forced or (dev.type == "cuda" and nr >= 100_000):
            max_cnt = int(row_masks.sum(axis=1).max())
            if forced or max_cnt / max(nr, 1) <= 0.625:
                bag_cap = min(n, -(-max(max_cnt, 1) // 512) * 512)
    is_goss = params.boosting_type == "goss"
    goss_cap = 0
    if is_goss:
        from ..core import threefry

        n_real = int(pm.sum())
        top_n = int(n_real * params.top_rate)
        other_n = int(n_real * params.other_rate)
        sel_budget = max(top_n + other_n, 1)
        goss_cap = min(n, -(-(sel_budget + max(256, sel_budget // 16))
                            // 512) * 512)
        goss_amp = float(np.float32((1.0 - params.top_rate)
                                    / max(params.other_rate, 1e-12)))
        goss_keys = threefry.split(threefry.prng_key(
            params.seed or params.bagging_seed, dev), iters)
        not_real = None if pm.all() else ~ones_mask
    cap = goss_cap or bag_cap
    caps = device_tier_caps(cap or n)
    f32 = torch.float32
    shrink = float(np.float32(lr))

    score = torch.as_tensor(scores[:, 0] if k == 1 else scores, dtype=f32,
                            device=dev)
    comp = torch.zeros_like(score)
    it_idx = torch.zeros(1, dtype=torch.int64, device=dev)
    cols = 10 + ((num_bins + 31) // 32 if cat_args is not None else 0)
    M = 2 * params.num_leaves - 1
    stacked = torch.zeros(iters, k, M, cols, dtype=torch.float64, device=dev)
    rows_grown = torch.zeros(iters, dtype=torch.int64, device=dev)
    ar_cap = torch.arange(cap, device=dev) if cap else None

    def step():
        g, h = grad_hess(params.objective, score, labels, w_dev, params.alpha)
        row_mask = (rm_all.index_select(0, it_idx)[0] if rm_all is not None
                    else ones_mask)
        fmask = (fm_all.index_select(0, it_idx)[0] if fm_all is not None
                 else None)
        if is_goss:
            row_mask, g, h = _scan_goss(
                g, h, goss_keys.index_select(0, it_idx)[0], top_n, other_n,
                goss_amp, not_real)
        if cap:
            mask_it = ar_cap < row_mask.sum(dtype=torch.int32)
        new_s, new_c = score, comp
        tables = []
        for kk in range(k):
            gk = (g if k == 1 else g[:, kk]).contiguous()
            hk = (h if k == 1 else h[:, kk]).contiguous()
            if cap:
                bins_it, gk, hk = select_kernel.select_rows(
                    bins_dev, gk, hk, row_mask, cap)
            else:
                bins_it, mask_it = bins_dev, row_mask
            out = _grow_tree_device_body(bins_it, gk, hk, mask_it, None,
                                         num_bins, config, fmask, cat_args,
                                         caps)
            rows = _route_full(bins_dev, out) if cap \
                else out["node_of_row"]
            new_s, new_c = _add_leaf_values(
                new_s, new_c, _scan_leaf_values(out, config) * shrink, rows,
                kk if k > 1 else None)
            tables.append(pack_tables(out))
        stacked.index_copy_(0, it_idx, torch.stack(tables)[None])
        rows_grown.index_copy_(0, it_idx, row_mask.sum().reshape(1))
        score.copy_(new_s)
        comp.copy_(new_c)
        it_idx.add_(1)

    t0 = time.perf_counter()
    capture = dev.type == "cuda" and iters > 1
    with _scan_loop_guard():
        step()
        if not capture:
            for _ in range(iters - 1):
                step()
    if capture:
        from . import graphs

        cap = graphs.Captured(step)
        try:
            with _scan_loop_guard():
                for _ in range(iters - 1):
                    cap.replay()
            host = stacked.cpu().numpy()         # the fit's one fetch
        finally:
            cap.release()
    else:
        host = stacked.cpu().numpy()
    loop_s = time.perf_counter() - t0
    _scan_tls.last_scan_rows = rows_grown.cpu().numpy()
    for it in range(iters):
        group = []
        for kk in range(k):
            tree = tree_from_packed(host[it, kk], config, mapper,
                                    cat_args is not None)
            tree.shrinkage = lr
            group.append(tree)
        booster.trees.append(group)
    return loop_s


# ---------------------------------------------------------------------------
# The native engine: small fits on the C++ grower, on the host
# ---------------------------------------------------------------------------


def _grad_hess_np(objective: str, scores: np.ndarray, labels: np.ndarray,
                  weights: Optional[np.ndarray], alpha: float):
    """Host mirror of ``grad_hess`` for the native engine (the reference's:
    numpy f32; lambdarank is gated out of that engine)."""
    scores = scores.astype(np.float32)
    labels = labels.astype(np.float32)
    if objective == "binary":
        p = 1.0 / (1.0 + np.exp(-scores))
        g = p - labels
        h = np.maximum(p * (1.0 - p), 1e-16)
    elif objective == "multiclass":
        m = scores - scores.max(axis=-1, keepdims=True)
        e = np.exp(m)
        p = e / e.sum(axis=-1, keepdims=True)
        yh = np.zeros_like(p)
        li = labels.astype(np.int64)
        # an out-of-range label gets a zero one-hot row
        ok = (li >= 0) & (li < p.shape[-1])
        yh[np.nonzero(ok)[0], li[ok]] = 1.0
        g = p - yh
        h = np.maximum(2.0 * p * (1.0 - p), 1e-16)
    elif objective in ("regression", "regression_l2", "l2",
                       "mean_squared_error"):
        g = scores - labels
        h = np.ones_like(scores)
    elif objective in ("regression_l1", "l1", "mae"):
        g = np.sign(scores - labels)
        h = np.ones_like(scores)
    elif objective == "quantile":
        diff = scores - labels
        g = np.where(diff >= 0, 1.0 - alpha, -alpha)
        h = np.ones_like(scores)
    elif objective == "huber":
        g = np.clip(scores - labels, -alpha, alpha)
        h = np.ones_like(scores)
    elif objective == "poisson":
        g = np.exp(scores) - labels
        h = np.exp(scores)
    else:
        raise ValueError(f"Unknown objective {objective!r}")
    if weights is not None:
        w = np.asarray(weights, dtype=np.float32)
        w = w if g.ndim == 1 else w[:, None]
        g, h = g * w, h * w
    return g, h


# environment names that pin a device route: set, the native engine stands
# aside (the tests pin routes this way in both packages)
_NATIVE_PATH_FORCING_ENVS = (
    "MMLSPARK_TPU_SCAN_TRAIN", "MMLSPARK_TPU_NO_SCAN_TRAIN",
    "MMLSPARK_TPU_FUSED_TREE", "MMLSPARK_TPU_NO_FUSED_TREE",
    "MMLSPARK_TPU_HIST_EXACT")


def _native_train_ok(params: TrainParams, n: int, device=None) -> bool:
    """Route this fit to the C++ grower? The reference's decision: never
    under ``MMLSPARK_TPU_NATIVE_TRAIN=0``, for categorical splits,
    lambdarank, more than 255 bins, a route-pinning environment name, or
    without the library; always under ``=1``; else when rows x iterations x
    classes is at most ``MMLSPARK_TPU_NATIVE_TRAIN_MAX`` (2e7), or the fit
    runs on the CPU. Decided before any device work."""
    env = os.environ.get("MMLSPARK_TPU_NATIVE_TRAIN", "")
    if env in ("0", "false"):
        return False
    if params.categorical_feature or params.objective == "lambdarank":
        return False
    if params.max_bin > 255 or (params.max_bin_by_feature
                                and max(params.max_bin_by_feature) > 255):
        return False
    if any(_env_on(e) for e in _NATIVE_PATH_FORCING_ENVS):
        return False
    from .. import native_loader

    if not native_loader.available():
        return False
    if env in ("1", "true", "force"):
        return True
    budget = float(os.environ.get("MMLSPARK_TPU_NATIVE_TRAIN_MAX", "2e7"))
    if n * params.num_iterations * max(params.num_class, 1) <= budget:
        return True
    return resolve_device(device).type == "cpu"


def _train_native(params: TrainParams, X: np.ndarray, y: np.ndarray,
                  weights, valid, valid_groups, init_scores, init_model,
                  log) -> Optional[Booster]:
    """Every iteration on the host over the C++ grower, no device tensor
    (the reference's ``_train_native``): the loop's objectives, bagging,
    goss, dart and rf, early stopping and metric logging, with
    ``native_loader.gbdt_grow_tree`` growing each tree. None when this fit
    cannot run natively after all (a mapper of more than 256 bins inherited
    from ``init_model``, or the library gone)."""
    from .. import native_loader

    n, num_f = X.shape
    k = max(params.num_class, 1)
    objective = params.objective
    rng = np.random.default_rng(params.seed or params.bagging_seed)

    if init_model is not None and init_model.bin_mapper is not None:
        mapper = init_model.bin_mapper
    else:
        mapper = BinMapper.fit(X, params.max_bin, (), seed=params.seed,
                               max_bin_by_feature=params.max_bin_by_feature)
    num_bins = mapper.max_num_bins
    if num_bins > 256:
        return None
    bins_fm = mapper.transform_fm(X, dtype=np.uint8)

    if init_scores is not None:
        base = np.zeros(k, dtype=np.float64)
        scores = np.broadcast_to(
            np.asarray(init_scores, dtype=np.float64).reshape(n, -1),
            (n, k)).copy()
    else:
        base = init_score(objective, np.asarray(y, dtype=np.float64), k,
                          alpha=params.alpha)
        scores = np.tile(base, (n, 1)).astype(np.float64)
    booster = Booster(params, mapper, base_score=base)
    if init_model is not None:
        booster.trees = [list(g) for g in init_model.trees]
        booster.base_score = init_model.base_score
        if init_model.trees:
            scores = init_model.raw_predict(
                X, num_iteration=len(init_model.trees)).reshape(n, -1)

    metric = params.metric or default_metric(objective)
    stopper = EarlyStopping(metric, params.early_stopping_round)
    val_X, val_y = valid if valid is not None else (None, None)
    is_rf = params.boosting_type == "rf"
    is_dart = params.boosting_type == "dart"
    is_goss = params.boosting_type == "goss"
    lr = 1.0 if is_rf else params.learning_rate
    bag_mask = np.ones(n, dtype=bool)
    yv = np.asarray(y, dtype=np.float64)
    wv = np.asarray(weights, dtype=np.float64) if weights is not None else None

    from ..obs.metrics import TrainRecorder

    recorder = TrainRecorder("gbdt_native")
    recorder.route("native")
    for it in range(params.num_iterations):
        it_t0 = time.perf_counter()
        _faults.fire(_faults.TRAIN_STEP, iteration=it, engine="native")
        dropped: List[int] = []
        if is_dart and booster.trees:
            dropped = dart_drops(params, rng, len(booster.trees))
            for di in dropped:
                for kk in range(k):
                    scores[:, kk] -= _tree_contrib(booster.trees[di][kk], X)

        sc = scores[:, 0] if k == 1 else scores
        g, h = _grad_hess_np(objective, sc, yv, wv, params.alpha)

        row_mask = bag_mask
        if is_goss:
            g_abs = np.abs(g)
            if g_abs.ndim == 2:
                g_abs = g_abs.sum(axis=1)
            top_n = int(n * params.top_rate)
            other_n = int(n * params.other_rate)
            # the top-|g| set, not its order: argpartition, as the
            # reference's native engine
            part = np.argpartition(-g_abs, max(top_n - 1, 0))
            row_mask = np.zeros(n, dtype=bool)
            row_mask[part[:top_n]] = True
            rest = part[top_n:]
            picked = rng.choice(len(rest), size=min(other_n, len(rest)),
                                replace=False)
            row_mask[rest[picked]] = True
            amp = np.ones(n)
            amp[rest] = (1.0 - params.top_rate) / max(params.other_rate,
                                                      1e-12)
            g, h = g * (amp if g.ndim == 1 else amp[:, None]), \
                h * (amp if h.ndim == 1 else amp[:, None])
        else:
            drawn = bagging_draw(params, rng, n, y, it, is_rf)
            if drawn is not None:
                bag_mask = row_mask = drawn
        feature_mask = feature_draw(params, rng, num_f)

        group: List[Tree] = []
        shrink = lr / (len(dropped) + lr) if dropped else lr
        for kk in range(k):
            gk = np.ascontiguousarray(g if g.ndim == 1 else g[:, kk],
                                      dtype=np.float32)
            hk = np.ascontiguousarray(h if h.ndim == 1 else h[:, kk],
                                      dtype=np.float32)
            res = native_loader.gbdt_grow_tree(
                bins_fm, gk, hk, None if row_mask.all() else row_mask,
                feature_mask, num_bins=num_bins,
                num_leaves=params.num_leaves, max_depth=params.max_depth,
                min_data_in_leaf=params.min_data_in_leaf,
                min_sum_hessian=params.min_sum_hessian_in_leaf,
                min_gain_to_split=params.min_gain_to_split,
                lambda_l1=params.lambda_l1, lambda_l2=params.lambda_l2,
                max_delta_step=params.max_delta_step)
            if res is None:
                return None
            native_loader.count("gbdt_grow_tree", "native")
            feat = res["feature"]
            thr = np.zeros(len(feat), dtype=np.float64)
            for i in np.nonzero(feat >= 0)[0]:
                thr[i] = mapper.bin_upper_value(int(feat[i]),
                                                int(res["threshold_bin"][i]))
            tree = Tree(
                feature=feat, threshold=thr,
                threshold_bin=res["threshold_bin"],
                default_left=res["default_left"], left=res["left"],
                right=res["right"], value=res["value"], gain=res["gain"],
                count=res["count"], weight=res["weight"])
            tree.shrinkage = shrink
            group.append(tree)
            scores[:, kk] += tree.value[res["leaf_of_row"]] * shrink
        if dropped:
            factor = len(dropped) / (len(dropped) + lr)
            for di in dropped:
                for kk in range(k):
                    booster.trees[di][kk].shrinkage *= factor
                    scores[:, kk] += _tree_contrib(booster.trees[di][kk], X)
        booster.trees.append(group)

        if params.train_metric and log:
            tm = eval_metric(metric, scores[:, 0] if k == 1 else scores, yv)
            recorder.metric(f"train_{metric}", tm)
            log(f"[{it + 1}] train {metric}={tm:.6f}")
        if val_X is not None:
            val_scores = booster.raw_predict(
                val_X, num_iteration=len(booster.trees))
            m = eval_metric(metric, val_scores,
                            np.asarray(val_y, dtype=np.float64), valid_groups)
            recorder.metric(f"valid_{metric}", m)
            stop = stopper.update(m, len(booster.trees))
            if log:
                log(f"[{it + 1}] valid {metric}={m:.6f}")
            if stop:
                booster.best_iteration = stopper.best_iter
                if log:
                    log(f"early stopping at iteration {it + 1}, "
                        f"best {stopper.best_iter}")
                recorder.step(time.perf_counter() - it_t0, examples=n)
                break
        elif log and not params.train_metric and (it + 1) % 10 == 0:
            m = eval_metric(metric, scores[:, 0] if k == 1 else scores, yv)
            log(f"[{it + 1}] train {metric}={m:.6f}")
        recorder.step(time.perf_counter() - it_t0, examples=n)

    if is_rf:
        rf_average(booster)
    booster.route = "native"
    return booster


@device_work
def train(params: TrainParams, X: np.ndarray, y: np.ndarray,
          weights: Optional[np.ndarray] = None,
          groups: Optional[np.ndarray] = None,
          valid: Optional[Tuple[np.ndarray, np.ndarray]] = None,
          valid_groups: Optional[np.ndarray] = None,
          init_scores: Optional[np.ndarray] = None,
          init_model: Optional[Booster] = None,
          log: Optional[Callable[[str], None]] = None,
          mesh=None, checkpoint=None,
          device: DeviceLike = None) -> Booster:
    """Bin, boost, early-stop; returns a Booster. Runs on ``device``
    (default: CUDA, or the device ``runtime.use_device`` asked for).

    ``groups``: per-row query ids for lambdarank (rows of a query
    contiguous). ``valid``: an (X, y) holdout scored after every iteration
    (``valid_groups`` its query ids); with ``early_stopping_round`` > 0 the
    fit stops after that many iterations without improvement and
    ``best_iteration`` marks the best. ``init_model``: a Booster whose bin
    mapper, base score and trees the fit continues from. ``checkpoint``: a
    ``checkpoint.CheckpointConfig``; the fit saves its model and loop state
    atomically every ``every_k`` iterations and at the end, and resumes from
    the saved file when there is one, repeating the iterations an
    uninterrupted fit would run.

    ``mesh``: a ``parallel.mesh.Mesh``; every process of it calls ``train``
    with the same inputs and gets the same Booster, grown data-parallel
    over the row block of its data coordinate (the module docstring). Runs
    on the mesh's device unless ``device`` names one."""
    shards = mesh_shards(mesh)
    sharded = mesh is not None          # one shard too: the sharded path
    dev = resolve_device(device if device is not None or mesh is None
                         else mesh.device)
    # the native C++ engine for small fits (and on the CPU), decided before
    # any device work; checkpointed fits keep the loop (its state is here)
    if mesh is None and groups is None and checkpoint is None \
            and _native_train_ok(params, len(y), dev):
        nb = _train_native(params, X, y, weights, valid, valid_groups,
                           init_scores, init_model, log)
        if nb is not None:
            return nb
    is_rf = params.boosting_type == "rf"
    is_dart = params.boosting_type == "dart"
    is_goss = params.boosting_type == "goss"
    fast_scores = dev.type == "cuda" and not is_dart

    # Pad rows to a multiple of 512 (of 512 x shards under a mesh): NaN
    # features (bin 0), zero label and weight, group -1, excluded from
    # training through pad_mask
    pad = (-len(y)) % (ROW_MULTIPLE * shards)
    if pad:
        X = np.concatenate([X, np.full((pad, X.shape[1]), np.nan)])
        y = np.concatenate([y, np.zeros(pad)])
        if weights is not None:
            weights = np.concatenate([weights, np.zeros(pad)])
        if groups is not None:
            groups = np.concatenate([groups, np.full(pad, -1)])
    pad_mask = np.ones(len(y), dtype=bool)
    if pad:
        pad_mask[-pad:] = False

    n, num_f = X.shape
    n_real = int(pad_mask.sum())
    k = max(params.num_class, 1)
    objective = params.objective
    rng = np.random.default_rng(params.seed or params.bagging_seed)

    if init_model is not None and init_model.bin_mapper is not None:
        mapper = init_model.bin_mapper
    else:
        mapper = BinMapper.fit(X[:n_real], params.max_bin,
                               params.categorical_feature, seed=params.seed,
                               max_bin_by_feature=params.max_bin_by_feature)
    num_bins = mapper.max_num_bins
    # this process's rows: all of them, or its block under a mesh (the
    # device tensors and the per-row loop state; the host's draws and the
    # mapper cover every row)
    blk = row_block(n, mesh) if sharded else slice(0, n)
    X_loc = X[blk]
    n_loc = blk.stop - blk.start
    # feature-major [F, N] bins: shipped as uint8 when they fit (4x fewer
    # host-to-device bytes) and widened to int32 on the device
    bin_dtype = np.uint8 if num_bins <= 256 else np.int32
    bins_dev = torch.from_numpy(mapper.transform_fm(X_loc, dtype=bin_dtype)) \
        .to(dev).to(torch.int32).contiguous()
    labels = torch.as_tensor(y[blk], dtype=torch.float32, device=dev)
    w_dev = (torch.as_tensor(weights[blk], dtype=torch.float32, device=dev)
             if weights is not None else None)
    # the lambdarank group layout is static across boosting: segment once
    # (under a mesh: the block's queries and those straddling its edges)
    group_seg = queries = None
    if groups is not None and objective == "lambdarank":
        if sharded:
            queries = ShardQueries(groups, y, np.arange(shards + 1)
                                   * (n // shards), data_index(mesh), dev)
        else:
            group_seg = segment_groups(groups, dev)

    if init_scores is not None:
        # per-row init score: boosting starts from it, but it is not part of
        # the saved model (LightGBM init_score semantics)
        base = np.zeros(k, dtype=np.float64)
        init_arr = np.asarray(init_scores, dtype=np.float64).reshape(
            len(init_scores), -1)
        if n - len(init_scores):
            init_arr = np.concatenate(
                [init_arr, np.zeros((n - len(init_scores), init_arr.shape[1]))])
        scores = np.broadcast_to(init_arr[blk], (n_loc, k)).copy()
    else:
        base = init_score(objective, np.asarray(y[:n_real], dtype=np.float64),
                          k, alpha=params.alpha)
        scores = np.tile(base, (n_loc, 1)).astype(np.float64)
    booster = Booster(params, mapper, base_score=base)
    if init_model is not None:
        booster.trees = [list(g) for g in init_model.trees]
        booster.base_score = init_model.base_score
        if init_model.trees:
            # seed from every inherited tree (all of them are carried into
            # the merged model), not the early-stopped prefix
            scores = init_model.raw_predict(
                X_loc, num_iteration=len(init_model.trees)).reshape(n_loc, -1)

    metric = params.metric or default_metric(objective)
    stopper = EarlyStopping(metric, params.early_stopping_round)

    config = GrowerConfig(
        num_leaves=params.num_leaves, max_depth=params.max_depth,
        min_data_in_leaf=params.min_data_in_leaf,
        min_sum_hessian_in_leaf=params.min_sum_hessian_in_leaf,
        min_gain_to_split=params.min_gain_to_split,
        lambda_l1=params.lambda_l1, lambda_l2=params.lambda_l2,
        max_delta_step=params.max_delta_step)
    # categorical SET splits on the flagged features
    cat_args = None
    if params.categorical_feature:
        cat_mask = np.zeros(num_f, dtype=bool)
        cat_mask[list(params.categorical_feature)] = True
        cat_args = (torch.as_tensor(cat_mask, device=dev), params.cat_smooth,
                    params.cat_l2, params.max_cat_threshold)
    lr = 1.0 if is_rf else params.learning_rate
    bag_mask = np.ones(n, dtype=bool)  # persists across iters (bagging_freq)
    max_nodes = 2 * params.num_leaves - 1
    y_real = np.asarray(y[:n_real], dtype=np.float64)
    groups_real = groups[:n_real] if groups is not None else None

    # ----- checkpoint resume: the model and the loop state (scores, the
    # random stream, the bagging mask, early stopping), so iterations
    # start_it.. repeat those of an uninterrupted fit
    start_it, kahan = 0, None
    if checkpoint is not None and checkpoint.resume:
        ck = load_checkpoint(checkpoint.path)
        if ck is not None:
            check_params_match(ck["params"], dataclasses.asdict(params),
                               checkpoint.path)
            restored = Booster.from_string(ck["model"])
            booster.trees = restored.trees
            booster.base_score = restored.base_score
            if ck["scores"].shape != (n, k) \
                    or int(ck.get("data_shards", 1)) != shards:
                raise ValueError(
                    f"checkpoint {checkpoint.path!r} scores shape "
                    f"{ck['scores'].shape} over "
                    f"{int(ck.get('data_shards', 1))} data shards does not "
                    f"match this dataset ({(n, k)} over {shards}); resume "
                    f"requires the same data and mesh")
            # the saved scores are every row's: this process keeps its block
            scores = ck["scores"][blk]
            kahan = ck.get("kahan")
            if kahan is not None:
                kahan = kahan[:, blk]
            rng.bit_generator.state = ck["rng_state"]
            bag_mask = ck["bag_mask"].astype(bool)
            stopper.best_val = ck["best_val"]
            stopper.best_iter = ck["best_iter"]
            stopper.no_improve = ck["rounds_no_improve"]
            start_it = int(ck["iteration"])

    holdout = _Holdout(valid, k) if valid is not None else None
    if holdout is not None:
        holdout.extend(booster.trees)

    # CUDA keeps the running scores on the device (Kahan f32); the CPU, and
    # dart everywhere, keep exact f64 scores on the host
    score_dev = comp_dev = None
    if fast_scores:
        if kahan is not None:
            # a resumed card fit: the saved (score, compensation) pair
            score_dev = torch.as_tensor(kahan[0].reshape(
                (n_loc,) if k == 1 else (n_loc, k)), device=dev)
            comp_dev = torch.as_tensor(kahan[1].reshape(score_dev.shape),
                                       device=dev)
        else:
            score_dev = torch.as_tensor(scores[:, 0] if k == 1 else scores,
                                        dtype=torch.float32, device=dev)
            comp_dev = torch.zeros_like(score_dev)

    def _host_scores() -> np.ndarray:
        """Every row's f64 score (gathered from every process under a
        mesh: a collective)."""
        if not fast_scores:
            if not sharded:
                return scores
            sc = torch.from_numpy(scores)
        else:
            sc = (score_dev.double() + comp_dev.double()).reshape(n_loc, -1)
        return fetch_global(sc, tree_mesh)

    from ..obs.metrics import TrainRecorder

    recorder = TrainRecorder("gbdt")
    # the whole-run scan: every iteration with no host read (never sharded)
    tree_mesh = mesh if sharded else None
    if not sharded and _scan_train_ok(params, objective, valid, log,
                                      checkpoint, dev):
        row_masks, feat_masks, ok = _scan_precompute_masks(
            params, rng, n, num_f, np.asarray(y), is_rf)
        if ok:
            # no per-iteration step: nothing times an iteration inside the
            # loop (the reference's scan records none either)
            recorder.route("scan")
            _train_scan(params, config, booster, mapper, bins_dev, labels,
                        w_dev, scores, n, num_f, num_bins, k, lr, row_masks,
                        feat_masks, pad_mask=pad_mask, cat_args=cat_args)
            if is_rf:
                rf_average(booster)
            booster.route = "scan"
            return booster

    # the per-iteration loop, over the fused grower where the reference
    # takes it (the card, under the node-histogram budget), else the
    # per-split host grower
    grower = None
    if _fused_tree_enabled(max_nodes, num_f, num_bins, dev):
        grower = FusedGrower(bins_dev, num_bins, config, mapper, cat_args,
                             mesh=tree_mesh)
    booster.route = "fused" if grower is not None else "host"
    recorder.route(booster.route)
    try:
        for it in range(start_it, params.num_iterations):
            it_t0 = time.perf_counter()
            _faults.fire(_faults.TRAIN_STEP, iteration=it)
            # ----- dart: drop a subset of the existing trees from the scores
            dropped: List[int] = []
            if is_dart and booster.trees:
                dropped = dart_drops(params, rng, len(booster.trees))
                for di in dropped:
                    for kk in range(k):
                        scores[:, kk] -= _tree_contrib(booster.trees[di][kk],
                                                       X_loc)

            if not fast_scores:
                score_dev = torch.as_tensor(scores[:, 0] if k == 1 else scores,
                                            dtype=torch.float32, device=dev)
            if queries is not None:
                g, h = queries.grad_hess(score_dev, tree_mesh)
            else:
                g, h = grad_hess(objective, score_dev, labels, w_dev,
                                 params.alpha, groups,
                                 group_segments=group_seg)

            # ----- bagging / goss row selection
            row_mask = bag_mask
            if is_goss:
                # ranked over every row's gradients (gathered under a mesh)
                row_mask, amp = goss_sample(all_gather(g, tree_mesh), n_real,
                                            n, params, rng)
                amp = amp[blk]
                if g.dim() == 2:
                    amp = amp[:, None]
                g, h = g * amp, h * amp
            else:
                drawn = bagging_draw(params, rng, n, y, it, is_rf)
                if drawn is not None:
                    bag_mask = row_mask = drawn

            # ----- feature subsampling
            fm = feature_draw(params, rng, num_f)
            feature_mask = torch.as_tensor(fm, device=dev) if fm is not None \
                else None

            row_mask = row_mask & pad_mask
            mask_dev = torch.as_tensor(row_mask[blk], device=dev)
            # dart's scale
            shrink = lr / (len(dropped) + lr) if dropped else lr
            group: List[Tree] = []
            for kk in range(k):
                gk = g if g.dim() == 1 else g[:, kk].contiguous()
                hk = h if h.dim() == 1 else h[:, kk].contiguous()
                if grower is not None:
                    tree, leaf_of_row = grower.grow(gk, hk, mask_dev,
                                                    feature_mask)
                else:
                    tree, leaf_of_row = grow_tree(bins_dev, gk, hk, mask_dev,
                                                  num_bins, config, mapper,
                                                  feature_mask,
                                                  cat_args=cat_args,
                                                  mesh=tree_mesh)
                tree.shrinkage = shrink
                group.append(tree)
                if fast_scores:
                    vals = np.zeros(max(max_nodes, len(tree.value)),
                                    dtype=np.float32)
                    vals[: len(tree.value)] = tree.value * shrink
                    score_dev, comp_dev = _add_leaf_values(
                        score_dev, comp_dev, torch.as_tensor(vals, device=dev),
                        leaf_of_row, kk if k > 1 else None)
                else:
                    scores[:, kk] += \
                        tree.value[leaf_of_row.cpu().numpy()] * shrink
            if dropped:
                # scale the dropped trees and add them back
                factor = len(dropped) / (len(dropped) + lr)
                for di in dropped:
                    for kk in range(k):
                        booster.trees[di][kk].shrinkage *= factor
                        scores[:, kk] += _tree_contrib(booster.trees[di][kk],
                                                       X_loc)
            booster.trees.append(group)

            # ----- eval + early stopping
            if params.train_metric and log:
                host_sc = _host_scores()[:n_real]
                tm = eval_metric(metric, host_sc[:, 0] if k == 1 else host_sc,
                                 y_real, groups_real)
                recorder.metric(f"train_{metric}", tm)
                log(f"[{it + 1}] train {metric}={tm:.6f}")
            if holdout is not None:
                holdout.extend([group])
                m = eval_metric(metric, holdout.raw(booster),
                                np.asarray(holdout.y, dtype=np.float64),
                                valid_groups)
                recorder.metric(f"valid_{metric}", m)
                stop = stopper.update(m, len(booster.trees))
                if log:
                    log(f"[{it + 1}] valid {metric}={m:.6f}")
                if stop:
                    booster.best_iteration = stopper.best_iter
                    if log:
                        log(f"early stopping at iteration {it + 1}, "
                            f"best {stopper.best_iter}")
                    recorder.step(time.perf_counter() - it_t0, examples=n_real)
                    break
            elif log and not params.train_metric and (it + 1) % 10 == 0:
                host_sc = _host_scores()[:n_real]
                m = eval_metric(metric, host_sc[:, 0] if k == 1 else host_sc,
                                y_real, groups_real)
                recorder.metric(f"train_{metric}", m)
                log(f"[{it + 1}] train {metric}={m:.6f}")

            # ----- atomic checkpoint every k iterations (and at the end);
            # under a mesh every rank gathers the scores (and the card's
            # Kahan pair) over its data group, the mesh's first rank
            # writes, and the ranks wait for the file before going on
            if checkpoint is not None and (
                    (it + 1) % max(checkpoint.every_k, 1) == 0
                    or it + 1 == params.num_iterations):
                ck_t0 = time.perf_counter()
                host_sc = _host_scores()
                pair = (np.moveaxis(fetch_global(torch.stack(
                    [score_dev, comp_dev], dim=1), tree_mesh), 1, 0)
                    if fast_scores else None)
                if not sharded or mesh.index == 0:
                    save_checkpoint(
                        checkpoint.path,
                        params_dict=dataclasses.asdict(params),
                        model_string=booster.to_string(), iteration=it + 1,
                        scores=host_sc, rng_state=rng.bit_generator.state,
                        bag_mask=bag_mask, best_val=stopper.best_val,
                        best_iter=stopper.best_iter,
                        rounds_no_improve=stopper.no_improve, kahan=pair,
                        data_shards=shards)
                if sharded:
                    barrier(mesh)
                recorder.checkpoint(time.perf_counter() - ck_t0)
            recorder.step(time.perf_counter() - it_t0, examples=n_real)
    finally:
        if grower is not None:
            grower.release()
    if is_rf:
        rf_average(booster)
    return booster


def _tree_contrib(tree: Tree, X: np.ndarray) -> np.ndarray:
    from .predict import predict_single_tree

    return predict_single_tree(tree, X)


class _Holdout:
    """The validation rows' raw scores, as ``Booster.raw_predict`` gives
    them with every tree, bit for bit: each tree's leaf per row is found once
    and its contribution (value times the tree's current shrinkage, which
    dart rescales) re-added in tree order."""

    def __init__(self, valid: Tuple[np.ndarray, np.ndarray], k: int):
        self.X, self.y = valid
        self.k = k
        self.leaves: List[List[np.ndarray]] = []

    def extend(self, groups: List[List[Tree]]) -> None:
        from .predict import leaf_nodes

        for group in groups:
            self.leaves.append([leaf_nodes(t, self.X) for t in group])

    def raw(self, booster: "Booster") -> np.ndarray:
        nv = self.X.shape[0]
        out = np.zeros((nv, self.k), dtype=np.float64)
        for group, leaves in zip(booster.trees, self.leaves):
            for kk, (t, node) in enumerate(zip(group, leaves)):
                out[:, kk] += t.value[node] * t.shrinkage
        sc = np.tile(booster.base_score, (nv, 1)).astype(np.float64)
        sc += out
        return sc[:, 0] if self.k == 1 else sc
