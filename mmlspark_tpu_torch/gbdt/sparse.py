"""Sparse (CSR) feature path through the GBDT engine, in PyTorch.

Counterpart of the reference's ``mmlspark_tpu/gbdt/sparse.py``: the
reference trains on sparse rows the way
LightGBM's ``generateSparseDataset`` does, for hashed-text and VW-width
feature spaces (2^18+ columns), without ever densifying.

  - ``rows_to_csr`` / ``SparseDataset``: numpy, copied. CSR plus
    per-feature distinct-value binning over the nonzeros with the implicit
    zero as its own bin, laid out as one FLAT ragged bin space
    (``feat_offset``; LightGBM's num_total_bin layout).
  - ``device_arrays``: the bin-sorted entry layout and per-bin tables as
    tensors on an explicit device (int32 layouts: nnz < 2^31).
  - histograms: the masked ``[3, nnz]`` entry stats go through K4
    (``sparse_hist_kernel``: CUDA for CUDA tensors, the plain version for
    CPU tensors); the zero bin of every feature is the node total minus the
    feature's nonzero sums (``_zero_completed``).
  - ``_find_best_split_flat``: the vectorized gain scan over all flat bins.
  - ``grow_tree_sparse``: one tree, routed as the reference decides: the
    fused grower (``_grow_tree_sparse_body``: the node tables and the
    candidates on the device, a fixed ``num_leaves - 1`` steps under a
    device "active" flag, one host read of the finished tree; a CUDA graph
    a tree in ``SparseFusedGrower``) on the card under the 2 GiB state
    gate, or the reference's per-split host loop
    (``_grow_tree_sparse_host``: a heap frontier, two host reads a split)
    on the CPU or above the gate. Node ids in split order.
  - ``train_sparse``: every boosting type (gbdt, rf, dart, goss), bagging,
    feature fraction, weights, init scores, every objective (lambdarank
    included), a CSR validation set with early stopping, and an in-memory
    ``init_model``, on one of three routes: ``scan`` (``_train_scan_sparse``:
    every iteration with no host read, one graph replay an iteration on the
    card; GOSS selected on the device by ``_exact_topk_mask`` over the
    reference's Threefry draws; the stream compacted to the selected rows'
    entries, ``_sparse_compact_cap``, and routing made lazy,
    ``_assign_leaves_all_rows``), ``fused`` or ``host`` (the reference's
    host-orchestrated loop over either grower).
  - ``predict_csr`` / ``CsrRows``: depth-stepped traversal, each row
    resolving the split feature through its own CSR row (absent -> 0.0), in
    f64 on the device; ``CsrRows`` stages the rows once for the loop's
    repeated scoring (DART's drops, the validation set). On the CPU the
    native C++ CSR traversal, as in the reference.

Where the port's arithmetic differs from the reference's, on purpose: the
reference takes within-feature sums as differences of one f32 prefix over
the whole flat bin space. After zero completion every feature's bins sum
to the node totals, so at 2^18 features that prefix passes 10^10 (one f32
ulp is 8192) and a rare feature's sums are lost. The port takes them with
a segmented (per-feature) scan in f64, the same elementwise adds on every
device, and rounds to f32 before the reference's f32 gain formula. The
reference's own formula (``_prefix_sum`` and ``cs - base``) is kept as
``_find_best_split_flat(..., faithful=True)``, which ``chip_smoke.py``
holds against the port's at full width. ROADMAP §C has the numbers.

Data-parallel training (``train_sparse(mesh=)``, the reference's
``shard_sparse_dataset`` and ``grow_tree_sparse_sharded``): each process of
the mesh calls with the same dataset, keeps its nnz-balanced contiguous
block of rows (``shard_bounds``, ``SparseDataset.rows``) and grows every
tree with the fused body, its flat histograms and root totals summed in
f64 across the processes and rounded once (``histogram.shard_reduce``).
Each process holds its own tensors, so the blocks are not padded to one
shape as ``shard_map`` forced the reference to (``nnz_valid``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.batching import sparse_width
from ..parallel.mesh import all_gather, data_index, fetch_global, mesh_shards
from ..runtime import (DeviceLike, default_device, device_work,
                       resolve_device)
from .booster import (Booster, EarlyStopping, ShardQueries, _env_on,
                      _scan_precompute_masks, bagging_draw, dart_drops,
                      default_metric, eval_metric, feature_draw, goss_sample,
                      grad_hess, init_score, rf_average, segment_groups)
from .histogram import (Reduce, _f32, _leaf_objective, reduced_histogram,
                        shard_reduce, total_sums, total_sums_sharded,
                        xla_cumsum)
from .predict import _tree_depth
from .sparse_hist_kernel import sparse_histogram
from .tree import GrowerConfig, Tree, leaf_values

_MAX_SPARSE_BIN = 64  # per-feature cap: count/tf features have few levels

_LOG = logging.getLogger(__name__)


def rows_to_csr(col, num_features: Optional[int] = None,
                filter_zeros: bool = True):
    """Sparse-row column ({"indices","values"[,"size"]}) -> sorted CSR
    (indptr, indices, values, width). The single row-walk shared by training
    (SparseDataset.from_rows) and predict (the stages' scoring)."""
    width = num_features or sparse_width(col)
    indptr = np.zeros(len(col) + 1, dtype=np.int64)
    idx_parts, val_parts = [], []
    for i, v in enumerate(col):
        if v is None:
            indptr[i + 1] = indptr[i]
            continue
        idx = np.asarray(v["indices"], dtype=np.int64)
        val = np.asarray(v["values"], dtype=np.float64)
        keep = idx < width
        if filter_zeros:
            keep &= val != 0.0
        idx, val = idx[keep], val[keep]
        srt = np.argsort(idx, kind="stable")  # CSR contract: sorted rows
        idx_parts.append(idx[srt])
        val_parts.append(val[srt])
        indptr[i + 1] = indptr[i] + len(idx)
    indices = (np.concatenate(idx_parts) if idx_parts
               else np.zeros(0, dtype=np.int64))
    values = (np.concatenate(val_parts) if val_parts
              else np.zeros(0, dtype=np.float64))
    return indptr, indices, values, width


@dataclasses.dataclass
class SparseDataset:
    """CSR dataset with flat ragged binning over the nonzero values."""

    indptr: np.ndarray        # i64 [N+1]
    indices: np.ndarray       # i32 [nnz] feature ids
    values: np.ndarray        # f32 [nnz]
    num_features: int
    # binning (flat ragged layout)
    feat_offset: np.ndarray   # i64 [F+1]: feature f owns flat bins
    #                           [feat_offset[f], feat_offset[f+1])
    thresholds: np.ndarray    # f64 [total_bins]: upper value per flat bin
    zero_local: np.ndarray    # i32 [F]: local bin index holding value 0.0
    bin_of_nnz: np.ndarray    # i64 [nnz]: flat bin id per entry
    row_of_nnz: np.ndarray    # i32 [nnz]

    @property
    def num_rows(self) -> int:
        return len(self.indptr) - 1

    @property
    def total_bins(self) -> int:
        return int(self.feat_offset[-1])

    @staticmethod
    def from_rows(col, num_features: Optional[int] = None,
                  max_bin: int = _MAX_SPARSE_BIN) -> "SparseDataset":
        """Build from a sparse-row column ({"indices","values"[,"size"]})."""
        indptr, indices, values, width = rows_to_csr(col, num_features)
        return SparseDataset.from_csr(indptr, indices, values, width, max_bin)

    @staticmethod
    def from_csr(indptr, indices, values, num_features: int,
                 max_bin: int = _MAX_SPARSE_BIN) -> "SparseDataset":
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        nnz = len(indices)

        # One synthetic zero "entry" per present feature makes the implicit
        # zero an ordinary distinct value: binning, zero position and
        # capping all handle it uniformly.
        feats_present = np.unique(indices) if nnz else np.zeros(0, np.int64)
        fs_aug = np.concatenate([indices, feats_present])
        vs_aug = np.concatenate([values, np.zeros(len(feats_present))])

        # distinct (feature, value) pairs via one lexsort; per-entry pair id
        order = np.lexsort((vs_aug, fs_aug))
        fs, vs = fs_aug[order], vs_aug[order]
        m = len(fs)
        first = np.ones(m, dtype=bool)
        if m:
            first[1:] = (fs[1:] != fs[:-1]) | (vs[1:] != vs[:-1])
        pair_of_sorted = np.cumsum(first) - 1 if m \
            else np.zeros(0, dtype=np.int64)
        df, dv = fs[first], vs[first]          # value-ascending per feature

        # stride-quantile cap: feature f with d_f distinct values uses
        # stride_f = ceil(d_f / max_bin); local bin = distinct_pos // stride,
        # an even subsample of the value range
        d_per_feat = np.bincount(df, minlength=num_features)
        stride = np.maximum(1, -(-d_per_feat // max_bin))      # [F]
        first_pair = np.searchsorted(df, df)
        pos_in_feat = np.arange(len(df)) - first_pair
        local_of_pair = pos_in_feat // stride[df]
        bins_per_feat = np.where(d_per_feat > 0,
                                 -(-d_per_feat // stride), 0)
        feat_offset = np.zeros(num_features + 1, dtype=np.int64)
        np.cumsum(bins_per_feat, out=feat_offset[1:])
        total_bins = int(feat_offset[-1])

        # upper threshold of flat bin (f, j): midpoint between the last
        # distinct value covered by bin j and the first of bin j+1; the
        # feature's last bin is +inf
        thresholds = np.full(total_bins, np.inf)
        if len(df):
            flat_of_pair = feat_offset[df] + local_of_pair
            not_last = np.zeros(len(df), dtype=bool)
            not_last[:-1] = (df[:-1] == df[1:]) & \
                (flat_of_pair[:-1] != flat_of_pair[1:])
            b_idx = np.nonzero(not_last)[0]
            thresholds[flat_of_pair[b_idx]] = (dv[b_idx] + dv[b_idx + 1]) / 2.0

        # zero position: the synthetic zero is a distinct value of every
        # present feature; take its pair's local bin
        zero_local = np.zeros(num_features, dtype=np.int32)
        if len(df):
            zpair = (dv == 0.0)
            zero_local[df[zpair]] = local_of_pair[zpair].astype(np.int32)

        # flat bin per ORIGINAL nnz entry (the synthetic zeros occupy the
        # tail of the augmented arrays)
        bin_of_nnz = np.zeros(nnz, dtype=np.int64)
        if nnz:
            flat_sorted = (feat_offset[df] + local_of_pair)[pair_of_sorted]
            flat_aug = np.zeros(len(fs_aug), dtype=np.int64)
            flat_aug[order] = flat_sorted
            bin_of_nnz = flat_aug[:nnz]
        return SparseDataset(
            indptr=indptr,
            indices=indices.astype(np.int32),
            values=values.astype(np.float32),
            num_features=int(num_features),
            feat_offset=feat_offset,
            thresholds=thresholds,
            zero_local=zero_local,
            bin_of_nnz=bin_of_nnz,
            row_of_nnz=np.repeat(
                np.arange(len(indptr) - 1, dtype=np.int64),
                np.diff(indptr)).astype(np.int32),
        )

    def bin_upper_value(self, f: int, local_bin: int) -> float:
        return float(self.thresholds[int(self.feat_offset[f]) + local_bin])

    def rows(self, r0: int, r1: int) -> "SparseDataset":
        """Rows [r0, r1) over the same flat bin space (a shard's block):
        its own CSR slice and entries, the binning of the whole set."""
        e0, e1 = int(self.indptr[r0]), int(self.indptr[r1])
        return dataclasses.replace(
            self, indptr=self.indptr[r0:r1 + 1] - e0,
            indices=self.indices[e0:e1], values=self.values[e0:e1],
            bin_of_nnz=self.bin_of_nnz[e0:e1],
            row_of_nnz=(self.row_of_nnz[e0:e1] - r0).astype(np.int32))


def shard_bounds(ds: SparseDataset, n_shards: int) -> np.ndarray:
    """[S + 1] row bounds of ``n_shards`` contiguous nnz-balanced blocks:
    the block edges at equal quantiles of the cumulative entries, monotone
    under empty blocks (the reference's ``shard_sparse_dataset``)."""
    n = ds.num_rows
    nnz = len(ds.indices)
    targets = (np.arange(1, n_shards) * nnz) // n_shards
    bounds = np.concatenate([
        [0], np.searchsorted(ds.indptr[1:], targets, side="left") + 1, [n]])
    return np.maximum.accumulate(bounds).astype(np.int64)


# ---------------------------------------------------------------------------
# Device layout
# ---------------------------------------------------------------------------


def _bin_sorted_layout(bin_of_nnz: np.ndarray, total_bins: int):
    """Host precompute for the flat histogram: a stable sort of entries by
    flat bin + the per-bin [start, end) offsets into the sorted stream.
    Returns (order, bin_start [TB], bin_end [TB])."""
    order = np.argsort(bin_of_nnz, kind="stable")
    sorted_bins = bin_of_nnz[order]
    bin_start = np.searchsorted(sorted_bins, np.arange(total_bins),
                                side="left")
    bin_end = np.searchsorted(sorted_bins, np.arange(total_bins),
                              side="right")
    return order, bin_start.astype(np.int64), bin_end.astype(np.int64)


def device_arrays(ds: SparseDataset, device: DeviceLike = None) -> Dict:
    """The reference's ``_device_arrays`` dict, as tensors on ``device``
    (default: ``default_device()``). Index layouts are int32 (nnz < 2^31);
    ``route_steps`` is the bit length of the largest row nnz (the routing
    search's step count), ``scan_steps`` the bit length of the largest
    feature's bin count minus one (the segmented scan's step count)."""
    dev = resolve_device(device)
    tb = ds.total_bins
    feat_of_bin = np.repeat(np.arange(ds.num_features, dtype=np.int64),
                            np.diff(ds.feat_offset))
    feat_start = ds.feat_offset[feat_of_bin]
    feat_end = ds.feat_offset[feat_of_bin + 1] - 1
    is_last = np.arange(tb) == feat_end
    present = np.nonzero(np.diff(ds.feat_offset) > 0)[0]
    zero_flat = (ds.feat_offset[present]
                 + ds.zero_local[present]).astype(np.int64)
    is_zero_bin = np.zeros(tb, dtype=bool)
    is_zero_bin[zero_flat] = True
    order, _, bin_end = _bin_sorted_layout(ds.bin_of_nnz, tb)
    row_nnz = np.diff(ds.indptr)
    bins_per_feat = np.diff(ds.feat_offset)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    i32 = torch.int32
    return {
        "bin_of_nnz": put(ds.bin_of_nnz, i32),
        "feat_of_nnz": put(ds.indices, i32),
        "indptr": put(ds.indptr, i32),
        # bin-sorted view of the entries for the flat histogram
        "row_of_nnz_bs": put(ds.row_of_nnz[order], i32),
        "bin_end": put(bin_end, i32),
        "is_zero_bin": put(is_zero_bin, torch.bool),
        "feat_of_bin": put(feat_of_bin, i32),
        "feat_start_of_bin": put(feat_start, i32),
        "feat_end_of_bin": put(feat_end, i32),
        "is_last_bin": put(is_last, torch.bool),
        "zero_local": put(ds.zero_local, i32),
        "feat_offset": put(ds.feat_offset, i32),
        "route_steps": int(max(int(row_nnz.max()) if len(row_nnz) else 1,
                               1)).bit_length(),
        "scan_steps": int(max(int(bins_per_feat.max())
                              if len(bins_per_feat) else 1, 1) - 1
                          ).bit_length(),
    }


# ---------------------------------------------------------------------------
# Histograms and split search over the flat ragged bin space
# ---------------------------------------------------------------------------

_PREFIX_BLOCK = 512


def _prefix_sum(data: torch.Tensor, int_channel: Optional[int] = None):
    """The reference's ``_prefix_sum``: inclusive prefix sum of f32 [C, n]
    with a LEADING zero column -> [C, n+1] (``out[:, k]`` = sum of the first
    k elements), and, for ``int_channel`` (the count channel), an exact
    integer prefix [n+1] beside it.

    Below 2^18 columns a plain cumsum: on the CPU in XLA's CPU order
    (``xla_cumsum``), so it is bit-identical to the reference's
    ``jnp.cumsum``; on CUDA ``torch.cumsum``. Above, the reference's blocked
    scheme: inclusive prefixes within 512-wide blocks as one product with an
    upper-triangular matrix (full f32: TF32 off), plus a cumsum over the
    block sums. The integer prefix is int64 (``torch.cumsum`` of int32
    widens), so unlike the reference's int32 prefix it does not wrap past
    2^31."""
    c, n = data.shape
    zero = torch.zeros(c, 1, dtype=data.dtype, device=data.device)
    xi = None
    if n < (1 << 18):
        cs = (xla_cumsum(data, 1) if data.device.type == "cpu"
              else torch.cumsum(data, 1))
        out = torch.cat([zero, cs], 1)
        if int_channel is not None:
            xi = torch.cumsum(torch.round(data[int_channel]).to(torch.int64), 0)
    else:
        B = _PREFIX_BLOCK
        n_pad = (n + B - 1) // B * B
        x = torch.nn.functional.pad(data, (0, n_pad - n)).reshape(c, -1, B)
        iota = torch.arange(B, device=data.device)
        ut = (iota[:, None] <= iota[None, :]).to(data.dtype)     # [B, B]
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            intra = torch.matmul(x, ut)                      # [c, nb, B]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        block_excl = torch.cumsum(intra[:, :, -1], 1) - intra[:, :, -1]
        cs = (intra + block_excl[:, :, None]).reshape(c, n_pad)[:, :n]
        out = torch.cat([zero, cs], 1)
        if int_channel is not None:
            xr = torch.round(x[int_channel]).to(torch.int64)    # [nb, B]
            intra_i = torch.cumsum(xr, 1)
            bsum = intra_i[:, -1]
            bexcl = torch.cumsum(bsum, 0) - bsum
            xi = (intra_i + bexcl[:, None]).reshape(n_pad)[:n]
    if int_channel is None:
        return out
    return out, torch.cat([xi.new_zeros(1), xi])


def _exact_topk_mask(key: torch.Tensor, k: int, n: int,
                     exclude: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n] bool mask of exactly ``min(k, eligible)`` rows with the largest
    ``|key|``, ties to the lowest row index: the reference's sort-free
    selection, a 32-step bisection for the threshold on the u32 view of the
    f32 key (plus 1, so an excluded row's 0 sorts below every eligible row)
    and a 32-step bisection for the index cut among the rows at the
    threshold. Each step is a compare and a count, in int64; nothing is
    read on the host and the result is integer arithmetic, so it is the
    same on every device. ``exclude``: optional [n] bool of rows never
    selected."""
    dev = key.device
    if k <= 0:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    ik = key.abs().to(torch.float32).view(torch.int32).to(torch.int64) + 1
    if exclude is not None:
        ik = torch.where(exclude, 0, ik)
        kk = torch.clamp((~exclude).sum(), max=k)
    else:
        kk = torch.full((), min(k, n), dtype=torch.int64, device=dev)
    # the largest t with count(ik >= t) >= kk (the count falls as t grows)
    lo = torch.zeros((), dtype=torch.int64, device=dev)
    hi = torch.full((), 2 ** 31 + 1, dtype=torch.int64, device=dev)
    for _ in range(32):
        mid = lo + ((hi - lo + 1) >> 1)
        take = (ik >= mid).sum() >= kk
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid - 1)
    gt = ik > lo
    need = kk - gt.sum()                     # rows still to take at t
    tie = ik == lo
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    # the smallest c with count(tie & idx < c) >= need
    c_lo = torch.zeros((), dtype=torch.int64, device=dev)
    c_hi = torch.full((), n, dtype=torch.int64, device=dev)
    for _ in range(32):
        mid = (c_lo + c_hi) >> 1
        ok = (tie & (idx < mid)).sum() >= need
        c_lo, c_hi = torch.where(ok, c_lo, mid + 1), torch.where(ok, mid, c_hi)
    return gt | (tie & (idx < c_lo))


def _segmented_cumsum(dev: Dict, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of [..., TB] WITHIN each feature's run of flat
    bins (a Hillis-Steele scan in ``scan_steps`` elementwise steps). The same
    adds in the same order on every device, so CPU and CUDA agree bitwise;
    run in f64 by the callers."""
    tb = x.shape[-1]
    pos = torch.arange(tb, device=x.device)
    start = dev["feat_start_of_bin"]
    for s in range(dev["scan_steps"]):
        d = 1 << s
        if d >= tb:
            break
        prev = torch.nn.functional.pad(x[..., :-d], (d, 0))
        x = x + torch.where(pos - d >= start, prev, 0.0)
    return x


def _entry_gh(dev: Dict, grad: torch.Tensor, hess: torch.Tensor):
    """Per-entry grad/hess in bin-sorted order, gathered once per tree (they
    are loop-invariant during a tree; only the node mask gather stays in the
    per-split path)."""
    rows_bs = dev["row_of_nnz_bs"]
    return grad.index_select(0, rows_bs), hess.index_select(0, rows_bs)


def _flat_histogram(dev: Dict, g_bs: torch.Tensor, h_bs: torch.Tensor,
                    node_mask_rows: torch.Tensor, reduce: Reduce = None
                    ) -> torch.Tensor:
    """Nonzero-entry histogram [3, TB] over the node's rows: one [nnz] row
    mask gather, the masked [3, nnz] stack, and K4 (channel-major, as the
    reference's); with ``reduce``, K4's f64 sums summed over the shards
    and rounded once."""
    m = node_mask_rows.index_select(0, dev["row_of_nnz_bs"]).to(torch.float32)
    data = torch.stack([g_bs * m, h_bs * m, m])
    return reduced_histogram(reduce, sparse_histogram, data, dev["bin_end"])


def _zero_completed(dev: Dict, flat_hist: torch.Tensor,
                    node_totals: torch.Tensor) -> torch.Tensor:
    """Add the implicit-zero bin of every feature: node totals minus the
    feature's nonzero-entry sums (LightGBM's default-bin subtraction). The
    feature sums come from the segmented scan in f64; each completed cell is
    rounded to f32 once."""
    h64 = flat_hist.double()
    feat_sum = _segmented_cumsum(dev, h64).index_select(
        -1, dev["feat_end_of_bin"])
    add = torch.where(dev["is_zero_bin"],
                      node_totals.double()[:, None] - feat_sum, 0.0)
    return (h64 + add).float()


def _find_best_split_flat(dev: Dict, hist: torch.Tensor, lambda_l1, lambda_l2,
                          min_sum_hessian, min_data_in_leaf: int,
                          bin_mask: Optional[torch.Tensor] = None,
                          faithful: bool = False) -> torch.Tensor:
    """Vectorized gain scan over ALL flat bins of each [3, TB] histogram of a
    [P, 3, TB] stack: candidate t at flat bin b sends local bins <= b left.
    Returns [P, 8] f64 (bin, gain, GL, HL, CL, GR, HR, CR) of each best
    candidate, ties to the lowest flat bin (``jnp.argmax``).

    Within-feature left sums: by default the f64 segmented scan, with
    right = total - left in f64, each rounded to f32 once; ``faithful`` takes
    the reference's formula as written (``cs - base`` over the f32
    ``_prefix_sum`` of all TB bins, right = total - left in f32, counts from
    the integer prefix). The gain formula and constraints are the
    reference's, in f32.

    ``bin_mask``: optional [TB] bool of ALLOWED candidate bins (feature
    fraction mapped to the flat bin space)."""
    l1, l2, msh = _f32(lambda_l1), _f32(lambda_l2), _f32(min_sum_hessian)
    p = hist.shape[0]
    fs, fe = dev["feat_start_of_bin"], dev["feat_end_of_bin"]
    if faithful:
        outs = []
        for hp in hist:
            cs, cs_i = _prefix_sum(hp, int_channel=2)
            cs, cs_i = cs[:, 1:], cs_i[1:]
            left = cs - (cs.index_select(-1, fs) - hp.index_select(-1, fs))
            total = left.index_select(-1, fe)
            hist_cnt = torch.round(hp[2]).to(torch.int64)
            left_i = cs_i - (cs_i.index_select(0, fs)
                             - hist_cnt.index_select(0, fs))
            total_i = left_i.index_select(0, fe)
            GL, HL = left[0], left[1]
            G, H = total[0], total[1]
            outs.append(torch.stack([
                GL, HL, left_i.to(torch.float32), G - GL, H - HL,
                (total_i - left_i).to(torch.float32), G, H]))
        parts = torch.stack(outs)                        # [P, 8, TB]
    else:
        left = _segmented_cumsum(dev, hist.double())     # [P, 3, TB]
        total = left.index_select(-1, fe)
        parts = torch.cat([left, total - left, total[:, :2]], 1).float()
    GL, HL, CL, GR, HR, CR, G, H = parts.unbind(1)
    gain = (_leaf_objective(GL, HL, l1, l2) + _leaf_objective(GR, HR, l1, l2)
            - _leaf_objective(G, H, l1, l2)) * -1.0
    ok = ((CL >= min_data_in_leaf) & (CR >= min_data_in_leaf)
          & (HL >= msh) & (HR >= msh) & ~dev["is_last_bin"])
    if bin_mask is not None:
        ok = ok & bin_mask
    gain = torch.where(ok, gain, float("-inf"))
    b = torch.argmax(gain, dim=1)                        # [P], first max
    rows = torch.arange(p, device=hist.device)
    d = torch.float64
    return torch.cat([b.to(d)[:, None], gain[rows, b].to(d)[:, None],
                      parts[rows, :6, b].to(d)], 1)


# ---------------------------------------------------------------------------
# Row routing
# ---------------------------------------------------------------------------


def _row_feature_search(dev: Dict, lo: torch.Tensor, hi: torch.Tensor,
                        f) -> torch.Tensor:
    """Vectorized lower-bound search for each row's entry of feature ``f``
    (one feature, or one a row) inside the row's feature-sorted CSR slice
    [lo, hi): ``route_steps`` gather steps (each row's slice is at most
    max-row-nnz wide), with no host read."""
    feats = dev["feat_of_nnz"]
    last = max(feats.shape[0] - 1, 0)
    for _ in range(dev["route_steps"]):
        cont = lo < hi
        mid = (lo + hi) >> 1
        go_hi = feats.index_select(0, torch.clamp(mid, 0, last)) < f
        lo = torch.where(cont & go_hi, mid + 1, lo)
        hi = torch.where(cont & ~go_hi, mid, hi)
    return lo


def _route_rows(dev: Dict, node_of_row: torch.Tensor, node_id, f, b, lid,
                rid, zero_goes_left) -> torch.Tensor:
    """Send the node's rows left iff their value's flat bin <= ``b`` (a bin
    of feature ``f``); rows without an entry of ``f`` carry the feature's
    zero bin (``zero_goes_left``). The node, feature, bin and children are
    ints or 1-element device tensors (the device-resident grower's, so the
    routing reads nothing on the host). With ``dev["route_lo"]`` /
    ``dev["route_hi"]`` (lazy routing) the routed rows are the selected
    rows, each searched in its own CSR slice of the entry stream."""
    dt = node_of_row.dtype
    dv = node_of_row.device

    def t(x):
        return torch.as_tensor(x, device=dv).reshape(-1)

    node_id, f, b, lid, rid = (t(x) for x in (node_id, f, b, lid, rid))
    in_node = node_of_row == node_id
    default = torch.where(t(zero_goes_left), lid, rid).to(dt)
    out = torch.where(in_node, default, node_of_row)
    feats = dev["feat_of_nnz"]
    if feats.shape[0] == 0:
        return out
    if "route_lo" in dev:
        lo0, hi0 = dev["route_lo"], dev["route_hi"]
    else:
        indptr = dev["indptr"]
        lo0, hi0 = indptr[:-1], indptr[1:]
    lo = _row_feature_search(dev, lo0, hi0, f)
    pos = torch.clamp(lo, 0, feats.shape[0] - 1)
    has = (lo < hi0) & (feats.index_select(0, pos) == f)
    target = torch.where(dev["bin_of_nnz"].index_select(0, pos) <= b, lid, rid)
    return torch.where(in_node & has, target.to(dt), out)


def _assign_leaves_all_rows(dev: Dict, out: Dict[str, torch.Tensor],
                            steps: int) -> torch.Tensor:
    """Every row of the dataset routed through a finished tree of
    ``_grow_tree_sparse_body`` (the lazy-routing complement): ``steps``
    level-synchronous passes, each advancing every row one node by one
    vectorized search for the row's entry of its current node's feature;
    an absent feature carries its zero bin, as in ``_route_rows``. A row at
    a leaf stays, so ``steps`` is any bound on the tree's depth."""
    feat, fbin = out["feature"], out["flat_bin"]
    li, ri = out["left"], out["right"]
    indptr = dev["indptr"]
    lo_all, hi_all = indptr[:-1], indptr[1:]
    feats, bins = dev["feat_of_nnz"], dev["bin_of_nnz"]
    zero_bin = dev["feat_offset"][:-1] + dev["zero_local"]
    nnz = feats.shape[0]
    pos = torch.zeros(lo_all.shape[0], dtype=torch.int64,
                      device=indptr.device)
    for _ in range(steps):
        f = feat.index_select(0, pos)
        f_safe = torch.clamp(f, min=0)
        bin_eff = zero_bin.index_select(0, f_safe)
        if nnz:
            lo = _row_feature_search(dev, lo_all, hi_all, f_safe)
            p = torch.clamp(lo, 0, nnz - 1)
            has = (lo < hi_all) & (feats.index_select(0, p) == f_safe)
            bin_eff = torch.where(has, bins.index_select(0, p), bin_eff)
        nxt = torch.where(bin_eff <= fbin.index_select(0, pos),
                          li.index_select(0, pos), ri.index_select(0, pos))
        pos = torch.where(f >= 0, nxt.to(torch.int64), pos)
    return pos


# ---------------------------------------------------------------------------
# Whole-tree growth
# ---------------------------------------------------------------------------

# The reference's cap on the fused grower's [2L - 1, total_bins, 3] f32 node
# histograms; above it the per-split host loop grows the tree
_FUSED_SPARSE_DEFAULT_BUDGET = 2 << 30

#: host reads of device data the sparse growers made (a reading aid: the
#: fused route makes one a tree, the per-split loop one at the root and one
#: for each child it evaluates, two a split)
host_reads = 0


def _fused_sparse_enabled(max_nodes: int, total_bins: int) -> bool:
    """The reference's gate on the fused grower's node histograms: under
    ``MMLSPARK_TPU_FUSED_TREE_BYTES`` (2 GiB by default), and never with
    ``MMLSPARK_TPU_NO_FUSED_TREE`` set."""
    if _env_on("MMLSPARK_TPU_NO_FUSED_TREE"):
        return False
    budget = int(os.environ.get("MMLSPARK_TPU_FUSED_TREE_BYTES",
                                _FUSED_SPARSE_DEFAULT_BUDGET))
    return max_nodes * total_bins * 3 * 4 <= budget


def _masked_totals(grad: torch.Tensor, hess: torch.Tensor,
                   row_mask: torch.Tensor) -> torch.Tensor:
    """[3] (sum grad, sum hess, count) over the masked rows, accumulated in
    f64 and rounded to f32 once (device-independent up to a rounding tie):
    ``histogram.total_sums``."""
    return total_sums(grad, hess, row_mask)


def _tree_from_nodes(nn: int, feature, tbin, flat_bin, default_left, left,
                     right, gain, sums, config: GrowerConfig,
                     thresholds: np.ndarray) -> Tree:
    """Tree from the grower's node tables; leaf values recomputed in f64 on
    the host (the reference's ``_tree_from_fused_out``)."""
    feature = feature[:nn].astype(np.int32)
    s64 = sums[:nn].astype(np.float64)
    value = leaf_values(s64, feature, config)
    value[0] = 0.0 if nn == 1 else value[0]
    flat_bin = flat_bin[:nn].astype(np.int64)
    threshold = np.where(feature >= 0, thresholds[flat_bin], 0.0)
    return Tree(
        feature=feature,
        threshold=threshold.astype(np.float64),
        threshold_bin=tbin[:nn].astype(np.int32),
        default_left=default_left[:nn].astype(bool),
        left=left[:nn].astype(np.int32),
        right=right[:nn].astype(np.int32),
        value=value,
        gain=gain[:nn].astype(np.float32),
        count=s64[:, 2].astype(np.int32),
        weight=s64[:, 1],
    )


_PACKED = ("feature", "threshold_bin", "flat_bin", "default_left", "left",
           "right", "gain")


def pack_sparse_tables(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The node tables of ``_grow_tree_sparse_body`` as one [M, 11] f64
    tensor, every field exact, for one host read a tree: feature,
    threshold_bin, flat_bin, default_left, left, right, gain, sums (3),
    n_nodes."""
    d = torch.float64
    m = out["feature"].shape[0]
    cols = [out[k].to(d)[:, None] for k in _PACKED]
    cols += [out["sums"].to(d), out["n_nodes"].to(d).expand(m)[:, None]]
    return torch.cat(cols, dim=1)


def tree_from_sparse_packed(packed: np.ndarray, config: GrowerConfig,
                            thresholds: np.ndarray) -> Tree:
    """A ``Tree`` from one [M, 11] block of ``pack_sparse_tables``."""
    nn = int(packed[0, 10])
    p = packed
    return _tree_from_nodes(nn, p[:, 0], p[:, 1], p[:, 2], p[:, 3] != 0,
                            p[:, 4], p[:, 5], p[:, 6], p[:, 7:10], config,
                            thresholds)


def _grow_tree_sparse_body(dev: Dict, grad: torch.Tensor, hess: torch.Tensor,
                           row_mask: torch.Tensor,
                           node_of_row: Optional[torch.Tensor],
                           root_tot: torch.Tensor, config: GrowerConfig,
                           bin_mask: Optional[torch.Tensor] = None,
                           reduce: Reduce = None) -> Dict[str, torch.Tensor]:
    """Grow one whole tree over the flat sparse bins on the device, with no
    host read: the reference's ``_grow_tree_sparse_body``.

    The node tables and the candidates (``cand_gain``, ``cand_bin``,
    ``cand_lsum``, ``cand_rsum``) are tensors of ``2L - 1`` nodes plus a
    trash slot, where a step that is not active writes. The best-first pop
    is ``argmax`` over the candidate gains (ties to the lowest id); the loop
    runs ``num_leaves - 1`` steps, each active while some candidate is
    finite (the reference's ``while_loop`` condition), so its shapes are
    fixed and a CUDA graph can hold it. Each split routes the leaf's rows,
    builds the smaller child's histogram (K4 on the card) and the sibling's
    by subtraction; a row without an entry of the split feature follows
    the feature's zero bin, and so does ``default_left``.

    ``dev``: ``device_arrays``, or its compacted view (``row_of_nnz_bs``
    and ``bin_end`` of the selected rows' entries; with ``route_lo`` /
    ``route_hi`` the rows are the selected rows). ``root_tot``: [3] f32
    masked (grad, hess, count), of every shard. ``reduce`` (the reference's
    ``psum_axis``): None, or each flat histogram is this process's rows'
    f64 sums through it (``histogram.shard_reduce``). Returns device
    tensors: ``node_of_row``,
    the node tables ``feature``, ``threshold_bin`` (local), ``flat_bin``,
    ``default_left``, ``left``, ``right``, ``gain`` [M], ``sums`` [M, 3]
    f32 and ``n_nodes`` [1] int64."""
    device = grad.device
    n = grad.shape[0]
    M = 2 * config.num_leaves - 1
    T = M                                   # the trash slot
    tb = dev["feat_of_bin"].shape[0]
    l1, l2 = config.lambda_l1, config.lambda_l2
    msh, mdl = config.min_sum_hessian_in_leaf, config.min_data_in_leaf
    mgs = float(np.float32(config.min_gain_to_split))
    neg_inf = float("-inf")
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    if node_of_row is None:
        node_of_row = torch.zeros(n, dtype=i32, device=device)
    g_bs, h_bs = _entry_gh(dev, grad, hess)

    def node_hist(mask_rows, totals):
        return _zero_completed(
            dev, _flat_histogram(dev, g_bs, h_bs, mask_rows, reduce), totals)

    def best(hists):
        return _find_best_split_flat(dev, hists, l1, l2, msh, mdl, bin_mask)

    def table(fill, dtype, *shape):
        return torch.full((M + 1, *shape), fill, dtype=dtype, device=device)

    feature, threshold_bin = table(-1, i32), table(0, i32)
    flat_bin = table(0, i64)
    default_left = table(True, torch.bool)
    left, right = table(-1, i32), table(-1, i32)
    gain, depth = table(0.0, f32), table(0, i32)
    sums = table(0.0, f32, 3)
    sums[0] = root_tot
    cand_gain = table(neg_inf, f32)
    cand_bin = table(0, i64)
    cand_lsum, cand_rsum = table(0.0, f32, 3), table(0.0, f32, 3)
    hists = torch.empty((M + 1, 3, tb), dtype=f32, device=device)
    n_nodes = torch.ones(1, dtype=i64, device=device)
    if tb:
        hists[0] = node_hist(row_mask, root_tot)
        s0 = best(hists[0][None])[0]
        g0 = s0[1].to(f32)
        cand_gain[0] = torch.where(torch.isfinite(g0) & (g0 > mgs), g0,
                                   neg_inf)
        cand_bin[0] = s0[0].to(i64)
        cand_lsum[0], cand_rsum[0] = s0[2:5].to(f32), s0[5:8].to(f32)
    minus_inf = torch.full((1,), neg_inf, dtype=f32, device=device)
    trash = torch.full((1,), T, dtype=i64, device=device)
    steps = config.num_leaves - 1 if tb else 0

    for _ in range(steps):
        cg = cand_gain[:M]
        active = cg.max() > neg_inf
        leaf = torch.argmax(cg).reshape(1)             # ties: the lowest id
        b = cand_bin.index_select(0, leaf)
        f = dev["feat_of_bin"].index_select(0, b).to(i64)
        t_local = b - dev["feat_start_of_bin"].index_select(0, b)
        dl = dev["zero_local"].index_select(0, f) <= t_local
        lsum = cand_lsum.index_select(0, leaf)[0]
        rsum = cand_rsum.index_select(0, leaf)[0]
        lid = n_nodes
        rid = lid + 1
        dchild = depth.index_select(0, leaf) + 1

        node_of_row = _route_rows(dev, node_of_row,
                                  torch.where(active, leaf, -1), f, b, lid,
                                  rid, dl)
        small_is_left = lsum[2] <= rsum[2]
        small_id = torch.where(small_is_left, lid, rid)
        big_id = torch.where(small_is_left, rid, lid)
        csums = torch.stack([torch.where(small_is_left, lsum, rsum),
                             torch.where(small_is_left, rsum, lsum)])
        small_hist = node_hist(row_mask & (node_of_row == small_id), csums[0])
        big_hist = hists.index_select(0, leaf)[0] - small_hist
        pair = best(torch.stack([small_hist, big_hist]))        # [2, 8] f64
        pg = pair[:, 1].to(f32)
        ok = (torch.isfinite(pg) & (pg > mgs) & (csums[:, 2] >= 2 * mdl))
        if config.max_depth > 0:
            ok = ok & (dchild < config.max_depth)

        # push both children (inactive steps write the trash slot)
        ids = torch.where(active, torch.cat([small_id, big_id]), T)
        pid = torch.where(active, leaf, trash)
        gain.index_put_((pid,), cand_gain.index_select(0, leaf))
        cand_gain.index_put_((ids,), torch.where(ok, pg, neg_inf))
        cand_gain.index_put_((pid,), minus_inf)
        cand_bin.index_put_((ids,), pair[:, 0].to(i64))
        cand_lsum.index_put_((ids,), pair[:, 2:5].to(f32))
        cand_rsum.index_put_((ids,), pair[:, 5:8].to(f32))
        feature.index_put_((pid,), f.to(i32))
        threshold_bin.index_put_((pid,), t_local.to(i32))
        flat_bin.index_put_((pid,), b)
        default_left.index_put_((pid,), dl)
        left.index_put_((pid,), lid.to(i32))
        right.index_put_((pid,), rid.to(i32))
        cids = torch.where(active, torch.cat([lid, rid]), T)
        sums.index_put_((cids,), torch.stack([lsum, rsum]))
        depth.index_put_((cids,), dchild.expand(2))
        hists.index_put_((ids,), torch.stack([small_hist, big_hist]))
        n_nodes = n_nodes + active.to(i64) * 2

    return dict(node_of_row=node_of_row, feature=feature[:M],
                threshold_bin=threshold_bin[:M], flat_bin=flat_bin[:M],
                default_left=default_left[:M], left=left[:M],
                right=right[:M], gain=gain[:M], sums=sums[:M],
                n_nodes=n_nodes)


def _fused_sparse_tables(dev: Dict, grad, hess, row_mask, config: GrowerConfig,
                         bin_mask=None, reduce: Reduce = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tree of ``_grow_tree_sparse_body`` over every row as
    (``node_of_row``, its ``pack_sparse_tables``), both on the device; with
    ``reduce`` the row-sharded tree (the reference's
    ``grow_tree_sparse_sharded``: the root totals summed over the shards
    too)."""
    out = _grow_tree_sparse_body(
        dev, grad, hess, row_mask, None,
        total_sums_sharded(grad, hess, row_mask, reduce), config, bin_mask,
        reduce)
    return out["node_of_row"], pack_sparse_tables(out)


def _read_sparse_tree(rows: torch.Tensor, packed: torch.Tensor,
                      config: GrowerConfig, thresholds: np.ndarray
                      ) -> Tuple[Tree, torch.Tensor]:
    """The fused route's one host read a tree: (tree, ``rows``)."""
    global host_reads
    host = packed.cpu().numpy()
    host_reads += 1
    return tree_from_sparse_packed(host, config, thresholds), rows


class SparseFusedGrower:
    """The fused route for the trees of one sparse fit: ``grow`` grows a
    tree with ``_grow_tree_sparse_body`` and reads it once; on the card a
    CUDA graph a tree from the second on, as ``tree.FusedGrower`` does
    (``graphs.Replayer``, ``run``). A returned ``node_of_row`` of a replay
    is the graph's own output: use it before the next ``grow``. With a
    ``mesh`` (``ds`` and ``dev`` this process's block) every tree is the
    row-sharded one: captured with its all-reduces on NCCL, eager on gloo
    (``tree.sharded_replayer``)."""

    def __init__(self, ds: SparseDataset, dev: Dict, config: GrowerConfig,
                 mesh=None):
        from .tree import sharded_replayer

        self.ds, self.config = ds, config
        reduce = shard_reduce(mesh)
        self.run = sharded_replayer(
            lambda g, h, m, bm: _fused_sparse_tables(dev, g, h, m, config, bm,
                                                     reduce),
            dev["bin_of_nnz"].is_cuda, mesh)

    def grow(self, grad: torch.Tensor, hess: torch.Tensor,
             row_mask: torch.Tensor, bin_mask: Optional[torch.Tensor] = None
             ) -> Tuple[Tree, torch.Tensor]:
        return _read_sparse_tree(*self.run(grad, hess, row_mask, bin_mask),
                                 self.config, self.ds.thresholds)

    def release(self) -> None:
        """Free the tree's CUDA graphs (the fit's end)."""
        self.run.release()


def _grow_tree_sparse_host(ds: SparseDataset, dev: Dict, grad: torch.Tensor,
                           hess: torch.Tensor, config: GrowerConfig,
                           row_mask: Optional[torch.Tensor] = None,
                           bin_mask: Optional[torch.Tensor] = None
                           ) -> Tuple[Tree, torch.Tensor]:
    """The reference's per-split host loop (``grow_tree_sparse`` with
    ``use_fused=False``), with its own semantics: a ``heapq`` frontier
    popped by (-gain, push order), the small child pushed before the big
    one; a node's default direction from its threshold's value
    (``0.0 <= threshold``); leaf values in f64 from the fetched sums; only
    the frontier's histograms held. One host read at the root and one for
    each child it evaluates (``host_reads``)."""
    import heapq

    global host_reads
    reads0 = host_reads
    n = ds.num_rows
    device = grad.device
    node_of_row = torch.zeros(n, dtype=torch.int32, device=device)
    ones = (row_mask if row_mask is not None
            else torch.ones(n, dtype=torch.bool, device=device))
    l1, l2 = config.lambda_l1, config.lambda_l2
    msh, mdl = config.min_sum_hessian_in_leaf, config.min_data_in_leaf
    feature, threshold, threshold_bin = [-1], [0.0], [0]
    default_left, left, right = [True], [-1], [-1]
    value, gains, counts, hweights = [0.0], [0.0], [0], [0.0]

    def leaf_value(s: np.ndarray) -> float:
        return float(leaf_values(s[None], np.full(1, -1), config)[0])

    g_bs, h_bs = _entry_gh(dev, grad, hess)

    def node_hist(mask_rows, totals):
        return _zero_completed(
            dev, _flat_histogram(dev, g_bs, h_bs, mask_rows), totals)

    totals0 = _masked_totals(grad, hess, ones)
    hist0 = node_hist(ones, totals0)
    totals0_h = totals0.double().cpu().numpy()
    host_reads += 1
    counts[0] = int(totals0_h[2])
    hweights[0] = float(totals0_h[1])

    def eval_split(hist):
        global host_reads
        s = _find_best_split_flat(dev, hist[None], l1, l2, msh, mdl,
                                  bin_mask)[0].cpu().numpy()
        host_reads += 1
        b = int(s[0])
        f = int(np.searchsorted(ds.feat_offset, b, side="right") - 1)
        return f, b - int(ds.feat_offset[f]), b, float(np.float32(s[1])), \
            s[2:5], s[5:8]

    heap: list = []
    tiebreak = 0

    def push(node_id, depth, hist, sums):
        nonlocal tiebreak
        f, t_local, b, g, lsum, rsum = eval_split(hist)
        if np.isfinite(g) and g > config.min_gain_to_split:
            if config.max_depth > 0 and depth >= config.max_depth:
                return
            heapq.heappush(heap, (-g, tiebreak, (node_id, depth, hist, sums,
                                                 f, t_local, b, lsum, rsum,
                                                 g)))
            tiebreak += 1

    push(0, 0, hist0, totals0_h)
    n_leaves = 1
    while heap and n_leaves < config.num_leaves:
        _, _, (nid, depth, hist, sums, f, t_local, b, lsum, rsum, g) = \
            heapq.heappop(heap)
        lid, rid = len(feature), len(feature) + 1
        thr = ds.bin_upper_value(f, t_local)
        feature[nid], threshold[nid], threshold_bin[nid] = f, thr, t_local
        # an absent entry (0.0) routes by the zero bin; the model's default
        # direction follows the threshold's value, as dense predict does
        default_left[nid] = bool(0.0 <= thr)
        left[nid], right[nid] = lid, rid
        gains[nid] = g
        value[nid] = 0.0
        for csum in (lsum, rsum):
            feature.append(-1)
            threshold.append(0.0)
            threshold_bin.append(0)
            default_left.append(True)
            left.append(-1)
            right.append(-1)
            value.append(leaf_value(csum))
            gains.append(0.0)
            counts.append(int(csum[2]))
            hweights.append(float(csum[1]))
        n_leaves += 1
        node_of_row = _route_rows(dev, node_of_row, nid, f, b, lid, rid,
                                  bool(ds.zero_local[f] <= t_local))
        small_id, big_id = (lid, rid) if lsum[2] <= rsum[2] else (rid, lid)
        small_sums = lsum if small_id == lid else rsum
        big_sums = rsum if small_id == lid else lsum
        small_hist = node_hist(
            ones & (node_of_row == small_id),
            torch.as_tensor(small_sums, dtype=torch.float32, device=device))
        big_hist = hist - small_hist
        del hist
        for cid, chist, csums in ((small_id, small_hist, small_sums),
                                  (big_id, big_hist, big_sums)):
            if csums[2] >= 2 * mdl:
                push(cid, depth + 1, chist, csums)

    _LOG.debug("per-split sparse tree: %d splits, %d host reads",
               n_leaves - 1, host_reads - reads0)
    tree = Tree(
        feature=np.asarray(feature, dtype=np.int32),
        threshold=np.asarray(threshold, dtype=np.float64),
        threshold_bin=np.asarray(threshold_bin, dtype=np.int32),
        default_left=np.asarray(default_left, dtype=bool),
        left=np.asarray(left, dtype=np.int32),
        right=np.asarray(right, dtype=np.int32),
        value=np.asarray(value, dtype=np.float64),
        gain=np.asarray(gains, dtype=np.float32),
        count=np.asarray(counts, dtype=np.int32),
        weight=np.asarray(hweights, dtype=np.float64),
    )
    return tree, node_of_row


def grow_tree_sparse(ds: SparseDataset, dev: Dict, grad: torch.Tensor,
                     hess: torch.Tensor, config: GrowerConfig,
                     row_mask: Optional[torch.Tensor] = None,
                     bin_mask: Optional[torch.Tensor] = None,
                     use_fused: Optional[bool] = None
                     ) -> Tuple[Tree, torch.Tensor]:
    """Grow one tree over the flat sparse bins; returns (tree, node_of_row)
    with ``node_of_row`` the device tensor of every row's final node.

    Routes as the reference decides (``use_fused`` None): the fused grower
    (``_grow_tree_sparse_body``, one host read of the finished tree) on the
    card under the state gate (``_fused_sparse_enabled``), the per-split
    host loop (``_grow_tree_sparse_host``) on the CPU or above the gate.
    Both route rows and grow best-first; they differ in the pop order among
    equal gains and in how a node's default direction is taken.

    ``row_mask``: [N] bool (bagging subset: histograms and totals are
    masked, routing covers every row). ``bin_mask``: [TB] bool of allowed
    split bins (feature fraction mapped to the flat space)."""
    if use_fused is None:
        use_fused = (_fused_sparse_enabled(2 * config.num_leaves - 1,
                                           ds.total_bins)
                     and grad.device.type != "cpu")
    if not use_fused:
        return _grow_tree_sparse_host(ds, dev, grad, hess, config, row_mask,
                                      bin_mask)
    if row_mask is None:
        row_mask = torch.ones(ds.num_rows, dtype=torch.bool,
                              device=grad.device)
    return _read_sparse_tree(*_fused_sparse_tables(dev, grad, hess, row_mask,
                                                   config, bin_mask),
                             config, ds.thresholds)


# ---------------------------------------------------------------------------
# The whole-run scan: every sparse boosting iteration with no host read
# ---------------------------------------------------------------------------


def _scan_sparse_ok(params, valid, log, device: DeviceLike = None) -> bool:
    """May this sparse fit take the whole-run scan? The reference's gate:
    not dart, lambdarank, a validation set, a log or a training metric, nor
    a single leaf; on the CPU only under ``MMLSPARK_TPU_SCAN_TRAIN=1``;
    never under ``MMLSPARK_TPU_NO_SCAN_TRAIN=1``."""
    if _env_on("MMLSPARK_TPU_NO_SCAN_TRAIN"):
        return False
    if params.boosting_type == "dart" or params.objective == "lambdarank":
        return False
    if valid is not None or log is not None or params.train_metric:
        return False
    if 2 * params.num_leaves - 1 < 3:
        return False
    if not _env_on("MMLSPARK_TPU_SCAN_TRAIN") \
            and resolve_device(device).type == "cpu":
        return False
    return True


def _sparse_compact_cap(params, ds: SparseDataset, row_masks,
                        device: DeviceLike = None) -> Tuple[int, int]:
    """The reference's static capacities ``(cap, sel_cap)`` of the scan's
    selected-row entry compaction, ``(0, 0)`` for none. ``cap`` bounds the
    selected rows' entries of every iteration (GOSS: the sum of the
    ``top_n + other_n`` largest row counts, since its selection is exact;
    bagging: the largest of the drawn masks'); ``sel_cap`` > 0 (the most
    rows selected) turns on lazy routing: each split routes only the
    selected rows, and ``_assign_leaves_all_rows`` routes every row once a
    tree.

    Off unless selection shrinks the stream on the card: the reference
    takes compaction only on its accelerator and at scale (nnz >= 2M, cap
    <= 0.75 nnz), the port on the card; lazy routing only when
    ``max_depth`` bounds the traversal and ``sel_frac * splits +
    max_depth < 0.9 * splits``. ``MMLSPARK_TPU_SPARSE_COMPACT=1`` forces
    it on past those rules, ``MMLSPARK_TPU_NO_SPARSE_COMPACT=1`` turns it
    off, ``MMLSPARK_TPU_NO_SPARSE_LAZY_ROUTE=1`` keeps compaction but
    routes every row at each split."""
    if _env_on("MMLSPARK_TPU_NO_SPARSE_COMPACT"):
        return 0, 0
    n = ds.num_rows
    nnz = int(ds.indptr[-1])
    row_nnz = np.diff(ds.indptr)
    if params.boosting_type == "goss":
        k_sel = int(n * params.top_rate) + int(n * params.other_rate)
        if k_sel <= 0 or k_sel >= n:
            return 0, 0
        cap = int(np.partition(row_nnz, n - k_sel)[n - k_sel:].sum())
    elif row_masks is not None:
        k_sel = int(row_masks.sum(axis=1).max())
        cap = int((row_masks.astype(np.int64) @ row_nnz.astype(np.int64))
                  .max())
    else:
        return 0, 0
    cap = max(cap, 1)
    sel_cap = max(int(k_sel), 1)
    if _env_on("MMLSPARK_TPU_NO_SPARSE_LAZY_ROUTE"):
        sel_cap = 0
    if _env_on("MMLSPARK_TPU_SPARSE_COMPACT"):
        return cap, sel_cap
    splits = max(params.num_leaves - 1, 1)
    if params.max_depth <= 0:
        sel_cap = 0
    elif sel_cap / max(n, 1) * splits + params.max_depth >= 0.9 * splits:
        sel_cap = 0
    if resolve_device(device).type != "cuda":
        return 0, 0
    if nnz < 2_000_000 or cap > int(0.75 * nnz):
        return 0, 0
    return cap, sel_cap


#: per thread: ``last_scan_stats``, the thread's last sparse scan's
#: selection, fetched after its loop (a reading aid): ``rows`` and
#: ``entries`` selected each iteration, the capacities
_scan_tls = threading.local()


def __getattr__(name: str):
    if name == "last_scan_stats":
        stats = getattr(_scan_tls, name, None)
        if stats is None:
            stats = _scan_tls.last_scan_stats = {}
        return stats
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _compact_stream(dev: Dict, row_mask: torch.Tensor, cap: int,
                    sel_cap: int) -> Tuple[Dict, Optional[torch.Tensor],
                                           Optional[torch.Tensor],
                                           torch.Tensor]:
    """The bin-sorted entry stream compacted to the selected rows' entries,
    with no host read: a ``cumsum`` over the entries' selection and a
    scatter of the selected entries to their ranks (the others to a trash
    slot past ``cap``); the order, and so each bin's run, is kept, and the
    bin ends become ``cnt0[bin_end]``, the last of them the selected
    entries' count on the device. Past it the stream holds zeros, which K4
    neither reads nor writes. With ``sel_cap`` (lazy routing) the rows are
    the selected rows too: their ids in ``sel_cap`` slots (zero past the
    count), the entries' row positions among them, and each one's CSR
    slice. Returns (the compacted view of ``dev``, the selected row ids,
    their validity, the selected entries' count)."""
    rbs = dev["row_of_nnz_bs"]
    i32, i64 = torch.int32, torch.int64
    esel = row_mask.index_select(0, rbs)
    cnt = torch.cumsum(esel.to(i32), 0, dtype=i32)
    idx = torch.where(esel, cnt.to(i64) - 1, cap)
    rows_cmp = torch.zeros(cap + 1, dtype=i32, device=rbs.device) \
        .scatter_(0, idx, rbs)[:cap]
    cnt0 = torch.cat([cnt.new_zeros(1), cnt])
    bend = cnt0.index_select(0, dev["bin_end"].to(i64)).contiguous()
    if not sel_cap:
        return dict(dev, row_of_nnz_bs=rows_cmp, bin_end=bend), None, None, \
            cnt0[-1]
    cnt_rows = torch.cumsum(row_mask.to(i32), 0, dtype=i32)
    rank = cnt_rows.to(i64) - 1
    n = row_mask.shape[0]
    slot = torch.where(row_mask, rank, sel_cap)
    sel_rows = torch.zeros(sel_cap + 1, dtype=i64, device=rbs.device) \
        .scatter_(0, slot, torch.arange(n, device=rbs.device))[:sel_cap]
    sel_valid = torch.arange(sel_cap, device=rbs.device) < cnt_rows[-1]
    selpos = torch.clamp(rank.index_select(0, rows_cmp.to(i64)), min=0)
    ip = dev["indptr"]
    view = dict(dev, row_of_nnz_bs=selpos.to(i32), bin_end=bend,
                route_lo=ip.index_select(0, sel_rows),
                route_hi=ip.index_select(0, sel_rows + 1))
    return view, sel_rows, sel_valid, cnt0[-1]


def _train_scan_sparse(params, config: GrowerConfig, booster: Booster,
                       ds: SparseDataset, dev: Dict, labels: torch.Tensor,
                       w_dev: Optional[torch.Tensor], scores: np.ndarray,
                       k: int, lr: float, row_masks, feat_masks,
                       compact_cap: int = 0, sel_cap: int = 0) -> float:
    """Every sparse boosting iteration with no host read, the trees fetched
    once (the reference's ``_train_scan_sparse``). Returns the loop's
    seconds.

    An iteration computes grad/hess from the running scores, takes its
    bagging and feature masks from device-resident [iters, N] / [iters, F]
    tensors by a device index (the feature mask mapped to bins through
    ``feat_of_bin``), selects GOSS's rows on the device as the dense scan
    does (exact top-k by |g| and by the reference's Threefry draws over the
    ``n`` rows), grows each class's tree with ``_grow_tree_sparse_body``
    and adds device-f32 leaf values into a Kahan-compensated f32 score.
    With ``compact_cap`` the stream is first compacted to the selected
    rows' entries (``_compact_stream``), and with ``sel_cap`` too the tree
    grows over the selected rows alone and ``_assign_leaves_all_rows``
    routes every row once. The saved trees' leaf values are recomputed on
    the host in f64 from the fetched sums.

    On the card iteration 0 runs eagerly (it builds and warms every
    kernel), the iteration is then captured once in a CUDA graph and
    replayed for the rest; on the CPU every iteration runs eagerly."""
    from ..core import threefry
    from .booster import (_add_leaf_values, _scan_goss, _scan_leaf_values,
                          _scan_loop_guard)

    device = labels.device
    n = ds.num_rows
    iters = params.num_iterations
    M = 2 * config.num_leaves - 1
    rm_all = (torch.as_tensor(row_masks, device=device)
              if row_masks is not None else None)
    fm_all = (torch.as_tensor(feat_masks, device=device)
              if feat_masks is not None else None)
    ones = torch.ones(n, dtype=torch.bool, device=device)
    is_goss = params.boosting_type == "goss"
    if is_goss:
        top_n = int(n * params.top_rate)
        other_n = int(n * params.other_rate)
        goss_amp = float(np.float32((1.0 - params.top_rate)
                                    / max(params.other_rate, 1e-12)))
        goss_keys = threefry.split(threefry.prng_key(
            params.seed or params.bagging_seed, device), iters)
    lazy = bool(compact_cap and sel_cap)
    depth_steps = (config.max_depth if config.max_depth > 0
                   else config.num_leaves - 1)
    shrink = float(np.float32(lr))
    score = torch.as_tensor(scores[:, 0] if k == 1 else scores,
                            dtype=torch.float32, device=device)
    comp = torch.zeros_like(score)
    it_idx = torch.zeros(1, dtype=torch.int64, device=device)
    stacked = torch.zeros(iters, k, M, 11, dtype=torch.float64,
                          device=device)
    selected = torch.zeros(iters, 2, dtype=torch.int64, device=device)

    def step():
        g, h = grad_hess(params.objective, score, labels, w_dev, params.alpha)
        row_mask = (rm_all.index_select(0, it_idx)[0] if rm_all is not None
                    else ones)
        bin_mask = (fm_all.index_select(0, it_idx)[0].index_select(
            0, dev["feat_of_bin"]) if fm_all is not None else None)
        if is_goss:
            row_mask, g, h = _scan_goss(
                g, h, goss_keys.index_select(0, it_idx)[0], top_n, other_n,
                goss_amp)
        devc, sel_rows, sel_valid = dev, None, None
        entries = torch.zeros((), dtype=torch.int64, device=device)
        if compact_cap:
            devc, sel_rows, sel_valid, entries = _compact_stream(
                dev, row_mask, compact_cap, sel_cap if lazy else 0)
        new_s, new_c = score, comp
        tables = []
        for kk in range(k):
            gk = (g if k == 1 else g[:, kk]).contiguous()
            hk = (h if k == 1 else h[:, kk]).contiguous()
            root_tot = _masked_totals(gk, hk, row_mask)
            if lazy:
                out = _grow_tree_sparse_body(
                    devc, gk.index_select(0, sel_rows),
                    hk.index_select(0, sel_rows), sel_valid, None, root_tot,
                    config, bin_mask)
                rows = _assign_leaves_all_rows(dev, out, depth_steps)
            else:
                out = _grow_tree_sparse_body(devc, gk, hk, row_mask, None,
                                             root_tot, config, bin_mask)
                rows = out["node_of_row"]
            new_s, new_c = _add_leaf_values(
                new_s, new_c, _scan_leaf_values(out, config) * shrink, rows,
                kk if k > 1 else None)
            tables.append(pack_sparse_tables(out))
        stacked.index_copy_(0, it_idx, torch.stack(tables)[None])
        selected.index_copy_(0, it_idx, torch.stack(
            [row_mask.sum(), entries.to(torch.int64)])[None])
        score.copy_(new_s)
        comp.copy_(new_c)
        it_idx.add_(1)

    t0 = time.perf_counter()
    capture = device.type == "cuda" and iters > 1
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
    sel = selected.cpu().numpy()
    _scan_tls.last_scan_stats = dict(
        rows=sel[:, 0], entries=sel[:, 1], compact_cap=compact_cap,
        sel_cap=sel_cap, lazy=lazy)
    for it in range(iters):
        group = []
        for kk in range(k):
            tree = tree_from_sparse_packed(host[it, kk], config,
                                           ds.thresholds)
            tree.shrinkage = lr
            group.append(tree)
        booster.trees.append(group)
    return loop_s


# ---------------------------------------------------------------------------
# Boosting
# ---------------------------------------------------------------------------


@device_work
def train_sparse(params, ds: SparseDataset, y: np.ndarray,
                 weights: Optional[np.ndarray] = None,
                 groups: Optional[np.ndarray] = None,
                 valid: Optional[Tuple] = None,
                 valid_groups: Optional[np.ndarray] = None,
                 init_scores: Optional[np.ndarray] = None,
                 init_model=None, log=None, mesh=None,
                 device: DeviceLike = None) -> Booster:
    """Boosting over a SparseDataset; returns an ordinary Booster (no bin
    mapper: the trees carry raw thresholds). The reference's
    host-orchestrated loop: scores stay exact f64 on the host and go to the
    device as f32 each iteration; every boosting type (DART drops and
    re-adds trees through ``predict_csr``), lambdarank ``groups``, weights,
    init scores and continued training from an in-memory ``init_model``;
    bagging, feature fraction, GOSS's sample and DART's drops draw from
    ``np.random.default_rng(seed or bagging_seed)`` in the reference's
    order. ``valid``: an optional ((indptr, indices, values), y) CSR holdout
    scored after every iteration (``valid_groups`` its query ids), with
    early stopping after ``early_stopping_round`` iterations without
    improvement. Runs on ``device`` (default: CUDA, or the device
    ``runtime.use_device`` asked for).

    The fit takes one of three routes, as the reference decides them, and
    records it on the Booster (``Booster.route``) and in the obs
    ``TrainRecorder`` (engine ``gbdt_sparse``):

      - ``scan`` (``_scan_sparse_ok``, ``_train_scan_sparse``): every
        iteration with no host read, one CUDA graph replay an iteration on
        the card; the default there for gbdt, rf and goss without
        validation, a log or a training metric, under the state gate;
        ``MMLSPARK_TPU_SCAN_TRAIN=1`` forces it on the CPU. It records no
        per-iteration step: nothing times an iteration inside its loop;
      - ``fused``: the per-iteration loop over the fused grower
        (``SparseFusedGrower``: one read a tree, a CUDA graph a tree on the
        card), under the state gate on any device (the reference's
        ``train_sparse`` passes the gate alone);
      - ``host``: the same loop over the per-split host loop, above the
        gate (``MMLSPARK_TPU_FUSED_TREE_BYTES`` moves it,
        ``MMLSPARK_TPU_NO_FUSED_TREE=1`` forces this route).

    The loop routes record each iteration's wall time.

    ``mesh``: a ``parallel.mesh.Mesh``; every process calls with the same
    inputs, keeps its nnz-balanced row block (``shard_bounds``) and grows
    the row-sharded fused tree (route ``fused``, never the scan), as the
    reference's ``train_sparse(mesh=)`` does; the loop's state is per block,
    GOSS ranks the gathered gradients, the draws cover every row. The
    blocks follow the data axis alone (the replicas along the other axes
    hold the same block); LambdaRank's queries that straddle a block edge
    are gathered and computed whole (``booster.ShardQueries``)."""
    if params.categorical_feature:
        raise ValueError(
            "categorical_feature is not supported on the sparse path "
            "(set splits need the dense bin space; sparse features are "
            "numeric TF counts) — densify for categorical slots")
    shards = mesh_shards(mesh)
    dev_t = resolve_device(device if device is not None or mesh is None
                           else mesh.device)
    k = max(params.num_class, 1)
    n = ds.num_rows
    tree_mesh, sizes = None, None
    blk = slice(0, n)
    if mesh is not None:
        # this process's nnz-balanced block: its tensors and loop state
        bounds = shard_bounds(ds, shards)
        sizes = np.diff(bounds)
        me = data_index(mesh)
        blk = slice(int(bounds[me]), int(bounds[me + 1]))
        ds = ds.rows(blk.start, blk.stop)
        tree_mesh = mesh
    n_loc = ds.num_rows
    dev = device_arrays(ds, dev_t)
    labels = torch.as_tensor(y[blk], dtype=torch.float32, device=dev_t)
    w_dev = (torch.as_tensor(weights[blk], dtype=torch.float32, device=dev_t)
             if weights is not None else None)
    group_seg = queries = None
    if groups is not None and params.objective == "lambdarank":
        if mesh is not None:
            queries = ShardQueries(groups, y, bounds, me, dev_t)
        else:
            group_seg = segment_groups(groups, dev_t)
    rng = np.random.default_rng(params.seed or params.bagging_seed)
    train_rows = None      # CsrRows of the training set, staged on first use

    def _train_rows() -> CsrRows:
        nonlocal train_rows
        if train_rows is None:
            train_rows = CsrRows(ds.indptr, ds.indices, ds.values, dev_t)
        return train_rows

    if init_scores is not None:
        base = np.zeros(k, dtype=np.float64)
        scores = np.broadcast_to(
            np.asarray(init_scores, dtype=np.float64).reshape(n, -1)[blk],
            (n_loc, k)).copy()
    else:
        base = init_score(params.objective, np.asarray(y, dtype=np.float64),
                          k, alpha=params.alpha)
        scores = np.tile(base, (n_loc, 1)).astype(np.float64)
    booster = Booster(params, None, base_score=base)
    if init_model is not None:
        booster.trees = [list(g) for g in init_model.trees]
        booster.base_score = init_model.base_score
        base = booster.base_score
        if init_model.trees:
            scores = (np.tile(base, (n_loc, 1))
                      + _train_rows().predict(init_model.trees, k))
    config = GrowerConfig(
        num_leaves=params.num_leaves, max_depth=params.max_depth,
        min_data_in_leaf=params.min_data_in_leaf,
        min_sum_hessian_in_leaf=params.min_sum_hessian_in_leaf,
        min_gain_to_split=params.min_gain_to_split,
        lambda_l1=params.lambda_l1, lambda_l2=params.lambda_l2,
        max_delta_step=params.max_delta_step)
    is_rf = params.boosting_type == "rf"
    is_dart = params.boosting_type == "dart"
    is_goss = params.boosting_type == "goss"
    lr = 1.0 if is_rf else params.learning_rate

    from ..obs.metrics import TrainRecorder

    recorder = TrainRecorder("gbdt_sparse")
    max_nodes = 2 * config.num_leaves - 1
    # a sharded fit grows the fused tree whatever the gate, as the
    # reference's does
    use_fused = mesh is not None or _fused_sparse_enabled(max_nodes,
                                                          ds.total_bins)
    if mesh is None and use_fused and _scan_sparse_ok(params, valid, log,
                                                      dev_t):
        row_masks, feat_masks, ok = _scan_precompute_masks(
            params, rng, n, ds.num_features, np.asarray(y), is_rf)
        if ok:
            ccap, scap = _sparse_compact_cap(params, ds, row_masks, dev_t)
            recorder.route("scan")
            _train_scan_sparse(params, config, booster, ds, dev, labels,
                               w_dev, scores, k, lr, row_masks, feat_masks,
                               compact_cap=ccap, sel_cap=scap)
            if is_rf:
                rf_average(booster)
            booster.route = "scan"
            return booster

    grower = (SparseFusedGrower(ds, dev, config, tree_mesh) if use_fused
              else None)
    booster.route = "fused" if use_fused else "host"
    recorder.route(booster.route)
    metric = params.metric or default_metric(params.objective)
    stopper = EarlyStopping(metric, params.early_stopping_round)
    val_rows = val_y = val_scores = None
    if valid is not None:
        val_csr, val_y = valid
        val_rows = CsrRows(*val_csr, device=dev_t)
        val_scores = np.tile(base, (val_rows.n, 1)).astype(np.float64)
        if init_model is not None and init_model.trees:
            val_scores += val_rows.predict(init_model.trees, k)

    bag_mask = np.ones(n, dtype=bool)
    try:
        for it in range(params.num_iterations):
            it_t0 = time.perf_counter()
            dropped: List[int] = []
            if is_dart and booster.trees:
                dropped = dart_drops(params, rng, len(booster.trees))
                for di in dropped:
                    scores -= _train_rows().predict([booster.trees[di]], k)
                    if val_rows is not None:
                        # keep the holdout scores in lockstep (the dropped
                        # trees are rescaled below)
                        val_scores -= val_rows.predict([booster.trees[di]], k)

            score_dev = torch.as_tensor(scores[:, 0] if k == 1 else scores,
                                        dtype=torch.float32, device=dev_t)
            if queries is not None:
                g, h = queries.grad_hess(score_dev, tree_mesh)
            else:
                g, h = grad_hess(params.objective, score_dev, labels, w_dev,
                                 params.alpha, groups,
                                 group_segments=group_seg)

            row_mask = bag_mask
            if is_goss:
                # ranked over every row's gradients (gathered under a mesh)
                row_mask, amp = goss_sample(all_gather(g, tree_mesh, sizes),
                                            n, n, params, rng)
                amp = amp[blk]
                if g.dim() == 2:
                    amp = amp[:, None]
                g, h = g * amp, h * amp
            else:
                drawn = bagging_draw(params, rng, n, y, it, is_rf)
                if drawn is not None:
                    bag_mask = row_mask = drawn

            bin_mask = None
            fm = feature_draw(params, rng, ds.num_features)
            if fm is not None:
                bin_mask = torch.as_tensor(fm, device=dev_t).index_select(
                    0, dev["feat_of_bin"])

            mask_dev = torch.as_tensor(row_mask[blk], device=dev_t)
            # dart's scale
            shrink = lr / (len(dropped) + lr) if dropped else lr
            group: List[Tree] = []
            for kk in range(k):
                gk = g if g.dim() == 1 else g[:, kk].contiguous()
                hk = h if h.dim() == 1 else h[:, kk].contiguous()
                if grower is not None:
                    tree, leaf_of_row = grower.grow(gk, hk, mask_dev, bin_mask)
                else:
                    tree, leaf_of_row = _grow_tree_sparse_host(
                        ds, dev, gk, hk, config, mask_dev, bin_mask)
                tree.shrinkage = shrink
                group.append(tree)
                scores[:, kk] += \
                    tree.value[leaf_of_row.cpu().numpy()] * shrink
            if dropped:
                factor = len(dropped) / (len(dropped) + lr)
                for di in dropped:
                    for kk in range(k):
                        booster.trees[di][kk].shrinkage *= factor
                    scores += _train_rows().predict([booster.trees[di]], k)
                    if val_rows is not None:
                        val_scores += val_rows.predict([booster.trees[di]], k)
            booster.trees.append(group)

            # eval + early stopping on the CSR holdout
            if val_rows is not None:
                val_scores += val_rows.predict([group], k)
                vs = val_scores[:, 0] if k == 1 else val_scores
                m = eval_metric(metric, vs,
                                np.asarray(val_y, dtype=np.float64),
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
                    recorder.step(time.perf_counter() - it_t0, examples=n)
                    break
            elif log and (it + 1) % 10 == 0:
                sc = fetch_global(torch.from_numpy(scores), tree_mesh, sizes)
                sc = sc[:, 0] if k == 1 else sc
                m = eval_metric(metric, sc, np.asarray(y, dtype=np.float64),
                                groups)
                recorder.metric(f"train_{metric}", m)
                log(f"[{it + 1}] train {metric}={m:.6f}")
            recorder.step(time.perf_counter() - it_t0, examples=n)
    finally:
        if grower is not None:
            grower.release()
    if is_rf:
        rf_average(booster)
    return booster


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------


def _flatten_forest(tree_groups):
    """Concatenated node arrays and per-tree offsets for the C++ CSR
    traversal (the reference's layout)."""
    feats, thrs, lefts, rights, vals_ = [], [], [], [], []
    offs, shr, cls = [0], [], []
    for group in tree_groups:
        for kcls, tree in enumerate(group):
            feats.append(np.asarray(tree.feature, dtype=np.int32))
            thrs.append(np.asarray(tree.threshold, dtype=np.float64))
            lefts.append(np.asarray(tree.left, dtype=np.int32))
            rights.append(np.asarray(tree.right, dtype=np.int32))
            vals_.append(np.asarray(tree.value, dtype=np.float64))
            offs.append(offs[-1] + len(tree.feature))
            shr.append(float(tree.shrinkage))
            cls.append(kcls)
    return (np.concatenate(feats), np.concatenate(thrs),
            np.concatenate(lefts), np.concatenate(rights),
            np.concatenate(vals_), np.asarray(offs, dtype=np.int64),
            np.asarray(shr, dtype=np.float64), np.asarray(cls, dtype=np.int32))


def _predict_csr_native(tree_groups, indptr, indices, values, n: int,
                        num_class: int):
    """The forest over CSR rows through the C++ traversal
    (``native_loader.csr_forest_predict``); None when the library is
    unavailable, so the caller keeps its own path."""
    from .. import native_loader

    if not any(len(g) for g in tree_groups):
        return np.zeros((n, num_class), dtype=np.float64)
    return native_loader.csr_forest_predict(
        indptr, indices, values, *_flatten_forest(tree_groups), num_class)


def predict_csr(tree_groups: List[List[Tree]], indptr, indices, values,
                num_class: int, device: DeviceLike = None) -> np.ndarray:
    """[CSR rows] -> [N, num_class] f64 raw score deltas (the reference's
    numpy ``predict_csr`` on f64 tensors on ``device``, default
    ``default_device()``).

    On the CPU a numeric forest takes the reference's native route, the
    C++ traversal bit-equal to the tensor one
    (``MMLSPARK_TPU_NO_NATIVE_CSR_PREDICT=1`` turns it off, as in the
    reference); on the card the traversal stays on the device."""
    import os

    from .. import native_loader

    dev = resolve_device(device) if device is not None else default_device()
    if (dev.type == "cpu"
            and os.environ.get("MMLSPARK_TPU_NO_NATIVE_CSR_PREDICT",
                               "") in ("", "0")
            and not any(t.cat_sets is not None
                        for g in tree_groups for t in g)):
        indptr = np.asarray(indptr, dtype=np.int64)
        out = _predict_csr_native(tree_groups, indptr, indices, values,
                                  len(indptr) - 1, num_class)
        if out is not None:
            native_loader.count("csr_forest_predict", "native")
            return out
        native_loader.count("csr_forest_predict", "numpy")
    return CsrRows(indptr, indices, values, dev).predict(tree_groups,
                                                        num_class)


class CsrRows:
    """CSR rows staged on a device once, for repeated traversals (DART's
    drops and the validation scores score the same rows every iteration).

    Each tree is walked for its depth in steps over all rows; a row's value
    of the split feature is found by ONE global ``searchsorted`` over the
    composite int64 key ``row * width + feature`` (CSR rows are sorted, so
    the keys ascend), absent -> 0.0. Contributions add in f64 in tree order,
    as the reference's."""

    def __init__(self, indptr, indices, values, device: DeviceLike = None):
        dev = resolve_device(device) if device is not None \
            else default_device()
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64)
        n = len(indptr) - 1
        width = int(indices.max()) + 2 if len(indices) else 1
        row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        self.n, self.width, self.device = n, width, dev
        self.key = torch.as_tensor(row_of * width + indices, device=dev)
        self.vals = torch.as_tensor(np.asarray(values, dtype=np.float64),
                                    device=dev)
        self.rows = torch.arange(n, dtype=torch.int64, device=dev)

    def _lookup(self, feats: torch.Tensor) -> torch.Tensor:
        if self.key.shape[0] == 0:
            return torch.zeros(self.n, dtype=torch.float64,
                               device=self.device)
        q = self.rows * self.width + torch.clamp(feats, 0, self.width - 1)
        pos = torch.clamp(torch.searchsorted(self.key, q),
                          max=self.key.shape[0] - 1)
        hit = (feats < self.width) & (self.key[pos] == q)
        return torch.where(hit, self.vals[pos], 0.0)

    def predict(self, tree_groups: List[List[Tree]],
                num_class: int) -> np.ndarray:
        """[N, num_class] f64 raw score deltas of ``tree_groups``."""
        for group in tree_groups:
            for tree in group:
                if tree.cat_sets is not None:
                    raise ValueError(
                        "categorical set splits cannot be evaluated on "
                        "sparse CSR rows (sparse features are numeric); "
                        "densify for categorical models")
        dev = self.device
        out = torch.zeros(self.n, num_class, dtype=torch.float64, device=dev)
        for group in tree_groups:
            for kcls, tree in enumerate(group):
                feat = torch.as_tensor(tree.feature, dtype=torch.int64,
                                       device=dev)
                thr = torch.as_tensor(tree.threshold, dtype=torch.float64,
                                      device=dev)
                lft = torch.as_tensor(tree.left, dtype=torch.int64, device=dev)
                rgt = torch.as_tensor(tree.right, dtype=torch.int64,
                                      device=dev)
                node = torch.zeros(self.n, dtype=torch.int64, device=dev)
                for _ in range(_tree_depth(tree) - 1):
                    f = feat[node]
                    x = self._lookup(f)
                    nxt = torch.where(x <= thr[node], lft[node], rgt[node])
                    node = torch.where(f >= 0, nxt, node)
                val = torch.as_tensor(tree.value, dtype=torch.float64,
                                      device=dev)
                out[:, kcls] += val[node] * tree.shrinkage
        return out.cpu().numpy()
