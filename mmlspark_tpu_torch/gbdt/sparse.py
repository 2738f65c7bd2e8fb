"""Sparse (CSR) feature path through the GBDT engine, in PyTorch.

Counterpart of the reference's ``mmlspark_tpu/gbdt/sparse.py`` on its
host-orchestrated path: the reference trains on sparse rows the way
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
  - ``grow_tree_sparse``: the reference's fused whole-tree grower
    (``_grow_tree_sparse_body``) as a Python loop over device tensors, with
    one host read per split; node ids in split order.
  - ``train_sparse``: the reference's host-orchestrated boosting loop for
    every boosting type (gbdt, rf, dart, goss), bagging, feature fraction,
    weights, init scores, every objective (lambdarank included), a CSR
    validation set with early stopping, and an in-memory ``init_model``.
  - ``predict_csr`` / ``CsrRows``: depth-stepped traversal, each row
    resolving the split feature through its own CSR row (absent -> 0.0), in
    f64 on the device; ``CsrRows`` stages the rows once for the loop's
    repeated scoring (DART's drops, the validation set).

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

Not ported yet (ROADMAP A6): the whole-run scan (``_train_scan_sparse``,
with selected-row compaction, exact top-k GOSS and the lazy full-row
traversal), the sharded grower, the per-split host loop the reference runs
above the 2 GiB state gate, and the native C++ CSR predict.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.batching import sparse_width
from ..runtime import DeviceLike, default_device, resolve_device
from .booster import (Booster, EarlyStopping, bagging_draw, dart_drops,
                      default_metric, eval_metric, feature_draw, goss_sample,
                      grad_hess, init_score, rf_average, segment_groups)
from .histogram import _f32, _leaf_objective, xla_cumsum
from .predict import _tree_depth
from .sparse_hist_kernel import sparse_histogram
from .tree import GrowerConfig, Tree

_MAX_SPARSE_BIN = 64  # per-feature cap: count/tf features have few levels


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
                    node_mask_rows: torch.Tensor) -> torch.Tensor:
    """Nonzero-entry histogram [3, TB] over the node's rows: one [nnz] row
    mask gather, the masked [3, nnz] stack, and K4 (channel-major, as the
    reference's)."""
    m = node_mask_rows.index_select(0, dev["row_of_nnz_bs"]).to(torch.float32)
    data = torch.stack([g_bs * m, h_bs * m, m])
    return sparse_histogram(data, dev["bin_end"])


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
                        f: int) -> torch.Tensor:
    """Vectorized lower-bound search for each row's entry of feature ``f``
    inside the row's feature-sorted CSR slice [lo, hi): ``route_steps``
    gather steps (each row's slice is at most max-row-nnz wide)."""
    feats = dev["feat_of_nnz"]
    last = max(feats.shape[0] - 1, 0)
    for _ in range(dev["route_steps"]):
        cont = lo < hi
        mid = (lo + hi) >> 1
        go_hi = feats.index_select(0, torch.clamp(mid, 0, last)) < f
        lo = torch.where(cont & go_hi, mid + 1, lo)
        hi = torch.where(cont & ~go_hi, mid, hi)
    return lo


def _route_rows(dev: Dict, node_of_row: torch.Tensor, node_id: int, f: int,
                b: int, lid: int, rid: int, zero_goes_left: bool
                ) -> torch.Tensor:
    """Send the node's rows left iff their value's flat bin <= ``b`` (a bin
    of feature ``f``); rows without an entry of ``f`` carry the feature's
    zero bin (``zero_goes_left``)."""
    in_node = node_of_row == node_id
    out = torch.where(in_node, lid if zero_goes_left else rid, node_of_row)
    feats = dev["feat_of_nnz"]
    if feats.shape[0] == 0:
        return out
    indptr = dev["indptr"]
    hi0 = indptr[1:]
    lo = _row_feature_search(dev, indptr[:-1], hi0, f)
    pos = torch.clamp(lo, 0, feats.shape[0] - 1)
    has = (lo < hi0) & (feats.index_select(0, pos) == f)
    target = torch.where(dev["bin_of_nnz"].index_select(0, pos) <= b, lid, rid)
    return torch.where(in_node & has, target.to(node_of_row.dtype), out)


# ---------------------------------------------------------------------------
# Whole-tree growth
# ---------------------------------------------------------------------------

# Per-node flat-histogram state cap: [2L-1, total_bins, 3] f32. Above it the
# reference runs a per-split host loop, which is not ported.
_FUSED_SPARSE_BUDGET = 2 << 30


def _fused_sparse_enabled(max_nodes: int, total_bins: int) -> bool:
    return max_nodes * total_bins * 3 * 4 <= _FUSED_SPARSE_BUDGET


def _masked_totals(grad: torch.Tensor, hess: torch.Tensor,
                   row_mask: torch.Tensor) -> torch.Tensor:
    """[3] (sum grad, sum hess, count) over the masked rows, accumulated in
    f64 and rounded to f32 once (device-independent up to a rounding tie)."""
    m = row_mask.to(torch.float64)
    return torch.stack([torch.sum(grad.double() * m),
                        torch.sum(hess.double() * m), torch.sum(m)]).float()


def _tree_from_nodes(nn: int, feature, tbin, flat_bin, default_left, left,
                     right, gain, sums, config: GrowerConfig,
                     thresholds: np.ndarray) -> Tree:
    """Tree from the grower's node tables; leaf values recomputed in f64 on
    the host (the reference's ``_tree_from_fused_out``)."""
    feature = feature[:nn].astype(np.int32)
    s64 = sums[:nn].astype(np.float64)
    g_thr = np.sign(s64[:, 0]) * np.maximum(
        np.abs(s64[:, 0]) - config.lambda_l1, 0.0)
    value = np.where(feature < 0, -g_thr / (s64[:, 1] + config.lambda_l2),
                     0.0)
    if config.max_delta_step > 0:
        value = np.clip(value, -config.max_delta_step, config.max_delta_step)
    value[0] = 0.0 if nn == 1 else value[0]
    threshold = np.where(feature >= 0, thresholds[flat_bin[:nn]], 0.0)
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


def grow_tree_sparse(ds: SparseDataset, dev: Dict, grad: torch.Tensor,
                     hess: torch.Tensor, config: GrowerConfig,
                     row_mask: Optional[torch.Tensor] = None,
                     bin_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[Tree, torch.Tensor]:
    """Grow one tree over the flat sparse bins; returns (tree, node_of_row)
    with ``node_of_row`` the device tensor of every row's final node.

    The reference's fused grower (``_grow_tree_sparse_body``): best-first
    over per-node candidates (ties to the lowest node id), the smaller
    child's histogram built from its rows and the sibling's by subtraction.
    The node tables live on the host; each split costs one host read of the
    two children's packed candidates.

    ``row_mask``: [N] bool (bagging subset: histograms and totals are
    masked, routing covers every row). ``bin_mask``: [TB] bool of allowed
    split bins (feature fraction mapped to the flat space)."""
    M = 2 * config.num_leaves - 1
    tb = ds.total_bins
    if not _fused_sparse_enabled(M, tb):
        raise NotImplementedError(
            f"a {tb}-bin sparse tree of {config.num_leaves} leaves exceeds "
            f"the 2 GiB grower state; the reference's per-split host loop "
            f"for it is not ported yet (ROADMAP A6)")
    n = ds.num_rows
    device = grad.device
    if row_mask is None:
        row_mask = torch.ones(n, dtype=torch.bool, device=device)
    node_of_row = torch.zeros(n, dtype=torch.int32, device=device)
    l1, l2 = config.lambda_l1, config.lambda_l2
    msh, mdl = config.min_sum_hessian_in_leaf, config.min_data_in_leaf
    mgs = np.float32(config.min_gain_to_split)
    neg_inf = np.float32(-np.inf)

    g_bs, h_bs = _entry_gh(dev, grad, hess)

    def node_hist(mask_rows, totals):
        return _zero_completed(
            dev, _flat_histogram(dev, g_bs, h_bs, mask_rows), totals)

    def best(hists):
        return _find_best_split_flat(dev, hists, l1, l2, msh, mdl, bin_mask)

    feature = np.full(M, -1, np.int32)
    threshold_bin = np.zeros(M, np.int32)
    flat_bin = np.zeros(M, np.int64)
    default_left = np.ones(M, bool)
    left = np.full(M, -1, np.int32)
    right = np.full(M, -1, np.int32)
    gain = np.zeros(M, np.float32)
    sums = np.zeros((M, 3), np.float32)
    depth = np.zeros(M, np.int32)
    cand_gain = np.full(M, neg_inf, np.float32)
    cand = np.zeros((M, 8), np.float64)       # packed best split per node
    hists: List[Optional[torch.Tensor]] = [None] * M

    root_tot = _masked_totals(grad, hess, row_mask)
    if tb:
        hists[0] = node_hist(row_mask, root_tot)
        host = torch.cat([root_tot.double(), best(hists[0][None])[0]]) \
            .cpu().numpy()
        cand[0] = host[3:]
        g0 = np.float32(cand[0, 1])
        if np.isfinite(g0) and g0 > mgs:
            cand_gain[0] = g0
    else:
        host = root_tot.double().cpu().numpy()
    sums[0] = host[:3]
    n_nodes, n_leaves = 1, 1

    def push(nid: int, s: np.ndarray, csum: np.ndarray, dchild: int):
        g = np.float32(s[1])
        ok = bool(np.isfinite(g) and g > mgs and csum[2] >= 2 * mdl)
        if config.max_depth > 0:
            ok = ok and dchild < config.max_depth
        cand_gain[nid] = g if ok else neg_inf
        cand[nid] = s

    while n_leaves < config.num_leaves and cand_gain.max() > neg_inf:
        leaf = int(np.argmax(cand_gain))
        b = int(cand[leaf, 0])
        f = int(np.searchsorted(ds.feat_offset, b, side="right") - 1)
        t_local = b - int(ds.feat_offset[f])
        dl = bool(ds.zero_local[f] <= t_local)   # absent (0.0) routing
        lsum = cand[leaf, 2:5].astype(np.float32)
        rsum = cand[leaf, 5:8].astype(np.float32)
        lid, rid = n_nodes, n_nodes + 1
        dchild = int(depth[leaf]) + 1

        node_of_row = _route_rows(dev, node_of_row, leaf, f, b, lid, rid, dl)
        small_is_left = bool(lsum[2] <= rsum[2])
        small_id, big_id = (lid, rid) if small_is_left else (rid, lid)
        small_tot, big_tot = (lsum, rsum) if small_is_left else (rsum, lsum)
        small_hist = node_hist(row_mask & (node_of_row == small_id),
                               torch.as_tensor(small_tot, device=device))
        big_hist = hists[leaf] - small_hist
        hists[leaf] = None
        s_small, s_big = best(torch.stack([small_hist, big_hist])) \
            .cpu().numpy()
        push(small_id, s_small, small_tot, dchild)
        push(big_id, s_big, big_tot, dchild)

        feature[leaf], threshold_bin[leaf], flat_bin[leaf] = f, t_local, b
        default_left[leaf] = dl
        left[leaf], right[leaf] = lid, rid
        gain[leaf] = cand_gain[leaf]
        cand_gain[leaf] = neg_inf
        sums[lid], sums[rid] = lsum, rsum
        depth[lid] = depth[rid] = dchild
        hists[small_id], hists[big_id] = small_hist, big_hist
        n_nodes += 2
        n_leaves += 1

    tree = _tree_from_nodes(n_nodes, feature, threshold_bin, flat_bin,
                            default_left, left, right, gain, sums, config,
                            ds.thresholds)
    return tree, node_of_row


# ---------------------------------------------------------------------------
# Boosting
# ---------------------------------------------------------------------------


def _unsupported(mesh) -> None:
    """Raise for every option a later slice of the port owns."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded sparse training (ROADMAP A6, A9) is not ported yet")


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
    improvement. Each iteration's wall time goes to the ``TrainRecorder``
    series under engine ``gbdt_sparse``. Runs on ``device`` (default: CUDA,
    or the device ``runtime.use_device`` asked for)."""
    if params.categorical_feature:
        raise ValueError(
            "categorical_feature is not supported on the sparse path "
            "(set splits need the dense bin space; sparse features are "
            "numeric TF counts) — densify for categorical slots")
    _unsupported(mesh)
    dev_t = resolve_device(device)
    k = max(params.num_class, 1)
    n = ds.num_rows
    dev = device_arrays(ds, dev_t)
    labels = torch.as_tensor(y, dtype=torch.float32, device=dev_t)
    w_dev = (torch.as_tensor(weights, dtype=torch.float32, device=dev_t)
             if weights is not None else None)
    group_seg = (segment_groups(groups, dev_t)
                 if groups is not None and params.objective == "lambdarank"
                 else None)
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
            np.asarray(init_scores, dtype=np.float64).reshape(n, -1),
            (n, k)).copy()
    else:
        base = init_score(params.objective, np.asarray(y, dtype=np.float64),
                          k, alpha=params.alpha)
        scores = np.tile(base, (n, 1)).astype(np.float64)
    booster = Booster(params, None, base_score=base)
    if init_model is not None:
        booster.trees = [list(g) for g in init_model.trees]
        booster.base_score = init_model.base_score
        base = booster.base_score
        if init_model.trees:
            scores = (np.tile(base, (n, 1))
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
    metric = params.metric or default_metric(params.objective)
    stopper = EarlyStopping(metric, params.early_stopping_round)
    val_rows = val_y = val_scores = None
    if valid is not None:
        val_csr, val_y = valid
        val_rows = CsrRows(*val_csr, device=dev_t)
        val_scores = np.tile(base, (val_rows.n, 1)).astype(np.float64)
        if init_model is not None and init_model.trees:
            val_scores += val_rows.predict(init_model.trees, k)

    from ..obs.metrics import TrainRecorder

    recorder = TrainRecorder("gbdt_sparse")
    bag_mask = np.ones(n, dtype=bool)
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
        g, h = grad_hess(params.objective, score_dev, labels, w_dev,
                         params.alpha, groups, group_segments=group_seg)

        row_mask = bag_mask
        if is_goss:
            row_mask, amp = goss_sample(g, n, n, params, rng)
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

        mask_dev = torch.as_tensor(row_mask, device=dev_t)
        shrink = lr / (len(dropped) + lr) if dropped else lr  # dart's scale
        group: List[Tree] = []
        for kk in range(k):
            gk = g if g.dim() == 1 else g[:, kk].contiguous()
            hk = h if h.dim() == 1 else h[:, kk].contiguous()
            tree, leaf_of_row = grow_tree_sparse(ds, dev, gk, hk, config,
                                                 row_mask=mask_dev,
                                                 bin_mask=bin_mask)
            tree.shrinkage = shrink
            group.append(tree)
            scores[:, kk] += tree.value[leaf_of_row.cpu().numpy()] * shrink
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
            m = eval_metric(metric, vs, np.asarray(val_y, dtype=np.float64),
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
            sc = scores[:, 0] if k == 1 else scores
            m = eval_metric(metric, sc, np.asarray(y, dtype=np.float64),
                            groups)
            recorder.metric(f"train_{metric}", m)
            log(f"[{it + 1}] train {metric}={m:.6f}")
        recorder.step(time.perf_counter() - it_t0, examples=n)

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
