"""Histogram accumulation and split finding — the GBDT hot path, in PyTorch.

Counterpart of the reference's ``mmlspark_tpu/gbdt/histogram.py``:

  - ``compute_histogram``: masked (grad, hess, count) sums into [F, B, 3].
    A CUDA tensor goes to the hand-written kernel K1 (``hist_kernel.py``),
    a CPU tensor to its plain ``index_add_`` version.
  - ``find_best_split`` / ``find_best_split_pair``: the vectorized gain scan
    over every (feature, bin) candidate with L1/L2 regularization,
    min-data / min-hessian constraints and the learned missing-value
    direction; one argmax, ties to the first index like ``jnp.argmax``.
  - ``cat_best_subset``: categorical SET splits (LightGBM's num_cat
    machinery): a categorical feature's bins sorted by G/(H + cat_smooth),
    the best prefix of that order goes left; the winning split's bin bitset
    rides ``SplitInfo.cat_words`` (int64 words holding the reference's u32
    bits: torch has little ``uint32`` arithmetic).
  - ``subtract_histogram``, ``total_sums``, ``partition_rows``,
    ``partition_rows_cat``.
  - ``shard_reduce``, ``reduced_histogram``, ``total_sums_sharded``: a
    row-sharded fit's sums (the reference's ``psum`` under ``shard_map``,
    ``pallas_hist.compute_histogram_sharded``): each process
    sums its rows in f64, the f64 sums are added across processes
    (``parallel.mesh.all_reduce_sum``) and rounded to f32 once, so every
    process holds the histogram one process builds over all the rows (up to
    a double-rounding tie) and takes the same split.

Gains stay in f32, as on the reference's device. The cumulative sums over
bins follow the order XLA's CPU ``cumsum`` uses (sequential within blocks
of 16, block totals scanned the same way, then added), so on the same
histogram the port computes bit-identical gains to the reference and its
argmax cannot flip on a near-tie. The categorical search's node totals
(a sum over bins) follow XLA's CPU tree reduction the same way
(``xla_sum``), and its sort is stable like ``jnp.argsort``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..parallel.mesh import all_reduce_sum, mesh_shards

# [F, N] int32 bins + per-row grad/hess + row mask -> [F, num_bins, 3] f32
# sums: K1 for CUDA tensors, its plain version for CPU tensors
from .hist_kernel import histogram as compute_histogram

__all__ = ["SplitInfo", "cat_best_subset", "compute_histogram",
           "find_best_split", "find_best_split_pair", "partition_rows",
           "partition_rows_cat", "reduced_histogram", "shard_reduce",
           "subtract_histogram", "total_sums", "total_sums_sharded",
           "xla_cumsum", "xla_sum"]

_SCAN_BLOCK = 16
# XLA's CPU tree-reduction rewriter: sums over more than this many elements
# become a reduce-window of this size, then a reduce of the window sums
_REDUCE_WINDOW = 32


class SplitInfo(NamedTuple):
    feature: torch.Tensor       # i64 scalar (or [P] for a pair)
    bin: torch.Tensor           # i64: rows with bin <= this go left
    gain: torch.Tensor          # f32
    default_left: torch.Tensor  # bool: where missing (bin 0) goes
    left_sum: torch.Tensor      # [3] (grad, hess, count)
    right_sum: torch.Tensor     # [3]
    # categorical set split: [CW] int64 words of a bin bitset (bin b goes
    # LEFT iff bit b is set; all zero = numerical split), None when the
    # search had no categorical features
    cat_words: Optional[torch.Tensor] = None

    def packed(self) -> torch.Tensor:
        """[..., 10 (+ CW)] f64 (feature, bin, gain, default_left, left_sum,
        right_sum, then the cat words if any): every field exactly (a u32
        word is exact in f64), for one host read per split."""
        d = torch.float64
        parts = [self.feature.to(d)[..., None], self.bin.to(d)[..., None],
                 self.gain.to(d)[..., None],
                 self.default_left.to(d)[..., None],
                 self.left_sum.to(d), self.right_sum.to(d)]
        if self.cat_words is not None:
            parts.append(self.cat_words.to(d))
        return torch.cat(parts, dim=-1)


def xla_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive f32 prefix sum along ``dim`` in XLA's CPU order: sequential
    within blocks of 16, the block totals prefix-summed the same way
    (recursively) and added to every later block."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    nb = -(-n // _SCAN_BLOCK)
    pad = nb * _SCAN_BLOCK - n
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], nb, _SCAN_BLOCK)
    local = torch.empty_like(blocks)
    acc = blocks[..., 0]
    local[..., 0] = acc
    for i in range(1, _SCAN_BLOCK):
        acc = acc + blocks[..., i]
        local[..., i] = acc
    if nb > 1:
        carry = xla_cumsum(local[..., -1], -1)                   # [..., nb]
        local[..., 1:, :] = local[..., 1:, :] + carry[..., :-1, None]
    out = local.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n]
    return out.movedim(-1, dim)


def xla_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """f32 sum along ``dim`` in XLA's CPU order: up to 32 elements added in
    sequence from 0; longer axes padded with zeros (half of the padding in
    front) to a multiple of 32, each window of 32 summed in sequence, and
    the window sums reduced the same way."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n > _REDUCE_WINDOW:
        pad = (-n) % _REDUCE_WINDOW
        if pad:
            x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        w = x.reshape(*x.shape[:-1], -1, _REDUCE_WINDOW)
        acc = torch.zeros_like(w[..., 0])
        for i in range(_REDUCE_WINDOW):
            acc = acc + w[..., i]
        return xla_sum(acc, -1)
    acc = torch.zeros_like(x[..., 0])
    for i in range(n):
        acc = acc + x[..., i]
    return acc


def _leaf_objective(G, H, l1: float, l2: float):
    """-0.5 * T(G)^2 / (H + l2), T = soft-threshold by l1 (LightGBM's
    GetLeafGain), in the reference's operation order."""
    t = torch.sign(G) * torch.clamp(torch.abs(G) - l1, min=0.0)
    return -0.5 * t * t / (H + l2)


def _f32(v) -> float:
    """A hyper-parameter as the f32 value the reference computes with."""
    return float(torch.tensor(float(v), dtype=torch.float32))


def cat_best_subset(hist: torch.Tensor, lambda_l1, lambda_l2,
                    min_sum_hessian, min_data_in_leaf: int, cat_smooth,
                    cat_l2, max_cat_threshold: int):
    """Per-feature best categorical SET split of a [..., F, B, 3] histogram
    (LightGBM's sorted-by-gradient-statistic partitioning): the value bins
    sorted by G/(H + cat_smooth) (absent bins last), the best prefix of
    that order goes left, at most ``max_cat_threshold`` bins of it.

    Returns (gain [..., F] f32, words [..., F, CW] int64 bin bitsets with
    u32 values, left_sum [..., F, 3]). The missing bin (0) is never a
    member: missing categories route right."""
    l1, msh = _f32(lambda_l1), _f32(min_sum_hessian)
    l2c = float(np.float32(lambda_l2) + np.float32(cat_l2))
    smooth = _f32(cat_smooth)
    b = hist.shape[-2]
    cw = (b + 31) // 32
    vb = hist[..., 1:, :]                                 # [..., F, B-1, 3]
    present = vb[..., 2] > 0.0
    n_present = present.sum(dim=-1)                       # [..., F]
    ratio = torch.where(present, vb[..., 0] / (vb[..., 1] + smooth),
                        float("inf"))
    order = torch.argsort(ratio, dim=-1, stable=True)     # [..., F, B-1]
    sh = torch.take_along_dim(vb, order[..., None], dim=-2)
    cum = xla_cumsum(sh, -2)                              # [..., F, B-1, 3]
    total = xla_sum(hist, -2)                             # [..., F, 3]
    G = total[..., 0, 0][..., None, None]                 # feature 0's totals
    H = total[..., 0, 1][..., None, None]
    C = total[..., 0, 2][..., None, None]
    GL, HL, CL = cum[..., 0], cum[..., 1], cum[..., 2]
    GR, HR, CR = G - GL, H - HL, C - CL
    gain = (_leaf_objective(GL, HL, l1, l2c)
            + _leaf_objective(GR, HR, l1, l2c)
            - _leaf_objective(G, H, l1, l2c)) * -1.0
    k = torch.arange(1, b, device=hist.device)            # prefix sizes
    ok = ((CL >= min_data_in_leaf) & (CR >= min_data_in_leaf)
          & (HL >= msh) & (HR >= msh) & (k <= int(max_cat_threshold))
          & (k <= n_present[..., None]))
    gain = torch.where(ok, gain, float("-inf"))
    ki = torch.argmax(gain, dim=-1, keepdim=True)         # first max
    gain_f = torch.take_along_dim(gain, ki, dim=-1)[..., 0]
    lsum_f = torch.take_along_dim(cum, ki[..., None], dim=-2)[..., 0, :]
    # membership in the original bin positions: sorted position <= ki
    pos = torch.empty_like(order)
    pos.scatter_(-1, order, torch.arange(b - 1, device=hist.device)
                 .expand_as(order).contiguous())
    member = pos <= ki                                    # [..., F, B-1]
    full = torch.nn.functional.pad(member, (1, cw * 32 - b))  # bin 0: never
    bits = full.reshape(*full.shape[:-1], cw, 32).to(torch.int64)
    words = (bits << torch.arange(32, device=hist.device)).sum(dim=-1)
    return gain_f, words, lsum_f


def find_best_split_pair(hist: torch.Tensor, lambda_l1, lambda_l2,
                         min_sum_hessian, min_data_in_leaf: int,
                         feature_mask: Optional[torch.Tensor] = None,
                         cat_info=None) -> SplitInfo:
    """Best (feature, bin, missing-direction) of each [F, B, 3] histogram of
    a [P, F, B, 3] stack, in one vectorized evaluation.

    Threshold semantics: candidate t sends bins 1..t left, bins t+1.. right;
    the missing bin (0) is tried on both sides and the better direction is
    kept (LightGBM's default-direction learning).

    ``cat_info``: optional (cat_mask [F] bool tensor, cat_smooth, cat_l2,
    max_cat_threshold). Features flagged categorical are split by set
    membership (``cat_best_subset``) instead of a threshold; a categorical
    winner has bin 0, default_left False and its bitset in ``cat_words``
    (all zero for a numerical winner)."""
    l1, l2, msh = _f32(lambda_l1), _f32(lambda_l2), _f32(min_sum_hessian)
    p, f, b, _ = hist.shape
    miss = hist[:, :, 0, :]                               # [P, F, 3]
    cum = xla_cumsum(hist[:, :, 1:, :], 2)                # [P, F, B-1, 3]
    total = cum[:, :, -1, :] + miss                       # [P, F, 3]
    G = total[:, 0, 0][:, None, None]
    H = total[:, 0, 1][:, None, None]
    C = total[:, 0, 2][:, None, None]
    parent = _leaf_objective(G, H, l1, l2)

    def gains(GL, HL, CL):
        GR, HR, CR = G - GL, H - HL, C - CL
        gain = (_leaf_objective(GL, HL, l1, l2)
                + _leaf_objective(GR, HR, l1, l2) - parent) * -1.0
        ok = ((CL >= min_data_in_leaf) & (CR >= min_data_in_leaf)
              & (HL >= msh) & (HR >= msh))
        return torch.where(ok, gain, float("-inf"))

    GL0, HL0, CL0 = cum[..., 0], cum[..., 1], cum[..., 2]
    gain_right = gains(GL0, HL0, CL0)                     # missing -> right
    gain_left = gains(GL0 + miss[:, :, None, 0], HL0 + miss[:, :, None, 1],
                      CL0 + miss[:, :, None, 2])          # missing -> left
    best_dir_left = gain_left >= gain_right
    gain = torch.maximum(gain_left, gain_right)           # [P, F, B-1]
    rows = torch.arange(p, device=hist.device)
    if cat_info is not None:
        return _best_with_cat(hist, cum, miss, total, gain, best_dir_left,
                              rows, lambda_l1, lambda_l2, min_sum_hessian,
                              min_data_in_leaf, feature_mask, cat_info)
    if feature_mask is not None:
        gain = torch.where(feature_mask[None, :, None], gain, float("-inf"))

    flat = torch.argmax(gain.reshape(p, -1), dim=1)       # first max
    bf = flat // (b - 1)
    bt = flat % (b - 1) + 1
    best_gain = gain.reshape(p, -1)[rows, flat]
    dleft = best_dir_left.reshape(p, -1)[rows, flat]
    lsum = cum[rows, bf, bt - 1, :] + torch.where(
        dleft[:, None], miss[rows, bf], 0.0)
    rsum = total[rows, bf] - lsum
    return SplitInfo(bf, bt, best_gain, dleft, lsum, rsum)


def _best_with_cat(hist, cum, miss, total, gain, best_dir_left, rows,
                   lambda_l1, lambda_l2, min_sum_hessian, min_data_in_leaf,
                   feature_mask, cat_info) -> SplitInfo:
    """The categorical branch of ``find_best_split_pair``: each feature's
    best numerical and best set split, the feature's kind picking one, then
    the best feature (ties to the first)."""
    cat_mask, cat_smooth, cat_l2, max_cat_threshold = cat_info
    cat_gain, cat_words, cat_lsum = cat_best_subset(
        hist, lambda_l1, lambda_l2, min_sum_hessian, min_data_in_leaf,
        cat_smooth, cat_l2, max_cat_threshold)
    num_ki = torch.argmax(gain, dim=2, keepdim=True)      # [P, F, 1]
    num_gain = torch.take_along_dim(gain, num_ki, dim=2)[..., 0]
    num_dir = torch.take_along_dim(best_dir_left, num_ki, dim=2)[..., 0]
    num_lsum = (torch.take_along_dim(cum, num_ki[..., None], dim=2)[:, :, 0]
                + torch.where(num_dir[..., None], miss, 0.0))
    gain_f = torch.where(cat_mask[None], cat_gain, num_gain)   # [P, F]
    if feature_mask is not None:
        gain_f = torch.where(feature_mask[None], gain_f, float("-inf"))
    bf = torch.argmax(gain_f, dim=1)                      # first max
    is_cat = cat_mask[bf]
    best_gain = gain_f[rows, bf]
    bt = torch.where(is_cat, 0, num_ki[rows, bf, 0] + 1)
    dleft = torch.where(is_cat, False, num_dir[rows, bf])
    lsum = torch.where(is_cat[:, None], cat_lsum[rows, bf], num_lsum[rows, bf])
    rsum = total[rows, bf] - lsum
    words = torch.where(is_cat[:, None], cat_words[rows, bf], 0)
    return SplitInfo(bf, bt, best_gain, dleft, lsum, rsum, words)


def find_best_split(hist: torch.Tensor, lambda_l1, lambda_l2,
                    min_sum_hessian, min_data_in_leaf: int,
                    feature_mask: Optional[torch.Tensor] = None,
                    cat_info=None) -> SplitInfo:
    """Best split of one [F, B, 3] histogram (see find_best_split_pair)."""
    s = find_best_split_pair(hist[None], lambda_l1, lambda_l2,
                             min_sum_hessian, min_data_in_leaf, feature_mask,
                             cat_info)
    return SplitInfo(*(x[0] if x is not None else None for x in s))


def partition_rows(bins_col: torch.Tensor, node_of_row: torch.Tensor,
                   node_id: int, threshold_bin: int, default_left: bool,
                   left_id: int, right_id: int) -> torch.Tensor:
    """Route rows of ``node_id`` to children: bin <= t (or missing per the
    default direction) left."""
    in_node = node_of_row == node_id
    go_left = torch.where(bins_col == 0, bool(default_left),
                          bins_col <= threshold_bin)
    child = torch.where(go_left, left_id, right_id).to(node_of_row.dtype)
    return torch.where(in_node, child, node_of_row)


def partition_rows_cat(bins_col: torch.Tensor, node_of_row: torch.Tensor,
                       node_id: int, threshold_bin: int, default_left: bool,
                       left_id: int, right_id: int,
                       cat_words: torch.Tensor) -> torch.Tensor:
    """Categorical-aware routing: with non-zero ``cat_words`` ([CW] int64
    words of a u32 bin bitset) the split is a SET, bin b going left iff bit
    b is set (never bin 0: missing routes right); all-zero words fall back
    to the threshold rule."""
    in_node = node_of_row == node_id
    b = bins_col.to(torch.int64)
    bits = (cat_words[b >> 5] >> (b & 31)) & 1
    go_left = torch.where(
        torch.any(cat_words != 0), bits == 1,
        torch.where(bins_col == 0, bool(default_left),
                    bins_col <= threshold_bin))
    child = torch.where(go_left, left_id, right_id).to(node_of_row.dtype)
    return torch.where(in_node, child, node_of_row)


def subtract_histogram(parent: torch.Tensor, child: torch.Tensor
                       ) -> torch.Tensor:
    """Sibling histogram by subtraction (LightGBM's halving trick). Grad sums
    may be negative; counts/hessians are clamped at 0 against float
    cancellation."""
    diff = parent - child
    diff[..., 1:] = torch.clamp(diff[..., 1:], min=0.0)
    return diff


def total_sums(grad: torch.Tensor, hess: torch.Tensor,
               row_mask: torch.Tensor) -> torch.Tensor:
    """[3] f32 (sum grad, sum hess, count) over the masked rows, summed in
    f64 and rounded once: the same on every device and in any order of the
    rows, so a sharded fit's root sums (``total_sums_sharded``) equal
    these up to a double-rounding tie."""
    return total_sums64(grad, hess, row_mask).float()


def total_sums64(grad: torch.Tensor, hess: torch.Tensor,
                 row_mask: torch.Tensor) -> torch.Tensor:
    """[3] f64 (sum grad, sum hess, count) over the masked rows, unrounded."""
    m = row_mask.to(torch.float64)
    return torch.stack([torch.sum(grad.double() * m),
                        torch.sum(hess.double() * m), torch.sum(m)])


Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def shard_reduce(mesh) -> Reduce:
    """The growers' ``reduce`` for ``mesh``: None without a mesh (the f32
    kernels, bit for bit as before), else f64 sums -> their all-reduce over
    the data axis (a mesh of one process included), rounded to f32 once."""
    mesh_shards(mesh)                      # a port Mesh, or None
    if mesh is None:
        return None
    return lambda t64: all_reduce_sum(t64, mesh).float()


def reduced_histogram(reduce: Reduce, fn, *args, **kw) -> torch.Tensor:
    """``fn(*args)`` (a histogram entry of K1 or K4) without ``reduce``; with
    it, the entry's f64 sums through ``reduce``."""
    if reduce is None:
        return fn(*args, **kw)
    return reduce(fn(*args, f64=True, **kw))


def total_sums_sharded(grad: torch.Tensor, hess: torch.Tensor,
                       row_mask: torch.Tensor, reduce: Reduce
                       ) -> torch.Tensor:
    """``total_sums`` of every shard's rows: without ``reduce`` the f32 sums
    of this process's rows; with it, f64 sums all-reduced and rounded
    once."""
    if reduce is None:
        return total_sums(grad, hess, row_mask)
    return reduce(total_sums64(grad, hess, row_mask))
