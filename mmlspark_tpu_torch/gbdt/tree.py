"""Leaf-wise (best-first) tree growth over binned features, in PyTorch.

Counterpart of the reference's ``mmlspark_tpu/gbdt/tree.py``: ``Tree``,
``GrowerConfig``, ``cat_sets_from_words``, ``build_thresholds``,
``predict_tree_binned`` and the whole-tree grower
(``_grow_tree_device_body``). The reference grows a tree inside one jitted
``lax.while_loop``; here the loop is Python over device tensors:

  - the best-first heap is an argmax over per-node candidate gains (ties to
    the lowest node id), read on the host once per split together with the
    two children's split candidates;
  - the reference's ``lax.switch`` over row-compaction tiers becomes one
    host read of the small child's row count and an ``if``.

Rows live on the device (``node_of_row``, the histograms); the node tables
are a few dozen entries and live on the host. Each split routes the
parent's rows, builds the smaller child's histogram (K1 on CUDA; for a
small child over a compacted tier buffer, filled by K2 on CUDA at mask
widths of 500k rows or more, else by ``nonzero`` + ``index_select``),
derives the sibling by subtraction and evaluates both children. The tier
arithmetic is the reference's exactly: it decides which rows are summed.

With ``cat_args`` the features it flags split by category SET
(``histogram.cat_best_subset``): a set node routes its rows by the bin
bitset the search returns (``partition_rows_cat``) and keeps it in
``Tree.cat_bin_words`` beside the category values it stands for
(``Tree.cat_sets``). The per-split host grower and the row-sharded grower
wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import histogram as H
from . import select_kernel


@dataclasses.dataclass
class Tree:
    """Flat decision tree. Node 0 is the root; feature == -1 marks a leaf."""

    feature: np.ndarray        # i32 [nodes], -1 for leaves
    threshold: np.ndarray      # f64 [nodes], raw-value threshold (<= goes left)
    threshold_bin: np.ndarray  # i32 [nodes]
    default_left: np.ndarray   # bool [nodes], missing direction
    left: np.ndarray           # i32 [nodes]
    right: np.ndarray          # i32 [nodes]
    value: np.ndarray          # f64 [nodes], leaf output (0 for internal)
    gain: np.ndarray           # f32 [nodes], split gain (0 for leaves)
    count: np.ndarray          # i32 [nodes], training rows through the node
    shrinkage: float = 1.0
    weight: Optional[np.ndarray] = None  # f64 [nodes], hessian sums
    # categorical SET splits: membership sends a row LEFT. Two views of one
    # set: cat_sets, per node the sorted int64 category VALUES (raw-value
    # scoring, LightGBM interchange) or None; cat_bin_words, [nodes, CW]
    # u32 bitsets over BIN ids (binned routing; None for imported models)
    cat_sets: Optional[list] = None
    cat_bin_words: Optional[np.ndarray] = None

    @property
    def num_leaves(self) -> int:
        return int((self.feature == -1).sum())

    def to_dict(self) -> dict:
        d = {
            "feature": self.feature.tolist(),
            "threshold": self.threshold.tolist(),
            "threshold_bin": self.threshold_bin.tolist(),
            "default_left": self.default_left.tolist(),
            "left": self.left.tolist(),
            "right": self.right.tolist(),
            "value": self.value.tolist(),
            "gain": self.gain.tolist(),
            "count": self.count.tolist(),
            "shrinkage": self.shrinkage,
        }
        if self.weight is not None:
            d["weight"] = self.weight.tolist()
        if self.cat_sets is not None:
            d["cat_sets"] = [s.tolist() if s is not None else None
                             for s in self.cat_sets]
        if self.cat_bin_words is not None:
            d["cat_bin_words"] = self.cat_bin_words.tolist()
        return d

    @staticmethod
    def from_dict(d: dict) -> "Tree":
        cat_sets = None
        if d.get("cat_sets") is not None:
            cat_sets = [np.asarray(s, dtype=np.int64) if s is not None
                        else None for s in d["cat_sets"]]
        return Tree(
            feature=np.asarray(d["feature"], dtype=np.int32),
            threshold=np.asarray(d["threshold"], dtype=np.float64),
            threshold_bin=np.asarray(d["threshold_bin"], dtype=np.int32),
            default_left=np.asarray(d["default_left"], dtype=bool),
            left=np.asarray(d["left"], dtype=np.int32),
            right=np.asarray(d["right"], dtype=np.int32),
            value=np.asarray(d["value"], dtype=np.float64),
            gain=np.asarray(d["gain"], dtype=np.float32),
            count=np.asarray(d["count"], dtype=np.int32),
            shrinkage=float(d.get("shrinkage", 1.0)),
            weight=(np.asarray(d["weight"], dtype=np.float64)
                    if d.get("weight") is not None else None),
            cat_sets=cat_sets,
            cat_bin_words=(np.asarray(d["cat_bin_words"], dtype=np.uint32)
                           if d.get("cat_bin_words") is not None else None),
        )


@dataclasses.dataclass
class GrowerConfig:
    num_leaves: int = 31
    max_depth: int = -1                 # -1 = unlimited (bounded by num_leaves)
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    max_delta_step: float = 0.0         # clamp |leaf value| (0 = off)


def cat_sets_from_words(words: Optional[np.ndarray], feature: np.ndarray,
                        bin_mapper) -> Tuple[Optional[list],
                                             Optional[np.ndarray]]:
    """[nodes, CW] u32 bin bitsets -> (per node the sorted category VALUES
    of its set or None, the words themselves); (None, None) when no node
    has a set."""
    if words is None or not words.any():
        return None, None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    sets: list = [None] * len(feature)
    for nid in range(len(feature)):
        w = words[nid]
        if not w.any():
            continue
        bits = np.unpackbits(w.view(np.uint8), bitorder="little")
        bins_in = np.nonzero(bits)[0]            # bin ids (>= 1 always)
        cats = bin_mapper.categories[int(feature[nid])]
        sets[nid] = np.sort(cats[bins_in - 1]).astype(np.int64)
    return sets, words


def build_thresholds(feature, tbin, cat_sets, bin_mapper) -> np.ndarray:
    """Raw-value thresholds per node: the bin's upper value for numerical
    splits, 0.0 for leaves and categorical set nodes (a set routes by
    membership, not by a threshold)."""
    return np.array(
        [bin_mapper.bin_upper_value(int(f), int(t))
         if f >= 0 and (cat_sets is None or cat_sets[i] is None) else 0.0
         for i, (f, t) in enumerate(zip(feature, tbin))], dtype=np.float64)


def predict_tree_binned(tree: Tree, bins: np.ndarray) -> np.ndarray:
    """One tree on binned [N, F] features, on the host (a reference for
    tests): set nodes route by their bin bitset."""
    node = np.zeros(bins.shape[0], dtype=np.int64)
    active = tree.feature[node] != -1
    while active.any():
        cur = node[active]
        b = bins[active, tree.feature[cur]]
        go_left = np.where(b == 0, tree.default_left[cur],
                           b <= tree.threshold_bin[cur])
        if tree.cat_bin_words is not None:
            w = tree.cat_bin_words[cur]                     # [A, CW]
            bit = (w[np.arange(len(b)), b >> 5]
                   >> (b & 31).astype(np.uint32)) & 1
            go_left = np.where(w.any(axis=1), bit == 1, go_left)
        node[active] = np.where(go_left, tree.left[cur], tree.right[cur])
        active = tree.feature[node] != -1
    return tree.value[node] * tree.shrinkage


def tier_caps(n_rows: int, use_select: bool) -> Tuple[int, ...]:
    """Static capacities of the small-child compaction tiers, descending —
    the reference's arithmetic (tree.py ``_grow_tree_device_body``): with
    the select kernel the tiers start at n/2 (up to 7 of them), without it
    at n/8 (up to 5); the top tier is capped to a 4 GB select buffer."""
    caps: List[int] = []
    top_div = 2 if use_select else 8
    max_tiers = 7 if use_select else 5
    c = (n_rows // top_div + 511) // 512 * 512
    while c * 132 * 4 > (4 << 30):   # select-buffer budget
        c = (c // 2 + 511) // 512 * 512
    while c >= max(4096, n_rows // 128) and len(caps) < max_tiers:
        caps.append(c)
        c = (c // 2 + 511) // 512 * 512
    return tuple(caps)


def pick_tier(caps: Tuple[int, ...], count: int) -> int:
    """Tier index for ``count`` rows: 0 = full width, i >= 1 = caps[i-1],
    the smallest tier that holds them (the reference's switch index)."""
    if not caps or count > caps[0]:
        return 0
    tidx = 1
    for i, cap in enumerate(caps[1:], 2):
        if count <= cap:
            tidx = i
    return tidx


def _small_child_hist(bins_fm, grad, hess, small_mask, small_cnt: int,
                      num_bins: int, caps, use_sel: bool) -> torch.Tensor:
    """Histogram of the masked rows, streaming only a tier-sized compacted
    buffer when a tier holds them (same rows, same order as the full
    scan)."""
    tidx = pick_tier(caps, small_cnt)
    if tidx == 0:
        return H.compute_histogram(bins_fm, grad, hess, small_mask, num_bins)
    cap = caps[tidx - 1]
    valid = torch.arange(cap, device=bins_fm.device) < small_cnt
    if use_sel:
        b_c, g_c, h_c = select_kernel.select_rows(bins_fm, grad, hess,
                                                  small_mask, cap)
        return H.compute_histogram(b_c, g_c, h_c, valid, num_bins)
    idx = torch.zeros(cap, dtype=torch.int64, device=bins_fm.device)
    idx[:small_cnt] = torch.nonzero(small_mask).flatten()
    return H.compute_histogram(bins_fm.index_select(1, idx).contiguous(),
                               grad.index_select(0, idx),
                               hess.index_select(0, idx), valid, num_bins)


def grow_tree(bins_fm: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              row_mask: torch.Tensor, num_bins: int, config: GrowerConfig,
              bin_mapper, feature_mask: Optional[torch.Tensor] = None,
              node_of_row: Optional[torch.Tensor] = None, cat_args=None
              ) -> Tuple[Tree, torch.Tensor]:
    """Grow one tree; returns (tree, node_of_row) with ``node_of_row`` the
    device tensor mapping every masked-in row to its final node id.

    ``bins_fm``: [F, N] int32 on the device (feature-major);
    ``grad``/``hess``: [N] f32; ``row_mask``: [N] bool (bagging subset);
    ``feature_mask``: [F] bool or None; ``cat_args``: None, or (cat_mask
    [F] bool tensor, cat_smooth, cat_l2, max_cat_threshold) to split the
    flagged features by category set."""
    dev = bins_fm.device
    n = int(bins_fm.shape[1])
    if node_of_row is None:
        node_of_row = torch.zeros(n, dtype=torch.int32, device=dev)
    M = 2 * config.num_leaves - 1
    use_sel = dev.type == "cuda" and select_kernel.use_select(n)
    caps = tier_caps(n, use_sel)
    l1, l2 = config.lambda_l1, config.lambda_l2
    msh, mdl = config.min_sum_hessian_in_leaf, config.min_data_in_leaf
    mgs = np.float32(config.min_gain_to_split)
    neg_inf = np.float32(-np.inf)

    root_hist = H.compute_histogram(bins_fm, grad, hess, row_mask, num_bins)
    root_sums = H.total_sums(grad, hess, row_mask)
    cw = (num_bins + 31) // 32
    width = 10 + (cw if cat_args is not None else 0)   # packed SplitInfo
    s0 = H.find_best_split(root_hist, l1, l2, msh, mdl, feature_mask,
                           cat_args)
    host = torch.cat([root_sums.to(torch.float64), s0.packed()]).cpu().numpy()

    # host node tables (the reference's device state dict)
    feature = np.full(M, -1, np.int32)
    threshold_bin = np.zeros(M, np.int32)
    default_left = np.ones(M, bool)
    left = np.full(M, -1, np.int32)
    right = np.full(M, -1, np.int32)
    gain = np.zeros(M, np.float32)
    sums = np.zeros((M, 3), np.float32)
    depth = np.zeros(M, np.int32)
    cand_gain = np.full(M, neg_inf, np.float32)
    cand = np.zeros((M, width), np.float64)  # packed SplitInfo per node
    cat_words = np.zeros((M, width - 10), np.uint32)
    hists: List[Optional[torch.Tensor]] = [None] * M

    sums[0] = host[:3]
    cand[0] = host[3:]
    g0 = np.float32(cand[0, 2])
    # the root is pushed without the 2*min_data_in_leaf check (the split
    # search already enforces per-side constraints)
    if np.isfinite(g0) and g0 > mgs:
        cand_gain[0] = g0
    hists[0] = root_hist
    n_nodes, n_leaves = 1, 1

    def push(nid: int, s: np.ndarray, csum: np.ndarray, dchild: int):
        g = np.float32(s[2])
        ok = bool(np.isfinite(g) and g > mgs
                  and csum[2] >= 2 * config.min_data_in_leaf)
        if config.max_depth > 0:
            ok = ok and dchild < config.max_depth
        cand_gain[nid] = g if ok else neg_inf
        cand[nid] = s

    while n_leaves < config.num_leaves and cand_gain.max() > neg_inf:
        leaf = int(np.argmax(cand_gain))
        c = cand[leaf]
        f, t, dl = int(c[0]), int(c[1]), bool(c[3])
        lsum = c[4:7].astype(np.float32)
        rsum = c[7:10].astype(np.float32)
        lid, rid = n_nodes, n_nodes + 1
        dchild = int(depth[leaf]) + 1

        words = cand[leaf, 10:].astype(np.uint32)
        if words.any():
            node_of_row = H.partition_rows_cat(
                bins_fm[f], node_of_row, leaf, t, dl, lid, rid,
                torch.as_tensor(words.astype(np.int64), device=dev))
        else:
            node_of_row = H.partition_rows(bins_fm[f], node_of_row, leaf, t,
                                           dl, lid, rid)
        small_is_left = bool(lsum[2] <= rsum[2])
        small_id, big_id = (lid, rid) if small_is_left else (rid, lid)
        small_mask = row_mask & (node_of_row == small_id)
        small_cnt = int(small_mask.sum())          # host read: tier choice
        small_hist = _small_child_hist(bins_fm, grad, hess, small_mask,
                                       small_cnt, num_bins, caps, use_sel)
        big_hist = H.subtract_histogram(hists[leaf], small_hist)
        hists[leaf] = None
        pair = H.find_best_split_pair(torch.stack([small_hist, big_hist]),
                                      l1, l2, msh, mdl, feature_mask,
                                      cat_args)
        s_small, s_big = pair.packed().cpu().numpy()

        small_sums, big_sums = (lsum, rsum) if small_is_left else (rsum, lsum)
        push(small_id, s_small, small_sums, dchild)
        push(big_id, s_big, big_sums, dchild)

        feature[leaf], threshold_bin[leaf], default_left[leaf] = f, t, dl
        left[leaf], right[leaf] = lid, rid
        cat_words[leaf] = words
        gain[leaf] = cand_gain[leaf]
        cand_gain[leaf] = neg_inf
        sums[lid], sums[rid] = lsum, rsum
        depth[lid] = depth[rid] = dchild
        hists[small_id], hists[big_id] = small_hist, big_hist
        n_nodes += 2
        n_leaves += 1

    nn = n_nodes
    feature, tbin = feature[:nn], threshold_bin[:nn]
    s64 = sums[:nn].astype(np.float64)
    # leaf values on host in f64 (the reference's precision lineage)
    g_thr = np.sign(s64[:, 0]) * np.maximum(np.abs(s64[:, 0]) - l1, 0.0)
    value = np.where(feature < 0, -g_thr / (s64[:, 1] + l2), 0.0)
    if config.max_delta_step > 0:
        value = np.clip(value, -config.max_delta_step, config.max_delta_step)
    # an unsplit root keeps 0.0 (it is never anyone's child)
    value[0] = 0.0 if nn == 1 else value[0]
    cat_sets, words_np = cat_sets_from_words(
        cat_words[:nn] if cat_args is not None else None, feature, bin_mapper)
    tree = Tree(
        feature=feature,
        threshold=build_thresholds(feature, tbin, cat_sets, bin_mapper),
        threshold_bin=tbin,
        default_left=default_left[:nn].copy(),
        left=left[:nn].copy(),
        right=right[:nn].copy(),
        value=value,
        gain=gain[:nn].copy(),
        count=s64[:, 2].astype(np.int32),
        weight=s64[:, 1],
        cat_sets=cat_sets,
        cat_bin_words=words_np,
    )
    return tree, node_of_row
