"""Leaf-wise (best-first) tree growth over binned features, in PyTorch.

Counterpart of the reference's ``mmlspark_tpu/gbdt/tree.py``: ``Tree``,
``GrowerConfig``, ``cat_sets_from_words``, ``build_thresholds``,
``predict_tree_binned`` and the whole-tree grower. Two routes grow the same
tree (best-first: the argmax over per-node candidate gains, ties to the
lowest node id; node ids in split order), and ``grow_tree`` picks one as
the reference does:

  - **fused** (``_grow_tree_device_body``, ``_grow_tree_fused``,
    ``FusedGrower``): the default on the card, under the reference's 2 GiB
    gate on the ``[2L - 1, F, B, 3]`` node histograms
    (``_fused_tree_enabled``; ``MMLSPARK_TPU_FUSED_TREE=1`` forces it on
    the CPU too, ``MMLSPARK_TPU_NO_FUSED_TREE=1`` turns it off). The node
    tables and the candidates are device tensors and the loop runs a fixed
    ``num_leaves - 1`` steps under a device "active" flag (the reference's
    ``while_loop`` condition), so nothing is read on the host between the
    root and the one fetch of the finished tree, and ``FusedGrower``
    captures the whole tree in a CUDA graph and replays it. A small child
    is compacted by K2 into a buffer as wide as the largest tier, and K1's
    device-count entry sums the rows before the count it reads on the
    device, grouped as a launch sized for the tier would group them: the
    per-split route's grouping from ``select_kernel.MIN_ROWS`` rows up.
    Below it the per-split route sums a child of more than n/8 rows at
    full width, so the last f32 bit of its histogram may differ.
  - **host** (``grow_tree``'s own loop): the per-split route, whose node
    tables live on the host; it reads the small child's row count (the
    tier choice) and the two children's split candidates once a split, and
    is the default on the CPU.

Rows live on the device (``node_of_row``, the histograms). Each split
routes the parent's rows, builds the smaller child's histogram (K1 on
CUDA; over a compacted tier buffer filled by K2 on CUDA, or on the host
route below 500k rows by ``nonzero`` + ``index_select``), derives the
sibling by subtraction and evaluates both children. The tier arithmetic is
the reference's exactly: it decides which rows are summed.

With ``cat_args`` the features it flags split by category SET
(``histogram.cat_best_subset``): a set node routes its rows by the bin
bitset the search returns (``partition_rows_cat``) and keeps it in
``Tree.cat_bin_words`` beside the category values it stands for
(``Tree.cat_sets``).

Row-sharded growth (the reference's ``_grow_tree_device_sharded`` and the
per-split loop's row-sharded branch): with a ``mesh`` each process holds
its own block of rows, and every histogram and the root's sums go through
``reduce`` (``histogram.shard_reduce``: the shard's f64 sums all-reduced
and rounded to f32 once), so every process takes the same split from the
same histogram while ``node_of_row`` stays its own. Every process issues
one all-reduce for every histogram, in lockstep. The per-split route
keeps its tier compaction, each process picking its tier from its own
rows' count (the all-reduce is issued whatever the tier); the fused body
compacts nothing under a mesh, as the reference turns compaction off
under ``psum`` (on the card the sharded fused fit ran no faster with each
shard compacting). On NCCL the sharded tree is captured in the per-tree
CUDA graph with its all-reduces, as one process's tree is; on gloo (its
collectives go through host memory) it runs eagerly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import hist_kernel, select_kernel
from . import histogram as H

# the reference's cap on the fused grower's [2L - 1, F, B, 3] f32 node
# histograms; above it the per-split host route grows the tree
_FUSED_TREE_DEFAULT_BUDGET = 2 << 30

#: host reads of device data the growers made (a reading aid: the fused
#: route makes one a tree, the host route one at the root and two a split)
host_reads = 0


def _fused_tree_enabled(max_nodes: int, num_f: int, num_bins: int,
                        device) -> bool:
    """The reference's route decision for a tree grown on ``device``: the
    fused grower on the card, under the memory budget
    (``MMLSPARK_TPU_FUSED_TREE_BYTES``), unless
    ``MMLSPARK_TPU_NO_FUSED_TREE`` is set; on the CPU only when
    ``MMLSPARK_TPU_FUSED_TREE`` forces it."""
    if os.environ.get("MMLSPARK_TPU_NO_FUSED_TREE", "") not in ("", "0"):
        return False
    budget = int(os.environ.get("MMLSPARK_TPU_FUSED_TREE_BYTES",
                                _FUSED_TREE_DEFAULT_BUDGET))
    if max_nodes * num_f * num_bins * 3 * 4 > budget:
        return False
    if os.environ.get("MMLSPARK_TPU_FUSED_TREE", "") not in ("", "0"):
        return True
    return torch.device(device).type == "cuda"


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
                      num_bins: int, caps, use_sel: bool,
                      reduce: H.Reduce = None) -> torch.Tensor:
    """Histogram of the masked rows, streaming only a tier-sized compacted
    buffer when a tier holds them (same rows, same order as the full
    scan); summed over the shards through ``reduce`` whatever the tier."""
    tidx = pick_tier(caps, small_cnt)
    hist = H.compute_histogram
    if tidx == 0:
        return H.reduced_histogram(reduce, hist, bins_fm, grad, hess,
                                   small_mask, num_bins)
    cap = caps[tidx - 1]
    valid = torch.arange(cap, device=bins_fm.device) < small_cnt
    if use_sel:
        b_c, g_c, h_c = select_kernel.select_rows(bins_fm, grad, hess,
                                                  small_mask, cap)
        return H.reduced_histogram(reduce, hist, b_c, g_c, h_c, valid,
                                   num_bins)
    idx = torch.zeros(cap, dtype=torch.int64, device=bins_fm.device)
    idx[:small_cnt] = torch.nonzero(small_mask).flatten()
    return H.reduced_histogram(reduce, hist,
                               bins_fm.index_select(1, idx).contiguous(),
                               grad.index_select(0, idx),
                               hess.index_select(0, idx), valid, num_bins)


def grow_tree(bins_fm: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              row_mask: torch.Tensor, num_bins: int, config: GrowerConfig,
              bin_mapper, feature_mask: Optional[torch.Tensor] = None,
              node_of_row: Optional[torch.Tensor] = None, cat_args=None,
              mesh=None) -> Tuple[Tree, torch.Tensor]:
    """Grow one tree; returns (tree, node_of_row) with ``node_of_row`` the
    device tensor mapping every masked-in row to its final node id.

    ``bins_fm``: [F, N] int32 on the device (feature-major);
    ``grad``/``hess``: [N] f32; ``row_mask``: [N] bool (bagging subset);
    ``feature_mask``: [F] bool or None; ``cat_args``: None, or (cat_mask
    [F] bool tensor, cat_smooth, cat_l2, max_cat_threshold) to split the
    flagged features by category set.

    The route is the reference's: the fused grower where
    ``_fused_tree_enabled`` says so (on the card by default), else the
    per-split host loop below. With a ``mesh`` the inputs are this
    process's row block and both routes grow the row-sharded tree (every
    process must call, in lockstep)."""
    dev = bins_fm.device
    n = int(bins_fm.shape[1])
    reduce = H.shard_reduce(mesh)
    if _fused_tree_enabled(2 * config.num_leaves - 1, int(bins_fm.shape[0]),
                           num_bins, dev):
        return _grow_tree_fused(bins_fm, grad, hess, row_mask, num_bins,
                                config, bin_mapper, feature_mask, node_of_row,
                                cat_args, reduce)
    if node_of_row is None:
        node_of_row = torch.zeros(n, dtype=torch.int32, device=dev)
    M = 2 * config.num_leaves - 1
    use_sel = dev.type == "cuda" and select_kernel.use_select(n)
    caps = tier_caps(n, use_sel)
    l1, l2 = config.lambda_l1, config.lambda_l2
    msh, mdl = config.min_sum_hessian_in_leaf, config.min_data_in_leaf
    mgs = np.float32(config.min_gain_to_split)
    neg_inf = np.float32(-np.inf)

    root_hist = H.reduced_histogram(reduce, H.compute_histogram, bins_fm,
                                    grad, hess, row_mask, num_bins)
    root_sums = H.total_sums_sharded(grad, hess, row_mask, reduce)
    cw = (num_bins + 31) // 32
    width = 10 + (cw if cat_args is not None else 0)   # packed SplitInfo
    s0 = H.find_best_split(root_hist, l1, l2, msh, mdl, feature_mask,
                           cat_args)
    global host_reads
    host = torch.cat([root_sums.to(torch.float64), s0.packed()]).cpu().numpy()
    host_reads += 1

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
        host_reads += 1
        small_hist = _small_child_hist(bins_fm, grad, hess, small_mask,
                                       small_cnt, num_bins, caps, use_sel,
                                       reduce)
        big_hist = H.subtract_histogram(hists[leaf], small_hist)
        hists[leaf] = None
        pair = H.find_best_split_pair(torch.stack([small_hist, big_hist]),
                                      l1, l2, msh, mdl, feature_mask,
                                      cat_args)
        s_small, s_big = pair.packed().cpu().numpy()
        host_reads += 1

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

    return _finish_tree(feature[:n_nodes], threshold_bin[:n_nodes],
                        default_left[:n_nodes], left[:n_nodes],
                        right[:n_nodes], gain[:n_nodes], sums[:n_nodes],
                        cat_words[:n_nodes] if cat_args is not None else None,
                        config, bin_mapper), node_of_row


def leaf_values(sums, feature, config: GrowerConfig):
    """Leaf values -T(G) / (H + l2) of node sums, T the soft threshold by
    l1, clipped by ``max_delta_step``, 0 at internal nodes: in f64 for
    numpy sums (the saved trees'), in f32 with the f32 hyper-parameters
    for device sums (the scans' running scores)."""
    if isinstance(sums, np.ndarray):
        l1, l2 = config.lambda_l1, config.lambda_l2
        g_thr = np.sign(sums[:, 0]) * np.maximum(np.abs(sums[:, 0]) - l1,
                                                 0.0)
        value = np.where(feature < 0, -g_thr / (sums[:, 1] + l2), 0.0)
    else:
        l1 = float(np.float32(config.lambda_l1))
        l2 = float(np.float32(config.lambda_l2))
        g_thr = torch.sign(sums[:, 0]) * torch.clamp(
            torch.abs(sums[:, 0]) - l1, min=0.0)
        value = torch.where(feature < 0, -g_thr / (sums[:, 1] + l2), 0.0)
    if config.max_delta_step > 0:
        value = value.clip(-config.max_delta_step, config.max_delta_step)
    return value


def _finish_tree(feature, tbin, default_left, left, right, gain, sums,
                 words, config: GrowerConfig, bin_mapper) -> Tree:
    """A ``Tree`` from its node tables (``sums``: the f32 (grad, hess,
    count) sums per node): leaf values on the host in f64 from the f32
    sums, the reference's precision lineage; an unsplit root keeps 0.0 (it
    is never anyone's child)."""
    nn = len(feature)
    feature = np.asarray(feature, dtype=np.int32)
    tbin = np.asarray(tbin, dtype=np.int32)
    s64 = np.asarray(sums, dtype=np.float32).astype(np.float64)
    value = leaf_values(s64, feature, config)
    value[0] = 0.0 if nn == 1 else value[0]
    cat_sets, words_np = cat_sets_from_words(
        np.asarray(words).astype(np.uint32) if words is not None else None,
        feature, bin_mapper)
    return Tree(
        feature=feature,
        threshold=build_thresholds(feature, tbin, cat_sets, bin_mapper),
        threshold_bin=tbin,
        default_left=np.asarray(default_left, dtype=bool).copy(),
        left=np.asarray(left, dtype=np.int32).copy(),
        right=np.asarray(right, dtype=np.int32).copy(),
        value=value,
        gain=np.asarray(gain, dtype=np.float32).copy(),
        count=s64[:, 2].astype(np.int32),
        weight=s64[:, 1],
        cat_sets=cat_sets,
        cat_bin_words=words_np,
    )


# ---------------------------------------------------------------------------
# The device-resident grower (the fused route)
# ---------------------------------------------------------------------------


def device_tier_caps(n_rows: int) -> Tuple[int, ...]:
    """The fused grower's compaction tiers: the reference's select-kernel
    tiers (``tier_caps(n, True)``), used only while the widest holds any
    small child (half the rows); () means every split sums the full width
    under its row mask."""
    caps = tier_caps(n_rows, True)
    return caps if caps and 2 * caps[0] >= n_rows else ()


def _grow_tree_device_body(bins_fm: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, row_mask: torch.Tensor,
                           node_of_row: Optional[torch.Tensor],
                           num_bins: int, config: GrowerConfig,
                           feature_mask: Optional[torch.Tensor] = None,
                           cat_args=None, caps: Optional[Tuple[int, ...]] = None,
                           reduce: H.Reduce = None
                           ) -> Dict[str, torch.Tensor]:
    """Grow one whole tree on the device, with no host read: the
    reference's ``_grow_tree_device_body``.

    The node tables and the candidates are tensors of ``2L - 1`` nodes plus
    one trash slot, where a step that is not active writes. The best-first
    pop is ``argmax`` over the candidate gains (ties to the lowest id); the
    loop runs ``num_leaves - 1`` steps, each active while some candidate is
    finite (the reference's ``while_loop`` condition), so its shapes are
    fixed and a CUDA graph can hold it. A small child's rows are compacted
    by ``select_rows`` (K2) into a ``caps[0]``-wide buffer and summed by
    ``histogram_count`` (K1's device-count entry) up to the count on the
    device; with no ``caps``, and always under ``reduce``, the full width
    is summed under the mask.
    ``reduce`` (the reference's ``psum_axis``): None for one shard, else
    every histogram and the root's sums are this process's rows' f64 sums
    through it (``histogram.shard_reduce``), issued on every step.

    Returns device tensors: ``node_of_row`` [N], the node tables
    ``feature``, ``threshold_bin``, ``default_left``, ``left``, ``right``,
    ``gain`` [M], ``sums`` [M, 3] f32, ``n_nodes`` [1] int64 and, with
    ``cat_args``, ``cat_words`` [M, CW] int64."""
    dev = bins_fm.device
    n = int(bins_fm.shape[1])
    M = 2 * config.num_leaves - 1
    T = M                                   # the trash slot
    if reduce is not None:
        caps = ()          # no compaction under the all-reduce (reference)
    elif caps is None:
        caps = device_tier_caps(n)
    l1, l2 = config.lambda_l1, config.lambda_l2
    msh, mdl = config.min_sum_hessian_in_leaf, config.min_data_in_leaf
    mgs = float(np.float32(config.min_gain_to_split))
    neg_inf = float("-inf")
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    if node_of_row is None:
        node_of_row = torch.zeros(n, dtype=i32, device=dev)

    root_hist = H.reduced_histogram(reduce, H.compute_histogram, bins_fm,
                                    grad, hess, row_mask, num_bins)
    root_sums = H.total_sums_sharded(grad, hess, row_mask, reduce)
    s0 = H.find_best_split(root_hist, l1, l2, msh, mdl, feature_mask,
                           cat_args)
    # the root is pushed without the 2 * min_data_in_leaf check (the split
    # search already enforces per-side constraints)
    root_ok = torch.isfinite(s0.gain) & (s0.gain > mgs)

    def table(fill, dtype, *shape):
        return torch.full((M + 1, *shape), fill, dtype=dtype, device=dev)

    feature, threshold_bin = table(-1, i32), table(0, i32)
    default_left = table(True, torch.bool)
    left, right = table(-1, i32), table(-1, i32)
    gain, depth = table(0.0, f32), table(0, i32)
    sums = table(0.0, f32, 3)
    sums[0] = root_sums
    hists = torch.empty((M + 1, *root_hist.shape), dtype=f32, device=dev)
    hists[0] = root_hist
    cand_gain = table(neg_inf, f32)
    cand_gain[0] = torch.where(root_ok, s0.gain, neg_inf)
    cand_feature, cand_bin = table(0, i64), table(0, i64)
    cand_dleft = table(False, torch.bool)
    cand_lsum, cand_rsum = table(0.0, f32, 3), table(0.0, f32, 3)
    cand_feature[0], cand_bin[0] = s0.feature, s0.bin
    cand_dleft[0] = s0.default_left
    cand_lsum[0], cand_rsum[0] = s0.left_sum, s0.right_sum
    cat_words = cand_cwords = None
    if cat_args is not None:
        cw = (num_bins + 31) // 32
        cat_words, cand_cwords = table(0, i64, cw), table(0, i64, cw)
        cand_cwords[0] = s0.cat_words
    n_nodes = torch.ones(1, dtype=i64, device=dev)
    minus_inf = torch.full((1,), neg_inf, dtype=f32, device=dev)
    trash = torch.full((1,), T, dtype=i64, device=dev)

    for _ in range(config.num_leaves - 1):
        cg = cand_gain[:M]
        active = cg.max() > neg_inf
        leaf = torch.argmax(cg).reshape(1)             # ties: the lowest id
        f = cand_feature.index_select(0, leaf)
        t = cand_bin.index_select(0, leaf)
        dl = cand_dleft.index_select(0, leaf)
        lsum = cand_lsum.index_select(0, leaf)[0]
        rsum = cand_rsum.index_select(0, leaf)[0]
        lid = n_nodes
        rid = lid + 1
        dchild = depth.index_select(0, leaf) + 1

        # route the leaf's rows to its children
        col = bins_fm.index_select(0, f)[0]
        go_left = torch.where(col == 0, dl, col <= t)
        if cat_args is not None:
            words = cand_cwords.index_select(0, leaf)[0]
            b = col.to(i64)
            bits = (words[b >> 5] >> (b & 31)) & 1
            go_left = torch.where(torch.any(words != 0), bits == 1, go_left)
        child = torch.where(go_left, lid, rid).to(i32)
        node_of_row = torch.where((node_of_row == leaf) & active, child,
                                  node_of_row)

        # the smaller child's histogram, the sibling's by subtraction
        small_is_left = lsum[2] <= rsum[2]
        small_id = torch.where(small_is_left, lid, rid)
        big_id = torch.where(small_is_left, rid, lid)
        small_mask = row_mask & (node_of_row == small_id)
        if caps:
            cnt = small_mask.sum(dtype=i32).reshape(1)
            b_c, g_c, h_c = select_kernel.select_rows(bins_fm, grad, hess,
                                                      small_mask, caps[0])
            small_hist = hist_kernel.histogram_count(b_c, g_c, h_c, cnt,
                                                     num_bins, caps)
        else:
            small_hist = H.reduced_histogram(reduce, H.compute_histogram,
                                             bins_fm, grad, hess, small_mask,
                                             num_bins)
        big_hist = H.subtract_histogram(hists.index_select(0, leaf)[0],
                                        small_hist)
        pair = H.find_best_split_pair(torch.stack([small_hist, big_hist]),
                                      l1, l2, msh, mdl, feature_mask,
                                      cat_args)

        # push both children (inactive steps write the trash slot)
        csums = torch.stack([torch.where(small_is_left, lsum, rsum),
                             torch.where(small_is_left, rsum, lsum)])
        ok = (torch.isfinite(pair.gain) & (pair.gain > mgs)
              & (csums[:, 2] >= 2 * mdl))
        if config.max_depth > 0:
            ok = ok & (dchild < config.max_depth)
        ids = torch.where(active, torch.cat([small_id, big_id]), T)
        pid = torch.where(active, leaf, trash)
        gain.index_put_((pid,), cand_gain.index_select(0, leaf))
        cand_gain.index_put_((ids,), torch.where(ok, pair.gain, neg_inf))
        cand_gain.index_put_((pid,), minus_inf)
        cand_feature.index_put_((ids,), pair.feature)
        cand_bin.index_put_((ids,), pair.bin)
        cand_dleft.index_put_((ids,), pair.default_left)
        cand_lsum.index_put_((ids,), pair.left_sum)
        cand_rsum.index_put_((ids,), pair.right_sum)
        if cat_args is not None:
            cat_words.index_put_((pid,), words[None])
            cand_cwords.index_put_((ids,), pair.cat_words)
        feature.index_put_((pid,), f.to(i32))
        threshold_bin.index_put_((pid,), t.to(i32))
        default_left.index_put_((pid,), dl)
        left.index_put_((pid,), lid.to(i32))
        right.index_put_((pid,), rid.to(i32))
        cids = torch.where(active, torch.cat([lid, rid]), T)
        sums.index_put_((cids,), torch.stack([lsum, rsum]))
        depth.index_put_((cids,), dchild.expand(2))
        hists.index_put_((ids,), torch.stack([small_hist, big_hist]))
        n_nodes = n_nodes + active.to(i64) * 2

    out = dict(node_of_row=node_of_row, feature=feature[:M],
               threshold_bin=threshold_bin[:M],
               default_left=default_left[:M], left=left[:M], right=right[:M],
               gain=gain[:M], sums=sums[:M], n_nodes=n_nodes)
    if cat_args is not None:
        out["cat_words"] = cat_words[:M]
    return out


def pack_tables(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The node tables of ``_grow_tree_device_body`` as one [..., M, 10 (+
    CW)] f64 tensor, every field exact (u32 words and f32 sums are exact in
    f64), for one host read a tree: feature, threshold_bin, default_left,
    left, right, gain, sums (3), n_nodes, then the set words."""
    d = torch.float64
    m = out["feature"].shape[-1]
    cols = [out[k].to(d)[..., None] for k in
            ("feature", "threshold_bin", "default_left", "left", "right",
             "gain")]
    lead = out["feature"].shape[:-1]
    cols += [out["sums"].to(d),
             out["n_nodes"].to(d).unsqueeze(-1).expand(*lead, m, 1)]
    if "cat_words" in out:
        cols.append(out["cat_words"].to(d))
    return torch.cat(cols, dim=-1)


def tree_from_packed(packed: np.ndarray, config: GrowerConfig, bin_mapper,
                     has_cat: bool) -> Tree:
    """A ``Tree`` from one [M, 10 (+ CW)] block of ``pack_tables``."""
    nn = int(packed[0, 9])
    p = packed[:nn]
    return _finish_tree(p[:, 0], p[:, 1], p[:, 2] != 0, p[:, 3], p[:, 4],
                        p[:, 5], p[:, 6:9], p[:, 10:] if has_cat else None,
                        config, bin_mapper)


def _fused_tables(bins_fm, grad, hess, row_mask, node_of_row,
                  num_bins: int, config: GrowerConfig, feature_mask=None,
                  cat_args=None, reduce: H.Reduce = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tree of ``_grow_tree_device_body`` as (``node_of_row``, its
    ``pack_tables``), both on the device: the fused route's device work."""
    out = _grow_tree_device_body(bins_fm, grad, hess, row_mask, node_of_row,
                                 num_bins, config, feature_mask, cat_args,
                                 reduce=reduce)
    return out["node_of_row"], pack_tables(out)


def _read_tree(rows: torch.Tensor, packed: torch.Tensor,
               config: GrowerConfig, bin_mapper, has_cat: bool
               ) -> Tuple[Tree, torch.Tensor]:
    """The fused route's one host read a tree: (tree, ``rows``)."""
    global host_reads
    host = packed.cpu().numpy()
    host_reads += 1
    return tree_from_packed(host, config, bin_mapper, has_cat), rows


def _grow_tree_fused(bins_fm, grad, hess, row_mask, num_bins: int,
                     config: GrowerConfig, bin_mapper, feature_mask=None,
                     node_of_row=None, cat_args=None, reduce: H.Reduce = None
                     ) -> Tuple[Tree, torch.Tensor]:
    """One tree on the fused route, eagerly (the reference's host wrapper of
    its device grower, sharded with ``reduce``): one host read, of the
    finished tree."""
    return _read_tree(*_fused_tables(bins_fm, grad, hess, row_mask,
                                     node_of_row, num_bins, config,
                                     feature_mask, cat_args, reduce),
                      config, bin_mapper, cat_args is not None)


def sharded_replayer(fn, on_card: bool, mesh=None):
    """``graphs.Replayer`` of a grower step over ``mesh``'s row block (None:
    one process): captured on the card where the mesh's collectives can be
    (``parallel.mesh.collectives_capturable``: NCCL, or none), the mesh's
    ranks agreeing on every capture through the store
    (``parallel.mesh.agree``)."""
    from ..parallel.mesh import agree, collectives_capturable
    from . import graphs

    return graphs.Replayer(
        fn, on_card and collectives_capturable(mesh),
        None if mesh is None else (lambda err: agree(mesh, "capture", err)))


class FusedGrower:
    """The fused route for the trees of one fit over one binned matrix.

    ``grow`` grows a tree as ``_grow_tree_fused`` does. On the card the
    first call runs eagerly, which also warms up every kernel; the second
    captures the whole tree in a CUDA graph over static copies of its
    inputs, and every later call copies its inputs in and replays
    (``graphs.Replayer``, ``run``). On the CPU every call runs eagerly. A
    row-sharded grower (``mesh``: ``bins_fm`` is this process's block; the
    reference's ``_grow_tree_device_sharded``) captures its all-reduces too
    on NCCL, every rank at the same call, and the ranks agree that each
    captured before any replays (``sharded_replayer``); on gloo it runs
    eagerly. A returned ``node_of_row`` of a replay is the graph's own
    output: use it before the next ``grow``."""

    def __init__(self, bins_fm: torch.Tensor, num_bins: int,
                 config: GrowerConfig, bin_mapper, cat_args=None, mesh=None):
        self.config, self.bin_mapper, self.cat_args = config, bin_mapper, \
            cat_args
        reduce = H.shard_reduce(mesh)
        self.run = sharded_replayer(
            lambda g, h, m, fm: _fused_tables(bins_fm, g, h, m, None,
                                              num_bins, config, fm, cat_args,
                                              reduce),
            bins_fm.is_cuda, mesh)

    def grow(self, grad: torch.Tensor, hess: torch.Tensor,
             row_mask: torch.Tensor,
             feature_mask: Optional[torch.Tensor] = None
             ) -> Tuple[Tree, torch.Tensor]:
        return _read_tree(*self.run(grad, hess, row_mask, feature_mask),
                          self.config, self.bin_mapper,
                          self.cat_args is not None)

    def release(self) -> None:
        """Free the tree's CUDA graphs (the fit's end)."""
        self.run.release()
