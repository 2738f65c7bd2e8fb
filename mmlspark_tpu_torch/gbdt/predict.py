"""Tree-ensemble prediction: host f64 path + PyTorch forest traversals.

Counterpart of the reference's ``mmlspark_tpu/gbdt/predict.py``:
``predict_single_tree`` and ``predict_ensemble`` on the host in f64, and
``DeviceEnsemble`` with both of the reference's device traversals as torch
ops:

- **GEMM forest** (default): per row, comparison signs s_i = +-1 for every
  internal node of every tree (one gather + compare), then one matmul
  against the +-1/0 path matrix C[i, l]; a leaf is reached iff (S @ C)[l]
  equals its path length, and its value is picked by that mask.
- **Gather loop**: bounded per-depth gathers over the padded node arrays.

The sign/path product is f32 and must stay full f32 (with TF32 its small
integer sums would still be exact, but PyTorch's default,
``torch.backends.cuda.matmul.allow_tf32 = False``, is what the port relies
on, and ``_full_f32`` holds it for the duration of a traversal). The sum of
the trees' leaf values per class, which the reference takes as
``contrib @ class_onehot``, is taken in one fixed pairwise order
(``_class_sums``), so a row's score has the same bits in a batch of any
size.

``predict_raw`` is a plain loop over row chunks; the fused pipeline
(``core/fusion.py``) scores through ``device_forward`` over its transfer
ring.

Categorical SET nodes (LightGBM semantics: the value truncated to an integer
and tested for membership; members go left, everything else, NaN and unseen
categories included, right) are scored on the host by ``leaf_nodes`` and on
the device by the gather loop over a padded ``[T, m, S]`` f32 table of each
node's category values (NaN fill, which compares false); a set is not a
sign comparison, so a categorical forest has no GEMM form. Where the table
would be large (a set of more than 256 values, or more than 2^27 cells, as
imported LightGBM models can carry), the ensemble scores on the host
instead, as the reference does, and says so in the log.
"""

from __future__ import annotations

import contextlib
import functools
import logging
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..runtime import DeviceLike, resolve_device
from .tree import Tree


def predict_single_tree(tree: Tree, X: np.ndarray) -> np.ndarray:
    """Host path: [N,F] raw floats -> [N] contributions (incl. shrinkage)."""
    return tree.value[leaf_nodes(tree, X)] * tree.shrinkage


def leaf_nodes(tree: Tree, X: np.ndarray) -> np.ndarray:
    """Host path: [N,F] raw floats -> [N] node id of each row's leaf. A set
    node sends a row left iff its value, truncated to an integer, is in the
    set (NaN never is)."""
    n = X.shape[0]
    node = np.zeros(n, dtype=np.int64)
    has_cat = tree.cat_sets is not None
    active = tree.feature[node] != -1
    while active.any():
        cur = node[active]
        f = tree.feature[cur]
        x = X[active, f]
        go_left = np.where(np.isnan(x), tree.default_left[cur],
                           x <= tree.threshold[cur])
        if has_cat:
            for nid in np.unique(cur):
                cset = tree.cat_sets[nid]
                if cset is None:
                    continue
                sel = cur == nid
                xv = x[sel]
                ok = ~np.isnan(xv)
                member = np.zeros(len(xv), dtype=bool)
                member[ok] = np.isin(xv[ok].astype(np.int64), cset)
                go_left[sel] = member
        node[active] = np.where(go_left, tree.left[cur], tree.right[cur])
        active = tree.feature[node] != -1
    return node


def predict_ensemble(tree_groups: List[List[Tree]], X: np.ndarray,
                     num_class: int) -> np.ndarray:
    """[iterations][class] trees -> [N, num_class] raw score deltas, f64 on
    the host (the parity reference for the device traversals).

    A numeric forest takes the native C++ traversal
    (``native_loader.forest_predict_f64``), f64 end to end and bit-equal to
    the per-tree numpy loop below, which stays for categorical forests,
    where the library cannot build, and as the parity reference;
    ``MMLSPARK_TPU_NO_NATIVE_PREDICT=1`` turns the native route off, as in
    the reference."""
    import os

    trees = [t for g in tree_groups for t in g]
    if (trees and not any(t.cat_sets is not None for t in trees)
            and os.environ.get("MMLSPARK_TPU_NO_NATIVE_PREDICT",
                               "") in ("", "0")):
        from .. import native_loader

        res = native_loader.forest_predict_f64(
            np.asarray(X), *padded_forest_f64(tree_groups), num_class)
        if res is not None:
            native_loader.count("forest_predict_f64", "native")
            return res
        native_loader.count("forest_predict_f64", "numpy")
    out = np.zeros((X.shape[0], num_class), dtype=np.float64)
    for group in tree_groups:
        for k, tree in enumerate(group):
            out[:, k] += predict_single_tree(tree, X)
    return out


def pad_soa(vals, fill, dtype, T: int, m: int) -> np.ndarray:
    """[T, m] padded struct-of-arrays field."""
    arr = np.full((T, m), fill, dtype=dtype)
    for i, v in enumerate(vals):
        arr[i, :len(v)] = v
    return arr


def padded_forest_f64(tree_groups: List[List[Tree]]):
    """[T, m] padded node arrays (f64 thresholds, values pre-scaled by
    shrinkage) and each tree's class, for the native host traversal."""
    trees = [t for g in tree_groups for t in g]
    m = max(len(t.feature) for t in trees)
    T = len(trees)
    return (pad_soa([t.feature for t in trees], -1, np.int32, T, m),
            pad_soa([t.threshold for t in trees], 0.0, np.float64, T, m),
            pad_soa([t.default_left for t in trees], True, bool, T, m),
            pad_soa([t.left for t in trees], 0, np.int32, T, m),
            pad_soa([t.right for t in trees], 0, np.int32, T, m),
            pad_soa([np.asarray(t.value) * t.shrinkage for t in trees],
                    0.0, np.float64, T, m),
            np.array([k for g in tree_groups for k in range(len(g))],
                     dtype=np.int32))


@contextlib.contextmanager
def _full_f32() -> Iterator[None]:
    """Full-f32 CUDA matmuls for the enclosed block (TF32 off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _tree_depth(tree: Tree) -> int:
    depth = np.zeros(len(tree.feature), dtype=np.int32)
    for i in range(len(tree.feature)):  # parents precede children
        if tree.feature[i] != -1:
            depth[tree.left[i]] = depth[i] + 1
            depth[tree.right[i]] = depth[i] + 1
    return int(depth.max()) + 1 if len(depth) else 1


class DeviceEnsemble:
    """All trees padded into one set of tensors; one traversal scores the
    forest. ``impl`` picks the default traversal: ``"gemm"`` (the default,
    unless the path matrix would pass 2^27 cells, as in the reference) or
    ``"gather"``; both are exact, so both give the same scores.

    The host layouts of both traversals are built at construction; their
    device tensors are built on first use. ``remap_ensemble``
    (``gather_kernel.py``) derives an ensemble over compacted columns by
    rewriting the host feature ids."""

    #: max rows per traversal call
    GEMM_ROW_CHUNK = 1 << 16

    #: a categorical forest scores on the host past these table sizes
    CAT_SET_MAX = 256
    CAT_CELLS_MAX = 1 << 27

    def __init__(self, tree_groups: List[List[Tree]], num_class: int,
                 device: DeviceLike = None, impl: str = "gemm"):
        if impl not in ("gemm", "gather"):
            raise ValueError(f"impl must be 'gemm' or 'gather', got {impl!r}")
        trees = [t for g in tree_groups for t in g]
        self.device = resolve_device(device)
        self.impl = impl
        self.num_class = num_class
        self.num_trees = len(trees)
        self.row_chunk = self.GEMM_ROW_CHUNK
        self._dev: Dict[str, Tuple[torch.Tensor, ...]] = {}
        self._gemm = None
        self.cat_vals = self.is_cat = None
        self.cat_host_fallback = False
        self._tree_groups = tree_groups
        if not trees:
            return
        class_of_tree = np.array(
            [k for g in tree_groups for k in range(len(g))], dtype=np.int64)
        self._class_order = _class_order(class_of_tree, num_class)
        T, m = self.num_trees, max(len(t.feature) for t in trees)
        self.depth = max(max(_tree_depth(t) for t in trees), 1)
        self.feature = pad_soa([t.feature for t in trees], -1, np.int64, T, m)
        self.threshold = pad_soa([t.threshold for t in trees], 0.0,
                                 np.float32, T, m)
        self.default_left = pad_soa([t.default_left for t in trees], True,
                                    bool, T, m)
        self.left = pad_soa([t.left for t in trees], 0, np.int64, T, m)
        self.right = pad_soa([t.right for t in trees], 0, np.int64, T, m)
        self.value = pad_soa([np.asarray(t.value) * t.shrinkage for t in trees],
                             0.0, np.float32, T, m)
        if any(t.cat_sets is not None for t in trees):
            self._build_cat(trees, m)
            self.impl = "gather"
            return
        self._build_gemm(trees)
        if self._gemm is None:
            self.impl = "gather"

    def _build_cat(self, trees: List[Tree], m: int) -> None:
        """The [T, m, S] f32 category values of every set node (NaN fill)
        and the [T, m] set-node flags; or, past ``CAT_SET_MAX`` values in
        one set or ``CAT_CELLS_MAX`` cells, the host traversal. The row
        chunk keeps the gather's [rows, T, S] membership test near 1.5 GB."""
        T = self.num_trees
        smax = max((len(s) for t in trees if t.cat_sets is not None
                    for s in t.cat_sets if s is not None), default=1)
        if smax > self.CAT_SET_MAX or T * m * smax > self.CAT_CELLS_MAX:
            self.cat_host_fallback = True
            logging.getLogger(__name__).warning(
                "categorical forest scored on the host: its largest set "
                "holds %d values over %d trees x %d nodes (device table "
                "limits: %d values, %d cells)", smax, T, m,
                self.CAT_SET_MAX, self.CAT_CELLS_MAX)
            return
        cv = np.full((T, m, smax), np.nan, dtype=np.float32)
        ic = np.zeros((T, m), dtype=bool)
        for i, t in enumerate(trees):
            if t.cat_sets is None:
                continue
            for nid, cset in enumerate(t.cat_sets):
                if cset is not None:
                    cv[i, nid, :len(cset)] = cset
                    ic[i, nid] = True
        self.cat_vals, self.is_cat = cv, ic
        chunk = int(1.5e9 // max(T * smax * 8, 1))
        self.row_chunk = max(256, min(self.GEMM_ROW_CHUNK,
                                      (chunk // 256) * 256))

    def _build_gemm(self, trees: List[Tree]) -> None:
        """Per-tree padded GEMM layout: comparison-sign x path-matrix
        forest evaluation (module docstring). Host-built once; skipped, as
        in the reference, when the [T, I, L] path matrix would pass 2^27
        cells."""
        T = self.num_trees
        i_max = max(max(int((t.feature >= 0).sum()) for t in trees), 1)
        l_max = max(max(t.num_leaves for t in trees), 1)
        if T * i_max * l_max > 1 << 27:
            return
        # activations scale with rows x T x (I + L): bound one call at ~1.5 GB
        per_row = T * (6 * i_max + 8 * l_max)
        chunk = int(1.5e9 // max(per_row, 1))
        self.row_chunk = max(256, min(self.GEMM_ROW_CHUNK,
                                      (chunk // 256) * 256))
        feat = np.zeros((T, i_max), dtype=np.int64)
        thr = np.zeros((T, i_max), dtype=np.float32)
        dl = np.zeros((T, i_max), dtype=bool)
        ivalid = np.zeros((T, i_max), dtype=np.float32)
        C = np.zeros((T, i_max, l_max), dtype=np.float32)
        plen = np.full((T, l_max), -1.0, dtype=np.float32)  # pad unreachable
        lval = np.zeros((T, l_max), dtype=np.float32)
        for ti, t in enumerate(trees):
            int_ids = np.nonzero(t.feature >= 0)[0]
            int_index = {int(nid): i for i, nid in enumerate(int_ids)}
            feat[ti, : len(int_ids)] = t.feature[int_ids]
            thr[ti, : len(int_ids)] = t.threshold[int_ids]
            dl[ti, : len(int_ids)] = t.default_left[int_ids]
            ivalid[ti, : len(int_ids)] = 1.0
            li = 0
            stack = [(0, [])]
            while stack:
                nid, path = stack.pop()
                if t.feature[nid] == -1:
                    for ii, sign in path:
                        C[ti, ii, li] = sign
                    plen[ti, li] = float(len(path))
                    lval[ti, li] = float(t.value[nid]) * t.shrinkage
                    li += 1
                else:
                    ii = int_index[int(nid)]
                    stack.append((int(t.left[nid]), path + [(ii, 1.0)]))
                    stack.append((int(t.right[nid]), path + [(ii, -1.0)]))
        self._gemm = (feat, thr, dl, ivalid, C, plen, lval)

    def _tensors(self, layout: str) -> Tuple[torch.Tensor, ...]:
        """The device tensors of one layout (``"gemm"``, ``"gather"`` or
        ``"classes"``), moved from the host arrays on first use."""
        if layout not in self._dev:
            if layout == "gemm":
                host = self._gemm
            elif layout == "gather":
                host = (self.feature, self.threshold, self.default_left,
                        self.left, self.right, self.value)
            elif layout == "cat":
                host = (self.cat_vals, self.is_cat)
            else:
                host = (self._class_order,)
            self._dev[layout] = tuple(torch.as_tensor(a, device=self.device)
                                      for a in host)
        return self._dev[layout]

    def _class_sums(self, contrib: torch.Tensor) -> torch.Tensor:
        """[N, T] per-tree leaf values -> [N, K] class sums, added in one
        fixed order: the trees of each class, zero-padded to a power of two,
        summed pairwise by halving. Every step is an elementwise add, so a
        row's sum has the same bits whatever the batch shape (a matmul
        against a class one-hot may pick another reduction order for
        another N), and the fused 256-row batches agree bitwise with the
        unfused 65,536-row chunks."""
        (order,) = self._tensors("classes")
        padded = torch.cat([contrib, contrib.new_zeros(contrib.shape[0], 1)],
                           dim=1)
        c = padded[:, order]                               # [N, K, P]
        while c.shape[2] > 1:
            half = c.shape[2] // 2
            c = c[:, :, :half] + c[:, :, half:]
        return c[:, :, 0]

    def _forward_gemm(self, X: torch.Tensor) -> torch.Tensor:
        feat, thr, dl, ivalid, C, plen, lval = self._tensors("gemm")
        x_sel = X[:, feat]                                 # [N, T, I]
        s = torch.where(torch.isnan(x_sel),
                        torch.where(dl[None], 1.0, -1.0),
                        torch.where(x_sel <= thr[None], 1.0, -1.0))
        s = s * ivalid[None]                               # pad ints -> 0
        # z[n, t, l] = sum_i s * C: small integers, exact in f32
        z = torch.einsum("nti,til->ntl", s, C)
        reach = (z == plen[None]).to(torch.float32)
        # one leaf per tree is reached: a sum of one value and zeros, exact
        contrib = torch.sum(reach * lval[None], dim=2)    # [N, T]
        return self._class_sums(contrib)                   # [N, K]

    def _forward_gather(self, X: torch.Tensor) -> torch.Tensor:
        feature, threshold, default_left, left, right, value = \
            self._tensors("gather")
        n, t = X.shape[0], self.num_trees
        cat = self._tensors("cat") if self.cat_vals is not None else None
        node = torch.zeros((n, t), dtype=torch.int64, device=X.device)
        t_idx = torch.arange(t, device=X.device)[None, :]
        for _ in range(self.depth):
            f = feature[t_idx, node]                       # [N, T]
            x = torch.gather(X, 1, torch.clamp(f, min=0))
            go_left = torch.where(torch.isnan(x),
                                  default_left[t_idx, node],
                                  x <= threshold[t_idx, node])
            if cat is not None:
                # set membership: truncated value equal to one of the node's
                # values (NaN fill and NaN inputs compare false -> right)
                member = torch.any(torch.trunc(x)[:, :, None]
                                   == cat[0][t_idx, node], dim=-1)
                go_left = torch.where(cat[1][t_idx, node], member, go_left)
            nxt = torch.where(go_left, left[t_idx, node], right[t_idx, node])
            node = torch.where(f == -1, node, nxt)
        return self._class_sums(value[t_idx, node])

    def _forward(self, impl: str, X: torch.Tensor) -> torch.Tensor:
        with _full_f32():
            if impl == "gemm":
                return self._forward_gemm(X)
            return self._forward_gather(X)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        """[N, F] f32 tensor on the ensemble's device -> [N, K] f32 raw
        scores, through the default traversal."""
        return self._forward(self.impl, X)

    def device_forward(self, params=None
                       ) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
        """The forest traversal ``X [N, F] f32 -> [N, K] f32`` for pipeline
        fusion, or None for an empty forest: the same torch ops
        ``predict_raw`` runs, so a fused segment's scores are
        bitwise-equal to the unfused ones.

        ``params`` (a kernel-variant params dict, see ``core.kernels``)
        selects the traversal: ``{"impl": "gather"}`` forces the gather
        loop; ``{"impl": "gemm"}`` and None keep the default routing. Both
        are exact, so every variant gives the same bits. None too for a
        categorical forest scored on the host (``cat_host_fallback``)."""
        if self.num_trees == 0 or self.cat_host_fallback:
            return None
        impl = "gather" if params and params.get("impl") == "gather" \
            else self.impl
        return functools.partial(self._forward, impl)

    def predict_raw(self, X: np.ndarray) -> np.ndarray:
        """[N, F] floats -> [N, num_class] summed tree outputs (f64 host
        array), scored on the device in chunks of ``row_chunk`` rows."""
        n = X.shape[0]
        if self.num_trees == 0:
            return np.zeros((n, self.num_class), dtype=np.float64)
        if self.cat_host_fallback:
            return predict_ensemble(self._tree_groups, np.asarray(X),
                                    self.num_class)
        Xf = np.ascontiguousarray(X, dtype=np.float32)
        outs = []
        for r0 in range(0, n, self.row_chunk):
            xc = torch.as_tensor(Xf[r0: r0 + self.row_chunk],
                                 device=self.device)
            outs.append(self.forward(xc).double().cpu().numpy())
        return (np.concatenate(outs, axis=0) if outs
                else np.zeros((0, self.num_class), dtype=np.float64))


def _class_order(class_of_tree: np.ndarray, num_class: int) -> np.ndarray:
    """[K, P] tree indices of each class in tree order, padded to a power of
    two P with index T (the zero column ``_class_sums`` appends)."""
    T = len(class_of_tree)
    per_class = [np.flatnonzero(class_of_tree == k) for k in range(num_class)]
    width = max(max(len(ix) for ix in per_class), 1)
    p = 1 << (width - 1).bit_length()
    order = np.full((num_class, p), T, dtype=np.int64)
    for k, ix in enumerate(per_class):
        order[k, :len(ix)] = ix
    return order
