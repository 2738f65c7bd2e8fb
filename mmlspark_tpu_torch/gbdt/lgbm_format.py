"""LightGBM text-model interchange: export and import the ``v3`` model string.

Counterpart of the reference's ``mmlspark_tpu/gbdt/lgbm_format.py``, line
for line, so the two packages write byte-identical text for the same
Booster and each reads the other's:

  - ``to_lightgbm_string(booster)``: a trained Booster in the LightGBM ``v3``
    text format (what ``LGBM_BoosterSaveModelToString`` writes). Base scores
    are folded into the first iteration's leaf values, so the sum of leaf
    outputs, LightGBM's prediction, reproduces this engine's raw scores.
  - ``from_lightgbm_string(text)``: a LightGBM model string (this package's
    or LightGBM's own) into a Booster that scores through the port's host
    and device traversals; ``parse_model_string`` also takes the Booster's
    JSON, as ``modelString`` does.

Format notes (LightGBM's tree serialization):
  - Internal nodes and leaves are numbered apart; a negative child id ``c``
    in left_child/right_child means leaf ``~c``.
  - ``decision_type`` is a bit field: bit0 = categorical, bit1 =
    default-left, bits2-3 = missing type (0=None, 1=Zero, 2=NaN).
  - Numerical rule: value <= threshold goes left; NaN goes the default
    direction when the missing type is NaN, else it is read as 0.
  - ``leaf_value`` already includes shrinkage; prediction is a plain sum.

Categorical set splits go through LightGBM's num_cat machinery:
``cat_boundaries``/``cat_threshold`` bitsets over category VALUES (members
go left, missing and unseen categories right), both ways; negative
categories cannot be written. Linear trees, unknown versions and malformed
categorical blocks are rejected.
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Sequence

import numpy as np

from .booster import Booster, TrainParams
from .tree import Tree

_MISSING_NAN = 2 << 2        # missing_type NaN in bits 2-3
_DEFAULT_LEFT = 2            # kDefaultLeftMask
_CATEGORICAL = 1             # kCategoricalMask


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


def _objective_string(params: TrainParams) -> str:
    obj = params.objective
    if obj == "binary":
        return "binary sigmoid:1"
    if obj == "multiclass":
        return f"multiclass num_class:{params.num_class}"
    if obj == "lambdarank":
        return "lambdarank"
    if obj in ("regression", "regression_l2", "l2", "mean_squared_error"):
        return "regression"
    if obj in ("regression_l1", "l1", "mae"):
        return "regression_l1"
    return obj


def _fmt(x: float) -> str:
    """LightGBM writes %.17g doubles; repr-style shortest is compatible."""
    return np.format_float_positional(
        float(x), unique=True, trim="0") if np.isfinite(x) else str(float(x))


def _tree_block(tree: Tree, index: int, fold_bias: float = 0.0) -> str:
    """Serialize one Tree to a LightGBM `Tree=N` block.

    Node mapping: our flat nodes with feature >= 0 become internal nodes
    (in node-id order, so the root stays index 0 — the same order LightGBM
    assigns, split creation order); feature == -1 nodes become leaves.
    """
    feat = tree.feature
    is_leaf = feat == -1
    n_nodes = len(feat)
    internal_ids = np.nonzero(~is_leaf)[0]
    leaf_ids = np.nonzero(is_leaf)[0]
    int_index = {int(nid): i for i, nid in enumerate(internal_ids)}
    leaf_index = {int(nid): i for i, nid in enumerate(leaf_ids)}

    def child_ref(nid: int) -> int:
        return int_index[nid] if not is_leaf[nid] else ~leaf_index[nid]

    # categorical SET splits -> LightGBM's num_cat machinery: per cat node,
    # a bitset over category VALUES (FindInBitset(cat_threshold +
    # cat_boundaries[cat_idx]) in LightGBM's CategoricalDecision)
    cat_idx_of_node = {}
    cat_boundaries = [0]
    cat_words_out: list = []
    if tree.cat_sets is not None:
        for nid in internal_ids:
            s = tree.cat_sets[int(nid)]
            if s is None:
                continue
            if (s < 0).any():
                raise ValueError(
                    "cannot serialize categorical split with negative "
                    "category values to the LightGBM format (its bitsets "
                    "are over non-negative ints); re-encode with "
                    "ValueIndexer first")
            mx = int(s.max())
            if mx >= 1 << 22:
                raise ValueError(
                    f"category value {mx} too large for a LightGBM bitset "
                    f"(> 2^22); re-encode with ValueIndexer first")
            w = np.zeros(mx // 32 + 1, dtype=np.uint32)
            np.bitwise_or.at(w, (s // 32).astype(np.int64),
                             np.uint32(1) << (s % 32).astype(np.uint32))
            cat_idx_of_node[int(nid)] = len(cat_boundaries) - 1
            cat_boundaries.append(cat_boundaries[-1] + len(w))
            cat_words_out.append(w)

    num_leaves = len(leaf_ids)
    lines = [f"Tree={index}", f"num_leaves={num_leaves}",
             f"num_cat={len(cat_words_out)}"]

    def node_weight(nid: int) -> str:
        # real hessian sums when the trainer recorded them (LightGBM uses
        # leaf_weight for refit/contrib); row counts only as legacy fallback
        if tree.weight is not None:
            return _fmt(float(tree.weight[nid]))
        return str(int(tree.count[nid]))

    if num_leaves == 1:
        # stump: LightGBM still writes one leaf_value row
        lines += [
            "split_feature=", "split_gain=", "threshold=", "decision_type=",
            "left_child=", "right_child=",
            "leaf_value=" + _fmt(tree.value[0] * tree.shrinkage + fold_bias),
            "leaf_weight=" + node_weight(0),
            "leaf_count=" + str(int(tree.count[0])),
            "internal_value=", "internal_weight=", "internal_count=",
            f"shrinkage={_fmt(tree.shrinkage)}",
        ]
        return "\n".join(lines) + "\n"

    sf, sg, th, dt, lc, rc = [], [], [], [], [], []
    for nid in internal_ids:
        sf.append(str(int(feat[nid])))
        sg.append(_fmt(float(tree.gain[nid])))
        if int(nid) in cat_idx_of_node:
            # categorical: threshold holds the cat_idx; decision_type is
            # the categorical bit (missing type None, no default-left)
            th.append(str(cat_idx_of_node[int(nid)]))
            dt.append(str(_CATEGORICAL))
        else:
            th.append(_fmt(float(tree.threshold[nid])))
            d = _MISSING_NAN | (_DEFAULT_LEFT if tree.default_left[nid]
                                else 0)
            dt.append(str(d))
        lc.append(str(child_ref(int(tree.left[nid]))))
        rc.append(str(child_ref(int(tree.right[nid]))))
    lv = [_fmt(float(tree.value[nid]) * tree.shrinkage + fold_bias)
          for nid in leaf_ids]
    lcount = [str(int(tree.count[nid])) for nid in leaf_ids]
    lw = [node_weight(int(nid)) for nid in leaf_ids]
    iv = [_fmt(0.0) for _ in internal_ids]
    iw = [node_weight(int(nid)) for nid in internal_ids]
    ic = [str(int(tree.count[nid])) for nid in internal_ids]

    lines += [
        "split_feature=" + " ".join(sf),
        "split_gain=" + " ".join(sg),
        "threshold=" + " ".join(th),
        "decision_type=" + " ".join(dt),
        "left_child=" + " ".join(lc),
        "right_child=" + " ".join(rc),
    ]
    if cat_words_out:
        lines += [
            "cat_boundaries=" + " ".join(str(b) for b in cat_boundaries),
            "cat_threshold=" + " ".join(
                str(int(w)) for ws in cat_words_out for w in ws),
        ]
    lines += [
        "leaf_value=" + " ".join(lv),
        "leaf_weight=" + " ".join(lw),
        "leaf_count=" + " ".join(lcount),
        "internal_value=" + " ".join(iv),
        "internal_weight=" + " ".join(iw),
        "internal_count=" + " ".join(ic),
        f"shrinkage={_fmt(tree.shrinkage)}",
    ]
    return "\n".join(lines) + "\n"


def to_lightgbm_string(booster: Booster,
                       feature_names: Optional[Sequence[str]] = None) -> str:
    """Serialize a Booster to the LightGBM v3 text model format."""
    params = booster.params
    k = max(params.num_class, 1)
    num_f = booster.bin_mapper.num_features if booster.bin_mapper else (
        max((int(t.feature.max()) + 1 if (t.feature >= 0).any() else 1)
            for g in booster.trees for t in g) if booster.trees else 1)
    names = list(feature_names) if feature_names else [
        f"Column_{i}" for i in range(num_f)]
    if len(names) != num_f:
        raise ValueError(f"{len(names)} feature names for {num_f} features")

    infos = []
    for i in range(num_f):
        mapper = booster.bin_mapper
        if mapper is not None and not mapper.categorical[i] \
                and len(mapper.edges[i]):
            e = mapper.edges[i]
            infos.append(f"[{_fmt(e[0])}:{_fmt(e[-1])}]")
        else:
            infos.append("none")

    blocks: List[str] = []
    idx = 0
    for it, group in enumerate(booster.trees):
        for kk, tree in enumerate(group):
            bias = float(booster.base_score[kk]) if it == 0 else 0.0
            blocks.append(_tree_block(tree, idx, fold_bias=bias))
            idx += 1

    out = io.StringIO()
    out.write("tree\n")
    out.write("version=v3\n")
    out.write(f"num_class={k}\n")
    out.write(f"num_tree_per_iteration={k}\n")
    out.write("label_index=0\n")
    out.write(f"max_feature_idx={num_f - 1}\n")
    out.write(f"objective={_objective_string(params)}\n")
    out.write("feature_names=" + " ".join(names) + "\n")
    out.write("feature_infos=" + " ".join(infos) + "\n")
    out.write("tree_sizes=" + " ".join(
        str(len(b.encode("utf-8")) + 1) for b in blocks) + "\n\n")
    for b in blocks:
        out.write(b)
        out.write("\n\n")
    out.write("end of trees\n\n")
    imp = booster.feature_importances("split") if booster.bin_mapper else None
    out.write("feature importances:\n")
    if imp is not None:
        order = np.argsort(-imp)
        for i in order:
            if imp[i] > 0:
                out.write(f"{names[i]}={int(imp[i])}\n")
    out.write("\nparameters:\n")
    out.write(f"[boosting: {params.boosting_type}]\n")
    out.write(f"[objective: {params.objective}]\n")
    out.write(f"[learning_rate: {params.learning_rate}]\n")
    out.write(f"[num_leaves: {params.num_leaves}]\n")
    out.write(f"[max_bin: {params.max_bin}]\n")
    out.write(f"[num_iterations: {params.num_iterations}]\n")
    out.write("\nend of parameters\n\n")
    out.write("pandas_categorical:null\n")
    return out.getvalue()


# ---------------------------------------------------------------------------
# Import
# ---------------------------------------------------------------------------


def _parse_header(text: str) -> Dict[str, str]:
    head: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Tree="):
            break
        if "=" in line:
            key, val = line.split("=", 1)
            head[key] = val
    return head


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split()] if s else [],
                    dtype=np.float64)


def _ints(s: str) -> np.ndarray:
    return np.array([int(x) for x in s.split()] if s else [], dtype=np.int64)


def _parse_tree(block: Dict[str, str]) -> Tree:
    num_leaves = int(block["num_leaves"])
    num_cat = int(block.get("num_cat", "0") or 0)
    cat_boundaries = _ints(block.get("cat_boundaries", "")) \
        if num_cat else None
    cat_threshold_words = _ints(block.get("cat_threshold", "")) \
        if num_cat else None
    if int(block.get("is_linear", "0") or 0):
        raise ValueError(
            "linear-tree models (is_linear=1) are not supported: leaves hold "
            "linear models, not constants — retrain without linear_tree")
    leaf_value = _floats(block["leaf_value"])
    leaf_count = _ints(block.get("leaf_count", "")) \
        if block.get("leaf_count") else np.zeros(num_leaves, dtype=np.int64)
    leaf_weight = _floats(block["leaf_weight"]) \
        if block.get("leaf_weight") else None
    int_weight = _floats(block["internal_weight"]) \
        if block.get("internal_weight") else None

    if num_leaves == 1:
        return Tree(
            feature=np.array([-1], dtype=np.int32),
            threshold=np.zeros(1), threshold_bin=np.zeros(1, dtype=np.int32),
            default_left=np.ones(1, dtype=bool),
            left=np.array([-1], dtype=np.int32),
            right=np.array([-1], dtype=np.int32),
            value=leaf_value[:1].astype(np.float64),
            gain=np.zeros(1, dtype=np.float32),
            count=leaf_count[:1].astype(np.int32),
            shrinkage=1.0,  # leaf_value already includes it
            weight=(leaf_weight[:1].astype(np.float64)
                    if leaf_weight is not None else None),
        )

    n_int = num_leaves - 1
    split_feature = _ints(block["split_feature"])
    threshold = _floats(block["threshold"])
    decision_type = _ints(block.get("decision_type", "")) \
        if block.get("decision_type") else np.zeros(n_int, dtype=np.int64)
    left_child = _ints(block["left_child"])
    right_child = _ints(block["right_child"])
    split_gain = _floats(block.get("split_gain", "")) \
        if block.get("split_gain") else np.zeros(n_int)
    int_count = _ints(block.get("internal_count", "")) \
        if block.get("internal_count") else np.zeros(n_int, dtype=np.int64)

    is_cat_node = (decision_type & _CATEGORICAL) != 0
    if is_cat_node.any() and (cat_boundaries is None or not len(cat_boundaries)
                              or cat_threshold_words is None
                              or not len(cat_threshold_words)):
        raise ValueError(
            "categorical decision_type bit set but the tree block carries "
            "no cat_boundaries/cat_threshold")

    # flatten: internal node i -> flat i; leaf j -> flat n_int + j
    n_nodes = n_int + num_leaves
    feature = np.full(n_nodes, -1, dtype=np.int32)
    thr = np.zeros(n_nodes, dtype=np.float64)
    dleft = np.ones(n_nodes, dtype=bool)
    left = np.full(n_nodes, -1, dtype=np.int32)
    right = np.full(n_nodes, -1, dtype=np.int32)
    value = np.zeros(n_nodes, dtype=np.float64)
    gain = np.zeros(n_nodes, dtype=np.float32)
    count = np.zeros(n_nodes, dtype=np.int32)

    def flat(c: int) -> int:
        return int(c) if c >= 0 else n_int + (~int(c))

    feature[:n_int] = split_feature
    thr[:n_int] = threshold
    # NaN routing by missing type (tree.h bits 2-3). Our predict sends NaN to
    # default_left, so translate each type into the direction NaN actually
    # takes in LightGBM: NaN type -> the stored default bit; None type ->
    # NaN is coerced to 0.0 and compared (left iff 0 <= threshold); Zero
    # type -> 0-as-missing goes the default direction, NaN included.
    missing_type = (decision_type >> 2) & 3
    stored_default = (decision_type & _DEFAULT_LEFT) != 0
    if (missing_type == 1).any():
        # Zero type: LightGBM sends exact-0.0 feature values the default
        # (missing) direction; this engine only applies the default bit to
        # NaN, so 0.0 compares against the threshold instead. Models with
        # Zero missing type typically come from sparse training data.
        import warnings

        warnings.warn(
            "importing a LightGBM model with missing_type=Zero: exact-0.0 "
            "feature values follow the threshold compare here, not the "
            "stored default direction — predictions can differ from "
            "LightGBM for rows with zero-valued features at those splits",
            RuntimeWarning, stacklevel=4)
    dleft[:n_int] = np.where(missing_type == 0, 0.0 <= threshold,
                             stored_default)
    left[:n_int] = [flat(c) for c in left_child]
    right[:n_int] = [flat(c) for c in right_child]
    gain[:n_int] = split_gain.astype(np.float32)
    count[:n_int] = int_count
    value[n_int:] = leaf_value
    count[n_int:] = leaf_count

    cat_sets = None
    if is_cat_node.any():
        cat_sets = [None] * n_nodes
        for i in np.nonzero(is_cat_node)[0]:
            ci = int(threshold[i])
            w = cat_threshold_words[
                int(cat_boundaries[ci]): int(cat_boundaries[ci + 1])]
            bits = np.unpackbits(
                w.astype(np.uint32).view(np.uint8), bitorder="little")
            cat_sets[int(i)] = np.nonzero(bits)[0].astype(np.int64)
            thr[int(i)] = 0.0           # threshold held the cat_idx
            dleft[int(i)] = False       # missing/unseen -> right
    weight = None
    if leaf_weight is not None and len(leaf_weight) == num_leaves:
        weight = np.zeros(n_nodes, dtype=np.float64)
        weight[n_int:] = leaf_weight
        if int_weight is not None and len(int_weight) == n_int:
            weight[:n_int] = int_weight
    return Tree(feature=feature, threshold=thr,
                threshold_bin=np.zeros(n_nodes, dtype=np.int32),
                default_left=dleft, left=left, right=right, value=value,
                gain=gain, count=count, shrinkage=1.0, weight=weight,
                cat_sets=cat_sets)


def parse_model_string(text: str) -> Booster:
    """Accept either model-string format: the LightGBM v3 text model (as
    written by save_native_model / any LightGBM runtime) or this engine's
    internal JSON — the reference's setModelString init-model path accepts
    its native string (LightGBMBase.scala:26-39)."""
    if is_lightgbm_string(text):
        return from_lightgbm_string(text)
    return Booster.from_string(text)


def is_lightgbm_string(text: str) -> bool:
    """True when the string looks like a LightGBM text model (vs the internal
    JSON format)."""
    head = text.lstrip()[:16].splitlines()
    return bool(head) and head[0].strip() == "tree"


def from_lightgbm_string(text: str) -> Booster:
    """Parse a LightGBM v3 text model into a Booster (predict-ready).

    Leaf values keep LightGBM semantics: the prediction is the plain sum of
    per-tree leaf outputs (shrinkage/init score already folded in), so
    ``base_score`` is zero and every imported tree has shrinkage 1.0.
    """
    if not is_lightgbm_string(text):
        raise ValueError("not a LightGBM model string (missing 'tree' magic)")
    head = _parse_header(text)
    version = head.get("version", "")
    # Version gate, explicit: v2/v3/v4 share the tree-block fields this
    # parser reads (v4 added linear trees, rejected per-tree below). An
    # unknown version means fields we have never seen — fail loudly instead
    # of silently misparsing.
    if version not in ("v2", "v3", "v4"):
        raise ValueError(
            f"unsupported LightGBM model version {version!r}: this parser "
            f"handles v2/v3/v4 text models")
    if int(head.get("linear_tree", "0") or 0):
        raise ValueError(
            "linear-tree models (linear_tree=1) are not supported: leaves "
            "hold linear models, not constants — retrain without linear_tree")
    k = int(head.get("num_class", "1"))
    obj_field = head.get("objective", "regression").split()
    objective = obj_field[0] if obj_field else "regression"
    if objective == "multiclassova":
        objective = "multiclass"

    body = text.split("end of trees")[0]
    blocks: List[Dict[str, str]] = []
    cur: Optional[Dict[str, str]] = None
    for line in body.splitlines():
        line = line.strip()
        if line.startswith("Tree="):
            cur = {}
            blocks.append(cur)
        elif cur is not None and "=" in line:
            key, val = line.split("=", 1)
            cur[key] = val
    trees = [_parse_tree(b) for b in blocks]

    if k > 1 and len(trees) % k != 0:
        raise ValueError(
            f"{len(trees)} trees is not a multiple of num_class={k}")
    groups = [trees[i: i + k] for i in range(0, len(trees), k)]

    params = TrainParams(
        objective=objective,
        num_class=k if k > 1 else 1,
        num_iterations=len(groups),
    )
    return Booster(params, bin_mapper=None, trees=groups,
                   base_score=np.zeros(max(k, 1)))
