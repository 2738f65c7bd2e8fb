"""Carry a trained model across from the reference package.

``booster_from_reference`` reads the string the reference's
``Booster.to_string()`` writes (JSON, format ``mmlspark_tpu.gbdt.v1``);
``booster_from_arrays`` builds the same content from numpy arrays. Either
way the port scores a model the JAX package trained — the tests hold the
port's scoring to the reference's on identical trees this way. Categorical
models carry across too: their trees' ``cat_sets`` / ``cat_bin_words`` and
the bin mapper's categorical features and category values. Sparse fits
emit the same trees (raw thresholds), so both carry them too.
``sparse_dataset_from_reference`` carries a reference ``SparseDataset``
(its numpy fields) into the port's. None of them imports the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .binning import BinMapper
from .booster import Booster, TrainParams
from .sparse import SparseDataset
from .tree import Tree

_TREE_FIELDS = ("feature", "threshold", "threshold_bin", "default_left",
                "left", "right", "value", "gain", "count")


def booster_from_reference(model_string: str) -> Booster:
    """The reference's ``Booster.to_string()`` output -> the port's Booster."""
    return Booster.from_string(model_string)


def booster_from_arrays(params: Dict, base_score: Sequence[float],
                        bin_edges: List[np.ndarray],
                        trees: List[List[Dict[str, np.ndarray]]],
                        categorical: Optional[Sequence[bool]] = None,
                        categories: Optional[Dict[int, np.ndarray]] = None
                        ) -> Booster:
    """Build a Booster from arrays: ``params`` (TrainParams fields; unknown
    keys are ignored), ``base_score`` [K], per-feature ascending
    ``bin_edges`` (empty for a categorical feature), and
    ``trees[iteration][class]`` dicts with the Tree node arrays
    (``feature``, ``threshold``, ``threshold_bin``, ``default_left``,
    ``left``, ``right``, ``value``, ``gain``, ``count``; optional
    ``shrinkage``, ``weight``, and for set splits ``cat_sets`` (per node a
    list of category values or None) and ``cat_bin_words`` ([nodes, CW]
    u32)). ``categorical``: which features are categorical (default none);
    ``categories``: feature -> its sorted category values."""
    known = {f.name for f in dataclasses.fields(TrainParams)}
    p = {k: v for k, v in params.items() if k in known}
    for key in ("categorical_feature", "max_bin_by_feature"):
        if key in p:
            p[key] = tuple(p[key])
    tp = TrainParams(**p)
    edges = [np.asarray(e, dtype=np.float64) for e in bin_edges]
    cat = list(categorical) if categorical is not None \
        else [False] * len(edges)
    if len(cat) != len(edges):
        raise ValueError(f"{len(cat)} categorical flags for {len(edges)} "
                         f"features")
    mapper = BinMapper(
        edges=edges, categorical=[bool(c) for c in cat],
        categories={int(f): np.asarray(v, dtype=np.int64)
                    for f, v in (categories or {}).items()},
        max_bin=tp.max_bin)
    groups = []
    for group in trees:
        out = []
        for d in group:
            missing = [f for f in _TREE_FIELDS if f not in d]
            if missing:
                raise KeyError(f"tree arrays lack {missing}")
            t = Tree.from_dict({
                k: (v if k == "cat_sets" else np.asarray(v).tolist())
                for k, v in d.items() if k != "shrinkage"})
            t.shrinkage = float(d.get("shrinkage", 1.0))
            out.append(t)
        groups.append(out)
    return Booster(tp, mapper, trees=groups,
                   base_score=np.asarray(base_score, dtype=np.float64))


def sparse_dataset_from_reference(ds) -> SparseDataset:
    """A reference ``SparseDataset`` (any object with its numpy fields) ->
    the port's, with the same arrays."""
    fields = [f.name for f in dataclasses.fields(SparseDataset)]
    return SparseDataset(**{k: (np.array(getattr(ds, k)) if k != "num_features"
                                else int(ds.num_features)) for k in fields})
