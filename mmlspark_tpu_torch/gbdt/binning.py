"""Quantile feature binning: float matrix -> uint8/int16 bin indices.

Equivalent of LightGBM's Dataset construction (driven by the reference at
lightgbm/LightGBMUtils.scala:199-252 via LGBM_DatasetCreateFromMat): per-feature
quantile-spaced bin edges, reserved bin for missing values, categorical features
binned by value identity.

Binning is a one-time host/device preprocessing step; the binned matrix is what
lives in device HBM during training (4-8x smaller than float32 features).

Copy of the reference's ``mmlspark_tpu/gbdt/binning.py``, with its native
single-sweep shortcuts (``native_loader.bin_column`` for one column,
``bin_matrix`` for a whole numeric matrix) where the reference takes them;
they are bit-equal to the numpy path, which stays as the parity reference
and where the library cannot build. Each use is counted in
``native_loader.uses``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import native_loader


@dataclasses.dataclass
class BinMapper:
    """Per-feature bin edges; maps float features -> integer bins.

    Bin layout per feature (LightGBM convention):
      - bin 0 reserved for missing (NaN)
      - bins 1..num_bins(f)-1 are value bins, upper-edge inclusive
    """

    edges: List[np.ndarray]              # per feature: ascending inner edges
    categorical: List[bool]
    categories: Dict[int, np.ndarray]    # feature -> sorted category values
    max_bin: int = 255

    @property
    def num_features(self) -> int:
        return len(self.edges)

    def num_bins(self, f: int) -> int:
        if self.categorical[f]:
            return len(self.categories[f]) + 1
        return len(self.edges[f]) + 2  # missing + (len+1) value bins

    @property
    def max_num_bins(self) -> int:
        return max((self.num_bins(f) for f in range(self.num_features)), default=1)

    @staticmethod
    def fit(X: np.ndarray, max_bin: int = 255,
            categorical_indexes: Sequence[int] = (),
            sample_cnt: int = 200_000, seed: int = 0,
            max_bin_by_feature: Sequence[int] = ()) -> "BinMapper":
        """Compute quantile edges from (a sample of) the data
        (LightGBM bin_construct_sample_cnt semantics).

        ``max_bin_by_feature``: per-feature bin counts overriding ``max_bin``
        outright — in either direction, like LightGBM's max_bin_by_feature
        (empty = uniform ``max_bin``)."""
        n, num_f = X.shape
        rng = np.random.default_rng(seed)
        if n > sample_cnt:
            idx = rng.choice(n, sample_cnt, replace=False)
            sample = X[idx]
        else:
            sample = X
        cat = set(categorical_indexes)
        caps = list(max_bin_by_feature) if max_bin_by_feature else []
        if caps and len(caps) != num_f:
            raise ValueError(
                f"max_bin_by_feature has {len(caps)} entries for {num_f} "
                f"features")
        edges: List[np.ndarray] = []
        categorical: List[bool] = []
        categories: Dict[int, np.ndarray] = {}
        for f in range(num_f):
            fmax = int(caps[f]) if caps else max_bin
            if not 2 <= fmax <= 65535:
                what = f"max_bin_by_feature[{f}]" if caps else "max_bin"
                raise ValueError(f"{what}={fmax} must be in [2, 65535]")
            col = sample[:, f]
            col = col[~np.isnan(col)]
            if f in cat:
                # inf is not a representable category either: int64 cast of
                # non-finite values is platform-defined (and warns)
                col = col[np.isfinite(col)]
                vals = np.unique(col.astype(np.int64)) if col.size else np.array([0])
                categories[f] = vals[: fmax - 1]
                edges.append(np.empty(0))
                categorical.append(True)
                continue
            categorical.append(False)
            uniq = np.unique(col)
            if len(uniq) <= 1:
                edges.append(np.empty(0))
                continue
            if len(uniq) <= fmax - 1:
                # one bin per distinct value: edges at midpoints
                e = (uniq[:-1] + uniq[1:]) / 2.0
            else:
                qs = np.linspace(0, 1, fmax)[1:-1]
                e = np.unique(np.quantile(col, qs))
            edges.append(e.astype(np.float64))
        return BinMapper(edges, categorical, categories, max_bin)

    def transform_col(self, f: int, col: np.ndarray) -> np.ndarray:
        """One feature column -> int32 bins (0 = missing)."""
        if self.categorical[f]:
            # cast only the FINITE entries: NaN/inf->int64 is a
            # platform-defined cast (and warns); missing stays bin 0, as
            # does any category outside the learned set (LightGBM missing
            # semantics, ref lightgbm/TrainParams.scala)
            cats = self.categories[f]
            out = np.zeros(len(col), dtype=np.int32)
            valid = np.isfinite(col)
            iv = col[valid].astype(np.int64)
            pos = np.clip(np.searchsorted(cats, iv), 0, len(cats) - 1)
            out[valid] = np.where(cats[pos] == iv, pos + 1, 0)
            return out
        edges = self.edges[f]
        if len(edges) >= 8 and len(col) >= 4096 and col.dtype == np.float64:
            # native single-sweep binning (NaN handled in the kernel)
            out = native_loader.bin_column(col, edges)
            if out is not None:
                native_loader.count("bin_column", "native")
                return out
            native_loader.count("bin_column", "numpy")
        miss = np.isnan(col)
        bins = np.searchsorted(edges, col, side="left") + 1
        return np.where(miss, 0, bins).astype(np.int32)

    def transform(self, X: np.ndarray) -> np.ndarray:
        """Float [N,F] -> int32 bins [N,F] (0 = missing)."""
        n, num_f = X.shape
        if num_f != self.num_features:
            # explicit check: under `python -O` a bare assert disappears and
            # mismatched widths would bin silently against wrong edges
            raise ValueError(f"feature count {num_f} != fitted "
                             f"{self.num_features}")
        out = np.zeros((n, num_f), dtype=np.int32)
        for f in range(num_f):
            out[:, f] = self.transform_col(f, X[:, f])
        return out

    def transform_fm(self, X: np.ndarray, dtype=np.int32,
                     n_threads: int = 0) -> np.ndarray:
        """Float [N,F] -> FEATURE-MAJOR bins [F,N] (the device column-store
        layout), binning columns in parallel — np.searchsorted releases the
        GIL."""
        import concurrent.futures
        import os

        n, num_f = X.shape
        if num_f != self.num_features:
            raise ValueError(f"feature count {num_f} != fitted "
                             f"{self.num_features}")
        if (not any(self.categorical) and dtype in (np.uint8, np.int32)
                and X.dtype == np.float64 and n * num_f >= 1 << 18):
            # native whole-matrix pass: streams the row-major X once instead
            # of re-reading the strided matrix per column
            out = native_loader.bin_matrix(X, self.edges, dtype)
            if out is not None:
                native_loader.count("bin_matrix", "native")
                return out
            native_loader.count("bin_matrix", "numpy")
        out = np.empty((num_f, n), dtype=dtype)
        n_threads = n_threads or min(num_f, os.cpu_count() or 1)
        if n_threads <= 1 or n * num_f < 1 << 22:
            for f in range(num_f):
                out[f] = self.transform_col(f, np.ascontiguousarray(X[:, f]))
            return out

        def _one(f):
            out[f] = self.transform_col(f, np.ascontiguousarray(X[:, f]))

        with concurrent.futures.ThreadPoolExecutor(n_threads) as pool:
            list(pool.map(_one, range(num_f)))
        return out

    def bin_upper_value(self, f: int, b: int) -> float:
        """Real-valued threshold for 'bin <= b' splits (used at predict time so the
        model evaluates raw floats, like LightGBM's stored tree thresholds).

        Categorical features: categories are stored sorted ascending, so bin order
        equals value order and 'bin <= b' is exactly 'value <= categories[b-1]'
        (an ordered-split approximation of LightGBM's category subsets; unseen
        categories follow the threshold rather than the missing direction)."""
        if b <= 0:
            return -np.inf
        if self.categorical[f]:
            cats = self.categories[f]
            return float(cats[b - 1]) if b - 1 < len(cats) else np.inf
        e = self.edges[f]
        if b - 1 < len(e):
            return float(e[b - 1])
        return np.inf

    def to_json(self) -> dict:
        return {
            "max_bin": self.max_bin,
            "edges": [e.tolist() for e in self.edges],
            "categorical": list(self.categorical),
            "categories": {str(k): v.tolist() for k, v in self.categories.items()},
        }

    @staticmethod
    def from_json(d: dict) -> "BinMapper":
        return BinMapper(
            edges=[np.asarray(e, dtype=np.float64) for e in d["edges"]],
            categorical=list(d["categorical"]),
            categories={int(k): np.asarray(v, dtype=np.int64)
                        for k, v in d["categories"].items()},
            max_bin=d["max_bin"],
        )
