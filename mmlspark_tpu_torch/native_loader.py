"""Build, load and call the port's native C++ library (host code).

Counterpart of the reference's ``mmlspark_tpu/native_loader.py``. The port
keeps its own copy of the source, ``native_src/mmlspark_native.cpp`` (ABI
version 5, the reference's), and builds it with g++ on first use into
``native/`` under the kernels' build directory (``_kernels.build_dir()``,
gitignored), with the reference's flags: ``-ffp-contract=off`` keeps the
predict paths bit-equal to their numpy versions. The build lands under a
temporary name and is renamed into place (concurrent processes never load a
half-written file); a library that does not load or reports another ABI is
rebuilt once. The file name carries the ABI and a tag of the host CPU's
features (the build is ``-march=native``).

Consumers, in the reference's places, each counted per function and route
in ``uses`` (``"native"`` or ``"numpy"``):

  - ``gbdt/binning.py``: ``bin_column`` / ``bin_matrix``;
  - ``gbdt/predict.py``: ``forest_predict_f64`` (``predict_ensemble``);
  - ``gbdt/sparse.py``: ``csr_forest_predict`` (host ``predict_csr``);
  - ``gbdt/booster.py``: ``gbdt_grow_tree`` (the native engine);
  - ``ops/image.py``: ``resize_bilinear`` (the host ``resize``; the image
    stages' and ImageFeaturizer's resize to the backbone's size);
  - ``ops/hashing.py``: ``murmur3_batch`` (``hash_strings``, the VW
    featurizer's batched hashing);
  - ``vw/learner.py``: ``vw_train_pass`` (``train_linear``'s native route,
    one sequential adaptive/SGD pass over the examples).
  ``unroll_chw`` is the reference's wrapper of the C unroll, which its
  ``UnrollImage`` does not call either (it unrolls in numpy).

Where the library cannot build, ``load()`` returns None and the consumers
keep their numpy paths (the parity references); ``chip_smoke.py`` fails if
that happens on the card's machine.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from . import _kernels

log = logging.getLogger("mmlspark_tpu_torch.native")

ABI_VERSION = 5
SOURCE = Path(__file__).resolve().parent / "native_src" / "mmlspark_native.cpp"
# -ffp-contract=off: no FMA contraction, so the predict paths round as the
# numpy references do
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-funroll-loops",
             "-fPIC", "-shared", "-std=c++17")

#: uses since the counter was last cleared: (function, route) -> calls
uses: Dict[Tuple[str, str], int] = collections.Counter()

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_build_attempted = False


def count(function: str, route: str) -> None:
    """Count one use of ``function`` by ``route`` (native or numpy)."""
    uses[(function, route)] += 1


def _host_tag() -> str:
    """The host CPU's machine and feature flags, hashed: a library built
    with -march=native loads only where they match."""
    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    ident += line
                    break
    except OSError:
        pass
    return hashlib.md5(ident.encode()).hexdigest()[:8]


def so_path() -> Path:
    return (_kernels.build_dir() / "native"
            / f"libmmlspark_native.v{ABI_VERSION}.{_host_tag()}.so")


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)   # atomic: a reader never loads half a file
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native build failed (%s); using the numpy paths", e)
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _try_load(path: Path) -> Optional[ctypes.CDLL]:
    """dlopen and the ABI check; None on any failure. A library that loads
    but fails the check is closed again, so that a rebuild at the same path
    is read anew (dlopen hands back a library it holds open by its name)."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        log.warning("native load failed (%s)", e)
        return None
    try:
        lib.mml_version.restype = ctypes.c_int32
        got = lib.mml_version()
    except (OSError, AttributeError) as e:
        log.warning("native ABI probe failed (%s)", e)
        got = None
    if got != ABI_VERSION:
        if got is not None:
            log.warning("native ABI v%s != expected v%s", got, ABI_VERSION)
        import _ctypes

        _ctypes.dlclose(lib._handle)
        return None
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None if it cannot be had. A
    file that is missing, does not load or has another ABI gets one
    rebuild in this process."""
    global _lib, _build_attempted
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = so_path()
        lib = _try_load(path) if path.exists() else None
        if lib is None:
            if _build_attempted:
                return None
            _build_attempted = True
            try:
                os.remove(path)
            except OSError:
                pass
            if not _build(path):
                return None
            lib = _try_load(path)
            if lib is None:
                log.warning("native library unusable after its rebuild; "
                            "using the numpy paths")
                return None
        _declare(lib)
        _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32, i64, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
    lib.mml_csr_forest_predict.argtypes = [
        i64p, i64p, f64p, i64, i32p, f64p, i32p, i32p, f64p, i64p, f64p,
        i32p, i32, i32, f64p]
    lib.mml_forest_predict_f64.argtypes = [
        f64p, i64, i32, i32p, f64p, u8p, i32p, i32p, f64p, i32, i32, i32p,
        i32, f64p]
    lib.mml_resize_bilinear_f32.argtypes = [f32p, i32, i32, i32, f32p, i32,
                                            i32]
    lib.mml_resize_bilinear_u8.argtypes = [u8p, i32, i32, i32, u8p, i32, i32]
    lib.mml_unroll_chw_f64.argtypes = [u8p, i32, i32, i32, f64p, i32]
    lib.mml_bin_column_f64.argtypes = [f64p, i64, f64p, i32, i32p]
    lib.mml_bin_matrix_f64_u8.argtypes = [f64p, i64, i32, f64p, i64p, u8p]
    lib.mml_bin_matrix_f64_i32.argtypes = [f64p, i64, i32, f64p, i64p, i32p]
    lib.mml_murmur3_batch.argtypes = [u8p, i64p, i64, ctypes.c_uint32,
                                      ctypes.POINTER(ctypes.c_uint32)]
    f32 = ctypes.c_float
    lib.mml_vw_train_pass.argtypes = [
        i32p, f32p, f32p, f32p, i64, i32, i32, f32, f32, f32, f32, f32, i32,
        f32p, f32p, f32p, f64p]
    lib.mml_gbdt_grow_tree.restype = i32
    lib.mml_gbdt_grow_tree.argtypes = [
        u8p, i64, i32, i32, f32p, f32p, u8p, u8p, i32, i32, f64, f64, f64,
        f64, f64, f64, i32p, i32p, u8p, i32p, i32p, f64p, f32p, i32p, f64p,
        i32p]


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _c(arr, dtype) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=dtype)


# ---------------------------------------------------------------------------
# Typed wrappers (None when the library is unavailable: the caller keeps its
# numpy path)
# ---------------------------------------------------------------------------


def resize_bilinear(img: np.ndarray, oh: int, ow: int) -> Optional[np.ndarray]:
    """HWC (or HW) uint8 or float32 image -> [oh, ow, C] bilinear resize
    with half-pixel centres, weights in f64 (uint8 rounded half to even
    and clamped): ``ops.image._resize_numpy``'s arithmetic."""
    lib = load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if img.dtype == np.uint8:
        dst = np.empty((oh, ow, c), dtype=np.uint8)
        lib.mml_resize_bilinear_u8(_ptr(img, ctypes.c_uint8), h, w, c,
                                   _ptr(dst, ctypes.c_uint8), oh, ow)
        return dst
    src = _c(img, np.float32)
    dst = np.empty((oh, ow, c), dtype=np.float32)
    lib.mml_resize_bilinear_f32(_ptr(src, ctypes.c_float), h, w, c,
                                _ptr(dst, ctypes.c_float), oh, ow)
    return dst


def unroll_chw(img: np.ndarray, normalize: bool = False
               ) -> Optional[np.ndarray]:
    """HWC (or HW) uint8 image -> flat CHW float64 vector (/255 with
    ``normalize``); None for another dtype or without the library."""
    lib = load()
    if lib is None or img.dtype != np.uint8:
        return None
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    out = np.empty(c * h * w, dtype=np.float64)
    lib.mml_unroll_chw_f64(_ptr(img, ctypes.c_uint8), h, w, c,
                           _ptr(out, ctypes.c_double), int(normalize))
    return out


def bin_column(vals: np.ndarray, edges: np.ndarray) -> Optional[np.ndarray]:
    """Numeric-column quantile binning: lower_bound(edges) + 1, NaN -> 0."""
    lib = load()
    if lib is None:
        return None
    vals, edges = _c(vals, np.float64), _c(edges, np.float64)
    out = np.empty(len(vals), dtype=np.int32)
    lib.mml_bin_column_f64(_ptr(vals, ctypes.c_double), len(vals),
                           _ptr(edges, ctypes.c_double), len(edges),
                           _ptr(out, ctypes.c_int32))
    return out


#: rows of one thread's block of ``bin_matrix``
BIN_BLOCK_ROWS = 1 << 16


def bin_matrix(X: np.ndarray, edges_list, dtype=np.int32
               ) -> Optional[np.ndarray]:
    """Row-major [N, F] floats -> feature-major [F, N] bins, each block of
    rows in one blocked pass (numeric features only; NaN -> bin 0). The
    blocks run on a thread each, up to the host's cores (the call releases
    the interpreter lock): one pass is single-threaded, and on the 8-core
    host of an H100 machine it took 5.5x the numpy path's threaded
    per-column time at 2,097,152 x 28 (PERF.md)."""
    import concurrent.futures

    lib = load()
    if lib is None or dtype not in (np.uint8, np.int32):
        return None
    X = _c(X, np.float64)
    n, num_f = X.shape
    offsets = np.zeros(num_f + 1, dtype=np.int64)
    np.cumsum([len(e) for e in edges_list], out=offsets[1:])
    flat = _c(np.concatenate([np.asarray(e, dtype=np.float64)
                              for e in edges_list])
              if offsets[-1] else np.empty(0), np.float64)
    out = np.empty((num_f, n), dtype=dtype)
    fn = (lib.mml_bin_matrix_f64_u8 if dtype == np.uint8
          else lib.mml_bin_matrix_f64_i32)
    ct = ctypes.c_uint8 if dtype == np.uint8 else ctypes.c_int32

    def block(r0: int) -> None:
        r1 = min(n, r0 + BIN_BLOCK_ROWS)
        part = np.empty((num_f, r1 - r0), dtype=dtype)
        fn(_ptr(X[r0:r1], ctypes.c_double), r1 - r0, num_f,
           _ptr(flat, ctypes.c_double), _ptr(offsets, ctypes.c_int64),
           _ptr(part, ct))
        out[:, r0:r1] = part

    starts = range(0, n, BIN_BLOCK_ROWS)
    workers = min(len(starts), os.cpu_count() or 1)
    if workers <= 1:
        for r0 in starts:
            block(r0)
    else:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            list(pool.map(block, starts))
    return out


def forest_predict_f64(X: np.ndarray, feature: np.ndarray,
                       threshold: np.ndarray, default_left: np.ndarray,
                       left: np.ndarray, right: np.ndarray,
                       value: np.ndarray, class_of_tree: np.ndarray,
                       num_class: int) -> Optional[np.ndarray]:
    """f64 dense forest traversal, bit-equal to the host numpy path for
    numeric splits; ``value`` pre-scaled by each tree's shrinkage; node
    arrays are [T, m] padded struct-of-arrays."""
    lib = load()
    if lib is None:
        return None
    X = _c(X, np.float64)
    n, num_feat = X.shape
    t, m = feature.shape
    feature, threshold = _c(feature, np.int32), _c(threshold, np.float64)
    dl, left, right = (_c(default_left, np.uint8), _c(left, np.int32),
                       _c(right, np.int32))
    value, cot = _c(value, np.float64), _c(class_of_tree, np.int32)
    out = np.zeros((n, num_class), dtype=np.float64)
    lib.mml_forest_predict_f64(
        _ptr(X, ctypes.c_double), n, num_feat, _ptr(feature, ctypes.c_int32),
        _ptr(threshold, ctypes.c_double), _ptr(dl, ctypes.c_uint8),
        _ptr(left, ctypes.c_int32), _ptr(right, ctypes.c_int32),
        _ptr(value, ctypes.c_double), t, m, _ptr(cot, ctypes.c_int32),
        num_class, _ptr(out, ctypes.c_double))
    return out


def csr_forest_predict(indptr: np.ndarray, indices: np.ndarray,
                       values: np.ndarray, feature: np.ndarray,
                       threshold: np.ndarray, left: np.ndarray,
                       right: np.ndarray, value: np.ndarray,
                       tree_offset: np.ndarray, shrinkage: np.ndarray,
                       class_of_tree: np.ndarray, num_class: int
                       ) -> Optional[np.ndarray]:
    """Flattened-forest traversal over CSR rows (numeric splits only). Node
    arrays are the trees' arrays concatenated; ``tree_offset`` is the
    [T + 1] node base of each tree; left/right stay tree-local ids."""
    lib = load()
    if lib is None:
        return None
    indptr, indices = _c(indptr, np.int64), _c(indices, np.int64)
    values = _c(values, np.float64)
    feature, threshold = _c(feature, np.int32), _c(threshold, np.float64)
    left, right = _c(left, np.int32), _c(right, np.int32)
    value, tree_offset = _c(value, np.float64), _c(tree_offset, np.int64)
    shrinkage, cot = _c(shrinkage, np.float64), _c(class_of_tree, np.int32)
    n = len(indptr) - 1
    out = np.zeros((n, num_class), dtype=np.float64)
    lib.mml_csr_forest_predict(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
        _ptr(values, ctypes.c_double), n, _ptr(feature, ctypes.c_int32),
        _ptr(threshold, ctypes.c_double), _ptr(left, ctypes.c_int32),
        _ptr(right, ctypes.c_int32), _ptr(value, ctypes.c_double),
        _ptr(tree_offset, ctypes.c_int64), _ptr(shrinkage, ctypes.c_double),
        _ptr(cot, ctypes.c_int32), len(shrinkage), num_class,
        _ptr(out, ctypes.c_double))
    return out


def gbdt_grow_tree(bins_fm: np.ndarray, grad: np.ndarray, hess: np.ndarray,
                   row_mask: Optional[np.ndarray],
                   feature_mask: Optional[np.ndarray], *,
                   num_bins: int, num_leaves: int, max_depth: int,
                   min_data_in_leaf: float, min_sum_hessian: float,
                   min_gain_to_split: float, lambda_l1: float,
                   lambda_l2: float, max_delta_step: float):
    """Grow one leaf-wise tree on the host (numeric splits only): a dict of
    flat node arrays (length = node count) and ``leaf_of_row`` [N], or None
    when the library is unavailable. ``bins_fm``: [F, N] uint8
    feature-major bins (0 = missing)."""
    lib = load()
    if lib is None or num_bins > 256:
        return None
    bins_fm = _c(bins_fm, np.uint8)
    num_f, n = bins_fm.shape
    grad, hess = _c(grad, np.float32), _c(hess, np.float32)
    rm = _c(row_mask, np.uint8) if row_mask is not None else None
    fm = _c(feature_mask, np.uint8) if feature_mask is not None else None
    cap = 2 * num_leaves - 1
    out = {"feature": np.empty(cap, np.int32),
           "threshold_bin": np.empty(cap, np.int32),
           "default_left": np.empty(cap, np.uint8),
           "left": np.empty(cap, np.int32), "right": np.empty(cap, np.int32),
           "value": np.empty(cap, np.float64),
           "gain": np.empty(cap, np.float32),
           "count": np.empty(cap, np.int32),
           "weight": np.empty(cap, np.float64)}
    leaf_of_row = np.empty(n, dtype=np.int32)
    null_u8 = ctypes.POINTER(ctypes.c_uint8)()
    ct = {np.int32: ctypes.c_int32, np.uint8: ctypes.c_uint8,
          np.float64: ctypes.c_double, np.float32: ctypes.c_float}
    ptrs = [_ptr(a, ct[a.dtype.type]) for a in out.values()]
    n_nodes = lib.mml_gbdt_grow_tree(
        _ptr(bins_fm, ctypes.c_uint8), n, num_f, num_bins,
        _ptr(grad, ctypes.c_float), _ptr(hess, ctypes.c_float),
        _ptr(rm, ctypes.c_uint8) if rm is not None else null_u8,
        _ptr(fm, ctypes.c_uint8) if fm is not None else null_u8,
        num_leaves, max_depth, float(min_data_in_leaf),
        float(min_sum_hessian), float(min_gain_to_split), float(lambda_l1),
        float(lambda_l2), float(max_delta_step), *ptrs,
        _ptr(leaf_of_row, ctypes.c_int32))
    m = int(n_nodes)
    res = {k: v[:m] for k, v in out.items()}
    res["default_left"] = res["default_left"].astype(bool)
    res["leaf_of_row"] = leaf_of_row
    return res


def murmur3_batch(strings, seed: int = 0) -> Optional[np.ndarray]:
    """MurmurHash3_x86_32 of each string's utf-8 bytes (int64 array of the
    uint32 hashes), or None without the library."""
    lib = load()
    if lib is None:
        return None
    encoded = [s.encode("utf-8") for s in strings]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    buf = np.frombuffer(b"".join(encoded), dtype=np.uint8) if encoded else \
        np.empty(0, dtype=np.uint8)
    buf = np.ascontiguousarray(buf)
    out = np.zeros(len(encoded), dtype=np.uint32)
    lib.mml_murmur3_batch(_ptr(buf, ctypes.c_uint8),
                          _ptr(offsets, ctypes.c_int64), len(encoded),
                          seed & 0xFFFFFFFF, _ptr(out, ctypes.c_uint32))
    return out.astype(np.int64)


_LOSS_IDS = {"squared": 0, "logistic": 1, "hinge": 2, "quantile": 3}


def vw_train_pass(indices: np.ndarray, values: np.ndarray,
                  labels: np.ndarray, weights: np.ndarray,
                  w: np.ndarray, g2: np.ndarray, t: float, *,
                  loss: str, tau: float, lr: float, power_t: float,
                  initial_t: float, l2: float, adaptive: bool):
    """One sequential learning pass IN PLACE over ``w``/``g2`` (padded
    sparse examples, [N, K] int32 indices and f32 values). Returns (new_t,
    loss_sum), or None without the library, for another loss, or for
    buffers that are not f32 (the caller takes the scan route then)."""
    lib = load()
    if lib is None or loss not in _LOSS_IDS:
        return None
    if w.dtype != np.float32 or g2.dtype != np.float32:
        return None
    indices = _c(indices, np.int32)
    values = _c(values, np.float32)
    labels = _c(labels, np.float32)
    weights = _c(weights, np.float32)
    n, k = indices.shape
    t_box = np.array([t], dtype=np.float32)
    loss_out = np.zeros(1, dtype=np.float64)
    lib.mml_vw_train_pass(
        _ptr(indices, ctypes.c_int32), _ptr(values, ctypes.c_float),
        _ptr(labels, ctypes.c_float), _ptr(weights, ctypes.c_float),
        n, k, _LOSS_IDS[loss], float(tau), float(lr), float(power_t),
        float(initial_t), float(l2), int(adaptive),
        _ptr(w, ctypes.c_float), _ptr(g2, ctypes.c_float),
        _ptr(t_box, ctypes.c_float), _ptr(loss_out, ctypes.c_double))
    return float(t_box[0]), float(loss_out[0])
