"""The port's fused scoring pipeline and K3 against the JAX reference, on the CPU.

Inputs are made with numpy from a seed (200 x 32 rows at density 0.15, as in
``tests/test_sparse_e2e.py``; 10 trees of 7 leaves) and go through the
reference (``mmlspark_tpu.core.fusion``, ``mmlspark_tpu.gbdt.pallas_sparse``)
and the port (``mmlspark_tpu_torch``, under ``use_device("cpu")``, where K3's
wrapper runs its plain version). The models are trained by the reference and
carried across with ``convert.booster_from_reference``.

Tolerances, and why:
  - the variant registry, ``used_features``, ``remap_ensemble``, plan
    layouts, cache keys: equal;
  - K3's plain version against the reference's ``csr_gather_xla`` and its
    Pallas kernel in interpret mode: bitwise (the gather copies values; the
    Pallas one-hot contraction turns -0.0 into 0.0 and spreads NaN, so it is
    held only on inputs without them);
  - fused against unfused in the port, fused CSR against fused dense rows,
    forest variants against each other: bitwise (the same traversal ops, and
    class sums in one fixed order for any batch shape);
  - port against reference: 1e-6, as ``test_torch_gbdt.py`` scores carried
    models (the reference sums trees with ``contrib @ class_onehot``);
  - CSR scores against the f64 host scorer: 1e-6, the reference's own
    ``CSR_VS_HOST_ATOL``;
  - the stitched classifier's probability: 1e-5, its declared
    ``finalize_tolerance``.

The model layer (``mmlspark_tpu_torch.models``) and the ``DNNModel`` stage,
served unfused and fused, against the reference's: every module is built by
the reference (``mmlspark_tpu.models``) with its own init, its weights
carried into the port with ``models.load_jax_params``, and fed the same
numpy inputs made from a seed. Tolerances, and why:
  - f32 (``matmul_precision("float32")`` on both sides): 1e-5 absolute, f32
    sums in another order;
  - the bf16 default: each product's operands are rounded to bf16 on both
    sides and multiplied in f32, so the results differ only where a sum in
    another order rounds to another bf16 value before the next layer
    (measured here: no such flip, every difference <= 1.2e-6). Dense 1e-5
    (no intermediate rounding); MHA 1e-3; a transformer block, the
    encoder's taps and the DNNModel slice 2e-2, room for one flip of a bf16
    intermediate of magnitude <= 4 (one ulp: 1.6e-2); LayerNorm of a bf16
    input one bf16 ulp (measured: equal);
  - Embed, the weights round trip, Minibatcher batches and PreprocessSpec:
    bitwise;
  - the port's fused DNNModel against its unfused one: bitwise (the same
    torch ops on batches of the same size).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import kernels as ref_kernels
from mmlspark_tpu.core.dataframe import DataFrame as RefDataFrame
from mmlspark_tpu.core.device_stage import CompileCache as RefCompileCache
from mmlspark_tpu.core.fusion import FusedPipelineModel as RefFused
from mmlspark_tpu.core.fusion import plan as ref_plan
from mmlspark_tpu.core.pipeline import Transformer as RefTransformer
from mmlspark_tpu.gbdt import pallas_sparse
from mmlspark_tpu.gbdt import predict as ref_predict
from mmlspark_tpu.gbdt import stages as ref_stages
from mmlspark_tpu.models import DNNModel as RefDNNModel
from mmlspark_tpu.models import attention as ref_attention
from mmlspark_tpu.models import module as ref_module
from mmlspark_tpu.parallel import batching as ref_batching
from mmlspark_tpu.parallel.ingest import PreprocessSpec as RefPreprocessSpec
from mmlspark_tpu_torch.core import faults, kernels
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device_stage import CompileCache
from mmlspark_tpu_torch.core.fusion import (FusedPipelineModel, SegmentExecutor,
                                            _HostFallback, _stack_col, plan)
from mmlspark_tpu_torch.core.pipeline import PipelineModel, Transformer
from mmlspark_tpu_torch.core.schema import ColType
from mmlspark_tpu_torch.gbdt import convert, gather_kernel, predict, stages
from mmlspark_tpu_torch.models import (DNNModel, Dense, Embed, FunctionModel,
                                       LayerNorm, MultiHeadAttention, attention,
                                       load_jax_params, matmul_precision,
                                       transformer_block, transformer_encoder)
from mmlspark_tpu_torch.parallel import batching
from mmlspark_tpu_torch.parallel.ingest import PreprocessSpec
from mmlspark_tpu_torch.runtime import use_device

N_ROWS, N_FEATURES, DENSITY = 200, 32, 0.15
PORT_VS_REF_ATOL = 1e-6   # tests/test_torch_gbdt.py, carried-model scoring
CSR_VS_HOST_ATOL = 1e-6   # tests/test_sparse_e2e.py CSR_VS_HOST_ATOL
STITCH_TOL = 1e-5         # the classifier's declared finalize_tolerance


def _sparse_matrix(n=N_ROWS, width=N_FEATURES, density=DENSITY, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, width)).astype(np.float32)
    X[rng.random((n, width)) >= density] = 0.0
    return X


def _csr_of(X):
    indptr, indices, values = [0], [], []
    for row in X:
        nz = np.flatnonzero(row)
        indices.extend(nz.tolist())
        values.extend(row[nz].tolist())
        indptr.append(len(indices))
    return (np.asarray(indptr, dtype=np.int32),
            np.asarray(indices, dtype=np.int32),
            np.asarray(values, dtype=np.float32))


def _rows(X, sparse):
    out = np.empty(len(X), dtype=object)
    for i, row in enumerate(X):
        if sparse:
            nz = np.flatnonzero(row)
            out[i] = {"indices": nz.astype(np.int64),
                      "values": row[nz].astype(np.float64), "size": X.shape[1]}
        else:
            out[i] = row
    return out


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def models():
    """Reference-trained regressor and binary classifier, carried into the
    port, plus dense and sparse frames of the same rows in both packages."""
    X = _sparse_matrix()
    rng = np.random.default_rng(1)
    y = X[:, 0] * 2 + X[:, 3] - X[:, 7] + rng.normal(scale=0.1, size=len(X))
    ref_df = RefDataFrame.from_dict({"features": _rows(X, False), "label": y})
    ref_reg = ref_stages.LightGBMRegressor(numIterations=10,
                                           numLeaves=7).fit(ref_df)
    ref_df = RefDataFrame.from_dict({"features": _rows(X, False),
                                     "label": (y > 0).astype(np.float64)})
    ref_clf = ref_stages.LightGBMClassifier(numIterations=10,
                                            numLeaves=7).fit(ref_df)
    port = {}
    for name, ref in (("reg", ref_reg), ("clf", ref_clf)):
        cls = (stages.LightGBMRegressionModel if name == "reg"
               else stages.LightGBMClassificationModel)
        port[name] = cls(booster=convert.booster_from_reference(
            ref.booster.to_string()), featuresCol="features")
    frames = {f"{kind}_{pkg}": fr.from_dict({"features": _rows(X, kind == "sparse")})
              for kind in ("dense", "sparse")
              for pkg, fr in (("ref", RefDataFrame), ("port", DataFrame))}
    return {"X": X, "ref": {"reg": ref_reg, "clf": ref_clf}, "port": port,
            **frames}


def _fused(model):
    return FusedPipelineModel(PipelineModel([model]).stages, cache=CompileCache())


def _label(fused):
    return [n.label for n in fused._last_plan if hasattr(n, "dfns")][0]


def _column(df, name):
    col = df.column(name)
    return np.stack(list(col)) if col.dtype == object else col.astype(np.float64)


def _seg(fused):
    return next(iter(fused.fusion_stats()["per_segment"].values()))


# ------------------------------------------------------------------ registry


def test_variant_registry_equals_reference():
    def spec(mod):
        return {vid: (v.kernel, dict(v.params), v.tolerance)
                for vid in mod.all_variant_ids() for v in [mod.get(vid)]}

    assert spec(kernels) == spec(ref_kernels)
    assert set(spec(kernels)) == {"hist.c256", "hist.c1024", "select.c512",
                                  "select.c2048", "forest.gather", "forest.gemm",
                                  "hist.csr", "forest.csr"}
    with kernels.activate("forest.csr"):
        assert kernels.active("forest").id == "forest.csr"
        assert kernels.active_param("forest", "impl", None) == "gather"
        assert kernels.active("hist") is None
    assert kernels.active("forest") is None


# ---------------------------------------------------------- used-feature remap


@pytest.mark.parametrize("name", ["reg", "clf"])
def test_used_features_and_remap_equal_reference(models, name):
    ref_ens = ref_predict.DeviceEnsemble(models["ref"][name].booster.trees, 1)
    with use_device("cpu"):
        ens = models["port"][name]._ensemble()
    used = gather_kernel.used_features(ens)
    np.testing.assert_array_equal(used, pallas_sparse.used_features(ref_ens))
    a = gather_kernel.remap_ensemble(ens, used)
    b = pallas_sparse.remap_ensemble(ref_ens, used)
    np.testing.assert_array_equal(a.feature, b.feature)
    np.testing.assert_array_equal(a._gemm[0], b._gemm[0])
    assert a._dev == {} and ens.feature is not a.feature
    # an all-leaf forest still gathers one column
    stub = type("Stub", (), {"feature": np.full((2, 1), -1)})()
    np.testing.assert_array_equal(gather_kernel.used_features(stub), [0])


# ----------------------------------------------------------------------- K3


def _gather_cases():
    """(name, indptr, indices, values, width, used) with the reference's
    wire layout: padded rows repeat the last offset, nnz pads with zeros."""
    X = _sparse_matrix(n=24, width=40, density=0.2, seed=3)
    X[[0, 5, 23]] = 0.0                       # empty rows, first and last
    indptr, indices, values = _csr_of(X)
    used = np.sort(np.random.default_rng(3).choice(40, 9, replace=False))
    ip = np.concatenate([indptr, np.full(8, indptr[-1], np.int32)])
    pad = (1 << len(indices).bit_length()) - len(indices)   # pow-2 nnz bucket
    cases = [
        ("plain", indptr, indices, values, 40, used),
        ("clamped", indptr, indices, values, 40, np.array([0, 39, 40, 47])),
        ("padded", ip, np.pad(indices, (0, pad)), np.pad(values, (0, pad)), 40, used),
        ("all-leaf forest", indptr, indices, values, 40, np.array([0])),
        ("no entries, padded", np.zeros(9, np.int32), np.zeros(8, np.int32),
         np.zeros(8, np.float32), 40, used),
    ]
    return [pytest.param(*c[1:], id=c[0]) for c in cases]


def _shuffled_case():
    """The plain case with ``used`` in no order, with duplicates and with
    ids past the width (which clamp onto a duplicate of the last column)."""
    X = _sparse_matrix(n=24, width=40, density=0.2, seed=3)
    X[[0, 5, 23]] = 0.0
    used = np.random.default_rng(4).permutation(
        [3, 17, 17, 39, 0, 45, 3, 40, 22, 8, 39])
    return pytest.param(*_csr_of(X), 40, used, id="shuffled used, duplicates")


def _k3_design_cases():
    """Inputs that reach the parts of K3's design the wire cases do not: a
    row longer than a warp's window, more used ids than a block stages, and
    no rows at all."""
    rng = np.random.default_rng(5)
    X = np.zeros((7, 2048), np.float32)
    for r, k in enumerate([20, 1300, 0, 33, 600, 512, 9]):
        cols = rng.choice(2048, k, replace=False)
        X[r, cols] = rng.integers(1, 5, k)
    long_used = np.concatenate([rng.choice(2048, 300), [2047, 2048, 5000]])
    Y = _sparse_matrix(n=6, width=4096, density=0.1, seed=6)
    big_used = np.concatenate([rng.choice(4096, 1500), [4095, 4100]])
    zero = (np.zeros(1, np.int32), np.zeros(4, np.int32),
            np.zeros(4, np.float32))
    return [pytest.param(*_csr_of(X), 2048, rng.permutation(long_used),
                         id="rows longer than the window"),
            pytest.param(*_csr_of(Y), 4096, big_used,
                         id="used past one block's chunk"),
            pytest.param(*zero, 40, np.array([1, 2]), id="0 rows")]


def _port_gather(indptr, indices, values, width, used):
    t = [torch.from_numpy(np.asarray(a)) for a in (indptr, indices, values)]
    return gather_kernel.csr_gather(*t, width, torch.from_numpy(
        np.asarray(used, dtype=np.int32))).numpy()


@pytest.mark.parametrize("indptr,indices,values,width,used",
                         _gather_cases() + [_shuffled_case()])
def test_k3_plain_bitwise_equals_reference(indptr, indices, values, width, used):
    got = _port_gather(indptr, indices, values, width, used)
    xla = np.asarray(pallas_sparse.csr_gather_xla(indptr, indices, values,
                                                  width, used))
    pallas = np.asarray(pallas_sparse.csr_gather_pallas(
        indptr, indices, values, width, used, interpret=True))
    np.testing.assert_array_equal(_bits(got), _bits(xla))
    np.testing.assert_array_equal(_bits(got), _bits(pallas))


def _k3_emulate(indptr, indices, values, width, used, rows_per_warp=None,
                warps=gather_kernel.WARPS_PER_BLOCK,
                stage=gather_kernel.STAGE_ENTRIES,
                chunk=gather_kernel.USED_CHUNK):
    """K3's index arithmetic (``csrc/csr_gather.cu``) in numpy: the grid,
    block -> warp -> tile of rows, the block's chunk of clamped used ids,
    each warp's window of staged entries (the tile's first, then restarted
    at a row that runs past it), a row's pieces and which piece decides
    each used id, and the branchless search of a piece (the last position
    whose index is <= the id, in steps that depend on the piece's length
    only). The lanes of a warp and their groups of used ids are one vector.
    ``rows_per_warp`` and ``warps`` (a block) default to the kernel's.
    Returns the [N, U] f32 result and how many times each cell was
    written."""
    n, u, nnz = len(indptr) - 1, len(used), len(indices)
    rpw = rows_per_warp or gather_kernel.launch_geometry(n, u)[0]
    out = np.zeros((max(n, 0), u), np.uint32)
    writes = np.zeros(out.shape, np.int64)
    if n <= 0:
        return out.view(np.float32), writes
    ip = np.asarray(indptr, np.int64)
    idx = np.asarray(indices, np.int64)
    val = _bits(values)
    grid_x, grid_y = -(-n // (warps * rpw)), -(-u // chunk)
    for by in range(grid_y):
        c0 = by * chunk
        q = np.minimum(np.asarray(used[c0:c0 + chunk], np.int64), width - 1)
        for bx in range(grid_x):
            for warp in range(warps):
                row0 = (bx * warps + warp) * rpw
                rows = max(0, min(rpw, n - row0))
                if rows == 0:
                    continue
                off = np.clip(ip[row0:row0 + rows + 1], 0, nnz)
                tile_hi, cur = off[rows], off[0]
                # the first window, staged while the block stages the ids
                win_lo, win_hi = cur, cur + max(0, min(stage, tile_hi - cur))
                for r in range(rows):
                    b = max(off[r + 1], cur)
                    pos, prev = cur, -np.inf
                    while True:                     # the row's pieces
                        if b > win_hi:              # restart the window
                            win_lo = pos
                            win_hi = pos + min(stage, max(tile_hi, b) - pos)
                        s_idx = idx[win_lo:win_hi]
                        s_val = val[win_lo:win_hi]
                        last = b <= win_hi
                        lo, ln = pos - win_lo, min(b, win_hi) - pos
                        top = np.inf if last else s_idx[lo + ln - 1]
                        at = np.full(len(q), lo)
                        held = np.full(len(q), s_idx[lo] if ln else 0)
                        m = ln
                        while m > 1:
                            half = m >> 1
                            step = s_idx[at + half]
                            move = step <= q
                            at[move] += half
                            held[move] = step[move]
                            m -= half
                        j = np.flatnonzero((q > prev) & (q <= top))
                        hit = (ln > 0) & (held[j] == q[j])
                        cells = np.zeros(len(j), np.uint32)
                        cells[hit] = s_val[at[j][hit]]
                        out[row0 + r, c0 + j] = cells
                        writes[row0 + r, c0 + j] += 1
                        if last:
                            break
                        prev, pos = top, win_hi
                    cur = b
    return out.view(np.float32), writes


@pytest.mark.parametrize("shape", ["card", "tiny"])
@pytest.mark.parametrize("indptr,indices,values,width,used",
                         _gather_cases() + [_shuffled_case()]
                         + _k3_design_cases())
def test_k3_design_emulation_bitwise_equals_plain_and_reference(
        indptr, indices, values, width, used, shape):
    # "card": the kernel's own window, chunk and launch_geometry; "tiny": a
    # window of 8 entries, chunks of 16 used ids and tiles of 3 rows in
    # blocks of 2 warps, so every case has rows in several pieces, tiles in
    # several windows and several used chunks
    kw = {} if shape == "card" else dict(rows_per_warp=3, warps=2, stage=8,
                                         chunk=16)
    got, writes = _k3_emulate(indptr, indices, values, width, used, **kw)
    plain = _port_gather(indptr, indices, values, width, used)
    xla = np.asarray(pallas_sparse.csr_gather_xla(indptr, indices, values,
                                                  width, used))
    assert got.shape == plain.shape == xla.shape
    assert (writes == 1).all()       # every cell written, and only once
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    np.testing.assert_array_equal(_bits(got), _bits(xla))


@pytest.mark.parametrize("n", [1, 200, 256, 1024, 4096, 16384, 65536, 200_000])
@pytest.mark.parametrize("u", [1, 55, 1024, 30_000])
def test_k3_launch_geometry(n, u):
    rpw, grid_x, grid_y = gather_kernel.launch_geometry(n, u)
    warps = gather_kernel.WARPS_PER_BLOCK
    # the C entry point's limits: a lane loads each of a tile's offsets,
    # grid.y's cap
    assert 1 <= rpw <= 31 and grid_y <= 65535
    assert (grid_x - 1) * warps * rpw < n <= grid_x * warps * rpw
    assert (grid_y - 1) * gather_kernel.USED_CHUNK < u
    assert u <= grid_y * gather_kernel.USED_CHUNK
    # from the executor's batch up, the blocks cover more than a quarter of
    # the card's SMs; each tile's entries fit a window at the text rows'
    # ~50 entries a row
    if n >= 256:
        assert grid_x * grid_y >= gather_kernel.SMS // 4
    assert rpw * 50 <= gather_kernel.STAGE_ENTRIES


def test_k3_plain_copies_stored_bits():
    # explicit 0.0, -0.0 and NaN stay what they are (the XLA gather selects;
    # the Pallas contraction adds zeros, so it is not held here)
    indptr = np.array([0, 3, 3, 5], np.int32)
    indices = np.array([1, 4, 7, 0, 4], np.int32)
    values = np.array([0.0, -0.0, np.nan, -2.5, 3.0], np.float32)
    used = np.array([0, 1, 4, 7, 9])
    got = _port_gather(indptr, indices, values, 10, used)
    xla = np.asarray(pallas_sparse.csr_gather_xla(indptr, indices, values, 10, used))
    np.testing.assert_array_equal(_bits(got), _bits(xla))
    assert _bits(got)[0, 2] == np.float32(-0.0).view(np.uint32)
    assert np.isnan(got[0, 3]) and got[1].tolist() == [0.0] * 5


def test_k3_wrapper_routes_by_device():
    empty = _port_gather(np.zeros(4, np.int32), np.zeros(0, np.int32),
                         np.zeros(0, np.float32), 6, [2, 9])
    np.testing.assert_array_equal(empty, np.zeros((3, 2), np.float32))
    meta = [torch.zeros(n, dtype=dt, device="meta") for n, dt in
            ((3, torch.int32), (2, torch.int32), (2, torch.float32),
             (1, torch.int32))]
    with pytest.raises(ValueError, match="device"):
        gather_kernel.csr_gather(meta[0], meta[1], meta[2], 4, meta[3])
    with pytest.raises(ValueError, match="width"):
        _port_gather(np.zeros(2, np.int32), np.zeros(1, np.int32),
                     np.zeros(1, np.float32), 0, [0])


# --------------------------------------------------------------------- plan


def _tag_stage(base):
    """A host-only stage of the same name in either package."""
    def transform(self, df):
        return df.with_column("tag", lambda p: np.ones(
            len(next(iter(p.values())))))

    return type("AddTag", (base,), {"_abstract": True,
                                    "transform": transform})()


@pytest.mark.parametrize("with_host", [False, True])
@pytest.mark.parametrize("stitch", [None, {"LightGBMClassificationModel": True}])
def test_plan_layout_equals_reference(models, with_host, stitch):
    def layout(plan_fn, base, model, df):
        chain = ([_tag_stage(base)] if with_host else []) + [model]
        nodes = plan_fn(chain, df.schema, stitch_overrides=stitch)
        return [(n.describe(), getattr(n, "stitched", None),
                 [d.terminal for d in getattr(n, "dfns", [])]) for n in nodes]

    ref = layout(ref_plan, RefTransformer, models["ref"]["clf"], models["dense_ref"])
    with use_device("cpu"):
        port = layout(plan, Transformer, models["port"]["clf"], models["dense_port"])
    assert port == ref
    assert port[-1][0]["kind"] == "fused"


# ----------------------------------------------------------- fused transform


@pytest.mark.parametrize("name,col", [("reg", "prediction"), ("clf", "rawPrediction")])
def test_fused_dense_matches_reference_and_unfused(models, name, col):
    ref = RefFused([models["ref"][name]], cache=RefCompileCache())
    ref_out = _column(ref.transform(models["dense_ref"]), col)
    with use_device("cpu"):
        fused = _fused(models["port"][name])
        got = _column(fused.transform(models["dense_port"]), col)
        unfused = _column(models["port"][name].transform(models["dense_port"]), col)
    np.testing.assert_allclose(got, ref_out, rtol=0, atol=PORT_VS_REF_ATOL)
    np.testing.assert_array_equal(got, unfused)
    st = fused.fusion_stats()
    assert st["fallbacks"] == [] and st["n_fused_segments"] == 1
    assert _seg(fused)["rows"] == N_ROWS


def test_sparse_knob_off_falls_back_bitwise(models):
    model = models["port"]["reg"]
    with use_device("cpu"):
        fused = _fused(model)
        got = _column(fused.transform(models["sparse_port"]), "prediction")
        host = _column(model.transform(models["sparse_port"]), "prediction")
    np.testing.assert_array_equal(got, host)
    assert any("sparse" in f for f in fused.fusion_stats()["fallbacks"])


def _csr_fused(model, variant="forest.csr", layout="csr"):
    fused = _fused(model)
    label = f"{type(model).__name__}"
    fused.set_tuning(layout={label: layout} if layout else {},
                     kernel_variants={label: {"*": variant}} if variant else {})
    return fused


def test_sparse_knob_on_stages_csr(models):
    model = models["port"]["reg"]
    with use_device("cpu"):
        host = _column(model.transform(models["sparse_port"]), "prediction")
        dense = _column(_fused(model).transform(models["dense_port"]), "prediction")
        fused = _csr_fused(model)
        got = _column(fused.transform(models["sparse_port"]), "prediction")
    st = fused.fusion_stats()
    assert st["fallbacks"] == [] and st["tuning"]["layout"] == {_label(fused): "csr"}
    seg = _seg(fused)
    assert seg["csr_batches"] >= 1 and "densifies" not in seg
    assert seg["csr_nnz_bytes"] < seg["csr_dense_bytes"]
    assert np.max(np.abs(got - host)) <= CSR_VS_HOST_ATOL
    np.testing.assert_array_equal(got, dense)


def test_forest_variants_agree_bitwise(models):
    model = models["port"]["reg"]
    outs = {}
    with use_device("cpu"):
        for kind in ("dense", "sparse"):
            for vid in ("forest.gather", "forest.gemm", "forest.csr", None):
                fused = _csr_fused(model, variant=vid)
                df = fused.transform(models[f"{kind}_port"])
                outs[kind, vid] = _column(df, "prediction")
    first = outs["dense", None]
    for key, out in outs.items():
        np.testing.assert_array_equal(out, first, err_msg=str(key))


def test_cache_keys_carry_layout_and_variant(models):
    with use_device("cpu"):
        fused = _csr_fused(models["port"]["reg"])
        fused.transform(models["dense_port"])
        fused.transform(models["sparse_port"])
        fused.transform(models["sparse_port"])
    shapes = [s for per in fused.compile_cache.costs().values() for s in per]
    assert any(s.startswith("variant=forest.csr;layout=csr;") for s in shapes)
    assert any(s.startswith("variant=forest.csr;features=") for s in shapes)
    assert all("first_call_ms" in rec for per in fused.compile_cache.costs().values()
               for rec in per.values())
    cs = fused.fusion_stats()["compile_cache"]   # one 256-row batch each
    assert cs["misses"] == len(shapes) == 2 and cs["hits"] == 1


def test_stitched_classifier_keeps_raw_bitwise(models):
    model = models["port"]["clf"]
    with use_device("cpu"):
        plain = _fused(model)
        base = plain.transform(models["dense_port"])
        stitched = _fused(model)
        stitched.set_tuning(stitch={"LightGBMClassificationModel": True})
        out = stitched.transform(models["dense_port"])
    for c in ("rawPrediction", "probability"):
        a, b = (np.stack(list(df.column(c))) for df in (base, out))
        if c == "rawPrediction":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=STITCH_TOL)
    np.testing.assert_array_equal(_column(base, "prediction"),
                                  _column(out, "prediction"))
    assert stitched.fusion_stats()["stitched"] == {
        "LightGBMClassificationModel": ["LightGBMClassificationModel"]}
    assert any(s.startswith("stitch=") for per in
               stitched.compile_cache.costs().values() for s in per)


def test_injected_sparse_stage_fault_densifies(models):
    model = models["port"]["reg"]

    def hook(point, **ctx):
        if point == faults.SPARSE_STAGE:
            raise faults.InjectedFault("injected sparse.stage fault")

    with use_device("cpu"):
        ref = _column(_csr_fused(model).transform(models["sparse_port"]), "prediction")
        fused = _csr_fused(model)
        prev = faults.install(hook)
        try:
            got = _column(fused.transform(models["sparse_port"]), "prediction")
        finally:
            faults.install(prev)
    np.testing.assert_array_equal(got, ref)
    seg = _seg(fused)
    assert seg["densifies"] == 1 and "csr_batches" not in seg
    assert seg["densified_bytes"] == N_ROWS * N_FEATURES * 4
    assert fused.fusion_stats()["fallbacks"] == []


def test_k3_failure_propagates_out_of_transform(models, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("csr_gather kernel launch: CUDA error 700")

    monkeypatch.setattr(gather_kernel, "csr_gather_plain", broken)
    fused = _csr_fused(models["port"]["reg"])
    with use_device("cpu"), pytest.raises(RuntimeError, match="CUDA error"):
        fused.transform(models["sparse_port"])
    assert fused.fusion_stats()["fallbacks"] == []


def test_ragged_and_mixed_rows_fall_back(models):
    model = models["port"]["reg"]
    X = models["X"]
    mixed = _rows(X, False)
    mixed[3] = _rows(X[3:4], True)[0]
    ragged = _rows(X, False)
    ragged[4] = X[4, :10]
    with use_device("cpu"):
        seg = plan([model], DataFrame.from_dict({"features": mixed}).schema)[0]
        ex = SegmentExecutor(seg, CompileCache(), layout="csr")
    with pytest.raises(_HostFallback, match="mixed sparse/dense rows"):
        ex._prep_partition({"features": mixed})
    with pytest.raises(_HostFallback, match="ragged rows"):
        _stack_col(ragged, allow_sparse=False)


def test_compile_cache_lru_drops_cost_with_entry():
    cache = CompileCache(capacity=2)
    for key in ("a", "b", "a", "c"):   # the hit on "a" makes "b" the LRU
        program = cache.get((key,), lambda: (lambda: None), label="seg", shape=key)
        program()
    st = cache.stats()
    assert (st["entries"], st["hits"], st["misses"], st["evictions"]) == (2, 1, 3, 1)
    assert sorted(cache.costs()["seg"]) == ["a", "c"]
    assert all("first_call_ms" in rec for rec in cache.costs()["seg"].values())


def test_fused_transform_runs_on_cuda_unless_asked(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fused = _fused(models["port"]["reg"])
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.transform(models["dense_port"])


def test_pipeline_fuse_entry_point(models):
    model = models["port"]["reg"]
    pm = PipelineModel([model])
    with use_device("cpu"):
        fused = pm.fuse()
        assert fused is pm.fuse() and fused.fuse() is fused
        a = _column(pm.transform(models["dense_port"], fused=True), "prediction")
        b = _column(pm.transform(models["dense_port"]), "prediction")
    np.testing.assert_array_equal(a, b)
    assert fused.fusion_stats()["segments"][0]["batch_size"] == 256


# ---------------------------------------------------------------------------
# the model layer and DNNModel (transformer encoders)
# ---------------------------------------------------------------------------


F32_TOL = 1e-5
DENSE_BF16_TOL = 1e-5
MHA_BF16_TOL = 1e-3
DEEP_BF16_TOL = 2e-2

ENC = dict(seq_len=16, dim=32, depth=2, num_heads=2, vocab_size=50,
           num_classes=5)
TAPS = ["block0", "block0/mlp/body/fc1", "ln_f"]


def _np_params(tree, rng):
    """The reference's params as numpy, LayerNorm/bias leaves made
    non-trivial (the reference inits them to ones and zeros)."""
    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "scale":
                out[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k == "bias":
                out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            else:
                out[k] = np.asarray(v, dtype=np.float32)
        return out
    return walk(tree)


def _pair(ref_mod, port_mod, in_shape, seed=0):
    """(reference params, port module with the same weights)."""
    params, _ = ref_mod.init(jax.random.key(seed), in_shape)
    params = _np_params(params, np.random.default_rng(seed))
    port_mod.init(torch.Generator().manual_seed(seed), in_shape)
    load_jax_params(FunctionModel(port_mod, in_shape), params)
    return params, port_mod


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _run(ref_mod, params, port_mod, x, f32):
    """Both forwards on ``x``; ``f32`` selects matmul_precision("float32")."""
    if f32:
        with ref_module.matmul_precision("float32"):
            ref = np.asarray(ref_mod.apply(params, jnp.asarray(x)))
        with matmul_precision("float32"), torch.inference_mode():
            got = port_mod(torch.from_numpy(x)).numpy()
    else:
        ref = np.asarray(ref_mod.apply(params, jnp.asarray(x)))
        with torch.inference_mode():
            got = port_mod(torch.from_numpy(x)).numpy()
    assert got.dtype == ref.dtype
    return ref, got


@pytest.mark.parametrize("f32", [True, False])
def test_layernorm_matches_reference(f32):
    params, port = _pair(ref_attention.LayerNorm(), LayerNorm(), (8, 16))
    ref, got = _run(ref_attention.LayerNorm(), params, port, _x((3, 8, 16)), f32)
    np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=0)


def test_layernorm_preserves_bf16():
    params, port = _pair(ref_attention.LayerNorm(), LayerNorm(), (8, 16))
    x = _x((3, 8, 16))
    ref = ref_attention.LayerNorm().apply(params,
                                          jnp.asarray(x).astype(jnp.bfloat16))
    with torch.inference_mode():
        got = port(torch.from_numpy(x).to(torch.bfloat16))
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    # one bf16 ulp of each value: the f32 statistics differ in order only
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -8, atol=1e-6)


@pytest.mark.parametrize("f32", [True, False])
def test_dense_matches_reference(f32):
    params, port = _pair(ref_module.Dense(12), Dense(12), (8, 16))
    ref, got = _run(ref_module.Dense(12), params, port, _x((3, 8, 16)), f32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=F32_TOL if f32 else DENSE_BF16_TOL,
                               rtol=0)


def test_embed_matches_reference_nan_rows_and_wrap():
    """Ids >= vocab give a NaN row, negative ids wrap once, ids are cast to
    int32 first (2^32 + 1 reads row 1)."""
    params, port = _pair(ref_attention.Embed(7, 5), Embed(7, 5), (4,))
    ids = np.array([[0, 6, 7, 100], [-1, -7, -8, 2 ** 32 + 1]], dtype=np.int64)
    ref = np.asarray(ref_attention.Embed(7, 5).apply(params, jnp.asarray(ids)))
    with torch.inference_mode():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[0, 2]).all() and np.isnan(got[1, 2]).all()
    np.testing.assert_array_equal(got[1, 0], params["table"][6])
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(ref))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("f32", [True, False])
def test_mha_matches_reference(causal, f32):
    ref_mod = ref_attention.MultiHeadAttention(2, causal=causal)
    params, port = _pair(ref_mod, MultiHeadAttention(2, causal=causal), (16, 32))
    ref, got = _run(ref_mod, params, port, _x((2, 16, 32)), f32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=F32_TOL if f32 else MHA_BF16_TOL,
                               rtol=0)


@pytest.mark.parametrize("f32", [True, False])
def test_transformer_block_matches_reference(f32):
    ref_mod = ref_attention.transformer_block(32, 2)
    params, port = _pair(ref_mod, transformer_block(32, 2), (16, 32))
    assert port.layer_paths() == ref_mod.layer_paths()
    ref, got = _run(ref_mod, params, port, _x((2, 16, 32)), f32)
    np.testing.assert_allclose(got, ref, atol=F32_TOL if f32 else DEEP_BF16_TOL,
                               rtol=0)


def _encoders(**kw):
    """(reference FunctionModel, port FunctionModel with its weights)."""
    cfg = dict(ENC, **kw)
    ref = ref_attention.transformer_encoder(**cfg, seed=0)
    port = transformer_encoder(**cfg, seed=1)
    params = jax.tree.map(np.asarray, ref.params)
    load_jax_params(port, params)
    return ref, port


def _tokens(n, seed=2, t=ENC["seq_len"], vocab=ENC["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, (n, t))


@pytest.mark.parametrize("f32", [True, False])
def test_transformer_encoder_matches_reference_with_taps(f32):
    ref, port = _encoders()
    assert port.module.layer_paths() == ref.module.layer_paths()
    assert port.layer_names == ref.layer_names
    assert port.output_names() == ref.output_names()
    ids = _tokens(3)
    taps = TAPS + [None]
    if f32:
        with ref_module.matmul_precision("float32"):
            want = ref.apply_taps(jnp.asarray(ids), taps)
        with matmul_precision("float32"):
            got = port.apply_taps(torch.from_numpy(ids), taps)
    else:
        want = ref.apply_taps(jnp.asarray(ids), taps)
        got = port.apply_taps(torch.from_numpy(ids), taps)
    assert set(got) == set(want)
    for t in taps:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                   atol=F32_TOL if f32 else DEEP_BF16_TOL,
                                   rtol=0, err_msg=str(t))
    assert got[None].shape == (3, 16, 5)


def test_function_model_addressing():
    ref, port = _encoders()
    for node in (None, "OUTPUT_0", "OUTPUT_2", "block1", "block0/attn/body/attn",
                 "transformer"):
        assert port.resolve_output(node) == ref.resolve_output(node)
    assert port.argument_names() == ref.argument_names() == ["ARGUMENT_0"]
    assert port.resolve_input("ARGUMENT_0") == "ARGUMENT_0"
    for bad in ("block9", "block0/mlp/fc1"):
        with pytest.raises(KeyError):
            port.resolve_output(bad)
    with pytest.raises(KeyError):
        port.resolve_input("ARGUMENT_1")
    ids = torch.from_numpy(_tokens(2))
    with matmul_precision("float32"):
        one = port.apply(ids, tap="block0/mlp/body/fc1")
        both = port.apply_taps(ids, ["block0/mlp/body/fc1"])
    assert torch.equal(one, both["block0/mlp/body/fc1"])
    assert one.shape == (2, 16, 128)


def test_cache_token_is_the_architecture_not_the_weights():
    a = transformer_encoder(**ENC, seed=0)
    b = transformer_encoder(**ENC, seed=1)
    assert a.cache_token() == b.cache_token()
    assert a.cache_token() != transformer_encoder(**dict(ENC, depth=3)).cache_token()
    assert a.cache_token() != transformer_encoder(
        **dict(ENC, num_heads=4)).cache_token()
    assert not torch.equal(a.params["embed"]["table"], b.params["embed"]["table"])


def test_device_params_follow_in_place_updates():
    m = transformer_encoder(**ENC, seed=0)
    first = m.device_params("cpu")
    # on its own device a parameter is used in place, not copied
    table = dict(m.module.named_parameters())["embed.table"]
    assert first["embed.table"].data_ptr() == table.data_ptr()
    assert m.device_params("cpu") is first
    ref, _ = _encoders()
    load_jax_params(m, jax.tree.map(np.asarray, ref.params))
    again = m.device_params("cpu")
    assert again is not first
    np.testing.assert_array_equal(again["embed.table"].detach().numpy(),
                                  np.asarray(ref.params["embed"]["table"]))


def test_weights_round_trip_and_mismatches_raise():
    ref = ref_attention.transformer_encoder(**ENC, seed=0)
    params = jax.tree.map(np.asarray, ref.params)
    port = transformer_encoder(**ENC, seed=5)
    load_jax_params(port, params)
    back = jax.tree.map(lambda t: t.detach().numpy(), port.params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    missing = jax.tree.map(lambda a: a, params)
    del missing["block1"]["mlp"]["body"]["fc2"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(port, missing)
    extra = jax.tree.map(lambda a: a, params)
    extra["head"]["scale"] = np.ones(5, np.float32)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(port, extra)
    shaped = jax.tree.map(lambda a: a, params)
    shaped["head"]["kernel"] = shaped["head"]["kernel"].T
    with pytest.raises(ValueError, match="head.kernel"):
        load_jax_params(port, shaped)
    # a raise leaves the weights as they were
    np.testing.assert_array_equal(port.params["head"]["kernel"].detach().numpy(),
                                  params["head"]["kernel"])


# ---------------------------------------------------------------------------
# the slice: DNNModel over a DataFrame
# ---------------------------------------------------------------------------


def _token_rows():
    rows = list(_tokens(7, seed=3))
    rows[4] = None
    return rows


def _stack(col):
    return [None if v is None else np.asarray(v) for v in col]


def _slice_outputs(stage_kw, f32):
    """(reference columns, port columns, port stage, port frame) of one
    DNNModel configuration over a 2-partition frame with a null row."""
    ref, port = _encoders()
    rows = _token_rows()
    cols = list(stage_kw.get("fetch", {}) or [stage_kw.get("out", "out")])
    ref_stage = RefDNNModel(inputCol="tokens", batchSize=3)
    stage = DNNModel(inputCol="tokens", batchSize=3)
    for s, m in ((ref_stage, ref), (stage, port)):
        s.set_model(m)
        if "fetch" in stage_kw:
            s.set_fetch_dict(stage_kw["fetch"])
        else:
            s.set("outputCol", "out")
            if "node" in stage_kw:
                s.set_output_node(stage_kw["node"])
    ref_df = RefDataFrame.from_dict({"tokens": rows}, num_partitions=2)
    df = DataFrame.from_dict({"tokens": rows}, num_partitions=2)
    if f32:
        with ref_module.matmul_precision("float32"):
            want = ref_stage.transform(ref_df)
        with matmul_precision("float32"), use_device("cpu"):
            got = stage.transform(df)
    else:
        want = ref_stage.transform(ref_df)
        with use_device("cpu"):
            got = stage.transform(df)
    return ({c: _stack(want.column(c)) for c in cols},
            {c: _stack(got.column(c)) for c in cols}, stage, df)


SLICE_CASES = [{}, {"node": "block1/mlp/body/fc1"}, {"node": "OUTPUT_2"},
               {"fetch": {"logits": "OUTPUT_0", "hidden": "ln_f"}}]


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("case", SLICE_CASES)
def test_dnn_model_slice_matches_reference(case, f32):
    want, got, stage, df = _slice_outputs(case, f32)
    for c in want:
        assert len(got[c]) == 7 and got[c][4] is None and want[c][4] is None
        w = np.stack([v for v in want[c] if v is not None])
        g = np.stack([v for v in got[c] if v is not None])
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=F32_TOL if f32 else DEEP_BF16_TOL,
                                   rtol=0, err_msg=c)
    st = stage.last_ingest_stats.summary()
    # 4 + 3 rows, one null: batches of 3 + 1 (padded to 3) and 3
    assert st["n_batches"] == 3 and st["rows"] == 6
    # the port's fused pipeline serves the same model, bitwise
    with use_device("cpu"), matmul_precision("float32" if f32 else "bfloat16"):
        fused = PipelineModel([stage]).fuse()
        out = fused.transform(df)
    stats = fused.fusion_stats()
    assert stats["fallbacks"] == [] and stats["n_fused_segments"] == 1
    for c in got:
        f = _stack(out.column(c))
        assert f[4] is None
        for a, b in zip(f, got[c]):
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_fused_program_cache_keeps_each_models_weights():
    """Two encoders of one architecture share the fused program cache (the
    key is the architecture, as the reference's): each still scores with
    its own weights, the same as its unfused transform."""
    df = DataFrame.from_dict({"tokens": list(_tokens(4))})
    outs = []
    for seed in (0, 1):
        m = transformer_encoder(**ENC, seed=seed)
        stage = DNNModel(inputCol="tokens", outputCol="o", batchSize=4)
        stage.set_model(m)
        with use_device("cpu"):
            fused = PipelineModel([stage]).fuse()
            got = np.stack(list(fused.transform(df).column("o")))
            want = np.stack(list(stage.transform(df).column("o")))
        np.testing.assert_array_equal(got, want)
        outs.append((got, fused.fusion_stats()["compile_cache"]))
    assert not np.array_equal(outs[0][0], outs[1][0])
    assert outs[1][1]["hits"] > outs[0][1]["hits"]


def test_dnn_model_transform_schema_and_params():
    _, port = _encoders()
    stage = DNNModel(inputCol="tokens", outputCol="emb").set_model(port)
    assert stage.get("batchSize") == 64 and stage.get("ringDepth") == 2
    df = DataFrame.from_dict({"tokens": list(_tokens(2))})
    assert stage.transform_schema(df.schema).types["emb"] == ColType.VECTOR
    stage.set_output_node_index(1)
    assert stage.get("outputNode") == "OUTPUT_1"
    fed = DNNModel(outputCol="emb").set_model(port).set_output_node_index(1)
    fed.set_feed_dict("ARGUMENT_0", "tokens")   # the primary input by name
    fed.set("donateInputs", True)   # accepted, no effect but a warning
    with use_device("cpu"):
        out = stage.transform(df)
        with pytest.warns(UserWarning, match="donateInputs"):
            out_fed = fed.transform(df)
    assert np.asarray(out.column("emb")[0]).shape == (16, 5)
    for a, b in zip(out.column("emb"), out_fed.column("emb")):
        np.testing.assert_array_equal(a, b)


def test_dnn_model_preprocess_runs_on_the_batch():
    """A PreprocessSpec (cast + scale) ahead of an embedding-free encoder
    equals the host-preprocessed input."""
    m = transformer_encoder(seq_len=8, dim=16, depth=1, num_heads=2, seed=0)
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 255, (5, 8, 16)).astype(np.uint8)
    spec = PreprocessSpec(scale=1 / 255.0, offset=-0.5)
    stage = DNNModel(inputCol="x", outputCol="y", batchSize=4).set_model(m)
    stage.set_preprocess(spec)
    plain = DNNModel(inputCol="x", outputCol="y", batchSize=4).set_model(m)
    with use_device("cpu"):
        a = stage.transform(DataFrame.from_dict({"x": list(raw)}))
        b = plain.transform(DataFrame.from_dict(
            {"x": list(spec.apply_host(raw))}))
    for u, v in zip(a.column("y"), b.column("y")):
        np.testing.assert_array_equal(u, v)


def test_dnn_model_unported_paths_raise():
    _, port = _encoders()
    df = DataFrame.from_dict({"tokens": list(_tokens(2))})
    stage = DNNModel(inputCol="tokens", outputCol="o", useMesh=True)
    stage.set_model(port)
    assert stage.device_fn(df.schema) is None
    with use_device("cpu"), pytest.raises(NotImplementedError, match="A9"):
        stage.transform(df)
    port.module.input_names = ["ids", "mask"]
    multi = DNNModel(outputCol="o").set_model(port)
    multi.set_feed_dict({"ids": "tokens", "mask": "tokens"})
    assert multi.device_fn(df.schema) is None
    with use_device("cpu"), pytest.raises(NotImplementedError, match="A7"):
        multi.transform(df)
    with pytest.raises(NotImplementedError, match="A9"):
        transformer_encoder(**ENC, ring_axis="seq", ring_axis_size=2)
    with pytest.raises(NotImplementedError, match="A9"):
        transformer_block(32, 2, moe_experts=4)
    for make in (lambda: attention.LSTM(8), lambda: attention.BiLSTM(8),
                 lambda: attention.bilstm_tagger(8, 10, 4, 4, 3)):
        with pytest.raises(NotImplementedError, match="A7"):
            make()


def test_dnn_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    _, port = _encoders()
    stage = DNNModel(inputCol="tokens", outputCol="o").set_model(port)
    with pytest.raises(RuntimeError, match="CUDA"):
        stage.transform(DataFrame.from_dict({"tokens": list(_tokens(2))}))


# ---------------------------------------------------------------------------
# batching and preprocessing helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,batch", [(7, 3), (10, 4), (5, 8), (9, 8)])
def test_minibatcher_matches_reference(n, batch):
    rng = np.random.default_rng(n)
    ints = np.empty(n, dtype=object)
    for i in range(n):
        ints[i] = rng.integers(0, 9, 4)
    part = {"ids": ints, "x": rng.standard_normal((n, 3))}
    kw = dict(bucket=True, dtype=np.float32, preserve_int=True)
    ref = list(ref_batching.Minibatcher(batch, **kw).batches(part, ["ids", "x"]))
    got = list(batching.Minibatcher(batch, **kw).batches(part, ["ids", "x"]))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.num_valid == b.num_valid
        np.testing.assert_array_equal(a.mask, b.mask)
        for c in ("ids", "x"):
            assert a.arrays[c].dtype == b.arrays[c].dtype
            np.testing.assert_array_equal(a.arrays[c], b.arrays[c])
    assert got[0].arrays["ids"].dtype == np.int64   # preserve_int
    outs = [batching._crop({"y": b.arrays["x"] * 2, "z": (b.arrays["x"],)},
                           b.num_valid)
            for b in batching.Minibatcher(batch, **kw).batches(part, ["x"])]
    ref_outs = ref_batching.Minibatcher(batch, **kw).map_batches(
        part, ["x"], lambda arrs: {"y": arrs["x"] * 2, "z": (arrs["x"],)})
    got_cat = batching.concat_outputs(outs)
    ref_cat = ref_batching.concat_outputs(ref_outs)
    np.testing.assert_array_equal(got_cat["y"], ref_cat["y"])
    np.testing.assert_array_equal(got_cat["z"][0], ref_cat["z"][0])
    assert got_cat["y"].shape == (n, 3)


@pytest.mark.parametrize("kw", [dict(scale=1 / 255.0), dict(offset=-0.5),
                                dict(scale=2.0, transpose=(2, 0, 1)),
                                dict(dtype="float64", scale=0.1)])
def test_preprocess_spec_matches_reference(kw):
    x = np.random.default_rng(0).integers(0, 255, (3, 4, 5, 2)).astype(np.uint8)
    ref = RefPreprocessSpec(**kw)
    spec = PreprocessSpec(**kw)
    assert spec.cache_key() == ref.cache_key()
    host = spec.apply_host(x)
    np.testing.assert_array_equal(host, ref.apply_host(x))
    if spec.dtype == "float32":   # the reference's device op needs x64 for f64
        np.testing.assert_array_equal(
            host, np.asarray(ref.apply_device(jnp.asarray(x))))
    dev = spec.apply_device(torch.from_numpy(x))
    np.testing.assert_array_equal(dev.numpy(), host)


def test_ring_yields_arrays_apart_from_its_readback_slots():
    """The ring copies each batch's outputs into its readback slots (one per
    ring slot and output, reused) and yields copies of them: an earlier
    batch's arrays keep their values after later batches overwrite the
    slots, and match an unpipelined ring's."""
    from mmlspark_tpu_torch.parallel.ingest import ReadbackSlots, TransferRing

    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((8, 5)).astype(np.float32) for _ in range(7)]

    def run(depth, slots):
        ring = TransferRing(iter(batches), put=torch.from_numpy,
                            step=lambda x: x * 2.0 + 1.0,
                            fetch=lambda y: (y, y[:2].double()), depth=depth,
                            slots=slots)
        return list(ring)

    slots = ReadbackSlots(pin=False)
    outs = run(2, slots)
    assert len(slots._bufs) == 2 * 2          # depth x outputs, reused
    bufs = [b.numpy() for b in slots._bufs.values()]
    for out, x in zip(outs, batches):
        np.testing.assert_array_equal(out[0], x * 2.0 + 1.0)
        np.testing.assert_array_equal(out[1], (x[:2] * 2.0 + 1.0).astype(np.float64))
        assert not any(np.shares_memory(a, b) for a in out for b in bufs)
    for a, b in zip(outs, run(1, None)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- persistence


def _score_cols(df, cols):
    return {c: np.stack([np.asarray(v, dtype=np.float64)
                         for v in df.column(c)]) for c in cols}


def _gbdt_model(kind, categorical):
    """A port-trained model of one kind over seeded rows, its frame and the
    columns its transform writes."""
    rng = np.random.default_rng(17)
    n = 400
    X = rng.standard_normal((n, 4))
    X[:, 0] = rng.integers(0, 12, n)
    y = np.isin(X[:, 0], (1, 4, 6, 9)).astype(np.float64) + 0.2 * X[:, 1]
    X[rng.random((n, 4)) < 0.03] = np.nan
    kw = dict(numIterations=4, numLeaves=6, minDataInLeaf=5)
    if categorical:
        kw["categoricalSlotIndexes"] = [0]
    cols = {"features": [r for r in X], "label": (y > 0.5).astype(np.float64)}
    if kind == "regressor":
        cols["label"] = y
        est = stages.LightGBMRegressor(**kw)
    elif kind == "ranker":
        cols["group"] = np.repeat(np.arange(n // 20), 20)
        cols["label"] = np.clip(np.round(y * 2), 0, 3)
        est = stages.LightGBMRanker(groupCol="group", **kw)
    else:
        est = stages.LightGBMClassifier(**kw)
    df = DataFrame.from_dict(cols, num_partitions=2)
    with use_device("cpu"):
        model = est.fit(df)
    out = ("rawPrediction", "probability", "prediction") \
        if kind == "classifier" else ("prediction",)
    return model, df.select("features"), out


@pytest.mark.parametrize("categorical", [False, True])
@pytest.mark.parametrize("kind", ["classifier", "regressor", "ranker"])
def test_gbdt_model_save_load_bitwise(tmp_path, kind, categorical):
    """A saved model stage loads to the same Booster string and the same
    transform, bit for bit; its Booster is stored as JSON text, no pickle."""
    from mmlspark_tpu_torch.core.pipeline import PipelineStage

    model, df, cols = _gbdt_model(kind, categorical)
    with use_device("cpu"):
        want = _score_cols(model.transform(df), cols)
        model.save(str(tmp_path / "m"))
        loaded = PipelineStage.load(str(tmp_path / "m"))
        got = _score_cols(loaded.transform(df), cols)
    assert type(loaded) is type(model)
    assert loaded.get_model_string() == model.get_model_string()
    assert loaded.booster.to_string() == model.booster.to_string()
    for c in cols:
        np.testing.assert_array_equal(got[c], want[c])
    files = [f for _, _, fs in os.walk(tmp_path / "m") for f in fs]
    assert "text.txt" in files and not any(f.endswith(".pkl") for f in files)
    assert any(t.cat_sets is not None for g in loaded.booster.trees
               for t in g) == categorical


@pytest.mark.parametrize("fused", [False, True])
def test_pipeline_model_save_load_bitwise(tmp_path, fused):
    """A PipelineModel, fused or not, saves its stages and loads back as a
    PipelineModel whose transform, unfused and fused, is the original's."""
    from mmlspark_tpu_torch.core.pipeline import PipelineStage

    clf, df, cols = _gbdt_model("classifier", True)
    reg, _, _ = _gbdt_model("regressor", False)
    reg.set("predictionCol", "reg_prediction")
    pm = PipelineModel([clf, reg])
    stage = pm.fuse() if fused else pm
    names = cols + ("reg_prediction",)
    with use_device("cpu"):
        want = _score_cols(stage.transform(df), names)
        stage.save(str(tmp_path / "p"))
        loaded = PipelineStage.load(str(tmp_path / "p"))
        got = _score_cols(loaded.transform(df), names)
        got_fused = _score_cols(loaded.fuse().transform(df), names)
    assert type(loaded) is PipelineModel and len(loaded.stages) == 2
    for c in names:
        np.testing.assert_array_equal(got[c], want[c])
        np.testing.assert_array_equal(got_fused[c], want[c])


def test_dnn_model_save_load_bitwise(tmp_path):
    """DNNModel with its FunctionModel's weights and a PreprocessSpec."""
    from mmlspark_tpu_torch.core.pipeline import PipelineStage

    _, port = _encoders()
    stage = DNNModel(inputCol="tokens", outputCol="out", batchSize=3)
    stage.set_model(port)
    df = DataFrame.from_dict({"tokens": _token_rows()}, num_partitions=2)
    with use_device("cpu"):
        want = _stack(stage.transform(df).column("out"))
        stage.save(str(tmp_path / "d"))
        loaded = PipelineStage.load(str(tmp_path / "d"))
        got = _stack(loaded.transform(df).column("out"))
    assert loaded.get("batchSize") == 3
    assert loaded.get_model().cache_token() == port.cache_token()
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_stage_directory_of_the_jax_package_is_refused(tmp_path):
    """A stage the JAX package saved names its classes; the port refuses
    the directory (and any pickle of that package's objects) and says how
    to carry the model across instead."""
    import pickle

    from mmlspark_tpu_torch.core import serialize
    from mmlspark_tpu_torch.core.pipeline import PipelineStage

    X = _sparse_matrix()
    ref_df = RefDataFrame.from_dict({"features": _rows(X, False),
                                     "label": (X[:, 0] > 0).astype(float)})
    ref = ref_stages.LightGBMClassifier(numIterations=2, numLeaves=4).fit(ref_df)
    ref.save(str(tmp_path / "ref"))
    with pytest.raises(ValueError, match="JAX package saved"):
        PipelineStage.load(str(tmp_path / "ref"))
    (tmp_path / "v.pkl").write_bytes(pickle.dumps(ref_stages.LightGBMClassifier))
    with pytest.raises(ValueError, match="object of the JAX package"):
        serialize._unpickle(str(tmp_path / "v.pkl"))
    # the model itself crosses as the Booster's JSON
    port = stages.LightGBMClassificationModel(
        booster=convert.booster_from_reference(ref.get_model_string()),
        featuresCol="features")
    with use_device("cpu"):
        raw = _score_cols(port.transform(DataFrame.from_dict(
            {"features": _rows(X, False)})), ("rawPrediction",))
    np.testing.assert_allclose(raw["rawPrediction"], _score_cols(
        ref.transform(RefDataFrame.from_dict({"features": _rows(X, False)})),
        ("rawPrediction",))["rawPrediction"], rtol=0, atol=PORT_VS_REF_ATOL)
