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
"""

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
from mmlspark_tpu_torch.core import faults, kernels
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device_stage import CompileCache
from mmlspark_tpu_torch.core.fusion import (FusedPipelineModel, SegmentExecutor,
                                            _HostFallback, _stack_col, plan)
from mmlspark_tpu_torch.core.pipeline import PipelineModel, Transformer
from mmlspark_tpu_torch.gbdt import convert, gather_kernel, predict, stages
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


def _port_gather(indptr, indices, values, width, used):
    t = [torch.from_numpy(np.asarray(a)) for a in (indptr, indices, values)]
    return gather_kernel.csr_gather(*t, width, torch.from_numpy(
        np.asarray(used, dtype=np.int32))).numpy()


@pytest.mark.parametrize("indptr,indices,values,width,used", _gather_cases())
def test_k3_plain_bitwise_equals_reference(indptr, indices, values, width, used):
    got = _port_gather(indptr, indices, values, width, used)
    xla = np.asarray(pallas_sparse.csr_gather_xla(indptr, indices, values,
                                                  width, used))
    pallas = np.asarray(pallas_sparse.csr_gather_pallas(
        indptr, indices, values, width, used, interpret=True))
    np.testing.assert_array_equal(_bits(got), _bits(xla))
    np.testing.assert_array_equal(_bits(got), _bits(pallas))


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
