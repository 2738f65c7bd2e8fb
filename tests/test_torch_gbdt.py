"""The port's GBDT path against the JAX reference, on the CPU.

Every test feeds the same inputs (numpy, from a seed) to the reference
(``mmlspark_tpu.gbdt``) and to the port (``mmlspark_tpu_torch.gbdt``, run
with ``device="cpu"`` / ``use_device("cpu")``). The reference is pinned to
its device-style path: ``MMLSPARK_TPU_NATIVE_TRAIN=0`` (no C++ engine) and
``MMLSPARK_TPU_FUSED_TREE=1`` (the whole-tree grower the port mirrors).

Trees must be identical in structure and predictions agree within 1e-6
(relative where the scores are large). They are not bit-equal: the port
accumulates histograms in f64 and rounds once, the reference adds rows in
f32, so leaf sums differ in the last bits.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as RefDataFrame
from mmlspark_tpu.gbdt import binning as ref_binning
from mmlspark_tpu.gbdt import booster as ref_booster
from mmlspark_tpu.gbdt import histogram as ref_hist
from mmlspark_tpu.gbdt import predict as ref_predict
from mmlspark_tpu.gbdt import stages as ref_stages
from mmlspark_tpu.gbdt import tree as ref_tree
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.gbdt import binning, booster, convert, histogram, predict
from mmlspark_tpu_torch.gbdt import lgbm_format, stages, tree
from mmlspark_tpu_torch.runtime import use_device

from test_benchmarks import _base_params
from test_gbdt_categorical import cat_data

RES = os.path.join(os.path.dirname(__file__), "resources")
STRUCT = ("feature", "threshold_bin", "left", "right", "default_left", "count")


@pytest.fixture
def ref_device_path(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    monkeypatch.setenv("MMLSPARK_TPU_FUSED_TREE", "1")


def _assert_same_tree(a, b, where=""):
    for fld in STRUCT:
        np.testing.assert_array_equal(getattr(a, fld), getattr(b, fld),
                                      err_msg=f"{where} {fld}")
    np.testing.assert_array_equal(a.threshold, b.threshold, err_msg=where)
    # leaf values come from f32 (grad, hess) sums: the reference adds rows
    # in f32 one by one, the port accumulates in f64 and rounds once
    np.testing.assert_allclose(a.value, b.value, rtol=1e-5, atol=1e-7,
                               err_msg=where)


def _assert_same_forest(ref, port):
    assert len(ref.trees) == len(port.trees)
    for i, (gr, gp) in enumerate(zip(ref.trees, port.trees)):
        assert len(gr) == len(gp)
        for k, (a, b) in enumerate(zip(gr, gp)):
            _assert_same_tree(a, b, f"iteration {i} class {k}")


# ---------------------------------------------------------------- components


def test_binning_edges_and_bins_match():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((6000, 7))
    X[:, 2] = np.round(X[:, 2] * 3)          # few distinct values
    X[:, 5] = 1.0                             # constant
    X[rng.random(X.shape) < 0.05] = np.nan    # missing
    r = ref_binning.BinMapper.fit(X, 63, seed=3)
    p = binning.BinMapper.fit(X, 63, seed=3)
    assert len(r.edges) == len(p.edges)
    for er, ep in zip(r.edges, p.edges):
        np.testing.assert_array_equal(er, ep)
    np.testing.assert_array_equal(r.transform_fm(X, dtype=np.int32),
                                  p.transform_fm(X, dtype=np.int32))
    assert r.max_num_bins == p.max_num_bins


@pytest.mark.parametrize("l1,l2,msh,mdl,masked", [
    (0.0, 0.0, 1e-3, 20, False),
    (0.1, 1.0, 1e-3, 5, False),
    (0.0, 0.5, 10.0, 50, True),
])
def test_find_best_split_matches(l1, l2, msh, mdl, masked):
    rng = np.random.default_rng(11)
    f, b, n = 9, 64, 4000
    bins = rng.integers(0, b, (f, n)).astype(np.int32)
    grad = rng.standard_normal(n).astype(np.float32)
    hess = (rng.random(n) + 0.1).astype(np.float32)
    mask = rng.random(n) < 0.7
    hist = np.array(ref_hist.compute_histogram_xla(bins, grad, hess, mask, b))
    fm = rng.random(f) < 0.5 if masked else None
    r = ref_hist.find_best_split(hist, np.float32(l1), np.float32(l2),
                                 np.float32(msh), mdl, fm)
    p = histogram.find_best_split(torch.from_numpy(hist), l1, l2, msh, mdl,
                                  torch.from_numpy(fm) if masked else None)
    for name, rv, pv in zip(("feature", "bin", "gain", "default_left",
                             "left_sum", "right_sum"), r, p):
        np.testing.assert_array_equal(np.asarray(rv), pv.numpy(), err_msg=name)
    pair = histogram.find_best_split_pair(
        torch.from_numpy(np.stack([hist, hist[:, ::-1].copy()])), l1, l2, msh,
        mdl, torch.from_numpy(fm) if masked else None)
    assert int(pair.feature[0]) == int(r.feature)
    assert int(pair.bin[0]) == int(r.bin)


@pytest.mark.parametrize("with_feature_mask", [False, True])
def test_fused_tree_matches_at_40k_rows(ref_device_path, with_feature_mask):
    """40,960 rows: the small-child compaction tier (n/8 = 5120 rows)
    engages, so the tier path and the full-width path both run."""
    rng = np.random.default_rng(21)
    n, f = 40_960, 6
    X = rng.standard_normal((n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(n) > 0)
    mapper = ref_binning.BinMapper.fit(X, 255, seed=0)
    pmapper = binning.BinMapper.fit(X, 255, seed=0)
    bins = mapper.transform_fm(X, dtype=np.int32)
    p = 1.0 / (1.0 + np.exp(-0.3 * X[:, 3]))
    grad = (p - y).astype(np.float32)
    hess = np.maximum(p * (1 - p), 1e-16).astype(np.float32)
    mask = rng.random(n) < 0.9
    fm = np.array([True, True, False, True, True, True]) if with_feature_mask \
        else None
    nb = mapper.max_num_bins
    assert tree.tier_caps(n, False) == (5120,)
    rcfg = ref_tree.GrowerConfig(num_leaves=15, min_data_in_leaf=20,
                                 lambda_l1=0.05, lambda_l2=1.0)
    pcfg = tree.GrowerConfig(num_leaves=15, min_data_in_leaf=20,
                             lambda_l1=0.05, lambda_l2=1.0)
    rt, rrows = ref_tree.grow_tree(bins, grad, hess, mask, nb, rcfg, mapper,
                                   feature_mask=fm)
    pt, prows = tree.grow_tree(torch.from_numpy(bins), torch.from_numpy(grad),
                               torch.from_numpy(hess), torch.from_numpy(mask),
                               nb, pcfg, pmapper,
                               torch.from_numpy(fm) if fm is not None else None)
    assert rt.num_leaves == 15
    _assert_same_tree(rt, pt)
    np.testing.assert_allclose(rt.gain, pt.gain, rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(rrows), prows.numpy())


@pytest.mark.parametrize("num_class", [1, 3])
def test_kahan_add_leaf_values_matches(num_class):
    rng = np.random.default_rng(2)
    n, m = 3000, 9
    shape = (n,) if num_class == 1 else (n, num_class)
    score = (rng.standard_normal(shape) * 100).astype(np.float32)
    comp = (rng.standard_normal(shape) * 1e-6).astype(np.float32)
    rows = rng.integers(0, m, n).astype(np.int32)
    r_s, r_c, p_s, p_c = score, comp, torch.from_numpy(score), torch.from_numpy(comp)
    for step in range(4):
        vals = (rng.standard_normal(m) * 1e-3).astype(np.float32)
        kk = None if num_class == 1 else step % num_class
        r_s, r_c = ref_booster._add_leaf_values(r_s, r_c, vals, rows, kk)
        p_s, p_c = booster._add_leaf_values(p_s, p_c, torch.from_numpy(vals),
                                            torch.from_numpy(rows), kk)
    np.testing.assert_array_equal(np.asarray(r_s), p_s.numpy())
    np.testing.assert_array_equal(np.asarray(r_c), p_c.numpy())


def test_xla_exp_matches_reference_objective():
    x = np.random.default_rng(4).standard_normal(50_000).astype(np.float32) * 6
    y = (x > 0.3).astype(np.float32)
    rg, rh = ref_booster.grad_hess("binary", x, y)
    pg, ph = booster.grad_hess("binary", torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(np.asarray(rg), pg.numpy())
    np.testing.assert_array_equal(np.asarray(rh), ph.numpy())


# ------------------------------------------------------------------ full fit


def _datasets():
    from sklearn.datasets import load_breast_cancer, load_diabetes, load_wine

    return {"breast_cancer": load_breast_cancer(), "wine": load_wine(),
            "diabetes": load_diabetes()}


def _frames(X, y):
    rows = [X[i] for i in range(len(X))]
    return (RefDataFrame.from_dict({"features": rows, "label": y}, num_partitions=2),
            DataFrame.from_dict({"features": rows, "label": y}, num_partitions=2))


def _committed():
    import csv

    with open(os.path.join(RES, "benchmarks_VerifyLightGBM.csv")) as fh:
        return {r["name"]: r for r in csv.DictReader(fh)}


def _benchmark_value(dataset, estimator, out):
    """The committed benchmark's metric (tests/test_benchmarks.py protocol):
    train AUC, train accuracy or train R^2."""
    data = _datasets()[dataset]
    if dataset == "breast_cancer":
        from sklearn.metrics import roc_auc_score

        return float(roc_auc_score(
            data.target, np.stack(list(out.column("probability")))[:, 1]))
    if dataset == "wine":
        return float((out.column("prediction") == data.target).mean())
    pred = np.asarray(out.column("prediction"), dtype=np.float64)
    ss_res = float(((pred - data.target) ** 2).sum())
    return 1.0 - ss_res / float(((data.target - data.target.mean()) ** 2).sum())


# Every row of the committed benchmark CSV (dataset x boosting type), plus a
# bagging + feature-fraction case. That case runs on wine: on breast_cancer
# the same draw makes iteration 4 choose between features 20 and 23 (worst
# radius and worst area order the rows identically), whose gains then differ
# only by summation rounding; the port sums histograms in f64, the
# reference in f32, so that tie can go either way.
_ROWS = [(ds, est, bt) for bt in ("gbdt", "rf", "dart", "goss")
         for ds, est in (("breast_cancer", "LightGBMClassifier"),
                         ("wine", "LightGBMClassifier"),
                         ("diabetes", "LightGBMRegressor"))]
_FITS = [(ds, est, bt, {}) for ds, est, bt in _ROWS] + [
    ("wine", "LightGBMClassifier", "gbdt",
     {"baggingFraction": 0.7, "baggingFreq": 1, "featureFraction": 0.6}),
]

# wine under rf: at iteration 0, class 1, node 2, two splits (feature 4 bin
# 11 and feature 0 bin 49) send different rows left with the same label mix.
# Every row of a class starts from one score, so the two gains are equal in
# exact arithmetic; the port's f64 sums keep them equal and take the lowest
# feature, the reference's f32 sums break the tie by rounding and take
# feature 4 (ROADMAP section C). test_rf_wine_exact_tie holds that node.
_EXACT_TIES = {("wine", "rf"): (0, 1, 2)}


def _assert_same_forest_until(ref, port, tie):
    """Identical trees up to the node ``tie`` = (iteration, class, node),
    where the two fits may part."""
    it, cls, node = tie
    for i in range(it):
        for k, (a, b) in enumerate(zip(ref.trees[i], port.trees[i])):
            _assert_same_tree(a, b, f"iteration {i} class {k}")
    for k in range(cls):
        _assert_same_tree(ref.trees[it][k], port.trees[it][k],
                          f"iteration {it} class {k}")
    a, b = ref.trees[it][cls], port.trees[it][cls]
    for fld in ("feature", "threshold_bin"):
        np.testing.assert_array_equal(getattr(a, fld)[:node],
                                      getattr(b, fld)[:node])


@pytest.mark.parametrize("dataset,estimator,boosting,extra", _FITS)
def test_full_fit_matches_reference(ref_device_path, dataset, estimator,
                                    boosting, extra):
    data = _datasets()[dataset]
    y = data.target.astype(np.float64)
    rdf, pdf = _frames(data.data, y)
    params = dict(_base_params(boosting), **extra)
    rmodel = getattr(ref_stages, estimator)(**params).fit(rdf)
    with use_device("cpu"):
        pmodel = getattr(stages, estimator)(**params).fit(pdf)
        pout = pmodel.transform(pdf)
    rout = rmodel.transform(rdf)
    tie = _EXACT_TIES.get((dataset, boosting)) if not extra else None
    if tie is not None:
        _assert_same_forest_until(rmodel.booster, pmodel.booster, tie)
    else:
        _assert_same_forest(rmodel.booster, pmodel.booster)
        col = ("probability" if estimator == "LightGBMClassifier"
               else "prediction")
        rv = np.stack(list(rout.column(col))).astype(np.float64)
        pv = np.stack(list(pout.column(col))).astype(np.float64)
        # transform scores through an f32 forest sum on both sides, in
        # another summation order: relative 1e-6 (the f64 host scores below
        # are exact)
        np.testing.assert_allclose(pv, rv, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pmodel.booster.raw_predict(data.data),
                                   rmodel.booster.raw_predict(data.data),
                                   rtol=1e-6, atol=1e-6)

    if extra:
        return
    # the committed benchmark gate (tests/test_benchmarks.py protocol): the
    # reference meets all 12 rows on this path, and so must the port
    row = _committed()[f"{estimator}_{dataset}_{boosting}"]
    value = _benchmark_value(dataset, estimator, pout)
    assert value - float(row["value"]) + float(row["precision"]) > 0, (
        value, row)


def test_rf_wine_exact_tie():
    """The node where the rf wine fits part (``_EXACT_TIES``): both splits'
    gains from exact f64 sums over the node's rows are equal, and the port,
    summing in f64, takes the lowest feature as the split search does for
    any exact tie."""
    data = _datasets()["wine"]
    X, y = data.data, data.target.astype(np.float64)
    params = booster.TrainParams(
        objective="multiclass", num_class=3, boosting_type="rf",
        num_leaves=5, num_iterations=1, min_data_in_leaf=20, seed=42,
        bagging_fraction=0.9, bagging_freq=1)
    pb = booster.train(params, X, y, device="cpu")
    t = pb.trees[0][1]
    assert (int(t.feature[2]), int(t.threshold_bin[2])) == (0, 49)
    # the fit's bagging draw and its class-1 gradients at iteration 0
    n = len(y)
    bag = np.random.default_rng(42).random(n + (-n) % booster.ROW_MULTIPLE)
    bag = bag[:n] < 0.9
    scores = torch.tensor(np.tile(pb.base_score, (n, 1)), dtype=torch.float32)
    g, h = booster.grad_hess("multiclass", scores,
                             torch.tensor(y, dtype=torch.float32))
    g, h = g[:, 1].double().numpy(), h[:, 1].double().numpy()
    bins = pb.bin_mapper.transform_fm(X, dtype=np.int32)
    node = bag & (bins[int(t.feature[0])] > int(t.threshold_bin[0]))

    def gain(f, b):
        left = node & (bins[f] <= b)
        gl, hl, gt, ht = g[left].sum(), h[left].sum(), g[node].sum(), h[node].sum()
        return gl * gl / hl + (gt - gl) ** 2 / (ht - hl) - gt * gt / ht

    left4, left0 = node & (bins[4] <= 11), node & (bins[0] <= 49)
    assert left4.sum() == left0.sum() and not np.array_equal(left4, left0)
    np.testing.assert_allclose(gain(4, 11), gain(0, 49), rtol=1e-12)


# -------------------------------------------------------------- carry across


@pytest.fixture(scope="module")
def ref_models():
    old = {k: os.environ.get(k) for k in ("MMLSPARK_TPU_NATIVE_TRAIN",
                                          "MMLSPARK_TPU_FUSED_TREE")}
    os.environ["MMLSPARK_TPU_NATIVE_TRAIN"] = "0"
    os.environ["MMLSPARK_TPU_FUSED_TREE"] = "1"
    try:
        out = {}
        ds = _datasets()
        rng = np.random.default_rng(9)
        for name, obj, nc in (("breast_cancer", "binary", 1),
                              ("wine", "multiclass", 3)):
            X = ds[name].data.copy()
            X[rng.random(X.shape) < 0.03] = np.nan     # exercise missing
            params = ref_booster.TrainParams(objective=obj, num_class=nc,
                                             num_leaves=7, num_iterations=8)
            out[name] = (ref_booster.train(params, X, ds[name].target.astype(
                np.float64)), X, nc)
        return out
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("impl", ["gemm", "gather"])
@pytest.mark.parametrize("name", ["breast_cancer", "wine"])
def test_carried_across_scoring_matches(ref_models, name, impl):
    rb, X, nc = ref_models[name]
    pb = convert.booster_from_reference(rb.to_string())
    _assert_same_forest(rb, pb)
    ref_raw = ref_predict.DeviceEnsemble(rb.trees, nc).predict_raw(X)
    ens = predict.DeviceEnsemble(pb.trees, nc, device="cpu", impl=impl)
    np.testing.assert_allclose(ens.predict_raw(X), ref_raw, rtol=0, atol=1e-6)
    host = predict.predict_ensemble(pb.trees, X, nc)
    np.testing.assert_allclose(ens.predict_raw(X), host, rtol=0, atol=1e-5)


def test_booster_from_arrays_matches_reference_string(ref_models):
    rb, X, nc = ref_models["wine"]
    trees = [[{k: getattr(t, k) for k in ("feature", "threshold", "threshold_bin",
                                           "default_left", "left", "right", "value",
                                           "gain", "count", "shrinkage")}
              for t in g] for g in rb.trees]
    pb = convert.booster_from_arrays(dataclasses.asdict(rb.params), rb.base_score,
                                     rb.bin_mapper.edges, trees)
    _assert_same_forest(rb, pb)
    np.testing.assert_array_equal(pb.raw_predict(X), rb.raw_predict(X))


def test_weights_and_init_scores_match_reference(ref_device_path):
    from sklearn.datasets import load_diabetes

    data = load_diabetes()
    rng = np.random.default_rng(8)
    X, y = data.data, data.target.astype(np.float64)
    w = rng.random(len(y)) + 0.5
    init = rng.standard_normal(len(y)) * 5 + y.mean()
    kw = dict(objective="regression", num_leaves=6, num_iterations=6, seed=3)
    rb = ref_booster.train(ref_booster.TrainParams(**kw), X, y, weights=w,
                           init_scores=init)
    pb = booster.train(booster.TrainParams(**kw), X, y, weights=w,
                       init_scores=init, device="cpu")
    _assert_same_forest(rb, pb)
    np.testing.assert_allclose(pb.raw_predict(X), rb.raw_predict(X),
                               rtol=1e-6, atol=1e-6)


def test_train_step_seam_and_recorder(monkeypatch):
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.obs import metrics

    # the per-iteration loop's seam (a fit this small takes the native
    # engine by default, whose seam carries engine="native")
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    X = np.random.default_rng(0).standard_normal((300, 3))
    y = X[:, 0] * 2.0
    params = booster.TrainParams(num_iterations=4, num_leaves=4)
    seen = []

    def hook(point, iteration):
        seen.append((point, iteration))
        if iteration == 2:
            raise OSError("injected")

    prev_reg = metrics.set_default_registry(metrics.MetricsRegistry())
    prev = faults.install(hook)
    try:
        with pytest.raises(OSError, match="injected"):
            booster.train(params, X, y, device="cpu")
        steps = metrics.default_registry().counter(
            "mmlspark_train_steps_total", labelnames=("engine",))
        assert steps.labels(engine="gbdt").value == 2.0
    finally:
        faults.install(prev)
        metrics.set_default_registry(prev_reg)
    assert seen == [(faults.TRAIN_STEP, i) for i in range(3)]


# ------------------------------------------------------------------ ranking


def _ranking_inputs(sizes, seed, equal_scores=False):
    """Contiguous groups of the given sizes, relevance 0-4 skewed to 0."""
    rng = np.random.default_rng(seed)
    groups = np.repeat(np.arange(len(sizes)), sizes)
    n = len(groups)
    labels = np.minimum(rng.geometric(0.55, n) - 1, 4).astype(np.float32)
    scores = (np.zeros(n) if equal_scores
              else rng.standard_normal(n)).astype(np.float32)
    return scores, labels, groups


# singletons; sizes across buckets 2..64; every score equal (iteration 0,
# where only a stable argsort ranks like the reference); a bucket cut into
# chunks (the pair budget shrunk in both packages)
_LAMBDARANK = {
    "singletons": (dict(sizes=[1] * 9 + [3, 1, 2]), None),
    "buckets": (dict(sizes=[1, 2, 3, 4, 5, 8, 9, 17, 31, 33, 64, 7, 1, 12]),
                None),
    "equal_scores": (dict(sizes=[5, 16, 3, 40, 2, 9], equal_scores=True),
                     None),
    "chunked": (dict(sizes=[30, 29, 32, 17, 25, 31, 20, 3, 26]), 3 * 32 * 32),
}


@pytest.mark.parametrize("case", list(_LAMBDARANK))
def test_lambdarank_grad_hess_matches(monkeypatch, case):
    kw, budget = _LAMBDARANK[case]
    if budget is not None:
        monkeypatch.setattr(ref_booster, "_LAMBDARANK_PAIR_BUDGET", budget)
        monkeypatch.setattr(booster, "_LAMBDARANK_PAIR_BUDGET", budget)
    scores, labels, groups = _ranking_inputs(seed=len(case), **kw)
    rg, rh = ref_booster.grad_hess("lambdarank", scores, labels, groups=groups)
    pg, ph = booster.grad_hess("lambdarank", torch.from_numpy(scores),
                               torch.from_numpy(labels), groups=groups)
    # the [m, G, G] pairwise sums reduce in another order: ulps, not bits
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ph.numpy(), np.asarray(rh), rtol=1e-6, atol=1e-7)
    seg = booster.segment_groups(groups)
    if budget is not None:
        assert any(m * gb * gb > budget for gb, _, _, _, m in seg.buckets)
    assert np.count_nonzero(pg.numpy()) > 0 or case == "singletons"


def test_segment_groups_raises_for_groups_that_are_not_contiguous():
    with pytest.raises(ValueError) as ref_err:
        ref_booster.segment_groups(np.array([0, 0, 1, 1, 0]))
    with pytest.raises(ValueError) as port_err:
        booster.segment_groups(np.array([0, 0, 1, 1, 0]))
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("case", ["ties", "not_contiguous"])
def test_ndcg_equals_reference_bit_for_bit(case):
    rng = np.random.default_rng(31)
    n = 900
    scores = np.round(rng.standard_normal(n), 1)          # many tied scores
    labels = np.minimum(rng.geometric(0.5, n) - 1, 4).astype(np.float64)
    if case == "ties":
        groups = np.repeat(np.arange(60), 15)
    else:
        groups = rng.integers(0, 45, n) * 7 - 20          # interleaved ids
    labels[groups == groups[0]] = 0.0                      # an idcg-0 group
    ref = ref_booster._ndcg(scores, labels, groups)
    port = booster._ndcg(scores, labels, groups)
    assert port == ref
    assert booster.eval_metric("ndcg", scores, labels, groups) == ref
    assert booster._ndcg(scores, labels, None) == \
        ref_booster._ndcg(scores, labels, None)


def _ranker_frames(n, n_groups, rel_noise, vmask=None):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 4))
    groups = np.repeat(np.arange(n_groups), n // n_groups)
    rel = np.clip(np.round(X[:, 0] + rel_noise * rng.normal(size=n)) + 1, 0, 3) \
        if rel_noise else np.clip(np.round(X[:, 0]) + 1, 0, 3)
    rows = [X[i] for i in range(n)]
    d = {"features": rows, "label": rel, "query": groups}
    if vmask is not None:
        d["isVal"] = vmask
    return (X, RefDataFrame.from_dict(d, num_partitions=2),
            DataFrame.from_dict(d, num_partitions=2))


# tests/test_gbdt.py's ranker stage fits: plain, and with a validation
# indicator and early stopping
_RANKERS = {
    "plain": (dict(n=300, n_groups=30, rel_noise=0.2),
              dict(numIterations=15, numLeaves=7, minDataInLeaf=3)),
    "validation": (dict(n=200, n_groups=20, rel_noise=0.0),
                   dict(numIterations=10, numLeaves=7, minDataInLeaf=3,
                        earlyStoppingRound=3, validationIndicatorCol="isVal")),
}


@pytest.mark.parametrize("case", list(_RANKERS))
def test_ranker_fit_matches_reference(ref_device_path, case):
    data_kw, params = _RANKERS[case]
    vmask = (np.repeat(np.arange(data_kw["n_groups"]), data_kw["n"]
                       // data_kw["n_groups"]) >= 15
             if "validationIndicatorCol" in params else None)
    X, rdf, pdf = _ranker_frames(vmask=vmask, **data_kw)
    rmodel = ref_stages.LightGBMRanker(groupCol="query", **params).fit(rdf)
    with use_device("cpu"):
        pmodel = stages.LightGBMRanker(groupCol="query", **params).fit(pdf)
        pout = pmodel.transform(pdf)
    _assert_same_forest(rmodel.booster, pmodel.booster)
    assert pmodel.booster.best_iteration == rmodel.booster.best_iteration
    np.testing.assert_allclose(
        np.asarray(pout.column("prediction"), dtype=np.float64),
        np.asarray(rmodel.transform(rdf).column("prediction"), dtype=np.float64),
        rtol=1e-6, atol=1e-6)


def _regression_frames(n=600, seed=3, vmask=None):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    y = 2 * X[:, 0] - X[:, 3] + 0.5 * X[:, 1] * X[:, 2] + rng.normal(size=n)
    d = {"features": [X[i] for i in range(n)], "label": y}
    if vmask is not None:
        d["isVal"] = vmask
    return (X, y, RefDataFrame.from_dict(d, num_partitions=2),
            DataFrame.from_dict(d, num_partitions=2))


@pytest.mark.parametrize("case", ["validation", "num_batches"])
def test_regressor_options_match_reference(ref_device_path, case):
    vmask = (np.arange(600) % 5 == 0) if case == "validation" else None
    X, _, rdf, pdf = _regression_frames(vmask=vmask)
    params = dict(numIterations=40, numLeaves=7, minDataInLeaf=5,
                  learningRate=0.3)
    if case == "validation":
        params.update(validationIndicatorCol="isVal", earlyStoppingRound=4)
    else:
        params.update(numBatches=3, numIterations=4)
    rmodel = ref_stages.LightGBMRegressor(**params).fit(rdf)
    with use_device("cpu"):
        pmodel = stages.LightGBMRegressor(**params).fit(pdf)
    _assert_same_forest(rmodel.booster, pmodel.booster)
    assert pmodel.booster.best_iteration == rmodel.booster.best_iteration
    if case == "validation":
        assert 0 < pmodel.booster.best_iteration < 40
    else:
        assert len(pmodel.booster.trees) == 12
    np.testing.assert_allclose(pmodel.booster.raw_predict(X),
                               rmodel.booster.raw_predict(X),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_init_model_continuation_matches_reference(ref_device_path, boosting):
    from sklearn.datasets import load_breast_cancer

    data = load_breast_cancer()
    X, y = data.data, data.target.astype(np.float64)
    kw = dict(objective="binary", num_leaves=6, num_iterations=4,
              boosting_type=boosting, seed=5)
    rb0 = ref_booster.train(ref_booster.TrainParams(**kw), X, y)
    pb0 = booster.train(booster.TrainParams(**kw), X, y, device="cpu")
    _assert_same_forest(rb0, pb0)
    # continue with a smaller max_bin: the init model's bin mapper stays
    kw.update(max_bin=16, num_iterations=3)
    rb = ref_booster.train(ref_booster.TrainParams(**kw), X, y, init_model=rb0)
    pb = booster.train(booster.TrainParams(**kw), X, y, init_model=pb0,
                       device="cpu")
    assert len(pb.trees) == 7
    _assert_same_forest(rb, pb)
    np.testing.assert_allclose(pb.raw_predict(X), rb.raw_predict(X),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- categorical


def _cat_hist(case):
    """A seeded [F, B, 3] histogram for one ``cat_best_subset`` case, with
    feature 0 categorical-shaped."""
    rng = np.random.default_rng({"ratio_ties": 1, "absent": 2,
                                 "max_cat_threshold": 3, "min_data": 4}[case])
    f, b, n = 5, 40, 6000
    bins = rng.integers(0, b, (f, n)).astype(np.int32)
    bins[0] = rng.integers(0, 30, n)
    grad = rng.standard_normal(n).astype(np.float32)
    hess = (rng.random(n) + 0.1).astype(np.float32)
    if case == "ratio_ties":
        # every row of bins 3..8 alike: their G/(H + smooth) tie exactly
        for v in range(3, 9):
            sel = bins[0] == v
            sel[np.nonzero(sel)[0][40:]] = False
            bins[0, (bins[0] == v) & ~sel] = 9
        grad[np.isin(bins[0], range(3, 9))] = -0.75
        hess[np.isin(bins[0], range(3, 9))] = 0.5
    if case == "absent":
        bins[:, np.isin(bins[0], (2, 5, 11, 17))] = 1
    if case == "max_cat_threshold":
        grad += np.where(bins[0] % 3 == 0, -1.5, 0.0).astype(np.float32)
    mask = rng.random(n) < 0.85
    return np.array(ref_hist.compute_histogram_xla(bins, grad, hess, mask, b))


@pytest.mark.parametrize("case,mct,mdl", [("ratio_ties", 32, 5),
                                          ("absent", 32, 5),
                                          ("max_cat_threshold", 2, 5),
                                          ("min_data", 32, 900)])
def test_cat_best_subset_matches_reference(case, mct, mdl):
    """Gains, left sums (f32) and bin words equal the reference's bit for
    bit on the same histogram: ties in G/(H + cat_smooth) and the absent
    bins keep their order (a stable sort), and ``max_cat_threshold`` and
    ``min_data_in_leaf`` bind."""
    import jax

    hist = _cat_hist(case)
    args = (np.float32(0.05), np.float32(1.0), np.float32(1e-3))
    rg, rw, rl = jax.jit(lambda h: ref_hist._cat_best_subset(
        h, *args, mdl, np.float32(10.0), np.float32(10.0), np.int32(mct)))(hist)
    pg, pw, pl = histogram.cat_best_subset(torch.from_numpy(hist), 0.05, 1.0,
                                           1e-3, mdl, 10.0, 10.0, mct)
    np.testing.assert_array_equal(np.asarray(rg), pg.numpy())
    np.testing.assert_array_equal(np.asarray(rl), pl.numpy())
    np.testing.assert_array_equal(np.asarray(rw).astype(np.int64), pw.numpy())
    assert np.isfinite(pg.numpy()).any()
    members = [bin(int(w)).count("1") for w in pw.numpy().reshape(-1)]
    if case == "max_cat_threshold":
        assert 0 < max(members) <= mct
    # the full search with feature 0 (and 3) categorical, single and paired
    cm = np.array([True, False, False, True, False])
    r = ref_hist.find_best_split(hist, *args, mdl, None,
                                 (cm, np.float32(10.0), np.float32(10.0),
                                  np.int32(mct)))
    cat = (torch.from_numpy(cm), 10.0, 10.0, mct)
    p = histogram.find_best_split(torch.from_numpy(hist), 0.05, 1.0, 1e-3, mdl,
                                  None, cat)
    for name, rv, pv in zip(SPLIT_FIELDS, r, p):
        np.testing.assert_array_equal(np.asarray(rv).astype(np.float64),
                                      pv.numpy().astype(np.float64),
                                      err_msg=name)
    pair = histogram.find_best_split_pair(
        torch.from_numpy(np.stack([hist, hist[:, ::-1].copy()])), 0.05, 1.0,
        1e-3, mdl, None, cat)
    np.testing.assert_array_equal(pair.cat_words[0].numpy(),
                                  np.asarray(r.cat_words).astype(np.int64))


SPLIT_FIELDS = ("feature", "bin", "gain", "default_left", "left_sum",
                "right_sum", "cat_words")


@pytest.mark.parametrize("is_cat", [True, False])
def test_partition_rows_cat_matches_reference(is_cat):
    rng = np.random.default_rng(6)
    n, b = 5000, 70
    bins = rng.integers(0, b, n).astype(np.int32)
    nodes = rng.integers(0, 4, n).astype(np.int32)
    words = rng.integers(0, 1 << 32, 3, dtype=np.uint64).astype(np.uint32)
    words[0] &= ~np.uint32(1)                    # bin 0 is never a member
    if not is_cat:
        words[:] = 0
    r = ref_hist.partition_rows_cat(bins, nodes, np.int32(2), np.int32(30),
                                    True, np.int32(7), np.int32(8), words)
    p = histogram.partition_rows_cat(
        torch.from_numpy(bins), torch.from_numpy(nodes), 2, 30, True, 7, 8,
        torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(r), p.numpy())


def _cat_fit_pair(fixture, **extra):
    """The reference's and the port's fit on a ``cat_data`` fixture of
    ``tests/test_gbdt_categorical.py`` (seed, rows, params)."""
    seed, n, kw = _CAT_FITS[fixture]
    X, y, _ = cat_data(seed=seed)
    X, y = X[:n], y[:n]
    if fixture == "negative_ids":
        X[:, 0] -= 6
    kw = dict(objective="binary", min_data_in_leaf=5,
              categorical_feature=(0,), **{**kw, **extra})
    rb = ref_booster.train(ref_booster.TrainParams(**kw), X, y)
    pb = booster.train(booster.TrainParams(**kw), X, y, device="cpu")
    return rb, pb, X, y


# name -> (cat_data seed, rows, TrainParams) as test_gbdt_categorical.py
# fits them; "sign_cancel" and "exact_tie" part from the reference (§C)
_CAT_FITS = {
    "beats_ordered": (1, 1500, dict(num_iterations=4, num_leaves=2)),
    "set_recovered": (2, 2000, dict(num_iterations=1, num_leaves=2)),
    "nan_routes_right": (3, 2000, dict(num_iterations=2, num_leaves=4)),
    "device_vs_host": (5, 2000, dict(num_iterations=5, num_leaves=7)),
    "scan_vs_per_tree": (6, 2000, dict(num_iterations=4, num_leaves=7)),
    "json_round_trip": (7, 2000, dict(num_iterations=3, num_leaves=7)),
    "text_round_trip": (8, 2000, dict(num_iterations=3, num_leaves=7)),
    "negative_ids": (9, 2000, dict(num_iterations=2, num_leaves=4)),
    "stage": (10, 2000, dict(num_iterations=4, num_leaves=4)),
}
_CAT_DEVIATIONS = ("json_round_trip", "stage")


def _assert_same_cat_forest(rb, pb):
    _assert_same_forest(rb, pb)
    for gr, gp in zip(rb.trees, pb.trees):
        a, b = gr[0], gp[0]
        assert (a.cat_bin_words is None) == (b.cat_bin_words is None)
        if a.cat_bin_words is not None:
            np.testing.assert_array_equal(a.cat_bin_words, b.cat_bin_words)
            for sa, sb in zip(a.cat_sets, b.cat_sets):
                assert (sa is None) == (sb is None)
                if sa is not None:
                    np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("fixture", [f for f in _CAT_FITS
                                     if f not in _CAT_DEVIATIONS])
def test_categorical_fit_matches_reference(ref_device_path, fixture):
    rb, pb, X, _ = _cat_fit_pair(fixture)
    _assert_same_cat_forest(rb, pb)
    assert any(t.cat_sets is not None for g in pb.trees for t in g)
    np.testing.assert_allclose(pb.raw_predict(X), rb.raw_predict(X),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bagging", [False, True])
def test_categorical_fit_with_bagging_matches_reference(ref_device_path,
                                                        bagging):
    extra = dict(bagging_fraction=0.8, bagging_freq=1, seed=3) if bagging \
        else dict(lambda_l2=1.0, max_cat_threshold=3)
    rb, pb, X, _ = _cat_fit_pair("text_round_trip", **extra)
    _assert_same_cat_forest(rb, pb)


def test_categorical_leaf_from_f32_differences(ref_device_path):
    """``json_round_trip``'s fixture (seed 7): same trees and sets, but the
    leaf at node 6 of iteration 1 is a small difference of f32 node totals
    (G = total - left), so each package's value is off the exact f64 leaf
    by about ulp(total) / |G|: the two agree within 1.5e-5, not 1e-5 (§C).
    Both stay within 4 f32 ulps of the parent's |G| of the exact value."""
    rb, pb, X, y = _cat_fit_pair("json_round_trip")
    for gr, gp in zip(rb.trees, pb.trees):
        for fld in STRUCT:
            np.testing.assert_array_equal(getattr(gr[0], fld),
                                          getattr(gp[0], fld))
    scores = np.full(len(y), pb.base_score[0])
    eps = float(np.finfo(np.float32).eps)
    for it in range(len(pb.trees)):
        t, tr = pb.trees[it][0], rb.trees[it][0]
        g, h = booster.grad_hess("binary", torch.tensor(scores, dtype=torch.float32),
                                 torch.tensor(y, dtype=torch.float32))
        g, h = g.double().numpy(), h.double().numpy()
        leaf = predict.leaf_nodes(t, X)
        for nid in np.nonzero(t.feature == -1)[0]:
            rows = leaf == nid
            exact = -g[rows].sum() / h[rows].sum()
            tol = 4 * eps * np.abs(g).sum() / h[rows].sum()
            assert abs(t.value[nid] - exact) <= tol
            assert abs(tr.value[nid] - exact) <= tol
            np.testing.assert_allclose(t.value[nid], tr.value[nid], rtol=1.5e-5)
        scores = scores + t.value[leaf] * t.shrinkage


def test_categorical_stage_fixture_exact_tie(ref_device_path):
    """The ``stage`` fixture (seed 10) parts from the reference at an exact
    tie: node 4's 107 rows split on feature 1 either at bin 7 (5 rows left)
    or at bin 236 (5 rows right), each 5-row tail alike, so the two gains
    are equal in exact arithmetic. The port's f64 sums keep them equal and
    take the lowest bin, the reference's f32 sums take bin 236 (§C).
    Everything else of the tree is the reference's."""
    rb, pb, X, y = _cat_fit_pair("stage", num_iterations=1)
    t, tr = pb.trees[0][0], rb.trees[0][0]
    assert (int(t.feature[4]), int(t.threshold_bin[4])) == (1, 7)
    assert (int(tr.feature[4]), int(tr.threshold_bin[4])) == (1, 236)
    np.testing.assert_array_equal(t.feature, tr.feature)
    np.testing.assert_array_equal(t.threshold_bin[:4], tr.threshold_bin[:4])
    np.testing.assert_array_equal(t.cat_bin_words, tr.cat_bin_words)
    scores = torch.full((len(y),), float(pb.base_score[0]))
    g, h = booster.grad_hess("binary", scores, torch.tensor(y, dtype=torch.float32))
    g, h = g.double().numpy(), h.double().numpy()
    bins = pb.bin_mapper.transform_fm(X, dtype=np.int32)
    node = predict.leaf_nodes(dataclasses.replace(
        t, feature=np.where(np.arange(len(t.feature)) == 4, -1, t.feature)),
        X) == 4

    def gain(b):
        left = node & (bins[1] <= b)
        gl, hl, gt, ht = g[left].sum(), h[left].sum(), g[node].sum(), h[node].sum()
        return gl * gl / hl + (gt - gl) ** 2 / (ht - hl) - gt * gt / ht

    assert node.sum() == 107
    np.testing.assert_allclose(gain(7), gain(236), rtol=1e-12)


def test_categorical_grower_matches_reference_rows(ref_device_path):
    """The reference's fused-grower case (seed 4, 800 rows, 64 bins, 7
    leaves): the same tree, words and row routing."""
    X, y, _ = cat_data(n=800, seed=4)
    rm = ref_binning.BinMapper.fit(X, max_bin=64, categorical_indexes=(0,))
    pm = binning.BinMapper.fit(X, max_bin=64, categorical_indexes=(0,))
    bins = np.ascontiguousarray(rm.transform(X).T)
    p = np.full_like(y, y.mean())
    grad = (p - y).astype(np.float32)
    hess = np.maximum(p * (1 - p), 1e-6).astype(np.float32)
    mask = np.ones(len(y), dtype=bool)
    cm = np.array([True, False, False])
    rt, rrows = ref_tree.grow_tree(
        bins, grad, hess, mask, rm.max_num_bins,
        ref_tree.GrowerConfig(num_leaves=7, min_data_in_leaf=5), rm,
        cat_args=(cm, np.float32(10.0), np.float32(10.0), np.int32(32)))
    pt, prows = tree.grow_tree(
        torch.from_numpy(bins), torch.from_numpy(grad), torch.from_numpy(hess),
        torch.from_numpy(mask), pm.max_num_bins,
        tree.GrowerConfig(num_leaves=7, min_data_in_leaf=5), pm,
        cat_args=(torch.from_numpy(cm), 10.0, 10.0, 32))
    _assert_same_tree(rt, pt)
    np.testing.assert_array_equal(rt.cat_bin_words, pt.cat_bin_words)
    np.testing.assert_array_equal(np.asarray(rrows), prows.numpy())
    binned = np.ascontiguousarray(bins.T)
    np.testing.assert_allclose(tree.predict_tree_binned(pt, binned),
                               ref_tree.predict_tree_binned(rt, binned),
                               rtol=1e-5, atol=1e-7)


def test_set_split_beats_ordered_on_holdout():
    X, y, _ = cat_data(seed=1)
    base = dict(objective="binary", num_iterations=4, num_leaves=2,
                min_data_in_leaf=5)
    b_cat = booster.train(booster.TrainParams(**base, categorical_feature=(0,)),
                          X[:1500], y[:1500], device="cpu")
    b_ord = booster.train(booster.TrainParams(**base), X[:1500], y[:1500],
                          device="cpu")
    acc_cat = float(((b_cat.raw_predict(X[1500:]) > 0) == y[1500:]).mean())
    acc_ord = float(((b_ord.raw_predict(X[1500:]) > 0) == y[1500:]).mean())
    assert acc_cat > acc_ord + 0.15 and acc_cat > 0.9, (acc_cat, acc_ord)


def test_cat_set_recovered():
    X, y, pos_set = cat_data(seed=2)
    b = booster.train(booster.TrainParams(
        objective="binary", num_iterations=1, num_leaves=2, min_data_in_leaf=5,
        categorical_feature=(0,)), X, y, device="cpu")
    root = {int(v) for v in b.trees[0][0].cat_sets[0]}
    assert root == pos_set or root == set(range(12)) - pos_set


def test_nan_category_routes_right():
    X, y, _ = cat_data(seed=3)
    b = booster.train(booster.TrainParams(
        objective="binary", num_iterations=2, num_leaves=4, min_data_in_leaf=5,
        categorical_feature=(0,)), X, y, device="cpu")
    t = b.trees[0][0]
    assert t.cat_sets[0] is not None
    Xq = X[:50].copy()
    Xq[:, 0] = np.nan
    node = predict.leaf_nodes(dataclasses.replace(
        t, feature=np.where(np.arange(len(t.feature)) == 0, t.feature, -1)),
        Xq)
    assert (node == t.right[0]).all()
    ens = predict.DeviceEnsemble(b.trees, 1, device="cpu")
    np.testing.assert_allclose(ens.predict_raw(Xq), predict.predict_ensemble(
        b.trees, Xq, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["gemm", "gather"])
def test_categorical_device_predict_matches_host(impl):
    """The reference's ``test_device_predict_matches_host``: a categorical
    forest has no GEMM form, so either ``impl`` runs the gather loop's
    membership test."""
    X, y, _ = cat_data(seed=5)
    X[::11, 0] = np.nan
    X[::13, 0] = 40.0                            # an unseen category
    b = booster.train(booster.TrainParams(
        objective="binary", num_iterations=5, num_leaves=7, min_data_in_leaf=5,
        categorical_feature=(0,)), X, y, device="cpu")
    ens = predict.DeviceEnsemble(b.trees, 1, device="cpu", impl=impl)
    assert ens.impl == "gather" and ens.cat_vals is not None
    host = predict.predict_ensemble(b.trees, X, 1)
    np.testing.assert_allclose(ens.predict_raw(X.astype(np.float32)), host,
                               rtol=1e-5, atol=1e-5)
    rb = convert.booster_from_reference(b.to_string())
    ref = ref_predict.DeviceEnsemble(rb.trees, 1).predict_raw(
        X.astype(np.float32))
    np.testing.assert_allclose(ens.predict_raw(X.astype(np.float32)), ref,
                               rtol=0, atol=1e-6)


def test_categorical_large_sets_score_on_the_host(caplog):
    """Past 256 values in one set the ensemble keeps the reference's host
    traversal, logs it, and has no device program."""
    text = _cat_text(list(range(0, 600, 2)))
    b = lgbm_format.from_lightgbm_string(text)
    with caplog.at_level("WARNING"):
        ens = predict.DeviceEnsemble(b.trees, 1, device="cpu")
    assert ens.cat_host_fallback and ens.device_forward() is None
    assert "scored on the host" in caplog.text
    X = np.array([[4.0], [5.0], [598.0], [np.nan], [700.0]])
    np.testing.assert_array_equal(ens.predict_raw(X)[:, 0],
                                  [1.0, -1.0, 1.0, -1.0, -1.0])


def _cat_text(cats) -> str:
    """A hand-written v3 model with one categorical split: ``cats`` left
    (leaf 1.0), everything else right (leaf -1.0)."""
    words = np.zeros(max(cats) // 32 + 1, dtype=np.uint64)
    for c in cats:
        words[c // 32] |= np.uint64(1) << np.uint64(c % 32)
    return (
        "tree\nversion=v3\nnum_class=1\nnum_tree_per_iteration=1\n"
        "label_index=0\nmax_feature_idx=0\nobjective=regression\n"
        "feature_names=c\nfeature_infos=none\ntree_sizes=100\n\n"
        "Tree=0\nnum_leaves=2\nnum_cat=1\nsplit_feature=0\n"
        "split_gain=1\nthreshold=0\ndecision_type=1\n"
        "left_child=-1\nright_child=-2\n"
        f"cat_boundaries=0 {len(words)}\n"
        f"cat_threshold={' '.join(str(int(w)) for w in words)}\n"
        "leaf_value=1 -1\nleaf_weight=1 1\nleaf_count=1 1\n"
        "internal_value=0\ninternal_weight=2\ninternal_count=2\n"
        "shrinkage=1\n\n\nend of trees\n")


def test_categorical_fixture_import():
    """The reference's hand-written v3 fixture: categories {2, 5} left."""
    b = lgbm_format.from_lightgbm_string(_cat_text([2, 5]))
    X = np.array([[2.0], [5.0], [3.0], [0.0], [np.nan], [7.0]])
    expect = [1.0, 1.0, -1.0, -1.0, -1.0, -1.0]
    np.testing.assert_allclose(b.raw_predict(X), expect)
    ens = predict.DeviceEnsemble(b.trees, 1, device="cpu")
    np.testing.assert_allclose(ens.predict_raw(X)[:, 0], expect)


@pytest.mark.parametrize("fmt", ["json", "text"])
def test_categorical_round_trips(fmt):
    X, y, _ = cat_data(seed=7 if fmt == "json" else 8)
    b = booster.train(booster.TrainParams(
        objective="binary", num_iterations=3, num_leaves=7, min_data_in_leaf=5,
        categorical_feature=(0,)), X, y, device="cpu")
    if fmt == "json":
        b2 = booster.Booster.from_string(b.to_string())
        np.testing.assert_array_equal(b2.raw_predict(X), b.raw_predict(X))
        return
    text = lgbm_format.to_lightgbm_string(b)
    assert "num_cat=" in text and "cat_boundaries=" in text
    assert "cat_threshold=" in text
    imported = lgbm_format.from_lightgbm_string(text)
    np.testing.assert_allclose(imported.raw_predict(X), b.raw_predict(X),
                               rtol=1e-9, atol=1e-9)
    assert lgbm_format.to_lightgbm_string(imported) != text   # folded bias
    assert lgbm_format.to_lightgbm_string(
        lgbm_format.from_lightgbm_string(lgbm_format.to_lightgbm_string(
            imported))) == lgbm_format.to_lightgbm_string(imported)


def test_negative_category_export_rejected():
    X, y, _ = cat_data(seed=9)
    X[:, 0] -= 6
    b = booster.train(booster.TrainParams(
        objective="binary", num_iterations=2, num_leaves=4, min_data_in_leaf=5,
        categorical_feature=(0,)), X, y, device="cpu")
    assert any(t.cat_sets is not None for g in b.trees for t in g)
    with pytest.raises(ValueError, match="negative"):
        lgbm_format.to_lightgbm_string(b)


@pytest.mark.parametrize("by", ["indexes", "names"])
def test_categorical_slots_on_the_stage(ref_device_path, by):
    """``categoricalSlotIndexes`` and ``categoricalSlotNames`` (through the
    features column's slot_names metadata) pick the same feature; the
    port's stage fits the reference's trees and saves a text model that
    loads back."""
    X, y, _ = cat_data(seed=11)
    kw = dict(numIterations=4, numLeaves=4, minDataInLeaf=5, labelCol="label")
    kw.update({"categoricalSlotIndexes": [0]} if by == "indexes"
              else {"categoricalSlotNames": ["carrier"]})
    frames = []
    for cls in (RefDataFrame, DataFrame):
        df = cls.from_dict({"features": [r for r in X], "label": y})
        df.schema.meta("features")["slot_names"] = ["carrier", "x1", "x2"]
        frames.append(df)
    rm = ref_stages.LightGBMClassifier(**kw).fit(frames[0])
    with use_device("cpu"):
        pm = stages.LightGBMClassifier(**kw).fit(frames[1])
        pred = np.asarray(pm.transform(frames[1]).column("prediction"))
    assert pm.booster.params.categorical_feature == (0,)
    _assert_same_cat_forest(rm.booster, pm.booster)
    assert (pred == y).mean() > 0.9


def test_categorical_slot_names_need_metadata():
    X, y, _ = cat_data(seed=11, n=200)
    df = DataFrame.from_dict({"features": [r for r in X], "label": y})
    with use_device("cpu"), pytest.raises(ValueError, match="slot_names"):
        stages.LightGBMClassifier(categoricalSlotNames=["a"]).fit(df)
    df.schema.meta("features")["slot_names"] = ["a", "b", "c"]
    with use_device("cpu"), pytest.raises(KeyError, match="zz"):
        stages.LightGBMClassifier(categoricalSlotNames=["zz"]).fit(df)


def test_categorical_model_carried_from_reference(ref_device_path):
    """A categorical model the JAX package trained scores the same in the
    port, through its JSON and through arrays with a categorical mapper."""
    rb, _, X, _ = _cat_fit_pair("device_vs_host")
    pb = convert.booster_from_reference(rb.to_string())
    _assert_same_cat_forest(rb, pb)
    np.testing.assert_array_equal(pb.raw_predict(X), rb.raw_predict(X))
    m = rb.bin_mapper
    trees = [[{k: getattr(t, k) for k in ("feature", "threshold", "threshold_bin",
                                           "default_left", "left", "right", "value",
                                           "gain", "count", "shrinkage", "cat_sets",
                                           "cat_bin_words")}
              for t in g] for g in rb.trees]
    pa = convert.booster_from_arrays(dataclasses.asdict(rb.params), rb.base_score,
                                     m.edges, trees, categorical=m.categorical,
                                     categories=m.categories)
    _assert_same_cat_forest(rb, pa)
    assert pa.bin_mapper.categorical == list(m.categorical)
    np.testing.assert_array_equal(pa.raw_predict(X), rb.raw_predict(X))
    np.testing.assert_array_equal(pa.bin_mapper.transform(X), m.transform(X))


# ------------------------------------------------ LightGBM text interchange


def _synth(n=300, d=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    return X, (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)


def _port_fit(objective, X, y, **kw):
    return booster.train(booster.TrainParams(objective=objective, **kw), X, y,
                         device="cpu")


@pytest.mark.parametrize("case", ["binary", "regression", "multiclass",
                                  "missing", "stumps", "categorical"])
def test_lightgbm_text_matches_reference_bytes(ref_device_path, case):
    """The port's text of a model the JAX package trained is the
    reference's, byte for byte; each package reads the other's text and
    scores it alike; and the port's own fit round-trips (raw scores and
    probabilities within 1e-9, as the reference's tests hold)."""
    from mmlspark_tpu.gbdt import lgbm_format as ref_fmt

    X, y = _synth(seed=3)
    kw = dict(num_iterations=5, num_leaves=7, min_data_in_leaf=5)
    obj = {"missing": "binary", "categorical": "binary", "stumps": "regression"
           }.get(case, case)
    if case == "regression":
        y = X[:, 0] * 2.0 + X[:, 2] + 0.1
    if case == "multiclass":
        y = (X[:, 0] > 0).astype(np.float64) + (X[:, 1] > 0.5)
        kw["num_class"] = 3
    if case == "missing":
        X[::7, 0] = np.nan
    if case == "stumps":
        y, kw = np.ones(len(y)), dict(num_iterations=2, num_leaves=4)
    if case == "categorical":
        X, y, _ = cat_data(seed=8)
        kw["categorical_feature"] = (0,)
    rb = ref_booster.train(ref_booster.TrainParams(objective=obj, **kw), X, y)
    pb = convert.booster_from_reference(rb.to_string())
    text = lgbm_format.to_lightgbm_string(pb)
    assert text == ref_fmt.to_lightgbm_string(rb)
    Xq = X.copy()
    Xq[1::3, 2] = np.nan
    ref_read = ref_fmt.from_lightgbm_string(text)
    port_read = lgbm_format.from_lightgbm_string(text)
    np.testing.assert_array_equal(port_read.raw_predict(Xq),
                                  ref_read.raw_predict(Xq))
    np.testing.assert_allclose(port_read.raw_predict(Xq), rb.raw_predict(Xq),
                               rtol=1e-9, atol=1e-9)
    own = _port_fit(obj, X, y, **kw)
    own_text = lgbm_format.to_lightgbm_string(own)
    assert own_text.startswith("tree\nversion=v3\n")
    again = ref_fmt.from_lightgbm_string(own_text)
    np.testing.assert_allclose(again.raw_predict(Xq), own.raw_predict(Xq),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(lgbm_format.from_lightgbm_string(own_text)
                               .predict_proba(Xq), own.predict_proba(Xq),
                               rtol=1e-9, atol=1e-9)


def test_tree_sizes_match_blocks():
    X, y = _synth()
    text = lgbm_format.to_lightgbm_string(
        _port_fit("binary", X, y, num_iterations=3, num_leaves=7,
                  min_data_in_leaf=5))
    sizes = [int(s) for s in next(line for line in text.splitlines()
                                  if line.startswith("tree_sizes="))
             .split("=")[1].split()]
    body = text.split("tree_sizes=")[1].split("\n", 1)[1]
    for i, size in enumerate(sizes):
        block = body[body.index(f"Tree={i}\n"):]
        assert size == len(block[:block.index("\n\n")].encode()) + 2, i


def _fixture_text():
    with open(os.path.join(RES, "lgbm_v3_binary.txt")) as f:
        return f.read()


def test_v3_fixture_predictions():
    """``tests/resources/lgbm_v3_binary.txt`` and its hand-computed scores,
    on the host and through the device ensemble, re-exported too."""
    b = lgbm_format.from_lightgbm_string(_fixture_text())
    assert b.params.objective == "binary" and len(b.trees) == 2
    X = np.array([[0.0, 0.0, -2.0], [1.0, 1.0, 0.0], [1.0, 2.0, -2.0],
                  [np.nan, 2.0, 0.0], [0.0, 0.0, np.nan]])
    expect = [0.3, -0.4, 0.8, 0.6, 0.3]
    np.testing.assert_allclose(b.raw_predict(X), expect, atol=1e-12)
    ens = predict.DeviceEnsemble(b.trees, 1, device="cpu")
    np.testing.assert_allclose(ens.predict_raw(X)[:, 0], expect, atol=1e-6)
    again = lgbm_format.from_lightgbm_string(lgbm_format.to_lightgbm_string(b))
    Xr = np.random.default_rng(1).normal(size=(100, 3))
    np.testing.assert_allclose(again.raw_predict(Xr), b.raw_predict(Xr),
                               atol=1e-12)


def _minimal(version="v3", header_extra="", tree_extra="", dt="0",
             thr="0.5"):
    return (f"tree\nversion={version}\nnum_class=1\n"
            "num_tree_per_iteration=1\n"
            "label_index=0\nmax_feature_idx=0\nobjective=regression\n"
            f"{header_extra}"
            "feature_names=a\nfeature_infos=none\ntree_sizes=100\n\n"
            f"Tree=0\nnum_leaves=2\nnum_cat=0\n{tree_extra}split_feature=0\n"
            f"split_gain=1\nthreshold={thr}\ndecision_type={dt}\n"
            "left_child=-1\nright_child=-2\nleaf_value=1 2\n"
            "leaf_weight=1.5 2.5\nleaf_count=1 1\ninternal_value=0\n"
            "internal_weight=4.0\ninternal_count=2\nshrinkage=1\n\n\n"
            "end of trees\n")


@pytest.mark.parametrize("version,ok", [("v2", True), ("v3", True),
                                        ("v4", True), ("v5", False),
                                        ("", False), ("3", False),
                                        (None, False)])
def test_text_version_matrix(version, ok):
    text = _minimal("v3" if version is None else version)
    if version is None:
        text = text.replace("version=v3\n", "")
    if not ok:
        with pytest.raises(ValueError, match="version"):
            lgbm_format.from_lightgbm_string(text)
        return
    b = lgbm_format.from_lightgbm_string(text)
    np.testing.assert_allclose(b.raw_predict(np.array([[0.0]])), [1.0])


@pytest.mark.parametrize("text,match", [
    (_minimal("v4", header_extra="linear_tree=1\n"), "linear"),
    (_minimal("v4", tree_extra="is_linear=1\n"), "linear"),
    ("", "LightGBM"), ("   \n  ", "LightGBM"),
    (_minimal(dt="1").replace("num_cat=0", "num_cat=1"), "categorical"),
])
def test_text_rejections(text, match):
    """Linear trees, empty strings and a categorical bit without its
    bitsets are refused, as in the reference."""
    with pytest.raises(ValueError, match=match):
        lgbm_format.from_lightgbm_string(text)


@pytest.mark.parametrize("thr,dt,expect", [("0.5", "0", 1.0), ("-0.5", "0", 2.0),
                                           ("0.5", "8", 2.0), ("-0.5", "10", 1.0)])
def test_text_missing_type(thr, dt, expect):
    """missing type None reads NaN as 0.0; NaN type follows the default
    bit; on the host and on the device ensemble alike."""
    b = lgbm_format.from_lightgbm_string(_minimal(dt=dt, thr=thr))
    X = np.array([[np.nan]])
    np.testing.assert_allclose(b.raw_predict(X), [expect])
    np.testing.assert_allclose(predict.DeviceEnsemble(
        b.trees, 1, device="cpu").predict_raw(X)[:, 0], [expect])


def test_text_missing_type_zero_warns():
    with pytest.warns(RuntimeWarning, match="missing_type=Zero"):
        lgbm_format.from_lightgbm_string(_minimal(dt="4"))


def test_text_leaf_weight():
    """Export writes hessian sums as leaf_weight and import reads them."""
    b = lgbm_format.from_lightgbm_string(_minimal())
    t = b.trees[0][0]
    np.testing.assert_allclose(sorted(t.weight[t.feature == -1]), [1.5, 2.5])
    np.testing.assert_allclose(t.weight[t.feature >= 0], [4.0])
    X, y = _synth()
    fit = _port_fit("binary", X, y, num_iterations=2, num_leaves=7,
                    min_data_in_leaf=5)
    tree0 = fit.trees[0][0]
    leaves = tree0.feature == -1
    assert (tree0.weight[leaves] < tree0.count[leaves]).all()
    text = lgbm_format.to_lightgbm_string(fit)
    line = next(ln for ln in text.splitlines() if ln.startswith("leaf_weight="))
    np.testing.assert_allclose(sorted(float(v) for v in line[12:].split()),
                               sorted(tree0.weight[leaves]), rtol=1e-5)
    it = lgbm_format.from_lightgbm_string(text).trees[0][0]
    np.testing.assert_allclose(sorted(it.weight[it.feature == -1]),
                               sorted(tree0.weight[leaves]), rtol=1e-5)


def test_native_model_api_on_the_stage(tmp_path):
    """save_native_model writes v3 text; load_native_model_from_file /
    _from_string score it; importances and the model string are the
    booster's."""
    X, y = _synth()
    df = DataFrame.from_dict({"features": [r for r in X], "label": y})
    with use_device("cpu"):
        model = stages.LightGBMClassifier(numIterations=3, numLeaves=7,
                                          labelCol="label").fit(df)
        path = str(tmp_path / "native" / "model.txt")
        model.save_native_model(path)
        with pytest.raises(FileExistsError):
            model.save_native_model(path, overwrite=False)
        loaded = stages.LightGBMClassificationModel.load_native_model_from_file(
            path, featuresCol="features")
        out = np.stack(list(loaded.transform(df).column("rawPrediction")))
    with open(path) as f:
        assert f.read().startswith("tree\nversion=v3\n")
    np.testing.assert_allclose(out[:, 1], model.booster.raw_predict(X),
                               rtol=1e-6, atol=1e-6)
    imp = model.get_feature_importances()
    assert len(imp) == 5 and sum(imp) == sum(
        int((t.feature >= 0).sum()) for g in model.booster.trees for t in g)
    assert model.get_feature_importances("gain")[0] > 0
    assert model.get_model_string() == model.booster.to_string()
    fixture = stages.LightGBMClassificationModel.load_native_model_from_string(
        _fixture_text(), featuresCol="features")
    np.testing.assert_allclose(fixture.booster.raw_predict(
        np.array([[0.0, 0.0, -2.0]])), [0.3], atol=1e-12)


@pytest.mark.parametrize("source", ["text", "json", "categorical_text"])
def test_model_string_continuation_matches_reference(ref_device_path, source):
    """``modelString`` takes LightGBM text or the Booster's JSON and the fit
    continues it: 3 + 2 iterations, the reference's trees and scores."""
    from mmlspark_tpu.gbdt import lgbm_format as ref_fmt

    X, _ = _synth()
    y = X[:, 0] * 2.0
    est_kw = dict(numIterations=3, numLeaves=7, labelCol="label")
    if source == "categorical_text":
        X, y, _ = cat_data(seed=12, n=400)
        est_kw.update(categoricalSlotIndexes=[0], minDataInLeaf=5)
    rdf = RefDataFrame.from_dict({"features": [r for r in X], "label": y})
    pdf = DataFrame.from_dict({"features": [r for r in X], "label": y})
    cls = "LightGBMRegressor" if source != "categorical_text" \
        else "LightGBMClassifier"
    r1 = getattr(ref_stages, cls)(**est_kw).fit(rdf)
    ms = r1.get_model_string() if source == "json" \
        else ref_fmt.to_lightgbm_string(r1.booster)
    est_kw["numIterations"] = 2
    r2 = getattr(ref_stages, cls)(**est_kw, modelString=ms).fit(rdf)
    with use_device("cpu"):
        p2 = getattr(stages, cls)(**est_kw, modelString=ms).fit(pdf)
    assert len(p2.booster.trees) == len(r2.booster.trees) == 5
    _assert_same_cat_forest(r2.booster, p2.booster)
    np.testing.assert_allclose(p2.booster.raw_predict(X),
                               r2.booster.raw_predict(X), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------ checkpointed training


def _ckpt_data(n=300, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    logit = X[:, 0] * 2 - X[:, 1] + 0.5 * X[:, 2] * X[:, 0]
    return X, (logit + rng.normal(scale=0.3, size=n) > 0).astype(np.float64)


def _ckpt_params(**kw):
    base = dict(objective="binary", num_iterations=8, num_leaves=7,
                min_data_in_leaf=5, bagging_fraction=0.8, bagging_freq=1,
                seed=3)
    base.update(kw)
    return base


class _FaultAt:
    """Installs a TRAIN_STEP hook that raises at the ``at``-th call (the
    reference's ``FaultInjector.plan(TRAIN_STEP, at=(k,))``)."""

    def __init__(self, at: int):
        self.at, self.calls = at, 0

    def __call__(self, point, **ctx):
        from mmlspark_tpu_torch.core import faults

        if point == faults.TRAIN_STEP:
            self.calls += 1
            if self.calls == self.at:
                raise faults.InjectedFault("injected preemption")

    def __enter__(self):
        from mmlspark_tpu_torch.core import faults

        self.prev = faults.install(self)
        return self

    def __exit__(self, *exc):
        from mmlspark_tpu_torch.core import faults

        faults.install(self.prev)


@pytest.mark.parametrize("extra", [{}, {"categorical_feature": (3,)}])
def test_interrupted_resume_is_identical(tmp_path, extra):
    """A fit preempted at its 6th iteration and resumed from the checkpoint
    of iteration 3 gives the uninterrupted fit's model, string for string."""
    from mmlspark_tpu_torch.core.faults import InjectedFault
    from mmlspark_tpu_torch.gbdt.checkpoint import (CheckpointConfig,
                                                    load_checkpoint)

    X, y = _ckpt_data()
    if extra:
        X[:, 3] = np.round(np.abs(X[:, 3]) * 4)
    p = booster.TrainParams(**_ckpt_params(**extra))
    full = booster.train(p, X, y, device="cpu", checkpoint=CheckpointConfig(
        str(tmp_path / "full.ckpt"), every_k=3))
    ckpt = str(tmp_path / "interrupted.ckpt")
    with _FaultAt(6), pytest.raises(InjectedFault):
        booster.train(p, X, y, device="cpu",
                      checkpoint=CheckpointConfig(ckpt, every_k=3))
    assert load_checkpoint(ckpt)["iteration"] == 3
    resumed = booster.train(p, X, y, device="cpu",
                            checkpoint=CheckpointConfig(ckpt, every_k=3))
    assert resumed.to_string() == full.to_string()
    np.testing.assert_array_equal(resumed.raw_predict(X), full.raw_predict(X))


def test_checkpoint_cadence_and_final(tmp_path, monkeypatch):
    """Every ``every_k`` iterations and once more at the end."""
    from mmlspark_tpu_torch.gbdt.checkpoint import (CheckpointConfig,
                                                    load_checkpoint)

    X, y = _ckpt_data()
    ckpt = str(tmp_path / "m.ckpt")
    seen, orig = [], booster.save_checkpoint
    monkeypatch.setattr(booster, "save_checkpoint", lambda path, **kw: (
        seen.append(kw["iteration"]), orig(path, **kw)))
    booster.train(booster.TrainParams(**_ckpt_params()), X, y, device="cpu",
                  checkpoint=CheckpointConfig(ckpt, every_k=3))
    assert seen == [3, 6, 8]
    assert load_checkpoint(ckpt)["iteration"] == 8


def test_param_mismatch_refuses_resume(tmp_path):
    from mmlspark_tpu_torch.gbdt.checkpoint import CheckpointConfig

    X, y = _ckpt_data()
    ckpt = str(tmp_path / "m.ckpt")
    booster.train(booster.TrainParams(**_ckpt_params()), X, y, device="cpu",
                  checkpoint=CheckpointConfig(ckpt, every_k=3))
    with pytest.raises(ValueError, match="different train params"):
        booster.train(booster.TrainParams(**_ckpt_params(learning_rate=0.27)),
                      X, y, device="cpu",
                      checkpoint=CheckpointConfig(ckpt, every_k=3))


def test_atomicity_survives_crash_mid_save(tmp_path, monkeypatch):
    """A crash inside the checkpoint write leaves the previous complete
    checkpoint (temporary file + rename: never a torn file)."""
    import errno

    from mmlspark_tpu_torch.gbdt.checkpoint import (load_checkpoint,
                                                    save_checkpoint)

    path = str(tmp_path / "c.ckpt")
    args = dict(params_dict={"a": 1}, model_string="tree v1",
                scores=np.zeros((4, 1)), rng_state={"s": 1},
                bag_mask=np.ones(4, dtype=bool), best_val=0.5,
                best_iter=2, rounds_no_improve=0)
    save_checkpoint(path, iteration=3, **args)

    def replace_boom(a, b):
        raise OSError(errno.EIO, "injected crash mid-rename")

    monkeypatch.setattr(os, "replace", replace_boom)
    with pytest.raises(OSError):
        save_checkpoint(path, iteration=4, **args)
    monkeypatch.undo()
    assert load_checkpoint(path)["iteration"] == 3
    assert os.listdir(tmp_path) == ["c.ckpt"]


def test_reference_checkpoint_resumes_in_the_port(ref_device_path, tmp_path):
    """A checkpoint the JAX package wrote (preempted at its 6th iteration)
    resumed by the port gives the trees of the reference's uninterrupted
    fit; the port's own checkpoint carries the same fields."""
    from mmlspark_tpu.core import faults as ref_faults
    from mmlspark_tpu.gbdt import checkpoint as ref_ck
    from mmlspark_tpu_torch.gbdt.checkpoint import (CheckpointConfig,
                                                    load_checkpoint)

    X, y = _ckpt_data()
    kw = _ckpt_params()
    ckpt = str(tmp_path / "ref.ckpt")
    with ref_faults.FaultInjector(seed=0).plan(ref_faults.TRAIN_STEP, at=(6,)):
        with pytest.raises(ref_faults.InjectedFault):
            ref_booster.train(ref_booster.TrainParams(**kw), X, y,
                              checkpoint=ref_ck.CheckpointConfig(ckpt, every_k=3))
    assert ref_ck.load_checkpoint(ckpt)["iteration"] == 3
    ref_full = ref_booster.train(ref_booster.TrainParams(**kw), X, y)
    resumed = booster.train(booster.TrainParams(**kw), X, y, device="cpu",
                            checkpoint=CheckpointConfig(ckpt, every_k=3))
    _assert_same_forest(ref_full, resumed)
    np.testing.assert_allclose(resumed.raw_predict(X), ref_full.raw_predict(X),
                               rtol=1e-6, atol=1e-6)
    mine = load_checkpoint(ckpt)
    theirs = ref_ck.load_checkpoint(ckpt)
    assert mine["iteration"] == 8 and "kahan" not in mine
    assert set(mine) == set(theirs)


# ------------------------------------------- fused grower, scan and native


@pytest.mark.parametrize("case", ["plain", "feature_mask", "max_depth",
                                  "categorical"])
def test_fused_grower_equals_host_loop_and_reference(ref_device_path, case):
    """The port's device-resident grower (``FusedGrower`` and
    ``_grow_tree_fused``) against its per-split host loop, bit for bit, and
    against the reference's ``_grow_tree_device`` with the gates of
    ``test_fused_tree_matches_at_40k_rows`` (structure and thresholds equal,
    leaf values rtol 1e-5, gains rtol 1e-4, rows equal). 40,960 rows: the
    fused route's K2 tiers (n/2 down to 5,120 rows) all engage."""
    rng = np.random.default_rng(22)
    n, f = 40_960, 6
    X = rng.standard_normal((n, f))
    cat = case == "categorical"
    if cat:
        X[:, 0] = rng.integers(0, 12, n)
    y = (X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + 0.3 * rng.standard_normal(n)
         + (np.isin(X[:, 0], (1, 4, 6, 9)) if cat else 0) > 0.2)
    mapper = ref_binning.BinMapper.fit(X, 255, (0,) if cat else (), seed=0)
    pmapper = binning.BinMapper.fit(X, 255, (0,) if cat else (), seed=0)
    bins = mapper.transform_fm(X, dtype=np.int32)
    p = 1.0 / (1.0 + np.exp(-0.3 * X[:, 4]))
    grad = (p - y).astype(np.float32)
    hess = np.maximum(p * (1 - p), 1e-16).astype(np.float32)
    mask = rng.random(n) < 0.9
    fm = np.array([True, True, False, True, True, True]) \
        if case == "feature_mask" else None
    nb = mapper.max_num_bins
    kw = dict(num_leaves=15, min_data_in_leaf=20, lambda_l1=0.05,
              lambda_l2=1.0, max_depth=4 if case == "max_depth" else -1)
    cm = np.zeros(f, dtype=bool)
    cm[0] = True
    rcat = (cm, np.float32(10.0), np.float32(10.0), np.int32(32)) \
        if cat else None
    pcat = (torch.from_numpy(cm), 10.0, 10.0, 32) if cat else None
    rt, rrows = ref_tree.grow_tree(bins, grad, hess, mask, nb,
                                   ref_tree.GrowerConfig(**kw), mapper,
                                   feature_mask=fm, cat_args=rcat)
    args = [torch.from_numpy(a) for a in (bins, grad, hess, mask)]
    pfm = torch.from_numpy(fm) if fm is not None else None
    pcfg = tree.GrowerConfig(**kw)
    assert tree.device_tier_caps(n) == (20480, 10240, 5120)
    grower = tree.FusedGrower(args[0], nb, pcfg, pmapper, pcat)
    assert not grower.run.capture      # CPU tensors: eager, no graph
    ft, frows = grower.grow(*args[1:], pfm)
    gt, grows = tree._grow_tree_fused(*args, nb, pcfg, pmapper, pfm,
                                      cat_args=pcat)
    os.environ.pop("MMLSPARK_TPU_FUSED_TREE")      # the per-split host loop
    ht, hrows = tree.grow_tree(*args, nb, pcfg, pmapper, pfm, cat_args=pcat)
    for t, rows in ((gt, grows), (ht, hrows)):
        for fld in STRUCT + ("threshold", "value", "gain", "weight"):
            np.testing.assert_array_equal(getattr(ft, fld), getattr(t, fld),
                                          err_msg=fld)
        assert torch.equal(frows, rows)
    if cat:
        np.testing.assert_array_equal(ft.cat_bin_words, ht.cat_bin_words)
        assert any(s is not None and len(s) >= 2 for s in ft.cat_sets)
    _assert_same_tree(rt, ft)
    np.testing.assert_allclose(rt.gain, ft.gain, rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(rrows), frows.numpy())


@pytest.mark.parametrize("count", [0, 1, 511, 512, 5120, 20480])
def test_histogram_count_plain_is_the_masked_histogram(count):
    """K1's device-count entry's plain version: the rows before the count
    as the row mask; and its grid table (``count_tiers``) K1's geometry for
    every tier width, widest first."""
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk

    rng = np.random.default_rng(count)
    n, f, b = 20480, 5, 64
    bins = torch.from_numpy(rng.integers(0, b, (f, n)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    h = torch.from_numpy(rng.random(n).astype(np.float32))
    c = torch.tensor([count], dtype=torch.int32)
    mask = torch.arange(n) < count
    assert torch.equal(hk.histogram_count(bins, g, h, c, b),
                       hk.histogram_plain(bins, g, h, mask, b))
    tiers = hk.count_tiers(n, f, b, (20480, 10240, 5120))
    assert [w for w, _ in tiers] == [20480, 10240, 5120]
    assert [geo for _, geo in tiers] == [hk.launch_geometry(w, f, b)
                                         for w, _ in tiers]


def _scan_case(name):
    from sklearn.datasets import load_breast_cancer, load_wine

    from test_gbdt_categorical import cat_data

    base = dict(num_iterations=5, num_leaves=5, min_data_in_leaf=20,
                seed=42)
    if name == "categorical":
        X, y, _ = cat_data(2000, 12, 0)
        return X, y, dict(base, objective="binary", categorical_feature=(0,))
    if name == "binary":
        d = load_breast_cancer()
        return d.data, d.target * 1.0, dict(base, objective="binary")
    if name == "goss_binary":
        d = load_breast_cancer()
        return d.data, d.target * 1.0, dict(base, objective="binary",
                                            boosting_type="goss")
    d = load_wine()
    kw = dict(base, objective="multiclass", num_class=3)
    if name == "goss_multiclass":
        kw.update(boosting_type="goss", top_rate=0.3, other_rate=0.2)
    if name == "rf_bagging_feature_fraction":
        kw.update(boosting_type="rf", bagging_fraction=0.7, bagging_freq=1,
                  feature_fraction=0.6)
    return d.data, d.target * 1.0, kw


@pytest.mark.parametrize("name", ["binary", "rf_bagging_feature_fraction",
                                  "multiclass", "categorical", "goss_binary",
                                  "goss_multiclass"])
def test_forced_scan_matches_reference_scan(monkeypatch, name):
    """``MMLSPARK_TPU_SCAN_TRAIN=1`` on both packages (the whole-run scan on
    the CPU: masks drawn up front, device-f32 leaf values into a Kahan f32
    score, trees fetched once; GOSS selected in the scan by exact top-k
    over the Threefry draws and compacted into ``goss_cap`` columns), with
    the gates of ``test_full_fit_matches_reference``: trees identical in
    structure, leaf values rtol 1e-5, raw predictions within 1e-6. The
    benchmark CSV's parameters (5 leaves, 20 rows a leaf), 5 iterations;
    the rf case bags on wine (breast_cancer's bagging has an exact tie, see
    _FITS)."""
    monkeypatch.setenv("MMLSPARK_TPU_SCAN_TRAIN", "1")
    X, y, kw = _scan_case(name)
    ref = ref_booster.train(ref_booster.TrainParams(**kw), X, y)
    port = booster.train(booster.TrainParams(**kw), X, y, device="cpu")
    assert port.route == "scan"
    _assert_same_forest(ref, port)
    np.testing.assert_allclose(port.raw_predict(X), ref.raw_predict(X),
                               rtol=1e-6, atol=1e-6)
    if kw.get("boosting_type") == "rf":
        assert port.trees[-1][0].shrinkage == 1.0 / len(port.trees)
    if kw.get("boosting_type") == "goss":
        n = len(y)
        want = int(n * kw.get("top_rate", 0.2)) + int(n * kw.get("other_rate",
                                                                  0.1))
        assert (booster.last_scan_rows == want).all()


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1])
def test_threefry_draws_match_jax_bitwise(seed):
    """``core/threefry.py`` bit for bit the JAX of this environment:
    ``PRNGKey``, ``split`` into 1, 5 and 20 keys, and ``uniform`` of n in
    {1, 7, 1000, 65,537} rows from every key."""
    import jax

    from mmlspark_tpu_torch.core import threefry

    rk, pk = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(rk).astype(np.int64), pk.numpy())
    for num in (1, 5, 20):
        rs, ps = jax.random.split(rk, num), threefry.split(pk, num)
        np.testing.assert_array_equal(np.asarray(rs).astype(np.int64),
                                      ps.numpy())
        for n in (1, 7, 1000, 65_537):
            for j in sorted({0, num - 1}):
                ru = np.asarray(jax.random.uniform(rs[j], (n,)))
                pu = threefry.uniform(ps[j], n).numpy()
                np.testing.assert_array_equal(ru.view(np.int32),
                                              pu.view(np.int32))


def test_scan_masks_are_drawn_as_the_reference_draws_them():
    """``_scan_precompute_masks``: every iteration's bagging and feature
    masks, bit for bit the reference's from the same generator (bagging
    every 2nd iteration, class-aware fractions)."""
    y = (np.arange(3000) % 3 == 0).astype(np.float64)
    for kw in (dict(bagging_fraction=0.6, bagging_freq=2,
                    feature_fraction=0.5),
               dict(pos_bagging_fraction=0.9, neg_bagging_fraction=0.4,
                    bagging_freq=1, boosting_type="rf")):
        rp = ref_booster.TrainParams(num_iterations=7, **kw)
        pp = booster.TrainParams(num_iterations=7, **kw)
        is_rf = kw.get("boosting_type") == "rf"
        r = ref_booster._scan_precompute_masks(
            rp, np.random.default_rng(3), 3000, 11, y, is_rf)
        p = booster._scan_precompute_masks(
            pp, np.random.default_rng(3), 3000, 11, y, is_rf)
        assert r[2] and p[2]
        for a, b in zip(r[:2], p[:2]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


_ROUTE_PARAMS = [
    dict(), dict(boosting_type="rf", bagging_fraction=0.5, bagging_freq=1),
    dict(boosting_type="dart"), dict(objective="lambdarank"),
    dict(categorical_feature=(1,)), dict(max_bin=511), dict(num_leaves=1),
    dict(num_iterations=400), dict(num_class=3, objective="multiclass"),
    dict(max_bin_by_feature=(63, 300, 63)), dict(boosting_type="goss"),
    dict(boosting_type="goss", num_class=3, objective="multiclass"),
]
_ROUTE_ENVS = [
    {}, {"MMLSPARK_TPU_NATIVE_TRAIN": "0"}, {"MMLSPARK_TPU_NATIVE_TRAIN": "1"},
    {"MMLSPARK_TPU_SCAN_TRAIN": "1"}, {"MMLSPARK_TPU_NO_SCAN_TRAIN": "1"},
    {"MMLSPARK_TPU_FUSED_TREE": "1"}, {"MMLSPARK_TPU_NO_FUSED_TREE": "1"},
    {"MMLSPARK_TPU_NATIVE_TRAIN_MAX": "10"},
    {"MMLSPARK_TPU_FUSED_TREE": "1", "MMLSPARK_TPU_FUSED_TREE_BYTES": "1000"},
]


@pytest.mark.parametrize("env", range(len(_ROUTE_ENVS)))
def test_route_decisions_match_the_reference(monkeypatch, env):
    """``_native_train_ok``, ``_scan_train_ok`` and ``_fused_tree_enabled``
    decide as the reference's do on the CPU for the same parameters and
    environment, goss included (it joins the scan in both)."""
    for name, value in _ROUTE_ENVS[env].items():
        monkeypatch.setenv(name, value)
    for kw in _ROUTE_PARAMS:
        rp = ref_booster.TrainParams(**kw)
        pp = booster.TrainParams(**kw)
        for n in (1000, 200_000):
            assert booster._native_train_ok(pp, n, "cpu") == \
                ref_booster._native_train_ok(rp, n), (kw, n)
        for valid, log, ck in ((None, None, None), ((1, 2), None, None),
                               (None, print, None), (None, None, "ck")):
            assert booster._scan_train_ok(pp, pp.objective, valid, log, ck,
                                          "cpu") == \
                ref_booster._scan_train_ok(rp, rp.objective, valid, log,
                                           None, ck), kw
    for shape in ((61, 28, 256), (61, 2000, 4096), (3, 1, 2)):
        assert tree._fused_tree_enabled(*shape, "cpu") == \
            ref_tree._fused_tree_enabled(*shape), shape


@pytest.mark.parametrize("case", ["gbdt", "goss", "dart_multiclass",
                                  "rf_validation"])
def test_train_native_matches_reference_bitwise(case):
    """Small fits take the native C++ engine in both packages by default:
    the port's own build of the same source gives the reference's trees and
    predictions bit for bit, and records the route."""
    from mmlspark_tpu_torch import native_loader

    rng = np.random.default_rng(8)
    X = rng.standard_normal((3000, 6))
    X[rng.random(X.shape) < 0.02] = np.nan
    y = (X[:, 0] + 0.4 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(3000)
         > 0).astype(np.float64)
    kw = dict(num_iterations=6, num_leaves=15, seed=5)
    valid = None
    if case == "goss":
        kw.update(boosting_type="goss", objective="binary")
    elif case == "dart_multiclass":
        y = np.digitize(X[:, 0], [-0.4, 0.4]).astype(np.float64)
        kw.update(boosting_type="dart", objective="multiclass", num_class=3)
    elif case == "rf_validation":
        kw.update(boosting_type="rf", objective="binary",
                  bagging_fraction=0.7, bagging_freq=1,
                  feature_fraction=0.7, early_stopping_round=2)
        valid = (X[:500], y[:500])
    else:
        kw.update(objective="binary")
    ref = ref_booster.train(ref_booster.TrainParams(**kw), X, y, valid=valid)
    before = native_loader.uses[("gbdt_grow_tree", "native")]
    port = booster.train(booster.TrainParams(**kw), X, y, valid=valid,
                         device="cpu")
    assert port.route == "native"
    assert native_loader.uses[("gbdt_grow_tree", "native")] > before
    assert port.best_iteration == ref.best_iteration
    assert ref.to_string() == port.to_string()
    np.testing.assert_array_equal(port.raw_predict(X), ref.raw_predict(X))


def test_route_is_recorded_on_the_booster_and_the_recorder(monkeypatch):
    from mmlspark_tpu_torch.obs import metrics

    X = np.random.default_rng(1).standard_normal((600, 3))
    y = X[:, 0] * 2.0
    params = booster.TrainParams(num_iterations=2, num_leaves=4)
    prev = metrics.set_default_registry(metrics.MetricsRegistry())
    try:
        routes = []
        for env in ({}, {"MMLSPARK_TPU_NATIVE_TRAIN": "0"},
                    {"MMLSPARK_TPU_FUSED_TREE": "1"},
                    {"MMLSPARK_TPU_SCAN_TRAIN": "1"}):
            with monkeypatch.context() as m:
                for k, v in env.items():
                    m.setenv(k, v)
                routes.append(booster.train(params, X, y, device="cpu").route)
        assert routes == ["native", "host", "fused", "scan"]
        c = metrics.default_registry().counter(
            "mmlspark_train_routes_total", labelnames=("engine", "route"))
        assert c.labels(engine="gbdt_native", route="native").value == 1.0
        for r in ("host", "fused", "scan"):
            assert c.labels(engine="gbdt", route=r).value == 1.0
    finally:
        metrics.set_default_registry(prev)


def test_native_binning_and_forest_predict_match_numpy(monkeypatch):
    """The native shortcuts against the port's numpy paths, bit for bit:
    ``bin_column``, ``bin_matrix`` (uint8 in one row block, int32 in ten
    on the host's threads) and
    ``forest_predict_f64`` (``predict_ensemble`` with and without
    ``MMLSPARK_TPU_NO_NATIVE_PREDICT``), each use counted by route."""
    from mmlspark_tpu_torch import native_loader

    rng = np.random.default_rng(4)
    X = rng.standard_normal((40_000, 7)) * 3        # 2^18+ cells: bin_matrix
    X[rng.random(X.shape) < 0.05] = np.nan
    X[:, 2] = np.round(X[:, 2])
    m = binning.BinMapper.fit(X, 63, seed=1)

    def numpy_bins(f):
        col = X[:, f]
        return np.where(np.isnan(col), 0, np.searchsorted(
            m.edges[f], col, side="left") + 1).astype(np.int32)

    before = dict(native_loader.uses)
    for f in range(7):
        np.testing.assert_array_equal(
            m.transform_col(f, np.ascontiguousarray(X[:, f])), numpy_bins(f))
    for dt, rows in ((np.uint8, native_loader.BIN_BLOCK_ROWS),
                     (np.int32, 4096)):       # one block; 10 on 8 threads
        monkeypatch.setattr(native_loader, "BIN_BLOCK_ROWS", rows)
        np.testing.assert_array_equal(
            m.transform_fm(X, dtype=dt),
            np.stack([numpy_bins(f) for f in range(7)]).astype(dt))
    assert native_loader.uses[("bin_matrix", "native")] == \
        before.get(("bin_matrix", "native"), 0) + 2
    assert native_loader.uses[("bin_column", "native")] > \
        before.get(("bin_column", "native"), 0)
    y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float64)
    b = booster.train(booster.TrainParams(objective="binary",
                                          num_iterations=4, num_leaves=7),
                      X, y, device="cpu")
    fast = predict.predict_ensemble(b.trees, X, 1)
    monkeypatch.setenv("MMLSPARK_TPU_NO_NATIVE_PREDICT", "1")
    slow = predict.predict_ensemble(b.trees, X, 1)
    np.testing.assert_array_equal(fast, slow)
    assert native_loader.uses[("forest_predict_f64", "native")] >= 1


def test_native_source_is_the_reference_copy():
    """The port builds its own copy of the reference's C++ source, byte for
    byte the same, at ABI version 5."""
    from mmlspark_tpu_torch import native_loader

    ref = os.path.join(os.path.dirname(RES), "..", "native", "src",
                       "mmlspark_native.cpp")
    with open(ref, "rb") as a, open(native_loader.SOURCE, "rb") as b:
        assert a.read() == b.read()
    assert native_loader.ABI_VERSION == ref_booster_native_abi()


def ref_booster_native_abi():
    from mmlspark_tpu import native_loader as ref_loader

    return ref_loader._ABI_VERSION


# ------------------------------------------------------ data-parallel fits
#
# The port's mesh is one process per shard (``parallel.mesh``), so its
# sharded fits run in gloo ranks on the CPU that import only the port
# (``parallel.launch.spawn``: a file rendezvous under the test's temporary
# directory, one thread and a 120 s limit a rank). One launch for each world
# size runs every case below; the reference's sharded fits run here, on
# ``make_mesh(MeshSpec(data=S), device_list=jax.devices()[:S])`` over the
# conftest's 8 CPU devices. Gates: the reference's own for a sharded tree
# (``tests/test_gbdt.py::test_sharded_fused_matches_single_device``:
# feature, threshold_bin, left and count identical, values within rtol
# 1e-4), and the port's single-process fit on the same route bit for bit,
# as every rank's model is.

_MESH_RANKS = r'''
"""One rank of the data-parallel cases (imports only the port)."""
import os

import numpy as np
import torch


def _dense(mesh, data, case, route):
    from mmlspark_tpu_torch.gbdt import booster

    os.environ.pop("MMLSPARK_TPU_FUSED_TREE", None)
    if route == "fused":
        os.environ["MMLSPARK_TPU_FUSED_TREE"] = "1"
    lines = []
    try:
        b = booster.train(booster.TrainParams(**case["params"]),
                          data[case["X"]], data[case["y"]], mesh=mesh,
                          log=lines.append)
    finally:
        os.environ.pop("MMLSPARK_TPU_FUSED_TREE", None)
    return b.route, b.to_string(), lines


def _sparse(mesh, data, case):
    from mmlspark_tpu_torch.gbdt import booster, sparse

    p = case["csr"]
    ds = sparse.SparseDataset.from_csr(data[p + "indptr"],
                                       data[p + "indices"],
                                       data[p + "values"], case["width"],
                                       case.get("max_bin", 64))
    b = sparse.train_sparse(booster.TrainParams(**case["params"]), ds,
                            data[p + "y"], mesh=mesh)
    return b.route, b.to_string()


def _vw(mesh, data, cfg):
    from mmlspark_tpu_torch.vw import LearnerConfig, SparseDataset
    from mmlspark_tpu_torch.vw import train_linear

    ds = SparseDataset(data["vw_idx"], data["vw_val"], data["vw_lab"],
                       data["vw_wts"])
    w, stats = train_linear(LearnerConfig(**cfg), ds, mesh=mesh)
    return w, [s.average_loss for s in stats]


def _sharded_body(mesh, data):
    """One row-sharded fused tree over this rank's block: the shard's
    tiers, the K2 compactions it made, its tables and its rows' nodes."""
    from mmlspark_tpu_torch.gbdt import histogram, select_kernel, tree

    n = len(data["cX"]) // mesh.size
    sl = slice(mesh.rank * n, (mesh.rank + 1) * n)
    bins = torch.from_numpy(np.ascontiguousarray(data["cbins"][:, sl]))
    g = torch.from_numpy(data["cg"][sl])
    h = torch.from_numpy(data["ch"][sl])
    m = torch.ones(n, dtype=torch.bool)
    cfg = tree.GrowerConfig(num_leaves=15, min_data_in_leaf=5)
    calls = []
    select = select_kernel.select_rows

    def counted(*a, **kw):
        calls.append(1)
        return select(*a, **kw)

    select_kernel.select_rows = counted
    try:
        o = tree._grow_tree_device_body(bins, g, h, m, None, 32, cfg,
                                        reduce=histogram.shard_reduce(mesh))
    finally:
        select_kernel.select_rows = select
    return (tree.device_tier_caps(n), len(calls),
            tree.pack_tables(o).numpy(), o["node_of_row"].numpy())


def _stages(mesh, data):
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.parallel import mesh as pm
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier

    X, y = data["X"], data["y"]
    df = DataFrame.from_dict({"features": list(X), "label": y},
                             num_partitions=2)
    feats = [{"indices": i, "values": v}
             for i, v in zip(data["st_idx"], data["st_val"])]
    vdf = DataFrame.from_dict({"features": feats, "label": data["st_y"]})
    out = {}
    pm.MeshContext.set(mesh)
    try:
        for nw in (0, 1):
            pm.stats.reset()
            m = LightGBMClassifier(numIterations=3, numLeaves=7,
                                   minDataInLeaf=5, numWorkers=nw).fit(df)
            out[f"lgbm{nw}"] = (m.get("model"), pm.stats.calls)
            pm.stats.reset()
            v = VowpalWabbitClassifier(numPasses=2, numWorkers=nw).fit(vdf)
            out[f"vw{nw}"] = (np.asarray(v.get("weights")), pm.stats.calls)
    finally:
        pm.MeshContext.reset()
    return out


def _ranker(mesh, data, params):
    """The LambdaRank fits over the query groups ``q`` (queries straddling
    the block edges): dense on both routes, sparse, and
    ``LightGBMRanker.fit`` under ``MeshContext`` beside ``train(mesh=)``
    with the stage's own params."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import LightGBMRanker, booster, sparse
    from mmlspark_tpu_torch.parallel import mesh as pm

    X, y, q = data["rX"], data["ry"], data["rq"]
    tp = booster.TrainParams(**params)
    out = {}
    for route in ("host", "fused"):
        os.environ.pop("MMLSPARK_TPU_FUSED_TREE", None)
        if route == "fused":
            os.environ["MMLSPARK_TPU_FUSED_TREE"] = "1"
        try:
            b = booster.train(tp, X, y, groups=q, mesh=mesh)
        finally:
            os.environ.pop("MMLSPARK_TPU_FUSED_TREE", None)
        out[("dense", route)] = (b.route, b.to_string())
    ds = sparse.SparseDataset.from_csr(data["r_indptr"], data["r_indices"],
                                       data["r_values"], X.shape[1], 64)
    b = sparse.train_sparse(tp, ds, y, groups=q, mesh=mesh)
    out["sparse"] = (b.route, b.to_string())
    df = DataFrame.from_dict({"features": list(X), "label": y, "query": q},
                             num_partitions=2)
    pm.MeshContext.set(mesh)
    try:
        m = LightGBMRanker(groupCol="query", numIterations=3, numLeaves=7,
                           minDataInLeaf=5).fit(df)
    finally:
        pm.MeshContext.reset()
    again = booster.train(m.booster.params, X, y, groups=q, mesh=mesh)
    out["stage"] = (m.booster.to_string(), again.to_string())
    return out


def _checkpointed(mesh, data, params, path):
    """A checkpointed sharded fit preempted at iteration 3 and resumed,
    beside the uninterrupted one; the checkpoint's path for the parent."""
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.gbdt import booster
    from mmlspark_tpu_torch.gbdt.checkpoint import CheckpointConfig

    tp = booster.TrainParams(**params)
    X, y = data["mX"], data["my"]
    whole = booster.train(tp, X, y, mesh=mesh, checkpoint=CheckpointConfig(
        path + ".whole", every_k=2))

    def preempt(point, iteration=None, **ctx):
        if point == faults.TRAIN_STEP and iteration == 3:
            raise faults.InjectedFault("preempted")

    prev = faults.install(preempt)
    try:
        booster.train(tp, X, y, mesh=mesh,
                      checkpoint=CheckpointConfig(path, every_k=2))
        stopped = None
    except faults.InjectedFault:
        from mmlspark_tpu_torch.gbdt.checkpoint import load_checkpoint

        stopped = load_checkpoint(path)["iteration"]
    finally:
        faults.install(prev)
    resumed = booster.train(tp, X, y, mesh=mesh,
                            checkpoint=CheckpointConfig(path, every_k=2))
    return {"whole": whole.to_string(), "resumed": resumed.to_string(),
            "stopped_at": stopped, "path": path}


def _other_axes(mesh, data, dense, sparse, vw):
    """The fits on meshes with a tensor or an fsdp axis of 2 beside a data
    axis of S / 2 (every rank of the world), and the base they must equal:
    the data-2 fit on a sub-mesh of two ranks (S = 4), or one process's
    (S = 2: a data axis of 1)."""
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh, sub_mesh

    s = mesh.size
    meshes = {axis: make_mesh(MeshSpec(data=s // 2, **{axis: 2}),
                              device="cpu", backend="gloo")
              for axis in ("tensor", "fsdp")}
    if s == 4:
        pair = [0, 1] if mesh.rank < 2 else [2, 3]
        meshes["base"] = sub_mesh(mesh, pair, MeshSpec(data=2))
    else:
        meshes["base"] = None
    os.environ["MMLSPARK_TPU_FUSED_TREE"] = "1"
    os.environ["MMLSPARK_TPU_NATIVE_VW"] = "0"    # the base's VW: the scan
    out = {}
    try:
        for name, m in meshes.items():
            out[name] = {
                "coords": None if m is None else (
                    m.coord("data"), m.coord("tensor"), m.coord("fsdp")),
                "dense": _dense_fit(m, data, dense),
                "sparse": _sparse(m, data, sparse)[1],
                "vw": _vw(m, data, vw)[0]}
    finally:
        os.environ.pop("MMLSPARK_TPU_FUSED_TREE", None)
        os.environ.pop("MMLSPARK_TPU_NATIVE_VW", None)
    return out


def _capture_agreement(mesh):
    """``graphs.Replayer`` of a sharded step whose capture fails on the
    last rank alone (a stand-in for ``Captured``): every rank must raise
    the same error, agreed through the store, before any replay."""
    from mmlspark_tpu_torch.gbdt import graphs
    from mmlspark_tpu_torch.parallel.mesh import agree

    class Capture:
        replays = 0

        def __init__(self, fn):
            if mesh.rank == mesh.size - 1:
                raise RuntimeError("injected capture failure")
            self.out = fn()

        def replay(self):
            self.replays += 1
            return self.out

    orig = graphs.Captured
    graphs.Captured = Capture
    try:
        run = graphs.Replayer(lambda x: x + 1, True,
                              lambda err: agree(mesh, "capture", err))
        first = float(run(torch.zeros(1)))
        try:
            run(torch.zeros(1))
            return first, None
        except RuntimeError as e:
            return first, str(e)
    finally:
        graphs.Captured = orig


def _dense_fit(mesh, data, case):
    from mmlspark_tpu_torch.gbdt import booster

    kw = {} if mesh is not None else {"device": "cpu"}
    return booster.train(booster.TrainParams(**case["params"]),
                         data[case["X"]], data[case["y"]], mesh=mesh,
                         **kw).to_string()


def run(mesh, inputs, dense, sparse, vw, ranker, checkpoint):
    from mmlspark_tpu_torch.parallel import mesh as pm

    data = dict(np.load(inputs))
    os.environ["MMLSPARK_TPU_NATIVE_TRAIN"] = "0"
    out = {"rank": mesh.rank, "size": mesh.size}
    for name, case in dense.items():
        for route in ("host", "fused"):
            out[("dense", name, route)] = _dense(mesh, data, case, route)
    for name, case in sparse.items():
        out[("sparse", name)] = _sparse(mesh, data, case)
    for name, cfg in vw.items():
        out[("vw", name)] = _vw(mesh, data, cfg)
    out["sharded_body"] = _sharded_body(mesh, data)
    out["ranker"] = _ranker(mesh, data, ranker)
    out["checkpoint"] = _checkpointed(
        mesh, data, checkpoint,
        os.path.join(os.path.dirname(inputs), f"ckpt_{mesh.size}.json"))
    out["other_axes"] = _other_axes(mesh, data, dense["graft"],
                                    sparse["graft"], vw["adaptive"])
    out["capture_agreement"] = _capture_agreement(mesh)
    os.environ.pop("MMLSPARK_TPU_NATIVE_TRAIN")
    out["stages"] = _stages(mesh, data)
    out["collectives"] = pm.stats.calls
    return out
'''

_MESH_DENSE = {
    # __graft_entry__.py's data-parallel gate; the training metric over the
    # gathered scores, logged every iteration
    "graft": dict(X="X", y="y", params=dict(
        objective="binary", num_iterations=4, num_leaves=7,
        min_data_in_leaf=5, train_metric=True)),
    # GOSS ranks the gathered gradients; feature fraction draws per tree
    "goss": dict(X="gX", y="gy", params=dict(
        objective="binary", boosting_type="goss", num_iterations=4,
        num_leaves=15, min_data_in_leaf=5, top_rate=0.3, other_rate=0.2,
        feature_fraction=0.8, seed=4)),
    # bagging's draws over every row, three trees an iteration; the draws
    # take the padded row count (the reference's), so 2048 rows, which no
    # world size pads, give the single-process fit's masks
    "multiclass_bag": dict(X="mX", y="my", params=dict(
        objective="multiclass", num_class=3, num_iterations=3, num_leaves=7,
        min_data_in_leaf=5, bagging_fraction=0.7, bagging_freq=1, seed=2)),
}
_MESH_SPARSE = {
    # __graft_entry__.py's sparse data-parallel gate
    "graft": dict(csr="g_", width=12, params=dict(
        objective="binary", num_iterations=3, num_leaves=7,
        min_data_in_leaf=5)),
    # test_torch_sparse's text-shaped fixture and its binary fit's params:
    # blocks with uneven entries
    "text": dict(csr="t_", width=1 << 10, max_bin=255, params=dict(
        objective="binary", num_iterations=4, num_leaves=15,
        min_data_in_leaf=20, learning_rate=0.2)),
}
# LambdaRank over 4,000 rows whose queries straddle every block edge at S =
# 2 and 4 (1,024-row blocks at S = 4): a 1,300-row query over rows 900-2199
# (across three blocks at S = 4), a 1,000-row one over 2600-3599, a
# singleton beside them
_MESH_RANKER = dict(objective="lambdarank", num_iterations=3, num_leaves=7,
                    min_data_in_leaf=5)
# bagging and feature fraction: the checkpoint holds the generator's state
# and the bag mask (2,048 rows: every world size's padded count)
_MESH_CKPT = dict(objective="multiclass", num_class=3, num_iterations=6,
                  num_leaves=7, min_data_in_leaf=5, bagging_fraction=0.7,
                  bagging_freq=1, feature_fraction=0.75, seed=2)
_MESH_VW = {
    "adaptive": dict(num_bits=10, loss_function="logistic", num_passes=3),
    "ftrl": dict(num_bits=10, loss_function="logistic", num_passes=2,
                 ftrl=True),
    # lr 0 freezes the weights: each real example's loss is log 2, so a pad
    # row in the loss shows (tests/test_vw.py's padded-loss gate)
    "pad_lr0": dict(num_bits=12, loss_function="logistic", learning_rate=0.0,
                    adaptive=False, num_passes=1),
}


def _mesh_inputs():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(600, 6))
    d = {"X": X, "y": (X[:, 0] - X[:, 1] > 0).astype(np.float64)}
    rng = np.random.default_rng(8)
    gX = rng.normal(size=(1500, 5))
    d["gX"] = gX
    d["gy"] = (gX[:, 0] + 0.5 * rng.normal(size=1500) > 0).astype(np.float64)
    rng = np.random.default_rng(11)
    mX = rng.normal(size=(2048, 4))
    d["mX"] = mX
    d["my"] = np.digitize(mX[:, 0] + mX[:, 1], [-0.8, 0.8]).astype(
        np.float64)
    rng = np.random.default_rng(5)
    Xs = rng.normal(size=(600, 12)) * (rng.random((600, 12)) < 0.3)
    nzr, nzc = np.nonzero(Xs)
    d["g_indptr"] = np.searchsorted(nzr, np.arange(601))
    d["g_indices"], d["g_values"] = nzc, Xs[nzr, nzc]
    d["g_y"] = (Xs[:, 0] - Xs[:, 1] > 0).astype(np.float64)
    from test_torch_sparse import make_csr_text

    (d["t_indptr"], d["t_indices"], d["t_values"],
     d["t_y"]) = make_csr_text(2000, 1 << 10, 20, 1)
    rng = np.random.default_rng(0)
    n, k = 401, 8
    d["vw_idx"] = rng.integers(0, 1 << 10, (n, k)).astype(np.int32)
    d["vw_idx"][:, 3] = d["vw_idx"][:, 1]          # duplicates in a row
    d["vw_val"] = rng.standard_normal((n, k)).astype(np.float32)
    d["vw_val"][:, -2:] = 0
    raw = (d["vw_val"] * rng.standard_normal(k)).sum(1)
    d["vw_lab"] = np.where(raw > 0, 1.0, -1.0).astype(np.float32)
    d["vw_wts"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    # the sharded body's case: 8192 rows a shard, so it would have a tier
    rng = np.random.default_rng(12)
    cX = rng.normal(size=(4 * 8192, 4))
    d["cX"] = cX
    d["cbins"] = np.clip((cX.T * 6 + 16), 0, 31).astype(np.int32)
    d["cg"] = (np.tanh(cX[:, 0]) - (cX[:, 1] > 0)).astype(np.float32)
    d["ch"] = rng.uniform(0.1, 0.3, len(cX)).astype(np.float32)
    rng = np.random.default_rng(5)
    d["st_idx"] = np.stack([np.sort(rng.choice(1 << 9, 6, replace=False))
                            for _ in range(300)])
    d["st_val"] = rng.standard_normal((300, 6)).astype(np.float32)
    d["st_y"] = (d["st_val"][:, :3].sum(1) > 0).astype(np.float64)
    d.update(_ranker_inputs())
    return d


def _ranker_inputs(n=4000, seed=21):
    """``_MESH_RANKER``'s rows: relevance 0-4 from the first two features,
    queries of 1-40 rows around the long ones; the sparse copy keeps the
    nonzeros (about 70%)."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < 900:
        sizes.append(int(rng.integers(1, 41)))
    sizes[-1] -= sum(sizes) - 900
    sizes += [1300, 1]
    while sum(sizes) < 2600:
        sizes.append(int(rng.integers(1, 41)))
    sizes[-1] -= sum(sizes) - 2600
    sizes += [1000]
    while sum(sizes) < n:
        sizes.append(int(rng.integers(1, 41)))
    sizes[-1] -= sum(sizes) - n
    sizes = [v for v in sizes if v > 0]
    q = np.repeat(np.arange(len(sizes)), sizes)
    X = rng.normal(size=(n, 5)) * (rng.random((n, 5)) < 0.7)
    rel = X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=n)
    y = np.digitize(rel, [-0.5, 0.3, 1.0, 1.8]).astype(np.float64)
    nzr, nzc = np.nonzero(X)
    return {"rX": X, "ry": y, "rq": q,
            "r_indptr": np.searchsorted(nzr, np.arange(n + 1)),
            "r_indices": nzc, "r_values": X[nzr, nzc]}


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def mesh_run(request, tmp_path_factory):
    """Every case of ``_MESH_RANKS`` in S gloo ranks (one launch a world
    size): (S, the inputs, each rank's results)."""
    from mmlspark_tpu_torch.parallel.launch import spawn

    s = request.param
    work = tmp_path_factory.mktemp(f"mesh{s}")
    (work / "mesh_ranks.py").write_text(_MESH_RANKS)
    data = _mesh_inputs()
    np.savez(work / "inputs.npz", **data)
    ranks = spawn("mesh_ranks:run", s, work, dict(
        inputs=str(work / "inputs.npz"), dense=_MESH_DENSE,
        sparse=_MESH_SPARSE, vw=_MESH_VW, ranker=_MESH_RANKER,
        checkpoint=_MESH_CKPT), threads=1, timeout=300, path=[str(work)])
    return s, data, ranks


def _ref_mesh(s):
    import jax

    from mmlspark_tpu.parallel.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(data=s), device_list=jax.devices()[:s])


def _assert_ranks_agree(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        got = r[key]
        if isinstance(first, tuple) and isinstance(first[0], np.ndarray):
            for a, b in zip(first, got):
                np.testing.assert_array_equal(a, b)
        else:
            assert got == first, f"rank {r['rank']} differs on {key}"
    return first


def _goes_left(tree, i, X, rows):
    """Which of ``rows`` node ``i`` of ``tree`` sends left (raw thresholds,
    ``<=`` goes left, NaN by ``default_left``)."""
    x = X[rows, int(tree.feature[i])]
    return np.where(np.isnan(x), tree.default_left[i], x <= tree.threshold[i])


def _binary_grads(model, X, y, it):
    """The binary log-loss gradients and hessians ``model``'s tree ``it``
    was grown on (f64, from its own scores before that tree)."""
    s = (np.full(len(X), float(model.base_score[0])) if it == 0
         else np.asarray(model.raw_predict(X, num_iteration=it)))
    p = 1.0 / (1.0 + np.exp(-s))
    return p - y, p * (1.0 - p)


def _split_gain(g, h, rows, go, l2):
    G, H = g[rows].sum(), h[rows].sum()
    GL, HL = g[rows][go].sum(), h[rows][go].sum()
    return 0.5 * (GL * GL / (HL + l2) + (G - GL) ** 2 / (H - HL + l2)
                  - G * G / (H + l2)), 0.5 * G * G / (H + l2)


def _assert_sharded_gate(ref, port, X, rtol=1e-4, atol=1e-6, y=None,
                         l2=0.0):
    """tests/test_gbdt.py's sharded-tree gate, tree by tree over the
    training rows ``X``: feature, threshold_bin, left and count identical,
    values within ``rtol``. Nodes are paired from the root down. Where a
    node's (feature, threshold_bin) differ, the rows must show a tie:

      - both splits send the same rows of the node each way (a threshold
        across bins empty in the node's summed histogram, or another
        feature with the same partition): one gain, exact, and the walk
        goes on;
      - with the binary labels ``y`` (the sparse fits against the
        reference's single device), the splits may part the rows
        differently where each model's split gains, in f64 under its own
        gradients, at least the other's less 1e-6 of the node's own
        objective (an exact gain tie that f32 noise breaks either way).
        The models then differ below that node and in every later tree:
        from there every leaf is held to its own rows' Newton step (within
        ``rtol``) and every split that differs to the same rule, instead of
        to the other model."""
    assert len(ref.trees) == len(port.trees)
    models = (ref, port)
    diverged = False
    for it, (gr, gp) in enumerate(zip(ref.trees, port.trees)):
        assert len(gr) == len(gp)
        grads = [_binary_grads(m, X, y, it) for m in models] \
            if y is not None else None
        for a, b in zip(gr, gp):
            stack = [(0, 0, np.arange(len(X)), diverged)]
            while stack:
                i, j, rows, div = stack.pop()
                trees, nodes = (a, b), (i, j)
                if not div:
                    assert a.count[i] == b.count[j], (it, i, "count")
                if a.feature[i] < 0 or b.feature[j] < 0:
                    if div:
                        for t, k, gh in zip(trees, nodes, grads):
                            _assert_own_steps(t, k, X, rows, gh, l2, rtol,
                                              atol)
                        continue
                    assert a.feature[i] == b.feature[j] == -1, (it, i)
                    np.testing.assert_allclose(a.value[i], b.value[j],
                                               rtol=rtol, atol=atol)
                    continue
                go_a, go_b = (_goes_left(a, i, X, rows),
                              _goes_left(b, j, X, rows))
                same = (a.feature[i] == b.feature[j]
                        and a.threshold_bin[i] == b.threshold_bin[j])
                if same or np.array_equal(go_a, go_b):
                    stack += [(int(a.left[i]), int(b.left[j]), rows[go_a],
                               div),
                              (int(a.right[i]), int(b.right[j]),
                               rows[~go_a], div)]
                    continue
                assert y is not None, (
                    f"tree {it} node {i}: features {a.feature[i]} and "
                    f"{b.feature[j]}, bins {a.threshold_bin[i]} and "
                    f"{b.threshold_bin[j]} part its rows differently")
                for (g, h), mine, other in zip(grads, (go_a, go_b),
                                               (go_b, go_a)):
                    own, scale = _split_gain(g, h, rows, mine, l2)
                    alt, _ = _split_gain(g, h, rows, other, l2)
                    assert own >= alt - 1e-6 * scale - 1e-12, (
                        it, i, own, alt)
                diverged = True
                for t, k, gh in zip(trees, nodes, grads):
                    _assert_own_steps(t, k, X, rows, gh, l2, rtol, atol)


def _assert_own_steps(t, i, X, rows, grads, l2, rtol, atol):
    """In the subtree of ``t`` under node ``i`` (reached by ``rows``): every
    leaf's value is its rows' Newton step ``-G / (H + l2)`` under the
    model's own gradients (a leaf's ``value`` is the step before the
    learning rate, which ``shrinkage`` holds)."""
    g, h = grads
    stack = [(i, rows)]
    while stack:
        k, r = stack.pop()
        if t.feature[k] < 0:
            want = -g[r].sum() / (h[r].sum() + l2)
            np.testing.assert_allclose(t.value[k], want, rtol=rtol,
                                       atol=atol)
            continue
        gl = _goes_left(t, k, X, r)
        stack += [(int(t.left[k]), r[gl]), (int(t.right[k]), r[~gl])]


@pytest.mark.parametrize("route", ["host", "fused"])
@pytest.mark.parametrize("case", sorted(_MESH_DENSE))
def test_mesh_dense_fit_matches_reference_and_single_process(
        mesh_run, monkeypatch, case, route):
    """``train(mesh=)`` at S ranks: every rank's model byte for byte the
    same, equal to the port's single-process fit on the same route, and to
    the reference's sharded fit under its gate."""
    s, data, ranks = mesh_run
    spec = _MESH_DENSE[case]
    got_route, got, lines = _assert_ranks_agree(ranks, ("dense", case, route))
    assert got_route == route
    X, y = data[spec["X"]], data[spec["y"]]
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    if route == "fused":
        monkeypatch.setenv("MMLSPARK_TPU_FUSED_TREE", "1")
    want = []
    single = booster.train(booster.TrainParams(**spec["params"]), X, y,
                           device="cpu", log=want.append)
    assert single.route == route
    assert got == single.to_string()
    assert lines == want and (len(lines) == 4) == (case == "graft")
    monkeypatch.setenv("MMLSPARK_TPU_FUSED_TREE", "1")
    ref = ref_booster.train(ref_booster.TrainParams(**spec["params"]), X, y,
                            mesh=_ref_mesh(s))
    _assert_sharded_gate(ref, booster.Booster.from_string(got), X)


@pytest.mark.parametrize("case", sorted(_MESH_SPARSE))
def test_mesh_sparse_fit_matches_reference_and_single_process(mesh_run,
                                                              case):
    """``train_sparse(mesh=)``: nnz-balanced blocks of uneven rows and
    entries, each rank's own tensors unpadded; the model is every rank's
    and the single-process fused fit's bit for bit. Against the reference:
    its sharded fit under its own gate for one
    (``__graft_entry__.py``'s: accuracy within 0.02, mean |dp| < 0.05),
    since the reference's sharded sparse trees leave its own single-device
    ones (f32 prefix differences, then a psum of f32: leaf values 7e-3
    apart and a swapped split at S = 4 on the text data); and its
    single-device fit under ``test_torch_sparse.py``'s gate (structure
    identical, a threshold bin only at a tie the rows show, leaf values
    within ``hist.csr``'s 2e-3)."""
    from mmlspark_tpu.gbdt import sparse as ref_sparse
    from mmlspark_tpu_torch.gbdt import sparse

    s, data, ranks = mesh_run
    spec = _MESH_SPARSE[case]
    got_route, got = _assert_ranks_agree(ranks, ("sparse", case))
    assert got_route == "fused"
    p = spec["csr"]
    csr = (data[p + "indptr"], data[p + "indices"], data[p + "values"])
    y = data[p + "y"]
    mb = spec.get("max_bin", 64)
    ds = sparse.SparseDataset.from_csr(*csr, spec["width"], mb)
    bounds = sparse.shard_bounds(ds, s)
    nnz = np.diff(ds.indptr[bounds])
    assert len(set(np.diff(bounds))) > 1 or len(set(nnz)) > 1  # uneven
    single = sparse.train_sparse(booster.TrainParams(**spec["params"]), ds,
                                 y, device="cpu")
    assert single.route == "fused"
    assert got == single.to_string()
    port = booster.Booster.from_string(got)
    rds = ref_sparse.SparseDataset.from_csr(*csr, spec["width"], mb)
    rp = ref_booster.TrainParams(**spec["params"])
    ref = ref_sparse.train_sparse(rp, rds, y, mesh=_ref_mesh(s))
    with use_device("cpu"):
        p1 = sparse.predict_csr(port.trees, *csr, 1)[:, 0]
    p2 = ref_sparse.predict_csr(ref.trees, *csr, 1)[:, 0]
    acc1 = float((((p1 + port.base_score[0]) > 0) == y).mean())
    acc2 = float((((p2 + ref.base_score[0]) > 0) == y).mean())
    assert abs(acc1 - acc2) <= 0.02, (acc1, acc2)
    assert float(np.mean(np.abs(p1 - p2))) < 0.05
    dense = np.zeros((len(y), spec["width"]))
    row = np.repeat(np.arange(len(y)), np.diff(csr[0]))
    dense[row, csr[1]] = csr[2]
    _assert_sharded_gate(ref_sparse.train_sparse(rp, rds, y), port, dense,
                         rtol=2e-3, atol=2e-3, y=y)


@pytest.mark.parametrize("case", sorted(_MESH_VW))
def test_mesh_vw_fit_matches_reference_mesh_fit(mesh_run, case):
    """``train_linear(mesh=)``: per-shard scans averaged between passes, the
    401 rows padded with inert rows; within the engines' bound (rtol 1e-3,
    atol 2e-4, tests/test_vw.py) of the reference's mesh fit, the same on
    every rank, and at lr 0 the loss exactly log 2."""
    import importlib

    ref_learner = importlib.import_module("mmlspark_tpu.vw.learner")
    s, data, ranks = mesh_run
    w, losses = _assert_ranks_agree(ranks, ("vw", case))
    ds = ref_learner.SparseDataset(data["vw_idx"], data["vw_val"],
                                   data["vw_lab"], data["vw_wts"])
    w_ref, st = ref_learner.train_linear(
        ref_learner.LearnerConfig(**_MESH_VW[case]), ds, mesh=_ref_mesh(s))
    np.testing.assert_allclose(w, np.asarray(w_ref), rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(losses, [x.average_loss for x in st],
                               rtol=1e-3)
    if case == "pad_lr0":
        assert losses[0] == pytest.approx(np.log(2), abs=1e-6)


def test_mesh_fused_tree_compacts_no_rows_and_equals_one_process(mesh_run):
    """Under the mesh the fused body compacts no small child (the
    reference's rule under ``psum``), though each shard's rows would fill a
    tier: every histogram is the block's full width under its mask. The
    tree is bit for bit the one process's body over all rows (which
    compacts), and each rank's rows' nodes are that body's for its
    block."""
    s, data, ranks = mesh_run
    bins = torch.from_numpy(data["cbins"])
    n = bins.shape[1]
    cfg = tree.GrowerConfig(num_leaves=15, min_data_in_leaf=5)
    assert tree.device_tier_caps(n)                  # one process compacts
    one = tree._grow_tree_device_body(
        bins, torch.from_numpy(data["cg"]), torch.from_numpy(data["ch"]),
        torch.ones(n, dtype=torch.bool), None, 32, cfg)
    want = tree.pack_tables(one).numpy()
    for r in ranks:
        caps, calls, packed, rows = r["sharded_body"]
        assert caps and calls == 0
        np.testing.assert_array_equal(packed, want)
        b = n // s
        np.testing.assert_array_equal(
            rows, one["node_of_row"].numpy()[r["rank"] * b:(r["rank"] + 1) * b])


def test_mesh_stages_under_mesh_context(mesh_run, monkeypatch):
    """``LightGBMClassifier`` and ``VowpalWabbitClassifier`` under
    ``MeshContext.set``: the sharded fits (the single-process per-split fit
    bit for bit; the reference's stages under its MeshContext within the
    gates), and ``numWorkers=1`` forcing one shard (no collective)."""
    import importlib

    from mmlspark_tpu.parallel.mesh import MeshContext as RefMeshContext
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier

    ref_vw = importlib.import_module("mmlspark_tpu.vw")
    s, data, ranks = mesh_run
    out = [r["stages"] for r in ranks]
    for key in ("lgbm0", "lgbm1"):
        assert all(o[key][0] == out[0][key][0] for o in out)
    for key in ("vw0", "vw1"):
        for o in out[1:]:
            np.testing.assert_array_equal(o[key][0], out[0][key][0])
    assert out[0]["lgbm0"][1] > 0 and out[0]["vw0"][1] > 0
    assert out[0]["lgbm1"][1] == 0 and out[0]["vw1"][1] == 0
    X, y = data["X"], data["y"]
    kw = dict(numIterations=3, numLeaves=7, minDataInLeaf=5)
    feats = [{"indices": i, "values": v}
             for i, v in zip(data["st_idx"], data["st_val"])]
    with use_device("cpu"):
        one = stages.LightGBMClassifier(**kw).fit(
            DataFrame.from_dict({"features": list(X), "label": y},
                                num_partitions=2))
        vw_one = VowpalWabbitClassifier(numPasses=2).fit(
            DataFrame.from_dict({"features": feats, "label": data["st_y"]}))
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    with use_device("cpu"):
        host = stages.LightGBMClassifier(**kw).fit(
            DataFrame.from_dict({"features": list(X), "label": y},
                                num_partitions=2))
    assert out[0]["lgbm0"][0] == host.get("model")
    assert out[0]["lgbm1"][0] == one.get("model")
    np.testing.assert_array_equal(out[0]["vw1"][0],
                                  np.asarray(vw_one.get("weights")))
    monkeypatch.setenv("MMLSPARK_TPU_FUSED_TREE", "1")
    RefMeshContext.set(_ref_mesh(s))
    try:
        ref = ref_stages.LightGBMClassifier(**kw).fit(RefDataFrame.from_dict(
            {"features": list(X), "label": y}, num_partitions=2))
        ref_v = ref_vw.VowpalWabbitClassifier(numPasses=2).fit(
            RefDataFrame.from_dict({"features": feats,
                                    "label": data["st_y"]}))
    finally:
        RefMeshContext.reset()
    _assert_sharded_gate(ref._booster,
                         booster.Booster.from_string(out[0]["lgbm0"][0]), X)
    np.testing.assert_allclose(out[0]["vw0"][0],
                               np.asarray(ref_v.get("weights")),
                               rtol=1e-3, atol=2e-4)


def _straddlers(q, edges):
    """For each block edge, the query that crosses it (None: the edge falls
    between two queries)."""
    out = []
    for e in edges:
        out.append(int(q[e]) if 0 < e < len(q) and q[e - 1] == q[e] else None)
    return out


@pytest.mark.parametrize("kind", ["host", "fused", "sparse"])
def test_mesh_ranker_matches_reference_and_single_process(mesh_run,
                                                          monkeypatch, kind):
    """LambdaRank under ``train(mesh=)`` / ``train_sparse(mesh=)``: queries
    straddle every block edge (one across three blocks at S = 4, a 1,000-row
    one, a singleton beside them), so each rank gathers the scores of the
    queries crossing its edges. Every rank's model is the port's
    single-process fit byte for byte (a query's g and h do not depend on
    the queries that share its bucket), and the reference's sharded ranker
    within its sharded-tree gate."""
    from mmlspark_tpu.gbdt import sparse as ref_sparse
    from mmlspark_tpu_torch.gbdt import sparse

    s, data, ranks = mesh_run
    X, y, q = data["rX"], data["ry"], data["rq"]
    key = "sparse" if kind == "sparse" else ("dense", kind)
    got_route, got = _assert_ranks_agree([r["ranker"] | {"rank": r["rank"]}
                                          for r in ranks], key)
    assert got_route == ("fused" if kind == "sparse" else kind)
    csr = (data["r_indptr"], data["r_indices"], data["r_values"])
    if kind == "sparse":
        ds = sparse.SparseDataset.from_csr(*csr, X.shape[1], 64)
        edges = sparse.shard_bounds(ds, s)[1:-1]
    else:
        edges = [len(q) * i // s for i in range(1, s)]
    across = _straddlers(q, edges)
    assert all(a is not None for a in across), (edges, across)
    if s == 4 and kind != "sparse":
        assert across[0] == across[1]                  # across three blocks
    assert 1 in np.bincount(q)                          # a singleton
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    params = booster.TrainParams(**_MESH_RANKER)
    if kind == "sparse":
        single = sparse.train_sparse(params, ds, y, groups=q, device="cpu")
    else:
        if kind == "fused":
            monkeypatch.setenv("MMLSPARK_TPU_FUSED_TREE", "1")
        single = booster.train(params, X, y, groups=q, device="cpu")
    assert single.route == got_route
    assert got == single.to_string()
    monkeypatch.setenv("MMLSPARK_TPU_FUSED_TREE", "1")
    rp = ref_booster.TrainParams(**_MESH_RANKER)
    if kind == "sparse":
        rds = ref_sparse.SparseDataset.from_csr(*csr, X.shape[1], 64)
        ref = ref_sparse.train_sparse(rp, rds, y, groups=q, mesh=_ref_mesh(s))
    else:
        ref = ref_booster.train(rp, X, y, groups=q, mesh=_ref_mesh(s))
    _assert_sharded_gate(ref, booster.Booster.from_string(got), X)


def test_mesh_ranker_stage_under_mesh_context(mesh_run, monkeypatch):
    """``LightGBMRanker.fit`` under ``MeshContext.set``: the sharded fit
    (``train(mesh=)`` with the stage's params, byte for byte) and the
    single-process stage fit byte for byte."""
    from mmlspark_tpu_torch.gbdt import LightGBMRanker

    s, data, ranks = mesh_run
    stage_model, again = _assert_ranks_agree(
        [r["ranker"] | {"rank": r["rank"]} for r in ranks], "stage")
    assert stage_model == again
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    df = DataFrame.from_dict({"features": list(data["rX"]),
                              "label": data["ry"], "query": data["rq"]},
                             num_partitions=2)
    with use_device("cpu"):
        one = LightGBMRanker(groupCol="query", numIterations=3, numLeaves=7,
                             minDataInLeaf=5).fit(df)
    assert stage_model == one.booster.to_string()


def test_mesh_checkpoint_resumes_to_the_uninterrupted_fit(mesh_run,
                                                          monkeypatch):
    """A checkpointed sharded fit (bagging, feature fraction, three classes)
    preempted at its fourth iteration resumes from the checkpoint of the
    second to the uninterrupted sharded fit byte for byte, which is the
    single-process fit. The file is the reference's format (its
    ``load_checkpoint`` reads it) with every row's scores, padded
    ``(n, k)``; a resume over another shard count raises."""
    from mmlspark_tpu.gbdt.checkpoint import load_checkpoint as ref_load
    from mmlspark_tpu_torch.gbdt.checkpoint import CheckpointConfig

    s, data, ranks = mesh_run
    outs = [r["checkpoint"] for r in ranks]
    for o in outs:
        assert o["stopped_at"] == 2
        assert o["resumed"] == o["whole"] == outs[0]["whole"]
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    params = booster.TrainParams(**_MESH_CKPT)
    X, y = data["mX"], data["my"]
    single = booster.train(params, X, y, device="cpu")
    assert outs[0]["whole"] == single.to_string()
    ck = ref_load(outs[0]["path"])
    assert ck["iteration"] == _MESH_CKPT["num_iterations"]
    assert ck["scores"].shape == (len(y), 3) and ck["data_shards"] == s
    with pytest.raises(ValueError, match="same data and mesh"):
        booster.train(params, X, y, device="cpu",
                      checkpoint=CheckpointConfig(outs[0]["path"]))


@pytest.mark.parametrize("kind", ["dense", "sparse", "vw"])
def test_mesh_fits_on_a_tensor_or_fsdp_axis(mesh_run, monkeypatch, kind):
    """GBDT and VW fits on a mesh whose tensor or fsdp axis is 2 beside the
    data axis (S / 2): the ranks that share a data coordinate hold the same
    block, and the fit is byte for byte the data-(S / 2) fit (at S = 4 on a
    sub-mesh of two ranks, at S = 2 one process's); at S = 4 the
    reference's data 2 x tensor 2 fit within its sharded-tree gate."""
    s, data, ranks = mesh_run
    for r in ranks:
        got = r["other_axes"]
        base = got["base"][kind]
        for axis in ("tensor", "fsdp"):
            d, t, f = got[axis]["coords"]
            assert d == r["rank"] // 2 if s == 4 else d == 0
            assert (t, f) == ((r["rank"] % 2, 0) if axis == "tensor"
                              else (0, r["rank"] % 2))
            if kind == "vw":
                np.testing.assert_array_equal(
                    got[axis][kind].view(np.uint32), base.view(np.uint32))
            else:
                assert got[axis][kind] == base, (r["rank"], axis)
        if kind == "vw":
            np.testing.assert_array_equal(
                base, ranks[0]["other_axes"]["base"][kind])
        else:
            assert base == ranks[0]["other_axes"]["base"][kind]
    if kind != "dense" or s != 4:
        return
    from mmlspark_tpu.parallel.mesh import MeshSpec as RefSpec
    from mmlspark_tpu.parallel.mesh import make_mesh as ref_make

    import jax

    spec = _MESH_DENSE["graft"]
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    monkeypatch.setenv("MMLSPARK_TPU_FUSED_TREE", "1")
    X, y = data[spec["X"]], data[spec["y"]]
    ref = ref_booster.train(ref_booster.TrainParams(**spec["params"]), X, y,
                            mesh=ref_make(RefSpec(data=2, tensor=2),
                                          device_list=jax.devices()[:4]))
    _assert_sharded_gate(ref, booster.Booster.from_string(
        ranks[0]["other_axes"]["tensor"]["dense"]), X)


def test_mesh_capture_failure_on_one_rank_raises_on_every_rank(mesh_run):
    """A sharded tree's CUDA-graph capture that fails on one rank alone
    (the last; ``Captured`` stood in for on the CPU) raises the same error
    on every rank before any replay: the ranks agree through the process
    group's store (``parallel.mesh.agree``), not the communicator a failed
    capture may leave out of step, so none waits in a replayed collective
    for a partner that is not there. The eager first call ran on all."""
    s, data, ranks = mesh_run
    outs = [r["capture_agreement"] for r in ranks]
    for first, err in outs:
        assert first == 1.0
        assert err is not None and "injected capture failure" in err
        assert err == outs[0][1]
    assert f"{s - 1}:" in outs[0][1]


def test_mesh_collectives_stage_tensors_where_the_backend_runs():
    """NCCL runs on the mesh's card, so a host tensor (the host-kept scores
    a sparse or DART fit's log gathers) goes there first; gloo runs on the
    host; a tensor already where its backend runs is used as it is. (The
    ``meta`` device stands in for the card.)"""
    from mmlspark_tpu_torch.parallel import mesh as pm

    t = torch.arange(4.0)
    nccl = pm.Mesh(shape={"data": 2}, backend="nccl",
                   device=torch.device("meta"))
    assert pm._staged(nccl, t).device.type == "meta"
    on_card = t.to("meta")
    assert pm._staged(nccl, on_card) is on_card
    gloo = pm.Mesh(shape={"data": 2}, backend="gloo")
    assert pm._staged(gloo, t) is t


def test_mesh_spec_resolve_and_process_shard_match_reference():
    """The host-only pieces: ``MeshSpec.resolve`` (with -1 absorbing the
    rest, and its errors) and ``process_shard``'s round robin."""
    from mmlspark_tpu.parallel import mesh as ref_mesh
    from mmlspark_tpu_torch.parallel import mesh as port_mesh

    for kw, n in (({}, 4), ({"data": 2}, 2), ({"data": -1, "fsdp": 2}, 8),
                  ({"data": 3, "tensor": 2}, 6)):
        assert port_mesh.MeshSpec(**kw).resolve(n) == \
            ref_mesh.MeshSpec(**kw).resolve(n)
    for kw, n in (({"data": -1, "fsdp": -1}, 4), ({"data": 3}, 4),
                  ({"data": -1, "tensor": 3}, 4)):
        with pytest.raises(ValueError):
            ref_mesh.MeshSpec(**kw).resolve(n)
        with pytest.raises(ValueError):
            port_mesh.MeshSpec(**kw).resolve(n)
    rows = {"x": np.arange(40.0)}
    df = DataFrame.from_dict(rows, num_partitions=5)
    rdf = RefDataFrame.from_dict(rows, num_partitions=5)
    for pid in range(3):
        got = port_mesh.process_shard(df, pid, 3)
        want = ref_mesh.process_shard(rdf, pid, 3)
        np.testing.assert_array_equal(np.asarray(got.column("x")),
                                      np.asarray(want.column("x")))
    assert port_mesh.process_shard(df, 0, 1) is df
    assert port_mesh.process_shard(
        DataFrame.from_dict(rows, num_partitions=1), 2, 3).count() == 0


# ---------------------------------------------------------------------------
# AutoML, the lasso and LIME (``mmlspark_tpu_torch.automl``, ``.ops.lasso``,
# ``.lime``) against the reference's, on the same numpy inputs. Tolerances:
#   - the lasso: 1e-4 * max(1, max|w|) on w and b (f32 sums in another
#     order over 200 nonexpansive ISTA steps; measured here <= 3e-7);
#   - tuning on the device path of both packages (``ref_device_path``):
#     ``allMetrics`` within 1e-12, ``bestParams`` and the best model's
#     predicted labels equal, its probabilities within 1e-6 (the
#     reference sums its trees in f32). ``evaluationMetric="AUC"`` is held
#     so where no two of a fold's scores tie in the reference's f32 sums
#     but not in the port's f64 ones (the grid case); the sampled case,
#     whose 150 rows hold such a pair, is held on ``accuracy``;
#   - ``MetricEvaluator`` and ``FindBestModel`` on the same scored
#     frames: equal;
#   - LIME: the reference's probes and a LightGBM model, explanations
#     within the lasso's tolerance; ``slic`` labels bitwise.
# ---------------------------------------------------------------------------

import contextlib  # noqa: E402
import threading  # noqa: E402

from mmlspark_tpu import automl as ref_automl  # noqa: E402
from mmlspark_tpu import lime as ref_lime  # noqa: E402
from mmlspark_tpu.core.schema import ImageSchema as RefImageSchema  # noqa: E402
from mmlspark_tpu.ops import lasso as ref_lasso  # noqa: E402
from mmlspark_tpu_torch import automl, lime, runtime  # noqa: E402
from mmlspark_tpu_torch.core.params import Param  # noqa: E402
from mmlspark_tpu_torch.core.pipeline import (Estimator,  # noqa: E402
                                              Model, PipelineStage)
from mmlspark_tpu_torch.core.schema import ImageSchema  # noqa: E402
from mmlspark_tpu_torch.ops import lasso  # noqa: E402

LASSO_TOL = 1e-4


def _lasso_tol(w):
    return LASSO_TOL * max(1.0, float(np.abs(np.asarray(w)).max()))


@pytest.mark.parametrize("b,n,d,reg,weighted", [
    (3, 300, 10, 0.01, True), (4, 100, 20, 0.0, False),
    (2, 1000, 7, 0.5, True), (64, 50, 3, 0.05, False)])
def test_fit_lasso_matches_reference(b, n, d, reg, weighted):
    rng = np.random.default_rng(b * 100 + d)
    X = (rng.normal(size=(b, n, d))
         * rng.uniform(0.1, 3.0, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) + 1.5
         + 0.1 * rng.normal(size=(b, n))).astype(np.float32)
    sw = rng.uniform(0.1, 1.0, (b, n)).astype(np.float32) if weighted \
        else np.ones((b, n), np.float32)
    wr, br = ref_lasso.fit_lasso_batch(X, y, np.float32(reg), sw)
    wp, bp = lasso.fit_lasso_batch(X, y, reg, sw if weighted else None,
                                   device="cpu")
    tol = _lasso_tol(wr)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wr), rtol=0, atol=tol)
    np.testing.assert_allclose(bp.numpy(), np.asarray(br), rtol=0, atol=tol)
    w1, b1 = ref_lasso.fit_lasso(X[0], y[0], np.float32(reg),
                                 fit_intercept=False)
    w2, b2 = lasso.fit_lasso(torch.from_numpy(X[0]), y[0], reg,
                             fit_intercept=False)
    assert w2.device.type == "cpu" and float(b2) == 0.0 == float(b1)
    np.testing.assert_allclose(w2.numpy(), np.asarray(w1), rtol=0,
                               atol=_lasso_tol(w1))


def test_lasso_reference_assertions():
    """``tests/test_lime.py``'s two lasso cases, through the port."""
    rng = np.random.default_rng(0)
    n, d = 300, 10
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = np.zeros(d)
    w_true[2], w_true[7] = 3.0, -2.0
    y = X @ w_true + 1.5 + 0.01 * rng.normal(size=n)
    with use_device("cpu"):
        w, b = lasso.fit_lasso(X, y.astype(np.float32), 0.01, iters=500)
        w = w.numpy()
        np.testing.assert_allclose(w[[2, 7]], [3.0, -2.0], atol=0.15)
        assert np.abs(w[[0, 1, 3, 4, 5, 6, 8, 9]]).max() < 0.1
        assert abs(float(b) - 1.5) < 0.2
        rng = np.random.default_rng(1)
        X = rng.normal(size=(100, 20)).astype(np.float32)
        y = (X[:, 0] + 0.01 * rng.normal(size=100)).astype(np.float32)
        w_strong, _ = lasso.fit_lasso(X, y, 0.5, iters=300)
        w_none, _ = lasso.fit_lasso(X, y, 0.0, iters=300)
    assert (w_strong.abs() > 1e-4).sum() < (w_none.abs() > 1e-4).sum()


def _clf_cols(n=250, seed=0):
    """``tests/test_automl_recommendation.py``'s ``clf_df`` columns."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    y = (X[:, 0] + 0.5 * X[:, 1]
         + rng.normal(scale=0.3, size=n) > 0).astype(float)
    return {"features": [X[i] for i in range(n)], "label": y}


_AUTOML = {"ref": (ref_automl, RefDataFrame, ref_stages.LightGBMClassifier),
           "port": (automl, DataFrame, stages.LightGBMClassifier)}


def _tune(pkg, space_kind, metric, par, n):
    A, DF, LC = _AUTOML[pkg]
    df = DF.from_dict(_clf_cols(n), num_partitions=2)
    if space_kind == "grid":
        est = LC(numIterations=10, minDataInLeaf=5)
        space = A.GridSpace(A.HyperparamBuilder().add_hyperparam(
            est, "numLeaves", A.DiscreteHyperParam([7, 31])).build())
        kw = {}
    else:
        est = LC(numIterations=5, minDataInLeaf=5)
        space = A.ParamSpace(A.HyperparamBuilder().add_hyperparam(
            est, "learningRate", A.RangeHyperParam(0.05, 0.3)).build(),
            seed=1)
        kw = {"numRuns": 3}
    model = A.TuneHyperparameters(
        models=[est], paramSpace=space, evaluationMetric=metric, numFolds=2,
        parallelism=par, labelCol="label", **kw).fit(df)
    return model, model.transform(df)


def _same_tuning(ref, port):
    (rm, rs), (pm, ps) = ref, port
    np.testing.assert_allclose(pm.get("allMetrics"), rm.get("allMetrics"),
                               rtol=0, atol=1e-12)
    assert pm.get("bestParams") == rm.get("bestParams")
    assert abs(pm.get("bestMetric") - rm.get("bestMetric")) <= 1e-12
    np.testing.assert_array_equal(ps.column("prediction"),
                                  rs.column("prediction"))
    np.testing.assert_allclose(np.stack(list(ps.column("probability"))),
                               np.stack(list(rs.column("probability"))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("metric", ["accuracy", "AUC", "precision", "recall"])
def test_tune_grid_matches_reference(ref_device_path, metric):
    """The reference test's grid (numLeaves 7 or 31, two folds) with each
    classification metric: the port at parallelism 1 and 2 against the
    reference, and the two parallelisms bit for bit."""
    ref = _tune("ref", "grid", metric, 1, 250)
    with use_device("cpu"):
        one = _tune("port", "grid", metric, 1, 250)
        two = _tune("port", "grid", metric, 2, 250)
    _same_tuning(ref, one)
    _same_tuning(ref, two)
    assert one[0].get("allMetrics") == two[0].get("allMetrics")
    assert one[0].get("bestModel").get_model_string() == \
        two[0].get("bestModel").get_model_string()
    assert len(one[0].get("allMetrics")) == 2
    assert "prediction" in one[1].columns


def test_tune_sampled_space_matches_reference(ref_device_path):
    """The reference test's sampled space (three learning rates drawn from
    ``default_rng(1)``) at parallelism 2: the same draws, metrics and
    best setting; on AUC the port's two parallelisms agree bit for bit."""
    ref = _tune("ref", "sampled", "accuracy", 2, 150)
    with use_device("cpu"):
        port = _tune("port", "sampled", "accuracy", 2, 150)
        auc_one = _tune("port", "sampled", "AUC", 1, 150)[0]
        auc_two = _tune("port", "sampled", "AUC", 2, 150)[0]
    _same_tuning(ref, port)
    assert len(port[0].get("allMetrics")) == 3
    assert auc_one.get("allMetrics") == auc_two.get("allMetrics")
    assert auc_one.get("bestParams") == auc_two.get("bestParams")


class _DeviceProbe(Estimator):
    """Records, at each fit, the thread and the device it resolves."""

    nothing = Param("nothing", "A setting to tune", 0, ptype=int)
    seen: list = []

    def fit(self, df):
        _DeviceProbe.seen.append((threading.get_ident(),
                                  runtime.default_device()))
        return _ConstModel()


class _ConstModel(Model):
    def transform(self, df):
        n = df.count()
        return df.with_column("prediction", np.zeros(n)) \
            .with_column("probability", [np.array([0.5, 0.5])] * n)


def test_parallel_tune_workers_run_on_the_callers_device():
    """A pool worker does not inherit ``use_device``: each enters the
    caller's device, so a parallelism-2 tune under ``use_device("cpu")``
    resolves the CPU in every worker (without the card it would raise)
    and its LightGBM fits equal the serial tune's."""
    _DeviceProbe.seen = []
    df = DataFrame.from_dict(_clf_cols(80), num_partitions=2)
    probe = _DeviceProbe()
    space = automl.ParamSpace([(probe, "nothing", automl.DiscreteHyperParam(
        [0]))], seed=0)
    with use_device("cpu"):
        automl.TuneHyperparameters(
            models=[probe], paramSpace=space, evaluationMetric="accuracy",
            numFolds=2, numRuns=4, parallelism=2).fit(df)
    workers = {t for t, _ in _DeviceProbe.seen[:-1]}
    assert threading.get_ident() not in workers
    assert {d.type for _, d in _DeviceProbe.seen} == {"cpu"}
    assert len(_DeviceProbe.seen) == 4 * 2 + 1
    with use_device("cpu"):
        one = _tune("port", "grid", "accuracy", 1, 120)[0]
        two = _tune("port", "grid", "accuracy", 2, 120)[0]
    assert one.get("allMetrics") == two.get("allMetrics")


def test_automl_spaces_match_reference():
    """Sampled settings, grids and the default ranges are the reference's
    (numpy draws from the same seeds)."""
    for A, LC in ((ref_automl, ref_stages.LightGBMClassifier),
                  (automl, stages.LightGBMClassifier)):
        with pytest.raises(KeyError):
            A.HyperparamBuilder().add_hyperparam(LC(), "nope",
                                                 A.DiscreteHyperParam([1]))
    got = []
    for A, LC in ((ref_automl, ref_stages.LightGBMClassifier),
                  (automl, stages.LightGBMClassifier)):
        est = LC()
        b = (A.HyperparamBuilder()
             .add_hyperparam(est, "numLeaves", A.RangeHyperParam(2, 64))
             .add_hyperparam(est, "learningRate",
                             A.RangeHyperParam(0.01, 0.3))
             .add_hyperparam(est, "maxBin", A.DiscreteHyperParam([15, 63])))
        gen = A.ParamSpace(b.build(), seed=7).param_maps()
        draws = [[(n, v) for _, n, v in next(gen)] for _ in range(20)]
        grid = A.GridSpace(b.build())
        got.append((draws, grid.space_size(),
                    [[(n, v) for _, n, v in s] for s in grid.param_maps()],
                    [(n, d.grid_values()) for n, d in
                     A.DefaultHyperparams.for_estimator(est)]))
    assert got[0] == got[1]


@pytest.mark.parametrize("metric", ["accuracy", "precision", "recall", "AUC",
                                    "mean_squared_error",
                                    "root_mean_squared_error",
                                    "mean_absolute_error", "R^2"])
def test_metric_evaluator_matches_reference(metric):
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 300).astype(np.float64)
    p1 = np.clip(0.6 * y + 0.5 * rng.random(300), 0, 1)
    p1[:9] = 0.5                                  # tied scores
    cols = {"label": y, "prediction": (p1 > 0.5).astype(np.float64),
            "probability": [np.array([1 - v, v]) for v in p1]}
    got = []
    for A, DF in ((ref_automl, RefDataFrame), (automl, DataFrame)):
        ev = A.MetricEvaluator(metric, labelCol="label")
        got.append((ev.evaluate(DF.from_dict(dict(cols), num_partitions=2)),
                    ev.is_larger_better()))
    assert got[0] == got[1]


def test_find_best_model_matches_reference(ref_device_path):
    """``tests/test_automl_recommendation.py``'s FindBestModel case: the
    same winner, metric and metrics table."""
    out = []
    for A, DF, LC in _AUTOML.values():
        df = DF.from_dict(_clf_cols(), num_partitions=2)
        ctx = use_device("cpu") if A is automl else contextlib.nullcontext()
        with ctx:
            good = LC(numIterations=20, numLeaves=15, minDataInLeaf=5).fit(df)
            bad = LC(numIterations=1, numLeaves=2, learningRate=0.001,
                     minDataInLeaf=100).fit(df)
            best = A.FindBestModel(models=[bad, good],
                                   evaluationMetric="accuracy",
                                   labelCol="label").fit(df)
        assert best.get_or_throw("bestModel") is good
        assert best.get_evaluation_results().count() == 2
        out.append((best.get("bestMetric"),
                    best.get_evaluation_results().rows()))
    assert out[0][0] == out[1][0]
    assert [r["accuracy"] for r in out[0][1]] == \
        [r["accuracy"] for r in out[1][1]]


class _LinearProbe:
    """``tests/test_lime.py``'s fake model: prediction = w . features."""

    def __init__(self, w, col="features"):
        self.w = np.asarray(w, dtype=np.float64)
        self.col = col

    def has_param(self, name):
        return name == "featuresCol"

    def get(self, name):
        return self.col

    def transform(self, df):
        return df.with_column("prediction", lambda p: np.array(
            [float(self.w @ np.asarray(v, dtype=np.float64).reshape(-1))
             for v in p[self.col]]))


class _BrightnessProbe:
    """``tests/test_lime.py``'s fake image model: the mean pixel of the
    left half."""

    def __init__(self, schema):
        self.schema = schema

    def has_param(self, name):
        return name == "inputCol"

    def get(self, name):
        return "image"

    def transform(self, df):
        def fn(p):
            out = np.zeros(len(p["image"]))
            for i, row in enumerate(p["image"]):
                img = self.schema.to_array(row).astype(np.float64)
                out[i] = img[:, : img.shape[1] // 2].mean()
            return out
        return df.with_column("prediction", fn)


def _same_explanations(ref_col, port_col):
    assert len(ref_col) == len(port_col)
    for a, b in zip(ref_col, port_col):
        if a is None:
            assert b is None
            continue
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=_lasso_tol(a))


def _tabular(pkg, kind):
    L, DF = (ref_lime, RefDataFrame) if pkg == "ref" else (lime, DataFrame)
    rng = np.random.default_rng(0)
    n, d = 60, 4
    X = rng.normal(size=(n, d)) * np.array([1.0, 2.0, 0.5, 1.0])
    w_true = np.array([2.0, -1.0, 0.0, 3.0])
    cols = {"features": [X[i] for i in range(n)]}
    if kind == "linear":
        model, pred, n_samples = _LinearProbe(w_true), "prediction", 400
    else:
        LC = ref_stages.LightGBMClassifier if pkg == "ref" \
            else stages.LightGBMClassifier
        cols["label"] = (X @ w_true > 0).astype(np.float64)
        model = LC(numIterations=10, numLeaves=7, minDataInLeaf=5).fit(
            DF.from_dict(dict(cols)))
        pred, n_samples = "probability", 200
    df = DF.from_dict(cols, num_partitions=2)
    if kind == "linear":
        df = df.with_column("features", lambda p: p["features"])
    m = L.TabularLIME(inputCol="features", outputCol="weights",
                      nSamples=n_samples, predictionCol=pred,
                      regularization=0.001 if kind == "lgbm" else 0.0
                      ).set("model", model).fit(df)
    col = np.empty(6, dtype=object)
    for i in range(6):
        col[i] = None if i == 2 else X[i]
    return m, m.transform(DF([{"features": col[:3]},
                              {"features": col[3:]}]))


@pytest.mark.parametrize("kind", ["linear", "lgbm"])
def test_tabular_lime_matches_reference(ref_device_path, kind):
    """The reference test's linear probe (weights recovered within 0.2),
    and a LightGBM classifier's probability, explained over two partitions
    with a missing row: the same draws, explanations within the lasso's
    tolerance."""
    _, ref = _tabular("ref", kind)
    with use_device("cpu"):
        _, port = _tabular("port", kind)
    _same_explanations(ref.column("weights"), port.column("weights"))
    if kind == "linear":
        for w in port.column("weights"):
            if w is not None:
                np.testing.assert_allclose(w, [2.0, -1.0, 0.0, 3.0],
                                           atol=0.2)


def _images(schema):
    rng = np.random.default_rng(3)
    flat = np.full((24, 24, 3), 200, dtype=np.uint8)
    noisy = rng.integers(0, 255, (24, 30, 3), dtype=np.uint8)
    return [schema.make(flat), None, schema.make(noisy)]


def test_image_lime_matches_reference():
    """The reference test's left-half probe over a flat and a noisy image
    (different superpixel counts: the batch pads the narrower) and a
    missing row: superpixels bitwise, importances within the lasso's
    tolerance, and the reference test's assertion."""
    out = []
    for L, DF, S in ((ref_lime, RefDataFrame, RefImageSchema),
                     (lime, DataFrame, ImageSchema)):
        df = DF.from_dict({"image": _images(S)})
        with use_device("cpu"):
            out.append(L.ImageLIME(
                inputCol="image", outputCol="weights", nSamples=80,
                cellSize=12.0).set("model", _BrightnessProbe(S)).transform(df))
    ref, port = out
    _same_explanations(ref.column("weights"), port.column("weights"))
    for a, b in zip(ref.column("superpixels"), port.column("superpixels")):
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(a["labels"], b["labels"])
        assert a["numClusters"] == b["numClusters"]
    w = port.column("weights")[0]
    labels = port.column("superpixels")[0]["labels"]
    left_ids = set(labels[:, :10].ravel().tolist())
    right_ids = set(labels[:, 14:].ravel().tolist()) - left_ids
    left_imp = np.mean([w[i] for i in left_ids])
    right_imp = np.mean([w[i] for i in right_ids]) if right_ids else 0.0
    assert left_imp > right_imp + 1.0


def _slic_image(kind):
    rng = np.random.default_rng(11)
    if kind == "noise":
        return rng.integers(0, 255, (40, 52, 3)).astype(np.uint8)
    if kind == "halves":
        img = np.zeros((32, 32, 3))
        img[:, 16:] = 255.0
        return img
    if kind == "gray":
        return rng.normal(size=(33, 30)) * 50.0
    yy, xx = np.mgrid[:64, :64]                  # smooth: tied distances
    return np.stack([yy * 4, xx * 4, (yy + xx) * 2], -1).astype(np.uint8)


@pytest.mark.parametrize("kind", ["noise", "halves", "gray", "ramp"])
@pytest.mark.parametrize("cell,mod", [(16.0, 130.0), (8.0, 20.0),
                                      (12.0, 130.0)])
def test_slic_labels_match_reference_bitwise(kind, cell, mod):
    img = _slic_image(kind)
    want = ref_lime.slic(img, cell, mod)
    got = lime.slic(img, cell, mod, device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_superpixel_transformer_matches_reference():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)
    ref = ref_lime.SuperpixelTransformer(inputCol="image").transform(
        RefDataFrame.from_dict({"image": [RefImageSchema.make(img), None]}))
    with use_device("cpu"):
        port = lime.SuperpixelTransformer(inputCol="image").transform(
            DataFrame.from_dict({"image": [ImageSchema.make(img), None]}))
    a, b = ref.column("superpixels")[0], port.column("superpixels")[0]
    np.testing.assert_array_equal(a["labels"], b["labels"])
    assert a["numClusters"] == b["numClusters"] > 1
    assert port.column("superpixels")[1] is None


@pytest.mark.parametrize("name", ["TuneHyperparametersModel",
                                  "TabularLIMEModel"])
def test_automl_and_lime_models_save_and_load(ref_device_path, tmp_path,
                                              name):
    """The tuned model and a TabularLIME model over the port's LightGBM
    round-trip through ``core/serialize``: the same outputs bit for bit."""
    with use_device("cpu"):
        if name == "TuneHyperparametersModel":
            stage, df = _tune("port", "grid", "accuracy", 1, 120)[0], \
                DataFrame.from_dict(_clf_cols(40))
        else:
            stage, _ = _tabular("port", "lgbm")
            df = DataFrame.from_dict({"features": [
                np.arange(4.0) * 0.1, np.ones(4)]})
        want = stage.transform(df)
        stage.save(str(tmp_path / "s"))
        loaded = PipelineStage.load(str(tmp_path / "s"))
        assert type(loaded) is type(stage)
        got = loaded.transform(df)
    assert got.columns == want.columns
    for c in want.columns:
        for a, b in zip(want.column(c), got.column(c)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if name == "TuneHyperparametersModel":
        for p in ("bestParams", "allMetrics", "bestMetric"):
            assert loaded.get(p) == stage.get(p)
