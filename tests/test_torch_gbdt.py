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
from mmlspark_tpu_torch.gbdt import stages, tree
from mmlspark_tpu_torch.runtime import use_device

from test_benchmarks import _base_params

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


def test_train_step_seam_and_recorder():
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.obs import metrics

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
