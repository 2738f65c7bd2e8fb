"""The port's sparse (CSR) GBDT path against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and go through the reference
(``mmlspark_tpu.gbdt.sparse``) and the port (``mmlspark_tpu_torch.gbdt.sparse``
on ``device="cpu"``, where K4's wrapper runs its plain version).

Tolerances, and why:
  - dataset layout, routing, integer prefixes, counts: exact;
  - K4's plain version against the reference's Pallas kernel (interpret
    mode, f32 sums per 512-entry chunk): count exact, g/h within
    1e-5 * sum|v| over the bin's entries + 1e-6;
  - against the reference's default prefix-sum histogram (bin sums as
    differences of ONE f32 prefix over all entries, off by ~1e-4 already at
    a few thousand entries): the reference's own declared tolerance for its
    histogram variants, ``hist.csr``'s allclose(rtol=2e-3, atol=2e-3);
  - trees: feature, threshold_bin, left, right, default_left and count
    identical; leaf values within ``hist.csr``'s tolerance of the
    reference's, and within rtol 1e-5 of an f64 recomputation from the rows
    each leaf holds (the port sums exactly and rounds once).

The fixtures are text-shaped (token counts 1-4, a few levels per feature),
the data the sparse path exists for. Continuous values with a bin per
distinct value give nodes whose rows leave adjacent bins empty; candidates
across those bins tie exactly, and the reference's f32 prefix noise breaks
such ties at random (ROADMAP §C), so they cannot be held to identical
thresholds.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mmlspark_tpu.core.dataframe import DataFrame as RefDataFrame
from mmlspark_tpu.gbdt import pallas_sparse
from mmlspark_tpu.gbdt import sparse as ref_sparse
from mmlspark_tpu.gbdt import stages as ref_stages
from mmlspark_tpu.gbdt.booster import TrainParams as RefTrainParams
from mmlspark_tpu.gbdt.tree import GrowerConfig as RefGrowerConfig
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.gbdt import convert, sparse, sparse_hist_kernel, stages
from mmlspark_tpu_torch.gbdt.booster import TrainParams
from mmlspark_tpu_torch.gbdt.tree import GrowerConfig
from mmlspark_tpu_torch.runtime import use_device

from test_gbdt_sparse import dense_to_csr, sparse_rows, synth_sparse

HIST_CSR_TOL = 2e-3      # mmlspark_tpu/core/kernels.py _HIST_TOL (hist.csr)
STRUCT = ("feature", "threshold_bin", "left", "right", "default_left", "count")


def make_csr_text(n_rows, width, avg_nnz, seed=0):
    """The reference benchmark's text-shaped CSR (tools/bench_gbdt_sparse.py
    make_csr_text): skewed token ids, counts 1-4, label from 8 signal
    tokens plus noise."""
    rng = np.random.default_rng(seed)
    nnz_per_row = rng.poisson(avg_nnz, n_rows).clip(1)
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_per_row)
    idx = (width * rng.random(int(nnz_per_row.sum())) ** 3).astype(np.int64)
    key = np.unique(row_of * width + idx.clip(0, width - 1))
    row_of, idx = key // width, key % width
    vals = 1.0 + rng.integers(0, 4, len(key)).astype(np.float64)
    indptr = np.searchsorted(row_of, np.arange(n_rows + 1))
    signal = (width * np.linspace(0.01, 0.6, 8) ** 3).astype(np.int64)
    sig = np.zeros(n_rows)
    for j, s in enumerate(signal):
        hit = idx == s
        np.add.at(sig, row_of[hit], (1.0 if j % 2 == 0 else -1.0) * vals[hit])
    y = (sig + rng.normal(0, 0.5, n_rows) > 0).astype(np.float64)
    return indptr, idx, vals, y


def _datasets(n=2000, width=1 << 10, avg=20, seed=1, max_bin=255):
    indptr, idx, vals, y = make_csr_text(n, width, avg, seed)
    rds = ref_sparse.SparseDataset.from_csr(indptr, idx, vals, width, max_bin)
    return (indptr, idx, vals, y), rds, convert.sparse_dataset_from_reference(rds)


def _abs_bin_sums(ids, vals, tb):
    return np.bincount(ids, weights=np.abs(vals.astype(np.float64)),
                       minlength=tb)


def _assert_same_tree(a, b, where=""):
    for fld in STRUCT:
        np.testing.assert_array_equal(getattr(a, fld), getattr(b, fld),
                                      err_msg=f"{where} {fld}")
    np.testing.assert_array_equal(a.threshold, b.threshold, err_msg=where)
    np.testing.assert_allclose(b.value, a.value, rtol=HIST_CSR_TOL,
                               atol=HIST_CSR_TOL, err_msg=where)


def _assert_same_forest(ref, port):
    assert len(ref.trees) == len(port.trees)
    for i, (gr, gp) in enumerate(zip(ref.trees, port.trees)):
        assert len(gr) == len(gp)
        for k, (a, b) in enumerate(zip(gr, gp)):
            _assert_same_tree(a, b, f"iteration {i} class {k}")


# ---------------------------------------------------------------- dataset


@pytest.mark.parametrize("case", ["text", "signed", "capped", "rows"])
def test_sparse_dataset_fields_match(case):
    if case == "text":
        (indptr, idx, vals, _), rds, _ = _datasets(800, 1 << 9, 12, seed=4)
        pds = sparse.SparseDataset.from_csr(indptr, idx, vals, 1 << 9, 255)
    elif case in ("signed", "capped"):
        X, _ = synth_sparse(300, 12, density=0.3, seed=7)
        mb = 255 if case == "signed" else 16
        indptr, idx, vals = dense_to_csr(X)
        rds = ref_sparse.SparseDataset.from_csr(indptr, idx, vals, 12, mb)
        pds = sparse.SparseDataset.from_csr(indptr, idx, vals, 12, mb)
    else:
        X, _ = synth_sparse(200, 9, density=0.25, seed=2)
        X[5] = 0.0                                  # an empty row
        rows = sparse_rows(X, size=12)              # declared width > data
        rds = ref_sparse.SparseDataset.from_rows(rows, max_bin=32)
        pds = sparse.SparseDataset.from_rows(rows, max_bin=32)
    for f in dataclasses.fields(ref_sparse.SparseDataset):
        r, p = getattr(rds, f.name), getattr(pds, f.name)
        if f.name == "num_features":
            assert r == p
        else:
            assert np.asarray(r).dtype == np.asarray(p).dtype, f.name
            np.testing.assert_array_equal(r, p, err_msg=f.name)
    assert rds.bin_upper_value(0, 0) == pds.bin_upper_value(0, 0)


def test_device_arrays_match_reference_layout():
    _, rds, pds = _datasets(600, 1 << 8, 10, seed=3)
    rdev = ref_sparse._device_arrays(rds)
    pdev = sparse.device_arrays(pds, "cpu")
    for key in ("bin_of_nnz", "feat_of_nnz", "row_of_nnz_bs", "bin_end",
                "is_zero_bin", "feat_of_bin", "feat_start_of_bin",
                "feat_end_of_bin", "is_last_bin"):
        np.testing.assert_array_equal(np.asarray(rdev[key]), pdev[key].numpy(),
                                      err_msg=key)
    np.testing.assert_array_equal(np.asarray(rdev["indptr_dev"]),
                                  pdev["indptr"].numpy())
    assert pdev["route_steps"] == rdev["route_steps"]
    assert pdev["bin_of_nnz"].dtype == torch.int32
    longest = int(np.diff(pds.feat_offset).max())
    assert 2 ** pdev["scan_steps"] >= longest > 2 ** (pdev["scan_steps"] - 1)


# ------------------------------------------------------------------- K4


def _hist_case(nnz, tb, seed, empty_every=0):
    """Bin-sorted entries over ``tb`` bins (every ``empty_every``-th bin
    empty), stats masked at 50%."""
    rng = np.random.default_rng(seed)
    weights = rng.random(tb) ** 4 + 1e-3        # skewed bin sizes
    if empty_every:
        weights[::empty_every] = 0.0
    ids = np.sort(rng.choice(tb, size=nnz, p=weights / weights.sum()))
    bin_end = np.searchsorted(ids, np.arange(tb), side="right")
    m = (rng.random(nnz) < 0.5).astype(np.float32)
    g = rng.standard_normal(nnz).astype(np.float32)
    h = (rng.random(nnz) + 0.1).astype(np.float32)
    data = np.stack([g * m, h * m, m]).astype(np.float32)
    return ids.astype(np.int32), bin_end.astype(np.int32), data


@pytest.mark.parametrize("nnz,tb,empty", [(1, 1, 0), (5, 9, 2), (4000, 300, 0),
                                          (6000, 777, 3), (3000, 1, 0)])
def test_sparse_hist_plain_matches_pallas_kernel(nnz, tb, empty):
    ids, bin_end, data = _hist_case(nnz, tb, seed=nnz + tb, empty_every=empty)
    got = sparse_hist_kernel.sparse_histogram(torch.from_numpy(data),
                                              torch.from_numpy(bin_end)).numpy()
    assert got.shape == (3, tb) and got.dtype == np.float32
    ref = np.asarray(pallas_sparse.sparse_histogram_mxu(
        jnp.asarray(ids), jnp.asarray(data), tb, interpret=True))
    np.testing.assert_array_equal(got[2], ref[2])
    for ch in (0, 1):
        tol = 1e-5 * _abs_bin_sums(ids, data[ch], tb) + 1e-6
        assert (np.abs(got[ch] - ref[ch]) <= tol).all(), ch
    exact = np.stack([np.bincount(ids, weights=data[c].astype(np.float64),
                                  minlength=tb) for c in range(3)])
    np.testing.assert_array_equal(got, exact.astype(np.float32))


_PATH_CASES = [(6000, 777, 0), (3000, 1, 0), (4000, 900, 2), (0, 50, 0),
               (300, 2000, 0), (5000, 40, 3)]


@pytest.fixture(params=["kernel tiles", "small tiles"])
def k4_tiles(request, monkeypatch):
    """K4's tile and grid constants as the kernel has them, or cut so that
    a few thousand entries span many shares, tiles and threads."""
    if request.param == "small tiles":
        monkeypatch.setattr(sparse_hist_kernel, "THREADS", 4)
        monkeypatch.setattr(sparse_hist_kernel, "ITEMS_PER_THREAD", 3)
        monkeypatch.setattr(sparse_hist_kernel, "TILE", 12)
        monkeypatch.setattr(sparse_hist_kernel, "END_WINDOW", 3)
        monkeypatch.setattr(sparse_hist_kernel, "SMS", 8)
    return request.param


def _walk(bin_end, nnz, i, j, items):
    """The merge path walked one item at a time from (marker i, entry j):
    (markers, entries, end coordinate)."""
    markers, entries = [], []
    for _ in range(items):
        if i < len(bin_end) and (j >= nnz or bin_end[i] <= j):
            markers.append(i)
            i += 1
        else:
            entries.append(j)
            j += 1
    return markers, entries, (i, j)


@pytest.mark.parametrize("nnz,tb,empty", _PATH_CASES)
def test_merge_path_partition_covers_every_item_once(k4_tiles, nnz, tb, empty):
    """K4's shares: the binary search lands where the walk does, the shares
    abut, every bin-end marker and every entry falls in exactly one share,
    and the carries run in share order (a share's head is the bin open at
    its start, its tail the bin open at its end, the next share's start)."""
    _, bin_end, data = _hist_case(nnz, tb, seed=nnz + tb + 1, empty_every=empty)
    be = [int(v) for v in bin_end]
    n_shares, share = sparse_hist_kernel.shares(nnz, tb)
    assert n_shares * share >= nnz + tb > (n_shares - 1) * share
    markers, entries, pos = [], [], (0, 0)
    starts = []
    for p in range(n_shares):
        d0, d1 = p * share, min((p + 1) * share, nnz + tb)
        i0 = sparse_hist_kernel.merge_path_search(be, nnz, d0)
        assert (i0, d0 - i0) == pos
        starts.append(i0)
        m, e, pos = _walk(be, nnz, *pos, d1 - d0)
        markers += m
        entries += e
    assert markers == list(range(tb)) and entries == list(range(nnz))
    _, carries = sparse_hist_kernel.partitioned_histogram(data, bin_end)
    assert len(carries) == n_shares
    for p, (head, tail) in enumerate(carries):
        assert head in (-1, starts[p])
        assert tail == (starts[p + 1] if p + 1 < n_shares else tb)
    if k4_tiles == "small tiles" and nnz + tb > 100:
        assert n_shares > 1


@pytest.mark.parametrize("nnz,tb,empty", _PATH_CASES)
def test_partitioned_reduction_matches_plain_and_pallas(k4_tiles, nnz, tb,
                                                        empty):
    """K4's partitioned f64 reduction (shares, tiles, thread runs, the
    block scan and the carries across shares), emulated in numpy, against
    the plain version and the reference's Pallas kernel in interpret mode:
    every bin written, counts exact, g/h within 1e-5 * sum|v| + 1e-6."""
    ids, bin_end, data = _hist_case(nnz, tb, seed=nnz + tb + 2,
                                    empty_every=empty)
    got, _ = sparse_hist_kernel.partitioned_histogram(data, bin_end)
    assert not np.isnan(got).any()
    plain = sparse_hist_kernel.sparse_histogram_plain(
        torch.from_numpy(data), torch.from_numpy(bin_end)).numpy()
    refs = [plain]
    if nnz:
        refs.append(np.asarray(pallas_sparse.sparse_histogram_mxu(
            jnp.asarray(ids), jnp.asarray(data), tb, interpret=True)))
    for ref in refs:
        np.testing.assert_array_equal(got[2], ref[2])
        for ch in (0, 1):
            tol = 1e-5 * _abs_bin_sums(ids, data[ch], tb) + 1e-6
            assert (np.abs(got[ch] - ref[ch]) <= tol).all(), ch


def test_sparse_hist_empty_stream_and_device_guard():
    data = torch.zeros(3, 0)
    out = sparse_hist_kernel.sparse_histogram(data, torch.zeros(4, dtype=torch.int32))
    assert out.shape == (3, 4) and not out.any()
    before = sparse_hist_kernel.launches
    _, bin_end, d = _hist_case(500, 40, seed=1)
    sparse_hist_kernel.sparse_histogram(torch.from_numpy(d), torch.from_numpy(bin_end))
    assert sparse_hist_kernel.launches == before     # CPU: plain, no launch
    with pytest.raises(ValueError, match="device"):
        sparse_hist_kernel.sparse_histogram(torch.zeros(3, 2, device="meta"),
                                            torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("masked", [False, True])
def test_flat_histogram_matches_reference_prefix_form(masked):
    _, rds, pds = _datasets(1500, 1 << 9, 15, seed=5)
    rdev = ref_sparse._device_arrays(rds)
    pdev = sparse.device_arrays(pds, "cpu")
    rng = np.random.default_rng(6)
    g = rng.standard_normal(1500).astype(np.float32)
    h = (rng.random(1500) + 0.2).astype(np.float32)
    mask = rng.random(1500) < 0.6 if masked else np.ones(1500, bool)
    gb, hb = ref_sparse._entry_gh(rdev, jnp.asarray(g), jnp.asarray(h))
    ref = np.asarray(ref_sparse._flat_histogram(rdev, gb, hb, jnp.asarray(mask)))
    pg, ph = sparse._entry_gh(pdev, torch.from_numpy(g), torch.from_numpy(h))
    got = sparse._flat_histogram(pdev, pg, ph, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got, ref, rtol=HIST_CSR_TOL, atol=HIST_CSR_TOL)
    tot = np.array([(g * mask).sum(), (h * mask).sum(), mask.sum()], np.float32)
    rz = np.asarray(ref_sparse._zero_completed(rdev, jnp.asarray(ref),
                                               jnp.asarray(tot)))
    pz = sparse._zero_completed(pdev, torch.from_numpy(got),
                                torch.from_numpy(tot)).numpy()
    np.testing.assert_array_equal(pz[2], rz[2])
    np.testing.assert_allclose(pz, rz, rtol=HIST_CSR_TOL, atol=HIST_CSR_TOL)
    # every present feature's bins now sum to the node totals
    fo = pds.feat_offset
    present = np.nonzero(np.diff(fo))[0]
    feat_tot = np.add.reduceat(pz.astype(np.float64), fo[present], axis=1)
    np.testing.assert_allclose(feat_tot, np.repeat(tot[:, None], len(present), 1),
                               rtol=1e-5, atol=1e-3)


# ------------------------------------------------------- prefix and split


@pytest.mark.parametrize("n", [700, (1 << 18) + 300])
def test_prefix_sum_matches_reference(n):
    rng = np.random.default_rng(n)
    data = np.stack([rng.standard_normal(n), rng.random(n),
                     rng.integers(0, 3, n)]).astype(np.float32)
    r_cs, r_ci = ref_sparse._prefix_sum(jnp.asarray(data), int_channel=2)
    p_cs, p_ci = sparse._prefix_sum(torch.from_numpy(data), int_channel=2)
    assert p_cs.shape == (3, n + 1) and p_ci.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(r_ci), p_ci.numpy())
    if n < (1 << 18):        # jnp.cumsum: the port reproduces XLA's CPU order
        np.testing.assert_array_equal(np.asarray(r_cs), p_cs.numpy())
    else:                    # blocked product: another f32 summation order
        scale = np.abs(np.asarray(r_cs)).max(axis=1, keepdims=True)
        np.testing.assert_allclose(p_cs.numpy(), np.asarray(r_cs), rtol=0,
                                   atol=float(1e-6 * scale.max()))


def test_segmented_cumsum_is_per_feature_cumsum():
    _, _, pds = _datasets(500, 1 << 8, 12, seed=8)
    pdev = sparse.device_arrays(pds, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, pds.total_bins)))
    got = sparse._segmented_cumsum(pdev, x).numpy()
    fo = pds.feat_offset
    for f in np.nonzero(np.diff(fo))[0][::7]:
        seg = x.numpy()[..., fo[f]:fo[f + 1]]
        np.testing.assert_allclose(got[..., fo[f]:fo[f + 1]], np.cumsum(seg, -1),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("l1,l2,mdl,masked", [(0.0, 0.0, 20, False),
                                              (0.1, 1.0, 5, True)])
def test_find_best_split_flat_matches(l1, l2, mdl, masked):
    _, rds, pds = _datasets(1200, 1 << 9, 15, seed=9)
    rdev = ref_sparse._device_arrays(rds)
    pdev = sparse.device_arrays(pds, "cpu")
    rng = np.random.default_rng(10)
    g = rng.standard_normal(1200).astype(np.float32)
    h = (rng.random(1200) + 0.2).astype(np.float32)
    gb, hb = ref_sparse._entry_gh(rdev, jnp.asarray(g), jnp.asarray(h))
    tot = jnp.asarray(np.array([g.sum(), h.sum(), 1200], np.float32))
    hist = ref_sparse._zero_completed(
        rdev, ref_sparse._flat_histogram(rdev, gb, hb, jnp.ones(1200, bool)),
        tot)
    bm = None
    if masked:
        fm = rng.random(pds.num_features) < 0.5
        bm = fm[np.repeat(np.arange(pds.num_features), np.diff(pds.feat_offset))]
    r = ref_sparse._find_best_split_flat(
        rdev, hist, np.float32(l1), np.float32(l2), np.float32(1e-3), mdl,
        None if bm is None else jnp.asarray(bm))
    r = np.concatenate([[float(r[0]), float(r[1])], np.asarray(r[2]),
                        np.asarray(r[3])])
    h_t = torch.tensor(np.asarray(hist))[None]
    bm_t = None if bm is None else torch.from_numpy(bm)
    faithful = sparse._find_best_split_flat(pdev, h_t, l1, l2, 1e-3, mdl, bm_t,
                                            faithful=True)[0].numpy()
    np.testing.assert_array_equal(faithful.astype(np.float32),
                                  r.astype(np.float32))
    port = sparse._find_best_split_flat(pdev, h_t, l1, l2, 1e-3, mdl,
                                        bm_t)[0].numpy()
    # exact within-feature sums against the reference's f32 prefix
    # differences: same bin, sums and gain within hist.csr's tolerance
    assert port[0] == r[0]
    np.testing.assert_allclose(port[1:], r[1:], rtol=HIST_CSR_TOL,
                               atol=HIST_CSR_TOL)


# ------------------------------------------------------------------ grower


def _leaf_truth(tree, rows, g, h, mask, l1, l2):
    """f64 leaf values recomputed from the rows each leaf holds."""
    out = {}
    for leaf in np.nonzero(tree.feature < 0)[0]:
        sel = (rows == leaf) & mask
        G, H = g[sel].astype(np.float64).sum(), h[sel].astype(np.float64).sum()
        out[leaf] = -np.sign(G) * max(abs(G) - l1, 0.0) / (H + l2)
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_grow_tree_sparse_matches_reference(fused):
    _, rds, pds = _datasets(2500, 1 << 10, 20, seed=11)
    rdev = ref_sparse._device_arrays(rds)
    pdev = sparse.device_arrays(pds, "cpu")
    rng = np.random.default_rng(12)
    n = pds.num_rows
    g = rng.standard_normal(n).astype(np.float32)
    h = (rng.random(n) + 0.1).astype(np.float32)
    mask = rng.random(n) < 0.8
    bm = np.repeat(rng.random(pds.num_features) < 0.7, np.diff(pds.feat_offset))
    # the reference's host loop compiles every split: fewer leaves there
    kw = dict(num_leaves=15 if fused else 6, min_data_in_leaf=20,
              lambda_l1=0.05, lambda_l2=1.0)
    rt, rrows = ref_sparse.grow_tree_sparse(
        rds, rdev, jnp.asarray(g), jnp.asarray(h), RefGrowerConfig(**kw),
        row_mask=jnp.asarray(mask), bin_mask=jnp.asarray(bm), use_fused=fused)
    pt, prows = sparse.grow_tree_sparse(
        pds, pdev, torch.from_numpy(g), torch.from_numpy(h), GrowerConfig(**kw),
        row_mask=torch.from_numpy(mask), bin_mask=torch.from_numpy(bm),
        use_fused=fused)
    assert pt.num_leaves == kw["num_leaves"]
    _assert_same_tree(rt, pt)
    np.testing.assert_allclose(pt.gain, rt.gain, rtol=HIST_CSR_TOL)
    np.testing.assert_array_equal(np.asarray(rrows), prows.numpy())
    for leaf, v in _leaf_truth(pt, prows.numpy(), g, h, mask, 0.05, 1.0).items():
        np.testing.assert_allclose(pt.value[leaf], v, rtol=1e-5, atol=1e-9)


def test_route_rows_matches_reference():
    _, rds, pds = _datasets(700, 1 << 8, 12, seed=13)
    rdev = ref_sparse._device_arrays(rds)
    pdev = sparse.device_arrays(pds, "cpu")
    rng = np.random.default_rng(14)
    node = rng.integers(0, 3, pds.num_rows).astype(np.int32)
    for f in (0, 3, 40, 200):
        nb = int(pds.feat_offset[f + 1] - pds.feat_offset[f])
        for t in sorted({0, nb // 2, max(nb - 2, 0)}):
            r = ref_sparse._route_rows(rdev, jnp.asarray(node), np.int32(1),
                                       np.int32(f), np.int32(t), np.int32(5),
                                       np.int32(6))
            b = int(pds.feat_offset[f]) + t
            p = sparse._route_rows(pdev, torch.from_numpy(node), 1, f, b, 5, 6,
                                   bool(pds.zero_local[f] <= t))
            np.testing.assert_array_equal(np.asarray(r), p.numpy())


def test_state_gate_raises_for_the_unported_host_loop(monkeypatch):
    """Above the grower-state gate (``MMLSPARK_TPU_FUSED_TREE_BYTES``) the
    tree grows on the per-split host loop, on any device, as in the
    reference: it no longer raises, and its tree and routing are the
    reference's (the gate's tolerances, ``_assert_same_tree``)."""
    _, rds, pds = _datasets(300, 1 << 7, 8, seed=15)
    rdev = ref_sparse._device_arrays(rds)
    pdev = sparse.device_arrays(pds, "cpu")
    monkeypatch.setenv("MMLSPARK_TPU_FUSED_TREE_BYTES", "1024")
    g = np.random.default_rng(15).standard_normal(pds.num_rows).astype(np.float32)
    h = np.ones(pds.num_rows, np.float32)
    kw = dict(num_leaves=5, min_data_in_leaf=10)
    assert not sparse._fused_sparse_enabled(9, pds.total_bins)
    before = sparse.host_reads
    pt, prows = sparse.grow_tree_sparse(pds, pdev, torch.from_numpy(g),
                                        torch.from_numpy(h), GrowerConfig(**kw),
                                        use_fused=None)
    # the root's totals and its evaluation, then one a child evaluated
    assert 2 < sparse.host_reads - before <= 2 + 2 * (pt.num_leaves - 1)
    rt, rrows = ref_sparse.grow_tree_sparse(rds, rdev, jnp.asarray(g),
                                            jnp.asarray(h), RefGrowerConfig(**kw))
    _assert_same_tree(rt, pt)
    np.testing.assert_array_equal(np.asarray(rrows), prows.numpy())


def test_per_split_loop_matches_reference_on_a_gain_tie():
    """The per-split host loop against the reference's
    (``grow_tree_sparse(use_fused=False)``) where the root's two children
    tie on gain exactly: mirrored gradients in two halves, the right half
    smaller by count (a left run of zero-hessian rows), so the loop pushes
    the right child first and pops it first (push order), where the fused
    grower's ``argmax`` takes the lower node id. Trees and routing equal
    the reference's loop (``_assert_same_tree``); the fused tree is the
    other one."""
    m, z = 50, 20
    cols, g = [], []
    for part, grad in (("P", 6.0), ("Q", 4.0), ("Z", 0.0), ("P'", -6.0),
                       ("Q'", -4.0)):
        count = z if part == "Z" else m
        feats = {"P": [1], "Q": [], "Z": [], "P'": [0, 2], "Q'": [0]}[part]
        cols += [feats] * count
        g += [grad] * count
    n = len(cols)
    h = np.array([0.0 if v == 0.0 else 1.0 for v in g], np.float32)
    g = np.asarray(g, np.float32)
    indptr = np.cumsum([0] + [len(c) for c in cols])
    idx = np.concatenate([np.asarray(c, np.int64) for c in cols])
    vals = np.ones(len(idx))
    rds = ref_sparse.SparseDataset.from_csr(indptr, idx, vals, 3)
    pds = convert.sparse_dataset_from_reference(rds)
    kw = dict(num_leaves=3, min_data_in_leaf=5, lambda_l2=0.0)
    rt, rrows = ref_sparse.grow_tree_sparse(
        rds, ref_sparse._device_arrays(rds), jnp.asarray(g), jnp.asarray(h),
        RefGrowerConfig(**kw), use_fused=False)
    pdev = sparse.device_arrays(pds, "cpu")
    args = (pds, pdev, torch.from_numpy(g), torch.from_numpy(h),
            GrowerConfig(**kw))
    pt, prows = sparse.grow_tree_sparse(*args, use_fused=False)
    _assert_same_tree(rt, pt)
    np.testing.assert_array_equal(np.asarray(rrows), prows.numpy())
    assert rt.feature[0] == 0 and rt.feature[2] == 2     # the right child
    ft, _ = sparse.grow_tree_sparse(*args, use_fused=True)
    assert ft.feature[1] == 1 and ft.feature[2] == -1    # the left child
    assert n == 4 * m + z


@pytest.mark.parametrize("case", ["ties", "exclude", "all_equal", "seed_0",
                                  "seed_1", "seed_2"])
def test_exact_topk_mask_matches_reference(case):
    """``_exact_topk_mask`` bit for bit the reference's: heavily tied keys
    (multiples of 1/8), an excluded half, all-equal keys (the tie the
    reference's >=-threshold mask failed on), and seeded random keys with
    and without an exclusion mask, at every k from 0 past n."""
    rng = np.random.default_rng(
        {"ties": 3, "exclude": 5, "all_equal": 7}.get(case)
        if not case.startswith("seed") else 100 + int(case[-1]))
    n = {"ties": 257, "exclude": 128, "all_equal": 50}.get(case, 4099)
    key = rng.random(n).astype(np.float32)
    if case == "ties":
        key = (np.round(key * 8) / 8).astype(np.float32)
    elif case == "all_equal":
        key[:] = 0.25
    elif case.startswith("seed"):
        key = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 3)).astype(
            np.float32)                     # signed: the |key| is ranked
    excl = [None]
    if case == "exclude":
        excl = [np.arange(n) % 2 == 0]
    elif case.startswith("seed"):
        excl = [None, rng.random(n) < 0.3]
    for ex in excl:
        for k in (0, 1, 7, 63, n // 3, n - 1, n, n + 5):
            r = np.asarray(ref_sparse._exact_topk_mask(
                jnp.asarray(key), k, n,
                exclude=None if ex is None else jnp.asarray(ex)))
            p = sparse._exact_topk_mask(
                torch.from_numpy(key), k, n,
                exclude=None if ex is None else torch.from_numpy(ex))
            np.testing.assert_array_equal(r, p.numpy(), err_msg=f"k={k}")


def test_assign_leaves_all_rows_matches_eager_routing():
    """The lazy-routing traversal lands every row on the node per-split
    routing put it in, for a grown tree (the reference's own check), at a
    depth bound and at ``num_leaves - 1`` levels."""
    X, y = synth_sparse(500, 12, density=0.35, seed=33)
    indptr, idx, vals = dense_to_csr(X)
    pds = sparse.SparseDataset.from_csr(indptr, idx, vals, X.shape[1])
    dev = sparse.device_arrays(pds, "cpu")
    from mmlspark_tpu_torch.gbdt.booster import grad_hess

    n = pds.num_rows
    g, h = grad_hess("binary", torch.zeros(n), torch.as_tensor(y).float())
    mask = torch.ones(n, dtype=torch.bool)
    for kw in (dict(num_leaves=7, min_data_in_leaf=5),
               dict(num_leaves=15, min_data_in_leaf=5, max_depth=3)):
        cfg = GrowerConfig(**kw)
        out = sparse._grow_tree_sparse_body(
            dev, g, h, mask, None, sparse._masked_totals(g, h, mask), cfg)
        steps = cfg.max_depth if cfg.max_depth > 0 else cfg.num_leaves - 1
        lazy = sparse._assign_leaves_all_rows(dev, out, steps)
        np.testing.assert_array_equal(lazy.numpy(),
                                      out["node_of_row"].numpy())
        assert int(out["n_nodes"]) > 3


@pytest.mark.parametrize("width", [0, 1, "w - 1", "w"])
def test_sparse_hist_reads_only_the_device_held_length(k4_tiles, width):
    """K4's compacted-stream contract, emulated (``partitioned_histogram``)
    and in the plain version: stats wider than the valid length
    ``bin_end[-1]``, the entries past it NaN; neither reads them, both give
    the histogram of the valid prefix, and the emulation splits the valid
    path over the grid sized for the width."""
    w = 5000
    ids, bin_end, data = _hist_case(w, 700, seed=41, empty_every=4)
    valid = {"w - 1": w - 1, "w": w}.get(width, width)
    bin_end = np.minimum(bin_end, valid).astype(np.int32)
    junk = data.copy()
    junk[:, valid:] = np.nan
    plain = sparse_hist_kernel.sparse_histogram_plain(
        torch.from_numpy(junk), torch.from_numpy(bin_end)).numpy()
    exact = np.stack([np.bincount(ids[:valid], minlength=700,
                                  weights=data[c, :valid].astype(np.float64))
                      for c in range(3)]).astype(np.float32)
    np.testing.assert_array_equal(plain, exact)
    got, carries = sparse_hist_kernel.partitioned_histogram(junk, bin_end)
    blocks, _ = sparse_hist_kernel.shares(w, 700)
    assert len(carries) == blocks
    np.testing.assert_array_equal(got[2], exact[2])
    tol = 1e-5 * _abs_bin_sums(ids[:valid], data[0, :valid], 700) + 1e-6
    assert (np.abs(got[0] - exact[0]) <= tol).all()


_SCAN_CASES = {
    "gbdt": ({}, {}),
    "goss_compacted": (dict(boosting_type="goss", top_rate=0.3,
                            other_rate=0.2),
                       {"MMLSPARK_TPU_SPARSE_COMPACT": "1",
                        "MMLSPARK_TPU_NO_SPARSE_LAZY_ROUTE": "1"}),
    "goss_lazy": (dict(boosting_type="goss", top_rate=0.3, other_rate=0.2,
                       max_depth=4),
                  {"MMLSPARK_TPU_SPARSE_COMPACT": "1"}),
    "bagging_compacted": (dict(bagging_fraction=0.6, bagging_freq=1,
                               feature_fraction=0.7),
                          {"MMLSPARK_TPU_SPARSE_COMPACT": "1"}),
    "multiclass": (dict(objective="multiclass", num_class=3), {}),
    "rf": (dict(boosting_type="rf", bagging_fraction=0.7, bagging_freq=1),
           {}),
}


@pytest.mark.parametrize("case", list(_SCAN_CASES))
def test_forced_sparse_scan_matches_reference_scan(monkeypatch, case):
    """``MMLSPARK_TPU_SCAN_TRAIN=1`` on both packages: the whole-run sparse
    scan on the CPU (GOSS selected by exact top-k over the Threefry draws;
    the stream compacted to the selected rows' entries where forced, with
    lazy routing unless ``MMLSPARK_TPU_NO_SPARSE_LAZY_ROUTE``), 4
    iterations. Gates: ``_assert_same_forest`` (structure identical, leaf
    values within hist.csr's 2e-3), raw scores within 1e-3, and the
    compaction the case asks for taken."""
    extra, env = _SCAN_CASES[case]
    monkeypatch.setenv("MMLSPARK_TPU_SCAN_TRAIN", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    (indptr, idx, vals, y), rds, pds = _datasets(2000, 1 << 10, 20, seed=1)
    if "num_class" in extra:
        y = (y + (np.random.default_rng(16).random(len(y)) < 0.3)).astype(float)
    kw = dict(dict(objective="binary", num_iterations=4, num_leaves=15,
                   min_data_in_leaf=20, learning_rate=0.2), **extra)
    k = kw.get("num_class", 1)
    rb = ref_sparse.train_sparse(RefTrainParams(**kw), rds, y)
    pb = sparse.train_sparse(TrainParams(**kw), pds, y, device="cpu")
    assert pb.route == "scan"
    _assert_same_forest(rb, pb)
    stats = sparse.last_scan_stats
    assert bool(stats["compact_cap"]) == bool(env)
    assert stats["lazy"] == (bool(env) and "NO_SPARSE_LAZY" not in str(env))
    if "goss" in case:
        assert (stats["rows"] == 600 + 400).all()
    rp = sparse.predict_csr(pb.trees, indptr, idx, vals, k, device="cpu")
    rr = ref_sparse.predict_csr(rb.trees, indptr, idx, vals, k)
    np.testing.assert_allclose(rp, rr, rtol=0, atol=1e-3)


_SPARSE_ROUTE_ENVS = [
    {}, {"MMLSPARK_TPU_SCAN_TRAIN": "1"}, {"MMLSPARK_TPU_NO_SCAN_TRAIN": "1"},
    {"MMLSPARK_TPU_SCAN_TRAIN": "1", "MMLSPARK_TPU_SPARSE_COMPACT": "1"},
    {"MMLSPARK_TPU_SPARSE_COMPACT": "1",
     "MMLSPARK_TPU_NO_SPARSE_LAZY_ROUTE": "1"},
    {"MMLSPARK_TPU_NO_SPARSE_COMPACT": "1",
     "MMLSPARK_TPU_SPARSE_COMPACT": "1"},
    {"MMLSPARK_TPU_FUSED_TREE_BYTES": "4096"},
    {"MMLSPARK_TPU_NO_FUSED_TREE": "1"},
]


@pytest.mark.parametrize("env", range(len(_SPARSE_ROUTE_ENVS)))
def test_sparse_route_decisions_match_the_reference(monkeypatch, env):
    """``_scan_sparse_ok``, ``_sparse_compact_cap`` (forced on the CPU, with
    a depth and without; goss and bagging masks) and
    ``_fused_sparse_enabled`` decide as the reference's do on the CPU for
    the same parameters and environment, and ``grow_tree_sparse``'s
    default takes the reference's grower there (the per-split loop, read
    through its host reads)."""
    for name, value in _SPARSE_ROUTE_ENVS[env].items():
        monkeypatch.setenv(name, value)
    _, rds, pds = _datasets(300, 1 << 7, 8, seed=23)
    masks = np.random.default_rng(4).random((3, 300)) < 0.5
    for kw in (dict(), dict(boosting_type="dart"), dict(objective="lambdarank"),
               dict(num_leaves=1), dict(boosting_type="goss", max_depth=3),
               dict(boosting_type="goss", top_rate=0.05, other_rate=0.05,
                    max_depth=2, num_leaves=63),
               dict(bagging_fraction=0.5, bagging_freq=1),
               dict(train_metric=True)):
        rp, pp = RefTrainParams(**kw), TrainParams(**kw)
        for valid, log in ((None, None), ((1, 2), None), (None, print)):
            assert sparse._scan_sparse_ok(pp, valid, log, "cpu") == \
                ref_sparse._scan_sparse_ok(rp, valid, log), kw
        for rm in (None, masks):
            assert sparse._sparse_compact_cap(pp, pds, rm, "cpu") == \
                ref_sparse._sparse_compact_cap(rp, rds, rm), (kw, rm is None)
    for shape in ((61, 1310720), (253, 1310720), (3, 700), (9, 100)):
        assert sparse._fused_sparse_enabled(*shape) == \
            ref_sparse._fused_sparse_enabled(*shape), shape
    before = sparse.host_reads
    g = torch.ones(pds.num_rows)
    sparse.grow_tree_sparse(pds, sparse.device_arrays(pds, "cpu"), g, g,
                            GrowerConfig(num_leaves=4))
    assert sparse.host_reads - before >= 2        # the per-split loop's


# ---------------------------------------------------------------- training


_TRAIN = {
    "binary": dict(objective="binary"),
    "multiclass": dict(objective="multiclass", num_class=3),
    "regression": dict(objective="regression", lambda_l2=0.5),
    "bagging_ff": dict(objective="binary", bagging_fraction=0.7, bagging_freq=1,
                       feature_fraction=0.6),
    "pos_neg_bagging": dict(objective="binary", pos_bagging_fraction=0.8,
                            neg_bagging_fraction=0.5, bagging_freq=2, seed=7),
}


@pytest.mark.parametrize("case", list(_TRAIN))
def test_train_sparse_matches_reference(case):
    (_, _, _, y), rds, pds = _datasets(2000, 1 << 10, 20, seed=1)
    rng = np.random.default_rng(16)
    kw = dict(num_iterations=4, num_leaves=15, min_data_in_leaf=20,
              learning_rate=0.2, **_TRAIN[case])
    if case == "multiclass":
        y = (y + (rng.random(len(y)) < 0.3)).astype(np.float64)
    elif case == "regression":
        y = 2.0 * y + rng.standard_normal(len(y))
    rb = ref_sparse.train_sparse(RefTrainParams(**kw), rds, y)
    pb = sparse.train_sparse(TrainParams(**kw), pds, y, device="cpu")
    _assert_same_forest(rb, pb)
    np.testing.assert_allclose(pb.base_score, rb.base_score, rtol=0, atol=0)


def test_train_sparse_weights_and_init_scores_match():
    (_, _, _, y), rds, pds = _datasets(1500, 1 << 9, 18, seed=17)
    rng = np.random.default_rng(18)
    w = rng.random(len(y)) + 0.5
    init = rng.standard_normal(len(y)) * 0.3
    kw = dict(objective="binary", num_iterations=3, num_leaves=7,
              min_data_in_leaf=20)
    rb = ref_sparse.train_sparse(RefTrainParams(**kw), rds, y, weights=w,
                                 init_scores=init)
    pb = sparse.train_sparse(TrainParams(**kw), pds, y, weights=w,
                             init_scores=init, device="cpu")
    _assert_same_forest(rb, pb)


def test_train_sparse_records_each_iteration():
    from mmlspark_tpu_torch.obs import metrics

    _, _, pds = _datasets(300, 1 << 7, 8, seed=25)
    prev = metrics.set_default_registry(metrics.MetricsRegistry())
    try:
        sparse.train_sparse(TrainParams(objective="binary", num_iterations=3,
                                        num_leaves=4), pds,
                            (np.arange(300) % 2).astype(float), device="cpu")
        steps = metrics.default_registry().histogram(
            "mmlspark_train_step_seconds", labelnames=("engine",))
        got = steps.labels(engine="gbdt_sparse").value
    finally:
        metrics.set_default_registry(prev)
    assert got["count"] == 3 and got["sum"] > 0


@pytest.fixture
def numpy_csr_predict(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_NO_NATIVE_CSR_PREDICT", "1")


# the rest of the sparse training surface, each against the reference's
# host loop: GOSS, DART (drops re-scored through predict_csr), rf, lambdarank
# over contiguous query groups, a CSR validation set with early stopping,
# and continuing an in-memory init_model.
#
# GOSS is held for one iteration, from the base score (every |g| of a class
# ties: numpy's argsort breaks the ties) and from seeded per-row scores
# (distinct |g|). A second iteration ranks rows by gradients of the first
# tree's leaf values, which the reference sums as f32 prefix differences
# (within hist.csr's 2e-3 of exact, section C of ROADMAP.md): a 1e-4
# difference between two leaves' |g| reorders the rows GOSS ranks and
# samples, so the fits part there. The dense GOSS fits of
# test_torch_gbdt.py, whose sums agree to f32 ulps, run 10 iterations.
_VARIANTS = {
    "goss": dict(objective="binary", boosting_type="goss", top_rate=0.3,
                 other_rate=0.2, num_iterations=1),
    "goss_scores": dict(objective="binary", boosting_type="goss",
                        top_rate=0.3, other_rate=0.2, num_iterations=1),
    "dart": dict(objective="binary", boosting_type="dart", drop_rate=0.3),
    "rf": dict(objective="binary", boosting_type="rf", bagging_fraction=0.8,
               bagging_freq=1),
    "lambdarank": dict(objective="lambdarank"),
    "validation": dict(objective="binary", learning_rate=0.3,
                       early_stopping_round=2, num_iterations=8),
    "init_model": dict(objective="binary"),
}


@pytest.mark.parametrize("case", list(_VARIANTS))
def test_train_sparse_variants_match_reference(numpy_csr_predict, case):
    (_, _, _, y), rds, pds = _datasets(2000, 1 << 10, 20, seed=1)
    kw = dict(dict(num_iterations=4, num_leaves=15, min_data_in_leaf=20,
                   learning_rate=0.2), **_VARIANTS[case])
    extra = {}
    if case == "lambdarank":
        rng = np.random.default_rng(26)
        y = np.minimum(y * rng.integers(1, 5, len(y)), 4.0)
        extra["groups"] = np.repeat(np.arange(100), 20)
    elif case == "goss_scores":
        extra["init_scores"] = np.random.default_rng(27).standard_normal(len(y))
    elif case == "validation":
        # a holdout with 30% of its labels flipped: it stops improving early
        (v_ptr, v_idx, v_val, v_y), _, _ = _datasets(600, 1 << 10, 20, seed=2)
        flip = np.random.default_rng(27).random(len(v_y)) < 0.3
        extra.update(valid=((v_ptr, v_idx, v_val),
                            np.where(flip, 1.0 - v_y, v_y)))
    rb_init = pb_init = None
    if case == "init_model":
        rb_init = ref_sparse.train_sparse(RefTrainParams(**kw), rds, y)
        pb_init = sparse.train_sparse(TrainParams(**kw), pds, y, device="cpu")
        _assert_same_forest(rb_init, pb_init)
    rb = ref_sparse.train_sparse(RefTrainParams(**kw), rds, y,
                                 init_model=rb_init, **extra)
    pb = sparse.train_sparse(TrainParams(**kw), pds, y, init_model=pb_init,
                             device="cpu", **extra)
    _assert_same_forest(rb, pb)
    assert pb.best_iteration == rb.best_iteration
    if case == "validation":
        assert 0 < pb.best_iteration < len(pb.trees) < 8
    if case == "init_model":
        assert len(pb.trees) == 8
    assert all(t.num_leaves > 1 for g in pb.trees for t in g)
    np.testing.assert_allclose([t.shrinkage for g in pb.trees for t in g],
                               [t.shrinkage for g in rb.trees for t in g],
                               rtol=1e-12)


@pytest.mark.parametrize("case", ["mesh", "categorical", "state_gate"])
def test_train_sparse_later_slices_raise(monkeypatch, case):
    """What the sparse fit refuses: a ``mesh=`` that is not the port's
    ``Mesh`` (TypeError), and categorical features, which are not a later
    slice: the reference refuses them on sparse rows too (set splits need
    the dense bin space), and the port keeps its error. A mesh with an
    fsdp axis no longer raises (ROADMAP A9k): on a data axis of 1 the fit
    holds every row and is the one-process fit byte for byte. Above the
    grower-state gate the fit no longer raises: it takes the per-split host
    loop (route ``host``), the reference's trees."""
    from mmlspark_tpu_torch.parallel.mesh import Mesh

    (_, _, _, y), rds, pds = _datasets(200, 1 << 6, 5, seed=19)
    kw, err = {}, NotImplementedError
    if case == "mesh":
        with pytest.raises(TypeError, match="Mesh"):
            sparse.train_sparse(TrainParams(), pds, y, device="cpu",
                                mesh=object())
        p = TrainParams(boosting_type="goss", num_iterations=2,
                        num_leaves=4, min_data_in_leaf=10)
        want = sparse.train_sparse(p, pds, y, device="cpu")
        got = sparse.train_sparse(p, pds, y, device="cpu",
                                  mesh=Mesh(shape={"data": 1, "fsdp": 2}))
        assert got.route == want.route == "fused"
        assert got.to_string() == want.to_string()
        return
    elif case == "state_gate":
        monkeypatch.setenv("MMLSPARK_TPU_FUSED_TREE_BYTES", "1024")
        p = dict(num_iterations=2, num_leaves=4, min_data_in_leaf=10)
        pb = sparse.train_sparse(TrainParams(**p), pds, y, device="cpu")
        assert pb.route == "host"
        _assert_same_forest(ref_sparse.train_sparse(RefTrainParams(**p), rds, y),
                            pb)
        return
    params = TrainParams(boosting_type="goss", categorical_feature=(
        (0,) if case == "categorical" else ()))
    if case == "categorical":
        err = ValueError
    with pytest.raises(err):
        sparse.train_sparse(params, pds, np.zeros(200), device="cpu", **kw)


# -------------------------------------------------------------- prediction


@pytest.mark.parametrize("num_class", [1, 3])
def test_predict_csr_matches_reference(numpy_csr_predict, num_class):
    (indptr, idx, vals, y), rds, _ = _datasets(1200, 1 << 9, 15, seed=20)
    obj = "binary" if num_class == 1 else "multiclass"
    if num_class == 3:
        y = (y + (np.random.default_rng(0).random(len(y)) < 0.4)).astype(float)
    rb = ref_sparse.train_sparse(RefTrainParams(
        objective=obj, num_class=num_class, num_iterations=4, num_leaves=9), rds, y)
    pb = convert.booster_from_reference(rb.to_string())
    # score other rows, with an out-of-range feature id and an empty row
    (q_ptr, q_idx, q_val, _), _, _ = _datasets(300, 1 << 10, 15, seed=21)
    q_ptr = np.concatenate([q_ptr, [q_ptr[-1]]])
    for csr in ((indptr, idx, vals), (q_ptr, q_idx, q_val)):
        ref = ref_sparse.predict_csr(rb.trees, *csr, num_class)
        got = sparse.predict_csr(pb.trees, *csr, num_class, device="cpu")
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="categorical"):
        t = pb.trees[0][0]
        cat = dataclasses.replace(t, cat_sets=[None] * len(t.feature))
        sparse.predict_csr([[cat]], indptr, idx, vals, 1, device="cpu")


@pytest.mark.parametrize("num_class", [1, 3])
def test_native_csr_predict_equals_the_tensor_traversal(num_class,
                                                       monkeypatch):
    """On the CPU ``predict_csr`` takes the native C++ traversal
    (``native_loader.csr_forest_predict``, counted), bit for bit the
    tensor traversal it keeps for the card and under
    ``MMLSPARK_TPU_NO_NATIVE_CSR_PREDICT=1``, and the reference's native
    route."""
    from mmlspark_tpu_torch import native_loader

    (indptr, idx, vals, y), rds, _ = _datasets(1200, 1 << 9, 15, seed=23)
    obj = "binary" if num_class == 1 else "multiclass"
    if num_class == 3:
        y = (y + (np.random.default_rng(1).random(len(y)) < 0.4)).astype(float)
    rb = ref_sparse.train_sparse(RefTrainParams(
        objective=obj, num_class=num_class, num_iterations=4, num_leaves=9),
        rds, y)
    pb = convert.booster_from_reference(rb.to_string())
    (q_ptr, q_idx, q_val, _), _, _ = _datasets(300, 1 << 10, 15, seed=24)
    q_ptr = np.concatenate([q_ptr, [q_ptr[-1]]])
    for csr in ((indptr, idx, vals), (q_ptr, q_idx, q_val)):
        before = native_loader.uses[("csr_forest_predict", "native")]
        native = sparse.predict_csr(pb.trees, *csr, num_class, device="cpu")
        assert native_loader.uses[("csr_forest_predict", "native")] == \
            before + 1
        np.testing.assert_array_equal(
            native, ref_sparse.predict_csr(rb.trees, *csr, num_class))
        np.testing.assert_array_equal(native, sparse.CsrRows(
            *csr, device="cpu").predict(pb.trees, num_class))
        with monkeypatch.context() as m:
            m.setenv("MMLSPARK_TPU_NO_NATIVE_CSR_PREDICT", "1")
            np.testing.assert_array_equal(native, sparse.predict_csr(
                pb.trees, *csr, num_class, device="cpu"))


# ------------------------------------------------------------------ stages


def _sparse_frames(X, y, width):
    rows = sparse_rows(X, size=width)
    return (RefDataFrame.from_dict({"features": rows, "label": y}, num_partitions=2),
            DataFrame.from_dict({"features": rows, "label": y}, num_partitions=2))


@pytest.mark.parametrize("estimator", ["LightGBMClassifier", "LightGBMRegressor"])
def test_stage_fit_transform_on_sparse_rows(numpy_csr_predict, estimator):
    rng = np.random.default_rng(22)
    X = rng.integers(1, 5, (800, 40)) * (rng.random((800, 40)) < 0.25)
    X = X.astype(np.float64)
    y = ((X[:, 0] - X[:, 1] + X[:, 2] + rng.normal(0, 0.5, 800)) > 0.5)
    y = y.astype(np.float64) if estimator == "LightGBMClassifier" \
        else X[:, 0] * 2.0 - X[:, 3] + rng.normal(0, 0.1, 800)
    rdf, pdf = _sparse_frames(X, y, 48)
    params = dict(numIterations=5, numLeaves=9, minDataInLeaf=10, maxBin=300)
    rmodel = getattr(ref_stages, estimator)(**params).fit(rdf)
    with use_device("cpu"):
        pmodel = getattr(stages, estimator)(**params).fit(pdf)
        pout = pmodel.transform(pdf)
    _assert_same_forest(rmodel.booster, pmodel.booster)
    rout = rmodel.transform(rdf)
    col = "rawPrediction" if estimator == "LightGBMClassifier" else "prediction"
    np.testing.assert_allclose(np.stack(list(pout.column(col))),
                               np.stack(list(rout.column(col))),
                               rtol=HIST_CSR_TOL, atol=HIST_CSR_TOL)
    # scoring the carried-across reference model is exact
    carried = type(pmodel)(booster=convert.booster_from_reference(
        rmodel.booster.to_string()), featuresCol="features")
    with use_device("cpu"):
        c_out = carried.transform(pdf)
    np.testing.assert_allclose(np.stack(list(c_out.column(col))),
                               np.stack(list(rout.column(col))), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("case", ["validation", "num_batches"])
def test_stage_sparse_validation_and_batches_match(numpy_csr_predict, case):
    rng = np.random.default_rng(28)
    X = rng.integers(1, 5, (900, 40)) * (rng.random((900, 40)) < 0.25)
    X = X.astype(np.float64)
    y = ((X[:, 0] - X[:, 1] + X[:, 2] + rng.normal(0, 1.0, 900)) > 0.5)
    y = y.astype(np.float64)
    rows = sparse_rows(X, size=48)
    d = {"features": rows, "label": y, "isVal": np.arange(900) % 4 == 0}
    rdf = RefDataFrame.from_dict(d, num_partitions=2)
    pdf = DataFrame.from_dict(d, num_partitions=2)
    params = dict(numIterations=6, numLeaves=9, minDataInLeaf=10,
                  learningRate=0.3)
    if case == "validation":
        params.update(validationIndicatorCol="isVal", earlyStoppingRound=2,
                      numIterations=20)
    else:
        params.update(numBatches=2)
    rmodel = ref_stages.LightGBMClassifier(**params).fit(rdf)
    with use_device("cpu"):
        pmodel = stages.LightGBMClassifier(**params).fit(pdf)
    _assert_same_forest(rmodel.booster, pmodel.booster)
    assert pmodel.booster.best_iteration == rmodel.booster.best_iteration
    if case == "validation":
        assert 0 < pmodel.booster.best_iteration < len(pmodel.booster.trees)
    else:
        assert len(pmodel.booster.trees) == 12


@pytest.mark.parametrize("param", ["categoricalSlotIndexes",
                                   "categoricalSlotNames"])
def test_stage_categorical_slots_raise_the_reference_error(numpy_csr_predict,
                                                           param):
    """Sparse rows refuse categorical slots with the reference's message;
    ``modelString`` continues a sparse fit as the reference's does, and a
    categorical model refuses sparse rows in the fused pipeline as it does
    unfused."""
    X, y = synth_sparse(200, 10, seed=23)
    rdf, pdf = _sparse_frames(X, y, 10)
    value = [1] if param == "categoricalSlotIndexes" else ["f1"]
    with pytest.raises(ValueError) as ref_err:
        ref_stages.LightGBMClassifier(**{param: value}).fit(rdf)
    with use_device("cpu"), pytest.raises(ValueError) as port_err:
        stages.LightGBMClassifier(**{param: value}).fit(pdf)
    assert str(port_err.value) == str(ref_err.value)
    kw = dict(numIterations=2, numLeaves=4, minDataInLeaf=5)
    r0 = ref_stages.LightGBMClassifier(**kw).fit(rdf)
    rm = ref_stages.LightGBMClassifier(
        **kw, modelString=r0.get_model_string()).fit(rdf)
    with use_device("cpu"):
        p0 = stages.LightGBMClassifier(**kw).fit(pdf)
        pm = stages.LightGBMClassifier(
            **kw, modelString=p0.get_model_string()).fit(pdf)
        assert len(pm.booster.trees) == len(rm.booster.trees) == 4
        for gr, gp in zip(rm.booster.trees, pm.booster.trees):
            np.testing.assert_array_equal(gr[0].feature, gp[0].feature)
            np.testing.assert_array_equal(gr[0].threshold, gp[0].threshold)
        from mmlspark_tpu_torch.core.pipeline import PipelineModel

        rng = np.random.default_rng(2)
        Xc = np.column_stack([rng.integers(0, 5, 300), rng.standard_normal(300)])
        dense = DataFrame.from_dict({"features": [r for r in Xc],
                                     "label": (Xc[:, 0] % 2).astype(float)})
        cat = stages.LightGBMClassifier(
            **kw, categoricalSlotIndexes=[0]).fit(dense)
        fused = PipelineModel([cat]).fuse()
        fused.set_tuning(layout={"LightGBMClassificationModel": "csr"})
        for run in (cat.transform, fused.transform):
            with pytest.raises(ValueError, match="categorical"):
                run(pdf.select("features")).collect()


def test_sparse_fit_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    X, y = synth_sparse(100, 6, seed=24)
    _, pdf = _sparse_frames(X, y, 6)
    with pytest.raises(RuntimeError, match="CUDA"):
        stages.LightGBMClassifier(numIterations=2).fit(pdf)


# ---------------------------------------------------------------- VW
#
# The VW online learner: hashing, featurizer and interactions bit for bit;
# the port's C++ pass against the reference's (the same source) bit for
# bit; the plain scan against the reference's jax.lax.scan (the native
# route off) within rtol 1e-5 and atol 1e-5 of the weights' max |w| (the
# measured gap, squared loss with AdaGrad over 3 passes, is 4.9e-6 of it:
# a prediction summed in another order feeds the next step); the stages'
# rawPrediction within 1e-6.

VW_RTOL = 1e-5
VW_ATOL_OF_MAX = 1e-5


def _vw_mixed_frame(n=60, seed=0):
    rng = np.random.default_rng(seed)
    words = np.array(["alpha", "beta", "gamma", "délta", "", "eps silon"])
    data = {
        "num": [float(v) if i % 7 else 0.0
                for i, v in enumerate(rng.standard_normal(n))],
        "cnt": [int(v) for v in rng.integers(0, 5, n)],
        "flag": [bool(v) for v in rng.random(n) > 0.5],
        "word": [str(words[i % len(words)]) if i % 5 else None
                 for i in range(n)],
        "text": [" ".join(rng.choice(words[:4], 3)) for _ in range(n)],
        "tags": [list(rng.choice(words[:4], 2)) for _ in range(n)],
        "kv": [{"a": float(rng.standard_normal()), "b": 0.0, "c": "x"}
               for _ in range(n)],
        "vec": [rng.standard_normal(4) for _ in range(n)],
    }
    return data


def _ref_vw():
    import importlib

    return (importlib.import_module("mmlspark_tpu.vw"),
            importlib.import_module("mmlspark_tpu.vw.learner"),
            importlib.import_module("mmlspark_tpu.ops.hashing"))


def test_murmur_and_hash_strings_bit_for_bit():
    """murmur3_32, hash_string, the prefix hasher and hash_strings (native
    batch and the numpy path) give the reference's ints."""
    from mmlspark_tpu_torch import native_loader
    from mmlspark_tpu_torch.ops import hashing

    _, _, ref = _ref_vw()
    rng = np.random.default_rng(0)
    strs = ["", "a", "ab", "abc", "abcd", "hello world", "déjà vu", "日本語"] + \
        ["".join(map(chr, rng.integers(32, 1000, int(k))))
         for k in rng.integers(0, 40, 200)]
    for seed in (0, 1, 0xDEADBEEF, 123456789):
        want = [ref.hash_string(s, seed) for s in strs]
        assert [hashing.hash_string(s, seed) for s in strs] == want
        assert [hashing.murmur3_32(s.encode(), seed) for s in strs] == want
        assert hashing.hash_strings(strs, seed).tolist() == want
        assert native_loader.murmur3_batch(strs, seed).tolist() == want
        assert hashing.MurmurWithPrefix("ns_").hash("x", seed) == \
            ref.MurmurWithPrefix("ns_").hash("x", seed)


@pytest.mark.parametrize("opts", [{}, {"prefixStringsWithColumnName": False},
                                  {"stringSplit": True, "numBits": 12},
                                  {"stringSplitInputCols": ["text"],
                                   "sumCollisions": False, "numBits": 4}])
def test_vw_featurizer_bit_for_bit(opts):
    """Every featurizer type (numeric, bool, string, split text, string
    array, map, vector, nulls) gives the reference's indices and values."""
    from mmlspark_tpu_torch.vw import VowpalWabbitFeaturizer

    ref_vw, _, _ = _ref_vw()
    data = _vw_mixed_frame()
    cols = list(data)
    got = VowpalWabbitFeaturizer(inputCols=cols, outputCol="f", **opts) \
        .transform(DataFrame.from_dict(data, num_partitions=2)).column("f")
    want = ref_vw.VowpalWabbitFeaturizer(inputCols=cols, outputCol="f", **opts) \
        .transform(RefDataFrame.from_dict(data, num_partitions=2)).column("f")
    for a, b in zip(got, want):
        assert a["size"] == b["size"]
        np.testing.assert_array_equal(a["indices"], b["indices"])
        assert a["values"].dtype == b["values"].dtype == np.float32
        np.testing.assert_array_equal(a["values"].view(np.uint32),
                                      b["values"].view(np.uint32))


def test_vw_interactions_bit_for_bit():
    from mmlspark_tpu_torch.vw import (VowpalWabbitFeaturizer,
                                       VowpalWabbitInteractions)

    ref_vw, _, _ = _ref_vw()
    data = _vw_mixed_frame(40, seed=1)
    outs = []
    for pkg, frame in ((None, DataFrame), (ref_vw, RefDataFrame)):
        feat = (VowpalWabbitFeaturizer if pkg is None
                else pkg.VowpalWabbitFeaturizer)
        inter = (VowpalWabbitInteractions if pkg is None
                 else pkg.VowpalWabbitInteractions)
        df = frame.from_dict(data)
        df = feat(inputCols=["num", "word"], outputCol="a").transform(df)
        df = feat(inputCols=["tags", "kv"], outputCol="b").transform(df)
        df = inter(inputCols=["a", "b"], outputCol="ab", numBits=14).transform(df)
        outs.append(list(df.column("ab")))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a["indices"], b["indices"])
        np.testing.assert_array_equal(a["values"].view(np.uint32),
                                      b["values"].view(np.uint32))


def _vw_dataset(n=400, k=10, bits=10, seed=0, loss="logistic", dups=True):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << bits, (n, k)).astype(np.int32)
    if dups:
        idx[:, 3] = idx[:, 1]      # duplicate indices within an example
        idx[::3, 6] = idx[::3, 1]
    val = rng.standard_normal((n, k)).astype(np.float32)
    val[:, -2:] = 0               # padded slots
    raw = (val * rng.standard_normal(k)).sum(1)
    lab = (np.where(raw > 0, 1.0, -1.0) if loss != "quantile"
           else np.abs(raw)).astype(np.float32)
    wts = rng.uniform(0.5, 2.0, n).astype(np.float32)
    wts[7] = 0.0
    return idx, val, lab, wts


def test_vw_native_pass_bit_for_bit_the_reference_pass(monkeypatch):
    """The port's ``native_loader.vw_train_pass`` (its own build of the same
    C++ source) against the reference's: weights, g2, t and the loss sum
    bit for bit, for every loss, adaptive and plain SGD."""
    from mmlspark_tpu import native_loader as ref_nl
    from mmlspark_tpu_torch import native_loader

    if not (ref_nl.available() and native_loader.available()):
        pytest.skip("native toolchain unavailable")
    for loss in ("squared", "logistic", "hinge", "quantile"):
        for adaptive in (True, False):
            idx, val, lab, wts = _vw_dataset(loss=loss)
            outs = []
            for nl in (native_loader, ref_nl):
                w = np.zeros(1 << 10, np.float32)
                g2 = np.zeros(1 << 10, np.float32)
                t, ls = 0.0, []
                for _ in range(2):
                    t, s = nl.vw_train_pass(idx, val, lab, wts, w, g2, t,
                                            loss=loss, tau=0.3, lr=0.4,
                                            power_t=0.5 if adaptive else 0.4,
                                            initial_t=1.0, l2=1e-3,
                                            adaptive=adaptive)
                    ls.append(s)
                outs.append((w, g2, t, ls))
            (w1, g1, t1, l1), (w2, g2_, t2, l2) = outs
            assert np.array_equal(w1.view(np.uint32), w2.view(np.uint32))
            assert np.array_equal(g1.view(np.uint32), g2_.view(np.uint32))
            assert t1 == t2 and l1 == l2


@pytest.mark.parametrize("loss", ["squared", "logistic", "hinge", "quantile"])
@pytest.mark.parametrize("mode", ["adaptive", "sgd", "ftrl", "ftrl_l1",
                                  "adaptive_l2"])
def test_vw_plain_scan_matches_reference_scan(loss, mode, monkeypatch):
    """The plain scan (``scan_kernel.scan_pass_plain``, what ``vw_scan`` is
    held to on the card) against the reference's ``jax.lax.scan``
    (``MMLSPARK_TPU_NATIVE_VW=0``), 3 passes, duplicate indices within
    examples, padded slots, a zero-weight example: weights within rtol 1e-5
    and atol 1e-5 of max |w|; the last pass's average loss within 1e-5."""
    from mmlspark_tpu_torch.vw import learner

    _, ref_learner, _ = _ref_vw()
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_VW", "0")
    kw = {"adaptive": dict(adaptive=True), "sgd": dict(adaptive=False),
          "ftrl": dict(ftrl=True), "ftrl_l1": dict(ftrl=True, l1=0.01),
          "adaptive_l2": dict(adaptive=True, l2=0.01, power_t=0.4)}[mode]
    idx, val, lab, wts = _vw_dataset(loss=loss)
    common = dict(num_bits=10, loss_function=loss, num_passes=3,
                  quantile_tau=0.3, **kw)
    w_ref, s_ref = ref_learner.train_linear(
        ref_learner.LearnerConfig(**common),
        ref_learner.SparseDataset(idx, val, lab, wts))
    with use_device("cpu"):
        w, s = learner.train_linear(learner.LearnerConfig(**common),
                                    learner.SparseDataset(idx, val, lab, wts))
    np.testing.assert_allclose(
        w, w_ref, rtol=VW_RTOL,
        atol=VW_ATOL_OF_MAX * float(np.abs(w_ref).max()))
    assert len(s) == 3
    assert abs(s[-1].average_loss - s_ref[-1].average_loss) <= \
        1e-5 * max(1.0, abs(s_ref[-1].average_loss))


def test_vw_scan_route_serves_ftrl_and_out_of_range_indices(monkeypatch):
    """The routes as the reference decides them: FTRL and an index outside
    [0, 2^bits) take the scan (XLA's semantics: a negative index wraps, a
    gather clamps, a scatter past the end drops) even with the native
    route on, and both packages give the same weights."""
    from mmlspark_tpu_torch import native_loader
    from mmlspark_tpu_torch.vw import learner

    _, ref_learner, _ = _ref_vw()
    monkeypatch.delenv("MMLSPARK_TPU_NATIVE_VW", raising=False)
    idx, val, lab, wts = _vw_dataset(n=200)
    idx[5, 0] = -3
    idx[9, 2] = (1 << 10) + 5
    native_loader.uses.clear()
    for kw in ({}, {"ftrl": True}):
        cfg = dict(num_bits=10, loss_function="logistic", num_passes=2, **kw)
        w_ref, _ = ref_learner.train_linear(
            ref_learner.LearnerConfig(**cfg),
            ref_learner.SparseDataset(idx, val, lab, wts))
        with use_device("cpu"):
            w, _ = learner.train_linear(learner.LearnerConfig(**cfg),
                                        learner.SparseDataset(idx, val, lab, wts))
        np.testing.assert_allclose(w, w_ref, rtol=VW_RTOL,
                                   atol=VW_ATOL_OF_MAX * float(np.abs(w_ref).max()))
    assert ("vw_train_pass", "native") not in native_loader.uses


def test_vw_default_route_is_native_and_copies_initial_weights(monkeypatch):
    """Adaptive SGD on one shard takes the native pass (its weights bit for
    bit the reference's native route's), and the caller's
    ``initial_weights`` array is never trained in place."""
    from mmlspark_tpu_torch import native_loader
    from mmlspark_tpu_torch.vw import learner

    if not native_loader.available():
        pytest.skip("native toolchain unavailable")
    _, ref_learner, _ = _ref_vw()
    monkeypatch.delenv("MMLSPARK_TPU_NATIVE_VW", raising=False)
    idx, val, lab, wts = _vw_dataset(n=300)
    init = np.random.default_rng(1).standard_normal(1 << 10).astype(np.float32)
    keep = init.copy()
    native_loader.uses.clear()
    cfg = dict(num_bits=10, loss_function="hinge", num_passes=2)
    w, s = learner.train_linear(learner.LearnerConfig(**cfg),
                                learner.SparseDataset(idx, val, lab, wts),
                                initial_weights=init)
    w_ref, s_ref = ref_learner.train_linear(
        ref_learner.LearnerConfig(**cfg),
        ref_learner.SparseDataset(idx, val, lab, wts), initial_weights=init)
    assert native_loader.uses[("vw_train_pass", "native")] == 2
    np.testing.assert_array_equal(init, keep)
    np.testing.assert_array_equal(w.view(np.uint32), w_ref.view(np.uint32))
    assert [x.average_loss for x in s] == [x.average_loss for x in s_ref]


def test_vw_predict_and_linear_learner_match_reference():
    """``predict_linear`` (a gather-sum on the device) and the incremental
    ``LinearLearner`` (partial_fit over three slices, state_dict round
    trip continuing bit for bit) against the reference's."""
    from mmlspark_tpu_torch.vw import learner

    _, ref_learner, _ = _ref_vw()
    rng = np.random.default_rng(4)
    rows = [{"indices": np.sort(rng.choice(1 << 8, 5, replace=False)),
             "values": rng.standard_normal(5).astype(np.float32)}
            for _ in range(90)]
    y = np.where(rng.random(90) > 0.5, 1.0, -1.0)
    for kw in ({}, {"ftrl": True}):
        cfg = dict(num_bits=8, loss_function="logistic", **kw)
        ref = ref_learner.LinearLearner(ref_learner.LearnerConfig(**cfg))
        port = learner.LinearLearner(learner.LearnerConfig(**cfg), device="cpu")
        for i in range(0, 60, 20):
            a = port.partial_fit(rows[i:i + 20], y[i:i + 20])
            b = ref.partial_fit(rows[i:i + 20], y[i:i + 20])
            assert abs(a - b) <= 1e-5 * max(1.0, abs(b))
        np.testing.assert_allclose(port.weights, ref.weights, rtol=VW_RTOL,
                                   atol=VW_ATOL_OF_MAX
                                   * float(np.abs(ref.weights).max()))
        np.testing.assert_allclose(port.predict(rows), ref.predict(rows),
                                   rtol=1e-5, atol=1e-6)
        twin = learner.LinearLearner(learner.LearnerConfig(**cfg), device="cpu")
        twin.load_state_dict(port.state_dict())
        port.partial_fit(rows[60:], y[60:])
        twin.partial_fit(rows[60:], y[60:])
        assert np.array_equal(port.weights.view(np.uint32),
                              twin.weights.view(np.uint32))
        assert twin.examples_seen == port.examples_seen == 90


def _vw_stage_frame(frame, n=300, seed=5):
    rng = np.random.default_rng(seed)
    feats = [{"indices": np.sort(rng.choice(1 << 9, 6, replace=False)),
              "values": rng.standard_normal(6).astype(np.float32)}
             for _ in range(n)]
    extra = [{"indices": np.array([int(rng.integers(0, 1 << 9))]),
              "values": np.array([1.0], np.float32)} for _ in range(n)]
    y = (np.array([f["values"][:3].sum() for f in feats]) > 0).astype(float)
    return frame.from_dict({"features": feats, "extra": extra, "label": y,
                            "w": rng.uniform(0.5, 1.5, n)}, num_partitions=2)


@pytest.mark.parametrize("kind", ["classifier", "regressor_quantile",
                                  "classifier_ftrl"])
def test_vw_stages_fit_transform_save_load_match_reference(tmp_path, kind,
                                                           monkeypatch):
    """Fit -> transform through the stages (``additionalFeatures``, a weight
    column, ``passThroughArgs``, ``initialModel`` from a readable dump)
    against the reference's: rawPrediction within 1e-6; the port's save ->
    load -> transform bit for bit; performance statistics per pass."""
    from mmlspark_tpu_torch.core.pipeline import PipelineStage
    from mmlspark_tpu_torch.vw import (VowpalWabbitClassifier,
                                       VowpalWabbitRegressor,
                                       parse_readable_model)

    ref_vw, _, _ = _ref_vw()
    monkeypatch.delenv("MMLSPARK_TPU_NATIVE_VW", raising=False)
    opts = dict(featuresCol="features", labelCol="label", weightCol="w",
                numBits=9, numPasses=2, additionalFeatures=["extra"])
    if kind == "classifier":
        mk, ref_mk, out = VowpalWabbitClassifier, ref_vw.VowpalWabbitClassifier, \
            "rawPrediction"
        opts["passThroughArgs"] = "--l2 1e-4 -l 0.3"
    elif kind == "classifier_ftrl":
        mk, ref_mk, out = VowpalWabbitClassifier, ref_vw.VowpalWabbitClassifier, \
            "rawPrediction"
        opts["passThroughArgs"] = "--ftrl --ftrl_alpha 0.05"
    else:
        mk, ref_mk, out = VowpalWabbitRegressor, ref_vw.VowpalWabbitRegressor, \
            "prediction"
        opts["passThroughArgs"] = "--loss_function quantile --quantile_tau 0.3"
    df, ref_df = _vw_stage_frame(DataFrame), _vw_stage_frame(RefDataFrame)
    with use_device("cpu"):
        model = mk(**opts).fit(df)
        got = np.asarray(model.transform(df).column(out), np.float64)
    ref_model = ref_mk(**opts).fit(ref_df)
    want = np.asarray(ref_model.transform(ref_df).column(out), np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    stats = model.get_performance_statistics()
    assert stats.count() == 2
    assert list(stats.column("numExamples")) == [300, 300]
    text = model.get_readable_model()
    assert text.splitlines()[0] == "bits:9"
    assert parse_readable_model(text)[0] == 9
    with use_device("cpu"):
        warm = mk(**opts).set_initial_model_readable(text).fit(df)
        ref_warm = ref_mk(**opts).set_initial_model_readable(
            ref_model.get_readable_model()).fit(ref_df)
        np.testing.assert_allclose(
            np.asarray(warm.transform(df).column(out), np.float64),
            np.asarray(ref_warm.transform(ref_df).column(out), np.float64),
            rtol=0, atol=1e-5)
        model.save(str(tmp_path / "m"))
        loaded = PipelineStage.load(str(tmp_path / "m"))
        again = np.asarray(loaded.transform(df).column(out), np.float64)
    assert type(loaded) is type(model)
    np.testing.assert_array_equal(again, got)


def test_vw_mesh_requests_raise_naming_a9():
    """The VW fits on meshes with an axis other than ``data`` above 1
    (ROADMAP A9, raised before A9k): under a ``MeshContext`` whose data axis
    is 1 the stage fits one shard, the fit without a mesh; on data 2 x
    expert 2 a rank's block is its data coordinate's (each rank of a mesh
    described by hand, with no process group, fits its own block). A
    ``mesh=`` that is not the port's ``Mesh`` is a TypeError."""
    from mmlspark_tpu_torch.vw import (LearnerConfig, SparseDataset,
                                       VowpalWabbitClassifier, train_linear)

    from mmlspark_tpu_torch.parallel.mesh import Mesh, MeshContext

    df = _vw_stage_frame(DataFrame, n=20)
    with use_device("cpu"):
        want = VowpalWabbitClassifier(numWorkers=2).fit(df)
    MeshContext.set(Mesh(shape={"data": 1, "tensor": 2}))
    try:
        with use_device("cpu"):
            got = VowpalWabbitClassifier(numWorkers=2).fit(df)
    finally:
        MeshContext.reset()
    np.testing.assert_array_equal(np.asarray(got.get("weights")),
                                  np.asarray(want.get("weights")))
    ds = SparseDataset.from_rows(list(df.column("features")),
                                 np.ones(20), num_bits=9)
    cfg = LearnerConfig(num_bits=9)
    for r in range(4):
        w, _ = train_linear(cfg, ds, device="cpu",
                            mesh=Mesh(shape={"data": 2, "expert": 2}, rank=r))
        block, _ = train_linear(cfg, ds, device="cpu",
                                mesh=Mesh(shape={"data": 2}, rank=r // 2))
        np.testing.assert_array_equal(w, block)
    with pytest.raises(TypeError, match="Mesh"):
        train_linear(LearnerConfig(num_bits=9), ds, mesh=4)


# TextFeaturizer's 2^18-wide rows into the sparse fit (ROADMAP A 10.1):
# ``tests/test_gbdt_sparse.py:141``'s journey in both packages. The port's
# featurizer gives the reference's rows bit for bit, so the forests are
# held as every sparse stage fit here is, and the fused CSR transform (K3's
# plain version on the CPU, the forest summed in f32) within 1e-6 of the
# unfused one (``predict_csr`` in f64), the reference's CSR_VS_HOST_ATOL
# (``tests/test_sparse_e2e.py``). From the
# second tree on, this journey's leaves are nearly pure and every split
# left gains 4e-6 to 1.1e-5 (its f32 rounding in the reference, f64 in the
# port), so which one a package takes is rounding noise: minGainToSplit
# 1e-3 keeps such splits out of both fits.

def _review_frames(idf: bool, parts: int):
    from mmlspark_tpu.featurize import TextFeaturizer as RefTextFeaturizer
    from mmlspark_tpu_torch.featurize import TextFeaturizer

    rng = np.random.default_rng(0)
    pos_words = ["great", "excellent", "love", "wonderful"]
    neg_words = ["terrible", "awful", "hate", "broken"]
    filler = [f"word{i}" for i in range(50)]
    texts, labels = [], []
    for i in range(300):
        label = i % 2
        words = list(rng.choice(filler, size=6))
        words += list(rng.choice(pos_words if label else neg_words, size=3))
        rng.shuffle(words)
        texts.append(" ".join(words))
        labels.append(float(label))
    d = {"text": texts, "label": labels}
    rdf = RefDataFrame.from_dict(d, num_partitions=parts)
    pdf = DataFrame.from_dict(d, num_partitions=parts)
    kw = dict(inputCol="text", outputCol="features", numFeatures=1 << 18,
              useIDF=idf)
    rf = RefTextFeaturizer(**kw).fit(rdf).transform(rdf)
    pf = TextFeaturizer(**kw).fit(pdf).transform(pdf)
    return rf, pf, np.asarray(labels)


@pytest.mark.parametrize("idf", [False, True])
def test_text_featurizer_into_the_sparse_fit_matches_reference(
        numpy_csr_predict, idf):
    from mmlspark_tpu_torch.core.pipeline import PipelineModel

    rf, pf, labels = _review_frames(idf, parts=2)
    for a, b in zip(rf.column("features"), pf.column("features")):
        assert a["size"] == b["size"] == 1 << 18
        np.testing.assert_array_equal(a["indices"], b["indices"])
        np.testing.assert_array_equal(a["values"].view(np.uint32),
                                      b["values"].view(np.uint32))
    params = dict(numIterations=10, numLeaves=7, minDataInLeaf=5,
                  minGainToSplit=1e-3, labelCol="label")
    rmodel = ref_stages.LightGBMClassifier(**params).fit(rf)
    with use_device("cpu"):
        pmodel = stages.LightGBMClassifier(**params).fit(pf)
        pout = pmodel.transform(pf)
        fused = PipelineModel([pmodel]).fuse()
        label = "LightGBMClassificationModel"
        fused.set_tuning(layout={label: "csr"},
                         kernel_variants={label: {"*": "forest.csr"}})
        fout = fused.transform(pf.select("features"))
    _assert_same_forest(rmodel.booster, pmodel.booster)
    rout = rmodel.transform(rf)
    np.testing.assert_allclose(np.stack(list(pout.column("rawPrediction"))),
                               np.stack(list(rout.column("rawPrediction"))),
                               rtol=HIST_CSR_TOL, atol=HIST_CSR_TOL)
    np.testing.assert_allclose(
        np.stack(list(fout.column("rawPrediction"))),
        np.stack(list(pout.column("rawPrediction"))), rtol=0, atol=1e-6)
    assert fused.fusion_stats()["fallbacks"] == []
    pred = np.asarray(pout.column("prediction"), np.float64)
    assert (pred == labels).mean() > 0.9


# ---------------------------------------------------------------------------
# Recommendation (``mmlspark_tpu_torch.recommendation``) against the
# reference's, on the same inputs. SAR on the CPU runs the card's torch
# ops. Tolerances: the affinity and the similarity bitwise (f32 adds in
# ``np.add.at``'s order, exact 0/1 co-occurrence counts, the same f32
# elementwise ops); the scores A @ S within rtol 1e-5 (f32 sums in another
# order); the TLC fixtures at ``tests/test_benchmarks.py``'s tolerances; the
# indexer's maps, the ranking split and every ranking metric equal. One
# deliberate deviation: tied scores rank by item ascending (the reference's
# ``np.argsort(-scores)`` leaves their order to the sort).
# ---------------------------------------------------------------------------

import csv  # noqa: E402
import gzip  # noqa: E402
import os  # noqa: E402

from mmlspark_tpu import recommendation as ref_rec  # noqa: E402
from mmlspark_tpu_torch import recommendation as rec  # noqa: E402
from mmlspark_tpu_torch.core.pipeline import PipelineStage  # noqa: E402
from mmlspark_tpu_torch.recommendation import sar as port_sar  # noqa: E402
from test_benchmarks import (RES, _SIM_CASES, _USERPRED_CASES,  # noqa: E402
                             _parse_ts)

SCORE_RTOL = 1e-5
_REC = {"ref": (ref_rec, RefDataFrame), "port": (rec, DataFrame)}


@pytest.fixture(scope="module")
def tlc_cols():
    with gzip.open(os.path.join(RES, "demoUsage.csv.gz"), "rt") as f:
        rows = [r for r in csv.DictReader(f)
                if r["userId"] and r["productId"] and r["timestamp"]]
    return {"userId": [r["userId"] for r in rows],
            "productId": [r["productId"] for r in rows],
            "ts": [_parse_ts(r["timestamp"]) for r in rows]}


def _tlc_fit(pkg, cols, threshold, similarity):
    R, DF = _REC[pkg]
    df = DF.from_dict(dict(cols))
    indexer = R.RecommendationIndexer(
        userInputCol="userId", userOutputCol="user",
        itemInputCol="productId", itemOutputCol="item").fit(df)
    model = R.SAR(userCol="user", itemCol="item", ratingCol="rating",
                  timeCol="ts", supportThreshold=threshold,
                  similarityFunction=similarity,
                  startTime=_parse_ts("2015/06/09T19:39:37")).fit(
        indexer.transform(df))
    return indexer, model


def _f32_bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("threshold,similarity,fixture", _SIM_CASES)
def test_sar_similarity_matches_tlc_fixture(tlc_cols, threshold, similarity,
                                            fixture):
    """The six TLC similarity fixtures through the port (every cell at the
    reference test's tolerance), S and the affinity bitwise the
    reference's (the TLC events repeat (user, item) cells), the scores
    within SCORE_RTOL."""
    _, rm = _tlc_fit("ref", tlc_cols, threshold, similarity)
    with use_device("cpu"):
        ix, pm = _tlc_fit("port", tlc_cols, threshold, similarity)
        scores = pm._scores().numpy()
    S = pm.get("itemSimilarity").numpy()
    np.testing.assert_array_equal(_f32_bits(S),
                                  _f32_bits(rm.get("itemSimilarity")))
    np.testing.assert_array_equal(_f32_bits(pm.get("userAffinity")),
                                  _f32_bits(rm.get("userAffinity")))
    want = rm._scores()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(fin, np.isfinite(scores))
    np.testing.assert_allclose(scores[fin], want[fin], rtol=SCORE_RTOL,
                               atol=0)
    item_index = {k: int(v) for k, v in ix.get("itemMap").items()}
    with gzip.open(os.path.join(RES, fixture), "rt") as f:
        fx = list(csv.reader(f))
    header = fx[0][1:]
    for line in fx[1:]:
        got = S[item_index[line[0]], [item_index[j] for j in header]]
        np.testing.assert_allclose(got, [float(v) for v in line[1:]],
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{fixture} row {line[0]}")
    assert len(fx) - 1 == len(header) == 101


@pytest.mark.parametrize("similarity,fixture", _USERPRED_CASES)
def test_sar_userpred_matches_tlc_fixture(tlc_cols, similarity, fixture):
    """The reference's userpred protocol (top 10 of the probe user: scores
    within 1e-3, the same set, the same order where scores differ)."""
    with use_device("cpu"):
        ix, model = _tlc_fit("port", tlc_cols, 3, similarity)
        recs = model.recommend_for_all_users(num_items=40, remove_seen=True)
    uid = int(ix.get("userMap")["0003000098E85347"])
    inv_item = {int(v): k for k, v in ix.get("itemMap").items()}
    got_items = [inv_item[i] for i in recs.column("recommendations")[uid][:10]]
    got_scores = np.asarray(recs.column("ratings")[uid][:10])
    with gzip.open(os.path.join(RES, fixture), "rt") as f:
        ans = list(csv.DictReader(f))[0]
    want_items = [ans[f"rec{i}"] for i in range(1, 11)]
    want_scores = np.array([float(ans[f"score{i}"]) for i in range(1, 11)])
    np.testing.assert_allclose(got_scores, want_scores, atol=1e-3)
    assert set(got_items) == set(want_items)
    for k in range(10):
        if all(abs(want_scores[k] - want_scores[j]) > 1e-6
               for j in range(10) if j != k):
            assert got_items[k] == want_items[k], k


def _events(n_users=30, n_items=20, seed=0, repeats=False, time=True):
    """``tests/test_automl_recommendation.py``'s two taste clusters, with
    timestamps; with ``repeats`` every event of a user's first item again,
    at ratings whose f32 sum depends on the order of the adds."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(n_users):
        liked = [i for i in range(n_items) if i % 2 == u % 2]
        chosen = rng.choice(liked, size=min(6, len(liked)), replace=False)
        for i in chosen:
            rows.append({"user": u, "item": int(i), "rating": 1.0,
                         "time": 1_600_000_000
                         + int(rng.integers(0, 86400 * 60))})
        if repeats:
            for r in (1e8, 1.0, -1e8, 3.0, 0.5):
                rows.append({"user": u, "item": int(chosen[0]),
                             "rating": r, "time": 1_600_000_000})
    cols = {k: np.array([r[k] for r in rows]) for k in rows[0]}
    if not time:
        del cols["time"]
    return cols


def test_sar_affinity_sums_repeated_events_in_input_order():
    """Repeated (user, item) events sum in input order, as ``np.add.at``
    sums them: bitwise the reference's affinity where another order gives
    other bits."""
    cols = _events(repeats=True)
    out = []
    for pkg in ("ref", "port"):
        R, DF = _REC[pkg]
        with use_device("cpu"):
            out.append(R.SAR(userCol="user", itemCol="item",
                             ratingCol="rating", timeCol="time",
                             supportThreshold=1).fit(
                DF.from_dict(dict(cols))).get("userAffinity"))
    ref, port = np.asarray(out[0]), out[1].numpy()
    np.testing.assert_array_equal(_f32_bits(port), _f32_bits(ref))
    vals = np.float32([1e8, 1.0, -1e8, 3.0, 0.5])
    assert np.add.reduce(np.sort(vals)) != np.add.reduce(vals)
    users = np.array([0, 1, 0, 0, 1, 0])
    items = np.array([2, 0, 2, 2, 0, 2])
    v = np.float32([1e8, 7.0, 1.0, -1e8, 0.25, 3.0])
    want = np.zeros((2, 3), np.float32)
    np.add.at(want, (users, items), v)
    got = port_sar.affinity_matrix(users, items, v, 2, 3, "cpu")
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))


def test_sar_top_k_orders_ties_by_item():
    """The deliberate deviation: scores descending, ties by item ascending.
    Against the reference: the same lists where no scores tie, and each
    tie group the same set apart from the group the cut at k splits."""
    rng = np.random.default_rng(4)
    scores = np.round(rng.random((50, 40)) * 4).astype(np.float32) / 4
    scores[3] = 0.0
    scores[5, ::3] = -np.inf
    scores[7, 2], scores[7, 9] = -0.0, 0.0
    items, vals = port_sar.top_k(torch.from_numpy(scores), 10)
    items = items.numpy()
    want = np.lexsort((np.arange(40)[None].repeat(50, 0), -scores))[:, :10]
    np.testing.assert_array_equal(items, want)
    np.testing.assert_array_equal(vals.numpy(),
                                  np.take_along_axis(scores, want, 1))
    A = (rng.random((50, 40)) < 0.3).astype(np.float32) * 2.0
    S = np.round(rng.random((40, 40)) * 3).astype(np.float32)
    ref = ref_rec.SARModel(userAffinity=A, itemSimilarity=S)
    with use_device("cpu"):
        port = rec.SARModel(userAffinity=A, itemSimilarity=S)
        got = port.recommend_for_all_users(10)
    want = ref.recommend_for_all_users(10)
    _same_up_to_ties(want, got, 10)
    full = np.where(A > 0, -np.inf, ref._scores(remove_seen=False))
    for u in range(50):
        gi = got.column("recommendations")[u]
        np.testing.assert_array_equal(
            gi, np.lexsort((np.arange(40), -full[u]))[:len(gi)])


def _same_up_to_ties(want, got, k):
    """Per user: the scores within SCORE_RTOL, and each group of equal
    scores the same set of items, apart from the group the cut at k
    splits (each package may keep other items of it)."""
    for u in range(want.count()):
        gi, wi = got.column("recommendations")[u], \
            want.column("recommendations")[u]
        gs, ws = got.column("ratings")[u], want.column("ratings")[u]
        assert len(gi) == len(wi)
        np.testing.assert_allclose(gs, ws, rtol=SCORE_RTOL, atol=0)
        cut = ws[-1] if len(ws) == k else None
        for s in np.unique(ws):
            g, w = set(gi[ws == s]), set(wi[ws == s])
            if s != cut:
                assert g == w, (u, s)


def test_sar_model_from_reference_arrays_scores_as_the_reference():
    """A SARModel built from the reference's fitted ``userAffinity`` and
    ``itemSimilarity`` arrays: the pair scores and every user's top-k
    within SCORE_RTOL, and its similarity functions finite and >= 0."""
    cols = _events()
    R, RDF = _REC["ref"]
    for sim in ("cooccurrence", "jaccard", "lift"):
        rm = ref_rec.SAR(userCol="user", itemCol="item", ratingCol="rating",
                         timeCol="time", similarityFunction=sim,
                         supportThreshold=1).fit(RDF.from_dict(dict(cols)))
        with use_device("cpu"):
            pm = rec.SARModel(userCol="user", itemCol="item",
                              userAffinity=rm.get("userAffinity"),
                              itemSimilarity=rm.get("itemSimilarity"))
            got = pm.transform(DataFrame.from_dict(dict(cols)))
            recs = pm.recommend_for_all_users(5)
        want = rm.transform(RDF.from_dict(dict(cols)))
        np.testing.assert_allclose(got.column("prediction"),
                                   want.column("prediction"),
                                   rtol=SCORE_RTOL, atol=0)
        wrecs = rm.recommend_for_all_users(5)
        for a, b in zip(recs.column("ratings"), wrecs.column("ratings")):
            np.testing.assert_allclose(a, b, rtol=SCORE_RTOL, atol=0)
        S = rm.get("itemSimilarity")
        assert np.isfinite(S).all() and (S >= 0).all()
        row0 = recs.rows()[0]
        evens = sum(1 for i in row0["recommendations"] if i % 2 == 0)
        assert evens >= len(row0["recommendations"]) - 1


def test_sar_time_decay_matches_reference():
    rows = {"user": [0, 0, 1, 1], "item": [0, 1, 0, 1],
            "rating": [1.0] * 4,
            "time": [0.0, 86400.0 * 365, 86400.0 * 365, 86400.0 * 365]}
    out = []
    for pkg in ("ref", "port"):
        R, DF = _REC[pkg]
        with use_device("cpu"):
            out.append(R.SAR(userCol="user", itemCol="item",
                             ratingCol="rating", timeCol="time",
                             supportThreshold=0, timeDecayCoeff=30).fit(
                DF.from_dict(dict(rows))).get("userAffinity"))
    np.testing.assert_array_equal(_f32_bits(out[1]), _f32_bits(out[0]))
    assert out[1][0, 0] < out[1][0, 1] * 1e-3


def test_recommendation_indexer_matches_reference():
    cols = {"u": ["alice", "bob", "alice", "carol", None],
            "i": ["x", "y", "y", 7, "x"], "rating": [1.0, 2.0, 3.0, 4, 5]}
    out = []
    for R, DF in _REC.values():
        m = R.RecommendationIndexer(userInputCol="u", userOutputCol="user",
                                    itemInputCol="i",
                                    itemOutputCol="item").fit(
            DF.from_dict(dict(cols)))
        t = m.transform(DF.from_dict(dict(cols)))
        out.append((m.get("userMap"), m.get("itemMap"),
                    list(t.column("user")), list(t.column("item")),
                    m.recover_user(0), m.recover_item(1)))
    assert out[0] == out[1]


@pytest.mark.parametrize("min_r,ratio,seed", [(2, 0.75, 0), (3, 0.5, 5),
                                              (1, 0.9, 2), (7, 0.75, 1)])
def test_ranking_split_matches_reference_bitwise(min_r, ratio, seed):
    """The O(N log N) split draws the reference's permutations for the same
    users in the same order: the same train and validation rows."""
    rng = np.random.default_rng(seed)
    n = 3000
    users = rng.zipf(1.5, n) % 211            # skewed, some users 1-2 rows
    cols = {"user": users, "item": rng.integers(0, 90, n),
            "rating": rng.random(n)}
    out = []
    for R, DF in _REC.values():
        tvs = R.RankingTrainValidationSplit(
            userCol="user", itemCol="item", ratingCol="rating",
            minRatingsPerUser=min_r, trainRatio=ratio, seed=seed)
        out.append(tvs.split(DF.from_dict(dict(cols), num_partitions=3)))
    for a, b in zip(out[0], out[1]):
        assert a.columns == b.columns
        for c in a.columns:
            np.testing.assert_array_equal(a.column(c), b.column(c))


@pytest.mark.parametrize("metric", ["ndcgAt", "map", "precisionAtk",
                                    "recallAtK"])
def test_ranking_evaluator_matches_reference(metric):
    rng = np.random.default_rng(9)
    rows = []
    for u in range(60):
        rows.append({"recommendations": rng.choice(30, rng.integers(0, 12),
                                                   replace=False),
                     "label": rng.choice(30, rng.integers(0, 6),
                                         replace=False)})
    got = [R.RankingEvaluator(metricName=metric, k=5).evaluate(
        DF.from_rows(rows)) for R, DF in _REC.values()]
    assert got[0] == got[1]
    small = [{"recommendations": np.array([1, 2, 3]),
              "label": np.array([1, 9])},
             {"recommendations": np.array([5, 6]), "label": np.array([7])}]
    ref_small, port_small = [R.RankingEvaluator(metricName=metric, k=3)
                             .evaluate(DF.from_rows(small))
                             for R, DF in _REC.values()]
    assert ref_small == port_small


def test_ranking_flow_matches_reference():
    """RankingTrainValidationSplit over SAR (time-decayed, so no scores
    tie): the same validation metric, and the reference test's bar; the
    adapter's per-user rows equal."""
    cols = _events(40, 20)
    out = []
    for R, DF in _REC.values():
        tvs = R.RankingTrainValidationSplit(
            estimator=R.SAR(supportThreshold=1, timeCol="time"),
            evaluator=R.RankingEvaluator(metricName="ndcgAt", k=5),
            userCol="user", itemCol="item", ratingCol="rating",
            minRatingsPerUser=3)
        with use_device("cpu"):
            model = tvs.fit(DF.from_dict(dict(cols)))
            adapted = model.transform(tvs.split(DF.from_dict(dict(cols)))[1])
        out.append((model.get("validationMetric"), model, adapted))
    assert abs(out[0][0] - out[1][0]) <= 1e-12
    assert out[1][0] > 0.2
    (_, rm, a), (_, pm, b) = out
    assert a.columns == b.columns
    for c in ("user", "label"):
        for x, y in zip(a.column(c), b.column(c)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # the recommendations: the tie rule (zero scores tie here)
    want = rm.get("bestModel").get("recommenderModel") \
        .recommend_for_all_users(10)
    with use_device("cpu"):
        got = pm.get("bestModel").get("recommenderModel") \
            .recommend_for_all_users(10)
    _same_up_to_ties(want, got, 10)


def test_sar_model_save_and_load(tmp_path):
    cols = _events()
    with use_device("cpu"):
        model = rec.SAR(userCol="user", itemCol="item", ratingCol="rating",
                        timeCol="time", supportThreshold=1).fit(
            DataFrame.from_dict(dict(cols)))
        want = model.recommend_for_all_users(5)
        model.save(str(tmp_path / "sar"))
        loaded = PipelineStage.load(str(tmp_path / "sar"))
        got = loaded.recommend_for_all_users(5)
    assert type(loaded) is rec.SARModel
    for c in want.columns:
        for x, y in zip(want.column(c), got.column(c)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
