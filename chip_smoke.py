#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # build, check, run; exit 0 only if all pass
    python3 chip_smoke.py --profile  # also print a torch.profiler breakdown of the fit

Run from the root of a checkout. It uses ``mmlspark_tpu_torch`` only (no JAX,
nothing of ``mmlspark_tpu``) and needs one CUDA device:

1. header: the card's name and power limit (nvidia-smi), torch/CUDA
   versions, and the seconds it takes to build every kernel under
   ``mmlspark_tpu_torch/csrc`` with nvcc (one process per source);
2. kernels: K1 (histogram) and K2 (row select) against their plain PyTorch
   versions on the card, at the main path's shapes and at ragged ones, each
   timed beside its plain version, one PyTorch library call computing the
   same function, and its bound (bytes or operations over the H100's peak);
3. dense main path: ``LightGBMClassifier(numLeaves=31, maxBin=255,
   numIterations=20).fit`` on a seeded synthetic HIGGS-shaped dataset
   (2,097,152 rows x 28 features) on the card, then ``.transform`` of 65,536
   rows. K1 and K2 must have launched during it. The scores are held
   against the host f64 traversal of the same model, and the first three
   trees against a refit on the CPU;
4. sparse data: the reference benchmark's text-shaped CSR (1,000,000 rows x
   2^18 hashed features, ~50 token counts per row, seeded), with the host
   costs of the sparse path timed apart: ``rows_to_csr`` over the rows,
   ``SparseDataset.from_csr`` and the bin-sorted layout;
5. K4 (flat sparse histogram) against its plain version at that dataset's
   layout (~49.7M entries, ~1.31M flat bins, 50% row mask) and at ragged
   shapes, timed the same way;
6. sparse main path: ``LightGBMClassifier(numLeaves=31, numIterations=10,
   learningRate=0.1, minDataInLeaf=20).fit`` on a DataFrame of those sparse
   rows (its boosting loop timed apart from the in-fit host build through
   the ``TrainRecorder`` series), then ``.transform`` of 65,536 rows. K4
   must have launched; the scores must equal the CPU ``predict_csr`` of the
   same model and the train accuracy exceed 0.7. The root split of the full-width dataset is searched
   with the reference's f32 prefix formula and the port's f64 one; the
   reference benchmark's anchor shape (100,000 x 2^12) is refit for 3
   iterations on the card and on the CPU, first tree identical;
7. K3 (CSR gather) against its plain version, bitwise: on the real 256-row
   CSR batches the fused executor stages from the sparse rows with the
   sparse model's used columns, on all 65,536 rows at once, and at ragged
   shapes (empty rows, a padded row and nnz tail, used ids past the width,
   an all-leaf forest, no entries), timed beside its plain version, a
   PyTorch sparse-tensor call and its bound, and timed once more with the
   host's cost of issuing it hidden (the kernel's own device time);
8. fused scoring: ``PipelineModel([model]).fuse()`` on both models. Sparse:
   with ``layout="csr"`` and ``forest.csr`` over the same 65,536 rows the
   sparse path scored unfused — no fallback, 256 CSR batches and no
   densify, 256 K3 launches, within 1e-6 of the unfused transform, and the
   ``forest.gather``/``forest.gemm`` variants bit-identical; dense: the
   65,536 HIGGS-shaped rows bitwise-equal to the unfused transform; and at
   the anchor's 2^12 width the CSR-staged output bitwise-equal to the same
   rows sent as dense arrays. Fused and unfused seconds, the host CSR
   staging's share, the transfer ring's decomposition and the cache's hits
   and misses are printed.

Any failure raises and exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``, after a ``{"kernels": [...]}`` line.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
import warnings

import numpy as np

N_MAIN = 2_097_152
F_MAIN = 28
BINS_MAIN = 256
N_SCORE = 65_536
SEED = 20_240_601
# the reference's sparse benchmark point (tools/bench_gbdt_sparse.py)
N_SPARSE = 1_000_000
W_SPARSE = 1 << 18
NNZ_SPARSE = 50
ITERS_SPARSE = 10
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events around the whole run, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(torch, fn, iters: int = 200, warmup: int = 3):
    """Mean device time of ``fn`` with the host's cost of issuing it hidden:
    a spin kernel holds the stream while the host queues all ``iters``
    calls, so the events bracket only their device work. The spin grows
    until it outlasts the queueing (the start event must still be
    pending once every call is queued). None where this torch has no spin
    kernel."""
    spin = getattr(torch.cuda, "_sleep", None)
    if spin is None:
        return None
    for _ in range(warmup):
        fn()
    cycles = 1 << 24          # ~8 ms at the H100's boost clock
    for _ in range(5):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 4
    fail("the spin kernel never outlasted the host's queueing")


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC AUC with average ranks for tied scores."""
    uniq, inv, counts = np.unique(scores, return_inverse=True, return_counts=True)
    upper = np.cumsum(counts)
    ranks = (upper - (counts - 1) / 2.0)[inv]
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def higgs_like(n: int, seed: int):
    """Seeded synthetic stand-in for HIGGS (28 float features: 21 low-level
    kinematics — momenta, pseudorapidities, azimuths, b-tags — and 7 derived
    masses), binary label from a nonlinear signal. Values are f32-exact."""
    rng = np.random.default_rng(seed)
    X = np.empty((n, F_MAIN), dtype=np.float32)
    for j in range(21):
        kind = j % 4
        if kind == 0:      # transverse momentum: positive, skewed
            X[:, j] = rng.lognormal(0.0, 0.5, n)
        elif kind == 1:    # pseudorapidity
            X[:, j] = rng.normal(0.0, 1.0, n)
        elif kind == 2:    # azimuth
            X[:, j] = rng.uniform(-np.pi, np.pi, n)
        else:              # b-tag: three levels
            X[:, j] = rng.choice(np.array([0.0, 1.1, 2.2], np.float32), n)
    for j in range(7):     # derived masses
        a, b = X[:, 4 * j % 21], X[:, (4 * j + 4) % 21]
        X[:, 21 + j] = np.sqrt(a * b * (1.0 + 0.5 * np.cos(X[:, (4 * j + 2) % 21]))
                               + rng.gamma(2.0, 0.1, n))
    z = (1.2 * (X[:, 21] - 1.0) - 0.8 * np.abs(X[:, 1]) + 0.6 * X[:, 0] * X[:, 3]
         + 0.5 * np.sin(X[:, 2]) * X[:, 24] + rng.logistic(0.0, 1.0, n))
    y = (z > np.median(z)).astype(np.float64)
    return X.astype(np.float64), y


def header(torch) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log({"phase": "header", "torch": torch.__version__,
         "cuda": torch.version.cuda, "python": sys.version.split()[0],
         "device": torch.cuda.get_device_name(0),
         "device_count": torch.cuda.device_count(), "nvidia_smi": smi})
    from mmlspark_tpu_torch import _kernels

    secs = _kernels.build_all()
    log({"phase": "build", "seconds": secs, "kernels": _kernels.sources(),
         "build_dir": str(_kernels.build_dir())})
    for name, text in _kernels.build_logs.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log({"phase": "build", "kernel": name, "ptxas": regs})
    return {"smi": smi}


def hist_inputs(torch, n, f, b, density, gen):
    dev = torch.device("cuda")
    bins = torch.randint(0, b, (f, n), generator=gen, dtype=torch.int32)
    grad = torch.randn(n, generator=gen)
    hess = torch.rand(n, generator=gen)
    mask = torch.rand(n, generator=gen) < density
    return [t.to(dev) for t in (bins, grad, hess, mask)]


def check_hist(torch, hk, n, f, b, gen) -> float:
    """K1 vs its plain version: count exact, grad/hess within 1e-5 of the
    bin's sum of |v| + 1e-6. Returns the max abs error of grad/hess."""
    bins, grad, hess, mask = hist_inputs(torch, n, f, b, 0.5, gen)
    k = hk.histogram_cuda(bins, grad, hess, mask, b)
    p = hk.histogram_plain(bins, grad, hess, mask, b)
    scale = hk.histogram_plain(bins, grad.abs(), hess.abs(), mask, b)
    torch.cuda.synchronize()
    if not torch.equal(k[..., 2], p[..., 2]):
        fail(f"hist count channel differs at n={n} f={f} b={b}")
    err = (k[..., :2] - p[..., :2]).abs()
    tol = 1e-5 * scale[..., :2] + 1e-6
    if not bool((err <= tol).all()):
        fail(f"hist grad/hess beyond tolerance at n={n} f={f} b={b}: "
             f"max err {err.max().item()}")
    log({"phase": "kernels", "kernel": "hist", "n": n, "f": f, "bins": b,
         "count_exact": True, "max_abs_err": err.max().item()})
    return err.max().item()


def kernel_phase(torch) -> dict:
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk
    from mmlspark_tpu_torch.gbdt import select_kernel as sk
    from mmlspark_tpu_torch.gbdt.tree import pick_tier, tier_caps

    gen = torch.Generator().manual_seed(SEED)
    out = {}

    # ----- K1
    err = check_hist(torch, hk, N_MAIN, F_MAIN, BINS_MAIN, gen)
    for n in (1, 1537):
        for b in (2, 17, 1024, 20000):
            check_hist(torch, hk, n, 65, b, gen)
    bins, grad, hess, mask = hist_inputs(torch, N_MAIN, F_MAIN, BINS_MAIN, 0.5, gen)
    n, f, b = N_MAIN, F_MAIN, BINS_MAIN
    m = mask.to(torch.float32)
    vals = torch.stack([grad * m, hess * m, m], dim=1)                  # [N, 3]
    flat_idx = ((bins.to(torch.int64) + torch.arange(f, device=bins.device)[:, None]
                 * b)[..., None] * 3 + torch.arange(3, device=bins.device)).reshape(-1)
    flat_vals = vals[None].expand(f, n, 3).reshape(-1)
    ms = time_ms(torch, lambda: hk.histogram_cuda(bins, grad, hess, mask, b))
    plain = time_ms(torch, lambda: hk.histogram_plain(bins, grad, hess, mask, b), 5)
    lib = time_ms(torch, lambda: torch.zeros(f * b * 3, device=bins.device)
                  .index_add_(0, flat_idx, flat_vals), 5)
    cnt = int(mask.sum())
    t_bound, by = bound_ms(cnt * f * 4 + n + cnt * 8 + f * b * 12, 3 * cnt * f)
    del flat_idx, flat_vals
    out["hist"] = dict(name="hist", route="cuda",
                       source="mmlspark_tpu_torch/csrc/hist.cu",
                       replaces="mmlspark_tpu/gbdt/pallas_hist.py:65",
                       max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=t_bound,
                       bound_by=by, library_ms=lib,
                       library_call="Tensor.index_add_ (one call, flat index "
                                    "and values prepared outside the timing)",
                       shape=dict(n=n, f=f, bins=b, selected=cnt))
    log(dict(phase="kernels", **out["hist"]))

    # ----- K2: bitwise, cap from the grower's tiers (full width when no
    # tier holds the rows)
    caps = tier_caps(N_MAIN, True)
    for density in (0.0, 0.3, 1.0):
        msk = (torch.rand(N_MAIN, generator=gen) < density).to(bins.device)
        count = int(msk.sum())
        tidx = pick_tier(caps, count)
        cap = caps[tidx - 1] if tidx else N_MAIN
        a = sk.select_rows_cuda(bins, grad, hess, msk, cap)
        p = sk.select_rows_plain(bins, grad, hess, msk, cap)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, p)):
            fail(f"select differs from its plain version at density {density}")
        log({"phase": "kernels", "kernel": "select", "density": density,
             "count": count, "cap": cap, "bitwise": True})
        if density == 0.3:
            sel = (msk, count, cap)
    msk, count, cap = sel
    ms = time_ms(torch, lambda: sk.select_rows_cuda(bins, grad, hess, msk, cap))
    plain = time_ms(torch, lambda: sk.select_rows_plain(bins, grad, hess, msk, cap), 5)

    def library():
        idx = torch.nonzero(msk).flatten()
        return (bins.index_select(1, idx), grad.index_select(0, idx),
                hess.index_select(0, idx))

    lib = time_ms(torch, library, 5)
    t_bound, by = bound_ms(N_MAIN + count * (F_MAIN + 2) * 4 + cap * (F_MAIN + 2) * 4, 0)
    out["select"] = dict(name="select", route="cuda",
                         source="mmlspark_tpu_torch/csrc/select.cu",
                         replaces="mmlspark_tpu/gbdt/pallas_select.py:52",
                         max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=t_bound,
                         bound_by=by, library_ms=lib,
                         library_call="torch.nonzero + 3x index_select",
                         shape=dict(n=N_MAIN, f=F_MAIN, selected=count, cap=cap))
    log(dict(phase="kernels", **out["select"]))
    return out


def first_diff(a, b):
    for fld in ("feature", "threshold_bin", "left", "right"):
        x, y = getattr(a, fld), getattr(b, fld)
        if len(x) != len(y):
            return {"field": fld, "nodes": [len(x), len(y)]}
        bad = np.nonzero(x != y)[0]
        if len(bad):
            i = int(bad[0])
            return {"field": fld, "node": i, "cuda": int(x[i]), "cpu": int(y[i])}
    return None


def main_path(torch, profile: bool):
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier, predict_ensemble
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk
    from mmlspark_tpu_torch.gbdt import select_kernel as sk
    from mmlspark_tpu_torch.runtime import use_device

    t0 = time.perf_counter()
    X, y = higgs_like(N_MAIN, SEED)
    df = DataFrame.from_dict({"features": X, "label": y})
    small = DataFrame.from_dict({"features": X[:N_SCORE], "label": y[:N_SCORE]})
    log({"phase": "data", "rows": N_MAIN, "features": F_MAIN,
         "seconds": time.perf_counter() - t0, "positives": float(y.mean())})
    est = LightGBMClassifier(numLeaves=31, maxBin=255, numIterations=20)

    hk.launches = 0
    sk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            model = est.fit(df)
            torch.cuda.synchronize()
    else:
        model = est.fit(df)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    scored = model.transform(small)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t1
    launches = {"hist": hk.launches, "select": sk.launches}
    log({"phase": "main", "fit_seconds": fit_s, "fit_rows_per_s": N_MAIN / fit_s,
         "transform_rows": N_SCORE, "transform_seconds": score_s,
         "launches": launches})
    if profile:
        rows = []
        for ev in p.key_averages():
            dev_us = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
            if dev_us:
                rows.append((dev_us, ev.key, ev.count))
        rows.sort(reverse=True)
        kernels_us = sum(d for d, k, _ in rows if not k.startswith("aten::"))
        from mmlspark_tpu_torch.gbdt.binning import BinMapper

        t2 = time.perf_counter()
        BinMapper.fit(X, 255).transform_fm(X, dtype=np.uint8)
        log({"phase": "profile", "fit_wall_ms": fit_s * 1e3,
             "device_kernel_ms": kernels_us / 1e3,
             "host_binning_ms": (time.perf_counter() - t2) * 1e3,
             "top": [{"name": k[:80], "device_ms": d / 1e3, "calls": c}
                     for d, k, c in rows[:20]]})
    if launches["hist"] < 1 or launches["select"] < 1:
        fail(f"a kernel of the main path never launched: {launches}")

    booster = model.booster
    raw = np.stack(list(scored.column("rawPrediction")))[:, 1]
    proba = np.stack(list(scored.column("probability")))
    if raw.shape != (N_SCORE,) or proba.shape != (N_SCORE, 2):
        fail(f"unexpected output shapes {raw.shape} {proba.shape}")
    if not (np.isfinite(raw).all() and np.isfinite(proba).all()):
        fail("non-finite scores")
    # the host f64 traversal of the same model, comparing features and
    # thresholds as f32 values the way the device traversal does
    trees32 = [[t.__class__(**{**t.__dict__, "threshold": t.threshold.astype(
        np.float32).astype(np.float64)}) for t in g] for g in booster.trees]
    X32 = X[:N_SCORE].astype(np.float32).astype(np.float64)
    host = predict_ensemble(trees32, X32, 1)[:, 0] + booster.base_score[0]
    diff = float(np.abs(raw - host).max())
    host64 = booster.raw_predict(X[:N_SCORE])
    train_auc = auc(raw, y[:N_SCORE])
    log({"phase": "main", "train_auc_65536": train_auc,
         "max_abs_diff_vs_host_f64": diff,
         "max_abs_diff_vs_host_f64_unrounded": float(np.abs(raw - host64).max()),
         "trees": len(booster.trees)})
    if diff > 1e-5:
        fail(f"device scores differ from the host f64 traversal by {diff}")
    if train_auc < 0.6:
        fail(f"train AUC {train_auc} is not learning")

    # CPU refit of the first 3 iterations on the same data
    t0 = time.perf_counter()
    with use_device("cpu"):
        cpu_model = LightGBMClassifier(numLeaves=31, maxBin=255,
                                       numIterations=3).fit(df)
    cpu_s = time.perf_counter() - t0
    cb = cpu_model.booster
    diffs = [first_diff(booster.trees[i][0], cb.trees[i][0]) for i in range(3)]
    raw3_cuda = booster.raw_predict(X[:N_SCORE], num_iteration=3)
    raw3_cpu = cb.raw_predict(X[:N_SCORE])
    d3 = float(np.abs(raw3_cuda - raw3_cpu).max())
    log({"phase": "cpu_refit", "seconds": cpu_s, "first_diff_per_tree": diffs,
         "max_abs_diff_3_trees": d3})
    if diffs[0] is not None:
        fail(f"tree 1 differs between the CUDA and CPU fits: {diffs[0]}")
    if d3 > 1e-3:
        fail(f"3-tree raw scores differ by {d3}")
    return launches, model, X[:N_SCORE].copy()


# ---------------------------------------------------------------------------
# sparse (CSR) path
# ---------------------------------------------------------------------------


def make_csr_text(n_rows: int, width: int, avg_nnz: int, seed: int):
    """Seeded copy of the reference benchmark's text-shaped CSR
    (tools/bench_gbdt_sparse.py make_csr_text): ~avg_nnz token counts (1-4)
    per row, token ids skewed toward low ids (width * r^3), label from 8
    signal tokens plus noise."""
    rng = np.random.default_rng(seed)
    nnz_per_row = rng.poisson(avg_nnz, n_rows).clip(1)
    total = int(nnz_per_row.sum())
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_per_row)
    idx = (width * rng.random(total) ** 3).astype(np.int64).clip(0, width - 1)
    key = np.unique(row_of * width + idx)   # sorted, distinct per row
    row_of = key // width
    idx = key % width
    vals = 1.0 + rng.integers(0, 4, len(key)).astype(np.float64)
    indptr = np.searchsorted(row_of, np.arange(n_rows + 1))
    signal = (width * np.linspace(0.01, 0.6, 8) ** 3).astype(np.int64)
    sig_val = np.zeros(n_rows)
    for j, s in enumerate(signal):
        hit = idx == s       # at most one entry per row: bincount == add.at
        sig_val += np.bincount(row_of[hit], minlength=n_rows,
                               weights=(1.0 if j % 2 == 0 else -1.0) * vals[hit])
    y = (sig_val + rng.normal(0, 0.5, n_rows) > 0).astype(np.float64)
    return indptr, idx, vals, y


def sparse_data() -> dict:
    """The full-width sparse dataset as sparse rows, with the host costs of
    the sparse path timed on their own."""
    from mmlspark_tpu_torch.gbdt import sparse

    t0 = time.perf_counter()
    indptr, idx, vals, y = make_csr_text(N_SPARSE, W_SPARSE, NNZ_SPARSE, 0)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = np.empty(N_SPARSE, dtype=object)
    for i in range(N_SPARSE):
        a, b = indptr[i], indptr[i + 1]
        rows[i] = {"indices": idx[a:b], "values": vals[a:b], "size": W_SPARSE}
    rows_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = sparse.rows_to_csr(rows)
    csr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = sparse.SparseDataset.from_csr(*csr, max_bin=255)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    order, _, bin_end = sparse._bin_sorted_layout(ds.bin_of_nnz, ds.total_bins)
    layout_s = time.perf_counter() - t0
    log({"phase": "sparse_data", "rows": N_SPARSE, "width": W_SPARSE,
         "nnz": int(len(idx)), "total_bins": ds.total_bins,
         "positives": float(y.mean()), "generate_seconds": gen_s,
         "row_dicts_seconds": rows_s, "host_rows_to_csr_seconds": csr_s,
         "host_from_csr_seconds": build_s,
         "host_bin_sorted_layout_seconds": layout_s})
    return {"rows": rows, "y": y, "csr": (indptr, idx, vals), "ds": ds,
            "order": order, "bin_end": bin_end}


def sparse_hist_inputs(torch, nnz, tb, empty_every, gen):
    """Bin-sorted entries over ``tb`` skewed bins (every ``empty_every``-th
    empty), stats masked at 50%, on the card."""
    rng = np.random.default_rng(int(torch.randint(0, 2**31, (1,), generator=gen)))
    weights = rng.random(tb) ** 4 + 1e-4
    if empty_every:
        weights[::empty_every] = 0.0
    ids = np.sort(rng.choice(tb, size=nnz, p=weights / weights.sum()))
    bin_end = np.searchsorted(ids, np.arange(tb), side="right").astype(np.int32)
    m = (rng.random(nnz) < 0.5).astype(np.float32)
    data = np.stack([rng.standard_normal(nnz) * m, (rng.random(nnz) + 0.1) * m, m])
    dev = torch.device(DEVICE)
    return (torch.from_numpy(data.astype(np.float32)).to(dev),
            torch.from_numpy(bin_end).to(dev))


def check_sparse_hist(torch, shk, data, bin_end, what) -> float:
    """K4 vs its plain version: count exact, grad/hess within 1e-5 of the
    bin's sum of |v| + 1e-6. Returns the max abs error of grad/hess."""
    k = shk.sparse_histogram_cuda(data, bin_end)
    p = shk.sparse_histogram_plain(data, bin_end)
    scale = shk.sparse_histogram_plain(data.abs(), bin_end)
    torch.cuda.synchronize()
    nnz, tb = data.shape[1], bin_end.shape[0]
    if tuple(k.shape) != (3, tb) or not torch.equal(k[2], p[2]):
        fail(f"sparse_hist count channel differs ({what}: nnz={nnz} tb={tb})")
    err = (k[:2] - p[:2]).abs()
    if not bool((err <= 1e-5 * scale[:2] + 1e-6).all()):
        fail(f"sparse_hist grad/hess beyond tolerance ({what}: nnz={nnz} "
             f"tb={tb}): max err {err.max().item()}")
    e = err.max().item() if err.numel() else 0.0
    log({"phase": "kernels", "kernel": "sparse_hist", "case": what, "nnz": nnz,
         "bins": tb, "count_exact": True, "max_abs_err": e})
    return e


def sparse_kernel_phase(torch, data: dict) -> dict:
    from mmlspark_tpu_torch.gbdt import sparse_hist_kernel as shk

    gen = torch.Generator().manual_seed(SEED + 4)
    dev = torch.device(DEVICE)
    ds = data["ds"]
    n, tb = ds.num_rows, ds.total_bins
    rows_bs = torch.as_tensor(ds.row_of_nnz[data["order"]].astype(np.int64),
                              device=dev)
    bin_end = torch.as_tensor(data["bin_end"].astype(np.int32), device=dev)
    grad = torch.randn(n, generator=gen).to(dev)
    hess = torch.rand(n, generator=gen).to(dev)
    m = (torch.rand(n, generator=gen) < 0.5).to(dev)[rows_bs].to(torch.float32)
    stats = torch.stack([grad[rows_bs] * m, hess[rows_bs] * m, m]).contiguous()
    del rows_bs
    err = check_sparse_hist(torch, shk, stats, bin_end, "main")
    for nnz, tb_r, empty, what in ((0, 5, 0, "nnz 0"), (1, 1, 0, "nnz 1"),
                                   (1, 9, 0, "nnz 1, empty bins"),
                                   (300_001, 1, 0, "one bin"),
                                   (123_457, 7_777, 3, "empty bins, ragged tb"),
                                   (2_049, 4_001, 2, "more bins than entries")):
        check_sparse_hist(torch, shk, *sparse_hist_inputs(torch, nnz, tb_r, empty,
                                                          gen), what)
    nnz = stats.shape[1]
    ids = shk.bin_ids(bin_end)
    ms = time_ms(torch, lambda: shk.sparse_histogram_cuda(stats, bin_end))
    plain = time_ms(torch, lambda: shk.sparse_histogram_plain(stats, bin_end), 5)
    lib = time_ms(torch, lambda: torch.zeros(3, tb, device=dev)
                  .index_add_(1, ids, stats), 5)
    t_bound, by = bound_ms(12 * nnz + 4 * tb + 12 * tb, 3 * nnz)
    row = dict(name="sparse_hist", route="cuda",
               source="mmlspark_tpu_torch/csrc/sparse_hist.cu",
               replaces="mmlspark_tpu/gbdt/pallas_sparse.py:269",
               max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=t_bound,
               bound_by=by, library_ms=lib,
               library_call="Tensor.index_add_ over the flat bin ids (f32, one "
                            "call, ids prepared outside the timing)",
               shape=dict(nnz=nnz, bins=tb, row_mask=0.5))
    log(dict(phase="kernels", **row))
    del stats, ids
    torch.cuda.empty_cache()
    return row


def root_split_check(torch, ds, y) -> dict:
    """The split search of the full-width dataset at iteration 0 with the
    reference's formula (f32 prefix over all flat bins) and the port's (f64
    segmented scan): the root's (bin, gain) both ways and the port's gain at
    the reference's bin, the error of the reference's left hessian sums over
    every bin, and the whole first tree grown with each. Recorded, not
    gated: a disagreement is the reference's fault."""
    from mmlspark_tpu_torch.gbdt import GrowerConfig, booster, sparse

    dev = torch.device(DEVICE)
    d = sparse.device_arrays(ds, dev)
    base = booster.init_score("binary", y)
    scores = torch.full((ds.num_rows,), float(base[0]), device=dev)
    labels = torch.as_tensor(y, dtype=torch.float32, device=dev)
    g, h = booster.grad_hess("binary", scores, labels)
    mask = torch.ones(ds.num_rows, dtype=torch.bool, device=dev)
    gb, hb = sparse._entry_gh(d, g, h)
    hist = sparse._zero_completed(d, sparse._flat_histogram(d, gb, hb, mask),
                                  sparse._masked_totals(g, h, mask))[None]
    args = (0.0, 0.0, 1e-3, 20)
    faithful = sparse._find_best_split_flat(d, hist, *args, faithful=True)[0]
    port = sparse._find_best_split_flat(d, hist, *args)[0]
    # within-feature left hessian sums of every flat bin, both ways
    h32 = hist[0]
    cs = sparse._prefix_sum(h32)[:, 1:]
    fs = d["feat_start_of_bin"]
    hl_f = (cs - (cs[:, fs] - h32[:, fs]))[1].double()
    hl_p = sparse._segmented_cumsum(d, h32.double())[1]
    hl_err = (hl_f - hl_p).abs()
    b_f = int(faithful[0])
    only = torch.zeros(ds.total_bins, dtype=torch.bool, device=dev)
    only[b_f] = True
    at_f = sparse._find_best_split_flat(d, hist, *args, bin_mask=only)[0]
    names = ("bin", "gain", "GL", "HL", "CL", "GR", "HR", "CR")
    out = {"faithful": dict(zip(names, faithful.tolist())),
           "port_f64": dict(zip(names, port.tolist())),
           "port_f64_at_faithful_bin": dict(zip(names, at_f.tolist())),
           "same_bin": b_f == int(port[0]),
           "left_hess_abs_err_max": hl_err.max().item(),
           "left_hess_abs_err_last_feature_bins": hl_err[-8:].tolist(),
           "bins_left_hess_err_over_1": int((hl_err > 1.0).sum())}
    # the whole first tree, grown once with each formula
    cfg = GrowerConfig(num_leaves=31, min_data_in_leaf=20)
    port_tree, port_rows = sparse.grow_tree_sparse(ds, d, g, h, cfg)
    exact = sparse._find_best_split_flat
    sparse._find_best_split_flat = functools.partial(exact, faithful=True)
    try:
        ref_tree, ref_rows = sparse.grow_tree_sparse(ds, d, g, h, cfg)
    finally:
        sparse._find_best_split_flat = exact

    def loss(rows) -> float:
        """sum over leaves of -G^2 / 2H, from f64 row sums (lower = better)"""
        gh = torch.zeros(2, 2 * cfg.num_leaves - 1, dtype=torch.float64, device=dev)
        gh.index_add_(1, rows.long(), torch.stack([g, h]).double())
        keep = gh[1] > 0
        return float((-0.5 * gh[0][keep] ** 2 / gh[1][keep]).sum())

    internal = port_tree.feature >= 0
    n_same = min(len(port_tree.feature), len(ref_tree.feature))
    diff = first_diff(ref_tree, port_tree)
    if diff and "cuda" in diff:
        diff["faithful"], diff["port_f64"] = diff.pop("cuda"), diff.pop("cpu")
    out["first_tree"] = {
        "first_diff": diff,
        "splits_with_other_feature_or_bin": int(
            ((port_tree.feature[:n_same] != ref_tree.feature[:n_same])
             | (port_tree.threshold_bin[:n_same]
                != ref_tree.threshold_bin[:n_same]))[internal[:n_same]].sum()),
        "splits": int(internal.sum()),
        "exact_loss_faithful": loss(ref_rows), "exact_loss_port_f64": loss(port_rows)}
    log(dict(phase="sparse_root_split", **out))
    return out


def sparse_main_path(torch, data: dict):
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.gbdt import sparse
    from mmlspark_tpu_torch.gbdt import sparse_hist_kernel as shk
    from mmlspark_tpu_torch.obs.metrics import TrainRecorder, default_registry

    rows, y = data["rows"], data["y"]
    df = DataFrame.from_dict({"features": rows, "label": y})
    small = DataFrame.from_dict({"features": rows[:N_SCORE], "label": y[:N_SCORE]})
    est = LightGBMClassifier(numLeaves=31, numIterations=ITERS_SPARSE,
                             learningRate=0.1, minDataInLeaf=20)
    # the boosting loop's own seconds inside the fit (train_sparse records
    # every iteration): the rest of the fit is the host build of the CSR
    # dataset and its device layout
    steps = default_registry().histogram(
        "mmlspark_train_step_seconds", labelnames=("engine",),
        buckets=TrainRecorder.STEP_BUCKETS).labels(engine="gbdt_sparse")
    before = steps.value
    shk.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = est.fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    loop_s = steps.value["sum"] - before["sum"]
    t1 = time.perf_counter()
    scored = model.transform(small)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t1
    launches = shk.launches
    nnz = int(len(data["csr"][1]))
    log({"phase": "sparse_main", "fit_seconds": fit_s,
         "fit_rows_per_s": N_SPARSE * ITERS_SPARSE / fit_s,
         "fit_nnz_per_s": nnz * ITERS_SPARSE / fit_s,
         "boosting_loop_seconds": loop_s,
         "boosting_loop_iterations": steps.value["count"] - before["count"],
         "transform_rows": N_SCORE, "transform_seconds": score_s,
         "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
         "launches": {"sparse_hist": launches}})
    if launches < 1:
        fail("K4 never launched on the sparse main path")

    booster = model.booster
    raw = np.stack(list(scored.column("rawPrediction")))[:, 1]
    if raw.shape != (N_SCORE,) or not np.isfinite(raw).all():
        fail(f"sparse scores: shape {raw.shape} or non-finite values")
    indptr, idx, vals = data["csr"]
    cut = int(indptr[N_SCORE])
    cpu = sparse.predict_csr(booster.trees, indptr[:N_SCORE + 1], idx[:cut],
                             vals[:cut], 1, device="cpu")[:, 0] + booster.base_score[0]
    diff = float(np.abs(raw - cpu).max())
    full = sparse.predict_csr(booster.trees, indptr, idx, vals, 1)[:, 0] \
        + booster.base_score[0]
    acc = float(((full > 0) == (y > 0.5)).mean())
    leaves = [t.num_leaves for g in booster.trees for t in g]
    log({"phase": "sparse_main", "max_abs_diff_vs_cpu_predict_csr": diff,
         "train_accuracy": acc, "trees": len(booster.trees), "leaves": leaves,
         "boosting_loop_ms_per_split":
             loop_s * 1e3 / max(sum(leaves) - len(leaves), 1)})
    if diff > 1e-12:
        fail(f"sparse transform differs from the CPU predict_csr by {diff}")
    if acc <= 0.7:
        fail(f"sparse train accuracy {acc} is not above 0.7")
    root_split_check(torch, data["ds"], y)
    return launches, model


def sparse_anchor(torch):
    """The reference benchmark's anchor shape, 3 iterations on the card and
    on the CPU: first tree identical, 3-tree raw scores within 1e-3.
    Returns the card's booster and the anchor's CSR arrays."""
    from mmlspark_tpu_torch.gbdt import TrainParams, sparse

    indptr, idx, vals, y = make_csr_text(100_000, 1 << 12, 50, 1)
    ds = sparse.SparseDataset.from_csr(indptr, idx, vals, 1 << 12)
    params = TrainParams(objective="binary", num_iterations=3, num_leaves=31,
                         learning_rate=0.1, min_data_in_leaf=20, seed=0)
    out = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        b = sparse.train_sparse(params, ds, y, device=dev)
        out[dev] = (b, time.perf_counter() - t0)
    (bc, cuda_s), (bp, cpu_s) = out[DEVICE], out["cpu"]
    diffs = [first_diff(bc.trees[i][0], bp.trees[i][0]) for i in range(3)]
    raw = [sparse.predict_csr(b.trees, indptr, idx, vals, 1, device="cpu")[:, 0]
           for b in (bc, bp)]
    d3 = float(np.abs(raw[0] - raw[1]).max())
    log({"phase": "sparse_anchor", "rows": 100_000, "width": 1 << 12,
         "nnz": int(len(idx)), "cuda_fit_seconds": cuda_s,
         "cpu_fit_seconds": cpu_s, "first_diff_per_tree": diffs,
         "max_abs_diff_3_trees": d3})
    if diffs[0] is not None:
        fail(f"anchor tree 1 differs between the CUDA and CPU fits: {diffs[0]}")
    if d3 > 1e-3:
        fail(f"anchor 3-tree raw scores differ by {d3}")
    return bc, (indptr, idx, vals)


# ---------------------------------------------------------------------------
# K3 and the fused scoring pipeline
# ---------------------------------------------------------------------------


def fused_batches(model, rows):
    """The CSR batches ``PipelineModel([model]).fuse()`` stages for
    ``rows`` with the layout knob at "csr" (the executor's own prep and
    batching), as host arrays."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.fusion import SegmentExecutor, plan

    df = DataFrame.from_dict({"features": rows})
    ex = SegmentExecutor(plan([model], df.schema)[0], layout="csr")
    state = ex._prep_partition(dict(df.partitions[0]))
    if "features" not in state.get("csr", {}):
        fail("the executor did not stage the sparse rows as CSR")
    return state["csr"]["features"], list(ex._batches(state))


def gather_args(torch, arrays, used):
    dev = torch.device(DEVICE)
    return ([torch.as_tensor(arrays[f"features:{k}"]).to(dev)
             for k in ("indptr", "indices", "values")]
            + [int(arrays["features:width"]), used])


def check_gather(torch, gk, args, what) -> None:
    """K3 vs its plain version: bitwise (the f32 bits of every cell)."""
    k = gk.csr_gather_cuda(*args)
    p = gk.csr_gather_plain(*args)
    torch.cuda.synchronize()
    n, u = args[0].shape[0] - 1, args[4].shape[0]
    if tuple(k.shape) != (n, u) or not torch.equal(k.view(torch.int32),
                                                   p.view(torch.int32)):
        fail(f"csr_gather differs from its plain version ({what}: rows={n} "
             f"used={u})")
    log({"phase": "kernels", "kernel": "csr_gather", "case": what, "rows": n,
         "used": u, "nnz": int(args[0][-1]), "nnz_staged": args[1].shape[0],
         "bitwise": True})


def library_gather(torch, args):
    """One PyTorch sparse-tensor call computing the gather on the same
    batch (the first of these that runs here), for the library yardstick."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # sparse tensors: beta
        return _library_gather(torch, args)


def _library_gather(torch, args):
    indptr, indices, values, width, used = args
    n, nnz = indptr.shape[0] - 1, int(indptr[-1])
    csr = torch.sparse_csr_tensor(indptr.long(), indices[:nnz].long(),
                                  values[:nnz], size=(n, width))
    used64 = used.long()

    def one_hot():
        sel = torch.zeros(width, used.shape[0], device=used.device)
        sel[used64, torch.arange(used.shape[0], device=used.device)] = 1.0
        return sel

    # (name, inputs prepared outside the timing, the timed call)
    cands = [("sparse CSR index_select(1, used) + to_dense", lambda: csr,
              lambda x: x.index_select(1, used64).to_dense()),
             ("sparse COO index_select(1, used) + to_dense", csr.to_sparse_coo,
              lambda x: x.index_select(1, used64).to_dense()),
             ("torch.sparse.mm(CSR, dense one-hot [width, U])", one_hot,
              lambda x: torch.sparse.mm(csr, x))]
    tried = []
    for name, prep, call in cands:
        try:
            x = prep()
            out = call(x)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, TypeError) as e:
            tried.append(f"{name}: {str(e).splitlines()[0][:120]}")
            continue
        return name, functools.partial(call, x), out, tried
    return None, None, None, tried


def gather_kernel_phase(torch, model, rows) -> dict:
    from mmlspark_tpu_torch.gbdt import gather_kernel as gk
    from mmlspark_tpu_torch.parallel.batching import pad_batch

    dev = torch.device(DEVICE)
    used_np = gk.used_features(model._ensemble())
    used = torch.as_tensor(used_np.astype(np.int32), device=dev)
    (indptr, indices, values, width), batches = fused_batches(model, rows)
    main_args = gather_args(torch, batches[0].arrays, used)
    check_gather(torch, gk, main_args, "fused batch 0 (256 rows)")
    check_gather(torch, gk, gather_args(torch, batches[-1].arrays, used),
                 "fused batch 255")
    # all rows at once: the partition's whole triple, nnz padded as a
    # batch would be
    nnz = int(indptr[-1])
    pad = 1 << (nnz - 1).bit_length()
    whole = {"features:indptr": indptr, "features:width": width,
             "features:indices": pad_batch(indices, pad),
             "features:values": pad_batch(values, pad)}
    big_args = gather_args(torch, whole, used)
    check_gather(torch, gk, big_args, "65,536 rows at once")
    empty = {"indices": np.zeros(0, np.int64), "values": np.zeros(0), "size": width}
    holes = rows[:256].copy()
    holes[::3] = [empty] * len(holes[::3])
    cases = [("empty rows", fused_batches(model, holes)[1][0].arrays, used),
             ("padded rows and nnz tail",
              fused_batches(model, rows[:1000])[1][-1].arrays, used),
             ("used ids past the width", batches[0].arrays,
              torch.cat([used, torch.tensor([width - 1, width, width + 5],
                                            dtype=torch.int32, device=dev)])),
             ("all-leaf forest (used = [0])", batches[0].arrays, used[:1] * 0),
             ("no entries", fused_batches(model, np.array(
                 [empty] * 256, dtype=object))[1][0].arrays, used)]
    for what, arrays, u in cases:
        check_gather(torch, gk, gather_args(torch, arrays, u), what)

    b_nnz = int(main_args[0][-1])
    n_rows, n_used = main_args[0].shape[0] - 1, used.shape[0]
    ms = time_ms(torch, lambda: gk.csr_gather_cuda(*main_args), 200)
    plain = time_ms(torch, lambda: gk.csr_gather_plain(*main_args), 20)
    big_ms = time_ms(torch, lambda: gk.csr_gather_cuda(*big_args), 20)
    # the same launches with the wrapper's host cost hidden: the kernel's
    # own device time
    queued = queued_ms(torch, lambda: gk.csr_gather_cuda(*main_args))
    big_queued = queued_ms(torch, lambda: gk.csr_gather_cuda(*big_args), 20)
    lib_name, lib_fn, lib_out, tried = library_gather(torch, main_args)
    lib = time_ms(torch, lib_fn, 20) if lib_fn is not None else None
    k = gk.csr_gather_cuda(*main_args)
    lib_equal = bool(torch.equal(lib_out, k)) if lib_out is not None else None
    # bytes the function must move: offsets, the batch's entries (index +
    # value), the used ids, the [N, U] f32 output
    t_bound, by = bound_ms(4 * (n_rows + 1) + 8 * b_nnz + 4 * n_used
                           + 4 * n_rows * n_used, 0)
    big_rows, big_nnz = big_args[0].shape[0] - 1, int(big_args[0][-1])
    row = dict(name="csr_gather", route="cuda",
               source="mmlspark_tpu_torch/csrc/csr_gather.cu",
               replaces="mmlspark_tpu/gbdt/pallas_sparse.py:151",
               max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=t_bound,
               bound_by=by, library_ms=lib, device_only_ms=queued,
               library_call=lib_name,
               library_equal=lib_equal, library_refused=tried,
               shape=dict(rows=n_rows, used=n_used, nnz=b_nnz,
                          nnz_staged=main_args[1].shape[0], width=width),
               all_rows=dict(rows=big_rows, nnz=big_nnz, ms=big_ms,
                             device_only_ms=big_queued,
                             bound_ms=bound_ms(4 * (big_rows + 1) + 8 * big_nnz
                                               + 4 * n_used
                                               + 4 * big_rows * n_used, 0)[0]))
    log(dict(phase="kernels", **row))
    return row


def _raw(df) -> np.ndarray:
    return np.stack(list(df.column("rawPrediction")))


def fused_sparse(torch, model, rows, smi) -> int:
    """The fused CSR scoring path over the sparse rows; returns K3's
    launches in it."""
    from mmlspark_tpu_torch.core import fusion
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.gbdt import gather_kernel as gk

    label = "LightGBMClassificationModel"
    df = DataFrame.from_dict({"features": rows})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unfused = _raw(model.transform(df))
    unfused_s = time.perf_counter() - t0
    fused = PipelineModel([model]).fuse()
    fused.set_tuning(layout={label: "csr"},
                     kernel_variants={label: {"*": "forest.csr"}})
    staging = [0.0]
    orig = fusion._csr_from_rows

    def timed_csr_from_rows(col, width):
        t = time.perf_counter()
        try:
            return orig(col, width)
        finally:
            staging[0] += time.perf_counter() - t

    fusion._csr_from_rows = timed_csr_from_rows
    try:
        gk.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scored = fused.transform(df)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        launches = gk.launches
    finally:
        fusion._csr_from_rows = orig
    st = fused.fusion_stats()
    seg = st["per_segment"].get(label, {})
    raw = _raw(scored)
    diff = float(np.abs(raw - unfused).max())
    variants = {}
    for vid in ("forest.gather", "forest.gemm", "forest.csr"):
        fused.set_tuning(kernel_variants={label: {"*": vid}})
        t0 = time.perf_counter()
        out = _raw(fused.transform(df))
        torch.cuda.synchronize()
        variants[vid] = {"seconds": time.perf_counter() - t0,
                         "bitwise_vs_first_run": bool(np.array_equal(out, raw))}
    log({"phase": "fused_sparse", "card": smi, "rows": len(rows),
         "fused_seconds": fused_s, "unfused_seconds": unfused_s,
         "host_csr_from_rows_seconds": staging[0],
         "host_csr_from_rows_share": staging[0] / fused_s,
         "k3_launches": launches, "max_abs_diff_vs_unfused": diff,
         "fallbacks": st["fallbacks"], "ring": seg,
         "compile_cache": st["compile_cache"],
         "segment_costs": st["segment_costs"], "variants": variants})
    if st["fallbacks"]:
        fail(f"fused sparse transform fell back: {st['fallbacks']}")
    if seg.get("csr_batches") != N_SCORE // 256 or "densifies" in seg:
        fail(f"expected {N_SCORE // 256} CSR batches and no densify, got {seg}")
    if launches != N_SCORE // 256:
        fail(f"K3 launched {launches} times in the fused sparse transform")
    if diff > 1e-6:
        fail(f"fused CSR scores differ from the unfused transform by {diff}")
    bad = [v for v, r in variants.items() if not r["bitwise_vs_first_run"]]
    if bad:
        fail(f"forest variants {bad} differ from forest.csr")
    return launches


def fused_dense(torch, model, X, smi) -> None:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel

    df = DataFrame.from_dict({"features": X})
    cols = ("rawPrediction", "probability", "prediction")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unfused = model.transform(df)
    unfused_s = time.perf_counter() - t0
    fused = PipelineModel([model]).fuse()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fused.transform(df)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    st = fused.fusion_stats()
    same = {c: bool(np.array_equal(np.stack(list(unfused.column(c))),
                                   np.stack(list(out.column(c))))) for c in cols}
    log({"phase": "fused_dense", "card": smi, "rows": len(X),
         "fused_seconds": fused_s, "unfused_seconds": unfused_s,
         "bitwise": same, "fallbacks": st["fallbacks"],
         "ring": st["per_segment"].get("LightGBMClassificationModel"),
         "compile_cache": st["compile_cache"]})
    if st["fallbacks"] or not all(same.values()):
        fail(f"fused dense scores are not the unfused ones bit for bit: {same}, "
             f"fallbacks {st['fallbacks']}")


def fused_anchor(torch, booster, csr, n: int = 8192) -> None:
    """At the anchor's 2^12 width, the CSR-staged fused output against the
    same rows sent as dense arrays (2^18 cannot be densified: 68 GB)."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.gbdt import LightGBMClassificationModel

    indptr, idx, vals = csr
    width = 1 << 12
    rows = np.empty(n, dtype=object)
    dense = np.zeros((n, width), dtype=np.float32)
    for i in range(n):
        a, b = indptr[i], indptr[i + 1]
        rows[i] = {"indices": idx[a:b], "values": vals[a:b], "size": width}
        dense[i, idx[a:b]] = vals[a:b]
    label = "LightGBMClassificationModel"
    fused = PipelineModel([LightGBMClassificationModel(booster=booster)]).fuse()
    fused.set_tuning(layout={label: "csr"},
                     kernel_variants={label: {"*": "forest.csr"}})
    via_csr = fused.transform(DataFrame.from_dict({"features": rows}))
    seg = fused.fusion_stats()["per_segment"][label]
    via_dense = fused.transform(DataFrame.from_dict({"features": dense}))
    same = {c: bool(np.array_equal(np.stack(list(via_csr.column(c))),
                                   np.stack(list(via_dense.column(c)))))
            for c in ("rawPrediction", "probability", "prediction")}
    log({"phase": "fused_anchor", "rows": n, "width": width,
         "csr_batches": seg.get("csr_batches"), "bitwise": same})
    if seg.get("csr_batches") != n // 256 or not all(same.values()):
        fail(f"anchor: CSR-staged and dense fused outputs differ: {same}, {seg}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile the main-path fit with torch.profiler")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mmlspark_tpu_torch  # noqa: F401  (fails outside a checkout)

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on; the forest sums need full f32")
    t_start = time.perf_counter()
    hdr = header(torch)
    smi = hdr["smi"].splitlines()[0]
    kernels = kernel_phase(torch)
    launches, dense_model, X_score = main_path(torch, args.profile)
    data = sparse_data()
    kernels["sparse_hist"] = sparse_kernel_phase(torch, data)
    launches["sparse_hist"], sparse_model = sparse_main_path(torch, data)
    rows = data["rows"][:N_SCORE]
    del data
    anchor = sparse_anchor(torch)
    kernels["csr_gather"] = gather_kernel_phase(torch, sparse_model, rows)
    launches["csr_gather"] = fused_sparse(torch, sparse_model, rows, smi)
    fused_dense(torch, dense_model, X_score, smi)
    fused_anchor(torch, *anchor)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for name in ("hist", "select", "csr_gather", "sparse_hist"):
        row = dict(kernels[name], launches=launches[name])
        rows.append({k: row[k] for k in keys})
    log({"phase": "done", "seconds": time.perf_counter() - t_start})
    log(smi)
    log({"kernels": rows})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
