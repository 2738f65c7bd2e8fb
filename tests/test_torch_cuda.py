"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped on a host without CUDA. This file imports neither JAX nor the
reference package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.gbdt import (gather_kernel, hist_kernel, select_kernel,
                                     sparse_hist_kernel)
from mmlspark_tpu_torch.models import flash_kernel
from mmlspark_tpu_torch.parallel import ingest


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(n, f, b, density, device, seed=0):
    rng = np.random.default_rng(seed)
    arrays = (rng.integers(0, b, (f, n)).astype(np.int32),
              rng.standard_normal(n).astype(np.float32),
              rng.random(n).astype(np.float32), rng.random(n) < density)
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b", [(100_003, 28, 256), (1537, 65, 17),
                                   (1537, 3, 4000), (1, 65, 2)])
def test_hist_kernel_matches_plain(cuda_device, n, f, b):
    bins, grad, hess, mask = _inputs(n, f, b, 0.6, cuda_device)
    k = hist_kernel.histogram_cuda(bins, grad, hess, mask, b)
    p = hist_kernel.histogram_plain(bins, grad, hess, mask, b)
    scale = hist_kernel.histogram_plain(bins, grad.abs(), hess.abs(), mask, b)
    assert torch.equal(k[..., 2], p[..., 2])
    # both accumulate in f64 and round once: equal up to a rounding tie
    assert bool(((k - p).abs() <= 1e-5 * scale + 1e-6).all())


def _assert_hist_close(k, p, scale):
    assert torch.equal(k[..., 2], p[..., 2])
    assert bool(((k - p).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 3])
def test_hist_kernel_contended_bins(cuda_device, levels):
    """Every row of a feature in one bin, or in three (the b-tags of
    HIGGS-shaped data): the warps aggregate lanes that share a bin; F = 28
    and B = 256 take one block's shared memory."""
    n, f, b = 300_001, 28, 256
    bins, grad, hess, mask = _inputs(n, f, b, 0.7, cuda_device, seed=4)
    bins[::3] = torch.randint(0, levels, (len(range(0, f, 3)), n),
                              dtype=torch.int32, device=cuda_device)
    assert hist_kernel.launch_geometry(n, f, b).groups == 1
    k = hist_kernel.histogram_cuda(bins, grad, hess, mask, b)
    _assert_hist_close(k, hist_kernel.histogram_plain(bins, grad, hess, mask, b),
                       hist_kernel.histogram_plain(bins, grad.abs(), hess.abs(),
                                                   mask, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,b,offset", [(100_003, 28, 2048, 0),
                                          (100_003, 28, 2049, 0),
                                          (20_001, 3, 20_000, 0),
                                          (70_001, 5, 256, 1),
                                          (70_002, 7, 17, 3)])
def test_hist_kernel_wide_bins_and_ragged_rows(cuda_device, n, f, b, offset):
    """B = 2048 and 2049 (fewer features a block), 20,000 (the global
    path), and N not a multiple of 4 with grad, hess and the mask starting
    ``offset`` values into their buffers (no 16-byte loads there)."""
    bins, grad, hess, mask = _inputs(n + offset, f, b, 0.5, cuda_device, seed=5)
    bins = bins[:, offset:].contiguous()
    grad, hess, mask = grad[offset:], hess[offset:], mask[offset:]
    assert grad.is_contiguous() and (offset == 0 or grad.data_ptr() % 16)
    k = hist_kernel.histogram_cuda(bins, grad, hess, mask, b)
    _assert_hist_close(k, hist_kernel.histogram_plain(bins, grad, hess, mask, b),
                       hist_kernel.histogram_plain(bins, grad.abs(), hess.abs(),
                                                   mask, b))


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_select_kernel_bitwise_matches_plain(cuda_device, density):
    bins, grad, hess, mask = _inputs(300_001, 28, 256, density, cuda_device)
    cap = 300_032
    a = select_kernel.select_rows_cuda(bins, grad, hess, mask, cap)
    b = select_kernel.select_rows_plain(bins, grad, hess, mask, cap)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,density,cap", [
    (300_001, 28, 0.5, None),      # count exactly cap: no zero tail
    (5_001, 28, 0.0, 4_096),       # count 0, n not a multiple of a chunk
    (100_003, 1, 0.4, 100_352),    # one feature
    (100_003, 65, 0.4, 100_352),   # more features than warps, unevenly
    (2_500_000, 3, 0.7, 2_500_000)])  # row blocks of more than one chunk
def test_select_kernel_edges_bitwise_match_plain(cuda_device, n, f, density,
                                                 cap):
    bins, grad, hess, mask = _inputs(n, f, 256, density, cuda_device, seed=2)
    if cap is None:
        cap = int(mask.sum())
    a = select_kernel.select_rows_cuda(bins, grad, hess, mask, cap)
    b = select_kernel.select_rows_plain(bins, grad, hess, mask, cap)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _sparse_hist_inputs(nnz, tb, empty_every, device, seed=0):
    """Bin-sorted entries over ``tb`` skewed bins (every ``empty_every``-th
    empty), stats masked at 50%: [3, nnz] f32 and the int32 bin ends."""
    rng = np.random.default_rng(seed)
    weights = rng.random(tb) ** 4 + 1e-4
    if empty_every:
        weights[::empty_every] = 0.0
    ids = np.sort(rng.choice(tb, size=nnz, p=weights / weights.sum()))
    bin_end = np.searchsorted(ids, np.arange(tb), side="right").astype(np.int32)
    m = (rng.random(nnz) < 0.5).astype(np.float32)
    data = np.stack([rng.standard_normal(nnz) * m, (rng.random(nnz) + 0.1) * m, m])
    return (torch.from_numpy(data.astype(np.float32)).to(device),
            torch.from_numpy(bin_end).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("nnz,tb,empty", [(1_000_003, 50_001, 0), (1, 1, 0),
                                          (0, 5, 0), (70_000, 1, 0),
                                          (123_457, 7_777, 3), (2049, 4000, 2)])
def test_sparse_hist_kernel_matches_plain(cuda_device, nnz, tb, empty):
    data, bin_end = _sparse_hist_inputs(nnz, tb, empty, cuda_device)
    k = sparse_hist_kernel.sparse_histogram_cuda(data, bin_end)
    p = sparse_hist_kernel.sparse_histogram_plain(data, bin_end)
    scale = sparse_hist_kernel.sparse_histogram_plain(data.abs(), bin_end)
    assert k.shape == (3, tb)
    assert torch.equal(k[2], p[2])
    # both accumulate in f64 and round once: equal up to a rounding tie
    assert bool(((k - p).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nnz,tb,empty", [(2_000_003, 60_001, 0),
                                          (1_000_000, 1, 0), (5_000, 90_000, 0)])
def test_sparse_hist_kernel_bitwise_from_call_to_call(cuda_device, nnz, tb,
                                                      empty):
    """K4 sums every bin in one fixed order: repeated calls agree bit for
    bit, a single bin of 10^6 entries included, and more bins than entries
    (tiles cut short at their staged bin ends)."""
    data, bin_end = _sparse_hist_inputs(nnz, tb, empty, cuda_device, seed=7)
    first = sparse_hist_kernel.sparse_histogram_cuda(data, bin_end)
    for _ in range(3):
        assert torch.equal(sparse_hist_kernel.sparse_histogram_cuda(data, bin_end),
                           first)
    p = sparse_hist_kernel.sparse_histogram_plain(data, bin_end)
    scale = sparse_hist_kernel.sparse_histogram_plain(data.abs(), bin_end)
    assert torch.equal(first[2], p[2])
    assert bool(((first - p).abs() <= 1e-5 * scale + 1e-6).all())


def _csr_batch(rows, width, avg_nnz, pad_rows, seed=0):
    """A CSR-staged batch as the fused executor ships it: sorted distinct
    indices per row (some rows empty), values with explicit 0.0, -0.0 and
    NaN, padded rows repeating the last offset, nnz zero-padded to a power
    of two."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(avg_nnz, rows)
    counts[::7] = 0
    idx = [np.sort(rng.choice(width, min(c, width), replace=False)) for c in counts]
    indptr = np.concatenate([[0], np.cumsum([len(i) for i in idx])]).astype(np.int32)
    indices = np.concatenate(idx + [np.zeros(0, np.int64)]).astype(np.int32)
    values = rng.integers(1, 5, len(indices)).astype(np.float32)
    values[::11] = 0.0
    values[1::13] = -0.0
    values[2::17] = np.nan
    nnz = len(indices)
    pad = (1 << max(nnz, 1).bit_length()) - nnz
    indptr = np.concatenate([indptr, np.full(pad_rows, indptr[-1], np.int32)])
    return [indptr, np.pad(indices, (0, pad)), np.pad(values, (0, pad))]


def _used_ids(kind, width, seed=1):
    rng = np.random.default_rng(seed)
    forest = np.sort(rng.choice(width, min(300, width), replace=False))
    if kind == "shuffled":   # no order, duplicates, ids past the width
        return rng.permutation(np.concatenate(
            [forest, forest[::7], [width - 1, width, width + 9]])).astype(np.int32)
    if kind == "30k":        # a forest of ~1,000 trees
        return np.sort(rng.choice(width, 30_000, replace=False)).astype(np.int32)
    return {"forest": forest, "clamped": np.array([0, 7, width - 1, width, width + 9]),
            "one": np.array([0])}[kind].astype(np.int32)


def _gather_pair(device, rows, width, avg, pad_rows, used):
    arrays = _csr_batch(rows, width, avg, pad_rows)
    t = [torch.from_numpy(a).to(device) for a in arrays + [_used_ids(used, width)]]
    return t[0], t[1], t[2], width, t[3]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width,avg,pad_rows,used", [
    (256, 1 << 18, 50, 0, "forest"), (200, 1 << 12, 40, 56, "forest"),
    (65_536, 1 << 18, 50, 0, "forest"), (33, 100, 5, 0, "clamped"),
    (9, 50, 3, 0, "one"), (16, 40, 0, 0, "forest"),
    (256, 1 << 18, 50, 0, "shuffled"), (65_536, 1 << 18, 50, 0, "shuffled"),
    (64, 1 << 12, 3000, 0, "forest"), (16_384, 1 << 12, 600, 0, "shuffled"),
    (256, 1 << 18, 50, 0, "30k"), (1, 1 << 18, 50, 0, "forest")])
def test_csr_gather_kernel_bitwise_matches_plain(cuda_device, rows, width, avg,
                                                 pad_rows, used):
    # rows of 600 and 3,000 entries are longer than a warp's window
    # (STAGE_ENTRIES); 30,000 used ids span 30 blocks' chunks
    args = _gather_pair(cuda_device, rows, width, avg, pad_rows, used)
    k = gather_kernel.csr_gather_cuda(*args)
    p = gather_kernel.csr_gather_plain(*args)
    torch.cuda.synchronize()
    assert k.shape == (rows + pad_rows, args[4].shape[0])
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rpw", [1, 2, 5, 31])
def test_csr_gather_kernel_any_geometry(cuda_device, monkeypatch, rpw):
    # every tile the C entry point takes gives the same bits, not only
    # launch_geometry's choice: up to 31 rows a warp
    monkeypatch.setattr(gather_kernel, "launch_geometry",
                        lambda n, u: (rpw, None, None))
    for case in [(4_099, 1 << 18, 50, 3, "shuffled"), (700, 1 << 12, 300, 0, "forest")]:
        args = _gather_pair(cuda_device, *case)
        k = gather_kernel.csr_gather_cuda(*args)
        p = gather_kernel.csr_gather_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(k.view(torch.int32), p.view(torch.int32))


@pytest.mark.cuda
def test_csr_gather_kernel_bitwise_from_call_to_call(cuda_device):
    args = _gather_pair(cuda_device, 65_536, 1 << 18, 50, 0, "shuffled")
    first = gather_kernel.csr_gather_cuda(*args)
    second = gather_kernel.csr_gather_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def _bf16(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device).to(torch.bfloat16)


def _attention_f64(q, k, v, causal):
    """Exact attention in f64 from the same bf16 [B, T, H, D] inputs (with
    |v|: each output element's scale, sum_j p_j |v_j|)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / q.shape[-1] ** 0.5
    if causal:
        t = q.shape[1]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool, device=s.device)
                          .triu(1), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.double())


def _assert_k5_close(o, p, q, k, v, causal):
    """The bounds chip_smoke.py holds K5 to: within the reference's 0.05 of
    its plain version and, per element, within 4 bf16 ulps of the scale
    sum_j p_j |v_j|; its max and rms error against exact f64 attention no
    more than 1.5x the plain version's."""
    exact = _attention_f64(q, k, v, causal)
    _, e = torch.frexp(_attention_f64(q, k, v.abs(), causal).float())
    o, p = o.float(), p.float()
    assert (o - p).abs().max().item() <= 0.05
    ulps = (o - p).abs() / torch.ldexp(torch.ones_like(o), e - 8)
    assert ulps.max().item() <= 4.0
    k5_err, plain_err = o.double() - exact, p.double() - exact
    assert k5_err.abs().max() <= 1.5 * plain_err.abs().max()
    assert k5_err.square().mean() <= 1.5 ** 2 * plain_err.square().mean()


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,causal", [
    (2, 256, 256, 4, 64, False), (2, 256, 256, 4, 64, True),
    (1, 1024, 1024, 2, 128, False), (1, 1024, 1024, 2, 128, True),
    (1, 512, 512, 2, 256, True), (3, 128, 256, 1, 64, False),
    (1, 64, 64, 1, 256, False), (1, 256, 256, 2, 384, False),
    (1, 256, 256, 2, 512, True), (1, 256, 256, 2, 640, False),
    (1, 256, 256, 2, 640, True), (1, 256, 256, 1, 768, True),
    (2, 128, 256, 1, 1024, False), (1, 192, 192, 1, 1024, True)])
def test_flash_kernel_matches_plain(cuda_device, b, tq, tk, h, d, causal):
    """K5 against its plain version and exact f64 attention on bf16
    normal(0, 1) inputs (``_assert_k5_close``), above D = 512 through the
    general path (Q and K streamed in 64-column chunks, 128-column output
    slices), ragged lengths and Tq != Tk included; two calls give the same
    bits."""
    rng = np.random.default_rng(3)
    q = _bf16(rng, (b, tq, h, d), cuda_device)
    k, v = (_bf16(rng, (b, tk, h, d), cuda_device) for _ in range(2))
    o = flash_kernel.flash_attention_cuda(q, k, v, causal)
    again = flash_kernel.flash_attention_cuda(q, k, v, causal)
    p = flash_kernel.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert o.shape == p.shape and o.dtype == torch.bfloat16
    assert torch.equal(o, again)
    _assert_k5_close(o, p, q, k, v, causal)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda_device):
    """q, k, v as views into one packed [B, T, 3, H, D] tensor: the kernel
    reads them through their strides, no copies."""
    rng = np.random.default_rng(4)
    qkv = _bf16(rng, (2, 256, 3, 4, 64), cuda_device)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    o = flash_kernel.flash_attention_cuda(q, k, v, True)
    p = flash_kernel.flash_attention_plain(q.contiguous(), k.contiguous(),
                                           v.contiguous(), True)
    torch.cuda.synchronize()
    _assert_k5_close(o, p, q, k, v, True)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,causal", [
    (1, 192, 320, 2, 64, False), (1, 320, 320, 2, 64, True),
    (2, 192, 192, 2, 64, True), (1, 320, 192, 2, 128, False),
    (1, 192, 192, 2, 128, True), (1, 192, 320, 1, 256, False),
    (1, 320, 320, 1, 256, True), (1, 192, 320, 2, 384, False),
    (1, 320, 320, 1, 512, True)])
def test_flash_kernel_ragged_tiles(cuda_device, b, tq, tk, h, d, causal):
    """Tq and Tk multiples of 64 but not of the kernel's query tile (192
    rows at D = 64, 128 above) or key tile (128 keys at D <= 128):
    zero-filled loads, keys past Tk masked, rows past Tq not stored, and at
    D = 384 and 512 the two column halves (``_assert_k5_close``)."""
    rng = np.random.default_rng(5)
    q = _bf16(rng, (b, tq, h, d), cuda_device)
    k, v = (_bf16(rng, (b, tk, h, d), cuda_device) for _ in range(2))
    o = flash_kernel.flash_attention_cuda(q, k, v, causal)
    p = flash_kernel.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert o.shape == p.shape
    _assert_k5_close(o, p, q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_reads_strided_views_d128(cuda_device, causal):
    """D = 128 (two TMA boxes per row) on views into one packed
    [B, T, 3, H, D] tensor, and an output in the right place when the
    views start mid-allocation."""
    rng = np.random.default_rng(6)
    qkv = _bf16(rng, (2, 320, 3, 3, 128), cuda_device)
    q, k, v = qkv.unbind(2)
    o = flash_kernel.flash_attention_cuda(q, k, v, causal)
    p = flash_kernel.flash_attention_plain(q.contiguous(), k.contiguous(),
                                           v.contiguous(), causal)
    torch.cuda.synchronize()
    _assert_k5_close(o, p, q, k, v, causal)


@pytest.mark.cuda
def test_flash_kernel_batch_past_grid_z_cap(cuda_device):
    """B = 65,537 > 65,535 (grid.z's cap): the batch rides the 1-D grid;
    the first and last rows are held to the plain version."""
    rng = np.random.default_rng(8)
    q, k, v = (_bf16(rng, (65_537, 128, 1, 64), cuda_device) for _ in range(3))
    o = flash_kernel.flash_attention_cuda(q, k, v)
    for sl in (slice(0, 16), slice(65_521, 65_537)):
        p = flash_kernel.flash_attention_plain(q[sl], k[sl], v[sl])
        torch.cuda.synchronize()
        _assert_k5_close(o[sl], p, q[sl], k[sl], v[sl], False)


def _attention_vjp_f64(q, k, v, do, causal):
    """Exact attention's (dq, dk, dv) in f64 from the same bf16 inputs."""
    leaves = [x.double().requires_grad_(True) for x in (q, k, v)]
    with torch.enable_grad():
        _attention_f64(*leaves, causal).backward(do.double())
    return [x.grad for x in leaves]


def _assert_bwd_close(got, plain, q, k, v, do, causal):
    """The bound chip_smoke.py holds K6/K7 to: per gradient, the max and
    rms error against an exact f64 backward of the same inputs no more than
    1.5x the plain backward's (``F64_RATIO_MAX``, as for K5)."""
    exact = _attention_vjp_f64(q, k, v, do, causal)
    for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
        assert g.dtype == torch.bfloat16 and g.shape == p.shape, name
        assert bool(torch.isfinite(g).all()), name
        ge, pe = g.double() - e, p.double() - e
        assert ge.abs().max() <= 1.5 * pe.abs().max(), name
        assert ge.square().mean() <= 1.5 ** 2 * pe.square().mean(), name


def _bwd_inputs(rng, b, tq, tk, h, d, device):
    q, do = (_bf16(rng, (b, tq, h, d), device) for _ in range(2))
    k, v = (_bf16(rng, (b, tk, h, d), device) for _ in range(2))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,causal", [
    (2, 256, 256, 4, 64, False), (2, 256, 256, 4, 64, True),
    (1, 192, 320, 2, 64, False), (1, 512, 512, 2, 128, False),
    (1, 512, 512, 2, 128, True), (1, 320, 128, 2, 128, False),
    (1, 256, 256, 2, 256, False), (1, 256, 256, 2, 256, True),
    (1, 128, 384, 1, 256, False), (1, 256, 256, 2, 384, False),
    (1, 256, 256, 2, 384, True), (1, 256, 256, 1, 512, False),
    (1, 256, 256, 2, 512, True), (1, 256, 256, 1, 640, False),
    (1, 256, 256, 1, 640, True)])
def test_flash_bwd_kernels_match_plain(cuda_device, b, tq, tk, h, d, causal):
    """K6 and K7 against the plain backward on K5's own output and lse,
    and both against an exact f64 backward (``_assert_bwd_close``); two
    calls give the same bits (no atomics), from D = 384 up through the
    128-column slices too."""
    rng = np.random.default_rng(21)
    q, k, v, do = _bwd_inputs(rng, b, tq, tk, h, d, cuda_device)
    o, lse = flash_kernel.flash_attention_cuda(q, k, v, causal, lse=True)
    got = flash_kernel.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    again = flash_kernel.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    plain = flash_kernel.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _assert_bwd_close(got, plain, q, k, v, do, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,causal", [
    (1, 192, 192, 2, 64, True), (1, 320, 320, 1, 128, True),
    (1, 192, 192, 2, 128, False), (1, 192, 192, 1, 256, True),
    (1, 320, 320, 2, 256, True), (1, 192, 320, 2, 256, False),
    (2, 320, 128, 1, 256, False), (1, 192, 192, 1, 384, True),
    (1, 192, 320, 1, 512, False), (1, 320, 320, 1, 640, True)])
def test_flash_bwd_kernels_ragged_tiles_and_no_column_split(cuda_device, b, tq,
                                                            tk, h, d, causal):
    """Lengths a multiple of 64 but not of the 128-row tiles (K6's second
    warpgroup past Tk, K7's past Tq: zero-filled rows that must add
    exactly 0), causal and not, and D = 256 through the design without a
    column split (K6's two warpgroups share a 64-key tile and hand P over;
    K7 holds all 256 columns of dQ), Tq != Tk included; from D = 384 up the
    same edges through the 128-column slices: against the plain backward
    and f64, two calls bit for bit."""
    rng = np.random.default_rng(27)
    q, k, v, do = _bwd_inputs(rng, b, tq, tk, h, d, cuda_device)
    o, lse = flash_kernel.flash_attention_cuda(q, k, v, causal, lse=True)
    got = flash_kernel.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    again = flash_kernel.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    plain = flash_kernel.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _assert_bwd_close(got, plain, q, k, v, do, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256, 384, 512, 640])
def test_flash_bwd_kernels_read_strided_views(cuda_device, d):
    """q, k, v and dO as views into packed tensors: K6 and K7 read them
    through their strides."""
    rng = np.random.default_rng(22)
    qkv = _bf16(rng, (2, 256, 3, 2, d), cuda_device)
    q, k, v = qkv.unbind(2)
    do = _bf16(rng, (2, 256, 2, 2, d), cuda_device)[:, :, 1]
    assert not q.is_contiguous() and not do.is_contiguous()
    o, lse = flash_kernel.flash_attention_cuda(q, k, v, True, lse=True)
    got = flash_kernel.flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    plain = flash_kernel.flash_attention_bwd_plain(
        *(x.contiguous() for x in (q, k, v, o)), lse, do.contiguous(), True)
    torch.cuda.synchronize()
    _assert_bwd_close(got, plain, q, k, v, do, True)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,causal", [
    (2, 256, 256, 2, 64, True), (1, 192, 320, 2, 128, False),
    (1, 256, 256, 1, 256, True), (1, 256, 256, 2, 384, False),
    (1, 192, 192, 1, 512, True), (1, 256, 256, 2, 640, True),
    (1, 192, 320, 1, 1024, False)])
def test_k5_lse_matches_plain_and_leaves_the_output(cuda_device, b, tq, tk, h,
                                                    d, causal):
    """K5's row log-sum-exp against the plain version's (1e-4: both f32,
    the kernel's exp2/log2 approximations and summation order), written
    once per row at D = 384/512 and above 512 (by the first column slice's
    CTA); with and without it the same output bits."""
    rng = np.random.default_rng(23)
    q = _bf16(rng, (b, tq, h, d), cuda_device)
    k, v = (_bf16(rng, (b, tk, h, d), cuda_device) for _ in range(2))
    o, lse = flash_kernel.flash_attention_cuda(q, k, v, causal, lse=True)
    o2 = flash_kernel.flash_attention_cuda(q, k, v, causal)
    _, want = flash_kernel.flash_attention_plain(q, k, v, causal,
                                                 return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2)
    assert lse.shape == (b, h, tq) and lse.dtype == torch.float32
    assert (lse - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_grad_through_dense_attention_runs_k6_k7(cuda_device, causal):
    """Under autograd the gate sends the call through FlashAttention: q, k
    and v get gradients (nothing is detached), K5, K6 and K7 launch once
    each, and the gradients hold the f64 gate against the plain
    backward."""
    from mmlspark_tpu_torch.models import attention

    rng = np.random.default_rng(24)
    q, k, v, do = _bwd_inputs(rng, 2, 256, 256, 4, 64, cuda_device)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (flash_kernel.launches, flash_kernel.bwd_dkv_launches,
              flash_kernel.bwd_dq_launches)
    o = attention.dense_attention(*leaves, causal=causal)
    assert o.requires_grad
    o.backward(do)
    after = (flash_kernel.launches, flash_kernel.bwd_dkv_launches,
             flash_kernel.bwd_dq_launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    got = [x.grad for x in leaves]
    assert all(g is not None for g in got)
    o2, lse = flash_kernel.flash_attention_cuda(q, k, v, causal, lse=True)
    plain = flash_kernel.flash_attention_bwd_plain(q, k, v, o2, lse, do, causal)
    torch.cuda.synchronize()
    _assert_bwd_close(got, plain, q, k, v, do, causal)


@pytest.mark.cuda
def test_k5_refuses_inputs_that_require_grad(cuda_device):
    """The repair: a bare K5 launch on inputs that require grad, with grad
    enabled, raises instead of returning an output autograd cannot
    differentiate; under no_grad it launches."""
    rng = np.random.default_rng(25)
    q, k, v = (_bf16(rng, (1, 128, 2, 64), cuda_device) for _ in range(3))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="FlashAttention"):
        flash_kernel.flash_attention_cuda(q, k, v)
    with torch.no_grad():
        o = flash_kernel.flash_attention_cuda(q, k, v)
    assert not o.requires_grad


@pytest.mark.cuda
def test_flash_bwd_rejects_head_dims_it_is_not_built_for(cuda_device):
    """Every head dim the gate admits is one K5-K7 are built for: under
    autograd ``dense_attention`` at D = 384 runs K5, K6 and K7 once each
    (no raise, no plain route) and its gradients hold the f64 gate against
    the plain backward. A head dim the gate does not admit (192) takes the
    plain path under autograd, launching nothing, and the kernels' own
    wrapper refuses it."""
    from mmlspark_tpu_torch.models import attention

    rng = np.random.default_rng(26)
    q, k, v, do = _bwd_inputs(rng, 1, 256, 256, 2, 384, cuda_device)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    counters = ("launches", "bwd_dkv_launches", "bwd_dq_launches")
    before = [getattr(flash_kernel, c) for c in counters]
    attention.dense_attention(*leaves, causal=True).backward(do)
    after = [getattr(flash_kernel, c) for c in counters]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    got = [x.grad for x in leaves]
    o, lse = flash_kernel.flash_attention_cuda(q, k, v, True, lse=True)
    plain = flash_kernel.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    _assert_bwd_close(got, plain, q, k, v, do, True)

    q, k, v, do = _bwd_inputs(rng, 1, 128, 128, 1, 192, cuda_device)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = [getattr(flash_kernel, c) for c in counters]
    attention.dense_attention(*leaves).backward(do)
    assert [getattr(flash_kernel, c) for c in counters] == before
    assert all(x.grad is not None for x in leaves)
    with pytest.raises(ValueError, match="head dim"):
        flash_kernel.flash_attention_cuda(q, k, v)


def _ring_run(device, depth, n_batches=6):
    """TransferRing over ``n_batches`` [64, 512] batches whose step is a
    matmul on the card and whose fetch casts on the readback stream; the
    yielded arrays as they came, and copies taken at yield time."""
    rng = np.random.default_rng(9)
    batches = [rng.standard_normal((64, 512)).astype(np.float32)
               for _ in range(n_batches)]
    w = torch.from_numpy(rng.standard_normal((512, 512)).astype(np.float32)
                         ).to(device)
    ring = ingest.TransferRing(
        iter(batches), put=lambda a: ingest.stage_array(a, device),
        step=lambda x: x @ w, fetch=lambda y: (y.double(), y[:3]), depth=depth,
        device=device)
    seen, at_yield = [], []
    for out in ring:
        seen.append(out)
        at_yield.append(tuple(a.copy() for a in out))
    return seen, at_yield, ring.stats.summary()


@pytest.mark.cuda
def test_ring_readback_stream_keeps_order_and_bits(cuda_device):
    """The readback on its own stream into reused pinned slots: batches in
    order, bitwise the outputs of an unpipelined ring (depth 1), and an
    earlier batch's arrays unchanged after the ring has moved on."""
    seen, at_yield, stats = _ring_run(cuda_device, depth=3)
    serial, _, _ = _ring_run(cuda_device, depth=1)
    assert len(seen) == len(serial) == 6
    for got, want, first in zip(seen, serial, at_yield):
        for a, b, c in zip(got, want, first):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    assert stats["n_batches"] == 6 and stats["readback_s"] > 0


@pytest.mark.cuda
def test_goss_fit_launches_k2_and_grows_the_cpu_first_tree(cuda_device,
                                                          monkeypatch):
    """GOSS at 524,288 rows on the device route (the native engine would
    take a fit this small): the scan selects its rows on the device and K2
    compacts them (and each small child), and the first tree, grown from
    the base score's tied gradients, equals a CPU refit's on the same route
    (the forced scan)."""
    from mmlspark_tpu_torch.gbdt import booster

    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    monkeypatch.setattr(booster, "scan_loop_sync_mode", "error")
    rng = np.random.default_rng(7)
    n = 524_288
    X = rng.standard_normal((n, 8))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + rng.logistic(size=n) > 0)
    params = booster.TrainParams(objective="binary", boosting_type="goss",
                                 num_iterations=2, num_leaves=31)
    select_kernel.launches = 0
    hist_kernel.launches = hist_kernel.count_launches = 0
    card = booster.train(params, X, y.astype(np.float64), device="cuda")
    assert card.route == "scan"
    assert (booster.last_scan_rows == int(n * 0.2) + int(n * 0.1)).all()
    assert select_kernel.launches > 0 and hist_kernel.launches > 0
    assert hist_kernel.count_launches > 0
    monkeypatch.setenv("MMLSPARK_TPU_SCAN_TRAIN", "1")
    cpu = booster.train(params, X, y.astype(np.float64), device="cpu")
    assert cpu.route == "scan"
    a, b = card.trees[0][0], cpu.trees[0][0]
    for fld in ("feature", "threshold_bin", "left", "right", "default_left",
                "count"):
        np.testing.assert_array_equal(getattr(a, fld), getattr(b, fld))
    np.testing.assert_allclose(a.value, b.value, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [[2] * 50 + [1] * 7, [3, 17, 100, 120, 1],
                                   [1251, 700, 64, 200, 5]])
def test_lambdarank_gradient_card_matches_cpu(cuda_device, sizes):
    """LambdaRank's g and h on the card against the CPU on the same f32
    scores, at buckets of 2 to 2,048 (the 2,048 bucket in chunks of 4
    groups): the pairwise sums reduce in another order on each device, so
    within rtol 1e-5 and atol 1e-6."""
    from mmlspark_tpu_torch.gbdt import booster

    rng = np.random.default_rng(len(sizes))
    groups = np.repeat(np.arange(len(sizes)), sizes)
    n = len(groups)
    labels = np.minimum(rng.geometric(0.55, n) - 1, 4).astype(np.float32)
    for scores in (np.zeros(n, np.float32),
                   rng.standard_normal(n).astype(np.float32)):
        out = {}
        for dev in ("cpu", "cuda"):
            seg = booster.segment_groups(groups, dev)
            g, h = booster.grad_hess(
                "lambdarank", torch.from_numpy(scores).to(dev),
                torch.from_numpy(labels).to(dev), group_segments=seg)
            out[dev] = (g.cpu().numpy(), h.cpu().numpy())
        for k in range(2):
            np.testing.assert_allclose(out["cuda"][k], out["cpu"][k],
                                       rtol=1e-5, atol=1e-6)


def _cat_rows(n, seed=0):
    """Seeded rows with three categorical columns (12, 40 and 300 values,
    the last past maxBin) and one numeric, the label set by a per-category
    offset (not monotone in the ids)."""
    rng = np.random.default_rng(seed)
    X = np.empty((n, 4))
    logit = np.full(n, -1.0)
    for j, k in enumerate((12, 40, 300)):
        X[:, j] = rng.integers(0, k, n)
        logit += rng.normal(0, 0.8, k)[X[:, j].astype(np.int64)]
    X[:, 3] = rng.integers(0, 2400, n)
    logit += 0.0008 * (X[:, 3] - 1200)
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    return X, y


def _same_cat_tree(a, b):
    for fld in ("feature", "threshold_bin", "left", "right", "default_left",
                "count"):
        np.testing.assert_array_equal(getattr(a, fld), getattr(b, fld))
    np.testing.assert_array_equal(a.cat_bin_words, b.cat_bin_words)
    for s, t in zip(a.cat_sets, b.cat_sets):
        assert (s is None) == (t is None)
        if s is not None:
            np.testing.assert_array_equal(s, t)
    np.testing.assert_allclose(a.value, b.value, rtol=1e-5)


@pytest.mark.cuda
def test_categorical_fit_card_matches_cpu(cuda_device, monkeypatch):
    """Set splits on the card (K1's two entries and K2 launched), on the
    scan route on both devices: the first 3 trees are the CPU's, words and
    category sets included; leaf values within rtol 1e-5 (``chip_smoke.py``
    gate c at 262,144 rows)."""
    from mmlspark_tpu_torch.gbdt import booster

    monkeypatch.setenv("MMLSPARK_TPU_SCAN_TRAIN", "1")
    X, y = _cat_rows(600_000)
    params = booster.TrainParams(objective="binary", num_iterations=3,
                                 num_leaves=31, categorical_feature=(0, 1, 2))
    hist_kernel.launches = hist_kernel.count_launches = 0
    select_kernel.launches = 0
    card = booster.train(params, X, y, device="cuda")
    assert card.route == "scan"
    assert hist_kernel.launches > 0 and hist_kernel.count_launches > 0
    assert select_kernel.launches > 0
    cpu = booster.train(params, X, y, device="cpu")
    assert cpu.route == "scan"
    assert any(s is not None and len(s) >= 2 for s in card.trees[0][0].cat_sets)
    for gc, gp in zip(card.trees, cpu.trees):
        _same_cat_tree(gc[0], gp[0])


@pytest.mark.cuda
def test_categorical_device_ensemble_matches_host(cuda_device):
    """The card's gather traversal with its membership test against the
    host f64 traversal, NaN and unseen categories included (gate d)."""
    from mmlspark_tpu_torch.gbdt import DeviceEnsemble, booster, predict_ensemble

    X, y = _cat_rows(50_000, seed=1)
    b = booster.train(booster.TrainParams(
        objective="binary", num_iterations=8, num_leaves=15,
        categorical_feature=(0, 1, 2)), X, y, device="cuda")
    assert b.route == "scan"
    Xq = X[:20_000].copy()
    Xq[::9, 1] = np.nan
    Xq[::7, 2] = 512.0
    ens = DeviceEnsemble(b.trees, 1, device="cuda")
    assert ens.cat_vals is not None and not ens.cat_host_fallback
    np.testing.assert_allclose(ens.predict_raw(Xq.astype(np.float32)),
                               predict_ensemble(b.trees, Xq, 1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_checkpoint_resume_on_card_is_identical(cuda_device, tmp_path):
    """A card fit with bagging, preempted at its 6th iteration and resumed
    from the checkpoint of iteration 3 (its Kahan score pair restored),
    gives the uninterrupted card fit's model string (gate i)."""
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.gbdt import CheckpointConfig, booster

    X, y = _cat_rows(100_000, seed=2)
    params = booster.TrainParams(
        objective="binary", num_iterations=9, num_leaves=31,
        bagging_fraction=0.8, bagging_freq=1, seed=7,
        categorical_feature=(0, 1, 2))
    full = booster.train(params, X, y, device="cuda", checkpoint=CheckpointConfig(
        str(tmp_path / "full.ckpt"), every_k=3))
    assert full.route == "fused"
    calls = [0]

    def preempt(point, **ctx):
        if point == faults.TRAIN_STEP:
            calls[0] += 1
            if calls[0] == 6:
                raise faults.InjectedFault("preempted")

    ckpt = str(tmp_path / "cut.ckpt")
    prev = faults.install(preempt)
    try:
        with pytest.raises(faults.InjectedFault):
            booster.train(params, X, y, device="cuda",
                          checkpoint=CheckpointConfig(ckpt, every_k=3))
    finally:
        faults.install(prev)
    resumed = booster.train(params, X, y, device="cuda",
                            checkpoint=CheckpointConfig(ckpt, every_k=3))
    assert resumed.to_string() == full.to_string()


@pytest.mark.cuda
@pytest.mark.parametrize("count", [0, 1, 511, 512, "cap"])
def test_hist_count_entry_matches_plain(cuda_device, count):
    """K1's device-count entry on a K2-sized buffer (1,048,576 rows, the
    tiers of a 2,097,152-row fit): the count channel exact and grad/hess
    within 1e-5 of the bin's |v| sum against ``histogram_plain`` over the
    rows before the count, and bit for bit a mask launch sized for the
    tier that holds the count (the per-split grower's launch)."""
    from mmlspark_tpu_torch.gbdt import tree

    n = 1_048_576
    caps = tree.tier_caps(2 * n, True)
    c = n if count == "cap" else count
    bins, grad, hess, _ = _inputs(n, 28, 256, 1.0, cuda_device)
    cnt = torch.tensor([c], dtype=torch.int32, device=cuda_device)
    valid = torch.arange(n, device=cuda_device) < c
    k = hist_kernel.histogram_count_cuda(bins, grad, hess, cnt, 256, caps)
    p = hist_kernel.histogram_plain(bins, grad, hess, valid, 256)
    _assert_hist_close(k, p, hist_kernel.histogram_plain(
        bins, grad.abs(), hess.abs(), valid, 256))
    tidx = tree.pick_tier(caps, c)
    w = caps[tidx - 1] if tidx else n
    m = hist_kernel.histogram_cuda(bins[:, :w].contiguous(), grad[:w],
                                   hess[:w], valid[:w], 256)
    assert torch.equal(k, m)


def _grower_inputs(device, n=524_288, f=12, seed=5):
    from mmlspark_tpu_torch.gbdt import binning

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    X[:, 3] = rng.choice([0.0, 1.1, 2.2], n)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + rng.logistic(size=n) > 0)
    mapper = binning.BinMapper.fit(X, 255)
    p = 1 / (1 + np.exp(-0.3 * X[:, 3]))
    arrays = (mapper.transform_fm(X, dtype=np.int32),
              (p - y).astype(np.float32),
              np.maximum(p * (1 - p), 1e-16).astype(np.float32),
              rng.random(n) < 0.9)
    return mapper, [torch.from_numpy(a).to(device) for a in arrays]


_TREE_FIELDS = ("feature", "threshold_bin", "left", "right", "default_left",
                "count", "gain", "value", "threshold")


@pytest.mark.cuda
def test_fused_grower_matches_per_split_grower_on_card(cuda_device,
                                                       monkeypatch):
    """The device-resident grower (K2 into the widest tier, K1's
    device-count entry) against the per-split host grower (K2 into the
    tier the host picks, K1's mask entry) on the card: the same tree and
    rows, gains and sums bit for bit."""
    from mmlspark_tpu_torch.gbdt import tree

    mapper, (bins, g, h, m) = _grower_inputs(cuda_device)
    cfg = tree.GrowerConfig(num_leaves=31)
    fused, frows = tree.grow_tree(bins, g, h, m, mapper.max_num_bins, cfg,
                                  mapper)
    monkeypatch.setenv("MMLSPARK_TPU_NO_FUSED_TREE", "1")
    host, hrows = tree.grow_tree(bins, g, h, m, mapper.max_num_bins, cfg,
                                 mapper)
    for fld in _TREE_FIELDS + ("weight",):
        np.testing.assert_array_equal(getattr(fused, fld), getattr(host, fld),
                                      err_msg=fld)
    assert torch.equal(frows, hrows)


@pytest.mark.cuda
def test_fused_grower_below_min_rows_within_the_gate(cuda_device,
                                                     monkeypatch):
    """At 262,144 rows (below ``select_kernel.MIN_ROWS``) the per-split
    grower compacts a small child only up to n/8 rows (``tier_caps(n,
    False)``) and sums a larger one at full width under its mask, where
    the fused grower compacts it into its n/2 tiers: the grouping of the
    partial sums differs, so the last f32 bit may (ROADMAP C). The same
    tree and rows; gains within 1e-4 and hessian sums within 1e-5
    relative, leaf values within the CPU tests' gate against the reference
    (1e-5 relative, 1e-7 absolute)."""
    from mmlspark_tpu_torch.gbdt import select_kernel, tree

    n = 262_144
    assert n < select_kernel.MIN_ROWS
    assert tree.tier_caps(n, False)[0] < tree.device_tier_caps(n)[0]
    mapper, (bins, g, h, m) = _grower_inputs(cuda_device, n=n, seed=7)
    cfg = tree.GrowerConfig(num_leaves=31)
    fused, frows = tree.grow_tree(bins, g, h, m, mapper.max_num_bins, cfg,
                                  mapper)
    monkeypatch.setenv("MMLSPARK_TPU_NO_FUSED_TREE", "1")
    host, hrows = tree.grow_tree(bins, g, h, m, mapper.max_num_bins, cfg,
                                 mapper)
    for fld in ("feature", "threshold_bin", "left", "right", "default_left",
                "count", "threshold"):
        np.testing.assert_array_equal(getattr(fused, fld), getattr(host, fld),
                                      err_msg=fld)
    np.testing.assert_allclose(fused.gain, host.gain, rtol=1e-4, atol=0)
    np.testing.assert_allclose(fused.value, host.value, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(fused.weight, host.weight, rtol=1e-5, atol=0)
    assert torch.equal(frows, hrows)


@pytest.mark.cuda
def test_captured_tree_equals_eager_and_counters_count_replays(cuda_device):
    """``FusedGrower`` grows its first tree eagerly, captures the second in
    a CUDA graph and replays it from then on: every tree equal to the eager
    one, one host read a tree, and each kernel's launch counter (K1's two
    entries, K2) counting the same launches on a replay as eagerly."""
    from mmlspark_tpu_torch.gbdt import graphs, tree

    mapper, (bins, g, h, m) = _grower_inputs(cuda_device, seed=6)
    grower = tree.FusedGrower(bins, mapper.max_num_bins,
                              tree.GrowerConfig(num_leaves=31), mapper)
    assert grower.run.capture
    hk = ("mmlspark_tpu_torch.gbdt.hist_kernel", "count_launches")
    sk = ("mmlspark_tpu_torch.gbdt.select_kernel", "launches")
    assert hk in graphs.COUNTERS and sk in graphs.COUNTERS
    trees, counts = [], []
    for _ in range(4):
        graphs.set_counters({c: 0 for c in graphs.COUNTERS})
        reads = tree.host_reads
        t, rows = grower.grow(g, h, m)
        assert tree.host_reads == reads + 1
        trees.append((t, rows.clone()))
        counts.append(graphs.read_counters())
    assert counts[0][hk] > 0 and counts[0][sk] > 0
    assert all(c == counts[0] for c in counts), counts
    for t, rows in trees[1:]:
        for fld in _TREE_FIELDS:
            np.testing.assert_array_equal(getattr(t, fld),
                                          getattr(trees[0][0], fld))
        assert torch.equal(rows, trees[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [{}, {"boosting_type": "rf",
                                        "bagging_fraction": 0.5,
                                        "bagging_freq": 1,
                                        "feature_fraction": 0.8}])
def test_scan_makes_no_host_read_and_matches_the_cpu_scan(cuda_device,
                                                          monkeypatch, extra):
    """The scan route on the card runs its boosting loop under
    ``set_sync_debug_mode("error")`` (a host read would raise), replays a
    captured iteration (K1 and K2 counted through the replays), and grows
    the trees of the CPU's forced scan on the same rows; rf at 50% bagging
    compacts its rows through K2 (``bag_cap``)."""
    from mmlspark_tpu_torch.gbdt import booster

    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    monkeypatch.setattr(booster, "scan_loop_sync_mode", "error")
    rng = np.random.default_rng(9)
    X = rng.standard_normal((131_072, 10))
    y = (X[:, 0] - X[:, 1] * X[:, 2] + rng.logistic(size=len(X)) > 0) * 1.0
    params = booster.TrainParams(objective="binary", num_iterations=4,
                                 num_leaves=31, **extra)
    hist_kernel.count_launches = select_kernel.launches = 0
    card = booster.train(params, X, y, device="cuda")
    assert card.route == "scan"
    assert hist_kernel.count_launches >= 4 * 30
    assert select_kernel.launches >= 4 * 30
    monkeypatch.setenv("MMLSPARK_TPU_SCAN_TRAIN", "1")
    cpu = booster.train(params, X, y, device="cpu")
    assert cpu.route == "scan"
    for gc, gp in zip(card.trees, cpu.trees):
        for fld in ("feature", "threshold_bin", "left", "right", "count"):
            np.testing.assert_array_equal(getattr(gc[0], fld),
                                          getattr(gp[0], fld))
    np.testing.assert_allclose(card.raw_predict(X[:4096]),
                               cpu.raw_predict(X[:4096]), rtol=1e-6,
                               atol=1e-6)


def _serve_all(server, bodies, headers, threads=16, timeout=60):
    import threading
    import urllib.error
    import urllib.request

    out = [None] * len(bodies)

    def post(i):
        req = urllib.request.Request(server.address, data=bodies[i],
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                out[i] = (resp.status, resp.read())
        except urllib.error.HTTPError as e:
            out[i] = (e.code, e.read())

    def run(k):
        for i in range(k, len(bodies), threads):
            post(i)

    with server:
        pool = [threading.Thread(target=run, args=(k,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=10 * timeout)
        assert not any(t.is_alive() for t in pool)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_two_replicas_on_one_card_serve_like_the_serial_server(cuda_device, layout):
    """Two replicas sharing one card, two batches in flight each, over many
    requests: every reply equals the serial server's, bitwise (the fused
    GBDT scores each row the same in any batch; ``resolve`` waits on its
    own batches' events and reads its own pinned buffers)."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.io.binary import (FRAME_CONTENT_TYPE,
                                              encode_csr_columns, encode_frame)
    from mmlspark_tpu_torch.serving import serve_pipeline

    rng = np.random.default_rng(21)
    X = rng.standard_normal((2000, 24)).astype(np.float32)
    X[rng.random(X.shape) > 0.3] = 0.0
    y = (X[:, 0] + X[:, 5] > 0).astype(np.float64)
    model = LightGBMClassifier(numIterations=8, numLeaves=15).fit(
        DataFrame.from_dict({"features": [r for r in X], "label": y}))
    bodies = []
    for r in X[:600]:
        if layout == "csr":
            nz = np.flatnonzero(r)
            cols = encode_csr_columns("features", np.array([0, len(nz)]), nz,
                                      r[nz], len(r))
        else:
            cols = {"x": r.astype(np.float64)}
        bodies.append(encode_frame(cols))
    label = "LightGBMClassificationModel"
    gather_launches = []
    replies = []
    for async_exec in (False, True):
        fused = PipelineModel([model]).fuse()
        if layout == "csr":
            fused.set_tuning(layout={label: "csr"},
                             kernel_variants={label: {"*": "forest.csr"}})
        gather_kernel.launches = 0
        server = serve_pipeline(fused, "features", reply_col="probability",
                                fused=True, async_exec=async_exec, replicas=2,
                                inflight=2, max_batch_size=64, max_wait_ms=1.0,
                                http_mode="async")
        replies.append(_serve_all(server, bodies,
                                  {"Content-Type": FRAME_CONTENT_TYPE}))
        gather_launches.append(gather_kernel.launches)
        assert fused.fusion_stats()["fallbacks"] == []
    assert all(r[0] == 200 for r in replies[0])
    assert replies[0] == replies[1]
    if layout == "csr":
        assert min(gather_launches) > 0


# ------------------------------------------------------- the sparse routes


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [0, 1, "w - 1", "w"])
def test_sparse_hist_compacted_stream_matches_plain(cuda_device, valid):
    """K4 on a stream wider than its valid length ``bin_end[-1]`` (the
    scan's compacted stream), the entries past it NaN: neither K4 nor its
    plain version reads them; counts exact, g/h within 1e-5 * sum|v| +
    1e-6, and bit for bit from call to call."""
    w, tb = 1_000_003, 40_001
    rng = np.random.default_rng(21)
    ids = np.sort(rng.integers(0, tb, w))
    v = {"w - 1": w - 1, "w": w}.get(valid, valid)
    bin_end = np.minimum(np.searchsorted(ids, np.arange(tb), side="right"), v)
    data = rng.standard_normal((3, w)).astype(np.float32)
    data[2] = 1.0
    data[:, v:] = np.nan
    d = torch.from_numpy(data).to(cuda_device)
    be = torch.from_numpy(bin_end.astype(np.int32)).to(cuda_device)
    k = sparse_hist_kernel.sparse_histogram_cuda(d, be)
    p = sparse_hist_kernel.sparse_histogram_plain(d, be)
    scale = sparse_hist_kernel.sparse_histogram_plain(d.abs(), be)
    assert torch.equal(k[2], p[2]) and bool(torch.isfinite(k).all())
    assert bool(((k[:2] - p[:2]).abs() <= 1e-5 * scale[:2] + 1e-6).all())
    assert torch.equal(k, sparse_hist_kernel.sparse_histogram_cuda(d, be))


@pytest.mark.cuda
def test_threefry_draws_and_topk_card_match_cpu(cuda_device):
    """The GOSS scan's draws and selection on the card, bit for bit the
    CPU's: 20 keys, a 2,097,152-row uniform draw, and the exact top-k of it
    and of signed keys with an exclusion mask."""
    from mmlspark_tpu_torch.core import threefry
    from mmlspark_tpu_torch.gbdt import sparse

    n = 2_097_152
    kc = threefry.split(threefry.prng_key(7, cuda_device), 20)
    kp = threefry.split(threefry.prng_key(7), 20)
    assert torch.equal(kc.cpu(), kp)
    uc, up = threefry.uniform(kc[19], n), threefry.uniform(kp[19], n)
    assert torch.equal(uc.cpu(), up)
    excl = torch.from_numpy(np.random.default_rng(3).random(n) < 0.2)
    for key_c, key_p in ((uc, up), (uc - 0.5, up - 0.5)):
        for k, ex in ((419_430, None), (209_715, excl)):
            mc = sparse._exact_topk_mask(
                key_c, k, n, None if ex is None else ex.to(cuda_device))
            mp = sparse._exact_topk_mask(key_p, k, n, ex)
            assert torch.equal(mc.cpu(), mp) and int(mp.sum()) == k


def _sparse_case(device, n=60_000, width=1 << 12, seed=13):
    from mmlspark_tpu_torch.gbdt import sparse

    rng = np.random.default_rng(seed)
    per_row = rng.poisson(30, n).clip(1)
    row_of = np.repeat(np.arange(n), per_row)
    idx = (width * rng.random(len(row_of)) ** 3).astype(np.int64)
    key = np.unique(row_of * width + idx)
    row_of, idx = key // width, key % width
    vals = 1.0 + rng.integers(0, 4, len(key))
    indptr = np.searchsorted(row_of, np.arange(n + 1))
    sig = np.bincount(row_of[idx == 5], minlength=n) - np.bincount(
        row_of[idx == 300], minlength=n)
    y = (sig + rng.normal(0, 0.5, n) > 0).astype(np.float64)
    ds = sparse.SparseDataset.from_csr(indptr, idx, vals, width)
    return ds, y


_SPARSE_FIELDS = ("feature", "threshold_bin", "left", "right", "default_left",
                  "count")


@pytest.mark.cuda
def test_captured_sparse_tree_equals_eager_and_counts_replays(cuda_device):
    """``SparseFusedGrower`` grows its first tree eagerly, captures the
    second in a CUDA graph and replays it from then on: every tree equal to
    the eager one, one host read a tree, and K4's launch counter counting
    the same launches on a replay as eagerly."""
    from mmlspark_tpu_torch.gbdt import graphs, sparse
    from mmlspark_tpu_torch.gbdt.tree import GrowerConfig

    ds, y = _sparse_case(cuda_device)
    dev = sparse.device_arrays(ds, cuda_device)
    g = torch.from_numpy((0.5 - y).astype(np.float32)).to(cuda_device)
    h = torch.full_like(g, 0.25)
    m = torch.from_numpy(np.random.default_rng(2).random(len(y)) < 0.8).to(
        cuda_device)
    grower = sparse.SparseFusedGrower(ds, dev, GrowerConfig(num_leaves=31))
    assert grower.run.capture
    k4 = ("mmlspark_tpu_torch.gbdt.sparse_hist_kernel", "launches")
    assert k4 in graphs.COUNTERS
    trees, counts = [], []
    for _ in range(4):
        graphs.set_counters({c: 0 for c in graphs.COUNTERS})
        reads = sparse.host_reads
        t, rows = grower.grow(g, h, m)
        assert sparse.host_reads == reads + 1
        trees.append((t, rows.clone()))
        counts.append(graphs.read_counters())
    assert counts[0][k4] == 31
    assert all(c == counts[0] for c in counts), counts
    for t, rows in trees[1:]:
        for fld in _SPARSE_FIELDS + ("gain", "value", "threshold"):
            np.testing.assert_array_equal(getattr(t, fld),
                                          getattr(trees[0][0], fld))
        assert torch.equal(rows, trees[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gbdt", "goss_compacted", "goss_lazy"])
def test_sparse_scan_makes_no_host_read_and_matches_the_cpu_scan(
        cuda_device, monkeypatch, case):
    """The sparse scan on the card: its loop under
    ``set_sync_debug_mode("error")``, K4 counted through the replays, the
    compaction and lazy routing the case forces, and the trees of the CPU's
    forced scan on the same data (first tree bit for bit, the rest within
    the structure gate)."""
    from mmlspark_tpu_torch.gbdt import booster, sparse
    from mmlspark_tpu_torch.gbdt.booster import TrainParams

    monkeypatch.setattr(booster, "scan_loop_sync_mode", "error")
    extra = {}
    if case != "gbdt":
        extra = dict(boosting_type="goss", top_rate=0.2, other_rate=0.1)
        monkeypatch.setenv("MMLSPARK_TPU_SPARSE_COMPACT", "1")
    if case == "goss_compacted":
        monkeypatch.setenv("MMLSPARK_TPU_NO_SPARSE_LAZY_ROUTE", "1")
    if case == "goss_lazy":
        extra["max_depth"] = 8
    ds, y = _sparse_case(cuda_device)
    params = TrainParams(objective="binary", num_iterations=4, num_leaves=31,
                         min_data_in_leaf=20, **extra)
    sparse_hist_kernel.launches = 0
    card = sparse.train_sparse(params, ds, y, device="cuda")
    assert card.route == "scan"
    assert sparse_hist_kernel.launches == 4 * 31
    stats = dict(sparse.last_scan_stats)
    assert bool(stats["compact_cap"]) == (case != "gbdt")
    assert stats["lazy"] == (case == "goss_lazy")
    monkeypatch.setenv("MMLSPARK_TPU_SCAN_TRAIN", "1")
    cpu = sparse.train_sparse(params, ds, y, device="cpu")
    assert cpu.route == "scan"
    for i, (gc, gp) in enumerate(zip(card.trees, cpu.trees)):
        for fld in _SPARSE_FIELDS:
            np.testing.assert_array_equal(getattr(gc[0], fld),
                                          getattr(gp[0], fld))
        if i == 0:
            np.testing.assert_array_equal(gc[0].value, gp[0].value)


@pytest.mark.cuda
def test_sparse_per_split_route_above_the_gate_matches_cpu(cuda_device,
                                                           monkeypatch):
    """Above the grower-state gate (``MMLSPARK_TPU_FUSED_TREE_BYTES``) a
    sparse fit on the card takes the per-split host loop (route ``host``,
    two host reads a split at most) and grows the CPU's trees on it."""
    from mmlspark_tpu_torch.gbdt import sparse
    from mmlspark_tpu_torch.gbdt.booster import TrainParams

    monkeypatch.setenv("MMLSPARK_TPU_FUSED_TREE_BYTES", "0")
    ds, y = _sparse_case(cuda_device)
    params = TrainParams(objective="binary", num_iterations=2, num_leaves=15,
                         min_data_in_leaf=20)
    reads = sparse.host_reads
    card = sparse.train_sparse(params, ds, y, device="cuda")
    assert card.route == "host"
    splits = sum(t.num_leaves - 1 for g in card.trees for t in g)
    assert sparse.host_reads - reads <= 2 * splits + 2 * len(card.trees)
    cpu = sparse.train_sparse(params, ds, y, device="cpu")
    assert cpu.route == "host"
    for gc, gp in zip(card.trees, cpu.trees):
        for fld in _SPARSE_FIELDS:
            np.testing.assert_array_equal(getattr(gc[0], fld),
                                          getattr(gp[0], fld))


# ------------------------------------------------- K-step mega dispatch


def _mega_model(seed=31, n=3000, width=64):
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import LightGBMRegressor

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, width)).astype(np.float32)
    X[rng.random(X.shape) > 0.2] = 0.0
    y = X[:, 0] * 2 - X[:, 3] + X[:, 9]
    model = LightGBMRegressor(numIterations=12, numLeaves=15).fit(
        DataFrame.from_dict({"features": [r for r in X], "label": y}))
    return model, X


def _mega_rows(X, sparse):
    out = np.empty(len(X), dtype=object)
    for i, r in enumerate(X):
        nz = np.flatnonzero(r)
        out[i] = ({"indices": nz, "values": r[nz], "size": len(r)} if sparse
                  else r)
    return out


def _mega_fused(model, sparse, k):
    from mmlspark_tpu_torch.core.device_stage import CompileCache
    from mmlspark_tpu_torch.core.fusion import FusedPipelineModel

    fused = FusedPipelineModel([model], cache=CompileCache())
    label = "LightGBMRegressionModel"
    tuning = {"mega_k": {label: k}}
    if sparse:
        tuning.update(layout={label: "csr"},
                      kernel_variants={label: {"*": "forest.csr"}})
    fused.set_tuning(**tuning)
    return fused


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
def test_mega_graph_output_equals_k1_bitwise(cuda_device, sparse):
    """K = 4 over 11 batches (two graph replays of four, three singly) on
    the card, twice (capture, then replays only): every output bit equals
    the per-batch dispatch's, K3 counts one launch a batch through the
    replays, and the replays make no host sync."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame

    model, X = _mega_model()
    df = DataFrame.from_dict({"features": _mega_rows(X[:2700], sparse)})
    want = np.stack(list(_mega_fused(model, sparse, 1)
                         .transform_submit(df)().column("prediction")))
    fused = _mega_fused(model, sparse, 4)
    first = np.stack(list(fused.transform_submit(df)().column("prediction")))
    gather_kernel.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        resolve = fused.transform_submit(df)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    again = np.stack(list(resolve().column("prediction")))
    assert np.array_equal(first.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(again.view(np.uint32), want.view(np.uint32))
    if sparse:
        assert gather_kernel.launches == 11
    records = fused._seg_stats["LightGBMRegressionModel"].records
    assert [t.mega_k for t in records] == [4] * 8 + [1] * 3


@pytest.mark.cuda
def test_mega_csr_graph_never_replays_another_width(cuda_device):
    """Two partitions of one batch shape and other widths: each width gets
    a graph of its own (the width is baked into the capture), and each
    scores as its per-batch dispatch does."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame

    model, X = _mega_model()
    rows_a = _mega_rows(X[:1024], True)
    rows_b = _mega_rows(X[1024:2048], True)
    for r in rows_b:
        r["size"] = 2 * len(X[0])       # a wider declared width, same rows
    outs = []
    for k in (1, 4):
        fused = _mega_fused(model, True, k)
        got = []
        for rows in (rows_a, rows_b, rows_a):
            df = DataFrame.from_dict({"features": rows})
            got.append(np.stack(list(fused.transform_submit(df)()
                                     .column("prediction"))))
        outs.append(got)
        if k == 4:
            shapes = [s for per in fused.compile_cache.costs().values()
                      for s in per if "mega4;" in s]
            megas = [e.program for e in fused.compile_cache._entries.values()
                     if hasattr(e.program, "graphs")]
            assert len(megas) == 2 and all(m.graphs == 1 for m in megas)
            assert shapes
    for a, b in zip(outs[0], outs[1]):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.cuda
def test_two_streams_replay_one_segments_graphs_without_mixing(cuda_device):
    """Two threads, each on a stream of its own, replay the same K-step
    program over different rows at once: one graph each, and every output
    is its own rows' per-batch scores."""
    import threading

    from mmlspark_tpu_torch.core.dataframe import DataFrame

    model, X = _mega_model()
    frames = [DataFrame.from_dict({"features": _mega_rows(X[i * 1024:(i + 1) * 1024],
                                                          False)})
              for i in range(2)]
    base = _mega_fused(model, False, 1)
    want = [np.stack(list(base.transform_submit(f)().column("prediction")))
            for f in frames]
    fused = _mega_fused(model, False, 4)
    got = [[], []]
    errors = []

    def run(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(6):
                    out = fused.transform_submit(frames[i])()
                    got[i].append(np.stack(list(out.column("prediction"))))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    for i in range(2):
        assert len(got[i]) == 6
        for g in got[i]:
            assert np.array_equal(g.view(np.uint32), want[i].view(np.uint32))
    megas = [e.program for e in fused.compile_cache._entries.values()
             if hasattr(e.program, "graphs")]
    assert len(megas) == 1 and megas[0].graphs == 2


@pytest.mark.cuda
def test_mega_program_evicted_while_another_thread_replays(cuda_device):
    """Two threads on streams of their own score through one cache that
    holds a single program, so each call evicts (and releases) a program
    the other thread may be replaying: a release waits for the calls in
    flight, a call on a released program captures a graph of its own, and
    every output is its rows' per-batch scores. Then a program released
    between two calls on one thread leaves it scoring the same."""
    import threading

    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.device_stage import CompileCache
    from mmlspark_tpu_torch.core.fusion import FusedPipelineModel

    model, X = _mega_model()
    frames = [DataFrame.from_dict({"features": _mega_rows(X[i * 1350:(i + 1) * 1350],
                                                          False)})
              for i in range(2)]
    base = _mega_fused(model, False, 1)
    want = [np.stack(list(base.transform_submit(f)().column("prediction")))
            for f in frames]
    cache = CompileCache(capacity=1)
    fused = FusedPipelineModel([model], cache=cache)
    fused.set_tuning(mega_k={"LightGBMRegressionModel": 4})
    got = [[], []]
    errors = []

    def run(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(5):
                    out = fused.transform_submit(frames[i])()
                    got[i].append(np.stack(list(out.column("prediction"))))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert cache.stats()["evictions"] > 0
    for i in range(2):
        assert len(got[i]) == 5
        for g in got[i]:
            assert np.array_equal(g.view(np.uint32), want[i].view(np.uint32))

    solo = _mega_fused(model, False, 4)
    first = np.stack(list(solo.transform_submit(frames[0])()
                          .column("prediction")))
    prog, = [e.program for e in solo.compile_cache._entries.values()
             if hasattr(e.program, "graphs")]
    prog.release()
    assert prog.dead and prog.graphs == 0
    again = np.stack(list(solo.transform_submit(frames[0])()
                          .column("prediction")))
    assert prog.graphs == 0
    for g in (first, again):
        assert np.array_equal(g.view(np.uint32), want[0].view(np.uint32))


@pytest.mark.cuda
def test_k5_counted_through_mega_replays(cuda_device):
    """A small bf16 encoder through DNNModel at K = 2: K5 launches once a
    layer a batch eagerly, the same through graph replays, and the outputs
    equal K=1's bit for bit."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.device_stage import CompileCache
    from mmlspark_tpu_torch.core.fusion import FusedPipelineModel
    from mmlspark_tpu_torch.models import DNNModel, transformer_encoder

    enc = transformer_encoder(vocab_size=97, seq_len=128, dim=64, depth=2,
                              num_heads=1, seed=3)
    stage = DNNModel(inputCol="tokens", outputCol="out", batchSize=4)
    stage.set_model(enc)
    ids = np.random.default_rng(4).integers(0, 97, (16, 128))
    df = DataFrame.from_dict({"tokens": list(ids)})
    outs = {}
    for k in (1, 2):
        fused = FusedPipelineModel([stage], cache=CompileCache())
        fused.set_tuning(mega_k={"DNNModel": k})
        fused.transform_submit(df)()
        flash_kernel.launches = 0
        out = fused.transform_submit(df)()
        outs[k] = (np.stack([np.asarray(v, np.float32)
                             for v in out.column("out")]),
                   flash_kernel.launches)
    assert outs[1][1] == 4 * 2 and outs[2][1] == outs[1][1]
    assert np.array_equal(outs[2][0].view(np.uint32), outs[1][0].view(np.uint32))


# ---------------------------------------------------------------- image path


@pytest.mark.cuda
@pytest.mark.parametrize("strides,padding", [((1, 1), "SAME"), ((2, 2), "SAME"),
                                             ((2, 2), ((1, 1), (1, 1)))])
def test_conv_f32_on_the_card_is_not_tf32(cuda_device, strides, padding):
    """A ResNet-sized conv under ``matmul_precision("float32")`` with
    cuDNN's TF32 flag left on (PyTorch's default) against the same conv in
    f64 on the card: within full-f32 error (TF32's 10-bit mantissas read
    ~1e-3 here), and the flag as it was afterwards."""
    from mmlspark_tpu_torch.models.module import Conv2D, matmul_precision

    conv = Conv2D(64, (3, 3), strides, padding)
    conv.init(torch.Generator().manual_seed(0), (56, 56, 64))
    conv.to(cuda_device)
    x = torch.randn(8, 56, 56, 64, generator=torch.Generator().manual_seed(1)
                    ).to(cuda_device)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with matmul_precision("float32"), torch.inference_mode():
            y = conv(x)
        with matmul_precision("float64"), torch.inference_mode():
            want = conv.double()(x.double())
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert y.dtype == torch.float32 and want.dtype == torch.float64
    err = ((y.double() - want).abs().max() / want.abs().max()).item()
    assert err < 1e-5, err


@pytest.mark.cuda
def test_image_featurizer_fused_bitwise_unfused_on_the_card(cuda_device):
    """``PipelineModel([ImageTransformer().resize(64, 64).flip(1),
    ImageFeaturizer(ResNet-50, width 16)]).fuse()`` on the card: the resize
    in prepare, the flip and the forward on the device, bit for bit the
    unfused chain, with no fallback."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.core.schema import ImageSchema
    from mmlspark_tpu_torch.image import ImageFeaturizer, ImageTransformer
    from mmlspark_tpu_torch.models import resnet

    rng = np.random.default_rng(0)
    rows = [ImageSchema.make(rng.integers(0, 256, (72, 80, 3), dtype=np.uint8))
            for _ in range(20)]
    df = DataFrame.from_dict({"image": rows}, num_partitions=2)
    feat = ImageFeaturizer(batchSize=8, scaleFactor=1 / 255).set_model(
        resnet(50, num_classes=10, image_size=64, width=16))
    pm = PipelineModel([ImageTransformer().resize(64, 64).flip(1), feat])
    want = np.stack(list(pm.transform(df).column("features")))
    fused = pm.fuse()
    got = np.stack(list(fused.transform(df).column("features")))
    assert fused.fusion_stats()["fallbacks"] == []
    assert got.shape == (20, 512) and np.isfinite(got).all()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_moe_block_on_the_card_matches_the_cpu(cuda_device, precision):
    """A transformer block with a switch-MoE FFN (8 experts, capacity factor
    1, tokens overflowing) on the card against the same block on the CPU: the
    same routing, the output within 1e-5 (f32) or 2e-2 (bf16, a flip of
    one bf16 intermediate) of the CPU's, relative to its max |value|."""
    from mmlspark_tpu_torch.models import matmul_precision, transformer_block

    block = transformer_block(64, 2, moe_experts=8, moe_capacity_factor=1.0)
    block.init(torch.Generator().manual_seed(0), (256, 64))
    x = torch.randn(4, 256, 64, generator=torch.Generator().manual_seed(1))
    moe = block.mlp.body.moe
    with matmul_precision(precision), torch.inference_mode():
        cpu = block(x)
        cpu_route = moe.routing(block.mlp.body.ln(x))
        block.to(cuda_device)
        card = block(x.to(cuda_device)).cpu()
        card_route = [t.cpu() for t in moe.routing(
            block.mlp.body.ln(x.to(cuda_device)))]
    assert torch.equal(card_route[0], cpu_route[0])
    assert torch.equal(card_route[2], cpu_route[2])
    assert (cpu_route[2].sum(dim=(2, 3)) == 0).any()     # overflow dropped
    tol = 1e-5 if precision == "float32" else 2e-2
    assert ((card - cpu).abs().max() / cpu.abs().max()).item() < tol


# ---------------------------------------------------------------- vw_scan


def _vw_case(loss, n=1500, k=39, bits=12, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << bits, (n, k)).astype(np.int32)
    idx[:, 3] = idx[:, 1]
    idx[::4, 20] = idx[::4, 1]
    idx[::7, 38] = idx[::7, 3]
    idx[5, 0], idx[6, 2] = -3, (1 << bits) + 5
    val = rng.standard_normal((n, k)).astype(np.float32)
    val[:, -3:] = 0
    lab = (np.where(rng.random(n) > 0.5, 1.0, -1.0) if loss != "quantile"
           else rng.standard_normal(n)).astype(np.float32)
    wts = rng.uniform(0.5, 2.0, n).astype(np.float32)
    wts[10] = 0
    return idx, val, lab, wts


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["squared", "logistic", "hinge", "quantile"])
@pytest.mark.parametrize("mode", ["adaptive", "sgd", "ftrl"])
@pytest.mark.parametrize("k", [39, 80])
def test_vw_scan_matches_plain_on_the_card(cuda_device, loss, mode, k):
    """``csrc/vw_scan.cu`` against its plain version on the card, two
    passes over examples with duplicate indices, padded slots, indices out
    of range and a zero-weight example (39 slots: mostly the kernel's fast
    path; 80: all through its general path): weights within rtol 1e-3 /
    atol 2e-4 (the reference's bound between its two engines), the clock
    equal, the loss sums within 1e-5; two calls bit for bit; one launch a
    pass."""
    from mmlspark_tpu_torch.vw import learner, scan_kernel

    cfg = learner.LearnerConfig(
        num_bits=12, loss_function=loss, quantile_tau=0.3,
        adaptive=mode == "adaptive", ftrl=mode == "ftrl", l1=1e-3,
        l2=1e-3 if mode == "adaptive" else 0.0,
        power_t=0.5 if mode != "sgd" else 0.4, initial_t=1.0)
    ds = learner.SparseDataset(*_vw_case(loss, k=k))
    dev = ds.to(cuda_device)
    plain_ds = ds.to(cuda_device)
    runs = []
    scan_kernel.launches = 0
    for _ in range(2):
        st = learner.init_state(cfg, cuda_device)
        losses = [float(scan_kernel.scan_pass(st, *dev, cfg).item())
                  for _ in range(2)]
        runs.append((learner.weights_of(cfg, st).cpu().numpy(), st, losses))
    assert scan_kernel.launches == 4
    plain = learner.init_state(cfg, cuda_device)
    p_losses = [float(scan_kernel.scan_pass_plain(plain, *plain_ds, cfg).item())
                for _ in range(2)]
    assert scan_kernel.launches == 4
    w, st, losses = runs[0]
    wp = learner.weights_of(cfg, plain).cpu().numpy()
    np.testing.assert_allclose(w, wp, rtol=1e-3, atol=2e-4)
    assert np.array_equal(w.view(np.uint32), runs[1][0].view(np.uint32))
    for a, b in zip(losses, p_losses):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b))
    if mode != "ftrl":
        assert st[2].item() == plain[2].item() == 2 * (len(ds.labels) - 1)


@pytest.mark.cuda
def test_vw_scan_route_on_the_card_against_the_native_pass(cuda_device,
                                                           monkeypatch):
    """``train_linear`` with the native route off runs ``vw_scan`` once a
    pass on the card; its adaptive weights within rtol 1e-3 / atol 2e-4 of
    the native C++ pass's, and ``predict_linear`` on the card within 1e-6
    of the host f64 dot (of each row's sum |w v|)."""
    from mmlspark_tpu_torch import native_loader
    from mmlspark_tpu_torch.vw import learner, scan_kernel

    if not native_loader.available():
        pytest.skip("native toolchain unavailable")
    idx, val, lab, wts = _vw_case("logistic", n=4000, seed=3)
    ds = learner.SparseDataset(np.clip(idx, 0, (1 << 12) - 1), val, lab, wts)
    cfg = learner.LearnerConfig(num_bits=12, loss_function="logistic",
                                num_passes=2)
    w_nat, _ = learner.train_linear(cfg, ds)
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_VW", "0")
    scan_kernel.launches = 0
    w_scan, _ = learner.train_linear(cfg, ds)
    assert scan_kernel.launches == 2
    np.testing.assert_allclose(w_scan, w_nat, rtol=1e-3, atol=2e-4)
    raw = learner.predict_linear(w_scan, ds)
    terms = w_scan.astype(np.float64)[ds.indices] * ds.values
    rel = np.abs(raw - terms.sum(1)) / np.maximum(np.abs(terms).sum(1), 1e-30)
    assert rel.max() <= 1e-6


# ---------------------------------------------------------- ONNX on the card


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_graph_module_conv_graph_on_the_card_matches_cpu(cuda_device):
    """A ResNet-18 (width 16) exported by the port and imported as a
    ``GraphModule``: its logits and a layer tap on the card (f32, TF32 off)
    within 1e-4 of the CPU's max |x|, and the bf16 import within 2e-2."""
    from mmlspark_tpu_torch.models import resnet
    from mmlspark_tpu_torch.onnx import export_onnx, import_onnx

    model = resnet(18, num_classes=10, image_size=32, width=16)
    blob = export_onnx(model.module, None, (32, 32, 3))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 3, 32, 32)).astype(np.float32))
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        g = import_onnx(blob, compute_dtype=dtype)
        tap = g.layer_names[1]
        cpu = g.apply_taps(x, [None, tap])
        card = g.apply_taps(x.to(cuda_device), [None, tap],
                            params=g.device_params(cuda_device))
        for key in (None, tap):
            want = cpu[key].float().numpy()
            got = card[key].float().cpu().numpy()
            assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.cuda
def test_two_input_graph_on_the_card_matches_cpu(cuda_device):
    """``chip_smoke.bert_onnx`` (2 layers, width 64) through a two-input
    ``DNNModel.setFeedDict`` on the card against the CPU: within 1e-4 of
    the max |x| (f32, TF32 off on both sides)."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models import DNNModel
    from mmlspark_tpu_torch.onnx import import_onnx
    from mmlspark_tpu_torch.runtime import use_device

    cs = _chip_smoke()
    blob = cs.bert_onnx(vocab=500, hidden=64, heads=4, ffn=128, layers=2,
                        seq=32, seed=1)
    ids, mask = cs.bert_inputs(10, 32, 500, seed=2)
    stage = DNNModel(outputCol="o", batchSize=4).set_model(import_onnx(blob))
    stage.set_feed_dict({"input_ids": "ids", "attention_mask": "mask"})
    df = DataFrame.from_dict({"ids": list(ids), "mask": list(mask)})
    card = np.stack(list(stage.transform(df).column("o")))
    with use_device("cpu"):
        cpu = np.stack(list(stage.transform(df).column("o")))
    assert card.shape == (10, 64)
    assert np.abs(card - cpu).max() <= 1e-4 * np.abs(cpu).max()


# ------------------------------------------ data-parallel fits on the card


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["mask", "count", "sparse"])
def test_f64_entries_match_plain_on_the_card(cuda_device, entry):
    """K1's two entries and K4 with ``f64=True``: the sums before their one
    rounding, against the plain versions' f64 sums (within 1e-9 of each
    cell's sum |v|: both sum in f64, in other orders), and the f32 entry
    is those sums rounded once, bit for bit."""
    n, f, b = 300_001, 28, 256
    bins, grad, hess, mask = _inputs(n, f, b, 0.6, cuda_device, seed=9)
    if entry == "sparse":
        rng = np.random.default_rng(9)
        tb = 40_000
        ends = np.sort(rng.integers(0, n, tb - 1))
        bin_end = torch.from_numpy(np.append(ends, n).astype(np.int32)).to(
            cuda_device)
        data = torch.stack([grad * mask, hess * mask, mask.float()])
        k64 = sparse_hist_kernel.sparse_histogram_cuda(data, bin_end, f64=True)
        p64 = sparse_hist_kernel.sparse_histogram_plain(data, bin_end,
                                                        f64=True)
        scale = sparse_hist_kernel.sparse_histogram_plain(data.abs(), bin_end,
                                                          f64=True)
        k32 = sparse_hist_kernel.sparse_histogram_cuda(data, bin_end)
    elif entry == "mask":
        k64 = hist_kernel.histogram_cuda(bins, grad, hess, mask, b, f64=True)
        p64 = hist_kernel.histogram_plain(bins, grad, hess, mask, b, f64=True)
        scale = hist_kernel.histogram_plain(bins, grad.abs(), hess.abs(),
                                            mask, b, f64=True)
        k32 = hist_kernel.histogram_cuda(bins, grad, hess, mask, b)
    else:
        cnt = torch.tensor([123_457], dtype=torch.int32, device=cuda_device)
        caps = (150_016, 75_264)
        args = (bins, grad, hess, cnt, b)
        k64 = hist_kernel.histogram_count_cuda(*args, caps, f64=True)
        p64 = hist_kernel.histogram_count_plain(*args, f64=True)
        valid = torch.arange(n, device=cuda_device) < 123_457
        scale = hist_kernel.histogram_plain(bins, grad.abs(), hess.abs(),
                                            valid, b, f64=True)
        k32 = hist_kernel.histogram_count_cuda(*args, caps)
    assert k64.dtype == torch.float64 and k32.dtype == torch.float32
    assert bool(((k64 - p64).abs() <= 1e-9 * scale).all())
    assert torch.equal(k64.float(), k32)


_CUDA_MESH_RANK = r'''
import numpy as np
import torch


def fit(mesh, inputs):
    from mmlspark_tpu_torch.gbdt import booster, sparse
    from mmlspark_tpu_torch.vw import LearnerConfig, SparseDataset
    from mmlspark_tpu_torch.vw import train_linear

    d = dict(np.load(inputs))
    p = booster.TrainParams(objective="binary", num_iterations=4,
                            num_leaves=15, min_data_in_leaf=5)
    dense = booster.train(p, d["X"], d["y"], mesh=mesh)
    ds = sparse.SparseDataset.from_csr(d["indptr"], d["indices"],
                                       d["values"], 512, 255)
    sp = sparse.train_sparse(p, ds, d["sy"], mesh=mesh)
    vw = SparseDataset(d["vi"], d["vv"], d["vl"], d["vw"])
    w, _ = train_linear(LearnerConfig(num_bits=10, loss_function="logistic",
                                      num_passes=2), vw, mesh=mesh)
    return dense.route, dense.to_string(), sp.to_string(), w
'''


def _mesh_case(seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(20_000, 6))
    d = {"X": X, "y": (X[:, 0] - X[:, 1] > 0).astype(np.float64)}
    n = 6000
    nnz = rng.integers(0, 12, n)
    d["indptr"] = np.concatenate([[0], np.cumsum(nnz)])
    d["indices"] = np.concatenate([np.sort(rng.choice(512, k, replace=False))
                                   for k in nnz])
    d["values"] = rng.integers(1, 5, len(d["indices"])).astype(np.float64)
    d["sy"] = (rng.random(n) < 0.4).astype(np.float64)
    d["vi"] = rng.integers(0, 1 << 10, (2001, 8)).astype(np.int32)
    d["vv"] = rng.standard_normal((2001, 8)).astype(np.float32)
    d["vl"] = np.where(rng.random(2001) < 0.5, -1.0, 1.0).astype(np.float32)
    d["vw"] = np.ones(2001, np.float32)
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("world,device,backend", [
    (1, "cuda", "nccl"), (2, "cuda:0", "gloo")])
def test_mesh_fits_on_the_card_equal_the_single_card_fit(cuda_device,
                                                         tmp_path, monkeypatch,
                                                         world, device,
                                                         backend):
    """A one-rank NCCL mesh, and two gloo ranks sharing ``cuda:0`` (asked
    for by name): the dense and sparse fits byte for byte the single-card
    fits on the same route (fused), every rank's the same; VW within the
    engines' bound of one process averaging its per-block passes."""
    from mmlspark_tpu_torch.gbdt import booster, sparse
    from mmlspark_tpu_torch.parallel.launch import spawn
    from mmlspark_tpu_torch.parallel.mesh import Mesh
    from mmlspark_tpu_torch.vw import LearnerConfig, SparseDataset
    from mmlspark_tpu_torch.vw import learner, scan_kernel

    d = _mesh_case()
    np.savez(tmp_path / "in.npz", **d)
    (tmp_path / "cuda_mesh_rank.py").write_text(_CUDA_MESH_RANK)
    ranks = spawn("cuda_mesh_rank:fit", world, tmp_path,
                  {"inputs": str(tmp_path / "in.npz")}, device=device,
                  backend=backend, timeout=300, path=[str(tmp_path)])
    p = booster.TrainParams(objective="binary", num_iterations=4,
                            num_leaves=15, min_data_in_leaf=5)
    # the single-card fits on the mesh fits' route: no native engine, no scan
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    monkeypatch.setenv("MMLSPARK_TPU_NO_SCAN_TRAIN", "1")
    dense = booster.train(p, d["X"], d["y"])
    ds = sparse.SparseDataset.from_csr(d["indptr"], d["indices"],
                                       d["values"], 512, 255)
    sp = sparse.train_sparse(p, ds, d["sy"])
    assert dense.route == "fused" and sp.route == "fused"
    for r in ranks:
        assert r[0] == "fused"
        assert r[1] == dense.to_string()
        assert r[2] == sp.to_string()
        np.testing.assert_array_equal(r[3], ranks[0][3])
    cfg = LearnerConfig(num_bits=10, loss_function="logistic", num_passes=2)
    vw = SparseDataset(d["vi"], d["vv"], d["vl"], d["vw"])
    blocks = [learner.shard_block(vw, Mesh(shape={"data": world}, rank=r))
              .to(cuda_device) for r in range(world)]
    state = learner.init_state(cfg, cuda_device)
    for _ in range(2):
        parts = []
        for blk in blocks:
            st = [t.clone() for t in state]
            scan_kernel.scan_pass_cuda(st, *blk, cfg)
            parts.append(st)
        state = [sum(q[i] for q in parts) / world for i in range(len(state))]
    want = learner.weights_of(cfg, state).cpu().numpy()
    np.testing.assert_allclose(ranks[0][3], want, rtol=1e-3, atol=2e-4)


@pytest.mark.cuda
def test_sharded_fused_body_reads_nothing_on_the_host_under_nccl(
        cuda_device, tmp_path):
    """The row-sharded fused body (every histogram's f64 sums all-reduced
    over a one-rank NCCL group) under ``set_sync_debug_mode("error")``: no
    host read inside a tree; its tables are the single-card body's."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.gbdt import histogram, tree
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, all_reduce_sum
    from mmlspark_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(MeshSpec(data=1), device="cuda:0")
        all_reduce_sum(torch.zeros(1, device=cuda_device), mesh)
        torch.cuda.synchronize()
        n, f, b = 262_144, 28, 256
        bins, grad, hess, _ = _inputs(n, f, b, 1.0, cuda_device, seed=5)
        mask = torch.ones(n, dtype=torch.bool, device=cuda_device)
        cfg = tree.GrowerConfig(num_leaves=31, min_data_in_leaf=20)
        want = tree._fused_tables(bins, grad, hess, mask, None, b, cfg)
        reduce = histogram.shard_reduce(mesh)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tree._fused_tables(bins, grad, hess, mask, None, b, cfg,
                                     reduce=reduce)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_sharded_fused_tree_replays_its_graph_under_nccl(cuda_device,
                                                         tmp_path, kind):
    """The row-sharded fused tree on a one-rank NCCL mesh as the growers run
    it (``tree.sharded_replayer``): the first tree eager, the second
    captured with its all-reduces in a CUDA graph, every later one a
    replay under ``set_sync_debug_mode("error")``. Every tree's tables
    equal the eager sharded body's on the same gradients byte for byte,
    and K1 (dense) or K4 (sparse) launches through the replays."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.gbdt import histogram, sparse, sparse_hist_kernel
    from mmlspark_tpu_torch.gbdt import tree
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, all_reduce_sum
    from mmlspark_tpu_torch.parallel.mesh import make_mesh

    cfg = tree.GrowerConfig(num_leaves=15, min_data_in_leaf=20)
    if kind == "dense":
        n, f, b = 131_072, 12, 64
        bins, _, _, _ = _inputs(n, f, b, 1.0, cuda_device, seed=6)
        module, counter = hist_kernel, "launches"

        def body(g, h, m, reduce):
            return tree._fused_tables(bins, g, h, m, None, b, cfg,
                                      reduce=reduce)
    else:
        d = _mesh_case(seed=6)
        ds = sparse.SparseDataset.from_csr(d["indptr"], d["indices"],
                                           d["values"], 512, 255)
        dev = sparse.device_arrays(ds, cuda_device)
        n = ds.num_rows
        module, counter = sparse_hist_kernel, "launches"

        def body(g, h, m, reduce):
            return sparse._fused_sparse_tables(dev, g, h, m, cfg, None,
                                               reduce)
    rng = np.random.default_rng(7)
    grads = [(torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              .to(cuda_device),
              torch.from_numpy(rng.uniform(0.1, 1.0, n).astype(np.float32))
              .to(cuda_device),
              torch.from_numpy(rng.random(n) < 0.8).to(cuda_device))
             for _ in range(4)]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(MeshSpec(data=1), device="cuda:0")
        all_reduce_sum(torch.zeros(1, device=cuda_device), mesh)
        reduce = histogram.shard_reduce(mesh)
        want = [tuple(t.clone() for t in body(*gh, reduce)) for gh in grads]
        run = tree.sharded_replayer(lambda *a: body(*a, reduce), True, mesh)
        assert run.capture
        before = getattr(module, counter)
        for i, gh in enumerate(grads):
            if i >= 2:
                torch.cuda.set_sync_debug_mode("error")
            try:
                got = run(*gh)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert torch.equal(got[0], want[i][0]), i
            assert torch.equal(got[1], want[i][1]), i
        torch.cuda.synchronize()
        assert run.replays == len(grads) - 1
        # the eager tree's launches, then the replays' (the capture's
        # launches counted in its tally, once a replay)
        per_tree = (getattr(module, counter) - before) // len(grads)
        assert per_tree > 0
        assert getattr(module, counter) - before == per_tree * len(grads)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_mesh_gathers_host_scores_for_logs_and_metrics(cuda_device,
                                                            tmp_path,
                                                            monkeypatch):
    """The fits whose scores stay on the host, on a one-rank NCCL mesh:
    ``train_sparse`` logging its train metric every 10th iteration and a
    DART fit with ``train_metric`` gather those host scores over NCCL (the
    collective runs on the mesh's card). Models and log lines equal the
    single-card fits'."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.gbdt import booster, sparse
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    d = _mesh_case(seed=4)
    ds = sparse.SparseDataset.from_csr(d["indptr"], d["indices"],
                                       d["values"], 512, 255)
    sp_p = booster.TrainParams(objective="binary", num_iterations=10,
                               num_leaves=15, min_data_in_leaf=5)
    dart_p = booster.TrainParams(objective="binary", num_iterations=4,
                                 num_leaves=15, min_data_in_leaf=5,
                                 boosting_type="dart", train_metric=True)
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    monkeypatch.setenv("MMLSPARK_TPU_NO_SCAN_TRAIN", "1")

    def fits(mesh):
        sp_log, dart_log = [], []
        sp = sparse.train_sparse(sp_p, ds, d["sy"], log=sp_log.append,
                                 mesh=mesh)
        dart = booster.train(dart_p, d["X"], d["y"], log=dart_log.append,
                             mesh=mesh)
        return sp.to_string(), sp_log, dart.to_string(), dart_log

    want = fits(None)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        got = fits(make_mesh(MeshSpec(data=1), device="cuda:0"))
    finally:
        dist.destroy_process_group()
    assert any("train" in line for line in got[1])
    assert len(got[3]) == 4
    assert got == want


_CUDA_DNN_RANK = r'''
import numpy as np
import torch


def step(mesh, spec, rows, steps, seed):
    """The encoder's sharded step on the card: f32 (plain attention) and
    bf16 (K5 forward, K6/K7 backward on the rank's heads), from the same
    seeded params; the launches and every param gathered."""
    from mmlspark_tpu_torch.models import flash_kernel as fk
    from mmlspark_tpu_torch.models import matmul_precision
    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.models import transformer_encoder
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, gather_tree, make_mesh

    m = make_mesh(MeshSpec(**spec), device=mesh.device, backend=mesh.backend)
    model = transformer_encoder(seq_len=256, dim=128, depth=2, num_heads=2,
                                vocab_size=100, num_classes=4, seed=seed)
    opt = T.make_optimizer(learning_rate=0.01)
    rng = np.random.default_rng(seed)
    batches = [{"x": rng.integers(0, 100, (rows, 256)),
                "y": rng.integers(0, 4, (rows, 256)).astype(np.int32)}
               for _ in range(steps)]
    out = {}
    for prec in ("float32", "bfloat16"):
        fk.launches = fk.bwd_dkv_launches = fk.bwd_dq_launches = 0
        with matmul_precision(prec):
            st = T.init_train_state(model.module, (256,), opt, seed=seed,
                                    mesh=m)
            run = T.compile_train_step(model.module, opt, mesh=m)
            losses = []
            for b in batches:
                st, met = run(st, b)
                losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        full = gather_tree(st.params, st.shardings, m)
        out[prec] = {"losses": losses,
                     "launches": (fk.launches, fk.bwd_dkv_launches,
                                  fk.bwd_dq_launches),
                     "params": {k: v.cpu().numpy() for k, v in
                                _flat(full).items()}}
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out
'''


@pytest.mark.cuda
@pytest.mark.parametrize("world,device,backend,spec", [
    (1, "cuda", "nccl", {"data": 1}),
    (2, "cuda:0", "gloo", {"data": 1, "tensor": 2})])
def test_sharded_train_step_on_the_card_equals_single_card(
        cuda_device, tmp_path, world, device, backend, spec):
    """The encoder's sharded step on the card, a one-rank NCCL mesh (every
    axis 1: NCCL's collectives run) and tensor=2 over two gloo ranks on
    ``cuda:0``: in f32 the single-card step's loss (1e-4) and params (atol
    5e-4 / rtol 1e-3, the reference's mesh tolerances); in bf16 K5 once a
    layer and step and K6/K7 once each in its backward, on the rank's
    heads, and the single-card bf16 step within 2e-2 of each leaf's max."""
    from mmlspark_tpu_torch.models import matmul_precision
    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.models import transformer_encoder
    from mmlspark_tpu_torch.models.module import _flatten
    from mmlspark_tpu_torch.parallel.launch import spawn

    (tmp_path / "cuda_dnn_rank.py").write_text(_CUDA_DNN_RANK)
    rows, steps = 4, 2
    ranks = spawn("cuda_dnn_rank:step", world, tmp_path,
                  {"spec": spec, "rows": rows, "steps": steps, "seed": 3},
                  device=device, backend=backend, timeout=300,
                  path=[str(tmp_path)])
    model = transformer_encoder(seq_len=256, dim=128, depth=2, num_heads=2,
                                vocab_size=100, num_classes=4, seed=3)
    opt = T.make_optimizer(learning_rate=0.01)
    rng = np.random.default_rng(3)
    batches = [{"x": rng.integers(0, 100, (rows, 256)),
                "y": rng.integers(0, 4, (rows, 256)).astype(np.int32)}
               for _ in range(steps)]
    for prec in ("float32", "bfloat16"):
        with matmul_precision(prec):
            st = T.init_train_state(model.module, (256,), opt, seed=3)
            run = T.compile_train_step(model.module, opt)
            losses = []
            for b in batches:
                st, met = run(st, b)
                losses.append(float(met["loss"]))
        want = {k: v.cpu().numpy() for k, v in _flatten(st.params).items()}
        for r in ranks:
            got = r[prec]
            if prec == "float32":
                assert got["launches"] == (0, 0, 0)
                np.testing.assert_allclose(got["losses"], losses, atol=1e-4)
                for k, w in want.items():
                    np.testing.assert_allclose(got["params"][k], w,
                                               atol=5e-4, rtol=1e-3,
                                               err_msg=k)
            else:
                assert got["launches"] == (2 * steps,) * 3
                np.testing.assert_allclose(got["losses"], losses, rtol=2e-2)
                for k, w in want.items():
                    scale = max(float(np.abs(w).max()), 1e-30)
                    assert np.abs(got["params"][k] - w).max() <= 2e-2 * scale, k


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_on_a_rank_head_slice(cuda_device, causal):
    """K5, K6 and K7 on a tensor rank's heads (4 of 8, the contiguous
    [B, T, H/2, D] a column-parallel projection gives): the same bits as
    those heads of the whole call, and within ``_assert_k5_close`` /
    ``_assert_bwd_close`` of the plain versions on the slice."""
    rng = np.random.default_rng(11)
    q, k, v, do = _bwd_inputs(rng, 2, 256, 256, 8, 64, cuda_device)
    part = [x[:, :, 4:].contiguous() for x in (q, k, v, do)]
    o, lse = flash_kernel.flash_attention_cuda(q, k, v, causal, lse=True)
    grads = flash_kernel.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    po, plse = flash_kernel.flash_attention_cuda(*part[:3], causal, lse=True)
    pg = flash_kernel.flash_attention_bwd_cuda(*part[:3], po, plse, part[3],
                                               causal)
    torch.cuda.synchronize()
    assert torch.equal(po, o[:, :, 4:]) and torch.equal(plse, lse[:, 4:])
    for g, full in zip(pg, grads):
        assert torch.equal(g, full[:, :, 4:])
    _assert_k5_close(po, flash_kernel.flash_attention_plain(*part[:3], causal),
                     *part[:3], causal)
    plain = flash_kernel.flash_attention_bwd_plain(*part[:3], po, plse,
                                                   part[3], causal)
    _assert_bwd_close(pg, plain, *part, causal)


_CUDA_FUSION_RANK = r'''
import numpy as np
import torch


def _chain(head, batch=8):
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.models import (Dense, DNNModel, FunctionModel,
                                           Sequential, transformer_encoder)

    enc = transformer_encoder(seq_len=256, dim=64, depth=2, num_heads=1,
                              vocab_size=100, seed=0)
    stages = [DNNModel(inputCol="tokens", outputCol="emb", batchSize=batch)
              .set_model(enc)]
    if head:
        mod = Sequential([("fc", Dense(3))], name="head")
        mod.init(torch.Generator().manual_seed(1), (256, 64))
        stages.append(DNNModel(inputCol="emb", outputCol="y", batchSize=8)
                      .set_model(FunctionModel(mod, (256, 64), name="head")))
    ids = np.random.default_rng(0).integers(0, 100, (16, 256))
    return PipelineModel(stages).fuse(), \
        DataFrame.from_dict({"tokens": ids}, num_partitions=1)


def _col(df, name):
    return np.stack(list(df.column(name)))


def run(mesh, pipe):
    """The encoder segment data-sharded over the launch's mesh (or, with
    ``pipe``, the encoder -> head chain over data x pipe 2), K5 counted;
    against the unsharded run in batches of a rank's rows (the same GEMM
    shapes) and in the segment's own batches of 8."""
    from mmlspark_tpu_torch.models import flash_kernel as fk
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    fused, df = _chain(pipe)
    col = "y" if pipe else "emb"
    want8 = _col(fused.transform(df), col)
    rows = 8 if pipe else 8 // mesh.axis_size("world")
    per_rank, _ = _chain(pipe, batch=rows)
    want = _col(per_rank.transform(df), col)
    if pipe:
        fused.set_mesh(make_mesh(MeshSpec(data=1, pipe=2),
                                 device=mesh.device, backend=mesh.backend))
        fused.set_tuning(pipe_depth=2)
    else:
        fused.set_mesh(mesh)
        fused.set_tuning(sharding={"DNNModel": "data"})
    fk.launches = 0
    got = _col(fused.transform(df), col)
    st = fused.fusion_stats()
    return {"err": float(np.abs(got - want).max()),
            "err8": float(np.abs(got - want8).max()),
            "bitwise": bool(np.array_equal(got, want)),
            "launches": fk.launches, "fallbacks": st["fallbacks"],
            "sharding": st.get("sharding"), "pipeline": st.get("pipeline")}


def run_sub_meshes(mesh):
    """Collectives on sub-meshes whose groups their members made alone
    (``mesh.sub_mesh``): the encoder segment data-sharded over the launch's
    four ranks, then re-planned onto ranks 1-3 after a wedge of rank 0's
    shard group (``MeshSupervision``); the encoder -> head chain over data
    2 x pipe 2 with each stage data-sharded over its two ranks; and the
    Tuner's agreement (``share_objects``) on the whole mesh and on the
    survivors."""
    from mmlspark_tpu_torch.models import flash_kernel as fk
    from mmlspark_tpu_torch.parallel import shardplan
    from mmlspark_tpu_torch.parallel.mesh import (MeshSpec, make_mesh,
                                                  share_objects)

    out = {"backend": mesh.backend, "device": str(mesh.device)}
    fused, df = _chain(False)
    want = _col(fused.transform(df), "emb")
    sup = shardplan.MeshSupervision(fused, mesh)
    fused.set_tuning(sharding={"DNNModel": "data"})
    out["before_err"] = float(np.abs(_col(fused.transform(df), "emb")
                                     - want).max())
    sub = sup.on_wedge(0)
    out["shared"] = share_objects(mesh.rank, mesh)
    out["shared_sub"] = share_objects(mesh.rank, sub)
    fk.launches = 0
    got = _col(fused.transform(df), "emb")
    st = fused.fusion_stats()
    out.update(after_err=float(np.abs(got - want).max()),
               after_bitwise=bool(np.array_equal(got, want)),
               after_launches=fk.launches, after_fallbacks=st["fallbacks"],
               after_sharding=st.get("sharding"))
    chain, cdf = _chain(True)
    want = _col(chain.transform(cdf), "y")
    chain.set_mesh(make_mesh(MeshSpec(data=2, pipe=2), device=mesh.device,
                             backend=mesh.backend))
    chain.set_tuning(pipe_depth=2, sharding={"DNNModel": "data"})
    fk.launches = 0
    got = _col(chain.transform(cdf), "y")
    st = chain.fusion_stats()
    out.update(pipe_err=float(np.abs(got - want).max()),
               pipe_launches=fk.launches, pipe_fallbacks=st["fallbacks"],
               pipeline=st.get("pipeline"), pipe_sharding=st.get("sharding"))
    return out
'''


@pytest.mark.cuda
@pytest.mark.parametrize("world,device,backend", [
    (1, "cuda", "nccl"), (2, "cuda:0", "gloo")])
def test_sharded_fused_segment_on_the_card(cuda_device, tmp_path, world,
                                           device, backend):
    """A fused encoder segment under the ``data`` spec on the card: two
    gloo ranks sharing ``cuda:0`` each run K5 on their 4 rows of every
    8-row batch and gather, bit for bit the unsharded run in 4-row batches
    (the same GEMM shapes: the sharding moves bits, not math), and within
    bf16's rounding (2e-2, the encoder's bf16 parity bound in
    ``test_torch_fusion.py``) of the unsharded 8-row batches, whose bf16
    GEMMs cuBLAS may sum in another order (5.3e-3 apart at these widths;
    ``chip_smoke.py``'s mesh_fused holds the full-width encoder to 1e-5).
    A one-rank NCCL mesh has one shard: the unsharded path bit for bit."""
    from mmlspark_tpu_torch.parallel.launch import spawn

    (tmp_path / "cuda_fusion_rank.py").write_text(_CUDA_FUSION_RANK)
    ranks = spawn("cuda_fusion_rank:run", world, tmp_path, {"pipe": False},
                  device=device, backend=backend, timeout=300,
                  path=[str(tmp_path)])
    for r in ranks:
        assert r["fallbacks"] == []
        assert r["launches"] == 2 * 2          # depth x batches a rank
        assert r["bitwise"] and r["err8"] <= 2e-2
        if world == 1:
            assert r["sharding"] is None
        else:
            seg = r["sharding"]["segments"]["DNNModel"]
            assert seg["shards"] == world


@pytest.mark.cuda
def test_pipelined_fused_chain_on_the_card_is_bitwise(cuda_device, tmp_path):
    """The encoder -> head chain over data 1 x pipe 2 on two gloo ranks
    sharing ``cuda:0``: stage 0 runs the encoder (K5) and hands its output
    on through host memory, stage 1 the head; both return the serial
    chain's output bit for bit."""
    from mmlspark_tpu_torch.parallel.launch import spawn

    (tmp_path / "cuda_fusion_rank.py").write_text(_CUDA_FUSION_RANK)
    ranks = spawn("cuda_fusion_rank:run", 2, tmp_path, {"pipe": True},
                  device="cuda:0", backend="gloo", timeout=300,
                  path=[str(tmp_path)])
    for r in ranks:
        assert r["bitwise"] and r["fallbacks"] == []
        pipe = r["pipeline"]
        assert pipe["depth"] == 2 and pipe["serial_fallback_partitions"] == 0
        assert r["launches"] == (2 * 2 if pipe["stage"] == 0 else 0)


@pytest.mark.cuda
def test_nccl_sub_meshes_on_four_cards(cuda_device, tmp_path):
    """NCCL collectives on sub-mesh groups made by their members alone, on
    four ranks with a card each (skips on fewer cards): the sharded encoder
    segment re-planned onto ranks 1-3 after a shard-group wedge (3 shards
    of 8-row batches; rank 0, outside, runs unsharded bit for bit) and the
    encoder -> head chain on data 2 x pipe 2 with both stages data-sharded
    over their two ranks; each within bf16's rounding (2e-2, as the one-card
    case above) of the single-card run, no fallback, K5 on every rank that
    runs the encoder; the Tuner's agreement over the whole mesh and over
    the survivors."""
    import torch

    from mmlspark_tpu_torch.parallel.launch import spawn

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    (tmp_path / "cuda_fusion_rank.py").write_text(_CUDA_FUSION_RANK)
    ranks = spawn("cuda_fusion_rank:run_sub_meshes", 4, tmp_path,
                  device="cuda", backend="nccl", timeout=600,
                  path=[str(tmp_path)])
    for rank, r in enumerate(ranks):
        assert r["backend"] == "nccl" and r["device"] == f"cuda:{rank}"
        assert r["before_err"] <= 2e-2
        assert r["shared"] == [0, 1, 2, 3]
        assert r["after_fallbacks"] == [] and r["pipe_fallbacks"] == []
        if rank == 0:
            assert r["shared_sub"] == [0] and r["after_bitwise"]
            assert r["after_sharding"] is None
        else:
            assert r["shared_sub"] == [1, 2, 3] and r["after_err"] <= 2e-2
            seg = r["after_sharding"]["segments"]["DNNModel"]
            assert seg["shards"] == 3
        assert r["after_launches"] == 2 * 2      # depth x batches
        assert r["pipe_err"] <= 2e-2
        pipe = r["pipeline"]
        assert pipe["depth"] == 2 and pipe["serial_fallback_partitions"] == 0
        assert r["pipe_sharding"]["segments"]["DNNModel"]["shards"] == 2
        assert r["pipe_launches"] == (2 * 2 if pipe["stage"] == 0 else 0)


# ------------------------------------------ featurize and train on the card
#
# Word2Vec's training step (one captured CUDA graph a step) and
# TextFeaturizer's rows through the sparse fit (K4) and the fused CSR
# transform (K3), against the port on the CPU.

def _reviews(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)]
    pos, neg = ["great", "love", "superb"], ["awful", "hate", "dull"]
    texts, y = [], []
    for i in range(n):
        label = i % 2
        toks = list(rng.choice(words, 12)) + list(rng.choice(
            pos if label else neg, 2))
        rng.shuffle(toks)
        texts.append(" ".join(toks))
        y.append(float(label))
    return texts, np.asarray(y)


@pytest.mark.cuda
def test_word2vec_on_the_card_repeats_and_matches_the_cpu(cuda_device):
    """Two fits on the card give the same bits (deterministic algorithms,
    the same captured step); their initial matrix (``threefry.normal``) is
    the CPU's bit for bit; the vectors are within 1e-4 of max |v| of a CPU
    fit (f32 sums in another order over ~60 steps)."""
    from mmlspark_tpu_torch.core import threefry
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.featurize import Word2Vec
    from mmlspark_tpu_torch.runtime import use_device

    texts, _ = _reviews(400)
    df = DataFrame.from_dict({"text": texts})
    kw = dict(inputCol="text", outputCol="v", vectorSize=32, minCount=2,
              numIterations=2, batchSize=256, seed=3)
    runs = []
    for dev in ("cuda", "cuda", "cpu"):
        with use_device(dev):
            est = Word2Vec(**kw)
            runs.append((est.fit(df).get("vectors"), est.last_losses))
    (a, la), (b, lb), (c, _) = runs
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    np.testing.assert_array_equal(la.view(np.uint32), lb.view(np.uint32))
    assert np.abs(a - c).max() <= 1e-4 * np.abs(c).max()
    key = threefry.split(threefry.prng_key(3, "cuda"), 2)[0]
    n = a.size
    np.testing.assert_array_equal(
        threefry.normal(key, n).cpu().numpy().view(np.uint32),
        threefry.normal(key.cpu(), n).numpy().view(np.uint32))


@pytest.mark.cuda
def test_text_featurizer_rows_through_k4_and_k3_on_the_card(cuda_device,
                                                           monkeypatch):
    """TextFeaturizer (2^18 features) -> LightGBMClassifier on the card's
    sparse route launches K4; the fused CSR transform launches K3, falls
    back nowhere and is within 1e-6 of the unfused one; the card's first
    trees are the CPU's on the same route."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.featurize import TextFeaturizer
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier

    texts, y = _reviews(3000, seed=1)
    df = DataFrame.from_dict({"text": texts, "label": y})
    feats = TextFeaturizer(inputCol="text", outputCol="features",
                           useStopWordsRemover=True).fit(df).transform(df)
    feats = feats.select("features", "label")
    sparse_hist_kernel.launches = 0
    model = LightGBMClassifier(numIterations=5, numLeaves=15,
                               labelCol="label").fit(feats)
    assert sparse_hist_kernel.launches > 0
    unfused = np.stack(list(model.transform(feats).column("rawPrediction")))
    label = "LightGBMClassificationModel"
    fused = PipelineModel([model]).fuse()
    fused.set_tuning(layout={label: "csr"},
                     kernel_variants={label: {"*": "forest.csr"}})
    gather_kernel.launches = 0
    got = np.stack(list(fused.transform(feats.select("features")).column(
        "rawPrediction")))
    assert gather_kernel.launches >= len(texts) // 256
    assert fused.fusion_stats()["fallbacks"] == []
    assert np.abs(got - unfused).max() <= 1e-6
    from mmlspark_tpu_torch.runtime import use_device

    monkeypatch.setenv("MMLSPARK_TPU_SCAN_TRAIN", "1")
    with use_device("cpu"):
        cpu = LightGBMClassifier(numIterations=5, numLeaves=15,
                                 labelCol="label").fit(feats)
    assert model.booster.route == cpu.booster.route == "scan"
    for ta, tb in zip(model.booster.trees, cpu.booster.trees):
        for fld in ("feature", "threshold_bin", "left", "right"):
            np.testing.assert_array_equal(getattr(ta[0], fld),
                                          getattr(tb[0], fld))


def _concurrent_case():
    from mmlspark_tpu_torch.gbdt import booster

    rng = np.random.default_rng(21)
    X = rng.standard_normal((65_536, 12))
    y = (X[:, 0] - X[:, 1] * X[:, 2] + rng.logistic(size=len(X)) > 0) * 1.0
    scan = booster.TrainParams(objective="binary", num_iterations=8,
                               num_leaves=31)
    # a validation set keeps this one off the scan: the fused per-tree
    # route, whose trees capture through graphs.Replayer
    fused = booster.TrainParams(objective="binary", num_iterations=6,
                                num_leaves=15)
    return ((scan, X, y, None), (fused, X[:32_768], y[:32_768],
                                 (X[-4096:], y[-4096:])))


def _fit_counted(case):
    from mmlspark_tpu_torch.gbdt import booster

    params, X, y, valid = case
    return booster.train(params, X, y, valid=valid, device="cuda")


@pytest.fixture(scope="module")
def serial_fits():
    """Each fit of ``_concurrent_case`` alone on the main thread: its
    LightGBM text and its K1 / K2 launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    from mmlspark_tpu_torch.core import graphs

    os.environ["MMLSPARK_TPU_NATIVE_TRAIN"] = "0"
    try:
        out = []
        for case in _concurrent_case():
            graphs.set_counters({c: 0 for c in graphs.COUNTERS})
            b = _fit_counted(case)
            out.append((b.to_string(), b.route, graphs.read_counters()))
    finally:
        del os.environ["MMLSPARK_TPU_NATIVE_TRAIN"]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("rep", range(50))
def test_two_fits_beside_a_third_capturing_thread(cuda_device, monkeypatch,
                                                  serial_fits, rep):
    """Two threads fit at once, each on its own stream (the scan route,
    and the fused per-tree route), while a third captures, replays and
    releases small graphs in a loop, under ``scan_loop_sync_mode="error"``:
    no capture fails, no thread's host read raises, both models are the
    serial fits' byte for byte, the third thread's replays are right, and
    K1 / K2 count each fit's launches once. Fifty repetitions."""
    import threading

    from mmlspark_tpu_torch.core import graphs
    from mmlspark_tpu_torch.gbdt import booster
    from mmlspark_tpu_torch.runtime import on_device

    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    monkeypatch.setattr(booster, "scan_loop_sync_mode", "error")
    cases = _concurrent_case()
    models = [None, None]
    errors, captures = [], []
    done = threading.Event()

    def fit(i):
        try:
            with on_device(cuda_device, graphs.capture_stream(cuda_device)):
                models[i] = _fit_counted(cases[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def capture():
        try:
            with on_device(cuda_device, graphs.capture_stream(cuda_device)):
                x = torch.arange(4096, dtype=torch.float32,
                                 device=cuda_device)
                (x * 2 + 1).sum()
                while not done.is_set():
                    cap = graphs.Captured(lambda: (x * 2 + 1).sum())
                    got = float(cap.replay())
                    cap.release()
                    captures.append(got == float(4096 * 4096))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    graphs.set_counters({c: 0 for c in graphs.COUNTERS})
    third = threading.Thread(target=capture)
    third.start()
    fitters = [threading.Thread(target=fit, args=(i,)) for i in range(2)]
    for t in fitters:
        t.start()
    for t in fitters:
        t.join(timeout=120)
    done.set()
    third.join(timeout=60)
    assert not any(t.is_alive() for t in fitters + [third])
    assert not errors, errors
    assert captures and all(captures)
    got = graphs.read_counters()
    for (text, route, counts), model in zip(serial_fits, models):
        assert model.route == route
        assert model.to_string() == text
    assert [m.route for m in models] == ["scan", "fused"]
    assert got == {c: serial_fits[0][2].get(c, 0)
                   + serial_fits[1][2].get(c, 0) for c in got}
    assert got[("mmlspark_tpu_torch.gbdt.hist_kernel", "launches")] \
        + got[("mmlspark_tpu_torch.gbdt.hist_kernel", "count_launches")] > 0


@pytest.mark.cuda
def test_scan_keeps_its_sync_proof_alone_and_drops_it_beside_a_worker(
        cuda_device, monkeypatch):
    """Alone on the main thread the scan's loop runs under the sync debug
    mode (``last_scan_guarded``); while another thread works it does not
    set the process's mode, and that thread's host reads do not raise."""
    import threading

    from mmlspark_tpu_torch.gbdt import booster
    from mmlspark_tpu_torch.runtime import working

    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    monkeypatch.setattr(booster, "scan_loop_sync_mode", "error")
    params, X, y, _ = _concurrent_case()[0]
    b = booster.train(params, X, y, device="cuda")
    assert b.route == "scan" and booster.last_scan_guarded is True
    busy, stop = threading.Event(), threading.Event()
    reads = []

    def reader():
        with working():
            busy.set()
            t = torch.ones(8, device=cuda_device)
            while not stop.is_set():
                reads.append(float(t.sum()))

    th = threading.Thread(target=reader)
    th.start()
    busy.wait(timeout=60)
    try:
        b2 = booster.train(params, X, y, device="cuda")
    finally:
        stop.set()
        th.join(timeout=60)
    assert booster.last_scan_guarded is False
    assert b2.to_string() == b.to_string()
    assert reads and all(r == 8.0 for r in reads)
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_lasso_graph_replays_equal_eager_and_the_cpu(cuda_device):
    """A shape's first call eager, its second captured, the later ones
    replayed: the same bits; within 1e-4 * max(1, max|w|) of the CPU."""
    from mmlspark_tpu_torch.ops import lasso

    rng = np.random.default_rng(2)
    X = rng.normal(size=(64, 1000, 12)).astype(np.float32)
    y = (X @ rng.normal(size=12) + 0.1 * rng.normal(size=(64, 1000))
         ).astype(np.float32)
    runs = [lasso.fit_lasso_batch(X, y, 0.01, device="cuda")
            for _ in range(4)]
    for w, b in runs[1:]:
        assert torch.equal(w, runs[0][0]) and torch.equal(b, runs[0][1])
    cw, cb = lasso.fit_lasso_batch(X, y, 0.01, device="cpu")
    tol = 1e-4 * max(1.0, float(cw.abs().max()))
    assert float((runs[0][0].cpu() - cw).abs().max()) <= tol
    assert float((runs[0][1].cpu() - cb).abs().max()) <= tol
    lasso.release_graphs()


@pytest.mark.cuda
def test_sar_and_slic_on_the_card_equal_the_cpu(cuda_device):
    """SAR's affinity and similarity on the card bitwise the CPU's (with
    repeated events), its scores within rtol 1e-5 and its top 10 by the
    tie rule; slic's labels on the card bitwise the CPU's."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.lime import slic
    from mmlspark_tpu_torch.recommendation import SAR
    from mmlspark_tpu_torch.runtime import use_device

    rng = np.random.default_rng(5)
    n = 20_000
    cols = {"user": rng.integers(0, 500, n), "item": rng.zipf(1.3, n) % 300,
            "rating": rng.integers(1, 11, n) * 0.5,
            "time": 1.2e9 + rng.integers(0, 4e8, n).astype(np.float64)}
    df = DataFrame.from_dict(cols)
    est = SAR(userCol="user", itemCol="item", ratingCol="rating",
              timeCol="time", supportThreshold=4)
    card = est.fit(df)
    with use_device("cpu"):
        cpu = est.fit(df)
        cpu_recs = cpu.recommend_for_all_users(10)
        cpu_scores = cpu._scores(remove_seen=False)
    for p in ("userAffinity", "itemSimilarity"):
        assert torch.equal(card.get(p).cpu(), cpu.get(p))
    scores = card._scores(remove_seen=False).cpu()
    assert bool(((scores - cpu_scores).abs()
                 <= 1e-5 * cpu_scores.abs()).all())
    recs = card.recommend_for_all_users(10)
    for a, b in zip(recs.column("ratings"), cpu_recs.column("ratings")):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    img = rng.integers(0, 255, (256, 256, 3)).astype(np.uint8)
    np.testing.assert_array_equal(slic(img, device="cuda"),
                                  slic(img, device="cpu"))
