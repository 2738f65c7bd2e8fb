"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped on a host without CUDA. This file imports neither JAX nor the
reference package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.gbdt import hist_kernel, select_kernel, sparse_hist_kernel


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


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_select_kernel_bitwise_matches_plain(cuda_device, density):
    bins, grad, hess, mask = _inputs(300_001, 28, 256, density, cuda_device)
    cap = 300_032
    a = select_kernel.select_rows_cuda(bins, grad, hess, mask, cap)
    b = select_kernel.select_rows_plain(bins, grad, hess, mask, cap)
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
