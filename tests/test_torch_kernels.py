"""The port's kernel modules against the JAX reference, on the CPU.

K1 (``mmlspark_tpu_torch.gbdt.hist_kernel``), K2 (``select_kernel``) and K5
(``mmlspark_tpu_torch.models.flash_kernel``) are CUDA kernels; on a CPU
tensor their wrappers run the plain PyTorch version, which is what these
tests hold against the reference's Pallas kernels (run in interpret mode;
for K5, JAX's library flash-attention kernel) and its XLA formulations. The
same inputs, made with numpy from a seed, go through both. The CUDA kernels
themselves are held against the plain versions by
``tests/test_torch_cuda.py`` (skipped without a card) and by
``chip_smoke.py`` on the card.

Tolerances, and why:
  - K1: the count channel is exact (integer sums below 2^24); grad and hess
    sums differ from the reference's by summation order only (the port
    accumulates in f64 and rounds once, the reference adds in f32), so
    |port - ref| <= 1e-5 * sum|v| over the bin's rows + 1e-6;
  - K5's plain version against the Pallas flash kernel (bf16, normal(0,
    1)): max |d| <= 0.02 (measured 0.0156, one bf16 ulp of the output); the
    Pallas kernel within 0.01 of an f64 recomputation (measured 0.0071).
    The plain version is the reference's XLA path, whose own error against
    f64 reaches 0.0122 on causal rows that see few keys (its probabilities
    are rounded to bf16 after normalising): it is held within 0.0125 of f64
    and within 0.001 of the XLA path's own error. Where that error itself
    passes 0.0125 (causal rows at D = 512 and 640, T = 128: 0.0128,
    0.0140), the plain version is held within 0.001 of it and the Pallas
    kernel (0.0117 at D = 640) within it;
  - K5's plain version against the reference's ``dense_attention`` (its
    XLA path): 0.02 in bf16 (the same rounding steps; the f32 sums differ
    in order), 1e-5 in f32, the offset and all-masked cases included;
  - K5's gate: the same decision as the reference's ``_flash_dispatch`` on
    the reference's own gate shapes;
  - K5's tiled arithmetic, emulated in f32 key tile by key tile (test code
    only): the chip's gates on the kernel, <= 4 bf16 ulps of sum_j p_j |v_j|
    from the plain version per element and <= 1.5x the plain version's max
    and rms error against f64, at each key-tile width the kernel uses;
  - the backward (K6/K7's plain version and ``FlashAttention`` on CPU
    tensors) against the library's own backward kernels in interpret mode,
    on the same bf16 inputs and output gradient: each of dq, dk, dv within
    2% of the library's max magnitude of it (both round P and dS to bf16
    and the result once; they differ in where those roundings land), and
    its max error against an f64 backward of the same inputs at most 1.5x
    the library's plus 1e-3 of the f64 gradient's magnitude;
  - the plain forward's row log-sum-exp against the library's residuals
    ``m + log(l)``: 1e-5 (both take f32 scores scaled in f32; they differ
    in summation order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (BlockSizes,
                                                             _flash_attention,
                                                             flash_attention)

from mmlspark_tpu.gbdt import histogram as ref_hist
from mmlspark_tpu.gbdt import pallas_hist, pallas_select
from mmlspark_tpu.models import attention as ref_attention
from mmlspark_tpu.models.module import matmul_precision as ref_precision
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.gbdt import hist_kernel, select_kernel
from mmlspark_tpu_torch.models import (DNNModel, attention, dense_attention,
                                       flash_kernel, flash_route,
                                       transformer_encoder)
from mmlspark_tpu_torch.runtime import use_device


def _hist_inputs(n, f, b, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, (f, n)).astype(np.int32)
    grad = rng.standard_normal(n).astype(np.float32)
    hess = rng.random(n).astype(np.float32)
    mask = rng.random(n) < 0.6
    return bins, grad, hess, mask


def _abs_sums(bins, vals, mask, b):
    """[F, B] sum of |v| over each bin's masked rows (the tolerance scale)."""
    out = np.zeros((bins.shape[0], b))
    w = np.abs(vals.astype(np.float64)) * mask
    for fi in range(bins.shape[0]):
        out[fi] = np.bincount(bins[fi], weights=w, minlength=b)
    return out


def _port_hist(bins, grad, hess, mask, b):
    return hist_kernel.histogram(torch.from_numpy(bins), torch.from_numpy(grad),
                                 torch.from_numpy(hess), torch.from_numpy(mask),
                                 b).numpy()


@pytest.mark.parametrize("b", [2, 17, 256])
@pytest.mark.parametrize("f", [1, 3, 70])
@pytest.mark.parametrize("n", [1, 1000, 1537])
def test_hist_plain_matches_reference(n, f, b):
    bins, grad, hess, mask = _hist_inputs(n, f, b, seed=n * 131 + f * 7 + b)
    got = _port_hist(bins, grad, hess, mask, b)
    assert got.shape == (f, b, 3) and got.dtype == np.float32

    xla = np.asarray(ref_hist.compute_histogram_xla(bins, grad, hess, mask, b))
    mxu = np.asarray(pallas_hist.compute_histogram_mxu(
        bins, grad, hess, mask, b, interpret=True, hilo=False))
    for ref in (xla, mxu):
        np.testing.assert_array_equal(got[..., 2], ref[..., 2])
        for ch, vals in ((0, grad), (1, hess)):
            tol = 1e-5 * _abs_sums(bins, vals, mask, b) + 1e-6
            assert (np.abs(got[..., ch] - ref[..., ch]) <= tol).all(), ch


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_select_plain_bitwise_matches_reference(density):
    rng = np.random.default_rng(int(density * 10) + 3)
    n, f, cap = 5000, 5, 5120
    bins = rng.integers(0, 256, (f, n)).astype(np.int32)
    grad = rng.standard_normal(n).astype(np.float32)
    hess = rng.random(n).astype(np.float32)
    mask = rng.random(n) < density
    ref = pallas_select.select_rows(bins, grad, hess, mask, cap, interpret=True)
    got = select_kernel.select_rows(torch.from_numpy(bins), torch.from_numpy(grad),
                                    torch.from_numpy(hess), torch.from_numpy(mask),
                                    cap)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype
        np.testing.assert_array_equal(g.numpy(), r)
    k = int(mask.sum())
    assert (got[0][:, k:] == 0).all() and (got[1][k:] == 0).all()


def test_wrappers_take_plain_path_on_cpu_without_launching():
    bins, grad, hess, mask = _hist_inputs(700, 4, 33)
    h0, s0 = hist_kernel.launches, select_kernel.launches
    t = [torch.from_numpy(a) for a in (bins, grad, hess, mask)]
    hist_kernel.histogram(*t, 33)
    select_kernel.select_rows(*t, 1024)
    assert (hist_kernel.launches, select_kernel.launches) == (h0, s0)


def test_note_launch_counts_on_the_counter_or_the_capturing_threads_tally():
    """Every kernel wrapper counts through ``graphs.note_launch``: on its
    module's counter, or, while the calling thread captures a graph, into
    that capture's tally alone (which ``Captured`` adds on each replay);
    another thread's launches meanwhile stay on the counter."""
    import threading

    from mmlspark_tpu_torch.core import graphs
    from mmlspark_tpu_torch.gbdt import gather_kernel, sparse_hist_kernel
    from mmlspark_tpu_torch.models import flash_kernel

    for mod in (hist_kernel, select_kernel, sparse_hist_kernel, gather_kernel,
                flash_kernel):
        assert (mod.__name__, "launches") in graphs.COUNTERS
    assert (hist_kernel.__name__, "count_launches") in graphs.COUNTERS
    key = (hist_kernel.__name__, "launches")
    h0 = hist_kernel.launches
    try:
        graphs.note_launch(*key)
        assert hist_kernel.launches == h0 + 1
        graphs._tls.tally = tally = {}
        try:
            graphs.note_launch(*key, 2)
            other = threading.Thread(target=graphs.note_launch, args=key)
            other.start()
            other.join()
        finally:
            graphs._tls.tally = None
        assert tally == {key: 2}
        assert hist_kernel.launches == h0 + 2
    finally:
        hist_kernel.launches = h0


@pytest.mark.parametrize("n", [0, 1, 2048, 2049, 300_001, 2_097_152,
                               2_500_000, 2**31 - 1])
def test_select_grid_covers_the_rows(n):
    """K2's grid, sized in Python: whole 2048-row chunks per block, 1 to
    1024 blocks (each block sums the counts of those before it), covering
    every row and no block wholly past the end (an empty mask still gets
    one block, which writes the zero outputs)."""
    rows, blocks = select_kernel.row_blocks(n)
    assert rows % select_kernel.CHUNK_ROWS == 0 and rows > 0
    assert 1 <= blocks <= select_kernel.MAX_BLOCKS
    assert rows * blocks >= n and (blocks == 1 or rows * (blocks - 1) < n)


@pytest.mark.parametrize("b", [2, 17, 256, 1024, 2048, 2049, 20000])
@pytest.mark.parametrize("f", [1, 28, 65, 200])
def test_hist_launch_geometry(f, b):
    """K1's grid, sized in Python: a block's feature group fits the 227 KB
    a block may opt into, the groups cover every feature once, the row
    blocks every row once in whole 4-row quads, and the scratch holds one
    f64 partial per row block; a histogram too wide for one feature a block
    takes the global path."""
    for n in (1, 1537, 131_072, 2_097_152):
        geo = hist_kernel.launch_geometry(n, f, b)
        if b * hist_kernel.CELL_BYTES + hist_kernel.AGG_BYTES \
                > hist_kernel.SMEM_BLOCK_MAX:
            assert geo.feat_per_block == 0 and geo.scratch == f * b * 3
        else:
            fpb, groups = geo.feat_per_block, geo.groups
            assert 1 <= fpb <= f and fpb * groups >= f > fpb * (groups - 1)
            assert geo.smem_bytes <= hist_kernel.SMEM_BLOCK_MAX
            assert geo.smem_bytes >= fpb * b * hist_kernel.CELL_BYTES
            assert geo.scratch == geo.row_blocks * f * b * 3
            if f == 28 and b == 256:   # the dense main path: one group
                assert groups == 1
            assert geo.row_blocks * groups <= 2 * hist_kernel.SMS
        rows, blocks = geo.rows_per_block, geo.row_blocks
        assert rows % 4 == 0 and blocks >= 1
        assert rows * blocks >= n > rows * (blocks - 1)


#: CTAs sharing a row tile, each writing its own output columns: K5 halves
#: them at D = 384 and 512 and cuts 128-column slices above; K6 and K7 cut
#: 128-column slices from 384 up (``Sm90Cfg``, ``SlicedCfg``,
#: ``DkvSlicedCfg``, ``DqSlicedCfg``)
FWD_SLICES = {384: 2, 512: 2, 640: 5, 768: 6, 1024: 8, 2048: 16}
BWD_SLICES = {384: 3, 512: 4, 640: 5, 768: 6, 1024: 8, 2048: 16}


def _columns_once(hy, h, slices, d):
    """Every (head, output column) of a row tile written by exactly one
    slot's slice, as the kernels decode a slot (slices of a head adjacent)."""
    width = d // slices
    cover = np.zeros((h, d), dtype=np.int64)
    for slot in np.unique(hy):
        head, sl = divmod(int(slot), slices)
        cover[head, sl * width:(sl + 1) * width] += 1
    np.testing.assert_array_equal(cover, np.ones((h, d), dtype=np.int64))


@pytest.mark.parametrize("b,tq,h,d", [(1, 64, 1, 64), (3, 2048, 8, 64),
                                      (5, 1024, 3, 384), (2, 640, 2, 512),
                                      (2, 320, 3, 640), (1, 1024, 2, 1024),
                                      (3, 192, 1, 2048),
                                      (65_537, 128, 1, 64),
                                      (1 << 20, 128, 1, 64)])
def test_flash_grid_decode_covers_every_block(b, tq, h, d):
    """K5's 1-D grid: every (batch, head x column slice, query block) once,
    query blocks fastest (the order of the 3-D grid it replaces), each
    head's output columns written once across its slices, and a batch past
    grid.z's 65,535 cap."""
    m_blocks, hc, total = flash_kernel.launch_grid(b, tq, h, d)
    assert m_blocks * (192 if d == 64 else 128) >= tq > m_blocks * 128 - 192
    slices = FWD_SLICES.get(d, 1)
    assert flash_kernel.col_slices(d) == slices
    assert hc == h * slices
    assert total == m_blocks * hc * b <= flash_kernel.MAX_GRID_BLOCKS
    block = np.arange(total, dtype=np.int64)
    bi, hy, m = flash_kernel.grid_decode(block, m_blocks, hc)
    assert bi.min() == 0 and bi.max() == b - 1
    np.testing.assert_array_equal((bi * hc + hy) * m_blocks + m, block)
    assert ((hy >= 0) & (hy < hc) & (m >= 0) & (m < m_blocks)).all()
    _columns_once(hy, h, slices, d)


def test_flash_grid_limit_raises():
    m_blocks, hc, total = flash_kernel.launch_grid(1 << 24, 8192, 16, 512)
    assert total > flash_kernel.MAX_GRID_BLOCKS
    assert flash_kernel.launch_grid(65_537, 128, 1, 64)[2] == 65_537


def test_select_gate_is_the_reference_gate():
    assert not select_kernel.use_select(499_999)
    assert select_kernel.use_select(500_000)
    assert pallas_select.use_select(499_999, interpret=True) is False
    assert pallas_select.use_select(500_000, interpret=True) is True


# ---------------------------------------------------------------------------
# K5: the attention's plain version and its gate
# ---------------------------------------------------------------------------


PALLAS_TOL = 0.02       # plain vs the Pallas kernel, bf16
F64_TOL = 0.01          # the Pallas kernel vs an f64 recomputation
XLA_F64_TOL = 0.0125    # the XLA path (and so the plain version) vs f64
XLA_BF16_TOL = 0.02     # plain vs the reference's XLA path, bf16
XLA_F32_TOL = 1e-5      # the same in f32


def _qkv(shape, seed, tk=None):
    """q [B, T, H, D] and k/v [B, Tk, H, D], f32 normal(0, 1)."""
    rng = np.random.default_rng(seed)
    b, t, h, d = shape
    kshape = (b, tk or t, h, d)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(kshape).astype(np.float32),
            rng.standard_normal(kshape).astype(np.float32))


def _bf16_np(a):
    """f32 array -> its bf16 rounding, as f32 (exact in both frameworks)."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _port(arrs, dtype=torch.bfloat16):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _f64_attention(q, k, v, causal):
    """Exact attention in f64 on [B, T, H, D] inputs."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[1]
        s = np.where(np.triu(np.ones((t, t), bool), 1), -np.inf, s)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def _pallas(q, k, v, causal):
    """JAX's library flash-attention kernel (what the reference's
    ``_flash_dispatch`` calls on a TPU), in TPU interpret mode."""
    tr = [jnp.asarray(a).astype(jnp.bfloat16).transpose(0, 2, 1, 3)
          for a in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        o = flash_attention(*tr, causal=causal,
                            sm_scale=1.0 / math.sqrt(q.shape[-1]))
    return np.asarray(o.transpose(0, 2, 1, 3).astype(jnp.float32))


@pytest.mark.parametrize("shape,causal", [
    ((2, 256, 4, 64), False), ((2, 256, 4, 64), True),
    ((1, 1024, 2, 64), False), ((1, 1024, 2, 64), True),
    ((1, 256, 1, 128), False), ((1, 256, 1, 128), True),
    # every head dim the gate admits takes the kernels: the tuned ones and
    # the sliced ones above them
    ((1, 256, 1, 256), False), ((1, 256, 1, 256), True),
    ((1, 128, 1, 384), False), ((1, 128, 1, 384), True),
    ((1, 128, 1, 512), False), ((1, 128, 1, 512), True),
    ((1, 128, 1, 640), False), ((1, 128, 1, 640), True),
    ((1, 128, 1, 768), False), ((1, 128, 1, 768), True)])
def test_plain_matches_pallas_flash_kernel(shape, causal):
    q, k, v = _qkv(shape, seed=3)
    ref = _pallas(q, k, v, causal)
    got = flash_kernel.flash_attention_plain(*_port((q, k, v)), causal)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    got = got.float().numpy()
    assert np.abs(got - ref).max() <= PALLAS_TOL
    exact = _f64_attention(*(_bf16_np(a) for a in (q, k, v)), causal)
    xla = ref_attention.dense_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=causal)
    xla_err = np.abs(np.asarray(xla.astype(jnp.float32)) - exact).max()
    # the caps hold where the reference's XLA path meets its own (every
    # shape at D <= 256); on causal rows at D = 512 and 640 (T = 128) that
    # path errs by 0.0128 and 0.0140 and the library's kernel by up to
    # 0.0117, and both the kernel and the plain version are held to the XLA
    # path's error instead
    within = xla_err <= XLA_F64_TOL
    assert np.abs(ref - exact).max() <= (F64_TOL if within else xla_err)
    cap = XLA_F64_TOL if within else xla_err
    assert np.abs(got - exact).max() <= min(cap, xla_err + 1e-3)


@pytest.mark.parametrize("shape,tk,causal", [
    ((2, 32, 2, 8), None, False), ((2, 32, 2, 8), None, True),
    ((1, 64, 2, 64), None, True), ((1, 16, 2, 16), 48, False),
    ((1, 128, 1, 128), None, False)])
def test_plain_matches_reference_dense_attention_bf16(shape, tk, causal):
    q, k, v = _qkv(shape, seed=7, tk=tk)
    ref = ref_attention.dense_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=causal)
    assert ref.dtype == jnp.bfloat16
    got = dense_attention(*_port((q, k, v)), causal=causal)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert diff.max() <= XLA_BF16_TOL


@pytest.mark.parametrize("shape,tk,causal,q_off,k_off", [
    ((2, 32, 2, 8), None, False, 0, 0), ((2, 32, 2, 8), None, True, 0, 0),
    ((1, 4, 1, 4), None, True, 0, 100),      # every query before every key
    ((1, 4, 1, 4), 8, True, 4, 0),           # second query block of 8
    ((1, 8, 2, 4), None, True, 3, 5)])
def test_plain_matches_reference_dense_attention_f32(shape, tk, causal,
                                                     q_off, k_off):
    q, k, v = _qkv(shape, seed=5, tk=tk)
    with ref_precision("float32"):
        ref = np.asarray(ref_attention.dense_attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
            q_offset=q_off, k_offset=k_off))
    got = dense_attention(*_port((q, k, v), torch.float32), causal=causal,
                          q_offset=q_off, k_offset=k_off)
    assert got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=XLA_F32_TOL, rtol=0)
    if k_off == 100:
        assert not got.numpy().any()


def test_offset_blocks_recompose_full_causal():
    """Two-block streaming with offsets == full causal attention (the
    reference's own check, tests/test_attention.py)."""
    q, k, v = _port(_qkv((1, 8, 1, 4), seed=6), torch.float32)
    want = dense_attention(q, k, v, causal=True)
    got = dense_attention(q[:, 4:], k, v, causal=True, q_offset=4)
    np.testing.assert_allclose(got.numpy(), want[:, 4:].numpy(), atol=1e-6)


# (B, T, H, D, dtype, causal, q_offset, Tk) — the reference's gate shapes
# (tests/test_attention.py) and its other conditions
GATE_CASES = [
    ((1, 96, 2, 64), "bfloat16", False, 0, None),    # T % 128
    ((1, 128, 2, 48), "bfloat16", False, 0, None),   # head dim
    ((1, 128, 2, 64), "bfloat16", False, 4, None),   # shard offset
    ((1, 128, 2, 64), "bfloat16", False, 0, None),   # accepted
    ((1, 128, 2, 64), "float32", False, 0, None),    # f32 stays exact
    ((1, 128, 1, 64), "bfloat16", True, 0, 256),     # causal, Tq != Tk
    ((1, 128, 1, 64), "bfloat16", False, 0, 256),    # cross, accepted
    ((1, 128, 1, 128), "bfloat16", True, 0, None),   # D = 128, accepted
    ((1, 256, 1, 64), "bfloat16", True, 0, 32),      # Tk % 128
    ((1, 128, 1, 640), "bfloat16", False, 0, None),  # D = 640, accepted
    ((1, 128, 1, 192), "bfloat16", False, 0, None),  # D % 128
]


def _gate_pair(monkeypatch, shape, dtype, causal, q_off, tk):
    """(reference routes to its flash kernel, port routes to K5) for one
    case, with the reference on a pretended TPU and the port's device test
    accepting CPU tensors."""
    q, k, v = _qkv(shape, seed=1, tk=tk)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        ref = ref_attention._flash_dispatch(jq, jk, jv, causal, q_off, 0)
    pq, pk = _port((q, k), getattr(torch, dtype))
    return ref is not None, flash_route(pq, pk, causal, q_off, 0)


@pytest.mark.parametrize("case", GATE_CASES)
def test_gate_matches_reference_flash_dispatch(monkeypatch, case):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(attention, "_kernel_device", lambda q: True)
    monkeypatch.setenv("MMLSPARK_TPU_FLASH_MIN_T", "64")
    ref, port = _gate_pair(monkeypatch, *case)
    assert port == ref


def test_gate_kill_switch_and_min_length(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(attention, "_kernel_device", lambda q: True)
    case = ((1, 128, 2, 64), "bfloat16", False, 0, None)
    monkeypatch.setenv("MMLSPARK_TPU_FLASH_MIN_T", "256")
    assert _gate_pair(monkeypatch, *case) == (False, False)
    monkeypatch.setenv("MMLSPARK_TPU_FLASH_MIN_T", "128")
    assert _gate_pair(monkeypatch, *case) == (True, True)
    monkeypatch.setenv("MMLSPARK_TPU_NO_FLASH", "1")
    assert _gate_pair(monkeypatch, *case) == (False, False)


def test_gate_keeps_cpu_tensors_on_the_plain_path(monkeypatch):
    """Without a CUDA device the gate never routes (the reference: not a
    TPU backend). On the kernel's device it routes every length the
    reference's conditions admit (no length threshold by default) and
    every head dim they admit, 64 or a multiple of 128: the tuned ones
    (up to 512) and the sliced ones above, 640 to 2048 included, none
    raising; 192 stays on the plain path, as in the reference."""
    q, k, _ = _port(_qkv((1, 128, 2, 64), seed=0))
    assert not flash_route(q, k, False)
    monkeypatch.setattr(attention, "_kernel_device", lambda q: True)
    assert flash_route(q, k, False)
    for d in (384, 512, 640, 768, 1024, 2048):
        q, k, _ = _port(_qkv((1, 128, 1, d), seed=0))
        assert flash_route(q, k, True) and flash_route(q, k, False), d
        assert flash_kernel.head_dim_ok(d)
        flash_kernel._check_inputs(q, k, k, True)    # the wrapper takes it
    q192, k192, _ = _port(_qkv((1, 128, 1, 192), seed=0))
    assert not flash_route(q192, k192, False)
    assert not flash_kernel.head_dim_ok(192)
    monkeypatch.setenv("MMLSPARK_TPU_NO_FLASH", "1")
    assert not flash_route(q, k, False)



def _k5_tiled(q, k, v, causal, kn, rescale=True, chunk=None, cols=None):
    """K5's arithmetic (``csrc/flash_attn.cu``) on the CPU, key tile by key
    tile of ``kn`` keys: f32 scores of the bf16 inputs, keys past Tk (the
    kernel's zero-filled loads) and, under causal masking, keys after the
    query masked to -inf; a running row max m in score units; p = exp2(s *
    c - m * c) with c = log2(e) / sqrt(D), one rounding as the kernel's fma;
    the accumulator and the row sum l rescaled by exp2(m_old * c - m * c)
    per tile, l summed from the unrounded p, P rounded to bf16 unnormalised
    before P V; the output divided by l once and rounded to bf16.
    ``rescale=False`` leaves the per-tile rescale out: the fault the ulp
    gate exists to catch. ``chunk`` sums the scores over D in chunks of
    that many columns, in order, and ``cols`` = (lo, hi) computes only
    those output columns: one CTA of the general path above D = 512."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    c = math.log2(math.e) / math.sqrt(d)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # [B, H, T, D]
    lo, hi = cols or (0, d)
    pad = -tk % kn
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    vf = torch.nn.functional.pad(vf[..., lo:hi], (0, 0, 0, pad))
    m = torch.full((b, h, tq, 1), -math.inf)
    l = torch.zeros(b, h, tq, 1)
    o = torch.zeros(b, h, tq, hi - lo)
    rows = torch.arange(tq)[:, None]
    for n0 in range(0, tk + pad, kn):
        keys = torch.arange(n0, n0 + kn)[None, :]
        s = torch.zeros(b, h, tq, kn)
        for c0 in range(0, d, chunk or d):
            s = s + qf[..., c0:c0 + (chunk or d)] @ \
                kf[:, :, n0:n0 + kn, c0:c0 + (chunk or d)].transpose(-1, -2)
        hidden = (keys >= tk) | ((keys > rows) if causal else False)
        s = s.masked_fill(hidden, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        msc = torch.where(m_new == -math.inf, 0.0, m_new * c)
        corr = torch.exp2(m * c - msc) if rescale else torch.ones_like(m)
        p = torch.exp2((s.double() * c - msc.double()).float())
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + p.to(torch.bfloat16).float() @ vf[:, :, n0:n0 + kn]
        m = m_new
    out = torch.where(l > 0, o / l, torch.zeros_like(o))
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("kn", [64, 128])
@pytest.mark.parametrize("shape,tk,causal", [
    ((2, 256, 2, 64), None, False), ((2, 256, 2, 64), None, True),
    ((1, 192, 2, 128), None, True), ((1, 64, 2, 128), 320, False),
    ((1, 320, 1, 256), None, True)])
def test_k5_tiled_arithmetic_within_chip_gates(shape, tk, causal, kn):
    """The chip's gates on K5 hold for its tile-by-tile arithmetic at each
    key-tile width, causal rows that see few keys included: the headroom of
    a new tile width, shown before any chip run."""
    q, k, v = _port(_qkv(shape, seed=11, tk=tk))
    got = _k5_tiled(q, k, v, causal, kn)
    plain = flash_kernel.flash_attention_plain(q, k, v, causal)
    exact = _f64_attention(q.float().numpy(), k.float().numpy(),
                           v.float().numpy(), causal)
    scale = _f64_attention(q.float().numpy(), k.float().numpy(),
                           np.abs(v.float().numpy()), causal)
    got, plain = got.double().numpy(), plain.double().numpy()
    _, e = np.frexp(scale.astype(np.float32))
    ulps = np.abs(got - plain) / np.ldexp(1.0, e - 8)
    assert ulps.max() <= 4.0
    k5_err, plain_err = got - exact, plain - exact
    assert np.abs(k5_err).max() <= 1.5 * np.abs(plain_err).max()
    assert np.square(k5_err).mean() <= 1.5 ** 2 * np.square(plain_err).mean()
    # the emulation is K5's arithmetic, not the plain version's: dropping
    # the per-tile rescale moves it far past the ulp gate
    if kn < (tk or shape[1]):
        broken = _k5_tiled(q, k, v, causal, kn, rescale=False)
        broken = broken.double().numpy()
        assert (np.abs(broken - plain) / np.ldexp(1.0, e - 8)).max() > 4.0


def _k5_sliced(q, k, v, causal, kdv=128, drop_chunk=False):
    """K5's general path (``flash_fwd_sliced``, D above 512) on the CPU: one
    ``_k5_tiled`` per ``kdv``-column slice of the output (a CTA's), 128-key
    tiles, S summed over D's 64-column chunks in order. Every slice sums
    the same S in the same order (the recompute gives the same bits);
    ``drop_chunk`` leaves D's last chunk out of S (its K columns zeroed),
    the fault a lost ring stage would be."""
    d = q.shape[-1]
    if drop_chunk:
        k = k.clone()
        k[..., d - 64:] = 0
    return torch.cat([_k5_tiled(q, k, v, causal, 128, chunk=64,
                                cols=(c0, c0 + kdv))
                      for c0 in range(0, d, kdv)], dim=-1)


@pytest.mark.parametrize("shape,tk,causal", [
    ((1, 256, 2, 640), None, False), ((1, 256, 2, 640), None, True),
    ((1, 192, 1, 768), 320, False), ((1, 128, 1, 1024), None, True)])
def test_k5_sliced_arithmetic_within_chip_gates(shape, tk, causal):
    """The chip's gates on K5 hold for the general path's arithmetic (S
    summed over 64-column chunks, the output in 128-column slices), causal
    rows that see few keys and a ragged last key tile included; a chunk
    left out of S moves it far past the ulp gate."""
    q, k, v = _port(_qkv(shape, seed=17, tk=tk))
    got = _k5_sliced(q, k, v, causal)
    plain = flash_kernel.flash_attention_plain(q, k, v, causal)
    qn, kn_, vn = (x.float().numpy() for x in (q, k, v))
    exact = _f64_attention(qn, kn_, vn, causal)
    scale = _f64_attention(qn, kn_, np.abs(vn), causal)
    got, plain = got.double().numpy(), plain.double().numpy()
    _, e = np.frexp(scale.astype(np.float32))
    ulp = np.ldexp(1.0, e - 8)
    assert (np.abs(got - plain) / ulp).max() <= 4.0
    k5_err, plain_err = got - exact, plain - exact
    assert np.abs(k5_err).max() <= 1.5 * np.abs(plain_err).max()
    assert np.square(k5_err).mean() <= 1.5 ** 2 * np.square(plain_err).mean()
    broken = _k5_sliced(q, k, v, causal, drop_chunk=True).double().numpy()
    assert (np.abs(broken - plain) / ulp).max() > 4.0


def test_wrapper_checks_kernel_inputs():
    q, k, v = _port(_qkv((1, 128, 2, 64), seed=0))
    with pytest.raises(TypeError):
        flash_kernel._check_inputs(q.float(), k, v, False)
    with pytest.raises(ValueError):
        flash_kernel._check_inputs(q[:, :100], k, v, False)
    with pytest.raises(ValueError):
        flash_kernel._check_inputs(q, k[:, :64], v[:, :64], True)
    with pytest.raises(ValueError):
        flash_kernel._check_inputs(q[..., :48].contiguous(), k, v, False)
    with pytest.raises(ValueError):   # a broadcast batch: stride 0
        flash_kernel._check_inputs(q.expand(2, -1, -1, -1), k.expand(2, -1, -1, -1),
                                   v.expand(2, -1, -1, -1), False)
    flash_kernel._check_inputs(q, k, v, True)
    # a CPU tensor runs the plain version, another device raises
    assert torch.equal(flash_kernel.flash_attention(q, k, v, True),
                       flash_kernel.flash_attention_plain(q, k, v, True))
    with pytest.raises(ValueError):
        flash_kernel.flash_attention(q.to("meta"), k, v)


def test_gate_routes_through_k5_with_no_fallback(monkeypatch):
    """With the gate forced to route CPU tensors to a K5 wrapper that
    raises, DNNModel.transform raises: no fallback hides the kernel."""
    monkeypatch.setenv("MMLSPARK_TPU_FLASH_MIN_T", "128")
    model = transformer_encoder(seq_len=128, dim=64, depth=1, num_heads=1,
                                vocab_size=30, seed=0)
    rng = np.random.default_rng(0)
    df = DataFrame.from_dict({"tokens": [rng.integers(0, 30, 128)
                                         for _ in range(3)]})
    stage = DNNModel(inputCol="tokens", outputCol="emb", batchSize=4)
    stage.set_model(model)
    with use_device("cpu"):
        want = np.stack(list(stage.transform(df).column("emb")))
    calls = []

    def routed(q, k, v, causal=False):
        calls.append(tuple(q.shape))
        return flash_kernel.flash_attention_plain(q, k, v, causal)

    monkeypatch.setattr(attention, "_kernel_device", lambda q: True)
    monkeypatch.setattr(flash_kernel, "flash_attention", routed)
    with use_device("cpu"):
        got = np.stack(list(stage.transform(df).column("emb")))
    assert calls == [(4, 128, 1, 64)]
    np.testing.assert_array_equal(got, want)

    def broken(q, k, v, causal=False):
        raise RuntimeError("flash_attn kernel launch: CUDA error 98")

    monkeypatch.setattr(flash_kernel, "flash_attention", broken)
    with use_device("cpu"), pytest.raises(RuntimeError, match="flash_attn"):
        stage.transform(df)


# ---------------------------------------------------------------------------
# K6/K7: the backward
# ---------------------------------------------------------------------------

BWD_LIB_TOL = 0.02       # of the library's max magnitude, per gradient
BWD_F64_RATIO = 1.5      # max error against f64, over the library's
BWD_F64_SLACK = 1e-3     # ... plus this much of the f64 gradient's magnitude
LSE_TOL = 1e-5


def _pallas_vjp(q, k, v, do, causal):
    """The library's flash-attention backward (its K6 and K7 Pallas
    kernels) in TPU interpret mode: (dq, dk, dv) as f32 [B, T, H, D]."""
    tr = [jnp.asarray(a).astype(jnp.bfloat16).transpose(0, 2, 1, 3)
          for a in (q, k, v, do)]
    scale = 1.0 / math.sqrt(q.shape[-1])
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: flash_attention(
            a, b, c, causal=causal, sm_scale=scale), *tr[:3])
        grads = vjp(tr[3])
    return [np.asarray(g.transpose(0, 2, 1, 3).astype(jnp.float32))
            for g in grads]


def _f64_vjp(q, k, v, do, causal):
    """Exact attention's (dq, dk, dv) in f64 from the same inputs."""
    q64, k64, v64 = (torch.from_numpy(np.asarray(a, np.float64))
                     .requires_grad_(True) for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q64, k64) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[1]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), -math.inf)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v64)
    o.backward(torch.from_numpy(np.asarray(do, np.float64)))
    return [x.grad.numpy() for x in (q64, k64, v64)]


BWD_SHAPES = [((2, 256, 4, 64), False), ((2, 256, 4, 64), True),
              ((1, 1024, 2, 64), False), ((1, 1024, 2, 64), True),
              ((1, 256, 1, 128), False), ((1, 256, 1, 128), True),
              ((1, 128, 1, 256), False), ((1, 128, 1, 256), True),
              ((1, 128, 1, 384), False), ((1, 128, 1, 384), True),
              ((1, 128, 1, 512), False), ((1, 128, 1, 512), True),
              ((1, 128, 1, 640), False), ((1, 128, 1, 640), True)]


@pytest.mark.parametrize("shape,causal", BWD_SHAPES)
def test_plain_backward_matches_pallas_backward_kernels(shape, causal):
    q, k, v = _qkv(shape, seed=11)
    do = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    lib = _pallas_vjp(q, k, v, do, causal)
    exact = _f64_vjp(*(_bf16_np(a) for a in (q, k, v, do)), causal)
    qt, kt, vt, dot = (t.requires_grad_(True) if i < 3 else t
                       for i, t in enumerate(_port((q, k, v, do))))
    o = flash_kernel.FlashAttention.apply(qt, kt, vt, causal)
    o.backward(dot)
    got = [x.grad for x in (qt, kt, vt)]
    # the Function's CPU route is the plain pair, bit for bit
    po, lse = flash_kernel.flash_attention_plain(*_port((q, k, v)), causal,
                                                 return_lse=True)
    assert torch.equal(o.detach(), po)
    plain = flash_kernel.flash_attention_bwd_plain(*_port((q, k, v)), po, lse,
                                                   dot, causal)
    for name, g, p, ref, ex in zip(("dq", "dk", "dv"), got, plain, lib, exact):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == shape, name
        assert torch.equal(g, p), name
        g = g.float().numpy()
        mag = np.abs(ref).max()
        assert np.abs(g - ref).max() <= BWD_LIB_TOL * mag, name
        lib_err = np.abs(ref - ex).max()
        assert np.abs(g - ex).max() <= (BWD_F64_RATIO * lib_err
                                        + BWD_F64_SLACK * np.abs(ex).max()), name


@pytest.mark.parametrize("shape,causal", [((2, 256, 4, 64), False),
                                          ((1, 256, 2, 64), True),
                                          ((1, 256, 1, 128), False),
                                          ((1, 256, 1, 128), True)])
def test_plain_lse_matches_library_residuals(shape, causal):
    q, k, v = _qkv(shape, seed=13)
    tr = [jnp.asarray(a).astype(jnp.bfloat16).transpose(0, 2, 1, 3)
          for a in (q, k, v)]
    b, t, h, d = shape
    with pltpu.force_tpu_interpret_mode():
        _, l, m = _flash_attention(*tr, None, None, True, causal,
                                   1.0 / math.sqrt(d),
                                   BlockSizes.get_default(b, h, t, t, d), False)
    want = np.asarray(m) + np.log(np.asarray(l))      # [B, H, T]
    _, lse = flash_kernel.flash_attention_plain(*_port((q, k, v)), causal,
                                                return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, t)
    assert np.abs(lse.numpy() - want).max() <= LSE_TOL


@pytest.mark.parametrize("b,tq,tk,h,d", [(1, 64, 64, 1, 64),
                                         (3, 2048, 2048, 8, 64),
                                         (2, 192, 320, 3, 128),
                                         (2, 640, 128, 2, 256),
                                         (2, 320, 192, 3, 384),
                                         (1, 2048, 2048, 4, 512),
                                         (2, 192, 320, 2, 640),
                                         (1, 256, 128, 2, 1024),
                                         (3, 128, 192, 1, 2048),
                                         (65_537, 128, 128, 1, 64)])
@pytest.mark.parametrize("which", ["dkv", "dq"])
def test_bwd_grid_decode_covers_every_block(b, tq, tk, h, d, which):
    """K6's and K7's 1-D grids: every (batch, head x column slice, tile)
    once, tiles fastest, past grid.z's cap; K6 tiles the keys (128 a CTA,
    64 at D = 256), K7 the queries (128 a CTA); up to D = 256 no CTA splits
    the columns, from 384 up each of a head's 128-column slices is written
    by one slot."""
    tiles, hc, total = flash_kernel.bwd_launch_grid(b, tq, tk, h, d, which)
    rows = 64 if which == "dkv" and d == 256 else 128
    assert flash_kernel.bwd_tile_rows(d, which) == rows
    assert tiles == -(-(tk if which == "dkv" else tq) // rows)
    slices = BWD_SLICES.get(d, 1)
    assert flash_kernel.col_slices(d, which) == slices
    assert hc == h * slices
    assert total == tiles * hc * b <= flash_kernel.MAX_GRID_BLOCKS
    block = np.arange(total, dtype=np.int64)
    bi, hy, m = flash_kernel.grid_decode(block, tiles, hc)
    assert bi.min() == 0 and bi.max() == b - 1
    np.testing.assert_array_equal((bi * hc + hy) * tiles + m, block)
    _columns_once(hy, h, slices, d)


@pytest.mark.parametrize("d,which,want", [
    (64, "dkv", (84_480, 3)), (128, "dkv", (116_480, 3)),
    (256, "dkv", (215_040, 2)), (64, "dq", (132_096, 3)),
    (128, "dq", (164_864, 3)), (256, "dq", (230_400, 3)),
    (384, "dkv", (198_144, 4)), (512, "dkv", (198_144, 4)),
    (640, "dkv", (198_144, 4)), (1024, "dkv", (198_144, 4)),
    (2048, "dkv", (198_144, 4)), (384, "dq", (181_248, 3)),
    (512, "dq", (181_248, 3)), (640, "dq", (181_248, 3)),
    (1024, "dq", (181_248, 3)), (2048, "dq", (181_248, 3))])
def test_bwd_smem_fits_a_block(d, which, want):
    """K6's and K7's shared memory, as the source sizes it, within the
    232,448 bytes a block takes: K6 K and V of 128 keys (64 and the 16 KB
    P hand-over at D = 256) and Q/dO/lse/di stages of 64 queries (32 at
    D = 128); K7 Q and dO of
    128 queries and K/V stages of 128, 64 or 32 keys; at least 2 stages.
    From D = 384 up the same at every head dim (D streams in 64-column
    chunks): K6 4 chunk stages of 40 KB (K and V boxes of 128 keys, Q and
    dO of 32 queries) and 2 slice stages of 16,640 bytes (Q and dO of 128
    columns, lse, di); K7 3 of 48 KB (Q and dO of 128 queries, K and V of
    64 keys) and 2 of 16 KB (K of 128 columns)."""
    got = flash_kernel.bwd_smem_bytes(d, which, parts=True)
    assert got == want
    assert got[0] + 256 <= flash_kernel.SMEM_MAX and got[1] >= 2
    assert flash_kernel.bwd_smem_bytes(d, which) == want[0]


def _tile_coverage(tiles, tq, tk, causal):
    """How often each (query, key) pair is computed by ``bwd_tiles``'s
    tiles, applying the element mask where a tile is masked; asserts that
    no unmasked tile reaches a pair the mask would hide (K7's rows past Tq
    are not masked: their zero rows add 0 and their stores are dropped)."""
    count = np.zeros((tq, tk), dtype=np.int64)
    q = np.arange(tq)[:, None]
    k = np.arange(tk)[None, :]
    visible = (k <= q) if causal else np.ones((tq, tk), dtype=bool)
    for _, q_lo, q_hi, k_lo, k_hi, masked in tiles:
        cell = np.zeros((tq, tk), dtype=bool)
        cell[q_lo:q_hi, k_lo:k_hi] = True
        if not masked:
            assert k_hi <= tk and visible[cell].all(), (q_lo, k_lo)
        count += cell & visible
    return count, visible


@pytest.mark.parametrize("t", [64, 192, 320, 512, 1024])
@pytest.mark.parametrize("d", [64, 128, 256, 384, 512, 640, 1024, 2048])
@pytest.mark.parametrize("which", ["dkv", "dq"])
def test_bwd_causal_schedule_covers_the_lower_triangle_once(t, d, which):
    """A numpy model of K6's and K7's causal tile walk (``bwd_tiles``, the
    source's tile arithmetic): every (query, key) pair of the lower
    triangle computed exactly once, none above it (the unmasked tiles lie
    wholly at or below the diagonal), at lengths a multiple of 64 but not
    of the 128-row tiles too; non-causal at Tq != Tk covers the whole
    rectangle once."""
    count, visible = _tile_coverage(
        flash_kernel.bwd_tiles(t, t, d, which, True), t, t, True)
    np.testing.assert_array_equal(count, visible.astype(np.int64))
    tk = t + 64 if t % 128 else t // 2 + 64
    count, _ = _tile_coverage(
        flash_kernel.bwd_tiles(t, tk, d, which, False), t, tk, False)
    np.testing.assert_array_equal(count, np.ones((t, tk), dtype=np.int64))


@pytest.mark.parametrize("d", [64, 128, 256, 384, 512, 640, 1024, 2048])
@pytest.mark.parametrize("which", ["dkv", "dq"])
def test_bwd_causal_schedule_starts_the_longest_first(d, which):
    """Under causal masking the CTAs with the most tiles launch first: K6's
    low key tiles, K7's high query tiles; every CTA of a (batch, head)
    computes at least one tile."""
    tiles = flash_kernel.bwd_tiles(2048, 2048, d, which, True)
    per_cta = np.bincount(tiles[:, 0])
    n = flash_kernel.bwd_launch_grid(1, 2048, 2048, 1, d, which)[0]
    assert len(per_cta) == n and per_cta.min() > 0
    assert (np.diff(per_cta) <= 0).all() and per_cta[0] > per_cta[-1]


def test_bwd_cost_counts_the_products():
    f_dkv, b_dkv = flash_kernel.bwd_cost(2, 256, 128, 4, 64, False, "dkv")
    f_dq, b_dq = flash_kernel.bwd_cost(2, 256, 128, 4, 64, False, "dq")
    assert f_dkv == 8 * 2 * 4 * 256 * 128 * 64
    assert f_dq == 6 * 2 * 4 * 256 * 128 * 64
    assert flash_kernel.bwd_cost(2, 256, 256, 4, 64, True, "dq")[0] == \
        flash_kernel.bwd_cost(2, 256, 256, 4, 64, False, "dq")[0] / 2
    reads = 2 * 2 * 4 * 64 * (2 * 256 + 2 * 128) + 8 * 2 * 4 * 256
    assert b_dkv == reads + 2 * 2 * 4 * 64 * 2 * 128
    assert b_dq == reads + 2 * 2 * 4 * 64 * 256


def _bwd_sliced(q, k, v, o, lse, do, causal, drop_chunk=False):
    """K6's and K7's arithmetic from D = 384 up (``flash_bwd_dkv_sliced``,
    ``flash_bwd_dq_sliced``) on the CPU: the products reduced over D (K6
    S^T = K Q^T and dP^T = V dO^T per 32-query tile; K7 S = Q K^T and
    dP = dO V^T per 64-key tile) summed in f32 over D's 64-column chunks
    in the kernels' order; P = exp2(s * log2(e) / sqrt(D) - lse * log2(e))
    (0 past Tk and, causal, above the diagonal), dS = (dP - di) P / sqrt(D);
    P and dS rounded to bf16 before the register-A products, which add
    tile by tile into each 128-column slice of dV, dK (K6: over the query
    tiles from the key tile's first, causal) and dQ (K7: over the key
    tiles); the results rounded to bf16 once. Each slice recomputes the
    same sums in the same order (the same bits), so they are taken once
    here. ``drop_chunk`` leaves D's last chunk out of the sums."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    c2 = scale * math.log2(math.e)
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, do))
    pad = -tk % 128
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    lse2 = lse.float() * math.log2(math.e)                  # [B, H, Tq]
    di = (o.float() * do.float()).sum(-1).transpose(1, 2)   # [B, H, Tq]
    chunks = range(0, d - 64 if drop_chunk else d, 64)

    def chunked(a, bt):
        acc = torch.zeros(*a.shape[:-1], bt.shape[-2])
        for ch in chunks:
            acc = acc + a[..., ch:ch + 64] @ bt[..., ch:ch + 64].transpose(-1, -2)
        return acc

    def probs(s, qpos, kpos, lrow):
        p = torch.exp2((s.double() * c2 - lrow.double()).float())
        hidden = (kpos >= tk) | ((kpos > qpos) if causal else False)
        return p.masked_fill(hidden, 0.0)

    # K6: every key tile of 128 at once, query tiles of 32 in order (under
    # causal masking a key tile starts at its own first query: the earlier
    # tiles would add only P = 0)
    keys = torch.arange(tk + pad)[:, None]
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for qs in range(0, tq, 32):
        qpos = torch.arange(qs, qs + 32)[None, :]
        st = chunked(kf, qf[:, :, qs:qs + 32])               # [B, H, Tk, 32]
        dpt = chunked(vf, dof[:, :, qs:qs + 32])
        pt = probs(st, qpos, keys, lse2[:, :, None, qs:qs + 32])
        dst = (dpt - di[:, :, None, qs:qs + 32]) * pt * scale
        if causal:
            live = (keys // 128) * 128 <= qs   # the key tile reaches qs
            pt, dst = pt * live, dst * live
        dv = dv + pt.to(torch.bfloat16).float() @ dof[:, :, qs:qs + 32]
        dk = dk + dst.to(torch.bfloat16).float() @ qf[:, :, qs:qs + 32]
    # K7: all queries at once, key tiles of 64 in order
    qpos = torch.arange(tq)[:, None]
    dq = torch.zeros_like(qf)
    for n0 in range(0, tk, 64):
        kpos = torch.arange(n0, n0 + 64)[None, :]
        s = chunked(qf, kf[:, :, n0:n0 + 64])
        dp = chunked(dof, vf[:, :, n0:n0 + 64])
        p = probs(s, qpos, kpos, lse2[..., None])
        ds = (dp - di[..., None]) * p * scale
        dq = dq + ds.to(torch.bfloat16).float() @ kf[:, :, n0:n0 + 64]
    return tuple(x.transpose(1, 2).to(torch.bfloat16)
                 for x in (dq, dk[:, :, :tk], dv[:, :, :tk]))


@pytest.mark.parametrize("shape,tk,causal", [
    ((1, 256, 1, 384), None, False), ((1, 256, 1, 384), None, True),
    ((1, 192, 1, 512), None, True), ((1, 128, 1, 640), 192, False)])
def test_bwd_sliced_arithmetic_within_chip_gates(shape, tk, causal):
    """The chip's gates on K6 and K7 hold for their arithmetic from D = 384
    up (the reductions over D in 64-column chunks, P and dS recomputed per
    slice): per gradient, the max and rms error against an f64 backward at
    most 1.5x the plain backward's, and within 2% of the plain backward's
    magnitude; lengths past the 128-row tiles included. A chunk left out
    of the sums moves it past the f64 gate."""
    q, k, v = _port(_qkv(shape, seed=19, tk=tk))
    do = _port([np.random.default_rng(20).standard_normal(
        shape).astype(np.float32)])[0]
    o, lse = flash_kernel.flash_attention_plain(q, k, v, causal,
                                                return_lse=True)
    plain = flash_kernel.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    got = _bwd_sliced(q, k, v, o, lse, do, causal)
    exact = _f64_vjp(*(x.float().numpy() for x in (q, k, v, do)), causal)
    broken = _bwd_sliced(q, k, v, o, lse, do, causal, drop_chunk=True)
    for name, g, p, ex, bad in zip(("dq", "dk", "dv"), got, plain, exact,
                                   broken):
        g, p, bad = (x.double().numpy() for x in (g, p, bad))
        assert np.abs(g - p).max() <= BWD_LIB_TOL * np.abs(p).max(), name
        ge, pe = g - ex, p - ex
        assert np.abs(ge).max() <= 1.5 * np.abs(pe).max(), name
        assert np.square(ge).mean() <= 1.5 ** 2 * np.square(pe).mean(), name
        assert np.abs(bad - ex).max() > 1.5 * np.abs(pe).max(), name


def test_k5_refuses_to_detach_a_graph():
    """While grad is enabled and an input requires grad, only
    ``FlashAttention`` may launch K5: a bare ``flash_attention_cuda`` call
    raises before it builds or launches anything."""
    q, k, v = _port(_qkv((1, 128, 2, 64), seed=0))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="FlashAttention"):
        flash_kernel.flash_attention_cuda(q, k, v)
    assert flash_kernel._requires_grad(q, k, v)
    with torch.no_grad():       # serving: the guard stays out of the way
        assert not flash_kernel._requires_grad(q, k, v)
    with torch.inference_mode():
        assert not flash_kernel._requires_grad(q, k, v)


def test_gate_sends_grad_through_flash_attention(monkeypatch):
    """With the gate forced on for CPU tensors: under autograd
    ``dense_attention`` goes through ``FlashAttention`` (its CPU route, the
    plain pair), under no_grad through the K5 wrapper alone; the gradients
    are the plain forward's autograd gradients within bf16 rounding."""
    monkeypatch.setattr(attention, "_kernel_device", lambda q: True)
    calls = []
    real_apply = flash_kernel.FlashAttention.apply

    def counting(*a):
        calls.append("function")
        return real_apply(*a)

    def k5(q, k, v, causal=False):
        calls.append("k5")
        return flash_kernel.flash_attention_plain(q, k, v, causal)

    monkeypatch.setattr(flash_kernel.FlashAttention, "apply", counting)
    monkeypatch.setattr(flash_kernel, "flash_attention", k5)
    q, k, v = _port(_qkv((2, 128, 2, 64), seed=1))
    do = _port([np.random.default_rng(2).standard_normal(
        (2, 128, 2, 64)).astype(np.float32)])[0]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    dense_attention(*leaves, causal=True).backward(do)
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    flash_kernel.flash_attention_plain(*ref, causal=True).backward(do)
    assert calls == ["function"]
    for got, want in zip(leaves, ref):
        assert got.grad is not None
        g, w = got.grad.float(), want.grad.float()
        assert (g - w).abs().max() <= BWD_LIB_TOL * w.abs().max()
    with torch.no_grad():
        dense_attention(*leaves, causal=True)
    assert calls == ["function", "k5"]


# ---------------------------------------------------------------- vw_scan
#
# ``csrc/vw_scan.cu`` (the VW learner's pass on the card; not a TPU kernel)
# has no CPU mode. Its arithmetic is emulated here in numpy f32, step for
# step as the source orders it (test code only): each lane's slots summed in
# ascending order, the warp's shuffle-down tree, the first occurrence of an
# index adding its duplicates' terms in slot order, the two-phase adaptive
# update and XLA's index semantics. The emulation is held to the plain
# version within rtol 1e-5 and atol 1e-5 of max |w| (they differ in the
# prediction's summation order) and bit for bit on the index bookkeeping
# (the slots each example updates).

def _f32(x):
    return np.float32(x)


def _vw_scan_emulate(state, idx, val, labels, wgts, cfg, touched=None):
    """The kernel's pass on numpy state arrays (in place); returns the f64
    loss sum. ``touched`` (a set) collects the slots each example writes."""
    from mmlspark_tpu_torch.vw.scan_kernel import mode_of

    mode = mode_of(cfg)
    s0, s1 = state[0], state[1]
    dim = s0.shape[0]
    t = _f32(state[2][0]) if mode != 2 else _f32(0)
    k = idx.shape[1]
    total = 0.0
    for i in range(idx.shape[0]):
        six = np.where(idx[i] < 0, idx[i] + dim, idx[i])
        sv = val[i]
        first = [not any(six[jj] == six[j] for jj in range(j))
                 for j in range(k)]
        gat = np.clip(six, 0, dim - 1)
        if mode == 2:
            zi, ni = s0[gat], s1[gat]
            sign = np.sign(zi).astype(np.float32)
            wi = np.where(np.abs(zi) <= _f32(cfg.l1), _f32(0),
                          -(zi - sign * _f32(cfg.l1))
                          / ((_f32(cfg.ftrl_beta) + np.sqrt(ni))
                             / _f32(cfg.ftrl_alpha) + _f32(cfg.l2)))
            wi = wi.astype(np.float32)
        else:
            wi = s0[gat].copy()
        part = np.zeros(32, np.float32)
        for j in range(k):
            part[j % 32] = _f32(part[j % 32] + _f32(wi[j] * sv[j]))
        for off in (16, 8, 4, 2, 1):
            part = np.array([part[l] + part[l + off] if l + off < 32
                             else part[l] for l in range(32)], np.float32)
        pred, label, wgt = part[0], labels[i], wgts[i]
        with np.errstate(over="ignore"):
            if cfg.loss_function == "logistic":
                g = -label / (_f32(1) + np.exp(label * pred))
                m = -label * pred
                ex = max(m, _f32(0)) + np.log1p(np.exp(-abs(m)))
            elif cfg.loss_function == "hinge":
                g = -label if label * pred < 1 else _f32(0)
                ex = max(_f32(0), _f32(1) - label * pred)
            elif cfg.loss_function == "quantile":
                tau = _f32(cfg.quantile_tau)
                g = _f32(1) - tau if pred > label else -tau
                d = pred - label
                ex = (_f32(1) - tau) * d if d > 0 else -tau * d
            else:
                g = pred - label
                ex = _f32(0.5) * (pred - label) * (pred - label)
        g = _f32(g * wgt)
        total += float(_f32(ex * wgt))

        def scatter(arr, terms):
            for j in range(k):
                ix = six[j]
                if not first[j] or ix < 0 or ix >= dim:
                    continue
                acc = arr[ix]
                for jj in range(j, k):
                    if six[jj] == ix:
                        acc = _f32(acc + terms[jj])
                arr[ix] = acc
                if touched is not None:
                    touched.add((i, int(ix)))

        if mode == 2:
            gi = (g * sv).astype(np.float32)
            ni = s1[gat]
            sigma = (np.sqrt(ni + gi * gi) - np.sqrt(ni)) / _f32(cfg.ftrl_alpha)
            t1 = (gi - sigma * wi).astype(np.float32)
            t2 = (gi * gi).astype(np.float32)
            scatter(s0, t1)
            scatter(s1, t2)
            continue
        gi = (g * sv + np.where(sv != 0, _f32(cfg.l2) * wi, _f32(0))
              ).astype(np.float32)
        t = _f32(t + (1 if wgt > 0 else 0))
        if mode == 1:
            scatter(s1, (gi * gi).astype(np.float32))
            g2 = s1[gat]
            base = g2 + _f32(1e-16)
            scale = (np.sqrt(base) if cfg.power_t == 0.5
                     else np.power(base, _f32(cfg.power_t))) + _f32(1e-8)
            step = (-_f32(cfg.learning_rate) * gi / scale).astype(np.float32)
        else:
            base = t + _f32(cfg.initial_t)
            eta = _f32(cfg.learning_rate) / (
                np.sqrt(base) if cfg.power_t == 0.5
                else np.power(base, _f32(cfg.power_t)))
            step = (-eta * gi).astype(np.float32)
        scatter(s0, step)
    if mode != 2:
        state[2][0] = t
    return total


@pytest.mark.parametrize("loss", ["squared", "logistic", "hinge", "quantile"])
@pytest.mark.parametrize("mode", ["adaptive", "sgd", "ftrl"])
def test_vw_scan_emulation_matches_the_plain_version(loss, mode):
    """The kernel's arithmetic (emulated) against ``scan_pass_plain`` on
    examples with duplicate indices, padded slots, a negative index, one
    past the end and a zero-weight example, two passes: weights within
    rtol 1e-5 and atol 1e-5 of max |w|, the clock equal, the loss within
    1e-5; the examples never write outside [0, dim)."""
    from mmlspark_tpu_torch.vw import learner, scan_kernel

    rng = np.random.default_rng(11)
    n, k, bits = 120, 37, 8
    idx = rng.integers(0, 1 << bits, (n, k)).astype(np.int32)
    idx[:, 5] = idx[:, 2]
    idx[:, 36] = idx[:, 2]
    idx[3, 0], idx[4, 1] = -7, (1 << bits) + 2
    val = rng.standard_normal((n, k)).astype(np.float32)
    val[:, -3:-1] = 0
    lab = (np.where(rng.random(n) > 0.5, 1.0, -1.0) if loss != "quantile"
           else rng.standard_normal(n)).astype(np.float32)
    wts = rng.uniform(0.5, 2.0, n).astype(np.float32)
    wts[9] = 0
    cfg = learner.LearnerConfig(
        num_bits=bits, loss_function=loss, l2=0.01 if mode == "adaptive" else 0,
        power_t=0.5 if mode != "sgd" else 0.4, initial_t=1.0,
        adaptive=mode == "adaptive", ftrl=mode == "ftrl", l1=0.001)
    st = learner.init_state(cfg, "cpu")
    emu = [s.numpy().copy() for s in st]
    tens = [torch.from_numpy(a) for a in (idx, val, lab, wts)]
    touched = set()
    for _ in range(2):
        got = float(scan_kernel.scan_pass_plain(st, *tens, cfg).item())
        want = _vw_scan_emulate(emu, idx, val, lab, wts, cfg, touched)
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
    w_plain = learner.weights_of(cfg, st).numpy()
    w_emu = learner.weights_of(cfg, [torch.from_numpy(a) for a in emu]).numpy()
    np.testing.assert_allclose(w_emu, w_plain, rtol=1e-5,
                               atol=1e-5 * float(np.abs(w_plain).max()))
    if mode != "ftrl":
        assert st[2].item() == emu[2][0] == 2 * (n - 1)
    assert all(0 <= ix < (1 << bits) for _, ix in touched)


def test_vw_scan_argument_block_matches_the_source():
    """``_Args`` is ``ScanArgs`` in ``csrc/vw_scan.cu`` field for field (8
    pointers, int64 n, 4 int32, 8 floats: 120 bytes), and the shared memory
    the launch asks for fits the card's 227 KB at ``MAX_K`` slots."""
    import ctypes
    import pathlib
    import re

    from mmlspark_tpu_torch.vw import scan_kernel

    a = scan_kernel._Args
    assert ctypes.sizeof(a) == 120
    assert a.n.offset == 64 and a.k.offset == 72 and a.mode.offset == 84
    assert a.tau.offset == 88 and a.beta.offset == 116
    src = (pathlib.Path(scan_kernel.__file__).resolve().parents[1] / "csrc"
           / "vw_scan.cu").read_text()
    body = re.sub(r"//.*", "", src[src.index("struct ScanArgs"):
                                    src.index("};")])
    names = re.findall(r"(\w+)(?:;|,)", body)
    assert names == [f for f, _ in a._fields_]
    assert scan_kernel.MAX_K * (6 * 4 + 1) <= 227 * 1024


def test_vw_scan_wrapper_routes_by_device_and_checks_inputs():
    from mmlspark_tpu_torch.vw import learner, scan_kernel

    cfg = learner.LearnerConfig(num_bits=4)
    st = learner.init_state(cfg, "cpu")
    idx = torch.zeros(3, 2, dtype=torch.int32)
    val = torch.ones(3, 2)
    ones = torch.ones(3)
    scan_kernel.launches = 0
    out = scan_kernel.scan_pass(st, idx, val, ones, ones, cfg)
    assert out.dtype == torch.float64 and scan_kernel.launches == 0
    with pytest.raises(TypeError, match="int32"):
        scan_kernel.scan_pass(st, idx.long(), val, ones, ones, cfg)
    with pytest.raises(ValueError, match="3 tensors"):
        scan_kernel.scan_pass(st[:2], idx, val, ones, ones, cfg)
    meta = [s.to("meta") for s in st]
    with pytest.raises(ValueError, match="no VW scan"):
        scan_kernel.scan_pass(meta, idx, val, ones, ones, cfg)


# ------------------------------------------- K1 and K4: the f64 (sharded) mode


@pytest.mark.parametrize("entry", ["mask", "count", "sparse"])
@pytest.mark.parametrize("shards", [2, 4])
def test_f64_entries_summed_over_shards_round_to_the_f32_entry(entry,
                                                               shards):
    """A sharded fit adds each shard's f64 sums (``f64=True``) across the
    processes and rounds once: over contiguous row blocks that equals the
    f32 entry over all rows, bit for bit, for K1's mask entry, its
    device-count entry and K4. With the f64 flag unset the entries are the
    f32 ones they were."""
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk
    from mmlspark_tpu_torch.gbdt import sparse_hist_kernel as shk

    rng = np.random.default_rng(40 + shards)
    n, f, b = 4096, 5, 48
    bins = torch.from_numpy(rng.integers(0, b, (f, n)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.0, 0.3, n).astype(np.float32))
    m = torch.from_numpy(rng.random(n) < 0.7)
    blocks = np.array_split(np.arange(n), shards)
    if entry == "sparse":
        tb = 300
        ends = np.sort(rng.integers(0, n, tb - 1))
        bin_end = torch.from_numpy(np.append(ends, n).astype(np.int32))
        data = torch.stack([g * m, h * m, m.float()])
        ids = shk.bin_ids(bin_end).numpy()
        whole = shk.sparse_histogram_plain(data, bin_end)
        total = torch.zeros(3, tb, dtype=torch.float64)
        for blk in blocks:
            # a shard holds its own entries, bin-sorted, and the same bins
            own = np.bincount(ids[blk], minlength=tb)
            part = shk.sparse_histogram_plain(
                data[:, blk].contiguous(),
                torch.from_numpy(np.cumsum(own).astype(np.int32)), f64=True)
            assert part.dtype == torch.float64
            total += part
    else:
        whole = hk.histogram_plain(bins, g, h, m, b)
        total = torch.zeros(f, b, 3, dtype=torch.float64)
        for blk in blocks:
            sl = slice(int(blk[0]), int(blk[-1]) + 1)
            args = (bins[:, sl].contiguous(), g[sl].contiguous(),
                    h[sl].contiguous())
            if entry == "mask":
                part = hk.histogram_plain(*args, m[sl].contiguous(), b,
                                          f64=True)
            else:
                # the compacted buffer: the masked rows first, then padding
                keep = torch.nonzero(m[sl]).flatten()
                cnt = torch.tensor([len(keep)], dtype=torch.int32)
                pad = torch.zeros(len(blk) - len(keep), dtype=torch.int64)
                idx = torch.cat([keep, pad])
                part = hk.histogram_count_plain(
                    args[0].index_select(1, idx).contiguous(),
                    args[1].index_select(0, idx), args[2].index_select(0, idx),
                    cnt, b, f64=True)
            assert part.dtype == torch.float64
            total += part
        assert hk.histogram_plain(bins, g, h, m, b).dtype == torch.float32
    assert torch.equal(total.float(), whole)
