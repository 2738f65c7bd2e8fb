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

Training (``models.training``, ``models.checkpoint``) against the
reference's ``make_train_step`` on the CPU, from the same params and
momentum trace (``convert.load_jax_train_state``) and the same batches:
grads and params after one step and after three, per leaf, relative to the
leaf's max |value|: F32_TOL in f32 and DEEP_BF16_TOL in the bf16 default
(the gradients cross the same bf16 roundings on both sides; sums in another
order can flip one). The loss and accuracy helpers F32_TOL; ``_apply_bn_ema``
and the optimizer's weight-decay mask equal; the train loop's resume,
preemption and checkpoint round trip bit for bit (one process, the same
torch ops). LSTM, BiLSTM and the tagger: f32 throughout on both sides
(F32_TOL), the tagger's Dense head in bf16 by default (DEEP_BF16_TOL).

The image path and the switch MoE against the reference, each constant
beside its case: Conv2D, BatchNorm and the pools (f32 F32_TOL, bf16 one
bf16 ulp, MaxPool bitwise, BatchNorm's batch statistics BN_STATS_RTOL);
ResNet-18/50 carried over by load_jax_params and from_torch_resnet on the
same seeded torchvision-layout state_dict (RESNET_F32_TOL, RESNET_BF16_TOL);
the host image ops bitwise (resize on the native and the numpy path; the
gray conversion within one level of the reference's BLAS sum, bitwise its
batched mirror), the batched mirrors bitwise, resize_batch within
RESIZE_BATCH_TOL; the image stages bitwise, fused and not; ImageFeaturizer
end to end (RESNET_*_TOL), fused bitwise unfused; the BatchNorm EMA train
step (1e-6) and a ResNet-18 step (RESNET_F32_TOL); MoE forward and
gradients against jax.grad (MOE_TOL).
"""

import contextlib
import importlib
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
from mmlspark_tpu.models import training as ref_training
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
from mmlspark_tpu_torch.models import checkpoint as port_checkpoint
from mmlspark_tpu_torch.models import module as port_module
from mmlspark_tpu_torch.models import moe as port_moe
from mmlspark_tpu_torch.models import training
from mmlspark_tpu_torch.models.convert import load_jax_train_state
from mmlspark_tpu_torch.parallel import batching
from mmlspark_tpu_torch.parallel.ingest import PreprocessSpec
from mmlspark_tpu_torch.runtime import use_device

# the packages export the builder function ``resnet`` over the submodule's
# name
port_resnet = importlib.import_module("mmlspark_tpu_torch.models.resnet")

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
    """What the model layer still refuses or keeps unfused: ``useMesh=True``
    and a multi-input feed stay unfused, a preprocess spec beside a
    multi-input feed raises (as in the reference). A mesh that is only this
    process's runs the single-device transform (its data axis is 1). The
    fused pipeline's mesh knobs (segment ``sharding``, ``pipe_depth``),
    ported since, change nothing without a mesh (as in the reference):
    the transform stays the single-device one, bit for bit."""
    from mmlspark_tpu_torch.parallel.mesh import Mesh, MeshContext

    _, port = _encoders()
    df = DataFrame.from_dict({"tokens": list(_tokens(2))})
    stage = DNNModel(inputCol="tokens", outputCol="o", useMesh=True)
    stage.set_model(port)
    assert stage.device_fn(df.schema) is None
    plain = DNNModel(inputCol="tokens", outputCol="o", useMesh=False)
    plain.set_model(port)
    try:
        with use_device("cpu"):
            want = np.stack(list(plain.transform(df).column("o")))
            got = np.stack(list(stage.transform(df).column("o")))
    finally:
        MeshContext.reset()
    np.testing.assert_array_equal(got, want)
    MeshContext.set(Mesh(shape={"data": 2}))
    try:
        auto = DNNModel(inputCol="tokens", outputCol="o").set_model(port)
        assert auto.device_fn(df.schema) is None
    finally:
        MeshContext.reset()
    port.module.input_names = ["ids", "mask"]
    multi = DNNModel(outputCol="o").set_model(port)
    multi.set_feed_dict({"ids": "tokens", "mask": "tokens"})
    assert multi.device_fn(df.schema) is None
    multi.set_preprocess(PreprocessSpec(scale=1.0))
    with use_device("cpu"), pytest.raises(ValueError, match="single-input"):
        multi.transform(df)
    fused = PipelineModel([plain]).fuse()
    fused.set_tuning(sharding={"DNNModel": "data"})
    fused.set_tuning(pipe_depth=2)
    with use_device("cpu"):
        knobbed = np.stack(list(fused.transform(df).column("o")))
    np.testing.assert_array_equal(knobbed, want)
    stats = fused.fusion_stats()
    assert fused.shard_mesh is None
    assert "sharding" not in stats and "pipeline" not in stats
    assert stats["tuning"]["sharding"] == {"DNNModel": "data"}


@pytest.mark.parametrize("data", [1, 2])
def test_image_featurizer_fuses_only_off_a_data_mesh(data):
    """Under ``MeshContext.set`` of a mesh whose data axis is above 1 the
    featurizer's ``device_fn`` is None (mesh-sharded eval keeps the unfused
    path), as the reference's is; on a data axis of 1 both fuse."""
    from mmlspark_tpu.parallel.mesh import MeshContext as RefMeshContext
    from mmlspark_tpu_torch.parallel.mesh import Mesh, MeshContext

    ref, port = _featurizer_pair()
    schema = DataFrame.from_dict({"image": [None]}).schema
    ref_schema = RefDataFrame.from_dict({"image": [None]}).schema
    MeshContext.set(Mesh(shape={"data": data}))
    RefMeshContext.set(_ref_mesh(data=data))
    try:
        got = port.device_fn(schema)
        want = ref.device_fn(ref_schema)
    finally:
        MeshContext.reset()
        RefMeshContext.reset()
    assert (got is None) == (want is None) == (data > 1)


def test_dnn_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    _, port = _encoders()
    stage = DNNModel(inputCol="tokens", outputCol="o").set_model(port)
    with pytest.raises(RuntimeError, match="CUDA"):
        stage.transform(DataFrame.from_dict({"tokens": list(_tokens(2))}))


# ---------------------------------------------------------------------------
# training: step, optimizer, loop and checkpoints; the LSTM family
# ---------------------------------------------------------------------------


def _find_trace(opt_state):
    import optax

    if isinstance(opt_state, optax.TraceState):
        return opt_state.trace
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _find_trace(sub)
            if found is not None:
                return found
    return None


def _with_trace(opt_state, trace):
    import optax

    if isinstance(opt_state, optax.TraceState):
        return optax.TraceState(trace=trace)
    if isinstance(opt_state, tuple):
        subs = [_with_trace(sub, trace) for sub in opt_state]
        return type(opt_state)(*subs) if hasattr(opt_state, "_fields") \
            else tuple(subs)
    return opt_state


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_tree_close(got, want, tol, what):
    want = dict(_leaves(want))
    got = dict(_leaves(got))
    assert set(got) == set(want), what
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        g = got[name].detach().double().numpy() if isinstance(got[name], torch.Tensor) \
            else np.asarray(got[name], np.float64)
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= tol * scale, (what, name,
                                                     np.abs(g - w).max() / scale)


TRAIN_OPT = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-3)


def _train_batches(n, seed=5, rows=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(0, ENC["vocab_size"], (rows, ENC["seq_len"]))
        y = rng.integers(0, ENC["num_classes"], (rows, ENC["seq_len"]))
        mask = rng.random((rows, ENC["seq_len"])) < 0.8
        out.append({"x": x, "y": y.astype(np.int32), "mask": mask})
    return out


def _train_pair():
    """The reference encoder's params (LayerNorm and biases made
    non-trivial), a non-zero momentum trace, the reference's optimizer
    state holding it, and a port encoder and TrainState from both."""
    ref = ref_attention.transformer_encoder(**ENC, seed=0)
    params = _np_params(jax.tree.map(np.asarray, ref.params),
                        np.random.default_rng(0))
    rng = np.random.default_rng(1)
    trace = jax.tree.map(
        lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32), params)
    opt = ref_training.make_optimizer(**TRAIN_OPT)
    opt_state = _with_trace(opt.init(params), jax.tree.map(jnp.asarray, trace))
    ref_state = ref_training.TrainState(jax.tree.map(jnp.asarray, params),
                                        opt_state, np.int32(0))
    port = transformer_encoder(**ENC, seed=1)
    with use_device("cpu"):
        state = load_jax_train_state(port, params, trace, 0)
    return ref, ref_state, port, state


@pytest.mark.parametrize("f32", [True, False])
def test_train_step_matches_reference(f32):
    """One step and three of the encoder from the same params, trace and
    batches: the loss, the grads of the first step, and the params and
    traces after each step, per leaf."""
    ref, ref_state, port, state = _train_pair()
    batches = _train_batches(3)
    tol = F32_TOL if f32 else DEEP_BF16_TOL
    ref_step = jax.jit(ref_training.make_train_step(
        ref.module, ref_training.make_optimizer(**TRAIN_OPT)))
    step = training.make_train_step(port.module,
                                    training.make_optimizer(**TRAIN_OPT))

    def ref_grads(st, batch):
        def loss(p):
            logits = ref.module.apply(p, jnp.asarray(batch["x"]), train=True)
            return ref_training.cross_entropy_loss(
                logits, jnp.asarray(batch["y"]), jnp.asarray(batch["mask"]))
        return jax.grad(loss)(st.params)

    ctx = ((lambda: ref_module.matmul_precision("float32")),
           (lambda: matmul_precision("float32"))) if f32 else (
        (lambda: contextlib.nullcontext()),) * 2
    for i, batch in enumerate(batches):
        with ctx[0]():
            want_g = ref_grads(ref_state, batch) if i == 0 else None
            ref_state, ref_m = ref_step(ref_state, batch)
        with ctx[1]():
            if i == 0:
                _, _, got_g = training.loss_and_grads(port.module,
                                                      state.params, batch)
                _assert_tree_close(got_g, want_g, tol, "grads")
            state, metrics = step(state, batch)
        assert abs(float(metrics["loss"]) - float(ref_m["loss"])) <= \
            tol * abs(float(ref_m["loss"]))
        _assert_tree_close(state.params, ref_state.params, tol, f"params {i}")
        _assert_tree_close(state.opt_state["trace"],
                           _find_trace(ref_state.opt_state), tol, f"trace {i}")
        assert state.step == int(ref_state.step) == i + 1


def test_weight_decay_skips_1d_leaves_like_optax():
    import optax

    rng = np.random.default_rng(3)
    params = {"fc": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                     "bias": rng.standard_normal(3).astype(np.float32)},
              "ln": {"scale": rng.standard_normal(3).astype(np.float32)}}
    grads = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape))
                         .astype(np.float32), params)
    assert training._decay_mask(params) == ref_training._decay_mask(params)
    opt = ref_training.make_optimizer(learning_rate=0.5, momentum=0.9,
                                      weight_decay=0.1)
    st = opt.init(params)
    want = params
    for _ in range(2):
        upd, st = opt.update(grads, st, want)
        want = optax.apply_updates(want, upd)
    port_opt = training.make_optimizer(learning_rate=0.5, momentum=0.9,
                                       weight_decay=0.1)
    tp = jax.tree.map(torch.from_numpy, params)
    tg = jax.tree.map(torch.from_numpy, grads)
    pst = port_opt.init(tp)
    got = tp
    for _ in range(2):
        got, pst = port_opt.update(tg, pst, got)
    _assert_tree_close(got, want, F32_TOL, "params")
    # with zero grads only the 2-d leaf moves
    zero = jax.tree.map(torch.zeros_like, tp)
    moved, _ = port_opt.update(zero, port_opt.init(tp), tp)
    assert not torch.equal(moved["fc"]["kernel"], tp["fc"]["kernel"])
    assert torch.equal(moved["fc"]["bias"], tp["fc"]["bias"])
    assert torch.equal(moved["ln"]["scale"], tp["ln"]["scale"])


def test_apply_bn_ema_equals_reference():
    rng = np.random.default_rng(4)

    def tree():
        r = np.random.default_rng(5)
        return {"stem": {"bn": {"mean": r.standard_normal(4),
                                "var": r.random(4), "scale": r.random(4)}},
                "layer1": {"0": {"body": {"bn1": {"mean": r.standard_normal(3),
                                                  "var": r.random(3)}}}}}

    stats = {"stem/bn": (rng.standard_normal(4), rng.random(4)),
             "layer1/0/body/bn1": (rng.standard_normal(3), rng.random(3))}
    want = ref_training._apply_bn_ema(tree(), stats, 0.9)
    got = training._apply_bn_ema(tree(), stats, 0.9)
    for (n, g), (m, w) in zip(_leaves(got), _leaves(want)):
        assert n == m
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", [(6, 4), (3, 5, 4)])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_accuracy_equal_reference(shape, masked):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    mask = (rng.random(shape[:-1]) < 0.6) if masked else None
    args = (jnp.asarray(logits), jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask))
    targs = (torch.from_numpy(logits), torch.from_numpy(labels),
             None if mask is None else torch.from_numpy(mask))
    for ref_fn, fn in ((ref_training.cross_entropy_loss,
                        training.cross_entropy_loss),
                       (ref_training.accuracy, training.accuracy)):
        np.testing.assert_allclose(float(fn(*targs)), float(ref_fn(*args)),
                                   atol=F32_TOL, rtol=0)


def _tiny_loop_setup():
    """The reference's ``TestDNNTrainLoop`` setup, ported: Dense(2) on 4
    features, SGD 0.1."""
    module = port_module.Sequential([("fc", Dense(2))], name="tiny")
    opt = training.make_optimizer(learning_rate=0.1)
    with use_device("cpu"):
        state = training.init_train_state(module, (4,), opt, seed=0)
    return state, training.compile_train_step(module, opt)


def _loop_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(8, 4)).astype(np.float32)
        out.append({"x": x, "y": (x[:, 0] > 0).astype(np.int32)})
    return out


def test_train_loop_preemption_checkpoints_and_resumes(tmp_path):
    state, step = _tiny_loop_setup()
    ckpt = str(tmp_path / "dnn_ckpt")
    guard = training.PreemptionGuard()

    def preempting(batches):
        for i, b in enumerate(batches):
            if i == 4:
                guard.request()
            yield b

    res = training.run_train_loop(state, step, preempting(_loop_batches(10)),
                                  checkpoint_path=ckpt, every_k=100, guard=guard)
    assert res.preempted and res.steps_run == 4 and os.path.exists(ckpt)
    state2, step2 = _tiny_loop_setup()
    res2 = training.run_train_loop(state2, step2, _loop_batches(10),
                                   checkpoint_path=ckpt, guard=None)
    assert not res2.preempted and res2.steps_run == 6
    assert res2.state.step == 10
    full = training.run_train_loop(*_tiny_loop_setup(), _loop_batches(10))
    for (n, a), (_, b) in zip(_leaves(res2.state.params),
                              _leaves(full.state.params)):
        assert torch.equal(a, b), n


def test_train_loop_resume_matches_uninterrupted(tmp_path):
    batches = _loop_batches(8)
    full = training.run_train_loop(*_tiny_loop_setup(), batches)
    assert full.steps_run == 8 and set(full.last_metrics) == {"loss", "accuracy"}
    ckpt = str(tmp_path / "halfway")
    half = training.run_train_loop(*_tiny_loop_setup(), batches[:4],
                                   checkpoint_path=ckpt, every_k=4)
    assert half.steps_run == 4
    res = training.run_train_loop(*_tiny_loop_setup(), batches,
                                  checkpoint_path=ckpt, every_k=100)
    assert res.steps_run == 4
    for tree in ("params", "opt_state"):
        for (n, a), (_, b) in zip(_leaves(getattr(res.state, tree)),
                                  _leaves(getattr(full.state, tree))):
            assert torch.equal(a, b), (tree, n)


def test_train_loop_step_injection_point_fires():
    state, step = _tiny_loop_setup()
    with faults.FaultInjector(seed=0).plan(faults.TRAIN_STEP, at=(3,)) as inj:
        with pytest.raises(faults.InjectedFault):
            training.run_train_loop(state, step, _loop_batches(5))
        assert len(inj.fired(faults.TRAIN_STEP)) == 1


def test_preemption_guard_signal_handler_roundtrip():
    import signal as S
    import time

    prev = S.getsignal(S.SIGUSR1)
    guard = training.PreemptionGuard(signals=(S.SIGUSR1,))
    with guard:
        os.kill(os.getpid(), S.SIGUSR1)
        deadline = time.time() + 2
        while not guard.requested() and time.time() < deadline:
            time.sleep(0.01)
        assert guard.requested()
    assert S.getsignal(S.SIGUSR1) == prev


def test_checkpoint_round_trip(tmp_path):
    _, _, port, state = _train_pair()
    step = training.make_train_step(port.module, training.make_optimizer(
        **TRAIN_OPT))
    state, _ = step(state, _train_batches(1)[0])
    path = str(tmp_path / "state.pt")
    port_checkpoint.save_train_state(state, path)
    for like in (None, state):
        back = port_checkpoint.load_train_state(path, like=like)
        assert back.step == state.step == 1
        for tree in ("params", "opt_state"):
            for (n, a), (_, b) in zip(_leaves(getattr(back, tree)),
                                      _leaves(getattr(state, tree))):
                assert torch.equal(a, b) and a.device == b.device, (tree, n)
    (tmp_path / "bad.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        port_checkpoint.load_train_state(str(tmp_path / "bad.pt"))
    small = transformer_encoder(**dict(ENC, dim=16), seed=0)
    with use_device("cpu"):
        other = training.init_train_state(small.module, (ENC["seq_len"],),
                                          training.make_optimizer())
    with pytest.raises(ValueError, match="shape"):
        port_checkpoint.load_train_state(path, like=other)


def _lstm_pair(ref_mod, port_mod, in_shape):
    params, _ = ref_mod.init(jax.random.key(0), in_shape)
    params = _np_params(jax.tree.map(np.asarray, params), np.random.default_rng(7))
    port_mod.init(torch.Generator().manual_seed(0), in_shape)
    load_jax_params(FunctionModel(port_mod, in_shape), params)
    return params


@pytest.mark.parametrize("make", ["lstm", "lstm_reverse", "bilstm"])
def test_lstm_family_matches_reference(make):
    ref_mod, port_mod = {
        "lstm": (ref_attention.LSTM(6), attention.LSTM(6)),
        "lstm_reverse": (ref_attention.LSTM(6, reverse=True),
                         attention.LSTM(6, reverse=True)),
        "bilstm": (ref_attention.BiLSTM(6), attention.BiLSTM(6))}[make]
    params = _lstm_pair(ref_mod, port_mod, (7, 5))
    x = _x((3, 7, 5))
    ref = np.asarray(ref_mod.apply(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = port_mod(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 7, 12 if make == "bilstm" else 6)
    np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("f32", [True, False])
def test_bilstm_tagger_matches_reference(f32):
    ref = ref_attention.bilstm_tagger(10, 20, 8, 6, 3, seed=0)
    port = attention.bilstm_tagger(10, 20, 8, 6, 3, seed=1)
    assert port.module.layer_paths() == ref.module.layer_paths()
    assert port.layer_names == ref.layer_names
    params = _np_params(jax.tree.map(np.asarray, ref.params),
                        np.random.default_rng(8))
    load_jax_params(port, params)
    ref = type(ref)(ref.module, jax.tree.map(jnp.asarray, params),
                    ref.input_shape, ref.layer_names, ref.name)
    ids = np.random.default_rng(9).integers(0, 20, (4, 10))
    taps = ["bilstm", None]
    if f32:
        with ref_module.matmul_precision("float32"):
            want = ref.apply_taps(jnp.asarray(ids), taps)
        with matmul_precision("float32"):
            got = port.apply_taps(torch.from_numpy(ids), taps)
    else:
        want = ref.apply_taps(jnp.asarray(ids), taps)
        got = port.apply_taps(torch.from_numpy(ids), taps)
    for t in taps:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                   atol=F32_TOL if f32 or t else DEEP_BF16_TOL,
                                   rtol=0, err_msg=str(t))


def test_bilstm_tagger_learns_the_per_token_rule():
    """The reference's ``TestSequenceTraining`` rule (tag = token >= 10)
    trained through the port's loop, without a mesh."""
    module = port_module.Sequential([
        ("embed", Embed(20, 8)), ("bilstm", attention.BiLSTM(8)),
        ("tags", Dense(2))], name="tagger")
    opt = training.make_optimizer(learning_rate=0.2, momentum=0.9)
    with use_device("cpu"):
        state = training.init_train_state(module, (10,), opt)
    step = training.compile_train_step(module, opt)
    rng = np.random.default_rng(0)
    first = last = None
    for _ in range(60):
        toks = rng.integers(0, 20, size=(16, 10))
        state, metrics = step(state, {"x": toks,
                                      "y": (toks >= 10).astype(np.int32)})
        last = {k: float(v) for k, v in metrics.items()}
        first = first or dict(last)
    assert last["loss"] < first["loss"] * 0.2, (first, last)
    assert last["accuracy"] > 0.95, last


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


# ---------------------------------------------------------------------------
# serving: the wire, the obs layer, the controllers, the journal, the server
# ---------------------------------------------------------------------------
#
# Held against the reference (``mmlspark_tpu.io``, ``.obs``, ``.serving``):
# frame bytes, exposition text, parsed trace headers, controller states,
# journal recoveries, reply bytes and statuses are all compared bitwise /
# equal. Served GBDT ``prediction`` replies are class labels, equal to the
# reference's; a served encoder's replies are held to DEEP_BF16_TOL against
# the reference's (the DNNModel slice gate above). No assertion reads a
# latency: servers bind port 0, every HTTP call has a timeout, and every
# server stops in a ``with`` block.

import json as _json  # noqa: E402
import queue as _queue  # noqa: E402
import struct as _struct  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import urllib.error as _urlerr  # noqa: E402
import urllib.request as _urlreq  # noqa: E402
from urllib.parse import urlsplit  # noqa: E402

from mmlspark_tpu.core.pipeline import PipelineModel as RefPipelineModel  # noqa: E402
from mmlspark_tpu.io import binary as ref_binary  # noqa: E402
from mmlspark_tpu.obs import metrics as ref_metrics  # noqa: E402
from mmlspark_tpu.obs import perf as ref_perf  # noqa: E402
from mmlspark_tpu.obs import trace as ref_trace  # noqa: E402
from mmlspark_tpu.serving import executor as ref_executor  # noqa: E402
from mmlspark_tpu.serving import journal as ref_journal  # noqa: E402
from mmlspark_tpu.serving import server as ref_server  # noqa: E402
from mmlspark_tpu.serving import stages as ref_sstages  # noqa: E402
from mmlspark_tpu.serving import supervisor as ref_supervisor  # noqa: E402
from mmlspark_tpu.serving import tenants as ref_tenants  # noqa: E402
from mmlspark_tpu_torch.io import binary  # noqa: E402
from mmlspark_tpu_torch.obs import metrics as obs_metrics  # noqa: E402
from mmlspark_tpu_torch.obs import perf as obs_perf  # noqa: E402
from mmlspark_tpu_torch.obs import trace as obs_trace  # noqa: E402
from mmlspark_tpu_torch.serving import executor as srv_executor  # noqa: E402
from mmlspark_tpu_torch.serving import journal as srv_journal  # noqa: E402
from mmlspark_tpu_torch.serving import server as srv_server  # noqa: E402
from mmlspark_tpu_torch.serving import stages as srv_stages  # noqa: E402
from mmlspark_tpu_torch.serving import supervisor as srv_supervisor  # noqa: E402
from mmlspark_tpu_torch.serving import tenants as srv_tenants  # noqa: E402

HTTP_TIMEOUT = 20
MODES = [(h, a) for h in ("thread", "async") for a in (False, True)]


def _frame_cases():
    rng = np.random.default_rng(5)
    return {
        "golden": {"x": np.arange(6, dtype=np.uint8).reshape(2, 3)},
        "image": {"img": (np.arange(8 * 8 * 3, dtype=np.uint8) % 251).reshape(8, 8, 3)},
        "dtypes": {"f32": np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4),
                   "i64": np.array([-5, 9], dtype=np.int64),
                   "scalar": np.array(7, dtype=np.int32),
                   "empty": np.zeros((0, 2), dtype=np.float64)},
        "strided": {"t": np.arange(64, dtype=np.float32).reshape(8, 8).T[::2]},
        "f64_row": {"x": rng.normal(size=28)},
        "csr": binary.encode_csr_columns(
            "features", *_csr_of(_sparse_matrix(n=6, width=12, seed=3)), 12),
    }


@pytest.mark.parametrize("case", sorted(_frame_cases()))
def test_encode_frame_bytes_equal_reference_and_decode_across(case):
    cols = _frame_cases()[case]
    port_buf = binary.encode_frame(cols)
    ref_buf = ref_binary.encode_frame(cols)
    assert port_buf == ref_buf
    for decode in (binary.decode_frame, ref_binary.decode_frame):
        for buf in (port_buf, ref_buf):
            out = decode(buf)
            assert list(out) == list(cols)
            for k, v in cols.items():
                assert out[k].dtype == v.dtype and out[k].shape == v.shape
                np.testing.assert_array_equal(out[k], v)
    assert binary.frame_info(port_buf)["total_len"] == \
        ref_binary.frame_info(port_buf)["total_len"]
    assert binary.is_frame(port_buf) and not binary.is_frame(b'{"data": [1]}')
    if case == "golden":   # the v1 layout, pinned as tests/test_wire.py pins it
        assert port_buf.hex() == ("4d4d5346" "010001" "2700000000000000" "1000"
                                  "0178" "0102" "0200000003000000" "06000000"
                                  "000102030405")


def _hostile_frames():
    buf = binary.encode_frame({"x": np.arange(6, dtype=np.uint8)})
    out = {"empty": b"", "short3": buf[:3], "short17": buf[:17],
           "minus1": buf[:-1], "plus1": buf + b"Z", "magic": b"XXXX" + buf[4:],
           "zeros": b"\x00" * 40}
    for name, (fmt, off, val) in {"total": ("<Q", 7, 1 << 62),
                                  "hlen": ("<H", 15, 0xFFFF)}.items():
        b = bytearray(buf)
        _struct.pack_into(fmt, b, off, val)
        out[name] = bytes(b)
    b = bytearray(buf)
    b[6] = 255
    out["ncols"] = bytes(b)
    b = bytearray(buf)
    b[4] = 9
    out["version"] = bytes(b)
    return out


@pytest.mark.parametrize("name", sorted(_hostile_frames()))
def test_frame_info_rejects_hostile_frames_like_reference(name):
    bad = _hostile_frames()[name]
    with pytest.raises(binary.FrameError) as port_err:
        binary.frame_info(bad)
    with pytest.raises(ref_binary.FrameError) as ref_err:
        ref_binary.frame_info(bad)
    assert str(port_err.value) == str(ref_err.value)
    big = binary.encode_frame({"x": np.zeros(1024, dtype=np.uint8)})
    with pytest.raises(binary.FrameError) as port_err:
        binary.frame_info(big, max_bytes=512)
    with pytest.raises(ref_binary.FrameError) as ref_err:
        ref_binary.frame_info(big, max_bytes=512)
    assert str(port_err.value) == str(ref_err.value)


def _csr_triple():
    return _csr_of(_sparse_matrix(n=16, width=12, seed=0))


def _hostile_triples():
    indptr, indices, values = _csr_triple()
    return {
        "oob": dict(indices=np.where(indices == indices.max(), 99, indices)),
        "negative": dict(indices=np.where(indices == indices.max(), -1, indices)),
        "non_monotone": dict(indptr=np.concatenate([indptr[:3][::-1], indptr[3:]])),
        "unclosed": dict(indptr=np.concatenate([indptr[:-1], [indptr[-1] + 3]])),
        "short_values": dict(values=values[:-1]),
        "unanchored": dict(indptr=indptr + 1),
        "width": dict(width=0),
        "rank2": dict(values=values.reshape(1, -1)),
        "rows": dict(rows=15),
    }


@pytest.mark.parametrize("name", sorted(_hostile_triples()))
def test_csr_triple_rejects_like_reference(name):
    indptr, indices, values = _csr_triple()
    kw = dict(indptr=indptr, indices=indices, values=values, width=12, rows=None)
    kw.update(_hostile_triples()[name])
    args = ("feat", kw["indptr"], kw["indices"], np.asarray(kw["values"]),
            kw["width"], kw["rows"])
    with pytest.raises(binary.FrameError) as port_err:
        binary.validate_csr_triple(*args)
    with pytest.raises(ref_binary.FrameError) as ref_err:
        ref_binary.validate_csr_triple(*args)
    assert str(port_err.value) == str(ref_err.value)


def test_csr_columns_decode_across_packages():
    indptr, indices, values = _csr_triple()
    cols = binary.encode_csr_columns("feat", indptr, indices, values, 12)
    cols["label"] = np.arange(16, dtype=np.float64)
    buf = binary.encode_frame(cols)
    assert buf == ref_binary.encode_frame(
        ref_binary.encode_csr_columns("feat", indptr, indices, values, 12)
        | {"label": cols["label"]})
    port_rows = binary.decode_csr_columns(binary.decode_frame(buf))
    ref_rows = ref_binary.decode_csr_columns(ref_binary.decode_frame(buf))
    assert set(port_rows) == set(ref_rows) == {"feat", "label"}
    for a, b in zip(port_rows["feat"], ref_rows["feat"]):
        assert a["size"] == b["size"] == 12
        np.testing.assert_array_equal(a["indices"], b["indices"])
        np.testing.assert_array_equal(a["values"], b["values"])
    # a hostile sibling set rejects the whole frame, nothing materialized
    partial = dict(cols)
    del partial["feat:width"]
    with pytest.raises(binary.FrameError):
        binary.decode_csr_columns(partial)


def test_parse_request_decodes_a_csr_frame_to_its_sparse_row():
    X = _sparse_matrix(n=3, width=12, seed=4)
    indptr, indices, values = _csr_of(X[1:2])
    body = binary.encode_frame(
        binary.encode_csr_columns("features", indptr, indices, values, 12))
    headers = np.empty(2, dtype=object)
    headers[:] = [{"Content-Type": binary.FRAME_CONTENT_TYPE}] * 2
    df = DataFrame.from_dict({"value": np.array([body, body[:-2]], dtype=object),
                              "headers": headers})
    col = srv_stages.parse_request(df, "features").column("features")
    row = col[0]
    assert row["size"] == 12 and col[1] is None
    np.testing.assert_array_equal(row["indices"], np.flatnonzero(X[1]))
    np.testing.assert_array_equal(row["values"], X[1][np.flatnonzero(X[1])])


# -- metrics, traces, perf ----------------------------------------------------


def _fill_registry(mod, reg):
    c = reg.counter("mmlspark_demo_requests_total", "requests", ("route",))
    c.labels(route="a").inc(3)
    c.labels(route='b"\\').inc()
    g = reg.gauge("mmlspark_demo_depth", "queue depth\nsecond line")
    g.set(7.25)
    h = reg.histogram("mmlspark_demo_latency_seconds", "latency",
                      buckets=mod.SERVING_LATENCY_BUCKETS)
    rng = np.random.default_rng(9)
    for i, v in enumerate(rng.exponential(0.01, size=40)):
        h.observe(float(v), exemplar={"trace_id": f"{i:032x}"} if i % 3 == 0 else None)
    h2 = reg.histogram("mmlspark_demo_build_seconds", "builds", ("seg",),
                       buckets=mod.COMPILE_BUCKETS)
    h2.labels(seg="s").observe(0.3)
    h2.labels(seg="s").observe(1e9)

    def collect():
        fam = mod.MetricFamily("mmlspark_demo_collected", "gauge", "from a collector")
        fam.add(1.5, {"k": "v"}).add(float("inf"), {"k": "w"}).add(float("nan"))
        return [fam]

    reg.register_collector(collect)


@pytest.mark.parametrize("exemplars", [False, True])
def test_exposition_text_equals_reference(monkeypatch, exemplars):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    port_reg, ref_reg = obs_metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    _fill_registry(obs_metrics, port_reg)
    _fill_registry(ref_metrics, ref_reg)
    assert port_reg.exposition(exemplars=exemplars) == \
        ref_reg.exposition(exemplars=exemplars)
    assert obs_metrics.MetricsRegistry.OPENMETRICS_CONTENT_TYPE == \
        ref_metrics.MetricsRegistry.OPENMETRICS_CONTENT_TYPE
    h = "mmlspark_demo_latency_seconds"
    assert port_reg.histogram(h, buckets=obs_metrics.SERVING_LATENCY_BUCKETS).snapshot() \
        == ref_reg.histogram(h, buckets=ref_metrics.SERVING_LATENCY_BUCKETS).snapshot()


TRACE_HEADERS = ["0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
                 "0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00",
                 "  abc-def-01 ", "abc-def", "xyz-def-01", "-def-01", "abc--01",
                 "abc-def-01-extra", "", None]


@pytest.mark.parametrize("value", TRACE_HEADERS)
def test_trace_headers_parse_like_reference(value):
    def fields(ctx):
        return None if ctx is None else (ctx.trace_id, ctx.span_id, ctx.parent_id,
                                         ctx.sampled, ctx.to_header())

    assert fields(obs_trace.parse_trace_header(value)) == \
        fields(ref_trace.parse_trace_header(value))
    for key in (obs_trace.TRACE_HEADER, obs_trace.TRACE_HEADER.lower(),
                obs_trace.TRACE_HEADER.upper()):
        hdrs = {key: value, "Other": "x"}
        assert fields(obs_trace.context_from_headers(hdrs)) == \
            fields(ref_trace.context_from_headers(hdrs))


def test_tracer_ingress_and_spans_like_reference():
    port, ref = obs_trace.Tracer(sample_rate=0.5, seed=3), ref_trace.Tracer(
        sample_rate=0.5, seed=3)
    hdr = {obs_trace.TRACE_HEADER: TRACE_HEADERS[0]}
    for t in (port, ref):
        for _ in range(20):
            t.ingress({})
        t.record("drain", t.ingress(hdr), 1.0, 0.5, rows=3)
    assert port.stats() == ref.stats()
    p_spans, r_spans = port.spans(), ref.spans()
    assert [(s["name"], s["trace_id"], s["parent_id"], s["attrs"]) for s in p_spans] \
        == [(s["name"], s["trace_id"], s["parent_id"], s["attrs"]) for s in r_spans]


def test_slo_tracker_burn_rates_equal_reference():
    clock = [1000.0]
    cfg = dict(objective_ms=50.0, target=0.9, windows_s=(10, 60))
    port = obs_perf.SLOTracker(obs_perf.SLOConfig(**cfg), clock=lambda: clock[0])
    ref = ref_perf.SLOTracker(ref_perf.SLOConfig(**cfg), clock=lambda: clock[0])
    rng = np.random.default_rng(11)
    for lat, step, shed in zip(rng.exponential(0.04, 300), rng.random(300),
                               rng.random(300) < 0.05):
        clock[0] += float(step) * 0.5
        for t in (port, ref):
            t.record(float(lat), breach=True if shed else None)
        assert port.burn_rates() == ref.burn_rates()
    assert port.summary() == ref.summary()
    port_reg, ref_reg = obs_metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    port_reg.register_collector(port.families)
    ref_reg.register_collector(ref.families)
    assert port_reg.exposition() == ref_reg.exposition()


def test_device_peaks_and_memory_families_on_a_cpu_host(monkeypatch):
    monkeypatch.delenv("MMLSPARK_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("MMLSPARK_PEAK_GBPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    peaks = obs_perf.device_peaks()
    assert peaks["peak_source"] == "nominal" and peaks["device_kind"] is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    peaks = obs_perf.device_peaks(data_shards=2)
    assert peaks["flops"] == 2 * 989e12 and peaks["bytes_per_s"] == 2 * 3.35e12
    assert peaks["peak_source"] == "tablex2"
    # a scrape never initialises CUDA: nothing before the process has
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert obs_perf.device_memory_families() == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda i: {"allocated_bytes.all.current": 512, "note": "x"})
    (fam,) = obs_perf.device_memory_families()
    assert fam.name == "mmlspark_device_memory_bytes"
    assert [(s.labels, s.value) for s in fam.samples] == [
        ({"device": "cuda:0", "stat": "allocated_bytes.all.current"}, 512.0)]


# -- controllers ----------------------------------------------------------------


def test_adaptive_batch_controller_states_equal_reference():
    kw = dict(alpha=0.6, min_wait_ms=0.5, max_wait_ms=20.0, init_wait_ms=4.0)
    port = srv_executor.AdaptiveBatchController(**kw)
    ref = ref_executor.AdaptiveBatchController(**kw)
    rng = np.random.default_rng(12)
    for i in range(200):
        args = (float(rng.exponential(0.01)), float(rng.exponential(0.004)),
                int(rng.integers(1, 64)), int(rng.integers(0, 100)))
        for c in (port, ref):
            c.observe(*args)
            if i == 50:
                c.seed_compute_ms(3.0)
            if i == 120:
                c.set_window_clamp(5.0)
        assert port.state() == ref.state()
        assert port.window_ms() == ref.window_ms()


def test_tenant_admission_decisions_equal_reference():
    w = {"gold": 3.0, "free": 1.0}
    port, ref = srv_tenants.TenantAdmission(w), ref_tenants.TenantAdmission(w)
    rng = np.random.default_rng(13)
    names = ["gold", "free", "default", "other"]
    live = {"port": [], "ref": []}
    for i in range(400):
        t = names[int(rng.integers(0, 4))]
        depth, cap = int(rng.integers(0, 12)), int(rng.integers(0, 10))
        got = [port.try_admit(t, depth, cap), ref.try_admit(t, depth, cap)]
        assert got[0] == got[1]
        if got[0]:
            live["port"].append(t)
            live["ref"].append(t)
        if live["port"] and rng.random() < 0.45:
            k = int(rng.integers(0, len(live["port"])))
            port.release(live["port"].pop(k))
            ref.release(live["ref"].pop(k))
        if i == 200:
            assert port.set_pressure(0.5) == ref.set_pressure(0.5)
        assert port.summary() == ref.summary()
    hdrs = {"x-mmlspark-tenant": " gold "}
    assert srv_tenants.TenantAdmission.tenant_of(hdrs) == \
        ref_tenants.TenantAdmission.tenant_of(hdrs) == "gold"
    for spec in ("a=3,b=1", "1", "off", None, ""):
        p, r = srv_tenants.tenants_from_spec(spec), ref_tenants.tenants_from_spec(spec)
        assert (p is None) == (r is None) and (p is None or p.weights == r.weights)


def test_replica_supervisor_and_watchdog_states_equal_reference():
    clock = [0.0]
    kw = dict(max_failures=2, quarantine_s=0.5, clock=lambda: clock[0])
    port = srv_supervisor.ReplicaSupervisor([0, 1, 3], **kw)
    ref = ref_supervisor.ReplicaSupervisor([0, 1, 3], **kw)
    wd_kw = dict(k=4.0, min_budget_s=0.05)
    pwd, rwd = srv_supervisor.DispatchWatchdog(**wd_kw), ref_supervisor.DispatchWatchdog(
        **wd_kw)
    rng = np.random.default_rng(14)
    for _ in range(300):
        clock[0] += float(rng.random()) * 0.2
        idx = [0, 1, 3][int(rng.integers(0, 3))]
        ev = int(rng.integers(0, 6))
        for sup, wd in ((port, pwd), (ref, rwd)):
            if ev <= 2:
                sup.note_success(idx, 0.004 * (ev + 1))
                wd.observe(0.004 * (ev + 1))
            elif ev == 3:
                sup.note_failure(idx)
            elif ev == 4:
                sup.note_wedged(idx)
                wd.note_trip("requeue")
            elif sup.probe_due(idx):
                sup.begin_probe(idx)
                sup.note_probe(idx, bool(idx != 3))
        assert port.summary() == ref.summary()
        assert [port.admitted(i) for i in (0, 1, 3)] == [ref.admitted(i) for i in (0, 1, 3)]
        assert port.healthy_peers(idx) == ref.healthy_peers(idx)
        assert pwd.budget_s(32) == rwd.budget_s(32) and pwd.summary() == rwd.summary()


def test_brownout_controller_states_equal_reference():
    clock = [0.0]
    burn = {"v": 0.0}

    class Slo:
        def burn_rates(self):
            return {60: burn["v"]}

    def ladder(mod, log):
        return [mod.BrownoutStep(n, lambda n=n: log.append(("apply", n)),
                                 lambda n=n: log.append(("revert", n)))
                for n in ("batch_window", "demote_segments", "tighten_admission")]

    logs = {"port": [], "ref": []}
    kw = dict(enter_burn=2.0, exit_burn=0.5, hold_s=1.0, check_interval_s=0.1,
              clock=lambda: clock[0])
    port = srv_supervisor.BrownoutController(Slo(), ladder(srv_supervisor, logs["port"]),
                                             **kw)
    ref = ref_supervisor.BrownoutController(Slo(), ladder(ref_supervisor, logs["ref"]),
                                            **kw)
    rng = np.random.default_rng(15)
    for i in range(300):
        clock[0] += 0.05 + float(rng.random()) * 0.3
        burn["v"] = 4.0 if (i // 60) % 2 == 0 else 0.1
        assert port.check() == ref.check()
        if i == 250:
            assert port.rollback() == ref.rollback()
        assert port.summary() == ref.summary()
    assert logs["port"] == logs["ref"] and logs["port"]
    assert port.transitions["restore"] > 0 and port.transitions["degrade"] > 0


def test_hedge_tracker_equal_reference():
    cfg = dict(quantile=0.9, min_delay_ms=1.0, max_delay_ms=500.0, min_samples=5)
    port = srv_supervisor.make_hedge(cfg)
    ref = ref_supervisor.make_hedge(cfg)
    rng = np.random.default_rng(16)
    for v in rng.exponential(0.02, 60):
        for t in (port, ref):
            t.note_request()
            t.observe(float(v))
        assert port.delay_s() == ref.delay_s()
    for t in (port, ref):
        t.note_hedged()
        t.note_win("hedge")
        t.note_suppressed()
    assert port.summary() == ref.summary()


# -- the journal ------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_journal_written_by_one_package_recovers_in_the_other(tmp_path, writer):
    mods = {"port": srv_journal, "ref": ref_journal}
    path = str(tmp_path / "journal.jsonl")
    frame = binary.encode_frame({"x": np.arange(5, dtype=np.float32)})
    j = mods[writer].RequestJournal(path)
    j.append_many(1, [(11, b'{"data": [1, 2]}', {"X-A": "1"}), (12, frame, {})])
    j.append_many(2, [(13, b"plain", {"H": "v"})])
    j.commit(1)
    j.append(3, 14, frame + b"\n\n", {"Content-Type": "x"})
    j.close()
    with open(path, "ab") as fh:
        fh.write(b'{"op": "entry", "epoch": 4, "id": 1')  # torn tail
    want = mods["ref"].RequestJournal.recover(path)
    assert srv_journal.RequestJournal.recover(path) == want
    assert [r[0] for r in want] == [13, 14]
    other = mods["ref" if writer == "port" else "port"].RequestJournal(path)
    other.compact()
    other.close()
    for mod in mods.values():
        assert mod.RequestJournal.recover(path) == want


# -- the server against the JAX server --------------------------------------------


def _echo_sum_with(parse):
    def transform(df):
        parsed = parse(df, "data", parse="json")
        return parsed.with_column(
            "reply", lambda p: [None if v is None else float(np.asarray(v).sum())
                                for v in p["data"]])
    return transform


def _post(address, body, headers=None, timeout=HTTP_TIMEOUT, method="POST"):
    req = _urlreq.Request(address, data=body if method == "POST" else None,
                          method=method, headers=dict(headers or {}))
    try:
        with _urlreq.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), resp.headers.get("Content-Type")
    except _urlerr.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


class _FullQueue(_queue.Queue):
    """An ingress queue that reads as full to admission (``qsize``) while
    the batcher drains it as usual: the tenant gate's 503 without timing."""

    def qsize(self):
        return max(super().qsize(), 1)


def _echo_requests():
    row = np.array([1.5, -2.25, 4.0])
    frame_ct = {"Content-Type": binary.FRAME_CONTENT_TYPE}
    frame = binary.encode_frame({"data": row})
    return [("json", _json.dumps({"data": row.tolist()}).encode(), {}),
            ("frame", frame, frame_ct),
            ("bad_frame", frame[:-3], frame_ct),
            ("deadline", b"[1]", {"X-MMLSpark-Deadline": "1.0"}),
            ("tenant", b"[1]", {"X-MMLSpark-Tenant": "a"}),
            ("text", b"not json", {})]


def _serve_echo(server, tenant_module):
    server._queue = _FullQueue()
    server._tenants.try_admit("a", 0, 0)  # tenant a holds its one share
    out = {}
    with server:
        for name, body, hdrs in _echo_requests():
            out[name] = _post(server.address, body, hdrs)
        health = _post(server.address.rstrip("/") + "/_mmlspark/healthz", b"")
        out["healthz"] = health
        stats = _json.loads(_post(server.address.rstrip("/") + "/_mmlspark/stats",
                                  b"")[1])
        out["shed"] = stats["shed"]
        out["wire"] = stats["wire"]
        out["missing"] = _post(server.address.rstrip("/") + "/nope", b"")
    return out


@pytest.mark.parametrize("http_mode,async_exec", MODES)
def test_server_replies_equal_reference_server(http_mode, async_exec):
    kw = dict(port=0, max_wait_ms=0.0, http_mode=http_mode, async_exec=async_exec,
              max_queue=1, tenants={"a": 1.0})
    with use_device("cpu"):
        port = srv_server.ServingServer(_echo_sum_with(srv_stages.parse_request), **kw)
    ref = ref_server.ServingServer(_echo_sum_with(ref_sstages.parse_request), **kw)
    got = _serve_echo(port, srv_tenants)
    want = _serve_echo(ref, ref_tenants)
    assert got == want
    assert got["json"][:2] == (200, b"3.25") and got["frame"] == got["json"]
    assert got["bad_frame"][0] == 400 and got["deadline"][0] == 504
    assert got["tenant"][0] == 503 and got["text"][0] == 204
    assert got["shed"]["by_reason"] == {"bad_frame": 1, "deadline_ingress": 1,
                                        "tenant_over_share": 1}


def test_server_token_gate_and_reply_hop_equal_reference():
    outs = []
    for mod, parse, dev in ((srv_server, srv_stages.parse_request, ["cpu"]),
                            (ref_server, ref_sstages.parse_request, None)):
        kw = {"devices": dev} if dev else {}
        handoff = mod.ServingServer(lambda df: df.limit(0), port=0, token="s3cret",
                                    slot_timeout_s=10, **kw)
        with handoff:
            parts = urlsplit(handoff.address)
            internal = f"http://{parts.netloc}{mod.ServingServer.INTERNAL_REPLY_PATH}"
            denied = _post(internal, b"{}")
            res = {}
            t = threading.Thread(target=lambda: res.update(
                r=_post(handoff.address, b'{"data": 1}')))
            t.start()
            rid = None
            for _ in range(1000):  # the request's slot exists once enqueued
                with handoff._id_lock:
                    rid = next(iter(handoff._slots), None)
                if rid is not None:
                    break
                time.sleep(0.01)
            mod.reply_to(handoff.address, rid, {"answer": np.float32(2.5)},
                         token="s3cret")
            t.join(timeout=HTTP_TIMEOUT)
            assert not t.is_alive()
        outs.append((denied, res["r"]))
    assert outs[0] == outs[1]
    assert outs[0][0][0] == 403 and outs[0][1][:2] == (200, b'{"answer": 2.5}')


def test_server_devices_and_unported_knobs(monkeypatch):
    with use_device("cpu"):
        with srv_server.ServingServer(_echo_sum_with(srv_stages.parse_request),
                                      port=0, async_exec=True) as server:
            assert server._devices == [torch.device("cpu")]
            assert _post(server.address, b'{"data": [1, 2]}')[:2] == (200, b"3.0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        srv_server.ServingServer(_echo_sum_with(srv_stages.parse_request), port=0)
    for knob in ("fleet", "lifecycle", "multimodel"):
        with pytest.raises(NotImplementedError, match="ROADMAP A step 10"):
            srv_server.serve_pipeline(PipelineModel([]), "x", devices=["cpu"],
                                      **{knob: True})
    # the Tuner is ported: autotune wires one, tuner= is taken as given
    fused = FusedPipelineModel([], cache=CompileCache())
    srv = srv_server.serve_pipeline(fused, "x", devices=["cpu"], autotune=True,
                                    tune_every=7)
    assert srv._tuner is not None and srv._tuner.every == 7
    assert srv._tuner.fused is fused and fused.cost_model is srv._tuner.model
    from mmlspark_tpu_torch.core.tune import Tuner

    tuner = Tuner(fused=fused)
    assert srv_server.ServingServer(lambda df: df, devices=["cpu"],
                                    tuner=tuner)._tuner is tuner
    fused.set_tuning(mega_k={"x": 1})  # K = 1 is the plain dispatch
    fused.set_tuning(mega_k={"x": 2})  # the K-step mega dispatch
    assert fused.mega_k_max == 2
    # the mesh knobs (ported since): set, kept, and cleared as
    # Tuner._push sends them
    fused.set_tuning(sharding={"x": "data"}, pipe_depth=2)
    assert fused._sharding_overrides == {"x": "data"}
    assert fused._pipe_depth == 2
    fused.set_tuning(sharding=None, pipe_depth=None)
    assert fused._pipe_depth == 2
    fused.set_tuning(sharding={}, pipe_depth=1)
    assert fused._sharding_overrides == {} and fused._pipe_depth is None
    from mmlspark_tpu_torch.serving import RoutingFront

    with pytest.raises(NotImplementedError, match="ROADMAP A step 10"):
        RoutingFront(fabric=True)


# -- serve_pipeline against the JAX package's -----------------------------------


N_SERVED = 40


def _post_all(server, bodies, headers=None, threads=8):
    """POST every body from ``threads`` client threads at once (so rows
    coalesce into batches of several sizes); replies in body order."""
    out = [None] * len(bodies)

    def run(k):
        for i in range(k, len(bodies), threads):
            out[i] = _post(server.address, bodies[i], headers)

    with server:
        pool = [threading.Thread(target=run, args=(k,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=4 * HTTP_TIMEOUT)
        assert not any(t.is_alive() for t in pool)
    return out


def _gbdt_bodies(X, kind):
    frame_ct = {"Content-Type": binary.FRAME_CONTENT_TYPE}
    if kind == "json":
        return [_json.dumps({"data": r.tolist()}).encode() for r in X], None
    if kind == "frame":
        return [binary.encode_frame({"x": r.astype(np.float64)}) for r in X], frame_ct
    if kind == "sparse_json":
        return [_json.dumps({"indices": np.flatnonzero(r).tolist(),
                             "values": r[np.flatnonzero(r)].tolist(),
                             "size": len(r)}).encode() for r in X], None
    bodies = []
    for r in X:
        cols = binary.encode_csr_columns("features", *_csr_of(r[None, :]), len(r))
        bodies.append(binary.encode_frame(cols))
    return bodies, frame_ct


@pytest.fixture(scope="module")
def served_reference(models):
    """The JAX package's fused serve of the classifier: prediction replies
    for the first rows, dense (JSON) and sparse (JSON dicts)."""
    X = models["X"][:N_SERVED]
    out = {}
    for kind in ("json", "sparse_json"):
        bodies, hdrs = _gbdt_bodies(X, kind)
        srv = ref_server.serve_pipeline(RefPipelineModel([models["ref"]["clf"]]),
                                        "features", reply_col="prediction",
                                        fused=True, max_wait_ms=2.0)
        out[kind] = _post_all(srv, bodies, hdrs)
    return out


@pytest.mark.parametrize("http_mode,async_exec", MODES)
@pytest.mark.parametrize("kind", ["json", "frame", "csr_frame", "sparse_json"])
def test_served_gbdt_predictions_equal_reference(models, served_reference, monkeypatch,
                                                 kind, http_mode, async_exec):
    calls = []
    real = gather_kernel.csr_gather

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(gather_kernel, "csr_gather", counting)
    X = models["X"][:N_SERVED]
    fused = PipelineModel([models["port"]["clf"]]).fuse()
    sparse = kind in ("csr_frame", "sparse_json")
    if sparse:
        label = "LightGBMClassificationModel"
        fused.set_tuning(layout={label: "csr"},
                         kernel_variants={label: {"*": "forest.csr"}})
    bodies, hdrs = _gbdt_bodies(X, kind)
    with use_device("cpu"):
        srv = srv_server.serve_pipeline(fused, "features", reply_col="prediction",
                                        fused=True, max_wait_ms=2.0, replicas=2,
                                        http_mode=http_mode, async_exec=async_exec)
    got = _post_all(srv, bodies, hdrs)
    want = served_reference["sparse_json" if sparse else "json"]
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert all(g[0] == 200 for g in got)
    assert fused.fusion_stats()["fallbacks"] == []
    assert bool(calls) == sparse
    if sparse:
        assert _seg(fused).get("csr_batches", 0) >= 1


def test_fused_transform_submit_is_bitwise_transform(models):
    X = models["X"][:70]
    for model, sparse in ((models["port"]["clf"], False), (models["port"]["reg"], True)):
        fused = _csr_fused(model) if sparse else _fused(model)
        df = DataFrame.from_dict({"features": _rows(X, sparse)}, num_partitions=2)
        with use_device("cpu"):
            want = fused.transform(df)
            got = fused.transform_submit(df)()
        for c in want.columns:
            a, b = want.column(c), got.column(c)
            if a.dtype == object:
                for u, v in zip(a, b):
                    if isinstance(u, dict):
                        assert u is v
                    else:
                        assert np.array_equal(_bits(u), _bits(v))
            else:
                assert np.array_equal(a, b)
        ingest = fused.last_ingest_stats
        assert ingest is not None and ingest.summary()["n_batches"] >= 2
        assert fused.fusion_stats()["fallbacks"] == []


def _encoder_bodies(n, frames):
    toks = _tokens(n, seed=7).astype(np.int32)
    if frames:
        return ([binary.encode_frame({"tokens": t}) for t in toks],
                {"Content-Type": binary.FRAME_CONTENT_TYPE})
    return [_json.dumps({"data": t.tolist()}).encode() for t in toks], None


def test_served_encoder_within_dnn_gate_of_reference():
    ref, port = _encoders()
    bodies, hdrs = _encoder_bodies(12, frames=False)
    ref_stage = RefDNNModel(inputCol="tokens", outputCol="out", batchSize=4)
    ref_stage.set_model(ref)
    want = _post_all(ref_server.serve_pipeline(ref_stage, "tokens", max_wait_ms=2.0),
                     bodies, hdrs, threads=4)
    stage = DNNModel(inputCol="tokens", outputCol="out", batchSize=4).set_model(port)
    replies = {}
    for fused_chain in (False, True):
        served = PipelineModel([stage]) if fused_chain else stage
        for frames in (False, True):
            bodies, hdrs = _encoder_bodies(12, frames)
            with use_device("cpu"):
                srv = srv_server.serve_pipeline(
                    served, "tokens", reply_col="out", fused=True, async_exec=True,
                    max_wait_ms=2.0)
            replies[(fused_chain, frames)] = _post_all(srv, bodies, hdrs, threads=4)
    for got in replies.values():
        assert all(g[0] == 200 for g in got)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(_json.loads(g[1])),
                                       np.asarray(_json.loads(w[1])),
                                       atol=DEEP_BF16_TOL, rtol=0)
    # the port's own replies: the same bytes whichever wire or chain served
    assert len({tuple(r[1] for r in v) for v in replies.values()}) == 1


def test_fused_async_server_equals_serial_server(models):
    X = models["X"][:N_SERVED]
    bodies, hdrs = _gbdt_bodies(X, "csr_frame")
    replies = []
    for async_exec, inflight in ((False, 1), (True, 2)):
        fused = _csr_fused(models["port"]["reg"])
        with use_device("cpu"):
            srv = srv_server.serve_pipeline(fused, "features", reply_col="prediction",
                                            fused=True, async_exec=async_exec,
                                            inflight=inflight, replicas=2,
                                            max_wait_ms=1.0)
        replies.append(_post_all(srv, bodies, hdrs))
    assert replies[0] == replies[1]
    assert all(r[0] == 200 for r in replies[0])


@pytest.mark.parametrize("front_mode", ["thread", "async"])
def test_routing_front_fails_over_when_a_worker_stops_hard(front_mode):
    """Two port workers behind a front; one is stopped hard (its transport
    closes its kept-alive connections, as a crashed worker's would): every
    request is still answered 200, and the dead worker's breaker opens."""
    from mmlspark_tpu_torch.serving import RoutingFront

    with use_device("cpu"):
        workers = [srv_server.ServingServer(_echo_sum_with(srv_stages.parse_request),
                                            port=0, max_wait_ms=0.0,
                                            http_mode="async", async_exec=True)
                   for _ in range(2)]
    for w in workers:
        w.start()
    try:
        with RoutingFront(http_mode=front_mode, max_failures=2) as front:
            for w in workers:
                front.register(w.address, capacity=w.capacity)
            before = [_post(front.address, b'{"data": [1, 2]}') for _ in range(6)]
            workers[0].stop(drain=False)
            after = [_post(front.address, b'{"data": [2, 2]}') for _ in range(8)]
            states = front.worker_states
    finally:
        for w in workers:
            w.stop(drain=False)
    assert [r[:2] for r in before] == [(200, b"3.0")] * 6
    assert [r[:2] for r in after] == [(200, b"4.0")] * 8
    assert states[workers[0].address] == "open"
    assert states[workers[1].address] == "closed"


# -- the cost model, the Tuner, cost attribution, slots and mega dispatch ------
#
# Inputs made from a seed go through the reference (``mmlspark_tpu.core.
# costmodel``, ``core.tune``, ``obs.perf``, ``parallel.ingest``, ``core.
# fusion``) and the port. Tolerances: the cost model, the Tuner, KnobSet,
# attribute_segments and the slot-pool counters are host arithmetic, held
# equal; the tally's flops of a GEMM program exactly 2*m*n*k; mega outputs
# bitwise equal to K=1 (the same per-batch program on the same batches) and
# within PORT_VS_REF_ATOL of the reference's transform_submit (carried-model
# scoring, as above; the DNNModel at f32, 1e-5 as above).

from mmlspark_tpu.core import costmodel as ref_costmodel  # noqa: E402
from mmlspark_tpu.core import tune as ref_tune  # noqa: E402
from mmlspark_tpu.obs import bridge as ref_bridge  # noqa: E402
from mmlspark_tpu.parallel import ingest as ref_ingest  # noqa: E402
from mmlspark_tpu_torch.core import costmodel, tune  # noqa: E402
from mmlspark_tpu_torch.obs import bridge as obs_bridge  # noqa: E402
from mmlspark_tpu_torch.parallel import ingest  # noqa: E402

PEAKS = {"flops": 1e12, "bytes_per_s": 1e11, "peak_source": "test"}
SEGS = ("A", "A+B", "C")


def _timings(timing_cls, rng, n, mega_k=1):
    """Seeded BatchTiming rows of one package: buckets 16/32/64, stage
    seconds in ranges where dispatch sometimes dominates."""
    out = []
    for _ in range(n):
        bucket = int(rng.choice([16, 32, 64]))
        out.append(timing_cls(
            queue_s=float(rng.uniform(0, 1e-3)),
            h2d_s=float(rng.uniform(1e-4, 2e-3)),
            dispatch_s=float(rng.uniform(1e-4, 8e-3)),
            compute_s=float(rng.uniform(1e-4, 4e-3)),
            readback_s=float(rng.uniform(1e-5, 1e-3)),
            rows=int(rng.integers(1, bucket + 1)), padded_rows=bucket,
            mega_k=mega_k))
    return out


def _fed_models(seed):
    """A reference and a port SegmentCostModel fed the same seeded
    observe_* / ingest_costs sequence."""
    ref = ref_costmodel.SegmentCostModel(peaks=dict(PEAKS), min_obs=3)
    port = costmodel.SegmentCostModel(peaks=dict(PEAKS), min_obs=3)
    costs = {}
    for i, seg in enumerate(SEGS):
        costs[seg] = {f"x={b}x8:float32": {"flops": 1e6 * b * (i + 1),
                                          "bytes_accessed": 4e4 * b,
                                          "compile_s": 0.5 + i,
                                          "output_bytes": 4.0 * b,
                                          "argument_bytes": 32.0 * b}
                      for b in (16, 64)}
        costs[seg]["mega4;x=16x8:float32"] = {"flops": 1.0}
    for m, cls in ((ref, ref_ingest.BatchTiming), (port, ingest.BatchTiming)):
        rng = np.random.default_rng(seed)
        m.ingest_costs(costs)
        for seg in SEGS:
            for t in _timings(cls, rng, int(rng.integers(2, 12)),
                              mega_k=int(rng.choice([1, 1, 4]))):
                m.observe_batch(seg, t)
            for stage in seg.split("+"):
                for _ in range(int(rng.integers(1, 6))):
                    m.observe_host(stage, float(rng.uniform(1e-4, 5e-2)),
                                   int(rng.integers(1, 200)))
            for _ in range(int(rng.integers(0, 6))):
                m.observe_nnz(seg, int(rng.integers(1, 300)),
                              int(rng.integers(0, 4000)),
                              int(rng.choice([64, 1 << 18])))
            for vid in ("default", "forest.gemm"):
                for _ in range(int(rng.integers(0, 6))):
                    m.observe_variant(seg, 32, vid, float(rng.uniform(1e-3, 3e-3)))
        for op in ("all_gather", "pipe_handoff"):
            for _ in range(int(rng.integers(0, 4))):
                m.observe_collective(op, float(rng.uniform(1e3, 1e6)),
                                     float(rng.uniform(1e-5, 1e-3)))
    return ref, port


def _decisions(m):
    cands = [{"name": "data", "shards": 4, "op": "all_gather",
              "collective_bytes": 4096.0},
             {"name": "none", "shards": 1}]
    out = {"to_dict": m.to_dict(), "stats": m.stats(),
           "error": m.prediction_error(), "segments": m.segments()}
    for seg in SEGS:
        out[seg] = {
            "predict": [m.predict(seg, batch=b) for b in (1, 16, 20, 48, 64, 99)],
            "shape": m.predict_ms(seg, shape="x=64x8:float32"),
            "mega_shape": m.predict_ms(seg, shape="mega4;x=64x8:float32"),
            "buckets": m.choose_buckets(seg, 64),
            "buckets_cands": m.choose_buckets(seg, 64, candidates=[8, 24, 64]),
            "fuse": m.fuse_decision(seg), "mega_k": m.choose_mega_k(seg),
            "layout": m.choose_layout(seg), "variant": m.choose_variant(seg, 32),
            "sharding": m.choose_sharding(seg, 64, cands),
            "confidence": m.confidence(seg), "calibrated": m.calibrated(seg),
            "nnz_bytes": m.nnz_bytes(seg, 32), "dense_bytes": m.dense_bytes(seg, 32),
            "per_row": m.per_row_ms(seg, 32),
            "sharded": m.predict_sharded_ms(seg, 64, 4, 1024.0)}
    out["stitch"] = [m.stitch_decision(a, b) for a in SEGS for b in SEGS]
    out["pipe"] = [m.choose_pipe_depth(list(SEGS), 32, 3),
                   m.choose_pipe_depth(list(SEGS), 32, 3, handoff_bytes=512.0),
                   m.predict_pipelined_ms(list(SEGS), 32)]
    out["collective"] = [m.collective_ms("all_gather", 1e5),
                         m.collective_calibrated()]
    return out


@pytest.mark.parametrize("seed", range(6))
def test_cost_model_decisions_equal_reference(seed):
    ref, port = _fed_models(seed)
    assert _decisions(port) == _decisions(ref)


@pytest.mark.parametrize("seed", range(3))
def test_cost_model_loads_a_reference_model(seed):
    ref, _ = _fed_models(seed)
    blob = _json.loads(_json.dumps(ref.to_dict()))
    port = costmodel.SegmentCostModel.from_dict(blob, peaks=dict(PEAKS))
    loaded = ref_costmodel.SegmentCostModel.from_dict(blob, peaks=dict(PEAKS))
    assert _decisions(port) == _decisions(loaded)
    back = ref_costmodel.SegmentCostModel.from_dict(port.to_dict(), peaks=dict(PEAKS))
    assert back.to_dict() == loaded.to_dict()


@pytest.mark.parametrize("key", ["x=8x4:float32;", "mega4;x=8x4:float32;",
                                 "mega2;spec=data;x=8x4:float32;",
                                 "variant=forest.csr;layout=csr;x=256:int32",
                                 "stitch=A;x=16x2:uint8", "garbage"])
def test_bucket_of_shape_equals_reference(key):
    assert costmodel.bucket_of_shape(key) == ref_costmodel.bucket_of_shape(key)


class _StubNode:
    def __init__(self, label, cap):
        self.label, self._cap, self.dfns = label, cap, ()

    def batch_size(self):
        return self._cap


class _StubCache:
    def __init__(self, costs):
        self._costs = costs

    def costs(self):
        return self._costs


class _StubFused:
    """A duck-typed fused model: a plan of two segments, live IngestStats
    the ``measure`` below feeds, a cost cache, and a recording set_tuning."""

    def __init__(self, pkg_ingest):
        self._ingest = pkg_ingest
        self._last_plan = [_StubNode("A", 64), _StubNode("C", 32)]
        self._seg_stats = {"A": pkg_ingest.IngestStats(),
                           "C": pkg_ingest.IngestStats()}
        self._cache = _StubCache({"A": {"x=64x8:float32": {
            "flops": 6.4e7, "bytes_accessed": 2.6e6, "compile_s": 0.4}}})
        self.calls = []
        self.shard_mesh = None

    def set_tuning(self, **kw):
        self.calls.append(_json.loads(_json.dumps(
            {k: (v if not isinstance(v, dict) else
                 {a: (list(b) if isinstance(b, tuple) else b)
                  for a, b in v.items()}) for k, v in kw.items()})))


def _tuner_run(pkg_tune, pkg_ingest, seed, every=0):
    fused = _StubFused(pkg_ingest)
    model = (ref_costmodel if pkg_tune is ref_tune else costmodel) \
        .SegmentCostModel(peaks=dict(PEAKS), min_obs=2)
    t = pkg_tune.Tuner(fused=fused, model=model, every=every)
    t._replica_suggestion = lambda compute, transfer: 2 if compute > transfer else 1
    rng = np.random.default_rng(seed)

    def measure():
        for label, st in fused._seg_stats.items():
            for tm in _timings(pkg_ingest.BatchTiming, rng, 3):
                st.record(tm)
        return float(rng.uniform(80.0, 120.0))

    if every:
        for _ in range(5 * every):
            measure()
            t.on_epoch(float(rng.uniform(0.001, 0.01)))
        summary = None
    else:
        summary = t.tune(measure, steps=3, warmup=1)
    journal = [{k: v for k, v in e.items()} for e in t.journal]
    return {"summary": summary, "journal": journal, "knobs": t.knobs.to_dict(),
            "calls": fused.calls, "rollbacks": t.rollbacks, "applies": t.applies,
            "to_dict": t.to_dict(), "stats": t.stats()}


class _StillClock:
    """``time`` for the Tuner's measurement probe: its fault-seam penalty
    (the probe's own wall time, a few microseconds of noise) reads 0."""

    @staticmethod
    def perf_counter():
        return 0.0


@pytest.fixture
def still_clock(monkeypatch):
    monkeypatch.setattr(ref_tune, "time", _StillClock)
    monkeypatch.setattr(tune, "time", _StillClock)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("every", [0, 3])
def test_tuner_journal_and_knobs_equal_reference(still_clock, seed, every):
    ref = _tuner_run(ref_tune, ref_ingest, seed, every)
    port = _tuner_run(tune, ingest, seed, every)
    assert port == ref
    if every == 0:
        assert len(port["summary"]["steps"]) >= 2


def test_tuner_rolls_back_like_reference(still_clock):
    outs = []
    for pkg_tune, pkg_ingest in ((ref_tune, ref_ingest), (tune, ingest)):
        fused = _StubFused(pkg_ingest)
        t = pkg_tune.Tuner(fused=fused)
        values = iter([100.0, 90.0, 80.0])
        out = t.tune(lambda: next(values), steps=3, warmup=0)
        knobs = pkg_tune.KnobSet(mega_k={"A": 3}, inflight=4)
        t.apply(knobs)
        assert t.rollback("test")
        outs.append((out, t.journal, t.knobs.to_dict(), fused.calls))
    assert outs[0] == outs[1]
    assert outs[1][0]["rollbacks"] == 1


@pytest.mark.parametrize("knobs", [
    {}, {"mega_k": {"seg": 4}, "inflight": 3},
    {"buckets": {"a": [8, 64]}, "fuse": {"a": False}, "layout": {"b": "csr"},
     "kernel_variants": {"b": {"32": "forest.gemm"}}, "stitch": {"X": True},
     "window_seed_ms": 1.5, "replicas": 2, "pipe_depth": 2,
     "sharding": {"a": "data"}}])
def test_knobset_interchanges_with_reference(knobs):
    ref = ref_tune.KnobSet.from_dict(knobs)
    port = tune.KnobSet.from_dict(ref.to_dict())
    assert port.to_dict() == ref.to_dict() == knobs
    assert ref_tune.KnobSet.from_dict(port.to_dict()) == ref
    assert port.is_default() == ref.is_default()


def test_tuner_push_degrades_for_older_fused_models():
    calls = []

    class Old:
        def set_tuning(self, buckets=None, fuse=None, mega_k=None,
                       sharding=None):
            calls.append(("old", buckets, fuse, mega_k, sharding))

    tune.Tuner._push(Old(), tune.KnobSet(mega_k={"s": 2}))
    assert calls == [("old", {}, {}, {"s": 2}, {})]


def _attr_inputs(seed):
    rng = np.random.default_rng(seed)
    per_segment, costs = {}, {}
    for seg in SEGS:
        n = int(rng.integers(0, 9))
        per_segment[seg] = {"n_batches": n, "rows": int(rng.integers(1, 9999)),
                            "wall_s": float(rng.uniform(0, 2)),
                            **{k: float(rng.uniform(0, 1)) for k in
                               ("queue_s", "h2d_s", "compute_s", "dispatch_s",
                                "readback_s")}}
        costs[seg] = {f"x={b}x4:float32": {
            k: float(rng.uniform(1, 1e9)) for k in
            ("flops", "bytes_accessed", "peak_memory_bytes", "output_bytes",
             "compile_s") if rng.random() < 0.8} for b in (8, 16)}
    return per_segment, costs


def _render(metrics_mod, fams):
    """The exposition less its HELP lines (the port words the help of
    families whose source it changed: tallied costs, not XLA's)."""
    return [line for f in fams for line in
            metrics_mod.render_family(f).splitlines()
            if not line.startswith("# HELP")]


@pytest.mark.parametrize("seed", range(4))
def test_attribute_segments_and_families_equal_reference(seed):
    per_segment, costs = _attr_inputs(seed)
    ref_m, port_m = _fed_models(seed)
    layout = {"C": "csr"}
    ref = ref_perf.attribute_segments(per_segment, costs, peaks=dict(PEAKS),
                                      cost_model=ref_m, layout=layout)
    port = obs_perf.attribute_segments(per_segment, costs, peaks=dict(PEAKS),
                                       cost_model=port_m, layout=layout)
    assert port == ref
    fusion = {"segment_costs": costs, "roofline": ref}
    assert _render(obs_metrics, obs_perf.segment_families(fusion)) == \
        _render(ref_metrics, ref_perf.segment_families(fusion))


def test_tuner_families_equal_reference(still_clock):
    ref = _tuner_run(ref_tune, ref_ingest, 1)
    stats = ref["stats"]
    stats["variant_switches"] = 2
    stats["knobs"]["kernel_variants"] = {"A": {"32": "forest.gemm"}}
    assert _render(obs_metrics, obs_bridge._tuner_families(stats)) == \
        _render(ref_metrics, ref_bridge._tuner_families(stats))


def test_extract_cost_degrades_like_reference():
    class Exe:
        def __init__(self, ca, ma):
            self._ca, self._ma = ca, ma

        def cost_analysis(self):
            if isinstance(self._ca, Exception):
                raise self._ca
            return self._ca

        def memory_analysis(self):
            return self._ma

    mem = type("M", (), {"temp_size_in_bytes": 5, "argument_size_in_bytes": 7,
                         "output_size_in_bytes": 11})()
    for exe in (Exe({"flops": 3.0, "bytes accessed": 9.0}, mem),
                Exe([{"flops": float("nan")}], None), Exe(RuntimeError("x"), None),
                Exe(None, mem), object()):
        assert obs_perf.extract_cost(exe) == ref_perf.extract_cost(exe)
    rec = type("P", (), {"cost_record": {"flops": 4.0, "bytes_accessed": "x"}})()
    assert obs_perf.extract_cost(rec) == {"flops": 4.0}


@pytest.mark.parametrize("m,n,k", [(8, 16, 4), (3, 5, 7), (64, 1, 33)])
def test_cost_tally_counts_a_gemm_exactly(m, n, k):
    a, b = torch.randn(m, k), torch.randn(k, n)
    with obs_perf.cost_tally((a, b)) as rec:
        rec["_out"] = y = a @ b
    assert rec["flops"] == 2 * m * n * k
    assert rec["argument_bytes"] == 4 * (m * k + k * n)
    assert rec["output_bytes"] == y.numel() * 4
    assert rec["bytes_accessed"] == 4 * (m * k + k * n + m * n)
    assert "peak_memory_bytes" not in rec   # the CPU reports none
    obs_perf.note_kernel_cost(1.0, 1.0)      # outside a tally: no-op
    with obs_perf.cost_tally() as rec:
        obs_perf.note_kernel_cost(*gather_kernel.gather_cost(4, 10, 3))
        with obs_perf.paused_tally():
            _ = a @ b
    assert rec["flops"] == 0 and rec["bytes_accessed"] == 20 + 80 + 12 + 48


def test_compile_cache_records_the_tally_and_keeps_mega_out_of_buckets():
    cache = CompileCache()
    prog = cache.get(("k", 1), lambda: (lambda a, b: a @ b), label="seg",
                     shape="x=8x4:float32")
    prog(torch.ones(8, 4), torch.ones(4, 2))
    mega = cache.get(("k", 2), lambda: (lambda a, b: a @ b), label="seg",
                     shape="mega2;x=8x4:float32")
    mega(torch.ones(8, 4), torch.ones(4, 2))
    costs = cache.costs()["seg"]
    assert costs["x=8x4:float32"]["flops"] == 2 * 8 * 4 * 2
    assert {"compile_s", "first_call_ms", "bytes_accessed", "argument_bytes",
            "output_bytes"} <= set(costs["x=8x4:float32"])
    model = costmodel.SegmentCostModel(peaks=dict(PEAKS))
    model.ingest_costs(cache.costs())
    assert model.to_dict()["analytic"] == {
        "seg\x008": {k: float(v) for k, v in costs["x=8x4:float32"].items()
                     if k in ("flops", "bytes_accessed", "compile_s",
                              "output_bytes", "argument_bytes")}}
    assert cache.segment_cost("seg")["flops"] == 128.0


N_MEGA = 1100   # 4 full 256-row batches and a 76-row one


def _mega_frames(models, sparse):
    X = np.tile(models["X"], (N_MEGA // N_ROWS + 1, 1))[:N_MEGA]
    return (RefDataFrame.from_dict({"features": _rows(X, sparse)}),
            DataFrame.from_dict({"features": _rows(X, sparse)}))


@pytest.fixture(scope="module")
def mega_reference(models):
    """The reference's transform_submit of the dense frame at K=1. Its own
    K-step program, and its CSR-staged program at this frame's 1,100 rows,
    fail on the CPU ("Computation compiled for 12 inputs but called with 4",
    ROADMAP §C), so the port's K>1 outputs are held to the port's K=1 ones
    bit for bit, and both layouts to the reference's dense scores (the
    port's CSR scores equal its dense ones bit for bit, above)."""
    ref_df, _ = _mega_frames(models, False)
    ref = RefFused([models["ref"]["reg"]], cache=RefCompileCache())
    return _column(ref.transform_submit(ref_df)(), "prediction")


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("sparse", [False, True])
def test_mega_dispatch_equals_k1_and_reference(models, mega_reference, sparse, k):
    _, df = _mega_frames(models, sparse)
    model = models["port"]["reg"]
    with use_device("cpu"):
        base = _csr_fused(model) if sparse else _fused(model)
        want = _column(base.transform_submit(df)(), "prediction")
        fused = _csr_fused(model) if sparse else _fused(model)
        fused.transform(models["sparse_port" if sparse else "dense_port"])
        fused.set_tuning(mega_k={_label(fused): k})
        assert fused.mega_k_max == k
        got = _column(fused.transform_submit(df)(), "prediction")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, mega_reference, rtol=0,
                               atol=PORT_VS_REF_ATOL)
    st = fused.fusion_stats()
    assert st["fallbacks"] == [] and st["tuning"]["mega_k"] == {_label(fused): k}
    records = fused._seg_stats[_label(fused)].records
    # 5 batches: the full groups of K rode the mega program, the rest singly
    assert [t.mega_k for t in records] == [k] * (5 // k * k) + [1] * (5 % k)
    shapes = [s for per in fused.compile_cache.costs().values() for s in per]
    assert any(f"mega{k};" in s for s in shapes)
    assert any(s.startswith("variant=") or s.startswith("features=")
               for s in shapes)


def test_mega_partial_group_dispatches_singly(models):
    """Three batches at K=4: no group fills, every batch rides the K=1
    program and the mega program is never built."""
    X = np.tile(models["X"], (4, 1))[:600]
    df = DataFrame.from_dict({"features": _rows(X, False)})
    with use_device("cpu"):
        want = _column(_fused(models["port"]["reg"]).transform_submit(df)(),
                       "prediction")
        fused = _fused(models["port"]["reg"])
        fused.transform(models["dense_port"])
        fused.set_tuning(mega_k={_label(fused): 4})
        got = _column(fused.transform_submit(df)(), "prediction")
    np.testing.assert_array_equal(got, want)
    shapes = [s for per in fused.compile_cache.costs().values() for s in per]
    assert not any("mega" in s for s in shapes)
    assert [t.mega_k for t in fused._seg_stats[_label(fused)].records] == [1, 1, 1]


def test_mega_stages_in_sliding_groups_of_k():
    """At most K staged inputs are alive at once: groups of K stage,
    dispatch and drop — at each mega dispatch only K more items have been
    pulled from the staging iterator (the reference's test)."""
    ex = object.__new__(SegmentExecutor)
    pulled, dispatch_pulls = [0], []

    def staged_items():
        for _ in range(6):
            pulled[0] += 1
            yield ({"x": torch.zeros(4, 2)}, 4), ingest.BatchTiming(rows=4)

    def mega(group):
        dispatch_pulls.append(pulled[0])
        return [(torch.zeros(1),)] * len(group)

    ex._make_mega_step = lambda params, state, k: mega
    ex._readback_async = lambda handle: handle
    handles = []
    ex._dispatch_mega(staged_items(), None, {"ext": ["x"]}, None, 2, handles)
    assert dispatch_pulls == [2, 4, 6]
    assert len(handles) == 6 and all(t.mega_k == 2 for _h, t in handles)


def test_mega_groups_split_on_host_scalar_values():
    """Two CSR batches of one shape and another width never share a group
    (a captured graph bakes the width in)."""
    ex = object.__new__(SegmentExecutor)
    groups = []

    def items():
        for w in (8, 8, 9, 9):
            yield ({"c:indptr": torch.zeros(5, dtype=torch.int32),
                    "c:width": torch.tensor(w, dtype=torch.int32)}, 4), \
                ingest.BatchTiming(rows=4)

    def mega(group):
        groups.append({SegmentExecutor._group_sig(x, ["c:indptr", "c:width"])
                       for (x, _m), _t in group})
        return [(torch.zeros(1),)] * len(group)

    ex._make_mega_step = lambda params, state, k: mega
    ex._readback_async = lambda handle: handle
    handles = []
    ex._dispatch_mega(items(), None, {"ext": ["c:indptr", "c:width"]}, None, 2,
                      handles)
    assert len(groups) == 2 and all(len(g) == 1 for g in groups)
    assert groups[0] != groups[1] and len(handles) == 4


def test_mega_dnn_model_equals_k1_and_reference():
    ref, port = _encoders()
    rows = list(_tokens(10, seed=5))
    ref_stage = RefDNNModel(inputCol="tokens", outputCol="out", batchSize=3)
    stage = DNNModel(inputCol="tokens", outputCol="out", batchSize=3)
    ref_stage.set_model(ref)
    stage.set_model(port)
    ref_fused = RefFused([ref_stage], cache=RefCompileCache())
    ref_df = RefDataFrame.from_dict({"tokens": rows})
    df = DataFrame.from_dict({"tokens": rows})
    outs = {}
    with ref_module.matmul_precision("float32"):
        ref_fused.transform(ref_df)
        ref_fused.set_tuning(mega_k={"DNNModel": 3})
        want_ref = np.stack(_stack(ref_fused.transform_submit(ref_df)().column("out")))
    with matmul_precision("float32"), use_device("cpu"):
        for k in (1, 2, 3):
            fused = FusedPipelineModel([stage], cache=CompileCache())
            fused.transform(df)
            fused.set_tuning(mega_k={"DNNModel": k})
            outs[k] = np.stack(_stack(fused.transform_submit(df)().column("out")))
    for k in (2, 3):
        np.testing.assert_array_equal(outs[k], outs[1])
    np.testing.assert_allclose(outs[3], want_ref, rtol=0, atol=1e-5)


# -- slots, deposit and the batchers ------------------------------------------


def _spec(rows=4, width=3, dt=np.float32):
    return {"x": ((rows, width), dt)}


def test_slot_pool_acquire_release_and_caps():
    pool = ingest.SlotPool(acquire_timeout_s=0.01)
    st = ingest.IngestStats()
    a, b = pool.acquire(_spec(), stats=st), pool.acquire(_spec(), stats=st)
    assert a is not None and b is not None and a.arrays["x"] is not b.arrays["x"]
    assert a.tensors["x"].data_ptr() == a.arrays["x"].ctypes.data
    assert pool.acquire(_spec()) is None            # two buffers a bucket
    a.fill_begin()
    a.fill_end()
    a.transfer_begin()
    a.transfer_end()                                # records a cycle, frees
    assert st.slot_transfers == 1 and pool.acquire(_spec()) is not None
    a.release()                                     # idempotent
    assert pool.acquire({}) is None
    small = ingest.SlotPool(max_slot_bytes=32, acquire_timeout_s=0.01)
    assert small.acquire(_spec()) is None           # 48 bytes > the slot cap
    assert pool.stats()["buckets"] == 1 and pool.stats()["pinned"] is False


def test_slot_pool_evicts_free_buckets_lru_under_its_total_cap():
    pool = ingest.SlotPool(max_total_bytes=2 * 48 * 2, acquire_timeout_s=0.01)
    for w in (3, 3):
        pool.acquire(_spec(width=w)).release()
    pool.acquire({"y": ((4, 3), np.float32)}).release()
    pool.acquire({"z": ((4, 3), np.float32)}).release()   # evicts "x"
    st = pool.stats()
    assert st["buckets"] == 2 and st["evictions"] == 1
    held = pool.acquire({"y": ((4, 3), np.float32)})
    held2 = pool.acquire({"z": ((4, 3), np.float32)})
    # every bucket holds a lease: no room is made for a third
    assert pool.acquire({"w": ((4, 3), np.float32)}) is None
    held.release()
    held2.release()


def test_abandoned_lease_returns_through_its_finalizer():
    import gc

    pool = ingest.SlotPool(buffers_per_bucket=1, acquire_timeout_s=0.01)
    lease = pool.acquire(_spec())
    assert pool.acquire(_spec()) is None
    del lease
    gc.collect()
    assert pool.acquire(_spec()) is not None


def test_slot_pool_counters_equal_reference():
    outs = []
    for mod in (ref_ingest, ingest):
        pool = mod.SlotPool(max_total_bytes=4 * 96, acquire_timeout_s=0.01)
        got = []
        for w in (3, 3, 5, 3, 7, 5, 9):
            lease = pool.acquire(_spec(width=w))
            got.append(lease is not None)
            if lease is not None and w != 5:
                lease.release()
        outs.append((got, {k: v for k, v in pool.stats().items()
                           if k != "pinned"}))
    assert outs[0] == outs[1]


def test_device_prefetcher_close_releases_queued_leases():
    pool = ingest.SlotPool(buffers_per_bucket=2, acquire_timeout_s=0.01)

    def src():
        for _ in range(4):
            lease = pool.acquire(_spec())
            yield batching.Batch({"x": lease.arrays["x"]}, np.ones(4, bool), 4,
                                 staging=lease)

    pf = batching.DevicePrefetcher(src(), depth=2)
    it = iter(pf)
    first = next(it)
    first.staging.release()
    pf.close()
    # both buffers come back: the queued leases at close(), the one the
    # producer held when it saw the stop as it gives up
    a = pool.acquire(_spec(), timeout=10.0)
    b = pool.acquire(_spec(), timeout=10.0)
    assert a is not None and b is not None


@pytest.mark.parametrize("cls", ["DynamicBufferedBatcher", "TimeIntervalBatcher"])
def test_batchers_equal_reference(cls):
    outs = []
    for mod in (ref_batching, batching):
        kw = {"interval_s": 0.05, "max_batch_size": 3} \
            if cls == "TimeIntervalBatcher" else {"max_buffer": 4}
        b = getattr(mod, cls)(iter(range(10)), **kw)
        time.sleep(0.2)            # the producer buffers what it can
        outs.append([x for batch in b for x in batch])
    assert outs[0] == outs[1] == list(range(10))


@pytest.mark.parametrize("spanning", [True, False])
def test_rows_to_batch_out_and_views_equal_reference(spanning):
    block = np.arange(5 * 6, dtype=np.float32).reshape(5, 6)
    rows = list(block) if spanning else [r.copy() for r in block]
    outs = []
    for mod in (ref_ingest, ingest):
        st = mod.IngestStats()
        view = mod.rows_to_batch(rows, stats=st)
        slot = np.zeros((8, 6), np.float32)
        filled = mod.rows_to_batch(rows, out=slot, stats=st)
        one = mod.rows_to_batch(rows[:1], stats=st)
        outs.append((view.tolist(), filled.tolist(), one.tolist(),
                     np.shares_memory(view, block), st.zero_copy_batches,
                     st.copied_batches))
    assert outs[0] == outs[1]


def _deposit_run(fused_cls, cache_cls, frame_cls, model, rows, staging, submit):
    fused = fused_cls([model], cache=cache_cls(), slot_staging=staging)
    df = frame_cls.from_dict({"features": rows}, num_partitions=2)
    out = fused.transform_submit(df)() if submit else fused.transform(df)
    s = fused.last_ingest_stats.summary()
    counts = {k: s.get(k) for k in ("slot_deposits", "fallback_copies",
                                    "n_batches")}
    return _column(out, "prediction"), counts


@pytest.mark.parametrize("wire", ["json", "frame"])
def test_deposit_parity_across_wire_fused_and_async(models, wire):
    """Rows as a JSON client's lists parse to f64 (the copying path) and a
    frame's f32 rows deposit into slots; both, fused and submitted, score
    bitwise as the allocating path, with the reference's deposit/copy
    counts for the same rows."""
    X = np.tile(models["X"], (3, 1))[:520]
    dt = np.float64 if wire == "json" else np.float32
    rows = np.empty(len(X), dtype=object)
    for i, r in enumerate(X):
        rows[i] = binary.decode_frame(binary.encode_frame({"f": r.astype(dt)}))["f"] \
            if wire == "frame" else np.asarray(r.tolist(), dtype=dt)
    outs, counts = {}, {}
    for staging in (False, True):
        for submit in (False, True):
            with use_device("cpu"):
                outs[staging, submit], counts[staging, submit] = _deposit_run(
                    FusedPipelineModel, CompileCache, DataFrame,
                    models["port"]["reg"], rows, staging, submit)
            _, ref_counts = _deposit_run(RefFused, RefCompileCache, RefDataFrame,
                                         models["ref"]["reg"], rows, staging,
                                         submit)
            assert counts[staging, submit] == ref_counts
    first = outs[False, False]
    for key, out in outs.items():
        np.testing.assert_array_equal(out, first, err_msg=str(key))
    with use_device("cpu"):
        unfused = _column(models["port"]["reg"].transform(
            DataFrame.from_dict({"features": rows}, num_partitions=2)), "prediction")
    np.testing.assert_array_equal(first, unfused)
    # two 260-row partitions: a 256-row and a 4-row batch each
    assert counts[True, False]["slot_deposits"] == (4 if wire == "frame"
                                                    else None)


def test_deposit_under_slot_contention_takes_the_accounted_copy(models):
    X = np.tile(models["X"], (2, 1))[:300]
    rows = np.empty(len(X), dtype=object)
    for i, r in enumerate(X):
        rows[i] = r.astype(np.float32)
    with use_device("cpu"):
        ref = _column(_fused(models["port"]["reg"]).transform(
            DataFrame.from_dict({"features": rows})), "prediction")
        fused = _fused(models["port"]["reg"])
        pool = fused._get_slot_pool(torch.device("cpu"))
        pool._timeout = 0.01
        held = [pool.acquire({"features": ((256, N_FEATURES), np.float32)})
                for _ in range(2)]
        got = _column(fused.transform(DataFrame.from_dict({"features": rows})),
                      "prediction")
        for lease in held:
            lease.release()
    np.testing.assert_array_equal(got, ref)
    s = fused.last_ingest_stats.summary()
    assert s["fallback_copies"] >= 1 and "slot_pool" in fused.fusion_stats()


def test_compile_cache_eviction_releases_the_program():
    released = []

    class Program:
        def __init__(self, name):
            self.name = name

        def __call__(self, x):
            return x

        def release(self):
            released.append(self.name)

    cache = CompileCache(capacity=1)
    cache.get(("a",), lambda: Program("a"), label="seg", shape="x=1:float32")
    cache.get(("b",), lambda: Program("b"), label="seg", shape="x=2:float32")
    assert released == ["a"] and cache.stats()["evictions"] == 1
    assert list(cache.costs()["seg"]) == ["x=2:float32"]


def test_ingest_stats_slot_summary_equals_reference():
    outs = []
    for mod in (ref_ingest, ingest):
        st = mod.IngestStats()
        st.record(mod.BatchTiming(rows=3, padded_rows=8, dispatch_s=0.5,
                                  mega_k=4))
        st.note_deposit()
        st.note_copy()
        st.note_slot(0.25, 0.5, 0.125)
        other = mod.IngestStats()
        other.note_deposit()
        st.merge(other)
        outs.append({k: v for k, v in st.summary().items() if k != "wall_s"})
    assert outs[0] == outs[1]
    assert outs[1]["slot_deposits"] == 2 and outs[1]["slot_overlap_ratio"] == 0.25


# -- serving with the Tuner ----------------------------------------------------


def _serve_tuned(fused_or_stage, ref, autotune, mode, bodies, hdrs, every=1000):
    """Serve the classifier's probability; the Tuner (``every`` batches a
    refit) stays uncalibrated over a short load."""
    http_mode, async_exec = mode
    mod = ref_server if ref else srv_server
    kw = {} if ref else {"devices": ["cpu"]}
    srv = mod.serve_pipeline(fused_or_stage, "features", reply_col="probability",
                             fused=True, max_wait_ms=2.0, autotune=autotune,
                             tune_every=every, http_mode=http_mode,
                             async_exec=async_exec, **kw)
    with srv:
        got = [_post(srv.address, b, hdrs) for b in bodies]
        base = srv.address.rstrip("/")
        stats = _json.loads(_post(base + "/_mmlspark/stats", b"")[1])
        metrics = _post(base + "/_mmlspark/metrics", b"", method="GET")[1].decode()
    names = sorted({line.split()[2] for line in metrics.splitlines()
                    if line.startswith("# TYPE mmlspark_tuner_")})
    return got, stats, names


@pytest.mark.parametrize("http_mode,async_exec", MODES)
def test_autotune_serving_replies_equal_untuned(models, http_mode, async_exec):
    X = models["X"][:N_SERVED]
    bodies, hdrs = _gbdt_bodies(X, "frame")
    mode = (http_mode, async_exec)
    with use_device("cpu"):
        plain, _, none = _serve_tuned(PipelineModel([models["port"]["clf"]]).fuse(),
                                      False, False, mode, bodies, hdrs)
        tuned_fused = FusedPipelineModel([models["port"]["clf"]], cache=CompileCache())
        tuned, stats, names = _serve_tuned(tuned_fused, False, True, mode, bodies,
                                           hdrs)
    assert [g[:2] for g in tuned] == [g[:2] for g in plain]
    assert all(g[0] == 200 for g in tuned) and none == []
    t = stats["tuner"]
    assert t["every"] == 1000 and t["epochs"] >= 1 and t["applies"] == 0
    assert t["knobs"] == t["default_knobs"] == {} and "model" in t
    assert "mmlspark_tuner_epochs_total" in names
    assert tuned_fused.cost_model is not None


def test_autotune_calibrated_stitch_replies(models):
    """A Tuner calibrated over the load (a refit every 5 batches). With a
    cost model that declines every stitch, every reply equals the un-tuned
    server's byte for byte. With the cost model as it comes, the planner
    stitches the classifier's finalize once calibrated, and every reply
    equals the un-tuned server's or, exactly, the probabilities of a fused
    model pinned stitched (``stitch=``) on the same rows."""
    from mmlspark_tpu_torch.core.costmodel import SegmentCostModel

    class Unstitched(SegmentCostModel):
        def stitch_decision(self, *args, **kwargs):
            return False

    label = "LightGBMClassificationModel"
    X = models["X"][:100].astype(np.float64)
    bodies, hdrs = _gbdt_bodies(X, "frame")
    mode = ("thread", False)
    with use_device("cpu"):
        pinned = _fused(models["port"]["clf"])
        pinned.set_tuning(stitch={label: True})
        want = [np.asarray(p, np.float64) for p in pinned.transform(
            DataFrame.from_dict({"features": list(X)})).column("probability")]
        assert pinned.fusion_stats()["stitched"] == {label: [label]}
        plain, _, _ = _serve_tuned(_fused(models["port"]["clf"]), False, False,
                                   mode, bodies, hdrs)
        unstitched = _fused(models["port"]["clf"])
        unstitched.set_tuning(cost_model=Unstitched())
        declined, stats, _ = _serve_tuned(unstitched, False, True, mode, bodies,
                                          hdrs, every=5)
        tuned = _fused(models["port"]["clf"])
        stitched, _, _ = _serve_tuned(tuned, False, True, mode, bodies, hdrs,
                                      every=5)
    assert stats["tuner"]["calibrated"] and "stitched" not in \
        unstitched.fusion_stats()
    assert [g[:2] for g in declined] == [g[:2] for g in plain]
    assert tuned.fusion_stats()["stitched"] == {label: [label]}
    n_stitched = 0
    for i, (a, b) in enumerate(zip(plain, stitched)):
        assert b[0] == 200
        if a[:2] != b[:2]:
            got = np.asarray(_json.loads(b[1]), np.float64)
            assert np.array_equal(got, want[i])
            n_stitched += 1
    assert n_stitched > len(X) // 2


def test_autotune_metric_family_names_equal_reference(models):
    """The served ``mmlspark_tuner_*`` families are the ones the reference's
    bridge renders from the same tuner state, and the ``tuner`` stats
    section has the reference's keys."""
    X = models["X"][:8]
    bodies, hdrs = _gbdt_bodies(X, "json")
    with use_device("cpu"):
        _, stats, names = _serve_tuned(PipelineModel([models["port"]["clf"]]),
                                       False, True, ("thread", False), bodies, hdrs,
                                       every=2)
    ref_names = sorted({f.name for f in ref_bridge._tuner_families(stats["tuner"])
                        if f.name.startswith("mmlspark_tuner_")})
    assert names == ref_names and "mmlspark_tuner_epochs_total" in names
    ref_keys = ref_tune.Tuner(fused=_StubFused(ref_ingest)).stats()
    assert sorted(stats["tuner"]) == sorted(ref_keys)


def test_executor_set_inflight_grows_and_shrinks():
    class _Srv:
        _stop = threading.Event()
        name = "t"

    ex = srv_executor.PipelinedExecutor(_Srv(), srv_executor.ReplicaSet.__new__(
        srv_executor.ReplicaSet), inflight=2)
    ex.set_inflight(4)
    assert ex.inflight == 4 and ex._slots._value == 4
    ex.set_inflight(1)
    assert ex.inflight == 1 and ex._shrink == 3
    for _ in range(3):
        ex._release_slot()          # consumed, not returned
    assert ex._shrink == 0 and ex._slots._value == 4
    ex._release_slot()
    assert ex._slots._value == 5


def test_watchdog_hint_reads_the_fused_models_k(models):
    fused = FusedPipelineModel([models["port"]["clf"]], cache=CompileCache())
    srv = srv_server.serve_pipeline(fused, "features", reply_col="prediction",
                                    devices=["cpu"])
    assert srv.transform.mega_k() == 1
    fused.set_tuning(mega_k={"LightGBMClassificationModel": 3})
    assert srv.transform.mega_k() == 3


# ---------------------------------------------------------------------------
# the image path: Conv2D, BatchNorm and pooling, ResNet and its torchvision
# import, the image ops and stages, ImageFeaturizer; the switch MoE
# ---------------------------------------------------------------------------

from mmlspark_tpu.core.dataframe import DataFrame as _RefDF  # noqa: E402
from mmlspark_tpu.core.schema import ImageSchema as RefImageSchema  # noqa: E402
from mmlspark_tpu.image import featurizer as ref_featurizer  # noqa: E402
from mmlspark_tpu.image import stages as ref_image_stages  # noqa: E402
from mmlspark_tpu.models import moe as ref_moe  # noqa: E402
from mmlspark_tpu.models import torch_import as ref_torch_import  # noqa: E402
from mmlspark_tpu.ops import image as ref_imops  # noqa: E402
from mmlspark_tpu_torch import native_loader  # noqa: E402
from mmlspark_tpu_torch.core.schema import ImageSchema  # noqa: E402
from mmlspark_tpu_torch.image import (ImageFeaturizer, ImageSetAugmenter,  # noqa: E402
                                      ImageTransformer, ResizeImageTransformer,
                                      UnrollBinaryImage, UnrollImage)
from mmlspark_tpu_torch.models import torch_import as port_torch_import  # noqa: E402
from mmlspark_tpu_torch.ops import image as port_imops  # noqa: E402

ref_resnet = importlib.import_module("mmlspark_tpu.models.resnet")

# A bf16 result against the reference's: one bf16 ulp of the value (both
# round the same f32 sums; a sum in another order can land on the other
# side of a rounding boundary). Measured: bitwise on every case here.
BF16_ULP = 2.0 ** -8
# ResNet logits/taps in f32: the reference's own bound for its forward
# (tests/test_models.py, DNNModel against apply), scaled by the output's
# max |value| where that passes 1 (random BatchNorm statistics grow the
# logits to ~2e3; measured 8.9e-7 relative: f32 sums in another order)
RESNET_F32_TOL = 1e-4
# ResNet in bf16 against the reference, relative to each output's max
# |value|: the activations are rounded to bf16 after every conv and
# BatchNorm on both sides, and an f32 sum in another order can flip one
# rounding, which later layers carry: DEEP_BF16_TOL's room for one flip.
# Measured: every bf16 tap bit for bit, the f32 logits 1.1e-7
RESNET_BF16_TOL = 2e-2
# jax.image.resize ("linear", antialiased when it shrinks) against
# F.interpolate(bilinear, antialias=True): the same filter weights, computed
# in another order in float32 (measured max 2.4e-7 on N(0, 1) values;
# "nearest" bit for bit)
RESIZE_BATCH_TOL = 2e-6
# BatchNorm's batch statistics: f32 sums of the same values in another
# order (measured 3.8e-6 absolute on a variance of ~9: 4e-7 relative)
BN_STATS_RTOL = 1e-6
# MoE and its gradients against jax.grad: f32 sums of the expert products
# in another order (f32), and with the bf16 operands rounded alike (bf16)
MOE_TOL = 1e-5


def _scale(w):
    """The tolerances' unit: an output's max |value|, at least 1."""
    return max(1.0, float(np.abs(w).max()))


def _to_np(t):
    """numpy f32 of a torch tensor or a JAX array (bf16 included)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _bn_stats(tree, rng):
    """Non-trivial moving statistics in every BatchNorm dict of a params
    tree (the reference inits them to 0 and 1)."""
    for v in tree.values():
        if isinstance(v, dict):
            if {"mean", "var"} <= set(v):
                v["mean"] = (0.2 * rng.standard_normal(v["mean"].shape)
                             ).astype(np.float32)
                v["var"] = rng.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)
            else:
                _bn_stats(v, rng)
    return tree


def _forward_pair(ref_mod, params, port_mod, x, f32, **kw):
    """(reference, port) outputs as numpy f32, after checking both have the
    same dtype; ``kw`` goes to both forwards."""
    prec = "float32" if f32 else "bfloat16"
    with ref_module.matmul_precision(prec):
        ref = ref_mod.apply(params, jnp.asarray(x), **kw)
    with matmul_precision(prec), torch.inference_mode():
        got = port_mod(torch.from_numpy(x), **kw)
    assert _dtype_name(got) == str(ref.dtype)
    assert tuple(got.shape) == tuple(ref.shape)
    return _to_np(ref), _to_np(got)


def _assert_bf16_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=BF16_ULP, atol=1e-30)


CONV_CASES = [((3, 3), (1, 1), "SAME", 9), ((3, 3), (1, 1), "SAME", 8),
              ((3, 3), (2, 2), "SAME", 10), ((3, 3), (2, 2), "SAME", 9),
              ((7, 7), (2, 2), "SAME", 16), ((1, 1), (2, 2), "SAME", 8),
              ((3, 3), (1, 1), "VALID", 9), ((3, 3), (2, 2), ((1, 1), (1, 1)), 10),
              ((3, 3), (1, 1), ((0, 2), (1, 0)), 7)]


@pytest.mark.parametrize("kernel,strides,padding,size", CONV_CASES)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("f32", [True, False])
def test_conv2d_matches_reference(kernel, strides, padding, size, bias, f32):
    """SAME at strides 1 and 2 on odd and even sizes (XLA's low/high split),
    VALID, explicit pairs (symmetric and not), with and without bias: f32
    within F32_TOL, bf16 (the reference's output dtype) within a bf16 ulp."""
    ref_mod = ref_module.Conv2D(6, kernel, strides, padding, use_bias=bias)
    port = port_module.Conv2D(6, kernel, strides, padding, use_bias=bias)
    params, port = _pair(ref_mod, port, (size, size, 4))
    ref_shape = ref_mod.init(jax.random.key(0), (size, size, 4))[1]
    assert port.init(torch.Generator(), (size, size, 4)) == ref_shape
    load_jax_params(FunctionModel(port, (size, size, 4)), params)
    ref, got = _forward_pair(ref_mod, params, port, _x((2, size, size, 4)), f32)
    if f32:
        np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=0)
    else:
        _assert_bf16_close(got, ref)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("f32", [True, False])
def test_batchnorm_matches_reference(train, f32):
    """Inference (the moving statistics; inv and shift rounded to x's dtype
    before x * inv + shift) and train (the batch's f32 statistics, written
    to stats_out under the layer path)."""
    params, port = _pair(ref_module.BatchNorm(), port_module.BatchNorm(), (5, 5, 8))
    rng = np.random.default_rng(7)
    params = _bn_stats({"bn": params}, rng)["bn"]
    load_jax_params(FunctionModel(port, (5, 5, 8)), params)
    x = (3.0 * _x((4, 5, 5, 8)) + 1.0).astype(np.float32)
    xin = x if f32 else np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    ref_st, st = {}, {}
    ref = ref_module.BatchNorm().apply(params, jnp.asarray(xin), train=train,
                                       stats_out=ref_st, _path="a/bn")
    with torch.inference_mode():
        tx = torch.from_numpy(x) if f32 else torch.from_numpy(x).to(torch.bfloat16)
        got = port(tx, train=train, stats_out=st, _path="a/bn")
    assert _dtype_name(got) == str(ref.dtype)
    if f32:
        np.testing.assert_allclose(_to_np(got), _to_np(ref), atol=F32_TOL, rtol=0)
    else:
        _assert_bf16_close(_to_np(got), _to_np(ref))
    assert set(st) == set(ref_st) == ({"a/bn"} if train else set())
    for (m, v), (rm, rv) in zip(st.values(), ref_st.values()):
        np.testing.assert_allclose(m.numpy(), np.asarray(rm), rtol=BN_STATS_RTOL,
                                   atol=BN_STATS_RTOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=BN_STATS_RTOL,
                                   atol=BN_STATS_RTOL)


@pytest.mark.parametrize("padding", ["SAME", "VALID", ((1, 1), (1, 1)),
                                     ((0, 2), (2, 0))])
@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("f32", [True, False])
def test_pooling_matches_reference(padding, size, f32):
    """MaxPool pads with -inf (all inputs negative: a zero pad would win),
    bit for bit; GlobalAvgPool's f32 mean within F32_TOL."""
    x = -np.abs(_x((2, size, size, 3))) - 1.0
    if not f32:
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    dt = jnp.float32 if f32 else jnp.bfloat16
    tdt = torch.float32 if f32 else torch.bfloat16
    ref_mod = ref_module.MaxPool((3, 3), (2, 2), padding)
    port = port_module.MaxPool((3, 3), (2, 2), padding)
    assert port.init(None, (size, size, 3)) == ref_mod.init(None, (size, size, 3))[1]
    ref = ref_mod.apply({}, jnp.asarray(x).astype(dt))
    got = port(torch.from_numpy(x).to(tdt))
    assert _dtype_name(got) == str(ref.dtype)
    np.testing.assert_array_equal(_to_np(got), _to_np(ref))
    ref = ref_module.GlobalAvgPool().apply({}, jnp.asarray(x).astype(dt))
    got = port_module.GlobalAvgPool()(torch.from_numpy(x).to(tdt))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL, rtol=0)


def _resnet_pair(depth, size, width=8, classes=10):
    """(reference FunctionModel, port FunctionModel) with the same weights:
    the reference's init, BatchNorm scale/bias/statistics made
    non-trivial."""
    ref = ref_resnet.resnet(depth, num_classes=classes, image_size=size,
                            width=width)
    rng = np.random.default_rng(depth)
    params = _bn_stats(_np_params(jax.tree.map(np.asarray, ref.params), rng), rng)
    ref.params = jax.tree.map(jnp.asarray, params)
    port = port_resnet.resnet(depth, num_classes=classes, image_size=size,
                              width=width, seed=1)
    load_jax_params(port, params)
    return ref, port


RESNET_TAPS = [None, "avgpool", "layer3", "stem/pool", "layer1/0/body/relu1"]


@pytest.mark.parametrize("depth,size", [(18, 32), (50, 64)])
@pytest.mark.parametrize("f32", [True, False])
def test_resnet_matches_reference_with_taps(depth, size, f32):
    """ResNet-18 (width 8, 32x32) and ResNet-50 (width 8, 64x64) carried
    over by load_jax_params: the logits, the pooled features, layer3 and
    inner taps in one forward."""
    ref, port = _resnet_pair(depth, size)
    assert port.module.layer_paths() == ref.module.layer_paths()
    assert port.layer_names == ref.layer_names
    x = _x((2, size, size, 3))
    prec = "float32" if f32 else "bfloat16"
    with ref_module.matmul_precision(prec):
        want = ref.apply_taps(jnp.asarray(x), RESNET_TAPS)
    with matmul_precision(prec):
        got = port.apply_taps(torch.from_numpy(x), RESNET_TAPS)
    for t in RESNET_TAPS:
        assert _dtype_name(got[t]) == str(want[t].dtype), t
        w, g = _to_np(want[t]), _to_np(got[t])
        assert g.shape == w.shape and np.isfinite(g).all(), t
        tol = (RESNET_F32_TOL if f32 else RESNET_BF16_TOL) * _scale(w)
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=str(t))
    assert got[None].shape == (2, 10)
    assert got["avgpool"].shape == (2, 8 * 8 * (4 if depth == 50 else 1))


def _torchvision_state_dict(depth, num_classes, seed, width=64):
    """A torchvision-layout resnet``depth`` state_dict from seeded tensors:
    its key names and shapes (OIHW convs, running statistics, the
    ``num_batches_tracked`` counters), BatchNorm not trivial."""
    gen = torch.Generator().manual_seed(seed)
    kind, blocks = port_resnet._CONFIGS[depth]
    sd = {}

    def conv(key, cout, cin, k):
        sd[key + ".weight"] = torch.randn(cout, cin, k, k, generator=gen) \
            * (2.0 / (cin * k * k)) ** 0.5

    def bn(key, c):
        sd[key + ".weight"] = 1.0 + 0.1 * torch.randn(c, generator=gen)
        sd[key + ".bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[key + ".running_mean"] = 0.2 * torch.randn(c, generator=gen)
        sd[key + ".running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[key + ".num_batches_tracked"] = torch.tensor(0)

    conv("conv1", width, 3, 7)
    bn("bn1", width)
    in_ch = width
    for i, n in enumerate(blocks):
        ch = width * 2 ** i
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            tk = f"layer{i + 1}.{j}"
            if kind == "bottleneck":
                out = ch * 4
                for c, (co, ci, k) in enumerate([(ch, in_ch, 1), (ch, ch, 3),
                                                 (out, ch, 1)], 1):
                    conv(f"{tk}.conv{c}", co, ci, k)
                    bn(f"{tk}.bn{c}", co)
            else:
                out = ch
                for c, ci in enumerate([in_ch, ch], 1):
                    conv(f"{tk}.conv{c}", ch, ci, 3)
                    bn(f"{tk}.bn{c}", ch)
            if stride != 1 or in_ch != out:
                conv(f"{tk}.downsample.0", out, in_ch, 1)
                bn(f"{tk}.downsample.1", out)
            in_ch = out
    sd["fc.weight"] = torch.randn(num_classes, in_ch, generator=gen) * in_ch ** -0.5
    sd["fc.bias"] = 0.1 * torch.randn(num_classes, generator=gen)
    return sd


@pytest.mark.parametrize("depth", [18, 50])
def test_from_torch_resnet_matches_reference(depth, tmp_path):
    """The same seeded torchvision-layout state_dict through both importers
    (a mapping and a .pth path): the same params bit for bit; ResNet-18's
    forward at 32x32 within RESNET_F32_TOL in f32 and RESNET_BF16_TOL in
    bf16; a mismatch raises in both."""
    sd = _torchvision_state_dict(depth, 7, seed=depth)
    ref = ref_torch_import.from_torch_resnet(sd, depth=depth, image_size=32)
    torch.save(sd, tmp_path / "r.pth")
    port = port_torch_import.from_torch_resnet(str(tmp_path / "r.pth"),
                                               depth=depth, image_size=32)
    assert port.layer_names == ref.layer_names and port.name == ref.name
    want = dict(_leaves(jax.tree.map(np.asarray, ref.params)))
    got = dict(_leaves(port.params))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].detach().numpy(), v, err_msg=k)
    if depth == 18:
        x = _x((2, 32, 32, 3))
        for prec in ("float32", "bfloat16"):
            with ref_module.matmul_precision(prec):
                w = np.asarray(ref.apply(jnp.asarray(x)))
            with matmul_precision(prec):
                g = port.apply(torch.from_numpy(x)).numpy()
            tol = (RESNET_F32_TOL if prec == "float32" else RESNET_BF16_TOL) \
                * _scale(w)
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=prec)
    other = 50 if depth == 18 else 18
    with pytest.raises((ValueError, KeyError)):
        ref_torch_import.from_torch_resnet(sd, depth=other)
    with pytest.raises(ValueError):
        port_torch_import.from_torch_resnet(sd, depth=other)
    bad = dict(sd)
    bad["fc.bias"] = torch.zeros(8)
    with pytest.raises(ValueError, match="fc"):
        port_torch_import.from_torch_resnet(bad, depth=depth)


# ---- image ops


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("src,dst", [((9, 7), (16, 12)), ((20, 14), (8, 8)),
                                     ((256, 256), (224, 224)), ((5, 5), (5, 9))])
@pytest.mark.parametrize("native", [True, False])
def test_resize_matches_reference_bitwise(dtype, src, dst, native, monkeypatch):
    """The host resize: the native bilinear kernel (the port's copy of the
    reference's C source) and the numpy path, each bit for bit the
    reference's; "nearest" too."""
    img = _u8(src + (3,)) if dtype == np.uint8 else _x(src + (3,))
    if not native:
        monkeypatch.setattr(native_loader, "resize_bilinear", lambda *a: None)
        want = ref_imops._resize_numpy(img, *dst)
    else:
        assert native_loader.available()
        want = ref_imops.resize(img, *dst)
    native_loader.uses.clear()
    got = port_imops.resize(img, *dst)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    assert native_loader.uses[("resize_bilinear",
                               "native" if native else "numpy")] == 1
    np.testing.assert_array_equal(port_imops.resize(img, *dst, method="nearest"),
                                  ref_imops.resize(img, *dst, method="nearest"))


@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("dst", [(16, 12), (4, 3), (7, 5)])
def test_resize_batch_within_tolerance_of_reference(method, dst):
    """The batched device resize against jax.image.resize, up and down
    (antialiased down), within RESIZE_BATCH_TOL."""
    x = _x((2, 8, 6, 3))
    want = np.asarray(ref_imops.resize_batch(jnp.asarray(x), *dst, method=method))
    got = port_imops.resize_batch(torch.from_numpy(x), *dst, method=method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_BATCH_TOL, rtol=0)


def _op_cases():
    return [("crop", dict(cx=1, cy=2, height=4, width=3)),
            ("flip", dict(flip_code=0)), ("flip", dict(flip_code=1)),
            ("flip", dict(flip_code=-1)),
            ("threshold", dict(thresh=100.0, max_val=255.0, kind="binary")),
            ("threshold", dict(thresh=0.5, max_val=7.0, kind="binary_inv")),
            ("threshold", dict(thresh=100.0, max_val=255.0, kind="trunc")),
            ("threshold", dict(thresh=100.0, max_val=255.0, kind="tozero")),
            ("threshold", dict(thresh=100.0, max_val=255.0, kind="tozero_inv")),
            ("color_format", dict(code="gray")),
            ("color_format", dict(code="bgr2rgb"))]


@pytest.mark.parametrize("op,kw", _op_cases())
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_batched_mirrors_bitwise_equal_host_ops(op, kw, dtype):
    """Each batched device mirror, on a [B, H, W, C] tensor, bit for bit the
    host op on every image of the batch (and the reference's host op)."""
    batch = _u8((3, 9, 7, 3)) if dtype == np.uint8 \
        else (_x((3, 9, 7, 3)) * 100.0).astype(np.float32)
    host_kw = dict(kw)
    if op == "crop":
        host_kw = dict(x=kw["cx"], y=kw["cy"], height=kw["height"], width=kw["width"])
    got = getattr(port_imops, op + "_batch")(torch.from_numpy(batch), **kw).numpy()
    for i in range(len(batch)):
        want = getattr(port_imops, op)(batch[i], *host_kw.values())
        ref = getattr(ref_imops, op)(batch[i], *host_kw.values())
        if kw.get("code") == "gray":    # see test_gray_host_op_and_mirror...
            np.testing.assert_allclose(want, ref, rtol=2.0 ** -23, atol=1)
        else:
            np.testing.assert_array_equal(want, ref)
        if op == "threshold":       # the host op promotes to f64 exactly
            want = want.astype(np.float32)
        assert got[i].dtype == want.dtype
        np.testing.assert_array_equal(got[i], want)


def test_gray_host_op_and_mirror_agree_on_every_uint8_pixel():
    """All 2^24 RGB uint8 pixels: the gray mirror bit for bit the host op
    (both the spelled-out f32 sum); the reference's host op sums through
    the BLAS's matvec, which rounds to the other gray level on 1,151 of
    them (measured here; 0.007%), never by more than one level."""
    a = np.arange(256, dtype=np.uint8)
    px = np.stack(np.meshgrid(a, a, a, indexing="ij"), -1).reshape(1, -1, 1, 3)
    host = port_imops.color_format(px[0], "gray")
    dev = port_imops.color_format_batch(torch.from_numpy(px), "gray")[0].numpy()
    np.testing.assert_array_equal(dev, host)
    ref = ref_imops.color_format(px[0], "gray")
    diff = np.abs(host.astype(np.int16) - ref)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-4


def test_fix_channels_and_unroll_batch_mirror_host():
    gray = _u8((2, 4, 5, 1))
    got = port_imops.fix_channels_batch(torch.from_numpy(gray), 3).numpy()
    np.testing.assert_array_equal(got, np.repeat(gray, 3, axis=3))
    want = np.asarray(ref_imops.fix_channels_batch(jnp.asarray(gray), 3))
    np.testing.assert_array_equal(got, want)
    rgba = _u8((2, 4, 5, 4))
    np.testing.assert_array_equal(
        port_imops.fix_channels_batch(torch.from_numpy(rgba), 3).numpy(),
        rgba[..., :3])
    np.testing.assert_array_equal(
        port_imops.fix_channels_batch(torch.from_numpy(rgba[..., 0]), 1).numpy(),
        rgba[..., :1])
    flat = port_imops.unroll_batch_chw(torch.from_numpy(rgba)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(flat[i].astype(np.float64),
                                      port_imops.unroll_chw(rgba[i]))
        np.testing.assert_array_equal(port_imops.unroll_chw(rgba[i]),
                                      ref_imops.unroll_chw(rgba[i]))
    np.testing.assert_array_equal(
        flat, np.asarray(ref_imops.unroll_batch_chw(jnp.asarray(rgba))))


def test_native_unroll_chw_and_decoders_match_reference():
    img = _u8((6, 5, 3), seed=4)
    np.testing.assert_array_equal(native_loader.unroll_chw(img),
                                  port_imops.unroll_chw(img))
    np.testing.assert_allclose(native_loader.unroll_chw(img, normalize=True),
                               port_imops.unroll_chw(img, normalize=True),
                               rtol=2.0 ** -52, atol=0)
    assert native_loader.unroll_chw(img.astype(np.float32)) is None
    ppm = port_imops.encode_ppm(img)
    assert ppm == ref_imops.encode_ppm(img)
    np.testing.assert_array_equal(port_imops._decode_builtin(ppm), img)
    np.testing.assert_array_equal(port_imops.decode_image(ppm), img)
    bmp = _bmp_bytes(img)
    np.testing.assert_array_equal(port_imops._decode_builtin(bmp), img)
    np.testing.assert_array_equal(port_imops.decode_image(bmp),
                                  ref_imops.decode_image(bmp))
    gray = port_imops.decode_image(b"P5\n3 2\n255\n" + bytes(range(6)))
    assert gray.shape == (2, 3, 3)
    assert port_imops.decode_image(b"not an image") is None
    assert ref_imops.decode_image(b"not an image") is None


def _bmp_bytes(img):
    """A 24-bit BMP of an HWC uint8 image (bottom-up rows, BGR, rows padded
    to 4 bytes), as tools/bench_image_e2e.py writes them."""
    import struct

    h, w, _ = img.shape
    pad = (4 - (w * 3) % 4) % 4
    size = (w * 3 + pad) * h
    head = b"BM" + struct.pack("<IHHI", 54 + size, 0, 0, 54) + struct.pack(
        "<IiiHHIIiiII", 40, w, h, 1, 24, 0, size, 2835, 2835, 0, 0)
    return head + b"".join(row.tobytes() + b"\0" * pad
                           for row in img[::-1, :, ::-1])


# ---- image stages


def _image_rows(n=6, h=10, w=8, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for _ in range(n)]
    return arrays


def _image_dfs(arrays, num_partitions=2, nulls=()):
    """(reference DataFrame, port DataFrame) of the same image structs."""
    def col(schema):
        out = np.empty(len(arrays), dtype=object)
        for i, a in enumerate(arrays):
            out[i] = None if i in nulls else schema.make(a, origin=f"img{i}")
        return out
    ref = _RefDF.from_dict({"image": col(RefImageSchema), "label": list(range(len(arrays)))},
                           num_partitions=num_partitions)
    port = DataFrame.from_dict({"image": col(ImageSchema),
                                "label": list(range(len(arrays)))},
                               num_partitions=num_partitions)
    return ref, port


def _struct_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert {k: g[k] for k in g if k != "data"} == {k: w[k] for k in w if k != "data"}
        assert g["data"].dtype == w["data"].dtype
        np.testing.assert_array_equal(g["data"], w["data"])


def _chains():
    return [lambda t: t.resize(6, 6).flip(1).color_format("gray"),
            lambda t: t.crop(1, 2, 5, 4).flip(-1).threshold(100.0),
            lambda t: t.blur(3, 3).gaussian_kernel(3, 1.0).flip(0),
            lambda t: t.color_format("bgr2rgb").threshold(0.5, 7.0, "tozero")]


@pytest.mark.parametrize("chain", range(4))
def test_image_transformer_matches_reference_and_fuses_bitwise(chain):
    """ImageTransformer chains through the port and the reference (the
    same host ops), then fused: the device-exact suffix on the batch, the
    host prefix (resize, blurs) in prepare, dtype widened in finalize —
    bit for bit the unfused output."""
    ref_df, df = _image_dfs(_image_rows(), nulls=(3,))
    build = _chains()[chain]
    ref_t = build(ref_image_stages.ImageTransformer(inputCol="image", outputCol="out"))
    t = build(ImageTransformer(inputCol="image", outputCol="out"))
    want = ref_t.transform(ref_df).column("out")
    with use_device("cpu"):
        got = t.transform(df).column("out")
        _struct_equal(got, want)
        fused = PipelineModel([t]).fuse()
        fo = fused.transform(df.dropna(subset=["image"])).column("out")
    _struct_equal(fo, [w for w in want if w is not None])


def test_resize_unroll_and_augment_match_reference():
    arrays = _image_rows(n=4, h=9, w=7)
    ref_df, df = _image_dfs(arrays)
    for nch in (None, 1, 3):
        kw = dict(inputCol="image", outputCol="r", height=5, width=6)
        if nch is not None:
            kw["nChannels"] = nch
        want = ref_image_stages.ResizeImageTransformer(**kw).transform(ref_df).column("r")
        got = ResizeImageTransformer(**kw).transform(df).column("r")
        _struct_equal(got, want)
    want = ref_image_stages.UnrollImage().transform(ref_df).column("unrolled")
    got = UnrollImage().transform(df).column("unrolled")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    blobs = [ref_imops.encode_ppm(a) for a in arrays] + [b"junk"]
    kw = dict(inputCol="value", outputCol="u", height=4, width=4)
    want = ref_image_stages.UnrollBinaryImage(**kw).transform(
        _RefDF.from_dict({"value": blobs})).column("u")
    got = UnrollBinaryImage(**kw).transform(DataFrame.from_dict({"value": blobs})).column("u")
    assert got[-1] is None and want[-1] is None
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g, w)
    kw = dict(inputCol="image", outputCol="image", flipUpDown=True)
    want = ref_image_stages.ImageSetAugmenter(**kw).transform(ref_df)
    got = ImageSetAugmenter(**kw).transform(df)
    assert got.count() == want.count() == 12
    _struct_equal(got.column("image"), want.column("image"))


# ---- ImageFeaturizer


def _featurizer_pair(**kw):
    ref_m, port_m = _resnet_pair(18, 16)
    ref = ref_featurizer.ImageFeaturizer(inputCol="image", outputCol="f", batchSize=4,
                                         **kw).set_model(ref_m)
    port = ImageFeaturizer(inputCol="image", outputCol="f", batchSize=4,
                           **kw).set_model(port_m)
    return ref, port


def _feature_rows(col):
    return [None if r is None else np.asarray(r) for r in col]


@pytest.mark.parametrize("cut", [1, 0, 3])
@pytest.mark.parametrize("f32", [True, False])
def test_image_featurizer_matches_reference(cut, f32):
    """ImageFeaturizer end to end on 20x14 images resized to the
    backbone's 16x16 (ResNet-18, width 8): the pooled features (cut 1),
    the logits (cut 0) and layer3 (cut 3), f32 within RESNET_F32_TOL and
    bf16 within RESNET_BF16_TOL of the reference's; null rows dropped."""
    ref, port = _featurizer_pair(cutOutputLayers=cut, scaleFactor=1 / 255)
    ref_df, df = _image_dfs(_image_rows(n=5, h=20, w=14), nulls=(2,))
    prec = "float32" if f32 else "bfloat16"
    with ref_module.matmul_precision(prec):
        want = np.stack(_feature_rows(ref.transform(ref_df).column("f")))
    with matmul_precision(prec), use_device("cpu"):
        got = np.stack(_feature_rows(port.transform(df).column("f")))
    assert got.shape == want.shape and got.shape[0] == 4
    assert got.shape[1:] == {1: (64,), 0: (10,), 3: (1, 1, 32)}[cut]
    tol = (RESNET_F32_TOL if f32 else RESNET_BF16_TOL) * _scale(want)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_image_featurizer_bytes_keep_na_and_host_preprocess():
    """From encoded bytes (PPM and BMP), keep-NA (dropNa=False: null and
    undecodable rows come back None), and hostPreprocess=True (the float32
    wire) bit for bit the uint8 wire with the cast on the device."""
    ref, port = _featurizer_pair(dropNa=False)
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (9, 9, 3), dtype=np.uint8) for _ in range(3)]
    blobs = [port_imops.encode_ppm(imgs[0]), _bmp_bytes(imgs[1]), None, b"junk",
             port_imops.encode_ppm(imgs[2])]
    col = np.empty(len(blobs), dtype=object)
    col[:] = blobs
    with matmul_precision("float32"), ref_module.matmul_precision("float32"):
        ref.set("inputCol", "data")
        want = _feature_rows(ref.transform(_RefDF([{"data": col}])).column("f"))
        port.set("inputCol", "data")
        with use_device("cpu"):
            got = _feature_rows(port.transform(DataFrame([{"data": col}])).column("f"))
            port.set("hostPreprocess", True)
            host = _feature_rows(port.transform(DataFrame([{"data": col}])).column("f"))
    assert [g is None for g in got] == [w is None for w in want] \
        == [False, False, True, True, False]
    for g, w, h in zip(got, want, host):
        if w is not None:
            assert g.shape == (64,)
            np.testing.assert_allclose(g, w, atol=RESNET_F32_TOL * _scale(w),
                                       rtol=0)
            np.testing.assert_array_equal(h, g)


@pytest.mark.parametrize("upstream", [None, "resize_flip", "flip_gray"])
def test_image_featurizer_fused_bitwise_unfused(upstream):
    """PipelineModel([..., featurizer]).fuse() against the unfused chain,
    bit for bit: the featurizer alone (decode/resize in prepare), behind an
    ImageTransformer whose resize runs in prepare and flip on the device
    (the featurizer then takes the device-resident batch), and behind a
    device-only chain (flip + gray: the channel fix on the device)."""
    _, port = _featurizer_pair(scaleFactor=1 / 255)
    _, df = _image_dfs(_image_rows(n=9, h=16, w=16), num_partitions=2)
    stages_ = []
    if upstream == "resize_flip":
        _, df = _image_dfs(_image_rows(n=9, h=20, w=14), num_partitions=2)
        stages_.append(ImageTransformer().resize(16, 16).flip(1))
    elif upstream == "flip_gray":
        stages_.append(ImageTransformer().flip(0).color_format("gray"))
    pm = PipelineModel(stages_ + [port])
    with use_device("cpu"):
        want = np.stack(_feature_rows(pm.transform(df).column("f")))
        fused = pm.fuse()
        got = np.stack(_feature_rows(fused.transform(df).column("f")))
        stats = fused.fusion_stats()
    np.testing.assert_array_equal(got, want)
    assert stats["fallbacks"] == []
    assert [s["kind"] for s in stats["segments"]] == ["fused"]


def test_image_featurizer_nchw_branch_through_the_preprocess_transpose():
    """A backbone that takes NCHW (imported ONNX models, ROADMAP A7d):
    input_shape (C, H, W), the HWC rows moved to CHW by PreprocessSpec's
    transpose on the device; fused and unfused alike."""
    head = port_module.Sequential([
        ("pool", port_module.Fn(_nchw_pool, _nchw_pool_shape)),
        ("fc", Dense(4)),
    ], name="nchw")
    head.init(torch.Generator().manual_seed(0), (3, 6, 5))
    model = FunctionModel(head, (3, 6, 5), ["fc", "pool"], "nchw",
                          data_format="NCHW")
    feat = ImageFeaturizer(inputCol="image", outputCol="f", batchSize=4,
                           cutOutputLayers=1).set_model(model)
    arrays = _image_rows(n=5, h=6, w=5)
    _, df = _image_dfs(arrays)
    with use_device("cpu"):
        got = np.stack(list(feat.transform(df).column("f")))
        fused = np.stack(list(PipelineModel([feat]).fuse().transform(df).column("f")))
    want = np.stack([a.astype(np.float32).transpose(2, 0, 1).mean(axis=(1, 2))
                     for a in arrays])
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    np.testing.assert_array_equal(fused, got)


def _nchw_pool(x):
    return x.mean(dim=(2, 3))


def _nchw_pool_shape(s):
    return (s[0],)


def test_image_featurizer_save_load_bitwise(tmp_path):
    from mmlspark_tpu_torch.core.pipeline import PipelineStage

    _, port = _featurizer_pair(scaleFactor=1 / 255)
    _, df = _image_dfs(_image_rows(n=3, h=16, w=16))
    with use_device("cpu"):
        want = np.stack(list(port.transform(df).column("f")))
        port.save(str(tmp_path / "feat"))
        loaded = PipelineStage.load(str(tmp_path / "feat"))
        got = np.stack(list(loaded.transform(df).column("f")))
    assert type(loaded) is ImageFeaturizer
    np.testing.assert_array_equal(got, want)


# ---- training with BatchNorm


def _bn_module(ref):
    mod = ref_module if ref else port_module
    return mod.Sequential([("dense", mod.Dense(8)), ("bn", mod.BatchNorm()),
                           ("relu", mod.relu()), ("head", mod.Dense(3))])


def test_batchnorm_ema_train_step_matches_reference():
    """The reference's BatchNorm EMA train step (tests/test_models.py)
    through the port's make_train_step from the same params, three steps
    in f32: params and moving statistics within 1e-6 of the reference's
    (all O(1)), and the statistics moved."""
    ref_mod, port = _bn_module(True), _bn_module(False)
    params, _ = ref_mod.init(jax.random.key(0), (4,))
    params = _np_tree(jax.tree.map(np.asarray, params))
    port.init(torch.Generator(), (4,))
    load_jax_params(FunctionModel(port, (4,)), params)
    ref_opt = ref_training.make_optimizer(0.01, weight_decay=1e-3)
    ref_state = ref_training.TrainState(jax.tree.map(jnp.asarray, params),
                                        ref_opt.init(params), np.int32(0))
    ref_step = jax.jit(ref_training.make_train_step(ref_mod, ref_opt))
    port_opt = training.make_optimizer(0.01, weight_decay=1e-3)
    step = training.make_train_step(port, port_opt)
    tparams = jax.tree.map(torch.from_numpy, params)
    state = training.TrainState(tparams, port_opt.init(tparams), 0)
    rng = np.random.default_rng(0)
    for i in range(3):
        batch = {"x": (rng.normal(size=(16, 4)) * 5 + 2).astype(np.float32),
                 "y": (np.arange(16) % 3).astype(np.int32)}
        with ref_module.matmul_precision("float32"):
            ref_state, _ = ref_step(ref_state, batch)
        with matmul_precision("float32"):
            state, _ = step(state, batch)
        want = dict(_leaves(jax.tree.map(np.asarray, ref_state.params)))
        for name, g in _leaves(state.params):
            np.testing.assert_allclose(g.numpy(), want[name], atol=1e-6, rtol=0,
                                       err_msg=f"step {i} {name}")
    assert not np.allclose(state.params["bn"]["mean"].numpy(), 0.0)
    assert not np.allclose(state.params["bn"]["var"].numpy(), 1.0)


def test_resnet_train_step_matches_reference():
    """One f32 step of ResNet-18 (width 8, 64x64, 8 rows) from the same
    params: the gradients (zero for the moving statistics), then params
    with the statistics' moving averages, per leaf relative to its max
    |value|, within RESNET_F32_TOL. Batch statistics over few values make
    the gradients ill-conditioned (at 16x16 and 4 rows, 4 values a channel
    at layer4: 1.3e-4 in f32, and bf16's roundings part the gradients by
    up to 20%), so bf16 is held on the forward only."""
    ref, port = _resnet_pair(18, 64, classes=4)
    params = jax.tree.map(np.asarray, ref.params)
    opt = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-3)
    ref_opt = ref_training.make_optimizer(**opt)
    ref_state = ref_training.TrainState(ref.params, ref_opt.init(ref.params),
                                        np.int32(0))
    port_opt = training.make_optimizer(**opt)
    tparams = jax.tree.map(torch.from_numpy, params)
    state = training.TrainState(tparams, port_opt.init(tparams), 0)
    rng = np.random.default_rng(3)
    batch = {"x": rng.normal(size=(8, 64, 64, 3)).astype(np.float32),
             "y": rng.integers(0, 4, 8).astype(np.int32)}
    tol = RESNET_F32_TOL
    prec = "float32"

    def loss(p):
        logits = ref.module.apply(p, jnp.asarray(batch["x"]), train=True,
                                  stats_out={})
        return ref_training.cross_entropy_loss(logits, jnp.asarray(batch["y"]))

    with ref_module.matmul_precision(prec):
        want_g = jax.grad(loss)(ref.params)
        ref_state, ref_m = ref_training.make_train_step(ref.module, ref_opt)(
            ref_state, batch)
    with matmul_precision(prec):
        _, stats, got_g = training.loss_and_grads(port.module, state.params, batch)
        state, m = training.make_train_step(port.module, port_opt)(state, batch)
    assert len(stats) == 20      # the stem, 8 blocks x 2 and 3 shortcuts
    _assert_tree_close(got_g, want_g, tol, "grads")
    assert float(got_g["stem"]["bn"]["mean"].abs().max()) == 0.0
    _assert_tree_close(state.params, ref_state.params, tol, "params")
    assert abs(float(m["loss"]) - float(ref_m["loss"])) <= tol * abs(float(ref_m["loss"]))


# ---- the switch MoE


def _moe_pair(experts, cf, in_shape=(16, 8), hidden=None):
    ref_mod = ref_moe.MoE(experts, hidden=hidden, capacity_factor=cf)
    params, _ = ref_mod.init(jax.random.key(experts), in_shape)
    params = jax.tree.map(np.asarray, params)
    port = port_moe.MoE(experts, hidden=hidden, capacity_factor=cf)
    assert port.init(torch.Generator(), in_shape) == in_shape
    load_jax_params(FunctionModel(port, in_shape), params)
    return ref_mod, params, port


@pytest.mark.parametrize("experts,cf", [(4, 2.0), (4, 0.5), (2, 1e-9), (8, 1.5)])
@pytest.mark.parametrize("f32", [True, False])
def test_moe_matches_reference_with_grads(experts, cf, f32):
    """The switch MoE on [2, 16, 8] tokens: routing (the same expert for
    every token, the same dropped tokens past capacity; cf 0.5 and 1e-9
    overflow), the output, and the gradients of a seeded cotangent against
    jax.grad, per leaf and for the input, within MOE_TOL."""
    ref_mod, params, port = _moe_pair(experts, cf)
    x = _x((2, 16, 8), seed=experts)
    cot = _x((2, 16, 8), seed=11)
    prec = "float32" if f32 else "bfloat16"

    def ref_loss(p, xx):
        return jnp.sum(ref_mod.apply(p, xx) * jnp.asarray(cot))

    with ref_module.matmul_precision(prec):
        want = np.asarray(ref_mod.apply(params, jnp.asarray(x)))
        want_gp, want_gx = jax.grad(ref_loss, argnums=(0, 1))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    with matmul_precision(prec):
        out = port(tx)
        expert, _, dispatch = port.routing(tx.detach())
        (out * torch.from_numpy(cot)).sum().backward()
    got = out.detach().numpy()
    assert got.dtype == want.dtype == np.float32
    logits = np.einsum("btd,de->bte", x, params["router"])
    np.testing.assert_array_equal(expert.numpy(), np.argmax(logits, -1))
    kept = dispatch.sum(dim=(2, 3)).numpy()
    if cf < 1:
        assert (kept == 0).any()          # tokens past capacity drop
    np.testing.assert_array_equal(np.abs(want).sum(-1) > 0, kept > 0)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, atol=MOE_TOL * scale, rtol=0)
    grads = {n: p.grad for n, p in port.named_parameters()}
    _assert_tree_close(grads, want_gp, MOE_TOL, "moe grads")
    gx = np.asarray(want_gx)
    np.testing.assert_allclose(tx.grad.numpy(), gx,
                               atol=MOE_TOL * max(np.abs(gx).max(), 1e-30), rtol=0)


@pytest.mark.parametrize("f32", [True, False])
def test_transformer_block_with_moe_matches_reference(f32):
    """``transformer_block(32, 2, moe_experts=4)``: the block with its
    switch-MoE FFN against the reference's (its layer paths too)."""
    ref_mod = ref_attention.transformer_block(32, 2, moe_experts=4)
    params, port = _pair(ref_mod, transformer_block(32, 2, moe_experts=4), (16, 32))
    assert port.layer_paths() == ref_mod.layer_paths()
    assert "mlp/body/moe" in port.layer_paths()
    ref, got = _run(ref_mod, params, port, _x((2, 16, 32)), f32)
    np.testing.assert_allclose(got, ref, atol=F32_TOL if f32 else DEEP_BF16_TOL,
                               rtol=0)


# ---- ONNX backbones and the multi-input feedDict (ROADMAP A7d)


@pytest.mark.parametrize("cut", [1, 0])
def test_image_featurizer_over_imported_onnx_backbone_matches_reference(cut):
    """A ResNet-18 (width 8, 16x16) exported by the reference and imported
    by both packages: ImageFeaturizer over the NCHW ``GraphModule`` (the
    pooled features, cut 1, and the logits, cut 0) within RESNET_F32_TOL of
    the reference's (the imported graph computes in f32); the fused
    featurizer bit for bit the unfused one."""
    from mmlspark_tpu.onnx import export_onnx as ref_export
    from mmlspark_tpu.onnx import import_onnx as ref_import
    from mmlspark_tpu_torch.onnx import import_onnx

    ref_m, _ = _resnet_pair(18, 16)
    blob = ref_export(ref_m.module, jax.tree.map(np.asarray, ref_m.params),
                      (16, 16, 3))
    ref_g, port_g = ref_import(blob), import_onnx(blob)
    assert port_g.data_format == ref_g.data_format == "NCHW"
    ref = ref_featurizer.ImageFeaturizer(
        inputCol="image", outputCol="f", batchSize=4, cutOutputLayers=cut,
        scaleFactor=1 / 255).set_model(ref_g)
    port = ImageFeaturizer(inputCol="image", outputCol="f", batchSize=4,
                           cutOutputLayers=cut,
                           scaleFactor=1 / 255).set_model(port_g)
    ref_df, df = _image_dfs(_image_rows(n=6, h=20, w=14), nulls=(1,))
    want = np.stack(_feature_rows(ref.transform(ref_df).column("f")))
    with use_device("cpu"):
        got = np.stack(_feature_rows(port.transform(df).column("f")))
        fused = np.stack(_feature_rows(
            PipelineModel([port]).fuse().transform(df).column("f")))
    assert got.shape == want.shape == (5, {1: 64, 0: 10}[cut])
    np.testing.assert_allclose(got, want, atol=RESNET_F32_TOL * _scale(want),
                               rtol=0)
    np.testing.assert_array_equal(fused, got)


def _bert_feed(n=7, seq=12, vocab=60, seed=4):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    blob = cs.bert_onnx(vocab=vocab, hidden=24, heads=3, ffn=48, layers=2,
                        seq=seq, seed=seed)
    ids, mask = cs.bert_inputs(n, seq, vocab, seed=seed + 1)
    return blob, ids, mask


def _two_input_graph(seed=6):
    """A two-input graph the reference's jitted DNNModel can run (no
    host-valued initializers: the reference passes every initializer to its
    jitted forward as a traced argument): ``x`` f32 [B, 6] masked by int64
    ``keep`` [B, 6] into a Gemm, plus the sum of ``keep``'s embeddings, then
    LayerNormalization and Relu."""
    from mmlspark_tpu_torch.onnx import proto as P

    rng = np.random.default_rng(seed)
    f32 = np.float32
    nodes = [P.make_node("Cast", ["keep"], ["kf"], name="kf", to=1),
             P.make_node("Mul", ["x", "kf"], ["xm"], name="xm"),
             P.make_node("Gemm", ["xm", "w", "b"], ["h"], name="h"),
             P.make_node("Gather", ["emb", "keep"], ["e"], name="e", axis=0),
             P.make_node("ReduceSum", ["e"], ["es"], name="es", axes=[1],
                         keepdims=0),
             P.make_node("Add", ["h", "es"], ["s"], name="s"),
             P.make_node("LayerNormalization", ["s", "sc", "bi"], ["ln"],
                         name="ln", axis=-1),
             P.make_node("Relu", ["ln"], ["out"], name="out")]
    inits = [P.make_tensor("w", rng.standard_normal((6, 5)).astype(f32)),
             P.make_tensor("b", rng.standard_normal(5).astype(f32)),
             P.make_tensor("emb", rng.standard_normal((2, 5)).astype(f32)),
             P.make_tensor("sc", rng.uniform(0.5, 1.5, 5).astype(f32)),
             P.make_tensor("bi", rng.standard_normal(5).astype(f32))]
    return P.make_model(
        nodes, inits,
        [P.make_value_info("x", [None, 6]),
         P.make_value_info("keep", [None, 6], P.DT_INT64)],
        [P.make_value_info("out", [None, 5])])


def test_dnn_model_feed_dict_two_inputs_matches_reference():
    """``DNNModel.setFeedDict`` over two-input ONNX graphs against the
    reference, within F32_TOL (1e-5) of each output's max |x|: (a) a graph
    the reference's DNNModel runs (f32 ``x`` and int64 ``keep``, by
    ARGUMENT_i and by name, a fetchDict of the output and a
    LayerNormalization tap), column against column, a row with a null in
    either fed column a null row, the feed unfused; (b) the BERT-shaped
    encoder of ``chip_smoke.bert_onnx`` (its Reshape/Unsqueeze read host
    values, which the reference's jitted DNNModel cannot trace) against the
    reference's ``import_onnx(...).apply`` on the same rows; (c) a feed
    naming only the secondary input raises."""
    from mmlspark_tpu.onnx import import_onnx as ref_import
    from mmlspark_tpu_torch.onnx import import_onnx

    rng = np.random.default_rng(2)
    blob = _two_input_graph()
    cols = {"xs": list(rng.standard_normal((7, 6)).astype(np.float32)),
            "keeps": list(rng.integers(0, 2, (7, 6)))}
    cols["keeps"][3] = None
    cols["xs"][5] = None
    outs = []
    for dnn_cls, imp, frame in ((RefDNNModel, ref_import, RefDataFrame),
                                (DNNModel, import_onnx, DataFrame)):
        stage = dnn_cls(batchSize=3).set_model(imp(blob))
        stage.set_feed_dict({"ARGUMENT_0": "xs", "keep": "keeps"})
        stage.set_fetch_dict({"y": "OUTPUT_0", "ln": "ln"})
        df = frame.from_dict(cols, num_partitions=2)
        if dnn_cls is DNNModel:
            assert stage.device_fn(df.schema) is None
            with use_device("cpu"):
                out = stage.transform(df)
        else:
            out = stage.transform(df)
        outs.append((list(out.column("y")), list(out.column("ln"))))
    for got_col, want_col in zip(outs[1], outs[0]):
        assert [g is None for g in got_col] == [w is None for w in want_col] \
            == [i in (3, 5) for i in range(7)]
        got = np.stack([g for g in got_col if g is not None])
        want = np.stack([np.asarray(w) for w in want_col if w is not None])
        assert got.shape == want.shape == (5, 5)
        np.testing.assert_allclose(got, want, atol=F32_TOL * _scale(want),
                                   rtol=0)

    blob, ids, mask = _bert_feed()
    stage = DNNModel(outputCol="cls", batchSize=3).set_model(import_onnx(blob))
    stage.set_feed_dict({"input_ids": "ids", "attention_mask": "mask"})
    with use_device("cpu"):
        got = np.stack(list(stage.transform(DataFrame.from_dict(
            {"ids": list(ids), "mask": list(mask)}, num_partitions=2))
            .column("cls")))
    want = np.asarray(ref_import(blob).apply({"input_ids": ids,
                                              "attention_mask": mask}))
    np.testing.assert_allclose(got, want, atol=F32_TOL * _scale(want), rtol=0)

    only = DNNModel(outputCol="o").set_model(import_onnx(blob))
    only.set_feed_dict({"attention_mask": "mask"})
    with use_device("cpu"), pytest.raises(KeyError, match="input_ids"):
        only.transform(DataFrame.from_dict({"mask": list(mask)}))


# ---------------------------------------------------------------- the DNN mesh
#
# The port's mesh is one process a rank (``parallel.mesh``), so its DNN mesh
# cases run in gloo ranks on the CPU that import only the port
# (``parallel.launch.spawn``, one thread a rank, a file rendezvous under the
# test's temporary directory). One launch for each world size (2, 4, 8)
# runs every case of ``_DNN_RANKS`` that needs it; a case's failure is
# returned as its traceback, so each test fails alone. This process builds
# the inputs with the reference (its own inits, carried into the port with
# ``load_jax_params``) and holds the ranks' results against the reference's
# own multi-device tests, on the ``mesh8`` fixture's 8 CPU devices where
# they need a mesh, at the reference's tolerances: the sharded step against
# the single-device one (loss 1e-4, accuracy 1e-6, params atol 5e-4 / rtol
# 1e-3, ``tests/test_models.py:515``), ring attention 2e-5 and the ring
# encoder 5e-5 (``tests/test_attention.py:46, 190``), the pipeline 1e-5 and
# its transformer blocks 1e-4, the expert-sharded MoE 1e-5
# (``tests/test_parallel_pp_ep.py``), the sharded DNNModel 1e-5
# (``tests/test_models.py:492``); the resumed mesh loop bit for bit.

_DNN_RANKS = r'''
"""One rank of the DNN mesh cases (imports only the port)."""
import dataclasses
import os
import pickle
import traceback

import numpy as np
import torch


def _mesh(**spec):
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(**spec), device="cpu", backend="gloo")


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _full(st):
    from mmlspark_tpu_torch.parallel.mesh import gather_tree

    return (_np(gather_tree(st.params, st.shardings, st.mesh)),
            _np(gather_tree(st.opt_state["trace"], st.shardings, st.mesh)))


def _state(module, in_shape, opt, mesh, params, trace=None):
    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.parallel.mesh import shard_tree

    st = T.init_train_state(module, in_shape, opt, mesh=mesh)
    p = shard_tree(_t(params), st.shardings, mesh)
    tr = st.opt_state if trace is None else \
        {"trace": shard_tree(_t(trace), st.shardings, mesh)}
    return dataclasses.replace(st, params=p, opt_state=tr)


def _precision(f32):
    import contextlib

    from mmlspark_tpu_torch.models import matmul_precision

    return matmul_precision("float32") if f32 else contextlib.nullcontext()


def case_resnet_step(c):
    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.models.resnet import build_resnet

    mesh = _mesh(**c["spec"])
    module = build_resnet(c["depth"], num_classes=c["classes"],
                          image_size=c["size"], width=8)
    opt = T.make_optimizer(**c["opt"])
    shape = (c["size"], c["size"], 3)
    out = {"metrics": []}
    with _precision(True):
        st = _state(module, shape, opt, mesh, c["params"])
        step = T.compile_train_step(module, opt, mesh=mesh)
        for b in c["batches"]:
            st, m = step(st, b)
            out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"], out["trace"] = _full(st)
    return out


def case_encoder_step(c):
    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.models import transformer_encoder
    from mmlspark_tpu_torch.parallel import mesh as pm

    mesh = _mesh(**c["spec"])
    port = transformer_encoder(**c["enc"], seed=1)
    opt = T.make_optimizer(**c["opt"])
    out = {"metrics": [], "params": [], "trace": []}
    with _precision(c["f32"]):
        st = _state(port.module, port.input_shape, opt, mesh, c["params"],
                    c["trace"])
        out["blocks"] = {n: tuple(t.shape) for n, t in
                         (("wq", st.params["block0"]["attn"]["body"]["attn"]
                           ["wq"]),
                          ("fc1", st.params["block0"]["mlp"]["body"]["fc1"]
                           ["kernel"]))}
        step = T.compile_train_step(port.module, opt, mesh=mesh)
        pm.stats.reset()
        for b in c["batches"]:
            st, m = step(st, b)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            p, tr = _full(st)
            out["params"].append(p)
            out["trace"].append(tr)
        out["collectives"] = pm.stats.calls
    return out


def case_restore(c):
    from mmlspark_tpu_torch.models import checkpoint as ck
    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.models.resnet import build_resnet
    from mmlspark_tpu_torch.parallel.mesh import gather_tree

    mesh = _mesh(**c["spec"])
    module = build_resnet(18, num_classes=4, image_size=16, width=8)
    like = T.init_train_state(module, (16, 16, 3), T.make_optimizer(),
                              seed=5, mesh=mesh)
    got = ck.load_train_state(c["path"], like=like)
    name = c["leaf"]
    spec = got.shardings
    for k in name.split("."):
        spec = spec[k]
    local = got.params
    for k in name.split("."):
        local = local[k]
    return {"spec": spec.spec, "slices": spec.local_slices(c["shape"], mesh),
            "local": local.numpy(), "step": got.step,
            "full": _np(gather_tree(got.params, got.shardings, mesh))}


def case_dnn_model(c):
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models import DNNModel, load_jax_params
    from mmlspark_tpu_torch.parallel.mesh import MeshContext

    mesh = _mesh(**c["spec"])
    model = pickle.loads(c["model"])
    load_jax_params(model, c["params"])
    df = DataFrame.from_dict({"x": list(c["x"])},
                             num_partitions=c["partitions"])
    stage = DNNModel(inputCol="x", outputCol="out",
                     batchSize=c["batch"]).set_model(model)
    MeshContext.set(mesh)
    try:
        fused = stage.device_fn(df.schema)
        out = np.stack(list(stage.transform(df).column("out")))
    finally:
        MeshContext.reset()
    return {"out": out, "device_fn": fused}


def case_ring(c):
    from mmlspark_tpu_torch.models import matmul_precision, ring_attention
    from mmlspark_tpu_torch.parallel.mesh import SEQ_AXIS

    mesh = _mesh(**c["spec"])
    n, me = mesh.axis_size(SEQ_AXIS), mesh.coord(SEQ_AXIS)
    t = c["q"].shape[1] // n
    q, k, v = (torch.from_numpy(c[a][:, me * t:(me + 1) * t]).requires_grad_()
               for a in "qkv")
    with matmul_precision("float32"):
        o = ring_attention(q, k, v, mesh, causal=c["causal"])
        gq, gk, gv = torch.autograd.grad((o * o).sum(), (q, k, v))
    return {"o": o.detach().numpy(), "grads": [g.numpy() for g in (gq, gk, gv)],
            "me": me}


def case_ring_encoder(c):
    from mmlspark_tpu_torch.models import (activation_sharding,
                                           load_jax_params, matmul_precision,
                                           transformer_encoder)
    from mmlspark_tpu_torch.parallel.mesh import SEQ_AXIS

    mesh = _mesh(**c["spec"])
    n, me = mesh.axis_size(SEQ_AXIS), mesh.coord(SEQ_AXIS)
    m = transformer_encoder(**c["enc"], ring_axis="seq", ring_axis_size=n)
    load_jax_params(m, c["params"])
    t = c["x"].shape[1] // n
    with matmul_precision("float32"), activation_sharding(mesh):
        y = m.apply(torch.from_numpy(c["x"][:, me * t:(me + 1) * t]))
    return {"y": y.numpy(), "me": me}


def case_tagger(c):
    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.models.attention import BiLSTM, Embed
    from mmlspark_tpu_torch.models.module import Dense, Sequential

    mesh = _mesh(**c["spec"])
    module = Sequential([("embed", Embed(20, 8)), ("bilstm", BiLSTM(8)),
                         ("tags", Dense(2))], name="tagger")
    opt = T.make_optimizer(learning_rate=0.2, momentum=0.9)
    st = _state(module, (10,), opt, mesh, c["params"])
    step = T.compile_train_step(module, opt, mesh=mesh)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(c["steps"]):
        toks = rng.integers(0, 20, size=(16, 10))
        st, m = step(st, {"x": toks, "y": (toks >= 10).astype(np.int32)})
        out.append({k: float(v) for k, v in m.items()})
    return {"metrics": out}


def case_pipeline(c):
    from mmlspark_tpu_torch.parallel.mesh import PIPE_AXIS
    from mmlspark_tpu_torch.parallel.pipeline_parallel import (
        pipeline_apply, stack_stage_params)

    mesh = _mesh(**c["spec"])
    stacked = stack_stage_params([_t(p) for p in c["stages"]])
    s = mesh.coord(PIPE_AXIS)
    mine = {k: v[s].clone().requires_grad_() for k, v in stacked.items()}
    xs = torch.from_numpy(c["xs"])

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    y = pipeline_apply(stage_fn, {k: v[None] for k, v in mine.items()}, xs,
                       mesh)
    n = mesh.axis_size(PIPE_AXIS)
    grads = torch.autograd.grad((y * y).sum() / n, list(mine.values()))
    return {"y": y.detach().numpy(), "stage": s,
            "grads": {k: g.numpy() for k, g in zip(mine, grads)}}


def case_pipe_blocks(c):
    from mmlspark_tpu_torch.models import matmul_precision, transformer_block
    from mmlspark_tpu_torch.models.module import _flatten
    from mmlspark_tpu_torch.parallel.pipeline_parallel import (
        pipeline_apply, stack_stage_params)

    mesh = _mesh(**c["spec"])
    block = transformer_block(c["dim"], c["heads"])
    block.init(torch.Generator(), c["in_shape"])
    stacked = stack_stage_params([_t(p) for p in c["stages"]])

    def stage_fn(p, x):
        return torch.func.functional_call(block, _flatten(p), (x,))

    with matmul_precision("float32"), torch.no_grad():
        y = pipeline_apply(stage_fn, stacked, torch.from_numpy(c["xs"]), mesh)
    return {"y": y.numpy()}


def case_moe(c):
    from mmlspark_tpu_torch.models import (FunctionModel, activation_sharding,
                                           load_jax_params, matmul_precision,
                                           transformer_block)
    from mmlspark_tpu_torch.models.module import _flatten
    from mmlspark_tpu_torch.models.moe import MoE, expert_shardings
    from mmlspark_tpu_torch.parallel.mesh import shard_tree

    mesh = _mesh(**c["spec"])
    if c["block"]:
        mod = transformer_block(c["dim"], 2, moe_experts=c["experts"],
                                moe_capacity_factor=c["cf"])
    else:
        mod = MoE(c["experts"], capacity_factor=c["cf"])
    mod.init(torch.Generator(), c["in_shape"])
    load_jax_params(FunctionModel(mod, c["in_shape"]), c["params"])
    local = shard_tree(_t(c["params"]), expert_shardings(mesh, c["params"]),
                       mesh)
    with matmul_precision("float32"), activation_sharding(mesh), \
            torch.no_grad():
        y = torch.func.functional_call(mod, _flatten(local),
                                       (torch.from_numpy(c["x"]),))
    w1 = local["w1"] if not c["block"] else local["mlp"]["body"]["moe"]["w1"]
    return {"y": y.numpy(), "w1": tuple(w1.shape)}


def case_resume(c):
    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.models import transformer_encoder

    mesh = _mesh(**c["spec"])
    port = transformer_encoder(**c["enc"], seed=1)
    opt = T.make_optimizer(**c["opt"])
    step = T.compile_train_step(port.module, opt, mesh=mesh)
    batches = c["batches"]

    def fresh():
        return _state(port.module, port.input_shape, opt, mesh, c["params"])

    with _precision(True):
        full = T.run_train_loop(fresh(), step, batches)
        guard = T.PreemptionGuard()

        def preempting():
            for i, b in enumerate(batches):
                if i == c["stop"]:
                    guard.request()
                yield b

        cut = T.run_train_loop(fresh(), step, preempting(),
                               checkpoint_path=c["path"], every_k=100,
                               guard=guard)
        rest = T.run_train_loop(fresh(), step, batches,
                                checkpoint_path=c["path"])
    return {"full": _full(full.state), "rest": _full(rest.state),
            "runs": (cut.steps_run, cut.preempted, rest.steps_run,
                     rest.state.step), "loss": full.last_metrics["loss"]}


def case_collectives(c):
    """Each differentiable collective's forward and backward on a known
    function, on every axis of the mesh."""
    from mmlspark_tpu_torch.parallel import mesh as pm

    mesh = _mesh(**c["spec"])
    out = {}
    for axis in ("data", "tensor", "batch", "world"):
        n, me = mesh.axis_size(axis), mesh.coord(axis)
        x = torch.arange(6, dtype=torch.float64).reshape(2, 3) * (me + 1)
        x.requires_grad_()
        g = pm.all_gather_axis(x, mesh, axis, dim=1)          # [2, 3n]
        w = torch.arange(g.numel(), dtype=torch.float64).reshape(g.shape)
        (gx,) = torch.autograd.grad((g * w).sum(), x)
        r = pm.reduce_scatter_axis(x.repeat(1, n), mesh, axis, dim=1)
        a = pm.all_reduce_axis(x, mesh, axis)
        (ga,) = torch.autograd.grad((a * (me + 2)).sum(), x)
        s = pm.ring_shift(x, mesh, axis)
        (gs,) = torch.autograd.grad((s * (me + 3)).sum(), x)
        h = pm.all_gather_axis(x.to(torch.bfloat16), mesh, axis, dim=0)
        out[axis] = dict(n=n, me=me, g=g.detach().numpy(), gx=gx.numpy(),
                         r=r.detach().numpy(), a=a.detach().numpy(),
                         ga=ga.numpy(), s=s.detach().numpy(), gs=gs.numpy(),
                         h=h.detach().float().numpy())
    return out


def run(mesh, cases):
    torch.use_deterministic_algorithms(False)
    out = {}
    for name, case in cases.items():
        try:
            out[name] = globals()["case_" + case["fn"]](case)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out
'''

_DNN_MESH_CASES = {}   # world size -> {case name: builder(tmp) -> inputs}


def _dnn_case(world, name):
    def register(fn):
        _DNN_MESH_CASES.setdefault(world, {})[name] = fn
        return fn
    return register


def _dnn_mesh_launch(world, tmp_path_factory):
    from mmlspark_tpu_torch.parallel.launch import spawn

    work = tmp_path_factory.mktemp(f"dnn_mesh{world}")
    (work / "dnn_ranks.py").write_text(_DNN_RANKS)
    cases = {name: build(work) for name, build in
             _DNN_MESH_CASES[world].items()}
    ranks = spawn("dnn_ranks:run", world, work, dict(cases=cases),
                  threads=1, timeout=240, path=[str(work)])
    return cases, ranks


@pytest.fixture(scope="module")
def dnn_mesh2(tmp_path_factory):
    return _dnn_mesh_launch(2, tmp_path_factory)


@pytest.fixture(scope="module")
def dnn_mesh4(tmp_path_factory):
    return _dnn_mesh_launch(4, tmp_path_factory)


@pytest.fixture(scope="module")
def dnn_mesh8(tmp_path_factory):
    return _dnn_mesh_launch(8, tmp_path_factory)


def _ranks_of(run, name):
    """(the case's inputs, each rank's result); a rank's failure fails the
    test with its traceback."""
    cases, ranks = run
    got = [r[name] for r in ranks]
    for r, g in enumerate(got):
        assert "error" not in g, f"rank {r}:\n{g['error']}"
    return cases[name], got


ref_resnet_mod = importlib.import_module("mmlspark_tpu.models.resnet")
MESH_LOSS_ATOL, MESH_ACC_ATOL = 1e-4, 1e-6          # tests/test_models.py:515
MESH_PARAM_ATOL, MESH_PARAM_RTOL = 5e-4, 1e-3
RING_ATOL, RING_ENCODER_ATOL = 2e-5, 5e-5          # tests/test_attention.py
PIPE_ATOL, PIPE_BLOCKS_ATOL, MOE_MESH_ATOL = 1e-5, 1e-4, 1e-5
DNN_MESH_ATOL = 1e-5                               # tests/test_models.py:492
MESH_GRAD_ATOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _resnet_case(depth, classes, size, spec, seed, rows, steps):
    ref_mod = ref_resnet_mod.build_resnet(depth, num_classes=classes,
                                          image_size=size, width=8)
    params, _ = ref_mod.init(jax.random.PRNGKey(seed), (size, size, 3))
    rng = np.random.default_rng(0)
    batches = [{"x": rng.normal(size=(rows, size, size, 3)).astype(np.float32),
                "y": (rng.integers(0, classes, size=rows)).astype(np.int32)}
               for _ in range(steps)]
    return dict(fn="resnet_step", depth=depth, classes=classes, size=size,
                spec=spec, opt=dict(learning_rate=0.1, momentum=0.9),
                params=_np_tree(params), batches=batches)


@_dnn_case(8, "resnet18")
def _build_resnet18(work):
    return _resnet_case(18, 4, 16, dict(data=2, fsdp=2, tensor=2), 3, 8, 1)


@_dnn_case(8, "resnet50")
def _build_resnet50(work):
    return _resnet_case(50, 16, 32, dict(data=2, fsdp=2, tensor=2), 0, 8, 1)


def _assert_mesh_params(got, want, what):
    want = dict(_leaves(want))
    got = dict(_leaves(got))
    assert set(got) == set(want), what
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w),
                                   atol=MESH_PARAM_ATOL, rtol=MESH_PARAM_RTOL,
                                   err_msg=f"{what} {name}")


def _ref_steps(module, case, prec="float32"):
    """The reference's single-device steps from the case's params."""
    opt = ref_training.make_optimizer(**case["opt"])
    params = jax.tree.map(jnp.asarray, case["params"])
    st = ref_training.TrainState(params, opt.init(params), np.int32(0))
    step = jax.jit(ref_training.make_train_step(module, opt))
    metrics = []
    with ref_module.matmul_precision(prec):
        for b in case["batches"]:
            st, m = step(st, dict(b))
            metrics.append({k: float(v) for k, v in m.items()})
    return st, metrics


def test_train_step_dp_fsdp_tp_matches_single_device(dnn_mesh8):
    """One data x fsdp x tensor (2 x 2 x 2) step of ResNet-18 (width 8,
    16 px) on 8 gloo ranks against the reference's single-device step from
    the same params: loss, accuracy and every param on every rank
    (``tests/test_models.py:515``)."""
    case, ranks = _ranks_of(dnn_mesh8, "resnet18")
    module = ref_resnet_mod.build_resnet(18, num_classes=4, image_size=16,
                                         width=8)
    want, metrics = _ref_steps(module, case)
    for r in ranks:
        assert r["metrics"][0]["loss"] == pytest.approx(
            metrics[0]["loss"], abs=MESH_LOSS_ATOL)
        assert r["metrics"][0]["accuracy"] == pytest.approx(
            metrics[0]["accuracy"], abs=MESH_ACC_ATOL)
        _assert_mesh_params(r["params"], want.params, "params")


def test_dryrun_resnet50_step_on_data_fsdp_tensor_mesh(dnn_mesh8):
    """``__graft_entry__.py:dryrun_multichip``'s flagship: ResNet-50 at
    width 8 and 32 px, one step on data=2, fsdp=2, tensor=2: a finite loss,
    as the dryrun asks, within 1e-4 of the reference's single-device step's,
    and the params of the port's single-device step. (Against the
    reference's step the port's own single-device step parts past the
    reference's tolerance here: layer4's BatchNorm sees 8 values a channel
    at 1 x 1, and its gradient amplifies f32 sums in another order.)"""
    case, ranks = _ranks_of(dnn_mesh8, "resnet50")
    module = ref_resnet_mod.build_resnet(50, num_classes=16, image_size=32,
                                         width=8)
    _, metrics = _ref_steps(module, case)
    port = port_resnet.build_resnet(50, num_classes=16, image_size=32, width=8)
    opt = training.make_optimizer(**case["opt"])
    params = jax.tree.map(torch.from_numpy, case["params"])
    with use_device("cpu"), matmul_precision("float32"):
        port.init(torch.Generator(), (32, 32, 3))
        state = training.TrainState(params, opt.init(params), 0)
        state, _ = training.make_train_step(port, opt)(state,
                                                       case["batches"][0])
    for r in ranks:
        assert np.isfinite(r["metrics"][0]["loss"])
        assert r["metrics"][0]["loss"] == pytest.approx(
            metrics[0]["loss"], abs=MESH_LOSS_ATOL)
        _assert_mesh_params(r["params"], state.params, "params")


def test_param_sharding_rules_actually_shard(mesh8):
    """The port's rules give the reference's specs leaf for leaf for the
    flagship ResNet (``tests/test_models.py:562``), from the mesh's shape
    alone; a rank's block of a leaf follows its coordinates."""
    from mmlspark_tpu.parallel.mesh import MeshSpec as RefMeshSpec
    from mmlspark_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from mmlspark_tpu_torch.parallel.mesh import Mesh, ShardSpec

    ref_mod = ref_resnet_mod.build_resnet(18, num_classes=4, image_size=16,
                                          width=8)
    params, _ = ref_mod.init(jax.random.PRNGKey(0), (16, 16, 3))
    ref_mesh = ref_make_mesh(RefMeshSpec(data=2, fsdp=2, tensor=2))
    want = ref_training.param_sharding_rules(params, ref_mesh)
    shape = {"data": 2, "fsdp": 2, "tensor": 2, "seq": 1, "expert": 1,
             "pipe": 1}
    got = training.param_sharding_rules(_np_tree(params), Mesh(shape=shape))
    flat_want = {"/".join(str(getattr(k, "key", k)) for k in path): s.spec
                 for path, s in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_got = {n.replace(".", "/"): s.spec for n, s in
                port_module._flatten(got).items()}
    assert set(flat_got) == set(flat_want)
    for n, spec in flat_want.items():
        assert flat_got[n] == tuple(spec), n
    sharded = [s for s in flat_got.values() if any(a is not None for a in s)]
    assert len(sharded) >= 10
    # rank 5 is (data 1, fsdp 0, tensor 1): the second half of cout
    kernel = np.zeros((3, 3, 8, 16), np.float32)
    spec = ShardSpec((None, None, "fsdp", "tensor"))
    assert spec.local_slices(kernel.shape, Mesh(shape=shape, rank=5)) == (
        slice(None), slice(None), slice(0, 4), slice(8, 16))


def test_mesh_coordinates_follow_the_reference_device_order(mesh8):
    """Rank r's coordinates are those of the reference's device r on a
    ``jax.make_mesh`` of the same shape (row-major, data slowest)."""
    from mmlspark_tpu.parallel.mesh import MeshSpec as RefMeshSpec
    from mmlspark_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from mmlspark_tpu_torch.parallel.mesh import coords_of

    for spec in (dict(data=2, fsdp=2, tensor=2), dict(data=1, seq=8),
                 dict(data=2, expert=2, pipe=2), dict(data=4, tensor=2)):
        ref_mesh = ref_make_mesh(RefMeshSpec(**spec))
        shape = dict(ref_mesh.shape)
        ids = np.vectorize(lambda d: d.id)(ref_mesh.devices)
        for idx in np.ndindex(*ids.shape):
            assert coords_of(int(ids[idx]), shape) == {
                a: int(i) for a, i in zip(ref_mesh.axis_names, idx)}, spec


@_dnn_case(8, "restore")
def _build_restore(work):
    module = port_resnet.build_resnet(18, num_classes=4, image_size=16,
                                      width=8)
    opt = training.make_optimizer()
    with use_device("cpu"):
        state = training.init_train_state(module, (16, 16, 3), opt, seed=0)
    state = training.TrainState(state.params, state.opt_state, 7)
    path = str(work / "ckpt")
    port_checkpoint.save_train_state(state, path)
    kernel = state.params["layer1"]["0"]["body"]["conv1"]["kernel"]
    return dict(fn="restore", spec=dict(data=2, fsdp=2, tensor=2), path=path,
                leaf="layer1.0.body.conv1.kernel", shape=tuple(kernel.shape))


def test_restore_onto_mesh_shardings(dnn_mesh8):
    """A single-device checkpoint restored onto a sharded ``like``: each rank
    holds its block of the saved leaves, at the placement ``like`` has, and
    the blocks gather back to the saved values, not ``like``'s
    (``tests/test_models.py:626``)."""
    case, ranks = _ranks_of(dnn_mesh8, "restore")
    saved = port_checkpoint.load_train_state(case["path"])
    want = saved.params["layer1"]["0"]["body"]["conv1"]["kernel"].numpy()
    for rank, r in enumerate(ranks):
        assert r["spec"] == (None, None, "fsdp", "tensor")
        assert r["step"] == 7
        np.testing.assert_array_equal(r["local"], want[r["slices"]])
        assert r["local"].shape == (3, 3, 4, 4)
        for (n, a), (_, b) in zip(_leaves(r["full"]), _leaves(saved.params)):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=n)


def _tiny_mlp_pair():
    ref = ref_module.Sequential([("dense1", ref_module.Dense(8)),
                                 ("relu1", ref_module.relu()),
                                 ("dense2", ref_module.Dense(3))], name="mlp")
    params, _ = ref.init(jax.random.PRNGKey(0), (6,))
    port = port_module.Sequential([("dense1", Dense(8)),
                                   ("relu1", port_module.relu()),
                                   ("dense2", Dense(3))], name="mlp")
    port.init(torch.Generator(), (6,))
    return (ref_module.FunctionModel(ref, params, (6,), ["dense2", "relu1"]),
            FunctionModel(port, (6,), ["dense2", "relu1"]), _np_tree(params))


@_dnn_case(8, "dnn_model")
def _build_dnn_model(work):
    import pickle

    _, port, params = _tiny_mlp_pair()
    x = np.random.default_rng(0).normal(size=(40, 6)).astype(np.float32)
    return dict(fn="dnn_model", spec=dict(data=8), model=pickle.dumps(port),
                params=params, x=x, partitions=2, batch=16)


@_dnn_case(4, "dnn_encoder")
def _build_dnn_encoder(work):
    import pickle

    ref, port = _encoders()
    return dict(fn="dnn_model", spec=dict(data=4), model=pickle.dumps(port),
                params=_np_tree(ref.params), x=_tokens(10), partitions=1,
                batch=8)


@pytest.mark.parametrize("world,name", [(8, "dnn_model"), (4, "dnn_encoder")])
def test_dnn_model_sharded_inference_matches_single_device(world, name,
                                                           request):
    """``DNNModel`` under a ``MeshContext`` whose data axis is above 1
    shards every batch the axis divides over the ranks and gathers the
    output; the others (the 40 rows' last batch of 4 on 8 ranks, the 10
    tokens' last of 2 on 4) run whole on every rank: the reference's
    single-device transform on every rank, within 1e-5 for the MLP
    (``tests/test_models.py:492``) and DEEP_BF16_TOL for the encoder in
    the bf16 default (a rank's 2-row block sums its products in another
    order than 8 rows do, and an intermediate can round to the next bf16
    value), and unfused (no ``device_fn``)."""
    case, ranks = _ranks_of(request.getfixturevalue(f"dnn_mesh{world}"), name)
    if name == "dnn_model":
        ref, _, _ = _tiny_mlp_pair()
    else:
        ref, _ = _encoders()
    df = RefDataFrame.from_dict({"x": list(case["x"])},
                                num_partitions=case["partitions"])
    single = RefDNNModel(inputCol="x", outputCol="out", batchSize=case["batch"],
                         useMesh=False).set_model(ref)
    want = np.stack(list(single.transform(df).column("out")))
    tol = DNN_MESH_ATOL if name == "dnn_model" else DEEP_BF16_TOL
    for r in ranks:
        assert r["device_fn"] is None
        np.testing.assert_allclose(r["out"], want, atol=tol)


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def _ring_case(seq, causal, seed=0, shape=(2, 32, 2, 8)):
    q, k, v = _qkv(*shape, seed)
    return dict(fn="ring", spec=dict(data=1, seq=seq), q=q, k=k, v=v,
                causal=causal)


for _c in (False, True):
    _dnn_case(8, f"ring_{_c}")(lambda work, c=_c: _ring_case(8, c))
_dnn_case(2, "ring_True")(lambda work: _ring_case(2, True, 4, (1, 16, 2, 4)))


def _ref_ring(case, n):
    from jax.sharding import PartitionSpec as P

    from mmlspark_tpu.parallel.mesh import MeshSpec as RefMeshSpec
    from mmlspark_tpu.parallel.mesh import make_mesh as ref_make_mesh

    mesh = ref_make_mesh(RefMeshSpec(data=1, seq=n),
                         device_list=jax.devices()[:n])
    spec = P(None, "seq", None, None)

    def loss(q, k, v):
        o = ref_attention.ring_attention(q, k, v, "seq", n,
                                         causal=case["causal"])
        return jnp.sum(o * o)

    fwd = jax.jit(jax.shard_map(
        lambda q, k, v: ref_attention.ring_attention(
            q, k, v, "seq", n, causal=case["causal"]),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))
    grad = jax.jit(jax.shard_map(
        lambda q, k, v: jax.grad(loss, argnums=(0, 1, 2))(q, k, v),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=(spec,) * 3))
    args = [jnp.asarray(case[a]) for a in "qkv"]
    with ref_module.matmul_precision("float32"):
        return np.asarray(fwd(*args)), [np.asarray(g) for g in grad(*args)]


@pytest.mark.parametrize("world,causal", [(8, False), (8, True), (2, True)])
def test_ring_attention_matches_reference(world, causal, request):
    """``ring_attention`` over the seq group against the reference's under
    ``shard_map`` (and its dense attention), 2e-5; the gradients of
    sum(o * o) through the ring's shifts against the reference's
    ``jax.grad`` through its ``ppermute``s, and against the dense
    attention's, 1e-5 (``tests/test_attention.py:46, 61``)."""
    case, ranks = _ranks_of(request.getfixturevalue(f"dnn_mesh{world}"),
                            f"ring_{causal}")
    want, want_g = _ref_ring(case, world)
    ranks = sorted(ranks, key=lambda r: r["me"])
    got = np.concatenate([r["o"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, want, atol=RING_ATOL)
    with ref_module.matmul_precision("float32"):
        dense = np.asarray(ref_attention.dense_attention(
            *[jnp.asarray(case[a]) for a in "qkv"], causal=causal))
    np.testing.assert_allclose(got, dense, atol=RING_ATOL)
    q, k, v = (torch.from_numpy(case[a]).double().requires_grad_()
               for a in "qkv")
    o = attention.dense_attention(q, k, v, causal=causal)
    dense_g = torch.autograd.grad((o * o).sum(), (q, k, v))
    for i in range(3):
        g = np.concatenate([r["grads"][i] for r in ranks], axis=1)
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        np.testing.assert_allclose(g, want_g[i], atol=MESH_GRAD_ATOL)
        np.testing.assert_allclose(g, dense_g[i].numpy(), atol=MESH_GRAD_ATOL)


@_dnn_case(8, "ring_encoder")
def _build_ring_encoder(work):
    with ref_module.matmul_precision("float32"):
        ref = ref_attention.transformer_encoder(seq_len=16, dim=8, depth=1,
                                                num_heads=1)
    x = np.random.default_rng(3).normal(size=(2, 16, 8)).astype(np.float32)
    return dict(fn="ring_encoder", spec=dict(data=1, seq=8),
                enc=dict(seq_len=16, dim=8, depth=1, num_heads=1),
                params=_np_tree(ref.params), x=x)


def test_ring_encoder_matches_dense_encoder(dnn_mesh8):
    """The same weights run dense on one device (the reference's encoder)
    and ring-parallel on 8 ranks' blocks of the sequence
    (``transformer_encoder(ring_axis="seq")``), 5e-5
    (``tests/test_attention.py:190``)."""
    case, ranks = _ranks_of(dnn_mesh8, "ring_encoder")
    with ref_module.matmul_precision("float32"):
        ref = ref_attention.transformer_encoder(**case["enc"])
        want = np.asarray(ref.module.apply(
            jax.tree.map(jnp.asarray, case["params"]), jnp.asarray(case["x"])))
    got = np.concatenate([r["y"] for r in sorted(ranks,
                                                 key=lambda r: r["me"])], 1)
    np.testing.assert_allclose(got, want, atol=RING_ENCODER_ATOL)


@_dnn_case(8, "tagger")
def _build_tagger(work):
    module = ref_module.Sequential([
        ("embed", ref_attention.Embed(20, 8)),
        ("bilstm", ref_attention.BiLSTM(8)),
        ("tags", ref_module.Dense(2)),
    ], name="tagger")
    params, _ = module.init(jax.random.PRNGKey(0), (10,))
    return dict(fn="tagger", spec=dict(data=-1), params=_np_tree(params),
                steps=60)


def test_tagger_trains_per_token_labels_on_data_axis(dnn_mesh8):
    """The per-token BiLSTM tagger trained on ``data=-1`` (8 ranks, 2 rows
    each of 16 a step): the reference's gates (loss below a fifth of the
    first, accuracy above 0.95, ``tests/test_attention.py:320``), and its
    first step's loss within 1e-4 of the reference's single-device step
    from the same params and batch."""
    case, ranks = _ranks_of(dnn_mesh8, "tagger")
    module = ref_module.Sequential([
        ("embed", ref_attention.Embed(20, 8)),
        ("bilstm", ref_attention.BiLSTM(8)),
        ("tags", ref_module.Dense(2)),
    ], name="tagger")
    toks = np.random.default_rng(0).integers(0, 20, size=(16, 10))
    _, metrics = _ref_steps(module, dict(
        opt=dict(learning_rate=0.2, momentum=0.9), params=case["params"],
        batches=[{"x": toks, "y": (toks >= 10).astype(np.int32)}]),
        prec="bfloat16")
    for r in ranks:
        first, last = r["metrics"][0], r["metrics"][-1]
        assert first["loss"] == pytest.approx(metrics[0]["loss"], rel=1e-4)
        assert last["loss"] < first["loss"] * 0.2, (first, last)
        assert last["accuracy"] > 0.95, last
        assert r["metrics"] == ranks[0]["metrics"]


def _pipe_stages(s, d, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32),
             "b": (rng.normal(size=(d,)) * .1).astype(np.float32)}
            for _ in range(s)]


def _pipe_case(s, m, seed, b=4, d=8):
    xs = np.random.default_rng(seed + 1).normal(size=(m, b, d)).astype(
        np.float32)
    return dict(fn="pipeline", spec=dict(data=1, pipe=s),
                stages=_pipe_stages(s, d, seed), xs=xs)


_dnn_case(8, "pipe")(lambda work: _pipe_case(8, 16, 0))
_dnn_case(8, "pipe_few")(lambda work: _pipe_case(8, 3, 4, b=2))
_dnn_case(2, "pipe")(lambda work: _pipe_case(2, 5, 6))


@pytest.mark.parametrize("world,name", [(8, "pipe"), (8, "pipe_few"),
                                        (2, "pipe")])
def test_pipeline_matches_sequential_with_grads(world, name, request):
    """The GPipe schedule over ``pipe`` against the stages applied in turn
    (1e-5, ``tests/test_parallel_pp_ep.py:51``, and with fewer microbatches
    than stages, ``:126``) on every rank, and the reference's
    ``pipeline_apply`` under ``shard_map``; each rank's stage gradients of
    sum(y * y), through the shifts' backward, against autograd of the
    sequential stages (``:65``: finite and non-zero for every stage)."""
    from jax.sharding import PartitionSpec as P

    from mmlspark_tpu.parallel.mesh import MeshSpec as RefMeshSpec
    from mmlspark_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from mmlspark_tpu.parallel.pipeline_parallel import (
        pipeline_apply as ref_pipeline_apply)
    from mmlspark_tpu.parallel.pipeline_parallel import (
        stack_stage_params as ref_stack)

    case, ranks = _ranks_of(request.getfixturevalue(f"dnn_mesh{world}"), name)
    stages = [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
              for p in case["stages"]]
    h = torch.from_numpy(case["xs"])
    for p in stages:
        h = torch.tanh(h @ p["w"] + p["b"])
    grads = torch.autograd.grad((h * h).sum(), [p[k] for p in stages
                                                for k in ("w", "b")])
    mesh = ref_make_mesh(RefMeshSpec(data=1, pipe=world),
                         device_list=jax.devices()[:world])
    f = jax.jit(jax.shard_map(
        lambda p, x: ref_pipeline_apply(lambda q, y: jnp.tanh(
            y @ q["w"] + q["b"]), p, x, "pipe", world),
        mesh=mesh, in_specs=(P("pipe"), P()), out_specs=P()))
    ref = np.asarray(f(ref_stack([jax.tree.map(jnp.asarray, p)
                                  for p in case["stages"]]),
                       jnp.asarray(case["xs"])))
    for r in ranks:
        np.testing.assert_allclose(r["y"], h.detach().numpy(), atol=PIPE_ATOL)
        np.testing.assert_allclose(r["y"], ref, atol=PIPE_ATOL)
        s = r["stage"]
        for k, g in zip(("w", "b"), grads[2 * s:2 * s + 2]):
            assert np.isfinite(r["grads"][k]).all()
            assert np.abs(r["grads"][k]).max() > 0
            np.testing.assert_allclose(r["grads"][k], g.numpy(),
                                       atol=MESH_GRAD_ATOL)
    assert sorted(r["stage"] for r in ranks) == list(range(world))


@_dnn_case(8, "pipe_blocks")
def _build_pipe_blocks(work):
    per_stage = []
    with ref_module.matmul_precision("float32"):
        for i in range(8):
            p, _ = ref_attention.transformer_block(16, 2).init(
                jax.random.key(i), (4, 16))
            per_stage.append(_np_tree(p))
    xs = np.random.default_rng(9).normal(size=(4, 2, 4, 16)).astype(
        np.float32)
    return dict(fn="pipe_blocks", spec=dict(data=1, pipe=8), dim=16, heads=2,
                in_shape=(4, 16), stages=per_stage, xs=xs)


def test_pipeline_of_transformer_blocks(dnn_mesh8):
    """8 transformer blocks, one a stage, through the pipeline against the
    reference's blocks applied in turn, 1e-4
    (``tests/test_parallel_pp_ep.py:88``)."""
    case, ranks = _ranks_of(dnn_mesh8, "pipe_blocks")
    block = ref_attention.transformer_block(16, 2)
    want = []
    with ref_module.matmul_precision("float32"):
        for m in range(case["xs"].shape[0]):
            h = jnp.asarray(case["xs"][m])
            for p in case["stages"]:
                h = block.apply(jax.tree.map(jnp.asarray, p), h)
            want.append(np.asarray(h))
    for r in ranks:
        np.testing.assert_allclose(r["y"], np.stack(want),
                                   atol=PIPE_BLOCKS_ATOL)


def _moe_case(block):
    with ref_module.matmul_precision("float32"):
        if block:
            mod = ref_attention.transformer_block(16, 2, moe_experts=8,
                                                  moe_capacity_factor=2.0)
            params, _ = mod.init(jax.random.key(0), (12, 16))
            x = np.random.default_rng(4).normal(size=(2, 12, 16))
        else:
            mod = ref_moe.MoE(num_experts=8, capacity_factor=2.0)
            params, _ = mod.init(jax.random.key(1), (32, 16))
            x = np.random.default_rng(1).normal(size=(2, 32, 16))
    return dict(fn="moe", spec=dict(data=1, expert=8), block=block, dim=16,
                experts=8, cf=2.0, in_shape=tuple(x.shape[1:]),
                params=_np_tree(params), x=x.astype(np.float32))


_dnn_case(8, "moe")(lambda work: _moe_case(False))
_dnn_case(8, "moe_block")(lambda work: _moe_case(True))


@pytest.mark.parametrize("name", ["moe", "moe_block"])
def test_moe_expert_sharded_matches_single_device(dnn_mesh8, name):
    """The switch MoE (and a transformer block with it) with its experts
    split one a rank over ``expert=8`` against the reference's
    single-device forward, 1e-5 (``tests/test_parallel_pp_ep.py:152,
    169``); each rank holds one expert's ``w1``."""
    case, ranks = _ranks_of(dnn_mesh8, name)
    with ref_module.matmul_precision("float32"):
        if case["block"]:
            mod = ref_attention.transformer_block(16, 2, moe_experts=8,
                                                  moe_capacity_factor=2.0)
        else:
            mod = ref_moe.MoE(num_experts=8, capacity_factor=2.0)
        want = np.asarray(jax.jit(mod.apply)(
            jax.tree.map(jnp.asarray, case["params"]), jnp.asarray(case["x"])))
    for r in ranks:
        assert r["w1"][0] == 1
        np.testing.assert_allclose(r["y"], want, atol=MOE_MESH_ATOL)


def _encoder_case(spec, f32, steps=3):
    ref = ref_attention.transformer_encoder(**ENC, seed=0)
    params = _np_params(jax.tree.map(np.asarray, ref.params),
                        np.random.default_rng(0))
    rng = np.random.default_rng(1)
    trace = jax.tree.map(lambda a: (0.01 * rng.standard_normal(a.shape))
                         .astype(np.float32), params)
    return dict(fn="encoder_step", spec=spec, enc=ENC, f32=f32,
                opt=TRAIN_OPT, params=params, trace=trace,
                batches=_train_batches(steps, rows=4))


_dnn_case(4, "encoder_f32")(lambda work: _encoder_case(dict(fsdp=2, tensor=2),
                                                        True))
_dnn_case(4, "encoder_bf16")(lambda work: _encoder_case(
    dict(fsdp=2, tensor=2), False))
_dnn_case(2, "encoder_f32")(lambda work: _encoder_case(dict(tensor=2), True))


@pytest.mark.parametrize("world,name", [(4, "encoder_f32"),
                                        (4, "encoder_bf16"),
                                        (2, "encoder_f32")])
def test_encoder_train_step_splits_heads_over_tensor(world, name, request):
    """Three masked per-token steps of the encoder on fsdp=2 x tensor=2
    (and on tensor=2 alone): each rank holds half the heads' q/k/v columns
    (and half the rows of a kernel under fsdp), and the loss and the
    params and traces after every step match the reference's
    single-device steps from the same params, trace and batches: f32 at
    the mesh test's tolerances; the bf16 default at DEEP_BF16_TOL of each
    leaf's max |value|, as ``test_train_step_matches_reference``."""
    case, ranks = _ranks_of(request.getfixturevalue(f"dnn_mesh{world}"), name)
    ref = ref_attention.transformer_encoder(**ENC, seed=0)
    opt = ref_training.make_optimizer(**TRAIN_OPT)
    st = ref_training.TrainState(
        jax.tree.map(jnp.asarray, case["params"]),
        _with_trace(opt.init(case["params"]),
                    jax.tree.map(jnp.asarray, case["trace"])), np.int32(0))
    step = jax.jit(ref_training.make_train_step(ref.module, opt))
    fsdp = case["spec"].get("fsdp", 1)
    prec = "float32" if case["f32"] else "bfloat16"
    for i, b in enumerate(case["batches"]):
        with ref_module.matmul_precision(prec):
            st, m = step(st, dict(b))
        for r in ranks:
            assert r["blocks"]["wq"] == (ENC["dim"] // fsdp, ENC["dim"] // 2)
            assert r["blocks"]["fc1"] == (ENC["dim"] // fsdp, ENC["dim"] * 2)
            got = r["metrics"][i]
            if case["f32"]:
                assert got["loss"] == pytest.approx(float(m["loss"]),
                                                    abs=MESH_LOSS_ATOL)
                assert got["accuracy"] == pytest.approx(
                    float(m["accuracy"]), abs=MESH_ACC_ATOL)
                _assert_mesh_params(r["params"][i], st.params, f"params {i}")
                _assert_mesh_params(r["trace"][i], _find_trace(st.opt_state),
                                    f"trace {i}")
            else:
                assert abs(got["loss"] - float(m["loss"])) <= \
                    DEEP_BF16_TOL * abs(float(m["loss"]))
                _assert_tree_close(r["params"][i], st.params, DEEP_BF16_TOL,
                                   f"params {i}")
    assert all(r["collectives"] == ranks[0]["collectives"] > 0
               for r in ranks)


@_dnn_case(4, "resume")
def _build_resume(work):
    case = _encoder_case(dict(data=2, tensor=2), True, steps=4)
    return dict(case, fn="resume", path=str(work / "loop_ckpt"), stop=2)


def test_mesh_train_loop_resume_matches_uninterrupted(dnn_mesh4):
    """``run_train_loop`` on data=2 x tensor=2: preempted after 2 of 4
    steps (the state gathered and written by rank 0), then resumed from
    the checkpoint onto the mesh, gives the uninterrupted run's params and
    trace bit for bit on every rank."""
    case, ranks = _ranks_of(dnn_mesh4, "resume")
    assert os.path.exists(case["path"])
    for r in ranks:
        assert r["runs"] == (2, True, 2, 4)
        assert np.isfinite(r["loss"])
        for a, b in zip(r["full"], r["rest"]):
            for (n, x), (_, y) in zip(_leaves(a), _leaves(b)):
                np.testing.assert_array_equal(x, y, err_msg=n)


@_dnn_case(4, "collectives")
def _build_collectives(work):
    return dict(fn="collectives", spec=dict(data=2, tensor=2))


def test_mesh_collectives_and_their_backwards(dnn_mesh4):
    """Each differentiable collective on data=2 x tensor=2, on every axis,
    the batch group and the world: the all-gather's forward and its
    backward (the reduce-scatter of the cotangent), the reduce-scatter,
    the all-reduce and its backward (the sum of every rank's cotangent),
    the ring shift and its backward (the reverse shift), and a bf16
    gather's bits."""
    case, ranks = _ranks_of(dnn_mesh4, "collectives")
    x0 = np.arange(6, dtype=np.float64).reshape(2, 3)
    for axis in ("data", "tensor", "batch", "world"):
        per = {r[axis]["me"]: r[axis] for r in ranks}
        n = ranks[0][axis]["n"]
        for me, r in per.items():
            xs = [x0 * (i + 1) for i in range(n)]
            np.testing.assert_array_equal(r["g"], np.concatenate(xs, 1))
            w = np.arange(2 * 3 * n, dtype=np.float64).reshape(2, 3 * n)
            np.testing.assert_array_equal(r["gx"], n * w[:, 3 * me:3 * me + 3])
            np.testing.assert_array_equal(r["r"], sum(xs))
            np.testing.assert_array_equal(r["a"], sum(xs))
            np.testing.assert_array_equal(
                r["ga"], np.full((2, 3), sum(i + 2 for i in range(n)),
                                 np.float64))
            np.testing.assert_array_equal(r["s"], xs[(me - 1) % n])
            np.testing.assert_array_equal(r["gs"], np.full(
                (2, 3), (me + 1) % n + 3, np.float64))
            np.testing.assert_array_equal(r["h"], np.concatenate(xs, 0))

# ------------------------------------------- the fusion planner over a mesh
#
# parallel/shardplan.py and parallel/pipeplan.py run SPMD: one gloo rank a
# process on the CPU (``parallel.launch.spawn``, one launch of 4 ranks runs
# every case of ``_FUSION_RANKS``; a case's failure comes back as its
# traceback). This process builds the inputs with the reference and holds
# the ranks' outputs to the port's own unsharded output (the reference's
# gate, ``__graft_entry__.py:166``: sharded within SHARD_ATOL = 1e-5 of
# unsharded; pipelined bitwise) and to the reference's sharded output on 4
# of the conftest's 8 CPU devices, at each stage's parity tolerance in this
# file (F32_TOL for the image chain, PORT_VS_REF_ATOL for the forest,
# DEEP_BF16_TOL for the default-precision encoder). The host-side planning
# (candidates, the pipeline view, stage balance, the plan's gates) runs in
# this process on meshes described by hand, beside the reference's.

import functools  # noqa: E402

from mmlspark_tpu_torch.core.fusion import HostStage  # noqa: E402

SHARD_ATOL = 1e-5

_FUSION_RANKS = r'''
"""One rank of the fusion mesh cases (imports only the port)."""
import functools
import traceback

import numpy as np
import torch


def _sub(mesh, members, **spec):
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, sub_mesh

    return sub_mesh(mesh, members, MeshSpec(**spec))


def _image_chain(case, heads=0):
    """The reference's image chain in the port: ImageTransformer ->
    ImageFeaturizer (the small CNN) [-> DNN heads], the case's weights."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.device_stage import CompileCache
    from mmlspark_tpu_torch.core.fusion import FusedPipelineModel
    from mmlspark_tpu_torch.core.schema import ImageSchema
    from mmlspark_tpu_torch.image import ImageFeaturizer, ImageTransformer
    from mmlspark_tpu_torch.models import (Conv2D, Dense, DNNModel,
                                           FunctionModel, GlobalAvgPool,
                                           Sequential, load_jax_params)
    from mmlspark_tpu_torch.models.module import relu

    size = 16
    mod = Sequential([("conv", Conv2D(4, (3, 3))), ("act", relu()),
                      ("pool", GlobalAvgPool()), ("head", Dense(4))],
                     name="cnn")
    mod.init(torch.Generator().manual_seed(0), (size, size, 3))
    backbone = FunctionModel(mod, (size, size, 3), ["head", "pool"], "cnn")
    load_jax_params(backbone, case["cnn"])
    stages = [ImageTransformer().resize(size, size),
              ImageFeaturizer(scaleFactor=1 / 255., batchSize=case["batch"])
              .set_model(backbone)]
    dims = [(4, "features", "emb", [8, 3]), (3, "emb", "emb2", [5])]
    for i in range(heads):
        width, src, dst, outs = dims[i]
        layers = []
        for k, n in enumerate(outs):
            layers.append((f"d{k}", Dense(n)))
            if k < len(outs) - 1:
                layers.append((f"a{k}", relu()))
        head = Sequential(layers, name=f"head{i}")
        head.init(torch.Generator().manual_seed(1 + i), (width,))
        fm = FunctionModel(head, (width,), name=f"head{i}")
        load_jax_params(fm, case[f"head{i}"])
        stages.append(DNNModel(inputCol=src, outputCol=dst,
                               batchSize=case["batch"]).set_model(fm))
    obj = np.empty(len(case["images"]), dtype=object)
    for i, a in enumerate(case["images"]):
        obj[i] = ImageSchema.make(a, f"img{i}")
    df = DataFrame.from_dict({"image": obj},
                             num_partitions=case["partitions"])
    return FusedPipelineModel(stages, cache=CompileCache()), df


def _col(out, name):
    return np.stack([np.asarray(v) for v in out.column(name)])


def _label(fused):
    return next(n.label for n in fused._last_plan if hasattr(n, "dfns"))


def case_sharded_image(case, mesh):
    from mmlspark_tpu_torch.core import faults

    out = {}
    fused, df = _image_chain(case)
    out["want"] = _col(fused.transform(df), "features")
    label = _label(fused)
    fused.set_mesh(mesh)
    out["mesh_only"] = _col(fused.transform(df), "features")
    out["mesh_only_stats"] = "sharding" in fused.fusion_stats()
    fused.set_tuning(sharding={label: "data"})
    out["got"] = _col(fused.transform(df), "features")
    st = fused.fusion_stats()
    out["stats"] = {"fallbacks": st["fallbacks"], "sharding": st["sharding"],
                    "roofline": st["roofline"].get(label, {})}
    fused.set_tuning(sharding={label: ""})
    out["cleared"] = _col(fused.transform(df), "features")
    fused.set_tuning(buckets={label: [11]}, sharding={label: "data"})
    out["odd"] = _col(fused.transform(df), "features")
    out["odd_fallbacks"] = fused.fusion_stats()["fallbacks"]
    fused.set_tuning(buckets={})
    with faults.FaultInjector(seed=11).plan(
            faults.MESH_CHIP_WEDGE, every=1, exc=RuntimeError,
            message="chip wedged"):
        out["wedged"] = _col(fused.transform(df), "features")
    out["wedged_fallbacks"] = fused.fusion_stats()["fallbacks"]
    # the K-step dispatch of the submit path, sharded: K=2 groups of one
    # partition's batches, each batch's collectives after the group
    one, df1 = _image_chain(dict(case, partitions=1))
    out["submit_want"] = _col(one.transform_submit(df1)(), "features")
    one.set_mesh(mesh)
    one.set_tuning(mega_k={label: 2}, sharding={label: "data"})
    out["submit_mega"] = _col(one.transform_submit(df1)(), "features")
    out["submit_fallbacks"] = one.fusion_stats()["fallbacks"]
    return out


def run(mesh, cases):
    out = {}
    for name, case in cases.items():
        try:
            out[name] = globals()["case_" + case["fn"]](case, mesh)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


def _mesh(**spec):
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(**spec), device="cpu", backend="gloo")


def _pipe_families(fused):
    from mmlspark_tpu_torch.obs.bridge import _fusion_families

    return [f.name for f in _fusion_families(fused.fusion_stats())
            if f.name.startswith("mmlspark_pipe_")]


def case_pipe_image(case, mesh):
    """The image chain with one or two DNN heads pipelined (data 2 x pipe 2,
    or pipe 3 on ranks 0-2 with rank 3 outside) against the serial fused
    chain on the same rank."""
    out = {}
    heads = case.get("heads", 1)
    name = "emb" if heads == 1 else "emb2"
    fused, df = _image_chain(case, heads=heads)
    out["want"] = _col(fused.transform(df), name)
    out["want_features"] = _col(fused.transform(df), "features")
    if heads == 1:
        pm = _mesh(data=2, pipe=2)
    else:
        pm = _sub(mesh, [0, 1, 2], pipe=3)
    fused.set_mesh(pm)
    fused.set_tuning(pipe_depth=heads + 1)
    got = fused.transform(df)
    out["got"] = _col(got, name)
    out["got_features"] = _col(got, "features")
    st = fused.fusion_stats()
    out["pipeline"] = st.get("pipeline")
    out["fallbacks"] = st["fallbacks"]
    out["families"] = _pipe_families(fused)
    if out["pipeline"]:
        from mmlspark_tpu_torch.obs.bridge import _fusion_families

        fams = {f.name: f for f in _fusion_families(st)}
        out["busy_stages"] = [s.labels.get("stage") for s in
                              fams["mmlspark_pipe_stage_busy_ratio"].samples]
    fused.set_tuning(pipe_depth=1)
    out["off"] = bool(np.array_equal(_col(fused.transform(df), name),
                                     out["want"]))
    out["off_families"] = _pipe_families(fused)
    out["off_stats"] = "pipeline" in fused.fusion_stats()
    return out


def _gbdt(case):
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.device_stage import CompileCache
    from mmlspark_tpu_torch.core.fusion import FusedPipelineModel
    from mmlspark_tpu_torch.gbdt import convert, stages

    model = stages.LightGBMClassificationModel(
        booster=convert.booster_from_reference(case["booster"]),
        featuresCol="features")
    X = case["X"]
    rows = np.empty(len(X), dtype=object)
    for i, r in enumerate(X):
        rows[i] = r
    df = DataFrame.from_dict({"features": rows},
                             num_partitions=case["partitions"])
    return FusedPipelineModel([model], cache=CompileCache()), df


def _encoder(case):
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.device_stage import CompileCache
    from mmlspark_tpu_torch.core.fusion import FusedPipelineModel
    from mmlspark_tpu_torch.models import (DNNModel, load_jax_params,
                                           transformer_encoder)

    enc = transformer_encoder(**case["spec"])
    load_jax_params(enc, case["params"])
    stage = DNNModel(inputCol="tokens", outputCol="emb",
                     batchSize=case["batch"]).set_model(enc)
    df = DataFrame.from_dict({"tokens": list(case["ids"])},
                             num_partitions=case["partitions"])
    return FusedPipelineModel([stage], cache=CompileCache()), df


def _outputs(out, cols):
    return {c: _col(out, c) if out.column(c).dtype == object
            else np.asarray(out.column(c), dtype=np.float64) for c in cols}


def case_sharded_stage(case, mesh):
    """One stage's segment unsharded, data-sharded over the world mesh and
    feature-sharded over data 2 x tensor 2."""
    build = {"gbdt": _gbdt, "encoder": _encoder}[case["stage"]]
    cols = case["cols"]
    fused, df = build(case)
    out = {"want": _outputs(fused.transform(df), cols)}
    label = _label(fused)
    fused.set_mesh(mesh)
    fused.set_tuning(sharding={label: "data"})
    out["data"] = _outputs(fused.transform(df), cols)
    out["data_stats"] = fused.fusion_stats()["sharding"]
    out["data_fallbacks"] = fused.fusion_stats()["fallbacks"]
    fused.set_mesh(_mesh(data=2, tensor=2))
    fused.set_tuning(sharding={label: "feature"})
    out["feature"] = _outputs(fused.transform(df), cols)
    out["feature_stats"] = fused.fusion_stats()["sharding"]
    out["feature_fallbacks"] = fused.fusion_stats()["fallbacks"]
    return out


def _forced(rank, **choose):
    """A cost model that wants the mesh knob on rank 0 alone: every other
    rank's own proposal leaves it out, so the ranks agree only through the
    Tuner taking the first rank's decisions. Its other decisions are the
    real ones, over each rank's own measurements."""
    from mmlspark_tpu_torch.core.costmodel import SegmentCostModel

    class Forced(SegmentCostModel):
        def choose_sharding(self, segment, batch, candidates, margin=0.95):
            names = [c["name"] for c in candidates]
            want = choose.get("sharding") if rank == 0 else None
            return want if want in names else None

        def choose_pipe_depth(self, chain_labels, batch, max_depth, **kw):
            d = choose.get("pipe_depth") if rank == 0 else None
            return d if d and max_depth >= d and len(chain_labels) >= 2 \
                else None

    return Forced(peaks={"flops": 1e9, "bytes_per_s": 1e9,
                         "peak_source": "test"}, min_obs=2)


def _timing(compute_ms=2.0, rows=8):
    from mmlspark_tpu_torch.parallel.ingest import BatchTiming

    return BatchTiming(compute_s=compute_ms / 1e3, h2d_s=5e-4, rows=rows,
                       padded_rows=rows)


def _measures(rank, others):
    """A ``measure`` for ``Tuner.tune``: 100.0 at every call on rank 0, the
    values of ``others`` in turn (then 100.0) on every other rank, so that
    alone they would judge a step the other way."""
    seq = iter(others)
    return lambda: 100.0 if rank == 0 else next(seq, 100.0)


def case_tuner(case, mesh):
    """The Tuner's sharding (or pipe_depth) knob: proposed, applied and
    journaled, then rolled back on an injected regression to the bitwise
    serial path. Only rank 0's cost model wants the knob, each rank folds
    its own (different) timings, and the other ranks measure the steps
    the other way: every rank must still take the same decisions."""
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.core.tune import KnobSet, Tuner

    knob = case["knob"]
    rank = mesh.rank
    out = {}
    fused, df = _image_chain(case, heads=1 if knob == "pipe_depth" else 0)
    col = "emb" if knob == "pipe_depth" else "features"
    want = _col(fused.transform(df), col)
    label = _label(fused)
    if knob == "pipe_depth":
        fused.set_mesh(_mesh(data=2, pipe=2))
        model = _forced(rank, pipe_depth=2)
    else:
        fused.set_mesh(mesh)
        model = _forced(rank, sharding="data")
        for _ in range(3):
            model.observe_batch(label, _timing(compute_ms=2.0 + 3.0 * rank,
                                               rows=8 * (1 + rank)))
    t = Tuner(fused=fused, model=model)
    knobs = t.propose()
    out["proposed"] = knobs.to_dict()
    out["round_trip"] = KnobSet.from_dict(knobs.to_dict()).to_dict()
    # ranks 1-3 alone would roll this step back (100 -> 10)
    result = t.tune(_measures(rank, [100.0, 10.0]), steps=1, warmup=0)
    out["rollbacks_1"] = result["rollbacks"]
    out["applied"] = [e["knobs"] for e in t.journal if e["action"] == "apply"]
    out["overrides"] = (dict(fused._sharding_overrides), fused._pipe_depth)
    got = _col(fused.transform(df), col)
    out["applied_err"] = float(np.abs(got - want).max())
    st = fused.fusion_stats()
    out["applied_pipeline"] = (st.get("pipeline") or {}).get("depth")
    out["applied_sharding"] = st.get("sharding")
    t2 = Tuner(fused=fused, model=model, tolerance=0.05)
    fused.set_tuning(sharding={}, pipe_depth=1)
    # ranks 1-3 alone would keep this step (100 -> 1000 / 1.2)
    with faults.FaultInjector(seed=3).plan(
            faults.TUNER_MEASURE, at=(2,), delay_s=0.2, exc=None):
        result = t2.tune(_measures(rank, [100.0, 1000.0]), steps=3,
                         warmup=0)
    out["journal"] = [{k: v for k, v in e.items()}
                      for e in t.journal + t2.journal]
    out["rollbacks"] = t2.rollbacks
    out["step1_accepted"] = result["steps"][1]["accepted"]
    out["final_default"] = KnobSet.from_dict(result["final_knobs"]).is_default()
    out["journal_rollback"] = any(e["action"].startswith("rollback")
                                  for e in t2.journal)
    out["after"] = (dict(fused._sharding_overrides), fused._pipe_depth)
    out["bitwise"] = bool(np.array_equal(_col(fused.transform(df), col),
                                         want))
    out["after_stats"] = sorted(k for k in fused.fusion_stats()
                                if k in ("pipeline", "sharding"))
    return out


def case_rank_faults(case, mesh):
    """A failure on one rank alone, at each step the ranks must agree on,
    turns into the same path on every rank and hangs none: resolving the
    spec (rank 1 raises: every rank unsharded), building the sharded
    program (rank 2 demotes it: every rank's host fallback; rank 3 raises:
    every rank raises), resolving the pipe plan (rank 1 raises: every rank
    serial), handing the placed plan to the supervisor (rank 2's hook
    raises: every rank serial) and forming a pipe stage's sub-mesh groups
    (rank 1 fails to prepare its group, or never arrives at it: every rank
    serial, its stage partner told at once or after ``FORM_TIMEOUT_S``,
    lowered to 5 s here)."""
    import time

    import torch.distributed as dist

    from mmlspark_tpu_torch.core.device_stage import FusionUnsupported
    from mmlspark_tpu_torch.core.fusion import SegmentExecutor
    from mmlspark_tpu_torch.parallel import mesh as pm
    from mmlspark_tpu_torch.parallel import pipeplan, shardplan

    rank = mesh.rank
    out = {}

    def once(patches, build, knobs, col, pipe_mesh=None, supervisor=None):
        fused, df = build()
        want = _col(fused.transform(df), col)
        fused.set_mesh(pipe_mesh or mesh)
        if supervisor is not None:
            pipeplan.PipeSupervision(fused, pipe_mesh, supervisor=supervisor)
        fused.set_tuning(**{k: (v if k == "pipe_depth" else
                                {_label(fused): v})
                            for k, v in knobs.items()})
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
        try:
            for obj, name, fn in patches:
                setattr(obj, name, fn)
            t0 = time.perf_counter()
            try:
                got = _col(fused.transform(df), col)
                res = {"err": float(np.abs(got - want).max()),
                       "bitwise": bool(np.array_equal(got, want))}
            except Exception as e:  # noqa: BLE001 — the case's outcome
                res = {"raised": type(e).__name__, "message": str(e)}
            res["seconds"] = time.perf_counter() - t0
        finally:
            for obj, name, fn in saved:
                setattr(obj, name, fn)
        st = fused.fusion_stats()
        res.update(fallbacks=st["fallbacks"], sharded="sharding" in st,
                   pipelined="pipeline" in st)
        return res

    def fail(*a, **k):
        raise RuntimeError(f"rank {rank}: injected failure")

    def demote(*a, **k):
        raise FusionUnsupported(f"rank {rank}: injected build failure")

    class Supervisor:
        def set_pipe_stages(self, groups):
            if rank == 2:
                fail()

    def absent(ranks, r, backend):
        # a member that counts the group, then never posts (a crash there)
        pm._MEMBER_GROUPS[ranks] = pm._MEMBER_GROUPS.get(ranks, 0) + 1
        raise RuntimeError(f"rank {rank}: injected absence")

    image = functools.partial(_image_chain, case)
    chain = functools.partial(_image_chain, case, heads=1)
    out["resolve"] = once(
        [(shardplan, "sharding_for", fail)] if rank == 1 else [],
        image, {"sharding": "data"}, "features")
    out["build_demoted"] = once(
        [(SegmentExecutor, "_build", demote)] if rank == 2 else [],
        image, {"sharding": "data"}, "features")
    out["build_raised"] = once(
        [(SegmentExecutor, "_build", fail)] if rank == 3 else [],
        image, {"sharding": "data"}, "features")
    out["pipe_run"] = once(
        [(pipeplan, "pipe_run", fail)] if rank == 1 else [],
        chain, {"pipe_depth": 2}, "emb", _mesh(data=2, pipe=2))
    out["pipe_hook"] = once([], chain, {"pipe_depth": 2}, "emb",
                            _mesh(data=2, pipe=2), supervisor=Supervisor())
    out["group_failed"] = once(
        [(dist, "PrefixStore", fail)] if rank == 1 else [],
        chain, {"pipe_depth": 2}, "emb", _mesh(data=2, pipe=2))
    out["group_absent"] = once(
        [(pm, "FORM_TIMEOUT_S", 5.0)]
        + ([(pm, "_member_group", absent)] if rank == 1 else []),
        chain, {"pipe_depth": 2}, "emb", _mesh(data=2, pipe=2))
    return out


def case_supervision(case, mesh):
    """MeshSupervision over data 4: shard groups, a wedge of rank 0's group
    re-plans onto the three survivors (rank 0 runs unsharded), idempotent
    per group."""
    from mmlspark_tpu_torch.parallel import shardplan
    from mmlspark_tpu_torch.serving.supervisor import ReplicaSupervisor

    fused, df = _image_chain(case)
    want = _col(fused.transform(df), "features")
    label = _label(fused)
    sup = ReplicaSupervisor(4, quarantine_s=60.0)
    ms = shardplan.MeshSupervision(fused, mesh, supervisor=sup)
    out = {"attached": fused.shard_mesh is mesh,
           "groups": shardplan.shard_groups(mesh)}
    fused.set_tuning(sharding={label: "data"})
    out["before_err"] = float(np.abs(_col(fused.transform(df), "features")
                                     - want).max())
    sub = ms.on_wedge(0)
    out["sub_shape"] = dict(sub.shape)
    out["sub_ranks"] = list(sub.ranks)
    out["replans"] = ms.replans
    out["fused_mesh_is_sub"] = fused.shard_mesh is sub
    out["states"] = {r["replica"]: r["state"] for r in sup.describe()}
    got = _col(fused.transform(df), "features")
    out["after_err"] = float(np.abs(got - want).max())
    out["after_bitwise"] = bool(np.array_equal(got, want))
    out["sharding"] = fused.fusion_stats().get("sharding")
    out["fallbacks"] = fused.fusion_stats()["fallbacks"]
    out["again_same"] = ms.on_wedge(0) is sub
    out["describe"] = ms.describe()
    return out


def case_pipe_wedge(case, mesh):
    """A stage wedge under PipeSupervision: every micro-batch (depth 2 ->
    serial on the survivors) or the fifth seam of a three-stage chain
    (depth 3 -> 2), bitwise either way."""
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.parallel.pipeplan import PipeSupervision
    from mmlspark_tpu_torch.serving.supervisor import ReplicaSupervisor

    deep = case["mode"] == "mid"
    name = "emb2" if deep else "emb"
    fused, df = _image_chain(case, heads=2 if deep else 1)
    want = _col(fused.transform(df), name)
    fused2, df2 = _image_chain(case, heads=2 if deep else 1)
    pm = _sub(mesh, [0, 1, 2], pipe=3) if deep else _mesh(data=2, pipe=2)
    sup = ReplicaSupervisor(3 if deep else 4, quarantine_s=60.0)
    ps = PipeSupervision(fused2, pm, supervisor=sup)
    fused2.set_tuning(pipe_depth=3 if deep else 2)
    plan = dict(at=(5,)) if deep else dict(every=1)
    with faults.FaultInjector(seed=0).plan(
            faults.PIPE_STAGE_WEDGE, message="chaos: stage wedged",
            **plan) as inj:
        got = _col(fused2.transform(df2), name)
    return {"bitwise": bool(np.array_equal(want, got)),
            "fired": len(inj.fired(faults.PIPE_STAGE_WEDGE)),
            "pipeline": fused2.fusion_stats().get("pipeline"),
            "supervision": ps.describe(),
            "states": {r["replica"]: (r["state"], r["last_reason"])
                       for r in sup.describe()},
            "member": pm.is_member}


def case_collectives(case, mesh):
    from mmlspark_tpu_torch.core.costmodel import SegmentCostModel
    from mmlspark_tpu_torch.parallel import shardplan

    m = SegmentCostModel()
    recs = shardplan.measure_collectives(mesh, sizes=(1 << 12, 1 << 14),
                                         repeats=1, model=m)
    return {"ops": sorted({r["op"] for r in recs}),
            "nonneg": all(r["seconds"] >= 0 for r in recs),
            "calibrated": m.collective_calibrated(),
            "predict": m.collective_ms("all_reduce", 1 << 13),
            "round_trip": SegmentCostModel.from_dict(m.to_dict())
            .collective_ms("all_reduce", 1 << 13)}
'''

_FUSION_CASES = {}   # case name -> builder() -> inputs


def _fusion_case(name):
    def register(fn):
        _FUSION_CASES[name] = fn
        return fn
    return register


@pytest.fixture(scope="module")
def fusion_mesh4(tmp_path_factory):
    from mmlspark_tpu_torch.parallel.launch import spawn

    work = tmp_path_factory.mktemp("fusion_mesh4")
    (work / "fusion_ranks.py").write_text(_FUSION_RANKS)
    cases = {name: build() for name, build in _FUSION_CASES.items()}
    ranks = spawn("fusion_ranks:run", 4, work, dict(cases=cases),
                  threads=1, timeout=240, path=[str(work)])
    return cases, ranks


_FUSION_NS = {}


def _fusion_ns():
    """``_FUSION_RANKS`` as a module of this process (its chain builders)."""
    if not _FUSION_NS:
        exec(compile(_FUSION_RANKS, "fusion_ranks", "exec"), _FUSION_NS)
    return _FUSION_NS


def _ref_cnn():
    from mmlspark_tpu.models.module import (Conv2D, GlobalAvgPool, Sequential,
                                            relu)

    return Sequential([("conv", Conv2D(4, (3, 3))), ("act", relu()),
                       ("pool", GlobalAvgPool()),
                       ("head", ref_module.Dense(4))], name="cnn")


def _ref_heads():
    from mmlspark_tpu.models.module import Sequential, relu

    return [Sequential([("d0", ref_module.Dense(8)), ("a0", relu()),
                        ("d1", ref_module.Dense(3))], name="head0"),
            Sequential([("d0", ref_module.Dense(5))], name="head1")]


def _chain_inputs(rows):
    """The image chain's weights (the reference's inits) and ``rows``
    seeded 20x20 images."""
    cnn, _ = _ref_cnn().init(jax.random.PRNGKey(0), (16, 16, 3))
    out = {"cnn": _np_tree(cnn), "batch": 8, "partitions": 2}
    for i, (head, width) in enumerate(zip(_ref_heads(), (4, 3))):
        hp, _ = head.init(jax.random.PRNGKey(1 + i), (width,))
        out[f"head{i}"] = _np_tree(hp)
    rng = np.random.default_rng(4)
    out["images"] = [rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)
                     for _ in range(rows)]
    return out


def _ref_image_chain(case, heads=0):
    """The reference's fused image chain on the case's weights and rows."""
    from mmlspark_tpu.image.featurizer import ImageFeaturizer as RefFeat
    from mmlspark_tpu.image.stages import ImageTransformer as RefIT
    from mmlspark_tpu.models.module import FunctionModel as RefFM

    backbone = RefFM(_ref_cnn(), jax.tree.map(jnp.asarray, case["cnn"]),
                     (16, 16, 3), layer_names=["head", "pool"], name="cnn")
    stages = [RefIT().resize(16, 16),
              RefFeat(scaleFactor=1 / 255., batchSize=case["batch"])
              .set_model(backbone)]
    io = [(4, "features", "emb"), (3, "emb", "emb2")]
    for i, head in enumerate(_ref_heads()[:heads]):
        width, src, dst = io[i]
        fm = RefFM(head, jax.tree.map(jnp.asarray, case[f"head{i}"]),
                   (width,), name=f"head{i}")
        stages.append(RefDNNModel(inputCol=src, outputCol=dst,
                                  batchSize=case["batch"]).set_model(fm))
    obj = np.empty(len(case["images"]), dtype=object)
    for i, a in enumerate(case["images"]):
        obj[i] = RefImageSchema.make(a, f"img{i}")
    df = RefDataFrame.from_dict({"image": obj},
                                num_partitions=case["partitions"])
    return RefFused(stages, cache=RefCompileCache()), df


def _ref_mesh(**spec):
    from mmlspark_tpu.parallel.mesh import MeshSpec as RefSpec
    from mmlspark_tpu.parallel.mesh import make_mesh as ref_make

    n = int(np.prod(list(spec.values())))
    return ref_make(RefSpec(**spec), device_list=jax.devices()[:n])


def _port_mesh(**spec):
    """A port mesh described by hand (no process group): what the planners
    read of a mesh (its shape and ranks)."""
    from mmlspark_tpu_torch.parallel.mesh import Mesh, MeshSpec

    n = int(np.prod(list(spec.values())))
    return Mesh(shape=MeshSpec(**spec).resolve(n))


def _ref_col(out, name):
    return np.stack([np.asarray(v) for v in out.column(name)])


def _ref_sharded(fused, df, mesh, spec, cols):
    label = next(n.label for n in fused._last_plan if hasattr(n, "dfns"))
    fused.set_mesh(mesh)
    fused.set_tuning(sharding={label: spec})
    out = fused.transform(df)
    assert fused.fusion_stats()["fallbacks"] == []
    return {c: _column(out, c) for c in cols}


@_fusion_case("image")
def _build_image():
    return dict(_chain_inputs(22), fn="sharded_image")


@_fusion_case("pipe2")
def _build_pipe2():
    return dict(_chain_inputs(16), fn="pipe_image", heads=1)


@_fusion_case("pipe3")
def _build_pipe3():
    return dict(_chain_inputs(16), fn="pipe_image", heads=2)


@functools.lru_cache(maxsize=None)
def _gbdt_inputs():
    X = np.random.default_rng(0).normal(size=(200, 28)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 3] - X[:, 7] > 0).astype(np.float64)
    ref = ref_stages.LightGBMClassifier(numIterations=10, numLeaves=7).fit(
        RefDataFrame.from_dict({"features": _rows(X, False), "label": y}))
    return X, ref


@_fusion_case("gbdt")
def _build_gbdt():
    X, ref = _gbdt_inputs()
    return dict(fn="sharded_stage", stage="gbdt",
                booster=ref.booster.to_string(), X=X, partitions=2,
                cols=["rawPrediction", "probability", "prediction"])


_SHARD_ENC = dict(seq_len=16, dim=32, depth=2, num_heads=2, vocab_size=50)


@_fusion_case("encoder")
def _build_encoder():
    ref = ref_attention.transformer_encoder(**_SHARD_ENC, seed=0)
    return dict(fn="sharded_stage", stage="encoder", spec=_SHARD_ENC,
                params=jax.tree.map(np.asarray, ref.params),
                ids=_tokens(22, seed=2, t=16, vocab=50), batch=8,
                partitions=2, cols=["emb"])


@_fusion_case("tuner_sharding")
def _build_tuner_sharding():
    return dict(_chain_inputs(24), fn="tuner", knob="sharding")


@_fusion_case("tuner_pipe_depth")
def _build_tuner_pipe():
    return dict(_chain_inputs(16), fn="tuner", knob="pipe_depth")


@_fusion_case("rank_faults")
def _build_rank_faults():
    return dict(_chain_inputs(16), fn="rank_faults")


@_fusion_case("supervision")
def _build_supervision():
    return dict(_chain_inputs(24), fn="supervision")


@_fusion_case("wedge_full")
def _build_wedge_full():
    return dict(_chain_inputs(16), fn="pipe_wedge", mode="full")


@_fusion_case("wedge_mid")
def _build_wedge_mid():
    return dict(_chain_inputs(16), fn="pipe_wedge", mode="mid")


@_fusion_case("collectives")
def _build_fusion_collectives():
    return dict(fn="collectives")


class _FakeDfn:
    def __init__(self, in_cols, out_cols, shard_dims=None, sparse=False):
        self.in_cols = tuple(in_cols)
        self.out_cols = tuple(out_cols)
        self.shard_dims = shard_dims
        self.sparse_cols = tuple(in_cols) if sparse else ()
        self.sparse_fn = (lambda p, env: env) if sparse else None


class _FakeSegment:
    label = "Fake"

    def __init__(self, dfns, external):
        self.dfns = list(dfns)
        self.external_in_cols = list(external)


_FAKE_SEGMENTS = {
    "undeclared": ([_FakeDfn(["x"], ["y"])], ["x"]),
    "declared": ([_FakeDfn(["x"], ["y"], shard_dims={"x": 1}),
                  _FakeDfn(["y"], ["z"])], ["x"]),
    "csr_capable": ([_FakeDfn(["x"], ["y"], shard_dims={"x": 1},
                              sparse=True)], ["x"]),
    "two_inputs": ([_FakeDfn(["x", "w"], ["y"], shard_dims={"x": 1})],
                   ["x", "w"]),
}
_CAND_MESHES = [dict(data=8), dict(data=4, tensor=2), dict(data=1),
                dict(tensor=2), dict(data=2, pipe=2)]


@pytest.mark.parametrize("spec", _CAND_MESHES, ids=str)
def test_shard_candidates_equal_the_reference(spec):
    """``candidates`` / ``tuner_candidates`` give the reference's names,
    axes, shards, in_dims, out_dim and collectives for the same segments
    and mesh shapes (``tests/test_sharding.py:117-170``), and
    ``sharding_for`` resolves the same ones (none on a one-shard axis)."""
    from mmlspark_tpu.parallel import shardplan as ref_sp
    from mmlspark_tpu_torch.parallel import shardplan as sp

    port, ref = _port_mesh(**spec), _ref_mesh(**spec)
    for name, (dfns, ext) in _FAKE_SEGMENTS.items():
        seg = _FakeSegment(dfns, ext)
        got = [c.describe() for c in sp.candidates(seg, port)]
        assert got == [c.describe() for c in ref_sp.candidates(seg, ref)], name
        assert sp.tuner_candidates(seg, port) == \
            ref_sp.tuner_candidates(seg, ref), name
        for spec_name in ("data", "feature", "csr_row", "", None):
            a = sp.sharding_for(seg, port, spec_name)
            b = ref_sp.sharding_for(seg, ref, spec_name)
            assert (a is None) == (b is None), (name, spec_name)
            if a is not None:
                assert a.cache_key() == b.cache_key()
                assert a.shape_prefix() == b.shape_prefix()
                assert a.describe() == dict(b.describe(), donate=False)
    assert sp.sharding_for(_FakeSegment(*_FAKE_SEGMENTS["undeclared"]), None,
                           "data") is None


def test_real_segments_derive_the_reference_candidates(models):
    """The fused forest's segment (data, csr_row, feature) and the image
    chain's (data only: its ImageTransformer declares no feature dim)
    against the reference's segments of the same stages; the sharded
    program's keys."""
    from mmlspark_tpu.core.costmodel import bucket_of_shape
    from mmlspark_tpu.parallel import shardplan as ref_sp
    from mmlspark_tpu_torch.parallel import shardplan as sp

    port_f = _fused(models["port"]["clf"])
    ref_f = RefFused([models["ref"]["clf"]], cache=RefCompileCache())
    with use_device("cpu"):
        port_f.transform(models["dense_port"])
    ref_f.transform(models["dense_ref"])
    case = _chain_inputs(8)
    with use_device("cpu"):
        img, df = _fusion_ns()["_image_chain"](case)
        img.transform(df)
    ref_img, rdf = _ref_image_chain(case)
    ref_img.transform(rdf)
    for spec in (dict(data=8), dict(data=4, tensor=2)):
        port, ref = _port_mesh(**spec), _ref_mesh(**spec)
        for a, b in ((port_f, ref_f), (img, ref_img)):
            sa = next(n for n in a._last_plan if hasattr(n, "dfns"))
            sb = next(n for n in b._last_plan if hasattr(n, "dfns"))
            assert sa.label == sb.label
            assert [c.describe() for c in sp.candidates(sa, port)] == \
                [c.describe() for c in ref_sp.candidates(sb, ref)]
            assert sp.tuner_candidates(
                sa, port, model=costmodel.SegmentCostModel(), batch=64) == \
                ref_sp.tuner_candidates(
                    sb, ref, model=ref_costmodel.SegmentCostModel(), batch=64)
    sh = sp.sharding_for(next(n for n in img._last_plan
                              if hasattr(n, "dfns")), _port_mesh(data=8),
                         "data")
    assert sh.cache_key() == ("spec", "data", "data", 8)
    assert sh.shape_prefix() == "spec=data8;"
    assert bucket_of_shape(sh.shape_prefix() + "image=16x16x16x3:uint8") \
        is None
    assert sp.donation_supported(_port_mesh(data=8)) is False
    assert sp.mesh_topology(None) == "none"
    assert sp.mesh_topology(_port_mesh(data=8)).startswith("data=8,")


def test_split_csr_rows_and_ragged_bytes_equal_the_reference():
    from mmlspark_tpu.parallel import shardplan as ref_sp
    from mmlspark_tpu_torch.parallel import shardplan as sp

    indptr, indices, values = _csr_of(_sparse_matrix(n=37, seed=5))
    for shards in (1, 2, 3, 8):
        got = sp.split_csr_rows(indptr, indices, values, shards)
        want = ref_sp.split_csr_rows(indptr, indices, values, shards)
        assert len(got) == len(want) == shards
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    for nnz, rows in (([3, 9, 0], [4, 4, 5]), ([], None), ([0, 0], [2, 2])):
        assert sp.ragged_allgather_bytes(nnz, rows) == \
            ref_sp.ragged_allgather_bytes(nnz, rows)


def _check_ranks_agree(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        if isinstance(first, dict):
            for c in first:
                np.testing.assert_array_equal(r[key][c], first[c])
        else:
            np.testing.assert_array_equal(r[key], first)


def test_sharded_image_chain_matches_unsharded_and_the_reference(
        fusion_mesh4):
    """The image chain data-sharded over data 4 (``__graft_entry__.py:
    118-172``): within SHARD_ATOL of the port's unsharded output on every
    rank, and of the reference's sharded output within F32_TOL; a mesh
    with no knob and a cleared knob are bitwise unsharded; an 11-row
    bucket pads to a shard multiple (``tests/test_sharding.py:279-345``)."""
    case, ranks = _ranks_of(fusion_mesh4, "image")
    ref, rdf = _ref_image_chain(case)
    ref_want = _ref_col(ref.transform(rdf), "features")
    ref_got = _ref_sharded(ref, rdf, _ref_mesh(data=4), "data",
                           ["features"])["features"]
    label = "ImageTransformer+ImageFeaturizer"
    for r in ranks:
        np.testing.assert_allclose(r["got"], r["want"], atol=SHARD_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(r["got"], ref_got, atol=F32_TOL, rtol=0)
        np.testing.assert_allclose(r["want"], ref_want, atol=F32_TOL, rtol=0)
        np.testing.assert_array_equal(r["mesh_only"], r["want"])
        assert r["mesh_only_stats"] is False
        np.testing.assert_array_equal(r["cleared"], r["want"])
        np.testing.assert_allclose(r["odd"], r["want"], atol=SHARD_ATOL,
                                   rtol=0)
        assert r["odd_fallbacks"] == [] and r["stats"]["fallbacks"] == []
        seg = r["stats"]["sharding"]["segments"][label]
        assert seg["spec"] == "data" and seg["shards"] == 4
        assert r["stats"]["sharding"]["mesh"].startswith("data=4,")
        roof = r["stats"]["roofline"]
        assert roof["spec"] == "data" and roof["shards"] == 4
        assert roof["peak_source"].endswith("x4")
    _check_ranks_agree(ranks, "got")


def test_chip_wedge_falls_back_on_every_rank_and_stays_correct(
        fusion_mesh4):
    """An armed ``mesh.chip_wedge`` fails every sharded staging: every rank
    agrees, runs the partition's host fallback and books it; the answer
    stays right (``tests/test_sharding.py:330-345``)."""
    _, ranks = _ranks_of(fusion_mesh4, "image")
    for r in ranks:
        np.testing.assert_allclose(r["wedged"], r["want"], atol=SHARD_ATOL,
                                   rtol=0)
        fb = r["wedged_fallbacks"]
        assert len(fb) == 2 and all("mesh stage failure" in f for f in fb)


def test_sharded_mega_dispatch_matches_unsharded(fusion_mesh4):
    """The submit path's K-step dispatch under the ``data`` spec (K = 2
    over one partition's three batches): each group's compute in one call,
    its batches' agreement and gathers after it, within SHARD_ATOL of the
    unsharded submit on every rank."""
    _, ranks = _ranks_of(fusion_mesh4, "image")
    for r in ranks:
        assert r["submit_fallbacks"] == []
        np.testing.assert_allclose(r["submit_mega"], r["submit_want"],
                                   atol=SHARD_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["gbdt", "encoder"])
def test_sharded_segments_data_and_feature_specs(fusion_mesh4, name):
    """A dense forest segment and a small encoder DNNModel under ``data``
    over data 4 and ``feature`` over data 2 x tensor 2: within SHARD_ATOL
    of the unsharded output, and of the reference's sharded output at the
    stage's tolerance."""
    case, ranks = _ranks_of(fusion_mesh4, name)
    if name == "gbdt":
        X, ref_model = _gbdt_inputs()
        tol = PORT_VS_REF_ATOL
        ref_df = RefDataFrame.from_dict({"features": _rows(X, False)},
                                        num_partitions=2)

        def ref_fused():
            return RefFused([ref_model], cache=RefCompileCache())
    else:
        tol = DEEP_BF16_TOL
        ref_enc = ref_attention.transformer_encoder(**_SHARD_ENC, seed=0)
        ref_df = RefDataFrame.from_dict({"tokens": list(case["ids"])},
                                        num_partitions=2)

        def ref_fused():
            st = RefDNNModel(inputCol="tokens", outputCol="emb",
                             batchSize=8).set_model(ref_enc)
            return RefFused([st], cache=RefCompileCache())
    want = {}
    for spec, mesh in (("data", dict(data=4)),
                       ("feature", dict(data=2, tensor=2))):
        fused = ref_fused()
        fused.transform(ref_df)
        want[spec] = _ref_sharded(fused, ref_df, _ref_mesh(**mesh), spec,
                                  case["cols"])
    for r in ranks:
        assert r["data_fallbacks"] == [] and r["feature_fallbacks"] == []
        assert r["feature_stats"]["mesh"].startswith("data=2,fsdp=1,tensor=2")
        for spec in ("data", "feature"):
            for c in case["cols"]:
                np.testing.assert_allclose(r[spec][c], r["want"][c],
                                           atol=SHARD_ATOL, rtol=0,
                                           err_msg=f"{spec} {c}")
                np.testing.assert_allclose(r[spec][c], want[spec][c],
                                           atol=tol, rtol=0,
                                           err_msg=f"{spec} {c} vs ref")
    _check_ranks_agree(ranks, "data")


def test_pipeline_view_balance_and_plan_gates_equal_the_reference():
    """``split_segments``/``chainable``/``chainable_runs``, ``balance_stages``,
    ``pipe_submeshes`` and ``build_pipe_plan``'s gates give the reference's
    answers (``tests/test_pipeline_mesh.py:121-240``) on the same chains and
    mesh shapes; stage placements are keyed apart."""
    from mmlspark_tpu.parallel import pipeplan as ref_pp
    from mmlspark_tpu_torch.parallel import pipeplan as pp

    for heads in (1, 2):
        case = _chain_inputs(8)
        with use_device("cpu"):
            fused, df = _fusion_ns()["_image_chain"](case, heads=heads)
            fused.transform(df)
        ref, rdf = _ref_image_chain(case, heads=heads)
        ref.transform(rdf)
        nodes, rnodes = fused._last_plan, ref._last_plan
        assert [type(n).__name__ for n in nodes] == ["Segment"]
        view, rview = pp.split_segments(nodes), ref_pp.split_segments(rnodes)
        assert [n.label for n in view] == [n.label for n in rview]
        assert len(view) == heads + 1
        assert [pp.chainable(a, b) for a, b in zip(view, view[1:])] == \
            [ref_pp.chainable(a, b) for a, b in zip(rview, rview[1:])]
        assert [[j for j, _ in run] for run in pp.chainable_runs(view)] == \
            [[j for j, _ in run] for run in ref_pp.chainable_runs(rview)]
        assert pp.chainable_runs(nodes) == []
        host = HostStage(nodes[0].stages[0])
        assert pp.split_segments([host])[0] is host
        assert pp.split_segments([view[-1]]) == [view[-1]]
        for spec, depth in ((dict(data=2, pipe=2), 2), (dict(pipe=3), 3),
                            (dict(data=4), 2), (dict(data=2, pipe=2), 1),
                            (dict(pipe=4), 2)):
            a = pp.build_pipe_plan(nodes, _port_mesh(**spec), depth)
            b = ref_pp.build_pipe_plan(rnodes, _ref_mesh(**spec), depth)
            assert (a is None) == (b is None), (spec, depth)
            if a is not None:
                assert (a.depth, a.first, a.last) == (b.depth, b.first,
                                                      b.last)
                assert [st.labels for st in a.stages] == \
                    [st.labels for st in b.stages]
                assert [st.device_ids() for st in a.stages] == \
                    [st.device_ids() for st in b.stages]
                assert len(a.nodes) == len(b.nodes)
    assert pp.build_pipe_plan(nodes, None, 2) is None
    for costs, depth in (([None, None, None], 2), ([1.0, None], 2),
                         ([4.0, 1.0, 1.0], 2), ([1.0, 1.0, 4.0], 2),
                         ([1.0] * 4, 5), ([3.0, 1.0, 2.0, 2.0], 3)):
        assert pp.balance_stages(costs, depth) == \
            ref_pp.balance_stages(costs, depth)
    for spec, depth in ((dict(data=4), 2), (dict(data=2, pipe=2), 1),
                        (dict(data=2, pipe=2), 3)):
        assert pp.pipe_submeshes(_port_mesh(**spec), depth) is None
    subs = pp.pipe_submeshes(_port_mesh(data=2, pipe=2), 2)
    assert [list(s.ranks) for s in subs] == [[0, 2], [1, 3]]
    assert all(s.shape["data"] == 2 and s.shape["pipe"] == 1 for s in subs)
    a = pp.PipeStageSharding(None, subs[0], 0, 2)
    b = pp.PipeStageSharding(None, subs[1], 1, 2)
    assert a.cache_key() != b.cache_key()
    assert a.shape_prefix() == "pipe=s0of2;" and not a.splits


@pytest.mark.parametrize("name", ["pipe2", "pipe3"])
def test_pipelined_chain_is_bitwise_the_serial_chain(fusion_mesh4, name):
    """The image chain with one DNN head streamed over data 2 x pipe 2, and
    with two heads over pipe 3 on ranks 0-2 (rank 3, outside the mesh,
    runs serially): every rank's output bitwise the serial fused chain's,
    whose output is the reference's within F32_TOL; the pipe metric
    families exist only while the plan is active
    (``tests/test_pipeline_mesh.py:300-345``)."""
    case, ranks = _ranks_of(fusion_mesh4, name)
    heads = case["heads"]
    col = "emb" if heads == 1 else "emb2"
    ref, rdf = _ref_image_chain(case, heads=heads)
    ref_want = _ref_col(ref.transform(rdf), col)
    families = ["mmlspark_pipe_depth", "mmlspark_pipe_bubble_ratio",
                "mmlspark_pipe_stage_busy_ratio",
                "mmlspark_pipe_handoff_bytes_total",
                "mmlspark_pipe_stage_requeues_total"]
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["got"], r["want"])
        np.testing.assert_array_equal(r["got_features"], r["want_features"])
        np.testing.assert_allclose(r["want"], ref_want, atol=F32_TOL, rtol=0)
        assert r["fallbacks"] == [] and r["off"] and not r["off_stats"]
        assert r["off_families"] == []
        pipe = r["pipeline"]
        if heads == 2 and rank == 3:
            assert pipe is None and r["families"] == []
            continue
        assert pipe["depth"] == heads + 1 and pipe["replans"] == 0
        assert pipe["serial_fallback_partitions"] == 0
        assert pipe["micro_batches"] >= 2 and pipe["handoff_bytes"] > 0
        devs = [set(st["devices"]) for st in pipe["stages"]]
        assert all(devs) and not set.intersection(*devs)
        assert 0.0 < pipe["bubble_ratio"] < 1.0
        assert all(0.0 <= st["busy_ratio"] <= 1.0 for st in pipe["stages"])
        assert [len(st["segments"]) for st in pipe["stages"]] == \
            [1] * (heads + 1)
        assert r["families"] == families
        assert r["busy_stages"] == [str(i) for i in range(heads + 1)]


@pytest.mark.parametrize("mode", ["full", "mid"])
def test_stage_wedge_replans_one_stage_shallower_bitwise(fusion_mesh4, mode):
    """``pipe.stage_wedge`` under PipeSupervision
    (``tests/test_pipeline_mesh.py:458-``): armed on every micro-batch of
    data 2 x pipe 2, the stage's two ranks are quarantined and the frame
    re-runs serially; armed at the fifth seam of the three-stage chain, it
    re-plans at depth 2 on the two survivors. Bitwise the serial chain
    either way, on every rank, no request dropped."""
    _, ranks = _ranks_of(fusion_mesh4, f"wedge_{mode}")
    for rank, r in enumerate(ranks):
        assert r["bitwise"], rank
        states = r["states"]
        if mode == "full":
            assert r["fired"] == 1 and r["pipeline"] is None
            assert r["supervision"]["replans"] == 1
            assert r["supervision"]["depth"] == 1
            wedged = [i for i, (s, _) in states.items() if s == "quarantined"]
            assert len(wedged) == 2
            assert all(states[i][1].startswith("pipe_stage:") for i in wedged)
            continue
        if rank == 3:   # outside the three-stage mesh: serial throughout
            assert not r["member"] and r["pipeline"] is None
            continue
        assert r["fired"] == 1 and r["supervision"]["replans"] == 1
        assert r["supervision"]["depth"] == 2
        assert sum(s == "quarantined" for s, _ in states.values()) == 1
        if rank == 1:   # the wedged stage's rank runs the re-run serially
            assert r["pipeline"] is None
        else:
            assert r["pipeline"]["depth"] == 2
            assert r["pipeline"]["replans"] == 1


@pytest.mark.parametrize("knob", ["sharding", "pipe_depth"])
def test_tuner_proposes_journals_and_rolls_back_the_mesh_knobs(
        fusion_mesh4, knob):
    """With a cost model forced to want the knob (``tests/test_sharding.py:
    373-416``, ``tests/test_pipeline_mesh.py:413-456``): ``propose`` carries
    it and round-trips through ``KnobSet``, ``tune`` applies and journals it
    and the applied model runs sharded (pipelined) and right; an injected
    measurement regression rolls back one step to the bitwise serial
    path."""
    _, ranks = _ranks_of(fusion_mesh4, f"tuner_{knob}")
    label = "ImageTransformer+ImageFeaturizer"
    for r in ranks:
        if knob == "sharding":
            assert r["proposed"]["sharding"] == {label: "data"}
            assert r["applied"][-1]["sharding"] == {label: "data"}
            assert r["overrides"] == ({label: "data"}, None)
            assert r["applied_sharding"]["segments"][label]["shards"] == 4
            assert r["applied_err"] <= SHARD_ATOL
        else:
            assert r["proposed"]["pipe_depth"] == 2
            assert r["applied"][-1]["pipe_depth"] == 2
            assert r["overrides"] == ({}, 2)
            assert r["applied_pipeline"] == 2 and r["applied_err"] == 0.0
        assert r["round_trip"] == r["proposed"]
        assert r["rollbacks_1"] == 0
        assert r["rollbacks"] >= 1 and r["step1_accepted"] is False
        assert r["final_default"] and r["journal_rollback"]
        assert r["after"] == ({}, None) and r["bitwise"]
        assert r["after_stats"] == []
        # only rank 0 wanted the knob and judged the steps as it did; every
        # rank took its decisions, step for step
        assert r["proposed"] == ranks[0]["proposed"]
        assert r["journal"] == ranks[0]["journal"]


@pytest.mark.parametrize("step", ["resolve", "build_demoted", "build_raised",
                                  "pipe_run", "pipe_hook", "group_failed",
                                  "group_absent"])
def test_a_failure_on_one_rank_takes_every_rank_the_same_way(
        fusion_mesh4, step):
    """One rank alone fails a step the ranks must agree on; every rank then
    takes the same path and none hangs (the spawn's limit would fail the
    fixture): a spec that failed to resolve, or a pipe plan that failed to
    resolve or to place, leaves every rank on the bitwise single-device or
    serial path; a sharded program demoted at build is every rank's host
    fallback, within SHARD_ATOL; one that raised at build raises on every
    rank. A pipe stage's sub-mesh group that one member fails to prepare,
    or never arrives at, is every rank's serial path too, well inside the
    spawn's limit: the members agree before any blocks in the group's
    rendezvous, and a missing member ends the wait after
    ``FORM_TIMEOUT_S`` (5 s in the case)."""
    _, ranks = _ranks_of(fusion_mesh4, "rank_faults")
    outs = [r[step] for r in ranks]
    if step.startswith("group_"):
        assert max(r["seconds"] for r in outs) < 60, outs
    for rank, r in enumerate(outs):
        if step == "build_raised":
            assert r["raised"] == "RuntimeError"
            assert ("injected failure" in r["message"]) == (rank == 3)
            continue
        assert "raised" not in r, r
        assert r["err"] <= SHARD_ATOL and r["pipelined"] is False
        if step == "build_demoted":   # resolved, then every batch demoted
            assert r["sharded"] and len(r["fallbacks"]) == 2
            assert all("injected build failure" in f or "peer rank" in f
                       for f in r["fallbacks"])
        else:
            assert r["sharded"] is False
            assert r["bitwise"] and r["fallbacks"] == []
    assert len({tuple(r["fallbacks"]) == () for r in outs}) == 1


def test_shard_groups_follow_the_data_axis():
    """``shard_groups``/``group_of``/``submesh_excluding`` on the reference's
    mesh shapes (``tests/test_sharding.py:418-450``)."""
    from mmlspark_tpu.parallel import shardplan as ref_sp
    from mmlspark_tpu_torch.parallel import shardplan as sp

    for spec in (dict(data=8), dict(data=4, tensor=2), dict(data=2, pipe=2)):
        port, ref = _port_mesh(**spec), _ref_mesh(**spec)
        groups = sp.shard_groups(port)
        assert groups == ref_sp.shard_groups(ref)
        for g in groups:
            assert sp.group_of(port, g[0]) == ref_sp.group_of(ref, g[0])
        with pytest.raises(ValueError):
            sp.group_of(port, 99)
    mesh8 = _port_mesh(data=8)
    sub = sp.submesh_excluding(mesh8, [0, 1])
    assert sub.shape["data"] == 6 and list(sub.ranks) == list(range(2, 8))
    assert sp.submesh_excluding(mesh8, range(8)) is None


def test_mesh_supervision_replans_onto_the_survivors(fusion_mesh4):
    """MeshSupervision over data 4: a wedge of rank 0's group quarantines it
    and re-plans onto the three survivors, sharded 3 ways (rank 0, outside
    the new mesh, runs unsharded); still right on every rank, idempotent per
    group (``tests/test_sharding.py:452-499``)."""
    _, ranks = _ranks_of(fusion_mesh4, "supervision")
    for rank, r in enumerate(ranks):
        assert r["attached"] and r["groups"] == [[0], [1], [2], [3]]
        assert r["before_err"] <= SHARD_ATOL and r["after_err"] <= SHARD_ATOL
        assert r["sub_shape"]["data"] == 3 and r["sub_ranks"] == [1, 2, 3]
        assert r["replans"] == 1 and r["fused_mesh_is_sub"]
        assert r["states"][0] == "quarantined"
        assert [r["states"][i] for i in (1, 2, 3)] == ["healthy"] * 3
        assert r["fallbacks"] == [] and r["again_same"]
        assert r["describe"]["failed_devices"] == 1
        assert r["describe"]["topology"].startswith("data=3,")
        if rank == 0:
            assert r["sharding"] is None and r["after_bitwise"]
        else:
            seg = r["sharding"]["segments"]["ImageTransformer+ImageFeaturizer"]
            assert seg["shards"] == 3


def test_measured_collectives_feed_the_cost_model(fusion_mesh4):
    """``measure_collectives`` times all-reduce and all-gather probes on the
    data group of every rank and calibrates ``collective_ms``; the fits
    round-trip ``to_dict``/``from_dict`` in the reference's format."""
    _, ranks = _ranks_of(fusion_mesh4, "collectives")
    for r in ranks:
        assert r["ops"] == ["all_gather", "all_reduce"] and r["nonneg"]
        assert r["calibrated"] and r["predict"] is not None
        assert r["round_trip"] == pytest.approx(r["predict"])
    m, ref = costmodel.SegmentCostModel(), ref_costmodel.SegmentCostModel()
    for model in (m, ref):
        model.observe_collective("all_reduce", 1024, 1e-6)
        model.observe_collective("all_reduce", 2048, 2e-6)
        model.observe_collective("pipe_handoff", 4096, 3e-6)
    assert m.to_dict()["collectives"] == ref.to_dict()["collectives"]
    back = costmodel.SegmentCostModel.from_dict(ref.to_dict())
    assert back.collective_ms("all_reduce", 2048) == \
        pytest.approx(ref.collective_ms("all_reduce", 2048))


# ------------------------------------------ featurize, stages and train layers
#
# ROADMAP A 10.1-10.2: ``mmlspark_tpu_torch.featurize``, ``.stages``,
# ``.train`` and ``core.utils`` against the JAX package's, on the cases of
# ``tests/test_featurize_train.py`` and ``tests/test_stages.py`` and on
# seeded inputs. Tolerances, and why:
#   - host code (the utilities, indexers, cleaners, converters, assemblers,
#     the stages, TextFeaturizer's rows and IDF weights, Word2Vec's draws,
#     pair table, transform and synonyms, the statistics of the same scored
#     columns): bitwise, the same numpy arithmetic;
#   - TrainClassifier / TrainRegressor fits (under ``ref_device_path``):
#     the trees as ``test_torch_gbdt.py`` holds them (structure equal, leaf
#     values rtol 1e-5), scores rtol 1e-5 / atol 1e-6;
#   - Word2Vec's initial matrix: bitwise (``threefry.normal`` against
#     ``jax.random.normal``; the issue allowed one f32 ulp); its trained
#     vectors W2V_TOL of max |v|: the f32 sums of each step in another
#     order, over at most 300 steps (measured: 4.5e-7 of 1.0);
#   - fused assemblers -> LightGBM against the unfused chain: bitwise.

import pickle as _pickle  # noqa: E402

from mmlspark_tpu import featurize as ref_featurize  # noqa: E402
from mmlspark_tpu import stages as ref_stage_lib  # noqa: E402
from mmlspark_tpu import train as ref_train  # noqa: E402
from mmlspark_tpu.core import utils as ref_utils  # noqa: E402
from mmlspark_tpu.core.pipeline import PipelineStage as RefPipelineStage  # noqa: E402
from mmlspark_tpu.featurize import text as ref_text  # noqa: E402
from mmlspark_tpu.featurize import word2vec as ref_word2vec  # noqa: E402
from mmlspark_tpu_torch import featurize as port_featurize  # noqa: E402
from mmlspark_tpu_torch import stages as port_stage_lib  # noqa: E402
from mmlspark_tpu_torch import train as port_train  # noqa: E402
from mmlspark_tpu_torch.core import threefry as port_threefry  # noqa: E402
from mmlspark_tpu_torch.core import utils as port_utils  # noqa: E402
from mmlspark_tpu_torch.core.device_stage import FusionUnsupported  # noqa: E402
from mmlspark_tpu_torch.core.pipeline import PipelineStage  # noqa: E402
from mmlspark_tpu_torch.featurize import text as port_text  # noqa: E402
from mmlspark_tpu_torch.featurize import word2vec as port_word2vec  # noqa: E402
from mmlspark_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402

W2V_TOL = 1e-5

# the two packages side by side: (DataFrame, featurize, stages, train,
# GBDT stages)
_PKGS = {"ref": (RefDataFrame, ref_featurize, ref_stage_lib, ref_train,
                 ref_stages),
         "port": (DataFrame, port_featurize, port_stage_lib, port_train,
                  stages)}


def _same_value(a, b, where):
    if isinstance(a, dict) or isinstance(b, dict):
        assert isinstance(a, dict) and isinstance(b, dict), where
        assert list(a) == list(b), where
        for k in a:
            _same_value(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
                _same_value(x, y, f"{where}[{i}]")
        elif a.dtype.kind == "f":
            assert np.array_equal(a.view(f"u{a.itemsize}"),
                                  b.view(f"u{b.itemsize}")), where
        else:
            assert np.array_equal(a, b), where
    elif isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_value(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and isinstance(b, float) and a != a:
        assert b != b, where
    else:
        assert type(a) is type(b) and a == b, f"{where}: {a!r} != {b!r}"


def _same_frame(ref_df, port_df):
    """Columns, partitions, dtypes and every value bit for bit."""
    assert port_df.columns == ref_df.columns
    assert port_df.num_partitions == ref_df.num_partitions
    for pr, pp in zip(ref_df.partitions, port_df.partitions):
        for c in ref_df.columns:
            _same_value(pr[c], pp[c], c)


def _mixed(pkg, n=200, seed=0, parts=2):
    """``tests/test_featurize_train.py``'s ``mixed_df`` in either package."""
    rng = np.random.default_rng(seed)
    age = rng.uniform(20, 70, n)
    city = rng.choice(["nyc", "sf", "la"], n)
    income = rng.normal(60, 15, n)
    income[rng.choice(n, 10, replace=False)] = np.nan
    logit = 0.08 * (age - 45) + np.where(city == "sf", 2.0, 0.0) \
        + 0.04 * np.nan_to_num(income - 60)
    label = (logit + rng.normal(scale=0.4, size=n) > 0)
    return _PKGS[pkg][0].from_dict({
        "age": age, "city": list(city), "income": income,
        "label": np.where(label, "yes", "no")}, num_partitions=parts)


def _both(fn):
    """``fn(pkg)`` for the reference and the port (on the CPU)."""
    ref = fn("ref")
    with use_device("cpu"):
        port = fn("port")
    return ref, port


def _utils_case(u, name):
    if name == "stopwatch":
        w = u.StopWatch()
        with w.measure():
            pass
        w.stop()
        return w.elapsed_ns > 0, w._start is None
    if name == "retry":
        calls, seen = [], []

        def fn():
            calls.append(1)
            if len(calls) < 3:
                raise ValueError(f"attempt {len(calls)}")
            return len(calls)

        return u.retry(fn, max_retries=4, initial_delay_s=0.0,
                       on_retry=lambda a, e: seen.append((a, str(e)))), seen
    if name == "retry_exhausted":
        with pytest.raises(KeyError):
            u.retry(lambda: {}["x"], max_retries=2, initial_delay_s=0.0)
        return True
    if name == "retry_with_timeout":
        with pytest.raises(TimeoutError):
            u.retry_with_timeout(lambda: time.sleep(0.5), 0.01, max_retries=2)
        return u.retry_with_timeout(lambda: 7, 5.0)
    if name == "buffered_await":
        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(3) as pool:
            futs = [pool.submit(lambda i=i: i * i) for i in range(9)]
            return list(u.buffered_await(iter(futs), 2))
    if name == "using":
        class R:
            closed = False

            def close(self):
                self.closed = True
        a, b = R(), R()
        with u.using(a, b) as got:
            assert got == (a, b)
        return a.closed, b.closed
    if name == "cast_column":
        col = np.array([1, np.array([1.5, 2.5]), 3.25], dtype=object)
        return (u.cast_column(np.arange(4), "float32"),
                u.cast_column(col, "float32"), u.dtype_scalar(2.7, "int32"))
    if name == "shared_variable":
        made = []
        u.SharedVariable.clear_all()
        a = u.SharedVariable(lambda: made.append(1) or len(made), key="k")
        b = u.SharedVariable(lambda: made.append(1) or len(made), key="k")
        c = u.SharedVariable(lambda: made.append(1) or len(made))
        out = (a.get(), b.get(), c.get(), c.get(), len(made))
        u.SharedVariable.clear_all()
        return out
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["stopwatch", "retry", "retry_exhausted",
                                  "retry_with_timeout", "buffered_await",
                                  "using", "cast_column", "shared_variable"])
def test_core_utils_match_reference(name):
    _same_value(_utils_case(ref_utils, name), _utils_case(port_utils, name),
                name)


def test_value_indexer_and_index_to_value_match_reference():
    def run(pkg):
        DF, feat = _PKGS[pkg][:2]
        df = DF.from_dict({"cat": ["b", "a", "c", "a", None],
                           "num": [3, 1, 3, 2, 1]}, num_partitions=2)
        out = feat.ValueIndexer(inputCol="cat", outputCol="idx").fit(
            df).transform(df)
        out = feat.ValueIndexer(inputCol="num", outputCol="nidx").fit(
            out).transform(out)
        back = feat.IndexToValue(inputCol="idx", outputCol="orig").transform(out)
        return back, (back.schema.metadata.get("idx"),
                      back.schema.metadata.get("nidx"))

    (ref, ref_meta), (port, port_meta) = _both(run)
    _same_frame(ref, port)
    assert port_meta == ref_meta
    assert list(port.column("idx")) == [1.0, 0.0, 2.0, 0.0, 3.0]


@pytest.mark.parametrize("mode", ["Mean", "Median", "Custom"])
def test_clean_missing_data_matches_reference(mode):
    def run(pkg):
        DF, feat = _PKGS[pkg][:2]
        df = DF.from_dict({
            "x": [1.0, np.nan, 3.0, 100.0, np.nan],
            "o": np.array([2, None, 5.5, None, 1], dtype=object)},
            num_partitions=2)
        kw = {"customValue": -1.0} if mode == "Custom" else {}
        m = feat.CleanMissingData(inputCols=["x", "o"], outputCols=["x2", "o2"],
                                  cleaningMode=mode, **kw).fit(df)
        return m.transform(df), m.get("fillValues")

    (ref, ref_fill), (port, port_fill) = _both(run)
    _same_frame(ref, port)
    assert port_fill == ref_fill


@pytest.mark.parametrize("to", ["boolean", "byte", "short", "integer", "long",
                                "float", "double", "string", "toCategorical",
                                "clearCategorical", "date"])
def test_data_conversion_matches_reference(to):
    def run(pkg):
        DF, feat = _PKGS[pkg][:2]
        if to == "date":
            df = DF.from_dict({"x": np.array(["2024-01-02 03:04:05", None,
                                              1.7e12], dtype=object)})
        elif to in ("toCategorical", "clearCategorical"):
            df = DF.from_dict({"x": ["b", "a", "b"]})
            df = feat.ValueIndexer(inputCol="x", outputCol="x").fit(
                df).transform(df)
        else:
            df = DF.from_dict({"x": [1.7, 0.0, -2.2]})
        out = feat.DataConversion(cols=["x"], convertTo=to).transform(df)
        return out, dict(out.schema.metadata)

    (ref, ref_meta), (port, port_meta) = _both(run)
    _same_frame(ref, port)
    assert port_meta == ref_meta


def _assemble_frame(pkg):
    DF = _PKGS[pkg][0]
    df = _mixed(pkg, 60)
    rng = np.random.default_rng(3)
    vec = [rng.normal(size=3) for _ in range(60)]
    vec[4] = None
    sparse = [{"size": 7, "indices": np.array([1, 5], np.int64),
               "values": np.array([0.5, 2.0], np.float32)} for _ in range(60)]
    words = np.array([f"w{i % 9}" for i in range(60)], dtype=object)
    words[7] = None
    return DF.from_dict({**df.collect(), "vec": vec, "sp": sparse,
                         "word": words, "odd": [object()] * 60},
                        num_partitions=2)


@pytest.mark.parametrize("kw", [{}, {"maxCategoricalLevels": 4},
                                {"oneHotEncodeCategoricals": False,
                                 "numberOfFeatures": 50}])
def test_assemble_features_matches_reference(kw):
    def run(pkg):
        feat = _PKGS[pkg][1]
        df = _assemble_frame(pkg)
        m = feat.AssembleFeatures(inputCols=["age", "city", "income", "vec",
                                             "sp", "word", "odd"],
                                  outputCol="f", **kw).fit(df)
        out = m.transform(df).select("f")
        return out, (m.get("encoders"), m.slot_names(),
                     out.schema.meta("f").get("slot_names"))

    (ref, ref_meta), (port, port_meta) = _both(run)
    _same_frame(ref, port)
    _same_value(ref_meta, port_meta, "encoders, slot names")


def test_featurize_and_fast_vector_assembler_match_reference():
    def run(pkg):
        DF, feat = _PKGS[pkg][:2]
        df = _mixed(pkg, 50)
        out = feat.Featurize(featureColumns={"feats": ["age", "city"],
                                             "nums": ["income"]}).fit(
            df).transform(df)
        fdf = DF.from_dict({
            "a": np.array([1.0, None, 3.0], dtype=object),
            "v": [np.array([4.0, 5.0]), np.array([6.0, 7.0]),
                  np.array([8.0, 9.0])],
            "b": np.array([10.0, 11.0, 12.0]), "l": [[1, 2], [3, 4], [5, 6]]})
        fva = feat.FastVectorAssembler(inputCols=["a", "v", "b", "l"],
                                       outputCol="f").transform(fdf)
        bad = DF.from_dict({"v": np.array([np.array([4.0, 5.0]), None],
                                          dtype=object), "b": [1.0, 2.0]})
        with pytest.raises(ValueError, match="cannot be null"):
            feat.FastVectorAssembler(inputCols=["v", "b"],
                                     outputCol="f").transform(bad).collect()
        return out.select("feats", "nums"), fva.select("f")

    (r1, r2), (p1, p2) = _both(run)
    _same_frame(r1, p1)
    _same_frame(r2, p2)


_TEXTS = None


def _text_corpus():
    global _TEXTS
    if _TEXTS is None:
        rng = np.random.default_rng(0)
        words = np.array([f"w{i}" for i in range(400)]
                         + ["the", "a", "Good", "BAD", "café", "x-y"])
        texts = [" ".join(rng.choice(words, rng.integers(0, 30)))
                 for _ in range(150)]
        _TEXTS = texts + [None, "", "  spaced   out  ", "The cat sat"]
    return _TEXTS


@pytest.mark.parametrize("kw", [
    {}, {"useStopWordsRemover": True},
    {"useNGram": True, "nGramLength": 3, "useIDF": False,
     "numFeatures": 1 << 12},
    {"minDocFreq": 3, "numFeatures": 97}, {"useTokenizer": False},
    {"toLowercase": False, "minTokenLength": 3, "tokenizerPattern": r"[\s-]+"}])
def test_text_featurizer_rows_match_reference_bitwise(kw):
    def run(pkg):
        DF, feat = _PKGS[pkg][:2]
        df = DF.from_dict({"t": _text_corpus()}, num_partitions=3)
        m = feat.TextFeaturizer(inputCol="t", outputCol="f", **kw).fit(df)
        return m.transform(df).select("f"), m.get("idfValues")

    (ref, ref_idf), (port, port_idf) = _both(run)
    _same_frame(ref, port)
    _same_value(ref_idf, port_idf, "idfValues")


def test_text_helpers_match_reference():
    toks = port_text.tokenize("The  cat, the HAT!", r"[\s,!]+", True, 2)
    assert toks == ref_text.tokenize("The  cat, the HAT!", r"[\s,!]+", True, 2)
    assert port_text.ngrams(toks, 2) == ref_text.ngrams(toks, 2)
    for tokens in ([], ["a"], toks * 3, ["café", "日本", ""]):
        for nf in (1, 97, 1 << 18):
            _same_value(ref_text.hash_tf(tokens, nf),
                        port_text.hash_tf(tokens, nf), str(tokens))

    def run(pkg):
        DF, feat = _PKGS[pkg][:2]
        grams = feat.MultiNGram(inputCol="toks", outputCol="g",
                                lengths=[1, 2, 3]).transform(DF.from_dict(
                                    {"toks": [["a", "b", "c"], None, []]}))
        text = ("word " * 100).strip()
        pages = feat.PageSplitter(inputCol="t", outputCol="p",
                                  maximumPageLength=120,
                                  minimumPageLength=100).transform(
            DF.from_dict({"t": [text, None, "short"]}))
        return grams, pages

    (rg, rp), (pg, pp) = _both(run)
    _same_frame(rg, pg)
    _same_frame(rp, pp)


@pytest.mark.parametrize("seed,shape", [(0, (3, 5)), (1, (1000, 100)),
                                        (12345, (7,)), (2 ** 31 - 1, (64, 33))])
def test_threefry_normal_matches_jax_bitwise(seed, shape):
    key = jax.random.split(jax.random.key(seed))[0]
    want = np.asarray(jax.random.normal(key, shape, dtype=jnp.float32))
    got = port_threefry.normal(port_threefry.split(
        port_threefry.prng_key(seed), 2)[0], int(np.prod(shape)))
    np.testing.assert_array_equal(got.numpy().reshape(shape).view(np.uint32),
                                  want.view(np.uint32))


def test_erf_inv_matches_xla_at_its_edges():
    x = np.array([0.0, -0.0, 1.0, -1.0, 1.5, np.nan, 1e-30, -1e-30, 0.41,
                  0.6436, -0.6436, 0.9999999, -0.99999994, 0.5, 0.25],
                 np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = port_threefry.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32),
                                  want[ok].view(np.uint32))


def _w2v_docs(pkg):
    rng = np.random.default_rng(0)
    animals = ["cat", "dog", "horse", "cow"]
    foods = ["pizza", "pasta", "salad", "soup"]
    docs = []
    for _ in range(120):
        group = animals if rng.random() < 0.5 else foods
        words = list(rng.choice(group, 4)) + ["the", "a"]
        rng.shuffle(words)
        docs.append(" ".join(words))
    return _PKGS[pkg][0].from_dict({"text": np.array(docs, object)})


@pytest.mark.parametrize("case", ["cooccurrence", "transform", "tokens"])
def test_word2vec_matches_reference(case):
    """``tests/test_featurize_train.py``'s Word2Vec cases: the vocabulary
    and the transform's zero rows equal, the vectors within W2V_TOL, and
    the reference's own checks hold on the port's model."""
    kw = {"cooccurrence": dict(vectorSize=16, minCount=2, numIterations=30,
                               windowSize=3, batchSize=256, stepSize=0.3,
                               seed=1),
          "transform": dict(vectorSize=8, minCount=2, numIterations=1),
          "tokens": dict(vectorSize=4, minCount=1, numIterations=1,
                         batchSize=8)}[case]

    def run(pkg):
        DF, feat = _PKGS[pkg][:2]
        if case == "tokens":
            df = DF.from_dict({"text": [["a", "b", "a"], ["b", "a", "b"]] * 6})
        else:
            df = _w2v_docs(pkg)
        m = feat.Word2Vec(inputCol="text", outputCol="vec", **kw).fit(df)
        probe = DF.from_dict({"text": np.array(["cat dog", "zzz qqq", None],
                                               object)})
        return m, m.transform(probe).column("vec")

    (rm, rv), (pm, pv) = _both(run)
    assert pm.get("vocab") == rm.get("vocab")
    a, b = rm.get("vectors"), pm.get("vectors")
    assert b.dtype == np.float32 and b.shape == a.shape
    assert np.abs(a - b).max() <= W2V_TOL * np.abs(a).max()
    for x, y in zip(rv, pv):
        np.testing.assert_allclose(y, x, atol=W2V_TOL * np.abs(a).max())
    if case == "cooccurrence":
        syn = dict(pm.find_synonyms("cat", num=len(pm.get("vocab"))))
        assert syn["dog"] > syn["pizza"] and syn["horse"] > syn["pasta"]
    if case == "transform":
        np.testing.assert_array_equal(pv[1], np.zeros(8, np.float32))


def test_word2vec_host_parts_match_reference():
    """The pair table in the reference's loop order, the pass's negatives
    drawn at once equal to its per-step ``rng.choice``, and the model's
    transform and synonyms on the same vectors, bit for bit."""
    rng = np.random.default_rng(4)
    docs = [list(rng.integers(0, 40, rng.integers(0, 12))) for _ in range(60)]
    centers, contexts = [], []
    for ids in docs:
        for i, c in enumerate(ids):
            for j in range(max(0, i - 2), min(len(ids), i + 3)):
                if j != i:
                    centers.append(c)
                    contexts.append(ids[j])
    got = port_word2vec._pair_table(docs, 2)
    np.testing.assert_array_equal(got[0], np.asarray(centers, np.int32))
    np.testing.assert_array_equal(got[1], np.asarray(contexts, np.int32))
    p = rng.random(37) ** 3
    p /= p.sum()
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    want = [r1.permutation(11)]
    want += [r1.choice(37, size=(16, 4), p=p) for _ in range(5)]
    got = [r2.permutation(11), port_word2vec.draw_negatives(
        r2, port_word2vec.negative_cdf(p, "cpu"), (5, 16, 4)).numpy()]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], np.stack(want[1:]))
    assert r1.random() == r2.random()
    vecs = rng.normal(size=(6, 5)).astype(np.float32)
    vocab = ["a", "b", "c", "d", "e", "f"]
    rm = ref_word2vec.Word2VecModel(inputCol="t", outputCol="v", vocab=vocab,
                                    vectors=vecs)
    pm = port_word2vec.Word2VecModel(inputCol="t", outputCol="v", vocab=vocab,
                                     vectors=vecs)
    _same_value(rm.find_synonyms("C", 4), pm.find_synonyms("C", 4), "syn")
    texts = np.array(["a b Q", None, "f f"], object)
    _same_frame(rm.transform(RefDataFrame.from_dict({"t": texts})),
                pm.transform(DataFrame.from_dict({"t": texts})))
    with pytest.raises(ValueError, match="vocab"):
        port_featurize.Word2Vec(inputCol="t", outputCol="v", minCount=5).fit(
            DataFrame.from_dict({"t": np.array(["x y", "z w"], object)}))


def _double(df):
    return df.with_column("numbers", lambda p: p["numbers"] * 2)


def _square(v):
    return v * v


def _basic(pkg, n=10, parts=2):
    return _PKGS[pkg][0].from_dict({
        "numbers": np.arange(n, dtype=np.float64),
        "words": [f"w{i % 3}" for i in range(n)]}, num_partitions=parts)


def _stage_case(pkg, name):
    DF, _, st = _PKGS[pkg][:3]
    if name == "lambda":
        return st.Lambda(_double).transform(_basic(pkg))
    if name == "udf_row":
        t = st.UDFTransformer(inputCol="numbers", outputCol="sq")
        return t.set("udf", _square).transform(_basic(pkg))
    if name == "udf_vectorized":
        t = st.UDFTransformer(inputCol="numbers", outputCol="sq")
        return t.set("vectorizedUdf", lambda c: c ** 2).transform(_basic(pkg))
    if name == "udf_multi":
        t = st.UDFTransformer(outputCol="cat")
        t.set("inputCols", ["numbers", "words"])
        return t.set("udf", lambda a, b: f"{b}:{a}").transform(_basic(pkg))
    if name == "multi_column_adapter":
        base = st.UDFTransformer()
        base.set("udf", lambda v: v + 1)
        t = st.MultiColumnAdapter()
        t.set("baseStage", base)
        t.set("inputCols", ["numbers", "numbers"])
        t.set("outputCols", ["plus1", "again"])
        return t.transform(_basic(pkg))
    if name == "explode":
        df = DF.from_dict({"id": [1, 2, 3], "vals": [[10, 20], [30], None]})
        return st.Explode(inputCol="vals").transform(df)
    if name == "select_drop_rename":
        df = st.SelectColumns(cols=["words", "numbers"]).transform(_basic(pkg))
        df = st.RenameColumn(inputCol="numbers", outputCol="nums").transform(df)
        return st.DropColumns(cols=["words"]).transform(df)
    if name == "repartition":
        return st.Repartition(n=5).transform(_basic(pkg, 10, 2))
    if name == "coalesce":
        return st.PartitionCoalesce(n=2).transform(_basic(pkg, 11, 5))
    if name == "cacher":
        return st.Cacher().transform(_basic(pkg))
    if name in ("stratified", "stratified_equal"):
        n = 43
        df = DF.from_dict({"label": [i % 4 if i < 40 else 0 for i in range(n)],
                           "x": np.arange(n, dtype=np.float64)},
                          num_partitions=4)
        mode = "equal" if name == "stratified_equal" else "original"
        return st.StratifiedRepartition(labelCol="label", mode=mode,
                                        seed=3).transform(df)
    if name == "class_balancer":
        df = DF.from_dict({"label": ["a"] * 6 + ["b"] * 2 + ["c"]})
        return st.ClassBalancer(inputCol="label").fit(df).transform(df)
    if name in ("ensemble_collapse", "ensemble_broadcast"):
        df = DF.from_dict({
            "key": ["a", "a", "b", "b"], "k2": [1, 1, 1, 2],
            "score": [np.array([1.0, 2.0]), np.array([3.0, 4.0]),
                      np.array([5.0, 6.0]), None],
            "s": [1.0, 3.0, 5.0, 7.0]})
        return st.EnsembleByKey(keys=["key", "k2"], cols=["score", "s"],
                                collapseGroup=name == "ensemble_collapse"
                                ).transform(df)
    if name == "timer":
        inner = st.UDFTransformer(inputCol="numbers", outputCol="sq")
        inner.set("udf", _square)
        timer = st.Timer()
        timer.set("stage", inner)
        return timer.fit(_basic(pkg)).transform(_basic(pkg))
    if name == "timer_estimator":
        timer = st.Timer(logToScala=False)
        timer.set("stage", st.ClassBalancer(inputCol="words"))
        return timer.fit(_basic(pkg)).transform(_basic(pkg))
    if name == "summarize":
        df = DF.from_dict({"numbers": [1.0, np.nan, 3.0, 4.5, 10.0],
                           "words": ["a", None, "b", "a", "c"],
                           "mixed": np.array([1, None, 2.5, "x", 3],
                                             dtype=object)})
        return st.SummarizeData().transform(df)
    if name == "fixed_minibatch":
        return st.FixedMiniBatchTransformer(batchSize=3).transform(_basic(pkg))
    if name == "fixed_roundtrip":
        b = st.FixedMiniBatchTransformer(batchSize=4).transform(
            _basic(pkg, 13, 3))
        return st.FlattenBatch().transform(b)
    if name == "dynamic_minibatch":
        return st.DynamicMiniBatchTransformer(maxBatchSize=3).transform(
            _basic(pkg, 8, 2))
    if name == "time_interval_minibatch":
        return st.TimeIntervalMiniBatchTransformer(maxBatchSize=2).transform(
            _basic(pkg, 5, 1))
    if name == "flatten_scalars":
        return st.FlattenBatch().transform(
            DF.from_dict({"batch": [[1, 2, 3], [4]], "tag": ["t", "u"]}))
    if name == "text_preprocessor":
        df = DF.from_dict({"text": ["Hello World", "hello there!", None,
                                    "abcd"]})
        out = []
        for norm in ("identity", "lowerCase", "removePunctuation"):
            t = st.TextPreprocessor(inputCol="text", outputCol=f"o_{norm}",
                                    normFunc=norm)
            t.set("map", {"hello": "hi", "world": "earth", "ab": "X",
                          "abc": "Y"})
            out.append(t)
        for t in out:
            df = t.transform(df)
        return df
    if name == "unicode_normalize":
        df = DF.from_dict({"text": ["Café", "ＡＢＣ", None, "ﬁ"]})
        for form in ("NFC", "NFD", "NFKC", "NFKD"):
            df = st.UnicodeNormalize(inputCol="text", outputCol=form,
                                     form=form, lower=form != "NFC"
                                     ).transform(df)
        return df
    if name == "udfs":
        col = np.empty(3, dtype=object)
        col[0], col[1], col[2] = np.array([1.0, 2.0, 3.0]), None, [4, 5, 6]
        dense = np.arange(9.0).reshape(3, 3)
        return DF.from_dict({"at": st.get_value_at(col, 1),
                             "vec": st.to_vector(col),
                             "dense": list(st.get_value_at(dense, 2))})
    raise AssertionError(name)


_STAGE_CASES = ["lambda", "udf_row", "udf_vectorized", "udf_multi",
                "multi_column_adapter", "explode", "select_drop_rename",
                "repartition", "coalesce", "cacher", "stratified",
                "stratified_equal", "class_balancer", "ensemble_collapse",
                "ensemble_broadcast", "timer", "timer_estimator", "summarize",
                "fixed_minibatch", "fixed_roundtrip", "dynamic_minibatch",
                "time_interval_minibatch", "flatten_scalars",
                "text_preprocessor", "unicode_normalize", "udfs"]


@pytest.mark.parametrize("name", _STAGE_CASES)
def test_stages_match_reference(name):
    ref, port = _both(lambda pkg: _stage_case(pkg, name))
    _same_frame(ref, port)


@pytest.fixture
def ref_device_path(monkeypatch):
    """Both packages' dense fits on their fused per-iteration growers (the
    reference's device path, ``tests/test_torch_gbdt.py``)."""
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    monkeypatch.setenv("MMLSPARK_TPU_FUSED_TREE", "1")


def _same_forest(ref_booster, port_booster):
    """As ``tests/test_torch_gbdt.py`` holds a fit: structure and
    thresholds equal, leaf values rtol 1e-5 (f32 sums one by one against
    f64 sums rounded once). One exception: where two one-hot slots of a
    column split a node's rows into the same two sets (the node holds two
    of its levels), their gains tie exactly and the packages may take
    either; the tree then holds the same leaves (sorted values equal)."""
    assert len(ref_booster.trees) == len(port_booster.trees)
    for gr, gp in zip(ref_booster.trees, port_booster.trees):
        for a, b in zip(gr, gp):
            fields = ("feature", "threshold_bin", "left", "right",
                      "default_left", "count", "threshold")
            if all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in fields):
                np.testing.assert_allclose(a.value, b.value, rtol=1e-5,
                                           atol=1e-7)
                continue
            node = int(np.nonzero(a.feature != b.feature)[0][0])
            assert a.gain[node] == b.gain[node]
            assert a.count[node] == b.count[node]
            leaves_a, leaves_b = a.feature < 0, b.feature < 0
            np.testing.assert_allclose(np.sort(a.value[leaves_a]),
                                       np.sort(b.value[leaves_b]), rtol=1e-5,
                                       atol=1e-7)


def _trained(pkg, kind, n=300):
    DF, feat, _, train, gb = _PKGS[pkg]
    if kind == "classifier":
        df = _mixed(pkg, n)
        est = train.TrainClassifier(labelCol="label").set_model(
            gb.LightGBMClassifier(numIterations=15, numLeaves=15,
                                  minDataInLeaf=5))
    else:
        rng = np.random.default_rng(0)
        a, b = rng.normal(size=n), rng.normal(size=n)
        y = 3 * a - 2 * b + 0.05 * rng.normal(size=n)
        df = DF.from_dict({"a": a, "b": b, "y": y}, num_partitions=2)
        est = train.TrainRegressor(labelCol="y").set_model(
            gb.LightGBMRegressor(numIterations=20, numLeaves=15,
                                 minDataInLeaf=5, learningRate=0.15))
    model = est.fit(df)
    return df, model, model.transform(df)


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_train_classifier_and_regressor_match_reference(ref_device_path, kind):
    """``tests/test_featurize_train.py``'s TrainClassifier (string labels,
    auto-featurized) and TrainRegressor journeys: the same forest, the
    featurizer's encoders, the label levels, the renamed columns and
    ``scored_labels_original``."""
    (rdf, rm, rs), (pdf, pm, ps) = _both(lambda pkg: _trained(pkg, kind))
    _same_forest(rm.get("model").booster, pm.get("model").booster)
    assert ps.columns == rs.columns
    if kind == "classifier":
        assert pm.get("levels") == rm.get("levels") == ["no", "yes"]
        _same_value(rm.get("featurizer").get("encoders"),
                    pm.get("featurizer").get("encoders"), "encoders")
        assert list(ps.column("scored_labels_original")) == \
            list(rs.column("scored_labels_original"))
        np.testing.assert_array_equal(ps.column("scored_labels"),
                                      rs.column("scored_labels"))
        for c in ("scores", "scored_probabilities"):
            np.testing.assert_allclose(np.stack(list(ps.column(c))),
                                       np.stack(list(rs.column(c))),
                                       rtol=1e-5, atol=1e-6)
        truth = pdf.column("label")
        assert np.mean([o == t for o, t in zip(
            ps.column("scored_labels_original"), truth)]) > 0.85
    else:
        assert pm.get("featurizer") is not None
        np.testing.assert_allclose(ps.column("scored_labels"),
                                   rs.column("scored_labels"),
                                   rtol=1e-5, atol=1e-6)


def _scored_columns(n=400, seed=5, classes=2):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n).astype(np.float64)
    logits = rng.normal(size=(n, classes)) + 1.5 * np.eye(classes)[
        y.astype(int)]
    logits[:7] = np.round(logits[:7])            # tied scores
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    pred = prob.argmax(1).astype(np.float64)
    return {"label": y, "scored_labels": pred, "scores": list(logits),
            "scored_probabilities": list(prob)}


@pytest.mark.parametrize("metric,classes,drop", [
    ("all", 2, None), ("all", 3, None), ("classification", 2, "scores"),
    ("accuracy", 2, None), ("precision", 3, None), ("recall", 2, None),
    ("AUC", 2, None), ("regression", 2, None),
    ("mean_squared_error", 2, "scored_labels")])
def test_model_statistics_match_reference_bitwise(metric, classes, drop):
    """ComputeModelStatistics and ComputePerInstanceStatistics on the same
    scored columns in both packages, and MetricsLogger's gauges in the
    port's registry."""
    cols = _scored_columns(classes=classes)
    if drop == "scored_labels":
        cols["prediction"] = cols.pop("scored_labels") + 0.25
    elif drop:
        del cols[drop]

    def run(pkg):
        DF, train = _PKGS[pkg][0], _PKGS[pkg][3]
        df = DF.from_dict(dict(cols), num_partitions=2)
        stats = train.ComputeModelStatistics(
            labelCol="label", evaluationMetric=metric).transform(df)
        per = train.ComputePerInstanceStatistics(labelCol="label").transform(df)
        return stats, per

    (rs, rp), (ps, pp) = _both(run)
    _same_frame(rs, ps)
    _same_frame(rp, pp)
    reg = MetricsRegistry()
    row = {k: v for k, v in ps.rows()[0].items()
           if not isinstance(v, np.ndarray)}
    port_train.MetricsLogger.log_metrics(row, registry=reg)
    text = reg.exposition()
    for k in row:
        assert f'mmlspark_eval_metric{{metric="{k}"}}' in text


def test_metric_helpers_match_reference():
    rng = np.random.default_rng(2)
    y = rng.integers(0, 3, 200).astype(np.float64)
    p = rng.integers(0, 3, 200).astype(np.float64)
    s = np.round(rng.normal(size=200), 1)
    rm, pmod = ref_train.metrics, port_train.metrics
    _same_value(rm.confusion_matrix(y, p, 3), pmod.confusion_matrix(y, p, 3),
                "cm")
    assert pmod.auc_score(y > 1, s) == rm.auc_score(y > 1, s)
    assert pmod.auc_score(np.ones(3), s[:3]) == 0.5
    _same_value(rm.classification_metrics(y, p, s),
                pmod.classification_metrics(y, p, s), "classification")
    _same_value(rm.regression_metrics(y, s), pmod.regression_metrics(y, s),
                "regression")


def _fused_pair(kind):
    """An assembler -> LightGBMRegressor chain in the port on the CPU: the
    model fit on the assembled rows, the chain run unfused and fused."""
    rng = np.random.default_rng(7)
    n = 600
    cols = {"a": rng.normal(size=n).astype(np.float32),
            "b": rng.integers(0, 5, n).astype(np.int16),
            "v": list(rng.normal(size=(n, 3)).astype(np.float32))}
    cols["a"][::17] = np.nan
    y = np.nan_to_num(cols["a"]) * 2 + cols["b"] - cols["v"][0][0]
    df = DataFrame.from_dict({**cols, "label": y}, num_partitions=2)
    if kind == "fast":
        asm = port_featurize.FastVectorAssembler(inputCols=["a", "b", "v"],
                                                 outputCol="features")
    else:
        fit_df = DataFrame.from_dict(
            {**cols, "a": np.where(np.isnan(cols["a"]), np.float32(0.5),
                                   cols["a"])})
        asm = port_featurize.AssembleFeatures(
            inputCols=["a", "b", "v"], outputCol="features").fit(fit_df)
        # fills the f32 wire carries exactly (``b`` has no missing value)
        asm.get("encoders")[0]["fill"] = 0.5
        asm.get("encoders")[1]["fill"] = 2.0
    with use_device("cpu"):
        model = stages.LightGBMRegressor(numIterations=5, numLeaves=7,
                                         minDataInLeaf=5).fit(asm.transform(df))
        chain = PipelineModel([asm, model])
        want = chain.transform(df)
        fused = chain.fuse()
        got = fused.transform(df)
    return asm, want, got, fused.fusion_stats()


@pytest.mark.parametrize("kind", ["fast", "assemble"])
def test_fused_assembler_to_lightgbm_equals_unfused(kind):
    """FastVectorAssembler / AssembleFeatures -> LightGBM fused on the
    device path (the assembler's torch ``device_fn`` in the segment, f32
    on the wire, widened to f64 by ``finalize``) is the unfused chain bit
    for bit, and the segment holds both stages."""
    asm, want, got, st = _fused_pair(kind)
    assert asm.device_fn(None) is not None
    assert got.columns == want.columns
    for c in ("features", "prediction"):
        for a, b in zip(want.column(c), got.column(c)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    segs = [k for k in st["per_segment"] if "LightGBMRegressionModel" in k]
    assert any(type(asm).__name__ in k for k in segs), st["per_segment"]


def test_assembler_device_fns_follow_the_reference_rules():
    """The port's ``device_fn``s keep the reference's ``accepts`` (f32-exact
    dtypes, no sparse rows) and refusals (string encoders, a fill the f32
    wire cannot carry), and compute the host's concatenation."""
    cols = ("a", "b")
    port = port_featurize.FastVectorAssembler(inputCols=list(cols),
                                              outputCol="f").device_fn(None)
    ref = ref_featurize.FastVectorAssembler(inputCols=list(cols),
                                            outputCol="f").device_fn(None)
    for probe in ({"a": {"dtype": np.dtype(np.float32), "sparse": False}},
                  {"a": {"dtype": np.dtype(np.float64), "sparse": False}},
                  {"a": {"dtype": np.dtype(np.int16), "sparse": False}},
                  {"a": {"dtype": np.dtype(np.int32), "sparse": False}},
                  {"b": {"dtype": np.dtype(np.float32), "sparse": True}},
                  {"a": {"dtype": None, "sparse": False}}):
        assert port.accepts(probe) == ref.accepts(probe)
    env = {"a": torch.tensor([1.0, 2.0]), "b": torch.arange(6).reshape(2, 3)}
    out = port.fn(None, env)["f"]
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), [[1, 0, 1, 2], [2, 3, 4, 5]])
    fin = port.finalize({"f": out.numpy()}, {})["f"]
    assert fin[0].dtype == np.float64
    enc = [{"col": "a", "kind": "numeric", "fill": 0.1}]
    assert port_featurize.assemble.AssembleFeaturesModel(
        inputCols=["a"], outputCol="f", encoders=enc).device_fn(None) is None
    enc = [{"col": "a", "kind": "onehot", "levels": ["x"]}]
    assert port_featurize.assemble.AssembleFeaturesModel(
        inputCols=["a"], outputCol="f", encoders=enc).device_fn(None) is None
    enc = [{"col": "a", "kind": "numeric", "fill": 0.5},
           {"col": "v", "kind": "vector", "dim": 2}]
    fn = port_featurize.assemble.AssembleFeaturesModel(
        inputCols=["a", "v"], outputCol="f", encoders=enc).device_fn(None)
    got = fn.fn(None, {"a": torch.tensor([np.nan, 3.0]),
                       "v": torch.ones(2, 2, dtype=torch.float64)})["f"]
    np.testing.assert_array_equal(got.numpy(), [[0.5, 1, 1], [3, 1, 1]])
    with pytest.raises(FusionUnsupported):
        fn.fn(None, {"a": torch.ones(2, 2), "v": torch.ones(2, 2)})
    with pytest.raises(FusionUnsupported):
        fn.fn(None, {"a": torch.ones(2), "v": torch.ones(2, 3)})


def _double_tensor(t):
    return t * 2.0


def test_udf_transformer_device_udf_fuses_bitwise():
    """``UDFTransformer.deviceUdf`` is a torch callable on [B, ...]
    tensors: its stage joins a fused segment with a LightGBM model and the
    fused chain equals the unfused one (the host ``udf``) bit for bit."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 3)).astype(np.float32)
    df = DataFrame.from_dict({"x": list(X), "label": X[:, 0] * 2.0})
    udf = port_stage_lib.UDFTransformer(inputCol="x", outputCol="features")
    udf.set("udf", lambda v: np.asarray(v, np.float32) * 2.0)
    udf.set("deviceUdf", _double_tensor)
    assert udf.device_fn(None) is not None
    with use_device("cpu"):
        model = stages.LightGBMRegressor(numIterations=3, numLeaves=4,
                                         minDataInLeaf=5).fit(udf.transform(df))
        chain = PipelineModel([udf, model])
        want = chain.transform(df).column("prediction")
        fused = chain.fuse()
        got = fused.transform(df).column("prediction")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert any("UDFTransformer" in k for k in fused.fusion_stats()["per_segment"])


def _roundtrip_stage(name):
    """(stage, frame) of each model stage the slice adds, fit in the port
    on the CPU."""
    if name in ("TrainedClassifierModel", "TrainedRegressorModel"):
        kind = "classifier" if name == "TrainedClassifierModel" else "regressor"
        df, model, _ = _trained("port", kind, n=120)
        return model, df
    df = _mixed("port", 80)
    if name == "ValueIndexerModel":
        return port_featurize.ValueIndexer(inputCol="city",
                                           outputCol="i").fit(df), df
    if name == "CleanMissingDataModel":
        return port_featurize.CleanMissingData(inputCols=["income"]).fit(df), df
    if name == "AssembleFeaturesModel":
        return port_featurize.AssembleFeatures(
            inputCols=["age", "city", "income"]).fit(df), df
    text = DataFrame.from_dict({"t": _text_corpus()})
    if name == "TextFeaturizerModel":
        return port_featurize.TextFeaturizer(
            inputCol="t", outputCol="f", useNGram=True).fit(text), text
    if name == "Word2VecModel":
        return port_featurize.Word2Vec(inputCol="t", outputCol="v",
                                       vectorSize=4, numIterations=1).fit(
            text), text
    if name == "ClassBalancerModel":
        return port_stage_lib.ClassBalancer(inputCol="city").fit(df), df
    if name == "TimerModel":
        t = port_stage_lib.Timer()
        t.set("stage", port_featurize.ValueIndexer(inputCol="city",
                                                   outputCol="i"))
        return t.fit(df), df
    if name == "Lambda":
        return port_stage_lib.Lambda(_double), _basic("port")
    if name == "UDFTransformer":
        t = port_stage_lib.UDFTransformer(inputCol="numbers", outputCol="sq")
        t.set("udf", _square)
        t.set("deviceUdf", _double_tensor)
        return t, _basic("port")
    raise AssertionError(name)


@pytest.mark.parametrize("name", [
    "ValueIndexerModel", "CleanMissingDataModel", "AssembleFeaturesModel",
    "TextFeaturizerModel", "Word2VecModel", "ClassBalancerModel", "TimerModel",
    "TrainedClassifierModel", "TrainedRegressorModel", "Lambda",
    "UDFTransformer"])
def test_new_stages_save_and_load_bitwise(tmp_path, name):
    """Every model stage of the slice saved and loaded gives the same frame
    bit for bit; stages holding a callable keep it by pickle (a module
    function here)."""
    with use_device("cpu"):
        stage, df = _roundtrip_stage(name)
        want = stage.transform(df)
        stage.save(str(tmp_path / "s"))
        loaded = PipelineStage.load(str(tmp_path / "s"))
        assert type(loaded) is type(stage)
        got = loaded.transform(df)
    _same_frame(want, got)
    if name == "UDFTransformer":
        assert loaded.get("deviceUdf") is _double_tensor
        assert _pickle.loads(_pickle.dumps(loaded.get("udf"))) is _square
