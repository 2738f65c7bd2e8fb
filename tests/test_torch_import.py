"""The port stands alone: no JAX, no reference package, no silent CPU.

``mmlspark_tpu_torch`` must import without pulling in ``jax`` or any module
of ``mmlspark_tpu`` (the prefixes overlap, so the checks use exact module
keys), and its entry points must refuse to run when they default to CUDA on
a host without it.
"""

import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "mmlspark_tpu_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
import mmlspark_tpu_torch
names = ["mmlspark_tpu_torch"]
for m in pkgutil.walk_packages(mmlspark_tpu_torch.__path__, "mmlspark_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "mmlspark_tpu")
             or k.startswith(("jax.", "jaxlib.", "mmlspark_tpu.")))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_clean_import_pulls_in_no_jax_and_no_reference():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == [], out["bad"]
    for mod in ("mmlspark_tpu_torch.gbdt.stages", "mmlspark_tpu_torch.gbdt.tree",
                "mmlspark_tpu_torch.gbdt.hist_kernel",
                "mmlspark_tpu_torch.gbdt.select_kernel",
                "mmlspark_tpu_torch.gbdt.sparse",
                "mmlspark_tpu_torch.gbdt.sparse_hist_kernel",
                "mmlspark_tpu_torch.gbdt.convert", "mmlspark_tpu_torch.runtime",
                "mmlspark_tpu_torch.gbdt.gather_kernel",
                "mmlspark_tpu_torch.core.fusion",
                "mmlspark_tpu_torch.core.device_stage",
                "mmlspark_tpu_torch.core.kernels",
                "mmlspark_tpu_torch.parallel.ingest",
                "mmlspark_tpu_torch.models.module",
                "mmlspark_tpu_torch.models.attention",
                "mmlspark_tpu_torch.models.flash_kernel",
                "mmlspark_tpu_torch.models.dnn_model",
                "mmlspark_tpu_torch.models.convert",
                "mmlspark_tpu_torch.models.training",
                "mmlspark_tpu_torch.models.checkpoint",
                "mmlspark_tpu_torch.serving.server",
                "mmlspark_tpu_torch.serving.executor",
                "mmlspark_tpu_torch.serving.routing",
                "mmlspark_tpu_torch.io.binary",
                "mmlspark_tpu_torch.obs.bridge",
                "mmlspark_tpu_torch.native_loader",
                "mmlspark_tpu_torch.core.profiling",
                "mmlspark_tpu_torch.gbdt.graphs",
                "mmlspark_tpu_torch.gbdt.booster",
                "mmlspark_tpu_torch.core.threefry",
                "mmlspark_tpu_torch.core.graphs",
                "mmlspark_tpu_torch.core.costmodel",
                "mmlspark_tpu_torch.core.tune",
                "mmlspark_tpu_torch.obs.perf",
                "mmlspark_tpu_torch.parallel.batching",
                "mmlspark_tpu_torch.parallel.shardplan",
                "mmlspark_tpu_torch.parallel.pipeplan",
                "mmlspark_tpu_torch.models.resnet",
                "mmlspark_tpu_torch.models.torch_import",
                "mmlspark_tpu_torch.models.moe",
                "mmlspark_tpu_torch.ops.image",
                "mmlspark_tpu_torch.io.image",
                "mmlspark_tpu_torch.image.stages",
                "mmlspark_tpu_torch.image.featurizer",
                "mmlspark_tpu_torch.onnx.proto",
                "mmlspark_tpu_torch.onnx.importer",
                "mmlspark_tpu_torch.onnx.export",
                "mmlspark_tpu_torch.models.graph_module",
                "mmlspark_tpu_torch.ops.hashing",
                "mmlspark_tpu_torch.vw.featurizer",
                "mmlspark_tpu_torch.vw.learner",
                "mmlspark_tpu_torch.vw.scan_kernel",
                "mmlspark_tpu_torch.vw.stages",
                "mmlspark_tpu_torch.core.utils",
                "mmlspark_tpu_torch.featurize.indexers",
                "mmlspark_tpu_torch.featurize.clean",
                "mmlspark_tpu_torch.featurize.text",
                "mmlspark_tpu_torch.featurize.assemble",
                "mmlspark_tpu_torch.featurize.word2vec",
                "mmlspark_tpu_torch.stages.basic",
                "mmlspark_tpu_torch.stages.minibatch",
                "mmlspark_tpu_torch.stages.text",
                "mmlspark_tpu_torch.stages.udfs",
                "mmlspark_tpu_torch.train.metrics",
                "mmlspark_tpu_torch.train.stages",
                "mmlspark_tpu_torch.ops.lasso",
                "mmlspark_tpu_torch.automl.params",
                "mmlspark_tpu_torch.automl.hyperparams",
                "mmlspark_tpu_torch.automl.tuning",
                "mmlspark_tpu_torch.recommendation.indexer",
                "mmlspark_tpu_torch.recommendation.sar",
                "mmlspark_tpu_torch.recommendation.ranking",
                "mmlspark_tpu_torch.lime.superpixel",
                "mmlspark_tpu_torch.lime.lime"):
        assert mod in out["imported"]


_DRAW_PROBE = r"""
import json, sys
from mmlspark_tpu_torch.core import threefry
keys = threefry.split(threefry.prng_key(42), 5)
u = threefry.uniform(keys[3], 1000)
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "mmlspark_tpu")
             or k.startswith(("jax.", "jaxlib.", "mmlspark_tpu.")))
print(json.dumps({"bad": bad, "keys": keys.tolist(),
                  "bits": u.view(__import__("torch").int32).tolist()}))
"""


def test_threefry_draws_in_a_process_without_jax():
    """The GOSS scan's random draws (``core/threefry.py``) run in a fresh
    process that imports neither ``jax`` nor ``mmlspark_tpu``, and give
    the bits JAX gives here."""
    import jax

    proc = subprocess.run([sys.executable, "-c", _DRAW_PROBE], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    keys = jax.random.split(jax.random.PRNGKey(42), 5)
    assert out["keys"] == np.asarray(keys).astype(np.int64).tolist()
    want = np.asarray(jax.random.uniform(keys[3], (1000,))).view(np.int32)
    assert out["bits"] == want.tolist()


@pytest.mark.parametrize("module", ["mmlspark_tpu_torch.core.fusion",
                                    "mmlspark_tpu_torch.models",
                                    "mmlspark_tpu_torch.models.training",
                                    "mmlspark_tpu_torch.models.checkpoint"])
def test_fused_pipeline_import_pulls_in_no_jax_and_no_reference(module):
    probe = (f"import json, sys; import {module}; "
             "print(json.dumps(sorted(k for k in sys.modules if k in "
             "('jax', 'jaxlib', 'mmlspark_tpu') or k.startswith(('jax.', "
             "'jaxlib.', 'mmlspark_tpu.')))))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


_SERVE_PROBE = r"""
import json, sys, urllib.request
import numpy as np
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.pipeline import PipelineModel
from mmlspark_tpu_torch.gbdt import LightGBMRegressor
from mmlspark_tpu_torch.io.binary import FRAME_CONTENT_TYPE, encode_frame
from mmlspark_tpu_torch.runtime import use_device
from mmlspark_tpu_torch.serving import serve_pipeline
import mmlspark_tpu_torch.obs
X = np.random.default_rng(0).standard_normal((64, 3))
df = DataFrame.from_dict({"features": [r for r in X], "label": X[:, 0]})
with use_device("cpu"):
    model = LightGBMRegressor(numIterations=2, numLeaves=4).fit(df)
    server = serve_pipeline(PipelineModel([model]), "features", fused=True,
                            async_exec=True, http_mode="async",
                            reply_col="prediction")
with server:
    req = urllib.request.Request(server.address, data=encode_frame({"x": X[0]}),
                                 headers={"Content-Type": FRAME_CONTENT_TYPE})
    with urllib.request.urlopen(req, timeout=60) as resp:
        status = resp.status
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "mmlspark_tpu")
             or k.startswith(("jax.", "jaxlib.", "mmlspark_tpu.")))
print(json.dumps({"bad": bad, "status": status}))
"""


@pytest.mark.parametrize("module", ["mmlspark_tpu_torch.serving",
                                    "mmlspark_tpu_torch.obs",
                                    "mmlspark_tpu_torch.io"])
def test_serving_obs_io_import_pulls_in_no_jax_and_no_reference(module):
    probe = (f"import json, sys; import {module}; "
             "print(json.dumps(sorted(k for k in sys.modules if k in "
             "('jax', 'jaxlib', 'mmlspark_tpu') or k.startswith(('jax.', "
             "'jaxlib.', 'mmlspark_tpu.')))))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_serving_a_request_pulls_in_no_jax_and_no_reference():
    """Fit, serve (fused, pipelined, async transport) and answer a frame
    request in a fresh process without importing ``jax`` or
    ``mmlspark_tpu``."""
    proc = subprocess.run([sys.executable, "-c", _SERVE_PROBE], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "status": 200}


_TUNE_PROBE = r"""
import json, sys
import numpy as np
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.pipeline import PipelineModel
from mmlspark_tpu_torch.core.tune import Tuner
from mmlspark_tpu_torch.gbdt import LightGBMRegressor
from mmlspark_tpu_torch.runtime import use_device
X = np.random.default_rng(0).standard_normal((600, 3)).astype(np.float32)
df = DataFrame.from_dict({"features": [r for r in X], "label": X[:, 0]})
with use_device("cpu"):
    model = LightGBMRegressor(numIterations=2, numLeaves=4).fit(df)
    fused = PipelineModel([model]).fuse()
    fused.transform(df)
    tuner = Tuner(fused=fused)
    tuner.apply(tuner.propose())
    fused.set_tuning(mega_k={"LightGBMRegressionModel": 2})
    out = fused.transform_submit(df)()
    ks = [t.mega_k for t in fused.last_ingest_stats.records]
    summary = tuner.tune(lambda: 1.0, steps=1, warmup=0)
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "mmlspark_tpu")
             or k.startswith(("jax.", "jaxlib.", "mmlspark_tpu.")))
print(json.dumps({"bad": bad, "mega_k": ks, "rows": len(out.column("prediction")),
                  "steps": len(summary["steps"])}))
"""


def test_tuning_and_mega_dispatch_pull_in_no_jax_and_no_reference():
    """Build a Tuner and a mega-dispatching fused model, tune and score in a
    fresh process without importing ``jax`` or ``mmlspark_tpu``."""
    proc = subprocess.run([sys.executable, "-c", _TUNE_PROBE], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "mega_k": [2, 2, 1], "rows": 600, "steps": 2}


_IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|optax|orbax|mmlspark_tpu)(?:[.\s]|$)",
    re.M)


def test_source_has_no_jax_or_reference_import():
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if _IMPORT_RE.search(p.read_text())]
    assert offenders == []
    assert (PKG / "csrc" / "hist.cu").exists()
    assert (PKG / "csrc" / "select.cu").exists()
    assert (PKG / "csrc" / "sparse_hist.cu").exists()
    assert (PKG / "csrc" / "csr_gather.cu").exists()
    assert (PKG / "csrc" / "flash_attn.cu").exists()
    assert (PKG / "csrc" / "flash_attn_bwd.cu").exists()
    assert (PKG / "csrc" / "vw_scan.cu").exists()
    assert (PKG / "csrc" / "streams.cu").exists()
    assert (PKG / "native_src" / "mmlspark_native.cpp").exists()


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")


def test_entry_points_raise_without_cuda(no_cuda):
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import (DeviceEnsemble, LightGBMClassifier,
                                         TrainParams, train)
    from mmlspark_tpu_torch.runtime import default_device, use_device

    rng = np.random.default_rng(0)
    X = rng.standard_normal((200, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    params = TrainParams(objective="binary", num_iterations=2, num_leaves=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        train(params, X, y)
    df = DataFrame.from_dict({"features": [r for r in X], "label": y})
    with pytest.raises(RuntimeError, match="CUDA"):
        LightGBMClassifier(numIterations=2).fit(df)
    booster = train(params, X, y, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceEnsemble(booster.trees, 1)
    with use_device("cpu"):
        model = LightGBMClassifier(numIterations=2, numLeaves=4).fit(df)
        out = model.transform(df)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.transform(df)
    assert len(out.column("prediction")) == 200


@pytest.mark.parametrize("option", ["mesh"])
def test_later_slices_raise_not_implemented(option, monkeypatch):
    """A ``mesh=`` that is not the port's ``Mesh`` is a TypeError, and
    ``make_mesh`` takes every axis: one process cannot hold a mesh of two.
    The sharded fits refuse nothing of the reference's since ROADMAP A9j
    and A9k: a mesh described by hand with a tensor, fsdp, seq, expert or
    pipe axis of 2 and a data axis of 1 fits every row on this process, the
    one-process fit byte for byte, with query groups and a checkpoint."""
    from mmlspark_tpu_torch.gbdt import TrainParams, train
    from mmlspark_tpu_torch.gbdt.checkpoint import CheckpointConfig
    from mmlspark_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh

    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 2))
    y = (X[:, 0] > 0).astype(np.float64)
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_TRAIN", "0")
    params = TrainParams(objective="binary", num_iterations=2,
                         num_leaves=4, min_data_in_leaf=5)
    want = train(params, X, y, device="cpu").to_string()
    for axis in ("tensor", "fsdp", "seq", "expert", "pipe"):
        with pytest.raises(ValueError, match="needs 2 devices"):
            make_mesh(MeshSpec(data=1, **{axis: 2}), device="cpu")
        got = train(params, X, y, device="cpu",
                    mesh=Mesh(shape={"data": 1, axis: 2}))
        assert got.to_string() == want
    with pytest.raises(TypeError, match="Mesh"):
        train(TrainParams(), X, y, device="cpu", mesh=object())
    one = Mesh(shape={"data": 1, "tensor": 2})
    rank = TrainParams(objective="lambdarank", num_iterations=2,
                       num_leaves=4, min_data_in_leaf=5)
    q = np.repeat(np.arange(8), 8)
    assert train(rank, X, y, device="cpu", groups=q,
                 mesh=one).to_string() == \
        train(rank, X, y, device="cpu", groups=q).to_string()
    with tempfile.TemporaryDirectory() as tmp:
        ck = CheckpointConfig(os.path.join(tmp, "fit.ckpt"), every_k=1)
        assert train(params, X, y, device="cpu", mesh=one,
                     checkpoint=ck).to_string() == want


_LOAD_PROBE = r"""
import json, sys
import numpy as np
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.runtime import use_device
stage = PipelineStage.load(sys.argv[1])
X = np.load(sys.argv[2])
with use_device("cpu"):
    out = stage.transform(DataFrame.from_dict({"features": [r for r in X]}))
raw = np.stack(list(out.column("rawPrediction")))
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "mmlspark_tpu")
             or k.startswith(("jax.", "jaxlib.", "mmlspark_tpu.")))
print(json.dumps({"bad": bad, "raw": raw.tolist(), "cls": type(stage).__name__}))
"""


@pytest.mark.parametrize("what", ["categorical_model", "pipeline_model"])
def test_loading_a_saved_stage_pulls_in_no_jax_and_no_reference(tmp_path,
                                                                 what):
    """A stage the port saved loads and scores in a fresh process without
    importing ``jax`` or ``mmlspark_tpu``, with the scores it had."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.runtime import use_device

    rng = np.random.default_rng(3)
    X = rng.standard_normal((300, 3))
    X[:, 0] = rng.integers(0, 9, 300)
    y = np.isin(X[:, 0], (1, 4, 6)).astype(np.float64)
    df = DataFrame.from_dict({"features": [r for r in X], "label": y})
    with use_device("cpu"):
        model = LightGBMClassifier(numIterations=3, numLeaves=4, minDataInLeaf=5,
                                   categoricalSlotIndexes=[0]).fit(df)
        raw = np.stack(list(model.transform(df).column("rawPrediction")))
    stage = model if what == "categorical_model" else PipelineModel([model]).fuse()
    stage.save(str(tmp_path / "stage"))
    np.save(tmp_path / "X.npy", X)
    proc = subprocess.run([sys.executable, "-c", _LOAD_PROBE,
                           str(tmp_path / "stage"), str(tmp_path / "X.npy")],
                          cwd=str(ROOT), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["cls"] == ("LightGBMClassificationModel"
                          if what == "categorical_model" else "PipelineModel")
    np.testing.assert_array_equal(np.asarray(out["raw"]), raw)


_FEATURIZER_PROBE = r"""
import json, sys
import numpy as np
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.io.image import read_images
from mmlspark_tpu_torch.runtime import use_device
stage = PipelineStage.load(sys.argv[1])
with use_device("cpu"):
    out = stage.transform(read_images(sys.argv[2]))
feats = np.stack(list(out.column("features")))
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "mmlspark_tpu")
             or k.startswith(("jax.", "jaxlib.", "mmlspark_tpu.")))
print(json.dumps({"bad": bad, "features": feats.tolist(),
                  "paths": [str(p) for p in out.column("path")],
                  "cls": type(stage).__name__}))
"""


def test_loading_a_saved_image_featurizer_pulls_in_no_jax_and_no_reference(
        tmp_path):
    """An ImageFeaturizer (a ResNet-18 backbone, width 8) the port saved
    loads in a fresh process and featurizes images read from a directory
    (PPM files through ``io.image.read_images``) without importing ``jax``
    or ``mmlspark_tpu``, with the features it had."""
    from mmlspark_tpu_torch.image import ImageFeaturizer
    from mmlspark_tpu_torch.io.image import read_images
    from mmlspark_tpu_torch.models import resnet
    from mmlspark_tpu_torch.ops.image import encode_ppm
    from mmlspark_tpu_torch.runtime import use_device

    rng = np.random.default_rng(5)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(3):
        (imgs / f"{i}.ppm").write_bytes(
            encode_ppm(rng.integers(0, 256, (20, 14, 3), dtype=np.uint8)))
    (imgs / "broken.ppm").write_bytes(b"not an image")
    stage = ImageFeaturizer(inputCol="image", outputCol="features",
                            batchSize=2, scaleFactor=1 / 255).set_model(
        resnet(18, num_classes=10, image_size=16, width=8))
    with use_device("cpu"):
        df = read_images(str(imgs))
        want = np.stack(list(stage.transform(df).column("features")))
    assert df.count() == 3            # the undecodable file dropped
    stage.save(str(tmp_path / "stage"))
    proc = subprocess.run([sys.executable, "-c", _FEATURIZER_PROBE,
                           str(tmp_path / "stage"), str(imgs)],
                          cwd=str(ROOT), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == [] and out["cls"] == "ImageFeaturizer"
    assert [pathlib.Path(p).name for p in out["paths"]] == ["0.ppm", "1.ppm",
                                                          "2.ppm"]
    np.testing.assert_array_equal(np.asarray(out["features"], np.float32), want)


_VW_ONNX_PROBE = r"""
import json, sys
import numpy as np
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.runtime import use_device
vw = PipelineStage.load(sys.argv[1])
dnn = PipelineStage.load(sys.argv[2])
rows = json.loads(open(sys.argv[3]).read())
feats = [{"indices": np.asarray(r[0], np.int64),
          "values": np.asarray(r[1], np.float32)} for r in rows["vw"]]
with use_device("cpu"):
    raw = vw.transform(DataFrame.from_dict({"features": feats})).column(
        "rawPrediction")
    emb = dnn.transform(DataFrame.from_dict(
        {"ids": [np.asarray(r, np.int64) for r in rows["ids"]],
         "mask": [np.asarray(r, np.int64) for r in rows["mask"]]})).column("emb")
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "mmlspark_tpu")
             or k.startswith(("jax.", "jaxlib.", "mmlspark_tpu.")))
print(json.dumps({"bad": bad, "raw": np.asarray(raw, np.float64).tolist(),
                  "emb": np.stack(list(emb)).tolist(),
                  "cls": [type(vw).__name__, type(dnn).__name__]}))
"""


def test_loading_saved_vw_and_onnx_stages_pulls_in_no_jax_and_no_reference(
        tmp_path):
    """A VW classification model and a two-input ``DNNModel`` over an
    imported ONNX graph, saved by the port, load and score in a fresh
    process without importing ``jax`` or ``mmlspark_tpu``, with the scores
    they had."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models import DNNModel
    from mmlspark_tpu_torch.onnx import import_onnx
    from mmlspark_tpu_torch.runtime import use_device
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier

    cs = _load_chip_smoke()
    rng = np.random.default_rng(9)
    feats = [{"indices": np.sort(rng.choice(1 << 10, 6, replace=False)),
              "values": rng.standard_normal(6).astype(np.float32)}
             for _ in range(80)]
    y = (np.array([f["values"].sum() for f in feats]) > 0).astype(np.float64)
    ids, mask = cs.bert_inputs(6, 8, 50, seed=1)
    with use_device("cpu"):
        vw = VowpalWabbitClassifier(numBits=10).fit(
            DataFrame.from_dict({"features": feats, "label": y}))
        raw = np.asarray(vw.transform(DataFrame.from_dict(
            {"features": feats})).column("rawPrediction"), np.float64)
        dnn = DNNModel(outputCol="emb", batchSize=4).set_model(import_onnx(
            cs.bert_onnx(vocab=50, hidden=16, heads=2, ffn=32, layers=1,
                         seq=8, seed=2))).set_feed_dict(
            {"input_ids": "ids", "attention_mask": "mask"})
        emb = np.stack(list(dnn.transform(DataFrame.from_dict(
            {"ids": list(ids), "mask": list(mask)})).column("emb")))
    vw.save(str(tmp_path / "vw"))
    dnn.save(str(tmp_path / "dnn"))
    (tmp_path / "rows.json").write_text(json.dumps(
        {"vw": [[f["indices"].tolist(), f["values"].tolist()] for f in feats],
         "ids": ids.tolist(), "mask": mask.tolist()}))
    proc = subprocess.run([sys.executable, "-c", _VW_ONNX_PROBE,
                           str(tmp_path / "vw"), str(tmp_path / "dnn"),
                           str(tmp_path / "rows.json")],
                          cwd=str(ROOT), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["cls"] == ["VowpalWabbitClassificationModel", "DNNModel"]
    np.testing.assert_array_equal(np.asarray(out["raw"]), raw)
    np.testing.assert_array_equal(np.asarray(out["emb"], np.float32), emb)


_TRAINED_PROBE = r"""
import json, sys
import numpy as np
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.runtime import use_device
rows = json.loads(open(sys.argv[3]).read())
clf = PipelineStage.load(sys.argv[1])
text = PipelineStage.load(sys.argv[2])
with use_device("cpu"):
    scored = clf.transform(DataFrame.from_dict(rows["table"]))
    feats = text.transform(DataFrame.from_dict({"t": rows["texts"]}))
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "mmlspark_tpu")
             or k.startswith(("jax.", "jaxlib.", "mmlspark_tpu.")))
print(json.dumps({
    "bad": bad, "cls": [type(clf).__name__, type(text).__name__],
    "proba": np.stack(list(scored.column("scored_probabilities"))).tolist(),
    "labels": list(scored.column("scored_labels_original")),
    "rows": [[r["size"], r["indices"].tolist(), r["values"].tolist()]
             for r in feats.column("f")]}))
"""


def test_loading_trained_classifier_and_text_featurizer_pulls_in_no_jax(
        tmp_path):
    """A ``TrainedClassifierModel`` (auto-featurized strings, reindexed
    string labels, LightGBM) and a ``TextFeaturizerModel`` the port saved
    load and run in a fresh process without importing ``jax`` or
    ``mmlspark_tpu``, with the scores and rows they had."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.featurize import TextFeaturizer
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.runtime import use_device
    from mmlspark_tpu_torch.train import TrainClassifier

    rng = np.random.default_rng(11)
    n = 200
    city = [str(c) for c in rng.choice(["nyc", "sf", "la"], n)]
    age = rng.uniform(20, 70, n)
    label = ["yes" if a > 45 or c == "sf" else "no" for a, c in zip(age, city)]
    table = {"age": age.tolist(), "city": city, "label": label}
    texts = ["the cat sat", "a dog, a cat", None, "", "café au lait x"] * 4
    with use_device("cpu"):
        clf = TrainClassifier(labelCol="label").set_model(LightGBMClassifier(
            numIterations=4, numLeaves=4, minDataInLeaf=5)).fit(
            DataFrame.from_dict(table))
        scored = clf.transform(DataFrame.from_dict(table))
        text = TextFeaturizer(inputCol="t", outputCol="f").fit(
            DataFrame.from_dict({"t": texts}))
        feats = text.transform(DataFrame.from_dict({"t": texts})).column("f")
    clf.save(str(tmp_path / "clf"))
    text.save(str(tmp_path / "text"))
    (tmp_path / "rows.json").write_text(json.dumps({"table": table,
                                                    "texts": texts}))
    proc = subprocess.run([sys.executable, "-c", _TRAINED_PROBE,
                           str(tmp_path / "clf"), str(tmp_path / "text"),
                           str(tmp_path / "rows.json")], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["cls"] == ["TrainedClassifierModel", "TextFeaturizerModel"]
    np.testing.assert_array_equal(
        np.asarray(out["proba"]),
        np.stack(list(scored.column("scored_probabilities"))))
    assert out["labels"] == list(scored.column("scored_labels_original"))
    for got, want in zip(out["rows"], feats):
        assert got[0] == want["size"] == 1 << 18
        np.testing.assert_array_equal(np.asarray(got[1], np.int64),
                                      want["indices"])
        np.testing.assert_array_equal(np.asarray(got[2], np.float32),
                                      want["values"])


@pytest.mark.parametrize("module", ["mmlspark_tpu_torch.featurize",
                                    "mmlspark_tpu_torch.stages",
                                    "mmlspark_tpu_torch.train",
                                    "mmlspark_tpu_torch.core.utils"])
def test_featurize_stages_train_import_pulls_in_no_jax_and_no_reference(
        module):
    probe = (f"import json, sys; import {module}; "
             "print(json.dumps(sorted(k for k in sys.modules if k in "
             "('jax', 'jaxlib', 'mmlspark_tpu') or k.startswith(('jax.', "
             "'jaxlib.', 'mmlspark_tpu.')))))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_word2vec_fit_raises_without_cuda(no_cuda):
    """Word2Vec trains on ``resolve_device()``: without a card and without
    a request for the CPU it raises, as every entry point does."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.featurize import Word2Vec
    from mmlspark_tpu_torch.runtime import use_device

    df = DataFrame.from_dict({"t": ["a b a b", "b a b a"] * 3})
    est = Word2Vec(inputCol="t", outputCol="v", vectorSize=4, minCount=1,
                   numIterations=1, batchSize=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        est.fit(df)
    with use_device("cpu"):
        assert est.fit(df).get("vectors").shape == (2, 4)


# ------------------------------------------------------------ native loader


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The port's native loader with no library loaded yet, building into
    ``tmp_path`` (``MMLSPARK_TORCH_BUILD_DIR``); every ``_build`` call
    counted."""
    from mmlspark_tpu_torch import native_loader

    monkeypatch.setenv("MMLSPARK_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_build_attempted", False)
    builds = []
    orig = native_loader._build

    def counted(out):
        builds.append(out)
        return orig(out)

    monkeypatch.setattr(native_loader, "_build", counted)
    return native_loader, builds


def test_native_library_builds_into_the_ignored_build_dir(fresh_native):
    """Built at first use with g++ into ``native/`` under the kernels'
    build directory (``build/torch_kernels`` beside the package, which
    ``.gitignore`` lists), named by the ABI version and the host CPU."""
    from mmlspark_tpu_torch import _kernels

    loader, builds = fresh_native
    path = loader.so_path()
    assert path.parent == _kernels.build_dir() / "native"
    assert f".v{loader.ABI_VERSION}." in path.name
    assert loader.available() and path.exists() and len(builds) == 1
    assert loader.load().mml_version() == 5
    assert loader.available() and len(builds) == 1       # loaded once
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert "-ffp-contract=off" in loader.CXX_FLAGS


@pytest.mark.parametrize("bad", ["corrupt", "abi"])
def test_a_bad_library_is_rebuilt_once(fresh_native, tmp_path, monkeypatch,
                                       bad):
    """A file that does not load, or reports another ABI version, gets one
    rebuild; when that rebuild fails too, the loader gives up (None) and
    does not build again in this process."""
    import subprocess as sp

    loader, builds = fresh_native
    path = loader.so_path()
    path.parent.mkdir(parents=True)
    if bad == "corrupt":
        path.write_bytes(b"\x7fELF not a library")
    else:
        src = tmp_path / "old.cpp"
        src.write_text('extern "C" int mml_version() { return 4; }\n')
        sp.run(["g++", "-shared", "-fPIC", "-o", str(path), str(src)],
               check=True)
    assert loader.load() is not None and len(builds) == 1
    assert loader.load().mml_version() == loader.ABI_VERSION
    # a broken toolchain, in a fresh build directory (the loaded library
    # stays mapped where it is): the one rebuild fails, then no more tries
    monkeypatch.setenv("MMLSPARK_TORCH_BUILD_DIR", str(tmp_path / "again"))
    loader._lib = None
    loader._build_attempted = False
    path = loader.so_path()
    path.parent.mkdir(parents=True)
    path.write_bytes(b"garbage")
    builds.clear()
    orig_run = sp.run

    def failing_run(cmd, *a, **kw):
        if cmd and cmd[0] == "g++":
            raise sp.CalledProcessError(1, cmd)
        return orig_run(cmd, *a, **kw)

    sp.run = failing_run
    try:
        assert loader.load() is None and len(builds) == 1
        assert loader.load() is None and len(builds) == 1
        assert not loader.available()
    finally:
        sp.run = orig_run


# ---------------------------------------------------------------- profiling


def test_profiling_on_the_cpu(tmp_path, monkeypatch):
    """``core.profiling`` on the CPU: a trace written to its directory with
    a named span, ``profile_transform`` of a stage, no device memory to
    report, and ``device_busy``'s busy share, top operations and idle gaps
    from device intervals (given here: a CPU trace has none)."""
    from mmlspark_tpu_torch.core import profiling
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import LightGBMRegressor
    from mmlspark_tpu_torch.runtime import use_device

    with profiling.trace(str(tmp_path / "t")) as prof:
        with profiling.annotate("span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "t" / "trace.json").exists()
    assert "span" in (tmp_path / "t" / "trace.json").read_text()
    assert profiling.device_busy(prof)["busy_share"] is None
    assert profiling.device_memory_stats() == []
    X = np.random.default_rng(0).standard_normal((300, 3))
    df = DataFrame.from_dict({"features": [r for r in X], "label": X[:, 0]})
    with use_device("cpu"):
        model = LightGBMRegressor(numIterations=2, numLeaves=4).fit(df)
        res = profiling.profile_transform(model, df, iterations=2)
    assert res["elapsed_s"] > 0 and res["per_call_s"] == res["elapsed_s"] / 2
    monkeypatch.setattr(profiling, "_device_intervals", lambda p: [
        (0.0, 10.0, "a"), (5.0, 20.0, "b"), (40.0, 50.0, "a"),
        (90.0, 100.0, "c")])
    busy = profiling.device_busy(object())
    assert busy["busy_ms"] == pytest.approx(0.04)
    assert busy["window_ms"] == pytest.approx(0.1)
    assert busy["busy_share"] == pytest.approx(0.4)
    assert [t["name"] for t in busy["top"]] == ["a", "b", "c"]
    assert [g["ms"] for g in busy["longest_gaps_ms"]] == \
        pytest.approx([0.04, 0.02])
    wide = profiling.device_busy(object(), window_us=(-100.0, 100.0))
    assert wide["busy_share"] == pytest.approx(0.2)
    assert wide["longest_gaps_ms"][0]["ms"] == pytest.approx(0.1)


# ------------------------------------------------------------------ ONNX
#
# The same ONNX bytes (written by the reference's test fixtures,
# tests/test_onnx.py, with the reference's writer) go through the
# reference's import_onnx(...).apply and the port's. Tolerances, against the
# reference's output's max |x|: integer and data-movement outputs bit for
# bit; elementwise and normalisation graphs 1e-5; conv and recurrent graphs
# 1e-4.

ONNX_ELEMENTWISE_TOL = 1e-5
ONNX_CONV_RNN_TOL = 1e-4


def _onnx_fixtures():
    import test_onnx as ref_fixtures   # the reference's tests/test_onnx.py

    return ref_fixtures


def _load_chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_onnx():
    from mmlspark_tpu.onnx import import_onnx as ref_import
    from mmlspark_tpu.onnx import proto as ref_proto

    return ref_import, ref_proto


def _both(blob, x, tap=None, **kw):
    """(reference output, port output) of the same bytes on the same input."""
    from mmlspark_tpu_torch.onnx import import_onnx

    ref_import, _ = _ref_onnx()
    ref = ref_import(blob, **kw)
    port = import_onnx(blob, **kw)
    want = np.asarray(ref.apply(x, tap=tap) if tap else ref.apply(x))
    feed = ({k: torch.from_numpy(v) for k, v in x.items()}
            if isinstance(x, dict) else torch.from_numpy(x))
    got = port.apply(feed, tap=tap).numpy()
    return want, got, ref, port


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64).reshape(np.shape(want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_proto_writer_emits_the_reference_bytes():
    """The port's writer emits the reference's bytes for the same nodes,
    tensors and value infos, and the port's reader parses the reference's
    bytes to the same fields."""
    from mmlspark_tpu_torch.onnx import proto

    _, ref_proto = _ref_onnx()
    rng = np.random.default_rng(0)
    tensors = [("w", rng.standard_normal((4, 3)).astype(np.float32)),
               ("i", np.array([1, -5, 2 ** 40], dtype=np.int64)),
               ("b", np.array([True, False]))]
    attrs = dict(strides=[2, 2], pads=[3, 3, 3, 3], epsilon=1e-5,
                 mode="constant", floats=[0.5, 1.5], group=2)
    blobs = []
    for mod in (proto, ref_proto):
        nodes = [mod.make_node("Gemm", ["input", "w"], ["out"], name="g",
                               transB=1),
                 mod.make_node("Conv", ["out", "w"], ["y"], name="c",
                               **attrs),
                 mod.make_node("Constant", [], ["k"],
                               value=mod.make_tensor("kv", tensors[1][1]))]
        inits = [mod.make_tensor(n, a) for n, a in tensors]
        blobs.append(mod.make_model(
            nodes, inits, [mod.make_value_info("input", [None, 3])],
            [mod.make_value_info("y", [None, 4], mod.DT_FLOAT)], opset=17))
    assert blobs[0] == blobs[1]
    mine, theirs = proto.load_model(blobs[1]), ref_proto.load_model(blobs[0])
    assert (mine.ir_version, mine.producer, mine.opset) == \
        (theirs.ir_version, theirs.producer, theirs.opset) == (7, "mmlspark_tpu", 17)
    for a, b in zip(mine.graph.nodes, theirs.graph.nodes):
        assert (a.op_type, a.name, a.inputs, a.outputs) == \
            (b.op_type, b.name, b.inputs, b.outputs)
        assert set(a.attrs) == set(b.attrs)
        for k in a.attrs:
            va, vb = a.attrs[k], b.attrs[k]
            if hasattr(va, "to_numpy"):
                np.testing.assert_array_equal(va.to_numpy(), vb.to_numpy())
            else:
                assert va == vb
    for a, b in zip(mine.graph.initializers, theirs.graph.initializers):
        assert a.name == b.name and a.dims == b.dims
        np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
    assert [(v.name, v.dims, v.elem_type) for v in mine.graph.inputs] == \
        [(v.name, v.dims, v.elem_type) for v in theirs.graph.inputs]


def test_export_resnet18_is_byte_identical_to_the_reference():
    """The JAX package's resnet18 weights carried into the port's ResNet-18
    (``load_jax_params``): the port's export_onnx writes the reference's
    bytes, and both imports of them score the same (conv family: 1e-4 of
    the logits' max |x|)."""
    import importlib

    import jax

    from mmlspark_tpu.onnx import export_onnx as ref_export
    from mmlspark_tpu_torch.models import load_jax_params, resnet18
    from mmlspark_tpu_torch.onnx import export_onnx

    ref_resnet = importlib.import_module("mmlspark_tpu.models.resnet")
    ref = ref_resnet.resnet18(num_classes=10, image_size=32, seed=0)
    params = jax.tree.map(np.asarray, ref.params)
    want = ref_export(ref.module, params, (32, 32, 3), name="r18")
    port = load_jax_params(resnet18(num_classes=10, image_size=32), params)
    got = export_onnx(port.module, port.params, (32, 32, 3), name="r18")
    assert got == want
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)
    a, b, ref_m, port_m = _both(got, x)
    assert _rel_err(b, a) <= ONNX_CONV_RNN_TOL
    assert port_m.layer_names == ref_m.layer_names
    assert port_m.data_format == "NCHW" and port_m.input_shape == (3, 32, 32)


def _torch_seq_case(name):
    """(torch model, per-example shape, tolerance) of a reference fixture
    built through its ``_onnx_from_torch_seq``."""
    import torch.nn as nn

    if name == "conv_bn_relu_pool_linear":
        torch.manual_seed(0)
        m = nn.Sequential(
            nn.Conv2d(3, 8, 3, stride=2, padding=1), nn.BatchNorm2d(8),
            nn.ReLU(), nn.MaxPool2d(3, stride=2, padding=1),
            nn.Conv2d(8, 16, 1), nn.ReLU(), nn.AdaptiveAvgPool2d(1),
            nn.Flatten(), nn.Linear(16, 5))
        m[1].running_mean.normal_(0, 0.5)
        m[1].running_var.uniform_(0.5, 2.0)
        return m, (3, 17, 17), ONNX_CONV_RNN_TOL
    if name == "grouped_conv":
        torch.manual_seed(1)
        m = nn.Sequential(
            nn.Conv2d(4, 8, 3, padding=1), nn.ReLU(),
            nn.Conv2d(8, 8, 3, padding=1, groups=8), nn.Sigmoid(),
            nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(8, 3))
        return m, (4, 12, 12), ONNX_CONV_RNN_TOL
    if name == "avgpool_dropout":
        torch.manual_seed(2)
        m = nn.Sequential(
            nn.Conv2d(2, 4, 5, padding=2), nn.ReLU(), nn.Dropout(0.5),
            nn.AvgPool2d(2), nn.Flatten(), nn.Linear(4 * 8 * 8, 6))
        return m, (2, 16, 16), ONNX_CONV_RNN_TOL
    if name == "layernorm_gelu_mlp":
        torch.manual_seed(5)
        m = nn.Sequential(
            nn.Flatten(), nn.Linear(12, 16), nn.LayerNorm(16), nn.GELU(),
            nn.Linear(16, 8), nn.LayerNorm(8), nn.ELU(), nn.Linear(8, 3))
        return m, (12,), ONNX_ELEMENTWISE_TOL
    if name == "conv_transpose_instance_norm":
        torch.manual_seed(6)
        m = nn.Sequential(
            nn.Conv2d(3, 8, 3, stride=2, padding=1),
            nn.InstanceNorm2d(8, affine=True), nn.ReLU(),
            nn.ConvTranspose2d(8, 4, 3, stride=2, padding=1, output_padding=1),
            nn.Softplus(),
            nn.ConvTranspose2d(4, 4, 4, stride=2, padding=1, groups=2))
        with torch.no_grad():
            m[1].weight.normal_(1.0, 0.2)
            m[1].bias.normal_(0, 0.2)
        return m, (3, 13, 13), ONNX_CONV_RNN_TOL
    raise KeyError(name)


@pytest.mark.parametrize("case", ["conv_bn_relu_pool_linear", "grouped_conv",
                                  "avgpool_dropout", "layernorm_gelu_mlp",
                                  "conv_transpose_instance_norm"])
def test_graph_module_matches_reference_on_torch_fixtures(tmp_path, case):
    """The reference's torch-packed fixtures (conv/bn/relu/pool/linear,
    grouped conv, avgpool/dropout, LayerNorm+Gelu MLP, ConvTranspose +
    InstanceNorm): conv graphs within 1e-4 and the MLP within 1e-5 of the
    reference output's max |x|."""
    model, shape, tol = _torch_seq_case(case)
    model.eval()
    path = _onnx_fixtures()._onnx_from_torch_seq(model, shape,
                                                 str(tmp_path / "m.onnx"))
    x = np.random.default_rng(7).normal(size=(4,) + shape).astype(np.float32)
    want, got, _, _ = _both(pathlib.Path(path).read_bytes(), x)
    assert got.shape == want.shape
    assert _rel_err(got, want) <= tol


def test_graph_module_attention_and_taps_match_reference(tmp_path):
    """The reference's MatMul/Softmax self-attention fixture: the output
    within 1e-5 of the reference's max |x|, and the tapped softmax (layer
    addressing) within 1e-5 too."""
    fx = _onnx_fixtures()
    rng = np.random.default_rng(0)
    D = 8
    ws = [(rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32)
          for _ in range(4)]
    path = fx.TestTransformerGraphImport._attention_onnx(
        None, *ws, 1.0 / np.sqrt(D), str(tmp_path / "attn.onnx"))
    blob = pathlib.Path(path).read_bytes()
    x = rng.normal(size=(3, 6, D)).astype(np.float32)
    want, got, ref, port = _both(blob, x, compute_dtype="float32")
    assert _rel_err(got, want) <= ONNX_ELEMENTWISE_TOL
    assert port.layer_names == ref.layer_names == \
        ["out_proj", "context", "attn_softmax", "scores"]
    want, got, _, _ = _both(blob, x, tap="attn_softmax",
                            layer_names=["out_proj", "attn_softmax"])
    assert got.shape == (3, 6, 6)
    assert _rel_err(got, want) <= ONNX_ELEMENTWISE_TOL


def test_graph_module_data_ops_bit_for_bit(tmp_path):
    """The reference's data-ops fixture (ReduceSum/ReduceMax/ArgMax/
    GreaterOrEqual/Where/Expand): the output within 1e-5 of the reference's
    max |x| and the ArgMax tap bit for bit; then Shape/Gather/Slice/Split/
    Concat/Reshape/compares on a graph of their own, bit for bit."""
    from mmlspark_tpu_torch.onnx import proto

    _, ref_proto = _ref_onnx()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)
    nodes = [
        ref_proto.make_node("ReduceSum", ["input", "axes1"], ["rsum"],
                            name="rsum", keepdims=1),
        ref_proto.make_node("ReduceMax", ["input"], ["rmax"], name="rmax",
                            axes=[2], keepdims=0),
        ref_proto.make_node("ArgMax", ["rmax"], ["amax"], name="amax",
                            axis=1, keepdims=0),
        ref_proto.make_node("GreaterOrEqual", ["input", "rsum"], ["ge"],
                            name="ge"),
        ref_proto.make_node("Where", ["ge", "input", "zero"], ["w"], name="w"),
        ref_proto.make_node("Expand", ["w", "eshape"], ["out"], name="out"),
    ]
    inits = [ref_proto.make_tensor("axes1", np.asarray([1], dtype=np.int64)),
             ref_proto.make_tensor("zero", np.asarray(0.0, dtype=np.float32)),
             ref_proto.make_tensor("eshape",
                                   np.asarray([2, 3, 4, 5], dtype=np.int64))]
    blob = ref_proto.make_model(
        nodes, inits, [ref_proto.make_value_info("input", [None, 4, 5])],
        [ref_proto.make_value_info("out", [2, 3, 4, 5])])
    want, got, _, _ = _both(blob, x, input_shape=(4, 5))
    assert _rel_err(got, want) <= ONNX_ELEMENTWISE_TOL
    want, got, _, _ = _both(blob, x, tap="amax", input_shape=(4, 5))
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))

    # the dynamic-batch shape idiom, slices, splits and compares
    P = proto
    nodes = [
        P.make_node("Shape", ["input"], ["shp"], name="shape"),
        # (the writer stores the 0-d index as [1]: the gather keeps its axis)
        P.make_node("Gather", ["shp", "i0"], ["bsz"], name="batch", axis=0),
        P.make_node("Squeeze", ["bsz", "ax0"], ["bsz0"], name="bsz0"),
        P.make_node("Unsqueeze", ["bsz0", "ax0"], ["bsz1"], name="bsz1"),
        P.make_node("Concat", ["bsz1", "m1"], ["flat_shape"], name="fshape",
                    axis=0),
        P.make_node("Reshape", ["input", "flat_shape"], ["flat"], name="flat"),
        P.make_node("Slice", ["flat", "st", "en", "axs", "stp"], ["sl"],
                    name="slice"),
        P.make_node("Split", ["sl"], ["s1", "s2"], name="split", axis=1,
                    split=[3, 5]),
        P.make_node("Less", ["s1", "thr"], ["lt"], name="less"),
        P.make_node("Cast", ["lt"], ["lti"], name="cast", to=7),
        P.make_node("Gather", ["s2", "cols"], ["g"], name="gather", axis=1),
        P.make_node("Transpose", ["g"], ["gt"], name="transpose"),
        P.make_node("ArgMin", ["gt"], ["amin"], name="amin", axis=0,
                    keepdims=0, select_last_index=1),
        P.make_node("Concat", ["lti", "lti"], ["out"], name="out", axis=1),
    ]
    inits = [P.make_tensor("i0", np.asarray(0, dtype=np.int64)),
             P.make_tensor("ax0", np.asarray([0], dtype=np.int64)),
             P.make_tensor("m1", np.asarray([-1], dtype=np.int64)),
             P.make_tensor("st", np.asarray([7, 0], dtype=np.int64)),
             P.make_tensor("en", np.asarray([-(2 ** 63), 2], dtype=np.int64)),
             P.make_tensor("axs", np.asarray([1, 0], dtype=np.int64)),
             P.make_tensor("stp", np.asarray([-1, 1], dtype=np.int64)),
             P.make_tensor("thr", np.asarray(0.1, dtype=np.float32)),
             P.make_tensor("cols", np.asarray([1, -2, 0], dtype=np.int64))]
    blob = P.make_model(nodes, inits,
                        [P.make_value_info("input", [None, 4, 5])],
                        [P.make_value_info("out", [None, 6])])
    for tap in (None, "slice", "gather", "amin", "shape", "flat"):
        want, got, _, _ = _both(blob, x, tap=tap, input_shape=(4, 5))
        assert got.shape == want.shape, tap
        if got.dtype.kind == "f":
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.astype(np.float32).view(np.uint32))
        else:
            np.testing.assert_array_equal(got.astype(np.int64),
                                          want.astype(np.int64))


@pytest.mark.parametrize("op", ["LSTM", "GRU"])
def test_graph_module_recurrent_matches_reference(tmp_path, op):
    """The reference's packed torch BiLSTM and GRU
    (``linear_before_reset=1``) fixtures through the ONNX LSTM/GRU ops:
    within 1e-4 of the reference output's max |x|."""
    import torch.nn as nn

    fx = _onnx_fixtures()
    torch.manual_seed(7 if op == "LSTM" else 8)
    T, B, I, H = (6, 2, 5, 7) if op == "LSTM" else (5, 3, 4, 6)
    rnn = nn.LSTM(I, H, bidirectional=True) if op == "LSTM" else nn.GRU(I, H)
    rnn.eval()
    path = fx.TestTransformerGraphImport._pack_rnn(
        None, op, rnn, I, H, tmp_path / "rnn.onnx",
        extra_attrs=None if op == "LSTM" else {"linear_before_reset": 1})
    x = np.random.default_rng(3).normal(size=(T, B, I)).astype(np.float32)
    want, got, _, _ = _both(pathlib.Path(path).read_bytes(), x,
                            input_shape=(B, I))
    assert got.shape == want.shape
    assert _rel_err(got, want) <= ONNX_CONV_RNN_TOL


def test_graph_module_resize_pad_clip_and_elementwise_ops():
    """Resize (nearest, linear up and antialiased down, cubic), Pad
    (constant, reflect, edge), Clip, HardSwish, LeakyRelu, Selu, Pow, Min,
    Max, Mean, Tile, ReduceProd/Mean, GlobalMaxPool, Gemm with alpha/beta:
    within 1e-5 of the reference output's max |x| (elementwise family)."""
    from mmlspark_tpu_torch.onnx import proto as P

    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 6, 8)).astype(np.float32)
    chain = [
        ("Resize", ["input", "", "up2"], dict(mode="nearest")),
        ("Resize", ["$", "", "", "down"], dict(mode="linear")),
        ("Resize", ["$", "", "up15"], dict(mode="linear")),
        ("Resize", ["$", "", "", "cub"], dict(mode="cubic")),
        ("Pad", ["$", "pads"], dict(mode="reflect")),
        ("Pad", ["$", "pads"], dict(mode="edge")),
        ("Pad", ["$", "pads", "pv"], {}),
        ("Clip", ["$", "lo", "hi"], {}),
        ("HardSwish", ["$"], {}),
        ("LeakyRelu", ["$"], dict(alpha=0.2)),
        ("Selu", ["$"], {}),
        ("Max", ["$", "half"], {}),
        ("Pow", ["$", "two"], {}),
        ("Min", ["$", "three"], {}),
        ("Mean", ["$", "half", "$"], {}),
        ("Tile", ["$", "reps"], {}),
        ("GlobalMaxPool", ["$"], {}),
        ("ReduceMean", ["$"], dict(axes=[2, 3], keepdims=0)),
        ("Gemm", ["$", "gw", "gb"], dict(alpha=0.5, beta=2.0, transB=1)),
    ]
    nodes, cur = [], "input"
    for i, (op, ins, attrs) in enumerate(chain):
        out = f"n{i}"
        nodes.append(P.make_node(op, [cur if a == "$" else a for a in ins],
                                 [out], name=f"{op.lower()}_{i}", **attrs))
        cur = out
    f32 = np.float32
    inits = [P.make_tensor("up2", np.asarray([1, 1, 2, 2], f32)),
             P.make_tensor("down", np.asarray([2, 3, 5, 3], np.int64)),
             P.make_tensor("up15", np.asarray([1, 1, 1.6, 2.0], f32)),
             P.make_tensor("cub", np.asarray([2, 3, 9, 7], np.int64)),
             P.make_tensor("pads", np.asarray([0, 0, 1, 2, 0, 0, 2, 1], np.int64)),
             P.make_tensor("pv", np.asarray(0.25, f32)),
             P.make_tensor("lo", np.asarray(-0.5, f32)),
             P.make_tensor("hi", np.asarray(0.75, f32)),
             P.make_tensor("half", np.asarray(0.5, f32)),
             P.make_tensor("two", np.asarray(2.0, f32)),
             P.make_tensor("three", np.asarray(3.0, f32)),
             P.make_tensor("reps", np.asarray([1, 2, 1, 1], np.int64)),
             P.make_tensor("gw", rng.normal(size=(4, 6)).astype(f32)),
             P.make_tensor("gb", rng.normal(size=(4,)).astype(f32))]
    blob = P.make_model(nodes, inits,
                        [P.make_value_info("input", [None, 3, 6, 8])],
                        [P.make_value_info(cur, [None, 4])])
    for tap in (None, "resize_1", "resize_3", "pad_6", "tile_15"):
        want, got, _, _ = _both(blob, x, tap=tap)
        assert got.shape == want.shape, tap
        assert _rel_err(got, want) <= ONNX_ELEMENTWISE_TOL, tap


def test_graph_module_unsupported_op_raises_like_the_reference():
    from mmlspark_tpu_torch.onnx import import_onnx
    from mmlspark_tpu_torch.onnx import proto as P

    blob = P.make_model([P.make_node("NonMaxSuppression", ["input"], ["out"],
                                     name="nms")], [],
                        [P.make_value_info("input", [None, 4])],
                        [P.make_value_info("out", [None, 4])])
    m = import_onnx(blob)
    with pytest.raises(NotImplementedError, match="NonMaxSuppression"):
        m.apply(torch.zeros(2, 4))


def test_graph_module_two_input_bert_graph_matches_reference():
    """``chip_smoke.bert_onnx`` (the BERT-shaped encoder the card runs, here
    2 layers of width 32): its two graph inputs, int64 ``input_ids`` and
    ``attention_mask``, fed by dict to the reference's and the port's
    imports: within 1e-5 of the reference output's max |x| (elementwise and
    normalisation family: Gather, LayerNormalization, MatMul/Softmax, Gelu);
    ``init``'s shape probe gives the hidden width."""
    cs = _load_chip_smoke()
    blob = cs.bert_onnx(vocab=97, hidden=32, heads=4, ffn=64, layers=2,
                        seq=16, seed=3)
    ids, mask = cs.bert_inputs(5, 16, 97, seed=4)
    want, got, ref, port = _both(blob, {"input_ids": ids,
                                        "attention_mask": mask})
    assert got.shape == (5, 32)
    assert _rel_err(got, want) <= ONNX_ELEMENTWISE_TOL
    assert port.argument_names() == ref.argument_names() == \
        ["input_ids", "attention_mask"]
    assert port.module.init(None, (16,)) == (32,)


_MESH_RANK_PROBE = r'''
import sys

import numpy as np


def run(mesh):
    """A sharded encoder step on tensor=2 and a ring attention over seq=2,
    then the modules this rank process imported."""
    import torch

    from mmlspark_tpu_torch.models import (ring_attention,
                                           transformer_encoder)
    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    tens = make_mesh(MeshSpec(data=1, tensor=2), device="cpu",
                     backend="gloo")
    model = transformer_encoder(seq_len=8, dim=16, depth=1, num_heads=2,
                                vocab_size=20, num_classes=3)
    opt = T.make_optimizer()
    st = T.init_train_state(model.module, (8,), opt, mesh=tens)
    rng = np.random.default_rng(0)
    st, m = T.compile_train_step(model.module, opt, mesh=tens)(
        st, {"x": rng.integers(0, 20, (2, 8)),
             "y": rng.integers(0, 3, (2, 8)).astype(np.int32)})
    seq = make_mesh(MeshSpec(data=1, seq=2), device="cpu", backend="gloo")
    q = torch.randn(1, 4, 1, 8, generator=torch.Generator().manual_seed(0))
    o = ring_attention(q, q, q, seq, causal=True)
    bad = sorted(k for k in sys.modules
                 if k in ("jax", "jaxlib", "mmlspark_tpu")
                 or k.startswith(("jax.", "jaxlib.", "mmlspark_tpu.")))
    return {"bad": bad, "loss": float(m["loss"]),
            "finite": bool(torch.isfinite(o).all())}
'''


def test_mesh_rank_processes_import_no_jax_and_no_reference(tmp_path):
    """A rank of the DNN mesh (a sharded train step and ring attention in
    2 gloo ranks) runs on the port alone."""
    from mmlspark_tpu_torch.parallel.launch import spawn

    (tmp_path / "mesh_probe.py").write_text(_MESH_RANK_PROBE)
    ranks = spawn("mesh_probe:run", 2, tmp_path, threads=1, timeout=120,
                  path=[str(tmp_path)])
    for r in ranks:
        assert r["bad"] == [], r["bad"]
        assert np.isfinite(r["loss"]) and r["finite"]


_FUSION_RANK_PROBE = r'''
import sys

import numpy as np


def run(mesh):
    """A DNN segment data-sharded over both ranks, then pipelined after a
    second one on data 1 x pipe 2, then the modules this rank imported."""
    import torch

    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.fusion import FusedPipelineModel
    from mmlspark_tpu_torch.models import (Dense, DNNModel, FunctionModel,
                                           Sequential)
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    stages = []
    for i, (src, dst) in enumerate((("x", "h"), ("h", "y"))):
        mod = Sequential([("fc", Dense(3))], name=f"m{i}")
        mod.init(torch.Generator().manual_seed(i), (3,))
        stages.append(DNNModel(inputCol=src, outputCol=dst, batchSize=4)
                      .set_model(FunctionModel(mod, (3,), name=f"m{i}")))
    x = np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32)
    df = DataFrame.from_dict({"x": list(x)})
    fused = FusedPipelineModel(stages[:1])
    want = np.stack(list(fused.transform(df).column("h")))
    fused.set_mesh(mesh)
    fused.set_tuning(sharding={"DNNModel": "data"})
    got = np.stack(list(fused.transform(df).column("h")))
    chain = FusedPipelineModel(stages)
    serial = np.stack(list(chain.transform(df).column("y")))
    chain.set_mesh(make_mesh(MeshSpec(data=1, pipe=2), device="cpu",
                             backend="gloo"))
    chain.set_tuning(pipe_depth=2)
    piped = np.stack(list(chain.transform(df).column("y")))
    bad = sorted(k for k in sys.modules
                 if k in ("jax", "jaxlib", "mmlspark_tpu")
                 or k.startswith(("jax.", "jaxlib.", "mmlspark_tpu.")))
    return {"bad": bad, "err": float(np.abs(got - want).max()),
            "bitwise": bool(np.array_equal(piped, serial)),
            "depth": chain.fusion_stats()["pipeline"]["depth"],
            "planners": sorted(k for k in sys.modules
                               if k.endswith(("shardplan", "pipeplan")))}
'''


def test_fusion_planner_rank_processes_import_no_jax_and_no_reference(
        tmp_path):
    """A rank of the fused planner's mesh (a data-sharded segment, then a
    pipelined chain, in 2 gloo ranks) runs on the port alone, its planners
    included."""
    from mmlspark_tpu_torch.parallel.launch import spawn

    (tmp_path / "fusion_probe.py").write_text(_FUSION_RANK_PROBE)
    ranks = spawn("fusion_probe:run", 2, tmp_path, threads=1, timeout=120,
                  path=[str(tmp_path)])
    for r in ranks:
        assert r["bad"] == [], r["bad"]
        assert r["err"] <= 1e-5 and r["bitwise"] and r["depth"] == 2
        assert r["planners"] == ["mmlspark_tpu_torch.parallel.pipeplan",
                                 "mmlspark_tpu_torch.parallel.shardplan"]
