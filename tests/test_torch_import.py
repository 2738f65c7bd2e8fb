"""The port stands alone: no JAX, no reference package, no silent CPU.

``mmlspark_tpu_torch`` must import without pulling in ``jax`` or any module
of ``mmlspark_tpu`` (the prefixes overlap, so the checks use exact module
keys), and its entry points must refuse to run when they default to CUDA on
a host without it.
"""

import json
import pathlib
import re
import subprocess
import sys

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
                "mmlspark_tpu_torch.models.resnet",
                "mmlspark_tpu_torch.models.torch_import",
                "mmlspark_tpu_torch.models.moe",
                "mmlspark_tpu_torch.ops.image",
                "mmlspark_tpu_torch.io.image",
                "mmlspark_tpu_torch.image.stages",
                "mmlspark_tpu_torch.image.featurizer"):
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
def test_later_slices_raise_not_implemented(option):
    """What a later slice still owns: a mesh (ROADMAP A9)."""
    from mmlspark_tpu_torch.gbdt import TrainParams, train

    X = np.zeros((64, 2))
    y = np.zeros(64)
    with pytest.raises(NotImplementedError, match="A9"):
        train(TrainParams(), X, y, device="cpu", mesh=object())


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
