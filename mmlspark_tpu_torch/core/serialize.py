"""Stage persistence: params and complex values to a directory tree.

Counterpart of the reference's ``mmlspark_tpu/core/serialize.py``, in its
directory layout:

    <path>/metadata.json        {"class": ..., "params": {...}, "complex": {...}}
    <path>/complex/<param>/     one directory per complex param, type-tagged
    <path>/stages/<i>_<name>/   nested stages (Pipeline / PipelineModel)

Complex values: nested stages (recursive), DataFrames, numpy arrays and
torch tensors (``npz``; kind ``tensor`` where the reference has
``jax_array``), bytes, strings (a GBDT model's Booster is its JSON string,
format ``mmlspark_tpu.gbdt.v1``, which both packages read), and any other
picklable value (``pkl``, the last resort; a ``FunctionModel`` goes this
way with its weights).

A stage is recorded under its nearest registered class, so a fused
``PipelineModel`` (``fuse()``; fusion is a way of running, not an artifact)
loads back as a plain one.

A directory the JAX package saved names ``mmlspark_tpu`` classes and may
hold pickles of them; loading it here raises ``ValueError`` and imports
nothing of that package (the unpickler refuses its modules and JAX's).
Models cross between the packages as LightGBM text or the Booster's JSON.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import shutil
import time
from typing import Any, Dict

import numpy as np
import torch

from .dataframe import DataFrame
from .params import Params

#: module prefixes a pickle in a saved stage may not name: the JAX package
#: and JAX itself (the port runs without either)
_FOREIGN = ("mmlspark_tpu", "jax", "jaxlib")


def _foreign(module: str) -> bool:
    return any(module == p or module.startswith(p + ".") for p in _FOREIGN)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if _foreign(module):
            raise ValueError(
                f"this stage holds a pickled {module}.{name}, an object of "
                f"the JAX package; the port does not load it (carry models "
                f"across as LightGBM text or the Booster's JSON)")
        return super().find_class(module, name)


def _unpickle(path: str) -> Any:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _write_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, default=_json_default)


def _json_default(o: Any):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"Not JSON serializable: {type(o)}")


def _save_value(value: Any, path: str) -> Dict[str, Any]:
    """Save one complex value under ``path``; return its type-tag manifest."""
    os.makedirs(path, exist_ok=True)
    from .pipeline import PipelineStage

    if isinstance(value, PipelineStage):
        save_stage(value, os.path.join(path, "stage"), overwrite=True)
        return {"kind": "stage"}
    if isinstance(value, DataFrame):
        with open(os.path.join(path, "df.pkl"), "wb") as f:
            pickle.dump(value.partitions, f)
        return {"kind": "dataframe"}
    if isinstance(value, np.ndarray) and value.dtype != object:
        np.savez(os.path.join(path, "array.npz"), arr=value)
        return {"kind": "ndarray"}
    if isinstance(value, torch.Tensor):
        np.savez(os.path.join(path, "array.npz"),
                 arr=value.detach().cpu().numpy())
        return {"kind": "tensor"}
    if isinstance(value, bytes):
        with open(os.path.join(path, "blob.bin"), "wb") as f:
            f.write(value)
        return {"kind": "bytes"}
    if isinstance(value, str):
        with open(os.path.join(path, "text.txt"), "w") as f:
            f.write(value)
        return {"kind": "str"}
    with open(os.path.join(path, "value.pkl"), "wb") as f:
        pickle.dump(value, f)
    return {"kind": "pickle"}


def _load_value(manifest: Dict[str, Any], path: str) -> Any:
    kind = manifest["kind"]
    if kind == "stage":
        return load_stage(os.path.join(path, "stage"))
    if kind == "dataframe":
        return DataFrame(_unpickle(os.path.join(path, "df.pkl")))
    if kind in ("ndarray", "tensor"):
        with np.load(os.path.join(path, "array.npz")) as z:
            arr = z["arr"]
        return torch.from_numpy(arr) if kind == "tensor" else arr
    if kind == "bytes":
        with open(os.path.join(path, "blob.bin"), "rb") as f:
            return f.read()
    if kind == "str":
        with open(os.path.join(path, "text.txt")) as f:
            return f.read()
    if kind == "pickle":
        return _unpickle(os.path.join(path, "value.pkl"))
    raise ValueError(f"Unknown complex value kind {kind!r} in {path!r} "
                     f"(a stage the JAX package saved holds kinds the port "
                     f"does not load)")


def _class_name(stage: Params) -> str:
    """The stage's nearest registered class, as "module.Name"."""
    from .pipeline import registered_stages

    reg = registered_stages()
    for cls in type(stage).__mro__:
        name = f"{cls.__module__}.{cls.__name__}"
        if reg.get(name) is cls:
            return name
    raise TypeError(f"{type(stage).__name__} is not a registered stage "
                    f"class and has no registered base")


def save_stage(stage: Params, path: str, overwrite: bool = True) -> None:
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        shutil.rmtree(path)
    os.makedirs(path)

    meta: Dict[str, Any] = {
        "class": _class_name(stage),
        "timestamp": time.time(),
        "params": stage.simple_params(),
        "complex": {},
    }
    complex_params = stage.complex_params()
    if complex_params:
        cdir = os.path.join(path, "complex")
        for name, value in complex_params.items():
            meta["complex"][name] = _save_value(value, os.path.join(cdir, name))

    # nested stage lists (Pipeline/PipelineModel constructor args)
    stages = getattr(stage, "_stages", None)
    if stages is not None:
        meta["num_stages"] = len(stages)
        for i, s in enumerate(stages):
            save_stage(s, os.path.join(path, "stages",
                                       f"{i:03d}_{type(s).__name__}"))

    _write_json(os.path.join(path, "metadata.json"), meta)


def load_stage(path: str) -> Any:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    if _foreign(meta["class"].rsplit(".", 1)[0]):
        raise ValueError(
            f"{path!r} holds a stage the JAX package saved "
            f"({meta['class']}); the port does not load its directories. "
            f"Carry a GBDT model across as LightGBM text "
            f"(save_native_model / load_native_model_from_file) or as the "
            f"Booster's JSON (get_model_string / modelString)")
    from .pipeline import get_stage_class

    module = meta["class"].rsplit(".", 1)[0]
    if module.startswith("mmlspark_tpu_torch."):
        importlib.import_module(module)          # registers its stages
    cls = get_stage_class(meta["class"])
    kwargs: Dict[str, Any] = {}
    if "num_stages" in meta:
        sdir = os.path.join(path, "stages")
        names = sorted(os.listdir(sdir)) if os.path.isdir(sdir) else []
        kwargs["stages"] = [load_stage(os.path.join(sdir, n)) for n in names]

    stage = cls(**kwargs) if kwargs else cls()
    for k, v in meta["params"].items():
        stage.set(k, v)
    for name, manifest in meta.get("complex", {}).items():
        stage.set(name, _load_value(manifest, os.path.join(path, "complex",
                                                           name)))
    return stage
