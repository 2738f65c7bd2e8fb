"""Pipeline stage contract: Transformer / Estimator / Model / Pipeline.

Copy of the reference's ``mmlspark_tpu/core/pipeline.py``.
``PipelineModel.fuse()`` returns the fused runner of ``core/fusion.py``,
``PipelineStage.device_fn`` is the hook a stage joins it through, and
``PipelineStage.save``/``load`` persist a stage (``core/serialize.py``).

Re-design of SparkML's stage algebra that the whole reference is expressed in
(SURVEY §1: "Everything is expressed as SparkML Transformer/Estimator stages operating
on DataFrames"). Stages carry typed params (core/params.py), operate column-to-column
on the partitioned columnar DataFrame (core/dataframe.py), and persist via
core/serialize.py (ComplexParamsWritable parity).

Class registry: every concrete stage subclass auto-registers by qualified name so
save/load can reconstruct stages from metadata (reference: Spark's
DefaultParamsReader.loadParamsInstance class-name dispatch).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Type

from .dataframe import DataFrame
from .params import Params
from .schema import Schema

_STAGE_REGISTRY: Dict[str, Type["PipelineStage"]] = {}


def get_stage_class(name: str) -> Type["PipelineStage"]:
    if name in _STAGE_REGISTRY:
        return _STAGE_REGISTRY[name]
    short = name.rsplit(".", 1)[-1]
    if short in _STAGE_REGISTRY:
        return _STAGE_REGISTRY[short]
    raise KeyError(f"Unknown stage class '{name}'. Registered: {sorted(_STAGE_REGISTRY)}")


def registered_stages() -> Dict[str, Type["PipelineStage"]]:
    """All registered stage classes — drives codegen + fuzzing coverage enforcement
    (reference: FuzzingTest reflection over the jar, core/test/fuzzing/FuzzingTest.scala)."""
    return dict(_STAGE_REGISTRY)


class PipelineStage(Params):
    """Base of all stages. Subclasses auto-register for persistence/codegen."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        # `_abstract = True` in the class's own dict marks intermediate bases
        # that are not user-constructible stages (kept out of the registry so
        # codegen and fuzzing enforcement see only concrete stages)
        if not cls.__name__.startswith("_") and \
                not cls.__dict__.get("_abstract", False):
            _STAGE_REGISTRY[cls.__name__] = cls
            _STAGE_REGISTRY[f"{cls.__module__}.{cls.__name__}"] = cls

    @property
    def uid(self) -> str:
        if not hasattr(self, "_uid"):
            self._uid = f"{type(self).__name__}_{id(self):x}"
        return self._uid

    def transform_schema(self, schema: Schema) -> Schema:
        """Schema-only validation/propagation hook. Default: identity."""
        return schema

    def device_fn(self, schema: Schema):
        """Device-stage contract hook (core/device_stage.py): return a
        ``DeviceFn`` describing this stage as a program over batched device
        tensors so the fusion planner (core/fusion.py) can run it in one
        program with its neighbors, or None (default) for host-only stages.
        Implementations must keep the bitwise contract: fused output ==
        unfused output on every partition the DeviceFn accepts."""
        return None

    # persistence (implemented in serialize.py to avoid circular imports)
    def save(self, path: str, overwrite: bool = True) -> None:
        from .serialize import save_stage
        save_stage(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "PipelineStage":
        from .serialize import load_stage
        return load_stage(path)


class Transformer(PipelineStage):
    """A DataFrame -> DataFrame stage."""

    _abstract = True

    def transform(self, df: DataFrame) -> DataFrame:
        raise NotImplementedError

    def __call__(self, df: DataFrame) -> DataFrame:
        return self.transform(df)


class Estimator(PipelineStage):
    """A stage fitted on a DataFrame, producing a Model."""

    _abstract = True

    def fit(self, df: DataFrame) -> "Model":
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer (may reference its parent estimator's params)."""

    _abstract = True


class Evaluator(Params):
    """Scores a transformed DataFrame with a single metric (SparkML Evaluator parity)."""

    def evaluate(self, df: DataFrame) -> float:
        raise NotImplementedError

    def is_larger_better(self) -> bool:
        return True


class Pipeline(Estimator):
    """Sequential composition of stages (SparkML Pipeline parity).

    fit() runs stages in order: Transformers transform-through, Estimators fit on the
    current data then transform with the fitted model. Produces a PipelineModel.
    """

    def __init__(self, stages: Optional[Sequence[PipelineStage]] = None, **kwargs):
        super().__init__(**kwargs)
        self._stages: List[PipelineStage] = list(stages or [])

    @property
    def stages(self) -> List[PipelineStage]:
        return self._stages

    def set_stages(self, stages: Sequence[PipelineStage]) -> "Pipeline":
        self._stages = list(stages)
        return self

    def fit(self, df: DataFrame) -> "PipelineModel":
        fitted: List[Transformer] = []
        cur = df
        for i, stage in enumerate(self._stages):
            if isinstance(stage, Estimator):
                model = stage.fit(cur)
                fitted.append(model)
                if i < len(self._stages) - 1:
                    cur = model.transform(cur)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if i < len(self._stages) - 1:
                    cur = stage.transform(cur)
            else:
                raise TypeError(f"Pipeline stage {stage!r} is neither Transformer nor Estimator")
        return PipelineModel(fitted)

    def transform_schema(self, schema: Schema) -> Schema:
        for s in self._stages:
            schema = s.transform_schema(schema)
        return schema


class PipelineModel(Model):
    """Fitted pipeline: a chain of Transformers.

    Also the product of NamespaceInjections.pipelineModel in the reference
    (org/apache/spark/ml/NamespaceInjections.scala:1-23) — construct directly
    from a list of transformers without fitting.
    """

    def __init__(self, stages: Optional[Sequence[Transformer]] = None, **kwargs):
        super().__init__(**kwargs)
        self._stages: List[Transformer] = list(stages or [])

    @property
    def stages(self) -> List[Transformer]:
        return self._stages

    def transform(self, df: DataFrame, fused: bool = False) -> DataFrame:
        if fused:
            return self.fuse().transform(df)
        for s in self._stages:
            df = s.transform(df)
        return df

    def fuse(self) -> "PipelineModel":
        """Run adjacent device-capable stages as one device program per
        batch (core/fusion.py). Returns a FusedPipelineModel whose transform
        is bitwise-identical to this chain but keeps intermediates on the
        device across stage boundaries; host-only stages still run
        per-stage. The fused runner is cached — repeated fuse() calls share
        its plans and the compile cache."""
        if getattr(self, "_fused_runner", None) is None:
            from .fusion import FusedPipelineModel

            self._fused_runner = FusedPipelineModel(self._stages)
        return self._fused_runner

    def transform_schema(self, schema: Schema) -> Schema:
        for s in self._stages:
            schema = s.transform_schema(schema)
        return schema


def pipeline_model(*stages: Transformer) -> PipelineModel:
    """NamespaceInjections.pipelineModel parity helper."""
    return PipelineModel(list(stages))
