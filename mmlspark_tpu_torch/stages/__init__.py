"""Utility pipeline stages (reference stages/ package, SURVEY §2.4).

Column/row plumbing, batching, timing, summarization, text preprocessing —
the ~25 wide-but-shallow stages every pipeline leans on.

The port's copy of ``mmlspark_tpu/stages``: host stages, and
``UDFTransformer.deviceUdf`` a torch callable under the port's ``DeviceFn``
contract (``core/device_stage.py``).
"""

from .basic import (
    Cacher,
    ClassBalancer,
    ClassBalancerModel,
    DropColumns,
    EnsembleByKey,
    Explode,
    Lambda,
    MultiColumnAdapter,
    PartitionCoalesce,
    RenameColumn,
    Repartition,
    SelectColumns,
    StratifiedRepartition,
    SummarizeData,
    Timer,
    TimerModel,
    UDFTransformer,
)
from .minibatch import (
    DynamicMiniBatchTransformer,
    FixedMiniBatchTransformer,
    FlattenBatch,
    TimeIntervalMiniBatchTransformer,
)
from .text import TextPreprocessor, UnicodeNormalize
from .udfs import get_value_at, to_vector

__all__ = [
    "Cacher", "ClassBalancer", "ClassBalancerModel", "DropColumns",
    "DynamicMiniBatchTransformer", "EnsembleByKey", "Explode",
    "FixedMiniBatchTransformer", "FlattenBatch", "Lambda", "MultiColumnAdapter",
    "PartitionCoalesce", "RenameColumn", "Repartition", "SelectColumns",
    "StratifiedRepartition", "SummarizeData", "TextPreprocessor",
    "TimeIntervalMiniBatchTransformer", "Timer", "TimerModel", "UDFTransformer",
    "UnicodeNormalize", "get_value_at", "to_vector",
]
