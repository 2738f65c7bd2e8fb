"""Featurization library (reference featurize/ package, SURVEY §2.4).

Auto-featurization (Featurize/AssembleFeatures), typed value indexing
(ValueIndexer/IndexToValue), missing-data imputation (CleanMissingData), type
coercion (DataConversion), and text featurization (TextFeaturizer, MultiNGram,
PageSplitter), and Word2Vec.

The port's copy of ``mmlspark_tpu/featurize``: host code, but Word2Vec's
training step and the assemblers' fused ``device_fn``s, which run on the
card.
"""

from .indexers import IndexToValue, ValueIndexer, ValueIndexerModel
from .clean import CleanMissingData, CleanMissingDataModel, DataConversion
from .assemble import AssembleFeatures, FastVectorAssembler, Featurize
from .text import MultiNGram, PageSplitter, TextFeaturizer, TextFeaturizerModel
from .word2vec import Word2Vec, Word2VecModel

__all__ = [
    "AssembleFeatures", "CleanMissingData", "CleanMissingDataModel",
    "DataConversion", "FastVectorAssembler", "Featurize", "IndexToValue",
    "MultiNGram", "PageSplitter",
    "TextFeaturizer", "TextFeaturizerModel", "ValueIndexer", "ValueIndexerModel",
    "Word2Vec", "Word2VecModel",
]
