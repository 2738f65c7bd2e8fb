"""Text featurization: tokenize -> ngrams -> hashTF -> IDF.

Reference: featurize/text/TextFeaturizer.scala (a configurable sub-pipeline over
Spark's Tokenizer/NGram/HashingTF/IDF), featurize/text/MultiNGram.scala
(concatenated n-gram ranges), featurize/text/PageSplitter.scala (split strings
into bounded-length pages for downstream services).

The port's copy of ``mmlspark_tpu/featurize/text.py``, host code. Its rows
are the reference's bit for bit (``{"size", "indices", "values"}``: indices
sorted int64, values f32; IDF in f64, ``log((n + 1) / (df + 1))``, applied
before the f32 cast). Where the reference hashes every token with the
Python ``murmur3_32``, the port hashes each distinct token of a partition
(of the column, in ``fit``) once through ``ops.hashing.hash_strings`` (the
native ``murmur3_batch``) and counts the buckets of all its rows in one
sort.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasInputCol, HasOutputCol, Param
from ..core.pipeline import Estimator, Model, Transformer
from ..core.schema import ColType, Schema
from ..ops.hashing import hash_strings

_DEFAULT_STOPWORDS = {
    "a", "an", "and", "are", "as", "at", "be", "by", "for", "from", "has", "he",
    "in", "is", "it", "its", "of", "on", "that", "the", "to", "was", "were",
    "will", "with",
}


def tokenize(text: str, pattern: str = r"\s+", to_lower: bool = True,
             min_token_length: int = 1) -> List[str]:
    if to_lower:
        text = text.lower()
    toks = [t for t in re.split(pattern, text) if len(t) >= min_token_length]
    return toks


def ngrams(tokens: List[str], n: int) -> List[str]:
    return [" ".join(tokens[i:i + n]) for i in range(len(tokens) - n + 1)]


def _hashed_rows(docs: List[List[str]], num_features: int):
    """Term counts of each token list by hash bucket: (keys, counts,
    bounds), ``keys`` the sorted ``row * num_features + bucket`` of every
    (row, bucket) present, ``counts`` its tokens (f32) and ``bounds`` the
    [n + 1] start of each row in them. Each distinct token is hashed
    once."""
    ids: Dict[str, int] = {}
    flat: List[int] = []
    lens = np.empty(len(docs), dtype=np.int64)
    for i, toks in enumerate(docs):
        flat.extend(ids.setdefault(t, len(ids)) for t in toks)
        lens[i] = len(toks)
    buckets = hash_strings(list(ids)) % num_features
    rows = np.repeat(np.arange(len(docs), dtype=np.int64), lens)
    keys, counts = np.unique(
        rows * num_features + buckets[np.asarray(flat, dtype=np.int64)],
        return_counts=True)
    bounds = np.searchsorted(keys // num_features,
                             np.arange(len(docs) + 1, dtype=np.int64))
    return keys, counts.astype(np.float32), bounds


def hash_tf(tokens: List[str], num_features: int) -> Dict[str, np.ndarray]:
    keys, counts, _ = _hashed_rows([tokens], num_features)
    return {"indices": keys % num_features, "values": counts}


class TextFeaturizer(Estimator, HasInputCol, HasOutputCol):
    """Tokenize -> stopwords -> n-grams -> hashing TF -> IDF, in one stage
    (featurize/text/TextFeaturizer.scala)."""

    useTokenizer = Param("useTokenizer", "Tokenize input", True, ptype=bool)
    tokenizerPattern = Param("tokenizerPattern", "Split regex", r"\s+", ptype=str)
    toLowercase = Param("toLowercase", "Lowercase before tokenizing", True, ptype=bool)
    minTokenLength = Param("minTokenLength", "Drop shorter tokens", 1, ptype=int)
    useStopWordsRemover = Param("useStopWordsRemover", "Remove stopwords", False,
                                ptype=bool)
    useNGram = Param("useNGram", "Emit n-grams instead of unigrams", False, ptype=bool)
    nGramLength = Param("nGramLength", "n-gram length", 2, ptype=int)
    numFeatures = Param("numFeatures", "Hashing TF buckets", 1 << 18, ptype=int)
    useIDF = Param("useIDF", "Rescale by inverse document frequency", True, ptype=bool)
    minDocFreq = Param("minDocFreq", "Min docs for IDF term", 1, ptype=int)

    def _token_fn(self):
        """``text -> tokens`` under this stage's params (read once)."""
        pattern, lower = self.get("tokenizerPattern"), self.get("toLowercase")
        min_len, split = self.get("minTokenLength"), self.get("useTokenizer")
        stop, n = self.get("useStopWordsRemover"), (
            self.get("nGramLength") if self.get("useNGram") else 0)

        def tokens(text: Optional[str]) -> List[str]:
            if text is None:
                return []
            toks = tokenize(text, pattern, lower, min_len) if split else [text]
            if stop:
                toks = [t for t in toks if t not in _DEFAULT_STOPWORDS]
            if n:
                toks = ngrams(toks, n)
            return toks

        return tokens

    def fit(self, df: DataFrame) -> "TextFeaturizerModel":
        nf = self.get("numFeatures")
        idf = None
        if self.get("useIDF"):
            col = df.column(self.get_or_throw("inputCol"))
            n_docs = len(col)
            tokens = self._token_fn()
            keys, _, _ = _hashed_rows([tokens(t) for t in col], nf)
            doc_freq = np.bincount(keys % nf, minlength=nf).astype(np.float64)
            min_df = self.get("minDocFreq")
            idf = np.where(doc_freq >= min_df,
                           np.log((n_docs + 1.0) / (doc_freq + 1.0)), 0.0)
        return TextFeaturizerModel(
            inputCol=self.get("inputCol"), outputCol=self.get("outputCol"),
            numFeatures=nf, idfValues=idf, config=self.simple_params())


class TextFeaturizerModel(Model, HasInputCol, HasOutputCol):
    numFeatures = Param("numFeatures", "Hashing TF buckets", 1 << 18, ptype=int)
    idfValues = ComplexParam("idfValues", "IDF weights (None = TF only)")
    config = Param("config", "Tokenization config from the estimator", None, ptype=dict)

    def _tokenizer(self) -> TextFeaturizer:
        cfg = self.get("config") or {}
        return TextFeaturizer(**{k: v for k, v in cfg.items()
                                 if TextFeaturizer.has_param(k)})

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        nf = self.get("numFeatures")
        idf = self.get("idfValues")

        tokens = self._tokenizer()._token_fn()

        def fn(p):
            col = p[in_col]
            keys, values, bounds = _hashed_rows([tokens(t) for t in col], nf)
            indices = keys % nf
            if idf is not None:
                values = (values * idf[indices]).astype(np.float32)
            out = np.empty(len(col), dtype=object)
            for i in range(len(col)):
                lo, hi = bounds[i], bounds[i + 1]
                # "size" makes the row densifiable downstream (stack_rows)
                out[i] = {"size": nf, "indices": indices[lo:hi],
                          "values": values[lo:hi]}
            return out

        return df.with_column(out_col, fn)

    def transform_schema(self, schema: Schema) -> Schema:
        out = schema.copy()
        out.types[self.get_or_throw("outputCol")] = ColType.STRUCT
        return out


class MultiNGram(Transformer, HasInputCol, HasOutputCol):
    """Concatenate n-grams for several lengths (featurize/text/MultiNGram.scala).
    Input: token-array column; output: array of n-gram strings."""

    lengths = Param("lengths", "N-gram lengths to emit", [1, 2, 3], ptype=list)

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        lengths = self.get("lengths")

        def fn(p):
            col = p[in_col]
            out = np.empty(len(col), dtype=object)
            for i, toks in enumerate(col):
                if toks is None:
                    out[i] = None
                    continue
                toks = list(toks)
                grams: List[str] = []
                for n in lengths:
                    grams.extend(ngrams(toks, n))
                out[i] = grams
            return out

        return df.with_column(out_col, fn)


class PageSplitter(Transformer, HasInputCol, HasOutputCol):
    """Split strings into pages within [minimumPageLength, maximumPageLength],
    preferring whitespace boundaries (featurize/text/PageSplitter.scala)."""

    maximumPageLength = Param("maximumPageLength", "Max chars per page", 5000,
                              lambda v: v > 0, int)
    minimumPageLength = Param("minimumPageLength", "Preferred min chars per page",
                              4500, lambda v: v > 0, int)
    boundaryRegex = Param("boundaryRegex", "Preferred break pattern", r"\s", ptype=str)

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        max_len = self.get("maximumPageLength")
        min_len = min(self.get("minimumPageLength"), max_len)
        boundary = re.compile(self.get("boundaryRegex"))

        def split(text: Optional[str]) -> Optional[List[str]]:
            if text is None:
                return None
            pages = []
            start = 0
            while start < len(text):
                end = min(start + max_len, len(text))
                if end < len(text):
                    # prefer the last boundary in [min_len, max_len)
                    window = text[start + min_len:end]
                    matches = [m.start() for m in boundary.finditer(window)]
                    if matches:
                        end = start + min_len + matches[-1] + 1
                pages.append(text[start:end])
                start = end
            return pages

        return df.with_column(out_col,
                              lambda p: [split(v) for v in p[in_col]])
