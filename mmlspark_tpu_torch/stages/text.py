"""Text preprocessing stages (reference stages/TextPreprocessor.scala:15-130,
stages/UnicodeNormalize.scala).

The port's copy of ``mmlspark_tpu/stages/text.py`` (host code).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer


class _Trie:
    """Longest-match replacement trie (TextPreprocessor's Trie, :15-60)."""

    __slots__ = ("children", "value")

    def __init__(self):
        self.children: Dict[str, "_Trie"] = {}
        self.value: Optional[str] = None

    def put(self, key: str, value: str) -> None:
        node = self
        for ch in key:
            node = node.children.setdefault(ch, _Trie())
        node.value = value

    def longest_match(self, text: str, start: int):
        """(match_length, replacement) of the longest key matching at ``start``."""
        node = self
        best = (0, None)
        i = start
        while i < len(text):
            node = node.children.get(text[i])
            if node is None:
                break
            i += 1
            if node.value is not None:
                best = (i - start, node.value)
        return best


class TextPreprocessor(Transformer, HasInputCol, HasOutputCol):
    """Trie-based string normalization and phrase replacement
    (stages/TextPreprocessor.scala:15-130): normFunc first, then greedy
    longest-match replacement over the normalized text."""

    map = Param("map", "Phrase -> replacement dict", None, ptype=dict)
    normFunc = Param("normFunc", "Normalization: identity|lowerCase|removePunctuation",
                     "identity",
                     lambda v: v in ("identity", "lowerCase", "removePunctuation"), str)

    _PUNCT = set(".,!?;:'\"()[]{}<>-_/\\|@#$%^&*+=~`")

    def _normalize(self, text: str) -> str:
        kind = self.get("normFunc")
        if kind == "lowerCase":
            return text.lower()
        if kind == "removePunctuation":
            return "".join(ch for ch in text if ch not in self._PUNCT)
        return text

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        trie = _Trie()
        for k, v in (self.get("map") or {}).items():
            trie.put(k, v)

        def process(text):
            if text is None:
                return None
            text = self._normalize(str(text))
            out = []
            i = 0
            while i < len(text):
                length, repl = trie.longest_match(text, i)
                if length:
                    out.append(repl)
                    i += length
                else:
                    out.append(text[i])
                    i += 1
            return "".join(out)

        return df.with_column(out_col,
                              lambda p: [process(v) for v in p[in_col]])


class UnicodeNormalize(Transformer, HasInputCol, HasOutputCol):
    """Unicode normal-form + optional lowercase (stages/UnicodeNormalize.scala)."""

    form = Param("form", "Normal form: NFC|NFD|NFKC|NFKD", "NFKD",
                 lambda v: v in ("NFC", "NFD", "NFKC", "NFKD"), str)
    lower = Param("lower", "Lowercase after normalizing", True, ptype=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        form = self.get("form")
        lower = self.get("lower")

        def process(v):
            if v is None:
                return None
            s = unicodedata.normalize(form, str(v))
            return s.lower() if lower else s

        return df.with_column(out_col, lambda p: [process(v) for v in p[in_col]])
