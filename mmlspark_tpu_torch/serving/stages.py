"""Request/reply column sugar (ServingImplicits parseRequest/makeReply parity).

Counterpart of the reference's ``mmlspark_tpu/serving/stages.py``.

Wire negotiation happens HERE, per row: a request whose Content-Type is
``application/x-mmlspark-frame`` (io/binary.py) decodes as a binary column
frame — numpy views over the body bytes, zero-copy, no JSON parse, no
base64 — regardless of the ``parse`` mode JSON clients use, so one endpoint
serves both wires and replies stay bitwise-identical between them."""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ..core.dataframe import DataFrame
from ..io.binary import (FRAME_CONTENT_TYPE, FrameError, decode_csr_columns,
                         decode_frame, is_frame)


def _row_content_type(headers) -> str:
    if not headers:
        return ""
    get = getattr(headers, "get", None)
    v = get("Content-Type") if get is not None else None
    if v is None:
        low = "content-type"
        for k in headers:
            if str(k).lower() == low:
                v = headers[k]
                break
    return str(v or "").split(";")[0].strip().lower()


def _decode_frame_row(raw: bytes):
    """Frame body -> parsed value: single-column frames unwrap to the bare
    array (mirroring the JSON single-'data'-key unwrap), multi-column frames
    stay a {name: array} dict. Views over ``raw`` — zero-copy.

    CSR sub-columns (``{c}:indptr`` / ``:indices`` / ``:values`` /
    ``:width``, io/binary.py ``encode_csr_columns``) decode to column ``c``
    of per-row ``{"indices", "values", "size"}`` dicts
    (``decode_csr_columns``, all-or-nothing); a request carrying one sparse
    row unwraps to that row's dict -- the form a JSON client sends and the
    sparse stages consume."""
    cols = decode_frame(raw)
    sparse = any(c.endswith(":indptr") for c in cols)
    if sparse:
        cols = decode_csr_columns(cols)
    if len(cols) == 1:
        value = next(iter(cols.values()))
        if sparse and value.dtype == object and len(value) == 1:
            return value[0]
        return value
    return cols


def parse_request(df: DataFrame, output_col: str, parse: str = "json",
                  value_col: str = "value",
                  headers_col: Optional[str] = "headers") -> DataFrame:
    """Decode the raw request-body column: json -> dict/list (dict payloads with
    a single 'data'/'value' key unwrap to the value), text -> str, bytes -> raw.
    Rows negotiated as binary frames (Content-Type + magic) decode to numpy
    views whatever ``parse`` says; a frame that fails validation parses to
    None (the ingress already 400s malformed frames — this covers journal
    replay and direct DataFrame use)."""
    use_headers = headers_col if headers_col in (df.schema or []) else None

    def fn(p):
        col = p[value_col]
        hdrs = p[use_headers] if use_headers else None
        out = np.empty(len(col), dtype=object)
        for i, body in enumerate(col):
            if body is None:
                out[i] = None
                continue
            raw = bytes(body)
            if is_frame(raw) and (
                    hdrs is None
                    or _row_content_type(hdrs[i]) == FRAME_CONTENT_TYPE):
                try:
                    out[i] = _decode_frame_row(raw)
                except FrameError:
                    out[i] = None
                continue
            if parse == "bytes":
                out[i] = raw
            elif parse == "text":
                out[i] = raw.decode("utf-8", errors="replace")
            else:
                try:
                    obj = json.loads(raw.decode("utf-8"))
                except Exception:
                    out[i] = None
                    continue
                if isinstance(obj, dict) and len(obj) == 1 and \
                        next(iter(obj)) in ("data", "value"):
                    obj = next(iter(obj.values()))
                out[i] = np.asarray(obj, dtype=np.float64) \
                    if isinstance(obj, list) and obj \
                    and isinstance(obj[0], (int, float)) else obj
        return out

    return df.with_column(output_col, fn)


def make_reply(df: DataFrame, input_col: str, reply_col: str = "reply"
               ) -> DataFrame:
    """Copy/coerce a column into the reply column (makeReplyUDF parity)."""
    return df.with_column(reply_col, lambda p: p[input_col])
