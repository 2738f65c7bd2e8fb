"""Binary I/O: whole-file reader + the zero-copy columnar wire frame.

Counterpart of the reference's ``mmlspark_tpu/io/binary.py``; a frame
encoded by either package decodes in the other, and ``encode_frame`` gives
the same bytes in both.

Whole-file reader (BinaryFileFormat parity): reads a
directory tree into a DataFrame of {path, bytes} rows with recursive glob,
extension filtering, sampling, and zip inspection — partitioned for
downstream parallel decode.

Wire frame (``encode_frame`` / ``decode_frame``): the serving stack's binary
request format, negotiated via Content-Type ``application/x-mmlspark-frame``.
A frame is a length-prefixed header (magic + version + per-column
name/dtype/shape table) followed by the columns' raw payload bytes — no JSON,
no base64, so a uint8 image ships at 1x instead of the 4/3x base64-JSON tax,
and ``decode_frame`` returns numpy VIEWS over the request buffer (zero-copy).
The first copy on the ingest path is either the batch stack
(parallel/ingest.rows_to_batch) or the direct deposit into a caller-owned
staging buffer:
``decode_frame(buf, out=...)`` / ``deposit_frame`` validate the frame fully,
check every destination (dtype/shape/contiguity/writeability), and only then
write payload bytes straight into the slot, so a hostile frame raises
``FrameError`` before any slot byte changes (all-or-nothing).

Frame layout (all integers little-endian):

    0..3    magic  b"MMSF"
    4       version u8 (= 1)
    5       flags u8 (reserved, 0)
    6       ncols u8 (1..MAX_FRAME_COLS)
    7..14   total_len u64  — whole frame, magic through last payload byte
    15..16  header_len u16 — column-table bytes (bounded: <= MAX_HEADER_LEN)
    17..    column table, ncols entries:
              name_len u8, name utf-8 bytes,
              dtype u8 (DTYPE_CODES), ndim u8 (0..MAX_FRAME_NDIM),
              dims u32 x ndim, payload_len u32
    then the payloads, concatenated in column order.

Every length field is validated against the actual buffer before any view is
built — a hostile length can only produce a ``FrameError``, never an
allocation sized by the attacker (the decoder allocates nothing but views).
"""

from __future__ import annotations

import fnmatch
import os
import struct
import zipfile
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.dataframe import DataFrame


def _walk(path: str, recursive: bool, pattern: Optional[str]) -> List[str]:
    out: List[str] = []
    if os.path.isfile(path):
        return [path]
    for root, dirs, files in os.walk(path):
        for f in sorted(files):
            if pattern and not fnmatch.fnmatch(f, pattern):
                continue
            out.append(os.path.join(root, f))
        if not recursive:
            break
        dirs.sort()
    return out


def read_binary_files(path: str, recursive: bool = True,
                      sample_ratio: float = 1.0, inspect_zip: bool = True,
                      seed: int = 0, num_partitions: int = 1,
                      pattern: Optional[str] = None) -> DataFrame:
    """Directory/file -> DataFrame[{path, bytes}] (BinaryFileReader parity)."""
    files = _walk(path, recursive, pattern)
    rng = np.random.default_rng(seed)
    if sample_ratio < 1.0:
        files = [f for f in files if rng.random() < sample_ratio]
    paths: List[str] = []
    blobs: List[bytes] = []
    for f in files:
        if inspect_zip and zipfile.is_zipfile(f):
            with zipfile.ZipFile(f) as z:
                for name in z.namelist():
                    if name.endswith("/"):
                        continue
                    if pattern and not fnmatch.fnmatch(os.path.basename(name),
                                                       pattern):
                        continue
                    if sample_ratio < 1.0 and rng.random() >= sample_ratio:
                        continue
                    paths.append(f"{f}/{name}")
                    blobs.append(z.read(name))
        else:
            with open(f, "rb") as fh:
                paths.append(f)
                blobs.append(fh.read())
    path_col = np.empty(len(paths), dtype=object)
    blob_col = np.empty(len(blobs), dtype=object)
    for i, (p, b) in enumerate(zip(paths, blobs)):
        path_col[i] = p
        blob_col[i] = b
    df = DataFrame([{"path": path_col, "bytes": blob_col}])
    return df.repartition(num_partitions) if num_partitions > 1 else df


class BinaryFileReader:
    """Object-style facade mirroring the reference reader options API."""

    def __init__(self):
        self._recursive = True
        self._sample_ratio = 1.0
        self._inspect_zip = True
        self._seed = 0
        self._pattern: Optional[str] = None
        self._partitions = 1

    def option(self, key: str, value) -> "BinaryFileReader":
        key = key.lower()
        if key == "recursive":
            self._recursive = bool(value)
        elif key in ("sampleratio", "subsample"):
            self._sample_ratio = float(value)
        elif key == "inspectzip":
            self._inspect_zip = bool(value)
        elif key == "seed":
            self._seed = int(value)
        elif key in ("pathfilter", "pattern"):
            self._pattern = str(value)
        elif key in ("numpartitions", "partitions"):
            self._partitions = int(value)
        else:
            raise KeyError(f"Unknown binary reader option {key!r}")
        return self

    def load(self, path: str) -> DataFrame:
        return read_binary_files(
            path, self._recursive, self._sample_ratio, self._inspect_zip,
            self._seed, self._partitions, self._pattern)


# ---------------------------------------------------------------------------
# Zero-copy columnar wire frame
# ---------------------------------------------------------------------------

#: Content-Type the serving stack negotiates the binary wire on
FRAME_CONTENT_TYPE = "application/x-mmlspark-frame"
FRAME_MAGIC = b"MMSF"
FRAME_VERSION = 1

#: header bounds — enforced BEFORE any length field is trusted, so a hostile
#: frame can never trigger an attacker-sized allocation or column walk
MAX_FRAME_COLS = 64
MAX_FRAME_NDIM = 8
MAX_HEADER_LEN = 8192
MAX_NAME_LEN = 64
#: default cap on a whole frame (callers pass their own ``max_bytes``; HTTP
#: ingress uses the request body length, already bounded by admission)
MAX_FRAME_BYTES = 1 << 31

#: wire dtype codes <-> numpy (little-endian on the wire; native here — the
#: wire is LE and so is every supported host and device platform)
DTYPE_CODES: Dict[int, np.dtype] = {
    1: np.dtype(np.uint8), 2: np.dtype(np.int8),
    3: np.dtype(np.uint16), 4: np.dtype(np.int16),
    5: np.dtype(np.uint32), 6: np.dtype(np.int32),
    7: np.dtype(np.uint64), 8: np.dtype(np.int64),
    9: np.dtype(np.float16), 10: np.dtype(np.float32),
    11: np.dtype(np.float64), 12: np.dtype(np.bool_),
}
_DTYPE_TO_CODE = {dt: code for code, dt in DTYPE_CODES.items()}

_FIXED = struct.Struct("<4sBBBQH")  # magic, version, flags, ncols,
#                                     total_len, header_len


class FrameError(ValueError):
    """Malformed, truncated, oversized, or otherwise rejected wire frame."""


def is_frame(buf: Union[bytes, bytearray, memoryview]) -> bool:
    """Cheap magic sniff (used by the journal to pick the record variant)."""
    return len(buf) >= 4 and bytes(buf[:4]) == FRAME_MAGIC


def encode_frame(columns: Dict[str, np.ndarray]) -> bytes:
    """Encode named arrays as one wire frame (column order preserved)."""
    if not columns:
        raise FrameError("frame needs at least one column")
    if len(columns) > MAX_FRAME_COLS:
        raise FrameError(f"too many columns ({len(columns)})")
    table = bytearray()
    payloads: List[bytes] = []
    for name, arr in columns.items():
        arr = np.asarray(arr)
        if not arr.flags["C_CONTIGUOUS"]:  # ascontiguousarray would also
            arr = np.ascontiguousarray(arr)  # promote 0-d to 1-d

        code = _DTYPE_TO_CODE.get(arr.dtype)
        if code is None:
            raise FrameError(f"unsupported dtype {arr.dtype} for {name!r}")
        nm = name.encode("utf-8")
        if not 1 <= len(nm) <= MAX_NAME_LEN:
            raise FrameError(f"bad column name {name!r}")
        if arr.ndim > MAX_FRAME_NDIM:
            raise FrameError(f"rank {arr.ndim} exceeds {MAX_FRAME_NDIM}")
        if arr.nbytes > 0xFFFFFFFF:
            raise FrameError(f"column {name!r} exceeds u32 payload bound")
        table += struct.pack(f"<B{len(nm)}sBB", len(nm), nm, code, arr.ndim)
        table += struct.pack(f"<{arr.ndim}I", *arr.shape)
        table += struct.pack("<I", arr.nbytes)
        payloads.append(arr.tobytes())
    if len(table) > MAX_HEADER_LEN:
        raise FrameError("column table exceeds MAX_HEADER_LEN")
    total = _FIXED.size + len(table) + sum(len(p) for p in payloads)
    head = _FIXED.pack(FRAME_MAGIC, FRAME_VERSION, 0, len(columns),
                       total, len(table))
    return b"".join([head, bytes(table)] + payloads)


def frame_info(buf: Union[bytes, bytearray, memoryview],
               max_bytes: int = MAX_FRAME_BYTES) -> Dict[str, object]:
    """Validate a frame's bounded header WITHOUT touching the payloads:
    returns {version, total_len, columns: [(name, dtype, shape)]}. The
    serving ingress calls this on arrival so malformed frames 400 before a
    batch slot, journal write, or transform is spent on them."""
    mv = memoryview(buf)
    if len(mv) < _FIXED.size:
        raise FrameError(f"truncated frame header ({len(mv)} bytes)")
    magic, version, _flags, ncols, total, hlen = _FIXED.unpack(
        mv[:_FIXED.size])
    if magic != FRAME_MAGIC:
        raise FrameError("bad magic")
    if version != FRAME_VERSION:
        raise FrameError(f"unsupported frame version {version}")
    if not 1 <= ncols <= MAX_FRAME_COLS:
        raise FrameError(f"bad column count {ncols}")
    if hlen > MAX_HEADER_LEN:
        raise FrameError(f"header length {hlen} exceeds bound")
    if total > max_bytes:
        raise FrameError(f"frame length {total} exceeds cap {max_bytes}")
    if total != len(mv):
        raise FrameError(
            f"frame length field {total} != buffer size {len(mv)}")
    if _FIXED.size + hlen > len(mv):
        raise FrameError("column table overruns buffer")
    table = mv[_FIXED.size:_FIXED.size + hlen]
    cols: List[Tuple[str, np.dtype, Tuple[int, ...], int]] = []
    off = 0
    payload_total = 0
    for _ in range(ncols):
        if off + 1 > len(table):
            raise FrameError("truncated column table")
        nlen = table[off]
        off += 1
        if not 1 <= nlen <= MAX_NAME_LEN or off + nlen + 2 > len(table):
            raise FrameError("bad column name length")
        name = bytes(table[off:off + nlen]).decode("utf-8", errors="strict")
        off += nlen
        code, ndim = table[off], table[off + 1]
        off += 2
        dt = DTYPE_CODES.get(code)
        if dt is None:
            raise FrameError(f"unknown dtype code {code}")
        if ndim > MAX_FRAME_NDIM or off + 4 * ndim + 4 > len(table):
            raise FrameError("bad column rank")
        shape = struct.unpack_from(f"<{ndim}I", table, off)
        off += 4 * ndim
        (plen,) = struct.unpack_from("<I", table, off)
        off += 4
        nelem = 1
        for d in shape:
            nelem *= d
        if plen != nelem * dt.itemsize:
            raise FrameError(
                f"column {name!r}: payload {plen} != shape {shape} x "
                f"{dt.itemsize}")
        cols.append((name, dt, tuple(int(d) for d in shape), plen))
        payload_total += plen
    if off != len(table):
        raise FrameError("column table has trailing bytes")
    if _FIXED.size + hlen + payload_total != total:
        raise FrameError("payload lengths do not sum to frame length")
    return {"version": version, "total_len": int(total),
            "columns": [(n, d, s) for n, d, s, _ in cols],
            "_spans": cols}


def _payload_offset(info: Dict[str, object]) -> int:
    """Byte offset of the first payload (fixed header + column table)."""
    return _FIXED.size + sum(
        1 + len(n.encode("utf-8")) + 2 + 4 * len(s) + 4
        for n, _, s in info["columns"])


def decode_frame(buf: Union[bytes, bytearray, memoryview],
                 max_bytes: int = MAX_FRAME_BYTES,
                 out: Optional[Dict[str, np.ndarray]] = None
                 ) -> Dict[str, np.ndarray]:
    """Frame bytes -> {name: ndarray}. The arrays are read-only VIEWS over
    ``buf`` (np.frombuffer — zero-copy); they stay valid as long as the
    caller keeps ``buf`` alive (the serving path keeps the request body in
    the batch rows, so views outlive the transform).

    ``out``: the deposit path (``deposit_frame``) — payloads land directly
    in the caller's pre-allocated staging arrays instead of views."""
    if out is not None:
        return deposit_frame(buf, out, max_bytes=max_bytes)
    info = frame_info(buf, max_bytes=max_bytes)
    mv = memoryview(buf)
    res: Dict[str, np.ndarray] = {}
    off = _payload_offset(info)
    for name, dt, shape, plen in info["_spans"]:
        arr = np.frombuffer(mv[off:off + plen], dtype=dt).reshape(shape)
        res[name] = arr
        off += plen
    return res


def deposit_frame(buf: Union[bytes, bytearray, memoryview],
                  out: Dict[str, np.ndarray],
                  max_bytes: int = MAX_FRAME_BYTES) -> Dict[str, np.ndarray]:
    """Socket-to-slot decode: copy each column's payload bytes DIRECTLY
    into a caller-owned staging destination (a pinned host buffer) — one
    memcpy per column, no intermediate views or allocations.

    Deposit contract: the ENTIRE frame is validated
    (``frame_info``) and every destination checked — present, C-contiguous,
    writeable, exact dtype and shape — BEFORE the first byte is written.
    A hostile frame (bad magic/lengths, truncated or misaligned payloads)
    or a mismatched destination raises ``FrameError`` with every slot
    untouched; a half-deposited slot is impossible. Extra ``out`` entries
    the frame doesn't name are left as-is. Returns {name: destination}
    for the frame's columns."""
    info = frame_info(buf, max_bytes=max_bytes)
    mv = memoryview(buf)
    spans = info["_spans"]
    for name, dt, shape, _plen in spans:
        dst = out.get(name)
        if dst is None:
            raise FrameError(f"no staging destination for column {name!r}")
        if not isinstance(dst, np.ndarray):
            raise FrameError(
                f"staging destination for {name!r} is not an ndarray")
        if not dst.flags["C_CONTIGUOUS"] or not dst.flags["WRITEABLE"]:
            raise FrameError(
                f"staging destination for {name!r} must be C-contiguous "
                f"and writeable")
        if dst.dtype != dt:
            raise FrameError(
                f"column {name!r}: frame dtype {dt} != slot dtype "
                f"{dst.dtype}")
        if tuple(dst.shape) != shape:
            raise FrameError(
                f"column {name!r}: frame shape {shape} != slot shape "
                f"{tuple(dst.shape)}")
    off = _payload_offset(info)
    res: Dict[str, np.ndarray] = {}
    for name, dt, shape, plen in spans:
        dst = out[name]
        # raw byte copy through the buffer protocol: the one host copy on
        # the deposit path (socket buffer -> staging slot); 0-d slots go
        # through a 1-element view (memoryview.cast needs ndim >= 1)
        flat = dst if dst.ndim else dst.reshape(1)
        memoryview(flat).cast("B")[:] = mv[off:off + plen]
        res[name] = dst
        off += plen
    return res


# ---------------------------------------------------------------------------
# CSR columns on the wire
# ---------------------------------------------------------------------------

#: reserved sub-column suffixes a CSR triple ships under; a frame column
#: named ``{c}:indptr`` declares sparse column ``c`` and requires its three
#: siblings (``:width`` rides along so decode never guesses the feature
#: count from the data)
CSR_SUFFIXES = (":indptr", ":indices", ":values", ":width")


def encode_csr_columns(name: str, indptr: np.ndarray, indices: np.ndarray,
                       values: np.ndarray, width: int
                       ) -> Dict[str, np.ndarray]:
    """One host CSR column -> the four wire sub-columns ``encode_frame``
    ships (i32 indptr / i32 indices / f32 values / 0-d i32 width). The
    triple is validated before encoding — a malformed CSR never leaves the
    encoder, so every reject lives in one place (``validate_csr_triple``)."""
    cols = {
        f"{name}:indptr": np.ascontiguousarray(indptr, dtype=np.int32),
        f"{name}:indices": np.ascontiguousarray(indices, dtype=np.int32),
        f"{name}:values": np.ascontiguousarray(values, dtype=np.float32),
        f"{name}:width": np.asarray(int(width), dtype=np.int32),
    }
    validate_csr_triple(name, cols[f"{name}:indptr"],
                        cols[f"{name}:indices"], cols[f"{name}:values"],
                        int(width))
    return cols


def validate_csr_triple(name: str, indptr: np.ndarray, indices: np.ndarray,
                        values: np.ndarray, width: int,
                        rows: Optional[int] = None) -> None:
    """Reject a hostile CSR triple with ``FrameError`` (all-or-nothing:
    callers validate EVERY declared triple before materializing any).
    Checked: rank-1 i32 indptr anchored at 0, non-decreasing, closing
    exactly on len(indices) == len(values); every index in [0, width);
    positive width; the row count when the caller knows it."""
    if indptr.ndim != 1 or indices.ndim != 1 or values.ndim != 1:
        raise FrameError(f"sparse column {name!r}: CSR parts must be rank-1")
    if len(indptr) < 1:
        raise FrameError(f"sparse column {name!r}: empty indptr")
    if rows is not None and len(indptr) != int(rows) + 1:
        raise FrameError(
            f"sparse column {name!r}: indptr rows {len(indptr) - 1} != "
            f"frame rows {rows}")
    if int(width) <= 0:
        raise FrameError(f"sparse column {name!r}: width must be positive")
    ip = np.asarray(indptr, dtype=np.int64)
    if ip[0] != 0:
        raise FrameError(f"sparse column {name!r}: indptr[0] != 0")
    if len(ip) > 1 and np.any(np.diff(ip) < 0):
        raise FrameError(f"sparse column {name!r}: non-monotone indptr")
    if int(ip[-1]) != len(indices) or len(indices) != len(values):
        raise FrameError(
            f"sparse column {name!r}: indptr[-1] {int(ip[-1])} != nnz "
            f"{len(indices)}/{len(values)}")
    if len(indices) and (int(np.min(indices)) < 0
                         or int(np.max(indices)) >= int(width)):
        raise FrameError(
            f"sparse column {name!r}: index out of [0, {int(width)})")


def decode_csr_columns(columns: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
    """Decoded frame columns -> ingest rows, materializing each declared
    CSR group as one object column of per-row ``{"indices", "values",
    "size"}`` dicts — the sparse-row form the whole host stack consumes
    (parallel/ingest.py, gbdt/sparse.py ``rows_to_csr``).

    All-or-nothing, like ``deposit_frame``: EVERY declared triple is
    validated (complete sibling set, ``validate_csr_triple``, equal row
    counts across groups and against any dense column) before the first
    row dict is built, so a hostile triple raises ``FrameError`` with
    nothing materialized. Dense columns pass through untouched; a frame
    with no ``:indptr`` columns returns byte-identical input."""
    bases = [c[:-len(":indptr")] for c in columns if c.endswith(":indptr")]
    if not bases:
        return columns
    rows: Optional[int] = None
    for c, v in columns.items():
        if any(c.endswith(s) for s in CSR_SUFFIXES):
            continue
        n = len(v) if np.ndim(v) else None
        if n is not None:
            if rows is not None and n != rows:
                raise FrameError("dense columns disagree on row count")
            rows = n
    triples: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray, int]] = {}
    for base in sorted(bases):
        parts = {}
        for suffix in CSR_SUFFIXES:
            part = columns.get(base + suffix)
            if part is None:
                raise FrameError(
                    f"sparse column {base!r}: missing {suffix} sibling")
            parts[suffix] = part
        if parts[":width"].ndim != 0:
            raise FrameError(f"sparse column {base!r}: width must be 0-d")
        width = int(parts[":width"])
        validate_csr_triple(base, parts[":indptr"], parts[":indices"],
                            parts[":values"], width, rows=rows)
        if rows is None:
            rows = len(parts[":indptr"]) - 1
        triples[base] = (np.asarray(parts[":indptr"], dtype=np.int64),
                         parts[":indices"], parts[":values"], width)
    out: Dict[str, np.ndarray] = {
        c: v for c, v in columns.items()
        if not any(c.endswith(s) for s in CSR_SUFFIXES)}
    for base, (ip, idx, val, width) in triples.items():
        col = np.empty(rows or 0, dtype=object)
        for i in range(rows or 0):
            lo, hi = int(ip[i]), int(ip[i + 1])
            col[i] = {"indices": np.asarray(idx[lo:hi], dtype=np.int64),
                      "values": np.asarray(val[lo:hi], dtype=np.float64),
                      "size": width}
        out[base] = col
    return out
