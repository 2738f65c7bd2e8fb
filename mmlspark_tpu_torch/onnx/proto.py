"""Minimal protobuf wire-format codec + ONNX message schema (no onnx/protobuf deps).

The port's own copy of ``mmlspark_tpu/onnx/proto.py`` (pure numpy, so the
port keeps it rather than import the JAX package): an ONNX ModelProto parser
feeding ``onnx/importer.py`` and the writers ``onnx/export.py`` uses. The
writers emit the reference's bytes for the same nodes and tensors, producer
name included, so a file exported by either package is byte for byte the
same.

Wire format: https://protobuf.dev/programming-guides/encoding/
  tag = (field_number << 3) | wire_type
  wire types: 0=varint, 1=fixed64, 2=length-delimited, 5=fixed32

Schema field numbers follow onnx/onnx.proto3 (IR v7, opset 13+ era — stable since 2017
for every field we touch).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def _write_varint(value: int) -> bytes:
    if value < 0:  # protobuf encodes negative ints as 10-byte two's complement
        value += 1 << 64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(value: int) -> int:  # not used by ONNX (no sint fields) but cheap to keep
    return (value << 1) ^ (value >> 63)


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, raw_value) for each field in a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, val


def parse_fields(buf: bytes) -> Dict[int, List[Any]]:
    """Group fields by number (repeated fields accumulate in order)."""
    out: Dict[int, List[Any]] = {}
    for field, _wire, val in iter_fields(buf):
        out.setdefault(field, []).append(val)
    return out


class Writer:
    """Append-only protobuf message writer."""

    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def varint(self, field: int, value: int) -> "Writer":
        self._parts.append(_write_varint(field << 3 | 0))
        self._parts.append(_write_varint(int(value)))
        return self

    def bytes_(self, field: int, value: bytes) -> "Writer":
        self._parts.append(_write_varint(field << 3 | 2))
        self._parts.append(_write_varint(len(value)))
        self._parts.append(value)
        return self

    def string(self, field: int, value: str) -> "Writer":
        return self.bytes_(field, value.encode("utf-8"))

    def message(self, field: int, sub: "Writer") -> "Writer":
        return self.bytes_(field, sub.tobytes())

    def float32(self, field: int, value: float) -> "Writer":
        self._parts.append(_write_varint(field << 3 | 5))
        self._parts.append(struct.pack("<f", value))
        return self

    def packed_varints(self, field: int, values) -> "Writer":
        body = b"".join(_write_varint(int(v)) for v in values)
        return self.bytes_(field, body)

    def tobytes(self) -> bytes:
        return b"".join(self._parts)


def _as_int(v: Any) -> int:
    return v if isinstance(v, int) else _read_varint(v, 0)[0]


def _as_str(v: bytes) -> str:
    return v.decode("utf-8")


def _packed_ints(vals: List[Any]) -> List[int]:
    """A repeated varint field arrives either packed (bytes) or unpacked (ints)."""
    out: List[int] = []
    for v in vals:
        if isinstance(v, int):
            out.append(v)
        else:
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                out.append(x)
    return out


def _signed64(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


# ---------------------------------------------------------------------------
# ONNX schema: typed views over parsed messages
# ---------------------------------------------------------------------------

# TensorProto.DataType
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64, DT_BOOL, DT_FLOAT16, DT_DOUBLE = (
    1, 2, 3, 6, 7, 9, 10, 11)
DT_BFLOAT16 = 16

_DT_TO_NP = {
    DT_FLOAT: np.float32,
    DT_UINT8: np.uint8,
    DT_INT8: np.int8,
    DT_INT32: np.int32,
    DT_INT64: np.int64,
    DT_BOOL: np.bool_,
    DT_FLOAT16: np.float16,
    DT_DOUBLE: np.float64,
}
_NP_TO_DT = {np.dtype(v): k for k, v in _DT_TO_NP.items()}


class Attribute:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, strings=9, type=20."""

    def __init__(self, buf: bytes):
        f = parse_fields(buf)
        self.name = _as_str(f[1][0]) if 1 in f else ""
        self.f = struct.unpack("<f", f[2][0])[0] if 2 in f else None
        self.i = _signed64(_as_int(f[3][0])) if 3 in f else None
        self.s = f[4][0] if 4 in f else None
        self.t = Tensor(f[5][0]) if 5 in f else None
        # repeated float: packed (one long buffer) or unpacked (4-byte chunks) — both
        # concatenate cleanly as little-endian f32
        self.floats = [x for v in f.get(7, [])
                       for x in np.frombuffer(v, dtype="<f4").tolist()]
        self.ints = [_signed64(x) for x in _packed_ints(f.get(8, []))]
        self.strings = list(f.get(9, []))

    def value(self) -> Any:
        for v in (self.t, self.s, self.f, self.i):
            if v is not None:
                return v
        if self.ints:
            return self.ints
        if self.floats:
            return self.floats
        if self.strings:
            return self.strings
        # scalar zero attributes (f=0.0 / i=0) are omitted on the wire; default to 0
        return 0


class Tensor:
    """TensorProto: dims=1, data_type=2, float_data=4, int32_data=5, int64_data=7,
    name=8, raw_data=9, double_data=10."""

    def __init__(self, buf: bytes):
        f = parse_fields(buf)
        self.dims = [_as_int(x) for x in _packed_ints(f.get(1, []))]
        self.data_type = _as_int(f[2][0]) if 2 in f else DT_FLOAT
        self.name = _as_str(f[8][0]) if 8 in f else ""
        self._f = f

    def to_numpy(self) -> np.ndarray:
        np_dtype = _DT_TO_NP.get(self.data_type)
        if np_dtype is None:
            raise ValueError(f"unsupported tensor data_type {self.data_type} "
                             f"for initializer {self.name!r}")
        f = self._f
        if 9 in f:  # raw_data: little-endian bytes
            arr = np.frombuffer(f[9][0], dtype=np.dtype(np_dtype).newbyteorder("<"))
        elif 4 in f and self.data_type == DT_FLOAT:
            arr = np.concatenate([np.frombuffer(v, dtype="<f4") for v in f[4]])
        elif 10 in f and self.data_type == DT_DOUBLE:
            arr = np.concatenate([np.frombuffer(v, dtype="<f8") for v in f[10]])
        elif 7 in f and self.data_type == DT_INT64:
            arr = np.array([_signed64(x) for x in _packed_ints(f[7])], dtype=np.int64)
        elif 5 in f:  # int32_data carries int32/int8/uint8/bool/float16 payloads
            ints = _packed_ints(f[5])
            if self.data_type == DT_FLOAT16:
                # fp16 in int32_data is the raw uint16 bit pattern, not a value
                arr = np.array(ints, dtype=np.int32).astype(np.uint16).view(np.float16)
            else:
                arr = np.array(ints, dtype=np.int32).astype(np_dtype)
        else:
            arr = np.zeros(0, dtype=np_dtype)
        return arr.reshape(self.dims).astype(np_dtype, copy=False)


class ValueInfo:
    """ValueInfoProto -> (name, elem_type, dims); dynamic dims become None."""

    def __init__(self, buf: bytes):
        f = parse_fields(buf)
        self.name = _as_str(f[1][0]) if 1 in f else ""
        self.elem_type: Optional[int] = None
        self.dims: Optional[List[Optional[int]]] = None
        if 2 in f:  # TypeProto
            tp = parse_fields(f[2][0])
            if 1 in tp:  # tensor_type
                tt = parse_fields(tp[1][0])
                if 1 in tt:
                    self.elem_type = _as_int(tt[1][0])
                if 2 in tt:  # TensorShapeProto
                    shape = parse_fields(tt[2][0])
                    dims: List[Optional[int]] = []
                    for dbuf in shape.get(1, []):
                        d = parse_fields(dbuf)
                        dims.append(_as_int(d[1][0]) if 1 in d else None)
                    self.dims = dims


class Node:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5, domain=7."""

    def __init__(self, buf: bytes):
        f = parse_fields(buf)
        self.inputs = [_as_str(v) for v in f.get(1, [])]
        self.outputs = [_as_str(v) for v in f.get(2, [])]
        self.name = _as_str(f[3][0]) if 3 in f else ""
        self.op_type = _as_str(f[4][0]) if 4 in f else ""
        self.domain = _as_str(f[7][0]) if 7 in f else ""
        self.attrs: Dict[str, Any] = {}
        for abuf in f.get(5, []):
            a = Attribute(abuf)
            self.attrs[a.name] = a.value()

    def __repr__(self) -> str:
        return f"Node({self.op_type}:{self.name} {self.inputs}->{self.outputs})"


class Graph:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""

    def __init__(self, buf: bytes):
        f = parse_fields(buf)
        self.name = _as_str(f[2][0]) if 2 in f else ""
        self.nodes = [Node(v) for v in f.get(1, [])]
        self.initializers = [Tensor(v) for v in f.get(5, [])]
        self.inputs = [ValueInfo(v) for v in f.get(11, [])]
        self.outputs = [ValueInfo(v) for v in f.get(12, [])]


class Model:
    """ModelProto: ir_version=1, producer=2, opset_import=8 (version=2), graph=7."""

    def __init__(self, buf: bytes):
        f = parse_fields(buf)
        self.ir_version = _as_int(f[1][0]) if 1 in f else 0
        self.producer = _as_str(f[2][0]) if 2 in f else ""
        if 7 not in f:
            raise ValueError("ModelProto has no graph — not an ONNX model file?")
        self.graph = Graph(f[7][0])
        self.opset = 0
        for ob in f.get(8, []):
            o = parse_fields(ob)
            if _as_str(o.get(1, [b""])[0]) == "":  # default (ai.onnx) domain
                self.opset = max(self.opset, _as_int(o[2][0]) if 2 in o else 0)


def load_model(path_or_bytes) -> Model:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return Model(bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as fh:
        return Model(fh.read())


# ---------------------------------------------------------------------------
# ONNX writers (export path + test-fixture construction)
# ---------------------------------------------------------------------------


def make_tensor(name: str, arr: np.ndarray) -> Writer:
    arr = np.ascontiguousarray(arr)
    dt = _NP_TO_DT.get(arr.dtype)
    if dt is None:
        raise ValueError(f"unsupported numpy dtype {arr.dtype} for ONNX export")
    w = Writer()
    w.packed_varints(1, arr.shape)
    w.varint(2, dt)
    w.string(8, name)
    w.bytes_(9, arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes())
    return w


def _attr(name: str, value: Any) -> Writer:
    w = Writer().string(1, name)
    if isinstance(value, float):
        w.float32(2, value).varint(20, 1)  # FLOAT
    elif isinstance(value, bool) or isinstance(value, int):
        w.varint(3, int(value)).varint(20, 2)  # INT
    elif isinstance(value, (bytes, str)):
        w.bytes_(4, value.encode() if isinstance(value, str) else value).varint(20, 3)
    elif isinstance(value, Writer):  # pre-built TensorProto
        w.message(5, value).varint(20, 4)
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        for v in value:
            w.float32(7, v)
        w.varint(20, 6)  # FLOATS
    elif isinstance(value, (list, tuple)):
        w.packed_varints(8, [int(v) for v in value]).varint(20, 7)  # INTS
    else:
        raise ValueError(f"unsupported attribute value {value!r}")
    return w


def make_node(op_type: str, inputs: List[str], outputs: List[str],
              name: str = "", **attrs: Any) -> Writer:
    w = Writer()
    for i in inputs:
        w.string(1, i)
    for o in outputs:
        w.string(2, o)
    if name:
        w.string(3, name)
    w.string(4, op_type)
    for k, v in attrs.items():
        w.message(5, _attr(k, v))
    return w


def make_value_info(name: str, dims: List[Optional[int]],
                    elem_type: int = DT_FLOAT) -> Writer:
    shape = Writer()
    for d in dims:
        dim = Writer()
        if d is not None:
            dim.varint(1, d)
        else:
            dim.string(2, "N")
        shape.message(1, dim)
    tensor_type = Writer().varint(1, elem_type).message(2, shape)
    type_proto = Writer().message(1, tensor_type)
    return Writer().string(1, name).message(2, type_proto)


def make_model(nodes: List[Writer], initializers: List[Writer],
               inputs: List[Writer], outputs: List[Writer],
               graph_name: str = "graph", opset: int = 13) -> bytes:
    g = Writer()
    for n in nodes:
        g.message(1, n)
    g.string(2, graph_name)
    for t in initializers:
        g.message(5, t)
    for vi in inputs:
        g.message(11, vi)
    for vi in outputs:
        g.message(12, vi)
    m = Writer()
    m.varint(1, 7)  # ir_version
    m.string(2, "mmlspark_tpu")
    m.message(7, g)
    m.message(8, Writer().string(1, "").varint(2, opset))
    return m.tobytes()
