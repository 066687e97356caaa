"""Minimal ONNX protobuf wire-format reader and writer (no ``onnx`` package).

Counterpart of ``audio_cut_tpu/onnx/proto.py``, numpy only: the subset of the
ONNX ModelProto schema that MDX-class separation models use (graph nodes,
attributes, initializers, value infos), read and written by walking the
protobuf wire format directly. Both packages write the same bytes for one
graph.

Wire format primer: a message is a sequence of (tag, value) records where
tag = (field_number << 3) | wire_type; wire types used by ONNX are 0
(varint), 2 (length-delimited: sub-messages, strings, bytes, packed arrays),
1/5 (fixed 64/32-bit scalars).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

# -- low-level wire helpers --------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _write_varint(value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1  # protobuf encodes negatives as 64-bit two's complement
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, raw value) records of one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _tag(fnum: int, wtype: int) -> bytes:
    return _write_varint((fnum << 3) | wtype)


def _f_varint(fnum: int, value: int) -> bytes:
    return _tag(fnum, 0) + _write_varint(int(value))


def _f_bytes(fnum: int, data: bytes) -> bytes:
    return _tag(fnum, 2) + _write_varint(len(data)) + data


def _f_str(fnum: int, s: str) -> bytes:
    return _f_bytes(fnum, s.encode("utf-8"))


def _f_float(fnum: int, v: float) -> bytes:
    return _tag(fnum, 5) + struct.pack("<f", v)


# -- ONNX data types ----------------------------------------------------------

DT_FLOAT = 1
DT_UINT8 = 2
DT_INT8 = 3
DT_INT16 = 5
DT_INT32 = 6
DT_INT64 = 7
DT_BOOL = 9
DT_FLOAT16 = 10
DT_DOUBLE = 11

_DTYPE_TO_NP = {
    DT_FLOAT: np.float32,
    DT_UINT8: np.uint8,
    DT_INT8: np.int8,
    DT_INT16: np.int16,
    DT_INT32: np.int32,
    DT_INT64: np.int64,
    DT_BOOL: np.bool_,
    DT_FLOAT16: np.float16,
    DT_DOUBLE: np.float64,
}
_NP_TO_DTYPE = {np.dtype(v): k for k, v in _DTYPE_TO_NP.items()}


# -- parsed model structures ---------------------------------------------------


@dataclass
class Attribute:
    name: str
    value: Any  # float | int | bytes(str) | np.ndarray | list[...]


@dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Graph:
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]          # graph inputs that are NOT initializers
    outputs: List[str]
    input_shapes: Dict[str, List[Optional[int]]] = field(default_factory=dict)
    name: str = "graph"
    opset: int = 17
    producer: str = ""


# -- TensorProto ---------------------------------------------------------------


def parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    data_type = DT_FLOAT
    name = ""
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int_data: List[int] = []
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 1 and wtype == 0:
            dims.append(val)
        elif fnum == 2 and wtype == 0:
            data_type = val
        elif fnum == 4:  # float_data (packed or unpacked)
            if wtype == 2:
                float_data.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                float_data.append(struct.unpack("<f", val)[0])
        elif fnum in (5, 7):  # int32_data / int64_data
            if wtype == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int_data.append(v)
            else:
                int_data.append(val)
        elif fnum == 8 and wtype == 2:
            name = val.decode("utf-8")
        elif fnum == 9 and wtype == 2:
            raw = val
        elif fnum == 13:
            raise ValueError(f"tensor {name!r} uses external data (unsupported)")
    np_dtype = _DTYPE_TO_NP.get(data_type)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {data_type}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np.dtype(np_dtype).newbyteorder("<")).astype(np_dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=np_dtype)
    elif int_data:
        if data_type == DT_INT64:
            # undo unsigned varint for negative int64
            arr = np.asarray(
                [v - (1 << 64) if v >= (1 << 63) else v for v in int_data], dtype=np.int64
            )
        else:
            arr = np.asarray(
                [v - (1 << 32) if v >= (1 << 31) else v for v in int_data], dtype=np_dtype
            )
    else:
        arr = np.zeros(0, dtype=np_dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def build_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dtype_code = _NP_TO_DTYPE.get(arr.dtype)
    if dtype_code is None:
        raise ValueError(f"unsupported numpy dtype {arr.dtype}")
    out = bytearray()
    for d in arr.shape:
        out += _f_varint(1, d)
    out += _f_varint(2, dtype_code)
    out += _f_str(8, name)
    out += _f_bytes(9, np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder("<")).tobytes())
    return bytes(out)


# -- AttributeProto ---------------------------------------------------------------

_ATTR_FLOAT = 1
_ATTR_INT = 2
_ATTR_STRING = 3
_ATTR_TENSOR = 4
_ATTR_FLOATS = 6
_ATTR_INTS = 7
_ATTR_STRINGS = 8


def parse_attribute(buf: bytes) -> Attribute:
    name = ""
    f_val = i_val = s_val = t_val = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    atype = None
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 1 and wtype == 2:
            name = val.decode("utf-8")
        elif fnum == 2:
            f_val = struct.unpack("<f", val)[0] if wtype == 5 else val
        elif fnum == 3 and wtype == 0:
            i_val = val - (1 << 64) if val >= (1 << 63) else val
        elif fnum == 4 and wtype == 2:
            s_val = val
        elif fnum == 5 and wtype == 2:
            t_val = parse_tensor(val)[1]
        elif fnum == 7:
            if wtype == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            if wtype == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(v - (1 << 64) if v >= (1 << 63) else v)
            else:
                ints.append(val - (1 << 64) if val >= (1 << 63) else val)
        elif fnum == 9 and wtype == 2:
            strings.append(val)
        elif fnum == 20 and wtype == 0:
            atype = val
    if atype == _ATTR_FLOAT or (atype is None and f_val is not None):
        return Attribute(name, float(f_val))
    if atype == _ATTR_INT or (atype is None and i_val is not None):
        return Attribute(name, int(i_val))
    if atype == _ATTR_STRING or (atype is None and s_val is not None):
        return Attribute(name, s_val.decode("utf-8", errors="replace"))
    if atype == _ATTR_TENSOR or (atype is None and t_val is not None):
        return Attribute(name, t_val)
    if atype == _ATTR_FLOATS or floats:
        return Attribute(name, [float(x) for x in floats])
    if atype == _ATTR_INTS or ints:
        return Attribute(name, [int(x) for x in ints])
    if atype == _ATTR_STRINGS or strings:
        return Attribute(name, [s.decode("utf-8", errors="replace") for s in strings])
    return Attribute(name, None)


def build_attribute(name: str, value: Any) -> bytes:
    out = bytearray()
    out += _f_str(1, name)
    if isinstance(value, bool):
        out += _f_varint(3, int(value)) + _f_varint(20, _ATTR_INT)
    elif isinstance(value, float):
        out += _f_float(2, value) + _f_varint(20, _ATTR_FLOAT)
    elif isinstance(value, int):
        out += _f_varint(3, value) + _f_varint(20, _ATTR_INT)
    elif isinstance(value, str):
        out += _f_bytes(4, value.encode("utf-8")) + _f_varint(20, _ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += _f_bytes(5, build_tensor(name + "_t", value)) + _f_varint(20, _ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            for v in value:
                out += _f_varint(8, v)
            out += _f_varint(20, _ATTR_INTS)
        elif all(isinstance(v, (int, float)) for v in value):
            for v in value:
                out += _f_float(7, float(v))
            out += _f_varint(20, _ATTR_FLOATS)
        else:
            raise ValueError(f"attribute {name!r}: unsupported list {value!r}")
    else:
        raise ValueError(f"attribute {name!r}: unsupported value {value!r}")
    return bytes(out)


# -- NodeProto ---------------------------------------------------------------------


def parse_node(buf: bytes) -> Node:
    inputs: List[str] = []
    outputs: List[str] = []
    name = ""
    op_type = ""
    attrs: Dict[str, Any] = {}
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 1 and wtype == 2:
            inputs.append(val.decode("utf-8"))
        elif fnum == 2 and wtype == 2:
            outputs.append(val.decode("utf-8"))
        elif fnum == 3 and wtype == 2:
            name = val.decode("utf-8")
        elif fnum == 4 and wtype == 2:
            op_type = val.decode("utf-8")
        elif fnum == 5 and wtype == 2:
            a = parse_attribute(val)
            attrs[a.name] = a.value
    return Node(op_type=op_type, inputs=inputs, outputs=outputs, name=name, attrs=attrs)


def build_node(node: Node) -> bytes:
    out = bytearray()
    for i in node.inputs:
        out += _f_str(1, i)
    for o in node.outputs:
        out += _f_str(2, o)
    if node.name:
        out += _f_str(3, node.name)
    out += _f_str(4, node.op_type)
    for aname, aval in node.attrs.items():
        out += _f_bytes(5, build_attribute(aname, aval))
    return bytes(out)


# -- ValueInfoProto ------------------------------------------------------------------


def _parse_value_info(buf: bytes) -> Tuple[str, List[Optional[int]]]:
    name = ""
    shape: List[Optional[int]] = []
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 1 and wtype == 2:
            name = val.decode("utf-8")
        elif fnum == 2 and wtype == 2:  # TypeProto
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1 and w2 == 2:  # tensor_type
                    for f3, w3, v3 in iter_fields(v2):
                        if f3 == 2 and w3 == 2:  # shape
                            for f4, w4, v4 in iter_fields(v3):
                                if f4 == 1 and w4 == 2:  # dim
                                    dim_val: Optional[int] = None
                                    for f5, w5, v5 in iter_fields(v4):
                                        if f5 == 1 and w5 == 0:
                                            dim_val = v5
                                    shape.append(dim_val)
    return name, shape


def _build_value_info(name: str, shape: List[Optional[int]], elem_type: int = DT_FLOAT) -> bytes:
    dims = bytearray()
    for d in shape:
        if d is None:
            dims += _f_bytes(1, _f_str(2, "N"))  # dim_param
        else:
            dims += _f_bytes(1, _f_varint(1, d))  # dim_value
    tensor_type = _f_varint(1, elem_type) + _f_bytes(2, bytes(dims))
    type_proto = _f_bytes(1, tensor_type)
    return _f_str(1, name) + _f_bytes(2, type_proto)


# -- GraphProto / ModelProto ------------------------------------------------------------


def parse_graph(buf: bytes) -> Graph:
    nodes: List[Node] = []
    initializers: Dict[str, np.ndarray] = {}
    inputs: List[str] = []
    outputs: List[str] = []
    input_shapes: Dict[str, List[Optional[int]]] = {}
    gname = "graph"
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 1 and wtype == 2:
            nodes.append(parse_node(val))
        elif fnum == 2 and wtype == 2:
            gname = val.decode("utf-8")
        elif fnum == 5 and wtype == 2:
            name, arr = parse_tensor(val)
            initializers[name] = arr
        elif fnum == 11 and wtype == 2:
            name, shape = _parse_value_info(val)
            inputs.append(name)
            input_shapes[name] = shape
        elif fnum == 12 and wtype == 2:
            name, _ = _parse_value_info(val)
            outputs.append(name)
    # graph "inputs" in ONNX may include initializers (legacy exports)
    real_inputs = [i for i in inputs if i not in initializers]
    return Graph(
        nodes=nodes,
        initializers=initializers,
        inputs=real_inputs,
        outputs=outputs,
        input_shapes={k: v for k, v in input_shapes.items() if k in real_inputs},
        name=gname,
    )


def load_model(path: str) -> Graph:
    with open(path, "rb") as f:
        data = f.read()
    graph_buf = None
    opset = 0
    producer = ""
    for fnum, wtype, val in iter_fields(data):
        if fnum == 7 and wtype == 2:
            graph_buf = val
        elif fnum == 2 and wtype == 2:
            producer = val.decode("utf-8", errors="replace")
        elif fnum == 8 and wtype == 2:  # opset_import
            for f2, w2, v2 in iter_fields(val):
                if f2 == 2 and w2 == 0:
                    opset = max(opset, v2)
    if graph_buf is None:
        raise ValueError(f"{path}: no graph in ONNX model")
    g = parse_graph(graph_buf)
    g.opset = opset or 17
    g.producer = producer
    return g


def save_model(graph: Graph, path: str, ir_version: int = 8) -> None:
    gbuf = bytearray()
    for node in graph.nodes:
        gbuf += _f_bytes(1, build_node(node))
    gbuf += _f_str(2, graph.name)
    for name, arr in graph.initializers.items():
        gbuf += _f_bytes(5, build_tensor(name, arr))
    for name in graph.inputs:
        shape = graph.input_shapes.get(name, [])
        gbuf += _f_bytes(11, _build_value_info(name, shape))
    for name in graph.outputs:
        gbuf += _f_bytes(12, _build_value_info(name, []))
    mbuf = bytearray()
    mbuf += _f_varint(1, ir_version)
    mbuf += _f_str(2, graph.producer or "audio_cut_tpu")
    mbuf += _f_bytes(7, bytes(gbuf))
    mbuf += _f_bytes(8, _f_str(1, "") + _f_varint(2, graph.opset))
    with open(path, "wb") as f:
        f.write(bytes(mbuf))
