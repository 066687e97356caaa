"""Pure-Python reader and writer for flax msgpack checkpoints.

The packaged checkpoints under ``audio_cut_tpu/models/weights/`` were written
by ``flax.serialization.to_bytes``: a msgpack map of maps whose leaves are
msgpack ext values. ``read_flax_msgpack`` returns what
``flax.serialization.msgpack_restore`` returns for them, without msgpack or
flax installed:

* ext type 1: an ndarray, itself msgpack-encoded as ``(shape, dtype name,
  row-major bytes)``;
* ext type 2: a complex scalar, encoded as ``(real, imag)``;
* ext type 3: a numpy scalar, encoded as a 0-d ndarray.

flax splits array leaves above 2**30 bytes into chunks; no checkpoint of
this repository is near that size, and a chunked leaf raises.

``write_flax_msgpack`` is the inverse for a parameter tree: nested dicts of
str keys whose leaves are numpy arrays, encoded as
``flax.serialization.to_bytes`` encodes them (msgpack maps in the dicts'
order, each array an ext type 1 value holding ``(shape, dtype name,
row-major bytes)``, every msgpack value in its shortest form).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Tuple, Union

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes, raw: bool = False) -> None:
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # strings stay bytes (flax reads the ndarray header so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:  # bin 8/16/32
            return bytes(self.take(self.unpack(lengths[b])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(1 << (b - 0xD4))))
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self._array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack byte 0x{b:02x} at {self.pos - 1}")

    def _str(self, n: int) -> Union[str, bytes]:
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _unpack_one(data: bytes, raw: bool) -> Any:
    reader = _Reader(data, raw=raw)
    value = reader.read()
    if reader.pos != len(data):
        raise ValueError("extra bytes after msgpack value")
    return value


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _unpack_one(data, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 leaves need ml_dtypes; the port's checkpoints are float32")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()), count=-1,
                         offset=0).reshape(shape, order="C")


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        re_, im_ = _unpack_one(data, raw=False)
        return complex(re_, im_)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _check_unchunked(tree: Any) -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("chunked flax array leaves (> 2**30 bytes) are not supported")
        for v in tree.values():
            _check_unchunked(v)


def read_flax_msgpack(source: Union[str, Path, bytes]) -> Any:
    """Decode a flax msgpack checkpoint (a path or its bytes) into nested
    dicts of numpy arrays, as ``flax.serialization.msgpack_restore`` does."""
    data = source if isinstance(source, (bytes, bytearray)) else Path(source).read_bytes()
    tree = _unpack_one(bytes(data), raw=False)
    _check_unchunked(tree)
    return tree


def flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> dict:
    """{(key, ..., key): leaf} for a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


_MAX_LEAF_BYTES = 2 ** 30  # above this flax would chunk the leaf


def _pack_uint_header(small_base: int, small_max: int, codes: Tuple[int, int, int], n: int,
                      out: bytearray) -> None:
    """A length header: fix form below ``small_max``, else the 8/16/32-bit
    form of ``codes`` (``None`` where msgpack has no 8-bit form)."""
    if n <= small_max:
        out.append(small_base | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack length {n} too large")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v > 0:
        for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                               (0xCE, ">BI", 0xFFFFFFFF), (0xCF, ">BQ", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out += struct.pack(fmt, code, v)
                return
        raise ValueError(f"integer {v} too large for msgpack")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000),
                               (0xD2, ">Bi", -0x80000000), (0xD3, ">Bq", -0x8000000000000000)):
            if v >= low:
                out += struct.pack(fmt, code, v)
                return
        raise ValueError(f"integer {v} too small for msgpack")


def _pack_str(s: str, out: bytearray) -> None:
    data = s.encode("utf-8")
    _pack_uint_header(0xA0, 31, (0xD9, 0xDA, 0xDB), len(data), out)
    out += data


def _pack_bin(data: bytes, out: bytearray) -> None:
    _pack_uint_header(0, -1, (0xC4, 0xC5, 0xC6), len(data), out)
    out += data


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_uint_header(0, -1, (0xC7, 0xC8, 0xC9), len(data), out)
    out += struct.pack(">b", code)
    out += data


def _pack_ndarray(arr: np.ndarray, out: bytearray) -> None:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or arr.dtype.fields:
        raise TypeError(f"cannot write a {arr.dtype} array to a flax checkpoint")
    if arr.nbytes > _MAX_LEAF_BYTES:
        raise ValueError("array leaves above 2**30 bytes (chunked by flax) are not supported")
    header = bytearray()
    _pack_uint_header(0x90, 15, (None, 0xDC, 0xDD), 3, header)  # (shape, dtype, bytes)
    _pack_uint_header(0x90, 15, (None, 0xDC, 0xDD), arr.ndim, header)
    for dim in arr.shape:
        _pack_int(int(dim), header)
    _pack_str(arr.dtype.name, header)
    _pack_bin(arr.tobytes("C"), header)
    _pack_ext(_EXT_NDARRAY, bytes(header), out)


def _pack_tree(tree: Any, out: bytearray) -> None:
    if isinstance(tree, dict):
        _pack_uint_header(0x80, 15, (None, 0xDE, 0xDF), len(tree), out)
        for key, value in tree.items():
            if not isinstance(key, str):
                raise TypeError(f"flax checkpoint keys are str, got {key!r}")
            _pack_str(key, out)
            _pack_tree(value, out)
    elif isinstance(tree, np.ndarray):
        _pack_ndarray(tree, out)
    else:
        raise TypeError(f"a flax parameter tree holds dicts and numpy arrays, got {type(tree)}")


def write_flax_msgpack(tree: Any) -> bytes:
    """Encode a parameter tree (nested dicts of str keys, numpy array leaves)
    as ``flax.serialization.to_bytes`` does."""
    out = bytearray()
    _pack_tree(tree, out)
    return bytes(out)
