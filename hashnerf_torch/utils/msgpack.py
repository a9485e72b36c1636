"""A msgpack decoder with the standard library and numpy, for the JAX
package's checkpoints.

Counterpart of flax's `serialization.msgpack_restore`: nil, bool, int,
float, str, bin, array, map and ext. flax's ext types become what flax makes
of them: 1 an ndarray (its data is msgpack of (shape, dtype name, bytes)),
2 a Python complex, 3 a numpy scalar. A dict flax made of an oversized
array (`__msgpack_chunked_array__`) is joined back into the array. Anything
it cannot decode raises ValueError naming it.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (wants {n} more)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-size headers: byte -> (struct format of the length or value, kind)
_SIZED = {
    0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
    0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
    0xdc: (">H", "array"), 0xdd: (">I", "array"),
    0xde: (">H", "map"), 0xdf: (">I", "map"),
    0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
}
_NUMBERS = {
    0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
    0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _decode(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_decode(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return bytes(r.take(b & 0x1f)).decode("utf-8")
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _NUMBERS:
        return r.unpack(_NUMBERS[b])
    if b in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(_FIXEXT[b])))
    if b in _SIZED:
        fmt, kind = _SIZED[b]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return bytes(r.take(n)).decode("utf-8")
        if kind == "array":
            return [_decode(r) for _ in range(n)]
        if kind == "map":
            return _map(r, n)
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at byte {r.pos - 1}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    if isinstance(name, bytes):
        name = name.decode()
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"msgpack: array dtype {name!r} has no numpy type") from None
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == 1:
        return _ndarray(data)
    if code == 2:
        re, im = unpackb(data)
        return complex(re, im)
    if code == 3:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack: unknown ext type {code}")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that fills `data`."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes left after the object")
    return out


def _seq(d: dict, what: str) -> Tuple:
    try:
        return tuple(d[str(i)] for i in range(len(d)))
    except (KeyError, TypeError):
        raise ValueError(f"msgpack: {_CHUNKED} {what} is not a list") from None


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        try:
            shape = _seq(tree["shape"], "shape")
            chunks = _seq(tree["chunks"], "chunks")
            return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)
        except (KeyError, ValueError) as e:
            raise ValueError(f"msgpack: a malformed {_CHUNKED} dict ({e})") from None
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The state dict flax's `msgpack_serialize` wrote into `data`."""
    return _unchunk(unpackb(data))
