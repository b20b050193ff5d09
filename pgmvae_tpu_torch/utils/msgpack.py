"""The subset of MessagePack that flax's checkpoints use, written out so the
port needs no `msgpack` package.

`packb(obj)` encodes None, bool, int (to 64 bits either sign), float (as
float64), str, bytes, list/tuple, dict (in its own key order) and `ExtType`
with the smallest encoding of each, which is what
`msgpack.packb(obj, use_bin_type=True)` chooses, so the bytes are the same.
`pack_parts` gives those bytes as a list of parts, where an `ExtType`'s data
may itself be a list of parts, so a large array is never joined twice.
`unpackb(data)` decodes the same subset (float32 and the raw-bytes forms
included); strings come back as str, arrays as lists, maps as dicts and
extension types as `ExtType`, or as `ext_hook(code, data)` when given.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Union

Buffer = Union[bytes, bytearray, memoryview]


class ExtType(NamedTuple):
    """An extension value: a type code (0 to 127 when packed, as msgpack
    takes them) and its data (bytes, or for packing a sequence of
    bytes-like parts)."""
    code: int
    data: Union[Buffer, Sequence[Buffer]]


def _length(n: int, small: Optional[int], fix: int, codes: Sequence[int]
            ) -> bytes:
    """Header of a str/bin/array/map of n items: the fixed form when n is
    below `small` (fix | n), else the first of the 8/16/32-bit forms that
    holds n (`codes` gives their type bytes; None where a form is absent)."""
    if small is not None and n < small:
        return bytes((fix | n,))
    for code, fmt, top in zip(codes, ('>B', '>H', '>I'),
                              (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f'msgpack object of {n} items is too large')


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes((x,))
    if -32 <= x < 0:
        return struct.pack('>b', x)
    if x >= 0:
        for code, fmt, top in ((0xcc, '>B', 0xff), (0xcd, '>H', 0xffff),
                               (0xce, '>I', 0xffffffff),
                               (0xcf, '>Q', 0xffffffffffffffff)):
            if x <= top:
                return bytes((code,)) + struct.pack(fmt, x)
    else:
        for code, fmt, low in ((0xd0, '>b', -0x80), (0xd1, '>h', -0x8000),
                               (0xd2, '>i', -0x80000000),
                               (0xd3, '>q', -0x8000000000000000)):
            if x >= low:
                return bytes((code,)) + struct.pack(fmt, x)
    raise OverflowError(f'integer {x} does not fit in 64 bits')


_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _pack(obj: Any, out: List[Buffer]) -> None:
    if obj is None:
        out.append(b'\xc0')
    elif obj is True or obj is False:
        out.append(b'\xc3' if obj else b'\xc2')
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b'\xcb' + struct.pack('>d', obj))
    elif type(obj) is str:
        data = obj.encode('utf-8')
        out.append(_length(len(data), 32, 0xa0, (0xd9, 0xda, 0xdb)))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast('B')
        out.append(_length(data.nbytes, None, 0, (0xc4, 0xc5, 0xc6)))
        out.append(data)
    elif type(obj) in (list, tuple):
        out.append(_length(len(obj), 16, 0x90, (None, 0xdc, 0xdd)))
        for item in obj:
            _pack(item, out)
    elif type(obj) is dict:
        out.append(_length(len(obj), 16, 0x80, (None, 0xde, 0xdf)))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif type(obj) is ExtType:
        if not 0 <= obj.code <= 127:
            raise ValueError(f'ext type code {obj.code} is out of range')
        parts = ([obj.data] if isinstance(obj.data, (bytes, bytearray,
                                                     memoryview))
                 else list(obj.data))
        n = sum(memoryview(p).nbytes for p in parts)
        if n in _FIXEXT:
            head = bytes((_FIXEXT[n],))
        else:
            head = _length(n, None, 0, (0xc7, 0xc8, 0xc9))
        out.append(head + struct.pack('>b', obj.code))
        out.extend(parts)
    else:
        raise TypeError(f'cannot serialize {type(obj).__name__} to msgpack')


def pack_parts(obj: Any) -> List[Buffer]:
    """`packb(obj)` as a list of bytes-like parts, in order."""
    out: List[Buffer] = []
    _pack(obj, out)
    return out


def packb(obj: Any) -> bytes:
    """The msgpack bytes of `obj` (see the module docstring)."""
    return b''.join(pack_parts(obj))


# type byte -> the struct format of its length (bin, ext, str, array, map)
_SIZES = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I', 0xc7: '>B', 0xc8: '>H',
          0xc9: '>I', 0xd9: '>B', 0xda: '>H', 0xdb: '>I', 0xdc: '>H',
          0xdd: '>I', 0xde: '>H', 0xdf: '>I'}
_CONSTANTS = {0xc0: None, 0xc2: False, 0xc3: True}
# type byte -> the struct format of its number (floats, ints)
_NUMBERS = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
            0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}


class _Reader:
    def __init__(self, data: Buffer, ext_hook: Optional[Callable]):
        self.buf = memoryview(data).cast('B')
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > self.buf.nbytes:
            raise ValueError('msgpack data ends early')
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int):
        code = self.unpack('>b')
        data = bytes(self.take(n))
        return (self.ext_hook(code, data) if self.ext_hook is not None
                else ExtType(code, data))

    def value(self):
        t = self.unpack('>B')
        if t < 0x80:
            return t
        if t >= 0xe0:
            return t - 0x100
        if t < 0x90:
            return self.map(t & 0x0f)
        if t < 0xa0:
            return self.array(t & 0x0f)
        if t < 0xc0:
            return str(self.take(t & 0x1f), 'utf-8')
        if t in _SIZES:
            n = self.unpack(_SIZES[t])
            if t <= 0xc6:
                return bytes(self.take(n))
            if t <= 0xc9:
                return self.ext(n)
            if t <= 0xdb:
                return str(self.take(n), 'utf-8')
            return self.array(n) if t <= 0xdd else self.map(n)
        if t in (0xd4, 0xd5, 0xd6, 0xd7, 0xd8):
            return self.ext(1 << (t - 0xd4))
        if t in _CONSTANTS:
            return _CONSTANTS[t]
        if t in _NUMBERS:
            return self.unpack(_NUMBERS[t])
        raise ValueError(f'msgpack type byte {t:#04x} is not supported')

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: Buffer, ext_hook: Optional[Callable] = None) -> Any:
    """Decode one msgpack object that fills `data`."""
    reader = _Reader(data, ext_hook)
    out = reader.value()
    if reader.pos != reader.buf.nbytes:
        raise ValueError(f'{reader.buf.nbytes - reader.pos} bytes of extra '
                         f'data after the msgpack object')
    return out
