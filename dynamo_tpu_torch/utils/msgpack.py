"""The port's own MessagePack codec, for the remote block store's frames and
the stream-checkpoint records.

``packb(obj)`` gives the bytes ``msgpack.packb(obj, use_bin_type=True)``
gives, and ``unpackb(data)`` reads them back as ``msgpack.unpackb(data,
raw=False)`` does, for the types those frames carry: dict (str or bytes
keys), list and tuple (read back as list), str, bytes and bytearray (read
back as bytes), bool, None, int from -2**63 to 2**64 - 1, and float (as a
float64). Every integer and float takes the smallest encoding the format
allows, as msgpack's packer picks it. Anything else raises ``TypeError``.
"""

from __future__ import annotations

import struct
from typing import Any

_NEST_LIMIT = 512


def _len_header(out: bytearray, n: int, fix_base: int | None, fix_max: int,
                codes: tuple[int, int, int | None]) -> None:
    """Append a length header: the fix form below ``fix_max``, else the
    8/16/32-bit form (``codes``; an 8-bit form of None skips to 16 bits)."""
    c8, c16, c32 = codes[0], codes[1], codes[2]
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
    elif c8 is not None and n <= 0xFF:
        out += struct.pack(">BB", c8, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", c16, n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", c32, n)
    else:
        raise ValueError(f"length {n} is too large for msgpack")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0x80 <= v <= 0xFF:
        out += struct.pack("BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0xFF < v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < -0x80:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < -0x8000:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError("Integer value out of range")


def _pack(out: bytearray, obj: Any, depth: int) -> None:
    if depth < 0:
        raise ValueError("recursion limit exceeded")
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, (bytes, bytearray)):
        _len_header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _len_header(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, (list, tuple)):
        _len_header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item, depth - 1)
    elif isinstance(obj, dict):
        _len_header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k, depth - 1)
            _pack(out, v, depth - 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes (str as str, bytes as bin)."""
    out = bytearray()
    _pack(out, obj, _NEST_LIMIT)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack data is truncated")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, depth: int) -> Any:
        if depth < 0:
            raise ValueError("recursion limit exceeded")
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, depth)
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, depth)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        fixed = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                 0xCA: ">f", 0xCB: ">d"}
        if b in fixed:
            return self.unpack(fixed[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if b not in sizes:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
        n = self.unpack(sizes[b])
        if b <= 0xC6:
            return bytes(self.take(n))
        if b <= 0xDB:
            return self.str(n)
        if b <= 0xDD:
            return self.array(n, depth)
        return self.map(n, depth)

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int, depth: int) -> list:
        return [self.obj(depth - 1) for _ in range(n)]

    def map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(depth - 1)
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"{type(k).__name__} is not allowed for map key")
            out[k] = self.obj(depth - 1)
        return out


def unpackb(data: bytes) -> Any:
    """The one object ``data`` holds (str as str, bin as bytes, arrays as
    lists); trailing bytes raise ``ValueError``."""
    r = _Reader(data)
    obj = r.obj(_NEST_LIMIT)
    if r.pos != len(r.data):
        raise ValueError("msgpack data has extra bytes after the object")
    return obj
