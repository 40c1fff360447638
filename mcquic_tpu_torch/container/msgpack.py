"""The msgpack subset that `.mcq` files use, in pure Python.

`packb(obj)` gives the bytes of `msgpack.packb(obj, use_bin_type=True)` for
dicts, lists, str, bytes and ints: every value in its smallest encoding
(fixmap/map16/map32, fixarray/array16/array32, fixstr/str8/str16/str32,
bin8/bin16/bin32, positive and negative fixint, uint8..uint64,
int8..int64). `unpackb` reads the same subset back, str as str and bin as
bytes. Anything else raises.
"""
import struct

_UINT = ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"), (0xFFFFFFFF, 0xCE, ">I"),
         (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"))
_INT = ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"), (-0x80000000, 0xD2, ">i"),
        (-0x8000000000000000, 0xD3, ">q"))


def _sized(out: bytearray, n: int, fix, codes):
    """Header of a str/bin/array/map of length n: fix = (base, limit) or None,
    codes = (code8, code16, code32) with None where the format lacks one."""
    if fix is not None and n <= fix[1]:
        out.append(fix[0] | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes((codes[0], n))
    elif n <= 0xFFFF:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError("object too large for msgpack")


def _pack(obj, out: bytearray):
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"msgpack subset: cannot pack {obj!r}")
    if isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj & 0xFF)
        elif obj > 0:
            for limit, code, fmt in _UINT:
                if obj <= limit:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise OverflowError(f"int {obj} does not fit uint64")
        else:
            for limit, code, fmt in _INT:
                if obj >= limit:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise OverflowError(f"int {obj} does not fit int64")
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), (0xA0, 31), (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _sized(out, len(data), None, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), (0x90, 15), (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _sized(out, len(obj), (0x80, 15), (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"msgpack subset: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(bytes(data))
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data truncated")
        chunk = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return chunk

    def unpack(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if b in lengths:
            n = self.unpack(lengths[b])
            if b in (0xD9, 0xDA, 0xDB):
                return self.take(n).decode("utf-8")
            if b in (0xC4, 0xC5, 0xC6):
                return self.take(n)
            if b in (0xDC, 0xDD):
                return self.array(n)
            return self.map(n)
        raise ValueError(f"msgpack subset: unsupported type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes):
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: extra data after the object")
    return obj
