"""PNG reading and writing with the standard library's zlib.

`readPng` takes 8-bit gray, RGB and RGBA images, non-interlaced, with any of
the five row filters, and returns an RGB uint8 [H, W, 3] array (gray is
replicated and alpha dropped, as `PIL.Image.convert("RGB")` does). Other
valid PNGs raise `UnsupportedPng`, corrupt ones `ValueError`. `writePng`
writes RGB with filter 0 on every row.
"""
import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


class UnsupportedPng(ValueError):
    """A valid PNG of a kind this reader does not take (16-bit, palette,
    gray with alpha, interlaced)."""
_CHANNELS = {0: 1, 2: 3, 6: 4}           # color type -> samples per pixel


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("PNG chunk truncated")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length


def _unfilterRow(kind: int, row: bytearray, prior: bytes, bpp: int):
    """Undo one row's filter in place (PNG spec section 9)."""
    n = len(row)
    if kind == 0:
        return
    if kind == 1:
        for i in range(bpp, n):
            row[i] = (row[i] + row[i - bpp]) & 0xFF
    elif kind == 2:
        row[:] = ((np.frombuffer(row, np.uint8).astype(np.uint16)
                   + np.frombuffer(prior, np.uint8)) & 0xFF).astype(np.uint8).tobytes()
    elif kind == 3:
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF
    elif kind == 4:
        for i in range(n):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            if pa <= pb and pa <= pc:
                pred = a
            elif pb <= pc:
                pred = b
            else:
                pred = c
            row[i] = (row[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG row filter {kind} is not one of 0..4")


def decodePng(data: bytes) -> np.ndarray:
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG lacks IHDR")
    width, height, depth, colorType, _, _, interlace = header
    if depth != 8 or colorType not in _CHANNELS or interlace != 0:
        raise UnsupportedPng(f"unsupported PNG: bit depth {depth}, color type {colorType}, "
                         f"interlace {interlace} (only 8-bit gray/RGB/RGBA, non-interlaced)")
    channels = _CHANNELS[colorType]
    stride = width * channels
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data truncated")
    pixels = bytearray(height * stride)
    prior = bytes(stride)
    for y in range(height):
        start = y * (stride + 1)
        row = bytearray(raw[start + 1:start + 1 + stride])
        _unfilterRow(raw[start], row, prior, channels)
        pixels[y * stride:(y + 1) * stride] = row
        prior = bytes(row)
    img = np.frombuffer(pixels, np.uint8).reshape(height, width, channels)
    if channels == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def readPng(path) -> np.ndarray:
    """PNG file -> RGB uint8 [H, W, 3]."""
    return decodePng(Path(path).read_bytes())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encodePng(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"writePng takes RGB uint8 [H, W, 3], got {img.dtype} {img.shape}")
    height, width, _ = img.shape
    rows = np.zeros((height, width * 3 + 1), np.uint8)     # filter byte 0 per row
    rows[:, 1:] = img.reshape(height, width * 3)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def writePng(path, img: np.ndarray):
    Path(path).write_bytes(encodePng(img))
