"""PNG reading and writing with the standard library's zlib.

`decodePng` / `readPng` take every PNG form the standard allows: gray at 1,
2, 4, 8 and 16 bits, gray with alpha, RGB and RGBA at 8 and 16 bits,
palette at 1, 2, 4 and 8 bits, Adam7-interlaced or not, with any of the
five row filters. They return an RGB uint8 [H, W, 3] array equal to
`PIL.Image.open(f).convert("RGB")`, whose conversions are (held to Pillow by
`tests/test_torch_images.py`):
  * gray below 8 bits is scaled to 0..255 (x 255, 85 or 17) and replicated;
  * 16-bit gray opens as PIL's `I;16` and is clipped at 255, not shifted;
  * 16-bit RGB, RGBA and gray with alpha keep their high bytes;
  * alpha, and the `tRNS` transparency of palette, gray and RGB images, are
    dropped;
  * a palette index past the PLTE entries is black.
A file that breaks the standard (bad IHDR combination, missing PLTE,
truncated data, a bad CRC) raises `ValueError`. `writePng` writes RGB with
filter 0 on every row.
"""
import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}           # color type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's passes: (x start, y start, x step, y step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


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
    """Undo one row's filter in place (PNG spec section 9); None, Sub and Up
    in numpy, Average and Paeth byte by byte."""
    n = len(row)
    if kind == 0:
        return
    if kind == 1:
        lanes = np.frombuffer(row, np.uint8).reshape(-1, bpp)
        row[:] = np.cumsum(lanes, axis=0, dtype=np.uint8).tobytes()
    elif kind == 2:
        row[:] = (np.frombuffer(row, np.uint8) + np.frombuffer(prior, np.uint8)).tobytes()
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


def _samples(rows: np.ndarray, depth: int, count: int) -> np.ndarray:
    """Unfiltered rows [h, rowBytes] -> samples [h, count] as integers."""
    if depth == 8:
        return rows[:, :count]
    if depth == 16:
        return rows[:, :2 * count].astype(np.uint16).reshape(len(rows), count, 2) \
            .dot(np.array([256, 1], np.uint16))
    bits = np.unpackbits(rows, axis=1)[:, :count * depth].reshape(len(rows), count, depth)
    return bits.dot(1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)


def _readPass(raw: memoryview, pos: int, height: int, width: int, depth: int, channels: int):
    """One pass (the whole image, or one of Adam7's): its rows unfiltered
    and unpacked -> (samples [height, width, channels], the next offset)."""
    rowBytes = (width * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    if len(raw) < pos + height * (rowBytes + 1):
        raise ValueError("PNG image data truncated")
    out = np.empty((height, rowBytes), np.uint8)
    prior = bytes(rowBytes)
    for y in range(height):
        start = pos + y * (rowBytes + 1)
        row = bytearray(raw[start + 1:start + 1 + rowBytes])
        _unfilterRow(raw[start], row, prior, bpp)
        out[y] = np.frombuffer(row, np.uint8)
        prior = bytes(row)
    samples = _samples(out, depth, width * channels).reshape(height, width, channels)
    return samples, pos + height * (rowBytes + 1)


def _toRgb(samples: np.ndarray, colorType: int, depth: int, palette) -> np.ndarray:
    """Samples [H, W, channels] -> RGB uint8, as Pillow's convert("RGB")."""
    if colorType == 3:
        table = np.zeros((256, 3), np.uint8)           # entries past the PLTE are black
        table[:len(palette)] = palette
        return table[samples[..., 0]]
    if depth == 16:
        color = np.minimum(samples, 255) if colorType == 0 else samples >> 8
    elif depth < 8:
        color = samples * (255 // ((1 << depth) - 1))
    else:
        color = samples
    color = color.astype(np.uint8)
    if colorType in (0, 4):
        return np.repeat(color[..., :1], 3, axis=2)
    return np.ascontiguousarray(color[..., :3])


def decodePng(data: bytes) -> np.ndarray:
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("bad IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or not 0 < len(body) <= 768:
                raise ValueError("bad PLTE chunk")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG lacks IHDR")
    width, height, depth, colorType, compression, filtering, interlace = header
    if (colorType not in _CHANNELS or depth not in _DEPTHS[colorType] or compression != 0
            or filtering != 0 or interlace not in (0, 1) or width == 0 or height == 0):
        raise ValueError(f"bad PNG header: bit depth {depth}, color type {colorType}, "
                         f"compression {compression}, filter {filtering}, interlace {interlace}")
    if colorType == 3 and palette is None:
        raise ValueError("palette PNG lacks PLTE")
    channels = _CHANNELS[colorType]
    raw = memoryview(zlib.decompress(b"".join(idat)))
    if not interlace:
        samples, _ = _readPass(raw, 0, height, width, depth, channels)
    else:
        samples = np.empty((height, width, channels), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for xs, ys, xd, yd in _ADAM7:
            pw, ph = (width - xs + xd - 1) // xd, (height - ys + yd - 1) // yd
            if pw <= 0 or ph <= 0:
                continue
            samples[ys::yd, xs::xd], pos = _readPass(raw, pos, ph, pw, depth, channels)
    return _toRgb(samples, colorType, depth, palette)


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
