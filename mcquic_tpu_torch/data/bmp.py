"""BMP reading (the forms PIL reads, `PIL/BmpImagePlugin.py`).

`decodeBmp(bytes)` returns RGB uint8 [H, W, 3] equal to
`PIL.Image.open(f).convert("RGB")` for a BITMAPINFOHEADER (40 bytes), one
of its extensions (V2 52, V3 56, OS/2 2.x 64, V4 108, V5 124) or the OS/2
1.x core header (12 bytes: 16-bit sizes, always bottom-up, a palette of
3-byte BGR entries):
  * 1, 4 and 8 bits per pixel through the palette (an index past the
    palette's `colors` entries is black). As in PIL, a palette that is the
    gray ramp (black and white at 2 colors) is dropped and the pixel data
    read as 1-bit (2 colors) or 8-bit gray, whatever the file's depth;
  * 16 bits as 5-5-5 (BI_RGB) or, with BI_BITFIELDS, 5-6-5 or 5-5-5; each
    field scaled by 255 / (2^bits - 1), floored;
  * 24 bits as BGR, and 32 bits as BGR with the fourth byte dropped (BI_RGB,
    which is how PIL writes RGBA) or, with BI_BITFIELDS, the byte layouts
    PIL knows (BGRX, XBGR, BGXR, ABGR, RGBA, BGRA, BGAR), alpha dropped;
  * rows bottom-up, or top-down where the height is negative, each padded
    to 4 bytes;
  * RLE8 and RLE4 as PIL's `BmpRleDecoder` reads them: encoded runs
    (clipped at the row's end; RLE4 alternating the byte's two nibbles),
    absolute runs padded to an even file offset (RLE4 reading count // 2
    bytes), end of line filling the row with index 0, end of bitmap, and a
    delta that skips two bytes and then fills `right + up * width` pixels
    with index 0, as PIL does. Data that ends before the last pixel, or an
    end of bitmap before it, leaves PIL short of pixels, and it fails; so
    does RLE over a 2-colour gray palette (PIL's mode 1 takes no "P" raw
    data) or at more than 8 bits.
Bitfield layouts PIL does not read, other compressions and depths,
truncated or malformed files raise `ValueError`, as PIL fails on them too.
"""
import struct

import numpy as np

MAGIC = b"BM"
MAX_PIXELS = 2 * 89478485          # PIL's decompression-bomb limit, as the JPEG decoder's
_HEADERS = (40, 52, 56, 64, 108, 124)
_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3
# 32-bit bitfield masks (r, g, b, a) PIL reads -> byte offsets of R, G, B in a pixel
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0),                  # BGRX
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1),            # XBGR
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0),                # BGXR
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1),           # ABGR
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2),           # RGBA
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0),           # BGRA
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0),           # BGAR
    (0x0, 0x0, 0x0, 0x0): (2, 1, 0),                           # BGRA
}
_MASKS16 = {(0xF800, 0x7E0, 0x1F): (11, 5, 0, 5, 6, 5),        # shifts and widths of R, G, B
            (0x7C00, 0x3E0, 0x1F): (10, 5, 0, 5, 5, 5)}


def _u32(data: bytes, pos: int) -> int:
    if pos + 4 > len(data):
        raise ValueError("BMP header truncated")
    return struct.unpack_from("<I", data, pos)[0]


def _u16(data: bytes, pos: int) -> int:
    if pos + 2 > len(data):
        raise ValueError("BMP header truncated")
    return struct.unpack_from("<H", data, pos)[0]


def _rows(data: bytes, offset: int, height: int, stride: int, need: int, topDown: bool):
    """The pixel rows [height, need bytes], top row first."""
    if need > stride:
        raise ValueError("BMP rows are shorter than their pixels")
    if offset + height * stride > len(data):
        raise ValueError("BMP pixel data truncated")
    rows = np.frombuffer(data, np.uint8, height * stride, offset).reshape(height, stride)[:, :need]
    return rows if topDown else rows[::-1]


def _bits(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """Packed rows -> [height, width] values of `depth` (1, 4 or 8) bits, MSB first."""
    if depth == 8:
        return rows[:, :width]
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(len(rows), width, depth)
    return bits.dot(1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)


def _rle(data: bytes, offset: int, width: int, height: int, rle4: bool, topDown: bool) -> np.ndarray:
    """PIL's `BmpRleDecoder.decode` over the file from `offset`: indices
    [height, width], top row first."""
    out, x, pos, need = bytearray(), 0, offset, width * height
    while len(out) < need:
        if pos + 2 > len(data):
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:                                   # encoded mode
            count = max(0, width - x) if x + count > width else count
            if rle4:
                out += bytes((byte >> 4, byte & 15)) * (count // 2) + bytes((byte >> 4,)) * (count % 2)
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:                             # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:                             # end of bitmap
            break
        elif byte == 2:                             # delta: PIL reads two bytes, then right and up
            if pos + 2 > len(data):
                break
            if pos + 4 > len(data):
                raise ValueError("BMP RLE delta truncated")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * width)
            x = len(out) % width
        else:                                       # absolute mode
            want = byte // 2 if rle4 else byte
            chunk = data[pos:pos + want]
            pos += len(chunk)
            if rle4:
                out += np.stack([np.frombuffer(chunk, np.uint8) >> 4,
                                 np.frombuffer(chunk, np.uint8) & 15], 1).tobytes()
            else:
                out += chunk
            if len(chunk) < want:
                break
            x += byte
            pos += pos % 2                          # a 16-bit boundary of the file
    if len(out) < need:
        raise ValueError("BMP RLE data ends before the last pixel")
    rows = np.frombuffer(bytes(out[:need]), np.uint8).reshape(height, width)
    return rows if topDown else rows[::-1]


def decodeBmp(data: bytes) -> np.ndarray:
    data = bytes(data)
    if not data.startswith(MAGIC) or len(data) < 18:
        raise ValueError("not a BMP file")
    offset, headerSize = _u32(data, 10), _u32(data, 14)
    if headerSize == 12:                            # OS/2 1.x BITMAPCOREHEADER
        if len(data) < 26:
            raise ValueError("BMP header truncated")
        width, height, depth = _u16(data, 18), _u16(data, 20), _u16(data, 24)
        compression, colors, padding, topDown = _BI_RGB, 0, 3, False
    elif headerSize in _HEADERS:
        header = data[18:14 + headerSize]
        if len(header) != headerSize - 4:
            raise ValueError("BMP header truncated")
        topDown = header[7] == 0xFF
        width = _u32(header, 0)
        height = 2 ** 32 - _u32(header, 4) if topDown else _u32(header, 4)
        depth, compression, colors = _u16(header, 10), _u32(header, 12), _u32(header, 28)
        padding = 4
    else:
        raise ValueError(f"unknown BMP header size {headerSize}")
    if width == 0 or height == 0 or width * height > MAX_PIXELS:
        raise ValueError(f"BMP of {width}x{height} pixels")
    colors = colors or (1 << depth)
    if offset == 14 + headerSize and depth <= 8:
        offset += 4 * colors
    stride = ((width * depth + 31) >> 3) & ~3
    rle = compression in (_BI_RLE8, _BI_RLE4)

    if compression == _BI_BITFIELDS:
        if len(header) >= 48:
            masks = [_u32(header, 36 + 4 * i) for i in range(4 if len(header) >= 52 else 3)]
        else:
            masks = [_u32(data, 14 + headerSize + 4 * i) for i in range(3)]
        masks = tuple(masks + [0] * (4 - len(masks)))
        if depth == 32 and masks in _MASKS32:
            order = _MASKS32[masks]
        elif depth == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
            order = (2, 1, 0)
        elif depth == 16 and masks[:3] in _MASKS16:
            order = _MASKS16[masks[:3]]
        else:
            raise ValueError(f"BMP bitfields layout {[hex(m) for m in masks]} at {depth} bits")
    elif compression == _BI_RGB or rle:
        order = {16: (10, 5, 0, 5, 5, 5), 24: (2, 1, 0), 32: (2, 1, 0)}.get(depth)
    else:
        raise ValueError(f"BMP compression {compression}")

    if depth in (1, 4, 8):
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP palette of {colors} colors")
        start = 14 + headerSize
        palette = data[start:start + padding * colors]
        if len(palette) != padding * colors:
            raise ValueError("BMP palette truncated")
        ramp = (0, 255) if colors == 2 else range(colors)
        gray = all(palette[padding * i:padding * i + 3] == bytes([v & 255]) * 3
                   for i, v in enumerate(ramp))
        if rle:
            if gray and colors == 2:
                raise ValueError("RLE BMP of a 2-colour gray palette, which PIL cannot read")
            values = _rle(data, offset, width, height, compression == _BI_RLE4, topDown)
            if gray:
                return np.repeat(values[..., None], 3, axis=2)
        elif gray:
            # PIL drops a gray palette and reads the pixels as mode 1 or L
            bits = 1 if colors == 2 else 8
            rows = _rows(data, offset, height, stride, (width * bits + 7) // 8, topDown)
            values = _bits(rows, bits, width) * (255 if bits == 1 else 1)
            return np.repeat(values[..., None].astype(np.uint8), 3, axis=2)
        else:
            rows = _rows(data, offset, height, stride, (width * depth + 7) // 8, topDown)
            values = _bits(rows, depth, width)
        table = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette, np.uint8).reshape(-1, padding)[:256, 2::-1]
        table[:len(entries)] = entries
        return table[values]
    if rle:
        raise ValueError(f"RLE BMP of {depth} bits per pixel, which PIL cannot read")
    if order is None:
        raise ValueError(f"BMP of {depth} bits per pixel")
    rows = _rows(data, offset, height, stride, width * depth // 8, topDown)
    if depth == 16:
        pixels = rows.reshape(height, width, 2).astype(np.uint32).dot(np.array([1, 256], np.uint32))
        channels = [((pixels >> shift) & ((1 << bits) - 1)) * 255 // ((1 << bits) - 1)
                    for shift, bits in zip(order[:3], order[3:])]
        return np.stack(channels, -1).astype(np.uint8)
    pixels = rows.reshape(height, width, depth // 8)
    return np.ascontiguousarray(pixels[..., list(order)])
