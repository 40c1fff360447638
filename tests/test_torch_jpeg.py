"""The port's JPEG codec (`mcquic_tpu_torch/data/jpeg.py`, `csrc/jpeg.cpp`)
against PIL on libjpeg-turbo, exactly:

  * the decoder equals `np.asarray(Image.open(f).convert("RGB"))` on crops
    of the photo written by PIL at q95 and q75 with subsampling 0, 1 and 2,
    grayscale, sizes 1x1, 17x9 and 257x131, restart markers, optimized
    Huffman tables, Adobe RGB and CMYK; and, on files of this test's own
    writers, on what PIL does not write: 4:4:0, 4:1:1 and every other
    sampling factor up to 4 libjpeg reads, non-interleaved scans, 16-bit
    quantization tables, SOF1, several tables in one DHT segment, component
    ids 'R', 'G', 'B', CMYK and YCCK (`writeBaseline`), arithmetic coding,
    sequential and progressive, with restarts and DAC conditioning (`_Qm`,
    a QM encoder after jcarith.c), and lossless files with each predictor
    (`writeLossless`);
  * progressive files (SOF2) as PIL writes them: 4:2:0, 4:2:2, 4:4:4, gray,
    sizes 1x1 to 257x131, restart intervals, optimized tables, q100 and q10,
    and the same cut after each scan, which libjpeg decodes with block
    smoothing;
  * the files libjpeg or PIL refuses (12-bit, 2 components, hierarchical, a
    DNL height, more than ten blocks per MCU, fractional sampling, lossless
    YCbCr) raise ValueError, and `_decodeImage` returns None for them as for
    a truncated or corrupt file, baseline, progressive or arithmetic;
  * the encoder's bytes equal `Image.save(f, "JPEG", quality=95)` (and 75);
  * the card's fixture (`tests/golden/torch_jpeg/`): PIL's decode of every
    committed file hashes to its manifest entry, and so does the port's.
"""
import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mcquic_tpu_torch.data.dataset import _decodeImage
from mcquic_tpu_torch.data.jpeg import UnsupportedJpeg, encodeJpeg, readJpeg
from mcquic_tpu_torch.data.png import readPng

ROOT = Path(__file__).resolve().parent.parent
PHOTO = readPng(ROOT / "assets" / "photo_768x512.png")
FIXTURE = ROOT / "tests" / "golden" / "torch_jpeg"


def pilSave(img, **kwargs) -> bytes:
    buffer = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(buffer, format="JPEG",
                                                                          **kwargs)
    return buffer.getvalue()


def pilDecode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def crop(h: int, w: int, top: int = 97, left: int = 211) -> np.ndarray:
    return np.ascontiguousarray(PHOTO[top:top + h, left:left + w])


# ----------------------------------------------------- a small baseline writer
ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
                   41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
                   15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
                   62, 63])
_U = np.arange(8)
DCT = np.sqrt(np.where(_U == 0, 1 / 8, 2 / 8))[:, None] * np.cos((2 * _U[None] + 1) * _U[:, None]
                                                                  * np.pi / 16)


def _standardHuffman():
    """(class, id) -> (16 counts, symbols), read from a file PIL wrote."""
    data, pos, tables = pilSave(crop(8, 8)), 2, {}
    while data[pos + 1] != 0xDA:
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] == 0xC4:
            body, i = data[pos + 4:pos + 2 + length], 0
            while i < len(body):
                counts = list(body[i + 1:i + 17])
                tables[(body[i] >> 4, body[i] & 15)] = (counts, list(body[i + 17:i + 17 + sum(counts)]))
                i += 17 + sum(counts)
        pos += 2 + length
    return tables


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code: int, size: int):
        self.acc, self.n = (self.acc << size) | (code & ((1 << size) - 1)), self.n + size
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out += bytes([byte, 0]) if byte == 0xFF else bytes([byte])

    def flush(self):
        if self.n:
            self.put(0x7F, 8 - self.n)


def _codes(table):
    counts, symbols = table
    codes, code, k = {}, 0, 0
    for length, count in enumerate(counts, 1):
        for _ in range(count):
            codes[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _planes(img: np.ndarray, adobe, ids):
    """The planes a writer codes: gray; RGB untransformed (Adobe 0, ids R G
    B); YCbCr; CMYK untransformed (no Adobe marker or transform 0); YCCK,
    jccolor.c's cmyk_ycck_convert: YCbCr of 255 - C, 255 - M, 255 - Y, and K."""
    x = img.astype(np.float64)
    ycc = lambda r, g, b: [0.299 * r + 0.587 * g + 0.114 * b,
                           -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                           0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    if img.ndim == 2:
        return [x]
    if img.shape[2] == 4:
        if not adobe:
            return [x[..., c] for c in range(4)]
        return ycc(255 - x[..., 0], 255 - x[..., 1], 255 - x[..., 2]) + [x[..., 3]]
    if adobe == 0 or ids == [82, 71, 66]:
        return [x[..., 0], x[..., 1], x[..., 2]]
    return ycc(x[..., 0], x[..., 1], x[..., 2])


def _coded(planes, sampling, quant, H, W):
    """Per component: zigzag coefficients [block rows, block cols, 64] over
    the interleaved MCU cover, and the real blocks' width and height."""
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mcusX, mcusY = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    coded = []
    for c, (h, v) in enumerate(sampling):
        sx, sy = hmax // h, vmax // v
        plane = np.pad(planes[c], ((0, (-H) % sy), (0, (-W) % sx)), mode="edge")
        plane = plane.reshape(plane.shape[0] // sy, sy, plane.shape[1] // sx, sx).mean((1, 3))
        rows, cols = mcusY * v * 8, mcusX * h * 8
        plane = np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")
        blocks = plane.reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3) - 128
        coefs = np.einsum("ux,abxy,vy->abuv", DCT, blocks, DCT)
        q = quant[min(c, 1)]
        zz = np.round(coefs / q).reshape(*coefs.shape[:2], 64)[..., ZIGZAG].astype(int)
        zz[..., 1:] = np.clip(zz[..., 1:], -1023, 1023)
        realW, realH = -(-(-(-W * h // hmax)) // 8), -(-(-(-H * v // vmax)) // 8)
        coded.append((zz, realW, realH))
    return coded, mcusX, mcusY


def _units(coded, sampling, components, mcusX, mcusY):
    """The (component, block row, block col) of each MCU of a scan."""
    if len(components) == 1:
        c = components[0]
        _, realW, realH = coded[c]
        return [[(c, by, bx)] for by in range(realH) for bx in range(realW)]
    return [[(c, my * sampling[c][1] + y, mx * sampling[c][0] + x) for c in components
             for y in range(sampling[c][1]) for x in range(sampling[c][0])]
            for my in range(mcusY) for mx in range(mcusX)]


def writeBaseline(img: np.ndarray, sampling, *, restart: int = 0, nonInterleaved: bool = False,
                  dqt16: bool = False, sof1: bool = False, adobe=None, ids=None,
                  jfif: bool = True, arithmetic: bool = False, script=None, dac=None) -> bytes:
    """A JPEG of `img` (uint8 [H, W, 3], [H, W] gray or [H, W, 4] CMYK)
    with the given (h, v) sampling per component, a float DCT, and the
    options PIL has no way to ask for. Huffman files are sequential with the
    standard tables in one DHT segment; `arithmetic` writes SOF9, or SOF10
    with a progressive `script` of (components, Ss, Se, Ah, Al) scans, coded
    by `_Qm`, with `dac` = (L, U, K) conditioning for every table.
    `adobe=0` writes RGB or CMYK planes untransformed, `adobe=2` YCCK."""
    gray = img.ndim == 2
    H, W = img.shape[:2]
    planes = _planes(img, adobe, ids)
    ids = ids or list(range(1, len(planes) + 1))
    quant = [np.clip(1 + 2 * (_U[:, None] + _U[None]) + 9 * t, 1, 255).astype(int)
             for t in range(2)]
    if dqt16:
        quant[1] = quant[1] + 280                       # needs 16-bit entries
    coded, mcusX, mcusY = _coded(planes, sampling, quant, H, W)
    huff = _standardHuffman()
    header = bytearray(b"\xff\xd8")
    if jfif:
        header += _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        header += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    for t in range(1 if gray else 2):
        precision = int(quant[t].max() > 255)
        values = quant[t].reshape(64)[ZIGZAG]
        header += _segment(0xDB, bytes([(precision << 4) | t]) + (
            b"".join(struct.pack(">H", int(v)) for v in values) if precision
            else bytes(int(v) for v in values)))
    sof = (0xCA if script else 0xC9) if arithmetic else (0xC1 if sof1 else 0xC0)
    header += _segment(sof, struct.pack(">BHHB", 8, H, W, len(sampling)) + b"".join(
        bytes([ids[c], (h << 4) | v, min(c, 1)]) for c, (h, v) in enumerate(sampling)))
    if arithmetic:
        if dac:
            L, U, K = dac
            header += _segment(0xCC, b"".join(bytes([t, (U << 4) | L, 16 + t, K])
                                              for t in range(1 if gray else 2)))
    else:
        dht = b""
        for (tc, th), (counts, symbols) in sorted(huff.items()):
            if not gray or th == 0:
                dht += bytes([(tc << 4) | th] + counts + symbols)
        header += _segment(0xC4, dht)
    if restart:
        header += _segment(0xDD, struct.pack(">H", restart))
    tables = [(_codes(huff[(0, min(c, 1))]), _codes(huff[(1, min(c, 1))])) for c in range(len(sampling))]

    def sos(components, ss=0, se=63, ah=0, al=0):
        return _segment(0xDA, bytes([len(components)]) + b"".join(
            bytes([ids[c], (min(c, 1) << 4) | min(c, 1)]) for c in components) + bytes([ss, se, (ah << 4) | al]))

    def scan(components, units):
        out = sos(components)
        bits, pred, count = _Bits(), {c: 0 for c in components}, 0
        for unit in units:
            if restart and count and count % restart == 0:
                bits.flush()
                out += bytes(bits.out) + bytes([0xFF, 0xD0 + (count // restart - 1) % 8])
                bits, pred = _Bits(), {c: 0 for c in components}
            for c, by, bx in unit:
                block = coded[c][0][by, bx]
                dc, ac = tables[c]
                diff = int(block[0]) - pred[c]
                pred[c] = int(block[0])
                n = int(abs(diff)).bit_length()
                bits.put(*dc[n])
                if n:
                    bits.put(diff if diff > 0 else diff - 1, n)
                run = 0
                for k in range(1, 64):
                    value = int(block[k])
                    if value == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(*ac[0xF0])
                        run -= 16
                    n = abs(value).bit_length()
                    bits.put(*ac[(run << 4) | n])
                    bits.put(value if value > 0 else value - 1, n)
                    run = 0
                if run:
                    bits.put(*ac[0x00])
            count += 1
        bits.flush()
        return out + bytes(bits.out)

    body = b""
    everything = list(range(len(sampling)))
    if arithmetic:
        L, U, K = dac or (0, 1, 5)
        for components, ss, se, ah, al in (script or [(everything, 0, 63, 0, 0)]):
            units = _units(coded, sampling, components, mcusX, mcusY)
            body += sos(components, ss, se, ah, al) + _arithScan(
                coded, units, components, ss, se, ah, al, bool(script), restart, L, U, K)
    elif nonInterleaved or len(sampling) == 1:
        for c in everything:
            body += scan([c], _units(coded, sampling, [c], mcusX, mcusY))
    else:
        body += scan(everything, _units(coded, sampling, everything, mcusX, mcusY))
    return bytes(header) + body + b"\xff\xd9"


# T.81 Table D.2: Qe, Next_Index_MPS, Next_Index_LPS, Switch_MPS; the last
# row is jaricom.c's fixed estimate for sign and correction bits
_QE = [(0x5a1d, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0), (0x080b, 4, 18, 0),
       (0x03d8, 5, 20, 0), (0x01da, 6, 23, 0), (0x00e5, 7, 25, 0), (0x006f, 8, 28, 0),
       (0x0036, 9, 30, 0), (0x001a, 10, 33, 0), (0x000d, 11, 35, 0), (0x0006, 12, 9, 0),
       (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5a7f, 15, 15, 1), (0x3f25, 16, 36, 0),
       (0x2cf2, 17, 38, 0), (0x207c, 18, 39, 0), (0x17b9, 19, 40, 0), (0x1182, 20, 42, 0),
       (0x0cef, 21, 43, 0), (0x09a1, 22, 45, 0), (0x072f, 23, 46, 0), (0x055c, 24, 48, 0),
       (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0), (0x01b1, 28, 54, 0),
       (0x0144, 29, 56, 0), (0x00f5, 30, 57, 0), (0x00b7, 31, 59, 0), (0x008a, 32, 60, 0),
       (0x0068, 33, 62, 0), (0x004e, 34, 63, 0), (0x003b, 35, 32, 0), (0x002c, 9, 33, 0),
       (0x5ae1, 37, 37, 1), (0x484c, 38, 64, 0), (0x3a0d, 39, 65, 0), (0x2ef1, 40, 67, 0),
       (0x261f, 41, 68, 0), (0x1f33, 42, 69, 0), (0x19a8, 43, 70, 0), (0x1518, 44, 72, 0),
       (0x1177, 45, 73, 0), (0x0e74, 46, 74, 0), (0x0bfb, 47, 75, 0), (0x09f8, 48, 77, 0),
       (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05cd, 51, 48, 0), (0x04de, 52, 50, 0),
       (0x040f, 53, 50, 0), (0x0363, 54, 51, 0), (0x02d4, 55, 52, 0), (0x025c, 56, 53, 0),
       (0x01f8, 57, 54, 0), (0x01a4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
       (0x00f6, 61, 58, 0), (0x00cb, 62, 59, 0), (0x00ab, 63, 61, 0), (0x008f, 32, 61, 0),
       (0x5b12, 65, 65, 1), (0x4d04, 66, 80, 0), (0x412c, 67, 81, 0), (0x37d8, 68, 82, 0),
       (0x2fe8, 69, 83, 0), (0x293c, 70, 84, 0), (0x2379, 71, 86, 0), (0x1edf, 72, 87, 0),
       (0x1aa9, 73, 87, 0), (0x174e, 74, 72, 0), (0x1424, 75, 72, 0), (0x119c, 76, 74, 0),
       (0x0f6b, 77, 74, 0), (0x0d51, 78, 75, 0), (0x0bb6, 79, 77, 0), (0x0a40, 48, 77, 0),
       (0x5832, 81, 80, 1), (0x4d1c, 82, 88, 0), (0x438e, 83, 89, 0), (0x3bdd, 84, 90, 0),
       (0x34ee, 85, 91, 0), (0x2eae, 86, 92, 0), (0x299a, 87, 93, 0), (0x2516, 71, 86, 0),
       (0x5570, 89, 88, 1), (0x4ca9, 90, 95, 0), (0x44d9, 91, 96, 0), (0x3e22, 92, 97, 0),
       (0x3824, 93, 99, 0), (0x32b4, 94, 99, 0), (0x2e17, 86, 93, 0), (0x56a8, 96, 95, 1),
       (0x4f46, 97, 101, 0), (0x47e5, 98, 102, 0), (0x41cf, 99, 103, 0), (0x3c3d, 100, 104, 0),
       (0x375e, 93, 99, 0), (0x5231, 102, 105, 0), (0x4c0f, 103, 106, 0), (0x4639, 104, 107, 0),
       (0x415e, 99, 103, 0), (0x5627, 106, 105, 1), (0x50e7, 107, 108, 0), (0x4b85, 103, 109, 0),
       (0x5597, 109, 110, 0), (0x504f, 107, 111, 0), (0x5a10, 111, 110, 1), (0x5522, 109, 112, 0),
       (0x59eb, 111, 112, 1), (0x5a1d, 113, 113, 0)]


class _Qm:
    """The QM encoder of T.81 Annex D as jcarith.c writes it: a statistics
    bin is an index into a bytearray holding MPS << 7 | state."""

    def __init__(self):
        self.c, self.a, self.ct, self.sc, self.zc, self.buffer = 0, 0x10000, 11, 0, 0, -1
        self.out = bytearray()

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def encode(self, stats: bytearray, i: int, val: int):
        sv = stats[i]
        qe, nmps, nlps, switch = _QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ (nlps | switch << 7)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self.out += bytes([self.buffer + 1] + ([0] if self.buffer + 1 == 0xFF else []))
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self.out.append(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self.out += bytes([self.buffer + 1] + ([0] if self.buffer + 1 == 0xFF else []))
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if self.c & mask:
                    byte = (self.c >> shift) & 0xFF
                    self.out += bytes([byte] + ([0] if byte == 0xFF else []))
        return bytes(self.out)


def _arithScan(coded, units, components, ss, se, ah, al, progressive, restart, L, U, K) -> bytes:
    """One scan's arithmetic-coded data (jcarith.c's encode_mcu and its four
    progressive kinds), with restart markers every `restart` MCUs."""
    dcScan, acScan = not progressive or (ss == 0 and ah == 0), not progressive or ss != 0
    state = {}

    def reset():
        state.update(qm=_Qm(), last={c: 0 for c in components}, ctx={c: 0 for c in components},
                     dc={min(c, 1): bytearray(64) for c in components},
                     ac={min(c, 1): bytearray(256) for c in components}, fixed=bytearray([113]))

    def magnitude(stats, st, v, high):
        """Figures F.8 and F.9 for v >= 1; `high` is the AC X1 bin or None for DC."""
        qm, m = state["qm"], 0
        v -= 1
        if v:
            qm.encode(stats, st, 1)
            m, v2 = 1, v >> 1
            if high is None:
                st = 20
                while v2:
                    qm.encode(stats, st, 1)
                    m, st, v2 = m << 1, st + 1, v2 >> 1
            elif v2:
                qm.encode(stats, st, 1)
                m, st, v2 = m << 1, high, v2 >> 1
                while v2:
                    qm.encode(stats, st, 1)
                    m, st, v2 = m << 1, st + 1, v2 >> 1
        qm.encode(stats, st, 0)
        st += 14
        m2 = m >> 1
        while m2:
            qm.encode(stats, st, int(bool(m2 & v)))
            m2 >>= 1
        return m

    def dc(c, value):
        qm, stats, ctx = state["qm"], state["dc"][min(c, 1)], state["ctx"]
        st, v = ctx[c], value - state["last"][c]
        if v == 0:
            qm.encode(stats, st, 0)
            ctx[c] = 0
            return
        state["last"][c] = value
        qm.encode(stats, st, 1)
        sign = int(v < 0)
        qm.encode(stats, st + 1, sign)
        ctx[c] = 8 if sign else 4
        m = magnitude(stats, st + 2 + sign, abs(v), None)
        if m < (1 << L) >> 1:
            ctx[c] = 0
        elif m > (1 << U) >> 1:
            ctx[c] += 8

    def ac(c, block, k0, k1, shift):
        qm, stats, fixed = state["qm"], state["ac"][min(c, 1)], state["fixed"]
        values = [int(np.sign(block[k])) * (abs(int(block[k])) >> shift) for k in range(64)]
        ke = k1
        while ke > 0 and values[ke] == 0:
            ke -= 1
        k = k0
        while k <= ke:
            st = 3 * (k - 1)
            qm.encode(stats, st, 0)
            while values[k] == 0:
                qm.encode(stats, st + 1, 0)
                st, k = st + 3, k + 1
            qm.encode(stats, st + 1, 1)
            qm.encode(fixed, 0, int(values[k] < 0))
            magnitude(stats, st + 2, abs(values[k]), 189 if k <= K else 217)
            k += 1
        if k <= k1:
            qm.encode(stats, 3 * (k - 1), 1)

    def acRefine(c, block):
        qm, stats, fixed = state["qm"], state["ac"][min(c, 1)], state["fixed"]
        mags = [abs(int(block[k])) for k in range(64)]
        ke = se
        while ke > 0 and not mags[ke] >> al:
            ke -= 1
        kex = ke
        while kex > 0 and not mags[kex] >> ah:
            kex -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                qm.encode(stats, st, 0)
            while True:
                v = mags[k] >> al
                if v:
                    if v >> 1:
                        qm.encode(stats, st + 2, v & 1)
                    else:
                        qm.encode(stats, st + 1, 1)
                        qm.encode(fixed, 0, int(block[k] < 0))
                    break
                qm.encode(stats, st + 1, 0)
                st, k = st + 3, k + 1
            k += 1
        if k <= se:
            qm.encode(stats, 3 * (k - 1), 1)

    reset()
    out, count = bytearray(), 0
    for unit in units:
        if restart and count and count % restart == 0:
            out += state["qm"].finish() + bytes([0xFF, 0xD0 + (count // restart - 1) % 8])
            reset()
        for c, by, bx in unit:
            block = coded[c][0][by, bx]
            if not progressive:
                dc(c, int(block[0]))
                ac(c, block, 1, 63, 0)
            elif ss == 0 and ah == 0:
                dc(c, int(block[0]) >> al)
            elif ss == 0:
                state["qm"].encode(state["fixed"], 0, (int(block[0]) >> al) & 1)
            elif ah == 0:
                ac(c, block, ss, se, al)
            else:
                acRefine(c, block)
        count += 1
    return bytes(out + state["qm"].finish())


# libjpeg's jpeg_simple_progression for three components
ARITH_SCRIPT = [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1), ([1], 1, 63, 0, 1),
                ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1), ([0, 1, 2], 0, 0, 1, 0), ([2], 1, 63, 1, 0),
                ([1], 1, 63, 1, 0), ([0], 1, 63, 1, 0)]


def writeLossless(img: np.ndarray, *, psv: int = 1, pt: int = 0, restart: int = 0,
                  ids=None, adobe=None, jfif: bool = False, sampling=None) -> bytes:
    """A lossless Huffman JPEG (SOF3) of a gray, RGB or CMYK image, one
    interleaved scan with predictor `psv` and point transform `pt`, the
    standard luminance DC table for the differences, restart markers every
    `restart` MCUs (whole rows); 1x1 sampling, or `sampling` (h, v) per
    component (no restarts), each plane decimated."""
    if sampling:
        return _losslessSampled(img, sampling, psv, ids)
    H, W = img.shape[:2]
    planes = [img.astype(int) >> pt] if img.ndim == 2 else [img[..., c].astype(int) >> pt
                                                            for c in range(img.shape[2])]
    ids = ids or list(range(1, len(planes) + 1))
    huff = _standardHuffman()
    dc = _codes(huff[(0, 0)])
    header = bytearray(b"\xff\xd8")
    if jfif:
        header += _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        header += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    header += _segment(0xC3, struct.pack(">BHHB", 8, H, W, len(planes)) + b"".join(
        bytes([ids[c], 0x11, 0]) for c in range(len(planes))))
    counts, symbols = huff[(0, 0)]
    header += _segment(0xC4, bytes([0] + counts + symbols))
    if restart:
        header += _segment(0xDD, struct.pack(">H", restart))
    header += _segment(0xDA, bytes([len(planes)]) + b"".join(bytes([ids[c], 0]) for c in range(len(planes)))
                       + bytes([psv, 0, pt]))
    out, bits = bytearray(), _Bits()
    first = 0                                           # the row that starts a restart interval
    for y in range(H):
        if restart and y and (y * W) % restart == 0:
            bits.flush()
            out += bytes(bits.out) + bytes([0xFF, 0xD0 + ((y * W) // restart - 1) % 8])
            bits, first = _Bits(), y
        for x in range(W):
            for p in planes:
                if y == first:
                    pred = 1 << (8 - pt - 1) if x == 0 else p[y, x - 1]
                elif x == 0:
                    pred = p[y - 1, x]
                else:
                    ra, rb, rc = int(p[y, x - 1]), int(p[y - 1, x]), int(p[y - 1, x - 1])
                    pred = [0, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                            (ra + rb) >> 1][psv]
                d = (int(p[y, x]) - int(pred)) & 0xFFFF
                d = d - 0x10000 if d >= 0x8000 else d
                n = abs(d).bit_length()
                bits.put(*dc[n])
                if n:
                    bits.put(d if d > 0 else d - 1, n)
    bits.flush()
    return bytes(header) + bytes(out) + bytes(bits.out) + b"\xff\xd9"


def _losslessSampled(img, sampling, psv, ids):
    """writeLossless with sampling factors: interleaved MCUs of h x v samples
    per component over each decimated plane's MCU cover."""
    H, W = img.shape[:2]
    ids = ids or [1, 2, 3]
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mcusX, mcusY = -(-W // hmax), -(-H // vmax)
    planes = []
    for c, (h, v) in enumerate(sampling):
        sx, sy = hmax // h, vmax // v
        p = np.pad(img[..., c].astype(int), ((0, (-H) % sy), (0, (-W) % sx)), mode="edge")
        p = p.reshape(p.shape[0] // sy, sy, p.shape[1] // sx, sx)[:, 0, :, 0]
        planes.append(np.pad(p, ((0, mcusY * v - p.shape[0]), (0, mcusX * h - p.shape[1])), mode="edge"))
    huff = _standardHuffman()
    dc = _codes(huff[(0, 0)])
    counts, symbols = huff[(0, 0)]
    header = bytearray(b"\xff\xd8") + _segment(0xC3, struct.pack(">BHHB", 8, H, W, 3) + b"".join(
        bytes([ids[c], (h << 4) | v, 0]) for c, (h, v) in enumerate(sampling)))
    header += _segment(0xC4, bytes([0] + counts + symbols))
    header += _segment(0xDA, bytes([3]) + b"".join(bytes([i, 0]) for i in ids) + bytes([psv, 0, 0]))
    bits = _Bits()
    for my in range(mcusY):
        for mx in range(mcusX):
            for c, (h, v) in enumerate(sampling):
                p = planes[c]
                for y in range(my * v, my * v + v):
                    for x in range(mx * h, mx * h + h):
                        if y == 0:
                            pred = 128 if x == 0 else p[y, x - 1]
                        elif x == 0:
                            pred = p[y - 1, x]
                        else:
                            ra, rb, rc = int(p[y, x - 1]), int(p[y - 1, x]), int(p[y - 1, x - 1])
                            pred = [0, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                                    rb + ((ra - rc) >> 1), (ra + rb) >> 1][psv]
                        d = int(p[y, x]) - int(pred)
                        n = abs(d).bit_length()
                        bits.put(*dc[n])
                        if n:
                            bits.put(d if d > 0 else d - 1, n)
    bits.flush()
    return bytes(header) + bytes(bits.out) + b"\xff\xd9"


# ----------------------------------------------------------------- decoding
PIL_CASES = [(f"q{q} subsampling {s}", crop(96, 128), dict(quality=q, subsampling=s))
             for q in (95, 75) for s in (0, 1, 2)]
PIL_CASES += [(f"{h}x{w} subsampling {s}", crop(h, w), dict(quality=95, subsampling=s))
              for h, w in ((1, 1), (17, 9), (257, 131)) for s in (0, 1, 2)]
PIL_CASES += [
    ("grayscale", crop(75, 61).mean(2).astype(np.uint8), dict(quality=90)),
    ("restart markers", crop(80, 120), dict(quality=95, restart_marker_blocks=3)),
    ("restart rows", crop(80, 120), dict(quality=95, restart_marker_rows=1, subsampling=0)),
    ("optimized Huffman", crop(80, 120), dict(quality=95, optimize=True)),
    ("Adobe RGB", crop(40, 56), dict(quality=95, keep_rgb=True)),
]
PIL_CASES += [(f"progressive {h}x{w} subsampling {s}", crop(h, w),
               dict(quality=90, subsampling=s, progressive=True))
              for h, w in ((1, 1), (17, 9), (96, 128), (257, 131)) for s in (0, 1, 2)]
PIL_CASES += [
    ("progressive grayscale", crop(75, 61).mean(2).astype(np.uint8),
     dict(quality=90, progressive=True)),
    ("progressive restart markers", crop(80, 120),
     dict(quality=95, progressive=True, restart_marker_blocks=3)),
    ("progressive restart rows 4:4:4", crop(80, 120),
     dict(quality=95, progressive=True, restart_marker_rows=1, subsampling=0)),
    ("progressive optimized q75", crop(80, 120), dict(quality=75, progressive=True, optimize=True)),
    ("progressive q100", crop(64, 64), dict(quality=100, progressive=True)),
    ("progressive q10", crop(64, 64), dict(quality=10, progressive=True)),
]


@pytest.mark.parametrize("name,img,kwargs", PIL_CASES, ids=[c[0] for c in PIL_CASES])
def test_decode_equals_pil(name, img, kwargs):
    data = pilSave(img, **kwargs)
    np.testing.assert_array_equal(readJpeg(data), pilDecode(data))


def cmyk(h: int, w: int, top: int = 97, left: int = 211) -> np.ndarray:
    return np.asarray(Image.fromarray(crop(h, w, top, left)).convert("CMYK"))


WRITER_CASES = [
    ("4:4:0", crop(64, 48), [(1, 2), (1, 1), (1, 1)], {}),
    ("4:4:0 odd size", crop(37, 29), [(1, 2), (1, 1), (1, 1)], {}),
    ("4:4:0 width 1", crop(9, 1), [(1, 2), (1, 1), (1, 1)], {}),
    ("4:2:0 non-interleaved", crop(35, 43), [(2, 2), (1, 1), (1, 1)], dict(nonInterleaved=True)),
    ("4:2:2 restart 1", crop(24, 40), [(2, 1), (1, 1), (1, 1)], dict(restart=1)),
    ("4:2:0 restart 5, SOF1, 16-bit DQT", crop(50, 70), [(2, 2), (1, 1), (1, 1)],
     dict(restart=5, sof1=True, dqt16=True)),
    ("gray 2x2 factors", crop(21, 19).mean(2).astype(np.uint8), [(2, 2)], {}),
    ("Adobe transform 0, no JFIF", crop(20, 28), [(1, 1)] * 3, dict(adobe=0, jfif=False)),
    ("Adobe transform 1", crop(20, 28), [(2, 2), (1, 1), (1, 1)], dict(adobe=1, jfif=False)),
    ("ids R G B, no markers", crop(20, 28), [(1, 1)] * 3, dict(ids=[82, 71, 66], jfif=False)),
    ("chroma at 2x2 with luma 1x1", crop(33, 35), [(1, 1), (2, 2), (2, 2)], {}),
    ("4:1:1", crop(37, 45), [(4, 1), (1, 1), (1, 1)], {}),
    ("4:1:1 width 5, restart 2", crop(19, 5), [(4, 1), (1, 1), (1, 1)], dict(restart=2)),
    ("h1v4", crop(37, 45), [(1, 4), (1, 1), (1, 1)], {}),
    ("h4v2", crop(37, 45), [(4, 2), (1, 1), (1, 1)], {}),
    ("h3v2", crop(37, 45), [(3, 2), (1, 1), (1, 1)], {}),
    ("h3v1", crop(29, 50), [(3, 1), (1, 1), (1, 1)], {}),
    ("h4v1 with chroma h2v1", crop(37, 45), [(4, 1), (2, 1), (2, 1)], {}),
    ("h2v1 h1v2 h1v1", crop(37, 45), [(2, 1), (1, 2), (1, 1)], {}),
    ("3x3 luma, non-interleaved", crop(37, 45), [(3, 3), (1, 1), (1, 1)], dict(nonInterleaved=True)),
    ("CMYK", cmyk(37, 45), [(1, 1)] * 4, dict(adobe=0, jfif=False)),
    ("CMYK, no Adobe marker", cmyk(30, 20), [(1, 1)] * 4, dict(jfif=False)),
    ("CMYK 2x2 K", cmyk(30, 20), [(2, 2), (1, 1), (1, 1), (2, 2)], dict(adobe=0, jfif=False)),
    ("YCCK", cmyk(37, 45), [(2, 2), (1, 1), (1, 1), (2, 2)], dict(adobe=2, jfif=False)),
    ("YCCK non-interleaved, restart 3", cmyk(26, 33), [(1, 1)] * 4,
     dict(adobe=2, jfif=False, nonInterleaved=True, restart=3)),
    ("arithmetic", crop(35, 43), [(2, 2), (1, 1), (1, 1)], dict(arithmetic=True)),
    ("arithmetic gray", crop(35, 43).mean(2).astype(np.uint8), [(1, 1)], dict(arithmetic=True)),
    ("arithmetic DAC", crop(35, 43), [(2, 2), (1, 1), (1, 1)], dict(arithmetic=True, dac=(2, 4, 10))),
    ("arithmetic restart 3", crop(35, 43), [(2, 2), (1, 1), (1, 1)], dict(arithmetic=True, restart=3)),
    ("arithmetic progressive", crop(35, 43), [(2, 2), (1, 1), (1, 1)],
     dict(arithmetic=True, script=ARITH_SCRIPT)),
    ("arithmetic progressive 4:2:2, restart 2, DAC", crop(35, 43), [(2, 1), (1, 1), (1, 1)],
     dict(arithmetic=True, script=ARITH_SCRIPT, restart=2, dac=(1, 3, 2))),
    ("arithmetic progressive cut (smoothed)", crop(40, 48), [(2, 2), (1, 1), (1, 1)],
     dict(arithmetic=True, script=ARITH_SCRIPT[:5])),
    ("arithmetic CMYK", cmyk(24, 30), [(1, 1)] * 4, dict(adobe=0, jfif=False, arithmetic=True)),
]


@pytest.mark.parametrize("name,img,sampling,kwargs", WRITER_CASES, ids=[c[0] for c in WRITER_CASES])
def test_decode_equals_pil_on_what_pil_does_not_write(name, img, sampling, kwargs):
    data = writeBaseline(img, sampling, **kwargs)
    want = pilDecode(data)
    assert want.shape == (*img.shape[:2], 3)
    np.testing.assert_array_equal(readJpeg(data), want)


LOSSLESS_CASES = [(f"predictor {psv}", crop(23, 31), dict(psv=psv, ids=[82, 71, 66]))
                  for psv in range(1, 8)]
LOSSLESS_CASES += [
    ("point transform 2, restart every 2 rows", crop(23, 31), dict(psv=4, pt=2, ids=[82, 71, 66],
                                                                   restart=62)),
    ("gray", crop(19, 13).mean(2).astype(np.uint8), dict(psv=7)),
    ("Adobe RGB", crop(11, 17), dict(psv=6, adobe=0)),
    ("CMYK", cmyk(15, 14), dict(psv=5, adobe=0)),
    ("4:2:0 luma 2x2", crop(17, 23), dict(psv=4, ids=[82, 71, 66], sampling=[(2, 2), (1, 1), (1, 1)])),
    ("4:2:2 luma 2x1", crop(16, 22), dict(psv=7, ids=[82, 71, 66], sampling=[(2, 1), (1, 1), (1, 1)])),
]


@pytest.mark.parametrize("name,img,kwargs", LOSSLESS_CASES, ids=[c[0] for c in LOSSLESS_CASES])
def test_lossless_decode_equals_pil(name, img, kwargs):
    data = writeLossless(img, **kwargs)
    want = pilDecode(data)
    np.testing.assert_array_equal(readJpeg(data), want)
    if img.ndim == 3 and img.shape[2] == 3 and not kwargs.get("pt") and not kwargs.get("sampling"):
        np.testing.assert_array_equal(want, img)


def test_pil_cmyk_files_decode_as_pil_decodes():
    """PIL writes CMYK with an Adobe marker, inverted ("CMYK;I"), 4:4:4:4,
    baseline and progressive; PIL's cmyk2rgb makes the RGB."""
    img = Image.fromarray(crop(41, 53)).convert("CMYK")
    for kwargs in (dict(quality=95), dict(quality=70, progressive=True),
                   dict(quality=90, progressive=True, restart_marker_blocks=3)):
        data = pilSave(img, **kwargs)
        np.testing.assert_array_equal(readJpeg(data), pilDecode(data))


def _withMarker(data: bytes, old: int, new: int) -> bytes:
    pos = data.index(bytes([0xFF, old]))
    return data[:pos + 1] + bytes([new]) + data[pos + 2:]


def _sofPrecision(data: bytes, bits: int) -> bytes:
    pos = data.index(b"\xff\xc0")
    return data[:pos + 4] + bytes([bits]) + data[pos + 5:]


def _sofField(data: bytes, offset: int, value: bytes) -> bytes:
    pos = data.index(b"\xff\xc0")
    return data[:pos + offset] + value + data[pos + offset + len(value):]


def _lastScanCut(data: bytes) -> bytes:
    """A progressive file cut before its last scan, which refines the luma
    AC coefficients from Al 1 to 0 in PIL's script: the file ends at EOI
    with bits unsent, and libjpeg decodes it with block smoothing."""
    sos = data.rindex(b"\xff\xda")
    return data[:sos] + b"\xff\xd9"


def _twoComponents() -> bytes:
    data = writeBaseline(crop(16, 16), [(1, 1)] * 3, jfif=False)
    pos = data.index(b"\xff\xc0")
    body = data[pos + 4:pos + 4 + 6 + 6]                 # precision, size, count 2, two components
    return data[:pos + 2] + struct.pack(">H", 2 + len(body)) + body[:5] + b"\x02" + body[6:] + \
        data[pos + 2 + 2 + 6 + 9:]


# Each was refused before the decoder read its kind; each now decodes to
# what PIL decodes, or to None where PIL fails. The "arithmetic" and
# "lossless" files are Huffman files with a patched SOF marker: corrupt as
# what they claim, so their answer is whatever PIL makes of them.
REFUSED = [
    ("progressive", lambda: _lastScanCut(pilSave(crop(32, 32), quality=90, progressive=True)), True),
    ("arithmetic", lambda: _withMarker(pilSave(crop(32, 32)), 0xC0, 0xC9), True),
    ("lossless", lambda: _withMarker(pilSave(crop(32, 32)), 0xC0, 0xC3), False),
    ("12-bit", lambda: _sofPrecision(pilSave(crop(32, 32)), 12), False),
    ("CMYK", lambda: pilSave(Image.fromarray(crop(32, 32)).convert("CMYK")), True),
    ("2 components", _twoComponents, False),
    ("hierarchical", lambda: _withMarker(pilSave(crop(16, 16)), 0xC0, 0xC5), False),
    ("lossless arithmetic", lambda: _withMarker(writeLossless(crop(9, 11), ids=[82, 71, 66]), 0xC3, 0xCB),
     False),
    ("DNL height 0", lambda: _sofField(pilSave(crop(16, 16)), 5, b"\x00\x00"), False),
    ("11 blocks per MCU", lambda: writeBaseline(crop(37, 45), [(3, 3), (1, 1), (1, 1)]), False),
    ("fractional sampling", lambda: _sofField(writeBaseline(crop(24, 24), [(3, 1), (1, 1), (1, 1)]),
                                              14, b"\x21"), False),
    ("lossless YCbCr", lambda: writeLossless(crop(9, 11), jfif=True), False),
    ("DNL segment after the scan", lambda: pilSave(crop(32, 40))[:-2] + b"\xff\xdc\x00\x04\x00\x20"
     + b"\xff\xd9", True),
]


@pytest.mark.parametrize("kind,make,pilReads", REFUSED, ids=[c[0] for c in REFUSED])
def test_unread_kinds_raise_naming_file_and_marker(kind, make, pilReads):
    """Decodes to PIL's RGB where PIL reads the file; where PIL fails, raises
    ValueError (never `UnsupportedJpeg`) naming the file, and `_decodeImage`
    returns None, as the JAX package's does."""
    data = make()
    try:
        want = pilDecode(data)
    except OSError:
        want = None
    assert (want is not None) == pilReads
    if want is not None:
        np.testing.assert_array_equal(readJpeg(data, "member.jpg"), want)
        np.testing.assert_array_equal(_decodeImage(data, "member.jpg"), want)
        return
    with pytest.raises(ValueError, match="member.jpg: ") as info:
        readJpeg(data, "member.jpg")
    assert not isinstance(info.value, UnsupportedJpeg)
    assert _decodeImage(data, "member.jpg") is None


@pytest.mark.parametrize("cut", [2, 1, 300, 40, 3])
def test_truncated_file_raises_and_decodes_to_none(cut):
    """PIL raises on every cut ('image file is truncated'), so the JAX
    package's `_decodeImage` returns None; so does the port's."""
    data = pilSave(crop(64, 64), quality=95, restart_marker_blocks=4)
    short = data[:len(data) - cut] if cut < 10 else data[:cut]
    with pytest.raises(OSError):
        pilDecode(short)
    with pytest.raises(ValueError) as info:
        readJpeg(short)
    assert not isinstance(info.value, UnsupportedJpeg)
    assert _decodeImage(short) is None


def test_corrupt_files_never_crash_the_decoder():
    """Random byte flips and cuts of a file with restart markers: each
    decodes or raises ValueError, none crashes the process."""
    data = pilSave(crop(48, 64), quality=95, restart_marker_blocks=2)
    rng = np.random.default_rng(0)
    outcomes = set()
    for _ in range(400):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        if rng.random() < 0.3:
            b = b[:int(rng.integers(0, len(b)))]
        try:
            readJpeg(bytes(b))
            outcomes.add("decoded")
        except ValueError:
            outcomes.add("raised")
    assert outcomes == {"decoded", "raised"}


def test_corrupt_progressive_files_never_crash_the_decoder():
    """The same byte flips and cuts of a progressive file with restart
    markers; every refinement scan kind and end-of-band run is in it."""
    data = pilSave(crop(48, 64), quality=95, progressive=True, restart_marker_blocks=2)
    rng = np.random.default_rng(1)
    outcomes = set()
    for _ in range(400):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        if rng.random() < 0.3:
            b = b[:int(rng.integers(0, len(b)))]
        try:
            readJpeg(bytes(b))
            outcomes.add("decoded")
        except ValueError:
            outcomes.add("raised")
    assert outcomes == {"decoded", "raised"}


CORRUPTED = [
    ("arithmetic progressive", lambda: writeBaseline(crop(32, 40), [(2, 2), (1, 1), (1, 1)],
                                                     arithmetic=True, script=ARITH_SCRIPT, restart=2)),
    ("lossless", lambda: writeLossless(crop(16, 20), psv=4, ids=[82, 71, 66], restart=40)),
    ("CMYK progressive", lambda: pilSave(Image.fromarray(crop(32, 40)).convert("CMYK"),
                                         progressive=True)),
]


@pytest.mark.parametrize("kind,make", CORRUPTED, ids=[c[0] for c in CORRUPTED])
def test_corrupt_arithmetic_lossless_and_cmyk_files_never_crash_the_decoder(kind, make):
    """The same byte flips and cuts of an arithmetic progressive file with
    restarts, a lossless file with restarts and a progressive CMYK file:
    each decodes or raises ValueError, none crashes the process."""
    data = make()
    rng = np.random.default_rng(2)
    outcomes = set()
    for _ in range(300):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        if rng.random() < 0.3:
            b = b[:int(rng.integers(0, len(b)))]
        try:
            readJpeg(bytes(b))
            outcomes.add("decoded")
        except ValueError:
            outcomes.add("raised")
    assert outcomes == {"decoded", "raised"}


def test_a_progressive_file_cut_before_a_scan_is_refused_whatever_is_missing():
    """Cut after each of PIL's ten scans but the last: PIL decodes every cut,
    smoothing what is missing (jdcoefct.c::decompress_smooth_data); the port
    decodes each to the same RGB, gray and colour, 4:2:0 and 4:4:4, widths
    of one and two blocks, and the whole file as PIL does."""
    cases = [(crop(40, 48), dict(quality=90)), (crop(57, 75), dict(quality=75)),
             (crop(33, 17), dict(quality=95, subsampling=0)), (crop(100, 9), dict(quality=90)),
             (crop(9, 100).mean(2).astype(np.uint8), dict(quality=90)),
             (crop(40, 48), dict(quality=90, restart_marker_blocks=2))]
    for img, kwargs in cases:
        data = pilSave(img, progressive=True, **kwargs)
        starts = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
        assert len(starts) == (6 if img.ndim == 2 else 10)
        for cut in starts[1:]:
            short = data[:cut] + b"\xff\xd9"
            want = pilDecode(short)
            assert want.shape == (*img.shape[:2], 3)
            np.testing.assert_array_equal(readJpeg(short), want)
        np.testing.assert_array_equal(readJpeg(data), pilDecode(data))


def test_a_header_claiming_a_huge_image_is_refused():
    data = bytearray(pilSave(crop(16, 16)))
    pos = data.index(b"\xff\xc0")
    data[pos + 5:pos + 9] = struct.pack(">HH", 65535, 65535)
    with pytest.raises(ValueError, match="exceed the limit"):
        readJpeg(bytes(data))


# ----------------------------------------------------------------- encoding
@pytest.mark.parametrize("shape", [(96, 128), (1, 1), (17, 9), (9, 17), (257, 131), (16, 16),
                                   (31, 33), (512, 512)])
@pytest.mark.parametrize("quality", [95, 75])
def test_encode_equals_pil_save(shape, quality):
    img = crop(*shape, top=0, left=0)
    assert encodeJpeg(img, quality) == pilSave(img, quality=quality)


def test_encode_takes_rgb_only():
    with pytest.raises(ValueError, match="RGB"):
        encodeJpeg(crop(8, 8).mean(2).astype(np.uint8))


# ------------------------------------------------------------------ fixture
def _sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8).tobytes()).hexdigest()


FIXTURE_FILES = {
    "q95_420.jpg": (crop(64, 80, 40, 300), dict(quality=95)),
    "q95_444.jpg": (crop(64, 80, 200, 100), dict(quality=95, subsampling=0)),
    "gray.jpg": (crop(48, 64, 300, 500).mean(2).astype(np.uint8), dict(quality=95)),
    "odd_37x29.jpg": (crop(37, 29, 10, 10), dict(quality=95)),
    "restart.jpg": (crop(64, 96, 350, 600), dict(quality=95, restart_marker_blocks=3)),
    "optimized.jpg": (crop(56, 72, 150, 420), dict(quality=90, optimize=True)),
    "progressive.jpg": (crop(32, 32, 5, 700), dict(quality=90, progressive=True)),
    "photo_progressive.jpg": (PHOTO, dict(quality=90, progressive=True)),
    "cmyk.jpg": (Image.fromarray(crop(48, 56, 60, 120)).convert("CMYK"), dict(quality=90)),
    "photo_cmyk_q95.jpg": (Image.fromarray(PHOTO).convert("CMYK"), dict(quality=95)),
    "smoothed.jpg": (lambda: _lastScanCut(pilSave(crop(40, 48, 250, 330), quality=90, progressive=True)),
                     "PIL's progressive q90 cut before its last scan"),
    "ycck.jpg": (lambda: writeBaseline(cmyk(40, 48, 10, 600), [(2, 2), (1, 1), (1, 1), (2, 2)],
                                       adobe=2, jfif=False), "writeBaseline YCCK 2x2 luma and K"),
    "h411.jpg": (lambda: writeBaseline(crop(37, 45, 300, 50), [(4, 1), (1, 1), (1, 1)]),
                 "writeBaseline 4:1:1"),
    "arithmetic.jpg": (lambda: writeBaseline(crop(40, 48, 420, 700), [(2, 2), (1, 1), (1, 1)],
                                             arithmetic=True, restart=4, dac=(1, 3, 8)),
                       "writeBaseline arithmetic, restart 4, DAC"),
    "arithmetic_progressive.jpg": (lambda: writeBaseline(crop(40, 48, 120, 500), [(2, 2), (1, 1), (1, 1)],
                                                         arithmetic=True, script=ARITH_SCRIPT),
                                   "writeBaseline arithmetic progressive"),
    "lossless.jpg": (lambda: writeLossless(crop(24, 32, 330, 260), psv=4, ids=[82, 71, 66]),
                     "writeLossless predictor 4"),
    "photo_arithmetic.jpg": (lambda: writeBaseline(PHOTO, [(2, 2), (1, 1), (1, 1)], arithmetic=True),
                             "writeBaseline arithmetic 4:2:0 of the photo"),
}


def fixtureBytes(name: str) -> bytes:
    made, how = FIXTURE_FILES[name]
    return made() if callable(made) else pilSave(made, **how)


def writeFixture(folder: Path):
    """The card's decoder fixture: the files PIL and this test's writers
    write, the full-size progressive, CMYK and arithmetic photos among them, and a
    manifest of the SHA-256 of PIL's decode of each. Rewrite
    `tests/golden/torch_jpeg/` with it only if the files change."""
    folder.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, (_, how) in FIXTURE_FILES.items():
        data = fixtureBytes(name)
        (folder / name).write_bytes(data)
        decoded = pilDecode(data)
        manifest[name] = {"shape": list(decoded.shape), "sha256": _sha(decoded), "pil": how}
    (folder / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")


def test_fixture_manifest_is_pils_decode_and_the_ports():
    from mcquic_tpu.data.dataset import _decodeImage as jaxDecodeImage
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    assert sorted(manifest) == sorted(FIXTURE_FILES)
    assert sum(p.stat().st_size for p in FIXTURE.iterdir()) < 500_000
    for name, entry in manifest.items():
        data = (FIXTURE / name).read_bytes()
        theirs = pilDecode(data)
        assert list(theirs.shape) == entry["shape"] and _sha(theirs) == entry["sha256"], name
        assert _sha(readJpeg(data, name)) == entry["sha256"], name
        np.testing.assert_array_equal(_decodeImage(data, name), jaxDecodeImage(data), err_msg=name)
