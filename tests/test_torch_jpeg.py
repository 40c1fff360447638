"""The port's JPEG codec (`mcquic_tpu_torch/data/jpeg.py`, `csrc/jpeg.cpp`)
against PIL on libjpeg-turbo, exactly:

  * the decoder equals `np.asarray(Image.open(f).convert("RGB"))` on crops
    of the photo written by PIL at q95 and q75 with subsampling 0, 1 and 2,
    grayscale, sizes 1x1, 17x9 and 257x131, restart markers, optimized
    Huffman tables and Adobe RGB; and, on files of this test's own baseline
    writer (`writeBaseline`), on what PIL does not write: 4:4:0,
    non-interleaved scans, 16-bit quantization tables, SOF1, several tables
    in one DHT segment, component ids 'R', 'G', 'B';
  * progressive files (SOF2) as PIL writes them: 4:2:0, 4:2:2, 4:4:4, gray,
    sizes 1x1 to 257x131, restart intervals, optimized tables, q100 and q10;
  * a progressive file whose scans leave bits unsent (PIL's scan script cut
    before its last refinement; libjpeg smooths such a file), arithmetic-coded,
    lossless, 12-bit and CMYK files raise `UnsupportedJpeg` naming the file and
    the marker; a truncated or corrupt file, baseline or progressive, raises
    ValueError, and `_decodeImage` returns None for it;
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


def writeBaseline(img: np.ndarray, sampling, *, restart: int = 0, nonInterleaved: bool = False,
                  dqt16: bool = False, sof1: bool = False, adobe=None, ids=None,
                  jfif: bool = True) -> bytes:
    """A sequential Huffman JPEG of `img` (uint8 [H, W, 3], or [H, W] gray)
    with the given (h, v) sampling per component, a float DCT, the standard
    Huffman tables in one DHT segment, and the options PIL has no way to ask
    for. `adobe=0` writes the RGB planes untransformed."""
    gray = img.ndim == 2
    H, W = img.shape[:2]
    x = img.astype(np.float64)
    if gray:
        planes = [x]
    elif adobe == 0 or (ids == [82, 71, 66]):
        planes = [x[..., 0], x[..., 1], x[..., 2]]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    ids = ids or list(range(1, len(planes) + 1))
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mcusX, mcusY = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    quant = [np.clip(1 + 2 * (_U[:, None] + _U[None]) + 9 * t, 1, 255).astype(int)
             for t in range(2)]
    if dqt16:
        quant[1] = quant[1] + 280                       # needs 16-bit entries
    huff = _standardHuffman()
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
    header += _segment(0xC1 if sof1 else 0xC0, struct.pack(">BHHB", 8, H, W, len(sampling)) + b"".join(
        bytes([ids[c], (h << 4) | v, min(c, 1)]) for c, (h, v) in enumerate(sampling)))
    dht = b""
    for (tc, th), (counts, symbols) in sorted(huff.items()):
        if not gray or th == 0:
            dht += bytes([(tc << 4) | th] + counts + symbols)
    header += _segment(0xC4, dht)
    if restart:
        header += _segment(0xDD, struct.pack(">H", restart))
    tables = [(_codes(huff[(0, min(c, 1))]), _codes(huff[(1, min(c, 1))])) for c in range(len(sampling))]

    def scan(components, units):
        out = _segment(0xDA, bytes([len(components)]) + b"".join(
            bytes([ids[c], (min(c, 1) << 4) | min(c, 1)]) for c in components) + b"\x00\x3f\x00")
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
    if nonInterleaved or len(sampling) == 1:
        for c in range(len(sampling)):
            _, realW, realH = coded[c]
            body += scan([c], [[(c, by, bx)] for by in range(realH) for bx in range(realW)])
    else:
        units = [[(c, my * v + y, mx * h + x) for c, (h, v) in enumerate(sampling)
                  for y in range(v) for x in range(h)]
                 for my in range(mcusY) for mx in range(mcusX)]
        body += scan(list(range(len(sampling))), units)
    return bytes(header) + body + b"\xff\xd9"


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
]


@pytest.mark.parametrize("name,img,sampling,kwargs", WRITER_CASES, ids=[c[0] for c in WRITER_CASES])
def test_decode_equals_pil_on_what_pil_does_not_write(name, img, sampling, kwargs):
    data = writeBaseline(img, sampling, **kwargs)
    want = pilDecode(data)
    assert want.shape == (*img.shape[:2], 3)
    np.testing.assert_array_equal(readJpeg(data), want)


def _withMarker(data: bytes, old: int, new: int) -> bytes:
    pos = data.index(bytes([0xFF, old]))
    return data[:pos + 1] + bytes([new]) + data[pos + 2:]


def _sofPrecision(data: bytes, bits: int) -> bytes:
    pos = data.index(b"\xff\xc0")
    return data[:pos + 4] + bytes([bits]) + data[pos + 5:]


def _lastScanCut(data: bytes) -> bytes:
    """A progressive file cut before its last scan, which refines the luma
    AC coefficients from Al 1 to 0 in PIL's script: the file ends at EOI
    with bits unsent, and libjpeg decodes it with block smoothing."""
    sos = data.rindex(b"\xff\xda")
    return data[:sos] + b"\xff\xd9"


REFUSED = [
    ("progressive", lambda: _lastScanCut(pilSave(crop(32, 32), quality=90, progressive=True)),
     "incomplete progressive scans: .*ends at Al 1 .*SOF marker 0xFFC2"),
    ("arithmetic", lambda: _withMarker(pilSave(crop(32, 32)), 0xC0, 0xC9), "0xFFC9"),
    ("lossless", lambda: _withMarker(pilSave(crop(32, 32)), 0xC0, 0xC3), "0xFFC3"),
    ("12-bit", lambda: _sofPrecision(pilSave(crop(32, 32)), 12), "12-bit"),
    ("CMYK", lambda: pilSave(Image.fromarray(crop(32, 32)).convert("CMYK")), "CMYK"),
]


@pytest.mark.parametrize("kind,make,marker", REFUSED, ids=[c[0] for c in REFUSED])
def test_unread_kinds_raise_naming_file_and_marker(kind, make, marker):
    data = make()
    with pytest.raises(UnsupportedJpeg, match=f"member.jpg: .*{marker}"):
        readJpeg(data, "member.jpg")
    with pytest.raises(UnsupportedJpeg, match="member.jpg"):
        _decodeImage(data, "member.jpg")


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


def test_a_progressive_file_cut_before_a_scan_is_refused_whatever_is_missing():
    """Cut after each of PIL's ten scans but the last: PIL decodes every cut
    (smoothing what is missing); the port refuses each, naming what is
    incomplete, and decodes the whole file as PIL does."""
    data = pilSave(crop(40, 48), quality=90, progressive=True)
    starts = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(starts) == 10
    for cut in starts[1:]:
        short = data[:cut] + b"\xff\xd9"
        assert pilDecode(short).shape == (40, 48, 3)
        with pytest.raises(UnsupportedJpeg, match="incomplete progressive scans"):
            readJpeg(short)
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
}


def writeFixture(folder: Path):
    """The card's decoder fixture: the files PIL writes, the full-size
    progressive photo among them, and a manifest of the SHA-256 of PIL's
    decode of each. Run once to create `tests/golden/torch_jpeg/`."""
    folder.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, (img, kwargs) in FIXTURE_FILES.items():
        data = pilSave(img, **kwargs)
        (folder / name).write_bytes(data)
        decoded = pilDecode(data)
        manifest[name] = {"shape": list(decoded.shape), "sha256": _sha(decoded), "pil": kwargs}
    (folder / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")


def test_fixture_manifest_is_pils_decode_and_the_ports():
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    assert sorted(manifest) == sorted(FIXTURE_FILES)
    assert sum(p.stat().st_size for p in FIXTURE.iterdir()) < 300_000
    for name, entry in manifest.items():
        data = (FIXTURE / name).read_bytes()
        theirs = pilDecode(data)
        assert list(theirs.shape) == entry["shape"] and _sha(theirs) == entry["sha256"], name
        assert _sha(readJpeg(data, name)) == entry["sha256"], name
