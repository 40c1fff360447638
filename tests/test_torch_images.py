"""The port's PNG and BMP readers (`mcquic_tpu_torch/data/png.py`,
`data/bmp.py`) against PIL, exactly: each decode equals
`np.asarray(Image.open(f).convert("RGB"))` (Pillow 12.1).

  * PNG: every color type at every bit depth the standard allows (gray 1,
    2, 4, 8, 16; RGB 8, 16; palette 1, 2, 4, 8 with and without tRNS; gray
    with alpha 8, 16; RGBA 8, 16), with and without Adam7 interlace, written
    by this test's own writer (`writePng`: random filters per row, since PIL
    writes none of the 16-bit color forms, no 2-bit gray and no Adam7), and
    the files PIL writes;
  * BMP: 1, 4 and 8-bit palettes (a gray ramp too, which PIL reads as mode
    1 or L), 16, 24 and 32 bits, BI_RGB and BI_BITFIELDS in every layout PIL
    knows, bottom-up and top-down, at header sizes 40, 56, 108 and 124,
    written by `writeBmp`, and the files PIL writes (modes 1, L, P, RGB,
    RGBA); RLE8 and RLE4 files (`writeRle`, `encodeRle8`: runs, absolute
    runs, deltas, early ends) and OS/2 1.x files (`writeOs2`) decode as PIL
    reads them, or to None through `_decodeImage` where PIL fails, as does
    a truncated file;
  * the card's fixture `tests/golden/torch_images/`: PIL's decode of every
    committed file hashes to its manifest entry (`writeFixture` writes both),
    and so does the port's.
"""
import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mcquic_tpu_torch.data.bmp import decodeBmp
from mcquic_tpu_torch.data.dataset import _decodeImage, readImage
from mcquic_tpu_torch.data.png import SIGNATURE, decodePng, readPng

ROOT = Path(__file__).resolve().parent.parent
PHOTO = readPng(ROOT / "assets" / "photo_768x512.png")
FIXTURE = ROOT / "tests" / "golden" / "torch_images"


def pilDecode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def pilSave(img: Image.Image, fmt: str) -> bytes:
    buffer = io.BytesIO()
    img.save(buffer, format=fmt)
    return buffer.getvalue()


# ------------------------------------------------------------- a PNG writer
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """Samples [h, n] -> packed rows [h, rowBytes], big-endian, MSB first."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.concatenate([samples, np.zeros((h, (-n) % per), samples.dtype)], 1)
    s = s.reshape(h, -1, per).astype(np.uint16)
    return sum(s[..., i] << (8 - depth * (i + 1)) for i in range(per)).astype(np.uint8)


def _filter(row: np.ndarray, prior: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    row, prior = row.astype(int), prior.astype(int)
    left = np.concatenate([np.zeros(bpp, int), row[:-bpp]])
    upLeft = np.concatenate([np.zeros(bpp, int), prior[:-bpp]])
    if kind == 4:
        p = left + prior - upLeft
        pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upLeft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upLeft))
    else:
        pred = [0 * row, left, prior, (left + prior) // 2][kind]
    return ((row - pred) % 256).astype(np.uint8)


def writePng(samples: np.ndarray, colorType: int, depth: int, interlace: bool = False,
             palette=None, trns: bytes = None, seed: int = 0) -> bytes:
    """samples [H, W, channels] in the depth's range -> a PNG, each row under
    a filter drawn from `seed`."""
    rng = np.random.default_rng(seed)
    height, width, channels = samples.shape
    bpp = max(1, channels * depth // 8)
    raw = bytearray()
    for xs, ys, xd, yd in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[ys::yd, xs::xd]
        if sub.size == 0:
            continue
        rows = _pack(sub.reshape(sub.shape[0], -1), depth)
        prior = np.zeros(rows.shape[1], np.uint8)
        for row in rows:
            kind = int(rng.integers(0, 5))
            raw += bytes([kind]) + _filter(row, prior, kind, bpp).tobytes()
            prior = row
    out = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, colorType,
                                                  0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(bytes(raw), 6)) + _chunk(b"IEND", b"")


def pngForm(colorType, depth, interlace=False, shape=(19, 23), seed=0, trns=False):
    """A PNG of the photo's crop in one form (samples from the photo, scaled
    to the depth), with a palette of random colors of random length."""
    rng = np.random.default_rng(seed)
    h, w = shape
    crop = PHOTO[50:50 + h, 300:300 + w].astype(np.int64)
    gray = crop.mean(2, keepdims=True).astype(np.int64)
    base = {0: gray, 2: crop, 3: gray, 4: np.concatenate([gray, crop[..., :1]], 2),
            6: np.concatenate([crop, crop[..., 1:2]], 2)}[colorType]
    top = (1 << depth) - 1
    samples = base * top // 255 if depth <= 8 else base * 257 + rng.integers(0, 256, base.shape)
    palette = trnsBytes = None
    if colorType == 3:
        entries = int(rng.integers(1, min(top + 1, 256) + 1))
        palette = rng.integers(0, 256, (entries, 3))
        if trns:
            trnsBytes = bytes(rng.integers(0, 256, entries).astype(np.uint8))
    elif trns:
        trnsBytes = b"".join(struct.pack(">H", int(v) & top) for v in rng.integers(0, 256,
                                                                                CHANNELS[colorType]))
    return writePng(samples, colorType, depth, interlace, palette, trnsBytes, seed)


PNG_FORMS = [(ct, d) for ct, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)),
                                        (4, (8, 16)), (6, (8, 16))) for d in depths]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "Adam7"])
@pytest.mark.parametrize("colorType,depth", PNG_FORMS, ids=[f"type{c}-{d}bit" for c, d in PNG_FORMS])
def test_png_decode_equals_pil(colorType, depth, interlace):
    for seed, shape in enumerate(((19, 23), (1, 1), (9, 2))):
        data = pngForm(colorType, depth, interlace, shape, seed, trns=seed == 0)
        np.testing.assert_array_equal(decodePng(data), pilDecode(data), err_msg=f"{shape}")


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "I;16", "RGB", "RGBA"])
def test_png_decode_equals_pil_on_what_pil_writes(mode):
    img = Image.fromarray(PHOTO[:37, :29]).convert(mode if mode != "I;16" else "L")
    if mode == "I;16":
        img = Image.fromarray((np.asarray(img).astype(np.uint16) * 300).astype(np.uint16))
    data = pilSave(img, "PNG")
    np.testing.assert_array_equal(decodePng(data), pilDecode(data))


# ------------------------------------------------------------- a BMP writer
def writeBmp(width, height, bits, pixels: bytes, compression=0, masks=None, header=40,
             palette=b"", colors=0, topDown=False) -> bytes:
    stride = ((width * bits + 31) >> 3) & ~3
    info = struct.pack("<IiiHHIIiiII", header, width, -height if topDown else height, 1, bits,
                       compression, stride * height, 2835, 2835, colors, 0)
    extra = b""
    if header > 40:
        info += struct.pack("<IIII", *(list(masks or (0, 0, 0, 0)) + [0] * 4)[:4])
        info += b"\0" * (header - 56)
    elif masks is not None:
        extra = struct.pack("<III", *masks[:3])
    offset = 14 + header + len(extra) + len(palette)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + extra
            + palette + pixels)


MASKS32 = [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
           (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
           (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
           (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)]


def bmpCases():
    rng = np.random.default_rng(0)
    cases = []
    for w, h in ((1, 1), (7, 5), (13, 9)):
        for topDown in (False, True):
            for header in (40, 56, 108, 124):
                tag = f"{w}x{h}{' top-down' if topDown else ''} header {header}"

                def px(bits):
                    stride = ((w * bits + 31) >> 3) & ~3
                    return rng.integers(0, 256, (h, stride)).astype(np.uint8).tobytes()
                for bits in (1, 4, 8):
                    colors = int(rng.integers(2, (1 << bits) + 1))
                    pal = rng.integers(0, 256, (colors, 4)).astype(np.uint8).tobytes()
                    cases.append((f"palette {bits} {tag}", writeBmp(w, h, bits, px(bits),
                                  palette=pal, colors=colors, topDown=topDown, header=header)))
                ramp = b"".join(bytes([v, v, v, 0]) for v in range(256))
                cases.append((f"gray ramp 8 {tag}", writeBmp(w, h, 8, px(8), palette=ramp,
                              colors=256, topDown=topDown, header=header)))
                cases.append((f"black and white 1 {tag}", writeBmp(
                    w, h, 1, px(1), palette=b"\0\0\0\0\xff\xff\xff\0", colors=2,
                    topDown=topDown, header=header)))
                for bits in (16, 24, 32):
                    cases.append((f"BI_RGB {bits} {tag}", writeBmp(w, h, bits, px(bits),
                                                                    topDown=topDown, header=header)))
                for masks in ((0xF800, 0x7E0, 0x1F, 0), (0x7C00, 0x3E0, 0x1F, 0)):
                    cases.append((f"bitfields 16 {masks[0]:#x} {tag}", writeBmp(
                        w, h, 16, px(16), 3, masks, header, topDown=topDown)))
                cases.append((f"bitfields 24 {tag}", writeBmp(w, h, 24, px(24), 3,
                              (0xFF0000, 0xFF00, 0xFF, 0), header, topDown=topDown)))
                for masks in MASKS32:
                    if header > 40 or not masks[3]:
                        cases.append((f"bitfields 32 {masks} {tag}", writeBmp(
                            w, h, 32, px(32), 3, masks, header, topDown=topDown)))
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        img = Image.fromarray(PHOTO[:11, :9]).convert(mode)
        cases.append((f"PIL {mode}", pilSave(img, "BMP")))
    return cases


def test_bmp_decode_equals_pil():
    cases = bmpCases()
    assert len(cases) > 250
    for name, data in cases:
        np.testing.assert_array_equal(decodeBmp(data), pilDecode(data), err_msg=name)


def _rle(data: bytes, compression: int) -> bytes:
    b = bytearray(data)
    b[30:34] = struct.pack("<I", compression)
    return bytes(b)


def writeRle(width, height, rle4, seed, *, palette=None, colors=16, topDown=False, delta=False,
             stop=None, header=40) -> bytes:
    """An RLE8 or RLE4 BMP of random runs: each row a mix of encoded runs
    and absolute runs (padded to 16 bits), ended by end of line, then end of
    bitmap. `delta` puts a delta escape (00 02 dx dy) in the second row,
    `stop` ends the bitmap after that many rows."""
    rng = np.random.default_rng(seed)
    if palette is None:
        palette = rng.integers(0, 256, (colors, 4)).astype(np.uint8).tobytes()
    stream = bytearray()
    for y in range(height if stop is None else stop):
        x = 0
        if delta and y == 1:
            stream += bytes([0, 2, 2, 1])
        while x < width:
            n = int(rng.integers(1, min(width - x, 20) + 1))
            if n >= 3 and rng.random() < 0.5:
                body = rng.integers(0, 256 if rle4 else colors, (n + 1) // 2 if rle4 else n)
                body = body.astype(np.uint8).tobytes()
                stream += bytes([0, n]) + body + bytes(len(body) % 2)
            else:
                stream += bytes([n, int(rng.integers(0, 256 if rle4 else colors))])
            x += n
        stream += b"\0\0"
    stream += b"\0\1"
    data = bytearray(writeBmp(width, height, 4 if rle4 else 8, bytes(stream), compression=2 if rle4 else 1,
                              palette=palette, colors=colors, topDown=topDown, header=header))
    return bytes(data)


def encodeRle8(img: np.ndarray) -> bytes:
    """An RLE8 BMP of RGB `img`, quantized to PIL's 256-colour palette:
    each row (bottom-up) as encoded runs of equal indices and absolute runs
    of differing ones (word padded), end of line, then end of bitmap, as
    Windows writes RLE8."""
    quantized = Image.fromarray(img).quantize(256)
    indices = np.asarray(quantized)
    rgb = np.asarray(quantized.getpalette()[:768], np.uint8).reshape(-1, 3)
    palette = np.zeros((256, 4), np.uint8)
    palette[:len(rgb), :3] = rgb[:, ::-1]
    stream = bytearray()
    for row in indices[::-1]:
        x, width = 0, len(row)
        while x < width:
            run = 1
            while x + run < width and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 2:
                stream += bytes([run, row[x]])
                x += run
                continue
            end = x + 1
            while end < width and end - x < 255 and (end + 1 >= width or row[end] != row[end + 1]):
                end += 1
            if end - x >= 3:
                stream += bytes([0, end - x]) + row[x:end].tobytes() + bytes((end - x) & 1)
            else:
                stream += b"".join(bytes([1, v]) for v in row[x:end])
            x = end
        stream += b"\0\0"
    stream += b"\0\1"
    return writeBmp(img.shape[1], img.shape[0], 8, bytes(stream), compression=1,
                    palette=palette.tobytes(), colors=256)


def writeOs2(width, height, bits, seed, gray=False) -> bytes:
    """An OS/2 1.x BMP (BITMAPCOREHEADER: 16-bit sizes, 3-byte palette)."""
    rng = np.random.default_rng(seed)
    colors = 1 << bits if bits <= 8 else 0
    palette = (b"".join(bytes([v, v, v]) for v in range(256)) if gray
               else rng.integers(0, 256, (colors, 3)).astype(np.uint8).tobytes())
    stride = ((width * bits + 31) >> 3) & ~3
    pixels = rng.integers(0, 256, (height, stride)).astype(np.uint8).tobytes()
    offset = 14 + 12 + len(palette)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + struct.pack("<IHHHH", 12, width, height, 1, bits) + palette + pixels)


def rleAndOs2Cases():
    cases = []
    for rle4 in (False, True):
        tag = "RLE4" if rle4 else "RLE8"
        for w, h in ((1, 1), (7, 5), (13, 9), (40, 3)):
            cases.append((f"{tag} {w}x{h}", writeRle(w, h, rle4, w * h)))
        cases.append((f"{tag} top-down", writeRle(13, 9, rle4, 1, topDown=True)))
        cases.append((f"{tag} header 124", writeRle(13, 9, rle4, 2, header=124)))
        cases.append((f"{tag} delta", writeRle(13, 9, rle4, 3, delta=True)))
        cases.append((f"{tag} end of bitmap early", writeRle(13, 9, rle4, 4, stop=5)))
        cases.append((f"{tag} 3 colors", writeRle(13, 9, rle4, 5, colors=3)))
    ramp = b"".join(bytes([v, v, v, 0]) for v in range(256))
    cases.append(("RLE8 gray ramp", writeRle(13, 9, False, 6, palette=ramp, colors=256)))
    cases.append(("RLE8 black and white", writeRle(13, 9, False, 7, palette=b"\0\0\0\0\xff\xff\xff\0",
                                                   colors=2)))
    data = writeRle(13, 9, False, 8)
    cases.append(("RLE8 truncated", data[:len(data) // 2]))
    cases.append(("RLE8 at 24 bits", data[:28] + struct.pack("<H", 24) + data[30:]))
    for bits in (1, 4, 8, 24):
        for w, h in ((1, 1), (7, 5), (13, 9)):
            cases.append((f"OS/2 1.x {bits} bits {w}x{h}", writeOs2(w, h, bits, bits * w + h)))
    cases.append(("OS/2 1.x gray ramp", writeOs2(13, 9, 8, 9, gray=True)))
    cases.append(("RLE8 of the photo", encodeRle8(PHOTO[100:160, 200:283])))
    return cases


def test_rle_and_os2_bmp_decode_equal_pil_or_none_where_pil_fails():
    """PIL's reading of every RLE and OS/2 1.x form, bit for bit; where PIL
    fails (an early end of bitmap, truncated data, RLE at 24 bits or over a
    2-colour gray palette) the port's `_decodeImage` returns None."""
    failed = 0
    for name, data in rleAndOs2Cases():
        try:
            want = pilDecode(data)
        except (OSError, ValueError):
            want = None
        got = _decodeImage(data, name)
        if want is None:
            failed += 1
            assert got is None, name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert 3 <= failed <= 7


def _rle(data: bytes, compression: int) -> bytes:
    b = bytearray(data)
    b[30:34] = struct.pack("<I", compression)
    return bytes(b)


@pytest.mark.parametrize("kind,make,text", [
    ("RLE8", lambda: _rle(pilSave(Image.fromarray(PHOTO[:8, :8]).convert("P"), "BMP"), 1), "RLE8"),
    ("RLE4", lambda: _rle(writeBmp(4, 4, 4, bytes(16), palette=bytes(64), colors=16), 2), "RLE4"),
    ("OS/2 1.x", lambda: b"BM" + struct.pack("<IHHI", 26 + 12, 0, 0, 26)
     + struct.pack("<IHHHH", 12, 2, 2, 1, 24) + bytes(16), "OS/2"),
])
def test_bmp_forms_the_port_does_not_read_raise_naming_the_file(kind, make, text):
    """The files once refused, each a form the reader now takes: the port
    decodes each to PIL's RGB, or to None where PIL fails on the bytes (the
    RLE8 case is uncompressed pixels relabelled RLE8)."""
    data = make()
    try:
        want = pilDecode(data)
    except (OSError, ValueError):
        want = None
    got = _decodeImage(data, "member.bmp")
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


def test_truncated_bmp_decodes_to_none_and_readimage_reads_bmp(tmp_path):
    data = pilSave(Image.fromarray(PHOTO[:20, :30]), "BMP")
    assert _decodeImage(data[:-7], "short.bmp") is None
    with pytest.raises(OSError, match="truncated"):
        pilDecode(data[:-7])
    (tmp_path / "a.bmp").write_bytes(data)
    np.testing.assert_array_equal(readImage(tmp_path / "a.bmp"), PHOTO[:20, :30])
    # a RIFF WEBP header without chunks: PIL does not identify it, and the port's
    # WebP decoder refuses it
    webp = b"RIFF" + struct.pack("<I", 4) + b"WEBP"
    with pytest.raises(OSError):
        pilDecode(webp)
    assert _decodeImage(webp, "b.webp") is None


# ------------------------------------------------------------------ fixture
def _sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8).tobytes()).hexdigest()


def fixtureFiles() -> dict:
    """name -> bytes of every fixture file: one PNG per form beyond 8-bit
    gray, RGB and RGBA (this test's writer), one BMP per form PIL writes."""
    files = {}
    for colorType, depth in PNG_FORMS:
        if depth == 8 and colorType in (0, 2, 6):
            continue
        files[f"png_type{colorType}_{depth}bit.png"] = pngForm(colorType, depth, shape=(24, 32),
                                                              seed=depth, trns=colorType == 3)
    files["png_adam7_rgb.png"] = pngForm(2, 8, True, (29, 35), seed=1)
    files["png_adam7_palette4.png"] = pngForm(3, 4, True, (29, 35), seed=2)
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        files[f"bmp_{mode.lower()}.bmp"] = pilSave(Image.fromarray(PHOTO[200:232, 400:440])
                                                   .convert(mode), "BMP")
    return files


def writeFixture(folder: Path = FIXTURE):
    """The card's image fixture: the files and a manifest of the SHA-256 of
    PIL's decode of each. Run once to create `tests/golden/torch_images/`."""
    folder.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, data in fixtureFiles().items():
        (folder / name).write_bytes(data)
        decoded = pilDecode(data)
        manifest[name] = {"shape": list(decoded.shape), "sha256": _sha(decoded)}
    (folder / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")


def test_fixture_manifest_is_pils_decode_and_the_ports():
    from mcquic_tpu.data.dataset import _decodeImage as jaxDecodeImage
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    assert sorted(manifest) == sorted(fixtureFiles())
    assert sum(p.stat().st_size for p in FIXTURE.iterdir()) < 60_000
    for name, entry in manifest.items():
        data = (FIXTURE / name).read_bytes()
        theirs = pilDecode(data)
        assert list(theirs.shape) == entry["shape"] and _sha(theirs) == entry["sha256"], name
        assert _sha(_decodeImage(data, name)) == entry["sha256"], name
        np.testing.assert_array_equal(_decodeImage(data, name), jaxDecodeImage(data), err_msg=name)
