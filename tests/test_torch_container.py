"""The port's `.mcq` container and PNG I/O, held to the libraries the JAX
package uses (msgpack, PIL), which the port itself does without."""
import io
import struct
import zlib
from pathlib import Path

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from mcquic_tpu.container import CodeSize as JaxCodeSize
from mcquic_tpu.container import File as JaxFile
from mcquic_tpu.container import FileHeader as JaxFileHeader
from mcquic_tpu.container import ImageSize as JaxImageSize
from mcquic_tpu_torch.container import CodeSize, File, FileHeader, ImageSize
from mcquic_tpu_torch.container import msgpack as mp
from mcquic_tpu_torch.data import png

PHOTO = Path(__file__).resolve().parent.parent / "assets" / "photo_768x512.png"
# every length boundary of the formats the subset writes
BOUNDARIES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]
INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
        -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]


def _same(obj):
    packed = mp.packb(obj)
    assert packed == msgpack.packb(obj, use_bin_type=True)
    assert mp.unpackb(packed) == msgpack.unpackb(packed, raw=False)
    return packed


@pytest.mark.parametrize("n", BOUNDARIES)
def test_msgpack_lengths_at_every_boundary(n):
    _same("s" * n)
    _same(b"b" * n)
    _same(list(range(min(n, 300))) if n < 65536 else [0] * n)
    _same({f"k{i}": i for i in range(n)} if n <= 256 else {f"k{i}": 0 for i in range(n)})


@pytest.mark.parametrize("value", INTS)
def test_msgpack_ints(value):
    _same(value)


_leaf = st.one_of(st.integers(-2 ** 63, 2 ** 64 - 1), st.text(max_size=300),
                  st.binary(max_size=70000))
_tree = st.recursive(_leaf, lambda kids: st.one_of(
    st.lists(kids, max_size=20), st.dictionaries(st.text(max_size=40), kids, max_size=20)),
    max_leaves=30)


@settings(max_examples=150, deadline=None, database=None)
@given(_tree)
def test_msgpack_matches_the_library(obj):
    _same(obj)


def test_msgpack_rejects_what_the_subset_lacks():
    for bad in (None, True, 1.5, {1, 2}):
        with pytest.raises(TypeError):
            mp.packb(bad)
    with pytest.raises(ValueError):
        mp.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError):
        mp.unpackb(mp.packb(b"abc")[:-1])


def test_mcq_file_matches_the_jax_package():
    binaries = [bytes(range(200)) * 2, b"", b"\x00" * 70000]
    ours = File(FileHeader("0.1.40", "2", CodeSize([2, 2, 2], [48, 24, 12], [32, 16, 8],
                                                  [8192, 2048, 512]), ImageSize(512, 768, 3)),
                binaries)
    theirs = JaxFile(JaxFileHeader("0.1.40", "2", JaxCodeSize([2, 2, 2], [48, 24, 12], [32, 16, 8],
                                                             [8192, 2048, 512]),
                                   JaxImageSize(512, 768, 3)), binaries)
    assert ours.serialize() == theirs.serialize()
    back = File.deserialize(theirs.serialize())
    assert back.Content == binaries and back.FileHeader.QuantizationParameter == "2"
    assert back.FileHeader.CodeSize == ours.FileHeader.CodeSize
    assert back.BPP == theirs.BPP
    with pytest.raises(ValueError, match="Version mismatch"):
        FileHeader("1.0.0", "2", ours.FileHeader.CodeSize, ours.FileHeader.ImageSize)


def test_png_reads_the_photo_like_pil():
    want = np.asarray(Image.open(PHOTO).convert("RGB"))
    got = png.readPng(PHOTO)
    assert got.dtype == np.uint8 and got.shape == (512, 768, 3)
    np.testing.assert_array_equal(got, want)


def _filtered(raw: np.ndarray, kind: int, bpp: int) -> bytes:
    """Rows of raw [H, W*bpp] uint8 encoded with one PNG filter type."""
    out = bytearray()
    prior = np.zeros(raw.shape[1], np.int32)
    for row in raw.astype(np.int32):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upLeft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upLeft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upLeft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upLeft))
        out.append(kind)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = row
    return bytes(out)


def _pngBytes(img: np.ndarray, colorType: int, kind: int) -> bytes:
    h, w, c = img.shape
    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))
    body = zlib.compress(_filtered(img.reshape(h, w * c), kind, c))
    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colorType, 0, 0, 0))
            + chunk(b"IDAT", body) + chunk(b"IEND", b""))


@pytest.mark.parametrize("colorType,channels", [(0, 1), (2, 3), (6, 4)])
@pytest.mark.parametrize("kind", range(5))
def test_png_filters_and_color_types_like_pil(colorType, channels, kind):
    rng = np.random.default_rng(kind * 10 + channels)
    img = rng.integers(0, 256, size=(9, 13, channels), dtype=np.uint8)
    img[3:6] = 200                                    # flat runs next to noise
    data = _pngBytes(img, colorType, kind)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(png.decodePng(data), want)


def test_png_writer_round_trips_through_pil(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, size=(17, 23, 3), dtype=np.uint8)
    png.writePng(tmp_path / "x.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "x.png")), img)
    np.testing.assert_array_equal(png.readPng(tmp_path / "x.png"), img)
    with pytest.raises(ValueError, match="RGB uint8"):
        png.encodePng(img[..., :2])


def _withHeader(data: bytes, depth: int, colorType: int, interlace: int = 0) -> bytes:
    width, height = struct.unpack(">II", data[16:24])
    ihdr = b"IHDR" + struct.pack(">IIBBBBB", width, height, depth, colorType, 0, 0, interlace)
    return data[:12] + ihdr + struct.pack(">I", zlib.crc32(ihdr)) + data[33:]


@pytest.mark.parametrize("mode", ["P", "I;16", "LA"])
def test_png_rejects_what_it_does_not_read(mode):
    """PIL's palette, 16-bit gray and gray-with-alpha files decode as PIL
    decodes them; the same files with a bit depth the standard does not
    allow for their color type are refused."""
    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 256, (5, 6, 3)).astype(np.uint8)).convert(
        "L" if mode == "I;16" else mode)
    if mode == "I;16":
        img = Image.fromarray((np.asarray(img).astype(np.uint16) * 257).astype(np.uint16))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    data = buf.getvalue()
    np.testing.assert_array_equal(png.decodePng(data),
                                  np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    colorType = data[25]
    with pytest.raises(ValueError, match=f"bad PNG header: bit depth 3, color type {colorType}"):
        png.decodePng(_withHeader(data, 3, colorType))


def test_png_rejects_interlaced_and_corrupt_files():
    """An interlace method other than none and Adam7 is refused, and so is
    an IHDR declaring Adam7 over rows written without it (the data runs
    short); a bad CRC and a foreign signature raise."""
    good = png.encodePng(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="interlace 2"):
        png.decodePng(_withHeader(good, 8, 2, 2))
    with pytest.raises(ValueError, match="truncated"):
        png.decodePng(_withHeader(good, 8, 2, 1))
    with pytest.raises(ValueError, match="CRC"):
        png.decodePng(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    with pytest.raises(ValueError, match="not a PNG"):
        png.decodePng(b"GIF89a")
