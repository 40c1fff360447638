"""The port's WebP decoder (`mcquic_tpu_torch/data/webp.py`,
`csrc/webp.cpp`) against PIL on libwebp 1.6, exactly: the RGBA PIL holds
(`Image.open(f).convert("RGBA")`) and so the RGB of `convert("RGB")`, on

  * files PIL writes: lossy at quality 0 to 100 and method 0 to 6, lossless
    at each method and quality, with and without alpha, `exact`,
    `alpha_quality`, odd sizes down to 1x1 (the upsampler's edges), ICC,
    EXIF and XMP chunks, and animations (`save_all`), of which PIL takes
    frame 0;
  * files of Pillow's own libwebp driven through ctypes (`encodeWebp`:
    `WebPConfigInitInternal` and `WebPEncode`) with the settings Pillow does
    not expose: the simple loop filter (`filter_type` 0), 2, 4 and 8 token
    partitions, 1 to 4 segments, filter sharpness and strength;
  * an animation whose frame 0 lies inside a larger canvas (this test's
    `animated`), which anim_decode.c composes on transparent black;
  * truncated and corrupt files: none crashes the decoder; where PIL fails,
    `_decodeImage` returns None, as the JAX package's does, and where PIL
    decodes, the port decodes to the same RGB;
  * the JAX package's `_decodeImage` on every fixture;
  * the card's fixture `tests/golden/torch_webp/`: PIL's decode of every
    committed file hashes to its manifest entry (`writeFixture` writes both),
    and so does the port's.
"""
import ctypes
import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mcquic_tpu_torch.data.dataset import _decodeImage
from mcquic_tpu_torch.data.png import readPng
from mcquic_tpu_torch.data.webp import readWebp, readWebpRgba

ROOT = Path(__file__).resolve().parent.parent
PHOTO = readPng(ROOT / "assets" / "photo_768x512.png")
FIXTURE = ROOT / "tests" / "golden" / "torch_webp"


def pilSave(img, **kwargs) -> bytes:
    buffer = io.BytesIO()
    if not isinstance(img, Image.Image):
        img = Image.fromarray(img, "RGBA" if img.ndim == 3 and img.shape[2] == 4 else None)
    img.save(buffer, format="WEBP", **kwargs)
    return buffer.getvalue()


def pilRgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def pilRgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def crop(h: int, w: int, top: int = 100, left: int = 200) -> np.ndarray:
    return np.ascontiguousarray(PHOTO[top:top + h, left:left + w])


def withAlpha(h: int, w: int, top: int = 100, left: int = 200) -> np.ndarray:
    """A crop with an alpha ramp and a fully transparent band."""
    alpha = (np.arange(w)[None].repeat(h, 0) * 7 % 256).astype(np.uint8)
    alpha[h // 3:h // 2] = 0
    return np.dstack([crop(h, w, top, left), alpha])


# ------------------------------------------- Pillow's libwebp through ctypes
_CONFIG_FIELDS = ["lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
                  "segments", "sns_strength", "filter_strength", "filter_sharpness", "filter_type",
                  "autofilter", "alpha_compression", "alpha_filtering", "alpha_quality", "pass_",
                  "show_compressed", "preprocessing", "partitions", "partition_limit",
                  "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless", "exact",
                  "use_delta_palette", "use_sharp_yuv", "qmin", "qmax"]


class _Config(ctypes.Structure):
    """encode.h's WebPConfig."""
    _fields_ = [(f, ctypes.c_float if f in ("quality", "target_PSNR") else ctypes.c_int)
                for f in _CONFIG_FIELDS]


class _Writer(ctypes.Structure):
    """encode.h's WebPMemoryWriter."""
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32)]


_ABI = 0x020f                 # WEBP_ENCODER_ABI_VERSION: only its major byte is checked
# WebPPicture offsets on a 64-bit build (encode.h)
_USE_ARGB, _WIDTH, _HEIGHT, _WRITER, _CUSTOM_PTR, _ERROR_CODE = 0, 8, 12, 96, 104, 136


def _libwebp():
    import PIL
    from PIL import _webp  # noqa: F401  (loads libwebp and the libsharpyuv it needs)
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    return ctypes.CDLL(str(next(libs.glob("libwebp-*.so*"))))


def encodeWebp(img: np.ndarray, quality: float = 75.0, **settings) -> bytes:
    """A WebP of RGB or RGBA `img` from Pillow's bundled libwebp with any
    WebPConfig setting (`WebPEncode`, the preset's defaults otherwise)."""
    lib = _libwebp()
    config = _Config()
    assert lib.WebPConfigInitInternal(ctypes.byref(config), 0, ctypes.c_float(quality), _ABI)
    for name, value in settings.items():
        setattr(config, name, value)
    picture = (ctypes.c_uint8 * 512)()
    assert lib.WebPPictureInitInternal(picture, _ABI)
    img = np.ascontiguousarray(img)
    ctypes.c_int.from_buffer(picture, _USE_ARGB).value = int(config.lossless)
    ctypes.c_int.from_buffer(picture, _WIDTH).value = img.shape[1]
    ctypes.c_int.from_buffer(picture, _HEIGHT).value = img.shape[0]
    importer = lib.WebPPictureImportRGBA if img.shape[2] == 4 else lib.WebPPictureImportRGB
    assert importer(picture, img.ctypes.data_as(ctypes.c_void_p), img.shape[1] * img.shape[2])
    writer = _Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    ctypes.c_void_p.from_buffer(picture, _WRITER).value = ctypes.cast(lib.WebPMemoryWrite,
                                                                      ctypes.c_void_p).value
    ctypes.c_void_p.from_buffer(picture, _CUSTOM_PTR).value = ctypes.addressof(writer)
    ok = lib.WebPEncode(ctypes.byref(config), picture)
    error = ctypes.c_int.from_buffer(picture, _ERROR_CODE).value
    data = ctypes.string_at(writer.mem, writer.size)
    lib.WebPMemoryWriterClear(ctypes.byref(writer))
    lib.WebPPictureFree(picture)
    assert ok, f"WebPEncode failed with error {error}"
    return data


# ------------------------------------------------------ an animation writer
def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def imageChunks(data: bytes) -> bytes:
    """The ALPH / VP8 / VP8L chunks of a still WebP."""
    pos, out = 12, b""
    while pos + 8 <= len(data):
        tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            out += data[pos:pos + 8 + size + (size & 1)]
        pos += 8 + size + (size & 1)
    return out


def animated(frames, canvas, alpha: bool = True) -> bytes:
    """VP8X + ANIM + one ANMF per (still WebP bytes, x, y, width, height):
    the frames placed at even offsets on a canvas (width, height)."""
    flags = 0x02 | (0x10 if alpha else 0)
    body = _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (canvas[0] - 1).to_bytes(3, "little")
                  + (canvas[1] - 1).to_bytes(3, "little"))
    body += _chunk(b"ANIM", struct.pack("<IH", 0xff00ff00, 0))
    for data, x, y, w, h in frames:
        header = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                  + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
                  + (100).to_bytes(3, "little") + b"\0")
        body += _chunk(b"ANMF", header + imageChunks(data))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _saveAll(frames, **kwargs) -> bytes:
    buffer = io.BytesIO()
    images = [Image.fromarray(f, "RGBA" if f.shape[2] == 4 else "RGB") for f in frames]
    images[0].save(buffer, format="WEBP", save_all=True, append_images=images[1:], duration=80,
                   **kwargs)
    return buffer.getvalue()


# ----------------------------------------------------------------- decoding
PIL_CASES = [(f"lossy q{q}", lambda q=q: pilSave(crop(64, 80), quality=q)) for q in (0, 10, 50, 80, 100)]
PIL_CASES += [(f"lossy method {m}", lambda m=m: pilSave(crop(48, 56), quality=70, method=m))
              for m in range(7)]
PIL_CASES += [(f"lossless method {m}", lambda m=m: pilSave(crop(40, 52), lossless=True, method=m))
              for m in (0, 3, 6)]
PIL_CASES += [(f"lossless q{q}", lambda q=q: pilSave(crop(40, 52), lossless=True, quality=q))
              for q in (0, 100)]
PIL_CASES += [(f"{h}x{w} {kind}", lambda h=h, w=w, kw=kw: pilSave(crop(h, w), **kw))
              for h, w in ((1, 1), (1, 7), (7, 1), (2, 2), (3, 17), (17, 3), (33, 65))
              for kind, kw in (("lossy", dict(quality=75)), ("lossless", dict(lossless=True)))]
PIL_CASES += [
    ("lossy alpha", lambda: pilSave(withAlpha(48, 64), quality=80)),
    ("lossy alpha_quality 0", lambda: pilSave(withAlpha(48, 64), quality=80, alpha_quality=0)),
    ("lossy alpha_quality 50", lambda: pilSave(withAlpha(48, 64), quality=80, alpha_quality=50)),
    ("lossy alpha exact", lambda: pilSave(withAlpha(48, 64), quality=60, exact=True)),
    ("lossless alpha", lambda: pilSave(withAlpha(48, 64), lossless=True)),
    ("lossless alpha exact", lambda: pilSave(withAlpha(48, 64), lossless=True, exact=True)),
    ("lossy 4-colour palette", lambda: pilSave(crop(32, 48) // 128 * 255, lossless=True)),
    ("lossy ICC EXIF XMP", lambda: pilSave(crop(32, 40), quality=80, icc_profile=b"\0" * 128,
                                           exif=b"Exif\0\0II*\0\x08\0\0\0\0\0", xmp=b"<x/>")),
    ("animated lossy", lambda: _saveAll([crop(40, 48, 10 * i, 20 * i) for i in range(3)])),
    ("animated lossless", lambda: _saveAll([crop(40, 48, 10 * i, 20 * i) for i in range(3)],
                                           lossless=True)),
    ("animated alpha", lambda: _saveAll([withAlpha(40, 48, 10 * i, 20 * i) for i in range(2)],
                                        quality=70)),
    ("frame 0 inside the canvas", lambda: animated(
        [(pilSave(crop(24, 30), lossless=True), 6, 10, 30, 24),
         (pilSave(crop(20, 20, 300, 300), quality=70), 0, 0, 20, 20)], (48, 40))),
    ("lossy alpha frame inside the canvas", lambda: animated(
        [(pilSave(withAlpha(16, 22), quality=60), 4, 2, 22, 16)], (32, 30))),
]


@pytest.mark.parametrize("name,make", PIL_CASES, ids=[c[0] for c in PIL_CASES])
def test_decode_equals_pil(name, make):
    data = make()
    want = pilRgba(data)
    np.testing.assert_array_equal(readWebpRgba(data), want)
    np.testing.assert_array_equal(readWebp(data), pilRgb(data))


CTYPES_CASES = [
    ("simple filter", dict(filter_type=0, filter_strength=60), True),
    ("simple filter, sharpness 7", dict(filter_type=0, filter_strength=100, filter_sharpness=7), True),
    ("2 partitions", dict(partitions=1, method=0), True),
    ("4 partitions", dict(partitions=2, method=0), True),
    ("8 partitions, simple filter", dict(partitions=3, method=0, filter_type=0, filter_strength=40), True),
    ("1 segment", dict(segments=1), True),
    ("2 segments", dict(segments=2), True),
    ("4 segments, sns 0", dict(segments=4, sns_strength=0), True),
    ("sharpness 3", dict(filter_sharpness=3, filter_strength=80), True),
    ("filter off", dict(filter_strength=0), True),
    ("autofilter", dict(autofilter=1), False),
    ("lossless near_lossless 60", dict(lossless=1, near_lossless=60), True),
]


@pytest.mark.parametrize("name,settings,changes", CTYPES_CASES, ids=[c[0] for c in CTYPES_CASES])
def test_decode_equals_pil_on_settings_pillow_does_not_expose(name, settings, changes):
    """Each setting changes the bytes (so the branch it reaches is in the
    file), and the port decodes them as PIL does."""
    img = crop(96, 112, 200, 330)
    data = encodeWebp(img, 60.0, **settings)
    if changes:
        plain = encodeWebp(img, 60.0, **{k: v for k, v in settings.items() if k in ("lossless", "method")})
        assert data != plain
    np.testing.assert_array_equal(readWebpRgba(data), pilRgba(data))


def _fuzzed(data: bytes, seed: int, count: int):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(12, len(b)))] = int(rng.integers(0, 256))
        if rng.random() < 0.3:
            b = b[:int(rng.integers(0, len(b)))]
        yield bytes(b)


CORRUPTED = [("lossy", lambda: pilSave(crop(40, 48), quality=75)),
             ("lossless", lambda: pilSave(crop(24, 32), lossless=True)),
             ("lossy alpha", lambda: pilSave(withAlpha(24, 32), quality=75)),
             ("lossless alpha", lambda: pilSave(withAlpha(24, 32), lossless=True)),
             ("animated", lambda: _saveAll([crop(24, 32, 10 * i, 20 * i) for i in range(2)]))]


@pytest.mark.parametrize("kind,make", CORRUPTED, ids=[c[0] for c in CORRUPTED])
def test_corrupt_files_never_crash_the_decoder(kind, make):
    """Byte flips and cuts: the decoder raises ValueError or decodes; every
    file PIL fails on decodes to None through `_decodeImage`, every file PIL
    reads decodes to PIL's RGB."""
    outcomes = set()
    for data in _fuzzed(make(), zlib.crc32(kind.encode()), 150):
        try:
            want = pilRgb(data)
        except Exception:
            want = None
        got = _decodeImage(data, "member.webp")
        if want is None:
            assert got is None
            outcomes.add("failed")
        else:
            np.testing.assert_array_equal(got, want)
            outcomes.add("decoded")
    assert "failed" in outcomes


@pytest.mark.parametrize("cut", [1, 7, 100, 12, 30])
def test_truncated_file_decodes_to_none(cut):
    data = pilSave(crop(40, 48), quality=75)
    short = data[:len(data) - cut] if cut < 12 else data[:cut]
    with pytest.raises(Exception):
        pilRgb(short)
    with pytest.raises(ValueError):
        readWebp(short, "short.webp")
    assert _decodeImage(short, "short.webp") is None


# ------------------------------------------------------------------ fixture
def _sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8).tobytes()).hexdigest()


FIXTURE_FILES = {
    "photo_q80.webp": lambda: pilSave(PHOTO),
    "photo_lossless.webp": lambda: pilSave(PHOTO, lossless=True),
    "lossless.webp": lambda: pilSave(crop(48, 64, 40, 500), lossless=True),
    "lossy_alpha.webp": lambda: pilSave(withAlpha(40, 56, 300, 100), quality=80),
    "lossless_alpha.webp": lambda: pilSave(withAlpha(40, 56, 200, 600), lossless=True, exact=True),
    "odd_37x29.webp": lambda: pilSave(crop(37, 29, 10, 10), quality=90),
    "animated.webp": lambda: _saveAll([crop(32, 40, 10 * i + 400, 20 * i) for i in range(3)]),
    "simple_filter_partitions.webp": lambda: encodeWebp(crop(64, 80, 150, 420), 70.0, filter_type=0,
                                                        filter_strength=50, partitions=2, method=0),
    "segments_sharpness.webp": lambda: encodeWebp(crop(64, 80, 350, 60), 50.0, segments=2,
                                                  filter_sharpness=5),
}


def writeFixture(folder: Path = FIXTURE):
    """The card's WebP fixture: the files, the full-size photo at PIL's
    default quality and lossless among them, and a manifest of the SHA-256 of PIL's RGB
    decode of each. Rewrite `tests/golden/torch_webp/` with it only if the
    files change."""
    folder.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, make in FIXTURE_FILES.items():
        data = make()
        (folder / name).write_bytes(data)
        decoded = pilRgb(data)
        manifest[name] = {"shape": list(decoded.shape), "sha256": _sha(decoded)}
    (folder / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")


def test_fixture_manifest_is_pils_decode_and_the_ports():
    from mcquic_tpu.data.dataset import _decodeImage as jaxDecodeImage
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    assert sorted(manifest) == sorted(FIXTURE_FILES)
    assert sum(p.stat().st_size for p in FIXTURE.iterdir()) < 500_000
    for name, entry in manifest.items():
        data = (FIXTURE / name).read_bytes()
        theirs = pilRgb(data)
        assert list(theirs.shape) == entry["shape"] and _sha(theirs) == entry["sha256"], name
        assert _sha(readWebp(data, name)) == entry["sha256"], name
        np.testing.assert_array_equal(_decodeImage(data, name), jaxDecodeImage(data))
