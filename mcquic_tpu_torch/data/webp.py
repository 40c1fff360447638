"""WebP reading through the port's own decoder (`csrc/webp.cpp`, built with
g++ into `mcquic_tpu_torch/_build/` at first use and bound through ctypes,
as `data/jpeg.py` binds the JPEG codec).

`readWebp(bytes)` returns RGB uint8 [H, W, 3], bit-identical to
`PIL.Image.open(f).convert("RGB")` on libwebp (which Pillow reads through
`WebPAnimDecoder`): lossy (VP8) and lossless (VP8L) files, simple and
extended, with alpha (ALPH) or without, and the first frame of an animation
on its canvas. `readWebpRgba` returns the RGBA PIL holds before `convert`.
A file libwebp refuses, truncated or corrupt data raises `ValueError`.

ctypes releases the GIL for the length of a call, so threads decode in
parallel.
"""
import ctypes
import shutil

import numpy as np

from mcquic_tpu_torch.utils.build import CSRC_DIR, GXX_FLAGS, loadLibrary

SOURCE = CSRC_DIR / "webp.cpp"
_OK = 0
_ERR_LEN = 256
_lib = None


def isWebp(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _library():
    global _lib
    if _lib is None:
        compiler = shutil.which("g++")
        if compiler is None:
            raise RuntimeError("g++ not found; the WebP decoder cannot be built.")
        lib = loadLibrary("webp", SOURCE, compiler, GXX_FLAGS)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        lib.mcq_webp_header.argtypes = [ctypes.c_char_p, i64, i32p, ctypes.c_char_p, i32]
        lib.mcq_webp_header.restype = ctypes.c_int
        lib.mcq_webp_decode.argtypes = [ctypes.c_char_p, i64, ctypes.POINTER(ctypes.c_uint8), i64,
                                        ctypes.c_char_p, i32]
        lib.mcq_webp_decode.restype = ctypes.c_int
        _lib = lib
    return _lib


def build():
    """Compile and load the library now (it is otherwise built at first use)."""
    _library()


def _raise(err, name: str):
    where = f"{name}: " if name else ""
    raise ValueError(f"{where}cannot decode the WebP: {err.value.decode(errors='replace')}")


def readWebpRgba(data: bytes, name: str = "") -> np.ndarray:
    """RGBA uint8 [H, W, 4] of a WebP file's bytes (frame 0 on its canvas);
    `name` (a path or tar member) is named in the error of a file that
    cannot be read."""
    lib = _library()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = np.zeros(2, np.int32)
    status = lib.mcq_webp_header(data, len(data), dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                 err, _ERR_LEN)
    if status != _OK:
        _raise(err, name)
    out = np.empty((int(dims[0]), int(dims[1]), 4), np.uint8)
    status = lib.mcq_webp_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                 out.size, err, _ERR_LEN)
    if status != _OK:
        _raise(err, name)
    return out


def readWebp(data: bytes, name: str = "") -> np.ndarray:
    """RGB uint8 [H, W, 3] of a WebP file's bytes: PIL's `convert("RGB")`,
    which drops alpha."""
    return np.ascontiguousarray(readWebpRgba(data, name)[..., :3])
