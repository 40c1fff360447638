"""JPEG reading and writing through the port's own codec (`csrc/jpeg.cpp`,
built with g++ into `mcquic_tpu_torch/_build/` at first use and bound through
ctypes, as `coding/rans.py` binds the rANS runtime).

`readJpeg(bytes)` returns RGB uint8 [H, W, 3], bit-identical to
`PIL.Image.open(f).convert("RGB")` on libjpeg-turbo for every file PIL
reads: sequential, progressive (with libjpeg's block smoothing where scans
leave bits unsent) and lossless files, Huffman or arithmetic-coded, of 1, 3
or 4 components (gray, YCbCr, RGB, CMYK, YCCK) with sampling factors up to
4. A file PIL refuses (12-bit, 2 components, hierarchical, lossless with a
colour conversion, and the like) or truncated or corrupt data raises
`ValueError`. `UnsupportedJpeg`, a `ValueError` for a valid file the
decoder does not read, is raised by no branch of the decoder today.

`encodeJpeg(rgb, quality)` returns the bytes `PIL.Image.save(f, "JPEG",
quality=quality)` writes for an RGB image: 4:2:0, the standard tables.

ctypes releases the GIL for the length of a call, so threads decode in
parallel.
"""
import ctypes
import shutil

import numpy as np

from mcquic_tpu_torch.utils.build import CSRC_DIR, GXX_FLAGS, loadLibrary

SOURCE = CSRC_DIR / "jpeg.cpp"
MAGIC = b"\xff\xd8\xff"
_OK, _UNSUPPORTED, _CORRUPT = 0, 1, 2
_ERR_LEN = 256
_lib = None


class UnsupportedJpeg(ValueError):
    """A valid JPEG of a kind the port's decoder does not read."""


def _library():
    global _lib
    if _lib is None:
        compiler = shutil.which("g++")
        if compiler is None:
            raise RuntimeError("g++ not found; the JPEG codec cannot be built.")
        lib = loadLibrary("jpeg", SOURCE, compiler, GXX_FLAGS)
        u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        lib.mcq_jpeg_header.argtypes = [ctypes.c_char_p, i64, i32p, ctypes.c_char_p, i32]
        lib.mcq_jpeg_header.restype = ctypes.c_int
        lib.mcq_jpeg_decode.argtypes = [ctypes.c_char_p, i64, u8p, i64, ctypes.c_char_p, i32]
        lib.mcq_jpeg_decode.restype = ctypes.c_int
        lib.mcq_jpeg_encode.argtypes = [u8p, i32, i32, i32, u8p, i64, ctypes.c_char_p, i32]
        lib.mcq_jpeg_encode.restype = i64
        _lib = lib
    return _lib


def build():
    """Compile and load the library now (it is otherwise built at first use)."""
    _library()


def _raise(status: int, err, name: str):
    message = err.value.decode(errors="replace")
    where = f"{name}: " if name else ""
    if status == _UNSUPPORTED:
        raise UnsupportedJpeg(f"{where}{message}")
    raise ValueError(f"{where}cannot decode the JPEG: {message}")


def readJpeg(data: bytes, name: str = "") -> np.ndarray:
    """RGB uint8 [H, W, 3] of a JPEG file's bytes; `name` (a path or tar
    member) is named in the error of a file that cannot be read."""
    lib = _library()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = np.zeros(3, np.int32)
    status = lib.mcq_jpeg_header(data, len(data), dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                 err, _ERR_LEN)
    if status != _OK:
        _raise(status, err, name)
    out = np.empty((int(dims[0]), int(dims[1]), 3), np.uint8)
    status = lib.mcq_jpeg_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                 out.size, err, _ERR_LEN)
    if status != _OK:
        _raise(status, err, name)
    return out


def encodeJpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """The JPEG bytes of an RGB uint8 [H, W, 3] image at `quality`, 4:2:0."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encodeJpeg takes RGB [H, W, 3], got {rgb.shape}")
    lib = _library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    source = rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    capacity = rgb.size + 65536
    while True:
        out = np.empty(capacity, np.uint8)
        size = lib.mcq_jpeg_encode(source, rgb.shape[0], rgb.shape[1], int(quality),
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), capacity,
                                   err, _ERR_LEN)
        if size < 0:
            raise ValueError(f"cannot encode the JPEG: {err.value.decode(errors='replace')}")
        if size <= capacity:
            return out[:size].tobytes()
        capacity = int(size)
