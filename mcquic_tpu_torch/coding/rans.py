"""ctypes bindings of the native rANS runtime (csrc/mcquic_rans.cpp).

The same bitstream as `mcquic_tpu/coding/rans.py`. There is no Python
fallback: `coding/pyrans.py` is kept only as the tests' golden model.
"""
import ctypes
from typing import List, Optional, Sequence

import numpy as np

_lib = None


def _library():
    global _lib
    if _lib is None:
        from mcquic_tpu_torch.coding.build import loadRansLibrary
        lib = loadRansLibrary()
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        lib.mcq_pmf_to_quantized_cdf.argtypes = [f32p, i32, i32, i32p]
        lib.mcq_pmf_to_quantized_cdf.restype = ctypes.c_int
        lib.mcq_build_decode_lut.argtypes = [i32p, i32, u16p]
        lib.mcq_build_decode_lut.restype = ctypes.c_int
        lib.mcq_encode_with_indexes.argtypes = [i32p, i32p, i64, i32p, i64, i32p, i32p, u8p, i64]
        lib.mcq_encode_with_indexes.restype = i64
        lib.mcq_decode_with_indexes.argtypes = [u8p, i64, i32p, i64, i32p, i64, i32p, i32p,
                                                u16p, i64, i32p]
        lib.mcq_decode_with_indexes.restype = i64
        lib.mcq_encode_batch.argtypes = [i32p, i32p, i64, i64, i32p, i64, i32p, i32p, u8p,
                                         i64, i64p]
        lib.mcq_encode_batch.restype = ctypes.c_int
        lib.mcq_decode_batch.argtypes = [u8p, i64p, i64p, i64, i32p, i64, i32p, i64, i32p,
                                         i32p, u16p, i64, i32p]
        lib.mcq_decode_batch.restype = ctypes.c_int
        _lib = lib
    return _lib


def build():
    """Compile and load the library now (it is otherwise built at first use)."""
    _library()


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def packCdfs(cdfs: Sequence[Sequence[int]]):
    """Ragged CDFs -> a [nCdfs, stride] int32 matrix and their sizes."""
    sizes = np.array([len(c) for c in cdfs], dtype=np.int32)
    mat = np.zeros((len(cdfs), int(sizes.max())), dtype=np.int32)
    for i, c in enumerate(cdfs):
        mat[i, :len(c)] = np.asarray(c, dtype=np.int32)
    return mat, sizes


def pmfToQuantizedCDF(pmf: Sequence[float], precision: int = 16) -> List[int]:
    """Quantized CDF with frequency stealing (reference ops.cpp:42-111)."""
    pmfArr = np.ascontiguousarray(pmf, dtype=np.float32)
    out = np.empty(pmfArr.size + 1, dtype=np.int32)
    rc = _library().mcq_pmf_to_quantized_cdf(_ptr(pmfArr, ctypes.c_float), pmfArr.size,
                                             precision, _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"Invalid pmf (error {rc}): {pmfArr[:8]}...")
    return out.tolist()


def buildDecodeLuts(cdfMat: np.ndarray, cdfSizes: np.ndarray) -> np.ndarray:
    """Per-CDF 2^16 cumFreq -> symbol tables for O(1) decode."""
    lib = _library()
    luts = np.empty((cdfMat.shape[0], 65536), dtype=np.uint16)
    for i in range(cdfMat.shape[0]):
        rc = lib.mcq_build_decode_lut(_ptr(_i32(cdfMat[i]), ctypes.c_int32),
                                      int(cdfSizes[i]), _ptr(luts[i], ctypes.c_uint16))
        if rc != 0:
            raise ValueError("bad cdf for LUT")
    return luts


def encodeNp(symbols, indexes, cdfMat, cdfSizes, offsets) -> bytes:
    """Encode one stream from numpy buffers."""
    symbols, indexes = _i32(symbols).ravel(), _i32(indexes).ravel()
    cdfMat, cdfSizes, offsets = _i32(cdfMat), _i32(cdfSizes), _i32(offsets)
    cap = symbols.size * 8 + 64
    out = np.empty(cap, dtype=np.uint8)
    n = _library().mcq_encode_with_indexes(
        _ptr(symbols, ctypes.c_int32), _ptr(indexes, ctypes.c_int32), symbols.size,
        _ptr(cdfMat, ctypes.c_int32), cdfMat.shape[1], _ptr(cdfSizes, ctypes.c_int32),
        _ptr(offsets, ctypes.c_int32), _ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise RuntimeError("rANS encode buffer overflow")
    return out[:n].tobytes()


def decodeNp(encoded: bytes, indexes, cdfMat, cdfSizes, offsets,
             luts: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode one stream to int32 symbols."""
    indexes = _i32(indexes).ravel()
    cdfMat, cdfSizes, offsets = _i32(cdfMat), _i32(cdfSizes), _i32(offsets)
    buf = np.frombuffer(encoded, dtype=np.uint8)
    out = np.empty(indexes.size, dtype=np.int32)
    lutPtr = _ptr(luts, ctypes.c_uint16) if luts is not None else None
    rc = _library().mcq_decode_with_indexes(
        _ptr(buf, ctypes.c_uint8), buf.size, _ptr(indexes, ctypes.c_int32), indexes.size,
        _ptr(cdfMat, ctypes.c_int32), cdfMat.shape[1], _ptr(cdfSizes, ctypes.c_int32),
        _ptr(offsets, ctypes.c_int32), lutPtr, cdfMat.shape[0], _ptr(out, ctypes.c_int32))
    if rc < 0:
        raise RuntimeError("rANS decode error")
    return out


def encodeBatchNp(symbols, indexes, cdfMat, cdfSizes, offsets) -> List[bytes]:
    """Encode [batch, n] symbol rows sharing indexes and CDFs; one stream per row."""
    symbols = _i32(symbols)
    batch, n = symbols.shape
    indexes = np.ascontiguousarray(np.broadcast_to(_i32(indexes), (batch, n)))
    cdfMat, cdfSizes, offsets = _i32(cdfMat), _i32(cdfSizes), _i32(offsets)
    perCap = n * 8 + 64
    out = np.empty((batch, perCap), dtype=np.uint8)
    sizes = np.empty(batch, dtype=np.int64)
    rc = _library().mcq_encode_batch(
        _ptr(symbols, ctypes.c_int32), _ptr(indexes, ctypes.c_int32), batch, n,
        _ptr(cdfMat, ctypes.c_int32), cdfMat.shape[1], _ptr(cdfSizes, ctypes.c_int32),
        _ptr(offsets, ctypes.c_int32), _ptr(out, ctypes.c_uint8), perCap,
        _ptr(sizes, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError("rANS batch encode failure")
    return [out[b, :sizes[b]].tobytes() for b in range(batch)]


def decodeBatchNp(binaries: List[bytes], indexes, cdfMat, cdfSizes, offsets,
                  luts: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode streams sharing indexes and CDFs -> [batch, n] int32."""
    indexes = _i32(indexes).ravel()
    cdfMat, cdfSizes, offsets = _i32(cdfMat), _i32(cdfSizes), _i32(offsets)
    n, batch = indexes.size, len(binaries)
    blob = np.frombuffer(b"".join(binaries), dtype=np.uint8)
    sizes = np.array([len(b) for b in binaries], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    out = np.empty((batch, n), dtype=np.int32)
    lutPtr = _ptr(luts, ctypes.c_uint16) if luts is not None else None
    rc = _library().mcq_decode_batch(
        _ptr(blob, ctypes.c_uint8), _ptr(offs, ctypes.c_int64), _ptr(sizes, ctypes.c_int64),
        batch, _ptr(indexes, ctypes.c_int32), n, _ptr(cdfMat, ctypes.c_int32), cdfMat.shape[1],
        _ptr(cdfSizes, ctypes.c_int32), _ptr(offsets, ctypes.c_int32), lutPtr,
        cdfMat.shape[0], _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError("rANS batch decode failure")
    return out
