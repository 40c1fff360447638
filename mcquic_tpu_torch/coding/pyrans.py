"""Pure-python golden model of the rANS bitstream.

Implements exactly the same format as csrc/mcquic_rans.cpp (64-bit state,
2^31 renorm bound, backwards 32-bit word stream, 16-bit precision, 4-bit
bypass escapes). The port uses it only as the cross-check oracle in tests:
the codec itself always runs the native library (coding/rans.py), and a
failed build raises.
"""
from typing import List, Sequence

import numpy as np

PRECISION = 16
BYPASS_BITS = 4
MAX_BYPASS = (1 << BYPASS_BITS) - 1
RANS_L = 1 << 31
MASK32 = 0xFFFFFFFF


def pmfToQuantizedCDF(pmf: Sequence[float], precision: int = 16) -> List[int]:
    pmf = np.asarray(pmf, dtype=np.float64)
    if np.any(~np.isfinite(pmf)) or np.any(pmf < 0):
        raise ValueError("Invalid pmf: non-finite or negative element.")
    # NOTE: match float32 rounding of the native path (multiply in float32,
    # then round — this is what `std::round(p * (1 << precision))` does).
    freq = np.round((pmf.astype(np.float32) * np.float32(1 << precision)).astype(np.float64)).astype(np.uint64)
    cdf = np.zeros(pmf.size + 1, dtype=np.uint64)
    cdf[1:] = freq
    total = int(cdf.sum())
    if total == 0:
        raise ValueError("Invalid pmf: all-zero.")
    cdf = ((1 << precision) * cdf) // total
    cdf = np.cumsum(cdf).astype(np.int64)
    cdf[-1] = 1 << precision
    cdf = cdf.tolist()
    size = len(cdf) - 1
    for i in range(size):
        if cdf[i] == cdf[i + 1]:
            # steal from the smallest frequency > 1
            bestFreq, bestSteal = None, -1
            for j in range(size):
                f = cdf[j + 1] - cdf[j]
                if f > 1 and (bestFreq is None or f < bestFreq):
                    bestFreq, bestSteal = f, j
            if bestSteal < 0:
                raise ValueError("Cannot repair cdf.")
            if bestSteal < i:
                for j in range(bestSteal + 1, i + 1):
                    cdf[j] -= 1
            else:
                for j in range(i + 1, bestSteal + 1):
                    cdf[j] += 1
    assert cdf[0] == 0 and cdf[-1] == (1 << precision)
    return [int(c) for c in cdf]


def encodeWithIndexes(symbols, indexes, cdfMat, cdfSizes, offsets) -> bytes:
    symbols = np.asarray(symbols, dtype=np.int64).ravel()
    indexes = np.asarray(indexes, dtype=np.int64).ravel()
    cdfMat = np.asarray(cdfMat, dtype=np.int64)
    cdfSizes = np.asarray(cdfSizes, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)

    syms = []  # (start, rangeOrBits, isBypass)
    for i in range(symbols.size):
        ci = int(indexes[i])
        cdf = cdfMat[ci]
        maxValue = int(cdfSizes[ci]) - 2
        value = int(symbols[i]) - int(offsets[ci])
        rawVal = 0
        if value < 0:
            rawVal = -2 * value - 1
            value = maxValue
        elif value >= maxValue:
            rawVal = 2 * (value - maxValue)
            value = maxValue
        syms.append((int(cdf[value]), int(cdf[value + 1] - cdf[value]), False))
        if value == maxValue:
            nBypass = 0
            while (rawVal >> (nBypass * BYPASS_BITS)) != 0:
                nBypass += 1
            val = nBypass
            while val >= MAX_BYPASS:
                syms.append((MAX_BYPASS, MAX_BYPASS + 1, True))
                val -= MAX_BYPASS
            syms.append((val, val + 1, True))
            for j in range(nBypass):
                chunk = (rawVal >> (j * BYPASS_BITS)) & MAX_BYPASS
                syms.append((chunk, chunk + 1, True))

    x = RANS_L
    words: List[int] = []
    for start, rng, bypass in reversed(syms):
        if not bypass:
            freq = rng
            xMax = ((RANS_L >> PRECISION) << 32) * freq
            if x >= xMax:
                words.append(x & MASK32)
                x >>= 32
            x = ((x // freq) << PRECISION) + (x % freq) + start
        else:
            freq = 1 << (PRECISION - BYPASS_BITS)
            xMax = ((RANS_L >> PRECISION) << 32) * freq
            if x >= xMax:
                words.append(x & MASK32)
                x >>= 32
            x = (x << BYPASS_BITS) | start
    stream = [x & MASK32, (x >> 32) & MASK32] + words[::-1]
    return np.asarray(stream, dtype=np.uint32).tobytes()


def decodeWithIndexes(encoded: bytes, indexes, cdfMat, cdfSizes, offsets) -> np.ndarray:
    indexes = np.asarray(indexes, dtype=np.int64).ravel()
    cdfMat = np.asarray(cdfMat, dtype=np.int64)
    cdfSizes = np.asarray(cdfSizes, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    words = np.frombuffer(encoded, dtype=np.uint32)
    pos = 2
    x = int(words[0]) | (int(words[1]) << 32)
    out = np.empty(indexes.size, dtype=np.int32)
    mask = (1 << PRECISION) - 1
    for i in range(indexes.size):
        ci = int(indexes[i])
        cdf = cdfMat[ci]
        maxValue = int(cdfSizes[ci]) - 2
        cumFreq = x & mask
        # first index with cdf > cumFreq, minus one
        s = int(np.searchsorted(cdf[:int(cdfSizes[ci])], cumFreq, side="right")) - 1
        start, freq = int(cdf[s]), int(cdf[s + 1] - cdf[s])
        x = freq * (x >> PRECISION) + (x & mask) - start
        if x < RANS_L and pos < words.size:
            x = (x << 32) | int(words[pos])
            pos += 1
        value = s
        if value == maxValue:
            def getBits(x, pos):
                val = x & MAX_BYPASS
                x >>= BYPASS_BITS
                if x < RANS_L and pos < words.size:
                    x = (x << 32) | int(words[pos])
                    pos += 1
                return val, x, pos

            val, x, pos = getBits(x, pos)
            nBypass = val
            while val == MAX_BYPASS:
                val, x, pos = getBits(x, pos)
                nBypass += val
            rawVal = 0
            for j in range(nBypass):
                val, x, pos = getBits(x, pos)
                rawVal |= val << (j * BYPASS_BITS)
            value = rawVal >> 1
            if rawVal & 1:
                value = -value - 1
            else:
                value += maxValue
        out[i] = value + int(offsets[ci])
    return out
