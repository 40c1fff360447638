"""The `.mcq` streams' rANS decode, pure Python.

The format: a 64-bit state, a 2^31 renormalization bound, 32-bit words read
forward after the two words of the final state, 16-bit quantized CDFs, and
a 4-bit bypass escape past the top symbol (McQuic's `rans64`-based entropy
coder, `modules/entropyCoder.py:95-154`). Each level's symbols are the
C-order walk of its codes [m, h, w], group g read with group g's CDF.
"""
import bisect
from typing import List, Sequence

import numpy as np

PRECISION = 16
BYPASS_BITS = 4
MAX_BYPASS = (1 << BYPASS_BITS) - 1
RANS_L = 1 << 31


def quantizedCdf(pmf: Sequence[float]) -> List[int]:
    """A pmf -> its 16-bit CDF of len(pmf) + 1 entries, every symbol given
    a frequency of at least 1 (taken from the smallest frequency above 1)."""
    pmf = np.asarray(pmf, dtype=np.float32)
    freq = np.round((pmf * np.float32(1 << PRECISION)).astype(np.float64)).astype(np.uint64)
    cdf = np.zeros(pmf.size + 1, dtype=np.uint64)
    cdf[1:] = freq
    cdf = ((1 << PRECISION) * cdf) // int(cdf.sum())
    cdf = np.cumsum(cdf).astype(np.int64)
    cdf[-1] = 1 << PRECISION
    cdf = cdf.tolist()
    size = len(cdf) - 1
    for i in range(size):
        if cdf[i] == cdf[i + 1]:
            best, steal = None, -1
            for j in range(size):
                f = cdf[j + 1] - cdf[j]
                if f > 1 and (best is None or f < best):
                    best, steal = f, j
            if steal < i:
                for j in range(steal + 1, i + 1):
                    cdf[j] -= 1
            else:
                for j in range(i + 1, steal + 1):
                    cdf[j] += 1
    return cdf


def levelCdfs(frequencies: np.ndarray) -> np.ndarray:
    """A level's code frequencies [m, k] -> CDF rows [m, k + 2]: the k + 1
    entries of each group's normalized frequencies, then the escape's top."""
    freq = np.asarray(frequencies, np.float64)
    freq = freq / freq.sum(-1, keepdims=True)
    m, k = freq.shape
    rows = np.zeros((m, k + 2), np.int64)
    for g in range(m):
        rows[g, :k + 1] = quantizedCdf(freq[g])
        rows[g, k + 1] = 1 << PRECISION
    return rows


def decode(stream: bytes, groups: np.ndarray, cdfs: np.ndarray) -> np.ndarray:
    """One level's stream -> its symbols; `groups` gives each symbol's CDF row.
    Raises ValueError on a stream that ends early or escapes past k."""
    words = np.frombuffer(stream, dtype=np.uint32)
    if words.size < 2:
        raise ValueError("stream shorter than its state")
    words = [int(w) for w in words]
    pos, x = 2, words[0] | (words[1] << 32)
    mask = (1 << PRECISION) - 1
    k = cdfs.shape[1] - 2
    rows = [row.tolist() for row in cdfs]
    out = np.empty(len(groups), np.int64)

    def renorm(x, pos):
        if x < RANS_L and pos < len(words):
            return (x << 32) | words[pos], pos + 1
        return x, pos

    for i, g in enumerate(groups.tolist()):
        cdf = rows[g]
        slot = x & mask
        s = bisect.bisect_right(cdf, slot) - 1
        x = (cdf[s + 1] - cdf[s]) * (x >> PRECISION) + slot - cdf[s]
        x, pos = renorm(x, pos)
        if s == k:
            raise ValueError(f"symbol {i} escapes past the codebook")
        out[i] = s
    if x != RANS_L or pos != len(words):
        raise ValueError("the stream does not end where its symbols do")
    return out
