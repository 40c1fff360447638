"""Entropy coding: per-level [m, k] frequency tables -> quantized CDFs ->
rANS streams (counterpart of `mcquic_tpu/coding/__init__.py::RansCoder`,
reference `mcquic/modules/entropyCoder.py:95-154`)."""
from typing import List, Sequence, Tuple

import numpy as np

from mcquic_tpu_torch.coding import rans
from mcquic_tpu_torch.container import CodeSize

PRECISION = 16


class RansCoder:
    """Entropy coder over per-level frequency tables; m groups and k
    codewords per level."""

    def __init__(self, m: Sequence[int], k: Sequence[int]):
        self._m = [int(x) for x in m]
        self._k = [int(x) for x in k]
        self._freq = [np.full((mi, ki), 1.0 / ki) for mi, ki in zip(self._m, self._k)]
        self._cdfMats = None
        self._cdfSizes = None
        self._luts = None

    def updateFreq(self, freqEMA: Sequence[np.ndarray]):
        """Install per-level [m, k] frequency tables; the CDFs are rebuilt lazily."""
        if len(freqEMA) != len(self._k):
            raise ValueError("level count mismatch")
        self._freq = [np.asarray(f, dtype=np.float64) for f in freqEMA]
        self._cdfMats = self._cdfSizes = self._luts = None

    @property
    def NormalizedFreq(self) -> List[np.ndarray]:
        """Per-level [m, k] code probabilities: each row of the frequency
        table over its sum (`mcquic_tpu/coding/__init__.py:57`)."""
        return [f / f.sum(-1, keepdims=True) for f in self._freq]

    def _ensureCdfs(self, needLuts: bool = False):
        if self._cdfMats is None:
            self._cdfMats, self._cdfSizes = [], []
            for freq, ki in zip(self.NormalizedFreq, self._k):
                # stride k+2: the escape sentinel never fires for in-range codes
                mat = np.zeros((freq.shape[0], ki + 2), dtype=np.int32)
                for g in range(freq.shape[0]):
                    mat[g, :ki + 1] = rans.pmfToQuantizedCDF(
                        freq[g].astype(np.float32).tolist(), PRECISION)
                    mat[g, ki + 1] = 1 << PRECISION
                self._cdfMats.append(mat)
                self._cdfSizes.append(np.full(freq.shape[0], ki + 2, dtype=np.int32))
            self._luts = [None] * len(self._k)
        if needLuts:
            for lv, lut in enumerate(self._luts):
                if lut is None:
                    self._luts[lv] = rans.buildDecodeLuts(self._cdfMats[lv], self._cdfSizes[lv])

    def compress(self, codes: List[np.ndarray]) -> Tuple[List[List[bytes]], List[CodeSize]]:
        """codes per level [n, m, h, w] -> (binaries[n][level], CodeSize per image)."""
        self._ensureCdfs()
        n = codes[0].shape[0]
        heights, widths = [], []
        compressed: List[List[bytes]] = [[] for _ in range(n)]
        for lv, code in enumerate(codes):
            _, mi, h, w = code.shape
            heights.append(h)
            widths.append(w)
            # symbol order is the C-flattened [m, h, w] walk (entropyCoder.py:120)
            indexes = np.repeat(np.arange(mi, dtype=np.int32), h * w)
            flat = np.ascontiguousarray(code.reshape(n, mi * h * w), dtype=np.int32)
            binaries = rans.encodeBatchNp(flat, indexes, self._cdfMats[lv], self._cdfSizes[lv],
                                          np.zeros(mi, dtype=np.int32))
            for i in range(n):
                compressed[i].append(binaries[i])
        return compressed, [CodeSize(list(self._m), heights, widths, list(self._k))
                            for _ in range(n)]

    def decompress(self, binaries: List[List[bytes]], codeSizes: List[CodeSize]) -> List[np.ndarray]:
        """binaries[n][level] -> per level [n, m, h, w] int32."""
        self._ensureCdfs(needLuts=True)
        cs = codeSizes[0]
        out = []
        for lv in range(len(binaries[0])):
            mi, h, w = cs.m[lv], cs.heights[lv], cs.widths[lv]
            indexes = np.repeat(np.arange(mi, dtype=np.int32), h * w)
            decoded = rans.decodeBatchNp([b[lv] for b in binaries], indexes, self._cdfMats[lv],
                                         self._cdfSizes[lv], np.zeros(mi, dtype=np.int32),
                                         luts=self._luts[lv])
            out.append(decoded.reshape(len(binaries), mi, h, w))
        return out
