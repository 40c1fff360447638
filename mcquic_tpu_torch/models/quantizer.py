"""The v1 cascaded multi-codebook quantizer, inference half.

Counterpart of `mcquic_tpu/models/quantizer.py::UMGMQuantizer.encode/decode`
(reference `mcquic/modules/quantizer.py:368-467`), named like the reference
state dict: `_encoders.L` hold `_latentStageEncoder`, `_quantizationHead`,
`_latentHead` and `_quantizer._codebook/_temperature`; `_decoders.L` hold
`_dequantizationHead`, `_sideHead` and `_restoreHead`; the entropy coder's
frequency tables are `_entropyCoder._freqEMA.L`. The last level has no
latent head and no side head.

Encoding calls `ops/vq.py::vqEncode` once per level, all m groups in one
call: kernel K1 on CUDA.
"""
from typing import Callable, List, Mapping, Sequence

import torch
from torch import nn

from mcquic_tpu_torch.ops.vq import groupLatent, vqDequantizeCodes, vqEncode


class _CodebookQuantizer(nn.Module):
    def __init__(self, m: int, k: int, d: int):
        super().__init__()
        self._codebook = nn.Parameter(torch.zeros(m, k, d))
        self._temperature = nn.Parameter(torch.ones(m, 1, 1, 1))


class _LevelEncoder(nn.Module):
    def __init__(self, m: int, k: int, d: int, latentStageEncoder: nn.Module,
                 quantizationHead: nn.Module, latentHead):
        super().__init__()
        self._latentStageEncoder = latentStageEncoder
        self._quantizationHead = quantizationHead
        self._latentHead = latentHead
        self._quantizer = _CodebookQuantizer(m, k, d)


class _LevelDecoder(nn.Module):
    def __init__(self, dequantizationHead: nn.Module, sideHead, restoreHead: nn.Module):
        super().__init__()
        self._dequantizationHead = dequantizationHead
        self._sideHead = sideHead
        self._restoreHead = restoreHead


class _EntropyCoderState(nn.Module):
    """Per-level [m, k] code frequencies that the rANS coder's CDFs come from."""

    def __init__(self, m: int, k: Sequence[int]):
        super().__init__()
        self._freqEMA = nn.ParameterList(
            [nn.Parameter(torch.full((m, ki), 1.0 / ki), requires_grad=False) for ki in k])


class UMGMQuantizer(nn.Module):
    """`components` maps the six head names to factories; each level builds
    fresh heads."""

    def __init__(self, channel: int, m: int, k: Sequence[int],
                 components: Mapping[str, Callable[[], nn.Module]]):
        super().__init__()
        self.m = m
        self.k = list(k)
        d = channel // m
        levels = len(self.k)
        self._encoders = nn.ModuleList([
            _LevelEncoder(m, ki, d, components["latentStageEncoder"](),
                          components["quantizationHead"](),
                          components["latentHead"]() if i < levels - 1 else None)
            for i, ki in enumerate(self.k)])
        self._decoders = nn.ModuleList([
            _LevelDecoder(components["dequantizationHead"](),
                          components["sideHead"]() if i < levels - 1 else None,
                          components["restoreHead"]())
            for i in range(levels)])
        self._entropyCoder = _EntropyCoderState(m, self.k)

    def codebook(self, level: int) -> torch.Tensor:
        return self._encoders[level]._quantizer._codebook

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [n, c, h, w] -> per level codes [n, m, h_l, w_l] (quantizer.py:411-420)."""
        codes = []
        for i, level in enumerate(self._encoders):
            z = level._latentStageEncoder(x)
            q = level._quantizationHead(z)
            code = vqEncode(groupLatent(q, self.m), self.codebook(i))
            codes.append(code)
            if level._latentHead is not None:
                x = level._latentHead(z) - vqDequantizeCodes(code, self.codebook(i))
        return codes

    def decode(self, codes: Sequence[torch.Tensor]) -> torch.Tensor:
        """per level codes -> yHat [n, c, h, w] (quantizer.py:422-428)."""
        formerLevel = None
        for i in reversed(range(len(self.k))):
            level = self._decoders[i]
            q = level._dequantizationHead(vqDequantizeCodes(codes[i], self.codebook(i)))
            if level._sideHead is not None and formerLevel is not None:
                q = q + level._sideHead(formerLevel)
            formerLevel = level._restoreHead(q)
        return formerLevel

    def frequencies(self) -> List[torch.Tensor]:
        return list(self._entropyCoder._freqEMA)
