"""McQuic's v1 codec (CVPR 2022), plain PyTorch, fp32.

An 8x-downsampling encoder, a cascade of codebook levels, each 2x below the
one before, and the mirrored decoder (McQuic `modules/compressor.py:120-177`,
`modules/quantizer.py:368-467`). Level l's latent stage encoder takes the
residual that level l-1's latent head leaves after its codes are taken
out; decoding runs from the smallest level up, each level's side head
adding the level below's restored features.

`latents` is the teacher-forced encode: given the codes a program chose,
it gives every level's tokens with the residual peeled off by *those*
codes, so each level's choice is judged on the input the program saw.
"""
from typing import List, Sequence

import torch
from torch import nn

from perfbench.reference.nn import (AttentionBlock, ResidualBlock, ResidualBlockShuffle,
                                    ResidualBlockWithStride, UpConv, conv, dequantize, nearest,
                                    toTokens)


class _Codebook(nn.Module):
    def __init__(self, m: int, k: int, d: int):
        super().__init__()
        self._codebook = nn.Parameter(torch.zeros(m, k, d))
        self._temperature = nn.Parameter(torch.ones(m, 1, 1, 1))


class _LevelEncoder(nn.Module):
    def __init__(self, c: int, m: int, k: int, last: bool):
        super().__init__()
        self._latentStageEncoder = nn.Sequential(ResidualBlockWithStride(c), ResidualBlock(c),
                                                 AttentionBlock(c))
        self._quantizationHead = nn.Sequential(ResidualBlock(c), AttentionBlock(c), conv(c, c, 3))
        self._latentHead = None if last else nn.Sequential(ResidualBlock(c), AttentionBlock(c),
                                                           conv(c, c, 3))
        self._quantizer = _Codebook(m, k, c // m)


class _LevelDecoder(nn.Module):
    def __init__(self, c: int, last: bool):
        super().__init__()
        self._dequantizationHead = nn.Sequential(AttentionBlock(c), conv(c, c, 3), ResidualBlock(c))
        self._sideHead = None if last else nn.Sequential(AttentionBlock(c), conv(c, c, 3),
                                                         ResidualBlock(c))
        self._restoreHead = nn.Sequential(AttentionBlock(c), ResidualBlock(c),
                                          ResidualBlockShuffle(c))


class _Frequencies(nn.Module):
    def __init__(self, m: int, k: Sequence[int]):
        super().__init__()
        self._freqEMA = nn.ParameterList([nn.Parameter(torch.ones(m, ki), requires_grad=False)
                                          for ki in k])


class _Quantizer(nn.Module):
    def __init__(self, c: int, m: int, k: Sequence[int]):
        super().__init__()
        L = len(k)
        self._encoders = nn.ModuleList([_LevelEncoder(c, m, ki, i == L - 1)
                                        for i, ki in enumerate(k)])
        self._decoders = nn.ModuleList([_LevelDecoder(c, i == L - 1) for i in range(L)])
        self._entropyCoder = _Frequencies(m, k)


class Compressor(nn.Module):
    def __init__(self, channel: int, m: int, k: Sequence[int]):
        super().__init__()
        c = channel
        self.m, self.k = m, list(k)
        self._encoder = nn.Sequential(
            conv(3, c, 3, 2), ResidualBlock(c), ResidualBlockWithStride(c), AttentionBlock(c),
            ResidualBlock(c), ResidualBlockWithStride(c), ResidualBlock(c))
        self._decoder = nn.Sequential(
            ResidualBlock(c), ResidualBlockShuffle(c), AttentionBlock(c), ResidualBlock(c),
            ResidualBlockShuffle(c), ResidualBlock(c), UpConv(c, 3))
        self._quantizer = _Quantizer(c, m, k)

    def codebook(self, level: int) -> torch.Tensor:
        return self._quantizer._encoders[level]._quantizer._codebook

    def frequencies(self) -> List[torch.Tensor]:
        return list(self._quantizer._entropyCoder._freqEMA)

    def latents(self, x: torch.Tensor, codes: Sequence[torch.Tensor] = None
                ) -> List[torch.Tensor]:
        """Image [n, 3, H, W] in [-1, 1] -> each level's tokens [m, n*h*w, d].
        Each level's residual is peeled with `codes` where they are given
        (teacher-forced), else with the nearest codewords."""
        y = self._encoder(x)
        tokens = []
        for i, level in enumerate(self._quantizer._encoders):
            z = level._latentStageEncoder(y)
            q = level._quantizationHead(z)
            tokens.append(toTokens(q, self.m))
            if level._latentHead is not None:
                code = codes[i] if codes is not None else self._codes(tokens[-1], i, q.shape)
                y = level._latentHead(z) - dequantize(code, self.codebook(i))
        return tokens

    def _codes(self, tokens, level, shape):
        n, _, h, w = shape
        code = nearest(tokens, self.codebook(level)).argmin(-1)        # [m, n*h*w]
        return code.reshape(self.m, n, h, w).permute(1, 0, 2, 3)

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Image -> per level codes [n, m, h, w] (nearest codewords)."""
        codes, y = [], self._encoder(x)
        for i, level in enumerate(self._quantizer._encoders):
            z = level._latentStageEncoder(y)
            q = level._quantizationHead(z)
            codes.append(self._codes(toTokens(q, self.m), i, q.shape))
            if level._latentHead is not None:
                y = level._latentHead(z) - dequantize(codes[-1], self.codebook(i))
        return codes

    def decode(self, codes: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per level codes [n, m, h, w] -> image [n, 3, H, W], about [-1, 1]."""
        former = None
        for i in reversed(range(len(self.k))):
            level = self._quantizer._decoders[i]
            q = level._dequantizationHead(dequantize(codes[i], self.codebook(i)))
            if level._sideHead is not None and former is not None:
                q = q + level._sideHead(former)
            former = level._restoreHead(q)
        return self._decoder(former)
