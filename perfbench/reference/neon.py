"""McQuic's v2 tokenizer (Neon), plain PyTorch, fp32, without GroupNorm.

An 8x-downsampling encoder into an 8-channel latent, a multi-scale residual
quantizer over one shared codebook, and a mirrored decoder (McQuic
`modules/compressor.py:181-233`, `modules/quantizer.py:577-765`). `size`
lists the levels' grids from large to small; codes run small -> large.
Decoding sums each level's dequantized codes into the decoded level below
and runs that level's decoder stack.
"""
from typing import List, Sequence

import torch
from torch import nn

from perfbench.reference.nn import (AttentionBlock, ResidualBlock, ResidualBlockShuffle,
                                    ResidualBlockWithStride, conv, dequantize, nearest, toTokens)

LATENT = 8


def _encStack(halving: bool) -> nn.Sequential:
    wide = 4 * LATENT
    return nn.Sequential(ResidualBlock(LATENT, wide), AttentionBlock(wide),
                         ResidualBlockWithStride(wide) if halving else ResidualBlock(wide),
                         conv(wide, LATENT, 1, bias=False))


def _upStack(halving: bool) -> nn.Sequential:
    wide = 4 * LATENT
    return nn.Sequential(conv(LATENT, wide, 1, bias=False),
                         ResidualBlockShuffle(wide) if halving else ResidualBlock(wide),
                         AttentionBlock(wide), ResidualBlock(wide, LATENT))


class _Level(nn.Module):
    def __init__(self, k: int = 0):
        super().__init__()
        if k:
            self._codebook = nn.Parameter(torch.zeros(1, k, LATENT))
        self._temperature = nn.Parameter(torch.ones(1, 1, 1, 1))


class _Frequencies(nn.Module):
    def __init__(self, k: int, levels: int):
        super().__init__()
        self._freqEMA = nn.ParameterList([nn.Parameter(torch.ones(1, k), requires_grad=False)
                                          for _ in range(levels)])


class _Quantizer(nn.Module):
    def __init__(self, k: int, size: Sequence[int]):
        super().__init__()
        L = len(size)
        # the largest level halves the encoder's latent; each other level
        # halves the grid before it or keeps it
        halving = [True] + [size[i] == size[i - 1] // 2 for i in range(1, L)]
        self.halving = halving
        self._encoders = nn.ModuleList([_encStack(h) for h in halving])
        self._backwards = nn.ModuleList([_upStack(h) for h in halving[:-1]] + [nn.Identity()])
        self._decoders = nn.ModuleList([_upStack(h) for h in halving])
        self._quantizers = nn.ModuleList([_Level(k)] + [_Level() for _ in range(L - 1)])
        self._entropyCoder = _Frequencies(k, L)


class Neon(nn.Module):
    def __init__(self, channel: int, k: int, size: Sequence[int]):
        super().__init__()
        c = channel
        self.size = list(size)
        self._encoder = nn.Sequential(
            conv(3, c, 3), AttentionBlock(c), ResidualBlock(c), ResidualBlock(c),
            ResidualBlockWithStride(c), ResidualBlock(c), ResidualBlockWithStride(c),
            ResidualBlock(c), ResidualBlockWithStride(c), AttentionBlock(c), ResidualBlock(c, 2 * c),
            ResidualBlock(2 * c), ResidualBlock(2 * c), ResidualBlock(2 * c),
            ResidualBlock(2 * c, LATENT), AttentionBlock(LATENT))
        self._decoder = nn.Sequential(
            AttentionBlock(LATENT), ResidualBlock(LATENT, 2 * c), ResidualBlock(2 * c),
            ResidualBlock(2 * c), ResidualBlock(2 * c), ResidualBlock(2 * c, c), AttentionBlock(c),
            ResidualBlock(c), ResidualBlockShuffle(c), ResidualBlock(c), ResidualBlockShuffle(c),
            ResidualBlock(c), ResidualBlockShuffle(c), ResidualBlock(c), ResidualBlock(c),
            AttentionBlock(c), conv(c, 3, 3))
        self._quantizer = _Quantizer(k, size)

    @property
    def codebook(self) -> torch.Tensor:
        return self._quantizer._quantizers[0]._codebook

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Image [n, 3, H, W] -> codes small -> large, each [n, 1, h, w]:
        top-down residual peeling with the nearest codewords."""
        q = self._quantizer
        latents, y = [], self._encoder(x)
        for enc in q._encoders:
            y = enc(y)
            latents.append(y)
        codes, current = [], torch.zeros_like(latents[-1])
        for i in reversed(range(len(self.size))):
            n, _, h, w = latents[i].shape
            code = nearest(toTokens(latents[i] - current, 1), self.codebook).argmin(-1)
            codes.append(code.reshape(n, 1, h, w))
            current = q._backwards[i](dequantize(codes[-1], self.codebook))
        return codes

    def decodeLatent(self, codes: Sequence[torch.Tensor]) -> torch.Tensor:
        """Codes small -> large -> the 8-channel latent."""
        q, L, former = self._quantizer, len(self.size), None
        for level, code in enumerate(codes):
            quantized = dequantize(code, self.codebook)
            if former is not None:
                quantized = quantized + former
            former = q._decoders[L - 1 - level](quantized)
        return former

    def decode(self, codes: Sequence[torch.Tensor]) -> torch.Tensor:
        """Codes small -> large -> image [n, 3, H, W], about [-1, 1]."""
        return self._decoder(self.decodeLatent(codes))
