"""The quantizers.

`UMGMQuantizer` is the v1 cascade and `ResidualBackwardQuantizer` the v2
(Neon) multi-scale residual quantizer, described at its class; both with
their training forward.

Counterpart of `mcquic_tpu/models/quantizer.py::UMGMQuantizer.encode/decode`
(reference `mcquic/modules/quantizer.py:368-467`), named like the reference
state dict: `_encoders.L` hold `_latentStageEncoder`, `_quantizationHead`,
`_latentHead` and `_quantizer._codebook/_temperature`; `_decoders.L` hold
`_dequantizationHead`, `_sideHead` and `_restoreHead`; the entropy coder's
frequency tables are `_entropyCoder._freqEMA.L`. The last level has no
latent head and no side head.

Encoding calls `ops/vq.py::vqEncode` once per level, all m groups in one
call: kernel K1 on CUDA. The training forward (`UMGMQuantizer.forward`,
`quantizer.py:149-178`) computes logits, samples hard Gumbel-softmax codes
with the frequency-biased drop, decodes the soft samples through the heads,
and, in training mode, moves `freqEMA` toward this batch's code counts (ema
0.9; the global batch's under data parallelism, `emaUpdates`). Its uniforms come from a `draw` function (`ops/vq.py::draws`), called
per level for the drop, then for the Gumbel noise, in the order the JAX
package draws them.
"""
from typing import Callable, List, Mapping, Sequence, Tuple

import torch
from torch import nn

from mcquic_tpu_torch import parallel
from mcquic_tpu_torch.nn import (AttentionBlock, ResidualBlock, ResidualBlockShuffle,
                                 ResidualBlockWithStride, conv1x1)
from mcquic_tpu_torch.nn.functional import EPS, gumbelSoftmax, lowerBound
from mcquic_tpu_torch.ops.vq import (Draw, groupLatent, randomDrop, vqDequantizeCodes,
                                     vqDequantizeSoft, vqEncode, vqLogits)

EMA = 0.9


def sample(x: torch.Tensor, codebook: torch.Tensor, temperature: torch.Tensor,
           freqEMA: torch.Tensor, draw: Draw, train: bool
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`_QuantizeCore.sample` (`quantizer.py:50-68`): x [n, m, d, h, w] ->
    (hard sample [n, m, h, w, k], codes [n, m, h, w], logits
    [n, m, h, w, k]); logits scaled by the temperature bounded below at
    eps, dropped by frequency in training."""
    logit = vqLogits(x, codebook)
    logit = logit * lowerBound(temperature, EPS).view(1, -1, 1, 1, 1)
    if train:
        logit = randomDrop(logit, freqEMA, draw(tuple(logit.shape)))
    sampled = gumbelSoftmax(logit, draw(tuple(logit.shape)))
    return sampled, logit.argmax(-1), logit


@torch.no_grad()
def emaUpdates(frequencies: Sequence[torch.Tensor], codes: Sequence[torch.Tensor],
               ema: float = EMA):
    """Each freqEMA [m, k] <- (1 - ema) * the global batch's normalized
    counts of its codes [n, m, h, w] + ema * freqEMA, in place (`_emaCounts`
    / `_emaUpdate`, `quantizer.py:71-78`). Under data parallelism the counts
    are summed over the ranks (one collective for every level) before they
    are normalized, as the JAX package sums the one-hot counts over the
    batch-sharded global batch; every rank then holds the same tables."""
    counts = []
    for freqEMA, code in zip(frequencies, codes):
        m = freqEMA.shape[0]
        index = code.transpose(0, 1).reshape(m, -1).long()
        counts.append(torch.zeros_like(freqEMA).scatter_add_(
            1, index, torch.ones_like(index, dtype=freqEMA.dtype)))
    parallel.allReduceSum_(counts)
    for freqEMA, count in zip(frequencies, counts):
        freqEMA.copy_((1 - ema) * (count / count.sum(-1, keepdim=True)) + ema * freqEMA)


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

    def forward(self, x: torch.Tensor, draw: Draw):
        """Training forward: x [n, c, h, w] -> (yHat [n, c, h, w], codes per
        level [n, m, h_l, w_l], logits per level [n, m, h_l, w_l, k_l])."""
        quantizeds, codes, logits = [], [], []
        for i, level in enumerate(self._encoders):
            z = level._latentStageEncoder(x)
            q = level._quantizationHead(z)
            sampled, code, logit = sample(groupLatent(q, self.m), self.codebook(i),
                                          level._quantizer._temperature,
                                          self._entropyCoder._freqEMA[i], draw, self.training)
            quantized = vqDequantizeSoft(sampled, self.codebook(i))
            quantizeds.append(quantized)
            codes.append(code)
            logits.append(logit)
            if level._latentHead is not None:
                x = level._latentHead(z) - quantized
        formerLevel = None
        for i in reversed(range(len(self.k))):
            level = self._decoders[i]
            q = level._dequantizationHead(quantizeds[i])
            if level._sideHead is not None and formerLevel is not None:
                q = q + level._sideHead(formerLevel)
            formerLevel = level._restoreHead(q)
        if self.training:
            emaUpdates(self.frequencies(), codes)
        return formerLevel, codes, logits


# --------------------------------------------------------------------- v2


def _sequentialEnc(ch: int, halving: bool, denseNorm: bool = False) -> nn.Sequential:
    """A level's encoder stack (`quantizer.py:317-341`): ResB(ch->4ch), Attn,
    ResBStride/2 or ResB, conv1x1(4ch->ch) without bias."""
    wide, dn = 4 * ch, denseNorm
    return nn.Sequential(ResidualBlock(ch, wide, 1, dn), AttentionBlock(wide, 1, dn),
                         ResidualBlockWithStride(wide, 2) if halving
                         else ResidualBlock(wide, wide, 1, dn),
                         conv1x1(wide, ch, bias=False))


def _sequentialUp(ch: int, upsample: bool, denseNorm: bool = False) -> nn.Sequential:
    """A level's backward or decoder stack (`quantizer.py:344-367`):
    conv1x1(ch->4ch) without bias, ResBShuffle*2 or ResB, Attn, ResB(4ch->ch)."""
    wide, dn = 4 * ch, denseNorm
    return nn.Sequential(conv1x1(ch, wide, bias=False),
                         ResidualBlockShuffle(wide, 2) if upsample
                         else ResidualBlock(wide, wide, 1, dn),
                         AttentionBlock(wide, 1, dn), ResidualBlock(wide, ch, 1, dn))


class _LevelQuantizer(nn.Module):
    """Reference `_quantizers.L`: every level has a temperature; the one
    codebook all levels share sits at level 0."""

    def __init__(self, k: int = 0, d: int = 0):
        super().__init__()
        if k:
            self._codebook = nn.Parameter(torch.zeros(1, k, d))
        self._temperature = nn.Parameter(torch.ones(1, 1, 1, 1))


class ResidualBackwardQuantizer(nn.Module):
    """The v2 shared-codebook multi-scale residual quantizer
    (`mcquic_tpu/models/quantizer.py:181-330`, reference
    `mcquic/modules/quantizer.py:577-765`).

    `size` lists each level's latent grid from large to small; every entry
    equals or halves the previous one, and the list ends in an equal pair,
    because the smallest level's backward is the identity. Modules sit in
    construction order (large -> small) under the reference names
    `_encoders.L`, `_backwards.L` (an `nn.Identity` at the last), `_decoders.L`
    and `_quantizers.L`; codes and `_entropyCoder._freqEMA.L` run small ->
    large. Codes are `[n, 1, h, w]`; the nearest-codeword search is
    `ops/vq.py::vqEncode` (kernel K1 on CUDA), d = `channel` = 8.

    The training forward (`quantizer.py:291-330`) peels the residual top-down
    as `encode` does, but each level samples hard Gumbel-softmax codes from
    the temperature-scaled, frequency-dropped logits and carries the soft
    sample's decode down; the decoders then sum bottom-up. Level l of the
    codes (small -> large) uses `_quantizers.{L-1-l}._temperature` (the JAX
    package's stacked row l) and `_freqEMA.{l}`, which training mode moves
    toward the batch's code counts (ema 0.998).
    """

    channel = 8
    EMA = 0.998                      # `quantizer.py:193`; the v1 cascade's is 0.9

    def __init__(self, k: int, size: Sequence[int], denseNorm: bool = False):
        super().__init__()
        self.k = k
        self.size = list(size)
        L = len(self.size)
        if L >= 2 and self.size[-1] != self.size[-2]:
            raise ValueError(f"size {tuple(self.size)} must end with an equal pair (e.g. ...,16,16): "
                             "the smallest level's backward is identity, so size[-1] must equal "
                             "size[-2]")
        ch = self.channel
        encoders, backwards, decoders = [], [], []
        lastSize = self.size[0] * 2
        for i, thisSize in enumerate(self.size):
            if thisSize not in (lastSize, lastSize // 2):
                raise ValueError("The given size sequence does not half or equal from left to right.")
            halving = thisSize == lastSize // 2
            encoders.append(_sequentialEnc(ch, halving, denseNorm))
            backwards.append(_sequentialUp(ch, halving, denseNorm) if i < L - 1
                             else nn.Identity())
            decoders.append(_sequentialUp(ch, halving, denseNorm))
            lastSize = thisSize
        self._encoders = nn.ModuleList(encoders)
        self._backwards = nn.ModuleList(backwards)
        self._decoders = nn.ModuleList(decoders)
        self._quantizers = nn.ModuleList([_LevelQuantizer(k, ch)] +
                                         [_LevelQuantizer() for _ in range(L - 1)])
        self._entropyCoder = _EntropyCoderState(1, [k] * L)

    @property
    def codebook(self) -> torch.Tensor:
        return self._quantizers[0]._codebook

    def frequencies(self) -> List[torch.Tensor]:
        """[1, k] per level, in the order of the codes (small -> large)."""
        return list(self._entropyCoder._freqEMA)

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [n, 8, h, w] -> codes small -> large, each [n, 1, h_l, w_l]
        (quantizer.py:676-693): top-down residual peeling."""
        latents = []
        for enc in self._encoders:
            x = enc(x)
            latents.append(x)
        codes = []
        current = torch.zeros_like(latents[-1])
        for i in reversed(range(len(self.size))):
            code = vqEncode(groupLatent(latents[i] - current, 1), self.codebook)
            codes.append(code)
            current = self._backwards[i](vqDequantizeCodes(code, self.codebook))
        return codes

    def residual_forward(self, code: torch.Tensor, formerLevel, level: int) -> torch.Tensor:
        """One decode step (quantizer.py:705-712); level 0 is the smallest."""
        quantized = vqDequantizeCodes(code, self.codebook)
        if formerLevel is not None:
            quantized = quantized + formerLevel
        return self._decoders[len(self.size) - 1 - level](quantized)

    def residual_backward(self, code: torch.Tensor, level: int) -> torch.Tensor:
        """A level's codes through its backward stack (quantizer.py:671-674);
        level counts from 1, the smallest. The smallest level's backward is
        the identity."""
        return self._backwards[len(self.size) - level](vqDequantizeCodes(code, self.codebook))

    def decode(self, codes: Sequence[torch.Tensor]) -> torch.Tensor:
        """codes small -> large -> latent [n, 8, H, W] (quantizer.py:695-703)."""
        formerLevel = None
        for level, code in enumerate(codes):
            formerLevel = self.residual_forward(code, formerLevel, level)
        return formerLevel

    def forward(self, x: torch.Tensor, draw: Draw):
        """Training forward: latent [n, 8, h, w] -> (yHat [n, 8, h, w], codes
        small -> large [n, 1, h_l, w_l], logits [n, 1, h_l, w_l, k])."""
        latents = []
        for enc in self._encoders:
            x = enc(x)
            latents.append(x)
        quantizeds, codes, logits = [], [], []
        current = torch.zeros_like(latents[-1])
        L = len(self.size)
        for level, i in enumerate(reversed(range(L))):
            sampled, code, logit = sample(groupLatent(latents[i] - current, 1), self.codebook,
                                          self._quantizers[i]._temperature,
                                          self._entropyCoder._freqEMA[level], draw, self.training)
            quantized = vqDequantizeSoft(sampled, self.codebook)
            quantizeds.append(quantized)
            codes.append(code)
            logits.append(logit)
            current = self._backwards[i](quantized)
        formerLevel = torch.zeros_like(quantizeds[0])
        for level, quantized in enumerate(quantizeds):
            formerLevel = self._decoders[L - 1 - level](formerLevel + quantized)
        if self.training:
            emaUpdates(self.frequencies(), codes, self.EMA)
        return formerLevel, codes, logits
