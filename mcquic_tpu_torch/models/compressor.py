"""The codecs, NCHW.

* `Compressor`, the v1 codec (reference `mcquic/modules/compressor.py:120-177`),
  counterpart of `mcquic_tpu/models/compressor.py::Compressor`: an
  8x-downsampling conv/GDN/attention encoder, the UMGM quantizer cascade
  with its six head stacks, and the mirrored pixel-shuffle decoder, whose
  final thin RGB head runs kernel K2 on CUDA outside autograd. `forward` is
  the training pass (`compressor.py:160-165`).
* `Neon`, the v2 tokenizer (reference `compressor.py:181-233`), counterpart
  of `mcquic_tpu/models/compressor.py:179-285`: an 8x-downsampling encoder
  into an 8-channel latent, the `ResidualBackwardQuantizer`, and a mirrored
  decoder ending in a plain conv3x3 to RGB. `forward` is the training pass
  (`compressor.py:199-203`); with `useRemat` (the JAX package's flag, on by
  default) the encoder and the decoder run under
  `torch.utils.checkpoint` in training, which keeps only their inputs and
  runs them again for the backward (`nn.remat`, `compressor.py:188-195`).
  Nothing random is drawn inside them: the sampling's uniforms come from
  `draw`, in the quantizer, outside the checkpointed regions.
"""
import math
from typing import List, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mcquic_tpu_torch.models.quantizer import ResidualBackwardQuantizer, UMGMQuantizer
from mcquic_tpu_torch.nn import (AttentionBlock, ResidualBlock, ResidualBlockShuffle,
                                 ResidualBlockWithStride, conv3x3, pixelShuffle3x3)
from mcquic_tpu_torch.utils.registry import ModelRegistry

NEON_GROUPS = 32               # `g` of the JAX Neon's encoder and decoder


def _v1Encoder(c: int) -> nn.Sequential:
    """conv3x3/2, ResB, ResBStride/2, Attn, ResB, ResBStride/2, ResB."""
    return nn.Sequential(conv3x3(3, c, 2), ResidualBlock(c), ResidualBlockWithStride(c, 2),
                         AttentionBlock(c), ResidualBlock(c), ResidualBlockWithStride(c, 2),
                         ResidualBlock(c))


def _v1Decoder(c: int) -> nn.Sequential:
    """Mirror of the encoder, ending in the thin RGB head pixelShuffle3x3(3, 2)."""
    return nn.Sequential(ResidualBlock(c), ResidualBlockShuffle(c, 2), AttentionBlock(c),
                         ResidualBlock(c), ResidualBlockShuffle(c, 2), ResidualBlock(c),
                         pixelShuffle3x3(c, 3, 2))


def _heads(c: int) -> dict:
    return {
        "latentStageEncoder": lambda: nn.Sequential(
            ResidualBlockWithStride(c, 2), ResidualBlock(c), AttentionBlock(c)),
        "quantizationHead": lambda: nn.Sequential(
            ResidualBlock(c), AttentionBlock(c), conv3x3(c, c)),
        "latentHead": lambda: nn.Sequential(
            ResidualBlock(c), AttentionBlock(c), conv3x3(c, c)),
        "dequantizationHead": lambda: nn.Sequential(
            AttentionBlock(c), conv3x3(c, c), ResidualBlock(c)),
        "sideHead": lambda: nn.Sequential(
            AttentionBlock(c), conv3x3(c, c), ResidualBlock(c)),
        "restoreHead": lambda: nn.Sequential(
            AttentionBlock(c), ResidualBlock(c), ResidualBlockShuffle(c, 2)),
    }


@ModelRegistry.register
class Compressor(nn.Module):
    """v1 multi-codebook codec: channel, m groups, per-level codebook sizes k."""

    def __init__(self, channel: int, m: int, k: Sequence[int]):
        super().__init__()
        self.channel = channel
        self.m = m
        self.k = list(k)
        self._encoder = _v1Encoder(channel)
        self._decoder = _v1Decoder(channel)
        self._quantizer = UMGMQuantizer(channel, m, self.k, _heads(channel))

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [n, 3, H, W] in [-1, 1], H and W multiples of 2^(3 + levels)
        -> per level codes [n, m, h, w] (compressor.py:79-88)."""
        return self._quantizer.encode(self._encoder(x))

    def decode(self, codes: Sequence[torch.Tensor]) -> torch.Tensor:
        """codes -> restored [n, 3, H, W] (compressor.py:114-117)."""
        return self._decoder(self._quantizer.decode(codes))

    def forward(self, x: torch.Tensor, draw):
        """Training pass: x [n, 3, H, W] in [-1, 1] -> (xHat, yHat, codes per
        level, logits per level); `draw` gives the sampling's uniforms
        (`ops/vq.py::draws`)."""
        y = self._encoder(x)
        yHat, codes, logits = self._quantizer(y, draw)
        return self._decoder(yHat), yHat, codes, logits


def _neonEncoder(c: int, denseNorm: bool = False) -> nn.Sequential:
    """16 stages (compressor.py:186-207), three of them stride 2, ending in
    the quantizer's 8-channel latent. With `denseNorm` the residual blocks'
    GroupNorms have 32 groups, those of the last two stages one."""
    latent, g, dn = ResidualBackwardQuantizer.channel, NEON_GROUPS, denseNorm
    return nn.Sequential(
        conv3x3(3, c), AttentionBlock(c, g, dn), ResidualBlock(c, c, g, dn),
        ResidualBlock(c, c, g, dn), ResidualBlockWithStride(c, 2), ResidualBlock(c, c, g, dn),
        ResidualBlockWithStride(c, 2), ResidualBlock(c, c, g, dn), ResidualBlockWithStride(c, 2),
        AttentionBlock(c, g, dn), ResidualBlock(c, 2 * c, g, dn), ResidualBlock(2 * c, 2 * c, g, dn),
        ResidualBlock(2 * c, 2 * c, g, dn), ResidualBlock(2 * c, 2 * c, g, dn),
        ResidualBlock(2 * c, latent, 1, dn), AttentionBlock(latent, 1, dn))


def _neonDecoder(c: int, denseNorm: bool = False) -> nn.Sequential:
    """17 stages (compressor.py:208-228), three pixel-shuffle upsamples, then
    conv3x3 to RGB; GroupNorms as in the encoder, one group in the first two
    stages."""
    latent, g, dn = ResidualBackwardQuantizer.channel, NEON_GROUPS, denseNorm
    return nn.Sequential(
        AttentionBlock(latent, 1, dn), ResidualBlock(latent, 2 * c, 1, dn),
        ResidualBlock(2 * c, 2 * c, g, dn), ResidualBlock(2 * c, 2 * c, g, dn),
        ResidualBlock(2 * c, 2 * c, g, dn), ResidualBlock(2 * c, c, g, dn), AttentionBlock(c, g, dn),
        ResidualBlock(c, c, g, dn), ResidualBlockShuffle(c, 2), ResidualBlock(c, c, g, dn),
        ResidualBlockShuffle(c, 2), ResidualBlock(c, c, g, dn), ResidualBlockShuffle(c, 2),
        ResidualBlock(c, c, g, dn), ResidualBlock(c, c, g, dn), AttentionBlock(c, g, dn),
        conv3x3(c, 3))


@ModelRegistry.register
class Neon(nn.Module):
    """v2 tokenizer: channel, one shared codebook of k codewords, per-level
    latent grids `size` (large -> small); `denseNorm` puts a GroupNorm in
    every residual block of the encoder, the decoder and the quantizer
    (with 32 groups in the encoder's and decoder's wide stages, so the
    channel must be a multiple of 32 there, as flax requires)."""

    def __init__(self, channel: int, k: int, size: Sequence[int], useRemat: bool = True,
                 denseNorm: bool = False):
        super().__init__()
        self.channel = channel
        self.k = k
        self.size = list(size)
        self.useRemat = useRemat
        self.denseNorm = denseNorm
        self._encoder = _neonEncoder(channel, denseNorm)
        self._decoder = _neonDecoder(channel, denseNorm)
        self._quantizer = ResidualBackwardQuantizer(k, self.size, denseNorm)

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [n, 3, H, W] in [-1, 1] -> codes small -> large, each [n, 1, h, w]."""
        return self._quantizer.encode(self._encoder(x))

    def decode(self, codes: Sequence[torch.Tensor]) -> torch.Tensor:
        """codes small -> large -> restored [n, 3, H, W]."""
        return self._decoder(self._quantizer.decode(codes))

    def _remat(self, stack: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.useRemat and self.training and torch.is_grad_enabled():
            return checkpoint(stack, x, use_reentrant=False)
        return stack(x)

    def forward(self, x: torch.Tensor, draw):
        """Training pass: x [n, 3, H, W] in [-1, 1] -> (xHat, yHat, codes
        small -> large, logits); `draw` gives the sampling's uniforms."""
        yHat, codes, logits = self._quantizer(self._remat(self._encoder, x), draw)
        return self._remat(self._decoder, yHat), yHat, codes, logits

    def residual_forward(self, code: torch.Tensor, formerLevel, level: int) -> torch.Tensor:
        """One decode step of the quantizer; level 0 is the smallest."""
        return self._quantizer.residual_forward(code, formerLevel, level)

    def residual_backward(self, code: torch.Tensor, level: int) -> torch.Tensor:
        """A level's codes through the quantizer's backward stack; level 1
        is the smallest."""
        return self._quantizer.residual_backward(code, level)


def buildModel(geometry: dict) -> nn.Module:
    """The stage-1 model of a geometry (`utils/convert.py::modelGeometry`):
    Neon where it has a `size` pyramid, the v1 Compressor otherwise."""
    return ModelRegistry.get("Neon" if "size" in geometry else "Compressor")(**geometry)


def seededModel(geometry: dict, seed: int = 0) -> nn.Module:
    """A stage-1 model with numpy-seeded weights at the scales a trained
    model has, for geometries with no trained file: convs U(+-1/sqrt(fan_in)),
    GDN reparams near their init, codebooks N(0, 2/(5d)), and code
    frequencies in [0.5, 1.5] before normalizing, so that every symbol of
    even a 16384-codeword level gets a nonzero rANS frequency at 16 bits."""
    model = buildModel(geometry)
    rng = np.random.default_rng(seed)

    def value(key, shape):
        if key.endswith("._codebook"):
            return rng.normal(size=shape) * np.sqrt(2 / (5 * shape[-1]))
        if key.endswith("._temperature") or key.endswith("beta"):
            return 1 + rng.uniform(0, 0.1, size=shape)
        if key.endswith("weight") and len(shape) == 1:          # a GroupNorm's scale
            return 1 + rng.uniform(-0.1, 0.1, size=shape)
        if "._freqEMA." in key:
            freq = rng.uniform(0.5, 1.5, size=shape)
            return freq / freq.sum(-1, keepdims=True)
        if key.endswith("gamma"):
            return np.sqrt(0.1) * np.eye(shape[0]) + rng.uniform(0, 0.05, size=shape)
        if key.endswith("weight"):
            return rng.uniform(-1, 1, size=shape) / np.sqrt(int(np.prod(shape[1:])))
        if key.endswith("bias"):
            return rng.uniform(-0.1, 0.1, size=shape)
        raise KeyError(key)

    model.load_state_dict({key: torch.from_numpy(value(key, tuple(v.shape)).astype(np.float32))
                           for key, v in model.state_dict().items()})
    return model.eval()


def seededCompressor(channel: int, m: int, k: Sequence[int], seed: int = 0) -> Compressor:
    """`seededModel` of a v1 Compressor."""
    return seededModel({"channel": channel, "m": m, "k": list(k)}, seed)


def truncatedNormal(shape, generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2] (`jax.random.truncated_normal(-2, 2)`),
    by redrawing what falls outside."""
    value = torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)
    outside = value.abs() > 2
    while bool(outside.any()):
        value = torch.where(outside, torch.randn(shape, generator=generator, device=like.device,
                                                 dtype=like.dtype), value)
        outside = value.abs() > 2
    return value


@torch.no_grad()
def initialize(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw a stage-1 model's training start (v1 Compressor or Neon) from
    `generator` with the JAX package's initializers' distributions: conv
    kernels U(+-1/sqrt(fan_in)) and zero biases (`nn/convs.py:17-32`), GDN
    beta sqrt(1 + eps^2) and gamma sqrt(0.1 I + eps^2) in reparam space
    (`nn/gdn.py:32-38`), temperatures 1, code frequencies 1/k; v1 codebooks
    N(0, 2 / (5 d)) (SmallInit, `models/quantizer.py:37-41`), Neon's shared
    codebook the same deviation truncated at 2 (`quantizer.py:44-47`), and
    Neon's RGB head variance-scaled by 1e-4, truncated normal
    (`compressor.py:270-283`)."""
    eps2 = 1e-12
    neonHead = f"_decoder.{len(model._decoder) - 1}.weight" if isinstance(model, Neon) else None
    for key, p in model.state_dict().items():
        shape = tuple(p.shape)
        if key == neonHead:
            std = math.sqrt(1e-4 / int(np.prod(shape[1:]))) / 0.87962566103423978
            value = truncatedNormal(shape, generator, p) * std
        elif key.endswith("._codebook") and isinstance(model, Neon):
            value = truncatedNormal(shape, generator, p) * math.sqrt(2 / (5 * shape[-1]))
        elif key.endswith("._codebook"):
            value = torch.randn(shape, generator=generator, device=p.device, dtype=p.dtype) \
                * math.sqrt(2 / (5 * shape[-1]))
        elif key.endswith("._temperature"):
            value = torch.ones_like(p)
        elif "._freqEMA." in key:
            value = torch.full_like(p, 1.0 / shape[-1])
        elif key.endswith("beta"):
            value = torch.full_like(p, math.sqrt(1 + eps2))
        elif key.endswith("gamma"):
            value = torch.sqrt(torch.clamp_min(0.1 * torch.eye(shape[0], dtype=p.dtype,
                                                               device=p.device) + eps2, eps2))
        elif key.endswith("weight") and len(shape) == 1:        # a GroupNorm's scale
            value = torch.ones_like(p)
        elif key.endswith("weight"):
            bound = 1 / math.sqrt(int(np.prod(shape[1:])))
            value = (torch.rand(shape, generator=generator, device=p.device, dtype=p.dtype)
                     * 2 - 1) * bound
        elif key.endswith("bias"):
            value = torch.zeros_like(p)
        else:
            raise KeyError(key)
        p.copy_(value)
    return model
