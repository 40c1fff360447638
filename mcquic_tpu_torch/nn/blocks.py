"""Residual and attention blocks, NCHW, named like the reference McQuic
state dict (`_branch.N`, `_skip`, `_mainBranch.N`, `_sideBranch.N`).

Counterparts of `mcquic_tpu/nn/blocks.py`:
  * ResidualBlock           SiLU-conv-SiLU-conv + skip; the skip is x, or
                            conv1x1(x) when the block changes width. With
                            `denseNorm` the middle SiLU is a GroupNorm of
                            `groups` groups (`blocks.py:43-46`)
  * ResidualBlockWithStride SiLU-conv(stride)-GDN-conv + skip: conv3x3(stride)
                            when stride != 1, else conv1x1 when the width
                            changes, else x
  * ResidualBlockShuffle    SiLU-pixelShuffle3x3-IGDN-conv + pixelShuffle3x3 skip
  * ResidualBlockMasked     ReLU-MaskedConv5x5(type)-ReLU-MaskedConv5x5(B) +
                            skip: x, or MaskedConv5x5(type) when the width changes
  * AttentionBlock          main(3 resblocks) * sigmoid(side(3 resblocks + conv1x1)) + x,
                            the conv-sigmoid gate of Cheng 2020 (no softmax), any width
  * NonLocalBlock           global attention over the h*w positions through
                            1x1-conv q, k, v (half width) and a 1x1-conv back,
                            logits scaled by sqrt(h*w), randomly masked in training

The stride and shuffle blocks take `groups` and `denseNorm` and ignore them,
as the JAX blocks do (`blocks.py:67-68`): their GDN is never grouped.

The GroupNorm has flax's epsilon, 1e-6. flax computes its variance as
E[x^2] - E[x]^2 and torch as the mean squared deviation; the two agree to
rounding (`tests/test_torch_primitives.py` states the tolerance).
"""
import math

import torch
from torch import nn

from mcquic_tpu_torch.nn.convs import MaskedConv, conv1x1, conv3x3, pixelShuffle3x3
from mcquic_tpu_torch.nn.gdn import GenDivNorm, InvGenDivNorm

GROUP_NORM_EPS = 1e-6          # flax nn.GroupNorm's default


class ResidualBlock(nn.Module):
    def __init__(self, inChannels: int, outChannels: int = None, groups: int = 1,
                 denseNorm: bool = False):
        super().__init__()
        outChannels = outChannels or inChannels
        middle = nn.GroupNorm(groups, outChannels, eps=GROUP_NORM_EPS) if denseNorm else nn.SiLU()
        self._branch = nn.Sequential(nn.SiLU(), conv3x3(inChannels, outChannels),
                                     middle, conv3x3(outChannels, outChannels))
        self._skip = conv1x1(inChannels, outChannels) if inChannels != outChannels else None

    def forward(self, x):
        return self._branch(x) + (x if self._skip is None else self._skip(x))


class ResidualBlockWithStride(nn.Module):
    def __init__(self, inChannels: int, stride: int = 2, outChannels: int = None,
                 groups: int = 1, denseNorm: bool = False):
        super().__init__()
        outChannels = outChannels or inChannels
        self._branch = nn.Sequential(nn.SiLU(), conv3x3(inChannels, outChannels, stride),
                                     GenDivNorm(outChannels), conv3x3(outChannels, outChannels))
        if stride != 1:
            self._skip = conv3x3(inChannels, outChannels, stride)
        elif inChannels != outChannels:
            self._skip = conv1x1(inChannels, outChannels)
        else:
            self._skip = None

    def forward(self, x):
        return self._branch(x) + (x if self._skip is None else self._skip(x))


class ResidualBlockShuffle(nn.Module):
    def __init__(self, inChannels: int, upsample: int = 2, outChannels: int = None,
                 groups: int = 1, denseNorm: bool = False):
        super().__init__()
        outChannels = outChannels or inChannels
        self._branch = nn.Sequential(nn.SiLU(), pixelShuffle3x3(inChannels, outChannels, upsample),
                                     InvGenDivNorm(outChannels), conv3x3(outChannels, outChannels))
        self._skip = pixelShuffle3x3(inChannels, outChannels, upsample)

    def forward(self, x):
        return self._branch(x) + self._skip(x)


class ResidualBlockMasked(nn.Module):
    """For causal decoding (`blocks.py:98-116`)."""

    def __init__(self, inChannels: int, outChannels: int = None, maskType: str = "A"):
        super().__init__()
        outChannels = outChannels or inChannels
        self._branch = nn.Sequential(nn.ReLU(), MaskedConv(inChannels, outChannels, 5, maskType),
                                     nn.ReLU(), MaskedConv(outChannels, outChannels, 5, "B"))
        self._skip = (MaskedConv(inChannels, outChannels, 5, maskType)
                      if inChannels != outChannels else None)

    def forward(self, x):
        return self._branch(x) + (x if self._skip is None else self._skip(x))


class AttentionBlock(nn.Module):
    def __init__(self, channels: int, groups: int = 1, denseNorm: bool = False):
        super().__init__()
        self._mainBranch = nn.Sequential(*[ResidualBlock(channels, channels, groups, denseNorm)
                                           for _ in range(3)])
        self._sideBranch = nn.Sequential(*[ResidualBlock(channels, channels, groups, denseNorm)
                                           for _ in range(3)], conv1x1(channels, channels))

    def forward(self, x):
        return self._mainBranch(x) * self._sideBranch(x).sigmoid() + x


class NonLocalBlock(nn.Module):
    """x + conv1x1(softmax(q k^T / sqrt(h*w)) v) over the flattened
    positions (`blocks.py:137-161`). The logits and the softmax are fp32
    whatever the input's precision, as in the JAX package. In training mode
    each logit is set to -1e9 where a uniform in [0, 1) is below
    `maskRate`; the [n, hw, hw] uniforms come from `draw` (a function of
    the shape, `ops/vq.py::draws` of a `torch.Generator`), or from the
    caller as `uniforms`."""

    def __init__(self, channels: int, groups: int = 1, maskRate: float = 0.1):
        super().__init__()
        half = channels // 2
        self._q = conv1x1(channels, half, groups=groups)
        self._k = conv1x1(channels, half, groups=groups)
        self._v = conv1x1(channels, half, groups=groups)
        self._z = conv1x1(half, channels, groups=groups)
        self.maskRate = maskRate

    def forward(self, x, draw=None, uniforms=None):
        n, c, h, w = x.shape
        hw = h * w

        def tokens(conv):                       # [n, hw, c / 2], positions row-major
            return conv(x).flatten(2).transpose(1, 2)
        q, k, v = tokens(self._q), tokens(self._k), tokens(self._v)
        logits = torch.einsum("nqc,nkc->nqk", q, k).float() / math.sqrt(hw)
        if self.training and self.maskRate > 0:
            if uniforms is None:
                if draw is None:
                    raise ValueError("NonLocalBlock in training draws its mask: pass `draw` "
                                     "(ops/vq.py::draws of a torch.Generator) or `uniforms`")
                uniforms = draw((n, hw, hw))
            logits = torch.where(uniforms.to(logits.device) < self.maskRate,
                                 torch.full_like(logits, -1e9), logits)
        weights = torch.softmax(logits, -1).to(x.dtype)
        z = torch.einsum("nqk,nkc->nqc", weights, v).transpose(1, 2).reshape(n, c // 2, h, w)
        return x + self._z(z)
