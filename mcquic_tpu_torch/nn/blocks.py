"""Residual and attention blocks, NCHW, named like the reference McQuic
state dict (`_branch.N`, `_skip`, `_mainBranch.N`, `_sideBranch.N`).

Counterparts of `mcquic_tpu/nn/blocks.py:31-134`:
  * ResidualBlock           SiLU-conv-SiLU-conv + skip; the skip is x, or
                            conv1x1(x) when the block changes width
  * ResidualBlockWithStride SiLU-conv(stride)-GDN-conv + skip: conv3x3(stride)
                            when stride != 1, else conv1x1 when the width
                            changes, else x
  * ResidualBlockShuffle    SiLU-pixelShuffle3x3-IGDN-conv + pixelShuffle3x3 skip
  * AttentionBlock          main(3 resblocks) * sigmoid(side(3 resblocks + conv1x1)) + x,
                            the conv-sigmoid gate of Cheng 2020 (no softmax), any width

The JAX blocks also take `groups` and `denseNorm`. With `denseNorm` False,
the only form any shipped configuration uses, `groups` changes nothing
(`blocks.py:43-46, 67-68`), so neither is taken here and `GroupNorm` is not
ported.
"""
from torch import nn

from mcquic_tpu_torch.nn.convs import conv1x1, conv3x3, pixelShuffle3x3
from mcquic_tpu_torch.nn.gdn import GenDivNorm, InvGenDivNorm


class ResidualBlock(nn.Module):
    def __init__(self, inChannels: int, outChannels: int = None):
        super().__init__()
        outChannels = outChannels or inChannels
        self._branch = nn.Sequential(nn.SiLU(), conv3x3(inChannels, outChannels),
                                     nn.SiLU(), conv3x3(outChannels, outChannels))
        self._skip = conv1x1(inChannels, outChannels) if inChannels != outChannels else None

    def forward(self, x):
        return self._branch(x) + (x if self._skip is None else self._skip(x))


class ResidualBlockWithStride(nn.Module):
    def __init__(self, inChannels: int, stride: int = 2, outChannels: int = None):
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
    def __init__(self, inChannels: int, upsample: int = 2, outChannels: int = None):
        super().__init__()
        outChannels = outChannels or inChannels
        self._branch = nn.Sequential(nn.SiLU(), pixelShuffle3x3(inChannels, outChannels, upsample),
                                     InvGenDivNorm(outChannels), conv3x3(outChannels, outChannels))
        self._skip = pixelShuffle3x3(inChannels, outChannels, upsample)

    def forward(self, x):
        return self._branch(x) + self._skip(x)


class AttentionBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self._mainBranch = nn.Sequential(*[ResidualBlock(channels) for _ in range(3)])
        self._sideBranch = nn.Sequential(*[ResidualBlock(channels) for _ in range(3)],
                                         conv1x1(channels, channels))

    def forward(self, x):
        return self._mainBranch(x) * self._sideBranch(x).sigmoid() + x
