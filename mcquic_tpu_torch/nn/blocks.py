"""Residual and attention blocks, NCHW, named like the reference McQuic
state dict (`_branch.N`, `_skip`, `_mainBranch.N`, `_sideBranch.N`).

Counterparts of `mcquic_tpu/nn/blocks.py` in the channel-preserving forms
the v1 codec uses:
  * ResidualBlock           SiLU-conv-SiLU-conv + x
  * ResidualBlockWithStride SiLU-conv(stride)-GDN-conv + strided conv skip
  * ResidualBlockShuffle    SiLU-pixelShuffle3x3-IGDN-conv + pixelShuffle3x3 skip
  * AttentionBlock          main(3 resblocks) * sigmoid(side(3 resblocks + conv1x1)) + x,
                            the conv-sigmoid gate of Cheng 2020 (no softmax)
"""
from torch import nn

from mcquic_tpu_torch.nn.convs import conv1x1, conv3x3, pixelShuffle3x3
from mcquic_tpu_torch.nn.gdn import GenDivNorm, InvGenDivNorm


class ResidualBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self._branch = nn.Sequential(nn.SiLU(), conv3x3(channels, channels),
                                     nn.SiLU(), conv3x3(channels, channels))

    def forward(self, x):
        return self._branch(x) + x


class ResidualBlockWithStride(nn.Module):
    def __init__(self, channels: int, stride: int = 2):
        super().__init__()
        self._branch = nn.Sequential(nn.SiLU(), conv3x3(channels, channels, stride),
                                     GenDivNorm(channels), conv3x3(channels, channels))
        self._skip = conv3x3(channels, channels, stride)

    def forward(self, x):
        return self._branch(x) + self._skip(x)


class ResidualBlockShuffle(nn.Module):
    def __init__(self, channels: int, upsample: int = 2):
        super().__init__()
        self._branch = nn.Sequential(nn.SiLU(), pixelShuffle3x3(channels, channels, upsample),
                                     InvGenDivNorm(channels), conv3x3(channels, channels))
        self._skip = pixelShuffle3x3(channels, channels, upsample)

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
