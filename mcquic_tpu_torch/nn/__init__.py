from mcquic_tpu_torch.nn.blocks import (AttentionBlock, ResidualBlock, ResidualBlockShuffle,
                                        ResidualBlockWithStride)
from mcquic_tpu_torch.nn.convs import PixelShuffleConv, conv1x1, conv3x3, pixelShuffle3x3
from mcquic_tpu_torch.nn.gdn import GenDivNorm, InvGenDivNorm

__all__ = [
    "AttentionBlock", "ResidualBlock", "ResidualBlockShuffle", "ResidualBlockWithStride",
    "PixelShuffleConv", "conv1x1", "conv3x3", "pixelShuffle3x3",
    "GenDivNorm", "InvGenDivNorm",
]
