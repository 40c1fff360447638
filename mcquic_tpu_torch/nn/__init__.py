from mcquic_tpu_torch.nn.blocks import (AttentionBlock, NonLocalBlock, ResidualBlock,
                                        ResidualBlockMasked, ResidualBlockShuffle,
                                        ResidualBlockWithStride)
from mcquic_tpu_torch.nn.convs import (MaskedConv, PixelShuffleConv, conv1x1, conv3x3, conv5x5,
                                       pixelShuffle1x1, pixelShuffle3x3, pixelShuffle5x5)
from mcquic_tpu_torch.nn.gdn import GenDivNorm, InvGenDivNorm

__all__ = [
    "AttentionBlock", "NonLocalBlock", "ResidualBlock", "ResidualBlockMasked",
    "ResidualBlockShuffle", "ResidualBlockWithStride",
    "MaskedConv", "PixelShuffleConv", "conv1x1", "conv3x3", "conv5x5",
    "pixelShuffle1x1", "pixelShuffle3x3", "pixelShuffle5x5",
    "GenDivNorm", "InvGenDivNorm",
]
